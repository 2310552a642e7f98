"""Run chip_smoke.py's checks of the causal FLARE kernel on the kernels of
one checkout, and time it, on the card:

    python scripts/torch_causal_checks.py <checkout root>

The checks are this repository's (``check_causal_small``: random operands
at flare_lm's width and ragged shapes, the bf16 output also beyond bf16
rounding against fp64; ``check_causal_main``: flare_lm's layer 0 at
T=32,768, fp32 against fp64 and bf16 beyond rounding, each rejecting a lost
64-token state tile), run against the checkout's ``repro_torch``; so the
parent's kernel can be held to a check the parent did not have. A failed
check is printed, not raised."""
import sys
import time
from pathlib import Path

root = sys.argv[1]
sys.path.insert(0, str(Path(__file__).resolve().parents[1]))   # this repository's chip_smoke
sys.path.insert(0, root + "/src")                               # the checkout's kernels
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402

print("causal checks on", root, flush=True)
_build.lib()
dev = torch.device("cuda")
torch.backends.cuda.matmul.allow_tf32 = False
for phase in ("small", "main"):
    checks = cs.Checks()
    try:
        if phase == "small":
            cs.check_causal_small(checks, dev)
            continue
        from repro_torch.config import SHAPES
        from repro_torch.configs import get_config
        from repro_torch.data.synthetic import TokenStream
        from repro_torch.models.api import get_model

        cfg = get_config("flare_lm")
        t0 = time.perf_counter()
        net = get_model(cfg).init(cs.SEED)
        print(f"init flare_lm {time.perf_counter() - t0:.1f} s", flush=True)
        n = SHAPES["prefill_32k"].seq_len
        stream = TokenStream(cfg.vocab, n, seed=cs.SEED)
        tokens = torch.from_numpy(stream.batch(0, 0, 1, 1)["tokens"]).long().to(dev)
        ops32 = cs.lm_operands(net, cfg, tokens, torch.float32)
        ops16 = cs.lm_operands(net, cfg, tokens, torch.bfloat16)
        del net
        torch.cuda.empty_cache()
        cs.check_causal_main(checks, ops32, ops16)
        print("time bf16", cs.time_causal(*ops16), flush=True)
    except AssertionError as err:
        print("FAILED", phase, err, flush=True)
