#!/usr/bin/env python3
"""How far two attention routes of Zamba2-7B drift apart, stage by stage.

Draws ``zamba2_7b`` at full size on the card (seed 0), prefills one seeded
prompt of T tokens (default 4,096) through the shared block's attention on
the ``pallas`` (the flash kernels), ``chunked`` and ``xla`` routes, in bf16
and in fp32 compute (TF32 off), and prints, for each route against
``chunked``: the last-token logits' difference over max |logit|, and after
each of the 26 stages (a group's Mamba2 layers, then its shared-block
invocation; the trailing layers last) the hidden state's max |h| and its
difference over max |h|. It shows how much the random-weight network
amplifies one attention output's rounding on its way to the logits.

    PYTHONPATH=src python3 scripts/torch_zamba_divergence.py [T]
"""
import sys
import time

import torch

from repro_torch.config import replace
from repro_torch.configs import get_config
from repro_torch.models import ssm, zamba
from repro_torch.models.api import get_model
from repro_torch.models.rope import text_positions
from repro_torch.nn.modules import embedding


def stages(net, cfg, tokens, impl):
    """(last-token logits, the hidden state after every stage, fp32)."""
    x0 = embedding(net.embed, tokens, getattr(torch, cfg.compute_dtype))
    pos = text_positions(*tokens.shape, device=tokens.device)
    x, hs = x0, []
    with torch.no_grad():
        for i, layers in enumerate(net.mamba_groups):
            for layer in layers:
                x, _ = ssm.mamba2_block(layer, x, cfg.ssm)
            hs.append(x.float().clone())
            x, _ = zamba._shared_block(net.shared, i, x, x0, cfg, positions=pos, impl=impl)
            hs.append(x.float().clone())
        for layer in net.mamba_tail:
            x, _ = ssm.mamba2_block(layer, x, cfg.ssm)
        hs.append(x.float().clone())
        return zamba._logits(net, x[:, -1:], cfg)[:, 0, :cfg.vocab], hs


def rel(a, b) -> float:
    return ((a - b).abs().max() / b.abs().max()).item()


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("torch_zamba_divergence.py needs a GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    t = int(sys.argv[1]) if len(sys.argv) > 1 else 4096
    cfg = get_config("zamba2_7b")
    net = get_model(cfg).init(0, generator=torch.Generator(device="cuda").manual_seed(0))
    tokens = torch.randint(0, cfg.vocab, (1, t), generator=torch.Generator().manual_seed(4)).cuda()
    for dtype in ("bfloat16", "float32"):
        c = replace(cfg, compute_dtype=dtype)
        out = {}
        for impl in ("pallas", "chunked", "xla"):
            t0 = time.time()
            out[impl] = stages(net, c, tokens, impl)
            torch.cuda.synchronize()
            print(dtype, impl, f"{time.time() - t0:.2f}s", flush=True)
        ref = out["chunked"]
        for impl in ("pallas", "xla"):
            logits, hs = out[impl]
            print(dtype, impl, "vs chunked logits rel", rel(logits, ref[0]))
            print("  per stage max|h| / rel diff:",
                  [f"{h.abs().max().item():.3g}/{rel(h, r):.2g}" for h, r in zip(hs, ref[1])],
                  flush=True)
        del out
        torch.cuda.empty_cache()
    print(torch.cuda.get_device_name(0))


if __name__ == "__main__":
    main()
