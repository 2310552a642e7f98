"""Run chip_smoke.py's ``serve prefix`` phase alone on the card:

    python scripts/torch_serve_prefix.py

From the root of a checkout: builds the port's kernels, draws Qwen2-1.5B at
full width and depth from seed 0, then serves the shared-template workload
with the prefix cache off and on through the paged kernel
(``chip_smoke.prefix_phase``: the bf16 hits against the cold run, the
corrupted-page control, references after every step, the coalesced run, a
traced run, fp32 on against off). Raises on a failed check, as
chip_smoke.py does. The card's name and power limit are printed first."""
import sys
import time
from pathlib import Path

root = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(root))
sys.path.insert(0, str(root / "src"))
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402

if not torch.cuda.is_available():
    sys.exit("torch.cuda.is_available() is false; this script needs a GPU")
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
print(f"gpu: {cs.gpu_line()}; torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
t0 = time.perf_counter()
_build.lib()
print(f"build: {time.perf_counter() - t0:.1f} s", flush=True)
cfg, model, net = cs.init_dense_lm("qwen2_1_5b", cs.QWEN2_SIZE)
print(f"paged launches of the cache-on run: {cs.prefix_phase(cfg, model, net)}")
