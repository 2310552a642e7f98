"""Run chip_smoke.py's ``pde baselines`` phase alone on the card:

    python scripts/torch_pde_baselines.py

From the root of a checkout: builds the port's kernels (the FLARE row trains
through the fused forward and backward), then holds each baseline against
the fp64 plain oracle at B=1, N=4,096, sweeps one block's forward over N,
holds the fused kernels at B=8, N=16,384 against the fp64 plain version and
trains the five Table-1 mixers at flare_pde's width there
(``chip_smoke.pde_baselines``). Raises on a failed check, as chip_smoke.py
does. The card's name and power limit are printed first."""
import sys
import time
from pathlib import Path

root = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(root))
sys.path.insert(0, str(root / "src"))
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402

if not torch.cuda.is_available():
    sys.exit("torch.cuda.is_available() is false; this script needs a GPU")
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
print(f"gpu: {cs.gpu_line()}; torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
t0 = time.perf_counter()
_build.lib()
print(f"build: {time.perf_counter() - t0:.1f} s", flush=True)
print(f"launches of the FLARE row: {cs.pde_baselines(cs.Checks(), get_config('flare_pde'), torch.device('cuda', 0))}")
