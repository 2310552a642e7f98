"""Run chip_smoke.py's two MLA serving phases alone on the card:

    python scripts/torch_serve_mla.py [deepseek_v2_lite_16b] [minicpm3_4b]

From the root of a checkout: builds the port's kernels, then for each arch
(both by default) draws the model at full width and depth on the card from
seed 0 and runs ``chip_smoke.mla_phase``: the paged kernel's MLA read on
random operands (bf16, int8, fp8 and fp32 pages) and on layer 0's decode operands
against the plain version in fp64, with a dropped-page control and its
times beside the bound, the plain version and SDPA; 16 requests on the
dense pool and the kernel route in bf16, 4 on those and the gather route
in fp32 (greedy tokens equal); one decode step's
``kernels.paged_attention`` scopes and its profiler breakdown; DeepSeek's expert-weight casts; MiniCPM3's prefix cache with its
corrupted-page control. Raises on a failed check, as chip_smoke.py does.
The card's name and power limit are printed first."""
import json
import sys
import time
from pathlib import Path

root = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(root))
sys.path.insert(0, str(root / "src"))
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402

PARAMS = {"deepseek_v2_lite_16b": cs.DEEPSEEK_PARAMS, "minicpm3_4b": cs.MINICPM3_PARAMS}

if not torch.cuda.is_available():
    sys.exit("torch.cuda.is_available() is false; this script needs a GPU")
archs = sys.argv[1:] or list(PARAMS)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
print(f"gpu: {cs.gpu_line()}; torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
t0 = time.perf_counter()
_build.lib()
print(f"build: {time.perf_counter() - t0:.1f} s", flush=True)
checks = cs.Checks()
device = torch.device("cuda", 0)
reads = {arch: cs.mla_phase(checks, arch, PARAMS[arch], device) for arch in archs}
print(json.dumps({"mla_read": reads}))
