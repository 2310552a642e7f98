"""Time the flash kernel's bf16 route off TMA and the causal FLARE kernel's
fp32 route of one checkout on the card, for comparing two checkouts in one
call on one card (run them in turns: A, B, B, A):

    python scripts/torch_ab_flash_causal.py <checkout root>

Random operands laid out as the model gives them ([B, H, S, D] views of
[B, S, H, D]). The flash route off TMA (the checkout's bf16 route that is
neither the wgmma kernel's nor fp32's) at qwen2-1.5b's prefill_32k layer 0
(B=1, 12 query heads over 2 KV heads, T=32,768, D=128, causal), forced onto
the route, and on a call ``flash_route`` sends there itself (the same
geometry at D=100): CUDA-event ms a call after one warm-up, and the error
beyond bf16's output rounding against the fp64 plain version on query head
0's last 1,024 rows. The causal kernel in fp32 at flare_lm's layer 0 (B=1,
H=16, M=512, T=32,768, D=128): CUDA-event ms a call, and its error against
the fp64 plain version on head 0. Then a SHA-256 of the output bytes of the
bf16 kernels that share these kernels' `mma.sync` helpers (the causal
kernel in bf16 on the same operands; MLA's paged read over bf16 pages, fp32
q at DeepSeek-V2-Lite's shape), equal across checkouts where their bits
are; ptxas's registers and spills of the checkout's flash and causal
kernels; and the card's name and power limit. Each checkout builds its
kernels into its own build directory."""
import hashlib
import re
import subprocess
import sys

import torch

root = sys.argv[1]
sys.path.insert(0, root + "/src")
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.attention import ROUTES, flash_attention, flash_route  # noqa: E402
from repro_torch.kernels.flare_causal import flare_causal_chunk  # noqa: E402
from repro_torch.kernels.paged_attention import paged_attention  # noqa: E402
from repro_torch.kernels.ref import flare_causal_chunk_ref, flash_attention_ref  # noqa: E402

OFF_TMA = next(r for r in ROUTES if r not in ("tensor_core", "fp32"))


def event_ms(fn, reps):
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return round(start.elapsed_time(end) / reps, 3)


def digest(x: torch.Tensor) -> str:
    return hashlib.sha256(x.contiguous().view(torch.uint8).cpu().numpy().tobytes()).hexdigest()[:16]


def rel(got, want) -> float:
    return ((got.double() - want).abs().max() / want.abs().max()).item()


gen = torch.Generator().manual_seed(0)
b, h, hkv, t = 1, 12, 2, 32768
rows = slice(t - 1024, t)
for d, forced in ((128, OFF_TMA), (100, None)):
    q = torch.randn(b, t, h, d, generator=gen).to("cuda", torch.bfloat16).transpose(1, 2)
    k, v = (torch.randn(b, t, hkv, d, generator=gen).to("cuda", torch.bfloat16).transpose(1, 2)
            for _ in range(2))
    kw = dict(scale=d ** -0.5, causal=True)
    call = lambda: flash_attention(q, k, v, **kw, route=forced)
    o = call()
    want = flash_attention_ref(q[:, :1, rows].double(), k[:, :1].double(), v[:, :1].double(),
                               q_offset=t - 1024, **kw)
    excess = (((o[:, :1, rows].double() - want).abs() - 2.0 ** -8 * want.abs()).max()
              / want.abs().max()).item()
    route = forced or flash_route(q, k, v)
    print(root, f"flash bf16 {route} qwen2 prefill_32k layer 0 geometry D={d}",
          event_ms(call, 3), f"ms; error beyond bf16 rounding vs fp64 (head 0, last 1,024 "
          f"rows) {excess:.3g}", flush=True)
    del q, k, v, o

h, m, d = 16, 512, 128
q = (torch.randn(h, m, d, generator=gen) * d ** -0.5).cuda()
k, v = (torch.randn(b, t, h, d, generator=gen).cuda().transpose(1, 2) for _ in range(2))
y = flare_causal_chunk(q, k, v)
want = flare_causal_chunk_ref(q[:1].double(), k[:, :1].double(), v[:, :1].double(), tile=256)
print(root, "causal fp32 flare_lm layer 0", event_ms(lambda: flare_causal_chunk(q, k, v), 5),
      f"ms; error vs fp64 (head 0) {rel(y[:, :1], want):.3g}", flush=True)
bits = {"causal bf16": digest(flare_causal_chunk(q.bfloat16(), k.bfloat16(), v.bfloat16()))}
del q, k, v, y
g, d, d2, block, lanes = 16, 512, 64, 16, (0, 17, 1985, 2048)
pages = -(-max(lanes) // block)
nb = len(lanes) * pages + 1
pt = torch.randperm(nb - 1, generator=gen)[: len(lanes) * pages].reshape(len(lanes), pages)
c = torch.randn(nb, block, 1, d, generator=gen).bfloat16().cuda()
kr = torch.randn(nb, block, 1, d2, generator=gen).bfloat16().cuda()
qm = (torch.randn(len(lanes), 1, g, d, generator=gen) * d ** -0.5).cuda()
q2 = (torch.randn(len(lanes), 1, g, d2, generator=gen) * d2 ** -0.5).cuda()
bits["paged mla bf16 pages"] = digest(paged_attention(
    qm, c, c, pt.int().cuda(), torch.tensor(lanes, dtype=torch.int32).cuda(), scale=0.1, q2=q2,
    k2_pages=kr, out_dtype=torch.bfloat16))
print(root, "output SHA-256", bits, flush=True)
props = None
for line in _build.build_log.splitlines():
    if m := re.search(r"Function properties for (\w+)", line):
        props = m.group(1)
    elif props and re.search(r"flash_(bf16_)?kernel|causal_(tf32_)?kernel", props) and (
            m := re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores|Used (\d+) "
                           r"registers", line)):
        print(root, "ptxas", props[:70], line.strip()[:90])
print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                     capture_output=True, text=True).stdout.strip())
