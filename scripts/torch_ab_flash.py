"""Time the port's flash-attention kernels of one checkout on the card, for
comparing two checkouts in one call on one card (run them in turns: A, B,
B, A):

    python scripts/torch_ab_flash.py <checkout root>

Random bf16 operands laid out as the model gives them ([B, H, S, D] views of
[B, S, H, D], K and V unexpanded), causal: qwen2-1.5b's prefill_32k layer 0
(B=1, 12 heads over 2 KV heads, T=32,768, D=128) and phi3-mini's prefill
(B=2, 32 heads, T=4,096, D=96). CUDA-event ms a launch after one warm-up:
the wgmma kernel, the checkout's other bf16 route on the same operands in
turns (other, wgmma, wgmma, other) and
``F.scaled_dot_product_attention`` on K and V expanded beforehand; then
ptxas's registers and spills of the tensor-core kernel's instances. Each
checkout builds its kernels into its own build directory."""
import re
import sys

import torch
import torch.nn.functional as F

root = sys.argv[1]
sys.path.insert(0, root + "/src")
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.attention import ROUTES, flash_attention  # noqa: E402

OFF_TMA = next(r for r in ROUTES if r not in ("tensor_core", "fp32"))   # bf16 off TMA


def ms(fn, reps):
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return round(start.elapsed_time(end) / reps, 3)


gen = torch.Generator().manual_seed(0)
for label, (b, h, hkv, t, d) in (("qwen2 prefill_32k layer 0", (1, 12, 2, 32768, 128)),
                                 ("phi3 prefill 2 x 4,096 layer 0", (2, 32, 32, 4096, 96))):
    q = torch.randn(b, t, h, d, generator=gen).to("cuda", torch.bfloat16).transpose(1, 2)
    k, v = (torch.randn(b, t, hkv, d, generator=gen).to("cuda", torch.bfloat16).transpose(1, 2)
            for _ in range(2))
    kw = dict(scale=d ** -0.5, causal=True)
    tc = lambda: flash_attention(q, k, v, **kw)
    cc = lambda: flash_attention(q, k, v, **kw, route=OFF_TMA)
    kx, vx = (x.repeat_interleave(h // hkv, 1) for x in (k, v))
    turns = [ms(cc, 1), ms(tc, 5), ms(tc, 5), ms(cc, 1)]
    sdpa = ms(lambda: F.scaled_dot_product_attention(q, kx, vx, is_causal=True, scale=d ** -0.5),
              5)
    flops = 4 * d * b * h * t * (t + 1) / 2
    print(root, label, {f"{OFF_TMA}, tensor_core, tensor_core, {OFF_TMA}": turns, "sdpa": sdpa,
                        "bound two products": round(flops / 989e12 * 1e3, 3),
                        "bound with the split P": round(1.5 * flops / 989e12 * 1e3, 3)},
          flush=True)
props = None
for line in _build.build_log.splitlines():
    if m := re.search(r"Function properties for (\w+)", line):
        props = m.group(1)
    elif props and "flash_tc_kernel" in props and ("spill" in line or "Used" in line):
        print(root, "flash_tc_kernel D=" + re.search(r"kernelILi(\d+)", props).group(1),
              line.strip())
