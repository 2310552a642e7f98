"""Time the port's D=8 FLARE kernels (encode, decode, fused forward, fused
backward) of one checkout on the card, for comparing two checkouts in one
call on one card (run them in turns: A, B, B, A):

    python scripts/torch_ab_flare_kernels.py <checkout root>

Random operands at the shapes of block 0 at pde_40k (B=8, N=40,000) and
pde_1m (B=1, N=1,048,576), H=8, M=2048; CUDA-event ms a launch after one
warm-up. Each checkout builds its kernels into its own build directory."""
import sys

import torch

root = sys.argv[1]
sys.path.insert(0, root + "/src")
from repro_torch.kernels.flare import flare_decode, flare_encode  # noqa: E402
from repro_torch.kernels.flare_packed import flare_fused_bwd, flare_fused_fwd  # noqa: E402


def ms(fn, reps=10):
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
for b, h, m, n, d in ((8, 8, 2048, 40000, 8), (1, 8, 2048, 1048576, 8)):
    q = (torch.randn(h, m, d, generator=gen) * d ** -0.5).cuda()
    k, v, dy = (torch.randn(b, n, h, d, generator=gen).cuda().transpose(1, 2) for _ in range(3))
    z = flare_encode(q, k, v)
    y, *res = flare_fused_fwd(q, k, v)
    print(root, f"N={n}", {"encode": ms(lambda: flare_encode(q, k, v)),
                           "decode": ms(lambda: flare_decode(q, k, z)),
                           "fused_fwd": ms(lambda: flare_fused_fwd(q, k, v)),
                           "fused_bwd": ms(lambda: flare_fused_bwd(q, k, v, *res, y, dy), 5)},
          flush=True)
    del q, k, v, dy, z, y, res
    torch.cuda.empty_cache()
