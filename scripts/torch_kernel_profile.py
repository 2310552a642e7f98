"""Device time by kernel (torch.profiler, one warm call) of the causal FLARE
kernel at flare_lm's layer 0 (B=1, H=16, M=512, T=32,768, D=128, random
bf16, the model's strided k/v) and of the fused FLARE forward at pde_40k and
pde_1m (random fp32), on the kernels of one checkout:

    python scripts/torch_kernel_profile.py <checkout root>

It splits each call into its kernels (the causal kernel and its combine;
the encode, decode and combine), which CUDA events around the call cannot."""
import sys

root = sys.argv[1]
sys.path.insert(0, root + "/src")
import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repro_torch.kernels.flare_causal import flare_causal_chunk  # noqa: E402
from repro_torch.kernels.flare_packed import flare_fused_fwd  # noqa: E402


def kernels(fn, label):
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = [(e.key, e.device_time_total / 1e3) for e in prof.key_averages()
            if e.device_time_total > 0 and e.device_type.name == "CUDA"]
    for key, ms in sorted(rows, key=lambda r: -r[1])[:4]:
        print(root, label, f"{ms:.3f} ms", key[:70], flush=True)


gen = torch.Generator().manual_seed(0)
q = (torch.randn(16, 512, 128, generator=gen) * 128 ** -0.5).to("cuda", torch.bfloat16)
k, v = (torch.randn(1, 32768, 16, 128, generator=gen).to("cuda", torch.bfloat16).transpose(1, 2)
        for _ in range(2))
kernels(lambda: flare_causal_chunk(q, k, v), "causal")
del q, k, v
for b, n in ((8, 40000), (1, 1048576)):
    q = (torch.randn(8, 2048, 8, generator=gen) * 8 ** -0.5).cuda()
    k, v = (torch.randn(b, n, 8, 8, generator=gen).cuda().transpose(1, 2) for _ in range(2))
    kernels(lambda: flare_fused_fwd(q, k, v), f"fused_fwd N={n}")
    del q, k, v
