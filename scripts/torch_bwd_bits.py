"""The fused FLARE backward of one checkout on fixed operands and residuals
(the plain forward's, the same for every checkout), saved for a bitwise
comparison of checkouts on the card:

    python scripts/torch_bwd_bits.py <checkout root> <out.pt>
    python scripts/torch_bwd_bits.py --compare <a.pt> <b.pt>

Shapes: pde_40k (B=8, N=40,000), pde_1m (B=1, N=1,048,576), both H=8,
M=2048, D=8, and a widened D=12; the comparison prints, per shape, whether
dq, dk and dv are equal bit for bit."""
import sys

import torch

if sys.argv[1] == "--compare":
    a, b = torch.load(sys.argv[2]), torch.load(sys.argv[3])
    for key in a:
        print("backward bits", key, [torch.equal(x, y) for x, y in zip(a[key], b[key])])
    sys.exit(0)

root, out = sys.argv[1], sys.argv[2]
sys.path.insert(0, root + "/src")
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels.flare_packed import flare_fused_bwd  # noqa: E402

res = {}
gen = torch.Generator().manual_seed(7)
for b, h, m, n, d in ((8, 8, 2048, 40000, 8), (1, 8, 2048, 1048576, 8), (2, 3, 40, 700, 12)):
    q = (torch.randn(h, m, d, generator=gen) * d ** -0.5).cuda()
    k, v, dy = (torch.randn(b, n, h, d, generator=gen).cuda().transpose(1, 2) for _ in range(3))
    outs = [ref.flare_fused_fwd_ref(q[i:i + 1], k[:, i:i + 1], v[:, i:i + 1]) for i in range(h)]
    y, z, mx, den, lse = (torch.cat(t, dim=1).contiguous() for t in zip(*outs))
    y = y.transpose(1, 2).contiguous().transpose(1, 2)   # the model's [B, N, H, D] layout
    res[f"{b}x{n}x{d}"] = [t.cpu() for t in flare_fused_bwd(q, k, v, z, mx, den, lse, y, dy)]
torch.save(res, out)
print(root, "saved", list(res))
