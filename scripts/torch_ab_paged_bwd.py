"""Time the port's paged-attention kernel and fused FLARE backward of one
checkout on the card, for comparing two checkouts in one call on one card
(run them in turns: A, B, B, A):

    python scripts/torch_ab_paged_bwd.py <checkout root>

Random operands from seed 0, laid out as the main paths give them. The paged
kernel at three reads: qwen2-1.5b's decode read on a layer (8 lanes of
1,800-2,200 tokens, 2 KV heads, 6 query rows a head, D=128, fp32 q over
bf16 pages of 16 tokens, bf16 out), phi3-mini's (4 lanes of 300-1,000
tokens, 32 heads, one query row, D=96, fp32 q over fp32 pages) and FLARE's
encode off pages (the ``paged`` backend at pde_40k, B=1: 8 heads, 2,048
latents, D=8, 40,000 tokens in pages of 16 with an identity table): device
ms a call from a CUDA graph replayed, beside one
``F.scaled_dot_product_attention`` over the view gathered beforehand. The
backward (``flare_fused_bwd``) at pde_40k (B=8, H=8, M=2,048, N=40,000,
D=8) and pde_1m (B=1, N=1,048,576), fp32, on the fused forward's own
residuals: CUDA-event ms a call after one warm-up. Then ptxas's registers
and spills of the two kernels' instances. Each checkout builds its kernels
into its own build directory."""
import re
import sys

import torch
import torch.nn.functional as F

root = sys.argv[1]
sys.path.insert(0, root + "/src")
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.flare_packed import flare_fused_bwd, flare_fused_fwd  # noqa: E402
from repro_torch.kernels.paged_attention import paged_attention  # noqa: E402
from repro_torch.kernels.ref import _gather_rows  # noqa: E402

torch.backends.cuda.matmul.allow_tf32 = False


def graph_ms(fn, reps):
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return event_ms(graph.replay, reps)


def event_ms(fn, reps):
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return round(start.elapsed_time(end) / reps, 4)


gen = torch.Generator().manual_seed(0)
dev = "cuda"
reads = {  # (B, H, G, D, lane lengths, pages in the table, page dtype, out dtype, shuffled)
    "qwen2 decode read": (8, 2, 6, 128, (1800, 2200), 256, torch.bfloat16, torch.bfloat16, True),
    "phi3 decode read": (4, 32, 1, 96, (300, 1000), 68, torch.float32, torch.float32, True),
    "flare encode pde_40k B=1": (1, 8, 2048, 8, (40000, 40000), 2500, torch.float32,
                                 torch.float32, False),
}
for label, (b, h, g, d, (lo, hi), pages, pdt, odt, shuffled) in reads.items():
    block = 16
    lengths = torch.randint(lo, hi + 1, (b,), generator=gen, dtype=torch.int32)
    q = torch.randn(b, h, g, d, generator=gen) * d ** -0.5
    k, v = (torch.randn(b * pages, block, h, d, generator=gen).to(pdt) for _ in range(2))
    pt = (torch.randperm(b * pages, generator=gen) if shuffled
          else torch.arange(b * pages)).int().reshape(b, pages)
    q, k, v, pt, lengths = (t.to(dev) for t in (q, k, v, pt, lengths))
    scale = d ** -0.5 if g < 2048 else 1.0
    call = lambda: paged_attention(q, k, v, pt, lengths, scale=scale, out_dtype=odt)
    kd, vd = _gather_rows(k, pt), _gather_rows(v, pt)
    mask = (torch.arange(kd.shape[2], device=dev)[None, :] < lengths.long()[:, None])
    qd = q.to(kd.dtype)
    sdpa = lambda: F.scaled_dot_product_attention(qd, kd, vd, attn_mask=mask[:, None, None, :],
                                                  scale=scale)
    reps = 20 if g >= 2048 else 200
    print(root, label, {"kernel ms": graph_ms(call, reps), "sdpa ms": graph_ms(sdpa, reps)},
          flush=True)
    del q, k, v, kd, vd

for label, (b, n) in (("bwd pde_40k", (8, 40000)), ("bwd pde_1m", (1, 1048576))):
    h, m, d = 8, 2048, 8
    q = (torch.randn(h, m, d, generator=gen) * d ** -0.5).to(dev)
    k, v, dy = (torch.randn(b, n, h, d, generator=gen).to(dev).transpose(1, 2)
                for _ in range(3))
    y, *res = flare_fused_fwd(q, k, v)
    call = lambda: flare_fused_bwd(q, k, v, *res, y, dy)
    print(root, label, {"kernel ms": event_ms(call, 5 if n < 10 ** 6 else 2)}, flush=True)
    del q, k, v, dy, y, res
    torch.cuda.empty_cache()

props = None
for line in _build.build_log.splitlines():
    if m := re.search(r"Function properties for (\w+)", line):
        props = m.group(1)
    elif props and re.search(r"(paged\w*|dz|dkv|dq)_kernel", props) and (
            "spill" in line or "Used" in line):
        print(root, re.search(r"(paged\w*|dz|dkv|dq)_kernel\w*", props).group(0)[:48],
              line.strip()[:100])
