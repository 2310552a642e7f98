"""Time the port's paged-attention and causal FLARE kernels of one checkout
on the card, for comparing two checkouts in one call on one card (run them
in turns: A, B, B, A):

    python scripts/torch_ab_paged_causal.py <checkout root>

Random operands. The paged kernel at qwen2-1.5b's decode read (8 lanes of
~2,000 tokens, 2 KV heads, 6 query rows a head, D=128, fp32 q over bf16
pages of 16 tokens) and, where the checkout takes D=96, phi3-mini's (4
lanes of ~1,000 tokens, 32 heads, one query row, D=96): device ms a call
from a CUDA graph replayed 50 times. The causal kernel at flare_lm's layer
0 (B=1, H=16, M=512, T=32,768, D=128, bf16 and fp32; the model's strided
k/v views): CUDA-event ms a call. Then ptxas's registers and spills of the
paged and causal kernels' instances."""
import re
import sys

import torch

root = sys.argv[1]
sys.path.insert(0, root + "/src")
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.flare_causal import flare_causal_chunk  # noqa: E402
from repro_torch.kernels.paged_attention import paged_attention  # noqa: E402


def graph_ms(fn, reps=50):
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    end.synchronize()
    return round(start.elapsed_time(end) / reps, 4)


gen = torch.Generator().manual_seed(0)
for label, (b, h, g, d, tokens) in (("qwen2 decode read", (8, 2, 6, 128, 2000)),
                                    ("phi3 decode read", (4, 32, 1, 96, 1000))):
    block, pages = 16, -(-tokens // 16) + 8
    q = torch.randn(b, h, g, d, generator=gen).cuda() * d ** -0.5
    k, v = (torch.randn(b * pages, block, h, d, generator=gen).to("cuda", torch.bfloat16)
            for _ in range(2))
    pt = torch.randperm(b * pages, generator=gen).int().reshape(b, pages).cuda()
    lengths = torch.full((b,), tokens, dtype=torch.int32).cuda()
    call = lambda: paged_attention(q, k, v, pt, lengths, scale=d ** -0.5,
                                   out_dtype=torch.bfloat16)
    try:
        print(root, label, graph_ms(call), "ms", flush=True)
    except ValueError as err:
        print(root, label, "not taken:", err, flush=True)


def ms(fn, reps=5):
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return round(start.elapsed_time(end) / reps, 3)


for dtype in (torch.bfloat16, torch.float32):
    q = (torch.randn(16, 512, 128, generator=gen) * 128 ** -0.5).to("cuda", dtype)
    k, v = (torch.randn(1, 32768, 16, 128, generator=gen).to("cuda", dtype).transpose(1, 2)
            for _ in range(2))
    print(root, f"causal flare_lm layer 0 {dtype}", ms(lambda: flare_causal_chunk(q, k, v)),
          "ms", flush=True)
props = None
for line in _build.build_log.splitlines():
    if m := re.search(r"Function properties for (\w+)", line):
        props = m.group(1)
    elif props and re.search(r"(paged|causal)_kernelI", props) and "spill" in line:
        print(root, re.search(r"(\w+_kernelI\w+?)EE", props).group(1), line.strip())
