"""Time MLA's paged read and the fp32 flash route of one checkout on the
card, and hash MLA's reads over bf16, int8 and fp8 pages, for comparing two
checkouts in one call on one card (run them in turns: A, B, B, A):

    python scripts/torch_ab_mla_fp32_flash.py <checkout root> [mla] [flash]

With no section named, both run. ``mla``: random operands from seed 0, as
chip_smoke.py's MLA phase draws them: the absorbed decode read at
DeepSeek-V2-Lite's shape (G=16 heads over one page head of latents, D=512,
D2=64) and MiniCPM3-4B's (G=40, D=256, D2=32), 8 lanes of 0, 17 and
1,985-2,048 tokens (12,091 in all) over pages of 16, a shuffled page table
whose unmapped entries point at a trash row of NaN, fp32 q and q2, the
latents both K and V. Over fp32, bf16, int8 and fp8 pages (per-row scales
for the one-byte ones): device ms a call (bf16 out) from a CUDA graph
replayed 50 times. Over fp32 pages also the error of the fp32-out call
against the plain version in fp64 over max |plain|; over the others a
SHA-256 of the fp32-out call's bytes, equal across checkouts where the bits
are. ``flash``: the fp32 flash route at qwen2-1.5b's prefill_32k layer 0
(B=1, 12 query heads over 2 KV heads, T=32,768, D=128, causal, the model's
[B, H, T, D] views of [B, T, H, D]): CUDA-event ms a call after one
warm-up, and its error against the fp64 plain version on one query head's
last 1,024 rows. Then ptxas's registers and spills of the checkout's MLA
and flash kernels that were built, and the card's name and power limit.
Each checkout builds its kernels into its own build directory."""
import hashlib
import re
import subprocess
import sys

import torch

root = sys.argv[1]
sections = set(sys.argv[2:]) or {"mla", "flash"}
sys.path.insert(0, root + "/src")
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.attention import flash_attention  # noqa: E402
from repro_torch.kernels.paged_attention import paged_attention  # noqa: E402
from repro_torch.kernels.ref import flash_attention_ref, paged_attention_ref  # noqa: E402
from repro_torch.serve.pool.quant import get_quant, quantize  # noqa: E402

LENGTHS = (0, 17, 1985, 1993, 2000, 2017, 2031, 2048)
SHAPES = {"DeepSeek-V2-Lite": (16, 512, 64), "MiniCPM3-4B": (40, 256, 32)}


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
    return round(start.elapsed_time(end) / reps, 5)


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


def sha(x):
    return hashlib.sha256(x.contiguous().view(torch.uint8).cpu().numpy().tobytes()).hexdigest()[:16]


def mla_operands(g, d, d2, page_dtype, gen):
    b, block = len(LENGTHS), 16
    pages = -(-max(LENGTHS) // block)
    nb = b * pages + 1
    lengths = torch.tensor(LENGTHS, dtype=torch.int32)
    pt = torch.randperm(nb - 1, generator=gen)[: b * pages].reshape(b, pages).int()
    for i in range(b):
        pt[i, -(-int(lengths[i]) // block):] = nb - 1
    q = torch.randn(b, 1, g, d, generator=gen) * d ** -0.5
    kw = {"q2": torch.randn(b, 1, g, d2, generator=gen) * d2 ** -0.5}
    c = torch.randn(nb, block, 1, d, generator=gen)
    kr = torch.randn(nb, block, 1, d2, generator=gen)
    if page_dtype in ("int8", "fp8"):
        spec = get_quant(page_dtype)
        (c, cs), (kr, krs) = quantize(spec, c), quantize(spec, kr)
        kw.update(k_scale=cs, v_scale=cs, k2_scale=krs)
    else:
        c, kr = c.to(getattr(torch, page_dtype)), kr.to(getattr(torch, page_dtype))
    if c.is_floating_point():
        c[nb - 1] = float("nan")
    kw["k2_pages"] = kr
    dev = lambda t: t.cuda()
    return (dev(q), dev(c), dev(pt), dev(lengths)), {key: dev(t) for key, t in kw.items()}


torch.backends.cuda.matmul.allow_tf32 = False
for label, (g, d, d2) in SHAPES.items() if "mla" in sections else ():
    gen = torch.Generator().manual_seed(0)
    for page_dtype in ("float32", "bfloat16", "int8", "fp8"):
        (q, c, pt, lengths), kw = mla_operands(g, d, d2, page_dtype, gen)
        read = lambda out: paged_attention(q, c, c, pt, lengths, scale=0.1, out_dtype=out, **kw)
        ms = graph_ms(lambda: read(torch.bfloat16))
        got = read(torch.float32)
        line = f"{root} mla read {label} {page_dtype}: {ms} ms"
        if page_dtype == "float32":
            wide = {key: t.double() if key == "q2" else t for key, t in kw.items()}
            want = paged_attention_ref(q.double(), c, c, pt, lengths, scale=0.1,
                                       out_dtype=torch.float64, **wide)
            err = ((got.double() - want).abs().max() / want.abs().max()).item()
            line += f"; error vs fp64 {err:.3g} of max |plain|; routes " \
                    f"{ {r: n for r, n in paged_attention.launches_by_route.items() if n} }"
        else:
            line += f"; sha256 {sha(got)}"
        print(line, flush=True)

if "flash" in sections:
    b, h, hkv, t, d = 1, 12, 2, 32768, 128
    gen = torch.Generator().manual_seed(0)
    q = torch.randn(b, t, h, d, generator=gen).cuda().transpose(1, 2)
    k, v = (torch.randn(b, t, hkv, d, generator=gen).cuda().transpose(1, 2) for _ in range(2))
    kw = dict(scale=d ** -0.5, causal=True)
    o = flash_attention(q, k, v, **kw)
    rows = slice(t - 1024, t)
    want = flash_attention_ref(q[:, :1, rows].double(), k[:, :1].double(), v[:, :1].double(),
                               q_offset=t - 1024, **kw)
    err = ((o[:, :1, rows].double() - want).abs().max() / want.abs().max()).item()
    ms = event_ms(lambda: flash_attention(q, k, v, **kw), 3)
    print(root, "flash fp32 qwen2 prefill_32k layer 0", ms,
          "ms; error vs fp64 (head 0, last 1,024 rows)", f"{err:.3g}", flush=True)
props = None
for line in _build.build_log.splitlines():
    if m := re.search(r"Function properties for (\w+)", line):
        props = m.group(1)
    elif (m := re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores", line)) and props \
            and ("mla" in props or "flash" in props):
        print(root, "ptxas", props[:70], f"stack {m.group(1)} B, spill {m.group(2)} B")
    elif (m := re.search(r"Used (\d+) registers(.*)", line)) and props and (
            "mla" in props or "flash" in props):
        print(root, "ptxas", props[:70], m.group(1), "regs", m.group(2)[:60])
print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                     capture_output=True, text=True).stdout.strip())
