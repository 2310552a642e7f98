"""Is PyTorch's SDPA a sound yardstick for the MLA read, and in which layout?

    python scripts/torch_sdpa_yardstick.py                 # every layout
    python scripts/torch_sdpa_yardstick.py --layout rows   # one

For DeepSeek-V2-Lite's and MiniCPM3-4B's MLA reads (chip_smoke's random
operands, bf16 and fp32 pages) it builds the yardstick's q = [q_abs |
q_rope], k = [latents | k_rope], v = latents and the lanes' mask in one of
three layouts: ``broadcast`` (G query heads over K and V expanded along
the heads, stride 0), ``contiguous`` (K, V and the mask copied out along
the heads) and ``rows`` (the G heads as G query rows of the one page head,
chip_smoke's yardstick). It runs SDPA with the default backend and with
each backend forced; between runs it fills 1 GiB of the caching
allocator's memory with random values and frees it, so that memory SDPA
takes without writing it holds other values each time. A line each: the
backend's error (if it refuses), whether 4 runs gave equal bits, and the
largest error against an fp64 softmax on the lanes with tokens (the trash
row's NaN keys, masked, set to 0 in the fp64 version; positions SDPA left
non-finite counted apart). With no ``--layout`` each layout runs in a
process of its own, since a fault ends its process. Then the card's name
and power limit."""
import contextlib
import math
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402
from torch.nn.attention import SDPBackend, sdpa_kernel  # noqa: E402

import chip_smoke as c  # noqa: E402
from repro_torch.kernels.ref import _gather_rows  # noqa: E402

MODELS = (("deepseek-v2-lite-16b", 16, 512, 64), ("minicpm3-4b", 40, 256, 32))
BACKENDS = {"default": None, "efficient": SDPBackend.EFFICIENT_ATTENTION,
            "cudnn": SDPBackend.CUDNN_ATTENTION, "math": SDPBackend.MATH}
RUNS = 4


def stir(dev):
    """Fill 1 GiB of cached memory with random values, then free it."""
    junk = torch.randn(1 << 28, device=dev)
    del junk


def layout(name, q, kw, pages, pt, lengths, g, d, d2):
    """(q, k, v, mask) as SDPA takes them in layout ``name``; the output's
    heads and rows as [B, G, D] through ``.reshape``."""
    b = q.shape[0]
    cd, krd = _gather_rows(pages, pt), _gather_rows(kw["k2_pages"], pt)   # [B, 1, T, *]
    t = cd.shape[2]
    qc = torch.cat([q, kw["q2"]], dim=-1).to(pages.dtype)                 # [B, 1, G, D+D2]
    kc = torch.cat([cd, krd], dim=-1)                                     # [B, 1, T, D+D2]
    mask = (torch.arange(t, device=q.device)[None, :]
            < lengths.long()[:, None])[:, None, None, :]                  # [B, 1, 1, T]
    dk = d + d2
    if name == "broadcast":
        return (qc.transpose(1, 2), kc.expand(b, g, t, dk), cd.expand(b, g, t, d), mask)
    if name == "contiguous":
        return (qc.transpose(1, 2), kc.expand(b, g, t, dk).contiguous(),
                cd.expand(b, g, t, d).contiguous(), mask.expand(b, g, 1, t).contiguous())
    return (qc, kc, cd, mask.expand(b, 1, g, t).contiguous())   # rows


LAYOUTS = ("rows", "contiguous", "broadcast")


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_sdpa_yardstick.py needs a GPU", file=sys.stderr)
        return 1
    if "--layout" not in sys.argv:
        for name in LAYOUTS:
            done = subprocess.run([sys.executable, __file__, "--layout", name])
            if done.returncode:
                print(f"layout {name}: its process exited {done.returncode}", flush=True)
        print(c.gpu_line())
        return 0
    lay = sys.argv[sys.argv.index("--layout") + 1]
    dev = torch.device("cuda", 0)
    for name, g, d, d2 in MODELS:
        scale = 1.0 / math.sqrt(128 + d2)
        gen = torch.Generator().manual_seed(c.SEED + 23)
        for page_dtype in ("bfloat16", "float32"):
            q, pages, pt, lengths, kw = c.mla_call(
                c.mla_operands(g, d, d2, page_dtype, scale, dev, gen))
            b = q.shape[0]
            ql, kl, vl, ml = layout(lay, q, kw, pages, pt, lengths, g, d, d2)
            # fp64 on the lanes with tokens; the trash row's NaN keys are masked: 0 here
            q64, k64, v64, m64 = layout("rows", q, kw, pages, pt, lengths, g, d, d2)
            s64 = (q64.double() @ torch.nan_to_num(k64.double()).transpose(-1, -2)) * scale
            want = (torch.softmax(s64.masked_fill(~m64, float("-inf")), -1)
                    @ torch.nan_to_num(v64.double())).reshape(b, g, d)
            live = lengths > 0
            for bname, backend in BACKENDS.items():
                tag = f"{name} {page_dtype} pages (q k^T over {d + d2}, v {d}) | {lay} | {bname}"
                outs = []
                try:
                    for _ in range(RUNS):
                        stir(dev)
                        with sdpa_kernel([backend]) if backend else contextlib.nullcontext():
                            y = F.scaled_dot_product_attention(ql, kl, vl, attn_mask=ml,
                                                               scale=scale)
                        torch.cuda.synchronize()
                        outs.append(y.float().reshape(b, g, d).clone())
                except RuntimeError as e:
                    print(f"{tag}: refused ({str(e).splitlines()[0][:100]})", flush=True)
                    if "illegal" in str(e):
                        return 1
                    continue
                same = all(torch.equal(torch.nan_to_num(o, nan=7.0),
                                       torch.nan_to_num(outs[0], nan=7.0)) for o in outs)
                y = outs[0][live].double()
                fin = torch.isfinite(y)
                w = want[live]
                err = ((y - w).abs() * fin).nan_to_num().max().item() / w.abs().max().item()
                print(f"{tag}: {RUNS} runs {'equal' if same else 'DIFFER'}; vs fp64 rel "
                      f"{err:.3g}, {int((~fin).sum())} of {fin.numel()} non-finite", flush=True)
            del ql, kl, vl, ml
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
