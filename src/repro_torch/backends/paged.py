"""``paged`` backend: the FLARE mixer with its encode run by the
paged-attention kernel (``kernels/paged_attention.py``).

Counterpart of ``repro/backends/paged.py``. FLARE's encode, M latent
queries attending over the N tokens, is the paged kernel's G = M case, so
the kernel that serves the slot pool's gqa decode reads also runs the mixer
off block storage. A dense call site pages its K/V on the fly
(:func:`pack_pages`, an identity page table). The decode, a softmax over
the M latents per token, stays plain torch. Forward-only, bidirectional.
The kernel's launch runs inside ``scope("kernels.paged_attention")``, which
its wrapper opens for every caller (the reference opens it here).

Its score is 40 at ``latents == 1``, the decode-read signature only the
serving engine's plan resolution produces, so "auto" routes the paged
pool's decode through the kernel; at M > 1 it scores below every dense
backend, so dense call sites never land on it unless they name it. The
slot-sharded ``paged_shard`` is not ported yet.
"""
from __future__ import annotations

import torch

from repro_torch.core.dispatch import Capabilities, MixerBackend, MixerPlan, MixerShape, register
from repro_torch.kernels.paged_attention import HEAD_DIMS

DEFAULT_BLOCK = 16


def _plan(shape: MixerShape, mesh, dtype, device) -> MixerPlan:
    return MixerPlan("paged", {"block": min(DEFAULT_BLOCK, shape.tokens)})


def pack_pages(x: torch.Tensor, block: int):
    """[B, H, N, D] -> ([B*P, block, H, D] contiguous pages, [B, P] int32
    identity page table), N zero-padded to P*block."""
    b, h, n, d = x.shape
    p = -(-n // block)
    xt = x.transpose(1, 2)                                   # [B, N, H, D]
    if p * block != n:
        xt = torch.nn.functional.pad(xt, (0, 0, 0, 0, 0, p * block - n))
    pages = xt.reshape(b * p, block, h, d).contiguous()
    pt = torch.arange(b * p, dtype=torch.int32, device=x.device).reshape(b, p)
    return pages, pt


def _run(plan: MixerPlan, q, k, v):
    from repro_torch.kernels.paged_attention import paged_attention

    b, h, n, d = k.shape
    m = q.shape[1]
    block = plan.params.get("block", DEFAULT_BLOCK)
    kp, pt = pack_pages(k, block)
    vp, _ = pack_pages(v, block)
    lengths = torch.full((b,), n, dtype=torch.int32, device=k.device)
    qb = q.to(k.dtype)[None].expand(b, h, m, d).contiguous()
    z = paged_attention(qb, kp, vp, pt, lengths, scale=1.0)   # [B, H, M, D] in k's dtype
    # decode: per-token softmax over the M latents (paper Fig. 3, 2nd SDPA)
    s = torch.einsum("hmd,bhnd->bhmn", q.float(), k.float())
    w = torch.softmax(s, dim=2)
    return torch.einsum("bhmn,bhmd->bhnd", w.to(z.dtype), z).to(v.dtype)


def _score(shape: MixerShape, device: str) -> float:
    return 40.0 if shape.latents == 1 else 0.5


register(MixerBackend(
    name="paged",
    caps=Capabilities(bidirectional=True, causal=False, device_kinds=("cpu", "cuda"),
                      dtypes=("float32", "bfloat16"), grads=False, head_dims=HEAD_DIMS),
    plan=_plan,
    run=_run,
    score=_score,
    doc="FLARE encode via the paged-attention kernel (the serving pool's decode read)",
))
