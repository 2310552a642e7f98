"""GQA attention (RoPE / M-RoPE, QKV bias, sliding window) and MLA
(DeepSeek-V2's multi-head latent attention): the train and prefill forward,
single-token decode against a cache, and the prefix cache's continuation.

Counterpart of ``repro/models/attention.py``: ``gqa_*`` over a
:class:`KVCache`, ``mla_*`` over an :class:`MLACache` of compressed latents
(``mla_decode`` runs attention in the latent space, the absorbed form, and
reads a paged pool through the paged-attention kernel, the latents both its
K and V and the rotary key its second score term).

``attn_sdpa`` is written op for op as the JAX package's XLA paths: the score
einsum in the operands' dtype, then the cast to fp32, then ``* scale``, then
the ``-inf`` bias or mask, then the softmax, then the value einsum in v's
dtype. It does not call ``F.scaled_dot_product_attention``: the greedy-parity
contracts of the serving engine rest on this staging. ``impl="pallas"`` runs
the flash kernel (``kernels/ops.py::flash_attention``, the port of
``repro/kernels/attention.py``; its plain version on CPU tensors), which takes
no ``q_offset``: the JAX package's pallas route drops a ``q_offset`` silently,
and this one raises. ``gqa_forward`` passes ``impl`` through, and so do the
LM's forward and prefill (``models/transformer.py``); on the ``"pallas"``
route it hands the kernel the KV heads unexpanded (the JAX package expands
them on every route; the ``xla`` and ``chunked`` routes still do).

Decode (``gqa_cache_attend``) has two routes:
  - a dense ``[B, Hkv, cap, D]`` cache: the new row is written at each slot's
    ring position **in place** (the JAX package returns a new array), then
    an fp32 masked softmax over the capacity;
  - a :class:`repro_torch.serve.pool.views.PagedTokenView` (the serving
    pool's kernel route): the row is appended into block storage and the
    read runs the paged-attention kernel over the mapped pages, never
    gathering a dense view.
Both compute an fp32 dot, then ``* scale``, then the mask, then an fp32
softmax and value reduction, then the cast: the order that keeps the routes
token-exact under greedy decode. Sliding-window decode keeps a ring buffer
of ``window`` rows.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
from torch import nn

from repro_torch.config import AttnConfig
from repro_torch.models.rope import apply_rope, mrope_angles, rope_angles
from repro_torch.nn.modules import RMSNorm, dense, init_dense, init_rmsnorm, rmsnorm

# ---------------------------------------------------------------------------
# SDPA
# ---------------------------------------------------------------------------


def _causal_window_bias(sq: int, skv: int, *, causal: bool, window: Optional[int],
                        q_offset: int = 0, device=None) -> Optional[torch.Tensor]:
    """Additive fp32 bias [sq, skv] of 0 and -inf."""
    if not causal and window is None:
        return None
    qi = torch.arange(sq, device=device)[:, None] + q_offset
    ki = torch.arange(skv, device=device)[None, :]
    ok = torch.ones(sq, skv, dtype=torch.bool, device=device)
    if causal:
        ok &= ki <= qi
    if window is not None:
        ok &= ki > qi - window
    return torch.zeros(sq, skv, device=device).masked_fill(~ok, -torch.inf)


def attn_sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, scale: float,
              causal: bool = True, window: Optional[int] = None, q_offset: int = 0,
              impl: str = "auto", chunk: int = 512) -> torch.Tensor:
    """q [B, H, Sq, D], k/v [B, H, Skv, D] -> [B, H, Sq, Dv] in v's dtype.
    ``impl``: "xla" (materialised scores), "chunked" (query blocks of
    ``chunk`` with an online softmax), "pallas" (the flash kernel; no
    ``q_offset``; k/v may have Hkv | H heads, read unexpanded), "auto"
    (chunked when both lengths exceed 2048)."""
    sq, skv = q.shape[-2], k.shape[-2]
    if impl == "auto":
        impl = "chunked" if (sq > 2048 and skv > 2048) else "xla"
    if impl == "pallas":
        if q_offset:
            raise ValueError(f"attn_sdpa(impl='pallas'): the flash kernel's causal mask is "
                             f"top-left aligned and takes no q_offset (got {q_offset}); use "
                             "impl='xla' or 'chunked'")
        from repro_torch.kernels.ops import flash_attention

        return flash_attention(q, k, v, scale=scale, causal=causal, window=window)
    if impl == "xla":
        scores = torch.einsum("bhsd,bhtd->bhst", q, k).float() * scale
        bias = _causal_window_bias(sq, skv, causal=causal, window=window, q_offset=q_offset,
                                   device=q.device)
        if bias is not None:
            scores = scores + bias
        w = torch.softmax(scores, dim=-1)
        return torch.einsum("bhst,bhtd->bhsd", w.to(v.dtype), v)
    if impl == "chunked":
        return _chunked_attention(q, k, v, scale=scale, causal=causal, window=window,
                                  q_offset=q_offset, chunk=chunk)
    raise ValueError(f"unknown attention impl {impl!r}")


def _chunked_attention(q, k, v, *, scale, causal, window, q_offset, chunk):
    """Query blocks of ``chunk`` rows, each against the whole K/V: the
    [chunk, Skv] score tile is the only large intermediate alive (the JAX
    package's ``lax.scan`` over blocks, as a loop; the last block ragged)."""
    sq, skv = q.shape[-2], k.shape[-2]
    kv_idx = torch.arange(skv, device=q.device)[None, :]
    outs = []
    for q0 in range(0, sq, chunk):
        qblk = q[:, :, q0:q0 + chunk]
        scores = torch.einsum("bhsd,bhtd->bhst", qblk, k).float() * scale
        q_idx = torch.arange(q0, q0 + qblk.shape[2], device=q.device)[:, None] + q_offset
        ok = torch.ones(qblk.shape[2], skv, dtype=torch.bool, device=q.device)
        if causal:
            ok &= kv_idx <= q_idx
        if window is not None:
            ok &= kv_idx > q_idx - window
        scores = scores.masked_fill(~ok, -torch.inf)
        m = scores.amax(dim=-1, keepdim=True).clamp_min(-1e30)   # fully masked rows
        e = torch.exp(scores - m)
        num = torch.einsum("bhst,bhtd->bhsd", e.to(v.dtype), v)
        den = e.sum(dim=-1, keepdim=True).to(v.dtype)
        outs.append(num / den.clamp_min(1e-30))
    return torch.cat(outs, dim=2)


# ---------------------------------------------------------------------------
# GQA
# ---------------------------------------------------------------------------


class KVCache(NamedTuple):
    k: torch.Tensor        # [B, Hkv, S_cap, D] (ring buffer when windowed)
    v: torch.Tensor        # [B, Hkv, S_cap, D]
    length: torch.Tensor   # [B] int32: tokens seen so far, per sequence slot


def init_kv_cache(batch: int, cfg: AttnConfig, capacity: int, device=None) -> KVCache:
    """A zero bf16 cache (bf16 whatever the compute dtype, as the JAX
    package keeps it) of ``capacity`` rows, ``min(capacity, window)`` when
    windowed."""
    cap = capacity if cfg.sliding_window is None else min(capacity, cfg.sliding_window)
    shape = (batch, cfg.num_kv_heads, cap, cfg.head_dim)
    return KVCache(torch.zeros(shape, dtype=torch.bfloat16, device=device),
                   torch.zeros(shape, dtype=torch.bfloat16, device=device),
                   torch.zeros(batch, dtype=torch.int32, device=device))


def _per_slot(length: torch.Tensor, batch: int) -> torch.Tensor:
    """A cache length leaf as per-slot [B] (a scalar broadcasts)."""
    return length.expand(batch) if length.dim() == 0 else length


def decode_valid_mask(new_len: torch.Tensor, cap: int) -> torch.Tensor:
    """[B] lengths -> [B, 1, 1, cap] bool: the cache rows visible to this
    decode step (index < min(length, cap), per slot). It also makes paged
    reads exact: rows gathered from unwritten or unmapped pages all sit at
    indices >= length."""
    idx = torch.arange(cap, device=new_len.device)
    return idx[None, None, None, :] < new_len.clamp_max(cap)[:, None, None, None]


class GQA(nn.Module):
    """Parameters ``wq``, ``wk``, ``wv`` (with bias when ``qkv_bias``) and
    ``wo``, as the JAX tree's ``attn``."""

    def __init__(self, wq: nn.Linear, wk: nn.Linear, wv: nn.Linear, wo: nn.Linear):
        super().__init__()
        self.wq, self.wk, self.wv, self.wo = wq, wk, wv, wo


def init_gqa(cfg: AttnConfig, d_model: int, *, generator: torch.Generator, device=None,
             dtype=torch.float32) -> GQA:
    mk = lambda i, o, bias: init_dense(i, o, generator=generator, use_bias=bias,
                                       device=device, dtype=dtype)
    return GQA(mk(d_model, cfg.q_dim, cfg.qkv_bias), mk(d_model, cfg.kv_dim, cfg.qkv_bias),
               mk(d_model, cfg.kv_dim, cfg.qkv_bias), mk(cfg.q_dim, d_model, False))


def _heads(x: torch.Tensor, n: int) -> torch.Tensor:   # [B, S, n*D] -> [B, n, S, D]
    b, s, _ = x.shape
    return x.reshape(b, s, n, -1).transpose(1, 2)


def _unheads(x: torch.Tensor) -> torch.Tensor:         # [B, n, S, D] -> [B, S, n*D]
    b, n, s, d = x.shape
    return x.transpose(1, 2).reshape(b, s, n * d)


def _expand_kv(k: torch.Tensor, groups: int) -> torch.Tensor:
    """[B, Hkv, S, D] -> [B, Hkv*groups, S, D] by repeat (GQA group expand)."""
    if groups == 1:
        return k
    b, hkv, s, d = k.shape
    return k[:, :, None].expand(b, hkv, groups, s, d).reshape(b, hkv * groups, s, d)


def _angles(cfg: AttnConfig, positions: torch.Tensor) -> torch.Tensor:
    if cfg.mrope_sections is not None:
        return mrope_angles(positions, cfg.head_dim, cfg.rope_theta, cfg.mrope_sections)
    return rope_angles(positions, cfg.head_dim, cfg.rope_theta)


def _qkv(attn: GQA, x: torch.Tensor, cfg: AttnConfig, positions: torch.Tensor):
    """Projected, split-head, rope'd q [B, H, S, D] and k, and v [B, Hkv, S, D]."""
    q = _heads(dense(attn.wq, x), cfg.num_heads)
    k = _heads(dense(attn.wk, x), cfg.num_kv_heads)
    v = _heads(dense(attn.wv, x), cfg.num_kv_heads)
    ang = _angles(cfg, positions)
    return apply_rope(q, ang), apply_rope(k, ang), v


def gqa_forward(attn: GQA, x: torch.Tensor, cfg: AttnConfig, *, positions: torch.Tensor,
                causal: bool = True, impl: str = "auto", return_kv: bool = False):
    """Train / prefill path: x [B, S, C], positions [B, S] (or [3, B, S] for
    M-RoPE) -> y [B, S, C] (and the rope'd k, v [B, Hkv, S, D]), through
    ``attn_sdpa``'s ``impl`` route."""
    q, k, v = _qkv(attn, x, cfg, positions)
    groups = cfg.num_heads // cfg.num_kv_heads
    # the flash kernel reads each KV head for its query heads: no expanded copy
    kx, vx = (k, v) if impl == "pallas" else (_expand_kv(k, groups), _expand_kv(v, groups))
    out = attn_sdpa(q, kx, vx, scale=1.0 / math.sqrt(cfg.head_dim), causal=causal,
                    window=cfg.sliding_window, impl=impl)
    y = dense(attn.wo, _unheads(out))
    return (y, (k, v)) if return_kv else y


def gqa_cache_attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, cache: KVCache, *,
                     groups: int, head_dim: int):
    """Append the new token's rope'd k/v [B, Hkv, 1, D] to the cache and
    attend q [B, H, 1, D] over the valid prefix -> (out [B, H, 1, D] in q's
    dtype, the cache one token longer). A ``PagedTokenView`` cache takes the
    kernel route; a dense cache is written in place."""
    from repro_torch.serve.pool.views import PagedTokenView

    b = q.shape[0]
    new_len = _per_slot(cache.length, b) + 1
    scale = 1.0 / math.sqrt(head_dim)

    if isinstance(cache.k, PagedTokenView):
        from repro_torch.kernels.paged_attention import paged_attention

        kview = cache.k.append(k[:, :, 0])    # [B, Hkv, D] row
        vview = cache.v.append(v[:, :, 0])
        k_pages, k_scale = kview.pages()
        v_pages, v_scale = vview.pages()
        hkv = k_pages.shape[2]
        qk = q[:, :, 0].reshape(b, hkv, groups, head_dim).float()
        out = paged_attention(qk, k_pages, v_pages, kview.pt, new_len.to(torch.int32),
                              scale=scale, k_scale=k_scale, v_scale=v_scale, out_dtype=q.dtype)
        return out.reshape(b, hkv * groups, head_dim)[:, :, None, :], KVCache(kview, vview, new_len)

    ck, cv = cache.k, cache.v
    cap = ck.shape[2]
    slot = (new_len - 1).remainder(cap).long()     # ring position (== length unwindowed)
    rows = torch.arange(b, device=ck.device)
    ck[rows, :, slot] = k[:, :, 0].to(ck.dtype)
    cv[rows, :, slot] = v[:, :, 0].to(cv.dtype)
    # q grouped per KV head, [B, Hkv, G, D]: the expanded [B, H, cap, D]
    # cache of the JAX package never materialises; the scores are the same dots
    hkv = ck.shape[1]
    qg = q[:, :, 0].reshape(b, hkv, groups, head_dim).float()
    scores = torch.einsum("bkgd,bktd->bkgt", qg, ck.float()).float() * scale   # f32, then scale
    scores = scores.masked_fill(~decode_valid_mask(new_len, cap), -torch.inf)
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgt,bktd->bkgd", w, cv.float()).to(q.dtype)
    return out.reshape(b, hkv * groups, 1, head_dim), KVCache(ck, cv, new_len)


def gqa_decode(attn: GQA, x: torch.Tensor, cfg: AttnConfig, cache: KVCache, *,
               positions: torch.Tensor):
    """Single-token decode: x [B, 1, C], positions [B, 1] (or [3, B, 1]) ->
    (y [B, 1, C], cache)."""
    q, k, v = _qkv(attn, x, cfg, positions)
    groups = cfg.num_heads // cfg.num_kv_heads
    out, cache = gqa_cache_attend(q, k, v, cache, groups=groups, head_dim=cfg.head_dim)
    return dense(attn.wo, _unheads(out)), cache


def prefill_kv_cache(k: torch.Tensor, v: torch.Tensor, cfg: AttnConfig, capacity: int,
                     lengths: Optional[torch.Tensor] = None) -> KVCache:
    """Pack prefill K/V [B, Hkv, S, D] into a fresh bf16 cache of
    ``capacity`` rows (``min(capacity, window)`` when windowed).
    ``lengths`` [B]: the true prompt lengths of a right-padded bucket; the
    rows past a sequence's length are garbage behind the decode mask. When
    S exceeds the capacity, each row keeps its last ``cap`` real tokens."""
    b, hkv, s, d = k.shape
    cap = capacity if cfg.sliding_window is None else min(capacity, cfg.sliding_window)
    length = (torch.full((b,), s, dtype=torch.int32, device=k.device) if lengths is None
              else lengths.to(torch.int32))
    bf16 = torch.bfloat16
    if s >= cap:
        if lengths is None:
            return KVCache(k[:, :, s - cap:].to(bf16).contiguous(),
                           v[:, :, s - cap:].to(bf16).contiguous(), length)
        start = (length.long() - cap).clamp(0, s - cap)
        idx = (start[:, None] + torch.arange(cap, device=k.device)[None, :])   # [B, cap]
        idx = idx[:, None, :, None].expand(b, hkv, cap, d)
        return KVCache(torch.gather(k, 2, idx).to(bf16), torch.gather(v, 2, idx).to(bf16),
                       length)
    pad = (0, 0, 0, cap - s)
    return KVCache(torch.nn.functional.pad(k, pad).to(bf16),
                   torch.nn.functional.pad(v, pad).to(bf16), length)


def gqa_extend(attn: GQA, x: torch.Tensor, cfg: AttnConfig, cache: KVCache, *,
               positions: torch.Tensor, offsets: torch.Tensor, lengths: torch.Tensor):
    """Width-S prefill continuation of an existing cache (the prefix cache's
    suffix path): x [B, S, C] the right-padded suffix, positions [B, S] (or
    [3, B, S]) absolute, ``offsets`` [B] the tokens already in the cache,
    ``lengths`` [B] the true suffix lengths. The suffix's rope'd K/V rows go
    into the cache at ``offsets + i`` (in place) and each suffix query
    attends causally over prefix and suffix -> (y [B, S, C], the cache at
    ``offsets + lengths``).

    The scores follow :func:`attn_sdpa`'s ``xla`` route op for op (the score
    product in the operands' dtype, the cast to fp32, ``* scale``, the
    ``-inf`` mask, the softmax, the cast to the cache's dtype, the value
    product), never SDPA or the flash kernel: a hit's greedy tokens equal a
    cold prefill's only when every reduction is staged as the prefill's
    (the masked keys add exact zeros, so the capacity-wide axis rounds as
    the bucket-wide one). Rows past ``lengths`` are bucket padding: the
    engine's masked scatter drops their cache rows, and no real query
    reaches them. Unwindowed caches only: a ring buffer's prefix rows do not
    stay at their positions."""
    q, k, v = _qkv(attn, x, cfg, positions)
    b, s = x.shape[:2]
    ck, cv = cache.k, cache.v
    cap = ck.shape[2]
    pos = offsets.long()[:, None] + torch.arange(s, device=x.device)[None, :]   # [B, S]
    rows = torch.arange(b, device=x.device)[:, None]
    # advanced indices around the head axis put [B, S] first: rows as [B, S, Hkv, D]
    ck[rows, :, pos] = k.transpose(1, 2).to(ck.dtype)
    cv[rows, :, pos] = v.transpose(1, 2).to(cv.dtype)
    groups = cfg.num_heads // cfg.num_kv_heads
    kk, vv = _expand_kv(ck, groups), _expand_kv(cv, groups)
    dt = torch.promote_types(q.dtype, kk.dtype)   # jnp.einsum's promotion of mixed operands
    scores = torch.einsum("bhsd,bhtd->bhst", q.to(dt), kk.to(dt)).float()
    scores = scores * (1.0 / math.sqrt(cfg.head_dim))
    ti = torch.arange(cap, device=x.device)[None, None, None, :]
    scores = scores.masked_fill(ti > pos[:, None, :, None], -torch.inf)
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhst,bhtd->bhsd", w.to(vv.dtype), vv)
    y = dense(attn.wo, _unheads(out))
    return y, KVCache(ck, cv, offsets.to(torch.int32) + lengths.to(torch.int32))


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V2 multi-head latent attention)
# ---------------------------------------------------------------------------


class MLACache(NamedTuple):
    c_kv: torch.Tensor     # [B, S_cap, kv_lora_rank] compressed latents
    k_rope: torch.Tensor   # [B, S_cap, qk_rope_head_dim] the shared rotary key
    length: torch.Tensor   # [B] int32: tokens seen so far, per sequence slot


def init_mla_cache(batch: int, cfg: AttnConfig, capacity: int, device=None) -> MLACache:
    """A zero bf16 latent cache of ``capacity`` rows (bf16 whatever the
    compute dtype, as the JAX package keeps it)."""
    m = cfg.mla
    zeros = lambda d: torch.zeros(batch, capacity, d, dtype=torch.bfloat16, device=device)
    return MLACache(zeros(m.kv_lora_rank), zeros(m.qk_rope_head_dim),
                    torch.zeros(batch, dtype=torch.int32, device=device))


class MLA(nn.Module):
    """Parameters ``w_dkv``, ``kv_norm``, ``w_kr``, ``w_uk``, ``w_uv``,
    ``w_o``, and the queries' ``w_dq``, ``q_norm``, ``w_uq`` (q-LoRA) or
    ``w_q`` (full rank), as the JAX tree's ``attn``."""

    def __init__(self, w_dkv: nn.Linear, kv_norm: RMSNorm, w_kr: nn.Linear, w_uk: nn.Linear,
                 w_uv: nn.Linear, w_o: nn.Linear, queries: dict):
        super().__init__()
        self.w_dkv, self.kv_norm, self.w_kr = w_dkv, kv_norm, w_kr
        self.w_uk, self.w_uv, self.w_o = w_uk, w_uv, w_o
        for name, module in queries.items():
            setattr(self, name, module)


def init_mla(cfg: AttnConfig, d_model: int, *, generator: torch.Generator, device=None,
             dtype=torch.float32) -> MLA:
    m, h = cfg.mla, cfg.num_heads
    qk_dim = m.qk_nope_head_dim + m.qk_rope_head_dim
    mk = lambda i, o: init_dense(i, o, generator=generator, device=device, dtype=dtype)
    w_dkv = mk(d_model, m.kv_lora_rank)
    kv_norm = init_rmsnorm(m.kv_lora_rank, device=device, dtype=dtype)
    w_kr = mk(d_model, m.qk_rope_head_dim)
    w_uk = mk(m.kv_lora_rank, h * m.qk_nope_head_dim)
    w_uv = mk(m.kv_lora_rank, h * m.v_head_dim)
    w_o = mk(h * m.v_head_dim, d_model)
    if m.q_lora_rank:
        queries = {"w_dq": mk(d_model, m.q_lora_rank),
                   "q_norm": init_rmsnorm(m.q_lora_rank, device=device, dtype=dtype),
                   "w_uq": mk(m.q_lora_rank, h * qk_dim)}
    else:
        queries = {"w_q": mk(d_model, h * qk_dim)}
    return MLA(w_dkv, kv_norm, w_kr, w_uk, w_uv, w_o, queries)


def _mla_queries(attn: MLA, x: torch.Tensor, cfg: AttnConfig, positions: torch.Tensor):
    """(q_nope, rope'd q_rope), each [B, H, S, *]. The q-LoRA norm takes
    ``rmsnorm``'s default eps (1e-6), as the JAX package's does, not the
    layers' ``norm_eps``."""
    m = cfg.mla
    if m.q_lora_rank:
        q = dense(attn.w_uq, rmsnorm(attn.q_norm, dense(attn.w_dq, x)))
    else:
        q = dense(attn.w_q, x)
    q_nope, q_rope = _heads(q, cfg.num_heads).split([m.qk_nope_head_dim, m.qk_rope_head_dim],
                                                    dim=-1)
    return q_nope, apply_rope(q_rope, rope_angles(positions, m.qk_rope_head_dim,
                                                  cfg.rope_theta))


def _mla_latents(attn: MLA, x: torch.Tensor, cfg: AttnConfig, positions: torch.Tensor):
    """The new tokens' latents c [B, S, r] (``kv_norm`` at eps 1e-6, as in
    the JAX package) and rope'd shared key [B, S, rope]."""
    m = cfg.mla
    c = rmsnorm(attn.kv_norm, dense(attn.w_dkv, x))
    kr = apply_rope(dense(attn.w_kr, x), rope_angles(positions, m.qk_rope_head_dim,
                                                      cfg.rope_theta))
    return c, kr


def _mla_scale(cfg: AttnConfig) -> float:
    return 1.0 / math.sqrt(cfg.mla.qk_nope_head_dim + cfg.mla.qk_rope_head_dim)


def _mla_kv(attn: MLA, c: torch.Tensor, kr: torch.Tensor, cfg: AttnConfig):
    """Per-head k [B, H, T, nope + rope] (the shared rotary key broadcast
    over the heads) and v [B, H, T, v_dim], decompressed from latents."""
    h = cfg.num_heads
    k_nope = _heads(dense(attn.w_uk, c), h)
    v = _heads(dense(attn.w_uv, c), h)
    b, _, t, _ = k_nope.shape
    return torch.cat([k_nope, kr[:, None].expand(b, h, t, kr.shape[-1])], dim=-1), v


def mla_forward(attn: MLA, x: torch.Tensor, cfg: AttnConfig, *, positions: torch.Tensor,
                causal: bool = True, impl: str = "auto", return_kv: bool = False):
    """Train / prefill path: per-head K/V decompressed from the latents,
    attended through ``attn_sdpa``'s ``impl`` route -> y [B, S, C] (and the
    latents c [B, S, r] and rope'd shared key [B, S, rope], what serving
    caches). The q/k head dim (nope + rope) differs from v's, which the
    flash kernel does not take: "auto" picks xla or chunked."""
    q_nope, q_rope = _mla_queries(attn, x, cfg, positions)
    c, kr = _mla_latents(attn, x, cfg, positions)
    k, v = _mla_kv(attn, c, kr, cfg)
    out = attn_sdpa(torch.cat([q_nope, q_rope], dim=-1), k, v, scale=_mla_scale(cfg),
                    causal=causal, window=None, impl=impl)
    y = dense(attn.w_o, _unheads(out))
    return (y, (c, kr)) if return_kv else y


def mla_decode(attn: MLA, x: torch.Tensor, cfg: AttnConfig, cache: MLACache, *,
               positions: torch.Tensor):
    """Absorbed single-token decode in the latent space: x [B, 1, C] ->
    (y [B, 1, C], cache). ``W_uk`` folds into the query (q_abs [B, H, 1, r]),
    score_t = q_abs . c_t + q_rope . k_rope_t, the context is a latent
    (sum_t w_t c_t) and ``W_uv`` folds in on the way out, so a step reads
    (r + rope) values a cached token. The JAX kernels ``[r, H*d]`` reshape to
    ``[r, H, d]``; an ``nn.Linear`` weight ``[H*d, r]`` to ``[H, d, r]``.

    A ``PagedTokenView`` cache takes the kernel route: the latents are both
    K and V of the paged-attention kernel (one page head, G = the heads),
    the rotary score its second term (q2 / k2). A dense cache is written in
    place and read by the fp32 formulation of the kernel route."""
    from repro_torch.serve.pool.views import PagedTokenView

    m, h = cfg.mla, cfg.num_heads
    b = x.shape[0]
    q_nope, q_rope = _mla_queries(attn, x, cfg, positions)           # [B, H, 1, *]
    w_uk = attn.w_uk.weight.to(x.dtype).reshape(h, m.qk_nope_head_dim, m.kv_lora_rank)
    q_abs = torch.einsum("bhsd,hdr->bhsr", q_nope, w_uk)
    c_new, kr_new = _mla_latents(attn, x, cfg, positions)            # [B, 1, *]
    new_len = _per_slot(cache.length, b) + 1
    scale = _mla_scale(cfg)

    if isinstance(cache.c_kv, PagedTokenView):
        from repro_torch.kernels.paged_attention import paged_attention

        cview = cache.c_kv.append(c_new[:, 0])       # [B, r] row
        krview = cache.k_rope.append(kr_new[:, 0])
        c_pages, c_scale = cview.pages()
        kr_pages, kr_scale = krview.pages()
        qa = q_abs[:, :, 0][:, None].float().contiguous()   # [B, 1, H, r]
        qr = q_rope[:, :, 0][:, None].float().contiguous()  # [B, 1, H, rope]
        ctx = paged_attention(qa, c_pages, c_pages, cview.pt, new_len.to(torch.int32),
                              scale=scale, k_scale=c_scale, v_scale=c_scale, q2=qr,
                              k2_pages=kr_pages, k2_scale=kr_scale, out_dtype=x.dtype)
        ctx = ctx[:, 0][:, :, None, :]               # [B, H, 1, r] latent context
        new_cache = MLACache(cview, krview, new_len)
    else:
        c_all, kr_all = cache.c_kv, cache.k_rope
        cap = c_all.shape[1]
        slot = (new_len - 1).remainder(cap).long()
        rows = torch.arange(b, device=x.device)
        c_all[rows, slot] = c_new[:, 0].to(c_all.dtype)
        kr_all[rows, slot] = kr_new[:, 0].to(kr_all.dtype)
        c32 = c_all.float()
        s_nope = torch.einsum("bhsr,btr->bhst", q_abs.float(), c32)
        s_rope = torch.einsum("bhsd,btd->bhst", q_rope.float(), kr_all.float())
        # flarecheck: disable=DS003 -- f32 operands (.float()); the rule sees only astype casts
        scores = (s_nope + s_rope) * scale
        scores = scores.masked_fill(~decode_valid_mask(new_len, cap), -torch.inf)
        w = torch.softmax(scores, dim=-1)
        ctx = torch.einsum("bhst,btr->bhsr", w, c32).to(x.dtype)
        new_cache = MLACache(c_all, kr_all, new_len)
    w_uv = attn.w_uv.weight.to(x.dtype).reshape(h, m.v_head_dim, m.kv_lora_rank)
    out = torch.einsum("bhsr,hdr->bhsd", ctx, w_uv)
    return dense(attn.w_o, _unheads(out)), new_cache


def mla_extend(attn: MLA, x: torch.Tensor, cfg: AttnConfig, cache: MLACache, *,
               positions: torch.Tensor, offsets: torch.Tensor, lengths: torch.Tensor):
    """Width-S prefill continuation of a latent cache (the prefix cache's
    suffix path; the contract of :func:`gqa_extend`): the suffix's latents
    go into the cache at ``offsets + i`` (in place), then, as
    :func:`mla_forward` does and not in the absorbed form, per-head K/V are
    decompressed from the whole cache and attended with ``attn_sdpa``'s
    ``xla`` staging (the score product in the operands' promoted dtype, the
    cast to fp32, ``* scale``, the mask, the softmax, the cast to v's dtype,
    the value product) -> (y [B, S, C], the cache at ``offsets + lengths``)."""
    q_nope, q_rope = _mla_queries(attn, x, cfg, positions)
    c_new, kr_new = _mla_latents(attn, x, cfg, positions)
    b, s = x.shape[:2]
    c_all, kr_all = cache.c_kv, cache.k_rope
    cap = c_all.shape[1]
    pos = offsets.long()[:, None] + torch.arange(s, device=x.device)[None, :]   # [B, S]
    rows = torch.arange(b, device=x.device)[:, None]
    c_all[rows, pos] = c_new.to(c_all.dtype)
    kr_all[rows, pos] = kr_new.to(kr_all.dtype)
    k, v = _mla_kv(attn, c_all, kr_all, cfg)
    q = torch.cat([q_nope, q_rope], dim=-1)
    dt = torch.promote_types(q.dtype, k.dtype)   # jnp.einsum's promotion of mixed operands
    scores = torch.einsum("bhsd,bhtd->bhst", q.to(dt), k.to(dt)).float() * _mla_scale(cfg)
    ti = torch.arange(cap, device=x.device)[None, None, None, :]
    scores = scores.masked_fill(ti > pos[:, None, :, None], -torch.inf)
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhst,bhtd->bhsd", w.to(v.dtype), v)
    y = dense(attn.w_o, _unheads(out))
    return y, MLACache(c_all, kr_all, offsets.to(torch.int32) + lengths.to(torch.int32))


def prefill_mla_cache(c_kv: torch.Tensor, k_rope: torch.Tensor, capacity: int,
                      lengths: Optional[torch.Tensor] = None) -> MLACache:
    """Pack prefill latents [B, S, r] and rotary keys [B, S, rope] into a
    fresh bf16 cache of ``capacity`` rows, with the true ``lengths`` of a
    right-padded bucket; when S exceeds the capacity each row keeps its
    last ``capacity`` real tokens."""
    b, s, _ = c_kv.shape
    length = (torch.full((b,), s, dtype=torch.int32, device=c_kv.device) if lengths is None
              else lengths.to(torch.int32))
    bf16 = torch.bfloat16
    if s >= capacity:
        if lengths is None:
            return MLACache(c_kv[:, s - capacity:].to(bf16).contiguous(),
                            k_rope[:, s - capacity:].to(bf16).contiguous(), length)
        start = (length.long() - capacity).clamp(0, s - capacity)
        idx = start[:, None] + torch.arange(capacity, device=c_kv.device)[None, :]   # [B, cap]
        take = lambda t: torch.gather(t, 1, idx[:, :, None].expand(b, capacity, t.shape[-1]))
        return MLACache(take(c_kv).to(bf16), take(k_rope).to(bf16), length)
    pad = (0, 0, 0, capacity - s)
    return MLACache(torch.nn.functional.pad(c_kv, pad).to(bf16),
                    torch.nn.functional.pad(k_rope, pad).to(bf16), length)
