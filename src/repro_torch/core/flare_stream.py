"""Causal, streaming FLARE: the LM mixer of ``flare_lm``.

Counterpart of ``repro/core/flare_stream.py``. The encode softmax is a
per-latent weighted running sum,

    z_m = (sum_n e^{q_m.k_n} v_n) / (sum_n e^{q_m.k_n}),

so a latent state per head (m_max [B, H, M], num [B, H, M, D], den
[B, H, M], all fp32) is updated in O(M*D) per appended token, and the decode
of token t against the state of tokens <= t is the FLARE decode restricted
to the causal prefix (a token sees itself).

Entry points:
  - ``stream_init``   : a fresh state (m_max = -inf)
  - ``stream_append`` : one decode step (serving)
  - ``stream_chunk``  : a chunk of tokens, exact for any scores (a log-depth
                        scan of the (max, num, den) combine per position)
  - ``stream_chunk_factored``: a chunk through the factored [T, T] matrix,
                        exact under the bounded-score contract below
  - ``flare_causal_with_state`` / ``flare_causal``: a scan of chunks over a
                        whole sequence (prefill returns the state)

``mask`` [B, T] (True = real token) keeps right-padding out of the state:
masked scores are -inf on the state side, so the carried state is exactly
that of the unpadded prefix; the outputs at masked positions are finite
values the caller discards. The slot-pool ops of a bare state pool:
``stream_insert_slots`` (admission) and ``stream_reset_slots`` (retirement).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch


class FlareState(NamedTuple):
    m_max: torch.Tensor  # [B, H, M]    fp32
    num: torch.Tensor    # [B, H, M, D] fp32
    den: torch.Tensor    # [B, H, M]    fp32


def stream_init(batch: int, num_heads: int, num_latents: int, head_dim: int, *,
                device=None, dtype=torch.float32) -> FlareState:
    """A fresh state on ``device``; fp32 (fp64 for an fp64 yardstick)."""
    kw = dict(device=device, dtype=dtype)
    return FlareState(
        m_max=torch.full((batch, num_heads, num_latents), -torch.inf, **kw),
        num=torch.zeros((batch, num_heads, num_latents, head_dim), **kw),
        den=torch.zeros((batch, num_heads, num_latents), **kw),
    )


def _scores(q: torch.Tensor, k: torch.Tensor, pattern: str) -> torch.Tensor:
    """fp32 scores q.k (scale 1), fp64 for fp64 inputs."""
    wide = torch.promote_types(k.dtype, torch.float32)
    return torch.einsum(pattern, q.to(wide), k.to(wide))


def stream_append(state: FlareState, q: torch.Tensor, k_t: torch.Tensor,
                  v_t: torch.Tensor) -> tuple:
    """One decode step: q [H, M, D], k_t/v_t [B, H, D] (the new token) ->
    (state, y [B, H, D] in v_t's dtype)."""
    s = _scores(q, k_t, "hmd,bhd->bhm")
    new_max = torch.maximum(state.m_max, s)
    scale_old = torch.exp(state.m_max - new_max)
    scale_new = torch.exp(s - new_max)
    num = (state.num * scale_old[..., None]
           + scale_new[..., None] * v_t.to(s.dtype)[:, :, None, :])
    den = state.den * scale_old + scale_new
    z = num / den.clamp_min(1e-30)[..., None]
    w = torch.softmax(s, dim=-1)                   # decode: over the latents
    y = torch.einsum("bhm,bhmd->bhd", w, z)
    return FlareState(new_max, num, den), y.to(v_t.dtype)


def _safe_exp(a: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """exp(a - m) with the -inf/-inf case (an all-masked prefix) pinned to 0.
    The exponent is made -inf before the exp, not the exp's NaN replaced
    after it, so the backward meets no NaN either (0 * NaN would leak
    through a ``where``)."""
    return torch.exp((a - m).masked_fill(a == -torch.inf, -torch.inf))


def _combine(a, b):
    """Associative combine of (max, num, den) softmax states."""
    am, an, ad = a
    bm, bn, bd = b
    m = torch.maximum(am, bm)
    ea, eb = _safe_exp(am, m), _safe_exp(bm, m)
    return m, an * ea[..., None] + bn * eb[..., None], ad * ea + bd * eb


def _inclusive_scan(elems, axis: int):
    """Inclusive scan of ``_combine`` along ``axis`` (of the max and den;
    ``axis`` of num, whose trailing D axis rides along), by doubling: log2(T)
    rounds, each combining every position with the one ``offset`` before it.
    The counterpart of ``jax.lax.associative_scan``: the same combine in
    another association order."""
    m, num, den = elems
    t, offset = m.shape[axis], 1
    while offset < t:
        lo = lambda x: x.narrow(axis, 0, t - offset)
        hi = lambda x: x.narrow(axis, offset, t - offset)
        cm, cn, cd = _combine((lo(m), lo(num), lo(den)), (hi(m), hi(num), hi(den)))
        head = lambda x: x.narrow(axis, 0, offset)
        m, num, den = (torch.cat([head(m), cm], axis), torch.cat([head(num), cn], axis),
                       torch.cat([head(den), cd], axis))
        offset *= 2
    return m, num, den


def stream_chunk(state: FlareState, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 mask: Optional[torch.Tensor] = None) -> tuple:
    """Causal prefill of a chunk: q [H, M, D], k/v [B, H, T, D] ->
    (state, y [B, H, T, D] in v's dtype). Per-position stabilisers by a scan
    of (max, num, den), so a large future score cannot underflow an earlier
    position's denominator: exact for any scores. O(T*M*D) memory."""
    b, h, t, d = k.shape
    s = _scores(q, k, "hmd,bhtd->bhmt")                              # [B, H, M, T]
    s_enc = s if mask is None else s.masked_fill(~mask[:, None, None, :], -torch.inf)
    vb = v.to(s.dtype)[:, :, None].expand(b, h, q.shape[1], t, d)
    mc, numc, denc = _inclusive_scan((s_enc, vb, torch.ones_like(s)), axis=3)
    m_t = torch.maximum(state.m_max[..., None], mc)
    e_carry = _safe_exp(state.m_max[..., None], m_t)
    e_cum = _safe_exp(mc, m_t)
    num_t = state.num[..., None, :] * e_carry[..., None] + numc * e_cum[..., None]
    den_t = state.den[..., None] * e_carry + denc * e_cum
    z_t = num_t / den_t.clamp_min(1e-30)[..., None]                  # [B, H, M, T, D]
    w = torch.softmax(s, dim=-2)                                     # over M, per token
    y = torch.einsum("bhmt,bhmtd->bhtd", w, z_t)
    return FlareState(m_t[..., -1], num_t[..., -1, :], den_t[..., -1]), y.to(v.dtype)


def stream_chunk_factored(state: FlareState, q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor, mask: Optional[torch.Tensor] = None) -> tuple:
    """Causal prefill of a chunk through the factored [T, T] mixing matrix:

        y_t = sum_m F2[t,m] carry_num_m e^{cm - REF} + sum_{tau<=t} A[t,tau] v_tau,
        A = F2 F1^T,  F1[tau,m] = e^{s_tau,m - REF_m} (<= 1),  F2[t,m] = w_tm / cden_tm,
        cden_tm = carry_den e^{cm - REF} + cumsum_tau(F1)_t,

    REF_m = max(carry max, max_tau s) the per-latent chunk stabiliser. O(T*M +
    T^2) memory. Bounded-score contract: exact unless a FUTURE in-chunk score
    exceeds the running max by more than ~85 nats (fp32; cden then meets the
    1e-30 guard). ``stream_chunk`` is exact for any scores."""
    s = _scores(q, k, "hmd,bhtd->bhmt")                              # [B, H, M, T]
    s_enc = s if mask is None else s.masked_fill(~mask[:, None, None, :], -torch.inf)
    ref = torch.maximum(state.m_max, s_enc.amax(dim=-1))             # [B, H, M]
    w = torch.softmax(s, dim=-2)                                     # decode, over M
    f1, carry_scale, new_den, f2 = _EncodeWeights.apply(s_enc, ref, state.m_max, state.den, w)
    carry_num = state.num * carry_scale[..., None]                   # [B, H, M, D]
    y = torch.einsum("bhmt,bhmd->bhtd", f2, carry_num)
    a = torch.einsum("bhmt,bhmu->bhtu", f2, f1).tril_()              # tau <= t
    vf = v.to(s.dtype)
    y = y + torch.einsum("bhtu,bhud->bhtd", a, vf)
    new_num = carry_num + torch.einsum("bhmt,bhtd->bhmd", f1, vf)
    return FlareState(ref, new_num, new_den), y.to(v.dtype)


def _encode_weights(s_enc, ref, m_max, den, w):
    """The factored chunk's F1, carry scale, new denominator and F2."""
    f1 = _safe_exp(s_enc, ref[..., None])
    carry_scale = _safe_exp(m_max, ref)
    cden = den[..., None] * carry_scale[..., None] + f1.cumsum(dim=-1)
    return f1, carry_scale, cden[..., -1], w / cden.clamp_min(1e-30)


class _EncodeWeights(torch.autograd.Function):
    """:func:`_encode_weights`, whose backward runs in fp64. Where a latent's
    running denominator is tiny (scores tens of nats below the chunk's
    max), d F2 / d cden = -w / cden^2 overflows fp32 (to inf, then NaN) on
    its way to a gradient that is finite: it is multiplied by F1 <= cden
    before it leaves this function. fp64 holds the intermediate; the
    forward is the fp32 one, bit for bit. (The JAX package's gradient is
    NaN there.)"""

    @staticmethod
    def forward(ctx, s_enc, ref, m_max, den, w):
        ctx.save_for_backward(s_enc, ref, m_max, den, w)
        return _encode_weights(s_enc, ref, m_max, den, w)

    @staticmethod
    def backward(ctx, *grads):
        saved = ctx.saved_tensors
        wide = [t.detach().to(torch.promote_types(t.dtype, torch.float64)).requires_grad_()
                for t in saved]
        with torch.enable_grad():
            outs = _encode_weights(*wide)
        keep = [(o, g.to(o.dtype)) for o, g in zip(outs, grads) if g is not None]
        got = torch.autograd.grad([o for o, _ in keep], wide, [g for _, g in keep],
                                  allow_unused=True)
        return tuple(None if g is None else g.to(t.dtype)
                     for g, t in zip(got, saved))


def flare_causal_with_state(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                            chunk_size: int = 256, mode: str = "factored",
                            mask: Optional[torch.Tensor] = None) -> tuple:
    """Causal FLARE over a sequence by a scan of chunked prefills: q [H, M, D],
    k/v [B, H, N, D] -> (the final state, y [B, H, N, D]). The chunk is the
    largest power-of-two fraction of ``chunk_size`` that divides N.
    ``mode="factored"`` steps with :func:`stream_chunk_factored`, ``"exact"``
    with :func:`stream_chunk`. ``mask`` [B, N] marks real tokens: the state
    returned is that of the masked prefix."""
    b, h, n, d = k.shape
    chunk_size = min(chunk_size, n)
    while n % chunk_size:
        chunk_size //= 2
    step = {"factored": stream_chunk_factored, "exact": stream_chunk}[mode]
    state = stream_init(b, h, q.shape[1], d, device=k.device,
                        dtype=torch.promote_types(k.dtype, torch.float32))
    ys = []
    for c0 in range(0, n, chunk_size):
        sl = slice(c0, c0 + chunk_size)
        state, y = step(state, q, k[:, :, sl], v[:, :, sl],
                        mask=None if mask is None else mask[:, sl])
        ys.append(y)
    return state, torch.cat(ys, dim=2)


def flare_causal(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                 chunk_size: int = 256, mode: str = "factored") -> torch.Tensor:
    """The causal FLARE mixer (see :func:`flare_causal_with_state`)."""
    return flare_causal_with_state(q, k, v, chunk_size=chunk_size, mode=mode)[1]


def stream_insert_slots(pool: FlareState, part: FlareState, slots: torch.Tensor) -> FlareState:
    """Write ``part``'s batch lanes into ``pool`` at ``slots`` ([b] integer):
    lane i of a prefilled state lands in pool slot ``slots[i]``; the other
    slots are untouched. Functional, as the reference: ``pool`` is not
    modified."""
    idx = slots.to(device=pool.m_max.device, dtype=torch.long)
    return FlareState(*(p.index_copy(0, idx, x.to(p.dtype)) for p, x in zip(pool, part)))


def stream_reset_slots(pool: FlareState, slots: torch.Tensor) -> FlareState:
    """``slots`` of a state pool back to the ``stream_init`` values: the
    retirement op. m_max returns to -inf, not 0 (a valid score), so a reused
    slot carries no trace of the previous request's stream."""
    _, h, m, d = pool.num.shape
    fresh = stream_init(slots.shape[0], h, m, d, device=pool.num.device, dtype=pool.num.dtype)
    return stream_insert_slots(pool, fresh, slots)


def flare_causal_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """O(N^2) oracle: token t applies the batch FLARE operator to the prefix
    [0..t]. Tests only."""
    n = k.shape[2]
    s = _scores(q, k, "hmd,bhnd->bhmn")                              # [B, H, M, N]
    vf = v.to(s.dtype)
    w_dec = torch.softmax(s, dim=-2)
    ys = []
    for t in range(n):
        w_enc = torch.softmax(s[..., : t + 1], dim=-1)
        z = torch.einsum("bhmn,bhnd->bhmd", w_enc, vf[:, :, : t + 1])
        ys.append(torch.einsum("bhm,bhmd->bhd", w_dec[..., t], z))
    return torch.stack(ys, dim=2).to(v.dtype)
