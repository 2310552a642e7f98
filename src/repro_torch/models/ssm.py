"""Attention-free token mixers: RWKV-6 (Finch) and Mamba2 (SSD).

Counterpart of ``repro/models/ssm.py``. Both come in two mathematically
identical forms:
  - ``*_scan``:    the sequential recurrence (the reference; also the decode step);
  - ``*_chunked``: the chunk-parallel form (an intra-chunk matrix and the
                   state carried between chunks), the prefill and training path.

The JAX package carries the state through ``jax.lax.scan`` over chunks and
computes each chunk's terms inside the scanned body. Here every term that
does not read the incoming state is computed for all chunks at once (one
batched product over a chunk axis), and only the state hand-off, one
multiply-add of ``[H, D, D]`` (RWKV) or ``[H, P, N]`` (Mamba2) a chunk,
runs as a loop; the sums are the JAX package's, in its order.

Stability: all decay products are computed in log space and only ratios
exp(lc_a - lc_b) with a >= b (hence <= 1) are ever exponentiated (the
factored RWKV form clips its one growing exponent at ``clamp``).

RWKV-6 recurrence per head (k-dim = v-dim = D):
    S_t = diag(w_t) S_{t-1} + k_t^T v_t          S: [D, D]
    y_t = r_t . (S_{t-1} + diag(u) k_t^T v_t)
with data-dependent per-channel decay w_t in (0,1).

Mamba2/SSD per head (scalar decay a_t = exp(dt_t * A)):
    S_t = a_t S_{t-1} + (dt_t x_t) (x) B_t       S: [P, N]
    y_t = S_t C_t + D_skip * x_t

Precision: the recurrences run in fp32, or in the inputs' dtype where it is
wider (fp64 oracles). The RWKV ddlerp and token-shift arithmetic runs in
the compute dtype (bf16); its decay ``exp(-exp(ww))`` and the WKV run in
fp32. Mamba2's conv state is kept in the compute dtype, its SSD state in
fp32. No kernel: the scans are plain torch, as the JAX package's are jnp.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.config import SSMConfig
from repro_torch.nn.modules import _param, dense, init_dense, init_layernorm, layernorm


def _wide(*xs: torch.Tensor) -> torch.dtype:
    """fp32, or the widest of the inputs' dtypes where that is wider."""
    dt = torch.float32
    for x in xs:
        dt = torch.promote_types(dt, x.dtype)
    return dt


# ===========================================================================
# RWKV-6
# ===========================================================================


def rwkv6_wkv_scan(r, k, v, w, u, s0=None):
    """The WKV recurrence, a token at a time.

    r, k, v, w: [B, T, H, D]; u: [H, D]; s0: [B, H, D, D].
    Returns (y [B, T, H, D], the final state), in fp32 (or wider)."""
    b, t, h, d = r.shape
    dt = _wide(r, k, v, w, u, *(() if s0 is None else (s0,)))
    s = (torch.zeros(b, h, d, d, dtype=dt, device=r.device) if s0 is None else s0.to(dt))
    r, k, v, w = (x.to(dt) for x in (r, k, v, w))
    uu = u.to(dt)[None, :, :, None]
    ys = []
    for i in range(t):
        kv = torch.einsum("bhk,bhv->bhkv", k[:, i], v[:, i])
        # bonus: the current token contributes through diag(u), not the decay
        ys.append(torch.einsum("bhk,bhkv->bhv", r[:, i], s + uu * kv))
        s = w[:, i, ..., None] * s + kv
    return torch.stack(ys, 1), s


def rwkv6_wkv_chunked(r, k, v, w, u, s0=None, *, chunk: int = 32, intra: str = "factored",
                      clamp: float = 40.0):
    """Chunk-parallel WKV; the signature and semantics of the scan form.

    intra="exact":    materialises the [L, L, D] decay-ratio tensor: exact
                      for any decay, O(L^2 D) memory a chunk.
    intra="factored": A[t,i] = <r_t * e^{lc_excl_t - lc_last},
                               k_i * e^{lc_last - lc_i}>, a plain [L,D]x[D,L]
                      product, O(L^2 + L*D).

    The factored form is exact while the decay accumulated over any chunk
    suffix stays under ``clamp`` nats (the r factor's exponent is clipped
    there): RWKV-6's w = exp(-exp(ww)) with its standard decay_base keeps
    a step's decay at 0.0025-0.5 nats, far below 40 over 64 tokens."""
    b, t, h, d = r.shape
    if t % chunk:
        raise ValueError(f"T={t} not divisible by chunk={chunk}")
    nc = t // chunk
    dt = _wide(r, k, v, w, u, *(() if s0 is None else (s0,)))
    s = (torch.zeros(b, h, d, d, dtype=dt, device=r.device) if s0 is None else s0.to(dt))

    def resh(x):   # [B, T, H, D] -> [B, nc, H, L, D]
        return x.to(dt).reshape(b, nc, chunk, h, d).transpose(2, 3)

    rc, kc, vc, wc = resh(r), resh(k), resh(v), resh(w)
    lc = torch.log(wc.clamp_min(1e-38)).cumsum(-2)          # inclusive, <= 0
    lce = F.pad(lc[..., :-1, :], (0, 0, 1, 0))              # exclusive
    lc_last = lc[..., -1:, :]                               # [B, nc, H, 1, D]
    below = torch.ones(chunk, chunk, dtype=torch.bool, device=r.device).tril(-1)   # i < t
    k_dec = kc * torch.exp(lc_last - lc)                    # exponent <= 0: safe
    if intra == "factored":
        r_fac = rc * torch.exp((lce - lc_last).clamp_max(clamp))
        a_intra = torch.einsum("bchtd,bchid->bchti", r_fac, k_dec)
        a_intra = a_intra.masked_fill(~below, 0.0)
    elif intra == "exact":
        # ratio[t, i, d] = exp(lc_excl[t, d] - lc[i, d]) <= 1 for i < t
        diff = lce[..., :, None, :] - lc[..., None, :, :]   # [B, nc, H, L(t), L(i), D]
        ratio = torch.exp(diff.masked_fill(~below[:, :, None], -torch.inf))
        a_intra = torch.einsum("bchtd,bchid,bchtid->bchti", rc, kc, ratio)
    else:
        raise ValueError(f"intra must be 'factored' or 'exact', not {intra!r}")
    y_intra = torch.einsum("bchti,bchiv->bchtv", a_intra, vc)
    # the diagonal bonus term: the current token enters through diag(u)
    a_diag = torch.einsum("bchtd,hd,bchtd->bcht", rc, u.to(dt), kc)
    y_diag = a_diag[..., None] * vc
    # the state hand-off: S_out = diag(exp(lc_last)) S_in + sum_i exp(lc_last - lc_i) k_i (x) v_i
    kv = torch.einsum("bchld,bchlv->bchdv", k_dec, vc)
    decay = torch.exp(lc_last[..., 0, :])[..., None]        # [B, nc, H, D, 1]
    s_in = []
    for c in range(nc):
        s_in.append(s)
        s = decay[:, c] * s + kv[:, c]
    # inter-chunk: y_t += (r_t * exp(lc_excl_t)) . S_in
    y_inter = torch.einsum("bchld,bchdv->bchlv", rc * torch.exp(lce), torch.stack(s_in, 1))
    y = y_inter + y_intra + y_diag
    return y.transpose(2, 3).reshape(b, t, h, d), s


class RWKV6Layer(nn.Module):
    """One RWKV-6 layer's parameters, named as the JAX tree's leaves: the
    norms ``ln1``, ``ln2``, ``ln_x`` (the per-head group norm); the time
    mix's ddlerp (``mu_x``, ``mu`` [5, C], ``lora_a`` [C, 5 r], ``lora_b``
    [5, r, C]), projections ``w_r``, ``w_k``, ``w_v``, ``w_g``, ``w_o``,
    decay (``decay_base``, ``decay_a`` [C, 64], ``decay_b`` [64, C]) and
    bonus ``u`` [H, D]; the channel mix's ``cm_mu_k``, ``cm_mu_r``, ``cm_k``,
    ``cm_v``, ``cm_r``. Raw parameters keep the JAX layout (``x @ lora_a``);
    the dense layers are ``nn.Linear``s."""

    def __init__(self, **modules):
        super().__init__()
        for name, m in modules.items():
            setattr(self, name, m)


def init_rwkv6_layer(d_model: int, cfg: SSMConfig, d_ff: int, *, generator: torch.Generator,
                     device=None, dtype=torch.float32) -> RWKV6Layer:
    d = cfg.head_dim
    h = d_model // d
    lora_r, decay_r = 32, 64
    std = 1.0 / math.sqrt(d_model)
    kw = dict(device=device, dtype=dtype)
    mat = lambda shape, s=std: _param(shape, s, generator, device, dtype)
    lin = lambda i, o: init_dense(i, o, generator=generator, **kw)
    const = lambda shape, value: nn.Parameter(torch.full(shape, value, **kw))
    return RWKV6Layer(
        ln1=init_layernorm(d_model, **kw), ln2=init_layernorm(d_model, **kw),
        mu_x=const((d_model,), 0.0), mu=const((5, d_model), 0.0),
        lora_a=mat((d_model, 5 * lora_r)), lora_b=mat((5, lora_r, d_model), 0.01),
        w_r=lin(d_model, d_model), w_k=lin(d_model, d_model), w_v=lin(d_model, d_model),
        w_g=lin(d_model, d_model), w_o=lin(d_model, d_model),
        decay_base=const((d_model,), -6.0), decay_a=mat((d_model, decay_r)),
        decay_b=mat((decay_r, d_model), 0.01), u=mat((h, d), 0.5),
        ln_x=init_layernorm(d_model, **kw),
        cm_mu_k=const((d_model,), 0.0), cm_mu_r=const((d_model,), 0.0),
        cm_k=lin(d_model, d_ff), cm_v=lin(d_ff, d_model), cm_r=lin(d_model, d_model))


def _token_shift(x: torch.Tensor, last: Optional[torch.Tensor] = None) -> torch.Tensor:
    """shift(x)[t] = x[t-1]; position 0 gets ``last`` (or zeros)."""
    first = torch.zeros_like(x[:, :1]) if last is None else last[:, None, :].to(x.dtype)
    return torch.cat([first, x[:, :-1]], dim=1)


def _pad_mask(lengths: Optional[torch.Tensor], b: int, t: int, device) -> Optional[torch.Tensor]:
    """[B, T] bool, True at a real token (right-padded serving buckets)."""
    if lengths is None:
        return None
    return torch.arange(t, device=device)[None, :] < lengths[:, None]


def _last_real(x: torch.Tensor, lengths: Optional[torch.Tensor]) -> torch.Tensor:
    """x [B, T, C] -> [B, C], the row at each sequence's last real position
    (position T-1 when ``lengths`` is None)."""
    if lengths is None:
        return x[:, -1, :]
    idx = (lengths.long() - 1).clamp(0, x.shape[1] - 1)
    return x[torch.arange(x.shape[0], device=x.device), idx]


class RWKVState(NamedTuple):
    tm_last: torch.Tensor   # [B, C] fp32, the time mix's last input
    cm_last: torch.Tensor   # [B, C] fp32, the channel mix's last input
    wkv: torch.Tensor       # [B, H, D, D] fp32


def _chunked(impl: str, t: int, chunk: int) -> bool:
    """The JAX package's pick: the chunked form where asked for and the
    length divides into chunks of more than one token, the scan otherwise
    (decode, and serving buckets shorter than a chunk)."""
    return impl == "chunked" and t % chunk == 0 and t > 1


def rwkv6_wkv_operands(p: RWKV6Layer, x: torch.Tensor, cfg: SSMConfig, *,
                       last: Optional[torch.Tensor] = None,
                       lengths: Optional[torch.Tensor] = None):
    """The time mix's WKV operands for x [B, T, C] (already normed): r, k, v
    [B, T, H, D] in x's dtype, the decay w [B, T, H, D] in fp32 (or wider)
    and the gate g [B, T, C]. ``last``: the previous token's input (the
    carried ``tm_last``); ``lengths``: padded positions get k = 0 and w = 1."""
    b, t, c = x.shape
    d = cfg.head_dim
    h = c // d
    cd = x.dtype
    sx = _token_shift(x, last)
    dx = sx - x
    xxx = x + dx * p.mu_x.to(cd)
    lr = torch.tanh(xxx @ p.lora_a.to(cd)).reshape(b, t, 5, -1)
    deltas = torch.einsum("btfr,frc->fbtc", lr, p.lora_b.to(cd))
    mu = p.mu.to(cd)
    xw, xk, xv, xr, xg = (x + dx * (mu[i] + deltas[i]) for i in range(5))

    r = dense(p.w_r, xr).reshape(b, t, h, d)
    k = dense(p.w_k, xk).reshape(b, t, h, d)
    v = dense(p.w_v, xv).reshape(b, t, h, d)
    g = F.silu(dense(p.w_g, xg))

    wd = _wide(x)
    ww = p.decay_base.to(wd) + (torch.tanh(xw.to(wd) @ p.decay_a.to(wd)) @ p.decay_b.to(wd))
    w = torch.exp(-torch.exp(ww)).reshape(b, t, h, d)   # in (0, 1)

    mask = _pad_mask(lengths, b, t, x.device)
    if mask is not None:
        k = torch.where(mask[..., None, None], k, 0.0)
        w = torch.where(mask[..., None, None], w, 1.0)
    return r, k, v, w, g


def rwkv6_time_mix(p: RWKV6Layer, x: torch.Tensor, cfg: SSMConfig, *,
                   state: Optional[RWKVState] = None, impl: str = "chunked",
                   lengths: Optional[torch.Tensor] = None):
    """x [B, T, C] (already normed) -> (y, (tm_last, wkv)).

    ``lengths`` [B]: the true prompt lengths of a right-padded bucket.
    Padded positions are WKV no-ops (k = 0 adds nothing to the state, w = 1
    leaves it undecayed) and the carried ``tm_last`` is the input at each
    row's last real position, so the state handed to decode is that of the
    unpadded prompt."""
    b, t, c = x.shape
    r, k, v, w, g = rwkv6_wkv_operands(p, x, cfg, last=None if state is None else state.tm_last,
                                       lengths=lengths)
    s0 = None if state is None else state.wkv
    if _chunked(impl, t, cfg.chunk):
        y, s = rwkv6_wkv_chunked(r, k, v, w, p.u, s0, chunk=cfg.chunk)
    else:
        y, s = rwkv6_wkv_scan(r, k, v, w, p.u, s0)
    # the per-head group norm: a layernorm of each head's slice (population
    # variance, eps 64e-5), in the WKV's precision
    mean = y.mean(-1, keepdim=True)
    var = y.var(-1, unbiased=False, keepdim=True)
    y = ((y - mean) * torch.rsqrt(var + 64e-5)).reshape(b, t, c)
    y = y * p.ln_x.scale.to(y.dtype) + p.ln_x.bias.to(y.dtype)
    out = dense(p.w_o, y.to(x.dtype) * g)
    return out, (_last_real(x, lengths).to(_wide(x)), s)


def rwkv6_channel_mix(p: RWKV6Layer, x: torch.Tensor, *, last: Optional[torch.Tensor] = None,
                      lengths: Optional[torch.Tensor] = None):
    """x [B, T, C] (already normed) -> (y, the new last input). The
    elementwise lerp runs in the compute dtype."""
    sx = _token_shift(x, last)
    dx = sx - x
    xk = x + dx * p.cm_mu_k.to(x.dtype)
    xr = x + dx * p.cm_mu_r.to(x.dtype)
    kk = torch.square(torch.relu(dense(p.cm_k, xk)))
    out = torch.sigmoid(dense(p.cm_r, xr)) * dense(p.cm_v, kk)
    return out, _last_real(x, lengths).to(_wide(x))


def rwkv6_block(p: RWKV6Layer, x: torch.Tensor, cfg: SSMConfig, *,
                state: Optional[RWKVState] = None, impl: str = "chunked",
                lengths: Optional[torch.Tensor] = None):
    """The full layer: x + TimeMix(LN1(x)), then x + ChannelMix(LN2(x)).
    ``lengths``: as :func:`rwkv6_time_mix`."""
    tm_out, (tm_last, wkv) = rwkv6_time_mix(p, layernorm(p.ln1, x), cfg, state=state,
                                            impl=impl, lengths=lengths)
    x = x + tm_out
    cm_out, cm_last = rwkv6_channel_mix(p, layernorm(p.ln2, x),
                                        last=None if state is None else state.cm_last,
                                        lengths=lengths)
    return x + cm_out, RWKVState(tm_last, cm_last, wkv)


# ===========================================================================
# Mamba2 (SSD)
# ===========================================================================


class Mamba2State(NamedTuple):
    conv: torch.Tensor   # [B, conv_dim, K-1] the causal conv's last inputs (compute dtype)
    ssm: torch.Tensor    # [B, H, P, N] fp32


class Mamba2Layer(nn.Module):
    """One Mamba2 layer's parameters, named as the JAX tree's leaves:
    ``norm``, ``in_proj`` (to z, xBC, dt), ``conv_w`` [conv_dim, K],
    ``conv_b``, ``a_log`` (A = -exp(a_log)), ``dt_bias``, ``d_skip``,
    ``out_norm``, ``out_proj``."""

    def __init__(self, **modules):
        super().__init__()
        for name, m in modules.items():
            setattr(self, name, m)


def mamba2_dims(d_model: int, cfg: SSMConfig) -> tuple:
    """(d_inner, heads, head dim P, state dim N, conv_dim)."""
    d_inner = cfg.expand * d_model
    h = cfg.num_heads or d_inner // cfg.head_dim
    return d_inner, h, cfg.head_dim, cfg.state_dim, d_inner + 2 * cfg.state_dim


def init_mamba2_layer(d_model: int, cfg: SSMConfig, *, generator: torch.Generator,
                      device=None, dtype=torch.float32) -> Mamba2Layer:
    d_inner, h, _, n, conv_dim = mamba2_dims(d_model, cfg)
    kw = dict(device=device, dtype=dtype)
    in_dim = 2 * d_inner + 2 * n + h   # z, xBC, dt
    in_proj = init_dense(d_model, in_dim, generator=generator, **kw)
    conv_w = torch.empty(conv_dim, cfg.conv_kernel, device=generator.device).normal_(
        generator=generator)
    return Mamba2Layer(
        norm=init_layernorm(d_model, **kw), in_proj=in_proj,
        conv_w=nn.Parameter((conv_w * 0.1).to(**kw)),
        conv_b=nn.Parameter(torch.zeros(conv_dim, **kw)),
        a_log=nn.Parameter(torch.log(torch.linspace(1.0, 16.0, h)).to(**kw)),
        dt_bias=nn.Parameter(torch.zeros(h, **kw)), d_skip=nn.Parameter(torch.ones(h, **kw)),
        out_norm=init_layernorm(d_inner, **kw),
        out_proj=init_dense(d_inner, d_model, generator=generator, **kw))


def _causal_conv1d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                   state: Optional[torch.Tensor] = None,
                   lengths: Optional[torch.Tensor] = None):
    """The depthwise causal conv: x [B, T, C], w [C, K] -> (y [B, T, C] in
    x's dtype, the new state [B, C, K-1] in fp32).

    ``lengths``: with a right-padded bucket the carried state is the K-1
    inputs ending at each row's last real token, not the padded tail (the
    JAX package's ``dynamic_slice`` under ``vmap``, here a gather)."""
    kk = w.shape[1]
    wd = _wide(x)
    xf = x.to(wd).transpose(1, 2)   # [B, C, T]
    pad = (torch.zeros(xf.shape[0], xf.shape[1], kk - 1, dtype=wd, device=x.device)
           if state is None else state.to(wd))
    xp = torch.cat([pad, xf], dim=-1)   # [B, C, T+K-1]
    t = xf.shape[-1]
    y = sum(xp[:, :, i:i + t] * w[:, i].to(wd)[None, :, None] for i in range(kk))
    y = y + b.to(wd)[None, :, None]
    if lengths is None:
        new_state = xp[:, :, t:]
    else:
        # tokens [len-K+1, len) are xp's [len, len+K-1); the start clamped as dynamic_slice's
        start = lengths.long().clamp(0, t)
        idx = start[:, None] + torch.arange(kk - 1, device=x.device)[None, :]
        new_state = xp.gather(2, idx[:, None, :].expand(xp.shape[0], xp.shape[1], kk - 1))
    return y.transpose(1, 2).to(x.dtype), new_state


def ssd_scan(x, dt, a_log, bmat, cmat, d_skip, s0=None):
    """The SSD recurrence, a token at a time.

    x [B, T, H, P], dt [B, T, H], bmat / cmat [B, T, N], d_skip [H],
    s0 [B, H, P, N] -> (y [B, T, H, P], the final state), in fp32 (or wider)."""
    b, t, h, p = x.shape
    n = bmat.shape[-1]
    wd = _wide(x, dt, bmat, *(() if s0 is None else (s0,)))
    s = torch.zeros(b, h, p, n, dtype=wd, device=x.device) if s0 is None else s0.to(wd)
    a = -torch.exp(a_log.to(wd))
    dtw = dt.to(wd)
    decay = torch.exp(dtw * a[None, None, :])   # [B, T, H]
    xw, bw, cw = x.to(wd), bmat.to(wd), cmat.to(wd)
    ys = []
    for i in range(t):
        s = decay[:, i, :, None, None] * s + torch.einsum(
            "bhp,bn->bhpn", dtw[:, i, :, None] * xw[:, i], bw[:, i])
        ys.append(torch.einsum("bhpn,bn->bhp", s, cw[:, i]))
    y = torch.stack(ys, 1) + d_skip.to(wd)[None, None, :, None] * xw
    return y, s


def ssd_chunked(x, dt, a_log, bmat, cmat, d_skip, s0=None, *, chunk: int = 64):
    """Chunk-parallel SSD (the Mamba2 algorithm); the semantics of
    :func:`ssd_scan`."""
    b, t, h, p = x.shape
    n = bmat.shape[-1]
    if t % chunk:
        raise ValueError(f"T={t} not divisible by chunk={chunk}")
    nc = t // chunk
    wd = _wide(x, dt, bmat, *(() if s0 is None else (s0,)))
    s = torch.zeros(b, h, p, n, dtype=wd, device=x.device) if s0 is None else s0.to(wd)
    a = -torch.exp(a_log.to(wd))
    dtw = dt.to(wd)
    ldec = (dtw * a[None, None, :]).reshape(b, nc, chunk, h).transpose(2, 3)   # [B, nc, H, L]
    xs = (dtw[..., None] * x.to(wd)).reshape(b, nc, chunk, h, p).transpose(2, 3)
    xr = x.to(wd).reshape(b, nc, chunk, h, p).transpose(2, 3)                  # [B, nc, H, L, P]
    bs = bmat.to(wd).reshape(b, nc, chunk, n)                                  # [B, nc, L, N]
    cs = cmat.to(wd).reshape(b, nc, chunk, n)
    lc = ldec.cumsum(-1)                                                       # inclusive
    tril = torch.ones(chunk, chunk, dtype=torch.bool, device=x.device).tril()  # i <= t
    # intra-chunk: M[t, i] = exp(lc_t - lc_i) for i <= t (a scalar a head)
    ratio = torch.exp((lc[..., :, None] - lc[..., None, :]).masked_fill(~tril, -torch.inf))
    gmat = torch.einsum("bctn,bcin->bcti", cs, bs)
    y_intra = torch.einsum("bcti,bchti,bchip->bchtp", gmat, ratio, xs)
    # the state hand-off
    lc_last = lc[..., -1:]
    k_dec = torch.exp(lc_last - lc)
    upd = torch.einsum("bchl,bchlp,bcln->bchpn", k_dec, xs, bs)
    decay = torch.exp(lc_last)[..., None]   # [B, nc, H, 1, 1]
    s_in = []
    for c in range(nc):
        s_in.append(s)
        s = decay[:, c] * s + upd[:, c]
    # inter-chunk: y_t = C_t . (exp(lc_t) S_in)
    y_inter = torch.einsum("bcln,bchpn,bchl->bchlp", cs, torch.stack(s_in, 1), torch.exp(lc))
    y = y_inter + y_intra + d_skip.to(wd)[None, None, :, None, None] * xr
    return y.transpose(2, 3).reshape(b, t, h, p), s


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """log(1 + e^x) everywhere, as ``jax.nn.softplus`` (``F.softplus``
    returns x itself above its threshold of 20)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def mamba2_block(p: Mamba2Layer, x: torch.Tensor, cfg: SSMConfig, *,
                 state: Optional[Mamba2State] = None, impl: str = "chunked",
                 lengths: Optional[torch.Tensor] = None):
    """The full Mamba2 layer, pre-norm with its residual: x [B, T, C] ->
    (x', Mamba2State).

    ``lengths`` [B]: a right-padded bucket's true lengths. Padded positions
    get dt = 0 (unit decay, no contribution to the state) and the conv state
    is taken at each row's last real token, so the carried state is that
    of the unpadded prompt."""
    b, t, c = x.shape
    d_inner, h, hp, n, _ = mamba2_dims(c, cfg)
    zxbcdt = dense(p.in_proj, layernorm(p.norm, x))
    z, xbc, dt = zxbcdt.split([d_inner, d_inner + 2 * n, h], dim=-1)
    xbc, new_conv = _causal_conv1d(xbc, p.conv_w, p.conv_b,
                                   None if state is None else state.conv, lengths=lengths)
    xbc = F.silu(xbc)
    xs, bmat, cmat = xbc.split([d_inner, n, n], dim=-1)
    xs = xs.reshape(b, t, h, hp)
    wd = _wide(x)
    dt = _softplus(dt.to(wd) + p.dt_bias.to(wd))
    mask = _pad_mask(lengths, b, t, x.device)
    if mask is not None:
        dt = dt * mask[..., None]
    s0 = None if state is None else state.ssm
    if _chunked(impl, t, cfg.chunk):
        y, s = ssd_chunked(xs, dt, p.a_log, bmat, cmat, p.d_skip, s0, chunk=cfg.chunk)
    else:
        y, s = ssd_scan(xs, dt, p.a_log, bmat, cmat, p.d_skip, s0)
    y = y.reshape(b, t, d_inner).to(x.dtype) * F.silu(z)
    out = dense(p.out_proj, layernorm(p.out_norm, y))
    return x + out, Mamba2State(new_conv.to(x.dtype), s)
