"""Plain PyTorch versions of the FLARE kernels (the allclose targets).

Counterpart of ``repro/kernels/ref.py``, in the port's per-head layout:
q ``[H, M, D]`` with k/v ``[B, H, N, D]`` (any strides). The latents are
indexed per head through the einsum, never broadcast. Scores and softmax
statistics are fp32 (fp64 for fp64 inputs, an exact yardstick); the outputs
take the input dtype, except the fused forward's residuals, which are fp32
(fp64) as the kernel keeps them. The fused backward takes the tokens in
chunks (``chunk=``), so that its [B, H, M, chunk] temporaries fit where the
whole [B, H, M, N] would not. The causal version sweeps the tokens in
tiles (``tile=``), the factored form of ``core/flare_stream.py``.
"""
from __future__ import annotations

import torch


def _wide(t: torch.Tensor) -> torch.Tensor:
    """t in fp32, or in its own dtype where that is wider."""
    return t.to(torch.promote_types(t.dtype, torch.float32))


def _scores(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """[B, H, M, N] scores q k^T (scale 1, paper §3.2), at least fp32."""
    return torch.einsum("hmd,bhnd->bhmn", _wide(q), _wide(k))


def flare_encode_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Encode: Z = softmax(q k^T) v over tokens -> [B, H, M, D] in v's dtype."""
    w = torch.softmax(_scores(q, k), dim=-1)
    return torch.einsum("bhmn,bhnd->bhmd", w, _wide(v)).to(v.dtype)


def flare_decode_ref(q: torch.Tensor, k: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """Decode: Y = softmax over latents of (k q^T), applied to z [B, H, M, D]
    -> [B, H, N, D] in k's dtype."""
    w = torch.softmax(_scores(q, k), dim=-2)                   # over M
    return torch.einsum("bhmn,bhmd->bhnd", w, _wide(z)).to(k.dtype)


def flare_mixer_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Both SDPA calls, encode then decode."""
    return flare_decode_ref(q, k, flare_encode_ref(q, k, v))


def flare_fused_fwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """The fused forward with its residuals, per head:
    q [H, M, D], k/v [B, H, N, D] -> (y [B, H, N, D] in v's dtype,
    Z [B, H, M, D], per-latent max and den [B, H, M], per-token decode
    log-sum-exp [B, H, N]; the residuals fp32, fp64 for fp64 inputs), where
    den = sum_n exp(s - max) and lse = log sum_m exp(s)."""
    s = _scores(q, k)
    mx = s.amax(dim=-1)
    p = torch.exp(s - mx[..., None])
    den = p.sum(dim=-1)
    z = torch.einsum("bhmn,bhnd->bhmd", p, _wide(v)) / den[..., None]
    del p   # at most two [B, H, M, N] tensors alive at a time
    lse = torch.logsumexp(s, dim=-2)
    y = torch.einsum("bhmn,bhmd->bhnd", torch.exp(s - lse[:, :, None]), z).to(v.dtype)
    return y, z, mx, den, lse


def _chunks(n: int, chunk):
    step = n if chunk is None else chunk
    return [slice(n0, min(n, n0 + step)) for n0 in range(0, n, step)]


def flare_bwd_dz_ref(q, k, lse, dy, *, chunk=None) -> torch.Tensor:
    """First pass of the fused backward: dZ = W dy, W the decode weights
    exp(s - lse) -> [B, H, M, D] (fp32, fp64 for fp64 inputs)."""
    dz = 0
    for sl in _chunks(k.shape[2], chunk):
        w = torch.exp(_scores(q, k[:, :, sl]) - lse[:, :, None, sl])
        dz = dz + torch.einsum("bhmn,bhnd->bhmd", w, _wide(dy[:, :, sl]))
    return dz


def flare_bwd_grads_ref(q, k, v, z, mx, den, lse, y, dy, dz, *, chunk=None):
    """Second pass of the fused backward, given dZ: with A = exp(s - max) / den
    and W = exp(s - lse),
    dS = A (dZ v^T - rowsum(dZ Z)) + W (Z dy^T - rowsum(dy y)) and
    dq = sum_b dS k [H, M, D], dk = dS^T q, dv = A^T dZ [B, H, N, D]."""
    qw = _wide(q)
    le = mx + den.log()                                    # encode log-sum-exp
    de = (dz * z).sum(-1)                                  # [B, H, M]
    dq, dk, dv = 0, [], []
    for sl in _chunks(k.shape[2], chunk):
        kc, vc, dyc = _wide(k[:, :, sl]), _wide(v[:, :, sl]), _wide(dy[:, :, sl])
        dd = (dyc * _wide(y[:, :, sl])).sum(-1)            # [B, H, n]
        s = _scores(q, kc)
        a = torch.exp(s - le[..., None])
        w = torch.exp(s - lse[:, :, None, sl])
        ds = (a * (torch.einsum("bhmd,bhnd->bhmn", dz, vc) - de[..., None])
              + w * (torch.einsum("bhmd,bhnd->bhmn", z, dyc) - dd[:, :, None]))
        dq = dq + torch.einsum("bhmn,bhnd->hmd", ds, kc)
        dk.append(torch.einsum("bhmn,hmd->bhnd", ds, qw))
        dv.append(torch.einsum("bhmn,bhmd->bhnd", a, dz))
    return (dq.to(q.dtype), torch.cat(dk, dim=2).to(k.dtype), torch.cat(dv, dim=2).to(v.dtype))


def flare_fused_bwd_ref(q, k, v, z, mx, den, lse, y, dy, *, chunk=None):
    """The backward of the fused forward from its residuals (the math of
    ``_fused_bwd_kernel``): q [H, M, D]; k, v, y, dy [B, H, N, D]; z, mx,
    den, lse as :func:`flare_fused_fwd_ref` returns them ->
    (dq [H, M, D] summed over the batch, dk, dv [B, H, N, D]) in the
    operands' dtypes. Scores and statistics are fp32 (fp64 for fp64 inputs);
    ``chunk`` tokens at a time."""
    dz = flare_bwd_dz_ref(q, k, lse, dy, chunk=chunk)
    return flare_bwd_grads_ref(q, k, v, z, mx, den, lse, y, dy, dz, chunk=chunk)


def flare_causal_chunk_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                           tile: int = 64) -> torch.Tensor:
    """Causal FLARE (the math of ``_causal_chunk_kernel``): q [H, M, D],
    k/v [B, H, T, D] (any strides, T any length) -> y [B, H, T, D] in v's
    dtype. The factored chunk of ``stream_chunk_factored`` over ``tile``
    tokens at a time (the last tile ragged), carrying the latent state.
    Scores and state fp32, fp64 for fp64 inputs; a [B, H, M, tile] and a
    [B, H, tile, tile] temporary at a time."""
    from repro_torch.core.flare_stream import stream_chunk_factored, stream_init

    b, h, t, d = k.shape
    wide = torch.promote_types(v.dtype, torch.float32)
    state = stream_init(b, h, q.shape[1], d, device=k.device, dtype=wide)
    ys = []
    for t0 in range(0, t, tile):
        state, y = stream_chunk_factored(state, q, k[:, :, t0:t0 + tile], v[:, :, t0:t0 + tile])
        ys.append(y)
    return torch.cat(ys, dim=2)
