"""Plain PyTorch versions of the FLARE kernels (the allclose targets).

Counterpart of ``repro/kernels/ref.py``, in the port's per-head layout:
q ``[H, M, D]`` with k/v ``[B, H, N, D]`` (any strides). The latents are
indexed per head through the einsum, never broadcast. Scores and softmax
statistics are fp32 (fp64 for fp64 inputs, an exact yardstick); the outputs
take the input dtype, except the fused forward's residuals, which are fp32
(fp64) as the kernel keeps them.
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
    Z [B, H, M, D] fp32, per-latent max [B, H, M] fp32, per-latent den
    [B, H, M] fp32; fp64 for fp64 inputs), where den = sum_n exp(s - max)."""
    s = _scores(q, k)
    mx = s.amax(dim=-1)
    p = torch.exp(s - mx[..., None])
    den = p.sum(dim=-1)
    z = torch.einsum("bhmn,bhnd->bhmd", p, _wide(v)) / den[..., None]
    w = torch.softmax(s, dim=-2)
    y = torch.einsum("bhmn,bhmd->bhnd", w, z).to(v.dtype)
    return y, z, mx, den
