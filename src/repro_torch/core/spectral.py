"""Spectral analysis of the FLARE communication operator (paper App. C).

Counterpart of ``repro/core/spectral.py``. Algorithm 1: the eigenvalues
and eigenvectors of W = W_dec @ W_enc in O(M^3 + M^2 N), without forming
the N x N matrix:

    A   = exp(Q K^T)                       [M, N]
    L_M = diag(1 / row-sums of A)          [M, M]
    L_N = diag(1 / col-sums of A)          [N, N]
    J   = L_M^{1/2} A L_N^{1/2}            [M, N]
    J J^T = U S^2 U^T (eig of M x M)  =>   eigvals(W) = S^2,
    eigvecs(W) = L_N^{1/2} J^T U S^{-1}    [N, M]

J is formed in log space, J_mn = exp(s_mn - lse_row(s)_m / 2 -
lse_col(s)_n / 2), with stable logsumexps: the exponent is never above 0,
so J never overflows, and a row or column whose mass underflows gives ~0
entries instead of rsqrt(0) = inf. A global score shift cancels exactly.

The functions run on whatever device their tensors are on, in fp32, or in
fp64 for fp64 inputs (the exact yardstick). No kernel: the reference is
plain jnp too.
"""
from __future__ import annotations

import torch


def _wide(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.promote_types(t.dtype, torch.float32))


def flare_spectrum(q: torch.Tensor, k: torch.Tensor, *, return_vectors: bool = True):
    """Eigen-decomposition of W for one head: q [M, D] latent queries,
    k [N, D] keys -> (eigvals [M] descending, eigvecs [N, M] or None)."""
    q, k = _wide(q), _wide(k)
    scores = q @ k.T                                          # [M, N]
    lse_row = torch.logsumexp(scores, dim=1)                  # log row-sums of A
    lse_col = torch.logsumexp(scores, dim=0)                  # log col-sums of A
    j = torch.exp(scores - 0.5 * lse_row[:, None] - 0.5 * lse_col[None, :])
    s2, u = torch.linalg.eigh(j @ j.T)                        # ascending
    s2, u = s2.flip(0), u.flip(1)
    if not return_vectors:
        return s2, None
    s = torch.sqrt(torch.clamp_min(s2, 1e-30))
    ln_half = torch.exp(-0.5 * lse_col)                       # L_N^{1/2} diagonal
    return s2, ln_half[:, None] * (j.T @ (u / s[None, :]))


def flare_spectrum_dense(q: torch.Tensor, k: torch.Tensor):
    """O(N^3) oracle: the eigenvalues of the materialised W, descending, and
    W [N, N] (tests only)."""
    scores = _wide(q) @ _wide(k).T
    w = torch.softmax(scores, dim=0).T @ torch.softmax(scores, dim=-1)
    eig = torch.linalg.eigvals(w)   # W is similar to a PSD matrix: a real spectrum
    return torch.sort(eig.real, descending=True).values, w


def effective_rank(eigvals: torch.Tensor, *, threshold: float = 0.99) -> torch.Tensor:
    """The modes that capture ``threshold`` of the spectral energy (App. C.2):
    the count of cumulative shares below it, plus one. As the reference, a
    tensor of several rows counts as one spectrum (flattened): take one
    head's eigenvalues at a time."""
    e = torch.clamp_min(eigvals.flatten(), 0.0)
    c = torch.cumsum(e, dim=0) / torch.clamp_min(e.sum(), 1e-30)
    return (c < threshold).sum() + 1


def spectrum_by_head(q_latent: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Over heads: q_latent [H, M, D], k [H, N, D] -> eigvals [H, M]."""
    return torch.stack([flare_spectrum(qh, kh, return_vectors=False)[0]
                        for qh, kh in zip(q_latent, k)])
