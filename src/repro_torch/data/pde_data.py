"""PDE data generated by a solver, on the device.

Counterpart of ``repro/data/pde_data.py``. Darcy family: a log-normal
coefficient field a(x) (a Gaussian random field by spectral filtering), then

    -div( a(x) grad u(x) ) = f,   u = 0 on the boundary

solved by matrix-free conjugate gradients on a regular grid. Inputs per
point are (x, y, a) and the target is u. The point-cloud variant subsamples
grid nodes with the same numpy Philox draw as the JAX package, so both pick
the same nodes. Batches are deterministic functions of (seed, index); the
GRF noise comes from a ``torch.Generator`` and so differs from JAX's.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def _grf_filter(n: int, *, alpha: float = 3.0, device=None) -> torch.Tensor:
    """Spectral decay |k|^-alpha on the n x n FFT grid, zero at k = 0."""
    f = torch.fft.fftfreq(n, device=device)
    k2 = f[:, None] ** 2 + f[None, :] ** 2
    return torch.where(k2 == 0, 0.0, (k2 + 1e-6) ** (-alpha / 2.0))


def _grf_from_noise(noise: torch.Tensor, *, alpha: float = 3.0) -> torch.Tensor:
    """Filter white noise [..., n, n] into a unit-std Gaussian random field."""
    filt = _grf_filter(noise.shape[-1], alpha=alpha, device=noise.device)
    field = torch.fft.ifft2(torch.fft.fft2(noise) * filt).real
    std = field.std(dim=(-2, -1), correction=0, keepdim=True)
    return field / std.clamp_min(1e-9)


def _grf(generator: torch.Generator, n: int, *, batch: int = 1, alpha: float = 3.0,
         device=None) -> torch.Tensor:
    """[batch, n, n] Gaussian random fields; noise drawn from ``generator``
    (a CPU generator, so one seed gives the same field on every device)."""
    noise = torch.randn((batch, n, n), generator=generator)
    return _grf_from_noise(noise.to(device), alpha=alpha)


def _apply_operator(u: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """Matrix-free A u = -div(a grad u) on [..., n, n], homogeneous Dirichlet
    BCs, face-averaged coefficients."""
    n = u.shape[-1]
    h2 = 1.0 / ((n + 1) ** 2)
    up = F.pad(u, (1, 1, 1, 1))                                   # zero Dirichlet
    lead = a.shape[:-2]
    ap = F.pad(a.reshape(-1, 1, n, n), (1, 1, 1, 1), mode="replicate").reshape(*lead, n + 2, n + 2)
    c = ap[..., 1:-1, 1:-1]
    uc = up[..., 1:-1, 1:-1]
    du = (0.5 * (c + ap[..., 2:, 1:-1]) * (up[..., 2:, 1:-1] - uc)
          + 0.5 * (c + ap[..., :-2, 1:-1]) * (up[..., :-2, 1:-1] - uc)
          + 0.5 * (c + ap[..., 1:-1, 2:]) * (up[..., 1:-1, 2:] - uc)
          + 0.5 * (c + ap[..., 1:-1, :-2]) * (up[..., 1:-1, :-2] - uc))
    return -du / h2


def _cg_solve(a: torch.Tensor, f: torch.Tensor, *, iters: int = 200) -> torch.Tensor:
    """Conjugate gradients for A u = f (A SPD), per problem over [..., n, n]."""
    dot = lambda x, y: (x * y).sum(dim=(-2, -1), keepdim=True)
    u = torch.zeros_like(f)
    r = f - _apply_operator(u, a)
    p = r
    rs = dot(r, r)
    for _ in range(iters):
        ap = _apply_operator(p, a)
        alpha = rs / dot(p, ap).clamp_min(1e-30)
        u = u + alpha * p
        r = r - alpha * ap
        rs_new = dot(r, r)
        p = r + (rs_new / rs.clamp_min(1e-30)) * p
        rs = rs_new
    return u


def _solve(a: torch.Tensor, *, cg_iters: int):
    """Coefficients [B, n, n] -> (features [B, n*n, 3], targets [B, n*n, 1])."""
    b, n, _ = a.shape
    u = _cg_solve(a, torch.ones_like(a), iters=cg_iters)
    xs = (torch.arange(n, device=a.device, dtype=a.dtype) + 0.5) / n
    xx, yy = torch.meshgrid(xs, xs, indexing="ij")
    feats = torch.stack([xx.expand(b, n, n), yy.expand(b, n, n), a], dim=-1).reshape(b, -1, 3)
    target = u.reshape(b, -1, 1)
    # normalize the target's magnitude for stable relative-L2 training
    return feats, target / target.abs().amax(dim=(1, 2), keepdim=True).clamp_min(1e-9)


def darcy_batch(seed: int, index: int, batch: int, *, grid: int = 32, cg_iters: int = 200,
                device="cuda"):
    """Deterministic batch of solved Darcy problems: x [B, N, 3], y [B, N, 1]
    with N = grid**2, on ``device``."""
    gen = torch.Generator().manual_seed(seed * 1_000_003 + index)
    a = torch.exp(0.5 * _grf(gen, grid, batch=batch, device=device))
    x, y = _solve(a, cg_iters=cg_iters)
    return {"x": x, "y": y}


def subsample_indices(seed: int, index: int, batch: int, n_total: int,
                      num_points: int) -> np.ndarray:
    """[batch, num_points] node indices, the JAX package's Philox draw."""
    rng = np.random.Generator(np.random.Philox(
        key=np.uint64(seed + 77), counter=[np.uint64(index), 0, 0, 0]))
    return np.stack([rng.permutation(n_total)[:num_points] for _ in range(batch)])


def pointcloud_batch(seed: int, index: int, batch: int, *, grid: int = 32,
                     num_points: int = 600, cg_iters: int = 200, device="cuda"):
    """Unstructured variant: a random subsample of grid nodes per example."""
    full = darcy_batch(seed, index, batch, grid=grid, cg_iters=cg_iters, device=device)
    idx = torch.as_tensor(subsample_indices(seed, index, batch, grid * grid, num_points),
                          device=full["x"].device)[:, :, None]
    return {"x": full["x"].gather(1, idx.expand(-1, -1, 3)),
            "y": full["y"].gather(1, idx)}


def darcy_dataset(seed: int, num: int, *, grid: int = 32, batch: int = 8, cg_iters: int = 200,
                  device="cuda") -> list:
    """A small dataset materialised as a list of ``num // batch`` batches,
    batch i ``darcy_batch(seed, i, batch)`` solved on ``device`` and held as
    host numpy arrays."""
    return [{k: v.cpu().numpy() for k, v in darcy_batch(
                seed, i, batch, grid=grid, cg_iters=cg_iters, device=device).items()}
            for i in range(num // batch)]
