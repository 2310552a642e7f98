"""Core modules: Linear (dense), Embedding, LayerNorm, RMSNorm, ResMLP, SwiGLU,
GeluMLP.

Counterpart of ``repro/nn/modules.py``. Parameters live in ``nn.Module``s;
compute follows the same mixed-precision rule: parameters are cast to the
activation dtype at use, norms keep fp32 statistics. Two layouts differ from
the JAX package and ``repro_torch.interop`` converts them: a dense layer is an
``nn.Linear`` whose ``weight`` is ``[out, in]`` (JAX stores ``kernel`` as
``[in, out]``).

Initialisers draw from an explicit ``torch.Generator`` and move the result
to ``device``: a CPU generator gives the same weights on every device; a
card's generator draws there (its stream differs from the CPU's).
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn


def truncated_normal_(t: torch.Tensor, stddev: float, generator: torch.Generator) -> torch.Tensor:
    """In place: a standard normal truncated to [-2, 2], times ``stddev``
    (``jax.random.truncated_normal(key, -2, 2) * stddev``), by the inverse
    CDF as JAX draws it: u uniform on (erf(-2/sqrt2), erf(2/sqrt2)), then
    sqrt2 * erfinv(u). One pass over the tensor, and the same draws in every
    torch version: ``nn.init.trunc_normal_`` rejection-samples in recent
    versions, redrawing the whole tensor each round, several times slower on
    the CPU, where a 2.6B-parameter model is drawn."""
    bound = math.erf(2.0 / math.sqrt(2.0))
    with torch.no_grad():
        t.uniform_(-bound, bound, generator=generator).erfinv_()
        return t.mul_(math.sqrt(2.0) * stddev).clamp_(-2.0 * stddev, 2.0 * stddev)


def _param(shape, stddev: float, generator, device, dtype) -> nn.Parameter:
    """Drawn on the generator's device (the CPU's, or a card's for weights
    too large to draw on the host in time), then moved to ``device``."""
    t = torch.empty(shape, dtype=torch.float32, device=generator.device)
    t = truncated_normal_(t, stddev, generator)
    return nn.Parameter(t.to(device=device, dtype=dtype))


# ---------------------------------------------------------------------------
# Linear
# ---------------------------------------------------------------------------

def init_dense(in_dim: int, out_dim: int, *, generator: torch.Generator,
               use_bias: bool = False, device=None, dtype=torch.float32) -> nn.Linear:
    """Fan-in init: truncated normal with stddev 1/sqrt(in_dim); zero bias."""
    layer = nn.Linear(in_dim, out_dim, bias=use_bias, device="meta")
    layer.weight = _param((out_dim, in_dim), 1.0 / math.sqrt(in_dim), generator, device, dtype)
    if use_bias:
        layer.bias = nn.Parameter(torch.zeros(out_dim, device=device, dtype=dtype))
    return layer


def dense(layer: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    bias = None if layer.bias is None else layer.bias.to(x.dtype)
    return F.linear(x, layer.weight.to(x.dtype), bias)


# ---------------------------------------------------------------------------
# Embedding
# ---------------------------------------------------------------------------

class Embedding(nn.Module):
    """Parameter ``table`` [vocab, dim] as in the JAX tree."""

    def __init__(self, table: nn.Parameter):
        super().__init__()
        self.table = table


def init_embedding(vocab: int, dim: int, *, generator: torch.Generator, device=None,
                   dtype=torch.float32) -> Embedding:
    """Truncated normal with stddev 1/sqrt(dim)."""
    return Embedding(_param((vocab, dim), 1.0 / math.sqrt(dim), generator, device, dtype))


def embedding(emb: Embedding, ids: torch.Tensor, dtype=torch.bfloat16) -> torch.Tensor:
    """Rows of the table for ``ids``, cast to ``dtype`` (the table is cast
    row by row, after the gather)."""
    return emb.table[ids].to(dtype)


# ---------------------------------------------------------------------------
# Norms (fp32 statistics)
# ---------------------------------------------------------------------------

class LayerNorm(nn.Module):
    """Parameters ``scale`` and ``bias`` as in the JAX tree."""

    def __init__(self, dim: int, *, eps: float = 1e-5, device=None, dtype=torch.float32):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(dim, device=device, dtype=dtype))
        self.bias = nn.Parameter(torch.zeros(dim, device=device, dtype=dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layernorm(self, x)


def init_layernorm(dim: int, *, device=None, dtype=torch.float32) -> LayerNorm:
    return LayerNorm(dim, device=device, dtype=dtype)


def layernorm(ln: LayerNorm, x: torch.Tensor, *, eps: Optional[float] = None) -> torch.Tensor:
    """Statistics in fp32, or in x's dtype where it is wider (fp64 oracles)."""
    eps = ln.eps if eps is None else eps
    wide = torch.promote_types(x.dtype, torch.float32)
    xw = x.to(wide)
    mu = xw.mean(dim=-1, keepdim=True)
    var = (xw - mu).square().mean(dim=-1, keepdim=True)
    y = (xw - mu) * torch.rsqrt(var + eps)
    y = y * ln.scale.to(wide) + ln.bias.to(wide)
    return y.to(x.dtype)


class RMSNorm(nn.Module):
    """Parameter ``scale`` as in the JAX tree."""

    def __init__(self, dim: int, *, device=None, dtype=torch.float32):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(dim, device=device, dtype=dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return rmsnorm(self, x)


def init_rmsnorm(dim: int, *, device=None, dtype=torch.float32) -> RMSNorm:
    return RMSNorm(dim, device=device, dtype=dtype)


def rmsnorm(norm: RMSNorm, x: torch.Tensor, *, eps: float = 1e-6) -> torch.Tensor:
    """x / rms(x) * scale with fp32 statistics, in x's dtype. The default eps
    is the JAX ``rmsnorm``'s; the LM passes its config's ``norm_eps``."""
    x32 = x.float()
    ms = x32.square().mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(ms + eps) * norm.scale.float()).to(x.dtype)


# ---------------------------------------------------------------------------
# ResMLP (paper Appendix B): linear in -> L residual (linear+GELU) -> linear out
# ---------------------------------------------------------------------------

class ResMLP(nn.Module):
    def __init__(self, w_in: nn.Linear, res: list, w_out: nn.Linear):
        super().__init__()
        self.w_in = w_in
        self.res = nn.ModuleList(res)
        self.w_out = w_out

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return resmlp(self, x)


def init_resmlp(in_dim: int, hidden_dim: int, out_dim: int, num_layers: int, *,
                generator: torch.Generator, device=None, dtype=torch.float32) -> ResMLP:
    mk = lambda i, o: init_dense(i, o, generator=generator, use_bias=True,
                                 device=device, dtype=dtype)
    return ResMLP(mk(in_dim, hidden_dim),
                  [mk(hidden_dim, hidden_dim) for _ in range(num_layers)],
                  mk(hidden_dim, out_dim))


def resmlp(mlp: ResMLP, x: torch.Tensor) -> torch.Tensor:
    """Input residual when C_i == C_h, output residual when C_h == C_o; each
    residual layer is ``h = h + GELU(W h)`` with the tanh GELU, which is
    ``jax.nn.gelu``'s default."""
    in_dim, hid_dim = mlp.w_in.in_features, mlp.w_in.out_features
    out_dim = mlp.w_out.out_features
    h = dense(mlp.w_in, x)
    if in_dim == hid_dim:
        h = h + x
    for layer in mlp.res:
        h = h + F.gelu(dense(layer, h), approximate="tanh")
    y = dense(mlp.w_out, h)
    if hid_dim == out_dim:
        y = y + h
    return y


# ---------------------------------------------------------------------------
# SwiGLU MLP (LLaMA-family FFN)
# ---------------------------------------------------------------------------

class SwiGLU(nn.Module):
    def __init__(self, w_gate: nn.Linear, w_up: nn.Linear, w_down: nn.Linear):
        super().__init__()
        self.w_gate = w_gate
        self.w_up = w_up
        self.w_down = w_down

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return swiglu(self, x)


def init_swiglu(dim: int, hidden: int, *, generator: torch.Generator, device=None,
                dtype=torch.float32) -> SwiGLU:
    mk = lambda i, o: init_dense(i, o, generator=generator, device=device, dtype=dtype)
    return SwiGLU(mk(dim, hidden), mk(dim, hidden), mk(hidden, dim))


def swiglu(mlp: SwiGLU, x: torch.Tensor) -> torch.Tensor:
    """w_down(silu(w_gate x) * w_up x), bias-free."""
    return dense(mlp.w_down, F.silu(dense(mlp.w_gate, x)) * dense(mlp.w_up, x))


# ---------------------------------------------------------------------------
# GELU MLP (the classic transformer FFN; the PDE baselines' MLP)
# ---------------------------------------------------------------------------

class GeluMLP(nn.Module):
    def __init__(self, w_up: nn.Linear, w_down: nn.Linear):
        super().__init__()
        self.w_up = w_up
        self.w_down = w_down

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return gelu_mlp(self, x)


def init_gelu_mlp(dim: int, hidden: int, *, generator: torch.Generator, device=None,
                  dtype=torch.float32) -> GeluMLP:
    mk = lambda i, o: init_dense(i, o, generator=generator, use_bias=True,
                                 device=device, dtype=dtype)
    return GeluMLP(mk(dim, hidden), mk(hidden, dim))


def gelu_mlp(mlp: GeluMLP, x: torch.Tensor) -> torch.Tensor:
    """w_down(GELU(w_up x)), both biased; the tanh GELU, ``jax.nn.gelu``'s default."""
    return dense(mlp.w_down, F.gelu(dense(mlp.w_up, x), approximate="tanh"))


def count_params(module: nn.Module) -> int:
    return sum(p.numel() for p in module.parameters())
