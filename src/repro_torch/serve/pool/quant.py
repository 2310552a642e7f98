"""Block-storage quantization for the paged pool: int8 / fp8 with per-row
scales, dequantized on read.

Counterpart of ``repro/serve/pool/quant.py``. Scales are per token row (one
fp32 scale per everything except the last, feature, axis), so a decode
append quantizes its row alone and resident rows are never re-scaled; the
int8 error is at most ``amax_row / (2 * 127)``. ``"none"`` keeps the leaf's
own dtype (lossless); ``"fp8"`` stores ``torch.float8_e4m3fn``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

INT8_MAX = 127.0
FP8_MAX = 448.0   # e4m3fn's largest finite value


@dataclasses.dataclass(frozen=True)
class QuantSpec:
    """How a paged leaf is stored: payload dtype, and whether scales exist."""

    name: str                          # "none" | "int8" | "fp8"
    store_dtype: Optional[torch.dtype]  # None = the leaf's own dtype
    scaled: bool

    def storage_dtype(self, leaf_dtype: torch.dtype) -> torch.dtype:
        return leaf_dtype if self.store_dtype is None else self.store_dtype


def get_quant(name: Optional[str]) -> QuantSpec:
    if name in (None, "none"):
        return QuantSpec("none", None, scaled=False)
    if name == "int8":
        return QuantSpec("int8", torch.int8, scaled=True)
    if name == "fp8":
        return QuantSpec("fp8", torch.float8_e4m3fn, scaled=True)
    raise ValueError(f"unknown kv quant {name!r}; known: none, int8, fp8")


def _row_scale(x: torch.Tensor, qmax: float) -> torch.Tensor:
    amax = x.abs().amax(dim=-1)
    # an all-zero row quantizes to zeros under any scale; 1.0 avoids 0/0
    return torch.where(amax > 0, amax / qmax, torch.ones_like(amax)).float()


def quantize(spec: QuantSpec, x: torch.Tensor) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """x [..., D] -> (payload, scale [...] or None). Lossless for "none"."""
    if not spec.scaled:
        return x, None
    xf = x.float()
    if spec.name == "int8":
        s = _row_scale(xf, INT8_MAX)
        return torch.round(xf / s[..., None]).clamp(-INT8_MAX, INT8_MAX).to(torch.int8), s
    s = _row_scale(xf, FP8_MAX)
    return (xf / s[..., None]).to(torch.float8_e4m3fn), s


def dequantize(spec: QuantSpec, data: torch.Tensor, scale: Optional[torch.Tensor],
               out_dtype: torch.dtype) -> torch.Tensor:
    if not spec.scaled:
        return data.to(out_dtype)
    return (data.float() * scale[..., None].float()).to(out_dtype)
