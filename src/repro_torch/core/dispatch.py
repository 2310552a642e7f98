"""Typed mixer-backend registry and capability dispatch.

Counterpart of ``repro/core/dispatch.py``, trimmed to what one device needs:
no mesh, no sharded backends, no legacy ``impl`` tuples, and only the
bidirectional (set-mixer) contract, the one the PDE surrogate uses. Every
FLARE mixer implementation registers a :class:`MixerBackend` saying what it
can do (device kinds, dtypes, whether autograd runs through it) and how to
run (a ``plan`` function and ``run``).

Device kinds are ``torch.device`` types: ``"cpu"`` and ``"cuda"``. Backends
live in :mod:`repro_torch.backends`; importing that package fills the
registry, which happens lazily here.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Any, Callable, Optional

import torch


@dataclasses.dataclass(frozen=True)
class MixerShape:
    """The problem shape the resolver and the planner see."""

    batch: int
    heads: int
    tokens: int     # N
    latents: int    # M
    head_dim: int   # D

    @staticmethod
    def from_qkv(q: torch.Tensor, k: torch.Tensor) -> "MixerShape":
        return MixerShape(batch=k.shape[0], heads=k.shape[1], tokens=k.shape[2],
                          latents=q.shape[-2], head_dim=k.shape[-1])


@dataclasses.dataclass(frozen=True)
class Capabilities:
    """What a backend may be selected for."""

    device_kinds: tuple = ("cpu", "cuda")
    dtypes: Optional[tuple] = None  # dtype names; None = any floating dtype
    grads: bool = True             # autograd runs through ``run``


@dataclasses.dataclass(frozen=True)
class MixerPlan:
    """A resolved execution plan. The kernels' tiles are fixed, so a plan is
    its backend's name; launch parameters join it with the autotuner."""

    backend: str

    def describe(self) -> str:
        return self.backend


@dataclasses.dataclass(frozen=True)
class MixerBackend:
    name: str
    caps: Capabilities
    plan: Callable[[MixerShape, Any], MixerPlan]   # plan(shape, dtype)
    run: Callable[..., torch.Tensor]               # run(plan, q, k, v) -> y
    # score(shape, device_kind) -> float; the highest eligible score wins "auto"
    score: Callable[[MixerShape, str], float] = lambda shape, device: 0.0
    doc: str = ""


_REGISTRY: dict = {}
_LOADED = False


def register(backend: MixerBackend) -> MixerBackend:
    _REGISTRY[backend.name] = backend
    return backend


def _ensure_loaded() -> None:
    global _LOADED
    if not _LOADED:
        importlib.import_module("repro_torch.backends")
        _LOADED = True


def get_backend(name: str) -> MixerBackend:
    _ensure_loaded()
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown mixer backend {name!r}; registered: {sorted(_REGISTRY)}") from None


def _dtype_name(dtype) -> str:
    return str(dtype).removeprefix("torch.")


def eligible(backend: MixerBackend, *, dtype, device: str = "cuda",
             grad: bool = False) -> bool:
    caps = backend.caps
    if device not in caps.device_kinds:
        return False
    if grad and not caps.grads:
        return False
    return caps.dtypes is None or _dtype_name(dtype) in caps.dtypes


def _check_contract(backend: MixerBackend, grad: bool) -> None:
    """A backend named explicitly must still meet the contract: that is an
    error, never a fallback."""
    if grad and not backend.caps.grads:
        raise ValueError(
            f"backend {backend.name!r} is forward-only and cannot serve a "
            "differentiated path; grad-capable backends: "
            f"{sorted(b.name for b in _REGISTRY.values() if b.caps.grads)}")


def resolve(impl, *, shape: MixerShape, dtype, device: str = "cuda", grad: bool = False):
    """Normalize ``impl`` ("auto", a backend name, or a MixerPlan) to a
    ``(MixerBackend, MixerPlan)`` pair for ``device`` (a device kind).

    ``grad=True`` marks a differentiated call site: "auto" considers only
    grad-capable backends, and naming a forward-only one is an error."""
    _ensure_loaded()
    if impl is None:
        impl = "auto"
    if isinstance(impl, MixerPlan):
        backend = get_backend(impl.backend)
        _check_contract(backend, grad)
        return backend, impl
    if not isinstance(impl, str):
        raise TypeError(f"impl must be str | MixerPlan, got {type(impl)!r}")
    if impl == "auto":
        cands = [b for b in _REGISTRY.values()
                 if eligible(b, dtype=dtype, device=device, grad=grad)]
        if not cands:
            raise ValueError(f"no eligible mixer backend (device={device}, "
                             f"dtype={_dtype_name(dtype)}, grad={grad})")
        best = max(cands, key=lambda b: b.score(shape, device))
        return best, best.plan(shape, dtype)
    backend = get_backend(impl)
    _check_contract(backend, grad)
    if device not in backend.caps.device_kinds:
        raise ValueError(f"backend {impl!r} does not run on {device!r}")
    return backend, backend.plan(shape, dtype)
