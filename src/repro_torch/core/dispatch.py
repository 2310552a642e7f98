"""Typed mixer-backend registry and capability dispatch.

Counterpart of ``repro/core/dispatch.py``, trimmed to what one device needs:
no mesh, no sharded backends, no legacy ``impl`` tuples. Every FLARE mixer
implementation registers a :class:`MixerBackend` saying what it can do
(which contract: the bidirectional set mixer of the PDE surrogate or the
causal LM mixer of ``flare_lm``; device kinds, dtypes, whether autograd runs
through it) and how to run (a ``plan`` function and ``run``). A backend that
breaks the contract of its path is an error, never a fallback.

Device kinds are ``torch.device`` types: ``"cpu"`` and ``"cuda"``. Backends
live in :mod:`repro_torch.backends`; importing that package fills the
registry, which happens lazily here.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Any, Callable, Mapping, Optional

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

    causal: bool = False           # satisfies the causal LM-mixer contract
    bidirectional: bool = True     # satisfies the set-mixer contract
    device_kinds: tuple = ("cpu", "cuda")
    dtypes: Optional[tuple] = None  # dtype names; None = any floating dtype
    grads: bool = True             # autograd runs through ``run``


@dataclasses.dataclass(frozen=True)
class MixerPlan:
    """A resolved execution plan: a backend's name and what its ``run`` needs
    beyond q, k and v (the plain causal scan's ``chunk_size``). The kernels' tiles
    are fixed; launch parameters join ``params`` with the autotuner."""

    backend: str
    params: Mapping[str, Any] = dataclasses.field(default_factory=dict)

    def describe(self) -> str:
        inner = ";".join(f"{k}={v}" for k, v in self.params.items())
        return f"{self.backend}({inner})" if inner else self.backend


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
             grad: bool = False, causal: bool = False) -> bool:
    caps = backend.caps
    if not (caps.causal if causal else caps.bidirectional):
        return False
    if device not in caps.device_kinds:
        return False
    if grad and not caps.grads:
        return False
    return caps.dtypes is None or _dtype_name(dtype) in caps.dtypes


def _check_contract(backend: MixerBackend, causal: bool, grad: bool) -> None:
    """A backend named explicitly must still meet the contract: a
    bidirectional mixer on the causal path would leak future tokens, so that
    is an error, never a fallback."""
    if causal and not backend.caps.causal:
        raise ValueError(
            f"backend {backend.name!r} is not causal — using it as an LM mixer "
            "would leak future tokens (registered causal backends: "
            f"{sorted(b.name for b in _REGISTRY.values() if b.caps.causal)})")
    if not causal and not backend.caps.bidirectional:
        raise ValueError(
            f"backend {backend.name!r} only implements the causal contract and "
            "cannot serve the bidirectional (set-mixer) path")
    if grad and not backend.caps.grads:
        raise ValueError(
            f"backend {backend.name!r} is forward-only and cannot serve a "
            "differentiated path; grad-capable backends: "
            f"{sorted(b.name for b in _REGISTRY.values() if b.caps.grads)}")


def resolve(impl, *, shape: MixerShape, dtype, device: str = "cuda", grad: bool = False,
            causal: bool = False):
    """Normalize ``impl`` ("auto", a backend name, or a MixerPlan) to a
    ``(MixerBackend, MixerPlan)`` pair for ``device`` (a device kind).

    ``grad=True`` marks a differentiated call site: "auto" considers only
    grad-capable backends, and naming a forward-only one is an error.
    ``causal=True`` marks the LM path: only causal backends serve it, and
    only bidirectional ones serve the default set-mixer path."""
    _ensure_loaded()
    if impl is None:
        impl = "auto"
    if isinstance(impl, MixerPlan):
        backend = get_backend(impl.backend)
        _check_contract(backend, causal, grad)
        return backend, impl
    if not isinstance(impl, str):
        raise TypeError(f"impl must be str | MixerPlan, got {type(impl)!r}")
    if impl == "auto":
        cands = [b for b in _REGISTRY.values()
                 if eligible(b, dtype=dtype, device=device, grad=grad, causal=causal)]
        if not cands:
            raise ValueError(f"no eligible mixer backend (causal={causal}, device={device}, "
                             f"dtype={_dtype_name(dtype)}, grad={grad})")
        best = max(cands, key=lambda b: b.score(shape, device))
        return best, best.plan(shape, dtype)
    backend = get_backend(impl)
    _check_contract(backend, causal, grad)
    if device not in backend.caps.device_kinds:
        raise ValueError(f"backend {impl!r} does not run on {device!r}")
    return backend, backend.plan(shape, dtype)
