"""Typed mixer-backend registry and capability dispatch.

Counterpart of ``repro/core/dispatch.py`` without the legacy ``impl``
tuples. Every FLARE mixer implementation registers a :class:`MixerBackend`
saying what it can do (which contract: the bidirectional set mixer of the
PDE surrogate or the causal LM mixer of ``flare_lm``; device kinds, dtypes,
whether autograd runs through it, whether it needs a mesh, which head dims
its kernel takes on the card) and how to run (a ``plan`` function and
``run``). A backend that breaks the contract of its path is an error, never
a fallback.

Meshes: a sharded backend runs on this rank's slice of the tokens, so it is
eligible only with a mesh, and a dense backend never with one (each rank
would mix its own tokens alone). :func:`sharded_plan` picks the sharded form
for a mesh and its axes.

Head dims: a kernel backend names the D its kernel takes
(``Capabilities.head_dims``); on the card "auto" passes over it at any other
D, and naming it there raises at resolve time, never at launch. The CPU runs
the plain versions, which take any D.

Device kinds are ``torch.device`` types: ``"cpu"`` and ``"cuda"``. Backends
live in :mod:`repro_torch.backends`; importing that package fills the
registry, which happens lazily here.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Any, Callable, Mapping, Optional, Sequence

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
    sharded: bool = False          # runs on this rank's tokens; needs a mesh in its plan
    device_kinds: tuple = ("cpu", "cuda")
    dtypes: Optional[tuple] = None  # dtype names; None = any floating dtype
    grads: bool = True             # autograd runs through ``run``
    # the head dims the kernel takes on the card (a container); None = any D
    head_dims: Any = None


@dataclasses.dataclass(frozen=True)
class MixerPlan:
    """A resolved execution plan: a backend's name and what its ``run`` needs
    beyond q, k and v (the plain causal scan's ``chunk_size``). The kernels' tiles
    are fixed; launch parameters join ``params`` with the autotuner."""

    backend: str
    params: Mapping[str, Any] = dataclasses.field(default_factory=dict)

    def describe(self) -> str:
        """``name(key=value;...)``, the mesh left out (``mesh_shape`` names
        it) and tuples joined by '+', so the string stays comma-free."""
        fmt = lambda v: "+".join(map(str, v)) if isinstance(v, (tuple, list)) else str(v)
        inner = ";".join(f"{k}={fmt(v)}" for k, v in self.params.items() if k != "mesh")
        return f"{self.backend}({inner})" if inner else self.backend


@dataclasses.dataclass(frozen=True)
class MixerBackend:
    name: str
    caps: Capabilities
    plan: Callable[[MixerShape, Any, Any], MixerPlan]   # plan(shape, mesh, dtype)
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


def takes_head_dim(backend: MixerBackend, head_dim: int, device: str) -> bool:
    """Whether the backend runs head dim ``head_dim`` on ``device`` (its
    kernel's limit applies on the card only)."""
    dims = backend.caps.head_dims
    return device != "cuda" or dims is None or head_dim in dims


def eligible(backend: MixerBackend, *, dtype, device: str = "cuda", grad: bool = False,
             causal: bool = False, mesh=None, shape: Optional[MixerShape] = None) -> bool:
    caps = backend.caps
    if not (caps.causal if causal else caps.bidirectional):
        return False
    if caps.sharded != (mesh is not None):
        return False
    if device not in caps.device_kinds:
        return False
    if grad and not caps.grads:
        return False
    if shape is not None and not takes_head_dim(backend, shape.head_dim, device):
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


def _check_head_dim(backend: MixerBackend, shape: MixerShape, device: str) -> None:
    if not takes_head_dim(backend, shape.head_dim, device):
        raise ValueError(f"backend {backend.name!r}: its kernel does not take head dim "
                         f"D={shape.head_dim} on {device!r}")


def resolve(impl, *, shape: MixerShape, dtype, device: str = "cuda", grad: bool = False,
            causal: bool = False, mesh=None):
    """Normalize ``impl`` ("auto", a backend name, or a MixerPlan) to a
    ``(MixerBackend, MixerPlan)`` pair for ``device`` (a device kind).

    ``grad=True`` marks a differentiated call site: "auto" considers only
    grad-capable backends, and naming a forward-only one is an error.
    ``causal=True`` marks the LM path: only causal backends serve it, and
    only bidirectional ones serve the default set-mixer path. ``mesh``:
    the call site runs on this rank's tokens of a mesh; "auto" then considers
    only sharded backends (without one, only dense ones), highest score
    first, and one whose plan rejects the shape gives way to the next."""
    _ensure_loaded()
    if impl is None:
        impl = "auto"
    if isinstance(impl, MixerPlan):
        backend = get_backend(impl.backend)
        _check_contract(backend, causal, grad)
        _check_head_dim(backend, shape, device)
        return backend, impl
    if not isinstance(impl, str):
        raise TypeError(f"impl must be str | MixerPlan, got {type(impl)!r}")
    if impl == "auto":
        cands = [b for b in _REGISTRY.values()
                 if eligible(b, dtype=dtype, device=device, grad=grad, causal=causal,
                             mesh=mesh, shape=shape)]
        if not cands:
            raise ValueError(f"no eligible mixer backend (causal={causal}, device={device}, "
                             f"dtype={_dtype_name(dtype)}, grad={grad}, "
                             f"mesh={mesh is not None}, D={shape.head_dim})")
        cands.sort(key=lambda b: b.score(shape, device), reverse=True)
        errors = []
        for backend in cands:
            try:
                return backend, backend.plan(shape, mesh, dtype)
            except ValueError as e:
                errors.append(f"{backend.name}: {e}")
        raise ValueError("auto: every eligible backend rejected the shape at plan time:\n  "
                         + "\n  ".join(errors))
    backend = get_backend(impl)
    _check_contract(backend, causal, grad)
    if device not in backend.caps.device_kinds:
        raise ValueError(f"backend {impl!r} does not run on {device!r}")
    _check_head_dim(backend, shape, device)
    if mesh is not None and not backend.caps.sharded:
        raise ValueError(f"backend {impl!r} is not sharded: under a mesh each rank holds a "
                         "slice of the tokens, which a dense mixer would mix alone")
    return backend, backend.plan(shape, mesh, dtype)


def sharded_plan(mesh, seq_axes, lat_axes="model", *, shape: Optional[MixerShape] = None,
                 dtype=None, prefer: Sequence[str] = (), device: str = "cuda") -> MixerPlan:
    """Pick the sharded FLARE form for a mesh: 1D sequence-parallel when the
    token axes cover the mesh (the ``lat_axes`` included), else the 2D seq x
    latent form, so that the latent axis keeps its ranks busy.

    With a ``shape``, the kernel form ``packed_shard`` is tried first: always
    when ``prefer`` names it, and by default on the card (where it is the
    fast path; on the CPU it runs the plain versions, so the plain forms
    keep the default). A shape it cannot take falls back to the plain forms
    unless ``packed_shard`` was named."""
    from repro_torch.distributed.compat import axes_tuple

    seq, lat = axes_tuple(seq_axes), axes_tuple(lat_axes)
    named = tuple(prefer or ())
    want_packed = "packed_shard" in named
    covered = all(a in seq for a in lat)
    if shape is not None and (want_packed or (not named and not covered and device == "cuda")):
        from repro_torch.backends.packed_shard import build_shard_plan

        lat_eff = () if covered else lat
        seq_eff = tuple(a for a in seq if a not in lat_eff)
        try:
            _check_head_dim(get_backend("packed_shard"), shape, device)
            return build_shard_plan(shape, mesh, seq_eff, lat_eff,
                                    dtype if dtype is not None else torch.float32)
        except ValueError:
            if want_packed:
                raise
    if covered:
        return MixerPlan("seqparallel", {"mesh": mesh, "seq_axes": seq})
    return MixerPlan("seqlat", {"mesh": mesh, "seq_axes": seq, "lat_axes": lat})
