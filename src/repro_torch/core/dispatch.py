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

Call sites hand their ``impl`` to :func:`resolve`, or to the wrappers
:func:`run_mixer` / :func:`run_causal_mixer`, which resolve for the device
of their tensors. ``python -m repro_torch.core.dispatch --list`` prints every
registered backend against the four canonical policies on this process's
device (:func:`device_kind`) and exits 1 where a policy has no eligible
backend or a backend is eligible both with and without a mesh.
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
    beyond q, k and v: the plain causal scan's ``chunk_size``, or the FLARE
    kernels' launch parameters ``block_m`` and ``block_n`` from
    :mod:`repro_torch.backends.autotune`, with the ``shape`` they were chosen
    for."""

    backend: str
    params: Mapping[str, Any] = dataclasses.field(default_factory=dict)

    def describe(self) -> str:
        """``name(key=value;...)``, the mesh and the shape left out
        (``mesh_shape`` names the one) and tuples joined by '+', so the
        string stays comma-free."""
        fmt = lambda v: "+".join(map(str, v)) if isinstance(v, (tuple, list)) else str(v)
        inner = ";".join(f"{k}={fmt(v)}" for k, v in self.params.items()
                         if k not in ("mesh", "shape"))
        return f"{self.backend}({inner})" if inner else self.backend


@dataclasses.dataclass(frozen=True)
class MixerBackend:
    name: str
    caps: Capabilities
    # plan(shape, mesh, dtype, device kind)
    plan: Callable[[MixerShape, Any, Any, str], MixerPlan]
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


def backends(*, causal: Optional[bool] = None, sharded: Optional[bool] = None) -> list:
    """The registered backends by name, optionally only those that serve the
    causal (``causal=True``) or the set-mixer (``causal=False``) contract, or
    those that are (not) sharded."""
    _ensure_loaded()
    out = []
    for b in _REGISTRY.values():
        if causal is not None and not (b.caps.causal if causal else b.caps.bidirectional):
            continue
        if sharded is not None and b.caps.sharded is not sharded:
            continue
        out.append(b)
    return sorted(out, key=lambda b: b.name)


def device_kind() -> str:
    """The device kind this process runs the port on: ``"cuda"`` where a
    card is present, else ``"cpu"``."""
    return "cuda" if torch.cuda.is_available() else "cpu"


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
                return backend, backend.plan(shape, mesh, dtype, device)
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
    return backend, backend.plan(shape, mesh, dtype, device)


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
                                    dtype if dtype is not None else torch.float32, device)
        except ValueError:
            if want_packed:
                raise
    if covered:
        return MixerPlan("seqparallel", {"mesh": mesh, "seq_axes": seq})
    return MixerPlan("seqlat", {"mesh": mesh, "seq_axes": seq, "lat_axes": lat})


def describe(impl, *, shape: MixerShape, dtype=torch.float32, mesh=None,
             causal: bool = False) -> str:
    """The backend and plan that would run (``MixerPlan.describe``) on
    :func:`device_kind`."""
    _, plan = resolve(impl, shape=shape, dtype=dtype, device=device_kind(), mesh=mesh,
                      causal=causal)
    return plan.describe()


def run_mixer(impl, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, mesh=None,
              grad: bool = False) -> torch.Tensor:
    """Bidirectional (set-mixer) FLARE: q [H, M, D], k/v [B, H, N, D] ->
    [B, H, N, D], resolved for the device of ``k``."""
    backend, plan = resolve(impl, shape=MixerShape.from_qkv(q, k), dtype=k.dtype,
                            device=k.device.type, mesh=mesh, causal=False, grad=grad)
    return backend.run(plan, q, k, v)


def run_causal_mixer(impl, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                     chunk_size: Optional[int] = None, grad: bool = False) -> torch.Tensor:
    """Causal (LM-mixer) FLARE: token t sees only the prefix <= t;
    ``chunk_size`` overrides the plan's."""
    backend, plan = resolve(impl, shape=MixerShape.from_qkv(q, k), dtype=k.dtype,
                            device=k.device.type, causal=True, grad=grad)
    if chunk_size is not None:
        plan = MixerPlan(plan.backend, {**plan.params, "chunk_size": chunk_size})
    return backend.run(plan, q, k, v)


# A stand-in mesh for the eligibility columns: eligibility asks only whether
# a call site runs under a mesh, not where its ranks are.
_PROBE_MESH = object()


def _policy_matrix(device: str):
    """Every registered backend x the four canonical policies (set-mixer or
    causal x inference or training) on ``device``: eligible, or why not; and
    the two mesh columns, eligible now (no mesh) and with a mesh, of which
    exactly one may say "yes"."""
    from repro_torch.core.policy import MixerPolicy, resolve_policy

    shape = MixerShape(batch=1, heads=4, tokens=1024, latents=16, head_dim=8)
    policies = {
        "bidi/infer": (MixerPolicy(), False),
        "bidi/train": (MixerPolicy(requires_grad=True), False),
        "causal/infer": (MixerPolicy(), True),
        "causal/train": (MixerPolicy(requires_grad=True), True),
    }
    rows = []
    for b in backends():
        cells = {}
        for label, (pol, causal) in policies.items():
            try:
                plan = resolve_policy(pol.with_(backends=(b.name,)), shape, torch.float32,
                                      device=device, causal=causal)
                ok = eligible(b, dtype=torch.float32, device=device, grad=pol.requires_grad,
                              causal=causal, mesh=plan.params.get("mesh"), shape=shape)
                cells[label] = "yes" if ok else "named-only"
            except ValueError as e:
                msg = str(e)
                cells[label] = ("no-grad" if "forward-only" in msg else
                                "no-causal" if "not causal" in msg else
                                "no-bidi" if "causal contract" in msg else "no")
        cells["now"] = "yes" if eligible(b, dtype=torch.float32, device=device) else "no"
        cells["with-mesh"] = "yes" if eligible(b, dtype=torch.float32, device=device,
                                               mesh=_PROBE_MESH) else "no"
        rows.append((b, cells))
    return shape, policies, rows


def main(argv: Optional[Sequence[str]] = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.core.dispatch",
        description="Print the mixer-backend registry and each backend's eligibility under "
                    "the canonical policies.")
    ap.add_argument("--list", action="store_true",
                    help="also print each backend's description")
    args = ap.parse_args(argv)
    _ensure_loaded()
    device = device_kind()
    shape, policies, rows = _policy_matrix(device)
    print(f"device={device}  probe shape: N={shape.tokens} M={shape.latents} "
          f"D={shape.head_dim} H={shape.heads}")
    cols = list(policies)
    header = (f"{'backend':<14} {'grads':<5} {'now':<4} {'with-mesh':<9} "
              + " ".join(f"{c:<13}" for c in cols))
    print(header)
    print("-" * len(header))
    for b, cells in rows:
        print(f"{b.name:<14} {'yes' if b.caps.grads else 'no':<5} {cells['now']:<4} "
              f"{cells['with-mesh']:<9} " + " ".join(f"{cells[c]:<13}" for c in cols)
              + (f"  # {b.doc}" if args.list and b.doc else ""))
    # each canonical policy needs an eligible backend
    for c in cols:
        if not any(cells[c] == "yes" for _, cells in rows):
            print(f"ERROR: no eligible backend for policy {c}")
            return 1
    # and no backend may be eligible both with and without a mesh
    for b, cells in rows:
        if cells["now"] == "yes" and cells["with-mesh"] == "yes":
            print(f"ERROR: backend {b.name} eligible both with and without a mesh")
            return 1
    return 0


if __name__ == "__main__":
    # ``python -m repro_torch.core.dispatch`` runs this file as __main__, a
    # second module instance with its own empty registry: delegate to the
    # canonical instance the backends register against.
    from repro_torch.core import dispatch as _canonical

    raise SystemExit(_canonical.main())
