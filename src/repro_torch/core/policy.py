"""Plan-first mixer dispatch: MixerPolicy -> (resolve once) -> MixerPlan.

Counterpart of ``repro/core/policy.py`` without the legacy spellings or the
causal ``chunk_size`` override. A :class:`MixerPolicy` says what the caller
wants (backend preference order, whether the call is differentiated, a
dtype to resolve for, a precision hint, whether to time the kernels' launch
parameters, and for a mesh, which axes split the tokens and the latents);
:func:`resolve_policy` turns it into a :class:`MixerPlan` once, at model
build; :func:`run_plan` runs a plan. The contract: ``requires_grad=True``
never resolves to a forward-only backend, and under a mesh only sharded
backends resolve.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional, Tuple, Union

import torch

from repro_torch.core import dispatch
from repro_torch.core.dispatch import MixerPlan, MixerShape


@dataclasses.dataclass(frozen=True)
class MixerPolicy:
    """A declarative mixer-dispatch request (frozen, hashable).

    backends: preference order; each entry is "auto" (capability-scored
      pick) or a backend name. Resolution returns the first entry that meets
      the contract, so ``("packed", "sdpa")`` means "the fused kernel where
      it is legal, the reference elsewhere".
    requires_grad: the policy feeds a differentiated call site; only
      grad-capable backends may resolve.
    dtype: a dtype name (or torch dtype) to resolve for instead of the
      data's; stored as its name ("float32", "bfloat16").
    precision: matmul precision hint recorded in the plan's params
      ("default" | "high" | "highest").
    seq_axes / lat_axes: under a mesh, the axes the tokens and the latents
      (heads, for ``packed_shard``) split over; with ``seq_axes`` set the
      sharded form comes from :func:`repro_torch.core.dispatch.sharded_plan`.
    autotune: tri-state opt-in for the timed search of the kernels' launch
      parameters at resolve (:mod:`repro_torch.backends.autotune`; None =
      follow the REPRO_AUTOTUNE env var).
    """

    backends: Tuple[str, ...] = ("auto",)
    requires_grad: bool = False
    dtype: Optional[str] = None
    precision: Optional[str] = None
    seq_axes: Optional[Union[str, Tuple[str, ...]]] = None
    lat_axes: Optional[Union[str, Tuple[str, ...]]] = None
    autotune: Optional[bool] = None

    def __post_init__(self):
        b = (self.backends,) if isinstance(self.backends, str) else tuple(self.backends)
        object.__setattr__(self, "backends", b)
        if self.dtype is not None:
            name = str(self.dtype).removeprefix("torch.")
            if not isinstance(getattr(torch, name, None), torch.dtype):
                raise ValueError(f"MixerPolicy: unknown dtype {self.dtype!r}")
            object.__setattr__(self, "dtype", name)

    def with_(self, **overrides) -> "MixerPolicy":
        return dataclasses.replace(self, **overrides)

    def describe(self) -> str:
        # every non-default field: an explicit autotune=False (opting out of
        # REPRO_AUTOTUNE=1) must read differently from unset
        shown = {f.name: getattr(self, f.name) for f in dataclasses.fields(self)
                 if getattr(self, f.name) != getattr(_DEFAULT_POLICY, f.name)}
        inner = ";".join(f"{k}={v}" for k, v in shown.items())
        return f"MixerPolicy({inner})" if inner else "MixerPolicy(auto)"


_DEFAULT_POLICY = MixerPolicy()
_STACK: list = [_DEFAULT_POLICY]


def current_policy() -> MixerPolicy:
    """The innermost active policy (the default policy at depth 0)."""
    return _STACK[-1]


@contextlib.contextmanager
def mixer_policy(policy: Optional[MixerPolicy] = None, **overrides):
    """Push a policy for the extent of the ``with`` block;
    ``mixer_policy(requires_grad=True)`` layers overrides onto the current one."""
    base = current_policy() if policy is None else policy
    new = base.with_(**overrides) if overrides else base
    _STACK.append(new)
    try:
        yield new
    finally:
        _STACK.pop()


PolicyLike = Union[MixerPolicy, MixerPlan, None]


def resolve_policy(policy: PolicyLike, shape: MixerShape, dtype=torch.float32, *,
                   device: str = "cuda", requires_grad: Optional[bool] = None,
                   causal: bool = False, mesh=None) -> MixerPlan:
    """Resolve a policy (None = the ambient one) to a plan for ``device``
    (a device kind) on the causal LM path (``causal=True``) or the
    set-mixer path, for this rank's tokens of ``mesh`` when one is given.
    ``requires_grad`` overrides the policy's own field."""
    if policy is None:
        policy = current_policy()
    if isinstance(policy, MixerPlan):
        rg = current_policy().requires_grad if requires_grad is None else requires_grad
        return dispatch.resolve(policy, shape=shape, dtype=dtype, device=device, grad=rg,
                                causal=causal, mesh=mesh)[1]
    if not isinstance(policy, MixerPolicy):
        raise TypeError(f"policy must be MixerPolicy | MixerPlan | None, got {type(policy)!r}")
    rg = policy.requires_grad if requires_grad is None else requires_grad
    if policy.dtype is not None:
        dtype = getattr(torch, policy.dtype)
    with _autotune_override(policy.autotune):
        plan = _resolve(policy, shape, dtype, device=device, grad=rg, causal=causal, mesh=mesh)
    if policy.precision is not None:
        plan = MixerPlan(plan.backend, {**plan.params, "precision": policy.precision})
    return plan


def _resolve(policy: MixerPolicy, shape: MixerShape, dtype, *, device: str, grad: bool,
             causal: bool, mesh) -> MixerPlan:
    """The sharded pick under a mesh with axis hints, else the first backend
    in the preference order that meets the contract."""
    if mesh is not None and policy.seq_axes is not None:
        named = policy.backends if policy.backends != ("auto",) else ()
        plan = dispatch.sharded_plan(mesh, policy.seq_axes, policy.lat_axes or "model",
                                     shape=shape, dtype=dtype, prefer=named, device=device)
        if named and plan.backend not in named:
            # a named backend is a contract everywhere else in this API: never
            # override it silently with the axis pick
            raise ValueError(f"policy names backends {policy.backends!r} but its seq/lat axis "
                             f"hints resolve to {plan.backend!r} on this mesh; drop the "
                             "explicit names (use 'auto') or the axis hints")
        dispatch._check_contract(dispatch.get_backend(plan.backend), causal, grad)
        return plan
    errors = []
    for name in policy.backends:
        try:
            return dispatch.resolve(name, shape=shape, dtype=dtype, device=device, grad=grad,
                                    causal=causal, mesh=mesh)[1]
        except ValueError as e:
            if len(policy.backends) == 1:
                raise
            errors.append(f"{name}: {e}")
    raise ValueError(f"no backend in preference order {policy.backends!r} satisfies "
                     f"(causal={causal}, requires_grad={grad}, device={device}):\n  "
                     + "\n  ".join(errors))


@contextlib.contextmanager
def _autotune_override(enabled: Optional[bool]):
    """``autotune.forced(enabled)`` around a resolution, unless unset."""
    if enabled is None:
        yield
        return
    from repro_torch.backends import autotune

    with autotune.forced(enabled):
        yield


def run_plan(plan: MixerPlan, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Execute a resolved plan: one registry lookup, no resolution."""
    return dispatch.get_backend(plan.backend).run(plan, q, k, v)
