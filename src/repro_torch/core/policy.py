"""Plan-first mixer dispatch: MixerPolicy -> (resolve once) -> MixerPlan.

Counterpart of ``repro/core/policy.py`` without autotune, dtype or precision
overrides, or the legacy spellings. A :class:`MixerPolicy` says what the
caller wants (backend preference order, whether the call is differentiated,
and for a mesh, which axes split the tokens and the latents);
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
    seq_axes / lat_axes: under a mesh, the axes the tokens and the latents
      (heads, for ``packed_shard``) split over; with ``seq_axes`` set the
      sharded form comes from :func:`repro_torch.core.dispatch.sharded_plan`.
    """

    backends: Tuple[str, ...] = ("auto",)
    requires_grad: bool = False
    seq_axes: Optional[Union[str, Tuple[str, ...]]] = None
    lat_axes: Optional[Union[str, Tuple[str, ...]]] = None

    def __post_init__(self):
        b = (self.backends,) if isinstance(self.backends, str) else tuple(self.backends)
        object.__setattr__(self, "backends", b)

    def with_(self, **overrides) -> "MixerPolicy":
        return dataclasses.replace(self, **overrides)


_STACK: list = [MixerPolicy()]


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
        dispatch._check_contract(dispatch.get_backend(plan.backend), causal, rg)
        return plan
    errors = []
    for name in policy.backends:
        try:
            return dispatch.resolve(name, shape=shape, dtype=dtype, device=device, grad=rg,
                                    causal=causal, mesh=mesh)[1]
        except ValueError as e:
            if len(policy.backends) == 1:
                raise
            errors.append(f"{name}: {e}")
    raise ValueError(f"no backend in preference order {policy.backends!r} satisfies "
                     f"(causal={causal}, requires_grad={rg}, device={device}):\n  "
                     + "\n  ".join(errors))


def run_plan(plan: MixerPlan, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Execute a resolved plan: one registry lookup, no resolution."""
    return dispatch.get_backend(plan.backend).run(plan, q, k, v)
