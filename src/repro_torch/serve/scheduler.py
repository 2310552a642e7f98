"""Slot scheduler for the continuous-batching engine.

The port's copy of ``repro/serve/scheduler.py`` (pure Python, no JAX),
with its metrics in the port's registry. The engine owns the device pool;
the scheduler owns *which request lives in which slot*:

  - **FIFO admission**: waiting requests are admitted into free slots in
    submission order, every step. Deterministic by construction (no
    randomness, no reordering), which the reproducibility tests pin.
  - **Slot free-list**: retirement returns a slot to the free list; the
    lowest-numbered free slot is always assigned next.
  - **Per-request deadlines**: a request whose deadline expires while still
    queued is dropped at admission time (never occupies a slot); an admitted
    request always runs to completion.
  - **Stats**: per-request latencies (total + first-token) for p50/p99, and
    per-decode-step slot-occupancy samples for the utilization stat the
    no-idle-waste acceptance check reads.
  - **Metrics**: admissions, retirements and deadline drops
    also count into a :class:`repro.obs.metrics.MetricsRegistry` (the
    engine passes its own; the default is the disabled null registry, so an
    uninstrumented scheduler pays one branch per event). ``stats()``
    surfaces the registry-backed totals plus the live queue depth.

A queued request may hold prefix-cache references (``prefix_blocks``, taken
when it was submitted); the engine's ``on_drop`` hook gives them back when
the request's deadline expires in the queue.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.obs.metrics import NULL_REGISTRY, MetricsRegistry


def percentile(xs, q: float) -> float:
    """Percentile with defined behaviour at every size — the latency lists
    arrive empty (no finished requests yet) or single-sample (one request)
    all the time in smoke runs:

      - empty   -> ``nan`` (explicitly "no data", never a crash)
      - [x]     -> ``x`` for every q (np.percentile agrees, but pin it)
      - else    -> linear-interpolated ``np.percentile``
    """
    if len(xs) == 0:
        return float("nan")
    if len(xs) == 1:
        return float(xs[0])
    return float(np.percentile(np.asarray(xs, np.float64), q))


@dataclasses.dataclass
class ServeRequest:
    rid: int
    prompt: np.ndarray                # [S] int32
    max_new_tokens: int = 32
    eos_id: int = -1                  # -1: never stops early
    deadline_s: Optional[float] = None  # relative to submit_t; None = never
    on_token: Optional[Callable[[int, int], None]] = None  # (rid, token), as sampled
    submit_t: float = 0.0
    # runtime bookkeeping (engine/scheduler owned)
    slot: Optional[int] = None
    tokens: List[int] = dataclasses.field(default_factory=list)
    admit_t: Optional[float] = None
    first_token_t: Optional[float] = None
    finish_t: Optional[float] = None
    dropped: bool = False
    # blocks this QUEUED request holds references on from prefix matching;
    # they move into the slot's lease at admission, and ``on_drop`` must
    # release them when the request is dropped while still waiting
    prefix_blocks: List[int] = dataclasses.field(default_factory=list)
    # the pool shard ``prefix_blocks`` belong to: None until matched, 0 on the
    # port's one-shard pool
    prefix_shard: Optional[int] = None

    def expired(self, now: float) -> bool:
        return self.deadline_s is not None and now - self.submit_t > self.deadline_s


class SlotScheduler:
    def __init__(self, num_slots: int,
                 registry: Optional[MetricsRegistry] = None):
        if num_slots < 1:
            raise ValueError("need at least one slot")
        self.num_slots = num_slots
        self.free: List[int] = list(range(num_slots))
        self.waiting: deque[ServeRequest] = deque()
        self.running: Dict[int, ServeRequest] = {}
        self.finished: List[ServeRequest] = []
        self.dropped: List[ServeRequest] = []
        self.admission_log: List[Tuple[int, int]] = []  # (rid, slot)
        self._util: List[int] = []  # active slots per decode step
        reg = registry if registry is not None else NULL_REGISTRY
        self.metrics = reg
        self._m_submitted = reg.counter(
            "sched.submitted", "requests enqueued")
        self._m_admitted = reg.counter(
            "sched.admitted", "requests admitted into a slot")
        self._m_retired = reg.counter(
            "sched.retired", "requests retired (ran to completion)")
        self._m_expired = reg.counter(
            "sched.expired", "queued requests dropped at deadline expiry")
        self._m_queue = reg.gauge(
            "sched.queue_depth", "waiting requests after the last admit")
        # the engine's hook for a request dropped while QUEUED (deadline
        # expiry), so what it took at submit (prefix references) goes back
        self.on_drop: Optional[Callable[[ServeRequest], None]] = None

    # -- queue ------------------------------------------------------------
    def submit(self, req: ServeRequest) -> None:
        self.waiting.append(req)
        self._m_submitted.inc()
        self._m_queue.set(len(self.waiting))

    def admit(self, now: float,
              can_admit: Optional[Callable[[ServeRequest], bool]] = None,
              ) -> List[Tuple[ServeRequest, int]]:
        """Pop waiting requests into free slots, FIFO. Expired-deadline
        requests are dropped without consuming a slot (or any pool pages —
        expiry is checked before the resource gate).

        ``can_admit`` is the engine's resource gate (the paged pool's
        block-availability check): when the HEAD of the queue fails it,
        admission stops for this cycle rather than skipping ahead — pool
        pressure is backpressure, never reordering, so admission order
        stays FIFO by construction."""
        admitted = []
        while self.waiting and self.free:
            req = self.waiting[0]
            if req.expired(now):
                self.waiting.popleft()
                req.dropped = True
                req.finish_t = now
                self.dropped.append(req)
                self._m_expired.inc()
                if self.on_drop is not None:
                    self.on_drop(req)
                continue
            if can_admit is not None and not can_admit(req):
                break
            self.waiting.popleft()
            slot = self.free.pop(0)  # lowest free slot — deterministic
            req.slot = slot
            req.admit_t = now
            self.running[slot] = req
            self.admission_log.append((req.rid, slot))
            admitted.append((req, slot))
        if admitted:
            self._m_admitted.inc(len(admitted))
        self._m_queue.set(len(self.waiting))
        return admitted

    def retire(self, slot: int, now: float) -> ServeRequest:
        req = self.running.pop(slot)
        req.finish_t = now
        self.finished.append(req)
        self.free.append(slot)
        self.free.sort()
        self._m_retired.inc()
        return req

    def has_work(self) -> bool:
        return bool(self.waiting or self.running)

    # -- stats ------------------------------------------------------------
    def note_decode_step(self) -> None:
        self._util.append(len(self.running))

    def stats(self) -> dict:
        done = [r for r in self.finished if r.finish_t is not None]
        total = [r.finish_t - r.submit_t for r in done]
        first = [r.first_token_t - r.submit_t for r in done
                 if r.first_token_t is not None]
        util = float(np.mean(self._util) / self.num_slots) if self._util else 0.0
        return {
            "finished": len(self.finished),
            "dropped": len(self.dropped),
            "waiting": len(self.waiting),
            "running": len(self.running),
            "latency_p50_s": percentile(total, 50),
            "latency_p99_s": percentile(total, 99),
            "first_token_p50_s": percentile(first, 50),
            "first_token_p99_s": percentile(first, 99),
            "slot_utilization": util,
            # registry-backed lifecycle totals (DESIGN.md §16) — all zero
            # when the owner wired no live registry in
            "queue_depth": len(self.waiting),
            "submitted_total": int(self._m_submitted.value),
            "admitted_total": int(self._m_admitted.value),
            "retired_total": int(self._m_retired.value),
            "expired_total": int(self._m_expired.value),
        }
