"""Span tracing with Chrome-trace-event export.

Counterpart of ``repro/obs/trace.py`` (stdlib only). The tracer records what
the serving engine and the trainer already know (the ``time.time()`` stamps
and host integers of their stats), so tracing adds no device work and no
host-device sync: the engine's ``host_syncs_per_step`` and its greedy tokens
are the same with tracing on.

Two event shapes: complete spans (:meth:`Tracer.complete`, Chrome
``ph="X"``, from a start and a duration the caller holds, or timed by the
tracer's own clock in :meth:`Tracer.span`) and instants
(:meth:`Tracer.instant`, ``ph="i"``). ``tid`` is the track: the engine puts
slot-resident events (prefill, retire) on track ``slot + 1`` and engine-wide
ones (enqueue, decode aggregates, train steps) on :data:`TID_ENGINE`;
:meth:`Tracer.set_track_name` names a track. ``enabled=False`` (or
:data:`NULL_TRACER`) makes every record call one attribute read.

:meth:`Tracer.write` exports the Chrome trace-event JSON object format
(Perfetto, ``chrome://tracing``): events sorted by time and rebased to the
first event, in microseconds, the track names as metadata events.
"""
from __future__ import annotations

import dataclasses
import json
import threading
import time
from typing import Dict, List, Optional

__all__ = ["Span", "Tracer", "NULL_TRACER", "TID_ENGINE", "PHASES"]

#: the track of engine-wide (not slot-resident) events
TID_ENGINE = 0

#: the request-lifecycle phases the engine emits, each at least once a run
PHASES = ("enqueue", "admit", "prefill", "decode", "retire")


@dataclasses.dataclass
class Span:
    name: str
    ph: str               # "X" complete | "i" instant
    ts: float             # seconds, time.time() timebase
    dur: float = 0.0      # seconds; 0 for instants
    cat: str = "serve"
    tid: int = TID_ENGINE
    args: Optional[dict] = None


class Tracer:
    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self._events: List[Span] = []
        self._tid_names: Dict[int, str] = {}
        self._lock = threading.Lock()

    # -- recording ---------------------------------------------------------
    def now(self) -> float:
        """The tracer's clock: ``time.time()``, the timebase the engine and
        the scheduler stamp requests with."""
        return time.time()

    def complete(self, name: str, ts: float, dur: float, *, cat: str = "serve",
                 tid: int = TID_ENGINE, args: Optional[dict] = None) -> None:
        """Record a finished interval (seconds, ``time.time`` timebase); a
        negative duration is clamped to 0."""
        if not self.enabled:
            return
        with self._lock:
            self._events.append(Span(name, "X", ts, max(dur, 0.0), cat=cat, tid=tid, args=args))

    def instant(self, name: str, *, ts: Optional[float] = None, cat: str = "serve",
                tid: int = TID_ENGINE, args: Optional[dict] = None) -> None:
        if not self.enabled:
            return
        ts = time.time() if ts is None else ts
        with self._lock:
            self._events.append(Span(name, "i", ts, 0.0, cat=cat, tid=tid, args=args))

    def span(self, name: str, *, cat: str = "serve", tid: int = TID_ENGINE,
             args: Optional[dict] = None) -> "_SpanCtx":
        """A context manager recording the interval it encloses by the
        tracer's own clock, for callers that hold no stamps."""
        return _SpanCtx(self, name, cat, tid, args)

    def set_track_name(self, tid: int, name: str) -> None:
        if self.enabled:
            self._tid_names[tid] = name

    # -- introspection -----------------------------------------------------
    @property
    def events(self) -> List[Span]:
        return list(self._events)

    def by_phase(self) -> Dict[str, List[Span]]:
        """The events grouped by name, each group in recording order."""
        out: Dict[str, List[Span]] = {}
        for e in self._events:
            out.setdefault(e.name, []).append(e)
        return out

    def clear(self) -> None:
        with self._lock:
            self._events.clear()

    # -- export ------------------------------------------------------------
    def to_chrome(self, pid: int = 1, process_name: str = "repro_torch") -> dict:
        with self._lock:
            events = sorted(self._events, key=lambda e: (e.ts, e.name))
        t0 = events[0].ts if events else 0.0
        out: List[dict] = [{"name": "process_name", "ph": "M", "pid": pid, "tid": 0,
                            "args": {"name": process_name}}]
        for tid, name in sorted(self._tid_names.items()):
            out.append({"name": "thread_name", "ph": "M", "pid": pid, "tid": tid,
                        "args": {"name": name}})
        for e in events:
            rec = {"name": e.name, "cat": e.cat, "ph": e.ph, "ts": (e.ts - t0) * 1e6,
                   "pid": pid, "tid": e.tid}
            if e.ph == "X":
                rec["dur"] = e.dur * 1e6
            else:
                rec["s"] = "t"   # instant scope: thread
            if e.args:
                rec["args"] = e.args
            out.append(rec)
        return {"traceEvents": out, "displayTimeUnit": "ms"}

    def write(self, path: str, **kw) -> int:
        """Export to ``path``; returns the number of recorded events."""
        with open(path, "w", encoding="utf-8") as f:
            json.dump(self.to_chrome(**kw), f, indent=1)
            f.write("\n")
        return len(self._events)


class _SpanCtx:
    __slots__ = ("_tr", "_name", "_cat", "_tid", "_args", "_t0")

    def __init__(self, tr: Tracer, name: str, cat: str, tid: int, args: Optional[dict]):
        self._tr, self._name, self._cat, self._tid, self._args = tr, name, cat, tid, args
        self._t0 = 0.0

    def __enter__(self) -> "_SpanCtx":
        self._t0 = time.time()
        return self

    def __exit__(self, *exc) -> bool:
        if self._tr.enabled:
            self._tr.complete(self._name, self._t0, time.time() - self._t0, cat=self._cat,
                              tid=self._tid, args=self._args)
        return False


#: permanently disabled tracer, the default for uninstrumented construction
NULL_TRACER = Tracer(enabled=False)
