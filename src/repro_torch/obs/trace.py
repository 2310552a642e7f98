"""Span tracing with Chrome-trace-event export.

Counterpart of ``repro/obs/trace.py`` (stdlib only), with what the trainer
records: complete spans from timestamps the caller already holds, and
instants. ``enabled=False`` (or :data:`NULL_TRACER`) makes every record call
one attribute read. :meth:`Tracer.write` exports the Chrome trace-event JSON
object format (Perfetto, ``chrome://tracing``), sorted by time and rebased
to the first event in microseconds.
"""
from __future__ import annotations

import dataclasses
import json
import threading
import time
from typing import List, Optional

#: the track of run-wide events (train steps, checkpoints)
TID_ENGINE = 0


@dataclasses.dataclass
class Span:
    name: str
    ph: str               # "X" complete | "i" instant
    ts: float             # seconds, time.time() timebase
    dur: float = 0.0      # seconds; 0 for instants
    cat: str = "train"
    tid: int = TID_ENGINE
    args: Optional[dict] = None


class Tracer:
    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self._events: List[Span] = []
        self._lock = threading.Lock()

    def complete(self, name: str, ts: float, dur: float, *, cat: str = "train",
                 tid: int = TID_ENGINE, args: Optional[dict] = None) -> None:
        """Record a finished interval (seconds, ``time.time`` timebase)."""
        if not self.enabled:
            return
        with self._lock:
            self._events.append(Span(name, "X", ts, max(dur, 0.0), cat=cat, tid=tid, args=args))

    def instant(self, name: str, *, ts: Optional[float] = None, cat: str = "train",
                tid: int = TID_ENGINE, args: Optional[dict] = None) -> None:
        if not self.enabled:
            return
        ts = time.time() if ts is None else ts
        with self._lock:
            self._events.append(Span(name, "i", ts, 0.0, cat=cat, tid=tid, args=args))

    @property
    def events(self) -> List[Span]:
        return list(self._events)

    def to_chrome(self, pid: int = 1, process_name: str = "repro_torch") -> dict:
        with self._lock:
            events = sorted(self._events, key=lambda e: (e.ts, e.name))
        t0 = events[0].ts if events else 0.0
        out: List[dict] = [{"name": "process_name", "ph": "M", "pid": pid, "tid": 0,
                            "args": {"name": process_name}}]
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


#: permanently disabled tracer, the default for uninstrumented construction
NULL_TRACER = Tracer(enabled=False)
