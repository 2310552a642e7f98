"""Host-side observability for the port: the counterpart of ``repro.obs``,
trimmed to what the trainer and the serving engine use.

  - :mod:`repro_torch.obs.metrics`: a metrics registry (counters, gauges,
    fixed-bucket histograms; thread-safe, near-zero cost when disabled).
  - :mod:`repro_torch.obs.trace`: span tracing with Chrome-trace-event
    (Perfetto-loadable) export, one track a serving slot.
  - :func:`annotate` / :func:`scope`: ``torch.profiler.record_function``, so a
    ``torch.profiler`` capture carries the same names as the span stream.
    PyTorch runs eagerly, so the JAX package's two kinds (host annotation
    around a compiled program, trace-time scope inside one) are one here.

Clocks and registry mutation stay at host boundaries: nothing here syncs the
device.
"""
from __future__ import annotations

from repro_torch.obs.metrics import NULL_REGISTRY, Counter, Gauge, Histogram, MetricsRegistry
from repro_torch.obs.trace import NULL_TRACER, PHASES, TID_ENGINE, Span, Tracer

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry", "NULL_REGISTRY", "NULL_TRACER",
           "PHASES", "Span", "TID_ENGINE", "Tracer", "annotate", "scope"]


def annotate(name: str):
    """A named range in ``torch.profiler`` traces around host dispatch:
    ``with annotate("train/step"): ...``."""
    import torch

    return torch.profiler.record_function(name)


scope = annotate
