"""OneCycleLR (paper D.3: warmup to peak, then cosine decay).

Counterpart of ``repro/optim/schedule.py``, on a Python step count: the
learning rate is a host float, so the schedule costs the device nothing.
"""
from __future__ import annotations

import math


def onecycle_schedule(step: int, *, total_steps: int, peak_lr: float, warmup_frac: float = 0.1,
                      final_div: float = 1e4) -> float:
    """Linear warmup for warmup_frac of steps, cosine decay to peak/final_div."""
    warm = max(1.0, warmup_frac * total_steps)
    if step < warm:
        return peak_lr * step / warm
    prog = min(max((step - warm) / max(1.0, total_steps - warm), 0.0), 1.0)
    floor = peak_lr / final_div
    return floor + 0.5 * (peak_lr - floor) * (1.0 + math.cos(math.pi * prog))
