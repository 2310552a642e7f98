"""Continuous-batching serving: the slot scheduler, the dense and the
block-paged cache pools, on-device sampling and the engine."""
from repro_torch.serve.cache import ModelSlotCache, insert_slots, slot_axes
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.scheduler import ServeRequest, SlotScheduler

__all__ = ["ServeEngine", "ServeRequest", "SlotScheduler", "ModelSlotCache", "insert_slots",
           "slot_axes"]
