from repro_torch.optim.adamw import AdamWState, adamw_update, init_adamw
from repro_torch.optim.schedule import onecycle_schedule

__all__ = ["AdamWState", "adamw_update", "init_adamw", "onecycle_schedule"]
