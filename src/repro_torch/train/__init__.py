from repro_torch.train.steps import make_eval_step, make_train_step
from repro_torch.train.trainer import Trainer

__all__ = ["make_eval_step", "make_train_step", "Trainer"]
