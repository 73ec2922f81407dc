"""Training runtime: step function, trainer loop, fault handling."""
from repro_torch.train.train_step import TrainHyper, make_train_step
from repro_torch.train.trainer import Trainer, TrainerConfig

__all__ = ["TrainHyper", "make_train_step", "Trainer", "TrainerConfig"]
