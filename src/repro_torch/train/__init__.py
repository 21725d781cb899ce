"""The LM training path: the PyTorch counterpart of ``repro.train``."""
from repro_torch.train.optimizer import (OptimizerConfig, OptState,
                                         adamw_update, init_opt_state,
                                         lr_schedule)
from repro_torch.train.train_step import (cross_entropy, loss_fn,
                                          make_train_state, train_step)
from repro_torch.train import checkpoint, compression, fault

__all__ = ["OptimizerConfig", "OptState", "adamw_update", "init_opt_state",
           "lr_schedule", "cross_entropy", "loss_fn", "make_train_state",
           "train_step", "checkpoint", "compression", "fault"]
