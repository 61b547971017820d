"""Training substrate: optimizers, train step, checkpointing, data."""
from repro_torch.train.data import DataConfig, TokenStream
from repro_torch.train.optimizer import (AdamW, Adafactor, clip_by_global_norm,
                                         global_norm, make_optimizer)
from repro_torch.train.trainer import (abstract_train_state,
                                       default_microbatches, init_train_state,
                                       make_train_step, train_state_axes)

__all__ = ["DataConfig", "TokenStream", "AdamW", "Adafactor",
           "clip_by_global_norm", "global_norm", "make_optimizer",
           "abstract_train_state", "default_microbatches", "init_train_state",
           "make_train_step", "train_state_axes"]
