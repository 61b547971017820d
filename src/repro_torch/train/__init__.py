"""Training substrate: optimizers, train step, checkpointing, data."""
from repro_torch.train.data import DataConfig, TokenStream
from repro_torch.train.optimizer import (AdamW, Adafactor, clip_by_global_norm,
                                         global_norm, make_optimizer)
from repro_torch.train.trainer import (default_microbatches, init_train_state,
                                       make_train_step)

__all__ = ["DataConfig", "TokenStream", "AdamW", "Adafactor",
           "clip_by_global_norm", "global_norm", "make_optimizer",
           "default_microbatches", "init_train_state", "make_train_step"]
