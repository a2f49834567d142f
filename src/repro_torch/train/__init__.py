"""Training substrate: optimizer, train step, checkpointing, elasticity
(port of ``repro.train``; the sharding specs wait for the LM sharding
slice)."""

from .optimizer import AdamWConfig, adamw_init, adamw_update, cosine_lr
from .train_step import TrainState, init_state, make_train_step
from .checkpoint import CheckpointManager, state_from_reference, \
    state_to_reference

__all__ = [
    "AdamWConfig", "adamw_init", "adamw_update", "cosine_lr",
    "TrainState", "init_state", "make_train_step",
    "CheckpointManager", "state_to_reference", "state_from_reference",
]
