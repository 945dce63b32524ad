"""Model families built on the framework's parallelism libraries.

Port of parsec_tpu/models: a transformer LM with dp/tp/sp(/ep) sharding
and an optional GPipe pipeline over the block stack, and its training
loop with checkpoints.
"""
from .transformer import (TransformerConfig, init_params, forward, loss_fn,
                          train_step, make_sharded_train_step,
                          pipelined_forward)
from .training import (TrainConfig, init_train_state, make_train_step,
                       train, resume_train_state)

__all__ = [
    "TransformerConfig", "init_params", "forward", "loss_fn", "train_step",
    "make_sharded_train_step", "pipelined_forward",
    "TrainConfig", "init_train_state", "make_train_step", "train",
    "resume_train_state",
]
