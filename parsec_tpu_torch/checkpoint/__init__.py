"""Checkpoint / resume.

Port of parsec_tpu/checkpoint.  The reference has NO checkpointing
(SURVEY.md §5 "Checkpoint / resume: Not present"); this package closes
the gap at the framework's two natural boundaries:

  collections  quiescent-point checkpoint of distributed data collections
               (tile payloads + geometry), in the JAX package's file
               format, so that a checkpoint written by either package
               loads in the other.
  train state  torch state save/restore (a module or state_dict, the
               optimizer's moments, the step) as one .npz, a leaf an
               array keyed by its path.
"""
from .checkpoint import (save_collections, load_collections,
                         save_train_state, load_train_state)

__all__ = ["save_collections", "load_collections",
           "save_train_state", "load_train_state"]
