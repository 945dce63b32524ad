"""parsec_tpu_torch: the PyTorch and CUDA port of parsec_tpu.

The same task runtime — the shared native core under native/, driven from
Python through Context -> Taskpool -> TaskClass — with a CUDA device
module (device/cuda.py) whose chores run hand-written Hopper kernels
(kernels/*.cu).  parsec_tpu stays the reference this package is held
against; this package imports torch and nothing of JAX or parsec_tpu.
"""
from ._native import (DEV_CPU, DEV_CUDA, DEV_RECURSIVE, HOOK_AGAIN,
                      HOOK_ASYNC, HOOK_DISABLE, HOOK_DONE, HOOK_ERROR,
                      HOOK_NEXT)
from .core import (Compound, Context, CountableFuture, Data, Future, G, In,
                   L, Mem, Out, Range, Ref, TaskClass, Taskpool, TaskView,
                   TriggeredFuture, call, compose, maximum, minimum,
                   recursive_call, select, shl, shr)

__version__ = "0.1.0"

__all__ = [
    "Context", "Data", "Taskpool", "TaskClass", "TaskView",
    "In", "Out", "Mem", "Ref",
    "L", "G", "Range", "select", "call", "minimum", "maximum", "shl", "shr",
    "Compound", "compose", "recursive_call",
    "Future", "CountableFuture", "TriggeredFuture",
    "HOOK_DONE", "HOOK_AGAIN", "HOOK_ASYNC", "HOOK_NEXT", "HOOK_DISABLE",
    "HOOK_ERROR", "DEV_CPU", "DEV_CUDA", "DEV_RECURSIVE",
    "__version__",
]
