from .compose import Compound, compose, recursive_call
from .context import Context, Data
from .expr import (G, L, Range, call, compile_expr, maximum, minimum, select,
                   shl, shr)
from .future import CountableFuture, Future, TriggeredFuture
from .taskclass import In, Mem, Out, Ref, TaskClass, TaskView
from .taskpool import Taskpool

__all__ = [
    "Context", "Data", "Taskpool", "TaskClass", "TaskView",
    "In", "Out", "Mem", "Ref",
    "L", "G", "Range", "select", "call", "minimum", "maximum", "shl", "shr",
    "compile_expr",
    "Compound", "compose", "recursive_call",
    "Future", "CountableFuture", "TriggeredFuture",
]
