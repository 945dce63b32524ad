"""spotrf through the panel DAG (`algos.build_potrf_panels`) with the
matrix in host memory, as DPLASMA runs `testing_spotrf -g 1`: the
descriptor's tiles are host arrays, the program's device module stages
each tile onto the card for the tasks that read it (or ahead of them,
its prefetch lane) and writes the factor back to the host tiles.

The user's side of the loop:
  - `reinstall`: a fresh copy of the pristine matrix written into the
    host tiles (one torch copy a tile, on the host's intra-op threads),
    then the tiles declared rewritten (`Collection.host_wrote()`), so
    that no device serves a mirror of the previous solve's factor.
  - `solve`: the builder call, `tp.run()`, `tp.wait()`, then
    `CudaDevice.flush()`, which writes every dirty mirror back: when it
    returns, L is in the host tiles.  Spans `build`, `run_wait`,
    `flush`.
  - `output`: the factor read from the host tiles, not from the card.

The deadline: a step (a re-install, a solve, a read of the factor) that
lasts past the workload's `deadline_s` ends the run at once with exit
code 3 and no result line, so that a program that cannot run the path
fails and does not hang.
"""
from __future__ import annotations

import contextlib
import os
import sys
import threading
import time

import numpy as np
import torch

from parsec_tpu_torch.algos import build_potrf_panels
from parsec_tpu_torch.data import TwoDimBlockCyclic
from parsec_tpu_torch.device.cuda import local_tile_index

DEADLINE_EXIT = 3        # the exit code of a run a step's deadline ends


class Driver:
    def __init__(self, ctx, dev, config, traffic, inputs):
        n, nb = int(traffic["N"]), int(config["NB"])
        self.ctx, self.dev = ctx, dev
        self.deadline_s = float(traffic["deadline_s"])
        self.A = TwoDimBlockCyclic(n, n, n, nb, dtype=np.float32)
        self.A.register(ctx, "A")
        self.idx = local_tile_index(self.A)
        # the host tiles, made once: the runtime reads these arrays
        self.host = [torch.from_numpy(self.A.tile(m, k))
                     for m, k in self.idx]
        a = inputs["A"]
        self.pristine = [a[m * self.A.mb:(m + 1) * self.A.mb,
                           k * nb:(k + 1) * nb].to("cpu", copy=True)
                         for m, k in self.idx]

    @contextlib.contextmanager
    def _deadline(self, what: str):
        """End the run at once if `what` outlasts the deadline."""
        def fail():
            sys.stderr.write(f"potrf_host: {what} ran past its deadline "
                             f"of {self.deadline_s} s; the run ends "
                             f"(exit {DEADLINE_EXIT})\n")
            sys.stderr.flush()
            os._exit(DEADLINE_EXIT)
        t = threading.Timer(self.deadline_s, fail)
        t.daemon = True
        t.start()
        try:
            yield
        finally:
            t.cancel()

    def reinstall(self) -> None:
        with self._deadline("a re-install"):
            for dst, src in zip(self.host, self.pristine):
                dst.copy_(src)
            self.A.host_wrote()

    def solve(self) -> dict:
        with self._deadline("a solve"):
            t0 = time.perf_counter()
            tp = build_potrf_panels(self.ctx, self.A, dev=self.dev)
            t1 = time.perf_counter()
            tp.run()
            tp.wait()
            t2 = time.perf_counter()
            self.dev.flush()
            t3 = time.perf_counter()
            tp.destroy()
        return {"build": (t0, t1), "run_wait": (t1, t2), "flush": (t2, t3)}

    def output(self) -> dict:
        """The factor as the host tiles hold it, one dense float32
        matrix on the host."""
        mb, nb = self.A.mb, self.A.nb
        with self._deadline("a read of the factor"):
            out = torch.empty((self.A.M, self.A.N), dtype=torch.float32)
            for (m, k), tile in zip(self.idx, self.host):
                out[m * mb:(m + 1) * mb, k * nb:(k + 1) * nb] = tile
        return {"A": out}
