"""sgemm through the DTD front end: every (m, n, k) product inserted as
one `DtdTaskpool.insert_cuda_task`, one launch a task.  The insert loop
is a frozen copy of parsec_tpu_torch/tools/bench_dtd_gemm.py's.

A and B are installed once and stay resident; a solve's C starts as
zeros.  A solve: the insert loop, `wait()`, the exec stream's
synchronize.  C stays in the device tiles.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from harness import tiles
from parsec_tpu_torch.data import TwoDimBlockCyclic
from parsec_tpu_torch.device.bench_utils import wait_device_tiles
from parsec_tpu_torch.dsl.dtd import DtdTaskpool


def k_gemm(a, b, c):
    return c + a @ b


class Driver:
    def __init__(self, ctx, dev, config, traffic, inputs):
        n, nb = int(traffic["N"]), int(config["NB"])
        self.ctx, self.dev, self.nb = ctx, dev, nb
        self.nt = n // nb
        self.A, self.B, self.C = (
            TwoDimBlockCyclic(n, n, nb, nb, dtype=np.float32)
            for _ in range(3))
        for name, coll in (("A", self.A), ("B", self.B), ("C", self.C)):
            coll.register(ctx, name)
        tiles.install(dev, self.A, tiles.stack(inputs["A"], self.A))
        tiles.install(dev, self.B, tiles.stack(inputs["B"], self.B))
        self.zeros = tiles.stack(torch.zeros_like(inputs["A"]), self.C)

    def reinstall(self) -> None:
        tiles.install(self.dev, self.C, self.zeros)

    def solve(self) -> dict:
        A, B, C, dev, nt = self.A, self.B, self.C, self.dev, self.nt
        t0 = time.perf_counter()
        dtd = DtdTaskpool(self.ctx)
        shapes = {i: (self.nb, self.nb) for i in range(3)}
        for m in range(nt):
            for n in range(nt):
                for k in range(nt):
                    dtd.insert_cuda_task(
                        dev, k_gemm,
                        (dtd.tile_of(A, m, k), "INPUT"),
                        (dtd.tile_of(B, k, n), "INPUT"),
                        (dtd.tile_of(C, m, n), "INOUT"), shapes=shapes)
        t1 = time.perf_counter()
        dtd.wait()
        t2 = time.perf_counter()
        wait_device_tiles(dev, C)
        t3 = time.perf_counter()
        dtd.destroy()
        return {"build": (t0, t1), "run_wait": (t1, t2), "drain": (t2, t3)}

    def output(self) -> dict:
        return {"C": tiles.dense(self.dev, self.C)}
