"""sgemm through the PTG GEMM (`algos.build_gemm`): Gemm(m, n, k) tasks
carry each C tile down its k-chain, a ready wave one batched product on
the card, certified waves chained by the wave compiler.

A and B are installed once and stay resident; a solve's C starts as
zeros.  A solve: the builder call, `tp.run()`, `tp.wait()`, the exec
stream's synchronize.  C stays in the device tiles.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from harness import tiles
from parsec_tpu_torch.algos import build_gemm
from parsec_tpu_torch.data import TwoDimBlockCyclic
from parsec_tpu_torch.device.bench_utils import wait_device_tiles


class Driver:
    def __init__(self, ctx, dev, config, traffic, inputs):
        n, nb = int(traffic["N"]), int(config["NB"])
        self.ctx, self.dev = ctx, dev
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
        t0 = time.perf_counter()
        tp = build_gemm(self.ctx, self.A, self.B, self.C, dev=self.dev)
        t1 = time.perf_counter()
        tp.run()
        tp.wait()
        t2 = time.perf_counter()
        wait_device_tiles(self.dev, self.C)
        t3 = time.perf_counter()
        tp.destroy()
        return {"build": (t0, t1), "run_wait": (t1, t2), "drain": (t2, t3)}

    def output(self) -> dict:
        return {"C": tiles.dense(self.dev, self.C)}
