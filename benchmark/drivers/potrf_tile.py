"""spotrf through the tiled dpotrf_L DAG (`algos.build_potrf`): NB x NB
tiles, POTRF / TRSM / SYRK / GEMM task classes, each ready wave of a
class one batched launch on the card.

A solve: the builder call, `tp.run()`, `tp.wait()`, the exec stream's
synchronize.  The factor stays in the device tiles.
"""
from __future__ import annotations

import time

import numpy as np

from harness import tiles
from parsec_tpu_torch.algos import build_potrf
from parsec_tpu_torch.data import TwoDimBlockCyclic
from parsec_tpu_torch.device.bench_utils import wait_device_tiles


class Driver:
    def __init__(self, ctx, dev, config, traffic, inputs):
        n, nb = int(traffic["N"]), int(config["NB"])
        self.ctx, self.dev = ctx, dev
        self.A = TwoDimBlockCyclic(n, n, nb, nb, dtype=np.float32)
        self.A.register(ctx, "A")
        self.pristine = tiles.stack(inputs["A"], self.A)

    def reinstall(self) -> None:
        tiles.install(self.dev, self.A, self.pristine)

    def solve(self) -> dict:
        t0 = time.perf_counter()
        tp = build_potrf(self.ctx, self.A, dev=self.dev)
        t1 = time.perf_counter()
        tp.run()
        tp.wait()
        t2 = time.perf_counter()
        wait_device_tiles(self.dev, self.A)
        t3 = time.perf_counter()
        tp.destroy()
        return {"build": (t0, t1), "run_wait": (t1, t2), "drain": (t2, t3)}

    def output(self) -> dict:
        return {"A": tiles.dense(self.dev, self.A)}
