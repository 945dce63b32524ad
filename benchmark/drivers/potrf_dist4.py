"""spotrf over a P x Q grid of ranks, one rank a card: DPLASMA's tiled
dpotrf_L DAG (`algos.build_potrf`) on a `TwoDimBlockCyclic` distributed
block-cyclically over the grid, the ranks joined by the program's own
comm engine (`Context.set_rank`, `Context.comm_init`), each rank's tiles
resident on its card.

Rank 0 is the harness's process: its Context and CudaDevice (cuda:0).
Ranks 1 .. P*Q-1 are processes this driver starts, this file run as a
script, each with a Context and CudaDevice of its own on cuda:<rank>
(on the host: device "cpu").  Every rank makes its device before it
joins the comm engine, as the harness does for rank 0.  Each rank is
bound to its share of the host's cores, a block of consecutive ones, as
mpirun's --bind-to binds the ranks of one host, and runs one PyTorch
intra-op thread, as torchrun sets OMP_NUM_THREADS=1 for each of several
processes on a host.  Rank 0 drives
the others over a pair of pipes a rank, one pickled command and one
reply at a time; their standard output and error go to rank 0's
standard error.

Set-up: rank 0 hands each rank its tiles of the seeded matrix the
harness made (copied to the rank's card, then shared by CUDA IPC; on the
host as bytes), and holds the rank's checksum of its copy to its own.

A solve: every rank builds `build_potrf` on its share, runs it, waits,
drains its exec stream and enters the comm engine's fence (every frame
sent before it has landed everywhere).  Rank 0's spans: `build`,
`run_wait`, `drain`, and `fence`, from its drain's end to the last
rank's report.  The factor stays in the device tiles; `output` gathers
it whole on rank 0's card (from another card by CUDA IPC, on the host
as bytes).

The watchdog: a rank process that exits before the finish, or a step
past its deadline (a solve: the workload's `deadline_s`), ends the run at
once with exit code 3 and no result line, every rank process killed; in
the finish the ranks' exits are due, and their codes are read there.  A rank process dies
with rank 0's process (PR_SET_PDEATHSIG, and a poll of its parent).
The harness gives a driver no teardown call, so rank 0's
`Context.destroy` is wrapped: the ranks leave the comm engine together
(`comm_fini`) before it runs.
"""
from __future__ import annotations

import argparse
import atexit
import ctypes
import json
import os
import pickle
import signal
import struct
import subprocess
import sys
import threading
import time
import traceback

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
ROOT = os.path.dirname(BENCH)

WATCHDOG_EXIT = 3        # the exit code of a run the watchdog ends
SETUP_S = 600.0          # deadline of the set-up: starts, inputs, joins
STEP_S = 120.0           # deadline of a re-install, a gather, the finish
_POLL_S = 0.2            # the watchdog's period


# ------------------------------------------------------------- the pipes
def _write(fd: int, data: bytes) -> None:
    view = memoryview(data)
    while view:
        view = view[os.write(fd, view):]


def _read(fd: int, n: int) -> bytes:
    buf = bytearray(n)
    view, got = memoryview(buf), 0
    while got < n:
        k = os.readv(fd, [view[got:]])
        if k == 0:
            raise EOFError("the pipe's other end closed")
        got += k
    return bytes(buf)


def _send(fd: int, obj, ipc: bool = False) -> None:
    """One message: its length, then its pickle (with `ipc`, a CUDA
    tensor in it travels as its CUDA IPC handle, torch's reduction)."""
    if ipc:
        import torch.multiprocessing  # noqa: F401  (registers reductions)
        from multiprocessing.reduction import ForkingPickler
        data = bytes(ForkingPickler.dumps(obj))
    else:
        data = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
    _write(fd, struct.pack("<Q", len(data)) + data)


def _recv(fd: int):
    (n,) = struct.unpack("<Q", _read(fd, 8))
    return pickle.loads(_read(fd, n))


# ------------------------------------------------------------- one rank
def core_blocks(world: int) -> list:
    """The cores this process may run on, split into `world` blocks of
    consecutive ones (the rest, where they do not divide, unused)."""
    cores = sorted(os.sched_getaffinity(0))
    k = max(1, len(cores) // world)
    return [cores[r * k:(r + 1) * k] or cores[:k] for r in range(world)]


def bind(cores) -> None:
    """Bind every thread of this process, and those it starts later, to
    `cores`, and run one PyTorch intra-op thread: the CPU side of a rank
    is its runtime's own threads (workers, device manager, lanes, the
    comm thread)."""
    import torch
    for tid in os.listdir("/proc/self/task"):
        try:
            os.sched_setaffinity(int(tid), cores)
        except OSError:         # a thread that has just ended
            pass
    torch.set_num_threads(1)


def checksum(stack) -> list:
    """An exact checksum of a float32 stack's bits: the sum of its 32-bit
    words and their sum weighted by place in a tile, each modulo 2^64
    (integer sums, so any order of summation gives the same)."""
    import torch
    words = stack.reshape(stack.shape[0], -1).view(torch.int32)
    w = torch.arange(1, words.shape[1] + 1, dtype=torch.int64,
                     device=words.device)
    s1 = s2 = 0
    for part in words.split(64):
        part = part.to(torch.int64)
        s1 += int(part.sum())
        s2 += int((part * w).sum())
    return [s1 % (1 << 64), s2 % (1 << 64)]


def torch_sync(device) -> None:
    import torch
    torch.cuda.synchronize(device)


def grid_collection(config, traffic, rank: int):
    """The N x N matrix in NB x NB tiles over the P x Q grid, as rank
    `rank` holds it."""
    from parsec_tpu_torch.data import TwoDimBlockCyclic
    n, nb = int(traffic["N"]), int(config["NB"])
    p, q = int(config["P"]), int(config["Q"])
    return TwoDimBlockCyclic(n, n, nb, nb, P=p, Q=q, nodes=p * q,
                             myrank=rank, dtype=np.float32)


class _Rank:
    """One rank's share: its tiles of the matrix, pristine, and its part
    of a solve."""

    def __init__(self, ctx, dev, config, traffic):
        from harness import tiles
        self.ctx, self.dev, self.tiles = ctx, dev, tiles
        self.A = grid_collection(config, traffic, ctx.myrank)
        self.A.register(ctx, "A")
        self.pristine = None

    def sync(self) -> None:
        if self.dev.device.type == "cuda":
            torch_sync(self.dev.device)

    def reinstall(self) -> None:
        self.tiles.install(self.dev, self.A, self.pristine)

    def solve(self) -> dict:
        """Build, run, wait, drain: this rank's spans (perf_counter)."""
        from parsec_tpu_torch.algos import build_potrf
        from parsec_tpu_torch.device.bench_utils import wait_device_tiles
        t0 = time.perf_counter()
        tp = build_potrf(self.ctx, self.A, dev=self.dev)
        t1 = time.perf_counter()
        tp.run()
        tp.wait()
        t2 = time.perf_counter()
        wait_device_tiles(self.dev, self.A)
        t3 = time.perf_counter()
        self._tp = tp
        return {"build": (t0, t1), "run_wait": (t1, t2), "drain": (t2, t3)}

    def fence(self) -> None:
        """The comm engine's fence, then the solved pool's teardown."""
        self.ctx.comm_fence()
        self._tp.destroy()
        self._tp = None

    def stacked(self):
        """([(m, n)], this rank's current device tiles stacked)."""
        import torch
        from parsec_tpu_torch.device.bench_utils import device_tiles
        self.tiles.wait_device_tiles(self.dev, self.A)
        idx, rows = [], []
        for mn, t in device_tiles(self.dev, self.A):
            idx.append(mn)
            rows.append(t)
        out = torch.stack(rows)
        self.sync()
        return idx, out


# ------------------------------------------------------------- rank 0
class Driver:
    def __init__(self, ctx, dev, config, traffic, inputs):
        from parsec_tpu_torch.comm.launch import free_port_base
        self.ctx, self.dev = ctx, dev
        self.world = int(config["P"]) * int(config["Q"])
        self.deadline_s = float(traffic["deadline_s"])
        self.ipc = dev.device.type == "cuda"
        self.cores = core_blocks(self.world)
        self.procs, self.cmd, self.reply = [], {}, {}
        self._closing = False
        self._finishing = False         # fini sent: a rank's exit is due
        self._armed = None              # (what, monotonic deadline)
        self._destroy = ctx.destroy
        atexit.register(self._kill)
        try:
            port = free_port_base(self.world)
            for r in range(1, self.world):
                self._start(r, port, config, traffic)
            bind(self.cores[0])
            threading.Thread(target=self._watch, daemon=True,
                             name="potrf_dist4 watchdog").start()
            self._arm("the set-up", SETUP_S)
            ctx.set_rank(0, self.world)
            ctx.comm_init(port)
            self.me = _Rank(ctx, dev, config, traffic)
            self.me.pristine = self.me.tiles.stack(inputs["A"], self.me.A)
            for r in range(1, self.world):
                # rank r's tiles, copied to its card here: it opens only
                # memory of its own card
                a = grid_collection(config, traffic, r)
                share = self.me.tiles.stack(inputs["A"], a).to(
                    self._device_of(r))
                if self.ipc:
                    torch_sync(share.device)
                self._put(r, {"op": "tiles", "stack": share}, ipc=self.ipc)
                got = self._get(r)
                want = checksum(share)
                del share
                if got["checksum"] != want:
                    raise RuntimeError(f"rank {r}'s tiles differ from rank "
                                       f"0's copy: checksum {got['checksum']}"
                                       f" against {want}")
            self._disarm()
        except BaseException:
            self._closing = True
            self._kill()
            raise
        ctx.destroy = self.close

    # -------------------------------------------------- the rank processes
    def _device_of(self, rank: int) -> str:
        return f"cuda:{rank}" if self.ipc else "cpu"

    def _start(self, rank, port, config, traffic) -> None:
        cmd_r, cmd_w = os.pipe()
        rep_r, rep_w = os.pipe()
        argv = [sys.executable, os.path.abspath(__file__),
                "--rank", str(rank), "--world", str(self.world),
                "--port", str(port),
                "--cores", ",".join(map(str, self.cores[rank])),
                "--device", self._device_of(rank),
                "--config", json.dumps(config),
                "--traffic", json.dumps(traffic),
                "--cmd-fd", str(cmd_r), "--reply-fd", str(rep_w),
                "--parent", str(os.getpid())]
        p = subprocess.Popen(argv, cwd=ROOT, stdin=subprocess.DEVNULL,
                             stdout=sys.stderr.fileno(),
                             pass_fds=(cmd_r, rep_w))
        os.close(cmd_r)
        os.close(rep_w)
        self.procs.append((rank, p))
        self.cmd[rank], self.reply[rank] = cmd_w, rep_r

    def _put(self, rank: int, msg: dict, ipc: bool = False) -> None:
        try:
            _send(self.cmd[rank], msg, ipc)
        except OSError as e:
            self._fatal(f"rank {rank} is gone ({e!r})")

    def _get(self, rank: int):
        try:
            out = _recv(self.reply[rank])
        except (EOFError, OSError) as e:
            self._fatal(f"rank {rank} is gone ({e!r})")
        if "error" in out:
            self._fatal(f"rank {rank} failed:\n{out['error']}")
        return out

    # -------------------------------------------------------- the watchdog
    def _arm(self, what: str, seconds: float) -> None:
        self._armed = (what, time.monotonic() + seconds)

    def _disarm(self) -> None:
        self._armed = None

    def _watch(self) -> None:
        while not self._closing:
            time.sleep(_POLL_S)
            for r, p in self.procs:
                if p.poll() is not None and not (self._closing
                                                 or self._finishing):
                    self._fatal(f"rank {r} exited with code {p.returncode}")
            armed = self._armed
            if armed is not None and time.monotonic() > armed[1]:
                self._fatal(f"{armed[0]} ran past its deadline")

    def _kill(self) -> None:
        for _, p in self.procs:
            if p.poll() is None:
                p.kill()
        for _, p in self.procs:
            try:
                p.wait(timeout=10)
            except subprocess.TimeoutExpired:
                pass

    def _fatal(self, why: str) -> None:
        """End the run: no result line, a non-zero exit, no rank left."""
        try:
            self._closing = True
            sys.stderr.write(f"potrf_dist4: {why}; the run ends "
                             f"(exit {WATCHDOG_EXIT})\n")
            sys.stderr.flush()
            self._kill()
        finally:
            os._exit(WATCHDOG_EXIT)

    # ------------------------------------------------- what the harness calls
    def reinstall(self) -> None:
        self._arm("a re-install", STEP_S)
        for r in range(1, self.world):
            self._put(r, {"op": "reinstall"})
        self.me.reinstall()
        for r in range(1, self.world):
            self._get(r)
        self._disarm()

    def solve(self) -> dict:
        self._arm("a solve", self.deadline_s)
        for r in range(1, self.world):
            self._put(r, {"op": "solve"})
        try:
            spans = self.me.solve()
            self.me.fence()
        except Exception:
            self._fatal(f"rank 0's solve failed:\n{traceback.format_exc()}")
        for r in range(1, self.world):
            self._get(r)
        spans["fence"] = (spans["drain"][1], time.perf_counter())
        self._disarm()
        return spans

    def output(self) -> dict:
        """The whole factor on rank 0's card, gathered bit for bit."""
        import torch
        self._arm("the gather", STEP_S)
        a = self.me.A
        mb, nb = a.mb, a.nb
        out = torch.empty((a.M, a.N), dtype=torch.float32,
                          device=self.dev.device)
        for r in range(self.world):
            if r == 0:
                idx, stack = self.me.stacked()
            else:
                self._put(r, {"op": "output"})
                got = self._get(r)
                idx, stack = got["tiles"], got["stack"].to(self.dev.device)
                del got
            for i, (m, n) in enumerate(idx):
                out[m * mb:(m + 1) * mb, n * nb:(n + 1) * nb] = stack[i]
            del stack
            self.me.sync()
        self._disarm()
        return {"A": out}

    def close(self) -> None:
        """Rank 0's Context.destroy: every rank leaves the comm engine
        together and stops, then rank 0's Context is destroyed."""
        self.ctx.destroy = self._destroy
        bad = []
        if not self._closing:
            # a rank exits once it has replied to `fini`: from here on
            # the watchdog keeps the deadline and leaves exits to this
            # call, which reads every reply and exit code
            self._finishing = True
            self._arm("the finish", STEP_S)
            for r in range(1, self.world):
                self._put(r, {"op": "fini"})
            self.ctx.comm_fini()
            for r in range(1, self.world):
                bad += [f"rank {r}: {m}" for m in self._get(r)["forbidden"]]
            for r, p in self.procs:
                try:
                    code = p.wait(timeout=STEP_S)
                except subprocess.TimeoutExpired:
                    self._fatal(f"rank {r} did not exit")
                if code != 0:
                    self._fatal(f"rank {r} exited with code {code}")
            self._closing = True
            self._disarm()
        self._kill()
        self._destroy()
        if bad:
            raise RuntimeError(f"modules loaded in the rank processes: "
                               f"{', '.join(bad)}")


# ------------------------------------------------------ ranks 1 .. P*Q-1
def _die_with_parent(parent: int) -> None:
    """This process ends when rank 0's does: the kernel's parent-death
    signal, and a poll of the parent where the signal is not to be had
    (or the parent died before it was set)."""
    try:
        ctypes.CDLL(None, use_errno=True).prctl(1, signal.SIGKILL)
    except (OSError, AttributeError):
        pass

    def poll():
        while os.getppid() == parent:
            time.sleep(_POLL_S)
        os._exit(WATCHDOG_EXIT)
    if os.getppid() != parent:
        os._exit(WATCHDOG_EXIT)
    threading.Thread(target=poll, name="parent poll", daemon=True).start()


def _rank_main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="one rank of potrf_dist4")
    for k in ("--rank", "--world", "--port", "--cmd-fd", "--reply-fd",
              "--parent"):
        ap.add_argument(k, type=int, required=True)
    for k in ("--cores", "--device", "--config", "--traffic"):
        ap.add_argument(k, required=True)
    args = ap.parse_args(argv)
    _die_with_parent(args.parent)
    sys.path[:0] = [BENCH, ROOT]
    fd = args.reply_fd
    try:
        import torch
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.set_float32_matmul_precision("highest")
        bind([int(c) for c in args.cores.split(",")])
        from harness import core
        import parsec_tpu_torch as pt
        from parsec_tpu_torch.device import CudaDevice
        config, traffic = json.loads(args.config), json.loads(args.traffic)
        if args.device.startswith("cuda"):
            torch.cuda.set_device(args.device)
        st = config["user_settings"]
        ctx = pt.Context(nb_workers=int(st["nb_workers"]))
        dev = CudaDevice(ctx, device=args.device,
                         cache_bytes=int(st["cache_bytes"]))
        ctx.set_rank(args.rank, args.world)
        ctx.comm_init(args.port)
        me = _Rank(ctx, dev, config, traffic)
        got = _recv(args.cmd_fd)
        me.pristine = got.pop("stack").to(dev.device, copy=True)
        del got
        me.sync()
        _send(fd, {"checksum": checksum(me.pristine)})
    except EOFError:
        return WATCHDOG_EXIT
    except Exception:
        _send(fd, {"error": traceback.format_exc()})
        return 1
    try:
        while True:
            op = _recv(args.cmd_fd)["op"]
            if op == "reinstall":
                me.reinstall()
                _send(fd, {})
            elif op == "solve":
                me.solve()
                me.fence()
                _send(fd, {})
            elif op == "output":
                idx, stack = me.stacked()
                _send(fd, {"tiles": idx, "stack": stack},
                      ipc=stack.is_cuda)
                del stack
            elif op == "fini":
                break
        ctx.comm_fini()
        _send(fd, {"forbidden": sorted(
            m for m in sys.modules if m.split(".")[0] in core.FORBIDDEN)})
        dev.stop()
        ctx.destroy()
    except EOFError:
        return WATCHDOG_EXIT
    except Exception:
        _send(fd, {"error": traceback.format_exc()})
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(_rank_main())
