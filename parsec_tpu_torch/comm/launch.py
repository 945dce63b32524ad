"""Multi-rank launcher: the mpirun analog for loopback SPMD jobs.

    python -m parsec_tpu_torch.comm.launch -n 4 [--port BASE] script.py \
        [args...]

Spawns N copies of `script.py` with PTC_RANK / PTC_WORLD / PTC_PORT
set; the script calls `parsec_tpu_torch.comm.init(ctx)` to join the
mesh.  Mirrors the reference's `${MPI_TEST_CMD_LIST} <nproc>` test
template (tests/CMakeLists.txt:41-57, SURVEY.md §4).  Port of
parsec_tpu/comm/launch.py.
"""
import argparse
import os
import random
import socket
import subprocess
import sys


def free_port_base(n: int) -> int:
    """A base port with n consecutive free loopback ports.  The range
    lies below Linux's default ephemeral ports (32768 and up), so that
    no outgoing connection, the ranks' own included, takes one of them
    between this probe and the ranks' listen."""
    for _ in range(64):
        base = random.randint(20000, 32767 - n)
        socks = []
        try:
            for i in range(n):
                s = socket.socket()
                s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
                s.bind(("127.0.0.1", base + i))
                socks.append(s)
            return base
        except OSError:
            continue
        finally:
            for s in socks:
                s.close()
    raise RuntimeError("no free port range found")


def main(argv=None):
    ap = argparse.ArgumentParser(prog="parsec_tpu_torch.comm.launch")
    ap.add_argument("-n", "--np", type=int, required=True,
                    help="number of ranks")
    ap.add_argument("--port", type=int, default=0,
                    help="base TCP port (default: pick a free range)")
    ap.add_argument("script")
    ap.add_argument("args", nargs=argparse.REMAINDER)
    opts = ap.parse_args(argv)

    port = opts.port or free_port_base(opts.np)
    procs = []
    for r in range(opts.np):
        env = dict(os.environ, PTC_RANK=str(r), PTC_WORLD=str(opts.np),
                   PTC_PORT=str(port))
        procs.append(subprocess.Popen(
            [sys.executable, opts.script, *opts.args], env=env))
    rc = 0
    for p in procs:
        p.wait()
        rc = rc or p.returncode
    if rc:
        for p in procs:
            if p.poll() is None:
                p.terminate()
    return rc


if __name__ == "__main__":
    sys.exit(main())
