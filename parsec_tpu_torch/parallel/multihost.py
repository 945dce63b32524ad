"""Multi-process bring-up for the SPMD compute path.

Port of parsec_tpu/parallel/multihost.py.  Every process calls
`init_distributed`, which joins it to a torch.distributed job (one card a
rank); the meshes built by parallel.make_mesh then carry dp/tp/sp/ep/pp
axes across the job's ranks.  The task runtime's own control plane
(native/comm.cpp) is independent: point its ranks at the same hosts for
the task-DAG traffic.
"""
import logging
import os
from typing import Optional

import torch
import torch.distributed as dist

from .mesh import rank_device

logger = logging.getLogger("parsec_tpu_torch.multihost")

# Env vars any of which indicate a job torch.distributed's env:// init can
# join (torchrun, SLURM, Open MPI set by a launcher).
_CLUSTER_ENV_VARS = ("MASTER_ADDR", "TORCHELASTIC_RUN_ID", "SLURM_JOB_ID",
                     "OMPI_COMM_WORLD_SIZE")


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     local_device_ids=None, device=None,
                     backend: Optional[str] = None) -> int:
    """Join this process to a torch.distributed job (no-op for one
    process).  Returns the job's device count (its number of ranks).

    `coordinator_address` "host:port", `num_processes` the world size and
    `process_id` this rank; without them the job is discovered from the
    environment (env://).  `local_device_ids[0]` picks this rank's card.
    `device`: where the rank computes, by default its card (raises
    without one); `backend` defaults to NCCL on the card and gloo on the
    CPU (gloo with CUDA tensors runs two ranks on one card, which NCCL
    refuses)."""
    if dist.is_initialized():
        return dist.get_world_size()
    if num_processes == 1:
        return 1
    if (coordinator_address is None and num_processes is None
            and not any(os.environ.get(v) for v in _CLUSTER_ENV_VARS)):
        # Nothing to discover: stay one process without even trying, so a
        # genuine bring-up failure is never mistaken for this.
        return 1
    if local_device_ids:
        torch.cuda.set_device(int(local_device_ids[0]))
    dev = rank_device(device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    try:
        dist.init_process_group(
            backend,
            init_method=(f"tcp://{coordinator_address}"
                         if coordinator_address else "env://"),
            world_size=-1 if num_processes is None else num_processes,
            rank=-1 if process_id is None else process_id)
    except Exception as e:
        # Explicit multi-process arguments must not fail silently.
        if num_processes is not None or coordinator_address is not None:
            raise
        # Discovery env present but bring-up failed: a real cluster
        # problem, logged; the process stays alone.
        logger.warning(
            "torch.distributed init failed despite cluster env (%s); "
            "continuing as one process: %s",
            ", ".join(v for v in _CLUSTER_ENV_VARS if os.environ.get(v)), e)
        return 1
    return dist.get_world_size()


def process_info():
    """(process_id, num_processes, local card count) of this process."""
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size(), \
            torch.cuda.device_count()
    return 0, 1, torch.cuda.device_count()
