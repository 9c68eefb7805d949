"""Multi-process runs and partition striding (counterpart of
necat_tpu/parallel/launcher.py:28-80, on torch.distributed).

The role of the reference's grid backends (Plgd/Grid*.pm) and its `-mn
node_id num_nodes` partition striding (src/consensus/main.c:71-73): every
process runs the same command, owns a strided stripe of the work (templates,
contigs) and writes its part to the shared project directory; the process
group carries only barriers. It uses the gloo backend, so that processes
may share one GPU (NCCL refuses two ranks on one card). Each process runs
on the device it was given.

Launch each process with the same command and its own NECAT_TPU_PROC_ID:

    NECAT_TPU_COORDINATOR=127.0.0.1:29500 NECAT_TPU_NUM_PROCS=2 NECAT_TPU_PROC_ID=0 \\
        python -m necat_tpu_torch.pipeline.cli correct my.cfg

Without NECAT_TPU_COORDINATOR the run is one process.
"""

from __future__ import annotations

import datetime
import os

import numpy as np
import torch.distributed as dist


def init_multihost() -> tuple[int, int]:
    """Join the process group the environment asks for:
    NECAT_TPU_COORDINATOR (host:port of process 0), NECAT_TPU_NUM_PROCS and
    NECAT_TPU_PROC_ID. Returns (process id, number of processes); (0, 1)
    without a coordinator. Idempotent."""
    coord = os.environ.get("NECAT_TPU_COORDINATOR")
    if not coord:
        return 0, 1
    n = int(os.environ.get("NECAT_TPU_NUM_PROCS", "1"))
    if n > 1 and not dist.is_initialized():
        # processes wait at a barrier while process 0 runs a whole stage
        # alone, so the group's timeout is long; a process that fails closes
        # its connections, which fails the others' barriers at once
        dist.init_process_group("gloo", init_method=f"tcp://{coord}", world_size=n,
                                rank=int(os.environ.get("NECAT_TPU_PROC_ID", "0")),
                                timeout=datetime.timedelta(days=7))
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def is_coordinator() -> bool:
    """Process 0, or the only process."""
    return not dist.is_initialized() or dist.get_rank() == 0


def host_stripe(n_items: int, process_id: int | None = None,
                num_processes: int | None = None) -> np.ndarray:
    """The items this process owns: i, i+n, i+2n, ... (the reference strides
    partition ids rather than blocking them, so that long and short
    partitions spread evenly)."""
    if process_id is None or num_processes is None:
        pid, n = ((dist.get_rank(), dist.get_world_size()) if dist.is_initialized()
                  else (0, 1))
        process_id = pid if process_id is None else process_id
        num_processes = n if num_processes is None else num_processes
    return np.arange(process_id, n_items, num_processes)


def barrier(name: str = "necat") -> None:
    """Wait for every process (the hand-off of files between stages, the
    role of serialRunJobs waiting for a stage's grid jobs); a no-op in one
    process. `name` is for the reader: gloo barriers are anonymous."""
    if dist.is_initialized() and dist.get_world_size() > 1:
        dist.barrier()
