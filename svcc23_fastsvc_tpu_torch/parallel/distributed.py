"""Multi-process data-parallel glue.

Counterpart of `svcc23_fastsvc_tpu/parallel/distributed.py`. JAX runs one
process per host, each with its local devices, and joins them with
`jax.distributed.initialize`; here every process drives one device (one
rank), and the processes join one `torch.distributed` process group:

  * `initialize()` starts the group over TCP at the coordinator (the same
    `SVC_*` environment defaults as JAX) and picks the rank's device;
  * `HostShardedBatcher` gives each rank its own seeded stream (seed +
    1000 * rank), so the ranks build disjoint local batches without
    talking to each other;
  * `global_batch()` / `global_stacked_batch()` take a rank's local rows
    as they are: the JAX functions assembled them into one global
    `jax.Array`; here the rows stay on their rank and the step averages
    gradients and metrics across the ranks instead (`train.gan`,
    `train.b02`, through the task's `dp_group`).

The backend is NCCL for CUDA devices and gloo on the CPU; `SVC_DIST_BACKEND`
names one explicitly (gloo lets two ranks share one card, which NCCL
refuses). A backend that fails to start raises: nothing switches to the
other one.
"""

from __future__ import annotations

import hashlib
import logging
import os
from typing import Optional

import torch
import torch.distributed as dist

from .mesh import _place

BACKENDS = ("nccl", "gloo")


def backend_for(device) -> str:
    """`SVC_DIST_BACKEND`, or NCCL for a CUDA device and gloo otherwise."""
    backend = os.environ.get("SVC_DIST_BACKEND") or (
        "nccl" if torch.device(device).type == "cuda" else "gloo")
    if backend not in BACKENDS:
        raise ValueError(f"SVC_DIST_BACKEND {backend!r}: expected one of "
                         f"{BACKENDS}")
    return backend


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None, *,
               device="cuda") -> torch.device:
    """Join the training processes into one group (a no-op for one process)
    and return the device this rank runs on: `cuda:{rank % cards}` for a
    CUDA device without an index, else `device` itself."""
    device = torch.device(device)
    num_processes = num_processes or int(
        os.environ.get("SVC_NUM_PROCESSES", "1"))
    if num_processes <= 1:
        logging.info("single-process run; skipping torch.distributed")
        return device
    address = coordinator_address or os.environ.get("SVC_COORDINATOR",
                                                    "127.0.0.1:12345")
    rank = process_id if process_id is not None else int(
        os.environ.get("SVC_PROCESS_ID", "0"))
    backend = backend_for(device)
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(device)
    elif backend == "nccl":
        raise ValueError(f"the NCCL backend needs a CUDA device, not "
                         f"{device}")
    # NCCL with a device starts its communicator now, so that two ranks on
    # one card fail here, not in the first step
    kw = {"device_id": device} if backend == "nccl" else {}
    dist.init_process_group(backend, init_method=f"tcp://{address}",
                            world_size=num_processes, rank=rank, **kw)
    logging.info("torch.distributed up: process %d/%d, %s on %s",
                 dist.get_rank(), dist.get_world_size(), backend, device)
    return device


def process_index() -> int:
    """This process's rank (0 outside a process group)."""
    return dist.get_rank() if dist.is_initialized() else 0


class HostShardedBatcher:
    """Wrap a batcher so each rank draws an independent seeded stream and
    builds only its local share of the global batch."""

    def __init__(self, make_batcher, *, seed: int = 0):
        """make_batcher(seed) -> iterable of batch dicts."""
        self.process_index = process_index()
        self.batcher = make_batcher(seed + 1000 * self.process_index)

    def __iter__(self):
        return iter(self.batcher)


def global_batch(local_batch: dict, mesh=None, *, device=None) -> dict:
    """A rank's local rows of the global batch, on `device` if given.

    In JAX this made one global array whose rows lay on every process's
    devices (`jax.make_array_from_process_local_data`). A rank here keeps
    only its own rows: the global batch exists as the ranks' rows
    together, and the step's gradient and metric means span it. `mesh` is
    the data group; the rows are taken as they are."""
    return _place(local_batch, device)


def global_stacked_batch(local_batches: dict, mesh=None, *,
                         device=None) -> dict:
    """`global_batch` for K stacked local batches (leading K axis, then the
    local rows): the multi-process feed of a K-step call."""
    return _place(local_batches, device)


def replica_checksum(*modules) -> str:
    """sha256 over the bytes of every parameter and buffer of `modules`:
    equal on every rank while the replicas agree bit for bit."""
    h = hashlib.sha256()
    for m in modules:
        for name, t in m.state_dict().items():
            h.update(name.encode())
            h.update(t.detach().cpu().reshape(-1).view(torch.uint8)
                     .numpy().tobytes())
    return h.hexdigest()

