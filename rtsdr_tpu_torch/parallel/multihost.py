"""Multi-host deployment helpers.

Counterpart of ``rtsdr_tpu/parallel/multihost.py``.  Each process (host)
ingests its own set of FM stations (its SDR front ends or capture shards)
and owns the matching contiguous block of global channel rows; hosts never
exchange sample data.  ``torch.distributed`` carries only the process
group's own coordination (gloo on the CPU, NCCL on CUDA).
"""

from __future__ import annotations

import numpy as np
import torch

from rtsdr_tpu_torch.parallel.mesh import Mesh


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None, device="cuda") -> None:
    """Join the process group (a no-op for at most one process).

    ``coordinator_address``: ``host:port`` of process 0 (a free port on
    localhost for processes of one machine).  The backend is NCCL for a
    CUDA ``device`` and gloo for the CPU.
    """
    if num_processes is None or num_processes <= 1:
        return
    import torch.distributed as dist

    backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id)


def _world() -> tuple[int, int]:
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def host_channel_slice(n_channels: int) -> slice:
    """The contiguous block of global channel indices this process ingests."""
    n_hosts, rank = _world()
    if n_channels % n_hosts:
        raise ValueError(
            f"{n_channels} channels not divisible by {n_hosts} hosts")
    per_host = n_channels // n_hosts
    return slice(rank * per_host, (rank + 1) * per_host)


def make_global_input(mesh: Mesh, n_channels: int, block_size: int,
                      local_blocks: np.ndarray) -> torch.Tensor:
    """This process's rows of the (n_channels, block_size) uint8 input, on
    the mesh's first device (a grid mesh's too: the time-sharded receiver
    hands each time shard its chunk from there).

    PyTorch has no global array: the process's channel-sharded receiver
    takes exactly its own rows (``host_channel_slice``), so ingest rides
    the host-to-device link and never crosses to another host.
    """
    n_hosts, _ = _world()
    want = (n_channels // n_hosts, block_size)
    local_blocks = np.asarray(local_blocks)
    if local_blocks.shape != want or local_blocks.dtype != np.uint8:
        raise ValueError(f"local blocks: expected uint8 {want}, got "
                         f"{local_blocks.dtype} {local_blocks.shape}")
    return torch.as_tensor(np.ascontiguousarray(local_blocks)).to(
        mesh.devices[0])
