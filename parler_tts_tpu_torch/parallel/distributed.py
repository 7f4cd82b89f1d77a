"""Multi-process wiring over `torch.distributed` (port of
`parler_tts_tpu/parallel/distributed.py`).

One process per rank, as `torchrun` starts them. The environment contract
is torchrun's, and maps onto the JAX package's:

  MASTER_ADDR:MASTER_PORT  <-> JAX_COORDINATOR    (rank 0's host:port)
  WORLD_SIZE               <-> JAX_NUM_PROCESSES
  RANK                     <-> JAX_PROCESS_ID
  LOCAL_RANK               (no JAX counterpart: a JAX process drives every
                            local device; here a rank drives `cuda:LOCAL_RANK`)

Each process feeds its own rows of the global batch (`local_batch_slice`),
and `host_local_to_global` places them on the rank's device once every rank
agrees on their shapes.
"""

from __future__ import annotations

import os
from typing import Any, Optional, Tuple

import torch
import torch.distributed as dist

from .collectives import Shard, gather_objects


def maybe_init_distributed(backend: Optional[str] = None,
                           device: Optional[str] = None) -> Tuple[int, int]:
    """Join the process group that torchrun's environment describes, when
    WORLD_SIZE is set and no group is up yet. The backend is NCCL for a
    `cuda` device (the default) and gloo for `cpu`, unless `backend` names
    one; a CUDA rank's device is made `cuda:LOCAL_RANK`. Returns (rank,
    world size), (0, 1) outside a distributed run."""
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    if "WORLD_SIZE" not in os.environ:
        return 0, 1
    kind = torch.device("cuda" if device is None else device).type
    if kind == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    dist.init_process_group(
        backend or ("nccl" if kind == "cuda" else "gloo"),
        init_method=(f"tcp://{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}"),
        rank=int(os.environ["RANK"]), world_size=int(os.environ["WORLD_SIZE"]))
    return dist.get_rank(), dist.get_world_size()


def rank_device(device: Optional[str] = None) -> torch.device:
    """The rank's device: `cuda:LOCAL_RANK` for CUDA, else `device`."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
    return dev


def local_batch_slice(global_batch_size: int, index: Optional[int] = None,
                      count: Optional[int] = None) -> slice:
    """Rows [index * b, (index + 1) * b) of the global batch, b =
    global_batch_size / count: the share of data rank `index` of `count`
    (default: this process of all of them; over a mesh with a `model` axis,
    pass `mesh.data.rank` and `mesh.data.size`, since a model group shares
    its rows)."""
    if count is None:
        index, count = ((dist.get_rank(), dist.get_world_size()) if dist.is_initialized()
                        else (0, 1))
    if global_batch_size % count != 0:
        raise ValueError(
            f"global batch {global_batch_size} not divisible by {count} data ranks")
    local = global_batch_size // count
    return slice(index * local, (index + 1) * local)


def host_local_to_global(batch: Any, mesh) -> Any:
    """The rank's local rows (a NamedTuple or tuple of arrays or tensors) as
    tensors on the mesh's device, after one all-gather of their shapes
    checks that every rank holds rows of the same shapes: ragged shares
    would hang or mis-sum a later collective."""
    tensors = [torch.as_tensor(x) for x in batch]
    shapes = [tuple(t.shape) for t in tensors]
    world = Shard(None, dist.get_world_size(), dist.get_rank())
    every = gather_objects(shapes, world)
    if any(s != shapes for s in every):
        raise ValueError(f"ranks hold local batches of different shapes: {every}")
    moved = [t.to(mesh.device) for t in tensors]
    return type(batch)(*moved) if hasattr(batch, "_fields") else type(batch)(moved)
