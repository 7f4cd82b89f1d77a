"""Parallelism over `torch.distributed`: the mesh and partition rules
(`mesh.py`), the collectives (`collectives.py`), FSDP's gather and scatter
(`fsdp.py`), partition-invariant draws (`rows.py`) and the process wiring
(`distributed.py`)."""

from .distributed import host_local_to_global, local_batch_slice, maybe_init_distributed
from .mesh import (
    Mesh,
    fsdp_params_shardings,
    local_seq_slice,
    make_mesh,
    param_partition_spec,
    params_shardings,
    shard_params,
)

__all__ = [
    "Mesh",
    "fsdp_params_shardings",
    "host_local_to_global",
    "local_batch_slice",
    "local_seq_slice",
    "make_mesh",
    "maybe_init_distributed",
    "param_partition_spec",
    "params_shardings",
    "shard_params",
]
