"""Every collective the port makes, in one place.

Tensor parallelism (the mesh's `model` axis) follows the Megatron pairing,
as `torch.autograd.Function`s the sharded modules call on their group:

  - `copy_to(x, shard)`: identity forward, all-reduce backward. It sits on
    the input of a column-parallel projection (q/k/v, fc1, the LM heads):
    each rank's gradient of that input is a partial sum over its columns;
  - `reduce_from(y, shard)`: all-reduce forward, identity backward, on the
    output of a row-parallel projection (out_proj, fc2, T5's o and wo);
  - `gather_last(x, shard)`: all-gather on the last dim forward, the rank's
    slice backward (the vocab-sharded LM logits, the heads of the chunked
    loss);
  - `vocab_embedding(ids, table, shard)`: a lookup in a table whose rows are
    sharded: each rank looks up the ids it holds, zeroes the rest, and the
    rows are summed by `reduce_from`.

Sequence parallelism (the `seq` axis) cuts a sequence's rows over the
ranks of a `seq` group (`SeqShare`: every rank's row count, in rank order;
rank 0 of `seq` may hold more, the prompt prefix):

  - `gather_seq(x, seq)`: the group's rows concatenated in rank order
    (all-gather forward, reduce-scatter of the gradient backward: each
    rank's keys and values are attended by every rank's queries);
  - `previous_last(x, shard)`: the last row of the previous rank's share
    (the label column the right shift moves across a rank boundary).

An all-reduce of one rank's tensor is summed in rank order by the backend,
so every rank of a group gets the same bits, and a `model` group computes
the same tokens on each of its ranks.

Data parallelism and FSDP (the `data` axis) call the plain functions below
it: `all_reduce_sum`, `all_gather_dim`, `reduce_scatter_dim`,
`gather_objects`, `all_max` and `barrier`. None of them switches its implementation by backend: a
backend that lacks a collective for a tensor's device raises.

`STATS` counts the calls and their host seconds (a call returns when the
backend has run it: gloo blocks, NCCL only enqueues), for the per-step
collective counts that `chip_smoke.py` prints.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, List, Optional, Tuple

import time

import torch
import torch.distributed as dist
import torch.nn.functional as F


@dataclass(frozen=True)
class Shard:
    """A module's place in one mesh axis: the axis's process group, its
    size and this rank's index in it."""

    group: Any
    size: int
    rank: int

    def span(self, total: int) -> slice:
        """This rank's contiguous share of `total` (which `size` divides)."""
        n = total // self.size
        return slice(self.rank * n, (self.rank + 1) * n)


@dataclass(frozen=True)
class SeqShare:
    """A rank's rows of a sequence cut over a `seq` group: `sizes` are every
    rank's row counts in rank order; this rank holds rows [first, first +
    rows) of `total`."""

    shard: Shard
    sizes: Tuple[int, ...]

    @property
    def rows(self) -> int:
        return self.sizes[self.shard.rank]

    @property
    def first(self) -> int:
        return sum(self.sizes[:self.shard.rank])

    @property
    def total(self) -> int:
        return sum(self.sizes)


STATS = {"calls": 0, "seconds": 0.0}


def _run(collective, *args, **kwargs) -> None:
    t0 = time.perf_counter()
    collective(*args, **kwargs)
    STATS["calls"] += 1
    STATS["seconds"] += time.perf_counter() - t0


def all_reduce_sum(x: torch.Tensor, shard: Shard) -> torch.Tensor:
    """The sum of `x` over the group, a new tensor."""
    out = x.contiguous().clone()
    _run(dist.all_reduce, out, op=dist.ReduceOp.SUM, group=shard.group)
    return out


def all_max(x: torch.Tensor, shard: Shard) -> torch.Tensor:
    out = x.contiguous().clone()
    _run(dist.all_reduce, out, op=dist.ReduceOp.MAX, group=shard.group)
    return out


def all_gather_dim(x: torch.Tensor, dim: int, shard: Shard) -> torch.Tensor:
    """The group's tensors concatenated along `dim`, in rank order."""
    parts = [torch.empty_like(x, memory_format=torch.contiguous_format)
             for _ in range(shard.size)]
    _run(dist.all_gather, parts, x.contiguous(), group=shard.group)
    return torch.cat(parts, dim=dim)


def reduce_scatter_dim(x: torch.Tensor, dim: int, shard: Shard) -> torch.Tensor:
    """The sum of `x` over the group, this rank's share of `dim` of it."""
    parts = [p.contiguous() for p in x.chunk(shard.size, dim=dim)]
    out = torch.empty_like(parts[0])
    _run(dist.reduce_scatter, out, parts, op=dist.ReduceOp.SUM, group=shard.group)
    return out


def gather_objects(obj: Any, shard: Shard) -> List[Any]:
    """Every rank's picklable `obj`, in rank order."""
    out = [None] * shard.size
    _run(dist.all_gather_object, out, obj, group=shard.group)
    return out


def barrier() -> None:
    """Every rank of the world waits for the others."""
    _run(dist.barrier)


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, shard):
        ctx.shard = shard
        return x

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_sum(grad, ctx.shard), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, shard):
        return all_reduce_sum(x, shard)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _GatherLast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, shard):
        ctx.shard, ctx.width = shard, x.shape[-1]
        return all_gather_dim(x, -1, shard)

    @staticmethod
    def backward(ctx, grad):
        r = ctx.shard.rank
        return grad[..., r * ctx.width:(r + 1) * ctx.width].contiguous(), None


def copy_to(x: torch.Tensor, shard: Shard) -> torch.Tensor:
    return _CopyTo.apply(x, shard)


def reduce_from(x: torch.Tensor, shard: Shard) -> torch.Tensor:
    return _ReduceFrom.apply(x, shard)


def gather_last(x: torch.Tensor, shard: Shard) -> torch.Tensor:
    return _GatherLast.apply(x, shard)


def vocab_embedding(ids: torch.Tensor, table: torch.Tensor, shard: Shard,
                    rows: Optional[int] = None, offsets=0) -> torch.Tensor:
    """`F.embedding(ids, full_table)` for the rank's rows `table` of a table
    sharded by rows: the ids outside the rank's rows look up zeros, and the
    group's lookups are summed (each entry has one nonzero term, so the sum
    is exact). A stacked table flattened to (K x rows, D) passes `rows`, the
    rank's rows of one table, and `offsets`, each id's table x rows."""
    rows = table.shape[0] if rows is None else rows
    local = ids - shard.rank * rows
    inside = (local >= 0) & (local < rows)
    out = F.embedding(local.clamp(0, rows - 1) + offsets, table)
    return reduce_from(out * inside[..., None].to(out.dtype), shard)


def _padded(x: torch.Tensor, dim: int, size: int) -> torch.Tensor:
    pad = size - x.shape[dim]
    if pad == 0:
        return x.contiguous()
    shape = list(x.shape)
    shape[dim] = pad
    return torch.cat([x, x.new_zeros(shape)], dim=dim)


def gather_rows(x: torch.Tensor, seq: SeqShare, dim: int = 1) -> torch.Tensor:
    """Every rank's share of `dim` concatenated in rank order (not
    differentiated): shares are padded to the largest for the all-gather
    and cut back after."""
    most = max(seq.sizes)
    full = all_gather_dim(_padded(x, dim, most), dim, seq.shard)
    return torch.cat([full.narrow(dim, r * most, n) for r, n in enumerate(seq.sizes)], dim=dim)


class _GatherSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, seq, dim):
        ctx.seq, ctx.dim = seq, dim
        return gather_rows(x, seq, dim)

    @staticmethod
    def backward(ctx, grad):
        seq, dim = ctx.seq, ctx.dim
        most = max(seq.sizes)
        parts = grad.split(list(seq.sizes), dim=dim)
        mine = reduce_scatter_dim(torch.cat([_padded(p, dim, most) for p in parts], dim=dim),
                                  dim, seq.shard)
        return mine.narrow(dim, 0, seq.rows), None, None


def gather_seq(x: torch.Tensor, seq: SeqShare, dim: int = 1) -> torch.Tensor:
    """The whole sequence of the rank's share `x` (rows on `dim`): forward
    all-gathered over `seq`, the gradient reduce-scattered back, so a rank
    gets the sum of every rank's gradient of its rows."""
    return _GatherSeq.apply(x, seq, dim)


def previous_last(x: torch.Tensor, shard: Shard, dim: int = 1) -> Optional[torch.Tensor]:
    """The last row (on `dim`, kept) of the previous rank's share of a
    sequence cut over `shard`, or None on rank 0 (not differentiated)."""
    last = all_gather_dim(x.narrow(dim, x.shape[dim] - 1, 1), dim, shard)
    return None if shard.rank == 0 else last.narrow(dim, shard.rank - 1, 1)
