"""Partition-invariant random draws.

Under data parallelism a rank holds rows [first, first + b) of a global
batch of `rows`. Inside `row_share(rows, first)` every draw of the port
(Gumbel and speculative noise in `ops/sampling.py` and
`runtime/speculative.py`, dropout masks in `models/layers.py`) draws the
global tensor from its generator and keeps the rank's rows, so a sampled or
dropout run over a mesh equals the single-process run at the same seed.
Tensor parallelism does the same for the columns a rank holds (`cols=`),
and sequence parallelism for the time rows (dim 1) a rank holds (`times=`).
"""

from __future__ import annotations

from contextlib import contextmanager
from typing import Callable, Optional, Tuple

import torch

_ROWS: Optional[Tuple[int, int]] = None


@contextmanager
def row_share(rows: int, first: int):
    """Draws inside are the rank's rows [first, first + b) of `rows`."""
    global _ROWS
    outer, _ROWS = _ROWS, (rows, first)
    try:
        yield
    finally:
        _ROWS = outer


def draw_sliced(draw: Callable[[tuple], torch.Tensor], shape, batch_dim: Optional[int] = 0,
                cols: Optional[Tuple[int, int]] = None,
                times: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """`draw(shape)`, or under a row share (rows on `batch_dim`; None: the
    draw has no batch), a column share `cols` = (global width, first
    column) of the last dim and a time share `times` = (global length,
    first row) of dim 1, the rank's part of the global draw."""
    full, index = list(shape), [slice(None)] * len(shape)
    if _ROWS is not None and batch_dim is not None:
        rows, first = _ROWS
        full[batch_dim], index[batch_dim] = rows, slice(first, first + shape[batch_dim])
    if times is not None:
        length, first = times
        full[1], index[1] = length, slice(first, first + shape[1])
    if cols is not None:
        width, first = cols
        full[-1], index[-1] = width, slice(first, first + shape[-1])
    if full == list(shape):
        return draw(tuple(shape))
    return draw(tuple(full))[tuple(index)]
