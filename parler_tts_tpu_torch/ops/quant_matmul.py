"""Weight-only int8 matrix product (kernel K2).

Port of `parler_tts_tpu/ops/pallas/quant_matmul.py:quant_matmul`.
`quant_matmul` launches the CUDA kernel `csrc/quant_matmul.cu` for CUDA
tensors and runs `quant_matmul_plain`, the plain PyTorch version with the same
semantics, for CPU tensors; there is no other route.

Semantics (those of `_qmm_kernel`): x (M, K) is rounded to bf16, the int8
weights w_q (K, N) convert exactly to bf16, products accumulate in fp32, the
fp32 per-output-channel scale (N,) multiplies the sums, and the output (M, N)
is in x's dtype (fp32 or bf16).

The kernel cuts K into the slices of `k2_grid`, one block of a thread-block
cluster each, and sums the slices' partial products on chip in rank order:
one launch, no workspace, and the output is the only allocation of a call.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from ._cuda import load

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# the grid (mirrors csrc/quant_matmul.cu): a block owns a STRIP-column strip
# of N, a row tile of x and one slice of K; the slices of a strip are the
# blocks of one thread-block cluster, at most MAX_SLICES (the portable
# cluster size), enough for about one 256-thread block per SM of an H100
# (132 SMs; a second wave of blocks costs more than it brings), each slice
# at least _MIN_SLICE rows
STRIP = 64
MAX_SLICES = 8
MAX_SLICE = 8192  # K rows of one slice: x's slice sits in shared memory as bf16
_TARGET_BLOCKS = 132
_MIN_SLICE = 64


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def row_tile(m: int) -> int:
    """Rows of x one block takes (mirrors the kernel's row tile R)."""
    return 1 if m <= 1 else 2 if m <= 2 else 4 if m <= 4 else 8


@functools.lru_cache(maxsize=None)
def k2_grid(m: int, k: int, n: int) -> Tuple[int, int]:
    """(slices, slice): the cluster size, a power of two up to MAX_SLICES,
    and the K rows of each slice, a multiple of 16; slice r of a strip holds
    K rows [r * slice, min((r + 1) * slice, K)), the last ones fewer or none.
    Looked up once per (M, K, N)."""
    tiles = _cdiv(n, STRIP) * _cdiv(m, row_tile(m))
    slices = 1
    while (slices < MAX_SLICES and 2 * slices * tiles <= _TARGET_BLOCKS
           and 2 * slices * _MIN_SLICE <= k):
        slices *= 2
    slice_ = _cdiv(_cdiv(k, slices), 16) * 16
    if slice_ > MAX_SLICE:
        raise ValueError(f"K={k} needs slices of {slice_} rows; the kernel takes at most "
                         f"{MAX_SLICES} x {MAX_SLICE}")
    return slices, slice_


def _check(x: torch.Tensor, w_q: torch.Tensor, scale: torch.Tensor) -> Tuple[int, int, int]:
    """Validate the operands; returns (M, K, N)."""
    if x.dim() != 2 or w_q.dim() != 2:
        raise ValueError(f"x must be (M, K) and w_q (K, N), got {tuple(x.shape)}, "
                         f"{tuple(w_q.shape)}")
    m, k = x.shape
    if w_q.shape[0] != k:
        raise ValueError(f"x has K={k}, w_q has {w_q.shape[0]} rows")
    n = w_q.shape[1]
    if w_q.dtype != torch.int8:
        raise TypeError(f"w_q must be int8, got {w_q.dtype}")
    if scale.shape != (n,) or scale.dtype != torch.float32:
        raise ValueError(f"scale must be ({n},) float32, got {tuple(scale.shape)} {scale.dtype}")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"x dtype {x.dtype} not supported (float32, bfloat16)")
    for name, t in (("w_q", w_q), ("scale", scale)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
    # what the kernel takes, checked on every route
    if k % 16 or n % 16:
        raise ValueError(f"K={k} and N={n} must be multiples of 16")
    for name, t in (("x", x), ("w_q", w_q), ("scale", scale)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if w_q.data_ptr() % 16:
        raise ValueError("w_q must be 16-byte aligned (the kernel reads it in 16-byte vectors)")
    return m, k, n


def quant_matmul_plain(x: torch.Tensor, w_q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel: same rounding points."""
    _check(x, w_q, scale)
    y = x.to(torch.bfloat16).float() @ w_q.float()
    return (y * scale[None, :]).to(x.dtype)


def k2_close(got: torch.Tensor, want: torch.Tensor) -> bool:
    """How close the kernel must come to its plain version: both sum the same
    exact products in fp32, in other orders. fp32 output: within
    1e-6 x max|y| + 1e-5 x |y| (the order noise of K <= 4096 terms; 1.5e-5
    read at max|y| ~ 30 on an H100); bf16 output: also, or one bf16 ulp of y
    apart (a rounding moved by that noise). A kernel that loses one 16-row
    slice of K is off by ~0.5."""
    g, w = got.float(), want.float()
    diff = (g - w).abs()
    ok = diff <= 1e-6 * w.abs().max() + 1e-5 * w.abs()
    if want.dtype == torch.bfloat16:
        ok |= diff <= torch.exp2(torch.floor(torch.log2(w.abs().clamp_min(1e-30))) - 7)
    return bool(ok.all())


@functools.lru_cache(maxsize=None)
def _launch_fn():
    """The kernel's C entry point, its argument types set once."""
    fn = load("quant_matmul").quant_matmul_launch
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p] * 4 + [i] * 6 + [p]
    fn.restype = i
    return fn


def _launch(x, w_q, scale, m, k, n) -> torch.Tensor:
    slices, slice_ = k2_grid(m, k, n)
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    err = _launch_fn()(
        x.data_ptr(), w_q.data_ptr(), scale.data_ptr(), out.data_ptr(), _DTYPE_CODES[x.dtype],
        m, k, n, slices, slice_, torch.cuda.current_stream(x.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"quant_matmul kernel launch failed: cudaError {err}")
    quant_matmul.launches += 1
    return out


def quant_matmul(x: torch.Tensor, w_q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """(M, N) = (bf16(x) @ w_q) * scale in x's dtype, fp32 accumulation.

    CUDA tensors launch the kernel (and count the launch in
    `quant_matmul.launches`); CPU tensors run the plain version.
    """
    m, k, n = _check(x, w_q, scale)
    if x.device.type == "cuda":
        return _launch(x, w_q, scale, m, k, n)
    if x.device.type == "cpu":
        return quant_matmul_plain(x, w_q, scale)
    raise ValueError(f"no quant_matmul route for device {x.device}")


quant_matmul.launches = 0
