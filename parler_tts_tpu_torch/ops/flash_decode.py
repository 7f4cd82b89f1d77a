"""Flash-decode attention over the static KV cache (kernel K1).

Port of `parler_tts_tpu/ops/pallas/flash_decode.py:flash_decode_attention`.
`flash_decode_attention` launches a CUDA kernel for CUDA tensors and runs
`flash_decode_attention_plain`, the plain PyTorch version with the same
semantics, for CPU tensors. Of the two kernels, `k1_route` picks one from the
dtype and shapes alone: "window" (`csrc/flash_decode_window.cu`, both
products on the tensor cores, one pass over each kv head's cache for all its
rows) for a bf16 cache with W > 1 columns and 8 < G x W <= 64 query rows a kv
head at Dh a multiple of 16 up to 128; "split" (`csrc/flash_decode.cu`) for
every other shape, every single-column decode and every fp32 cache among them.

Semantics (those of the Pallas kernel, not of its XLA oracle):
  * q (B, H, Dh), or (B, W, H, Dh) for W window columns; pre-scaled, RoPE'd;
  * k/v (B, S, H_kv, Dh), or with `layer` the whole stacked cache
    (L, B, S, H_kv * Dh) or (L, B, S, H_kv, Dh), read in place;
  * window column i of row b sees slots [starts[b], limit_b + i), with
    `limit` an int (all rows) or a (B,) int32 tensor;
  * query head h reads kv head h // (H / H_kv);
  * q is rounded to the cache dtype, the softmax runs in fp32, P is cast to
    the cache dtype before the P . V product, and the output is in q's dtype;
  * an empty range returns 0 (the XLA oracle returns the mean of V there).

Both kernels cut each row's range [0, limit + W - 1) into contiguous shares
by `split_bounds` (`split_count` of them on the split route,
`window_split_count` on the window route; `kernel_split_count` gives the one
of the route a shape takes), one block of a thread-block cluster each, and
merge the shares' softmax states in rank order. The plain version's
`splits=n` form computes the same shares and merges them the same way, so the
merge is testable where the kernels cannot run.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple, Union

import torch

from ._cuda import load

NEG_INF = torch.finfo(torch.float32).min
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_INT32_MAX = 2**31 - 1
# the grid: clusters of up to MAX_SPLITS blocks (the portable cluster size),
# enough of them for about two 128-thread blocks per SM of an H100 (132 SMs)
MAX_SPLITS = 8
_TARGET_BLOCKS = 264
_MIN_SHARE = 16      # cache slots a share should hold at S, at the least
_MAX_ROW_BYTES = 512  # Dh * itemsize: one 16-byte vector per lane of a 32-lane group
# the window kernel: at most this many query rows a kv head (four 16-row
# tiles of its tensor-core products), cache tiles of 64 slots, Dh up to 128
WINDOW_MAX_ROWS = 64
WINDOW_TILE = 64
WINDOW_MAX_DH = 128

Limit = Union[int, torch.Tensor]


def _shapes(q, k, v, starts, limit, layer):
    """Validate the operands; returns (B, W, H, Dh, H_kv, S)."""
    if q.dim() not in (3, 4):
        raise ValueError(f"q must be (B, H, Dh) or (B, W, H, Dh), got {tuple(q.shape)}")
    b, h, dh = q.shape[0], q.shape[-2], q.shape[-1]
    w = q.shape[1] if q.dim() == 4 else 1
    if k.shape != v.shape or k.dtype != v.dtype:
        raise ValueError("k and v must have one shape and dtype")
    if layer is None:
        if k.dim() != 4:
            raise ValueError(f"per-layer k/v must be (B, S, H_kv, Dh), got {tuple(k.shape)}")
        kb, s, h_kv = k.shape[0], k.shape[1], k.shape[2]
        if k.shape[3] != dh:
            raise ValueError("k/v head dim differs from q's")
    else:
        if k.dim() == 5:
            if k.shape[4] != dh:
                raise ValueError("k/v head dim differs from q's")
            n_layers, kb, s, h_kv = k.shape[0], k.shape[1], k.shape[2], k.shape[3]
        elif k.dim() == 4:
            n_layers, kb, s, hd = k.shape
            if hd % dh:
                raise ValueError(f"flat cache width {hd} is not a multiple of Dh={dh}")
            h_kv = hd // dh
        else:
            raise ValueError(f"stacked k/v must be rank 4 or 5, got {tuple(k.shape)}")
        if not 0 <= layer < n_layers:
            raise ValueError(f"layer {layer} out of range for {n_layers} layers")
    if kb != b:
        raise ValueError(f"cache batch {kb} != q batch {b}")
    if h % h_kv:
        raise ValueError(f"H={h} is not a multiple of H_kv={h_kv}")
    if starts.shape != (b,):
        raise ValueError(f"starts must be (B,), got {tuple(starts.shape)}")
    if isinstance(limit, torch.Tensor) and limit.shape not in ((), (b,)):
        raise ValueError(f"limit must be an int, () or (B,), got {tuple(limit.shape)}")
    for name, t in (("q", q), ("k", k), ("v", v), ("starts", starts)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
    return b, w, h, dh, h_kv, s


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def row_tile(rows: int) -> int:
    """Query rows one block holds: 1, 2, 4 or 8; a kv head with more rows
    gets several blocks (mirrors `row_tile` in csrc/flash_decode.cu)."""
    return 1 if rows <= 1 else 2 if rows <= 2 else 4 if rows <= 4 else 8


def split_count(b: int, h_kv: int, s: int, rows: int) -> int:
    """Blocks of one cluster, each taking one share of a row's slots: a power
    of two up to MAX_SPLITS, so that the grid holds about _TARGET_BLOCKS
    blocks, with at least _MIN_SHARE slots per share at the cache's length S.
    It depends on shapes only, never on `limit`, so a captured launch stays
    valid as the cache fills."""
    tiles = b * h_kv * _cdiv(rows, row_tile(rows))
    n = 1
    while n < MAX_SPLITS and 2 * n * tiles <= _TARGET_BLOCKS and 2 * n * _MIN_SHARE <= s:
        n *= 2
    return n


def k1_route(kv_dtype: torch.dtype, g: int, w: int, dh: int) -> str:
    """The kernel a CUDA launch takes, from dtype and shapes alone: "window"
    (csrc/flash_decode_window.cu) for a bf16 cache with W > 1 window columns,
    8 < G x W <= WINDOW_MAX_ROWS query rows a kv head (G = H / H_kv) and Dh a
    multiple of 16 up to WINDOW_MAX_DH; "split" (csrc/flash_decode.cu) for
    every other shape, every single-column decode and fp32 cache among them."""
    rows = g * w
    if (kv_dtype == torch.bfloat16 and w > 1 and 8 < rows <= WINDOW_MAX_ROWS
            and dh % 16 == 0 and dh <= WINDOW_MAX_DH):
        return "window"
    return "split"


def window_split_count(b: int, h_kv: int, s: int, rows: int) -> int:
    """The window kernel's cluster size: a power of two up to MAX_SPLITS, so
    that the grid holds about _TARGET_BLOCKS blocks of one (row, kv head,
    share) each (all `rows` query rows of the kv head in one block, whose
    tensor-core tiles take WINDOW_MAX_ROWS), with at least one WINDOW_TILE-slot
    tile per share at the cache's length S. Shapes only, never `limit`."""
    tiles = b * h_kv * _cdiv(rows, WINDOW_MAX_ROWS)
    n = 1
    while n < MAX_SPLITS and 2 * n * tiles <= _TARGET_BLOCKS and 2 * n * WINDOW_TILE <= s:
        n *= 2
    return n


def kernel_split_count(kv_dtype: torch.dtype, b: int, h: int, h_kv: int, s: int, w: int,
                       dh: int) -> int:
    """The split count of the kernel `k1_route` picks for these shapes: the
    `splits=` at which the plain version repeats that kernel's shares."""
    g = h // h_kv
    if k1_route(kv_dtype, g, w, dh) == "window":
        return window_split_count(b, h_kv, s, g * w)
    return split_count(b, h_kv, s, g * w)


def split_bounds(begin, end, n_split: int) -> torch.Tensor:
    """Edges (..., n_split + 1) of the shares of the slots [begin, end): share
    i is [edges[i], edges[i + 1]), ceil(len / n_split) slots each, the last
    ones fewer or none (len = max(end - begin, 0)). The kernel cuts its
    shares by the same rule (`share_of` in csrc/flash_decode.cu)."""
    begin = torch.as_tensor(begin, dtype=torch.int64)
    end = torch.as_tensor(end, dtype=torch.int64)
    n = (end - begin).clamp_min(0)
    chunk = (n + n_split - 1) // n_split
    i = torch.arange(n_split + 1, device=begin.device)
    return begin[..., None] + torch.minimum(i * chunk[..., None], n[..., None])


def slot_range(starts: torch.Tensor, limit: Limit, w: int, s: int) -> Tuple[torch.Tensor, ...]:
    """(begin, end) per row of the range the kernel cuts into shares:
    [0, min(limit + W - 1, S)), the slots below any column's limit. It starts
    at slot 0, not at the row's start, so that the kernel's first loads need
    no value read on the device; slots below start are masked."""
    lim = torch.as_tensor(limit, dtype=torch.int64, device=starts.device).expand(starts.shape)
    end = (lim + w - 1).clamp_max(s)
    return torch.zeros_like(end), end


def flash_decode_attention_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    starts: torch.Tensor,
    limit: Limit,
    layer: Optional[int] = None,
    splits: int = 1,
) -> torch.Tensor:
    """Plain PyTorch version of the kernel, same semantics and rounding points.

    The range is cut by `split_bounds` into `splits` shares, each with its
    own max, sum and accumulator (P rounded to the cache dtype relative to
    the share's max), merged in rank order (`flash_decode_attention_shares`).
    `splits=1`, the default, is one softmax over the whole range, the form
    the CPU tests hold against the Pallas kernel; `splits=kernel_split_count(...)`
    is the form of the kernel the shapes route to.
    """
    b, w, h, dh, h_kv, s = _shapes(q, k, v, starts, limit, layer)
    edges = split_bounds(*slot_range(starts, limit, w, s), splits)
    return flash_decode_attention_shares(q, k, v, starts, limit, edges[:, :-1], edges[:, 1:],
                                         layer)


def flash_decode_attention_shares(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    starts: torch.Tensor,
    limit: Limit,
    lo: torch.Tensor,
    hi: torch.Tensor,
    layer: Optional[int] = None,
) -> torch.Tensor:
    """The plain split form over explicit shares: share i of row b holds the
    slots [lo[b, i], hi[b, i]) that column w also sees ([starts[b],
    limit_b + w)); its max m_i, sum l_i and P . V accumulator a_i are its
    own, and the shares merge in rank order as the kernel's cluster does:
    out = sum_i a_i e^(m_i - M) / max(sum_i l_i e^(m_i - M), 1e-30), M the
    largest m_i. A share with no slot keeps m_i = finfo.min and weighs 0."""
    b, w, h, dh, h_kv, s = _shapes(q, k, v, starts, limit, layer)
    if layer is not None:
        k, v = k[layer], v[layer]
    k = k.reshape(b, s, h_kv, dh)
    v = v.reshape(b, s, h_kv, dh)
    q4 = q if q.dim() == 4 else q[:, None]
    device = q.device
    lim = torch.as_tensor(limit, dtype=torch.int32, device=device).expand(b)
    pos = torch.arange(s, device=device)
    lim_w = lim[:, None] + torch.arange(w, device=device)[None, :]           # (B, W)
    valid = (pos[None, None, :] >= starts.to(device)[:, None, None]) & (
        pos[None, None, :] < lim_w[:, :, None]
    )                                                                         # (B, W, S)
    qg = q4.to(k.dtype).float().reshape(b, w, h_kv, h // h_kv, dh)
    scores = torch.einsum("bwkgd,bskd->bwkgs", qg, k.float())
    lo, hi = lo.to(device), hi.to(device)
    m_all = torch.full((b, w, h_kv, h // h_kv, 1), NEG_INF, device=device)
    parts = []
    for i in range(lo.shape[1]):
        share = (pos[None, :] >= lo[:, i, None]) & (pos[None, :] < hi[:, i, None])     # (B, S)
        mask = (valid & share[:, None, :])[:, :, None, None, :]               # (B, W, 1, 1, S)
        si = scores.masked_fill(~mask, NEG_INF)
        m = si.amax(dim=-1, keepdim=True)
        p = torch.exp(si - m).masked_fill(~mask, 0.0)
        acc = torch.einsum("bwkgs,bskd->bwkgd", p.to(v.dtype).float(), v.float())
        parts.append((m, p.sum(dim=-1, keepdim=True), acc))
        m_all = torch.maximum(m_all, m)
    num = torch.zeros_like(parts[0][2])
    den = torch.zeros_like(parts[0][1])
    for m, l, acc in parts:  # rank order
        wgt = torch.exp(m - m_all)
        num = num + acc * wgt
        den = den + l * wgt
    out = (num / den.clamp_min(1e-30)).reshape(b, w, h, dh).to(q.dtype)
    return out if q.dim() == 4 else out[:, 0]


@functools.lru_cache(maxsize=None)
def _plan(kv_dtype: torch.dtype, b: int, h: int, h_kv: int, s: int, w: int,
          dh: int) -> Tuple[str, int]:
    """(route, split count) of a launch; raises for what the kernel does not
    take. Cached per shape, so a launch makes one foreign call."""
    route = k1_route(kv_dtype, h // h_kv, w, dh)
    elem = torch.finfo(kv_dtype).bits // 8
    if route == "split" and dh * elem > _MAX_ROW_BYTES:
        raise ValueError(f"Dh={dh} at {elem} bytes an element exceeds the kernel's "
                         f"{_MAX_ROW_BYTES}-byte head row (32 lanes of 16 bytes)")
    return route, kernel_split_count(kv_dtype, b, h, h_kv, s, w, dh)


def _launch(q, k, v, starts, limit, layer, shapes) -> torch.Tensor:
    b, w, h, dh, h_kv, s = shapes
    for name, t in (("q", q), ("k", k)):
        if t.dtype not in _DTYPE_CODES:
            raise TypeError(f"{name} dtype {t.dtype} not supported (float32, bfloat16)")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if starts.dtype != torch.int32 or not starts.is_contiguous():
        raise TypeError("starts must be a contiguous int32 tensor")
    limits_ptr, limit_scalar = None, 0
    if isinstance(limit, torch.Tensor):
        if limit.dtype != torch.int32 or limit.device != q.device:
            raise TypeError("a tensor limit must be int32 on q's device")
        limit = limit.expand(b).contiguous()
        limits_ptr = limit.data_ptr()
    else:
        limit_scalar = int(limit)
    elem = k.element_size()
    if (dh * elem) % 16 or k.data_ptr() % 16 or v.data_ptr() % 16:
        raise ValueError("the kernels read K/V rows in 16-byte vectors: Dh * itemsize must be "
                         "a multiple of 16 and k/v 16-byte aligned")
    stride_s = h_kv * dh
    stride_b = s * stride_s
    stride_l = b * stride_b
    if stride_l > _INT32_MAX:
        raise ValueError("cache layer exceeds 2**31 elements")
    route, n_split = _plan(k.dtype, b, h, h_kv, s, w, dh)
    if route == "window" and q.data_ptr() % 8:
        raise ValueError("the window kernel reads q in pairs: q must be 8-byte aligned")
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    layer = 0 if layer is None else layer
    if route == "window":
        err = _window_fn()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), starts.data_ptr(), limits_ptr,
            limit_scalar, out.data_ptr(), _DTYPE_CODES[q.dtype], b, w, h, h_kv, dh, s, layer,
            stride_l, stride_b, stride_s, n_split, stream,
        )
    else:
        err = _split_fn()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), starts.data_ptr(), limits_ptr,
            limit_scalar, out.data_ptr(), _DTYPE_CODES[q.dtype], _DTYPE_CODES[k.dtype],
            b, w, h, h_kv, dh, s, layer, stride_l, stride_b, stride_s, n_split, stream,
        )
    if err != 0:
        raise RuntimeError(f"flash_decode {route} kernel launch failed: cudaError {err}")
    flash_decode_attention.launches += 1
    if route == "window":
        flash_decode_attention.launches_window += 1
    else:
        flash_decode_attention.launches_split += 1
    return out


@functools.lru_cache(maxsize=None)
def _split_fn():
    """The split kernel's C entry point, its argument types set once."""
    fn = load("flash_decode").flash_decode_attention_launch
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, p, p, p, i, p] + [i] * 13 + [p]
    fn.restype = i
    return fn


@functools.lru_cache(maxsize=None)
def _window_fn():
    """The window kernel's C entry point, its argument types set once."""
    fn = load("flash_decode_window").flash_decode_window_launch
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, p, p, p, i, p] + [i] * 12 + [p]
    fn.restype = i
    return fn


def flash_decode_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    starts: torch.Tensor,
    limit: Limit,
    layer: Optional[int] = None,
) -> torch.Tensor:
    """Decode attention over the valid cache prefix; (B, H, Dh) or (B, W, H, Dh).

    CUDA tensors launch the kernel `k1_route` picks and count the launch in
    `flash_decode_attention.launches` (every launch) and in
    `launches_split` or `launches_window` (its route); CPU tensors run the
    plain version.
    """
    shapes = _shapes(q, k, v, starts, limit, layer)
    if q.device.type == "cuda":
        return _launch(q, k, v, starts, limit, layer, shapes)
    if q.device.type == "cpu":
        return flash_decode_attention_plain(q, k, v, starts, limit, layer)
    raise ValueError(f"no flash-decode route for device {q.device}")


flash_decode_attention.launches = 0
flash_decode_attention.launches_split = 0
flash_decode_attention.launches_window = 0
