"""Flash-decode attention over the static KV cache (kernel K1).

Port of `parler_tts_tpu/ops/pallas/flash_decode.py:flash_decode_attention`.
`flash_decode_attention` launches the CUDA kernel `csrc/flash_decode.cu` for
CUDA tensors and runs `flash_decode_attention_plain`, the plain PyTorch
version with the same semantics, for CPU tensors; there is no other route.

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
"""

from __future__ import annotations

import ctypes
from typing import Optional, Union

import torch

from ._cuda import load

NEG_INF = torch.finfo(torch.float32).min
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_INT32_MAX = 2**31 - 1

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


def flash_decode_attention_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    starts: torch.Tensor,
    limit: Limit,
    layer: Optional[int] = None,
) -> torch.Tensor:
    """Plain PyTorch version of the kernel, same semantics and rounding points."""
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
    valid = valid[:, :, None, None, :]
    qg = q4.to(k.dtype).float().reshape(b, w, h_kv, h // h_kv, dh)
    scores = torch.einsum("bwkgd,bskd->bwkgs", qg, k.float())
    scores = scores.masked_fill(~valid, NEG_INF)
    p = torch.exp(scores - scores.amax(dim=-1, keepdim=True)).masked_fill(~valid, 0.0)
    denom = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    ctx = torch.einsum("bwkgs,bskd->bwkgd", p.to(v.dtype).float(), v.float())
    out = (ctx / denom).reshape(b, w, h, dh).to(q.dtype)
    return out if q.dim() == 4 else out[:, 0]


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
        raise ValueError("the kernel reads K/V rows in 16-byte vectors: Dh * itemsize must be "
                         "a multiple of 16 and k/v 16-byte aligned")
    stride_s = h_kv * dh
    stride_b = s * stride_s
    stride_l = b * stride_b
    if stride_l > _INT32_MAX:
        raise ValueError("cache layer exceeds 2**31 elements")
    lib = _library()
    rows = (h // h_kv) * w
    if lib.flash_decode_smem_bytes(rows, dh) > lib.flash_decode_max_smem_bytes():
        raise ValueError(f"{rows} query rows of Dh={dh} exceed one block's shared memory")
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    err = lib.flash_decode_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), starts.data_ptr(), limits_ptr,
        limit_scalar, out.data_ptr(), _DTYPE_CODES[q.dtype], _DTYPE_CODES[k.dtype],
        b, w, h, h_kv, dh, s, 0 if layer is None else layer, stride_l, stride_b, stride_s,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"flash_decode kernel launch failed: cudaError {err}")
    flash_decode_attention.launches += 1
    return out


def _library() -> ctypes.CDLL:
    lib = load("flash_decode")
    fn = lib.flash_decode_attention_launch
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, i, p] + [i] * 12 + [p]
        fn.restype = i
        lib.flash_decode_smem_bytes.argtypes = [i, i]
        lib.flash_decode_smem_bytes.restype = ctypes.c_longlong
        lib.flash_decode_max_smem_bytes.argtypes = []
        lib.flash_decode_max_smem_bytes.restype = ctypes.c_longlong
    return lib


def flash_decode_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    starts: torch.Tensor,
    limit: Limit,
    layer: Optional[int] = None,
) -> torch.Tensor:
    """Decode attention over the valid cache prefix; (B, H, Dh) or (B, W, H, Dh).

    CUDA tensors launch the kernel (and count the launch in
    `flash_decode_attention.launches`); CPU tensors run the plain version.
    """
    shapes = _shapes(q, k, v, starts, limit, layer)
    if q.device.type == "cuda":
        return _launch(q, k, v, starts, limit, layer, shapes)
    if q.device.type == "cpu":
        return flash_decode_attention_plain(q, k, v, starts, limit, layer)
    raise ValueError(f"no flash-decode route for device {q.device}")


flash_decode_attention.launches = 0
