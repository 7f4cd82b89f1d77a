"""Training flash attention, forward and backward (kernel K4).

Port of `parler_tts_tpu/ops/pallas/flash_attention.py:flash_attention`.
`flash_attention` launches three CUDA kernels (forward, dq, dk/dv) through a
`torch.autograd.Function` for CUDA tensors and runs `flash_attention_plain`,
the plain PyTorch version with the same semantics and rounding, for CPU
tensors. On the card `_k4_route` picks the kernels by dtype and head dim:
bf16 with Dh = 64 (every configuration of the JAX package) runs on the
tensor cores (`csrc/flash_attention_wgmma.cu`: wgmma, TMA-fed tiles); fp32,
whose products stay exact in fp32, and bf16 with Dh 16, 32 or 128 run on the
CUDA cores (`csrc/flash_attention.cu`). Neither falls back to the other.

Semantics (those of the Pallas kernel, not of dense softmax attention):
  * q (B, Tq, H, Dh), already scaled; k/v (B, Tk, H_kv, Dh); mask (B, Tk)
    key validity; query row i sits at absolute position q_offset + i and, when
    causal, sees keys at positions <= its own;
  * kv heads are repeated to H before the autograd Function, so the repeat's
    own backward sums dk and dv over each group of H / H_kv query heads;
  * scores in fp32 from input-dtype operands; an online softmax over key
    tiles of `BLOCK_K` with m, l and acc in fp32, p rounded to the input
    dtype before p @ v (the rounding of p relative to the running max is why
    the plain version walks the kernel's tiles); l clamped at 1e-30;
  * backward from the fp32 logsumexp: p = exp(s - lse) where the mask
    allows, D = rowsum(do . o), ds = p * (do @ v^T - D); p rounded before
    p^T @ do, ds before ds @ k and ds^T @ q; sums in fp32;
  * a query row with no valid key (a left-padded prompt row) gets exactly 0
    in the output and in every gradient; dense softmax attention gives the
    mean of v there.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from ._cuda import load

NEG_INF = torch.finfo(torch.float32).min
BLOCK_K = 64  # the CUDA kernels' key tile; the plain version's softmax walks the same tiles
HEAD_DIMS = (16, 32, 64, 128)
WGMMA_HEAD_DIM = 64  # the tensor-core kernels' head dim (one 128-byte bf16 row)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_SOURCES = {"simt": "flash_attention", "wgmma": "flash_attention_wgmma"}


def _k4_route(dtype: torch.dtype, dh: int) -> str:
    """Which kernels K4 launches for a CUDA tensor: "wgmma" (tensor cores) for
    bf16 with Dh = 64, "simt" (CUDA cores, exact fp32 products) for fp32 and
    for bf16 with another supported head dim; raises for anything else."""
    if dtype not in _DTYPE_CODES:
        raise TypeError(f"dtype {dtype} not supported (float32, bfloat16)")
    if dh not in HEAD_DIMS:
        raise ValueError(f"head dim {dh} not supported by the kernel ({HEAD_DIMS})")
    return "wgmma" if dtype == torch.bfloat16 and dh == WGMMA_HEAD_DIM else "simt"


def _shapes(q, k, v, mask):
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"q and k must be (B, T, H, Dh), got {tuple(q.shape)}, {tuple(k.shape)}")
    b, tq, h, dh = q.shape
    tk, h_kv = k.shape[1], k.shape[2]
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != dh:
        raise ValueError(f"k/v {tuple(k.shape)}/{tuple(v.shape)} do not fit q {tuple(q.shape)}")
    if h % h_kv:
        raise ValueError(f"H={h} is not a multiple of H_kv={h_kv}")
    if mask is not None and tuple(mask.shape) != (b, tk):
        raise ValueError(f"mask must be (B, Tk) = {(b, tk)}, got {tuple(mask.shape)}")
    for name, t in (("k", k), ("v", v), ("mask", mask)):
        if t is not None and t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("q, k and v must share one dtype")
    return b, tq, h, dh, tk, h_kv


def _visible(mask, tq, causal, q_offset) -> torch.Tensor:
    """(B, 1, Tq, Tk) bool: key valid and, when causal, not after the query."""
    ok = mask.to(torch.bool)[:, None, None, :]
    if causal:
        tk = mask.shape[1]
        q_pos = torch.arange(tq, device=mask.device)[:, None] + q_offset
        ok = ok & (torch.arange(tk, device=mask.device)[None, :] <= q_pos)
    return ok


def _plain_forward(q, k, v, ok, acc_dtype, block_k) -> Tuple[torch.Tensor, torch.Tensor]:
    """o (B, Tq, H, Dh) in q's dtype and lse (B, H, Tq) in acc_dtype."""
    b, tq, h, dh = q.shape
    qa, ka, va = q.to(acc_dtype), k.to(acc_dtype), v.to(acc_dtype)
    m = torch.full((b, h, tq), NEG_INF, dtype=acc_dtype, device=q.device)
    l = torch.zeros((b, h, tq), dtype=acc_dtype, device=q.device)
    acc = torch.zeros((b, h, tq, dh), dtype=acc_dtype, device=q.device)
    for lo in range(0, k.shape[1], block_k):
        okb = ok[..., lo:lo + block_k]
        s = torch.einsum("bqhd,bkhd->bhqk", qa, ka[:, lo:lo + block_k])
        s = s.masked_fill(~okb, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None]).masked_fill(~okb, 0.0)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1)
        pv = torch.einsum("bhqk,bkhd->bhqd", p.to(q.dtype).to(acc_dtype), va[:, lo:lo + block_k])
        acc = acc * alpha[..., None] + pv
        m = m_new
    l = l.clamp_min(1e-30)
    o = (acc / l[..., None]).to(q.dtype).transpose(1, 2)
    return o, m + torch.log(l)


def _plain_backward(q, k, v, ok, o, lse, do, acc_dtype, parts=("dq", "dkv")):
    """(dq, dk, dv), or those of the kernels named in `parts` ("dq": dq;
    "dkv": dk, dv), each of which recomputes p and ds as its kernel does."""
    dt = q.dtype
    qa, ka, va, doa = (t.to(acc_dtype) for t in (q, k, v, do))
    s = torch.einsum("bqhd,bkhd->bhqk", qa, ka)
    p = torch.where(ok, torch.exp(torch.where(ok, s - lse[..., None], 0.0)), 0.0)
    delta = (doa * o.to(acc_dtype)).sum(dim=-1).transpose(1, 2)       # (B, H, Tq)
    dp = torch.einsum("bqhd,bkhd->bhqk", doa, va)
    ds = (p * (dp - delta[..., None])).to(dt).to(acc_dtype)
    out = []
    if "dq" in parts:
        out.append(torch.einsum("bhqk,bkhd->bqhd", ds, ka).to(dt))
    if "dkv" in parts:
        out.append(torch.einsum("bhqk,bqhd->bkhd", ds, qa).to(dt))
        out.append(torch.einsum("bhqk,bqhd->bkhd", p.to(dt).to(acc_dtype), doa).to(dt))
    return tuple(out)


class _PlainFlash(torch.autograd.Function):
    """The plain version as an autograd Function whose backward is the
    kernel's dense formula, so that p and ds are rounded where the kernel
    rounds them (autograd of the forward would round elsewhere)."""

    @staticmethod
    def forward(ctx, q, k, v, ok, acc_dtype, block_k):
        o, lse = _plain_forward(q, k, v, ok, acc_dtype, block_k)
        ctx.save_for_backward(q, k, v, ok, o, lse)
        ctx.acc_dtype = acc_dtype
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, ok, o, lse = ctx.saved_tensors
        return (*_plain_backward(q, k, v, ok, o, lse, do, ctx.acc_dtype), None, None, None)


def _repeat_kv(k, v, h):
    g = h // k.shape[2]
    if g == 1:
        return k, v
    return k.repeat_interleave(g, dim=2), v.repeat_interleave(g, dim=2)


def flash_attention_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    causal: bool = True,
    q_offset: int = 0,
    acc_dtype: torch.dtype = torch.float32,
    block_k: int = BLOCK_K,
) -> torch.Tensor:
    """Plain PyTorch version of the kernel: same semantics and rounding
    points, dense scores. `acc_dtype=torch.float64` sums in float64 with the
    same rounding points (a yardstick of fp32 summation noise)."""
    b, tq, _, _, tk, _ = _shapes(q, k, v, mask)
    if mask is None:
        mask = torch.ones((b, tk), dtype=torch.bool, device=q.device)
    k, v = _repeat_kv(k, v, q.shape[2])
    return _PlainFlash.apply(q, k, v, _visible(mask, tq, causal, q_offset), acc_dtype, block_k)


def _library(route: str) -> ctypes.CDLL:
    """The kernels of `route`; both sources share one C interface."""
    lib = load(_SOURCES[route])
    if lib.flash_attention_fwd.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.flash_attention_fwd.argtypes = [p] * 6 + [i] * 8 + [p]
        lib.flash_attention_dq.argtypes = [p] * 9 + [i] * 8 + [p]
        lib.flash_attention_dkv.argtypes = [p] * 9 + [i] * 8 + [p]
        for fn in (lib.flash_attention_fwd, lib.flash_attention_dq, lib.flash_attention_dkv):
            fn.restype = i
    return lib


def _check(err: int, which: str, route: str) -> None:
    if err != 0:
        raise RuntimeError(f"flash_attention {which} kernel ({route}) launch failed: "
                           f"cudaError {err}")
    flash_attention.launches[which] += 1
    if route == "wgmma":
        flash_attention.launches_wgmma[which] += 1


def _launch_fwd(q, k, v, mask_u8, dims, route):
    b, tq, h = q.shape[:3]
    o = torch.empty_like(q)
    lse = torch.empty((b, h, tq), dtype=torch.float32, device=q.device)
    _check(_library(route).flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), mask_u8.data_ptr(), o.data_ptr(),
        lse.data_ptr(), *dims, torch.cuda.current_stream(q.device).cuda_stream), "fwd", route)
    return o, lse


def _launch_dq(q, k, v, mask_u8, o, lse, do, dims, route):
    """dq, and delta = rowsum(do . o) (B, H, Tq) for the dk/dv kernel."""
    dq, delta = torch.empty_like(q), torch.empty_like(lse)
    _check(_library(route).flash_attention_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), mask_u8.data_ptr(), o.data_ptr(),
        lse.data_ptr(), do.data_ptr(), dq.data_ptr(), delta.data_ptr(), *dims,
        torch.cuda.current_stream(q.device).cuda_stream), "dq", route)
    return dq, delta


def _launch_dkv(q, k, v, mask_u8, lse, do, delta, dims, route):
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _check(_library(route).flash_attention_dkv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), mask_u8.data_ptr(), lse.data_ptr(),
        do.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), *dims,
        torch.cuda.current_stream(q.device).cuda_stream), "dkv", route)
    return dk, dv


class _CudaFlash(torch.autograd.Function):
    """K4: the forward kernel; the backward launches the dq kernel (which also
    writes D = rowsum(do . o)) and then the dk/dv kernel, each on the stream
    that is current when it runs (autograd may run the backward on another),
    all three from the route `_k4_route` picked."""

    @staticmethod
    def forward(ctx, q, k, v, mask_u8, causal, q_offset, route):
        b, tq, h, dh = q.shape
        dims = (_DTYPE_CODES[q.dtype], b, h, tq, k.shape[1], dh, int(causal), q_offset)
        o, lse = _launch_fwd(q, k, v, mask_u8, dims, route)
        ctx.save_for_backward(q, k, v, mask_u8, o, lse)
        ctx.dims, ctx.route = dims, route
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, mask_u8, o, lse = ctx.saved_tensors
        do = do.to(q.dtype).contiguous()
        dq, delta = _launch_dq(q, k, v, mask_u8, o, lse, do, ctx.dims, ctx.route)
        dk, dv = _launch_dkv(q, k, v, mask_u8, lse, do, delta, ctx.dims, ctx.route)
        return dq, dk, dv, None, None, None, None


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    causal: bool = True,
    q_offset: int = 0,
) -> torch.Tensor:
    """Causal, key-masked attention for training, differentiable; returns
    (B, Tq, H, Dh) in q's dtype.

    CUDA tensors launch K4 on the route `_k4_route` picks (each launch counted
    in `flash_attention.launches` by kernel, "fwd", "dq", "dkv", and those of
    the tensor-core route also in `flash_attention.launches_wgmma`); CPU
    tensors run `flash_attention_plain`."""
    b, tq, h, dh, tk, _ = _shapes(q, k, v, mask)
    if q_offset < 0:
        raise ValueError(f"q_offset must be >= 0, got {q_offset}")
    if mask is None:
        mask = torch.ones((b, tk), dtype=torch.bool, device=q.device)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, mask, causal, q_offset)
    if q.device.type != "cuda":
        raise ValueError(f"no flash-attention route for device {q.device}")
    route = _k4_route(q.dtype, dh)
    k, v = _repeat_kv(k, v, h)
    return _CudaFlash.apply(q.contiguous(), k.contiguous(), v.contiguous(),
                            mask.to(torch.uint8).contiguous(), causal, q_offset, route)


flash_attention.launches = {"fwd": 0, "dq": 0, "dkv": 0}        # every route
flash_attention.launches_wgmma = {"fwd": 0, "dq": 0, "dkv": 0}  # the tensor-core route


# ------------------------------------------------ holding K4 to its plain version
# Gaps are norm-relative, ||got - want|| / ||want||, for o, dq, dk and dv. A
# limit is K4_NOISE_FACTOR x the gap between the plain version summing in
# fp32 and in float64 (same rounding points) on the same inputs, and at least
# K4_FLOOR: bf16's floor is a tenth of what dropping one 64-key tile moves
# mini-v1's training shape by.
K4_NOISE_FACTOR = 4.0
K4_FLOOR = {torch.float32: 1e-6, torch.bfloat16: 1e-4}


def attention_and_grads(fn, q, k, v, mask, do, **kw):
    """[o, dq, dk, dv] of `fn(q, k, v, mask, **kw)` for the cotangent `do`, fp32."""
    qq, kk, vv = (x.detach().clone().requires_grad_(True) for x in (q, k, v))
    o = fn(qq, kk, vv, mask, **kw)
    o.backward(do)
    return [x.float() for x in (o.detach(), qq.grad, kk.grad, vv.grad)]


def k4_gaps(got, want):
    return [float((g - w).norm() / w.norm().clamp_min(1e-30)) for g, w in zip(got, want)]


def k4_limits(noise, dtype):
    return [max(K4_NOISE_FACTOR * n, K4_FLOOR[dtype]) for n in noise]
