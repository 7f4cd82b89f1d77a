"""Fused B=1 decode step: all decoder layers of one token in one launch
(kernel K3).

Port of `parler_tts_tpu/ops/pallas/fused_decode_step.py:fused_decode_layers`.
`fused_decode_layers` launches the CUDA kernel `csrc/fused_decode_step.cu`
for CUDA tensors and runs `fused_decode_layers_plain`, the plain PyTorch
version, for CPU tensors; there is no other route.

Semantics (those of the Pallas kernel, not of the eager decoder): int8
weight-only projections with per-output-channel scales; the residual carried
in fp32 across layers; LN in fp32 (eps 1e-5) rounded to bf16 before each
projection; q = bf16(q * Dh^-0.5), k and v bf16; self-attention over the
cache rows [start, n_rows) plus the current token, whose k/v join last;
cross-attention over the precomputed cross k/v with an additive encoder
bias; tanh gelu (relu and silu as the Pallas kernel has them); returns the
bf16 hidden state before the final LN and the new k/v rows (L, 1, D).
The plain version repeats the Pallas kernel's rounding at a given `block_s`,
the TPU layout's artifacts included (bf16 k*q products, the bf16 rescale
factor on the accumulator, the bf16 cross denominator).

`start` and `n_rows` are ints or () int32 tensors on the operands' device:
a tensor bound stays on the device (the kernel reads it there, clamping
start to >= 0 and n_rows to [0, S]), so a step that advances it in place
needs no host value.

Scope: B=1, MHA (H == H_kv, self and cross), sinusoidal positions; the CUDA
kernel also needs head_dim 64.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Dict, Tuple, Union

import torch

from ..config import DecoderConfig
from ..utils.quantize import quantize_kernel_torch
from ._cuda import load

NEG_INF = torch.finfo(torch.float32).min
_ACT_CODES = {"gelu": 0, "gelu_new": 0, "relu": 1}  # anything else: silu (2)
CUDA_CHUNK = 32  # kChunk of csrc/fused_decode_step.cu: cache rows per work item
_VARIANTS = {"stream": 1, "chain": 2}  # the kernel's timing variants (`Mode`)
Bound = Union[int, torch.Tensor]  # an int or a () int32 tensor on the operands' device
# (device index, D, F, H, S) -> (scratch, counters), allocated and zeroed once:
# every launch leaves the counters at 0 but the launch epoch, which it advances
_state: Dict[Tuple[int, ...], Tuple[torch.Tensor, torch.Tensor]] = {}

# How close the kernel must come to its plain version at the kernel's tiling
# (`tiling="cuda", block_s=CUDA_CHUNK`, fp32 sums). Every projection rounds
# its input to bf16, so a last-bit difference in an fp32 sum moves a rounding
# now and then, and the layers after carry that on: two right versions part
# by about a bf16 step in most entries a few layers down, and in some cases
# already in layer 1. The gaps are norm-relative, slice by slice (layer l's
# new k and v rows for l = 0 .. L-1, then the hidden state), and the noise is
# the same gap between the plain version summing in fp32 and in float64:
#   * in every case, each slice within K3_NOISE_FACTOR x the largest noise
#     over the cases at that slice or an earlier one (the noise grows with
#     depth), and at least K3_NOISE_FACTOR x K3_FLOOR;
#   * over the cases held, the median gap at slice 1 (layer 1's rows, the
#     first that layer 0's attention over the cache feeds) within
#     K3_NOISE_FACTOR x the median noise there, and at least
#     K3_NOISE_FACTOR x K3_FLOOR. A cache row dropped in every case moves
#     that median by about 2 x its limit at mini-v1's 434 and 867 rows; one
#     case's noise alone can be that large, so no per-case limit sees it.
# K3_FLOOR is one bf16 step (2^-8 of an entry at the least) in 1 of 64
# entries, norm-relative.
K3_NOISE_FACTOR = 4.0
K3_FLOOR = 2.0 ** -8 / 8


@dataclass
class FusedParams:
    """Per-layer stacked int8 weights and fp32 scales of a decoder.

    The weights are stored output-major, the layout the CUDA kernel reads:
    `w_attn[l]` is the JAX package's (D, 6D) `w_attn[l]` transposed, rows
    [q | k | v | o | cq | co]; `wfc1[l]` is (F, D) and `wfc2[l]` (D, F), each
    the transpose of the JAX package's. Scales and layer norms are as there.
    The JAX package's `head_sum` / `head_expand` one-hot matrices serve the
    TPU's layout only and are not kept.
    """

    ln1_scale: torch.Tensor  # (L, D) fp32 self_attn_layer_norm
    ln1_bias: torch.Tensor
    ln2_scale: torch.Tensor  # encoder_attn_layer_norm
    ln2_bias: torch.Tensor
    ln3_scale: torch.Tensor  # final_layer_norm
    ln3_bias: torch.Tensor
    w_attn: torch.Tensor     # (L, 6D, D) int8
    s_attn: torch.Tensor     # (L, 6D) fp32
    wfc1: torch.Tensor       # (L, F, D) int8
    sfc1: torch.Tensor       # (L, F)
    wfc2: torch.Tensor       # (L, D, F) int8
    sfc2: torch.Tensor       # (L, D)


def check_fused_config(config: DecoderConfig) -> None:
    """The fused step serves MHA models with sinusoidal positions."""
    h = config.num_attention_heads
    if config.num_key_value_heads != h or config.num_cross_attention_key_value_heads != h:
        raise ValueError(
            "the fused decode step supports MHA only (num_key_value_heads and "
            "num_cross_attention_key_value_heads equal to num_attention_heads)"
        )
    if config.rope_embeddings:
        raise ValueError("the fused decode step supports sinusoidal positions only, not RoPE")


@torch.no_grad()
def prepare_fused_params(decoder) -> FusedParams:
    """Quantize and stack a float `ParlerDecoder`'s layers, on its device."""
    check_fused_config(decoder.config)
    if not hasattr(decoder.layers[0].fc1, "kernel"):
        raise ValueError("prepare_fused_params needs float weights; this decoder is "
                         "weight_quant (the fused step quantizes the float kernels itself)")

    def quant(dense) -> Tuple[torch.Tensor, torch.Tensor]:
        w_q, scale = quantize_kernel_torch(dense.kernel)
        return w_q.t().contiguous(), scale

    fields = {name: [] for name in FusedParams.__dataclass_fields__}
    for layer in decoder.layers:
        sa, ca = layer.self_attn, layer.encoder_attn
        attn = [quant(m) for m in (sa.q_proj, sa.k_proj, sa.v_proj, sa.out_proj,
                                   ca.q_proj, ca.out_proj)]
        fields["w_attn"].append(torch.cat([w for w, _ in attn], dim=0))
        fields["s_attn"].append(torch.cat([s for _, s in attn]))
        for prefix, dense in (("fc1", layer.fc1), ("fc2", layer.fc2)):
            w, s = quant(dense)
            fields["w" + prefix].append(w)
            fields["s" + prefix].append(s)
        for i, ln in enumerate((layer.self_attn_layer_norm, layer.encoder_attn_layer_norm,
                                layer.final_layer_norm), start=1):
            fields[f"ln{i}_scale"].append(ln.scale.float())
            fields[f"ln{i}_bias"].append(ln.bias.float())
    return FusedParams(**{k: torch.stack(v).contiguous() for k, v in fields.items()})


def _check(config, fp, x_emb, cache_k, cache_v, cross_k, cross_v, enc_bias, start, n_rows):
    check_fused_config(config)
    n_layers, d = config.num_hidden_layers, config.hidden_size
    if tuple(x_emb.shape) != (1, d):
        raise ValueError(f"x_emb must be (1, {d}), got {tuple(x_emb.shape)}")
    if cache_k.dim() != 3 or cache_k.shape[0] != n_layers or cache_k.shape[2] != d:
        raise ValueError(f"cache must be ({n_layers}, S, {d}), got {tuple(cache_k.shape)}")
    if cross_k.dim() != 3 or cross_k.shape[0] != n_layers or cross_k.shape[2] != d:
        raise ValueError(f"cross k/v must be ({n_layers}, S_enc, {d}), got "
                         f"{tuple(cross_k.shape)}")
    if cache_v.shape != cache_k.shape or cross_v.shape != cross_k.shape:
        raise ValueError("k and v must have one shape")
    if enc_bias.numel() != cross_k.shape[1]:
        raise ValueError(f"enc_bias must have S_enc={cross_k.shape[1]} entries")
    for name, bound in (("start", start), ("n_rows", n_rows)):
        if isinstance(bound, torch.Tensor) and (
                bound.dtype != torch.int32 or bound.dim() != 0 or bound.device != x_emb.device):
            raise TypeError(f"a tensor {name} must be a () int32 tensor on {x_emb.device}, got "
                            f"{tuple(bound.shape)} {bound.dtype} on {bound.device}")
    # a tensor bound is not read on the host (that would wait for the device)
    if not isinstance(start, torch.Tensor) and start < 0:
        raise ValueError(f"need 0 <= start, got {start}")
    if not isinstance(n_rows, torch.Tensor) and not 0 <= n_rows <= cache_k.shape[1]:
        raise ValueError(f"need 0 <= n_rows ({n_rows}) <= S ({cache_k.shape[1]})")
    for t in (cache_k, cache_v, cross_k, cross_v, enc_bias, fp.w_attn):
        if t.device != x_emb.device:
            raise ValueError(f"operands on {t.device} and {x_emb.device}")


def _layer_norm(x, scale, bias):
    mu = x.mean(dim=-1, keepdim=True)
    var = (x - mu).square().mean(dim=-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + 1e-5) * scale + bias


def _activation(x: torch.Tensor, act: str) -> torch.Tensor:
    if act in ("gelu", "gelu_new"):  # tanh gelu, as the Pallas kernel has it
        return torch.nn.functional.gelu(x, approximate="tanh")
    if act == "relu":
        return torch.relu(x)
    return torch.nn.functional.silu(x)


@torch.no_grad()
def fused_decode_layers_plain(
    config: DecoderConfig,
    fp: FusedParams,
    x_emb: torch.Tensor,     # (1, D): summed codebook embedding + position
    cache_k: torch.Tensor,   # (L, S, D) bf16
    cache_v: torch.Tensor,
    cross_k: torch.Tensor,   # (L, S_enc, D) bf16
    cross_v: torch.Tensor,
    enc_bias: torch.Tensor,  # (1, S_enc) fp32 additive (0 / NEG_INF)
    start: Bound,
    n_rows: Bound,
    block_s: int = 64,
    tiling: str = "pallas",
    dtype: torch.dtype = torch.float32,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version with the kernel's rounding points, summing in
    `dtype` (float32; float64 measures what the order of fp32 sums does).
    Returns (hidden (1, D) bf16, new_k (L, 1, D) bf16, new_v (L, 1, D) bf16).

    `tiling` picks whose softmax tiling it repeats, the one rounding that
    depends on it: "pallas", an online softmax over `block_s`-row blocks of
    the cache from row 0 and one block over the encoder rows (the Pallas
    kernel); "cuda", `block_s`-row chunks from `start`, each with its own
    max and sum, merged after the last with the current token, and the
    encoder rows online over `block_s`-row groups (the CUDA kernel, at
    block_s=CUDA_CHUNK). Tensor bounds are read as the kernel reads them
    (start clamped to >= 0, n_rows to [0, S])."""
    if tiling not in ("pallas", "cuda"):
        raise ValueError(f"tiling must be 'pallas' or 'cuda', got {tiling!r}")
    _check(config, fp, x_emb, cache_k, cache_v, cross_k, cross_v, enc_bias, start, n_rows)
    if isinstance(start, torch.Tensor):
        start = max(int(start), 0)
    if isinstance(n_rows, torch.Tensor):
        n_rows = min(max(int(n_rows), 0), cache_k.shape[1])
    d, h = config.hidden_size, config.num_attention_heads
    dh = d // h
    inv_sqrt_dh = float(dh) ** -0.5
    s_cache, dev = cache_k.shape[1], x_emb.device
    bias = enc_bias.reshape(-1, 1).to(dtype)
    x = x_emb.to(torch.bfloat16).to(dtype)[0]  # (D,) residual
    new_k, new_v = [], []

    def bf16(t):  # t rounded to bf16, kept in `dtype`
        return t.to(torch.bfloat16).to(dtype)

    def proj(hb, w, s):  # bf16-valued (K,) x output-major int8 (N, K) -> (N,)
        return (w.to(dtype) @ hb) * s.to(dtype)

    def expand(per_head):  # (..., H) -> (..., D)
        return per_head.repeat_interleave(dh, dim=-1)

    def scores(k, q):  # (S', D) x (D,) -> (S', H): bf16 products, summed per head
        return bf16(k.to(dtype) * q).reshape(k.shape[0], h, dh).sum(dim=-1)

    def ln(i, l):
        return bf16(_layer_norm(x, getattr(fp, f"ln{i}_scale")[l].to(dtype),
                                getattr(fp, f"ln{i}_bias")[l].to(dtype)))

    def self_attention_pallas(l, q, knew, vnew):
        m_run = torch.full((h,), NEG_INF, dtype=dtype, device=dev)
        l_run = torch.zeros(h, dtype=dtype, device=dev)
        acc = torch.zeros(d, dtype=dtype, device=dev)
        for i in range(-(-n_rows // block_s)):
            r0, r1 = i * block_s, min((i + 1) * block_s, s_cache)
            pos = torch.arange(r0, r1, device=dev)[:, None]
            ok = (pos >= start) & (pos < n_rows)
            s_blk = torch.where(ok, scores(cache_k[l, r0:r1], q), NEG_INF)
            m_new = torch.maximum(m_run, s_blk.max(dim=0).values)
            p = torch.where(ok, torch.exp(s_blk - m_new), 0.0)
            alpha = torch.exp(m_run - m_new)
            pv = (expand(bf16(p)) * cache_v[l, r0:r1].to(dtype)).sum(dim=0)
            acc = acc * expand(bf16(alpha)) + pv
            l_run = l_run * alpha + p.sum(dim=0)
            m_run = m_new
        s_cur = scores(knew[None], q)[0]
        m_new = torch.maximum(m_run, s_cur)
        p_cur = torch.exp(s_cur - m_new)
        alpha = torch.exp(m_run - m_new)
        acc = acc * expand(bf16(alpha)) + expand(bf16(p_cur)) * vnew
        l_run = l_run * alpha + p_cur
        return bf16(acc / expand(l_run.clamp_min(1e-30)))

    def self_attention_cuda(l, q, knew, vnew):
        parts = []  # (max, sum, acc) of each chunk
        for r0 in range(start, n_rows, block_s):
            r1 = min(r0 + block_s, n_rows)
            s_blk = scores(cache_k[l, r0:r1], q)
            m = s_blk.max(dim=0).values
            p = torch.exp(s_blk - m)
            parts.append((m, p.sum(dim=0),
                          (expand(bf16(p)) * cache_v[l, r0:r1].to(dtype)).sum(dim=0)))
        s_cur = scores(knew[None], q)[0]
        big = s_cur
        for m, _, _ in parts:
            big = torch.maximum(big, m)
        acc = torch.zeros(d, dtype=dtype, device=dev)
        den = torch.zeros(h, dtype=dtype, device=dev)
        for m, l_sum, pv in parts:
            alpha = torch.exp(m - big)
            acc = acc + pv * expand(bf16(alpha))
            den = den + l_sum * alpha
        p_cur = torch.exp(s_cur - big)
        acc = acc + expand(bf16(p_cur)) * vnew
        return bf16(acc / expand((den + p_cur).clamp_min(1e-30)))

    def cross_attention(l, qc):
        s_all = scores(cross_k[l], qc) + bias
        group = s_all.shape[0] if tiling == "pallas" else block_s
        m_run = torch.full((h,), NEG_INF, dtype=dtype, device=dev)
        l_run = torch.zeros(h, dtype=dtype, device=dev)
        acc = torch.zeros(d, dtype=dtype, device=dev)
        for r0 in range(0, s_all.shape[0], group):
            s_c = s_all[r0:r0 + group]
            m_new = torch.maximum(m_run, s_c.max(dim=0).values)
            alpha = torch.exp(m_run - m_new)
            p_c = torch.exp(s_c - m_new)
            pv = (expand(bf16(p_c)) * cross_v[l, r0:r0 + group].to(dtype)).sum(dim=0)
            acc = acc * expand(alpha) + pv
            l_run = l_run * alpha + p_c.sum(dim=0)
            m_run = m_new
        return bf16(acc / expand(bf16(l_run.clamp_min(1e-30))))

    self_attention = self_attention_pallas if tiling == "pallas" else self_attention_cuda
    for l in range(config.num_hidden_layers):
        wa, sa = fp.w_attn[l], fp.s_attn[l]
        qkv = proj(ln(1, l), wa[:3 * d], sa[:3 * d])
        q = bf16(qkv[:d] * inv_sqrt_dh)
        knew, vnew = bf16(qkv[d:2 * d]), bf16(qkv[2 * d:])
        new_k.append(knew)
        new_v.append(vnew)
        x = x + proj(self_attention(l, q, knew, vnew), wa[3 * d:4 * d], sa[3 * d:4 * d])
        qc = bf16(proj(ln(2, l), wa[4 * d:5 * d], sa[4 * d:5 * d]) * inv_sqrt_dh)
        x = x + proj(cross_attention(l, qc), wa[5 * d:], sa[5 * d:])
        mid = _activation(proj(ln(3, l), fp.wfc1[l], fp.sfc1[l]), config.activation_function)
        x = x + proj(bf16(mid), fp.wfc2[l], fp.sfc2[l])
    as_rows = lambda rows: torch.stack(rows)[:, None].to(torch.bfloat16)  # noqa: E731
    return x[None].to(torch.bfloat16), as_rows(new_k), as_rows(new_v)


def fused_gaps(got, want) -> torch.Tensor:
    """Norm-relative gaps between two results of the fused step, slice by
    slice: layer l's new k and v rows together (l = 0 .. L-1), then the
    hidden state. Returns (L + 1,) fp32 on the CPU."""
    def slices(out):
        hidden, k, v = (t.float() for t in out)
        return torch.cat([k[:, 0], v[:, 0]], dim=1), hidden.reshape(1, -1)

    (gk, gh), (wk, wh) = slices(got), slices(want)
    gaps = [(gk - wk).norm(dim=1) / wk.norm(dim=1), (gh - wh).norm(dim=1) / wh.norm(dim=1)]
    return torch.cat(gaps).cpu()


def fused_limits(noise: torch.Tensor) -> Tuple[torch.Tensor, float]:
    """Limits from `noise` (cases, L + 1), the `fused_gaps` between the plain
    version summing in fp32 and in float64 over the cases held: (the limit
    of each slice in every case (L + 1,), the limit of the median over the
    cases of slice 1)."""
    noise = noise.reshape(-1, noise.shape[-1])
    per_case = noise.max(dim=0).values.cummax(dim=0).values.clamp_min(K3_FLOOR)
    median = max(K3_FLOOR, noise[:, 1].median().item())
    return K3_NOISE_FACTOR * per_case, K3_NOISE_FACTOR * median


def fused_close(gaps: torch.Tensor, limits: Tuple[torch.Tensor, float]) -> bool:
    """Whether `gaps` (cases, L + 1) keep the limits of `fused_limits`."""
    gaps = gaps.reshape(-1, gaps.shape[-1])
    per_case, median = limits
    return bool((gaps <= per_case).all()) and gaps[:, 1].median().item() <= median


def _library() -> ctypes.CDLL:
    lib = load("fused_decode_step")
    fn = lib.fused_decode_launch
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * 25 + [i] * 10 + [p]
        fn.restype = i
        lib.fused_decode_scratch_floats.argtypes = [i, i, i, i]
        lib.fused_decode_scratch_floats.restype = ctypes.c_longlong
        lib.fused_decode_counter_ints.argtypes = [i]
        lib.fused_decode_counter_ints.restype = i
        for name in ("fused_decode_head_dim", "fused_decode_chunk"):
            getattr(lib, name).argtypes = []
            getattr(lib, name).restype = i
        lib.fused_decode_plan.argtypes = [i, i] + [ctypes.POINTER(ctypes.c_int)] * 4
        lib.fused_decode_plan.restype = i
    return lib


def launch_plan(config: DecoderConfig) -> Dict[str, int]:
    """The kernel's launch on the current CUDA device: persistent blocks (one
    per SM), threads per block (consumer warps and the producer warp), the
    weight ring's stages and bytes per stage, and the cache rows per
    self-attention chunk (the plain version's `block_s` at tiling="cuda")."""
    lib = _library()
    out = [ctypes.c_int(0) for _ in range(4)]
    err = lib.fused_decode_plan(config.hidden_size, config.ffn_dim,
                                *(ctypes.byref(v) for v in out))
    if err != 0:
        raise RuntimeError(f"fused decode step: no cooperative launch (cudaError {err})")
    plan = dict(zip(("blocks", "threads", "stages", "stage_bytes"), (v.value for v in out)))
    return dict(plan, chunk=lib.fused_decode_chunk())


def _bound(value: Bound) -> Tuple[int, int]:
    """(device pointer or 0, host value or 0) of a bound."""
    if isinstance(value, torch.Tensor):
        return value.data_ptr(), 0
    return 0, int(value)


def _launch(config, fp, x_emb, cache_k, cache_v, cross_k, cross_v, enc_bias, start, n_rows,
            mode=0):
    d, f, h = config.hidden_size, config.ffn_dim, config.num_attention_heads
    n_layers, s_cache, s_enc = config.num_hidden_layers, cache_k.shape[1], cross_k.shape[1]
    lib = _library()
    if d // h != lib.fused_decode_head_dim() or f % 16:
        raise ValueError(f"the CUDA kernel needs head_dim {lib.fused_decode_head_dim()} "
                         f"(got {d // h}) and ffn_dim a multiple of 16 (got {f})")
    for name, t, dtype in (
        ("x_emb", x_emb, torch.bfloat16), ("cache_k", cache_k, torch.bfloat16),
        ("cache_v", cache_v, torch.bfloat16), ("cross_k", cross_k, torch.bfloat16),
        ("cross_v", cross_v, torch.bfloat16), ("enc_bias", enc_bias, torch.float32),
        ("w_attn", fp.w_attn, torch.int8), ("wfc1", fp.wfc1, torch.int8),
        ("wfc2", fp.wfc2, torch.int8), ("s_attn", fp.s_attn, torch.float32),
        ("sfc1", fp.sfc1, torch.float32), ("sfc2", fp.sfc2, torch.float32),
    ):
        if t.dtype != dtype or not t.is_contiguous():
            raise TypeError(f"{name} must be a contiguous {dtype} tensor, got {t.dtype}")
    for name in ("ln1_scale", "ln1_bias", "ln2_scale", "ln2_bias", "ln3_scale", "ln3_bias"):
        t = getattr(fp, name)
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise TypeError(f"{name} must be a contiguous float32 tensor")
    dev = x_emb.device
    hidden = torch.empty((1, d), dtype=torch.bfloat16, device=dev)
    new_k = torch.empty((n_layers, 1, d), dtype=torch.bfloat16, device=dev)
    new_v = torch.empty_like(new_k)
    key = (dev.index, d, f, h, s_cache)
    if key not in _state:  # zeroed once: no word of the scratch carries a tag yet
        _state[key] = (
            torch.zeros(lib.fused_decode_scratch_floats(d, f, h, s_cache), dtype=torch.float32,
                        device=dev),
            torch.zeros(lib.fused_decode_counter_ints(h), dtype=torch.int32, device=dev),
        )
    scratch, counters = _state[key]
    (start_ptr, start_value), (rows_ptr, rows_value) = _bound(start), _bound(n_rows)
    act = _ACT_CODES.get(config.activation_function, 2)
    err = lib.fused_decode_launch(
        x_emb.data_ptr(), fp.ln1_scale.data_ptr(), fp.ln1_bias.data_ptr(),
        fp.ln2_scale.data_ptr(), fp.ln2_bias.data_ptr(), fp.ln3_scale.data_ptr(),
        fp.ln3_bias.data_ptr(), fp.w_attn.data_ptr(), fp.s_attn.data_ptr(),
        fp.wfc1.data_ptr(), fp.sfc1.data_ptr(), fp.wfc2.data_ptr(), fp.sfc2.data_ptr(),
        cache_k.data_ptr(), cache_v.data_ptr(), cross_k.data_ptr(), cross_v.data_ptr(),
        enc_bias.data_ptr(), hidden.data_ptr(), new_k.data_ptr(), new_v.data_ptr(),
        scratch.data_ptr(), counters.data_ptr(), start_ptr, rows_ptr,
        n_layers, d, h, f, s_cache, s_enc, start_value, rows_value, act, mode,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"fused decode step launch failed: cudaError {err}")
    return hidden, new_k, new_v


def fused_decode_variant(variant: str, *args) -> None:
    """Launch a stripped timing variant of the kernel on CUDA tensors, with
    `fused_decode_layers`' arguments: "stream", the weight ring and the
    consumers' work without the dependency waits; "chain", the dependency
    waits and the consumers' work without the weight bytes. Their results
    mean nothing, so none is returned, and they do not count as launches of
    the kernel. Only the card's checks time them."""
    if variant not in _VARIANTS:
        raise ValueError(f"variant must be one of {sorted(_VARIANTS)}, got {variant!r}")
    _check(*args)
    if args[2].device.type != "cuda":
        raise ValueError("the timing variants run on CUDA tensors only")
    _launch(*args, mode=_VARIANTS[variant])


def fused_decode_layers(
    config: DecoderConfig,
    fp: FusedParams,
    x_emb: torch.Tensor,
    cache_k: torch.Tensor,
    cache_v: torch.Tensor,
    cross_k: torch.Tensor,
    cross_v: torch.Tensor,
    enc_bias: torch.Tensor,
    start: Bound,
    n_rows: Bound,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """All decoder layers of one B=1 token: (hidden (1, D) bf16 before the
    final LN, new_k (L, 1, D), new_v (L, 1, D)). `start` and `n_rows` are
    ints or () int32 tensors on the operands' device.

    CUDA tensors launch the kernel (and count the launch in
    `fused_decode_layers.launches`); CPU tensors run the plain version. The
    kernel's scratch and dependency counters are allocated at the first
    launch for a device and shape and reused by every later one, so launches
    of one shape go on one stream.
    """
    args = (config, fp, x_emb, cache_k, cache_v, cross_k, cross_v, enc_bias, start, n_rows)
    _check(*args)
    if x_emb.device.type == "cuda":
        out = _launch(*args)
        fused_decode_layers.launches += 1
        return out
    if x_emb.device.type == "cpu":
        return fused_decode_layers_plain(*args)
    raise ValueError(f"no fused decode route for device {x_emb.device}")


fused_decode_layers.launches = 0
