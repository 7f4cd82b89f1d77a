"""Kernel K4's plain version (`flash_attention_plain`, what the port runs on
the CPU) and the port's `chunked_attention` against the JAX package, values
and gradients, fp32 on the CPU. The JAX side runs the Pallas kernel in
interpret mode, as `tests/test_flash_attention.py` does, on that file's
cases plus a left-padded row whose first queries see no valid key.

Tolerances: values atol 2e-5 / rtol 2e-5 (`test_flash_attention.py`'s);
gradients atol 5e-4 / rtol 5e-3 (its model-level gradient check). A query row
with no valid key is 0 in both, in the output and in every gradient.

In bf16 the rounding points decide the result (p relative to the running max
before p @ v, p before p^T @ do, ds before ds @ k and ds^T @ q), so the same
cases also run with bf16 inputs against the Pallas kernel at the port's key
tile (block_k 64): each of o, dq, dk, dv within the card check's rule,
`k4_limits` of the gap between the plain version summing in fp32 and in
float64 (norm-relative, 4x that gap, at least 1e-4).

`_k4_route`, which picks the CUDA kernels by dtype and head dim, is tested
here too: the choice needs no card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parler_tts_tpu.ops.chunked_attention import chunked_attention as jax_chunked
from parler_tts_tpu.ops.pallas.flash_attention import flash_attention as pallas_flash
from parler_tts_tpu_torch.ops.chunked_attention import chunked_attention
from parler_tts_tpu_torch.ops.flash_attention import (
    BLOCK_K,
    _k4_route,
    attention_and_grads,
    flash_attention,
    flash_attention_plain,
    k4_gaps,
    k4_limits,
)

VALUE_TOL = dict(atol=2e-5, rtol=2e-5)
GRAD_TOL = dict(atol=5e-4, rtol=5e-3)


def inputs(seed, b, tq, tk, h, h_kv, dh, left_pad=0):
    rng = np.random.default_rng(seed)
    q = (rng.normal(size=(b, tq, h, dh)) * dh ** -0.5).astype(np.float32)
    k = rng.normal(size=(b, tk, h_kv, dh)).astype(np.float32)
    v = rng.normal(size=(b, tk, h_kv, dh)).astype(np.float32)
    w = rng.normal(size=(b, tq, h, dh)).astype(np.float32)  # cotangent
    mask = np.ones((b, tk), bool)
    mask[-1, max(1, tk - 37):] = False  # right padding, as the Pallas tests
    if left_pad:
        mask[0, :left_pad] = False      # prompt padding: the first rows see no key
    return q, k, v, mask, w


def jax_value_and_grads(fn, q, k, v, w):
    out, vjp = jax.vjp(fn, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return [np.asarray(x) for x in (out, *vjp(jnp.asarray(w)))]


def torch_value_and_grads(fn, q, k, v, w):
    tq, tk, tv = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    out = fn(tq, tk, tv)
    (out * torch.from_numpy(w)).sum().backward()
    return [x.detach().numpy() for x in (out, tq.grad, tk.grad, tv.grad)]


CASES = pytest.mark.parametrize(
    "tq,tk,h,h_kv,causal,q_offset,left_pad",
    [
        (256, 256, 4, 4, True, 0, 0),       # MHA causal, block-aligned
        (200, 200, 4, 4, True, 0, 0),       # lengths off the tiles
        (128, 384, 4, 4, True, 256, 0),     # q block at an offset into the keys
        (256, 256, 8, 2, True, 0, 0),       # GQA, 4 query heads per kv head
        (192, 256, 4, 4, False, 0, 0),      # non-causal
        (200, 200, 4, 4, True, 0, 5),       # left-padded row: rows 0-4 see no valid key
    ],
)


@CASES
def test_plain_matches_pallas_kernel(tq, tk, h, h_kv, causal, q_offset, left_pad):
    q, k, v, mask, w = inputs(tq + tk + h_kv, 2, tq, tk, h, h_kv, 64, left_pad)
    want = jax_value_and_grads(
        lambda a, b_, c: pallas_flash(a, b_, c, jnp.asarray(mask), causal=causal,
                                      q_offset=q_offset, block_q=128, block_k=128),
        q, k, v, w)
    got = torch_value_and_grads(
        lambda a, b_, c: flash_attention(a, b_, c, torch.from_numpy(mask), causal=causal,
                                         q_offset=q_offset),
        q, k, v, w)
    for name, g, x in zip(("o", "dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g, x, err_msg=name, **(VALUE_TOL if name == "o" else GRAD_TOL))
    if left_pad:
        for g in got[:2]:  # o and dq of the rows with no valid key
            assert not g[0, :left_pad].any()


@CASES
def test_plain_matches_pallas_kernel_bf16(tq, tk, h, h_kv, causal, q_offset, left_pad):
    """bf16 inputs. kv heads are repeated before both sides: the group-sum of
    dk and dv is the framework's reduction (XLA's CPU reduce of bf16 rounds
    differently from torch's), not the kernel's, and the fp32 cases hold it."""
    q, k, v, mask, w = inputs(tq + tk + h_kv, 2, tq, tk, h, h_kv, 64, left_pad)
    k, v = np.repeat(k, h // h_kv, axis=2), np.repeat(v, h // h_kv, axis=2)
    tq_, tk_, tv_, tw = (torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v, w))
    m = torch.from_numpy(mask)
    kw = dict(causal=causal, q_offset=q_offset)
    got = attention_and_grads(flash_attention_plain, tq_, tk_, tv_, m, tw, **kw)
    wide = attention_and_grads(flash_attention_plain, tq_, tk_, tv_, m, tw,
                               acc_dtype=torch.float64, **kw)

    def bf16(x):
        return jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)

    out, vjp = jax.vjp(
        lambda a, b_, c: pallas_flash(a, b_, c, jnp.asarray(mask), block_q=64, block_k=BLOCK_K,
                                      **kw),
        bf16(tq_), bf16(tk_), bf16(tv_))
    want = [torch.from_numpy(np.asarray(x.astype(jnp.float32))) for x in (out, *vjp(bf16(tw)))]
    gaps, limits = k4_gaps(got, want), k4_limits(k4_gaps(got, wide), torch.bfloat16)
    for name, gap, limit in zip(("o", "dq", "dk", "dv"), gaps, limits):
        assert gap <= limit, (name, gap, limit)
    if left_pad:
        for g in got[:2]:
            assert not g[0, :left_pad].any()


def test_plain_tiling_and_float64_agree():
    """The plain version's key tiling only reorders fp32 sums; its float64
    form stays within fp32 noise of it (the yardstick the card check uses)."""
    q, k, v, mask, w = inputs(3, 2, 130, 130, 4, 2, 16, left_pad=3)
    m = torch.from_numpy(mask)
    one = torch_value_and_grads(lambda a, b, c: flash_attention_plain(a, b, c, m), q, k, v, w)
    for kw in (dict(block_k=130), dict(acc_dtype=torch.float64)):
        other = torch_value_and_grads(
            lambda a, b, c: flash_attention_plain(a, b, c, m, **kw), q, k, v, w)
        for g, x in zip(one, other):
            np.testing.assert_allclose(g, x, atol=2e-6, rtol=1e-5)
    assert BLOCK_K == 64


@pytest.mark.parametrize("dtype,dh,route", [
    (torch.bfloat16, 64, "wgmma"),   # every configuration of the JAX package: tensor cores
    (torch.float32, 64, "simt"),     # fp32 keeps exact fp32 products on the CUDA cores
    (torch.float32, 16, "simt"),
    (torch.float32, 128, "simt"),
    (torch.bfloat16, 16, "simt"),
    (torch.bfloat16, 32, "simt"),
    (torch.bfloat16, 128, "simt"),
])
def test_k4_route_by_dtype_and_head_dim(dtype, dh, route):
    """Which kernels a CUDA tensor launches; the choice needs no card."""
    assert _k4_route(dtype, dh) == route


@pytest.mark.parametrize("dtype,dh,error", [
    (torch.float16, 64, TypeError),
    (torch.float64, 64, TypeError),
    (torch.bfloat16, 48, ValueError),
    (torch.float32, 256, ValueError),
])
def test_k4_route_rejects_what_no_kernel_takes(dtype, dh, error):
    with pytest.raises(error):
        _k4_route(dtype, dh)


def test_launch_counters_cover_both_routes():
    assert flash_attention.launches.keys() == flash_attention.launches_wgmma.keys() == {
        "fwd", "dq", "dkv"}


def test_cpu_route_is_the_plain_version():
    q, k, v, mask, _ = inputs(4, 1, 70, 70, 2, 2, 32)
    args = [torch.from_numpy(x) for x in (q, k, v, mask)]
    assert torch.equal(flash_attention(*args), flash_attention_plain(*args))
    with pytest.raises(ValueError, match="mask"):
        flash_attention(*args[:3], args[3][:, :5])


@pytest.mark.parametrize(
    "chunk,h_kv,causal,q_offset", [(32, 4, True, 0), (64, 2, False, 0), (48, 4, True, 20)])
def test_chunked_attention_matches_jax(chunk, h_kv, causal, q_offset):
    q, k, v, mask, w = inputs(chunk + h_kv, 2, 100, 120, 4, h_kv, 32, left_pad=17)
    want = jax_value_and_grads(
        lambda a, b, c: jax_chunked(a, b, c, jnp.asarray(mask), causal=causal,
                                    q_offset=q_offset, chunk_q=chunk, chunk_k=chunk),
        q, k, v, w)
    got = torch_value_and_grads(
        lambda a, b, c: chunked_attention(a, b, c, torch.from_numpy(mask), causal=causal,
                                          q_offset=q_offset, chunk_q=chunk, chunk_k=chunk),
        q, k, v, w)
    for name, g, x in zip(("o", "dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g, x, err_msg=name, **(VALUE_TOL if name == "o" else GRAD_TOL))
