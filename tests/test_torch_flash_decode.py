"""Kernel K1's plain PyTorch version against the Pallas kernel (interpret mode).

`flash_decode_attention_plain` is what the port's wrapper runs for CPU
tensors and what the CUDA kernel is held against on the card
(`tests/test_torch_cuda.py`, `chip_smoke.py`). Here it is held against the
Pallas kernel itself, run in interpret mode as `tests/test_flash_decode.py`
runs it, on the same cases. Tolerance: atol 2e-5, rtol 1e-4 in fp32 (the
Pallas file's own); atol 2e-3, rtol 1e-2 in bf16 (one bf16 ulp, 2.4e-4, is the
most these cases read).
"""

import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parler_tts_tpu.ops.pallas.flash_decode import flash_decode_attention as pallas_decode
from parler_tts_tpu_torch.ops.flash_decode import (
    MAX_SPLITS,
    flash_decode_attention,
    flash_decode_attention_plain,
    flash_decode_attention_shares,
    k1_route,
    kernel_split_count,
    slot_range,
    split_bounds,
    split_count,
    window_split_count,
)

F32_TOL = dict(atol=2e-5, rtol=1e-4)
BF16_TOL = dict(atol=2e-3, rtol=1e-2)


def make_case(seed=0, b=2, h=8, h_kv=8, dh=64, s=512, w=None):
    rng = np.random.default_rng(seed)
    qshape = (b, h, dh) if w is None else (b, w, h, dh)
    q = rng.normal(size=qshape).astype(np.float32) * 0.3
    k = rng.normal(size=(b, s, h_kv, dh)).astype(np.float32) * 0.3
    v = rng.normal(size=(b, s, h_kv, dh)).astype(np.float32) * 0.3
    return q, k, v


def both(q, k, v, starts, limit, block_s=256, layer=None, dtype=np.float32, splits=1):
    """(Pallas interpret output, port plain output) as fp32 numpy; the port's
    plain version cut into `splits` shares."""
    jdt = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bf16" else torch.float32
    starts = np.asarray(starts, np.int32)
    limit_np = np.asarray(limit, np.int32)
    got = pallas_decode(
        jnp.asarray(q, jdt), jnp.asarray(k, jdt), jnp.asarray(v, jdt),
        jnp.asarray(starts), jnp.asarray(limit_np), block_s=block_s, interpret=True,
        layer=layer,
    )
    t_limit = int(limit) if limit_np.ndim == 0 else torch.from_numpy(limit_np)
    port = flash_decode_attention_plain(
        torch.from_numpy(q).to(tdt), torch.from_numpy(k).to(tdt), torch.from_numpy(v).to(tdt),
        torch.from_numpy(starts), t_limit, layer=layer, splits=splits,
    )
    return np.asarray(got, np.float32), port.float().numpy()


@pytest.mark.parametrize("b", [1, 2, 8])
@pytest.mark.parametrize("limit", [1, 5, 255, 256, 257, 512])
def test_plain_matches_pallas_prefix(b, limit):
    q, k, v = make_case(b=b)
    want, got = both(q, k, v, np.zeros(b), limit)
    np.testing.assert_allclose(got, want, **F32_TOL)


@pytest.mark.parametrize("b", [1, 2, 8])
def test_plain_matches_pallas_left_padded_starts(b):
    q, k, v = make_case(seed=1, b=b)
    starts = np.random.default_rng(7).integers(0, 120, (b,))
    want, got = both(q, k, v, starts, 300, block_s=128)
    np.testing.assert_allclose(got, want, **F32_TOL)


def test_plain_matches_pallas_per_row_limits():
    b = 8
    q, k, v = make_case(seed=9, b=b)
    rng = np.random.default_rng(3)
    starts = rng.integers(0, 50, (b,))
    limits = rng.integers(60, 512, (b,))
    want, got = both(q, k, v, starts, limits, block_s=128)
    np.testing.assert_allclose(got, want, **F32_TOL)


def test_plain_matches_pallas_gqa():
    q, k, v = make_case(seed=2, h=8, h_kv=2)
    want, got = both(q, k, v, np.zeros(2), 200, block_s=128)
    np.testing.assert_allclose(got, want, **F32_TOL)


def test_plain_matches_pallas_mqa():
    q, k, v = make_case(seed=4, h=8, h_kv=1)
    want, got = both(q, k, v, np.array([0, 33]), 200, block_s=128)
    np.testing.assert_allclose(got, want, **F32_TOL)


def test_plain_matches_pallas_bf16():
    q, k, v = make_case(seed=3)
    want, got = both(q, k, v, np.zeros(2), 400, dtype="bf16")
    np.testing.assert_allclose(got, want, **BF16_TOL)


@pytest.mark.parametrize("b", [1, 2, 8])
@pytest.mark.parametrize("w", [2, 8])
def test_plain_matches_pallas_window(b, w):
    q, k, v = make_case(seed=11, b=b, w=w)
    want, got = both(q, k, v, np.zeros(b), 130, block_s=128)
    assert got.shape == q.shape
    np.testing.assert_allclose(got, want, **F32_TOL)


def test_plain_matches_pallas_window_per_row_limits():
    b, w = 8, 6
    q, k, v = make_case(seed=12, b=b, w=w)
    rng = np.random.default_rng(5)
    starts = rng.integers(0, 40, (b,))
    limits = rng.integers(41, 500 - w, (b,))
    want, got = both(q, k, v, starts, limits, block_s=128)
    np.testing.assert_allclose(got, want, **F32_TOL)


def test_plain_matches_pallas_window_gqa_bf16():
    q, k, v = make_case(seed=13, b=2, h=8, h_kv=2, w=4)
    want, got = both(q, k, v, np.array([0, 17]), 333, dtype="bf16")
    np.testing.assert_allclose(got, want, **BF16_TOL)


@pytest.mark.parametrize("limit", [126, 127, 128])
def test_plain_matches_pallas_window_block_boundaries(limit):
    q, k, v = make_case(seed=14, b=2, w=4, s=256)
    want, got = both(q, k, v, np.zeros(2), limit, block_s=128)
    np.testing.assert_allclose(got, want, **F32_TOL)


@pytest.mark.parametrize("flat", [True, False])
@pytest.mark.parametrize("layer", [0, 2])
def test_plain_matches_pallas_stacked_layer(flat, layer):
    b, h, h_kv, dh, s, n_layers = 2, 8, 4, 64, 384, 3
    rng = np.random.default_rng(20 + layer)
    q = rng.normal(size=(b, h, dh)).astype(np.float32) * 0.3
    ks = rng.normal(size=(n_layers, b, s, h_kv, dh)).astype(np.float32) * 0.3
    vs = rng.normal(size=(n_layers, b, s, h_kv, dh)).astype(np.float32) * 0.3
    starts = rng.integers(0, 40, (b,))
    if flat:
        ks, vs = ks.reshape(n_layers, b, s, -1), vs.reshape(n_layers, b, s, -1)
    want, got = both(q, ks, vs, starts, 300, block_s=128, layer=layer)
    np.testing.assert_allclose(got, want, **F32_TOL)


def test_plain_matches_pallas_stacked_layer_windowed():
    b, w, h, h_kv, dh, s, n_layers = 2, 4, 8, 8, 64, 384, 2
    rng = np.random.default_rng(31)
    q = rng.normal(size=(b, w, h, dh)).astype(np.float32) * 0.3
    ks = rng.normal(size=(n_layers, b, s, h_kv * dh)).astype(np.float32) * 0.3
    vs = rng.normal(size=(n_layers, b, s, h_kv * dh)).astype(np.float32) * 0.3
    want, got = both(q, ks, vs, np.zeros(b), np.array([100, 250]), block_s=128, layer=1)
    np.testing.assert_allclose(got, want, **F32_TOL)


def test_empty_range_returns_zero_like_the_kernel():
    """limit <= start: the Pallas kernel's clamped denominator gives 0 (its
    XLA oracle would give the mean of V); the port follows the kernel."""
    q, k, v = make_case(seed=15, b=2)
    want, got = both(q, k, v, np.array([40, 0]), np.array([40, 0]), block_s=128)
    np.testing.assert_array_equal(want, 0.0)
    np.testing.assert_array_equal(got, 0.0)


def test_wrapper_runs_plain_version_for_cpu_tensors():
    q, k, v = (torch.from_numpy(x) for x in make_case(seed=16, b=2, h=8, h_kv=2))
    starts = torch.tensor([0, 9], dtype=torch.int32)
    before = flash_decode_attention.launches
    got = flash_decode_attention(q, k, v, starts, 100)
    want = flash_decode_attention_plain(q, k, v, starts, 100)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert flash_decode_attention.launches == before  # only kernel launches count


@pytest.mark.parametrize(
    "bad",
    ["q_rank", "heads", "layer_range", "starts_shape", "batch"],
)
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    q, k, v = (torch.from_numpy(x) for x in make_case(seed=17, b=2, h=8, h_kv=4, s=64))
    starts = torch.zeros(2, dtype=torch.int32)
    layer = None
    if bad == "q_rank":
        q = q[0]
    elif bad == "heads":
        q = q[:, :6]
    elif bad == "layer_range":
        k, v, layer = k[None], v[None], 1
    elif bad == "starts_shape":
        starts = torch.zeros(3, dtype=torch.int32)
    elif bad == "batch":
        k, v = k[:1], v[:1]
    with pytest.raises(ValueError):
        flash_decode_attention(q, k, v, starts, 10, layer=layer)


# ------------------------------------------------ the kernel's split form
def split_case(kind):
    """(q, k, v, starts, limit, dtype) of one split-form case."""
    if kind == "short_prefix":  # limit 3: with 8 shares, shares 3-7 own no slot
        return (*make_case(seed=40), np.zeros(2), 3, np.float32)
    if kind == "per_row":
        rng = np.random.default_rng(41)
        return (*make_case(seed=41, b=8), rng.integers(0, 50, (8,)), rng.integers(60, 512, (8,)),
                np.float32)
    if kind == "window":
        return (*make_case(seed=42, w=4), np.array([0, 17]), 130, np.float32)
    if kind == "gqa":
        return (*make_case(seed=43, h=8, h_kv=2), np.array([0, 33]), 200, np.float32)
    if kind == "bf16":
        return (*make_case(seed=44), np.array([0, 5]), 400, "bf16")
    # the window kernel's shapes (G x W > 8 rows a kv head), per-row limits
    # that differ, row 1 left-padded
    if kind == "window_w24":
        return (*make_case(seed=47, h=2, h_kv=2, w=24, s=256), np.array([0, 17]),
                np.array([220, 140]), "bf16")
    if kind == "window_w16":
        return (*make_case(seed=48, h=3, h_kv=3, w=16, s=256), np.array([3, 0]),
                np.array([90, 235]), np.float32)
    if kind == "window_gqa":
        return (*make_case(seed=49, h=8, h_kv=2, w=4, s=256), np.array([0, 33]),
                np.array([200, 250]), "bf16")
    assert kind == "empty"
    return (*make_case(seed=45), np.array([40, 0]), np.array([40, 0]), np.float32)


@pytest.mark.parametrize("splits", [1, 2, MAX_SPLITS])
@pytest.mark.parametrize("kind", ["short_prefix", "per_row", "window", "gqa", "bf16", "empty",
                                  "window_w24", "window_w16", "window_gqa"])
def test_plain_split_form_matches_pallas(kind, splits):
    """The kernel's form: each share its own max, sum and accumulator, merged
    in rank order; shares that own no slot weigh exactly nothing."""
    q, k, v, starts, limit, dtype = split_case(kind)
    want, got = both(q, k, v, starts, limit, block_s=128, dtype=dtype, splits=splits)
    assert got.shape == q.shape
    np.testing.assert_allclose(got, want, **(BF16_TOL if dtype == "bf16" else F32_TOL))
    if kind == "empty":
        np.testing.assert_array_equal(got, 0.0)


@pytest.mark.parametrize("begin,end,n", [
    (0, 0, 8), (5, 3, 4), (0, 1, 8), (0, 3, 8), (3, 9, 8), (3, 12, 8), (0, 868, 8),
    (7, 500, 4), (0, 127, 2), (10, 11, 1), (1, 512, 8), (0, 513, 8),
])
def test_split_bounds_tile_the_range(begin, end, n):
    """Shares are contiguous, in order, cover [begin, end) once and hold
    ceil(len / n) slots each but the last ones; the kernel's `share_of`
    rule gives the same edges."""
    edges = split_bounds(begin, end, n).tolist()
    length = max(end - begin, 0)
    chunk = -(-length // n)
    assert len(edges) == n + 1 and edges[0] == begin and edges[-1] == begin + length
    sizes = [hi - lo for lo, hi in zip(edges, edges[1:])]
    assert all(0 <= size <= chunk for size in sizes) and sum(sizes) == length
    assert sizes == sorted(sizes, reverse=True)
    for rank in range(n):  # csrc/flash_decode.cu:share_of
        lo = begin + min(rank * chunk, length)
        hi = begin + min((rank + 1) * chunk, length)
        assert (edges[rank], edges[rank + 1]) == (lo, hi)


def test_split_bounds_per_row():
    begin, end = torch.tensor([0, 3, 40, 9]), torch.tensor([868, 9, 40, 8])
    edges = split_bounds(begin, end, 8)
    for row in range(4):
        assert edges[row].tolist() == split_bounds(int(begin[row]), int(end[row]), 8).tolist()


@pytest.mark.parametrize("b,h_kv,s,rows,want", [
    (1, 16, 868, 1, 8), (2, 16, 868, 1, 8), (4, 16, 868, 1, 4), (8, 16, 868, 1, 2),
    (32, 16, 868, 1, 1), (2, 16, 20, 1, 1), (2, 16, 100, 1, 4), (2, 4, 868, 16, 8),
])
def test_split_count_fills_the_card_from_shapes_alone(b, h_kv, s, rows, want):
    """About two blocks per SM at decode sizes (mini-v1 B=2: 256 blocks in
    place of 32), never below 16 slots per share at the cache length."""
    n = split_count(b, h_kv, s, rows)
    assert n == want and n & (n - 1) == 0 and 1 <= n <= MAX_SPLITS


# ------------------------------------------------ the window kernel's route
@pytest.mark.parametrize("g,w,dtype,dh,want", [
    (1, 24, torch.bfloat16, 64, "window"),   # mini-v1's speculative window
    (1, 16, torch.bfloat16, 64, "window"),   # large-v1's and the demo's
    (4, 4, torch.bfloat16, 64, "window"),    # the GQA test shapes
    (2, 32, torch.bfloat16, 64, "window"),   # R = 64, the most the kernel holds
    (1, 24, torch.bfloat16, 16, "window"), (1, 24, torch.bfloat16, 128, "window"),
    (1, 1, torch.bfloat16, 64, "split"), (16, 1, torch.bfloat16, 64, "split"),  # W = 1
    (1, 8, torch.bfloat16, 64, "split"), (4, 2, torch.bfloat16, 64, "split"),   # R <= 8
    (1, 24, torch.float32, 64, "split"), (4, 4, torch.float32, 64, "split"),    # fp32 cache
    (2, 33, torch.bfloat16, 64, "split"),    # R = 66
    (1, 24, torch.bfloat16, 72, "split"), (1, 24, torch.bfloat16, 256, "split"),  # Dh
])
def test_k1_route_is_a_function_of_dtype_and_shapes(g, w, dtype, dh, want):
    """bf16, W > 1, 8 < G x W <= 64 and Dh a multiple of 16 up to 128 take
    the window kernel; everything else, every single-column decode and fp32
    cache among it, the split kernel."""
    assert k1_route(dtype, g, w, dh) == want
    h_kv, s = 4, 892
    n = kernel_split_count(dtype, 2, g * h_kv, h_kv, s, w, dh)
    assert n == (window_split_count(2, h_kv, s, g * w) if want == "window"
                 else split_count(2, h_kv, s, g * w))


def test_route_and_split_counts_take_no_limit():
    """What a launch takes is read from dtype and shapes alone, never from
    `starts` or `limit`: a launch captured into a CUDA graph stays valid as
    a device limit moves."""
    for fn in (k1_route, split_count, window_split_count, kernel_split_count):
        assert not {"limit", "limits", "starts"} & set(inspect.signature(fn).parameters)


@pytest.mark.parametrize("b,h_kv,s,rows,want", [
    (2, 16, 892, 24, 8), (1, 16, 892, 24, 8), (1, 24, 884, 16, 8), (8, 16, 892, 24, 2),
    (32, 16, 892, 24, 1), (2, 2, 288, 16, 4), (2, 4, 100, 16, 1), (2, 16, 160, 24, 2),
    (2, 16, 256, 24, 4), (2, 16, 511, 24, 4), (2, 16, 512, 24, 8),
])
def test_window_split_count_fills_the_card_from_shapes_alone(b, h_kv, s, rows, want):
    """One block a (row, kv head, share), about two blocks per SM (mini-v1
    W=24 B=2: 256 blocks), never below one 64-slot tile per share at S."""
    n = window_split_count(b, h_kv, s, rows)
    assert n == want and n & (n - 1) == 0 and 1 <= n <= MAX_SPLITS
    assert n == 1 or (b * h_kv * n <= 264 and s // n >= 64)


@pytest.mark.parametrize("kind,past", [("w24", 63), ("w24", 64), ("w24", 65), ("w16", 64),
                                       ("gqa", 63), ("gqa", 65)])
def test_plain_window_split_form_matches_pallas(kind, past):
    """The window kernel's form, `splits=window_split_count(...)`: row 0's
    shares hold `past` = 63 / 64 / 65 slots (one 64-slot tile less one, the
    tile, the tile and one), row 1 left-padded with a shorter limit."""
    h, h_kv, w = {"w24": (2, 2, 24), "w16": (3, 3, 16), "gqa": (8, 2, 4)}[kind]
    b, s = 2, 288  # the Pallas kernel's cache length: whole blocks of 96 slots
    q, k, v = make_case(seed=50 + past, b=b, h=h, h_kv=h_kv, w=w, s=s)
    n = window_split_count(b, h_kv, s, (h // h_kv) * w)
    assert n > 1 and n * past <= s
    limit0 = n * past - w + 1          # row 0's range [0, limit + W - 1) is n shares of `past`
    limits = np.array([limit0, limit0 - 37])
    want, got = both(q, k, v, np.array([0, 11]), limits, block_s=96, dtype="bf16", splits=n)
    edges = split_bounds(*slot_range(torch.tensor([0, 11]), torch.from_numpy(limits), w, s), n)
    assert (edges[0, 1:] - edges[0, :-1]).tolist() == [past] * n
    np.testing.assert_allclose(got, want, **BF16_TOL)


@pytest.mark.parametrize("drop", ["first", "last", "boundary"])
def test_a_dropped_slot_fails_the_fp32_tolerance(drop):
    """The fp32 tolerance the kernel is held to sees one cache slot left
    out: the first (start + 1), the last (limit - 1), or the last slot of a
    share (its end cut by one, the next share unchanged)."""
    q, k, v = (torch.from_numpy(x) for x in make_case(seed=46, b=2, s=868))
    starts, limit, n = torch.tensor([0, 3], dtype=torch.int32), 700, 8
    want = flash_decode_attention_plain(q, k, v, starts, limit, splits=n)
    if drop == "first":
        got = flash_decode_attention_plain(q, k, v, starts + 1, limit, splits=n)
    elif drop == "last":
        got = flash_decode_attention_plain(q, k, v, starts, limit - 1, splits=n)
    else:
        edges = split_bounds(*slot_range(starts, limit, 1, 868), n)
        lo, hi = edges[:, :-1], edges[:, 1:].clone()
        hi[:, 3] -= 1
        got = flash_decode_attention_shares(q, k, v, starts, limit, lo, hi)
    assert not torch.allclose(got, want, **F32_TOL)
