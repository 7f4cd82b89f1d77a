"""Port tests that need the card: the CUDA kernels K1 (flash-decode), K2
(int8 matmul), K3 (fused decode step) and K4 (training flash attention)
against their plain versions, the pipeline on the GPU in its eager, int8 and
fused modes, checkpoints loaded onto the GPU (the default device, a BF16
shard bit for bit), the fused_qkv and weight_quant="xla" modes on CUDA
tensors, the launch counts of a remat'd train step, what remat_policy="dots"
keeps on the card, and speculative
decoding (K1 at the W=24 window, K2 at M = 24 and 48, a greedy fp32 run
equal to the AR run but at near-ties within 2e-4), K1 at a tensor-parallel
rank's heads, K4 at a seq=2 rank's rows (q_offset > 0, Tq < Tk), K2 at a
TP=2 rank's slices, and by two gloo ranks sharing the card: fp32 greedy
generation at TP=2 (float, int8 and fused q|k|v weights) and seq=2 train
steps, and the four init scripts writing a tiny model from the card.
Marked `cuda`; without a GPU each test
skips (a CUDA kernel has no CPU mode). This file imports no JAX, since the
machine with the card has none. Run there with

    python -m pytest tests/test_torch_cuda.py -m cuda -q --noconftest

(`--noconftest`: the suite's conftest.py sets up JAX, which that machine lacks.)

Tolerances: fp32 atol 2e-5 / rtol 1e-4 (the Pallas tests' own); bf16
atol 2e-3 / rtol 1e-2 (both sides round P to bf16, at different points of the
online softmax; an H100 80GB HBM3 at 700 W reads at most one bf16 step, 9.8e-4
on outputs up to 0.25, and a kernel that drops or repeats one 64-slot tile moves them by
~4e-3). K1 is held against its plain version at the kernel's own split count
(`split_count`), a second call must give the same bits, and a result that
leaves out one slot must fail the fp32 tolerance.
K2: `k2_close` (ops/quant_matmul.py): within 1e-6 x max|y| + 1e-5 x |y|
(fp32 summation-order noise over K <= 4096 terms), bf16 also within one bf16
ulp; a result without one K slice of the cluster must fail it. K3:
`fused_close` (ops/fused_decode_step.py) over `fused_gaps`, slice by slice
(each layer's new k and v rows, then the hidden state), within the limits
`fused_limits` sets from the noise between its plain version summing
in fp32 and in float64 over the cases held: in every case 4 x the largest
noise, and for the median over the cases at layer 1 4 x the median noise,
both at least 4 x one bf16 step in 1 of 64 entries; also at the chunk edges,
n_rows = start + 1, the self-attention items' ownership edge and S_enc 33,
200 launches bit for bit, bounds as device tensors bit for bit, and the two
stripped timing variants leaving the counters as they found them. K4: o, dq, dk and dv,
norm-relative, each within `k4_limits` (ops/flash_attention.py): 4 x the gap
between the plain version summing in fp32 and in float64 on the same
inputs, at least 1e-6 (fp32) or 1e-4 (bf16); a kernel that drops one key
tile must fail them. K4's launch counters show the route: bf16 at head dim
64 on the tensor-core kernels, fp32 and other head dims on the SIMT ones.
"""

import copy
import dataclasses
import importlib

import pytest
import torch

from parler_tts_tpu_torch.config import (
    DACConfig,
    DecoderConfig,
    GenerationConfig,
    ParlerTTSConfig,
    T5Config,
)
from parler_tts_tpu_torch.config import mini_v1_decoder_config
from parler_tts_tpu_torch.models.decoder import ParlerDecoder
from parler_tts_tpu_torch.models.layers import init_weights
from parler_tts_tpu_torch.ops.flash_attention import (
    attention_and_grads,
    flash_attention,
    flash_attention_plain,
    k4_gaps,
    k4_limits,
)
from parler_tts_tpu_torch.ops.flash_decode import (
    flash_decode_attention,
    flash_decode_attention_plain,
    flash_decode_attention_shares,
    slot_range,
    split_bounds,
    split_count,
)
from parler_tts_tpu_torch.ops.fused_decode_step import (
    CUDA_CHUNK,
    fused_close,
    fused_decode_layers,
    fused_decode_layers_plain,
    fused_decode_variant,
    fused_gaps,
    fused_limits,
    launch_plan,
    prepare_fused_params,
)
from parler_tts_tpu_torch.ops.quant_matmul import (
    k2_close,
    k2_grid,
    quant_matmul,
    quant_matmul_plain,
)
from parler_tts_tpu_torch.runtime.pipeline import ParlerTTSPipeline

pytestmark = pytest.mark.cuda

TOL = {torch.float32: dict(atol=2e-5, rtol=1e-4), torch.bfloat16: dict(atol=2e-3, rtol=1e-2)}
K3_CASES = [(0, 1), (3, 65), (0, 434), (3, 867)]  # (start, n_rows)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def case(device, dtype, b=2, h=16, h_kv=16, dh=64, s=868, w=None, layers=None, seed=0):
    g = torch.Generator(device=device).manual_seed(seed)
    qshape = (b, h, dh) if w is None else (b, w, h, dh)
    q = torch.randn(qshape, generator=g, device=device) * 0.3
    kshape = (b, s, h_kv, dh) if layers is None else (layers, b, s, h_kv * dh)
    k = torch.randn(kshape, generator=g, device=device) * 0.3
    v = torch.randn(kshape, generator=g, device=device) * 0.3
    return q.to(dtype), k.to(dtype), v.to(dtype)


def splits_of(q, k, layer=None):
    """The kernel's split count for these operands (`split_count`)."""
    b, h, dh = q.shape[0], q.shape[-2], q.shape[-1]
    w = q.shape[1] if q.dim() == 4 else 1
    kl = k if layer is None else k[layer]
    s, h_kv = kl.shape[1], kl[0, 0].numel() // dh
    return split_count(b, h_kv, s, (h // h_kv) * w)


def check(q, k, v, starts, limit, layer=None):
    """The kernel against its plain version at the kernel's split count, and
    a second call bit for bit the same."""
    before = flash_decode_attention.launches
    got = flash_decode_attention(q, k, v, starts, limit, layer=layer)
    torch.cuda.synchronize()
    assert flash_decode_attention.launches == before + 1
    want = flash_decode_attention_plain(q, k, v, starts, limit, layer=layer,
                                        splits=splits_of(q, k, layer))
    assert got.dtype == q.dtype and got.shape == q.shape
    torch.testing.assert_close(got.float(), want.float(), **TOL[q.dtype])
    assert torch.equal(flash_decode_attention(q, k, v, starts, limit, layer=layer), got)
    return got


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b", [1, 2, 4])
@pytest.mark.parametrize("limit", [1, 63, 64, 65, 868])
def test_kernel_matches_plain_prefix(cuda, dtype, b, limit):
    q, k, v = case(cuda, dtype, b=b)
    check(q, k, v, torch.zeros(b, dtype=torch.int32, device=cuda), limit)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_per_row_starts_and_limits(cuda, dtype):
    q, k, v = case(cuda, dtype, b=4, seed=1)
    starts = torch.tensor([0, 3, 70, 200], dtype=torch.int32, device=cuda)
    limits = torch.tensor([868, 64, 500, 201], dtype=torch.int32, device=cuda)
    check(q, k, v, starts, limits)


@pytest.mark.parametrize("h_kv", [4, 1])
@pytest.mark.parametrize("w", [None, 4])
def test_kernel_gqa_mqa_and_windows(cuda, h_kv, w):
    q, k, v = case(cuda, torch.float32, b=2, h_kv=h_kv, w=w, seed=2)
    check(q, k, v, torch.tensor([0, 17], dtype=torch.int32, device=cuda), 300)


@pytest.mark.parametrize("layer", [0, 23])
def test_kernel_reads_the_stacked_cache_in_place(cuda, layer):
    q, k, v = case(cuda, torch.bfloat16, b=2, layers=24, seed=3)
    starts = torch.tensor([0, 5], dtype=torch.int32, device=cuda)
    got = check(q, k, v, starts, 700, layer=layer)
    sliced = flash_decode_attention(q, k[layer].reshape(2, 868, 16, 64).contiguous(),
                                    v[layer].reshape(2, 868, 16, 64).contiguous(), starts, 700)
    torch.testing.assert_close(got, sliced, rtol=0, atol=0)


def test_kernel_at_the_main_path_shape(cuda):
    """B=2, bf16, the stacked 24-layer cache at its last layer and full
    length, a left-padded second row: what the mini-v1 decode loop runs."""
    q, k, v = case(cuda, torch.bfloat16, b=2, layers=24, seed=5)
    check(q, k, v, torch.tensor([0, 3], dtype=torch.int32, device=cuda), 868, layer=23)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,layers", [(8, 24), (12, 30)])
def test_kernel_at_a_tensor_parallel_rank_shape(cuda, dtype, h, layers):
    """A TP=2 rank's heads: mini-v1's 8 of 16 and large-v1's 12 of 24, B=2
    over the stacked cache at its last layer, a left-padded second row."""
    q, k, v = case(cuda, dtype, b=2, h=h, h_kv=h, layers=layers, seed=8)
    check(q, k, v, torch.tensor([0, 3], dtype=torch.int32, device=cuda), 868,
          layer=layers - 1)


def test_kernel_empty_range_gives_zero(cuda):
    q, k, v = case(cuda, torch.float32, b=2, seed=4)
    starts = torch.tensor([100, 0], dtype=torch.int32, device=cuda)
    got = check(q, k, v, starts, torch.tensor([100, 0], dtype=torch.int32, device=cuda))
    assert torch.count_nonzero(got) == 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b", [1, 2, 4])
@pytest.mark.parametrize("edge", [64, 128])
def test_kernel_share_boundary_on_slot(cuda, dtype, b, edge):
    """A limit that puts share boundaries on slots edge - 1 / edge."""
    q, k, v = case(cuda, dtype, b=b, seed=6)
    n = splits_of(q, k)
    check(q, k, v, torch.zeros(b, dtype=torch.int32, device=cuda), min(edge * n, 868))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_per_row_limits_leave_shares_empty(cuda, dtype):
    """Row 1 has no slot, row 2 one slot (seven of eight shares empty), row 3
    a limit below its start."""
    q, k, v = case(cuda, dtype, b=4, seed=7)
    starts = torch.tensor([0, 3, 8, 5], dtype=torch.int32, device=cuda)
    limits = torch.tensor([868, 3, 9, 1], dtype=torch.int32, device=cuda)
    got = check(q, k, v, starts, limits)
    assert torch.count_nonzero(got[1]) == 0 and torch.count_nonzero(got[3]) == 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b", [1, 2])
def test_kernel_starts_3_and_5_limit_9(cuda, dtype, b):
    q, k, v = case(cuda, dtype, b=b, seed=8)
    check(q, k, v, torch.tensor([3, 5][:b], dtype=torch.int32, device=cuda), 9)


@pytest.mark.parametrize("drop", ["first", "last", "boundary"])
def test_a_dropped_slot_fails_the_fp32_tolerance(cuda, drop):
    """The kernel passes `TOL[float32]` and a result that leaves out one slot
    fails it: the first (start + 1), the last (limit - 1), or the last slot
    of share 3 (the plain split form with that share's end cut by one)."""
    q, k, v = case(cuda, torch.float32, b=2, layers=24, seed=9)
    starts, limit, layer = torch.tensor([0, 3], dtype=torch.int32, device=cuda), 700, 23
    n = splits_of(q, k, layer)
    got = check(q, k, v, starts, limit, layer=layer)
    if drop == "first":
        dropped = flash_decode_attention_plain(q, k, v, starts + 1, limit, layer=layer,
                                               splits=n)
    elif drop == "last":
        dropped = flash_decode_attention_plain(q, k, v, starts, limit - 1, layer=layer,
                                               splits=n)
    else:
        edges = split_bounds(*slot_range(starts, limit, 1, 868), n)
        hi = edges[:, 1:].clone()
        hi[:, 3] -= 1
        dropped = flash_decode_attention_shares(q, k, v, starts, limit, edges[:, :-1], hi,
                                                layer=layer)
    assert not torch.allclose(got, dropped, **TOL[torch.float32])


def tiny_config(hidden=64):
    pad, bos = 88, 89
    return ParlerTTSConfig(
        text_encoder=T5Config(vocab_size=120, d_model=48, d_kv=12, d_ff=96, num_layers=2,
                              num_heads=4, relative_attention_num_buckets=8,
                              relative_attention_max_distance=20, dropout_rate=0.0),
        audio_encoder=DACConfig(num_codebooks=4, codebook_size=pad, codebook_dim=4,
                                latent_dim=64, encoder_dim=4, encoder_rates=(2, 4, 4),
                                decoder_dim=96, decoder_rates=(4, 4, 2),
                                sampling_rate=16000, frame_rate=500),
        decoder=DecoderConfig(vocab_size=100, hidden_size=hidden, num_hidden_layers=2,
                              num_attention_heads=4, ffn_dim=2 * hidden, num_codebooks=4,
                              max_position_embeddings=128, pad_token_id=pad,
                              bos_token_id=bos, eos_token_id=pad, dropout=0.0),
        vocab_size=256, pad_token_id=pad, decoder_start_token_id=bos,
    )


TINY_GEN = GenerationConfig(max_length=40, min_new_tokens=40, do_sample=False,
                            bos_token_id=89, pad_token_id=88, eos_token_id=88,
                            codebook_guard=88)


def tiny_request(b=2):
    g = torch.Generator().manual_seed(0)
    desc = torch.randint(0, 120, (b, 9), generator=g)
    prompt = torch.randint(0, 256, (b, 5), generator=g)
    prompt_mask = torch.ones(b, 5, dtype=torch.int64)
    prompt_mask[0, :2] = 0
    return desc, None, prompt, prompt_mask


def test_pipeline_on_the_gpu_launches_the_kernel_every_decode_step(cuda):
    cfg, gen = tiny_config(), TINY_GEN
    pipe = ParlerTTSPipeline.from_random(cfg, seed=0, generation_config=gen, frame_bucket=8)
    assert pipe.device.type == "cuda"
    desc, _, prompt, prompt_mask = tiny_request()
    before = flash_decode_attention.launches
    out = pipe.generate_codes(desc, None, prompt, prompt_mask)
    decode_steps = out.steps - 2  # prefill samples column 1; the loop the rest
    assert out.steps == gen.max_length
    assert flash_decode_attention.launches - before == 2 * decode_steps
    audio, lengths = pipe.decode_codes(out.codes, out.lengths)
    assert torch.isfinite(torch.from_numpy(audio)).all()
    assert (lengths == (gen.max_length - 4) * cfg.audio_encoder.hop_length).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b", [1, 2])
def test_kernel_at_the_speculative_window(cuda, dtype, b):
    """K1 at mini-v1's speculative window: W=24 columns at H=16, G=1 (three
    row tiles per kv head), over the stacked cache of s_p + L + W slots,
    with (B,) limits that differ and row 1 left-padded; a result whose last
    column lacks its last slot fails the fp32 tolerance."""
    q, k, v = case(cuda, dtype, b=b, w=24, layers=24, s=892, seed=b)
    starts = torch.tensor([0, 3][:b], dtype=torch.int32, device=cuda)
    limits = torch.tensor([531, 434][:b], dtype=torch.int32, device=cuda)
    got = check(q, k, v, starts, limits, layer=23)
    if dtype == torch.float32:
        wrong = got.clone()
        wrong[:, -1] = flash_decode_attention_plain(
            q[:, -1:].contiguous(), k, v, starts, limits + 22, layer=23,
            splits=splits_of(q[:, :1], k, 23))[:, 0]
        assert not torch.allclose(got, wrong, **TOL[dtype])


# ------------------------------------------------------------------ K2
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k,n", [(1024, 1024), (1024, 4096), (4096, 1024), (1024, 1040),
                                 # a TP=2 rank's slices: q/k/v, out_proj, fc1, fc2
                                 (1024, 512), (512, 1024), (1024, 2048), (2048, 1024)])
@pytest.mark.parametrize("m", [1, 2, 18, 24, 32, 48])
def test_quant_matmul_matches_plain(cuda, m, k, n, dtype):
    g = torch.Generator(device=cuda).manual_seed(m + k + n)
    x = (torch.randn(m, k, generator=g, device=cuda) * 0.3).to(dtype)
    w = torch.randint(-127, 128, (k, n), generator=g, device=cuda,
                      dtype=torch.int32).to(torch.int8)
    s = torch.rand(n, generator=g, device=cuda) * 0.009 + 1e-3
    before = quant_matmul.launches
    got = quant_matmul(x, w, s)
    torch.cuda.synchronize()
    assert quant_matmul.launches == before + 1
    want = quant_matmul_plain(x, w, s)
    assert got.dtype == dtype and got.shape == (m, n)
    assert k2_close(got, want)
    # deterministic: split-K partials are summed in a fixed order
    assert torch.equal(quant_matmul(x, w, s), got)
    # a result that left out one K slice of the cluster fails the check
    slices, slice_ = k2_grid(m, k, n)
    dropped = x.clone()
    dropped[:, (slices - 1) * slice_:] = 0
    assert not k2_close(quant_matmul_plain(dropped, w, s), want)


# ------------------------------------------------------------------ K3
@pytest.fixture(scope="module")
def mini_v1_fused():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    dev = torch.device("cuda")
    cfg = mini_v1_decoder_config()
    g = torch.Generator(device=dev).manual_seed(0)
    decoder = ParlerDecoder(cfg, device=dev, dtype=torch.bfloat16)
    init_weights(decoder, g)
    n_layers, d, s_enc = cfg.num_hidden_layers, cfg.hidden_size, 16

    def bf16(*shape):
        return (torch.randn(shape, generator=g, device=dev) * 0.5).to(torch.bfloat16)

    bias = torch.zeros(1, s_enc, device=dev)
    bias[0, 12:] = torch.finfo(torch.float32).min
    tensors = (bf16(1, d), bf16(n_layers, 868, d), bf16(n_layers, 868, d),
               bf16(n_layers, s_enc, d), bf16(n_layers, s_enc, d), bias)
    fp = prepare_fused_params(decoder)
    want, limits = plain_wants(cfg, fp, tensors, K3_CASES)
    return cfg, fp, tensors, want, limits


def plain_wants(cfg, fp, tensors, cases):
    """The plain version at the kernel's tiling over `cases`, and the limits
    `fused_limits` sets from its fp32-vs-float64 noise over them."""
    def plain(start, n_rows, **kw):
        return fused_decode_layers_plain(cfg, fp, *tensors, start, n_rows,
                                         block_s=CUDA_CHUNK, tiling="cuda", **kw)

    want = {case: plain(*case) for case in cases}
    noise = torch.stack([fused_gaps(plain(*case, dtype=torch.float64), want[case])
                         for case in cases])
    return want, fused_limits(noise)


@pytest.mark.parametrize("start,n_rows", K3_CASES)
def test_fused_decode_matches_plain_at_mini_v1(cuda, mini_v1_fused, start, n_rows):
    cfg, fp, tensors, wants, limits = mini_v1_fused
    want = wants[(start, n_rows)]
    before = fused_decode_layers.launches
    got = fused_decode_layers(cfg, fp, *tensors, start, n_rows)
    torch.cuda.synchronize()
    assert fused_decode_layers.launches == before + 1
    assert [g.shape for g in got] == [w.shape for w in want]
    per_case, _ = limits
    assert (fused_gaps(got, want) <= per_case).all()
    # a kernel that dropped a layer's fc2 fails the limit of every case
    no_fc2 = dataclasses.replace(fp, sfc2=fp.sfc2.clone())
    no_fc2.sfc2[12] = 0.0
    broken = fused_decode_layers(cfg, no_fc2, *tensors, start, n_rows)
    assert (fused_gaps(broken, want) > per_case).any()


def test_fused_decode_median_gap_at_mini_v1(cuda, mini_v1_fused):
    cfg, fp, tensors, wants, limits = mini_v1_fused
    gaps = torch.stack([fused_gaps(fused_decode_layers(cfg, fp, *tensors, *case), wants[case])
                        for case in K3_CASES])
    assert fused_close(gaps, limits)
    # a kernel that dropped the first or the last cache row fails them
    long = [(start, n_rows) for start, n_rows in K3_CASES if n_rows > start + 1]
    for shift in ((1, 0), (0, -1)):
        broken = torch.stack([
            fused_gaps(fused_decode_layers(cfg, fp, *tensors, start + shift[0],
                                           n_rows + shift[1]), wants[(start, n_rows)])
            for start, n_rows in long])
        assert not fused_close(broken, limits), shift


# chunk edges (32 and 33 rows from start), n_rows = start + 1, and the
# self-attention items' ownership edge (16 heads x 8 chunks fill fewer than
# 132 blocks' first warps, 16 x 9 wrap onto second warps)
K3_EDGES = [(0, 32), (0, 33), (3, 35), (3, 36), (3, 4), (0, 256), (0, 257)]


def test_fused_decode_at_the_edges(cuda, mini_v1_fused):
    cfg, fp, tensors, _, _ = mini_v1_fused
    assert launch_plan(cfg)["chunk"] == CUDA_CHUNK
    # one set of limits from the noise over the main cases and the edges
    want, limits = plain_wants(cfg, fp, tensors, K3_CASES + K3_EDGES)
    gaps = torch.stack([fused_gaps(fused_decode_layers(cfg, fp, *tensors, *case), want[case])
                        for case in K3_CASES + K3_EDGES])
    assert fused_close(gaps, limits)


def test_fused_decode_with_33_encoder_rows(cuda, mini_v1_fused):
    cfg, fp, tensors, _, _ = mini_v1_fused
    g = torch.Generator(device=tensors[0].device).manual_seed(7)
    n_layers, d = cfg.num_hidden_layers, cfg.hidden_size
    cross = [(torch.randn(n_layers, 33, d, generator=g, device=g.device) * 0.5).to(torch.bfloat16)
             for _ in range(2)]
    bias = torch.zeros(1, 33, device=g.device)
    bias[0, 28:] = torch.finfo(torch.float32).min
    tensors33 = (tensors[0], tensors[1], tensors[2], *cross, bias)
    want, limits = plain_wants(cfg, fp, tensors33, K3_CASES)
    gaps = torch.stack([fused_gaps(fused_decode_layers(cfg, fp, *tensors33, *case), want[case])
                        for case in K3_CASES])
    assert fused_close(gaps, limits)


def test_fused_decode_repeats_bit_for_bit(cuda, mini_v1_fused):
    cfg, fp, tensors, _, _ = mini_v1_fused
    first = fused_decode_layers(cfg, fp, *tensors, 3, 867)
    for _ in range(199):
        out = fused_decode_layers(cfg, fp, *tensors, 3, 867)
        assert all(torch.equal(a, b) for a, b in zip(out, first))


@pytest.mark.parametrize("start,n_rows", K3_CASES + [(3, 4)])
def test_fused_decode_device_bounds_give_the_bits_of_int_bounds(cuda, mini_v1_fused, start,
                                                                n_rows):
    cfg, fp, tensors, _, _ = mini_v1_fused
    i32 = lambda v: torch.tensor(v, dtype=torch.int32, device=cuda)  # noqa: E731
    want = fused_decode_layers(cfg, fp, *tensors, start, n_rows)
    got = fused_decode_layers(cfg, fp, *tensors, i32(start), i32(n_rows))
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_fused_decode_variants_leave_the_counters_as_they_found_them(cuda, mini_v1_fused):
    cfg, fp, tensors, _, _ = mini_v1_fused
    want = fused_decode_layers(cfg, fp, *tensors, 3, 434)
    before = fused_decode_layers.launches
    for variant in ("stream", "chain", "stream", "chain"):
        fused_decode_variant(variant, cfg, fp, *tensors, 3, 434)
    torch.cuda.synchronize()
    assert fused_decode_layers.launches == before  # timing variants are not K3 launches
    got = fused_decode_layers(cfg, fp, *tensors, 3, 434)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    with pytest.raises(ValueError, match="variant"):
        fused_decode_variant("weights", cfg, fp, *tensors, 3, 434)


# ------------------------------------------------------- int8 and fused
def test_int8_pipeline_launch_counts(cuda):
    cfg = tiny_config()
    pipe = ParlerTTSPipeline.from_random(cfg, seed=0, generation_config=TINY_GEN,
                                         frame_bucket=8, weight_quant=True)
    k1, k2 = flash_decode_attention.launches, quant_matmul.launches
    out = pipe.generate_codes(*tiny_request())
    decode_steps = out.steps - 2
    assert out.steps == TINY_GEN.max_length
    # 8 projections a layer in the prefill and each decode step, 2 for cross k/v
    assert quant_matmul.launches - k2 == 2 * 8 * (decode_steps + 1) + 2 * 2
    assert flash_decode_attention.launches - k1 == 2 * decode_steps


def test_fused_pipeline_launch_counts(cuda):
    cfg = tiny_config(hidden=256)  # head_dim 64, as K3 needs
    pipe = ParlerTTSPipeline.from_random(cfg, seed=0, generation_config=TINY_GEN,
                                         frame_bucket=8, dtype=torch.bfloat16,
                                         fused_decode=True)
    before = fused_decode_layers.launches
    out = pipe.generate_codes(*(None if x is None else x[1:] for x in tiny_request()))
    assert out.steps == TINY_GEN.max_length
    assert fused_decode_layers.launches - before == out.steps - 2
    before = fused_decode_layers.launches
    pipe.generate_codes(*tiny_request())  # B=2 takes the eager loop
    assert fused_decode_layers.launches == before


# ------------------------------------------------------------------ K4
# (b, tq, tk, h, h_kv, causal, q_offset, left-padded keys of row 1, dh)
K4_CASES = {
    "mini_v1": (2, 1040, 1040, 16, 16, True, 0, 5, 64),
    "gqa": (2, 256, 256, 8, 2, True, 0, 0, 64),
    "offset": (2, 128, 384, 4, 4, True, 256, 0, 64),
    "unaligned": (2, 200, 200, 4, 4, True, 0, 3, 64),
    "noncausal": (2, 192, 256, 4, 4, False, 0, 0, 64),
    "tq_lt_tk_no_valid_key": (2, 136, 264, 4, 4, True, 128, 140, 64),
    "tq_gt_tk": (2, 264, 200, 4, 4, True, 0, 7, 64),
    "tq_gt_tk_noncausal": (2, 264, 200, 4, 4, False, 0, 7, 64),
    "dh32": (2, 200, 200, 4, 4, True, 0, 3, 32),
    # a seq=2 rank's rows of mini-v1's training sequence against the gathered keys
    "seq_rank0": (2, 528, 1040, 16, 16, True, 0, 5, 64),
    "seq_rank1": (2, 512, 1040, 16, 16, True, 528, 5, 64),
}


def k4_inputs(device, dtype, b, tq, tk, h, h_kv, pad, dh=64, seed=0):
    g = torch.Generator(device=device).manual_seed(seed)
    q = (torch.randn(b, tq, h, dh, generator=g, device=device) * dh ** -0.5).to(dtype)
    k, v = (torch.randn(b, tk, h_kv, dh, generator=g, device=device).to(dtype)
            for _ in range(2))
    do = torch.randn(b, tq, h, dh, generator=g, device=device).to(dtype)
    mask = torch.ones(b, tk, dtype=torch.bool, device=device)
    mask[1, :pad] = False
    return q, k, v, mask, do


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", list(K4_CASES))
def test_flash_attention_matches_plain(cuda, name, dtype):
    """bf16 at Dh 64 runs the tensor-core kernels, everything else the SIMT ones."""
    b, tq, tk, h, h_kv, causal, q_offset, pad, dh = K4_CASES[name]
    q, k, v, mask, do = k4_inputs(cuda, dtype, b, tq, tk, h, h_kv, pad, dh=dh)
    kw = dict(causal=causal, q_offset=q_offset)
    before = dict(flash_attention.launches)
    before_wgmma = dict(flash_attention.launches_wgmma)
    got = attention_and_grads(flash_attention, q, k, v, mask, do, **kw)
    torch.cuda.synchronize()
    assert {n: flash_attention.launches[n] - before[n] for n in before} == {"fwd": 1, "dq": 1, "dkv": 1}
    on_wgmma = int(dtype == torch.bfloat16 and dh == 64)
    assert ({n: flash_attention.launches_wgmma[n] - before_wgmma[n] for n in before_wgmma}
            == {"fwd": on_wgmma, "dq": on_wgmma, "dkv": on_wgmma})
    want = attention_and_grads(flash_attention_plain, q, k, v, mask, do, **kw)
    f64 = attention_and_grads(flash_attention_plain, q, k, v, mask, do,
                              acc_dtype=torch.float64, **kw)
    gaps, limits = k4_gaps(got, want), k4_limits(k4_gaps(want, f64), dtype)
    assert all(g <= lim for g, lim in zip(gaps, limits)), (gaps, limits)
    if pad:  # row 1: masked keys get no gradient; causal rows before `pad` see no valid key
        dead = max(0, min(tq, pad - q_offset)) if causal else 0
        assert not got[0][1, :dead].any() and not got[1][1, :dead].any()
        assert not got[2][1, :pad].any() and not got[3][1, :pad].any()


def test_flash_attention_dropped_key_tile_fails_the_limits(cuda):
    b, tq, tk, h, h_kv, causal, q_offset, pad, _ = K4_CASES["mini_v1"]
    q, k, v, mask, do = k4_inputs(cuda, torch.bfloat16, b, tq, tk, h, h_kv, pad)
    want = attention_and_grads(flash_attention_plain, q, k, v, mask, do)
    f64 = attention_and_grads(flash_attention_plain, q, k, v, mask, do, acc_dtype=torch.float64)
    limits = k4_limits(k4_gaps(want, f64), torch.bfloat16)
    dropped = mask.clone()
    dropped[0, 512:576] = False  # what a kernel that skips key tile 8 of row 0 computes
    before = flash_attention.launches_wgmma["fwd"]
    got = attention_and_grads(flash_attention, q, k, v, dropped, do)
    assert flash_attention.launches_wgmma["fwd"] == before + 1  # the tensor-core kernels
    assert any(g > 10 * lim for g, lim in zip(k4_gaps(got, want), limits))


@pytest.mark.parametrize("hidden", [64, 256])
def test_train_step_launch_counts(cuda, hidden):
    """One remat'd bf16 step of a tiny model over K4: 2 x L forward launches
    (the forward and its recompute in the backward), L dq and L dkv; with 4
    heads, hidden 64 (Dh 16) runs the SIMT kernels and hidden 256 (Dh 64) the
    tensor-core ones."""
    from parler_tts_tpu_torch.models.parler import ParlerTTS
    from parler_tts_tpu_torch.training import Batch, TrainState, make_optimizer, make_train_step

    cfg = tiny_config(hidden)
    model = ParlerTTS(cfg, device=cuda, dtype=torch.bfloat16, param_dtype=torch.float32,
                      use_chunked_attention="pallas", remat_layers=True)
    init_weights(model, torch.Generator(device=cuda).manual_seed(0))
    tx = make_optimizer(warmup_steps=1)
    state = TrainState.create(model, tx)
    step = make_train_step(model, tx)
    g = torch.Generator().manual_seed(1)
    labels = torch.randint(0, 88, (2, 30, 4), generator=g)
    labels[1, -5:] = -100
    prompt_mask = torch.ones(2, 5, dtype=torch.int64)
    prompt_mask[1, :2] = 0
    batch = Batch(torch.randint(0, 120, (2, 9), generator=g), torch.ones(2, 9, dtype=torch.int64),
                  torch.randint(0, 256, (2, 5), generator=g), prompt_mask, labels)
    batch = Batch(*(x.to(cuda) for x in batch))
    n = cfg.decoder.num_hidden_layers
    for i in range(2):
        for key in flash_attention.launches:
            flash_attention.launches[key] = flash_attention.launches_wgmma[key] = 0
        state, metrics = step(state, batch, i)
        torch.cuda.synchronize()
        want = {"fwd": 2 * n, "dq": n, "dkv": n}
        assert flash_attention.launches == want
        assert flash_attention.launches_wgmma == (want if hidden == 256 else dict.fromkeys(want, 0))
        assert torch.isfinite(metrics["loss"]) and torch.isfinite(metrics["grad_norm"])


def test_remat_dots_keeps_the_matrix_products_on_the_gpu(cuda):
    """What `remat_policy="dots"` sees on the card, in bf16 over K4
    (`tests/test_torch_training.py` holds the same counts on the CPU): a
    forward and backward under full remat runs 7 non-batched products
    (`aten.mm`) a layer more than under "dots", which keeps them; the
    batched products and K4's forward are recomputed under both."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from parler_tts_tpu_torch.models.parler import ParlerTTS

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = {}

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.ops[func] = self.ops.get(func, 0) + 1
            return func(*args, **(kwargs or {}))

    cfg = tiny_config(256)
    g = torch.Generator().manual_seed(1)
    inputs = (torch.randint(0, 120, (2, 9), generator=g), torch.ones(2, 9, dtype=torch.int64),
              torch.randint(0, 256, (2, 5), generator=g), torch.ones(2, 5, dtype=torch.int64),
              torch.randint(0, 88, (2, 30, 4), generator=g))
    counts, k4 = {}, {}
    for policy in (None, "dots"):
        model = ParlerTTS(cfg, device=cuda, dtype=torch.bfloat16, param_dtype=torch.float32,
                          use_chunked_attention="pallas", remat_layers=True,
                          remat_policy=policy)
        init_weights(model, torch.Generator(device=cuda).manual_seed(0))
        model.requires_grad_(True)
        for key in flash_attention.launches:
            flash_attention.launches[key] = 0
        with Count() as mode:
            logits, _ = model(*(x.to(cuda) for x in inputs))
            logits.float().sum().backward()
        torch.cuda.synchronize()
        counts[policy], k4[policy] = mode.ops, dict(flash_attention.launches)
    layers = cfg.decoder.num_hidden_layers
    mm, bmm = torch.ops.aten.mm.default, torch.ops.aten.bmm.default
    assert counts[None][mm] - counts["dots"][mm] == 7 * layers, (counts[None][mm],
                                                                counts["dots"][mm])
    assert counts[None].get(bmm, 0) == counts["dots"].get(bmm, 0)
    assert k4[None] == k4["dots"] == {"fwd": 2 * layers, "dq": layers, "dkv": layers}


# ------------------------------------------------------------ checkpoints
def test_from_pretrained_defaults_to_the_gpu(cuda, tmp_path):
    cfg = tiny_config()
    src = ParlerTTSPipeline.from_random(cfg, seed=2, generation_config=TINY_GEN,
                                        dtype=torch.bfloat16)
    src.save_pretrained(str(tmp_path))
    pipe = ParlerTTSPipeline.from_pretrained(str(tmp_path), dtype=torch.bfloat16)
    assert pipe.device.type == "cuda" and pipe.generation_config == TINY_GEN
    for (name, got), (_, want) in zip(pipe.model.named_parameters(),
                                      src.model.named_parameters()):
        assert got.is_cuda and torch.equal(got, want), name
    request = tiny_request()
    assert torch.equal(pipe.generate_codes(*request).delayed_ids,
                       src.generate_codes(*request).delayed_ids)


@pytest.mark.parametrize("script", ["init_dummy_model", "init_dummy_model_with_encodec",
                                    "init_model_600M", "init_large_model"])
def test_init_scripts_write_on_the_gpu(cuda, script, tmp_path, monkeypatch):
    """Each init script's `main` with `--device cuda`, its `configs` cut to
    the tiny config: the weights drawn on the card from the seed, written,
    and loaded back equal, with the generation config written beside."""
    module = importlib.import_module(f"parler_tts_tpu_torch.scripts.{script}")
    cfg, gen = tiny_config(), None if module.configs()[1] is None else TINY_GEN
    monkeypatch.setattr(module, "configs", lambda: (cfg, gen))
    pipe = module.main([str(tmp_path), "--seed", "3", "--device", "cuda"])
    assert pipe.device.type == "cuda"
    loaded = ParlerTTSPipeline.from_pretrained(str(tmp_path))
    again = ParlerTTSPipeline.from_random(cfg, seed=3, generation_config=gen)
    assert loaded.config == cfg and loaded.generation_config == pipe.generation_config
    for got, want in ((loaded.model, again.model), (loaded.dac, again.dac)):
        params = dict(want.named_parameters())
        for name, p in got.named_parameters():
            assert p.is_cuda and torch.equal(p, params[name]), name


def test_a_bf16_shard_loads_bit_exact_onto_the_gpu(cuda, tmp_path):
    from chip_smoke import write_safetensors
    from parler_tts_tpu_torch.runtime.checkpoint import load_safetensors_dir

    g = torch.Generator(device=cuda).manual_seed(3)
    want = {"w": torch.randn(64, 96, generator=g, device=cuda).to(torch.bfloat16),
            "v": torch.randn(7, generator=g, device=cuda).to(torch.bfloat16)}
    write_safetensors(str(tmp_path / "a.safetensors"), want)
    got = load_safetensors_dir(str(tmp_path))
    for name, w in want.items():
        on_card = got[name].to(cuda)
        assert on_card.dtype == torch.bfloat16
        assert torch.equal(on_card.view(torch.int16), w.view(torch.int16)), name


def test_weight_quant_xla_and_fused_qkv_run_on_the_gpu(cuda):
    cfg, request = tiny_config(), tiny_request()
    float_pipe = ParlerTTSPipeline.from_random(cfg, seed=4, generation_config=TINY_GEN)
    fused = ParlerTTSPipeline(float_pipe.model, float_pipe.dac, TINY_GEN, fused_qkv=True)
    assert fused.model.decoder.decoder.layers[0].self_attn.qkv_proj.kernel.is_cuda
    before = flash_decode_attention.launches
    out = fused.generate_codes(*request)
    assert out.steps == TINY_GEN.max_length
    assert flash_decode_attention.launches - before == 2 * (out.steps - 2)
    xla = ParlerTTSPipeline.from_random(cfg, seed=4, generation_config=TINY_GEN,
                                        weight_quant="xla")
    fc1 = xla.model.decoder.decoder.layers[0].fc1
    assert fc1.xla and fc1.w_q.is_cuda and fc1.w_q.dtype == torch.int8
    before = quant_matmul.launches
    out = xla.generate_codes(*request)
    assert out.steps == TINY_GEN.max_length and quant_matmul.launches == before
    assert torch.isfinite(torch.from_numpy(xla.decode_codes(out.codes, out.lengths)[0])).all()


# ------------------------------------------------- voice steering, streaming
def test_encode_voice_prompt_on_the_gpu_matches_the_cpu(cuda):
    """Codes on the card equal the fp32 CPU encode of the same codec, but at
    its near-ties (`chip_smoke.codes_agree`), latents within 1e-4."""
    import copy

    from chip_smoke import LATENT_REL, codes_agree, encode_gaps, norm_rel, voice_clips

    cfg = tiny_config()
    pipe = ParlerTTSPipeline.from_random(cfg, seed=5, generation_config=TINY_GEN)
    audio = voice_clips(cfg.sampling_rate, 1605)  # 50.2 hops
    codes = pipe.encode_voice_prompt(audio)
    hop = cfg.audio_encoder.hop_length
    assert codes.device.type == cuda.type and codes.shape == (2, 4, -(-audio.shape[1] // hop))
    x = torch.nn.functional.pad(torch.from_numpy(audio)[:, :, None],
                                (0, 0, 0, -audio.shape[1] % hop))
    cpu = copy.deepcopy(pipe.dac).cpu()
    with torch.inference_mode():
        lat_cpu = cpu.encoder(x)
        want = cpu.quantizer.encode(lat_cpu)[0]
        assert norm_rel(pipe.dac.encoder(x.to(cuda)).cpu(), lat_cpu) <= LATENT_REL
        assert codes_agree(codes, want, encode_gaps(cpu.quantizer, lat_cpu, want))[0]


def test_voice_steered_streams_on_the_gpu_match_generate_codes(cuda):
    """`stream_batch` with voice-prompt codes launches K1 every decode step
    and its samples equal the offline lengths; the stream's tokens equal
    `generate_codes`'s."""
    from parler_tts_tpu_torch.runtime.generate import make_stream_functions

    cfg = tiny_config()
    pipe = ParlerTTSPipeline.from_random(cfg, seed=6, generation_config=TINY_GEN, frame_bucket=8)
    request = tiny_request()
    codes = pipe.encode_voice_prompt(torch.randn(2, 6 * cfg.audio_encoder.hop_length) * 0.1)
    offline = pipe.generate_codes(*request, decoder_prompt_codes=codes)
    prefill, step = make_stream_functions(pipe.model, TINY_GEN, pipe.cache_dtype)
    state = prefill(*(x if x is None else x.to(cuda) for x in request),
                    decoder_prompt_codes=codes)
    before = flash_decode_attention.launches
    while state.t < TINY_GEN.max_length:
        step(state, 7)
    s0 = 1 + codes.shape[-1]  # BOS and the voice prompt; the prefill samples column s0
    assert flash_decode_attention.launches - before == 2 * (TINY_GEN.max_length - s0 - 1)
    assert torch.equal(state.out_ids, offline.delayed_ids)
    got = 0
    for chunk, valid in pipe.stream_batch(*request, play_steps=8, decoder_prompt_codes=codes):
        got = got + valid
    assert (got == offline.lengths.cpu().numpy() * cfg.audio_encoder.hop_length).all()


def test_pcm_stream_on_the_gpu(cuda):
    from parler_tts_tpu_torch.native import float_to_pcm16
    from parler_tts_tpu_torch.runtime.streamer import ParlerTTSStreamer

    pipe = ParlerTTSPipeline.from_random(tiny_config(), seed=7, generation_config=TINY_GEN)
    request = [None if x is None else x[:1] for x in tiny_request()]
    chunks = list(pipe.stream(*request, play_steps=8))
    pcm = b"".join(ParlerTTSStreamer(pipe, play_steps=8).pcm_stream(*request))
    assert pcm and pcm == b"".join(float_to_pcm16(c[0]) for c in chunks)


# ------------------------------------------------------------ speculative
def ar_top_two(pipe, request, monkeypatch):
    """The AR run of `request` with each column's top two processed logits."""
    import parler_tts_tpu_torch.runtime.generate as tgen

    real, seen = tgen._sample_column, {}

    def recording(logits, t, eos_state, pattern, gen, k, prompt_cols=1, **kw):
        x, _ = tgen._process_column(logits, t, eos_state, gen, k, prompt_cols)
        seen[t] = x.topk(2, dim=-1)
        return real(logits, t, eos_state, pattern, gen, k, prompt_cols=prompt_cols, **kw)

    monkeypatch.setattr(tgen, "_sample_column", recording)
    out = pipe.generate_codes(*request)
    monkeypatch.undo()
    return out, seen


@pytest.mark.parametrize("per_row", [False, True])
def test_speculative_pipeline_on_the_gpu(cuda, per_row, monkeypatch):
    """Greedy W=4 speculation on the card (fp32, tiny config, B=2): K1 once
    a layer per forward run, and each row equal to the AR run's up to its
    first parting, where the parting tokens are the AR run's top two within
    2e-4 (a near-tie the W-row matmuls may round the other way)."""
    ar = ParlerTTSPipeline.from_random(tiny_config(), seed=0, generation_config=TINY_GEN,
                                       frame_bucket=8, cache_dtype=torch.float32)
    spec = ParlerTTSPipeline(ar.model, ar.dac, TINY_GEN, cache_dtype=torch.float32,
                             speculative_window=4, speculative_per_row=per_row)
    request = tiny_request()
    want, top2 = ar_top_two(ar, request, monkeypatch)
    before = flash_decode_attention.launches
    got = spec.generate_codes(*request)
    st = spec.last_spec_stats
    assert flash_decode_attention.launches - before == 2 * (st.forwards + st.frozen)
    assert got.steps == TINY_GEN.max_length and st.forwards < st.columns
    for b in range(2):
        diff = (got.delayed_ids[b] != want.delayed_ids[b]).any(dim=0).nonzero()
        if not diff.numel():
            continue
        t = int(diff[0, 0])
        vals, idx = top2[t]
        for k in (got.delayed_ids[b, :, t] != want.delayed_ids[b, :, t]).nonzero()[:, 0]:
            pair = {int(got.delayed_ids[b, k, t]), int(want.delayed_ids[b, k, t])}
            assert pair == {int(idx[b, k, 0]), int(idx[b, k, 1])}
            assert float(vals[b, k, 0] - vals[b, k, 1]) <= 2e-4


# ------------------------------------------------------------ training CLI
def test_run_training_over_k4_on_the_gpu(cuda, tmp_path, monkeypatch):
    """`run_training` on the card at tiny size (hidden 256, Dh 64: the
    tensor-core route) with `attention_impl="pallas_flash"` and two
    micro-batches: K4 launches 2 x 2L forward, 2L dq and 2L dk/dv kernels a
    step, all on the wgmma route, finite losses; a run resumed from its
    step-2 checkpoint ends with the uninterrupted run's parameters; the
    export loads onto the card with the last checkpoint's parameters."""
    from parler_tts_tpu_torch.codec.registry import build_codec, init_codec_params
    from parler_tts_tpu_torch.models.parler import ParlerTTS
    from parler_tts_tpu_torch.training import arguments as ta
    from parler_tts_tpu_torch.training import checkpoints as ck
    from parler_tts_tpu_torch.training import run_training as rt

    cfg = tiny_config(256)
    model = ParlerTTS(cfg, use_chunked_attention="pallas", remat_layers=True)
    init_weights(model, torch.Generator().manual_seed(3))
    g = torch.Generator().manual_seed(4)
    feats = [{"labels": torch.randint(0, 88, (int(t), 4), generator=g).numpy(),
              "input_ids": torch.randint(0, 120, (7,), generator=g).tolist(),
              "prompt_input_ids": torch.randint(0, 256, (4,), generator=g).tolist()}
             for t in torch.randint(20, 40, (12,), generator=g)]
    counts, real = [], rt.make_train_step

    def counted(model, tx, **kw):
        step = real(model, tx, **kw)

        def run(state, batch, seed):
            for key in flash_attention.launches:
                flash_attention.launches[key] = flash_attention.launches_wgmma[key] = 0
            state, metrics = step(state, batch, seed)
            counts.append((dict(flash_attention.launches), dict(flash_attention.launches_wgmma),
                           float(metrics["loss"])))
            return state, metrics
        return run

    monkeypatch.setattr(rt, "make_train_step", counted)

    def args(out, steps):
        return ta.TrainingArguments(
            output_dir=str(out), per_device_train_batch_size=4, gradient_accumulation_steps=2,
            gradient_accumulation_mode="microbatch", learning_rate=1e-3, warmup_steps=0,
            max_steps=steps, save_steps=2, save_total_limit=1, logging_steps=1,
            report_to="none", dtype="bfloat16", attention_impl="pallas_flash")

    margs, dargs = ta.ModelArguments(max_length=64), ta.DataTrainingArguments()
    # each run trains the model it is given in place: give each one a copy
    whole, step = rt.run_training(margs, dargs, args(tmp_path / "whole", 3),
                                  copy.deepcopy(model), feats)
    n = cfg.decoder.num_hidden_layers
    want = {"fwd": 4 * n, "dq": 2 * n, "dkv": 2 * n}
    assert step == 3 and all(c == want and w == want for c, w, _ in counts)
    assert all(torch.isfinite(torch.tensor(loss)) for _, _, loss in counts)
    rt.run_training(margs, dargs, args(tmp_path / "cut", 2), copy.deepcopy(model), feats)
    resumed, step = rt.run_training(margs, dargs, args(tmp_path / "cut", 3), model, feats)
    assert step == 3 and abs(counts[-1][2] - counts[2][2]) <= 1e-5 * abs(counts[2][2])
    for (name, p), (_, q) in zip(resumed.model.named_parameters(),
                                 whole.model.named_parameters()):
        # equal but for the summation order of the card's reductions
        assert p.is_cuda
        torch.testing.assert_close(p, q, rtol=1e-5, atol=1e-6, msg=name)
    codec = init_codec_params(build_codec(cfg.audio_encoder), torch.Generator().manual_seed(5))
    final = rt.export_and_push(str(tmp_path / "whole"), str(tmp_path / "final"), cfg, codec)
    pipe = ParlerTTSPipeline.from_pretrained(final)
    saved = ck.load_state_dict(ck.get_last_checkpoint(str(tmp_path / "whole")))["params"]
    for name, p in pipe.model.named_parameters():
        assert p.is_cuda and torch.equal(p.cpu(), saved[name]), name


# ------------------------------------------------------------ Encodec
@pytest.mark.parametrize("causal", [True, False])
def test_encodec_on_the_gpu_matches_the_cpu(cuda, causal):
    """A small Encodec (16 kHz, ratios 4 x 4) on the card against the same
    fp32 codec on the CPU (`chip_smoke.encodec_check`): latents and the
    decode of the CPU's codes within 1e-4 (norm-relative), codes equal but
    at the CPU's near-ties."""
    import numpy as np

    from chip_smoke import encodec_check
    from parler_tts_tpu_torch.codec.encodec_model import EncodecCodecConfig
    from parler_tts_tpu_torch.codec.registry import build_codec, init_codec_params

    cfg = EncodecCodecConfig(sampling_rate=16000, num_filters=8, hidden_size=16,
                             upsampling_ratios=(4, 4), codebook_size=64, codebook_dim=16,
                             use_causal_conv=causal)
    codec = init_codec_params(build_codec(cfg, cuda), torch.Generator(cuda).manual_seed(0))
    clips = (np.random.default_rng(1).normal(size=(2, 16 * 301, 1)) * 0.2).astype(np.float32)
    encodec_check(codec.eval(), clips, torch.cuda.get_device_name(0), "small Encodec")


def test_tensor_parallel_greedy_on_the_shared_card(cuda):
    """Two gloo ranks of `tests/torch_dist_worker.py` share the card (CUDA
    tensors; gloo carries each collective through the host) and run fp32
    greedy generation at TP=2 on the tiny config: both return the ids of
    the single-process run on the card, with K1 on each rank's 2 heads."""
    from parler_tts_tpu_torch.convert import to_jax_tree
    from parler_tts_tpu_torch.models.parler import ParlerTTS
    from parler_tts_tpu_torch.runtime.generate import make_generate
    from torch_dist_worker import launch

    cfg = tiny_config()
    model = ParlerTTS(cfg, device=cuda)
    init_weights(model, torch.Generator(device=cuda).manual_seed(0))
    desc, desc_mask, prompt, prompt_mask = tiny_request()
    inputs = [torch.as_tensor(x, dtype=torch.int64) for x in
              (desc, torch.ones_like(torch.as_tensor(desc)), prompt, prompt_mask)]
    want = make_generate(model, TINY_GEN, torch.float32)(
        *(x.to(cuda) for x in inputs)).delayed_ids.cpu().numpy()
    got = launch(2, "generate", {"cfg": cfg, "params": to_jax_tree(model.named_parameters()),
                                 "device": "cuda", "cases": [dict(
                                     name="tp2", mesh=(1, 2), gen=TINY_GEN,
                                     inputs=[x.numpy() for x in inputs])]}, timeout=300)
    for rank in got:
        assert (rank["tp2"]["delayed"] == want).all()


def test_tensor_parallel_int8_and_fused_qkv_on_the_shared_card(cuda):
    """TP=2 greedy generation by two gloo ranks on the card with int8
    weights (K2 at each rank's column and row slices) and with the fused
    q|k|v projection: both return the ids of the single-process run of the
    same model on the card."""
    from parler_tts_tpu_torch.convert import to_jax_tree
    from parler_tts_tpu_torch.models.parler import ParlerTTS, fused_qkv_model
    from parler_tts_tpu_torch.runtime.generate import make_generate
    from torch_dist_worker import launch

    cfg = tiny_config()
    desc, _, prompt, prompt_mask = tiny_request()
    inputs = [torch.as_tensor(x, dtype=torch.int64)
              for x in (desc, torch.ones_like(desc), prompt, prompt_mask)]
    cases, want = [], {}
    for name, kw in (("int8", dict(weight_quant=True)), ("fused_qkv", dict(fused_qkv=True))):
        model = ParlerTTS(cfg, device=cuda, weight_quant=kw.get("weight_quant", False))
        init_weights(model, torch.Generator(device=cuda).manual_seed(0))
        if name == "fused_qkv":
            model = fused_qkv_model(model)
        want[name] = make_generate(model, TINY_GEN, torch.float32)(
            *(x.to(cuda) for x in inputs)).delayed_ids.cpu().numpy()
        cases.append(dict(name=name, mesh=(1, 2), gen=TINY_GEN, model_kw=kw,
                          params=to_jax_tree(model.named_parameters()),
                          inputs=[x.numpy() for x in inputs]))
    got = launch(2, "generate", {"cfg": cfg, "params": cases[0]["params"], "device": "cuda",
                                 "cases": cases}, timeout=300)
    for rank in got:
        for name in want:
            assert (rank[name]["delayed"] == want[name]).all(), name


def test_sequence_parallel_train_steps_on_the_shared_card(cuda):
    """Two gloo ranks on the card at seq=2 (K4 on each rank's rows against
    the gathered keys, the fp32 SIMT route at the tiny config's head dim 16)
    take 3 train steps at dropout 0.1 equal to the single-process steps on
    the card: loss within rtol 2e-4, grad_norm within rtol 2e-3, every
    parameter within 3e-5; K4 2 x 2 forward and 2 backward launches a step a
    rank (remat)."""
    import numpy as np

    from parler_tts_tpu_torch.convert import load_jax_params, to_jax_tree
    from parler_tts_tpu_torch.models.parler import ParlerTTS
    from parler_tts_tpu_torch.training import Batch, TrainState, make_optimizer, make_train_step
    from torch_dist_worker import launch

    cfg = tiny_config()
    cfg = dataclasses.replace(cfg, decoder=dataclasses.replace(cfg.decoder, dropout=0.1))
    model = ParlerTTS(cfg, device=cuda, use_chunked_attention="pallas", remat_layers=True)
    init_weights(model, torch.Generator(device=cuda).manual_seed(0))
    params = to_jax_tree(model.named_parameters())
    rng = np.random.default_rng(0)
    batches = []
    for _ in range(3):
        labels = rng.integers(0, 88, size=(2, 12, 4))
        labels[0, -3:] = -100
        prompt_mask = np.ones((2, 5), np.int64)
        prompt_mask[1, :2] = 0
        batches.append((rng.integers(0, 120, size=(2, 9)), np.ones((2, 9), np.int64),
                        rng.integers(0, 256, size=(2, 5)), prompt_mask, labels))
    opt = dict(learning_rate=1e-3, warmup_steps=2)
    tx = make_optimizer(**opt)
    state, step = TrainState.create(model, tx), make_train_step(model, tx)
    want = []
    for i, arrays in enumerate(batches):
        state, m = step(state, Batch(*(torch.from_numpy(x).to(cuda) for x in arrays)), i)
        want.append({k: v.detach().cpu().numpy() for k, v in m.items()})
    want_params = {n: p.detach().cpu().numpy() for n, p in model.named_parameters()}
    got = launch(2, "train", {"cfg": cfg, "params": params, "opt": opt, "batches": batches,
                              "device": "cuda", "cases": [dict(
                                  name="sp2", mesh=(1, 1, 2), model_kw=dict(
                                      use_chunked_attention="pallas", remat_layers=True))]},
                 timeout=300)
    layers = cfg.decoder.num_hidden_layers
    for rank in got:
        out = rank["sp2"]
        for m, w in zip(out["metrics"], want):
            np.testing.assert_allclose(m["loss"], w["loss"], rtol=2e-4)
            np.testing.assert_allclose(m["grad_norm"], w["grad_norm"], rtol=2e-3)
        assert out["k4"] == {"fwd": 2 * layers * 3, "dq": layers * 3, "dkv": layers * 3}
        trained = ParlerTTS(cfg)
        load_jax_params(trained, out["params"])
        for n, p in trained.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), want_params[n], rtol=0, atol=3e-5,
                                       err_msg=n)
