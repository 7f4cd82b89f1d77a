"""Port tests that need the card: the CUDA kernel K1 against its plain
version, and the pipeline on the GPU. Marked `cuda`; without a GPU each test
skips (a CUDA kernel has no CPU mode). This file imports no JAX, since the
machine with the card has none. Run there with

    python -m pytest tests/test_torch_cuda.py -m cuda -q --noconftest

(`--noconftest`: the suite's conftest.py sets up JAX, which that machine lacks.)

Tolerances: fp32 atol 2e-5 / rtol 1e-4 (the Pallas tests' own); bf16
atol 2e-3 / rtol 1e-2 (both sides round P to bf16, at different points of the
online softmax; the card reads at most 4.9e-4 on outputs of 0.01-0.05, and a
kernel that drops or repeats one 64-slot tile moves them by ~4e-3).
"""

import pytest
import torch

from parler_tts_tpu_torch.config import (
    DACConfig,
    DecoderConfig,
    GenerationConfig,
    ParlerTTSConfig,
    T5Config,
)
from parler_tts_tpu_torch.ops.flash_decode import (
    flash_decode_attention,
    flash_decode_attention_plain,
)
from parler_tts_tpu_torch.runtime.pipeline import ParlerTTSPipeline

pytestmark = pytest.mark.cuda

TOL = {torch.float32: dict(atol=2e-5, rtol=1e-4), torch.bfloat16: dict(atol=2e-3, rtol=1e-2)}


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


def check(q, k, v, starts, limit, layer=None):
    before = flash_decode_attention.launches
    got = flash_decode_attention(q, k, v, starts, limit, layer=layer)
    torch.cuda.synchronize()
    assert flash_decode_attention.launches == before + 1
    want = flash_decode_attention_plain(q, k, v, starts, limit, layer=layer)
    assert got.dtype == q.dtype and got.shape == q.shape
    torch.testing.assert_close(got.float(), want.float(), **TOL[q.dtype])
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


def test_kernel_empty_range_gives_zero(cuda):
    q, k, v = case(cuda, torch.float32, b=2, seed=4)
    starts = torch.tensor([100, 0], dtype=torch.int32, device=cuda)
    got = check(q, k, v, starts, torch.tensor([100, 0], dtype=torch.int32, device=cuda))
    assert torch.count_nonzero(got) == 0


def test_pipeline_on_the_gpu_launches_the_kernel_every_decode_step(cuda):
    pad, bos = 88, 89
    cfg = ParlerTTSConfig(
        text_encoder=T5Config(vocab_size=120, d_model=48, d_kv=12, d_ff=96, num_layers=2,
                              num_heads=4, relative_attention_num_buckets=8,
                              relative_attention_max_distance=20, dropout_rate=0.0),
        audio_encoder=DACConfig(num_codebooks=4, codebook_size=pad, codebook_dim=4,
                                latent_dim=64, encoder_dim=4, encoder_rates=(2, 4, 4),
                                decoder_dim=96, decoder_rates=(4, 4, 2),
                                sampling_rate=16000, frame_rate=500),
        decoder=DecoderConfig(vocab_size=100, hidden_size=64, num_hidden_layers=2,
                              num_attention_heads=4, ffn_dim=128, num_codebooks=4,
                              max_position_embeddings=128, pad_token_id=pad,
                              bos_token_id=bos, eos_token_id=pad, dropout=0.0),
        vocab_size=256, pad_token_id=pad, decoder_start_token_id=bos,
    )
    gen = GenerationConfig(max_length=40, min_new_tokens=40, do_sample=False,
                           bos_token_id=bos, pad_token_id=pad, eos_token_id=pad,
                           codebook_guard=pad)
    pipe = ParlerTTSPipeline.from_random(cfg, seed=0, generation_config=gen, frame_bucket=8)
    assert pipe.device.type == "cuda"
    g = torch.Generator().manual_seed(0)
    desc = torch.randint(0, 120, (2, 9), generator=g)
    prompt = torch.randint(0, 256, (2, 5), generator=g)
    prompt_mask = torch.ones(2, 5, dtype=torch.int64)
    prompt_mask[0, :2] = 0
    before = flash_decode_attention.launches
    out = pipe.generate_codes(desc, None, prompt, prompt_mask)
    decode_steps = out.steps - 2  # prefill samples column 1; the loop the rest
    assert out.steps == gen.max_length
    assert flash_decode_attention.launches - before == 2 * decode_steps
    audio, lengths = pipe.decode_codes(out.codes, out.lengths)
    assert torch.isfinite(torch.from_numpy(audio)).all()
    assert (lengths == (gen.max_length - 4) * cfg.audio_encoder.hop_length).all()
