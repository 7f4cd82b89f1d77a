#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`parler_tts_tpu_torch`) on one GPU.

    python3 chip_smoke.py        # from the root of the repository

Builds the port's CUDA kernels with nvcc, then:
  (a) holds kernel K1 (flash-decode attention) against its plain PyTorch
      version on the card at the main path's shapes (H=16, Dh=64,
      S = 8 prompt slots + 860 frames) over batch, starts, limits, windows,
      the stacked cache and the empty range, and times K1, its plain version
      and `F.scaled_dot_product_attention` (a yardstick only: the port never
      calls it);
  (b) serves parler-tts-mini-v1 (random weights from a seed, initialised on
      the card, bf16 weights and KV cache): `generate_codes` at B=2 over 860
      greedy columns with codebook_guard=1024, then `decode_codes` to 44.1 kHz
      audio, counting K1's launches (24 per decode step);
  (c) runs one mini-v1 decode step in fp32 through K1 and through the dense
      attention path on the same cache, and compares the logits.
TF32 is off for matmuls and cuDNN convolutions throughout, so fp32 means fp32.

Prints each phase's seconds with the card's name and power limit, one JSON
line of kernel numbers, the `nvidia-smi` name/power-limit line, and last
`{"ok": true, "device": {...}}`. Exits non-zero, printing no result, when
there is no CUDA device, when the port is not beside this script, or when
any check fails.
"""

import json
import subprocess
import sys
import time

import torch

S_PROMPT, MAX_LENGTH, BATCH = 8, 860, 2
S_CACHE = S_PROMPT + MAX_LENGTH
PROFILE_COLUMNS = 240
# bf16: at most 4.9e-4 read on the card (outputs 0.01-0.05 at these lengths), so a
# kernel that drops or repeats one 64-slot tile (~4e-3) fails
TOL = {torch.float32: dict(atol=2e-5, rtol=1e-4), torch.bfloat16: dict(atol=2e-3, rtol=1e-2)}
LOGITS_TOL = dict(atol=2e-4, rtol=2e-4)
HBM_BYTES_PER_S = 3.35e12   # H100 SXM, NVIDIA data sheet
BF16_OPS_PER_S = 989e12     # dense bf16 tensor-core peak, same source


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 5) -> float:
    for i in range(warmup):
        fn(i)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(i)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def phase_a(dev, card):
    """K1 against its plain version; returns (max_abs_err, timings)."""
    import torch.nn.functional as F

    from parler_tts_tpu_torch.ops.flash_decode import (
        flash_decode_attention,
        flash_decode_attention_plain,
    )

    g = torch.Generator(device=dev).manual_seed(0)
    h, dh, n_layers = 16, 64, 24

    def rand(*shape, dtype):
        return (torch.randn(shape, generator=g, device=dev) * 0.3).to(dtype)

    def i32(values):
        return torch.tensor(values, dtype=torch.int32, device=dev)

    max_err, n_cases = 0.0, 0
    for dtype in (torch.float32, torch.bfloat16):
        for b in (1, BATCH, 4):
            cache_k = rand(n_layers, b, S_CACHE, h * dh, dtype=dtype)
            cache_v = rand(n_layers, b, S_CACHE, h * dh, dtype=dtype)
            k, v = cache_k[5].reshape(b, S_CACHE, h, dh), cache_v[5].reshape(b, S_CACHE, h, dh)
            zeros = i32([0] * b)
            rows = i32([0, 3, 8, 5][:b])
            cases = [(f"limit={n}", rand(b, h, dh, dtype=dtype), k, v, zeros, n, None)
                     for n in (1, 63, 64, 65, 128, 640, S_CACHE)]
            cases += [
                ("per-row starts", rand(b, h, dh, dtype=dtype), k, v, rows, 500, None),
                ("per-row limits", rand(b, h, dh, dtype=dtype), k, v, rows,
                 i32([S_CACHE, 64, 300, 9][:b]), None),
                ("W=4 window", rand(b, 4, h, dh, dtype=dtype), k, v, rows, S_CACHE - 3, None),
                ("stacked layer 0", rand(b, h, dh, dtype=dtype), cache_k, cache_v, rows, 700, 0),
                ("stacked layer 23", rand(b, h, dh, dtype=dtype), cache_k, cache_v, rows, 700,
                 23),
                ("stacked 23 limit=S", rand(b, h, dh, dtype=dtype), cache_k, cache_v, rows,
                 S_CACHE, 23),
                ("empty range", rand(b, h, dh, dtype=dtype), k, v, i32([9] * b), 9, None),
            ]
            for name, q, kk, vv, starts, limit, layer in cases:
                got = flash_decode_attention(q, kk, vv, starts, limit, layer=layer)
                torch.cuda.synchronize()
                want = flash_decode_attention_plain(q, kk, vv, starts, limit, layer=layer)
                err = (got.float() - want.float()).abs().max().item()
                torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])
                if name == "empty range" and torch.count_nonzero(got).item():
                    raise AssertionError("K1 on an empty range must return 0")
                max_err, n_cases = max(max_err, err), n_cases + 1
                print(f"  K1 vs plain {str(dtype)[6:]:8s} B={b} {name:18s} "
                      f"max_abs_err={err:.3e}")
            del cache_k, cache_v
    print(f"  {n_cases} cases within fp32 atol 2e-5 rtol 1e-4, bf16 atol 2e-3 rtol 1e-2")

    # timing at the main path's shapes: B=2, bf16 q and cache, 434 slots (the
    # mean decode step of the 860-column run) and 868 (the last); each launch
    # reads another layer of the stacked cache (170 MB, over the 50 MB L2), as
    # the decode loop does
    b = BATCH
    cache_k = rand(n_layers, b, S_CACHE, h * dh, dtype=torch.bfloat16)
    cache_v = rand(n_layers, b, S_CACHE, h * dh, dtype=torch.bfloat16)
    q = rand(b, h, dh, dtype=torch.bfloat16)
    starts = i32([0] * b)
    q4 = q.view(b, h, 1, dh)
    for limit in (S_CACHE // 2, S_CACHE):
        k_views = [cache_k[i].view(b, S_CACHE, h, dh)[:, :limit].transpose(1, 2)
                   for i in range(n_layers)]
        v_views = [cache_v[i].view(b, S_CACHE, h, dh)[:, :limit].transpose(1, 2)
                   for i in range(n_layers)]
        kernel_ms = cuda_ms(lambda i: flash_decode_attention(
            q, cache_k, cache_v, starts, limit, layer=i % n_layers), iters=480)
        plain_ms = cuda_ms(lambda i: flash_decode_attention_plain(
            q, cache_k, cache_v, starts, limit, layer=i % n_layers), iters=96)
        sdpa_ms = cuda_ms(lambda i: F.scaled_dot_product_attention(
            q4, k_views[i % n_layers], v_views[i % n_layers], scale=1.0), iters=480)
        bytes_moved = 2 * (b * h * dh) * 2 + 2 * b * limit * h * dh * 2  # q, out; k, v
        ops = 4 * b * h * limit * dh
        byte_s, op_s = bytes_moved / HBM_BYTES_PER_S, ops / BF16_OPS_PER_S
        bound_ms, bound_by = max(byte_s, op_s) * 1e3, "bytes" if byte_s >= op_s else "operations"
        print(f"  K1 {kernel_ms * 1e3:.2f} us, plain {plain_ms * 1e3:.2f} us, SDPA "
              f"{sdpa_ms * 1e3:.2f} us, bound {bound_ms * 1e3:.2f} us ({bound_by}: "
              f"{bytes_moved / 1e6:.2f} MB) per call at B={b}, bf16, {limit} slots ({card})")
    return max_err, dict(ms=kernel_ms, plain_ms=plain_ms, library_ms=sdpa_ms,
                         bound_ms=bound_ms, bound_by=bound_by)


def mini_v1_pipeline(dev, dtype, seed, gen):
    from parler_tts_tpu_torch.config import mini_v1_config
    from parler_tts_tpu_torch.runtime.pipeline import ParlerTTSPipeline

    return ParlerTTSPipeline.from_random(
        mini_v1_config(), seed=seed, generation_config=gen, device=dev, dtype=dtype,
        cache_dtype=dtype,
    )


def request_ids(seed):
    import numpy as np

    rng = np.random.default_rng(seed)
    desc = rng.integers(0, 32000, size=(BATCH, 16))
    prompt = rng.integers(0, 32000, size=(BATCH, S_PROMPT))
    prompt_mask = np.ones((BATCH, S_PROMPT), np.int64)
    prompt_mask[1, :3] = 0  # a left-padded prompt: K1's starts > 0 on row 1
    return desc, np.ones((BATCH, 16), np.int64), prompt, prompt_mask


def phase_b(dev, card):
    """mini-v1 served end to end; returns K1's launches on the main path."""
    import dataclasses

    import numpy as np

    from parler_tts_tpu_torch.config import GenerationConfig
    from parler_tts_tpu_torch.ops.flash_decode import flash_decode_attention
    from parler_tts_tpu_torch.runtime.pipeline import ParlerTTSPipeline

    gen = GenerationConfig(max_length=MAX_LENGTH, min_new_tokens=MAX_LENGTH, do_sample=False,
                           codebook_guard=1024)
    t0 = time.perf_counter()
    pipe = mini_v1_pipeline(dev, torch.bfloat16, 0, gen)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in pipe.model.parameters())
    print(f"  mini-v1 initialised on the card: {n_params / 1e6:.1f}M parameters + codec, "
          f"{time.perf_counter() - t0:.2f} s")
    desc, desc_mask, prompt, prompt_mask = request_ids(0)
    # warm-up: the same entry points over 40 columns
    warm = ParlerTTSPipeline(pipe.model, pipe.dac,
                             dataclasses.replace(gen, max_length=40, min_new_tokens=40),
                             cache_dtype=torch.bfloat16, device=dev)
    warm.decode_codes(*warm.generate_codes(desc, desc_mask, prompt, prompt_mask)[1:3])
    torch.cuda.synchronize()

    flash_decode_attention.launches = 0
    t0 = time.perf_counter()
    out = pipe.generate_codes(desc, desc_mask, prompt, prompt_mask, seed=0)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    audio, lengths = pipe.decode_codes(out.codes, out.lengths)
    t2 = time.perf_counter()
    launches = flash_decode_attention.launches

    n_layers = pipe.config.decoder.num_hidden_layers
    decode_steps = out.steps - 2  # prefill samples column 1, the loop 2 .. L-1
    frames = MAX_LENGTH - pipe.config.decoder.num_codebooks
    hop, sr = pipe.config.audio_encoder.hop_length, pipe.config.sampling_rate
    audio_s = frames * hop / sr
    print(f"  audio {tuple(audio.shape)} finite={bool(np.isfinite(audio).all())} "
          f"lengths={lengths.tolist()}")
    print(f"  K1 launches {launches} = {n_layers} layers x {decode_steps} decode steps: "
          f"{launches == n_layers * decode_steps}")
    print(f"  generate_codes {t1 - t0:.3f} s ({decode_steps / (t1 - t0):.1f} decode steps/s), "
          f"decode_codes {t2 - t1:.3f} s; {audio_s:.2f} s of audio -> real-time factor "
          f"{(t2 - t0) / audio_s:.4f} (RTFx {audio_s / (t2 - t0):.2f}) at B={BATCH} ({card})")
    if out.steps != MAX_LENGTH:
        raise AssertionError(f"expected {MAX_LENGTH} columns, got {out.steps}")
    if launches != n_layers * decode_steps:
        raise AssertionError(f"K1 launched {launches} times, want {n_layers * decode_steps}")
    if audio.shape != (BATCH, frames * hop) or not np.isfinite(audio).all():
        raise AssertionError(f"bad audio: shape {audio.shape}")
    if (lengths != frames * hop).any():
        raise AssertionError(f"bad lengths {lengths}")
    profile_decode(pipe, gen, dev, card, (desc, desc_mask, prompt, prompt_mask), t1 - t0,
                   decode_steps)
    del pipe, warm
    torch.cuda.empty_cache()
    return launches


def profile_decode(pipe, gen, dev, card, request, wall_s, decode_steps):
    """Device time of the served run by kernel, from a CUDA-only profile of
    the same request over PROFILE_COLUMNS columns (the profiler's own host cost
    stays out of the unprofiled wall time measured above)."""
    import dataclasses
    from collections import defaultdict

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from parler_tts_tpu_torch.runtime.pipeline import ParlerTTSPipeline

    short = ParlerTTSPipeline(pipe.model, pipe.dac, dataclasses.replace(
        gen, max_length=PROFILE_COLUMNS, min_new_tokens=PROFILE_COLUMNS),
        cache_dtype=torch.bfloat16, device=dev)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = short.generate_codes(*request)
        torch.cuda.synchronize()
    steps = out.steps - 2
    by_name, count = defaultdict(float), defaultdict(int)
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] += e.time_range.elapsed_us()
            count[e.name] += 1
    busy_us = sum(by_name.values())
    k1_us = sum(v for k, v in by_name.items() if "flash_decode_kernel" in k)
    per_step_wall_ms = wall_s / decode_steps * 1e3
    print(f"  profile over {PROFILE_COLUMNS} columns: {sum(count.values()) / steps:.0f} kernels "
          f"per decode step, device busy {busy_us / steps / 1e3:.3f} ms per step (prefill "
          f"included), K1 {k1_us / steps / 1e3:.3f} ms of it; unprofiled wall "
          f"{per_step_wall_ms:.3f} ms per step over {MAX_LENGTH} columns ({card})")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
        print(f"    {us / busy_us:6.1%} {count[name]:7d}x {name[:90]}")


def phase_c(dev, card):
    """One fp32 mini-v1 decode step through K1 vs the dense attention path."""
    from parler_tts_tpu_torch.config import GenerationConfig
    from parler_tts_tpu_torch.models.decoder import DecoderCache
    from parler_tts_tpu_torch.ops.masks import causal_self_attention_bias

    pipe = mini_v1_pipeline(dev, torch.float32, 1, GenerationConfig())
    model, dcfg = pipe.model, pipe.config.decoder
    desc, desc_mask, prompt, prompt_mask = (torch.as_tensor(x, device=dev)
                                            for x in request_ids(1))
    g = torch.Generator(device=dev).manual_seed(1)
    n_pre = MAX_LENGTH // 2  # prefill the prompt and 430 columns, then decode the next one
    cols = torch.randint(0, 1024, (BATCH, dcfg.num_codebooks, n_pre + 1), generator=g,
                         device=dev)
    with torch.inference_mode():
        enc = model.encode_description(desc, desc_mask)
        cache = DecoderCache.zeros(dcfg, BATCH, S_CACHE, enc.shape[1], torch.float32, dev)
        cache.cross_k, cache.cross_v = model.decoder.precompute_cross_kv(enc)
        kv_valid = torch.cat([prompt_mask.bool(),
                              torch.ones(BATCH, MAX_LENGTH, dtype=torch.bool, device=dev)], 1)
        pos = torch.arange(S_CACHE, device=dev)[None].expand(BATCH, -1)
        pre = torch.cat([model.prompt_hidden(prompt),
                         model.decoder.embed_ids(cols[:, :, :n_pre])], dim=1)
        t = S_PROMPT + n_pre
        model.decoder(pre, pos[:, :t], self_attn_bias=causal_self_attention_bias(
            pos[:, :t], kv_valid), cross_attn_bias=None, cache=cache)
        emb = model.decoder.embed_ids(cols[:, :, n_pre:])
        starts = (S_PROMPT - prompt_mask.sum(1)).to(torch.int32)
        with_k1 = model.decoder(emb, pos[:, t:t + 1], self_attn_bias=None,
                                cross_attn_bias=None, cache=cache,
                                decode_lengths=(starts, t + 1))
        cache.index = t
        dense = model.decoder(emb, pos[:, t:t + 1], self_attn_bias=causal_self_attention_bias(
            pos[:, t:t + 1], kv_valid), cross_attn_bias=None, cache=cache)
    err = (with_k1 - dense).abs().max().item()
    print(f"  decode step at position {t}: logits {tuple(with_k1.shape)}, K1 vs dense "
          f"max_abs_err={err:.3e} (tolerance atol 2e-4 rtol 2e-4, fp32, TF32 off) ({card})")
    torch.testing.assert_close(with_k1, dense, **LOGITS_TOL)
    del pipe, model, cache
    torch.cuda.empty_cache()


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from parler_tts_tpu_torch.ops._cuda import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = card_line()
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    t0 = time.perf_counter()
    log = build("flash_decode")
    print(f"[build] nvcc of flash_decode{'' if log else ' (up to date)'}: "
          f"{time.perf_counter() - t0:.2f} s ({card})")
    for line in log.splitlines():
        if "Used" in line or "spill" in line:
            print("  ptxas:", line.strip())

    t0 = time.perf_counter()
    max_err, timing = phase_a(dev, card)
    print(f"[phase a] K1 vs plain: {time.perf_counter() - t0:.2f} s ({card})")
    t0 = time.perf_counter()
    launches = phase_b(dev, card)
    print(f"[phase b] mini-v1 pipeline: {time.perf_counter() - t0:.2f} s ({card})")
    t0 = time.perf_counter()
    phase_c(dev, card)
    print(f"[phase c] decode step K1 vs dense: {time.perf_counter() - t0:.2f} s ({card})")

    kernels = [dict(
        name="flash_decode_attention", route="cuda",
        source="parler_tts_tpu_torch/csrc/flash_decode.cu",
        replaces="parler_tts_tpu/ops/pallas/flash_decode.py:192",
        launches=launches, max_abs_err=max_err, **timing,
    )]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
