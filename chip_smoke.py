#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`parler_tts_tpu_torch`) on one GPU.

    python3 chip_smoke.py        # from the root of the repository

Builds the port's CUDA kernels with nvcc, then:
  (a) holds kernel K1 (flash-decode attention) against its plain PyTorch
      version at the kernel's split count on the card at the shapes of an
      860-column run (H=16, Dh=64, S = 8 prompt slots + 860 frames) over batch,
      starts, limits (share boundaries on slots 63/64 and 127/128, rows whose
      shares are all or partly empty), windows, the stacked cache and the
      empty range, each call repeated bit for bit; checks that a result
      without the first, the last or a share's last slot fails the fp32
      tolerance; and times K1 (device time from CUDA-graph replays and the
      profiler, and paced by the host), its plain version and
      `F.scaled_dot_product_attention` (a yardstick only: the port never
      calls it) at B=2 over 434 and 868 slots and at B=1 over 868;
  (b) serves parler-tts-mini-v1 (random weights from a seed, initialised on
      the card, bf16 weights and KV cache): `generate_codes` at B=2 over 430
      greedy columns with codebook_guard=1024, then `decode_codes` to 44.1 kHz
      audio, counting K1's launches (24 per decode step);
  (c) runs one mini-v1 decode step in fp32 through K1 and through the dense
      attention path on the same cache, and compares the logits;
  (d) holds kernel K2 (int8 weight-only matmul) against its plain version at
      the int8 path's shapes (M in {1, 2, 18, 32}; K x N = 1024 x 1024,
      1024 x 4096, 4096 x 1024, and 1024 x 1040 for a ragged strip; fp32
      and bf16 x), each call repeated bit for bit, and checks that a result
      without the cluster's last K slice fails `k2_close`; times K2, its
      plain version and a bf16 `torch.matmul` on pre-dequantized weights (a
      yardstick only) at M=2 over 24 layers' weights, by the profiler's
      kernel sums and host-paced, and one decode layer's 8 launches over 24
      layers by CUDA-graph replay;
  (e) serves mini-v1 with `weight_quant=True` (int8 decoder layers quantized
      on the card) at B=2 over (b)'s request, counting K2's launches
      (192 x (decode steps + 1) + 48) and K1's (24 per decode step), profiles
      it, and compares one fp32 int8 decode step's logits, K2 against its
      plain version;
  (f) holds kernel K3 (the fused 24-layer decode step) against its plain
      version at the kernel's tiling, at mini-v1 shapes (cache 868 rows,
      S_enc 16 with 4 masked, n_rows in {1, 64, 65, 434, 867}, start in
      {0, 3}; the chunk edges, n_rows = start + 1, the self-attention items'
      ownership edge; S_enc 33), layer by layer within limits set by the plain
      version's own fp32-vs-float64 noise in this run (`fused_limits`),
      checks that a K3 that drops the first or last cache row (at n_rows 8,
      434 and 867) or a layer's fc2 fails them, that 200 launches give the
      same bits and that bounds given as device tensors give the bits of int
      bounds, and times K3 and its two stripped variants (the weight stream
      without the dependency waits, the waits without the weight bytes) by
      CUDA-graph replay (the profiler's kernel sums beside) and its plain
      version;
  (g) serves mini-v1 at B=1 with `fused_decode=True` (row 1 of (b)'s request,
      left-padded) over 430 columns, counting one K3 launch per decode step,
      and prints steps/s, RTF, kernels per decode step and device idle share
      beside the eager bf16 path on the same request;
  (h) holds kernel K4 (training flash attention: forward, dq, dk/dv) against
      its plain version, output and gradients, on both of its routes: bf16
      with Dh 64 on the tensor-core kernels (csrc/flash_attention_wgmma.cu),
      fp32 and bf16 with another head dim on the SIMT kernels
      (csrc/flash_attention.cu). Cases: mini-v1's training attention (B=2,
      H=16, Dh=64, T = 16 prompt + 1024 frames, causal, row 1's prompt
      left-padded by 5) and small GQA 8:2, q_offset 256, unaligned and
      non-causal cases, each in bf16 and fp32; in bf16 also Tq < Tk with an
      offset and a left pad that leaves query rows no valid key, Tq > Tk causal
      and non-causal, and Dh 32 (SIMT). Each within limits set by the plain
      version's own fp32-vs-float64 noise, on the route `_k4_route` picks (its
      launch counters), with rows that see no valid key and masked keys
      exactly 0 in o and every gradient; a kernel that drops one key tile must
      fail the limits. At the main shape it times both routes' kernels (wgmma,
      SIMT, wgmma) beside each one's own plain version (the forward, the dq
      part and the dk/dv part of the plain backward) and
      `F.scaled_dot_product_attention` forward and backward with the same
      boolean mask (a yardstick only; no library call computes dq or dk/dv
      alone, so its backward is reported once, as the dk/dv entry's
      `library_backward_ms`), with achieved TFLOP/s and the share of the bound;
  (i) trains parler-tts-mini-v1 at full width and depth (fp32 parameters and
      AdamW moments, bf16 compute, K4 attention, every layer rematerialised)
      for 5 steps on one B=2 batch with `make_optimizer(warmup_steps=1)`:
      the loss is finite and falls from step 2 to step 5, step 1 (lr 0)
      changes no parameter, the frozen text encoder never changes, and K4
      launches exactly 48 forward, 24 dq and 24 dk/dv kernels a step, all on
      the tensor-core route; a profiled step gives K4's device time and the
      step's device busy time; step 1's loss and gradient norm through the
      plain chunked-attention route (bf16) agree with K4's within the gap
      between K4's bf16 and fp32 runs of that step, the noise bf16 compute
      puts on them; K4 in fp32 launches its 48 / 24 / 24 kernels on the SIMT
      route; and in fp32 the two routes' step-1 loss, gradient norm and every
      gradient leaf agree within 1e-4 (norm-relative), the CPU tests'
      gradient tolerance against the JAX package;
  (j) serves phase (b)'s pipeline from disk: `save_pretrained` (the native
      layout) and the port's HF exporters through `write_safetensors` (two
      shards, BF16 model tensors, F32 codec in the weight_g / weight_v form
      with v_scale 1.7), each loaded by `from_pretrained` in bf16; every model
      parameter `torch.equal` to the source's and the folded codec kernels
      within 1e-6 of their scale, a transposed decoder kernel and an unfolded
      conv failing that check; the loaded pipelines give phase (b)'s 430
      columns (K1 24 a decode step), phase (g)'s B=1 stream over K3 and phase
      (e)'s int8 stream with its K2 count; weight_quant="xla" (a decode
      step within 4 x K2's own float64-summation gap of K2, 256 columns
      timed); fused_qkv (prefill and 8 decode steps' logits within half the
      bf16 model's gap to its fp32 copy, the 430 columns equal to phase (b)'s
      but at near-ties of phase (b), 2e-4); the bf16 codec (fp32 audio equal
      to the fp32 codec over bf16-rounded weights, relative RMS below 0.12
      with conv_out in the unit range); the sliding-window cache over 512
      columns in fp32 (a window spanning the cache gives the static path's
      stream but at its near-ties, a 256 window the same columns before it
      can drop a slot and then parts; no K1 launch, no NaN); text through a
      stub tokenizer equal to the same ids;
  (k) steers phase (b)'s pipeline with a voice: two seeded synthetic 3 s
      clips at 44.1 kHz through `encode_voice_prompt` on the card, the
      latents within 1e-4 (norm-relative) of the same fp32 codec's encode on
      the CPU and the codes equal to its codes but at its near-ties (a
      best-to-second distance gap below 1e-5, counted); `stream` (B=1, row 0)
      and `stream_batch` (B=2) over phase (b)'s request with those codes as
      voice prompt, play_steps 86, after `warmup_stream_async`: the chunks'
      tokens equal `generate_codes` on the same request, their samples the
      offline lengths, K1 24 launches a decode step; time to the first
      chunk, decode steps/s and chunk count; `pcm_stream` over 256 columns
      through the native ring buffer gives the bytes of `float_to_pcm16` of
      the stream's chunks;
  (l) runs parler-tts-large-v1 (decoder 30 layers x 1536, 24 heads, FFN
      6144; flan-t5-large; random bf16 weights drawn on the card from a
      seed): K1 against its plain version at H=24 over a 868-slot stacked
      cache (fp32 and bf16, repeats bit for bit, a dropped first slot fails
      fp32 TOL); K2 at K x N = 1536 x 1536, 1536 x 6144, 6144 x 1536 within
      `k2_close` (repeats bit for bit, a dropped K slice fails); K3 layer by
      layer within `fused_limits` at n_rows 1, 434 and 867 from starts 0 and
      3 (a dropped first or last cache row fails, 20 repeats bit for bit);
      one fp32 decode step through K1 against the dense path; then serves
      eager bf16 B=2, `weight_quant=True` B=2 and `fused_decode=True` B=1
      over 256 greedy columns with exact launch counts (K1 30 a decode step,
      K2 240 x (steps + 1) + 60, K3 one a decode step), and times K1, K2's
      decode layer and K3 by CUDA-graph replay;
  (m) serves both speculatively (W candidate columns verified per forward):
      K1 against its plain version at the window's shapes (mini-v1 W=24 at
      B=1 and at B=2 with per-row limits that differ, large-v1 W=16; fp32
      and bf16, repeats bit for bit, a last column without its last slot
      fails fp32 TOL), timed beside SDPA with the equal boolean mask; then
      mini-v1 bf16 W=24, lookup 3, over 430 greedy columns at B=1 (row 1)
      and per-row at B=2, each row equal to phase (b)'s eager row up to its
      first parting, which must be a near-tie of the AR run (its logit of
      the speculative token within 4 x the bf16 decode step's largest logit
      gap to its fp32 copy; replayed on the AR run up to that column); the
      same per-row in fp32 over 256 columns against the fp32 AR run with
      near-ties at 2e-4; sampled B=1 twice from one seed (equal tokens, >= 1
      column a forward, valid codes); a speculative stream B=1 (play_steps
      86) equal to the offline tokens bit for bit; int8 over K2 at M = 24
      against phase (e); large-v1 W=16 over 256 columns against phase (l);
      decoder-only in fp32 over 256 columns, AR against speculative; K1 24
      (large-v1 30) launches and K2 192 a forward run, exactly.
  (n) trains through the CLI at mini-v1 width (random weights from a seed,
      dropout 0, saved in the native layout): `run_training.main` over an in-memory
      stand-in dataset of 22 seeded synthetic clips of 2-8 s at 44.1 kHz
      (one 8 s long, so the labels pass 512 frames and the trainer turns on
      K4 and remat) plus a too-short row and an over-long description, the
      stub tokenizer, bf16, `attention_impl="pallas_flash"`, B=2 with two
      micro-batches, `group_by_length`, 6 steps at lr 5e-4, checkpoints
      every 3 kept to 1, eval loss and eval generation of 2 samples at step
      6, the export: each clip's labels equal `build_labels_from_codes` of
      its encode alone but at near-ties, the filters drop the two rows, K4
      launches 96 / 48 / 48 a step on the wgmma route, K1 24 a decode step
      of the eval generation, finite losses, an eval loss at step 6 below the
      initial parameters', checkpoint-3 then checkpoint-6 with one left; a
      second uninterrupted run and one resumed from checkpoint-3 (every saved
      tensor restored bit for bit, losses within the two uninterrupted runs'
      spread); `final/` loaded by `from_pretrained` with every parameter
      equal to the last checkpoint's and 64 greedy columns served; then
      remat_policy="dots" against full remat and bf16 Adam moments over 3
      steps of phase (i)'s batch (losses within phase (i)'s bf16 gap, K4 48 /
      24 / 24 a step, peak memory and ms a step printed);
  (o) runs Encodec at the JAX package's default geometry (32 kHz, 64 filters,
      ratios 8 5 4 4, 4 codebooks of 2048; random weights from a seed), causal
      and not: two seeded 3 s clips encoded on the card, latents within 1e-4
      of the same fp32 codec on the CPU and codes equal but at its
      near-ties, the CPU's codes decoded within 1e-4; a stereo normalising
      variant through `encode_voice_prompt(return_scales=True)` (scales
      within 1e-6) and `decode_codes(audio_scales=)` (frames x hop x 2
      interleaved samples within 1e-4); a mini-v1-width decoder over its 4
      codebooks served bf16 B=2 over 256 greedy columns (K1 24 a decode
      step), decoded to 32 kHz, saved in the native layout and served again
      from disk with equal parameters and columns.
  (p, after m) parallelism: (p0) K1 against its plain version at the shapes
      tensor and data parallelism give it (mini-v1 TP=2: H=8, B=2; large-v1
      TP=2: H=12; the W=24 window at H=8; a DP=2 rank's row: B=1), fp32 and
      bf16 within TOL, repeats bit for bit, a dropped last slot failing fp32
      TOL, each timed by graph replay beside its plain version and SDPA with
      the equal boolean mask; K2 at a DP rank's M=1 and at each TP=2 rank
      slice at M=2 (q/k/v 1024 -> 512, out_proj 512 -> 1024, fc1 1024 ->
      2048, fc2 2048 -> 1024) within `k2_close`, one TP rank's decode layer
      timed by graph replay beside the bf16 matmul; K4 forward, dq and dk/dv
      on both routes at H=8 B=2, H=16 B=1 and each seq=2 rank's rows of
      phase (i)'s sequence (Tq 528 at q_offset 0, Tq 512 at q_offset 528,
      against Tk 1040) within `k4_limits`, the wgmma kernels timed at those
      shapes beside their plain versions and SDPA; (p1) NCCL at world size 1
      in this process, run beside
      (p2)'s ranks with the train references and world 1's CLI run:
      `make_generate(mesh=make_mesh(1, 1))` over (b)'s request bit-identical
      to (b)'s ids, and one train step over the mesh and under FSDP
      bit-identical (loss, grad_norm, every parameter) to the step without a
      mesh; (p2) two ranks of this script (`--phase-p-rank`) sharing the
      card over gloo on CUDA tensors (NCCL refuses two ranks on one GPU):
      DP=2 bf16 B=2 over 128 columns and TP=2 bf16 over 64 (cut from 430
      for time), each held to the single-process run at every column (its
      token forced where they part), each partition's near-tie (the largest
      change of the one-process top-two gap over 22 teacher-forced decode
      steps after each of 215, 430 and 645 columns, under TP or for a row
      alone) no larger than bf16's own (one
      process's bf16 logits against fp32's over the same steps), and every
      parting within its partition's near-tie; gloo's bf16 and fp32
      all-reduce and all-gather on CUDA tensors bit-exact; TP=2 fp32 B=2
      over 96 columns and TP=2 speculative fp32 W=24 B=1 equal to the fp32
      AR run but at near-ties of 2e-4, with fewer forwards than columns;
      DP=2 int8 over K2 at M=1 with exact launch counts; TP=2 bf16 with
      int8 weights (K2 at the rank's slices, 192 launches a decode step) and
      with fused q|k|v, each over 64 columns held to the one-process run of
      the same model at every column within its own near-tie, as TP=2 bf16
      is; one train step at
      dropout 0.1 in each mode of P_TRAIN_MODES (DP=2, TP=2, FSDP=2 and
      SP=2 in fp32 on K4's SIMT route; DP=2, FSDP=2, SP=2 and TP=2 in bf16
      on its wgmma route; TP=2 bf16 again with its row-parallel partial
      sums all-reduced in fp32, `fp32_partial_sums`) against the
      single-process step of its dtype: loss and grad_norm within this
      run's gaps between its bf16 and fp32 steps (bf16 TP=2's also within
      the move between TP's steps with and without fp32 partial sums),
      num_items
      exact, the sampled parameters' updates parting on no larger a share
      than the bf16 and fp32 steps', K4 48 / 24 / 24 a rank on the route of
      its dtype at each rank's (Tq, Tk, q_offset), and each step's memory a
      rank by phase with the
      allocations live at its peak (StepMemory); the CLI at world 2
      (`mesh_data=2`, fp32) over (n)'s features for 3 steps and a gathered
      checkpoint, resumed at world 1 against an uninterrupted world-1 run
      (losses within phase (i)'s bf16 gap, parameters as the train
      steps'); decode steps/s, collectives a decode step, host ms a
      collective, train ms and peak GiB a rank printed as two processes on
      one card, not a scaling figure. Any failure of a rank fails (p).
  (q, after o) runs the helper scripts (`parler_tts_tpu_torch/scripts/`) at
      mini-v1 width: `init_model_600M --device cuda --seed 0` into a
      temporary directory (GB and seconds printed), loaded back in fp32 with
      every parameter `torch.equal` to the drawn ones and the script's
      configs, served in bf16 B=2 over 64 greedy columns (K1 24 a decode
      step); `push_trained_parler_tts_to_hub` on its params.pkl and
      config.json, the export loaded in bf16 with the model and codec equal
      to the native load's; the real-size codec's state dict
      (`export_dac_params`, weight_g / weight_v with v_scale 1.7) as
      `.safetensors` and `.pth` through `push_dac_to_hub`, each tree's folded
      kernels within 1e-6 of their scale and its decode of the served codes
      within 1e-3 (relative RMS) of the pipeline's codec, one kernel left
      unfolded failing that; the demo's CLI loop over the
      directory (stub tokenizer, speculative W=16, sampled over 64 columns),
      its WAV finite and K1 24 a forward.
TF32 is off for matmuls and cuDNN convolutions throughout, so fp32 means fp32.

Prints each phase's seconds with the card's name and power limit, one JSON
line of kernel numbers (K1, K2 and K3 with their large-v1 numbers under
`large_v1`, K1's window numbers under `window` and phase (m)'s runs under
`speculative`, phase (n)'s under `training_cli`, phase (o)'s under
`encodec`, phase (q)'s under `helper_scripts`, and phase (p)'s under
`parallel` for K1, K2 and K4), the `nvidia-smi` name/power-limit line, and last
`{"ok": true, "device": {...}}`. Exits non-zero, printing no result, when
there is no CUDA device, when the port is not beside this script, or when
any check fails.
"""

import contextlib
import json
import math
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import torch

from parler_tts_tpu_torch.runtime.checkpoint import write_safetensors

S_PROMPT, MAX_LENGTH, BATCH = 8, 430, 2
S_CACHE = S_PROMPT + MAX_LENGTH  # the cache the serving phases give K1 and K3
# the kernels' own checks and timings, and the teacher-forced decode steps that
# measure logits and near-ties (decode_prefix), keep an 860-column run's shapes
# (868 slots; its mean and last decode steps at 434 and 867), whatever the
# depth the serving phases run to; phases (a) and (f) hold K1 and K3 to their
# plain versions at S_CACHE as well
K_COLUMNS = 860
K_SLOTS = S_PROMPT + K_COLUMNS
PROFILE_COLUMNS = 240
# bf16: at most 9.8e-4 read on an H100 80GB HBM3 at 700 W (one bf16 step of outputs
# up to 0.25 at short prefixes), so a kernel that drops or repeats one 64-slot tile
# (~4e-3) fails; fp32: a result without one slot fails (phase a checks it)
TOL = {torch.float32: dict(atol=2e-5, rtol=1e-4), torch.bfloat16: dict(atol=2e-3, rtol=1e-2)}
LOGITS_TOL = dict(atol=2e-4, rtol=2e-4)
KERNEL_SOURCES = ("flash_decode", "flash_decode_window", "quant_matmul", "fused_decode_step",
                  "flash_attention", "flash_attention_wgmma")
T_PROMPT_TRAIN, T_FRAMES_TRAIN, TRAIN_STEPS = 16, 1024, 5
HBM_BYTES_PER_S = 3.35e12   # H100 SXM, NVIDIA data sheet
BF16_OPS_PER_S = 989e12     # dense bf16 tensor-core peak, same source
# phase (i), fp32: the chunked route against K4, loss, gradient norm and each
# gradient leaf, relative; the CPU tests hold each leaf to the JAX package so
TRAIN_FP32_LIMIT = 1e-4


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


def device_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean device time of one call of `fn`: every CUDA kernel it launches,
    summed from a CUDA-only torch.profiler trace of `iters` calls (the host's
    launch overhead, which paces back-to-back small calls, is left out)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for i in range(warmup):
        fn(i)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(iters):
            fn(i)
        torch.cuda.synchronize()
    return sum(e.time_range.elapsed_us() for e in prof.events()
               if e.device_type == DeviceType.CUDA) / iters / 1e3


def graph_ms(fn, n: int, reps: int = 20) -> float:
    """Device time of one call of `fn`: CUDA events around `reps` replays of
    a CUDA graph holding fn(0) .. fn(n - 1), so the host's launch pace,
    which paces back-to-back calls of small kernels, stays out of it."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up outside the capture
        for i in range(n):
            fn(i)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(n):
            fn(i)
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / reps / n


def padded_ms(fn, iters: int, warmup: int = 2) -> float:
    """Median device time of one call of `fn`, between CUDA events around it,
    with the stream held by a spin kernel while the host enqueues the call:
    the host's launch pace, which paces back-to-back calls of many small
    kernels, stays out of the time."""
    for i in range(warmup):
        fn(i)
    torch.cuda.synchronize()
    times = []
    for i in range(iters):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(50_000_000)  # about 25 ms at the H100's clock
        start.record()
        fn(i)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def phase_a(dev, card):
    """K1 against its plain version; returns (max_abs_err, timings)."""
    import torch.nn.functional as F

    from parler_tts_tpu_torch.ops.flash_decode import (
        flash_decode_attention,
        flash_decode_attention_plain,
        flash_decode_attention_shares,
        slot_range,
        split_bounds,
        split_count,
    )

    g = torch.Generator(device=dev).manual_seed(0)
    h, dh, n_layers = 16, 64, 24

    def rand(*shape, dtype):
        return (torch.randn(shape, generator=g, device=dev) * 0.3).to(dtype)

    def i32(values):
        return torch.tensor(values, dtype=torch.int32, device=dev)

    # the kernel's checks run at an 860-column run's cache (K_SLOTS) and at
    # the cache the serving phases give it (S_CACHE), each at its split count
    max_err, n_cases = 0.0, 0
    for slots, dtype, b in [(s, t, b) for s in (K_SLOTS, S_CACHE)
                            for t in (torch.float32, torch.bfloat16) for b in (1, BATCH, 4)]:
        cache_k = rand(n_layers, b, slots, h * dh, dtype=dtype)
        cache_v = rand(n_layers, b, slots, h * dh, dtype=dtype)
        k, v = cache_k[5].reshape(b, slots, h, dh), cache_v[5].reshape(b, slots, h, dh)
        zeros = i32([0] * b)
        rows = i32([0, 3, 8, 5][:b])
        n_split = split_count(b, h, slots, 1)
        cases = [(f"limit={n}", rand(b, h, dh, dtype=dtype), k, v, zeros, n, None)
                 for n in (1, 63, 64, 65, 128, 640, slots) if n <= slots]
        # share boundaries on slots 63/64 and 127/128; rows whose shares
        # are all or partly empty; short ranges that start late
        cases += [(f"share edge {e}", rand(b, h, dh, dtype=dtype), k, v, zeros,
                   e * n_split, None) for e in (64, 128) if e * n_split <= slots]
        cases += [
            ("per-row empty shares", rand(b, h, dh, dtype=dtype), k, v, rows,
             i32([slots, 3, 9, 1][:b]), None),
            ("starts 3/5 limit=9", rand(b, h, dh, dtype=dtype), k, v, i32([3, 5, 3, 5][:b]),
             9, None),
        ]
        cases += [
            ("per-row starts", rand(b, h, dh, dtype=dtype), k, v, rows, min(500, slots - 8),
             None),
            ("per-row limits", rand(b, h, dh, dtype=dtype), k, v, rows,
             i32([slots, 64, 300, 9][:b]), None),
            ("W=4 window", rand(b, 4, h, dh, dtype=dtype), k, v, rows, slots - 3, None),
            ("stacked layer 0", rand(b, h, dh, dtype=dtype), cache_k, cache_v, rows,
             min(700, slots - 8), 0),
            ("stacked layer 23", rand(b, h, dh, dtype=dtype), cache_k, cache_v, rows,
             min(700, slots - 8), 23),
            ("stacked 23 limit=S", rand(b, h, dh, dtype=dtype), cache_k, cache_v, rows,
             slots, 23),
            ("empty range", rand(b, h, dh, dtype=dtype), k, v, i32([9] * b), 9, None),
        ]
        for name, q, kk, vv, starts, limit, layer in cases:
            got = flash_decode_attention(q, kk, vv, starts, limit, layer=layer)
            torch.cuda.synchronize()
            splits = split_count(b, h, slots, q.shape[1] if q.dim() == 4 else 1)  # MHA
            want = flash_decode_attention_plain(q, kk, vv, starts, limit, layer=layer,
                                                splits=splits)
            err = (got.float() - want.float()).abs().max().item()
            torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])
            if name == "empty range" and torch.count_nonzero(got).item():
                raise AssertionError("K1 on an empty range must return 0")
            if not torch.equal(flash_decode_attention(q, kk, vv, starts, limit, layer=layer),
                               got):
                raise AssertionError(f"K1 {name}: a second call gave other bits")
            max_err, n_cases = max(max_err, err), n_cases + 1
            print(f"  K1 vs plain {str(dtype)[6:]:8s} S={slots} B={b} {name:20s} "
                  f"splits={splits} max_abs_err={err:.3e}")
        del cache_k, cache_v
    print(f"  {n_cases} cases within fp32 atol 2e-5 rtol 1e-4, bf16 atol 2e-3 rtol 1e-2, "
          f"each against the plain version at the kernel's split count, a second call "
          f"bit-identical")

    # a result that leaves out one slot must fail the fp32 tolerance: the
    # first (start + 1), the last (limit - 1), the last slot of share 3; at
    # both caches
    b, layer = BATCH, 23
    for slots in (K_SLOTS, S_CACHE):
        limit = min(700, slots - 8)
        cache_k = rand(n_layers, b, slots, h * dh, dtype=torch.float32)
        cache_v = rand(n_layers, b, slots, h * dh, dtype=torch.float32)
        q, starts = rand(b, h, dh, dtype=torch.float32), i32([0, 3])
        n_split = split_count(b, h, slots, 1)
        got = flash_decode_attention(q, cache_k, cache_v, starts, limit, layer=layer)
        edges = split_bounds(*slot_range(starts, limit, 1, slots), n_split)
        cut = edges[:, 1:].clone()
        cut[:, 3] -= 1
        dropped = {
            "first slot": flash_decode_attention_plain(q, cache_k, cache_v, starts + 1, limit,
                                                       layer=layer, splits=n_split),
            "last slot": flash_decode_attention_plain(q, cache_k, cache_v, starts, limit - 1,
                                                      layer=layer, splits=n_split),
            "share 3's last slot": flash_decode_attention_shares(
                q, cache_k, cache_v, starts, limit, edges[:, :-1], cut, layer=layer),
        }
        for name, wrong in dropped.items():
            gap = (got - wrong).abs().max().item()
            caught = not torch.allclose(got, wrong, **TOL[torch.float32])
            print(f"  K1 vs a result without the {name} (S={slots}, limit {limit}, {n_split} "
                  f"splits): max_abs_err={gap:.3e}, fails fp32 TOL: {caught}")
            if not caught:
                raise AssertionError(f"fp32 TOL does not see the {name} left out at S={slots}")
        del cache_k, cache_v

    # timing at the main path's shapes: bf16 q and cache, B=2 at 434 slots (the
    # mean decode step of the 860-column run) and 868 (the last), and B=1 at
    # 868; each launch reads another layer of the stacked cache (170 MB, over
    # the 50 MB L2), as the decode loop does. Device time from CUDA-graph
    # replays of 24 launches (and the profiler's kernel sums); the host-paced
    # time of back-to-back calls beside it
    timing = {}
    for b, limit in ((BATCH, K_SLOTS // 2), (1, K_SLOTS), (BATCH, K_SLOTS)):
        cache_k = rand(n_layers, b, K_SLOTS, h * dh, dtype=torch.bfloat16)
        cache_v = rand(n_layers, b, K_SLOTS, h * dh, dtype=torch.bfloat16)
        q = rand(b, h, dh, dtype=torch.bfloat16)
        starts = i32([0] * b)
        q4 = q.view(b, h, 1, dh)
        k_views = [cache_k[i].view(b, K_SLOTS, h, dh)[:, :limit].transpose(1, 2)
                   for i in range(n_layers)]
        v_views = [cache_v[i].view(b, K_SLOTS, h, dh)[:, :limit].transpose(1, 2)
                   for i in range(n_layers)]

        def k1(i):
            return flash_decode_attention(q, cache_k, cache_v, starts, limit,
                                          layer=i % n_layers)

        def sdpa(i):
            return F.scaled_dot_product_attention(q4, k_views[i % n_layers],
                                                  v_views[i % n_layers], scale=1.0)

        kernel_ms, sdpa_ms = graph_ms(k1, n_layers), graph_ms(sdpa, n_layers)
        kernel_dev, sdpa_dev = device_ms(k1, iters=240), device_ms(sdpa, iters=240)
        kernel_paced, sdpa_paced = cuda_ms(k1, iters=480), cuda_ms(sdpa, iters=480)
        plain_ms = cuda_ms(lambda i: flash_decode_attention_plain(
            q, cache_k, cache_v, starts, limit, layer=i % n_layers,
            splits=split_count(b, h, K_SLOTS, 1)), iters=96)
        bytes_moved = 2 * (b * h * dh) * 2 + 2 * b * limit * h * dh * 2  # q, out; k, v
        ops = 4 * b * h * limit * dh
        byte_s, op_s = bytes_moved / HBM_BYTES_PER_S, ops / BF16_OPS_PER_S
        bound_ms, bound_by = max(byte_s, op_s) * 1e3, "bytes" if byte_s >= op_s else "operations"
        print(f"  K1 {kernel_ms * 1e3:.2f} us device time (graph replay; profiler "
              f"{kernel_dev * 1e3:.2f}; {kernel_paced * 1e3:.2f} paced by the host), SDPA "
              f"{sdpa_ms * 1e3:.2f} us ({sdpa_dev * 1e3:.2f}; {sdpa_paced * 1e3:.2f}), K1 faster "
              f"than SDPA: {kernel_ms < sdpa_ms}; plain {plain_ms * 1e3:.2f} us; bound "
              f"{bound_ms * 1e3:.2f} us ({bound_by}: {bytes_moved / 1e6:.2f} MB, "
              f"{bound_ms / kernel_ms:.1%} of it) per call at B={b}, bf16, {limit} slots, "
              f"{split_count(b, h, K_SLOTS, 1)} splits ({card})")
        timing = dict(ms=kernel_ms, plain_ms=plain_ms, library_ms=sdpa_ms, bound_ms=bound_ms,
                      bound_by=bound_by, device_ms=kernel_dev, library_device_ms=sdpa_dev,
                      paced_ms=kernel_paced, library_paced_ms=sdpa_paced)
        del cache_k, cache_v, k_views, v_views
    return max_err, timing  # the last row: B=2, 868 slots


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
    """mini-v1 served end to end; returns K1's launches on the main path, the
    pipeline and its MAX_LENGTH-column output (phase j serves them from disk)."""
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
    del warm
    torch.cuda.empty_cache()
    return launches, pipe, out


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


def phase_c(dev, card, config=None):
    """One fp32 decode step of mini-v1 (or `config`) through K1 vs the dense
    attention path."""
    from parler_tts_tpu_torch.config import GenerationConfig, mini_v1_config
    from parler_tts_tpu_torch.models.decoder import DecoderCache
    from parler_tts_tpu_torch.ops.masks import causal_self_attention_bias
    from parler_tts_tpu_torch.runtime.pipeline import ParlerTTSPipeline

    pipe = ParlerTTSPipeline.from_random(config or mini_v1_config(), seed=1,
                                         generation_config=GenerationConfig(), device=dev,
                                         dtype=torch.float32, cache_dtype=torch.float32)
    model, dcfg = pipe.model, pipe.config.decoder
    desc, desc_mask, prompt, prompt_mask = (torch.as_tensor(x, device=dev)
                                            for x in request_ids(1))
    g = torch.Generator(device=dev).manual_seed(1)
    n_pre = K_COLUMNS // 2  # prefill the prompt and half the columns, then decode the next one
    cols = torch.randint(0, dcfg.pad_token_id, (BATCH, dcfg.num_codebooks, n_pre + 1),
                         generator=g, device=dev)
    with torch.inference_mode():
        enc = model.encode_description(desc, desc_mask)
        cache = DecoderCache.zeros(dcfg, BATCH, K_SLOTS, enc.shape[1], torch.float32, dev)
        cache.cross_k, cache.cross_v = model.decoder.precompute_cross_kv(enc)
        kv_valid = torch.cat([prompt_mask.bool(),
                              torch.ones(BATCH, K_COLUMNS, dtype=torch.bool, device=dev)], 1)
        pos = torch.arange(K_SLOTS, device=dev)[None].expand(BATCH, -1)
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
    print(f"  {dcfg.num_hidden_layers} x {dcfg.hidden_size} decode step at position {t}: logits "
          f"{tuple(with_k1.shape)}, K1 vs dense "
          f"max_abs_err={err:.3e} (tolerance atol 2e-4 rtol 2e-4, fp32, TF32 off) ({card})")
    torch.testing.assert_close(with_k1, dense, **LOGITS_TOL)
    del pipe, model, cache
    torch.cuda.empty_cache()


# ---------------------------------------------------------------- int8 side
K2_SHAPES = ((1024, 1024), (1024, 4096), (4096, 1024))  # q/k/v/out/cross q/out, fc1, fc2
K2_PER_LAYER = (6, 1, 1)                                # launches of each shape per layer
INT8_OPS_PER_S = 1979e12    # dense int8 tensor-core peak, NVIDIA data sheet


def k2_check(x, w, s, label):
    """K2 on (x, w, s) against its plain version: within k2_close, of x's
    dtype, the same bits on a second call, and a result that left out the
    cluster's last K slice outside k2_close. Returns (max abs error, slices,
    rows per slice)."""
    from parler_tts_tpu_torch.ops.quant_matmul import (
        k2_close,
        k2_grid,
        quant_matmul,
        quant_matmul_plain,
    )

    slices, slice_ = k2_grid(*x.shape, w.shape[1])
    got = quant_matmul(x, w, s)
    torch.cuda.synchronize()
    want = quant_matmul_plain(x, w, s)
    err = (got.float() - want.float()).abs().max().item()
    if got.dtype != x.dtype or not k2_close(got, want):
        raise AssertionError(f"{label}: error {err:.3e} (max |y| "
                             f"{want.float().abs().max().item():.1f})")
    if not torch.equal(quant_matmul(x, w, s), got):
        raise AssertionError(f"{label}: a second call gave other bits")
    dropped = x.clone()
    dropped[:, (slices - 1) * slice_:] = 0
    if k2_close(quant_matmul_plain(dropped, w, s), want):
        raise AssertionError(f"{label}: k2_close misses a dropped K slice")
    return err, slices, slice_


def phase_d(dev, card):
    """K2 against its plain version; times it over 24 layers' weights per shape."""
    from parler_tts_tpu_torch.ops.quant_matmul import quant_matmul, quant_matmul_plain

    g = torch.Generator(device=dev).manual_seed(4)

    def int8(*shape):
        return torch.randint(-127, 128, shape, generator=g, device=dev,
                             dtype=torch.int32).to(torch.int8)

    def scales(n):  # the CPU test's range
        return torch.rand(n, generator=g, device=dev) * 0.009 + 1e-3

    max_err, n_cases = 0.0, 0
    # decode B=1 and B=2, B=1 prefill (8 + 1 rows), B=1 cross kv (16), B=2
    # prefill, the speculative window B x W at B=1, B=2 cross kv, B x W at B=2
    for m in (1, BATCH, 9, 16, 18, 24, 32, 48):
        # N = 1040: a multiple of 16 that leaves the last 64-column strip ragged
        for k, n in K2_SHAPES + ((1024, 1040),):
            w, s = int8(k, n), scales(n)
            for dtype in (torch.float32, torch.bfloat16):
                x = (torch.randn(m, k, generator=g, device=dev) * 0.3).to(dtype)
                err, slices, slice_ = k2_check(x, w, s, f"K2 {str(dtype)[6:]} M={m} K={k} N={n}")
                max_err, n_cases = max(max_err, err), n_cases + 1
                print(f"  K2 vs plain {str(dtype)[6:]:8s} M={m:2d} K={k} N={n} "
                      f"{slices} x {slice_}-row slices max_abs_err={err:.3e}")
    print(f"  {n_cases} cases within 1e-6 x max|y| + 1e-5 x |y| (bf16: or one bf16 ulp), a "
          f"second call bit-identical, a dropped K slice outside it")

    # timing at the decode shapes (M=2, bf16 x): each launch reads another
    # layer's weights (24 layers, 352 MB in all, beyond the 50 MB L2)
    totals = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bytes=0, ops=0)
    for (k, n), per_layer in zip(K2_SHAPES, K2_PER_LAYER):
        ws = [int8(k, n) for _ in range(24)]
        ss = [scales(n) for _ in range(24)]
        deq = [w.to(torch.bfloat16) for w in ws]  # the yardstick's pre-dequantized weights
        x = torch.randn(BATCH, k, generator=g, device=dev).to(torch.bfloat16)
        kernel_ms = device_ms(lambda i: quant_matmul(x, ws[i % 24], ss[i % 24]), iters=240)
        paced_ms = cuda_ms(lambda i: quant_matmul(x, ws[i % 24], ss[i % 24]), iters=480)
        plain_ms = device_ms(lambda i: quant_matmul_plain(x, ws[i % 24], ss[i % 24]), iters=96)
        lib_ms = device_ms(lambda i: torch.matmul(x, deq[i % 24]), iters=240)
        lib_paced_ms = cuda_ms(lambda i: torch.matmul(x, deq[i % 24]), iters=480)
        bytes_moved = k * n + BATCH * k * 2 + n * 4 + BATCH * n * 2
        ops = 2 * BATCH * k * n
        bound_ms = max(bytes_moved / HBM_BYTES_PER_S, ops / INT8_OPS_PER_S) * 1e3
        print(f"  K2 M={BATCH} K={k} N={n}: {kernel_ms * 1e3:.2f} us device time "
              f"({paced_ms * 1e3:.2f} us per call when the host paces back-to-back calls), "
              f"plain {plain_ms * 1e3:.2f} us, bf16 matmul {lib_ms * 1e3:.2f} us "
              f"({lib_paced_ms * 1e3:.2f} us paced by the host), bound "
              f"{bound_ms * 1e3:.2f} us (bytes: {bytes_moved / 1e6:.2f} MB) ({card})")
        for key, value in (("ms", kernel_ms), ("plain_ms", plain_ms), ("library_ms", lib_ms),
                           ("bytes", bytes_moved), ("ops", ops)):
            totals[key] += per_layer * value
        del ws, deq
    byte_s, op_s = totals["bytes"] / HBM_BYTES_PER_S, totals["ops"] / INT8_OPS_PER_S
    timing = dict(ms=totals["ms"], plain_ms=totals["plain_ms"], library_ms=totals["library_ms"],
                  bound_ms=max(byte_s, op_s) * 1e3,
                  bound_by="bytes" if byte_s >= op_s else "operations")

    # the second way: one decode layer's 8 launches over 24 layers' own
    # weights (336 MB of int8) in a CUDA graph, events around its replays
    layers = [[(int8(k, n), scales(n)) for (k, n), per in zip(K2_SHAPES, K2_PER_LAYER)
               for _ in range(per)] for _ in range(24)]
    xs = {k: torch.randn(BATCH, k, generator=g, device=dev).to(torch.bfloat16)
          for k in (1024, 4096)}

    def k2_layer(i):
        for w, s in layers[i]:
            quant_matmul(xs[w.shape[0]], w, s)

    timing["graph_ms"] = graph_ms(k2_layer, 24)
    deq = [[w.to(torch.bfloat16) for w, _ in layer] for layer in layers]
    del layers

    def mm_layer(i):
        for w in deq[i]:
            torch.matmul(xs[w.shape[0]], w)

    timing["library_graph_ms"] = graph_ms(mm_layer, 24)
    del deq
    print(f"  K2, one decode layer's 8 launches at M={BATCH}: {timing['ms'] * 1e3:.2f} us device "
          f"time (profiler), {timing['graph_ms'] * 1e3:.2f} us (graph replay over 24 layers); "
          f"bf16 matmul {timing['library_ms'] * 1e3:.2f} / "
          f"{timing['library_graph_ms'] * 1e3:.2f} us; K2 faster: "
          f"{timing['ms'] < timing['library_ms']} / "
          f"{timing['graph_ms'] < timing['library_graph_ms']}; plain "
          f"{timing['plain_ms'] * 1e3:.2f} us, bound {timing['bound_ms'] * 1e3:.2f} us "
          f"({timing['bound_ms'] / timing['ms']:.1%} of it) ({card})")
    return max_err, timing


def serve(pipe, request, label, card):
    """One timed generate_codes + decode_codes of `request`; returns
    (output, generate seconds, decode seconds, audio, lengths)."""
    import numpy as np

    t0 = time.perf_counter()
    out = pipe.generate_codes(*request, seed=0)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    audio, lengths = pipe.decode_codes(out.codes, out.lengths)
    t2 = time.perf_counter()
    cfg = pipe.config
    decode_steps = out.steps - 2
    frames = pipe.generation_config.max_length - cfg.decoder.num_codebooks
    audio_s = frames * cfg.audio_encoder.hop_length / cfg.sampling_rate
    b = audio.shape[0]
    print(f"  {label}: audio {tuple(audio.shape)} finite={bool(np.isfinite(audio).all())}; "
          f"generate_codes {t1 - t0:.3f} s ({decode_steps / (t1 - t0):.1f} decode steps/s), "
          f"decode_codes {t2 - t1:.3f} s; {audio_s:.2f} s of audio -> real-time factor "
          f"{(t2 - t0) / audio_s:.4f} at B={b} ({card})")
    if out.steps != pipe.generation_config.max_length:
        raise AssertionError(f"{label}: expected {pipe.generation_config.max_length} columns, "
                             f"got {out.steps}")
    if not np.isfinite(audio).all() or (lengths != frames * cfg.audio_encoder.hop_length).any():
        raise AssertionError(f"{label}: bad audio {audio.shape} or lengths {lengths}")
    return out, t1 - t0, t2 - t1


def profile_steps(pipe, request, columns):
    """(kernels per decode step, device-busy ms per decode step, busy us by
    kernel name) from a CUDA-only profile of `request` over `columns`
    columns, prefill included."""
    import dataclasses
    from collections import defaultdict

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from parler_tts_tpu_torch.runtime.pipeline import ParlerTTSPipeline

    gen = dataclasses.replace(pipe.generation_config, max_length=columns,
                              min_new_tokens=columns)
    short = ParlerTTSPipeline(pipe.model, pipe.dac, gen, cache_dtype=pipe.cache_dtype,
                              device=pipe.device, fused_decode=pipe.fused is not None)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = short.generate_codes(*request)
        torch.cuda.synchronize()
    steps = out.steps - 2
    by_name, count = defaultdict(float), 0
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] += e.time_range.elapsed_us()
            count += 1
    return count / steps, sum(by_name.values()) / steps / 1e3, by_name


def phase_e(dev, card):
    """mini-v1 with int8 weights over K2, B=2; returns K2's launches and the
    delayed ids."""
    import dataclasses

    from parler_tts_tpu_torch.config import GenerationConfig, mini_v1_config
    from parler_tts_tpu_torch.ops.flash_decode import flash_decode_attention
    from parler_tts_tpu_torch.ops.quant_matmul import quant_matmul
    from parler_tts_tpu_torch.runtime.pipeline import ParlerTTSPipeline

    gen = GenerationConfig(max_length=MAX_LENGTH, min_new_tokens=MAX_LENGTH, do_sample=False,
                           codebook_guard=1024)
    t0 = time.perf_counter()
    pipe = ParlerTTSPipeline.from_random(mini_v1_config(), seed=0, generation_config=gen,
                                         device=dev, dtype=torch.bfloat16,
                                         cache_dtype=torch.bfloat16, weight_quant=True)
    torch.cuda.synchronize()
    print(f"  mini-v1 int8 initialised and quantized on the card: "
          f"{time.perf_counter() - t0:.2f} s")
    request = request_ids(0)
    warm = ParlerTTSPipeline(pipe.model, pipe.dac, dataclasses.replace(
        gen, max_length=40, min_new_tokens=40), cache_dtype=torch.bfloat16, device=dev)
    warm.decode_codes(*warm.generate_codes(*request)[1:3])
    torch.cuda.synchronize()

    quant_matmul.launches = flash_decode_attention.launches = 0
    out, gen_s, _ = serve(pipe, request, "int8 serve", card)
    k2, k1 = quant_matmul.launches, flash_decode_attention.launches
    n_layers = pipe.config.decoder.num_hidden_layers
    decode_steps = out.steps - 2
    want_k2 = 8 * n_layers * (decode_steps + 1) + 2 * n_layers
    print(f"  K2 launches {k2} = 192 x ({decode_steps} decode steps + prefill) + 48 cross-kv: "
          f"{k2 == want_k2}; K1 launches {k1} = 24 x {decode_steps}: "
          f"{k1 == n_layers * decode_steps}")
    if k2 != want_k2 or k1 != n_layers * decode_steps:
        raise AssertionError(f"launches: K2 {k2} (want {want_k2}), K1 {k1}")
    per_step, busy_ms, by_name = profile_steps(pipe, request, PROFILE_COLUMNS)
    k2_ms, k1_ms = (sum(v for k, v in by_name.items() if name in k) / (PROFILE_COLUMNS - 2) / 1e3
                    for name in ("quant_matmul_kernel", "flash_decode_kernel"))
    wall_ms = gen_s / decode_steps * 1e3
    print(f"  int8 profile over {PROFILE_COLUMNS} columns: {per_step:.0f} kernels per decode "
          f"step, device busy {busy_ms:.3f} ms per step (K2 {k2_ms:.3f} ms, K1 {k1_ms:.3f} ms), "
          f"unprofiled wall {wall_ms:.3f} ms per step: device idle {1 - busy_ms / wall_ms:.1%} "
          f"({card})")
    del pipe, warm
    torch.cuda.empty_cache()
    int8_decode_step_logits(dev, card)
    return k2, out.delayed_ids


def norm_rel(got, want) -> float:
    return ((got.float() - want.float()).norm() / want.float().norm()).item()


def plain_f64(x, w_q, scale):
    """K2's plain version summing in float64: the same function as
    `quant_matmul_plain`, with the sums rounded in another way."""
    y = x.to(torch.bfloat16).double() @ w_q.double()
    return (y * scale.double()[None, :]).to(x.dtype)


def int8_decode_step_logits(dev, card):
    """One fp32 int8 mini-v1 decode step with K2 against the same step with
    QuantDense over K2's plain version (substituted here, for the check only).

    Every projection rounds its input to bf16, so a last-bit difference in an
    fp32 sum moves some of those roundings, and 24 layers carry the change
    to the logits. The tolerance is 4 x what that noise alone does: the gap
    between the plain version and the plain version summing in float64."""
    import parler_tts_tpu_torch.models.decoder as decoder_module
    from parler_tts_tpu_torch.config import GenerationConfig, mini_v1_config
    from parler_tts_tpu_torch.models.decoder import DecoderCache
    from parler_tts_tpu_torch.ops.masks import causal_self_attention_bias
    from parler_tts_tpu_torch.ops.quant_matmul import quant_matmul_plain
    from parler_tts_tpu_torch.runtime.pipeline import ParlerTTSPipeline

    pipe = ParlerTTSPipeline.from_random(mini_v1_config(), seed=1,
                                         generation_config=GenerationConfig(), device=dev,
                                         dtype=torch.float32, cache_dtype=torch.float32,
                                         weight_quant=True)
    model, dcfg = pipe.model, pipe.config.decoder
    desc, desc_mask, prompt, prompt_mask = (torch.as_tensor(x, device=dev)
                                            for x in request_ids(1))
    g = torch.Generator(device=dev).manual_seed(1)
    n_pre = K_COLUMNS // 2
    cols = torch.randint(0, 1024, (BATCH, dcfg.num_codebooks, n_pre + 1), generator=g,
                         device=dev)
    kv_valid = torch.cat([prompt_mask.bool(),
                          torch.ones(BATCH, K_COLUMNS, dtype=torch.bool, device=dev)], 1)
    pos = torch.arange(K_SLOTS, device=dev)[None].expand(BATCH, -1)
    starts = (S_PROMPT - prompt_mask.sum(1)).to(torch.int32)
    t = S_PROMPT + n_pre

    def decode_step():
        with torch.inference_mode():
            enc = model.encode_description(desc, desc_mask)
            cache = DecoderCache.zeros(dcfg, BATCH, K_SLOTS, enc.shape[1], torch.float32, dev)
            cache.cross_k, cache.cross_v = model.decoder.precompute_cross_kv(enc)
            pre = torch.cat([model.prompt_hidden(prompt),
                             model.decoder.embed_ids(cols[:, :, :n_pre])], dim=1)
            model.decoder(pre, pos[:, :t], self_attn_bias=causal_self_attention_bias(
                pos[:, :t], kv_valid), cross_attn_bias=None, cache=cache)
            return model.decoder(model.decoder.embed_ids(cols[:, :, n_pre:]), pos[:, t:t + 1],
                                 self_attn_bias=None, cross_attn_bias=None, cache=cache,
                                 decode_lengths=(starts, t + 1))

    with_k2 = decode_step()
    kernel = decoder_module.quant_matmul
    try:
        decoder_module.quant_matmul = quant_matmul_plain
        plain = decode_step()
        decoder_module.quant_matmul = plain_f64
        plain64 = decode_step()
    finally:
        decoder_module.quant_matmul = kernel
    err, noise = norm_rel(with_k2, plain), norm_rel(plain64, plain)
    print(f"  int8 fp32 decode step at position {t}: logits {tuple(with_k2.shape)}, K2 vs plain "
          f"norm-rel {err:.3e}, max abs {(with_k2 - plain).abs().max().item():.3e}; plain vs "
          f"plain summing in float64 {noise:.3e}; tolerance 4 x that ({card})")
    if err > 4 * noise:
        raise AssertionError(f"int8 decode step: K2 vs plain {err:.3e} > 4 x {noise:.3e}")
    del pipe, model
    torch.cuda.empty_cache()


# -------------------------------------------------------------- fused side
def phase_f(dev, card):
    """K3 against its plain version at mini-v1 shapes, slice by slice within
    the limits `fused_limits` sets from this run's fp32-vs-float64 noise, at
    the main cases, the chunk and ownership edges and S_enc 33; dropped-row
    and dropped-fc2 negative checks; 200 repeats bit for bit; bounds as
    device tensors; K3, its stripped variants (stream only, chain only) and
    its plain version timed. Returns (max abs error, largest norm-relative
    gap, timing)."""
    import dataclasses

    from parler_tts_tpu_torch.config import mini_v1_decoder_config
    from parler_tts_tpu_torch.models.decoder import ParlerDecoder
    from parler_tts_tpu_torch.models.layers import init_weights
    from parler_tts_tpu_torch.ops.fused_decode_step import (
        CUDA_CHUNK,
        K3_FLOOR,
        K3_NOISE_FACTOR,
        fused_close,
        fused_decode_layers,
        fused_decode_layers_plain,
        fused_decode_variant,
        fused_gaps,
        fused_limits,
        launch_plan,
        prepare_fused_params,
    )

    cfg = mini_v1_decoder_config()
    g = torch.Generator(device=dev).manual_seed(5)
    decoder = ParlerDecoder(cfg, device=dev, dtype=torch.bfloat16)
    init_weights(decoder, g)
    fp = prepare_fused_params(decoder)
    del decoder
    n_layers, d, s_enc = cfg.num_hidden_layers, cfg.hidden_size, 16

    def bf16(*shape):
        return (torch.randn(shape, generator=g, device=dev) * 0.5).to(torch.bfloat16)

    cache_k, cache_v = bf16(n_layers, K_SLOTS, d), bf16(n_layers, K_SLOTS, d)
    whole = (cache_k, cache_v)
    served = (bf16(n_layers, S_CACHE, d), bf16(n_layers, S_CACHE, d))  # the serving phases'
    cross_k, cross_v, x = bf16(n_layers, s_enc, d), bf16(n_layers, s_enc, d), bf16(1, d)
    enc_bias = torch.zeros(1, s_enc, device=dev)
    enc_bias[0, 12:] = torch.finfo(torch.float32).min  # 4 masked encoder positions
    cross = (cross_k, cross_v, enc_bias)
    # S_enc 33: two groups of 32 encoder rows, the second of one row; 5 masked
    bias33 = torch.zeros(1, 33, device=dev)
    bias33[0, 28:] = torch.finfo(torch.float32).min
    cross33 = (bf16(n_layers, 33, d), bf16(n_layers, 33, d), bias33)
    plan = launch_plan(cfg)
    print(f"  launch: {plan['blocks']} persistent blocks of {plan['threads']} threads (consumer "
          f"warps and a producer warp), a weight ring of {plan['stages']} x "
          f"{plan['stage_bytes']} B stages, {plan['chunk']}-row self-attention chunks")
    if plan["chunk"] != CUDA_CHUNK:
        raise AssertionError(f"kernel chunk {plan['chunk']} != CUDA_CHUNK {CUDA_CHUNK}")

    def args(start, n_rows, params=fp, enc=cross, cache=whole):
        return (cfg, params, x, *cache, *enc, start, n_rows)

    def plain(start, n_rows, enc=cross, cache=whole, **kw):  # at the kernel's tiling
        return fused_decode_layers_plain(*args(start, n_rows, enc=enc, cache=cache),
                                         block_s=CUDA_CHUNK, tiling="cuda", **kw)

    def show(gaps):  # layers 0-3, the largest of layers 4 .. L-1, the hidden state
        return (" ".join(f"{v:.2e}" for v in gaps[:4].tolist())
                + f" | {gaps[4:-1].max().item():.2e} | {gaps[-1].item():.2e}")

    def verdict(gaps, limits):  # (worst slice / its limit, median at slice 1 / its limit)
        gaps = gaps.reshape(-1, gaps.shape[-1])
        return ((gaps / limits[0]).max().item(), gaps[:, 1].median().item() / limits[1])

    def run(cases):
        """K3, its plain version and the plain version's fp32-vs-float64
        noise over `cases`, each (start, n_rows, cross inputs, cache), keyed
        (start, n_rows, S_enc, cache slots)."""
        got, want, noise = {}, {}, {}
        for start, n_rows, enc, cache in cases:
            case = (start, n_rows, len(enc[2][0]), cache[0].shape[1])
            got[case] = fused_decode_layers(*args(start, n_rows, enc=enc, cache=cache))
            torch.cuda.synchronize()
            want[case] = plain(start, n_rows, enc=enc, cache=cache)
            noise[case] = fused_gaps(plain(start, n_rows, enc=enc, cache=cache,
                                           dtype=torch.float64), want[case])
        return got, want, noise

    main = [(start, n_rows, cross, whole) for start in (0, 3)
            for n_rows in (1, 64, 65, 434, 867)]
    # chunk edges (32 and 33 rows from start), n_rows = start + 1, and the
    # self-attention items' ownership edge: 16 heads x 8 chunks fill fewer
    # than 132 blocks' first warps, 16 x 9 wrap onto second warps; then 33
    # encoder rows (a second group of one row)
    edges = [(s, n, cross, whole) for s, n in ((0, 32), (0, 33), (3, 35), (3, 36), (3, 4),
                                                 (0, 256), (0, 257))]
    edges += [(s, n, cross33, whole) for s, n in ((0, 1), (3, 65), (0, 434), (3, 867))]
    # the cache the serving phases give K3 (S_CACHE slots; row 1's prompt
    # starts at 3), its mean and last decode steps
    long_served = [(s, n) for s in (0, 3) for n in (S_CACHE // 2, S_CACHE - 1)]
    at_served = [(s, n, cross, served) for s, n in [(0, 1), (3, 65)] + long_served]
    got, want, noise = run(main + edges + at_served)
    # one set of limits from the noise over every case held, as in the CPU tests
    all_noise = torch.stack(list(noise.values()))
    limits = fused_limits(all_noise)
    print(f"  slices: layer 0-3 | largest of layers 4-{n_layers - 1} | hidden; norm-relative; "
          f"case (start, n_rows, S_enc)")
    print(f"  limit in every case = {K3_NOISE_FACTOR:g} x max(largest plain fp32 vs float64 "
          f"noise over the {len(noise)} cases, {K3_FLOOR:.2e}): {show(limits[0])}")
    print(f"  limit of the median over the cases at layer 1 = {K3_NOISE_FACTOR:g} x max(median "
          f"noise there {all_noise[:, 1].median().item():.2e}, {K3_FLOOR:.2e}) = {limits[1]:.2e}")
    max_abs, gaps = 0.0, []
    for case in got:
        gaps.append(fused_gaps(got[case], want[case]))
        abs_err = max((a.float() - b.float()).abs().max().item()
                      for a, b in zip(got[case], want[case]))
        max_abs = max(max_abs, abs_err)
        line = (f"  K3 vs plain {case}: {show(gaps[-1])}; max abs {abs_err:.3e}\n"
                f"    plain fp32 vs float64: {show(noise[case])}")
        if case[2:] == (s_enc, K_SLOTS) and case[:2] in {c[:2] for c in main}:
            tiling = fused_gaps(fused_decode_layers_plain(*args(*case[:2]), block_s=64),
                                want[case])
            line += f"\n    plain at the Pallas tiling (block_s=64): {show(tiling)}"
        print(line)
    gaps = torch.stack(gaps)
    worst, median = verdict(gaps, limits)
    print(f"  K3: worst slice {worst:.2f} x its limit, median at layer 1 {median:.2f} x its limit")
    if not fused_close(gaps, limits):
        raise AssertionError(f"K3 exceeds its limits: worst slice {worst:.2f} x, median at "
                             f"layer 1 {median:.2f} x")
    want_served = {case[:2]: out for case, out in want.items() if case[3] == S_CACHE}
    want = {case[:2]: out for case, out in want.items() if case[2:] == (s_enc, K_SLOTS)}
    # negative checks: a kernel that dropped a cache row at either end of the
    # range, or a layer's fc2, must fail the main cases' limits
    no_fc2 = dataclasses.replace(fp, sfc2=fp.sfc2.clone())
    no_fc2.sfc2[12] = 0.0
    want[(0, 8)] = plain(0, 8)
    long = [(s, n) for s, n, *_ in main if n >= 434]
    broken = {
        "row 0 dropped at n_rows=8": [(fused_decode_layers(*args(1, 8)), want[(0, 8)])],
        "row 7 dropped at n_rows=8": [(fused_decode_layers(*args(0, 7)), want[(0, 8)])],
        "first row dropped at n_rows 434 and 867, starts 0 and 3":
            [(fused_decode_layers(*args(s + 1, n)), want[(s, n)]) for s, n in long],
        "last row dropped at n_rows 434 and 867, starts 0 and 3":
            [(fused_decode_layers(*args(s, n - 1)), want[(s, n)]) for s, n in long],
        f"first and last row dropped at the served {S_CACHE}-slot cache, n_rows "
        f"{S_CACHE // 2} and {S_CACHE - 1}, starts 0 and 3":
            [(fused_decode_layers(*args(s + 1, n, cache=served)), want_served[(s, n)])
             for s, n in long_served]
            + [(fused_decode_layers(*args(s, n - 1, cache=served)), want_served[(s, n)])
               for s, n in long_served],
        "layer 12's fc2 dropped at n_rows=434":
            [(fused_decode_layers(*args(0, 434, no_fc2)), want[(0, 434)])],
    }
    passed_broken = []
    for label, pairs in broken.items():
        broken_gaps = torch.stack([fused_gaps(out, ref) for out, ref in pairs])
        worst_b, median_b = verdict(broken_gaps, limits)
        print(f"  negative check, {label}: worst slice {worst_b:.2f} x its limit, median at "
              f"layer 1 {median_b:.2f} x its limit")
        if fused_close(broken_gaps, limits):
            passed_broken.append(label)
    if passed_broken:
        raise AssertionError(f"a broken K3 passes the limits: {passed_broken}")

    # 200 back-to-back launches give the first one's bits (a missing fence or
    # a counter left behind shows here); bounds as () int32 device tensors
    # give the bits of the same bounds as ints
    first = fused_decode_layers(*args(3, 867))
    differ = [i for i in range(1, 200)
              if not all(torch.equal(a, b) for a, b in zip(fused_decode_layers(*args(3, 867)),
                                                           first))]
    print(f"  200 launches at start=3 n_rows=867: {200 - len(differ)} bit-identical to the first")
    if differ:
        raise AssertionError(f"K3 repeats differ from the first launch at {differ[:10]}")

    def i32(v):
        return torch.tensor(v, dtype=torch.int32, device=dev)

    for case in ((3, 867), (0, 65), (3, 4), (0, 1)):
        by_int = fused_decode_layers(*args(*case))
        by_tensor = fused_decode_layers(*args(i32(case[0]), i32(case[1])))
        if not all(torch.equal(a, b) for a, b in zip(by_int, by_tensor)):
            raise AssertionError(f"K3 with device bounds {case} differs from int bounds")
    print("  bounds as () int32 device tensors: the bits of int bounds at (3, 867), (0, 65), "
          "(3, 4), (0, 1)")

    # K3 and its variants by CUDA-graph replay (bounds on the device), as K1
    # is timed, and by the profiler's kernel sums beside; the plain version by
    # the profiler
    timing, graph_error = {}, None
    for n_rows in (434, 867):  # the mean and the last decode step of 860 columns
        bounds = (i32(3), i32(n_rows))
        runs = {"": lambda i: fused_decode_layers(*args(*bounds)),
                "stream_only_": lambda i: fused_decode_variant("stream", *args(*bounds)),
                "chain_only_": lambda i: fused_decode_variant("chain", *args(*bounds))}
        t = {}
        for key, fn in runs.items():
            t[f"{key}device_ms"] = device_ms(fn, iters=50)
            if graph_error is None:
                try:
                    t[f"{key}ms"] = graph_ms(fn, n=10)
                except Exception as e:  # noqa: BLE001 - the capture error is the finding
                    graph_error = f"{type(e).__name__}: {e}"[:300]
                    torch.cuda.synchronize()
            t.setdefault(f"{key}ms", t[f"{key}device_ms"])
        plain_ms = device_ms(lambda i: plain(3, n_rows), iters=3, warmup=1)
        weights = fp.w_attn.numel() + fp.wfc1.numel() + fp.wfc2.numel()
        small = 4 * (fp.s_attn.numel() + fp.sfc1.numel() + fp.sfc2.numel() + 6 * n_layers * d)
        rows = n_rows - 3
        bytes_moved = (weights + small + 2 * n_layers * rows * d * 2 + 2 * n_layers * s_enc * d * 2
                       + s_enc * 4 + d * 2 * 2 + 2 * n_layers * d * 2)
        ops = 2 * weights + 4 * n_layers * (rows + 1 + s_enc) * d
        byte_s, op_s = bytes_moved / HBM_BYTES_PER_S, ops / INT8_OPS_PER_S
        timing[n_rows] = dict(t, plain_ms=plain_ms, library_ms=None,
                              bound_ms=max(byte_s, op_s) * 1e3,
                              bound_by="bytes" if byte_s >= op_s else "operations")
        t = timing[n_rows]
        how = "CUDA-graph replay of 10 launches" if graph_error is None else "the profiler"
        print(f"  K3 24 layers, {n_rows} cache rows, by {how}: {t['ms']:.4f} ms; stream only "
              f"{t['stream_only_ms']:.4f} ms, chain only {t['chain_only_ms']:.4f} ms; by the "
              f"profiler's kernel sums {t['device_ms']:.4f} / {t['stream_only_device_ms']:.4f} / "
              f"{t['chain_only_device_ms']:.4f} ms; plain {plain_ms:.2f} ms; bound "
              f"{t['bound_ms']:.4f} ms ({t['bound_by']}: {bytes_moved / 1e6:.1f} MB) ({card})")
    if graph_error:
        print(f"  K3 does not capture into a CUDA graph: {graph_error}")
    del fp, cache_k, cache_v, whole, served
    torch.cuda.empty_cache()
    out = dict(timing[434], graph_error=graph_error)  # the mean decode step of 860 columns
    out.update({f"{k}_867": v for k, v in timing[867].items()
                if k.endswith("ms") and k != "library_ms"})
    return max_abs, gaps.max().item(), out


def phase_g(dev, card):
    """mini-v1 served at B=1 through K3 (fused_decode=True), beside the eager
    bf16 path on the same request; returns K3's launches and the delayed ids."""
    import dataclasses

    from parler_tts_tpu_torch.config import GenerationConfig, mini_v1_config
    from parler_tts_tpu_torch.ops.flash_decode import flash_decode_attention
    from parler_tts_tpu_torch.ops.fused_decode_step import fused_decode_layers
    from parler_tts_tpu_torch.ops.quant_matmul import quant_matmul
    from parler_tts_tpu_torch.runtime.pipeline import ParlerTTSPipeline

    gen = GenerationConfig(max_length=MAX_LENGTH, min_new_tokens=MAX_LENGTH, do_sample=False,
                           codebook_guard=1024)
    eager = ParlerTTSPipeline.from_random(mini_v1_config(), seed=0, generation_config=gen,
                                          device=dev, dtype=torch.bfloat16,
                                          cache_dtype=torch.bfloat16)
    t0 = time.perf_counter()
    fused = ParlerTTSPipeline(eager.model, eager.dac, gen, cache_dtype=torch.bfloat16,
                              device=dev, fused_decode=True)
    torch.cuda.synchronize()
    print(f"  prepare_fused_params (quantize + stack 24 layers on the card): "
          f"{time.perf_counter() - t0:.2f} s")
    # row 1 of phase (b)'s request: its prompt is left-padded, so K3's start is 3
    request = tuple(x[1:2] for x in request_ids(0))
    short = dataclasses.replace(gen, max_length=40, min_new_tokens=40)
    for pipe in (fused, eager):
        warm = ParlerTTSPipeline(pipe.model, pipe.dac, short, cache_dtype=torch.bfloat16,
                                 device=dev, fused_decode=pipe.fused is not None)
        warm.decode_codes(*warm.generate_codes(*request)[1:3])
    torch.cuda.synchronize()

    fused_decode_layers.launches = flash_decode_attention.launches = quant_matmul.launches = 0
    out, gen_s, _ = serve(fused, request, "fused B=1 serve", card)
    k3 = fused_decode_layers.launches
    decode_steps = out.steps - 2
    print(f"  K3 launches {k3} = 1 x {decode_steps} decode steps: {k3 == decode_steps} "
          f"(K1 {flash_decode_attention.launches}, K2 {quant_matmul.launches})")
    if k3 != decode_steps or flash_decode_attention.launches or quant_matmul.launches:
        raise AssertionError(f"fused path launches: K3 {k3}, want {decode_steps}")
    rows = {}
    for label, pipe, wall_s in (("fused", fused, gen_s),
                                ("eager bf16", eager, serve(eager, request, "eager B=1 serve",
                                                            card)[1])):
        per_step, busy_ms, by_name = profile_steps(pipe, request, PROFILE_COLUMNS)
        wall_ms = wall_s / decode_steps * 1e3
        rows[label] = busy_ms
        print(f"  {label} B=1: {decode_steps / wall_s:.1f} decode steps/s, {per_step:.0f} "
              f"kernels per decode step, device busy {busy_ms:.3f} ms per step (profile over "
              f"{PROFILE_COLUMNS} columns, prefill included), wall {wall_ms:.3f} ms per step: "
              f"device idle {1 - busy_ms / wall_ms:.1%} ({card})")
        for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:5]:
            print(f"    {us / sum(by_name.values()):6.1%} {name[:90]}")
    print(f"  eager bf16 B=1 decode step device time (K3's yardstick): "
          f"{rows['eager bf16']:.3f} ms; fused {rows['fused']:.3f} ms ({card})")
    del fused, eager
    torch.cuda.empty_cache()
    return k3, out.delayed_ids


def k4_inputs(dev, dtype, b, tq, tk, h, h_kv, pad, dh=64, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    q = (torch.randn(b, tq, h, dh, generator=g, device=dev) * dh ** -0.5).to(dtype)
    k, v = (torch.randn(b, tk, h_kv, dh, generator=g, device=dev).to(dtype) for _ in range(2))
    do = torch.randn(b, tq, h, dh, generator=g, device=dev).to(dtype)
    mask = torch.ones(b, tk, dtype=torch.bool, device=dev)
    if pad:
        mask[1, :pad] = False
    return q, k, v, mask, do


K4_ROUTES = ("wgmma", "simt")


def k4_case_check(fa, label, dtype, b, tq, tk, h, h_kv, causal, q_offset, pad, dh, dev):
    """One K4 case against the plain version; returns (route, [max abs err of
    o, dq, dk, dv], failure or None)."""
    q, k, v, mask, do = k4_inputs(dev, dtype, b, tq, tk, h, h_kv, pad, dh=dh)
    kw = dict(causal=causal, q_offset=q_offset)
    route = fa._k4_route(dtype, dh)
    before = {n: (fa.flash_attention.launches[n], fa.flash_attention.launches_wgmma[n])
              for n in fa.flash_attention.launches}
    got = fa.attention_and_grads(fa.flash_attention, q, k, v, mask, do, **kw)
    torch.cuda.synchronize()
    per_route = {n: (fa.flash_attention.launches[n] - a, fa.flash_attention.launches_wgmma[n] - w)
                 for n, (a, w) in before.items()}
    want = fa.attention_and_grads(fa.flash_attention_plain, q, k, v, mask, do, **kw)
    f64 = fa.attention_and_grads(fa.flash_attention_plain, q, k, v, mask, do,
                                 acc_dtype=torch.float64, **kw)
    gaps, limits = fa.k4_gaps(got, want), fa.k4_limits(fa.k4_gaps(want, f64), dtype)
    abs_err = [float((a - w).abs().max()) for a, w in zip(got, want)]
    # row 1's first `pad` keys are masked: no gradient reaches them, and when
    # causal its queries at positions below `pad` see no valid key at all
    dead = max(0, min(tq, pad - q_offset)) if causal else (tq if pad >= tk else 0)
    zero = not pad or all(not x.any() for x in (got[0][1, :dead], got[1][1, :dead],
                                                 got[2][1, :pad], got[3][1, :pad]))
    routed = all(c == (1, int(route == "wgmma")) for c in per_route.values())
    print(f"  K4 vs plain, {label} ({str(dtype)[6:]}, Dh={dh}, Tq={tq}, Tk={tk}, H={h}/{h_kv}, "
          f"{route} route: {routed}): o dq dk dv gaps " + " ".join(f"{x:.2e}" for x in gaps)
          + " | limits " + " ".join(f"{x:.2e}" for x in limits) + "; max abs "
          + " ".join(f"{x:.2e}" for x in abs_err)
          + ("" if not pad else f"; {dead} query rows with no valid key and {pad} masked keys "
             f"exactly 0 in o and every gradient: {zero}"))
    bad = any(x > lim for x, lim in zip(gaps, limits))
    failure = None
    if bad or not zero or not routed:
        failure = f"{label} {dtype} Dh={dh} (limits: {not bad}, zeros: {zero}, route: {routed})"
    return route, abs_err, failure


def phase_h(dev, card):
    """K4 against its plain version on both routes; returns {route: {kernel:
    json fields}} for the tensor-core ("wgmma") and SIMT kernels, forward, dq
    and dk/dv."""
    import torch.nn.functional as F

    from parler_tts_tpu_torch.ops import flash_attention as fa

    t_train = T_PROMPT_TRAIN + T_FRAMES_TRAIN
    bf16, fp32 = torch.bfloat16, torch.float32
    # (label, B, Tq, Tk, H, H_kv, causal, q_offset, left-padded keys of row 1, Dh)
    both = [
        ("mini-v1 training", 2, t_train, t_train, 16, 16, True, 0, 5, 64),
        ("GQA 8:2", 2, 256, 256, 8, 2, True, 0, 0, 64),
        ("q_offset 256", 2, 128, 384, 4, 4, True, 256, 0, 64),
        ("unaligned T 200", 2, 200, 200, 4, 4, True, 0, 3, 64),
        ("non-causal", 2, 192, 256, 4, 4, False, 0, 0, 64),
    ]
    bf16_only = [
        ("Tq 136 < Tk 264, q_offset 128, left pad 140", 2, 136, 264, 4, 4, True, 128, 140, 64),
        ("Tq 264 > Tk 200, causal", 2, 264, 200, 4, 4, True, 0, 7, 64),
        ("Tq 264 > Tk 200, non-causal", 2, 264, 200, 4, 4, False, 0, 7, 64),
        ("Dh 32", 2, 200, 200, 4, 4, True, 0, 3, 32),
    ]
    cases = ([(c, bf16) for c in both] + [(c, fp32) for c in both]
             + [(c, bf16) for c in bf16_only])
    print(f"  limit of each of o, dq, dk, dv (norm-relative) = {fa.K4_NOISE_FACTOR:g} x the gap "
          f"between the plain version summing in fp32 and in float64 on the same inputs, at "
          f"least {fa.K4_FLOOR[fp32]:g} (fp32) / {fa.K4_FLOOR[bf16]:g} (bf16); route by "
          f"`_k4_route`: bf16 with Dh 64 on the tensor cores (wgmma), the rest SIMT")
    errs = {route: {"fwd": 0.0, "dq": 0.0, "dkv": 0.0} for route in K4_ROUTES}
    failed = []
    for case, dtype in cases:
        route, abs_err, failure = k4_case_check(fa, case[0], dtype, *case[1:], dev=dev)
        e = errs[route]
        e["fwd"], e["dq"] = max(e["fwd"], abs_err[0]), max(e["dq"], abs_err[1])
        e["dkv"] = max(e["dkv"], abs_err[2], abs_err[3])
        if failure:
            failed.append(failure)

    # negative check at the main shape in bf16, on the tensor-core kernels
    q, k, v, mask, do = k4_inputs(dev, bf16, 2, t_train, t_train, 16, 16, 5)
    want = fa.attention_and_grads(fa.flash_attention_plain, q, k, v, mask, do)
    f64 = fa.attention_and_grads(fa.flash_attention_plain, q, k, v, mask, do,
                                 acc_dtype=torch.float64)
    limits = fa.k4_limits(fa.k4_gaps(want, f64), bf16)
    dropped = mask.clone()
    dropped[0, 512:576] = False  # what a kernel that skips key tile 8 of row 0 computes
    before = fa.flash_attention.launches_wgmma["fwd"]
    got = fa.attention_and_grads(fa.flash_attention, q, k, v, dropped, do)
    worst = max(x / lim for x, lim in zip(fa.k4_gaps(got, want), limits))
    on_wgmma = fa.flash_attention.launches_wgmma["fwd"] == before + 1
    print(f"  negative check, key tile 8 of row 0 dropped (wgmma route: {on_wgmma}): worst gap "
          f"{worst:.1f} x its limit")
    if worst <= 1.0 or not on_wgmma:
        failed.append("the dropped key tile passed the limits or missed the wgmma route")
    if failed:
        raise AssertionError(f"K4 outside its limits: {failed}")

    b, t, h, dh = q.shape
    ok = fa._visible(mask, t, True, 0)                          # (B, 1, T, T)
    pairs = int(ok.sum()) * h                                    # (b, h, query, key) pairs
    elem = b * t * h * dh
    dims = (1, b, h, t, t, dh, 1, 0)
    mask_u8 = mask.to(torch.uint8)
    with torch.no_grad():
        o, lse = fa._launch_fwd(q, k, v, mask_u8, dims, "wgmma")
        _, delta = fa._launch_dq(q, k, v, mask_u8, o, lse, do, dims, "wgmma")
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    sdpa_leaves = [x.detach().clone().requires_grad_(True) for x in (qt, kt, vt)]
    sdpa_o = F.scaled_dot_product_attention(*sdpa_leaves, attn_mask=ok, scale=1.0)
    do_t = do.transpose(1, 2).contiguous()

    # the library call and the plain version launch many short kernels, which
    # the host paces when they are timed back to back
    def timed(fn, iters):
        return padded_ms(lambda i: fn(), iters=iters)

    def plain_bwd(part):  # the plain version of one backward kernel, same inputs
        return lambda: fa._plain_backward(q, k, v, ok, o, lse, do, torch.float32, parts=(part,))

    def kernels(route):  # both routes on the same inputs (the SIMT kernels take bf16 at Dh 64)
        return (lambda: fa._launch_fwd(q, k, v, mask_u8, dims, route),
                lambda: fa._launch_dq(q, k, v, mask_u8, o, lse, do, dims, route),
                lambda: fa._launch_dkv(q, k, v, mask_u8, lse, do, delta, dims, route))

    kernel_ms = {}
    with torch.no_grad():
        for route in K4_ROUTES:  # the wgmma kernels, the SIMT ones, and the wgmma ones again
            kernel_ms.setdefault(route, []).append([timed(fn, 20) for fn in kernels(route)])
        kernel_ms["wgmma"].append([timed(fn, 20) for fn in kernels("wgmma")])
        plain_fwd_ms = timed(lambda: fa.flash_attention_plain(q, k, v, mask), 5)
        plain_dq_ms, plain_dkv_ms = timed(plain_bwd("dq"), 5), timed(plain_bwd("dkv"), 5)
        sdpa_fwd_ms = timed(lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=ok,
                                                                   scale=1.0), 20)
    sdpa_bwd_ms = timed(lambda: torch.autograd.grad(sdpa_o, sdpa_leaves, do_t,
                                                    retain_graph=True), 20)
    out = {route: {} for route in K4_ROUTES}
    # operations: 2 * Dh per visible pair per matmul (the forward's s and p @ v;
    # dq's s, dp and ds @ k; dk/dv's s, dp, p^T @ do and ds^T @ q); bytes: each
    # input read once and each output written once, bf16 tensors, fp32 lse/delta.
    # No library call computes dq alone or dk/dv alone: SDPA's backward (all
    # three) is reported once, on the dk/dv entry, as library_backward_ms.
    for route in K4_ROUTES:
        runs = kernel_ms[route]
        for i, (name, matmuls, n_in, n_out, n_rows, plain, lib) in enumerate((
                ("fwd", 2, 3, 1, 1, plain_fwd_ms, sdpa_fwd_ms),
                ("dq", 3, 5, 1, 2, plain_dq_ms, None),
                ("dkv", 4, 4, 2, 2, plain_dkv_ms, None))):
            ms = min(run[i] for run in runs)
            ops = 2 * dh * pairs * matmuls
            bytes_moved = 2 * elem * (n_in + n_out) + 4 * b * h * t * n_rows + b * t
            byte_s, op_s = bytes_moved / HBM_BYTES_PER_S, ops / BF16_OPS_PER_S
            bound_ms = max(byte_s, op_s) * 1e3
            out[route][name] = dict(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=bound_ms,
                                    bound_by="bytes" if byte_s >= op_s else "operations",
                                    max_abs_err=errs[route][name])
            print(f"  K4 {route} {name} {ms:.4f} ms (runs " + " / ".join(
                f"{run[i]:.4f}" for run in runs) + f"), {ops / ms / 1e9:.1f} TFLOP/s, "
                f"{bound_ms / ms:.1%} of its bound {bound_ms:.4f} ms ({out[route][name]['bound_by']}: "
                f"{ops / 1e9:.2f} GFLOP, {bytes_moved / 1e6:.1f} MB); plain {plain:.3f} ms; at "
                f"B={b}, H={h}, T={t}, bf16 ({card})")
        out[route]["dkv"]["library_backward_ms"] = sdpa_bwd_ms
    w, m = out["wgmma"], out["simt"]
    print(f"  device time per call (CUDA events, host pace excluded), with the same boolean "
          f"mask: wgmma forward {w['fwd']['ms']:.4f} ms vs SDPA forward {sdpa_fwd_ms:.4f} ms; "
          f"wgmma backward {w['dq']['ms'] + w['dkv']['ms']:.4f} ms (dq {w['dq']['ms']:.4f}, "
          f"dk/dv {w['dkv']['ms']:.4f}) vs SDPA backward {sdpa_bwd_ms:.4f} ms; SIMT "
          f"{m['fwd']['ms']:.4f} + {m['dq']['ms'] + m['dkv']['ms']:.4f} ms; plain "
          f"{plain_fwd_ms:.3f} + {plain_dq_ms + plain_dkv_ms:.3f} ms ({card})")
    slow = [name for name in ("fwd", "dq", "dkv") if not w[name]["ms"] < m[name]["ms"]]
    if slow:
        raise AssertionError(f"wgmma K4 not faster than the SIMT kernels: {slow}")
    del sdpa_o, sdpa_leaves
    torch.cuda.empty_cache()
    return out


def train_batch(dev, seed=0):
    """B=2: 32 description ids (row 1 right-padded), 16 prompt ids (row 1
    left-padded by 5), labels (2, 1024, 9) of codes < 1024 with a -100 tail
    on row 0."""
    from parler_tts_tpu_torch.training import Batch

    g = torch.Generator(device=dev).manual_seed(seed)
    desc_mask = torch.ones(2, 32, dtype=torch.int64, device=dev)
    desc_mask[1, 24:] = 0
    prompt_mask = torch.ones(2, T_PROMPT_TRAIN, dtype=torch.int64, device=dev)
    prompt_mask[1, :5] = 0
    labels = torch.randint(0, 1024, (2, T_FRAMES_TRAIN, 9), generator=g, device=dev)
    labels[0, -100:] = -100
    return Batch(torch.randint(0, 32000, (2, 32), generator=g, device=dev), desc_mask,
                 torch.randint(0, 32000, (2, T_PROMPT_TRAIN), generator=g, device=dev),
                 prompt_mask, labels)


def profile_train_step(step, state, batch, step_ms, card):
    """A CUDA-only profile of one more step (after the counted ones): device
    busy time, the idle share against `step_ms`, and the largest kernels."""
    from collections import defaultdict

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        step(state, batch, TRAIN_STEPS)
        torch.cuda.synchronize()
    by_name, count = defaultdict(float), 0
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] += e.time_range.elapsed_us()
            count += 1
    busy_ms = sum(by_name.values()) / 1e3
    k4_tags = ("::fwd_kernel<", "::dq_kernel<", "::dkv_kernel<",  # csrc/flash_attention.cu
               "k4_fwd_wgmma", "k4_dq_wgmma", "k4_dkv_wgmma")     # csrc/flash_attention_wgmma.cu
    k4 = {tag: sum(us for name, us in by_name.items() if tag in name) / 1e3 for tag in k4_tags}
    k4_ms = sum(k4.values())
    print(f"  profile of one train step: {count} kernels, device busy {busy_ms:.1f} ms of "
          f"{step_ms:.1f} ms (idle {1 - busy_ms / step_ms:.1%}), K4 {k4_ms:.2f} ms "
          f"({k4_ms / busy_ms:.1%}): " + ", ".join(f"{tag.strip(':<')} {ms:.2f}"
                                                    for tag, ms in k4.items() if ms)
          + f" ({card})")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
        print(f"    {us / 1e3 / busy_ms:6.1%} {us / 1e3:8.2f} ms  {name[:90]}")


def phase_i(dev, card):
    """mini-v1 trained for 5 steps over K4; returns K4's launches by route and
    kernel (the tensor-core kernels' over the 5 bf16 steps, the SIMT kernels'
    over the fp32 step) and step 1's loss gap between K4 in fp32 and in bf16,
    the noise bf16 compute puts on a loss (phase n's limit)."""
    from parler_tts_tpu_torch.config import mini_v1_config
    from parler_tts_tpu_torch.models.layers import init_weights
    from parler_tts_tpu_torch.models.parler import ParlerTTS
    from parler_tts_tpu_torch.ops.flash_attention import flash_attention
    from parler_tts_tpu_torch.training import TrainState, make_optimizer, make_train_step

    cfg = mini_v1_config()

    def trainer(route, dtype, params=None):
        model = ParlerTTS(cfg, device=dev, dtype=dtype, param_dtype=torch.float32,
                          use_chunked_attention=route, remat_layers=True)
        if params is None:
            init_weights(model, torch.Generator(device=dev).manual_seed(0))
        else:
            model.load_state_dict(params)
        tx = make_optimizer(warmup_steps=1)
        return model, TrainState.create(model, tx), make_train_step(model, tx)

    t0 = time.perf_counter()
    model, state, step = trainer("pallas", torch.bfloat16)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"  mini-v1 trainer on the card: {n_params / 1e6:.1f}M fp32 parameters, bf16 compute, "
          f"K4 attention, remat_layers, {time.perf_counter() - t0:.2f} s")
    initial = {n: p.detach().clone() for n, p in model.named_parameters()}
    batch = train_batch(dev)
    torch.cuda.reset_peak_memory_stats()
    k4, k4_wgmma = flash_attention.launches, flash_attention.launches_wgmma
    total = {"wgmma": dict.fromkeys(k4, 0), "simt": dict.fromkeys(k4, 0)}
    losses, norms, times = [], [], []
    want = {"fwd": 2 * cfg.decoder.num_hidden_layers, "dq": cfg.decoder.num_hidden_layers,
            "dkv": cfg.decoder.num_hidden_layers}
    for i in range(TRAIN_STEPS):
        for key in k4:
            k4[key] = k4_wgmma[key] = 0
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        state, metrics = step(state, batch, i)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
        losses.append(float(metrics["loss"]))
        norms.append(float(metrics["grad_norm"]))
        if dict(k4) != want or dict(k4_wgmma) != want:
            raise AssertionError(f"step {i + 1}: K4 launches {dict(k4)}, on the wgmma route "
                                 f"{dict(k4_wgmma)}, want {want} on it")
        for key in k4:
            total["wgmma"][key] += k4_wgmma[key]
        changed = [n for n, p in model.named_parameters()
                   if (i == 0 or n.startswith("text_encoder.")) and not torch.equal(p, initial[n])]
        if changed:
            raise AssertionError(f"step {i + 1} changed {changed[:3]}")
        print(f"  step {i + 1}: loss {losses[-1]:.6f}, grad_norm {norms[-1]:.6f}, "
              f"{times[-1]:.1f} ms, K4 launches {dict(k4)}, all on the wgmma route")
    if not all(map(math.isfinite, losses + norms)) or not losses[-1] < losses[1]:
        raise AssertionError(f"losses {losses}")
    step_ms = statistics.median(times[1:])
    frames = batch.labels.shape[0] * T_FRAMES_TRAIN
    print(f"  {TRAIN_STEPS} steps: loss {losses[1]:.6f} at step 2 -> {losses[-1]:.6f} at step "
          f"{TRAIN_STEPS}; step 1 changed no parameter, the text encoder none in any step; "
          f"{step_ms:.1f} ms per step (median of steps 2-{TRAIN_STEPS}, CUDA events), "
          f"{frames / step_ms * 1e3:.0f} label frames/s, peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB ({card})")
    profile_train_step(step, state, batch, step_ms, card)
    del model, state, step
    torch.cuda.empty_cache()

    # step 1 again through the plain chunked route: in bf16, beside K4's bf16
    # step above, and in fp32 beside K4 in fp32, every gradient leaf
    again, grads = {}, {}
    for label, route, dtype in (("chunked bf16", True, torch.bfloat16),
                                ("K4 fp32", "pallas", torch.float32),
                                ("chunked fp32", True, torch.float32)):
        model, state, step = trainer(route, dtype, initial)
        for key in k4:
            k4[key] = k4_wgmma[key] = 0
        _, metrics = step(state, batch, 0)
        torch.cuda.synchronize()
        again[label] = (float(metrics["loss"]), float(metrics["grad_norm"]))
        if label == "K4 fp32":  # fp32 stays on the SIMT kernels
            if dict(k4) != want or any(k4_wgmma.values()):
                raise AssertionError(f"K4 fp32 step: launches {dict(k4)}, on the wgmma route "
                                     f"{dict(k4_wgmma)}; want {want}, none on it")
            total["simt"] = dict(k4)
            print(f"  K4 fp32 step 1: launches {dict(k4)}, all on the SIMT route")
        if dtype == torch.float32:
            grads[label] = {n: p.grad.detach().clone() for n, p in model.named_parameters()}
        del model, state, step
        torch.cuda.empty_cache()
    k4_run = (losses[0], norms[0])
    fail = []
    for j, name in enumerate(("loss", "grad_norm")):
        gap = abs(again["chunked bf16"][j] - k4_run[j])
        limit = abs(again["K4 fp32"][j] - k4_run[j])  # bf16's own noise on this step
        gap32 = abs(again["chunked fp32"][j] - again["K4 fp32"][j]) / abs(again["K4 fp32"][j])
        print(f"  step 1 {name}: K4 bf16 {k4_run[j]:.6f}, chunked bf16 "
              f"{again['chunked bf16'][j]:.6f}, K4 fp32 {again['K4 fp32'][j]:.6f}, chunked fp32 "
              f"{again['chunked fp32'][j]:.6f}; |chunked - K4 bf16| {gap:.3e} within "
              f"|K4 fp32 - K4 bf16| = {limit:.3e}: {gap <= limit}; fp32 routes' relative gap "
              f"{gap32:.2e} within {TRAIN_FP32_LIMIT:g}: {gap32 <= TRAIN_FP32_LIMIT}")
        if gap > limit or gap32 > TRAIN_FP32_LIMIT:
            fail.append(name)
    leaf_gaps = {n: float((g - grads["K4 fp32"][n]).norm()
                          / grads["K4 fp32"][n].norm().clamp_min(1e-30))
                 for n, g in grads["chunked fp32"].items()}
    worst = max(leaf_gaps, key=leaf_gaps.get)
    print(f"  step 1 gradients, chunked fp32 vs K4 fp32, ||g_chunked - g_K4|| / ||g_K4|| per "
          f"leaf: median {statistics.median(leaf_gaps.values()):.2e}, largest "
          f"{leaf_gaps[worst]:.2e} ({worst}), limit {TRAIN_FP32_LIMIT:g} over "
          f"{len(leaf_gaps)} leaves")
    if leaf_gaps[worst] > TRAIN_FP32_LIMIT:
        fail.append(f"gradient {worst}")
    if fail:
        raise AssertionError(f"chunked route vs K4 at step 1: {fail}")
    return total, abs(again["K4 fp32"][0] - k4_run[0])


# ------------------------------------------------------- checkpoint side
TIE = 2e-4           # decoder-logit bound (COMPONENTS.md row 5): a near-tie
FOLD_REL = 1e-6      # folded DAC kernels: max |diff| / max |w| per tensor
CODEC_REL_RMS = 0.12  # bf16 codec: the JAX package's bound for random weights
WINDOW, WINDOW_COLUMNS, TEXT_COLUMNS, XLA_COLUMNS = 256, 512, 64, 256


class ReplayDone(Exception):
    """Raised by a SampleHook once it has sampled its `stop` column."""


class SampleHook:
    """Wraps `runtime.generate._sample_column` for the generate calls made
    inside it (a check instrument: it syncs each step). It keeps the raw
    logits of the first `keep` sampling events, the processed logits at the
    columns `keep_at`, and whether any logits held a NaN. Given `want` (B,
    K, L) ids, each column before `follow_until` that parts from them is
    recorded as (column, row, codebook, own token, wanted token, gap of the
    two in this run's logits) and the wanted token is forced, so the rest of
    the stream stays comparable; from `follow_until` on, the first column
    that parts is recorded and nothing is forced. Given `stop`, the run ends
    with ReplayDone once column `stop` is sampled."""

    def __init__(self, want=None, follow_until=None, keep=0, keep_at=(), stop=None):
        self.want, self.follow_until, self.keep, self.stop = want, follow_until, keep, stop
        self.keep_at = set(keep_at)
        self.kept, self.processed, self.partings = [], {}, []
        self.first_free_parting, self.nan = None, False

    def __enter__(self):
        import parler_tts_tpu_torch.runtime.generate as tgen

        self.tgen, self.real = tgen, tgen._sample_column
        tgen._sample_column = self._sample
        return self

    def __exit__(self, *exc):
        self.tgen._sample_column = self.real

    def _sample(self, logits, t, eos_state, pattern, gen, k, prompt_cols=1, generator=None):
        col, state = self._follow(logits, t, eos_state, pattern, gen, k, prompt_cols, generator)
        if self.stop is not None and t >= self.stop:
            raise ReplayDone
        return col, state

    def _follow(self, logits, t, eos_state, pattern, gen, k, prompt_cols, generator):
        kw = dict(prompt_cols=prompt_cols, generator=generator)
        self.nan |= bool(torch.isnan(logits).any())
        if len(self.kept) < self.keep:
            self.kept.append(logits.clone())
        if t in self.keep_at:
            self.processed[t] = self.tgen._process_column(logits, t, eos_state, gen, k,
                                                          prompt_cols)[0]
        col, state = self.real(logits, t, eos_state, pattern, gen, k, **kw)
        if self.want is None or torch.equal(col, self.want[:, :, t]):
            return col, state
        if self.follow_until is not None and t >= self.follow_until:
            if self.first_free_parting is None:
                self.first_free_parting = t
            return col, state
        ref, forced = self.want[:, :, t], logits.clone()
        for b, kk in torch.nonzero(col != ref).tolist():
            mine, theirs = int(col[b, kk]), int(ref[b, kk])
            self.partings.append((t, b, kk, mine, theirs,
                                  float(logits[b, kk, mine] - logits[b, kk, theirs])))
            forced[b, kk, theirs] = logits[b, kk, mine] + 1.0
        return self.real(forced, t, eos_state, pattern, gen, k, **kw)


def param_mismatches(model, dac, src_model, src_dac):
    """(names that differ, worst folded-kernel deviation): every model
    parameter `torch.equal` to the source's; the codec's conv weights and
    in/out-projections (folded from weight_g / weight_v) within FOLD_REL of
    each tensor's scale, its other parameters equal."""
    bad = []
    want = dict(src_model.named_parameters())
    for name, p in model.named_parameters():
        if name not in want or p.dtype != want[name].dtype or not torch.equal(p, want[name]):
            bad.append(name)
    worst, want = 0.0, dict(src_dac.named_parameters())
    for name, p in dac.named_parameters():
        w = want[name]
        if name.split(".")[-1] in ("weight", "in_proj_kernel", "out_proj_kernel"):
            rel = ((p.double() - w.double()).abs().max() / w.double().abs().max()).item()
            worst = max(worst, rel)
            if rel > FOLD_REL:
                bad.append(name)
        elif not torch.equal(p, w):
            bad.append(name)
    return bad + sorted(set(want) - {n for n, _ in dac.named_parameters()}), worst


def near_ties(label, partings, replay, want, need, tie=TIE, top_two=True, stop_early=False):
    """Each parting (column, row, codebook, other run's token, `want`'s
    token, ...) of a stream held to `want` must fall where `want`'s own run
    had `want`'s token on top and the other token within `tie` of it: as its
    runner-up (`top_two`), or at any rank with every token between also
    within `tie`. `replay()` reruns the run that gave `want`, recording its
    processed logits; it must give `want` again, or with `stop_early` follow
    it up to the last parting column, where it is ended."""
    cols = sorted({x[0] for x in partings})
    if not cols:
        return
    with SampleHook(want=want, keep_at=cols, stop=cols[-1] if stop_early else None) as hook:
        try:
            same = torch.equal(replay().delayed_ids, want)
        except ReplayDone:
            same = True  # it followed `want` up to the stop if hook.partings is empty
    need(same and cols[-1] in hook.processed and not hook.partings and not hook.nan,
         f"{label}: the replay gave another stream")
    for t, b, k, mine, theirs, *_ in partings:
        x = hook.processed[t][b, k]
        gap = float(x[theirs] - x[mine])
        rank = int((x > x[mine]).sum())
        print(f"    {label}: column {t} row {b} codebook {k}: token {mine} for {theirs}; in the "
              f"reference {gap:.2e} below its top {int(x.argmax())}, rank {rank} (near-tie: "
              f"<= {tie:.2e}{', runner-up' if top_two else ''})")
        need(int(x.argmax()) == theirs and 0 <= gap <= tie and (rank <= 1 or not top_two),
             f"{label}: column {t} row {b} codebook {k} is not a near-tie")


def first_partings(label, got, want, rows):
    """Greedy ids `got` (b, K, L) against `want` (B, K, L), row i of `got`
    against row rows[i] of `want`: the entries of each row's first parting
    column, as (column, row of `want`, codebook, got's token, want's
    token)."""
    partings, firsts = [], []
    for i, r in enumerate(rows):
        diff = (got[i] != want[r]).any(dim=0).nonzero()
        firsts.append(int(diff[0, 0]) if diff.numel() else None)
        if diff.numel():
            t = firsts[-1]
            partings += [(t, r, k, int(got[i, k, t]), int(want[r, k, t]))
                         for k in (got[i, :, t] != want[r, :, t]).nonzero()[:, 0].tolist()]
    print(f"    {label}: first parting column of each row {firsts} (of {got.shape[-1]})")
    return partings


def dir_bytes(path) -> int:
    import os

    return sum(os.path.getsize(os.path.join(path, f)) for f in os.listdir(path))


def check_disk(path, need: int) -> None:
    import shutil

    free = shutil.disk_usage(path).free
    if free < need * 1.25:
        raise AssertionError(f"{path}: {free / 1e9:.2f} GB free, the checkpoint needs "
                             f"{need / 1e9:.2f} GB (x1.25): not writing it")


def stub_tokenizer(texts):
    """A stand-in tokenizer, one id a byte (mod 32000): a string -> {"input_ids":
    [...]}, as the training CLI calls it; a list of strings -> one list each,
    as the pipeline does."""
    if isinstance(texts, str):
        return {"input_ids": [b % 32000 for b in texts.encode()]}
    return {"input_ids": [[b % 32000 for b in t.encode()] for t in texts]}


def hf_config_json(cfg) -> dict:
    """The HF layout's config.json for `cfg` (nested sections, DAC tagged
    `dac_on_the_hub`)."""
    import dataclasses

    return {
        "text_encoder": dataclasses.asdict(cfg.text_encoder),
        "audio_encoder": dict(dataclasses.asdict(cfg.audio_encoder),
                              model_type="dac_on_the_hub"),
        "decoder": dataclasses.asdict(cfg.decoder),
        **{k: getattr(cfg, k) for k in ("vocab_size", "prompt_cross_attention",
                                        "pad_token_id", "decoder_start_token_id")},
    }


def serve_checked(pipe, request, want, label, card, need):
    """`generate_codes` of `request`, timed; its delayed ids must equal
    `want` and K1 must launch once per layer and decode step."""
    from parler_tts_tpu_torch.ops.flash_decode import flash_decode_attention

    n_layers = pipe.config.decoder.num_hidden_layers
    flash_decode_attention.launches = 0
    t0 = time.perf_counter()
    out = pipe.generate_codes(*request, seed=0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    steps, k1 = out.steps - 2, flash_decode_attention.launches
    same = torch.equal(out.delayed_ids, want)
    print(f"  {label}: {out.steps} columns, {steps / wall:.1f} decode steps/s, delayed ids "
          f"equal to the source's: {same}; K1 launches {k1} = {n_layers} x {steps}: "
          f"{k1 == n_layers * steps} ({card})")
    need(same and k1 == n_layers * steps, f"{label}: ids equal {same}, K1 launches {k1}")


def decode_prefix(model, dev, dtype, n_after, n_pre=K_COLUMNS // 2):
    """A B=2 mini-v1 request's cache prefilled with `n_pre` random columns after
    the prompt; returns (cache, positions, K1's starts, the next position,
    the `n_after` random columns that follow)."""
    from parler_tts_tpu_torch.models.decoder import DecoderCache
    from parler_tts_tpu_torch.ops.masks import causal_self_attention_bias

    dcfg = model.config.decoder
    desc, desc_mask, prompt, prompt_mask = (torch.as_tensor(x, device=dev)
                                            for x in request_ids(1))
    g = torch.Generator(device=dev).manual_seed(1)
    cols = torch.randint(0, min(1024, dcfg.vocab_size), (BATCH, dcfg.num_codebooks,
                                                         n_pre + n_after), generator=g, device=dev)
    kv_valid = torch.cat([prompt_mask.bool(),
                          torch.ones(BATCH, K_COLUMNS, dtype=torch.bool, device=dev)], 1)
    pos = torch.arange(K_SLOTS, device=dev)[None].expand(BATCH, -1)
    starts = (S_PROMPT - prompt_mask.sum(1)).to(torch.int32)
    t = S_PROMPT + n_pre
    with torch.inference_mode():
        enc = model.encode_description(desc, desc_mask)
        cache = DecoderCache.zeros(dcfg, BATCH, K_SLOTS, enc.shape[1], dtype, dev,
                                   model.model_shards)
        cache.cross_k, cache.cross_v = model.decoder.precompute_cross_kv(enc)
        pre = torch.cat([model.prompt_hidden(prompt),
                         model.decoder.embed_ids(cols[:, :, :n_pre])], dim=1)
        model.decoder(pre, pos[:, :t], self_attn_bias=causal_self_attention_bias(
            pos[:, :t], kv_valid), cross_attn_bias=None, cache=cache)
    return cache, pos, starts, t, cols[:, :, n_pre:]


def decode_step_logits(model, dev, dtype):
    """Logits of one mini-v1 decode step at position S_PROMPT + K_COLUMNS // 2 after a
    prefill of random columns (phase e's int8 step, at `dtype`)."""
    return decode_steps_logits(model, dev, dtype, 1)


def decode_steps_logits(model, dev, dtype, n, row=None, n_pre=K_COLUMNS // 2):
    """Logits (B, K, n, V) of n one-column decode steps over the random
    columns that follow decode_prefix(n_pre=), each step fed the given
    column (teacher-forced); with `row`, that row's steps alone (M = 1)."""
    from parler_tts_tpu_torch.models.decoder import DecoderCache

    cache, pos, starts, t, cols = decode_prefix(model, dev, dtype, n, n_pre)
    if row is not None:
        r = slice(row, row + 1)
        cache = DecoderCache(cache.self_k[:, r].clone(), cache.self_v[:, r].clone(),
                             cache.cross_k[:, r], cache.cross_v[:, r], cache.index)
        pos, starts, cols = pos[r], starts[r], cols[r]
    steps = []
    with torch.inference_mode():
        for i in range(n):
            steps.append(model.decoder(model.decoder.embed_ids(cols[:, :, i:i + 1]),
                                       pos[:, t + i:t + i + 1], self_attn_bias=None,
                                       cross_attn_bias=None, cache=cache,
                                       decode_lengths=(starts, t + i + 1)))
    return torch.cat(steps, dim=2)


def tie_steps_logits(model, dev, dtype, row=None):
    """Logits (B, K, len(P_TIE_PREFIXES) x P_TIE_STEPS, V) of P_TIE_STEPS
    teacher-forced decode steps after each prefix of P_TIE_PREFIXES, in
    that order: the steps a near-tie is measured over."""
    return torch.cat([decode_steps_logits(model, dev, dtype, P_TIE_STEPS, row=row, n_pre=n)
                      for n in P_TIE_PREFIXES], dim=2)


def per_prefix(moves) -> str:
    """The largest of `moves` (..., steps, 1) after each prefix of P_TIE_PREFIXES."""
    return " / ".join(f"{m.max().item():.4f}"
                      for m in moves.split(P_TIE_STEPS, dim=-2))


def top_two_moves(ref, other):
    """The change, from logits `ref` to `other` (..., V), of the gap between
    `ref`'s top two logits, at every position."""
    top = ref.float().topk(2, dim=-1).indices
    return (other.float().gather(-1, top) - ref.float().gather(-1, top)).diff(dim=-1).abs()


def window_vs_steps(model, dev, w, n_windows):
    """Logits of the same n_windows x W random columns after decode_prefix,
    at the model's dtype, computed two ways from one prefilled cache: as
    n_windows W-column forwards (M = B x W rows; the cache index and K1's
    limits device tensors, as the speculative step runs them) and as
    one-column steps (M = B, as the AR loop runs them), each way writing
    its own copy of the cache. Returns (window, steps), each (B, K, n x W, V)."""
    import dataclasses

    dtype = next(model.decoder.parameters()).dtype
    cache, pos, starts, t, cols = decode_prefix(model, dev, dtype, n_windows * w)
    copy = dataclasses.replace(cache, self_k=cache.self_k.clone(),
                               self_v=cache.self_v.clone())
    cache.index = torch.tensor(t, device=dev)
    window, steps = [], []
    with torch.inference_mode():
        for j in range(n_windows):
            p = t + j * w
            limit = torch.full((BATCH,), p + 1, dtype=torch.int32, device=dev)
            window.append(model.decoder(
                model.decoder.embed_ids(cols[:, :, j * w:(j + 1) * w]), pos[:, p:p + w],
                self_attn_bias=None, cross_attn_bias=None, cache=cache,
                decode_lengths=(starts, limit)))
        for i in range(n_windows * w):
            steps.append(model.decoder(
                model.decoder.embed_ids(cols[:, :, i:i + 1]), pos[:, t + i:t + i + 1],
                self_attn_bias=None, cross_attn_bias=None, cache=copy,
                decode_lengths=(starts, t + i + 1)))
    return torch.cat(window, dim=2), torch.cat(steps, dim=2)


def phase_j(dev, card, source, out_b, stream_e, stream_g):
    """Phase (b)'s mini-v1 pipeline saved in the native and the HF layout and
    served from disk: parameters equal to the source's, phases (b), (e) and
    (g)'s streams through K1, K2 and K3 with their launch counts, the
    negative checks, then fused_qkv, weight_quant="xla", the bf16 codec, the
    sliding-window cache and text input on the same weights."""
    import copy
    import dataclasses
    import json
    import os
    import tempfile

    import numpy as np

    from parler_tts_tpu_torch.codec.convert import convert_dac_params, export_dac_params
    from parler_tts_tpu_torch.codec.dac_model import DACModel
    from parler_tts_tpu_torch.convert import load_jax_dac_params, load_jax_params, tensor_tree
    from parler_tts_tpu_torch.models.parler import ParlerTTS, convert_composite_params
    from parler_tts_tpu_torch.ops.flash_decode import flash_decode_attention
    from parler_tts_tpu_torch.ops.fused_decode_step import fused_decode_layers
    from parler_tts_tpu_torch.ops.quant_matmul import quant_matmul
    from parler_tts_tpu_torch.runtime.checkpoint import load_safetensors_dir
    from parler_tts_tpu_torch.runtime.pipeline import ParlerTTSPipeline
    from parler_tts_tpu_torch.utils.hf_export import export_composite_to_hf_tensors

    import parler_tts_tpu_torch.models.decoder as decoder_module

    failed = []

    def need(ok, what):
        """Record a failed check and go on, so one run reports every check;
        the phase raises at its end if any failed."""
        if not ok:
            failed.append(what)
            print(f"  FAILED: {what}")

    cfg, gen = source.config, source.generation_config
    request = request_ids(0)
    want_b = out_b.delayed_ids
    bf16 = dict(device=dev, dtype=torch.bfloat16, cache_dtype=torch.bfloat16)
    model_bytes = sum(p.numel() * 4 for p in source.model.parameters())
    dac_bytes = sum(p.numel() * 4 for p in source.dac.parameters())
    tmp_root = tempfile.gettempdir()

    # ---- native layout: config.json, generation_config.json, params.pkl, dac_params.pkl
    with tempfile.TemporaryDirectory() as path:
        check_disk(tmp_root, model_bytes + dac_bytes)
        t0 = time.perf_counter()
        source.save_pretrained(path)
        t1 = time.perf_counter()
        native = ParlerTTSPipeline.from_pretrained(path, **bf16)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        print(f"  native layout: {dir_bytes(path) / 1e9:.3f} GB written in {t1 - t0:.2f} s, "
              f"loaded onto the card in {t2 - t1:.2f} s ({card})")
    bad, worst = param_mismatches(native.model, native.dac, source.model, source.dac)
    print(f"  native: parameters equal to the source's: {not bad} (codec worst {worst:.1e}); "
          f"generation_config honoured: {native.generation_config == gen}")
    need(not bad and native.generation_config == gen,
         f"native layout: parameters differ: {bad[:5]}")
    serve_checked(native, request, want_b, "native-loaded B=2 serve", card, need)
    del native

    # ---- HF layout: the port's exporters, two shards, BF16 model / F32 codec, weight_g/v
    tensors = export_composite_to_hf_tensors(tensor_tree(source.model), cfg)
    tensors.update(export_dac_params(tensor_tree(source.dac), cfg.audio_encoder,
                                     prefix="audio_encoder.model.", v_scale=1.7))
    names = list(tensors)
    hf_dir = tempfile.TemporaryDirectory()
    path = hf_dir.name
    try:
        check_disk(tmp_root, sum(t.numel() * t.element_size() for t in tensors.values()))
        t0 = time.perf_counter()
        written = sum(write_safetensors(os.path.join(path, f"model-{i + 1:05d}-of-00002"
                                                     ".safetensors"),
                                        {k: tensors[k] for k in part})
                      for i, part in enumerate((names[: len(names) // 2],
                                                names[len(names) // 2:])))
        with open(os.path.join(path, "config.json"), "w") as f:
            json.dump(hf_config_json(cfg), f)
        with open(os.path.join(path, "generation_config.json"), "w") as f:
            json.dump(dataclasses.asdict(gen), f)
        t1 = time.perf_counter()
        hf = ParlerTTSPipeline.from_pretrained(path, **bf16)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        del tensors
        print(f"  HF layout: {written / 1e9:.3f} GB in 2 shards written in {t1 - t0:.2f} s, "
              f"loaded onto the card in {t2 - t1:.2f} s ({card})")
        bad, worst = param_mismatches(hf.model, hf.dac, source.model, source.dac)
        print(f"  HF: parameters equal to the source's: {not bad}; folded codec kernels "
              f"within {worst:.2e} of their scale (limit {FOLD_REL:.0e})")
        need(not bad and worst > 0.0, f"HF layout: parameters differ: {bad[:5]}, fold {worst}")

        # negative checks: one decoder kernel transposed, one DAC g left unfolded
        on_disk = load_safetensors_dir(path)
        tree = convert_composite_params(on_disk, cfg)
        q = tree["decoder"]["decoder"]["layers_0"]["self_attn"]["q_proj"]
        q["kernel"] = q["kernel"].t()
        broken = ParlerTTS(cfg, device=dev, dtype=torch.bfloat16)
        load_jax_params(broken, tree)
        unfolded = dict(on_disk)
        conv = "audio_encoder.model.decoder.model.0"
        unfolded[f"{conv}.weight"] = unfolded.pop(f"{conv}.weight_v")
        del unfolded[f"{conv}.weight_g"]
        broken_dac = DACModel(cfg.audio_encoder, device=dev)
        load_jax_dac_params(broken_dac, convert_dac_params(unfolded, cfg.audio_encoder,
                                                           prefix="audio_encoder.model."))
        caught = (param_mismatches(broken, hf.dac, source.model, source.dac)[0],
                  param_mismatches(hf.model, broken_dac, source.model, source.dac)[0])
        print(f"  negative checks: a transposed q_proj kernel fails the check: {caught[0]}; "
              f"an unfolded conv_in weight fails it: {caught[1]}")
        need(caught == (["decoder.decoder.layers.0.self_attn.q_proj.kernel"],
                        ["decoder.conv_in.weight"]), f"negative checks: {caught}")
        del broken, broken_dac, tree, on_disk, unfolded

        serve_checked(hf, request, want_b, "HF-loaded B=2 serve", card, need)
        # K3: phase (g)'s row, B=1
        fused = ParlerTTSPipeline(hf.model, hf.dac, gen, device=dev, fused_decode=True)
        row = tuple(x[1:2] for x in request)
        fused_decode_layers.launches = 0
        out = fused.generate_codes(*row, seed=0)
        k3, same = fused_decode_layers.launches, torch.equal(out.delayed_ids, stream_g)
        print(f"  HF-loaded fused B=1 serve: ids equal to phase (g)'s: {same}; K3 launches "
              f"{k3} = {out.steps - 2} decode steps: {k3 == out.steps - 2}")
        need(same and k3 == out.steps - 2, f"HF fused B=1: ids equal {same}, K3 launches {k3}")
        del fused
        # K2: phase (e)'s stream
        int8 = ParlerTTSPipeline.from_pretrained(path, weight_quant=True, **bf16)
        quant_matmul.launches = 0
        out = int8.generate_codes(*request, seed=0)
        steps, k2, n_layers = out.steps - 2, quant_matmul.launches, cfg.decoder.num_hidden_layers
        want_k2 = 8 * n_layers * (steps + 1) + 2 * n_layers
        same = torch.equal(out.delayed_ids, stream_e)
        print(f"  HF-loaded int8 B=2 serve: ids equal to phase (e)'s: {same}; K2 launches "
              f"{k2} = {8 * n_layers} x ({steps} + 1) + {2 * n_layers}: {k2 == want_k2}")
        need(same and k2 == want_k2, f"HF int8: ids equal {same}, K2 launches {k2}")

        # ---- weight_quant="xla", B=2: one decode step against K2, then 256 columns
        xla = ParlerTTSPipeline.from_pretrained(path, weight_quant="xla", **bf16)
    finally:
        hf_dir.cleanup()
    del hf
    step_xla = decode_step_logits(xla.model, dev, torch.bfloat16)
    step_k2 = decode_step_logits(int8.model, dev, torch.bfloat16)
    kernel = decoder_module.quant_matmul
    try:
        decoder_module.quant_matmul = plain_f64
        step_f64 = decode_step_logits(int8.model, dev, torch.bfloat16)
    finally:
        decoder_module.quant_matmul = kernel
    err, noise = norm_rel(step_xla, step_k2), norm_rel(step_f64, step_k2)
    print(f"  weight_quant='xla' bf16 decode step vs K2: norm-rel {err:.3e}; K2 vs its plain "
          f"version summing in float64 {noise:.3e}; tolerance 4 x that ({card})")
    need(err <= 4 * noise, f"xla decode step: {err:.3e} > 4 x {noise:.3e}")
    quant_matmul.launches = 0
    pipe_kw = {k: v for k, v in bf16.items() if k != "dtype"}
    warm = dataclasses.replace(gen, max_length=24, min_new_tokens=24)
    ParlerTTSPipeline(xla.model, xla.dac, warm, **pipe_kw).generate_codes(*request, seed=0)
    short = dataclasses.replace(gen, max_length=XLA_COLUMNS, min_new_tokens=XLA_COLUMNS)
    xla_pipe = ParlerTTSPipeline(xla.model, xla.dac, short, **pipe_kw)
    t0 = time.perf_counter()
    out = xla_pipe.generate_codes(*request, seed=0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    print(f"  weight_quant='xla' B=2 serve: {out.steps} columns, "
          f"{(out.steps - 2) / wall:.1f} decode steps/s; K2 launches {quant_matmul.launches} "
          f"({card})")
    need(quant_matmul.launches == 0, "the xla route launched K2")
    del xla, xla_pipe, int8
    torch.cuda.empty_cache()

    # ---- fused_qkv: logits of the prefill and 8 decode steps, then MAX_LENGTH columns
    fqkv = ParlerTTSPipeline(source.model, source.dac, gen, fused_qkv=True, **pipe_kw)
    fp32_model = ParlerTTS(cfg, device=dev, dtype=torch.float32)
    load_jax_params(fp32_model, tensor_tree(source.model))
    first = dataclasses.replace(gen, max_length=20, min_new_tokens=20)
    logits = {}
    for label, model in (("source", source.model), ("fused_qkv", fqkv.model),
                         ("fp32", fp32_model)):
        p = ParlerTTSPipeline(model, source.dac, first, device=dev,
                              cache_dtype=torch.float32 if label == "fp32" else torch.bfloat16)
        with SampleHook(want=want_b, follow_until=10, keep=9) as hook:
            p.generate_codes(*request, seed=0)
        logits[label] = torch.stack(hook.kept).float()
    del fp32_model
    err, gap = (norm_rel(logits["fused_qkv"], logits["source"]),
                norm_rel(logits["source"], logits["fp32"]))
    print(f"  fused_qkv logits of the prefill and 8 decode steps vs the source: norm-rel "
          f"{err:.3e}; the bf16 model vs its fp32 copy {gap:.3e}; limit half of that")
    need(err <= 0.5 * gap, f"fused_qkv logits: {err:.3e} > 0.5 x {gap:.3e}")
    t0 = time.perf_counter()
    out = fqkv.generate_codes(*request, seed=0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if torch.equal(out.delayed_ids, want_b):
        print(f"  fused_qkv B=2 serve: {(out.steps - 2) / wall:.1f} decode steps/s, the {out.steps} "
              f"columns equal phase (b)'s ({card})")
    else:
        with SampleHook(want=want_b) as hook:
            fqkv.generate_codes(*request, seed=0)
        print(f"  fused_qkv B=2 serve: {(out.steps - 2) / wall:.1f} decode steps/s, parts "
              f"from phase (b) at columns {sorted({p[0] for p in hook.partings})} ({card})")
        near_ties("fused_qkv", hook.partings,
                  lambda: source.generate_codes(*request, seed=0), want_b, need)
    del fqkv

    # ---- bf16 codec: decode_codes of phase (b)'s codes. It computes in fp32
    # over bf16-rounded weights (the JAX codec's semantics): the same audio as
    # the fp32 codec given those weights. Random full-size DAC weights drive
    # conv_out to about +-33 before the tanh, where rounding flips saturated
    # samples, so the relative-RMS bound is held on a copy whose conv_out is
    # scaled into the unit range, as tests/test_torch_models.py does for a
    # random codec (`output_in_unit_range`); the raw figure is printed too.
    def decode(dac, **kw):
        p = ParlerTTSPipeline(source.model, dac, gen, **pipe_kw, **kw)
        p.decode_codes(out_b.codes, out_b.lengths)  # warm-up
        t0 = time.perf_counter()
        audio = p.decode_codes(out_b.codes, out_b.lengths)[0]
        return audio, time.perf_counter() - t0

    def rel_rms(a, b):
        return float(np.sqrt(np.mean((a - b) ** 2)) / (np.sqrt(np.mean(b ** 2)) + 1e-9))

    a32, s32 = decode(source.dac)
    a16, s16 = decode(source.dac, codec_dtype=torch.bfloat16)
    rounded, _ = decode(copy.deepcopy(source.dac).to(torch.bfloat16).float())
    unit = copy.deepcopy(source.dac)
    with torch.no_grad():
        unit.decoder.conv_out.weight /= 32.0
    u32, _ = decode(unit)
    u16, _ = decode(unit, codec_dtype=torch.bfloat16)
    exact, rel_raw, rel_unit = float(np.abs(a16 - rounded).max()), rel_rms(a16, a32), \
        rel_rms(u16, u32)
    print(f"  codec_dtype=bf16: audio {a16.dtype} {a16.shape}; max |diff| from the fp32 codec "
          f"over bf16-rounded weights {exact:.1e}; relative RMS vs the fp32 codec {rel_raw:.4f} "
          f"(saturated output), {rel_unit:.4f} with conv_out in the unit range (limit "
          f"{CODEC_REL_RMS}); decode_codes {s32:.3f} s fp32, {s16:.3f} s bf16 ({card})")
    need(a16.dtype == np.float32 and exact <= 1e-5 and rel_unit < CODEC_REL_RMS,
         f"bf16 codec: dtype {a16.dtype}, {exact}, {rel_unit}")
    del unit

    # ---- sliding window over the static cache, 512 columns: the dense bias
    # path with the window in the mask. Held in fp32, against the static path
    # (K1) in fp32: in bf16 the two attention paths' rounding moves the logits
    # by more than the 2e-4 tie bound, in fp32 by far less.
    span = S_PROMPT + WINDOW_COLUMNS
    static_gen = dataclasses.replace(gen, max_length=WINDOW_COLUMNS,
                                     min_new_tokens=WINDOW_COLUMNS)
    windowed = dataclasses.replace(static_gen, cache_implementation="sliding_window")
    fp32 = dict(device=dev, cache_dtype=torch.float32)

    def fp32_pipe(window, gen_):
        wcfg = dataclasses.replace(cfg, decoder=dataclasses.replace(cfg.decoder,
                                                                    sliding_window=window))
        model = ParlerTTS(wcfg, device=dev, dtype=torch.float32)
        load_jax_params(model, tensor_tree(source.model))
        return ParlerTTSPipeline(model, source.dac, gen_, **fp32)

    static = fp32_pipe(None, static_gen)
    want_s = static.generate_codes(*request, seed=0).delayed_ids
    free_from = WINDOW_COLUMNS - cfg.decoder.num_codebooks + 1  # the pattern's PAD tail
    streams = {}
    for w in (span, WINDOW):
        p = fp32_pipe(w, windowed)
        # the window first drops a slot at column w - S_PROMPT + 1 (slot 0 of row 0)
        until = min(free_from, w - S_PROMPT + 1)
        flash_decode_attention.launches = 0
        t0 = time.perf_counter()
        with SampleHook(want=want_s, follow_until=until) as hook:
            out = p.generate_codes(*request, seed=0)
        wall = time.perf_counter() - t0
        k1 = flash_decode_attention.launches
        streams[w] = out.delayed_ids
        print(f"  sliding window {w}, fp32: {out.steps} columns ({(out.steps - 2) / wall:.1f} "
              f"decode steps/s, synced each step), K1 launches {k1}, NaN in the logits "
              f"{hook.nan}; columns < {until} part from the static path at "
              f"{sorted({x[0] for x in hook.partings})}; first parting from {until} on: "
              f"{hook.first_free_parting} ({card})")
        need(not k1 and not hook.nan and out.steps == WINDOW_COLUMNS,
             f"sliding window {w}: K1 {k1}, NaN {hook.nan}")
        near_ties(f"window {w}", hook.partings,
                  lambda: static.generate_codes(*request, seed=0), want_s, need)
        if w == WINDOW:
            first = WINDOW - S_PROMPT + 1
            same_before = torch.equal(streams[w][:, :, :first], streams[span][:, :, :first])
            parted = hook.first_free_parting
            print(f"  window {WINDOW} vs window {span}: columns < {first} equal: {same_before}; "
                  f"parts from the static path at column {parted}")
            need(same_before and parted is not None and parted < free_from,
                 f"window {WINDOW}: equal before {first} {same_before}, parts at {parted}")
        del p
    del static

    # ---- text input through a stub tokenizer: bytes mod 32000
    text_gen = dataclasses.replace(gen, max_length=TEXT_COLUMNS, min_new_tokens=TEXT_COLUMNS)
    p = ParlerTTSPipeline(source.model, source.dac, text_gen, tokenizer=stub_tokenizer,
                          **pipe_kw)
    descs = ["A calm female voice, close to the microphone.", "A fast, bright male voice."]
    prompts = ["Hello from the card.", "Served from a saved checkpoint, through a tokenizer."]
    a_text, l_text = p.generate(descs, prompts)
    desc_ids, desc_mask = p._encode_text(descs, left_pad=False)
    prompt_ids, prompt_mask = p._encode_text(prompts, left_pad=True)
    a_ids, l_ids = p.generate(desc_ids, prompt_ids, desc_mask=desc_mask, prompt_mask=prompt_mask)
    same = np.array_equal(a_text, a_ids) and np.array_equal(l_text, l_ids)
    print(f"  text input: ids {desc_ids.shape} / {prompt_ids.shape} (padded to 16), "
          f"{TEXT_COLUMNS} columns, audio {a_text.shape} equal to generate on the ids: {same}")
    need(same and bool(np.isfinite(a_text).all()), "text input: generate(text) != generate(ids)")
    if failed:
        raise AssertionError(f"phase (j): {len(failed)} checks failed: {failed}")


# ------------------------------------------------------------ voice side
ENCODE_TIE = 1e-5    # RVQ: a best-to-second distance gap below this is a near-tie
LATENT_REL = 1e-4    # DAC encoder latents against the CPU's, norm-relative
VOICE_SECONDS, PLAY_STEPS, PCM_COLUMNS = 3.0, 86, 256


def encode_gaps(quantizer, latents, codes):
    """(B, K, T') gaps between the best and the second-best distance of each
    choice of the greedy quantization that gave `codes` from `latents`
    (either codec's quantizer: its `distances` and `quantized`)."""
    residual, gaps = latents, []
    for k in range(codes.shape[1]):
        two = quantizer.distances(residual, k).topk(2, dim=-1, largest=False).values
        gaps.append(two[..., 1] - two[..., 0])
        residual = residual - quantizer.quantized(k, codes[:, k])
    return torch.stack(gaps, dim=1)


def codes_agree(got, want, gaps):
    """(whether codes `got` (B, K, T') may stand for the reference `want`,
    the frames where they part): in each frame they agree up to the first
    codebook where they part, and that choice is a near-tie of the reference
    (its `gaps` below ENCODE_TIE); the codebooks after it quantize another
    residual, so they may part too."""
    differ = got.cpu() != want.cpu()
    parts = differ.any(dim=1)  # (B, T')
    first = differ.to(torch.int8).argmax(dim=1, keepdim=True)
    tie = gaps.cpu().gather(1, first)[:, 0] < ENCODE_TIE
    return bool((~parts | tie).all()), int(parts.sum())


def voice_clips(sampling_rate: int, n: int, seed: int = 0):
    """Two seeded synthetic clips (2, n) float32: a chord and a noisy glide."""
    import numpy as np

    rng = np.random.default_rng(seed)
    t = np.arange(n) / sampling_rate
    chord = 0.2 * (np.sin(2 * np.pi * 220 * t) + np.sin(2 * np.pi * 277 * t))
    glide = 0.3 * np.sin(2 * np.pi * (150 + 40 * t) * t) + 0.05 * rng.normal(size=t.size)
    return np.stack([chord, glide]).astype(np.float32)


class ChunkRecorder:
    """Wraps a pipeline's stream functions (a check instrument): keeps the
    columns the prefill gives and each chunk adds, whose concatenation is the
    stream's tokens."""

    def __init__(self, pipe):
        self.pipe, self.real = pipe, pipe._ensure_stream_fns()
        prefill, step = self.real
        self.parts = []

        def recording_prefill(*args, **kw):
            state = prefill(*args, **kw)
            self.parts = [state.out_ids[:, :, :state.t].clone()]
            return state

        def recording_step(state, n_steps):
            t0 = state.t
            step(state, n_steps)
            self.parts.append(state.out_ids[:, :, t0:state.t].clone())
            return state

        pipe._stream_fns = (recording_prefill, recording_step)

    def tokens(self):
        self.pipe._stream_fns = self.real
        return torch.cat(self.parts, dim=-1)


def encode_check(pipe, audio, card):
    """`encode_voice_prompt` on the card against the fp32 encode of the same
    codec on the CPU: latents within LATENT_REL, codes equal but at the CPU's
    near-ties. Returns the codes."""
    import copy

    hop = pipe.config.audio_encoder.hop_length
    pipe.encode_voice_prompt(audio[:, :8 * hop])  # first use of the encoder's shapes
    torch.cuda.synchronize()
    encode_s = []
    for _ in range(2):  # the first call at this shape, then again
        t0 = time.perf_counter()
        codes = pipe.encode_voice_prompt(audio)
        torch.cuda.synchronize()
        encode_s.append(time.perf_counter() - t0)
    x = torch.nn.functional.pad(torch.from_numpy(audio)[:, :, None],
                                (0, 0, 0, -audio.shape[1] % hop))
    cpu = copy.deepcopy(pipe.dac).cpu()
    with torch.inference_mode():
        lat_cpu = cpu.encoder(x)
        codes_cpu = cpu.quantizer.encode(lat_cpu)[0]
        gaps = encode_gaps(cpu.quantizer, lat_cpu, codes_cpu)
        lat_rel = norm_rel(pipe.dac.encoder(x.to(pipe.device)).cpu(), lat_cpu)
    ok, parted = codes_agree(codes, codes_cpu, gaps)
    n_ties = int((gaps < ENCODE_TIE).sum())
    print(f"  encode_voice_prompt {tuple(audio.shape)} at {pipe.config.sampling_rate} Hz -> codes "
          f"{tuple(codes.shape)} in {encode_s[0] * 1e3:.1f} ms, again {encode_s[1] * 1e3:.1f} ms "
          f"({card}); latents vs the CPU's fp32 "
          f"encode norm-rel {lat_rel:.2e} (limit {LATENT_REL:g}); codes equal to the CPU's: "
          f"{torch.equal(codes.cpu(), codes_cpu)}, frames parted {parted}, all at the CPU's "
          f"near-ties (gap < {ENCODE_TIE:g}; {n_ties} such choices): {ok}")
    if lat_rel > LATENT_REL or not ok:
        raise AssertionError(f"voice encode: latents {lat_rel:.2e}, codes parted at {parted} "
                             f"frames, near-ties only: {ok}")
    return codes


def phase_k(dev, card, source):
    """Voice-steered streaming on phase (b)'s mini-v1: a seeded 3 s clip
    encoded on the card against the CPU; `stream` (B=1) and `stream_batch`
    (B=2) with its codes as voice prompt, their tokens equal to
    `generate_codes` on the same request and K1 24 a decode step;
    `pcm_stream` through the native ring buffer. Returns the stream's
    numbers."""
    import dataclasses

    import numpy as np

    from parler_tts_tpu_torch.native import float_to_pcm16, float_to_pcm16_plain
    from parler_tts_tpu_torch.ops.flash_decode import flash_decode_attention
    from parler_tts_tpu_torch.runtime.pipeline import ParlerTTSPipeline
    from parler_tts_tpu_torch.runtime.streamer import ParlerTTSStreamer

    pipe, cfg = source, source.config
    hop, n_layers = cfg.audio_encoder.hop_length, cfg.decoder.num_hidden_layers
    codes = encode_check(pipe, voice_clips(cfg.sampling_rate,
                                           int(VOICE_SECONDS * cfg.sampling_rate)), card)
    s0 = 1 + codes.shape[-1]
    decode_steps = MAX_LENGTH - s0 - 1
    request = request_ids(0)
    row0 = tuple(x[:1] for x in request)
    warm = pipe.warmup_stream_async(*row0, play_steps=PLAY_STEPS, decoder_prompt_codes=codes[:1])
    warm.join()

    out = {}
    for label, req, steer in (("stream B=1", row0, codes[:1]), ("stream_batch B=2", request,
                                                                  codes)):
        rec = ChunkRecorder(pipe)
        flash_decode_attention.launches = 0
        chunks, first, got = [], None, np.zeros(steer.shape[0], np.int64)
        t0 = time.perf_counter()
        if steer.shape[0] == 1:
            for chunk in pipe.stream(*req, play_steps=PLAY_STEPS, decoder_prompt_codes=steer):
                first = first or time.perf_counter() - t0
                chunks.append(chunk)
                got += chunk.shape[1]
        else:
            for chunk, valid in pipe.stream_batch(*req, play_steps=PLAY_STEPS,
                                                  decoder_prompt_codes=steer):
                first = first or time.perf_counter() - t0
                chunks.append(chunk)
                got += valid
        wall = time.perf_counter() - t0
        k1 = flash_decode_attention.launches
        tokens = rec.tokens()
        offline = pipe.generate_codes(*req, decoder_prompt_codes=steer)
        same = torch.equal(tokens, offline.delayed_ids)
        want_samples = offline.lengths.cpu().numpy() * hop
        print(f"  {label}, voice prompt {codes.shape[-1]} frames, {MAX_LENGTH} columns: first "
              f"chunk after {first:.3f} s, {len(chunks)} chunks, {decode_steps / wall:.1f} "
              f"decode steps/s over the stream ({wall:.2f} s, codec flushes included) ({card})")
        print(f"    tokens equal to generate_codes: {same}; samples {got.tolist()} = "
              f"{want_samples.tolist()}: {bool((got == want_samples).all())}; K1 launches {k1} "
              f"= {n_layers} x {decode_steps}: {k1 == n_layers * decode_steps}; audio finite "
              f"{bool(np.isfinite(np.concatenate(chunks, axis=1)).all())}")
        if (not same or (got != want_samples).any() or k1 != n_layers * decode_steps
                or not np.isfinite(np.concatenate(chunks, axis=1)).all()):
            raise AssertionError(f"{label}: tokens equal {same}, samples {got} vs "
                                 f"{want_samples}, K1 {k1}")
        out[label] = dict(first_chunk_s=first, steps_per_s=decode_steps / wall,
                          chunks=len(chunks), launches=k1)

    # PCM through the native ring buffer, over PCM_COLUMNS columns
    short = ParlerTTSPipeline(pipe.model, pipe.dac, dataclasses.replace(
        pipe.generation_config, max_length=PCM_COLUMNS, min_new_tokens=PCM_COLUMNS),
        cache_dtype=torch.bfloat16, device=dev)
    chunks = list(short.stream(*row0, play_steps=PLAY_STEPS))
    want = b"".join(float_to_pcm16(c[0]) for c in chunks)
    pcm = b"".join(ParlerTTSStreamer(short, play_steps=PLAY_STEPS).pcm_stream(*row0))
    plain = b"".join(float_to_pcm16_plain(c[0]) for c in chunks)
    print(f"  pcm_stream over {PCM_COLUMNS} columns: {len(pcm)} bytes in {len(chunks)} chunks, "
          f"equal to float_to_pcm16 of the stream's chunks: {pcm == want}, and to its numpy "
          f"version: {want == plain}")
    if pcm != want or want != plain or not pcm:
        raise AssertionError("pcm_stream bytes differ from the stream's chunks")
    return out


# ------------------------------------------------------------ large-v1 side
LARGE_COLUMNS = 256


def large_v1_config():
    from parler_tts_tpu_torch.config import ParlerTTSConfig, large_v1_decoder_config

    return ParlerTTSConfig(decoder=large_v1_decoder_config())


def bound(bytes_moved, ops, ops_per_s):
    byte_s, op_s = bytes_moved / HBM_BYTES_PER_S, ops / ops_per_s
    return max(byte_s, op_s) * 1e3, "bytes" if byte_s >= op_s else "operations"


def large_k1(dev, card):
    """K1 at large-v1's H=24 over the 868-slot stacked cache of 30 layers."""
    import torch.nn.functional as F

    from parler_tts_tpu_torch.ops.flash_decode import (
        flash_decode_attention,
        flash_decode_attention_plain,
        split_count,
    )

    cfg = large_v1_config().decoder
    g = torch.Generator(device=dev).manual_seed(11)
    h, dh, n_layers, b = cfg.num_attention_heads, cfg.head_dim, cfg.num_hidden_layers, BATCH

    def rand(*shape, dtype):
        return (torch.randn(shape, generator=g, device=dev) * 0.3).to(dtype)

    starts = torch.tensor([0, 3], dtype=torch.int32, device=dev)
    max_err = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        cache_k = rand(n_layers, b, K_SLOTS, h * dh, dtype=dtype)
        cache_v = rand(n_layers, b, K_SLOTS, h * dh, dtype=dtype)
        cases = [(f"limit={n} layer {layer}", rand(b, h, dh, dtype=dtype), n, layer)
                 for n in (1, 65, 434, 867, K_SLOTS) for layer in (0, n_layers - 1)]
        cases.append(("W=4 window", rand(b, 4, h, dh, dtype=dtype), K_SLOTS - 3, n_layers - 1))
        for name, q, limit, layer in cases:
            got = flash_decode_attention(q, cache_k, cache_v, starts, limit, layer=layer)
            torch.cuda.synchronize()
            splits = split_count(b, h, K_SLOTS, q.shape[1] if q.dim() == 4 else 1)
            want = flash_decode_attention_plain(q, cache_k, cache_v, starts, limit, layer=layer,
                                                splits=splits)
            err = (got.float() - want.float()).abs().max().item()
            torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])
            if not torch.equal(flash_decode_attention(q, cache_k, cache_v, starts, limit,
                                                      layer=layer), got):
                raise AssertionError(f"K1 large-v1 {name}: a second call gave other bits")
            max_err = max(max_err, err)
        if dtype == torch.float32:  # a result without the first slot fails the fp32 tolerance
            q = cases[6][1]
            got = flash_decode_attention(q, cache_k, cache_v, starts, 434, layer=0)
            dropped = flash_decode_attention_plain(q, cache_k, cache_v, starts + 1, 434,
                                                   layer=0, splits=split_count(b, h, K_SLOTS, 1))
            if torch.allclose(got, dropped, **TOL[dtype]):
                raise AssertionError("K1 large-v1: fp32 TOL does not see the first slot left out")
        print(f"  K1 at H={h} vs plain {str(dtype)[6:]}: {len(cases)} cases (starts 0/3, "
              f"stacked layers 0 and {n_layers - 1}, W=4) within TOL, max_abs_err "
              f"{max_err:.3e}, repeats "
              f"bit-identical, {split_count(b, h, K_SLOTS, 1)} splits"
              + ("; a dropped first slot fails fp32 TOL" if dtype == torch.float32 else ""))
        del cache_k, cache_v

    cache_k = rand(n_layers, b, K_SLOTS, h * dh, dtype=torch.bfloat16)
    cache_v = rand(n_layers, b, K_SLOTS, h * dh, dtype=torch.bfloat16)
    q = rand(b, h, dh, dtype=torch.bfloat16)
    zeros = torch.zeros(b, dtype=torch.int32, device=dev)
    k_views = [cache_k[i].view(b, K_SLOTS, h, dh).transpose(1, 2) for i in range(n_layers)]
    v_views = [cache_v[i].view(b, K_SLOTS, h, dh).transpose(1, 2) for i in range(n_layers)]
    ms = graph_ms(lambda i: flash_decode_attention(q, cache_k, cache_v, zeros, K_SLOTS,
                                                   layer=i % n_layers), n_layers)
    sdpa_ms = graph_ms(lambda i: F.scaled_dot_product_attention(
        q.view(b, h, 1, dh), k_views[i % n_layers], v_views[i % n_layers], scale=1.0), n_layers)
    plain_ms = cuda_ms(lambda i: flash_decode_attention_plain(
        q, cache_k, cache_v, zeros, K_SLOTS, layer=i % n_layers,
        splits=split_count(b, h, K_SLOTS, 1)), iters=60)
    bound_ms, bound_by = bound(2 * b * h * dh * 2 + 2 * b * K_SLOTS * h * dh * 2,
                               4 * b * h * K_SLOTS * dh, BF16_OPS_PER_S)
    print(f"  K1 large-v1 B=2 bf16 868 slots: {ms * 1e3:.2f} us by graph replay of {n_layers} "
          f"launches, "
          f"SDPA {sdpa_ms * 1e3:.2f} us, plain {plain_ms * 1e3:.2f} us, bound "
          f"{bound_ms * 1e3:.2f} us ({bound_by}; {bound_ms / ms:.1%} of it) ({card})")
    return dict(ms=ms, plain_ms=plain_ms, library_ms=sdpa_ms, bound_ms=bound_ms,
                bound_by=bound_by, max_abs_err=max_err)


def large_k2(dev, card):
    """K2 at large-v1's K x N = D x D, D x F and F x D (1536 x 1536, 1536 x
    6144, 6144 x 1536), 6, 1 and 1 launches a layer."""
    from parler_tts_tpu_torch.ops.quant_matmul import quant_matmul, quant_matmul_plain

    cfg = large_v1_config().decoder
    d, f, n_layers = cfg.hidden_size, cfg.ffn_dim, cfg.num_hidden_layers
    shapes = ((d, d), (d, f), (f, d))
    g = torch.Generator(device=dev).manual_seed(12)

    def int8(*shape):
        return torch.randint(-127, 128, shape, generator=g, device=dev,
                             dtype=torch.int32).to(torch.int8)

    def scales(n):
        return torch.rand(n, generator=g, device=dev) * 0.009 + 1e-3

    max_err = 0.0
    for m in (1, BATCH, 18):  # B=1 and B=2 decode, B=2 prefill of 8 + 1 columns
        for k, n in shapes:
            w, s = int8(k, n), scales(n)
            for dtype in (torch.float32, torch.bfloat16):
                x = (torch.randn(m, k, generator=g, device=dev) * 0.3).to(dtype)
                err, slices, slice_ = k2_check(x, w, s, f"K2 large-v1 {dtype} M={m} K={k} N={n}")
                max_err = max(max_err, err)
            print(f"  K2 large-v1 M={m:2d} K={k} N={n}: {slices} x {slice_}-row slices, fp32 and "
                  f"bf16 within k2_close, repeats bit-identical, a dropped slice outside")

    layers = [[(int8(k, n), scales(n)) for (k, n), per in zip(shapes, (6, 1, 1))
               for _ in range(per)] for _ in range(n_layers)]
    xs = {k: torch.randn(BATCH, k, generator=g, device=dev).to(torch.bfloat16) for k in (d, f)}

    def k2_layer(i):
        for w, s in layers[i]:
            quant_matmul(xs[w.shape[0]], w, s)

    def plain_layer(i):
        for w, s in layers[i % n_layers]:
            quant_matmul_plain(xs[w.shape[0]], w, s)

    ms = graph_ms(k2_layer, n_layers)
    plain_ms = device_ms(plain_layer, iters=n_layers)
    deq = [[w.to(torch.bfloat16) for w, _ in layer] for layer in layers]

    def mm_layer(i):
        for w in deq[i]:
            torch.matmul(xs[w.shape[0]], w)

    library_ms = graph_ms(mm_layer, n_layers)
    weights = sum(w.numel() for w, _ in layers[0])
    small = sum(BATCH * w.shape[0] * 2 + s.numel() * 4 + BATCH * w.shape[1] * 2
                for w, s in layers[0])
    bound_ms, bound_by = bound(weights + small, 2 * BATCH * weights, INT8_OPS_PER_S)
    print(f"  K2 large-v1, one decode layer's 8 launches at M=2 ({weights / 1e6:.2f} MB of "
          f"int8): {ms * 1e3:.2f} us by graph replay over {n_layers} layers, bf16 matmul "
          f"{library_ms * 1e3:.2f} us, plain {plain_ms * 1e3:.2f} us, bound "
          f"{bound_ms * 1e3:.2f} us ({bound_by}; {bound_ms / ms:.1%} of it) ({card})")
    return dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms,
                bound_by=bound_by, max_abs_err=max_err)


def large_k3(dev, card):
    """K3 at large-v1 (D=1536, F=6144, H=24, 30 layers) against its plain
    version layer by layer within `fused_limits`, at n_rows 1, 434 and 867
    from starts 0 and 3; a dropped first or last cache row must fail."""
    from parler_tts_tpu_torch.models.decoder import ParlerDecoder
    from parler_tts_tpu_torch.models.layers import init_weights
    from parler_tts_tpu_torch.ops.fused_decode_step import (
        CUDA_CHUNK,
        fused_close,
        fused_decode_layers,
        fused_decode_layers_plain,
        fused_gaps,
        fused_limits,
        launch_plan,
        prepare_fused_params,
    )

    cfg = large_v1_config().decoder
    g = torch.Generator(device=dev).manual_seed(13)
    decoder = ParlerDecoder(cfg, device=dev, dtype=torch.bfloat16)
    init_weights(decoder, g)
    fp = prepare_fused_params(decoder)
    del decoder
    n_layers, d, s_enc = cfg.num_hidden_layers, cfg.hidden_size, 16

    def bf16(*shape):
        return (torch.randn(shape, generator=g, device=dev) * 0.5).to(torch.bfloat16)

    cache_k, cache_v = bf16(n_layers, K_SLOTS, d), bf16(n_layers, K_SLOTS, d)
    cross_k, cross_v, x = bf16(n_layers, s_enc, d), bf16(n_layers, s_enc, d), bf16(1, d)
    enc_bias = torch.zeros(1, s_enc, device=dev)
    enc_bias[0, 12:] = torch.finfo(torch.float32).min
    plan = launch_plan(cfg)
    print(f"  K3 large-v1 launch: {plan['blocks']} blocks of {plan['threads']} threads, "
          f"{plan['stages']} x {plan['stage_bytes']} B ring stages")

    def args(start, n_rows):
        return (cfg, fp, x, cache_k, cache_v, cross_k, cross_v, enc_bias, start, n_rows)

    def plain(start, n_rows, **kw):
        return fused_decode_layers_plain(*args(start, n_rows), block_s=CUDA_CHUNK, tiling="cuda",
                                         **kw)

    mean, last = K_SLOTS // 2, K_SLOTS - 1  # 434 and 867: an 860-column run's mean and last step
    cases = [(s, n) for s in (0, 3) for n in (1, mean, last)]
    got, want, noise = {}, {}, {}
    for case in cases:
        got[case] = fused_decode_layers(*args(*case))
        torch.cuda.synchronize()
        want[case] = plain(*case)
        noise[case] = fused_gaps(plain(*case, dtype=torch.float64), want[case])
    limits = fused_limits(torch.stack(list(noise.values())))
    gaps = torch.stack([fused_gaps(got[c], want[c]) for c in cases])
    max_abs = max((a.float() - b.float()).abs().max().item()
                  for c in cases for a, b in zip(got[c], want[c]))
    worst = (gaps / limits[0]).max().item()
    median = gaps[:, 1].median().item() / limits[1]
    print(f"  K3 large-v1 vs plain over {len(cases)} cases (start, n_rows) {cases}: worst slice "
          f"{worst:.2f} x its limit, median at layer 1 {median:.2f} x its limit, max abs "
          f"{max_abs:.3e}; limits from the plain version's fp32-vs-float64 noise (largest "
          f"{limits[0].max().item():.2e})")
    if not fused_close(gaps, limits):
        raise AssertionError(f"K3 large-v1 exceeds its limits: {worst:.2f} x, {median:.2f} x")
    long = [c for c in cases if c[1] >= mean]
    for label, cut in (("first", lambda s, n: (s + 1, n)), ("last", lambda s, n: (s, n - 1))):
        broken = torch.stack([fused_gaps(fused_decode_layers(*args(*cut(*c))), want[c])
                              for c in long])
        print(f"  K3 large-v1 negative check, the {label} cache row dropped at n_rows {mean} "
              f"and {last}: worst slice {(broken / limits[0]).max().item():.2f} x its limit, "
              f"median at layer 1 {broken[:, 1].median().item() / limits[1]:.2f} x its limit")
        if fused_close(broken, limits):
            raise AssertionError(f"K3 large-v1: a dropped {label} cache row passes the limits")
    first = fused_decode_layers(*args(3, last))
    if not all(all(torch.equal(a, b) for a, b in zip(fused_decode_layers(*args(3, last)), first))
               for _ in range(20)):
        raise AssertionError("K3 large-v1: a repeat gave other bits")

    bounds = [torch.tensor(v, dtype=torch.int32, device=dev) for v in (3, mean)]
    ms = graph_ms(lambda i: fused_decode_layers(*args(*bounds)), n=10)
    plain_ms = device_ms(lambda i: plain(3, mean), iters=3, warmup=1)
    weights = fp.w_attn.numel() + fp.wfc1.numel() + fp.wfc2.numel()
    small = 4 * (fp.s_attn.numel() + fp.sfc1.numel() + fp.sfc2.numel() + 6 * n_layers * d)
    rows = mean - 3
    bytes_moved = (weights + small + 2 * n_layers * rows * d * 2 + 2 * n_layers * s_enc * d * 2
                   + s_enc * 4 + d * 2 * 2 + 2 * n_layers * d * 2)
    bound_ms, bound_by = bound(bytes_moved, 2 * weights + 4 * n_layers * (rows + 1 + s_enc) * d,
                               INT8_OPS_PER_S)
    print(f"  K3 large-v1, {n_layers} layers at {mean} cache rows: {ms:.4f} ms by CUDA-graph "
          f"replay of 10 launches, plain {plain_ms:.2f} ms, bound {bound_ms:.4f} ms ({bound_by}: "
          f"{bytes_moved / 1e6:.1f} MB; {bound_ms / ms:.1%} of it); 20 repeats bit-identical "
          f"({card})")
    return dict(ms=ms, plain_ms=plain_ms, library_ms=None, bound_ms=bound_ms, bound_by=bound_by,
                max_abs_err=max_abs, max_norm_rel_err=gaps.max().item())


def large_serve(dev, card):
    """large-v1 served over LARGE_COLUMNS greedy columns on the three paths,
    with exact launch counts; returns them, the eager pipeline and its
    output (phase m holds its speculative run to them)."""
    import dataclasses

    from parler_tts_tpu_torch.config import GenerationConfig
    from parler_tts_tpu_torch.ops.flash_decode import flash_decode_attention
    from parler_tts_tpu_torch.ops.fused_decode_step import fused_decode_layers
    from parler_tts_tpu_torch.ops.quant_matmul import quant_matmul
    from parler_tts_tpu_torch.runtime.pipeline import ParlerTTSPipeline

    cfg = large_v1_config()
    gen = GenerationConfig(max_length=LARGE_COLUMNS, min_new_tokens=LARGE_COLUMNS,
                           do_sample=False, codebook_guard=1024)
    bf16 = dict(device=dev, dtype=torch.bfloat16, cache_dtype=torch.bfloat16)
    request = request_ids(0)
    n_layers = cfg.decoder.num_hidden_layers
    decode_steps = LARGE_COLUMNS - 2
    t0 = time.perf_counter()
    eager = ParlerTTSPipeline.from_random(cfg, seed=0, generation_config=gen, **bf16)
    int8 = ParlerTTSPipeline.from_random(cfg, seed=0, generation_config=gen, weight_quant=True,
                                         **bf16)
    fused = ParlerTTSPipeline(eager.model, eager.dac, gen, cache_dtype=torch.bfloat16,
                              device=dev, fused_decode=True)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in eager.model.parameters())
    print(f"  large-v1 ({n_params / 1e6:.1f}M parameters + codec) in bf16, int8 and fused on the "
          f"card: {time.perf_counter() - t0:.2f} s")
    launches = {}
    for label, pipe, req, want in (
            ("eager bf16 B=2", eager, request, dict(k1=n_layers * decode_steps, k2=0, k3=0)),
            ("int8 B=2", int8, request, dict(k1=n_layers * decode_steps,
                                             k2=8 * n_layers * (decode_steps + 1) + 2 * n_layers,
                                             k3=0)),
            ("fused B=1", fused, tuple(x[1:2] for x in request),
             dict(k1=0, k2=0, k3=decode_steps))):
        warm = ParlerTTSPipeline(pipe.model, pipe.dac, dataclasses.replace(
            gen, max_length=40, min_new_tokens=40), cache_dtype=torch.bfloat16, device=dev,
            fused_decode=pipe.fused is not None)
        warm.decode_codes(*warm.generate_codes(*req)[1:3])
        torch.cuda.synchronize()
        flash_decode_attention.launches = quant_matmul.launches = 0
        fused_decode_layers.launches = 0
        served = serve(pipe, req, f"large-v1 {label}", card)[0]
        if pipe is eager:
            eager_out = served.delayed_ids
        got = dict(k1=flash_decode_attention.launches, k2=quant_matmul.launches,
                   k3=fused_decode_layers.launches)
        print(f"    launches {got} = {want}: {got == want}")
        if got != want:
            raise AssertionError(f"large-v1 {label}: launches {got}, want {want}")
        launches[label] = got
    del int8, fused
    torch.cuda.empty_cache()
    return dict(k1=launches["eager bf16 B=2"]["k1"], k2=launches["int8 B=2"]["k2"],
                k3=launches["fused B=1"]["k3"]), eager, eager_out


def phase_l(dev, card):
    """large-v1 at full width and depth on the card: K1, K2 and K3 against
    their plain versions at its shapes, one fp32 decode step through K1
    against the dense path, and the three serving paths with exact launch
    counts. Returns each kernel's large-v1 numbers, the eager pipeline and
    its output."""
    out = dict(k1=large_k1(dev, card), k2=large_k2(dev, card), k3=large_k3(dev, card))
    torch.cuda.empty_cache()
    phase_c(dev, card, large_v1_config())
    launches, eager, eager_out = large_serve(dev, card)
    for key, n in launches.items():
        out[key]["launches"] = n
    return out, eager, eager_out


# ---------------------------------------------------------- speculative side
SPEC_WINDOW, SPEC_LOOKUP, SPEC_WINDOW_LARGE = 24, 3, 16
SAMPLED_COLUMNS, DECODER_ONLY_COLUMNS = 256, 256


def window_tie(label, model, dev, w):
    """The near-tie limit of a greedy speculative run of `model` held to its
    AR run, read like for like: over window_vs_steps' 4 x W columns, the
    largest change, from the one-column steps to the window forwards, of the
    gap between the steps' top two logits (each row, codebook and column)."""
    window, steps = window_vs_steps(model, dev, w, 4)
    moved = top_two_moves(steps, window)
    q = moved.flatten().quantile(torch.tensor([0.5, 0.99], device=dev)).tolist()
    tie = moved.max().item()
    print(f"  {label} near-tie limit: the window forward moves the steps' top-two gap by at most "
          f"{tie:.3e} (median {q[0]:.3e}, 99% {q[1]:.3e}) over {moved.numel()} rows, codebooks "
          f"and columns at W={w}")
    return tie


def window_dropped_slot(q, cache_k, cache_v, layer, label):
    """The window kernel's negative check in its own dtype, bf16: over a short
    range (row 0's last column sees W + 5 slots, row 1's W + 6) the kernel
    passes TOL against its plain version, and a result whose last column
    lacks its last slot must fail it. Returns that result's largest gap."""
    from parler_tts_tpu_torch.ops.flash_decode import (
        flash_decode_attention,
        flash_decode_attention_plain,
        kernel_split_count,
    )

    b, w, h, dh = q.shape
    s, h_kv = cache_k.shape[2], cache_k.shape[3] // dh
    dev = q.device
    starts = torch.tensor([0, 3][:b], dtype=torch.int32, device=dev)
    limits = torch.tensor([6, 10][:b], dtype=torch.int32, device=dev)
    got = flash_decode_attention(q, cache_k, cache_v, starts, limits, layer=layer)
    splits = kernel_split_count(cache_k.dtype, b, h, h_kv, s, w, dh)
    want = flash_decode_attention_plain(q, cache_k, cache_v, starts, limits, layer=layer,
                                        splits=splits)
    torch.testing.assert_close(got.float(), want.float(), **TOL[torch.bfloat16])
    wrong = want.clone()
    wrong[:, -1] = flash_decode_attention_plain(
        q[:, -1:].contiguous(), cache_k, cache_v, starts, limits + w - 2, layer=layer,
        splits=splits)[:, 0]
    gap = (got.float() - wrong.float()).abs().max().item()
    if torch.allclose(got.float(), wrong.float(), **TOL[torch.bfloat16]):
        raise AssertionError(f"K1 {label}: bf16 TOL does not see the last column's last slot "
                             f"left out (gap {gap:.3e})")
    return gap


def window_k1(dev, card):
    """K1 at the speculative window's shapes: W query columns, per-row (B,)
    limits, the cache s_p + L + W slots long. fp32 runs the split kernel,
    bf16 the window kernel (the route read off the launch counters), each
    held to its plain version at its own split count, with a dropped last
    slot caught (fp32 over the whole range, bf16 over a short one); bf16
    timed by CUDA-graph replay beside SDPA with the equal boolean mask.
    Returns the timings."""
    import torch.nn.functional as F

    from parler_tts_tpu_torch.ops.flash_decode import (
        flash_decode_attention,
        flash_decode_attention_plain,
        k1_route,
        kernel_split_count,
    )

    g = torch.Generator(device=dev).manual_seed(21)
    large = large_v1_config().decoder
    mean = S_PROMPT + K_COLUMNS // 2
    cases = [  # label, H, layers, W, starts, limits at the window's first column
        ("mini-v1 W=24 B=1", 16, 24, SPEC_WINDOW, [3], [mean]),
        ("mini-v1 W=24 B=2", 16, 24, SPEC_WINDOW, [0, 3], [mean + 97, mean]),
        ("large-v1 W=16 B=1", large.num_attention_heads, large.num_hidden_layers,
         SPEC_WINDOW_LARGE, [3], [mean]),
    ]
    out = {}
    for label, h, n_layers, w, starts_l, limits_l in cases:
        b, dh, s = len(starts_l), 64, K_SLOTS + w
        starts = torch.tensor(starts_l, dtype=torch.int32, device=dev)
        limits = torch.tensor(limits_l, dtype=torch.int32, device=dev)
        errs, routes = {}, {}
        for dtype in (torch.float32, torch.bfloat16):
            def rand(*shape):
                return (torch.randn(shape, generator=g, device=dev) * 0.3).to(dtype)

            cache_k, cache_v = rand(n_layers, b, s, h * dh), rand(n_layers, b, s, h * dh)
            q = rand(b, w, h, dh)
            splits = kernel_split_count(dtype, b, h, h, s, w, dh)
            route = k1_route(dtype, 1, w, dh)
            window_before, err = flash_decode_attention.launches_window, 0.0
            for layer in (0, n_layers - 1):
                got = flash_decode_attention(q, cache_k, cache_v, starts, limits, layer=layer)
                torch.cuda.synchronize()
                want = flash_decode_attention_plain(q, cache_k, cache_v, starts, limits,
                                                    layer=layer, splits=splits)
                err = max(err, (got.float() - want.float()).abs().max().item())
                torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])
                if not torch.equal(flash_decode_attention(q, cache_k, cache_v, starts, limits,
                                                          layer=layer), got):
                    raise AssertionError(f"K1 {label}: a second call gave other bits")
            errs[str(dtype)[6:]] = err
            window = flash_decode_attention.launches_window - window_before
            if window != (4 if route == "window" else 0):
                raise AssertionError(f"K1 {label} {dtype}: route {route}, but {window} of 4 "
                                     f"launches on the window kernel")
            routes[str(dtype)[6:]] = route
            if dtype == torch.float32:
                # the last window column without its last slot (limit + W - 2)
                wrong = want.clone()
                wrong[:, -1] = flash_decode_attention_plain(
                    q[:, -1:].contiguous(), cache_k, cache_v, starts, limits + w - 2,
                    layer=n_layers - 1, splits=splits)[:, 0]
                if torch.allclose(got, wrong, **TOL[dtype]):
                    raise AssertionError(f"K1 {label}: fp32 TOL does not see the last column's "
                                         f"last slot left out")
                caught = "the last column's last slot dropped fails fp32 TOL"
            else:
                gap = window_dropped_slot(q, cache_k, cache_v, n_layers - 1, label)
                caught = (f"over limits [6, 10][:B] the last column's last slot dropped moves "
                          f"it by {gap:.3e}, outside bf16 TOL")
            print(f"  K1 {label} {str(dtype)[6:]} on the {route} kernel vs plain at {splits} "
                  f"splits, {n_layers} layers' stacked cache of {s} slots, starts {starts_l}, "
                  f"limits {limits_l}: max_abs_err {err:.3e}, repeats bit-identical; {caught}")
            del cache_k, cache_v

        # bf16 timing over the stacked cache, one launch per layer
        cache_k = (torch.randn(n_layers, b, s, h * dh, generator=g, device=dev) * 0.3).to(
            torch.bfloat16)
        cache_v = (torch.randn(n_layers, b, s, h * dh, generator=g, device=dev) * 0.3).to(
            torch.bfloat16)
        q = (torch.randn(b, w, h, dh, generator=g, device=dev) * 0.3).to(torch.bfloat16)
        pos = torch.arange(s, device=dev)
        mask = ((pos[None, None, :] >= starts[:, None, None])
                & (pos[None, None, :] < limits[:, None, None]
                   + torch.arange(w, device=dev)[None, :, None]))[:, None]   # (B, 1, W, S)
        qs = q.transpose(1, 2)
        k_views = [cache_k[i].view(b, s, h, dh).transpose(1, 2) for i in range(n_layers)]
        v_views = [cache_v[i].view(b, s, h, dh).transpose(1, 2) for i in range(n_layers)]
        splits = kernel_split_count(torch.bfloat16, b, h, h, s, w, dh)
        ms = graph_ms(lambda i: flash_decode_attention(q, cache_k, cache_v, starts, limits,
                                                       layer=i % n_layers), n_layers)
        sdpa_ms = graph_ms(lambda i: F.scaled_dot_product_attention(
            qs, k_views[i % n_layers], v_views[i % n_layers], attn_mask=mask, scale=1.0),
            n_layers)
        plain_ms = cuda_ms(lambda i: flash_decode_attention_plain(
            q, cache_k, cache_v, starts, limits, layer=i % n_layers, splits=splits), iters=24)
        slots = sum(lim + w - 1 - st for st, lim in zip(starts_l, limits_l))
        bytes_moved = 2 * b * w * h * dh * 2 + 2 * slots * h * dh * 2
        ops = 4 * h * dh * sum(lim + i - st for st, lim in zip(starts_l, limits_l)
                               for i in range(w))
        bound_ms, bound_by = bound(bytes_moved, ops, BF16_OPS_PER_S)
        print(f"  K1 {label} bf16 on the {routes['bfloat16']} kernel: {ms * 1e3:.2f} us by graph "
              f"replay of {n_layers} launches, SDPA with the equal boolean mask "
              f"{sdpa_ms * 1e3:.2f} us, plain {plain_ms * 1e3:.2f} us, bound "
              f"{bound_ms * 1e3:.2f} us ({bound_by}: {bytes_moved / 1e6:.2f} MB; "
              f"{bound_ms / ms:.1%} of it), {splits} splits of {b * h} (row, kv head) blocks "
              f"({card})")
        out[label] = dict(ms=ms, plain_ms=plain_ms, library_ms=sdpa_ms, bound_ms=bound_ms,
                          bound_by=bound_by, max_abs_err=errs["bfloat16"],
                          max_abs_err_fp32=errs["float32"], routes=routes, splits=splits)
        del cache_k, cache_v, k_views, v_views
    return out


def fp32_copy(model, dev):
    """An fp32 ParlerTTS holding `model`'s weights."""
    from parler_tts_tpu_torch.convert import load_jax_params, tensor_tree
    from parler_tts_tpu_torch.models.parler import ParlerTTS

    fp32 = ParlerTTS(model.config, device=dev, dtype=torch.float32)
    load_jax_params(fp32, tensor_tree(model))
    return fp32


def spec_serve(pipe, request, label, card):
    """One timed speculative generate_codes + decode_codes; returns (output,
    stats, the wall seconds of generate_codes)."""
    import numpy as np

    t0 = time.perf_counter()
    out = pipe.generate_codes(*request, seed=0)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    audio, lengths = pipe.decode_codes(out.codes, out.lengths)
    t2 = time.perf_counter()
    st, cfg = pipe.last_spec_stats, pipe.config
    frames = pipe.generation_config.max_length - cfg.decoder.num_codebooks
    audio_s = frames * cfg.audio_encoder.hop_length / cfg.sampling_rate
    print(f"  {label}: {st.forwards} forwards (+{st.frozen} frozen) for {st.columns} columns, "
          f"{st.columns / st.forwards:.2f} columns per forward, {st.columns / (t1 - t0):.1f} "
          f"columns/s; generate_codes {t1 - t0:.3f} s + decode_codes {t2 - t1:.3f} s = "
          f"{t2 - t0:.3f} s for {audio_s:.2f} s of audio: real-time factor "
          f"{(t2 - t0) / audio_s:.4f} at B={audio.shape[0]} ({card})")
    if out.steps != pipe.generation_config.max_length:
        raise AssertionError(f"{label}: expected {pipe.generation_config.max_length} columns, "
                             f"got {out.steps}")
    if not np.isfinite(audio).all() or (lengths != frames * cfg.audio_encoder.hop_length).any():
        raise AssertionError(f"{label}: bad audio {audio.shape} or lengths {lengths}")
    if st.columns < st.forwards:
        raise AssertionError(f"{label}: fewer columns than forwards")
    return out, st, t1 - t0


def spec_pipeline(pipe, gen=None, **kw):
    from parler_tts_tpu_torch.runtime.pipeline import ParlerTTSPipeline

    kw.setdefault("speculative_window", SPEC_WINDOW)
    return ParlerTTSPipeline(pipe.model, pipe.dac, gen or pipe.generation_config,
                             cache_dtype=pipe.cache_dtype, device=pipe.device,
                             speculative_lookup=SPEC_LOOKUP, **kw)


def phase_m(dev, card, source, out_b, stream_e, large_eager, large_out):
    """Speculative decoding on the card: K1 at the window shapes, then
    mini-v1 served speculatively (greedy B=1 and per-row B=2 against phase
    (b)'s eager rows and, in fp32, against the fp32 AR run; sampled;
    streamed; int8 against phase (e), with K2 held to its plain version at
    each shape that run gives it), large-v1 against phase (l)'s eager rows
    and its fp32 AR run, and decoder-only generation. Returns K1's window
    numbers and launches."""
    import dataclasses

    import numpy as np

    import parler_tts_tpu_torch.models.decoder as tdec
    from parler_tts_tpu_torch.config import mini_v1_config
    from parler_tts_tpu_torch.ops.flash_decode import flash_decode_attention
    from parler_tts_tpu_torch.ops.quant_matmul import quant_matmul
    from parler_tts_tpu_torch.runtime.generate import generate_tokens_decoder_only
    from parler_tts_tpu_torch.runtime.pipeline import ParlerTTSPipeline
    from parler_tts_tpu_torch.runtime.speculative import (
        generate_tokens_decoder_only_speculative,
    )

    numbers = dict(k1=window_k1(dev, card))
    n_layers = source.config.decoder.num_hidden_layers
    request = request_ids(0)
    row1 = tuple(x[1:2] for x in request)

    def need(ok, msg):
        if not ok:
            raise AssertionError(msg)

    def held(label, got, want, rows, replay, tie=TIE, top_two=True):
        """Greedy ids equal to the AR run's up to each row's first parting,
        which is a near-tie of the AR run (near_ties)."""
        near_ties(label, first_partings(label, got, want, rows), replay, want, need, tie,
                  top_two, stop_early=True)

    def k1_reset():
        flash_decode_attention.launches = flash_decode_attention.launches_window = 0
        flash_decode_attention.launches_split = 0

    def k1_check(label, st, k1, layers=n_layers, window=True):
        """K1 launched once a layer and forward run, all on the window kernel
        (bf16 caches) or all on the split kernel (fp32). Returns the window
        kernel's launches."""
        runs = st.forwards + st.frozen
        k1w = flash_decode_attention.launches_window
        want_w = k1 if window else 0
        print(f"    {label}: K1 launches {k1} = {layers} x {runs} forwards run "
              f"({st.forwards} advancing, {st.frozen} frozen): {k1 == layers * runs}; on the "
              f"window kernel {k1w} (want {want_w}), on the split kernel "
              f"{flash_decode_attention.launches_split}")
        need(k1 == layers * runs and k1w == want_w and k1w + flash_decode_attention.launches_split
             == k1, f"{label}: K1 launched {k1} times ({k1w} on the window kernel), want "
             f"{layers} x {runs} ({want_w})")
        return k1w

    # warm-up: the window's shapes over 64 columns
    short = dataclasses.replace(source.generation_config, max_length=64, min_new_tokens=64)
    for per_row, req in ((False, row1), (True, request)):
        spec_pipeline(source, short, speculative_per_row=per_row).generate_codes(*req)
    torch.cuda.synchronize()

    # bf16: the window forward runs every matmul at M = B x W rows where the
    # AR step runs M = B, and bf16 rounds the two otherwise, so a greedy run
    # parts from its AR run where the AR run's top logits lie within what
    # that rounding moves them (window_tie). Three tokens can lie that close
    # in a random model's flat logits, so the AR run's runner-up is not
    # required there; fp32 runs keep it, at TIE.
    ties = dict(mini_v1=window_tie("mini-v1 bf16", source.model, dev, SPEC_WINDOW))

    # greedy B=1 (row 1, left-padded) and per-row B=2 against phase (b)
    got = {}
    for label, per_row, req in (("spec W=24 B=1", False, row1),
                                ("spec W=24 per-row B=2", True, request)):
        pipe = spec_pipeline(source, speculative_per_row=per_row)
        k1_reset()
        out, st, gen_s = spec_serve(pipe, req, label, card)
        k1w = k1_check(label, st, flash_decode_attention.launches)
        got[label] = out.delayed_ids
        numbers[label] = dict(forwards=st.forwards, frozen=st.frozen, columns=st.columns,
                              columns_per_s=st.columns / gen_s,
                              k1_launches=flash_decode_attention.launches,
                              k1_window_launches=k1w)
    held("greedy B=1 and per-row B=2 vs phase (b)",
         torch.cat([got["spec W=24 B=1"], got["spec W=24 per-row B=2"]]), out_b, [1, 0, 1],
         lambda: source.generate_codes(*request, seed=0), ties["mini_v1"], top_two=False)

    # fp32, B=1 and per-row B=2 over 256 columns, against the fp32 AR run: TIE
    fp32 = fp32_copy(source.model, dev)
    gen32 = dataclasses.replace(source.generation_config, max_length=DECODER_ONLY_COLUMNS,
                                min_new_tokens=DECODER_ONLY_COLUMNS)
    ar32 = ParlerTTSPipeline(fp32, source.dac, gen32, cache_dtype=torch.float32, device=dev)
    want32 = ar32.generate_codes(*request, seed=0).delayed_ids
    for label, per_row, req, rows in (("fp32 spec W=24 B=1", False, row1, [1]),
                                      ("fp32 spec W=24 per-row B=2", True, request, [0, 1])):
        k1_reset()
        out, st, _ = spec_serve(spec_pipeline(ar32, speculative_per_row=per_row), req, label,
                                card)
        k1_check(label, st, flash_decode_attention.launches, window=False)
        held(f"{label} vs the fp32 AR run", out.delayed_ids, want32, rows,
             lambda: ar32.generate_codes(*request, seed=0))

    # sampled B=1: two runs from one seed give the same tokens
    sampled_gen = dataclasses.replace(source.generation_config, do_sample=True,
                                      max_length=SAMPLED_COLUMNS, min_new_tokens=SAMPLED_COLUMNS)
    sampled = spec_pipeline(source, sampled_gen)
    first, st1, _ = spec_serve(sampled, row1, "sampled spec W=24 B=1", card)
    again = sampled.generate_codes(*row1, seed=0)
    st2 = sampled.last_spec_stats
    same = torch.equal(first.delayed_ids, again.delayed_ids)
    valid = bool((first.codes < 1024).all())
    print(f"    sampled: two runs from seed 0 equal: {same}; {st1.columns} columns in "
          f"{st1.forwards} forwards (>= 1 a forward: {st1.columns >= st1.forwards}); codes "
          f"inside the codebooks: {valid}")
    need(same and st1 == st2._replace(frozen=st1.frozen) and valid,
         f"sampled spec: repeat equal {same}, stats {st1} / {st2}, codes valid {valid}")

    # a speculative stream B=1 over row 1: the offline tokens, bit for bit
    pipe = spec_pipeline(source)
    prefill, step = pipe._ensure_stream_fns()
    seen = {}

    def keep(*args, **kw):
        seen["state"] = prefill(*args, **kw)
        return seen["state"]

    pipe._stream_fns = (keep, step)
    chunks, first_chunk = [], None
    t0 = time.perf_counter()
    for chunk in pipe.stream(*row1, play_steps=PLAY_STEPS):
        first_chunk = first_chunk or time.perf_counter() - t0
        chunks.append(chunk)
    wall = time.perf_counter() - t0
    state = seen["state"]
    t_end = int(state.t)
    columns = t_end - state.t0
    same = t_end == MAX_LENGTH and torch.equal(state.out_ids[:, :, :MAX_LENGTH],
                                               got["spec W=24 B=1"])
    print(f"  spec stream B=1, play_steps {PLAY_STEPS}: first chunk after {first_chunk:.3f} s, "
          f"{len(chunks)} chunks, {columns / wall:.1f} columns/s over the stream ({wall:.2f} s, "
          f"codec flushes included); tokens equal to the offline spec run: {same} ({card})")
    need(same and np.isfinite(np.concatenate(chunks, axis=1)).all(),
         f"spec stream: tokens equal {same}")
    numbers["stream"] = dict(first_chunk_s=first_chunk, columns_per_s=columns / wall,
                             chunks=len(chunks))

    # int8 over K2 at M = W: K2 against its plain version on the inputs the
    # warm-up run gave it, one of each (M, K, N); then against phase (e)'s
    # int8 AR row 1
    int8 = ParlerTTSPipeline.from_random(mini_v1_config(), seed=0,
                                         generation_config=source.generation_config,
                                         device=dev, dtype=torch.bfloat16,
                                         cache_dtype=torch.bfloat16, weight_quant=True)
    pipe = spec_pipeline(int8)
    shapes, real = {}, tdec.quant_matmul

    def record(x, w, s):
        shapes.setdefault((x.shape[0],) + tuple(w.shape), (x.clone(), w, s))
        return real(x, w, s)

    tdec.quant_matmul = record
    try:
        pipe.generate_codes(*row1, seed=0)  # warm-up of M = 24
    finally:
        tdec.quant_matmul = real
    for (m, k, n), (x, w, s) in sorted(shapes.items()):
        err, slices, slice_ = k2_check(x, w, s, f"K2 int8 spec M={m} K={k} N={n}")
        print(f"  K2 at the int8 speculative run's M={m:2d} K={k} N={n} on its own inputs: "
              f"max_abs_err {err:.3e} within k2_close, {slices} x {slice_}-row slices, a "
              f"repeat bit-identical, a dropped slice outside")
    ties["int8"] = window_tie("mini-v1 int8", int8.model, dev, SPEC_WINDOW)
    k1_reset()
    quant_matmul.launches = 0
    out, st, gen_s = spec_serve(pipe, row1, "int8 spec W=24 B=1", card)
    runs = st.forwards + st.frozen
    k2, want_k2 = quant_matmul.launches, 8 * n_layers * (runs + 1) + 2 * n_layers
    print(f"    int8: K2 launches {k2} = 192 x ({runs} forwards run + prefill) + 48 cross-kv: "
          f"{k2 == want_k2}")
    need(k2 == want_k2, f"int8 spec: K2 launched {k2} times, want {want_k2}")
    k1w = k1_check("int8 spec", st, flash_decode_attention.launches)
    held("int8 spec B=1 vs phase (e)", out.delayed_ids, stream_e, [1],
         lambda: int8.generate_codes(*request, seed=0), ties["int8"], top_two=False)
    numbers["int8"] = dict(forwards=st.forwards, columns=st.columns, k2_launches=k2,
                           k1_window_launches=k1w,
                           columns_per_s=st.columns / gen_s,
                           k2_shapes=[list(key) for key in sorted(shapes)])
    del int8, pipe, shapes
    torch.cuda.empty_cache()

    # large-v1 W=16 against phase (l)'s eager row 1, then in fp32 against
    # the fp32 AR run
    large_layers = large_eager.config.decoder.num_hidden_layers
    ties["large_v1"] = window_tie("large-v1 bf16", large_eager.model, dev, SPEC_WINDOW_LARGE)
    pipe = spec_pipeline(large_eager, speculative_window=SPEC_WINDOW_LARGE)
    pipe.generate_codes(*row1, seed=0)  # warm-up
    k1_reset()
    out, st, gen_s = spec_serve(pipe, row1, "large-v1 spec W=16 B=1", card)
    k1w = k1_check("large-v1 spec", st, flash_decode_attention.launches, large_layers)
    held("large-v1 spec B=1 vs phase (l)", out.delayed_ids, large_out, [1],
         lambda: large_eager.generate_codes(*request, seed=0), ties["large_v1"], top_two=False)
    numbers["large-v1"] = dict(forwards=st.forwards, columns=st.columns,
                               columns_per_s=st.columns / gen_s, k1_window_launches=k1w)
    del pipe
    large_ar32 = ParlerTTSPipeline(fp32_copy(large_eager.model, dev), large_eager.dac,
                                   large_eager.generation_config, cache_dtype=torch.float32,
                                   device=dev)
    want = large_ar32.generate_codes(*request, seed=0).delayed_ids
    k1_reset()
    out, st, _ = spec_serve(spec_pipeline(large_ar32, speculative_window=SPEC_WINDOW_LARGE),
                            row1, "large-v1 fp32 spec W=16 B=1", card)
    k1_check("large-v1 fp32 spec", st, flash_decode_attention.launches, large_layers,
             window=False)
    held("large-v1 fp32 spec B=1 vs the fp32 AR run", out.delayed_ids, want, [1],
         lambda: large_ar32.generate_codes(*request, seed=0))
    del large_ar32
    torch.cuda.empty_cache()

    # decoder-only, in fp32 (phase (b)'s weights): phase (b)'s description
    # row 1 as encoder states
    model = fp32
    gen = dataclasses.replace(source.generation_config, max_length=DECODER_ONLY_COLUMNS,
                              min_new_tokens=DECODER_ONLY_COLUMNS)
    desc, desc_mask = (torch.as_tensor(x[1:2], device=dev) for x in request[:2])
    with torch.inference_mode():
        states, mask = model.build_encoder_states(model.encode_description(desc, desc_mask),
                                                  desc_mask, None, None)
    kw = dict(encoder_hidden_states=states, encoder_mask=mask, cache_dtype=torch.float32)

    def decoder_only_ar():
        return generate_tokens_decoder_only(model, gen, 1, **kw)

    generate_tokens_decoder_only_speculative(model, gen, 1, window=SPEC_WINDOW, **kw)  # warm-up
    t0 = time.perf_counter()
    ar = decoder_only_ar()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    k1_reset()
    spec, st = generate_tokens_decoder_only_speculative(model, gen, 1, window=SPEC_WINDOW,
                                                        lookup_ngram=SPEC_LOOKUP, **kw)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    print(f"  decoder-only fp32 B=1 over {DECODER_ONLY_COLUMNS} columns: AR {t1 - t0:.3f} s, "
          f"spec W=24 {t2 - t1:.3f} s ({st.forwards} forwards, {st.columns / st.forwards:.2f} "
          f"columns per forward) ({card})")
    k1_check("decoder-only spec", st, flash_decode_attention.launches, window=False)
    need(ar.steps == DECODER_ONLY_COLUMNS and spec.steps == DECODER_ONLY_COLUMNS,
         f"decoder-only: {ar.steps} / {spec.steps} columns")
    held("decoder-only fp32 spec vs AR", spec.delayed_ids, ar.delayed_ids, [0], decoder_only_ar)
    numbers["decoder-only"] = dict(forwards=st.forwards, columns=st.columns)
    numbers["tie_bf16"] = ties
    del fp32
    return numbers


# ------------------------------------------------------------ training CLI
CLI = dict(
    clips=22, eval_clips=2, seconds=(2.0, 8.0), short_seconds=0.5, min_seconds=1.0,
    max_seconds=10.0, max_desc_tokens=200, steps=6, save_steps=3, max_length=704,
    # a constant 5e-4 from step 1 (no warmup): six steps lower mini-v1's eval
    # loss from its random initialisation
    learning_rate=5e-4, accumulate=2, batch=2,
)


STAGE1_BATCH = 8  # clips a stage-1 encode batch


class Rows:
    """An in-memory stand-in for `training.data.load_multiple_datasets`'s
    dataset: rows by index, `len`, `select`."""

    def __init__(self, rows):
        self.rows = rows

    def __len__(self):
        return len(self.rows)

    def __getitem__(self, i):
        return self.rows[i]

    def select(self, idx):
        return Rows([self.rows[i] for i in idx])


def cli_rows(sampling_rate, n, seconds, seed, bad=None):
    """`n` seeded synthetic clips (a glide over a noise floor) of
    `seconds` = (low, high) s each, the last one `high` long, with their
    descriptions and prompts; `bad` = (short_s, long description) adds the
    two rows the filters must drop: one too short, one whose description is
    over the token cap."""
    import numpy as np

    rng = np.random.default_rng(seed)
    rows = []
    for i in range(n):
        sec = seconds[1] if i == n - 1 else float(rng.uniform(*seconds))
        t = np.arange(int(sec * sampling_rate)) / sampling_rate
        f0 = rng.uniform(90, 260)
        audio = (0.3 * np.sin(2 * np.pi * f0 * t * (1 + 0.05 * np.sin(2 * np.pi * 0.7 * t)))
                 + 0.02 * rng.normal(size=t.size))
        rows.append({"audio": {"array": audio.astype(np.float32)},
                     "description": f"voice {seed}-{i}: a calm speaker at {f0:.0f} Hz",
                     "text": f"This is sentence {i} of split {seed}."})
    if bad is not None:
        short_s, long_description = bad
        rows.insert(3, {"audio": {"array": np.zeros(int(short_s * sampling_rate), np.float32)},
                        "description": "too short", "text": "x"})
        rows.insert(7, {"audio": {"array": rows[0]["audio"]["array"]},
                        "description": long_description, "text": "a long description"})
    return rows


class Patches:
    """Attributes set for a while (check instruments around the CLI's
    functions), put back by `undo`."""

    def __init__(self):
        self.saved = []

    def set(self, obj, name, value):
        self.saved.append((obj, name, getattr(obj, name)))
        setattr(obj, name, value)

    def undo(self):
        while self.saved:
            obj, name, value = self.saved.pop()
            setattr(obj, name, value)


def stay_offline() -> None:
    """Eval generation's metrics look their models up on the hub when
    `transformers` is installed: keep every lookup offline."""
    import os

    os.environ.setdefault("HF_HUB_OFFLINE", "1")
    os.environ.setdefault("TRANSFORMERS_OFFLINE", "1")


def stage1_codes(labels, k):
    """The codes (K, n) a stage-1 label array (n + 1 + K, K) was built from."""
    n = labels.shape[0] - 1 - k
    return torch.stack([torch.as_tensor(labels[1 + i: 1 + i + n, i]) for i in range(k)])


def phase_n(dev, card, loss_gap, cfg=None, cli=None, batch_fn=None, tokenizer=stub_tokenizer):
    """The training CLI at mini-v1 width (`cfg`, random weights from a seed):
    `run_training.main` over a stand-in dataset (stage 1, the filters, six
    steps over K4, checkpoints, eval loss and eval generation over K1, the
    export), a second uninterrupted run and a run resumed from step 3, the
    export served back, then item 21b's remat_policy="dots" and bf16 Adam
    moments beside phase (i)'s trainer. `loss_gap` is phase (i)'s bf16 loss
    gap; `cfg`, `cli`, `batch_fn` and `tokenizer` shrink the phase for a
    rehearsal on the CPU. Returns the phase's numbers."""
    import copy
    import dataclasses
    import json
    import os
    import pickle
    import tempfile

    import numpy as np

    from parler_tts_tpu_torch.config import GenerationConfig, mini_v1_config
    from parler_tts_tpu_torch.models.layers import init_weights
    from parler_tts_tpu_torch.models.parler import ParlerTTS
    from parler_tts_tpu_torch.ops.flash_attention import flash_attention
    from parler_tts_tpu_torch.ops.flash_decode import flash_decode_attention
    from parler_tts_tpu_torch.runtime import generate as gen_mod
    from parler_tts_tpu_torch.runtime.pipeline import ParlerTTSPipeline
    from parler_tts_tpu_torch.training import TrainState, make_optimizer, make_train_step
    from parler_tts_tpu_torch.training import checkpoints as ck
    from parler_tts_tpu_torch.training import data as data_mod
    from parler_tts_tpu_torch.training import run_training as rt
    from parler_tts_tpu_torch.training.arguments import parse_args
    from parler_tts_tpu_torch.training.data import (
        DataCollatorEncodecWithPadding,
        DataCollatorParlerTTSWithPadding,
    )

    stay_offline()
    # dropout 0: a resumed run restarts the dropout seeds, as the JAX loop its RNG
    cfg = cfg or dataclasses.replace(mini_v1_config(), decoder=dataclasses.replace(
        mini_v1_config().decoder, dropout=0.0))
    cli = cli or CLI
    batch_fn = batch_fn or train_batch
    sr, n_layers = cfg.sampling_rate, cfg.decoder.num_hidden_layers
    k_cb, hop = cfg.decoder.num_codebooks, cfg.audio_encoder.hop_length
    k4, k4w = flash_attention.launches, flash_attention.launches_wgmma
    fails = []

    def need(ok, what):
        if not ok:
            fails.append(what)
        return ok

    src = ParlerTTSPipeline.from_random(cfg, seed=0, device=dev)  # fp32, as from_pretrained
    param_bytes = sum(p.numel() * 4 for p in src.model.parameters())
    train_rows = cli_rows(sr, cli["clips"], cli["seconds"], seed=1,
                          bad=(cli["short_seconds"], "y" * (cli["max_desc_tokens"] + 50)))
    eval_rows = cli_rows(sr, cli["eval_clips"], cli["seconds"], seed=2)

    with tempfile.TemporaryDirectory() as root:
        # the init checkpoint, run A's two checkpoints, its export, run B's
        # and the resumed run's: checkpoints hold the parameters and both moments
        check_disk(root, 12 * param_bytes)
        paths = {name: os.path.join(root, name) for name in
                 ("init", "run_a", "run_b", "resumed", "features")}
        src.save_pretrained(paths["init"])
        blob = dict(
            model_name_or_path=paths["init"], train_dataset_name="synthetic/train",
            train_dataset_config_name="default", eval_dataset_name="synthetic/eval",
            eval_split_name="eval", max_eval_samples=cli["eval_clips"],
            min_duration_in_seconds=cli["min_seconds"], max_duration_in_seconds=cli["max_seconds"],
            max_description_token_length=cli["max_desc_tokens"], output_dir=paths["run_a"],
            save_to_disk=paths["features"], per_device_train_batch_size=cli["batch"],
            per_device_eval_batch_size=cli["eval_clips"],
            gradient_accumulation_steps=cli["accumulate"], gradient_accumulation_mode="microbatch",
            group_by_length=True, learning_rate=cli["learning_rate"], warmup_steps=0,
            max_steps=cli["steps"], num_train_epochs=2, logging_steps=1,
            save_steps=cli["save_steps"], save_total_limit=1, eval_steps=cli["steps"],
            max_length=cli["max_length"], do_sample=False, compute_clap_similarity_metric=False,
            compute_noise_level_metric=False, report_to="none", dtype="bfloat16",
            attention_impl="pallas_flash", audio_encoder_per_device_batch_size=STAGE1_BATCH,
            seed=0)
        cfg_path = os.path.join(root, "train.json")
        with open(cfg_path, "w") as f:
            json.dump(blob, f)

        # ---- the check instruments around the CLI's functions
        steps, saves, evals, gens, restores, stage1 = [], [], [], [], [], {}
        patches = Patches()

        def make_counted(model, tx, **kw):
            real_step = real["make_train_step"](model, tx, **kw)

            def counted(state, batch, seed):
                for key in k4:
                    k4[key] = k4w[key] = 0
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
                    enable_timing=True)
                start.record()
                state, metrics = real_step(state, batch, seed)
                end.record()
                torch.cuda.synchronize()
                steps.append(dict(ms=start.elapsed_time(end), loss=float(metrics["loss"]),
                                  k4=dict(k4), k4_wgmma=dict(k4w),
                                  frames=batch.labels.shape[0] * batch.labels.shape[1],
                                  valid=float(metrics["num_items"]) / k_cb))
                return state, metrics
            return counted

        def save_linked(state, output_dir, step, epoch, limit=None):
            t0 = time.perf_counter()
            path = real["save_train_state"](state, output_dir, step, epoch, limit)
            write_s = time.perf_counter() - t0  # the state is on the host once it returns
            saves.append((output_dir, os.path.basename(path), ck.sorted_checkpoints(output_dir),
                          write_s, dir_bytes(path)))
            keep = os.path.join(paths["resumed"], os.path.basename(path))
            if output_dir == paths["run_a"] and step == cli["save_steps"]:
                os.makedirs(keep)  # run A's step-3 checkpoint, kept past its rotation
                for name in os.listdir(path):
                    os.link(os.path.join(path, name), os.path.join(keep, name))
            return path

        def eval_counted(*a, **kw):
            for key in k4:
                k4[key] = 0
            loss = real["run_eval"](*a, **kw)
            evals.append((loss, dict(k4)))
            return loss

        def gen_counted(*a, **kw):
            advances = [0]

            def advance(*aa, **kk):
                advances[0] += 1
                return real_advance(*aa, **kk)

            flash_decode_attention.launches = 0
            patches.set(gen_mod, "_advance", advance)
            t0 = time.perf_counter()
            try:
                out = real["run_eval_generation"](*a, **kw)
                torch.cuda.synchronize()
            finally:
                setattr(gen_mod, "_advance", real_advance)
            gens.append(dict(seconds=time.perf_counter() - t0, advances=advances[0],
                             k1=flash_decode_attention.launches))
            return out

        def restore_checked(path, state):
            out = real["restore_train_state"](path, state)
            saved = ck.load_state_dict(path)
            opt = state.opt_state
            odd = [(key, name) for key, tensors in (
                ("params", dict(state.model.named_parameters())), ("mu", opt.mu), ("nu", opt.nu))
                for name, t in tensors.items() if not torch.equal(t.cpu(), saved[key][name])]
            restores.append((os.path.basename(path), odd, state.step, opt.count))
            return out

        def stage1_timed(*a, **kw):
            t0 = time.perf_counter()
            labels = real["encode_corpus_stage"](*a, **kw)
            torch.cuda.synchronize()
            stage1.setdefault("seconds", []).append(time.perf_counter() - t0)
            return labels

        real = {name: getattr(rt, name) for name in (
            "make_train_step", "save_train_state", "run_eval", "run_eval_generation",
            "restore_train_state", "encode_corpus_stage")}
        real_advance = gen_mod._advance
        for name, fn in (("make_train_step", make_counted), ("save_train_state", save_linked),
                         ("run_eval", eval_counted), ("run_eval_generation", gen_counted),
                         ("restore_train_state", restore_checked),
                         ("encode_corpus_stage", stage1_timed)):
            patches.set(rt, name, fn)
        patches.set(data_mod, "load_multiple_datasets", lambda specs, sampling_rate, **kw: Rows(
            eval_rows if specs[0]["split"] == "eval" else train_rows))
        try:
            # ---- run A: the CLI end to end
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            rt.main([cfg_path], tokenizers=(tokenizer, tokenizer), device=dev)
            torch.cuda.synchronize()
            main_s = time.perf_counter() - t0
            peak_gib = torch.cuda.max_memory_allocated() / 2**30
            run_a = steps[:]
            with open(os.path.join(paths["features"], "features.pkl"), "rb") as f:
                feats = pickle.load(f)
            margs, dargs, targs = parse_args([cfg_path])

            # ---- run B, uninterrupted again; the resumed run from run A's step 3
            # (the trainer updates the model it is given: each takes a copy)
            steps.clear()
            rt.run_training(margs, dargs, dataclasses.replace(
                targs, output_dir=paths["run_b"], save_steps=100, eval_steps=100),
                copy.deepcopy(src.model), feats["train"], device=dev)
            run_b = steps[:]
            steps.clear()
            state_c, step_c = rt.run_training(margs, dargs, dataclasses.replace(
                targs, output_dir=paths["resumed"], save_steps=100, eval_steps=100),
                copy.deepcopy(src.model), feats["train"], device=dev)
            run_c = steps[:]
        finally:
            patches.undo()
        del state_c

        # ---- stage 1: filters, and each clip's labels against its encode alone
        audio_s = sum(len(r["audio"]["array"]) for r in train_rows + eval_rows) / sr
        kept = [f["description_text"] for f in feats["train"]]
        dropped = sorted({r["description"] for r in train_rows} - set(kept))
        need(len(kept) == cli["clips"] and dropped == sorted(
            ["too short", "y" * (cli["max_desc_tokens"] + 50)]),
            f"filters kept {len(kept)} rows, dropped {[d[:12] for d in dropped]}")
        # each clip alone, zero-padded as stage 1 padded its batch of
        # `audio_encoder_per_device_batch_size` rows
        coll = DataCollatorEncodecWithPadding(sampling_rate=sr, hop_length=hop,
                                              max_length_seconds=cli["max_seconds"])
        padded = {}
        for rows in (train_rows, eval_rows[:cli["eval_clips"]]):
            for i in range(0, len(rows), STAGE1_BATCH):
                chunk = rows[i:i + STAGE1_BATCH]
                width = coll(chunk)["input_values"].shape[-1]
                padded.update({r["description"]: (r["audio"]["array"], width) for r in chunk})
        parted = ties_ok = 0
        for f in feats["train"] + feats["eval"]:
            clip, width = padded[f["description_text"]]
            x = torch.zeros((1, width, 1))
            x[0, :clip.size, 0] = torch.from_numpy(clip)
            with torch.inference_mode():
                lat = src.dac.encoder(x.to(dev))
                alone = src.dac.quantizer.encode(lat)
                alone = (alone[0] if isinstance(alone, tuple) else alone)[:, :, :-(-clip.size // hop)]
                gaps = encode_gaps(src.dac.quantizer, lat[:, :alone.shape[-1]], alone)
            labels = np.asarray(f["labels"])
            ok, n_parted = codes_agree(stage1_codes(labels, k_cb)[None], alone, gaps)
            parted += n_parted
            ties_ok += ok
            want_shape = rt.build_labels_from_codes(
                alone[0].cpu().numpy(), cfg.decoder.bos_token_id, cfg.decoder.eos_token_id,
                cli["max_length"]).shape
            need(ok and labels.shape == want_shape,
                 f"stage-1 labels of {f['description_text'][:20]}: {labels.shape}, "
                 f"near-ties only {ok}")
        n_feats = len(feats["train"]) + len(feats["eval"])
        print(f"  stage 1: {len(train_rows) + len(eval_rows)} clips, {audio_s:.1f} s of audio at "
              f"{sr} Hz, encoded in {sum(stage1['seconds']):.2f} s "
              f"({audio_s / sum(stage1['seconds']):.1f} audio-s/s) ({card}); filters dropped "
              f"{dropped[:1]} and a {len(dropped[-1])}-byte description; each clip's labels "
              f"equal to build_labels_from_codes of its encode alone but at near-ties: "
              f"{ties_ok}/{n_feats} clips, {parted} frames parted")

        # ---- the steps: K4 launches, losses, time
        g = cli["accumulate"]
        want = {"fwd": 2 * n_layers * g, "dq": n_layers * g, "dkv": n_layers * g}
        for label, run in (("run A", run_a), ("run B", run_b), ("resumed", run_c)):
            for i, st in enumerate(run):
                need(st["k4"] == want and st["k4_wgmma"] == want and math.isfinite(st["loss"]),
                     f"{label} step {i + 1}: K4 {st['k4']} (wgmma {st['k4_wgmma']}), "
                     f"loss {st['loss']}")
        need(len(run_a) == len(run_b) == cli["steps"] and len(run_c) == cli["steps"]
             - cli["save_steps"] and step_c == cli["steps"],
             f"steps: A {len(run_a)}, B {len(run_b)}, resumed {len(run_c)} to {step_c}")
        step_ms = statistics.median(st["ms"] for st in run_a[1:])
        frames = statistics.median(st["frames"] for st in run_a[1:])
        print(f"  run A: losses {[round(st['loss'], 5) for st in run_a]}; K4 launches {want} "
              f"a step ({g} micro-batches of {cli['batch']}), all on the wgmma route: "
              f"{all(st['k4_wgmma'] == want for st in run_a)}; {step_ms:.1f} ms a step (median "
              f"of steps 2-{cli['steps']}, CUDA events), {frames / step_ms * 1e3:.0f} label "
              f"frames/s ({frames:.0f} padded frames a step), peak memory {peak_gib:.2f} GiB, "
              f"main() {main_s:.1f} s ({card})")

        # ---- evals: the initial parameters' eval loss, then step 6's
        model0 = ParlerTTS(cfg, device=dev, dtype=torch.bfloat16, param_dtype=torch.float32,
                           use_chunked_attention="pallas", remat_layers=True)
        model0.load_state_dict(src.model.state_dict())
        coll = DataCollatorParlerTTSWithPadding(
            prompt_padding_side="left", max_total_length=cfg.decoder.max_position_embeddings)
        loss0 = rt.run_eval(TrainState(0, model0, None), coll, feats["eval"], targs, None, 0, 0)
        del model0
        (loss6, k4_eval), = evals
        need(loss6 < loss0, f"eval loss {loss6} at step {cli['steps']}, {loss0} at step 0")
        need(k4_eval == {"fwd": n_layers, "dq": 0, "dkv": 0}, f"eval K4 {k4_eval}")
        (gen,) = gens
        need(gen["k1"] == n_layers * gen["advances"] and gen["advances"] > 0,
             f"eval generation: K1 {gen['k1']}, decode steps {gen['advances']}")
        print(f"  eval loss {loss0:.5f} at step 0 -> {loss6:.5f} at step {cli['steps']} (K4 "
              f"{k4_eval}); eval generation of {cli['eval_clips']} samples: "
              f"{gen['advances']} decode steps, K1 launches {gen['k1']} = {n_layers} x "
              f"{gen['advances']}, {gen['seconds']:.2f} s ({card})")

        # ---- checkpoints, rotation, resume
        a_saves = [(name, left) for d, name, left, _, _ in saves if d == paths["run_a"]]
        writes = [(name, write_s, size) for d, name, _, write_s, size in saves
                  if d == paths["run_a"]]
        per_epoch = cli["clips"] // (cli["batch"] * cli["accumulate"])
        first_a, last_a = (f"checkpoint-{n}-epoch-{(n - 1) // per_epoch}"
                           for n in (cli["save_steps"], cli["steps"]))
        need([n for n, _ in a_saves] == [first_a, last_a]
             and a_saves[-1][1] == [last_a], f"run A's saves {a_saves}")
        (r_name, odd, r_step, r_count), = restores
        need(r_name == first_a and not odd
             and r_step == r_count == cli["save_steps"], f"restore {r_name}: {odd[:3]}")
        spread = max(abs(a["loss"] - b["loss"]) for a, b in zip(run_a, run_b))
        gap_c = max(abs(a["loss"] - c["loss"]) for a, c in zip(run_a[cli["save_steps"]:], run_c))
        need(gap_c <= spread, f"resumed losses {gap_c} from run A's, spread {spread}")
        print(f"  checkpoints of run A: {[n for n, _ in a_saves]}, left after rotation "
              f"{a_saves[-1][1]}; written in "
              f"{', '.join(f'{w:.2f} s ({b / 1e9:.2f} GB)' for _, w, b in writes)} "
              f"(save_train_state's wall time) ({card}); "
              f"the resumed run restored {r_name} bit for bit: {not odd}; "
              f"its losses at steps {cli['save_steps'] + 1}-{cli['steps']} within "
              f"{gap_c:.3e} of run A's (two uninterrupted runs: {spread:.3e})")

        # ---- the export, served back
        final = os.path.join(paths["run_a"], "final")
        saved = ck.load_state_dict(ck.get_last_checkpoint(paths["run_a"]))["params"]
        gen64 = GenerationConfig(max_length=64, min_new_tokens=64, do_sample=False,
                                 bos_token_id=cfg.decoder.bos_token_id,
                                 pad_token_id=cfg.decoder.pad_token_id,
                                 eos_token_id=cfg.decoder.eos_token_id,
                                 codebook_guard=cfg.audio_encoder.codebook_size)
        t0 = time.perf_counter()
        pipe = ParlerTTSPipeline.from_pretrained(final, generation_config=gen64, device=dev,
                                                 cache_dtype=torch.float32)
        load_s = time.perf_counter() - t0
        unequal = [n for n, p in pipe.model.named_parameters() if not torch.equal(
            p.cpu(), saved[n])]
        flash_decode_attention.launches = 0
        vocab = min(cfg.vocab_size, cfg.text_encoder.vocab_size)
        request = tuple(x % vocab for x in request_ids(0))
        out = pipe.generate_codes(*request)
        torch.cuda.synchronize()
        k1 = flash_decode_attention.launches
        need(not unequal and k1 == n_layers * (out.steps - 2) and out.steps == 64,
             f"export: {len(unequal)} parameters differ, K1 {k1}, {out.steps} columns")
        print(f"  export {dir_bytes(final) / 1e9:.2f} GB loaded by from_pretrained in "
              f"{load_s:.2f} s: every parameter equal to the last checkpoint's: {not unequal}; "
              f"64 greedy fp32 columns, K1 {k1} = {n_layers} x {out.steps - 2} ({card})")
        del pipe, saved, src
        torch.cuda.empty_cache()

    # ---- item 21b on the card: remat_policy="dots" and bf16 Adam moments
    batch = batch_fn(dev)
    runs = {}
    for label, policy, mu in (("full", None, None), ("dots", "dots", None),
                              ("full, bf16 mu", None, torch.bfloat16)):
        model = ParlerTTS(cfg, device=dev, dtype=torch.bfloat16, param_dtype=torch.float32,
                          use_chunked_attention="pallas", remat_layers=True, remat_policy=policy)
        init_weights(model, torch.Generator(device=dev).manual_seed(0))
        tx = make_optimizer(warmup_steps=1, mu_dtype=mu)
        state, step = TrainState.create(model, tx), make_train_step(model, tx)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        losses, times, counts = [], [], []
        for i in range(3):
            for key in k4:
                k4[key] = 0
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
                enable_timing=True)
            start.record()
            state, metrics = step(state, batch, i)
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
            losses.append(float(metrics["loss"]))
            counts.append(dict(k4))
        mu_dtypes = {m.dtype for m in state.opt_state.mu.values()}
        peak = torch.cuda.max_memory_allocated() / 2**30
        # what the forward leaves held for the backward: the layer inputs
        # under full remat, and under "dots" also the products it keeps
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        out, _ = model(*batch, deterministic=False, dropout_key=0)
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated() - base
        del out
        runs[label] = dict(losses=losses, ms=statistics.median(times[1:]), peak_gib=peak,
                           held_gib=held / 2**30)
        want1 = {"fwd": 2 * n_layers, "dq": n_layers, "dkv": n_layers}
        need(all(c == want1 for c in counts) and all(map(math.isfinite, losses))
             and mu_dtypes == {mu or torch.float32},
             f"21b {label}: K4 {counts}, losses {losses}, mu {mu_dtypes}")
        print(f"  {label}: losses {[round(x, 5) for x in losses]}, {runs[label]['ms']:.1f} ms a "
              f"step (median of steps 2-3), peak memory {runs[label]['peak_gib']:.2f} GiB, "
              f"held after a forward {runs[label]['held_gib']:.3f} GiB, "
              f"K4 {counts[-1]} a step, exp_avg {sorted(map(str, mu_dtypes))} ({card})")
        del model, state, step
        torch.cuda.empty_cache()
    dots_gap = max(abs(a - b) for a, b in zip(runs["dots"]["losses"], runs["full"]["losses"]))
    need(dots_gap <= loss_gap, f"dots vs full: {dots_gap} over the bf16 gap {loss_gap}")
    # "dots" keeps at least the 7 products a layer that full remat recomputes
    # (q, k, v, out, cross q, cross out: hidden wide; fc1: ffn wide) for each
    # label frame, in bf16
    dcfg = cfg.decoder
    kept_gib = (n_layers * batch.labels.shape[0] * batch.labels.shape[1] * 2
                * (6 * dcfg.hidden_size + dcfg.ffn_dim)) / 2**30
    extra_gib = runs["dots"]["held_gib"] - runs["full"]["held_gib"]
    need(extra_gib >= kept_gib, f"dots holds {extra_gib:.3f} GiB more than full after a "
         f"forward, under the {kept_gib:.3f} GiB of the products it keeps")
    print(f"  remat dots vs full over 3 steps: losses within {dots_gap:.3e} (phase i's bf16 "
          f"gap {loss_gap:.3e}): {dots_gap <= loss_gap}; dots holds {extra_gib:.3f} GiB more "
          f"after a forward, against at least {kept_gib:.3f} GiB of kept products "
          f"({extra_gib >= kept_gib})")
    if fails:
        raise AssertionError(f"phase n: {fails}")
    return dict(step_ms=step_ms, label_frames_per_s=frames / step_ms * 1e3, peak_gib=peak_gib,
                stage1_s=sum(stage1["seconds"]), stage1_audio_s_per_s=audio_s / sum(
                    stage1["seconds"]), eval_generation_s=gen["seconds"],
                k4_per_step=run_a[-1]["k4_wgmma"], k1_eval_generation=gen["k1"],
                eval_loss=[loss0, loss6], checkpoint_write_s=[w for _, w, _ in writes],
                remat=runs, cfg=cfg, args=(margs, dargs, targs), features=feats)


# ------------------------------------------------------------ Encodec
ENCODEC_REL = 1e-4   # Encodec latents and audio against the CPU's, norm-relative
SCALE_REL = 1e-6     # normalising Encodec's scales against the CPU's
ENCODEC_COLUMNS = 256


def encodec_composite(codec_cfg, decoder):
    """A Parler-TTS config over an Encodec: the ids of
    `helpers/model_init_scripts/init_dummy_model_with_encodec.py` (vocab
    codebook_size + 64, pad and eos codebook_size, bos codebook_size + 1)."""
    import dataclasses

    from parler_tts_tpu_torch.config import ParlerTTSConfig, mini_v1_config

    size = codec_cfg.codebook_size
    return ParlerTTSConfig(
        text_encoder=mini_v1_config().text_encoder, audio_encoder=codec_cfg,
        decoder=dataclasses.replace(decoder, vocab_size=size + 64,
                                    num_codebooks=codec_cfg.num_codebooks, pad_token_id=size,
                                    eos_token_id=size, bos_token_id=size + 1),
        vocab_size=32128, pad_token_id=size, decoder_start_token_id=size + 1)


def encodec_check(codec, clips, card, label):
    """Encode `clips` (B, T, C) on the card against the same fp32 codec on the
    CPU (latents within ENCODEC_REL, codes equal but at the CPU's near-ties),
    and decode the CPU's codes on both (within ENCODEC_REL)."""
    import copy

    cpu = copy.deepcopy(codec).cpu()
    x = torch.from_numpy(clips)
    with torch.inference_mode():
        if codec.config.normalize:
            x = x / cpu._scale(x)[:, None, None]
        lat_cpu = cpu.encoder(x)
        codes_cpu = cpu.quantizer.encode(lat_cpu)
        gaps = encode_gaps(cpu.quantizer, lat_cpu, codes_cpu)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lat = codec.encoder(x.to(codec.quantizer.codebooks.device))
        codes = codec.quantizer.encode(lat)
        torch.cuda.synchronize()
        enc_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        audio = codec.decode(codes_cpu.to(lat.device))
        torch.cuda.synchronize()
        dec_s = time.perf_counter() - t0
        audio_cpu = cpu.decode(codes_cpu)
    lat_rel, audio_rel = norm_rel(lat.cpu(), lat_cpu), norm_rel(audio.cpu(), audio_cpu)
    ok, parted = codes_agree(codes, codes_cpu, gaps)
    print(f"  {label}: encode {tuple(x.shape)} -> codes {tuple(codes.shape)} in "
          f"{enc_s * 1e3:.1f} ms, decode in {dec_s * 1e3:.1f} ms ({card}); latents vs the CPU "
          f"norm-rel {lat_rel:.2e}, codes equal to the CPU's: {torch.equal(codes.cpu(), codes_cpu)}"
          f" (frames parted {parted}, all at near-ties: {ok}), audio norm-rel {audio_rel:.2e} "
          f"(limit {ENCODEC_REL:g})")
    if lat_rel > ENCODEC_REL or audio_rel > ENCODEC_REL or not ok:
        raise AssertionError(f"{label}: latents {lat_rel:.2e}, audio {audio_rel:.2e}, codes "
                             f"parted at {parted} frames, near-ties only: {ok}")
    return codes_cpu


def phase_o(dev, card, codec_cfg=None, decoder=None, columns=ENCODEC_COLUMNS):
    """Encodec on the card: the JAX package's default geometry (32 kHz, the
    `facebook/encodec_32khz` codec) with causal and non-causal convs against
    the CPU, a normalising stereo variant through the pipeline's
    `encode_voice_prompt` and `decode_codes`, and a mini-v1-width decoder over
    4 Encodec codebooks served, decoded, saved and served again. Returns the
    phase's numbers."""
    import copy
    import dataclasses
    import tempfile

    import numpy as np

    from parler_tts_tpu_torch.codec.encodec_model import EncodecCodecConfig
    from parler_tts_tpu_torch.codec.registry import build_codec, init_codec_params
    from parler_tts_tpu_torch.config import GenerationConfig, mini_v1_decoder_config
    from parler_tts_tpu_torch.models.layers import init_weights
    from parler_tts_tpu_torch.models.parler import ParlerTTS
    from parler_tts_tpu_torch.ops.flash_decode import flash_decode_attention
    from parler_tts_tpu_torch.runtime.pipeline import ParlerTTSPipeline

    base = codec_cfg or EncodecCodecConfig()
    decoder = decoder or mini_v1_decoder_config()
    sr, hop = base.sampling_rate, base.hop_length
    mono = voice_clips(sr, int(VOICE_SECONDS * sr))          # (2, T)
    for causal in (True, False):
        ccfg = dataclasses.replace(base, use_causal_conv=causal)
        codec = init_codec_params(build_codec(ccfg, dev), torch.Generator(dev).manual_seed(7))
        encodec_check(codec.eval(), mono[:, :, None], card,
                      f"Encodec {'causal' if causal else 'non-causal'}")
        del codec

    # ---- stereo with normalisation, through the pipeline on both devices
    scfg = dataclasses.replace(base, audio_channels=2, normalize=True)
    small = dataclasses.replace(decoder, num_hidden_layers=2)
    pcfg = encodec_composite(scfg, small)
    gen = GenerationConfig(max_length=32, do_sample=False, bos_token_id=pcfg.decoder.bos_token_id,
                           pad_token_id=pcfg.pad_token_id, eos_token_id=pcfg.pad_token_id)
    model = ParlerTTS(pcfg)
    init_weights(model, torch.Generator().manual_seed(8))
    codec = init_codec_params(build_codec(scfg), torch.Generator().manual_seed(9))
    cpu = ParlerTTSPipeline(model, codec, gen, device="cpu")
    card_pipe = ParlerTTSPipeline(copy.deepcopy(model), copy.deepcopy(codec), gen, device=dev)
    clip = np.stack([mono, mono[:, ::-1] * 0.5], axis=-1).copy()
    clip[1] *= 5.0
    with torch.inference_mode():
        x = torch.from_numpy(clip)
        gaps = encode_gaps(codec.quantizer, codec.encoder(x / codec._scale(x)[:, None, None]),
                           codec.encode(x))
    codes_cpu, scales_cpu = cpu.encode_voice_prompt(clip, return_scales=True)
    codes, scales = card_pipe.encode_voice_prompt(clip, return_scales=True)
    scale_rel = float(((scales.cpu() - scales_cpu).abs() / scales_cpu).max())
    ok, parted = codes_agree(codes, codes_cpu, gaps)
    lengths = torch.tensor([codes.shape[-1], codes.shape[-1] - 7])
    audio, n = card_pipe.decode_codes(codes_cpu.to(dev), lengths, audio_scales=scales_cpu)
    audio_cpu, n_cpu = cpu.decode_codes(codes_cpu, lengths, audio_scales=scales_cpu)
    audio_rel = norm_rel(torch.from_numpy(audio), torch.from_numpy(audio_cpu))
    shape_ok = (audio.shape == (2, codes.shape[-1] * hop * 2) and np.array_equal(n, n_cpu)
                and np.array_equal(n, lengths.numpy() * hop * 2))
    print(f"  Encodec stereo, normalize: scales {scales.cpu().numpy().round(5)} within "
          f"{scale_rel:.2e} of the CPU's (limit {SCALE_REL:g}); codes equal but at near-ties: "
          f"{ok} ({parted} frames parted); decode_codes with audio_scales: {audio.shape} "
          f"interleaved samples, lengths {n} = frames x {hop} x 2: {shape_ok}, norm-rel "
          f"{audio_rel:.2e} to the CPU's")
    if scale_rel > SCALE_REL or not ok or audio_rel > ENCODEC_REL or not shape_ok:
        raise AssertionError(f"Encodec stereo: scales {scale_rel:.2e}, codes {ok}, audio "
                             f"{audio_rel:.2e}, shapes {shape_ok}")
    del cpu, card_pipe, model, codec

    # ---- a mini-v1-width decoder over 4 Encodec codebooks, served and saved
    cfg = encodec_composite(base, decoder)
    n_layers, size = cfg.decoder.num_hidden_layers, base.codebook_size
    gen = GenerationConfig(max_length=columns, min_new_tokens=columns, do_sample=False,
                           bos_token_id=size + 1, pad_token_id=size, eos_token_id=size,
                           codebook_guard=size)
    pipe = ParlerTTSPipeline.from_random(cfg, seed=3, generation_config=gen, device=dev,
                                         dtype=torch.bfloat16)
    request = request_ids(0)
    warm = ParlerTTSPipeline(pipe.model, pipe.dac, dataclasses.replace(
        gen, max_length=40, min_new_tokens=40), device=dev)
    warm.decode_codes(*warm.generate_codes(*request)[1:3])
    torch.cuda.synchronize()
    flash_decode_attention.launches = 0
    t0 = time.perf_counter()
    out = pipe.generate_codes(*request)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    audio, n = pipe.decode_codes(out.codes, out.lengths)
    t2 = time.perf_counter()
    k1, steps = flash_decode_attention.launches, out.steps - 2
    seconds = float(n.max()) / sr
    rtf = (t2 - t0) / seconds
    print(f"  mini-v1-width decoder ({n_layers} x {cfg.decoder.hidden_size}, "
          f"{cfg.decoder.num_attention_heads} heads) over Encodec {base.num_codebooks} x {size}, "
          f"bf16 B=2: {out.steps} greedy columns, {steps / (t1 - t0):.1f} decode steps/s, K1 "
          f"launches {k1} = {n_layers} x {steps}: {k1 == n_layers * steps}; decode_codes "
          f"{audio.shape} at {sr} Hz ({seconds:.2f} s) in {t2 - t1:.2f} s, RTF {rtf:.4f} "
          f"({card})")
    if k1 != n_layers * steps or not np.isfinite(audio).all() or out.steps != columns:
        raise AssertionError(f"Encodec serving: K1 {k1}, steps {steps}, finite "
                             f"{np.isfinite(audio).all()}")
    with tempfile.TemporaryDirectory() as path:
        check_disk(tempfile.gettempdir(), 2 * sum(p.numel() * 4 for p in pipe.model.parameters()))
        pipe.save_pretrained(path)
        loaded = ParlerTTSPipeline.from_pretrained(path, generation_config=gen, device=dev,
                                                   dtype=torch.bfloat16)
        unequal, _ = param_mismatches(loaded.model, loaded.dac, pipe.model, pipe.dac)
        flash_decode_attention.launches = 0
        again = loaded.generate_codes(*request)
        same = torch.equal(again.delayed_ids, out.delayed_ids)
        print(f"  saved ({dir_bytes(path) / 1e9:.2f} GB, native layout) and loaded: parameters "
              f"equal {not unequal}, the same {again.steps} columns {same}, K1 "
              f"{flash_decode_attention.launches}")
        if unequal or not same or flash_decode_attention.launches != k1:
            raise AssertionError(f"Encodec checkpoint: {unequal[:3]}, columns equal {same}")
    return dict(steps_per_s=steps / (t1 - t0), rtf=rtf, k1=k1)


# ----------------------------------------------------------- helper scripts
Q_COLUMNS = 64       # (q) the init directory served greedily, and the demo's max_length
# (q) a converted codec's decode against the source's, relative RMS. A correct
# fold leaves each kernel within FOLD_REL, yet the random real-width DAC moves
# its decode by ~5e-5 for such a 1e-7 change (4.8e-5 on the CPU); a kernel left
# unfolded (x 1.7, the export's v_scale) moves it by far more than this limit
DAC_DECODE_REL = 1e-3


def phase_q(dev, card):
    """The helper scripts (`parler_tts_tpu_torch/scripts/`) at mini-v1 width:
    `init_model_600M` on the card, its directory loaded back (fp32, equal to
    the drawn weights) and served (bf16, greedy, K1 24 a decode step);
    `push_trained_parler_tts_to_hub` on its params.pkl (the HF export loads
    with the native load's parameters and codec); `push_dac_to_hub` on the
    real-size codec's state dict as `.safetensors` and `.pth` (each tree's
    kernels within FOLD_REL of the codec's, its decode of the served codes
    within DAC_DECODE_REL, a kernel left unfolded outside it); the demo's
    CLI loop over the
    directory (speculative, W=16, sampled over Q_COLUMNS columns). Returns
    the phase's numbers."""
    import dataclasses
    import json
    import os
    import shutil
    import tempfile
    import wave

    import numpy as np

    from parler_tts_tpu_torch.codec.convert import export_dac_params
    from parler_tts_tpu_torch.codec.registry import build_codec
    from parler_tts_tpu_torch.convert import load_jax_dac_params, tensor_tree
    from parler_tts_tpu_torch.models.parler import ParlerTTS
    from parler_tts_tpu_torch.ops.flash_decode import flash_decode_attention
    from parler_tts_tpu_torch.runtime.pipeline import ParlerTTSPipeline, load_pickle
    from parler_tts_tpu_torch.scripts import (
        gradio_demo,
        init_model_600M,
        push_dac_to_hub,
        push_trained_parler_tts_to_hub,
    )

    failed = []

    def need(ok, what):
        if not ok:
            failed.append(what)
            print(f"  FAILED: {what}")

    cfg, script_gen = init_model_600M.configs()
    n_layers, size = cfg.decoder.num_hidden_layers, cfg.audio_encoder.codebook_size
    gen = dataclasses.replace(script_gen, max_length=Q_COLUMNS, min_new_tokens=Q_COLUMNS,
                              do_sample=False, codebook_guard=size)
    model_bytes = 4 * sum(p.numel() for p in ParlerTTS(cfg, device="meta").parameters())
    dac_bytes = 4 * sum(p.numel() for p in build_codec(cfg.audio_encoder, "meta").parameters())
    request = request_ids(0)
    numbers = {}
    root = tempfile.mkdtemp()
    saved = {name: getattr(gradio_demo, name) for name in ("OUTPUT_WAV", "write_wav")}
    try:
        # the native directory, the HF export, two codec files and two codec trees
        check_disk(root, 2 * model_bytes + 5 * dac_bytes)

        # ---- 1. init_model_600M on the card
        init_dir = os.path.join(root, "init")
        t0 = time.perf_counter()
        source = init_model_600M.main([init_dir, "--device", "cuda", "--seed", "0"])
        torch.cuda.synchronize()
        numbers["init_s"] = time.perf_counter() - t0
        numbers["init_gb"] = dir_bytes(init_dir) / 1e9
        print(f"  init_model_600M --device cuda --seed 0: {numbers['init_gb']:.3f} GB drawn on "
              f"the card and written in {numbers['init_s']:.2f} s ({card})")

        # ---- 2. loaded back in fp32: the weights drawn from the seed
        t0 = time.perf_counter()
        fp32 = ParlerTTSPipeline.from_pretrained(init_dir, device=dev)
        torch.cuda.synchronize()
        numbers["load_fp32_s"] = time.perf_counter() - t0
        bad, worst = param_mismatches(fp32.model, fp32.dac, source.model, source.dac)
        bad += ["codec"] * (worst > 0.0)  # the pickled codec is exact, not only within FOLD_REL
        for name in ("config.json", "generation_config.json"):
            with open(os.path.join(init_dir, name)) as f:
                print(f"  {name}: {json.dumps(json.load(f))}")
        print(f"  loaded in fp32 in {numbers['load_fp32_s']:.2f} s: parameters equal to "
              f"from_random(cfg, seed=0)'s: {not bad}; config and generation config the "
              f"script's: {fp32.config == cfg and fp32.generation_config == script_gen}")
        need(not bad and fp32.config == cfg and fp32.generation_config == script_gen,
             f"init directory in fp32: {bad[:5]}")
        del fp32, source
        torch.cuda.empty_cache()

        # ---- 3. served in bf16, greedy over Q_COLUMNS columns
        t0 = time.perf_counter()
        native = ParlerTTSPipeline.from_pretrained(init_dir, generation_config=gen, device=dev,
                                                   dtype=torch.bfloat16)
        torch.cuda.synchronize()
        numbers["load_bf16_s"] = time.perf_counter() - t0
        flash_decode_attention.launches = 0
        t0 = time.perf_counter()
        out = native.generate_codes(*request)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        k1, steps = flash_decode_attention.launches, out.steps - 2
        audio, _ = native.decode_codes(out.codes, out.lengths)
        numbers.update(k1=k1, steps_per_s=steps / wall)
        print(f"  served in bf16 (loaded in {numbers['load_bf16_s']:.2f} s), B=2 greedy: "
              f"{out.steps} columns, {steps / wall:.1f} decode steps/s, K1 launches {k1} = "
              f"{n_layers} x {steps}: {k1 == n_layers * steps}; audio {audio.shape} finite "
              f"{bool(np.isfinite(audio).all())} ({card})")
        need(out.steps == Q_COLUMNS and k1 == n_layers * steps and np.isfinite(audio).all(),
             f"serving the init directory: {out.steps} columns, K1 {k1}")

        # ---- 4. push_trained_parler_tts_to_hub on its params.pkl and config.json
        export_dir = os.path.join(root, "hf")
        t0 = time.perf_counter()
        push_trained_parler_tts_to_hub.main([os.path.join(init_dir, "params.pkl"),
                                             os.path.join(init_dir, "config.json"), export_dir,
                                             "--device", "cuda"])
        numbers["export_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        hf = ParlerTTSPipeline.from_pretrained(export_dir, generation_config=gen, device=dev,
                                               dtype=torch.bfloat16)
        torch.cuda.synchronize()
        numbers["export_load_s"] = time.perf_counter() - t0
        bad, worst = param_mismatches(hf.model, hf.dac, native.model, native.dac)
        bad += ["codec"] * (worst > 0.0)
        print(f"  push_trained_parler_tts_to_hub: {dir_bytes(export_dir) / 1e9:.3f} GB "
              f"({', '.join(sorted(os.listdir(export_dir)))}) in {numbers['export_s']:.2f} s, "
              f"loaded in bf16 in {numbers['export_load_s']:.2f} s: model and codec equal to "
              f"the native load's: {not bad} ({card})")
        need(not bad, f"trained-checkpoint export: {bad[:5]}")
        del hf
        shutil.rmtree(export_dir)

        # ---- 5. push_dac_to_hub on the real-size codec's state dict, both forms
        state = export_dac_params(tensor_tree(native.dac), cfg.audio_encoder, prefix="",
                                  v_scale=1.7)
        write_safetensors(os.path.join(root, "dac.safetensors"), state)
        torch.save({"state_dict": {k: v.cpu() for k, v in state.items()}},
                   os.path.join(root, "dac.pth"))
        del state
        codes = out.codes.clamp(0, size - 1)

        def decode(tree):
            dac = build_codec(cfg.audio_encoder, dev)
            load_jax_dac_params(dac, tree)
            with torch.inference_mode():
                return dac.eval().decode(codes).double(), dac

        with torch.inference_mode():
            want = native.dac.decode(codes).double()
        numbers["dac_rel"] = {}
        for form in ("safetensors", "pth"):
            out_dir = os.path.join(root, f"dac_{form}")
            t0 = time.perf_counter()
            push_dac_to_hub.main([os.path.join(root, f"dac.{form}"), out_dir, "--device", "cuda"])
            seconds = time.perf_counter() - t0
            tree = load_pickle(os.path.join(out_dir, "dac_params.pkl"))
            got, dac = decode(tree)
            bad, fold = param_mismatches(native.model, dac, native.model, native.dac)
            rel = ((got - want).norm() / want.norm()).item()
            tree["decoder"]["conv_in"]["kernel"] = tree["decoder"]["conv_in"]["kernel"] * 1.7
            unfolded = decode(tree)[0]
            neg = ((unfolded - want).norm() / want.norm()).item()
            numbers["dac_rel"][form] = rel
            print(f"  push_dac_to_hub .{form}: {seconds:.2f} s; its folded kernels within "
                  f"{fold:.2e} of their scale (limit {FOLD_REL:g}), the rest equal: {not bad}; "
                  f"its decode of the served codes within {rel:.2e} of the pipeline codec's "
                  f"(relative RMS; limit {DAC_DECODE_REL:g}); one kernel left unfolded: "
                  f"{neg:.2e}")
            need(not bad and 0.0 < fold and rel <= DAC_DECODE_REL < neg,
                 f"push_dac_to_hub .{form}: {bad[:5]}, fold {fold:.2e}, decode {rel:.2e}, "
                 f"unfolded {neg:.2e}")
            del dac, got, unfolded
        del native, want
        torch.cuda.empty_cache()

        # ---- 6. the demo's CLI loop: speculative W=16, sampled over Q_COLUMNS columns
        answers = ["", ""]  # the default prompt and description, then EOF

        def answer(prompt=""):
            if not answers:
                raise EOFError
            return answers.pop(0)

        waves = []
        gradio_demo.OUTPUT_WAV = os.path.join(root, "demo.wav")
        gradio_demo.input = answer
        gradio_demo.write_wav = lambda path, rate, wav: waves.append(wav) or saved[
            "write_wav"](path, rate, wav)
        gradio = sys.modules.get("gradio")
        sys.modules["gradio"] = None  # the CLI loop, whatever the machine has installed
        flash_decode_attention.launches = flash_decode_attention.launches_window = 0
        t0 = time.perf_counter()
        try:
            demo = gradio_demo.main(["--model", init_dir, "--device", "cuda"],
                                    tokenizer=stub_tokenizer, dtype=torch.bfloat16,
                                    generation_config=dataclasses.replace(
                                        script_gen, max_length=Q_COLUMNS,
                                        min_new_tokens=Q_COLUMNS, codebook_guard=size))
        finally:
            if gradio is None:
                del sys.modules["gradio"]
            else:
                sys.modules["gradio"] = gradio
        numbers["demo_s"] = time.perf_counter() - t0
        stats, k1 = demo.last_spec_stats, flash_decode_attention.launches
        k1w = flash_decode_attention.launches_window
        with wave.open(gradio_demo.OUTPUT_WAV) as f:
            frames, rate = f.getnframes(), f.getframerate()
        want_frames = (Q_COLUMNS - cfg.decoder.num_codebooks) * cfg.audio_encoder.hop_length
        numbers.update(demo_k1=k1, demo_k1_window=k1w, demo_forwards=stats.forwards,
                       demo_frozen=stats.frozen, demo_columns=stats.columns)
        k1_ok = k1 == n_layers * (stats.forwards + stats.frozen) == k1w
        print(f"  demo (load, then one request): {numbers['demo_s']:.2f} s; window "
              f"{demo.spec_window}, {stats.columns} columns in {stats.forwards} forwards "
              f"(+{stats.frozen} frozen); K1 launches {k1} = {n_layers} x "
              f"({stats.forwards} + {stats.frozen}), {k1w} on the window kernel: {k1_ok}; WAV "
              f"{frames} samples at {rate} Hz, finite {bool(np.isfinite(waves[0]).all())} "
              f"({card})")
        need(demo.spec_window == 16 and k1_ok
             and stats.forwards > 0 and len(waves) == 1 and np.isfinite(waves[0]).all()
             and frames == want_frames == waves[0].size and rate == cfg.sampling_rate,
             f"demo: window {demo.spec_window}, K1 {k1}, {stats}, {frames} samples")
        del demo
    finally:
        for name, value in saved.items():
            setattr(gradio_demo, name, value)
        gradio_demo.__dict__.pop("input", None)
        shutil.rmtree(root, ignore_errors=True)
        torch.cuda.empty_cache()
    if failed:
        raise AssertionError(f"phase q: {len(failed)} checks failed: {failed}")
    return numbers


# ----------------------------------------------------------- parallelism
# (p2)'s runs, cut for time: at TP=2 each of the 73 collectives of a decode step
# goes through the host (gloo on CUDA tensors; 1.5-2.2 ms each on an H100 80GB
# HBM3 at 700 W). The bf16 runs are held to the one-process run at every
# column (SampleHook forces the reference's token where they part), so 64
# columns compare 62 columns' decisions
P_FP32_COLUMNS = 96       # fp32 greedy TP=2 and speculative runs
P_INT8_COLUMNS = 128      # int8 DP=2 run
P_TP_COLUMNS, P_DP_COLUMNS = 64, 128  # bf16 greedy runs (phase (b): MAX_LENGTH)
P_WARM_COLUMNS = 16       # a warm-up run before each timed bf16 run (> 9 codebooks)
# a partition's near-tie and bf16's own are each the largest move over
# P_TIE_STEPS teacher-forced decode steps after each of these prefixes (columns
# of an 860-column run), so that neither bound rests on one stretch of steps
P_TIE_PREFIXES = (K_COLUMNS // 4, K_COLUMNS // 2, 3 * K_COLUMNS // 4)
P_TIE_STEPS = 22
P_WINDOW = 24
P_TRAIN_LR = 1e-4         # (p1, p2) one train step at a constant lr (no warmup)
P_SAMPLES = 4096          # (p2) sampled entries a leaf in the parameter comparisons
P_RANKS_TIMEOUT_S = 600
# (p2)'s train steps: label, (n_data, n_model, n_seq), fsdp, compute dtype, and
# whether the row-parallel partial sums are all-reduced in fp32 (fp32_partial_sums)
P_TRAIN_MODES = (
    ("DP=2 fp32", (2, 1, 1), False, torch.float32, False),
    ("TP=2 fp32", (1, 2, 1), False, torch.float32, False),
    ("FSDP=2 fp32", (2, 1, 1), True, torch.float32, False),
    ("SP=2 fp32", (1, 1, 2), False, torch.float32, False),
    ("DP=2 bf16", (2, 1, 1), False, torch.bfloat16, False),
    ("FSDP=2 bf16", (2, 1, 1), True, torch.bfloat16, False),
    ("SP=2 bf16", (1, 1, 2), False, torch.bfloat16, False),
    ("TP=2 bf16", (1, 2, 1), False, torch.bfloat16, False),
    ("TP=2 bf16, fp32 partial sums", (1, 2, 1), False, torch.bfloat16, True),
)
# (p2)'s bf16 greedy runs held to one process at every column: result key, the
# one-process run's payload key, and its teacher-forced decode steps' key
P_HELD_RUNS = (("dp2_bf16", "want_dp", None), ("tp2_bf16", "want_tp", "tp2_steps"),
               ("tp2_int8_bf16", "want_tp_int8", "tp2_int8_steps"),
               ("tp2_fused_bf16", "want_tp", "tp2_fused_steps"))


def k1_sharded(dev, card, label, h, b, n_layers, w=None):
    """K1 against its plain version at a tensor-parallel rank's head count
    (fp32 and bf16 within TOL at the split count of the kernel each routes
    to, the route read off the launch counters, a second call bit for bit,
    a dropped last slot failing fp32 TOL and, on the window kernel, bf16 TOL
    over a short range), then timed in bf16 by CUDA-graph replay over the
    stacked cache beside its plain version and SDPA. Returns the numbers for
    the kernels line."""
    import torch.nn.functional as F

    from parler_tts_tpu_torch.ops.flash_decode import (
        flash_decode_attention,
        flash_decode_attention_plain,
        k1_route,
        kernel_split_count,
    )

    dh, cols = 64, w or 1
    g = torch.Generator(device=dev).manual_seed(h * 100 + b)
    starts = torch.tensor([0, 3][:b], dtype=torch.int32, device=dev)
    limit = K_SLOTS - cols + 1
    max_err, routes = 0.0, {}
    for dtype in (torch.float32, torch.bfloat16):
        splits = kernel_split_count(dtype, b, h, h, K_SLOTS, cols, dh)
        route = routes[str(dtype)[6:]] = k1_route(dtype, 1, cols, dh)
        window_before = flash_decode_attention.launches_window
        ck, cv = ((torch.randn(n_layers, b, K_SLOTS, h * dh, generator=g, device=dev) * 0.3)
                  .to(dtype) for _ in range(2))
        shape = (b, h, dh) if w is None else (b, w, h, dh)
        q = (torch.randn(shape, generator=g, device=dev) * 0.3).to(dtype)
        for layer in (0, n_layers - 1):
            got = flash_decode_attention(q, ck, cv, starts, limit, layer=layer)
            want = flash_decode_attention_plain(q, ck, cv, starts, limit, layer=layer,
                                                splits=splits)
            torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])
            if not torch.equal(flash_decode_attention(q, ck, cv, starts, limit, layer=layer),
                               got):
                raise AssertionError(f"K1 {label}: a second call gave other bits")
            max_err = max(max_err, (got.float() - want.float()).abs().max().item())
            if dtype == torch.float32 and layer == 0:
                short = flash_decode_attention_plain(q, ck, cv, starts, limit - 1, layer=layer,
                                                     splits=splits)
                if torch.allclose(got, short, **TOL[dtype]):
                    raise AssertionError(f"K1 {label}: fp32 TOL misses a dropped last slot")
        window = flash_decode_attention.launches_window - window_before
        if window != (4 if route == "window" else 0):
            raise AssertionError(f"K1 {label} {dtype}: route {route}, but {window} of 4 launches "
                                 f"on the window kernel")
        if route == "window":
            gap = window_dropped_slot(q, ck, cv, n_layers - 1, label)
            print(f"  K1 {label} bf16 on the window kernel: over limits [6, 10][:B] the last "
                  f"column's last slot dropped moves it by {gap:.3e}, outside bf16 TOL")
        if dtype == torch.bfloat16:
            def k1(i):
                return flash_decode_attention(q, ck, cv, starts, limit, layer=i % n_layers)

            kernel_ms = graph_ms(k1, n_layers)
            plain_ms = cuda_ms(lambda i: flash_decode_attention_plain(
                q, ck, cv, starts, limit, layer=i % n_layers, splits=splits), iters=48)
            # SDPA over the same slots: column j of row r sees [start_r, limit + j)
            q4 = q.view(b, h, 1, dh) if w is None else q.transpose(1, 2)
            top = limit + cols - 1
            kv = [(ck[i].view(b, K_SLOTS, h, dh)[:, :top].transpose(1, 2),
                   cv[i].view(b, K_SLOTS, h, dh)[:, :top].transpose(1, 2))
                  for i in range(n_layers)]
            slot = torch.arange(top, device=dev)
            mask = ((slot[None, None, :] >= starts[:, None, None])
                    & (slot[None, None, :] < limit + torch.arange(cols, device=dev)[None, :, None]))
            library_ms = graph_ms(lambda i: F.scaled_dot_product_attention(
                q4, *kv[i % n_layers], attn_mask=mask[:, None], scale=1.0), n_layers)
            slots = sum(limit + cols - 1 - int(s) for s in starts.tolist())
            bound_ms, bound_by = bound(2 * b * cols * h * dh * 2 + 2 * slots * h * dh * 2,
                                       4 * h * dh * slots * cols, BF16_OPS_PER_S)
        del ck, cv
    print(f"  K1 {label}: B={b}, H={h}, W={cols}, {K_SLOTS} slots, routes {routes}, {splits} "
          f"splits in bf16: max_abs_err "
          f"{max_err:.3e} (fp32 and bf16 within TOL, repeats bit for bit, a dropped last slot "
          f"fails fp32 TOL); bf16 {kernel_ms * 1e3:.2f} us (graph replay), plain "
          f"{plain_ms * 1e3:.2f} us, SDPA "
          + f"{library_ms * 1e3:.2f} us (boolean mask), bound {bound_ms * 1e3:.2f} us ({bound_by}) ({card})")
    return dict(shape=dict(b=b, h=h, w=cols, slots=K_SLOTS, splits=splits), routes=routes,
                max_abs_err=max_err,
                ms=kernel_ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms,
                bound_by=bound_by)


def phase_p0(dev, card):
    """K1, K2 and K4 at the shapes parallelism gives them."""
    import parler_tts_tpu_torch.ops.flash_attention as fa
    from parler_tts_tpu_torch.utils.quantize import quantize_kernel_torch

    k1 = {
        "mini_v1_tp2": k1_sharded(dev, card, "mini-v1 TP=2", 8, BATCH, 24),
        "large_v1_tp2": k1_sharded(dev, card, "large-v1 TP=2", 12, BATCH, 30),
        "mini_v1_tp2_window": k1_sharded(dev, card, "mini-v1 TP=2 W=24", 8, 1, 24, w=P_WINDOW),
        "mini_v1_dp2": k1_sharded(dev, card, "mini-v1 DP=2 (a rank's row)", 16, 1, 24),
    }
    g = torch.Generator(device=dev).manual_seed(7)
    k2 = {}
    for k, n in ((1024, 1024), (1024, 4096), (4096, 1024)):
        w, s = quantize_kernel_torch(torch.randn(k, n, generator=g, device=dev) * 0.02)
        x = torch.randn(1, k, generator=g, device=dev).to(torch.bfloat16)
        err, slices, _ = k2_check(x, w, s, f"K2 DP=2 M=1 {k}x{n}")
        k2[f"{k}x{n}"] = dict(m=1, max_abs_err=err, slices=slices)
    print(f"  K2 at a DP=2 rank's M=1 (int8 serving's K x N): "
          + ", ".join(f"{kn} error {v['max_abs_err']:.3e} over {v['slices']} slices"
                      for kn, v in k2.items()) + " within k2_close, repeats bit for bit, a "
          f"dropped K slice caught ({card})")
    k2["tp2"] = k2_tp_slices(dev, card)
    t = T_PROMPT_TRAIN + T_FRAMES_TRAIN
    k4, fails = {}, []
    for label, b, h, pad in (("TP=2 rank", 2, 8, 5), ("DP=2 rank", 1, 16, 0)):
        for dtype in (torch.bfloat16, torch.float32):
            route, errs, failure = k4_case_check(fa, f"mini-v1 {label}", dtype, b, t, t, h, h,
                                                 True, 0, pad, 64, dev)
            k4[f"{label.split()[0]}_{route}"] = dict(b=b, h=h, t=t, max_abs_err=errs)
            if failure:
                fails.append(failure)
    # a seq=2 rank's rows of phase (i)'s sequence (rank 0 also holds the prompt)
    for rank, (tq, q_offset) in enumerate(seq_rank_rows()):
        for dtype in (torch.bfloat16, torch.float32):
            route, errs, failure = k4_case_check(
                fa, f"mini-v1 SP=2 rank {rank}, q_offset {q_offset}", dtype, BATCH, tq, t, 16,
                16, True, q_offset, 5, 64, dev)
            k4[f"SP_rank{rank}_{route}"] = dict(b=BATCH, h=16, tq=tq, tk=t, q_offset=q_offset,
                                               max_abs_err=errs)
            if failure:
                fails.append(failure)
    if fails:
        raise AssertionError(f"K4 at the sharded shapes: {fails}")
    k4["SP_times"] = [k4_rank_times(dev, card, tq, t, q_offset)
                      for tq, q_offset in seq_rank_rows()]
    return dict(k1=k1, k2=k2, k4=k4)


def seq_rank_rows():
    """(Tq, q_offset) of each seq=2 rank over phase (i)'s prompt and frames:
    rank 0 holds the prompt and the first half of the frames."""
    half = T_FRAMES_TRAIN // 2
    return [(T_PROMPT_TRAIN + half, 0), (half, T_PROMPT_TRAIN + half)]


def k4_rank_times(dev, card, tq, tk, q_offset):
    """K4's tensor-core kernels at a seq rank's shape (B=2, H=16, bf16, row
    1's first 5 keys masked), each timed as phase (h) times them, beside its
    plain version and SDPA (forward, with the equal boolean mask), with the
    bound of the visible (query, key) pairs."""
    import torch.nn.functional as F

    from parler_tts_tpu_torch.ops import flash_attention as fa

    q, k, v, mask, do = k4_inputs(dev, torch.bfloat16, BATCH, tq, tk, 16, 16, 5)
    b, _, h, dh = q.shape
    ok = fa._visible(mask, tq, True, q_offset)
    pairs = int(ok.sum()) * h
    dims = (1, b, h, tq, tk, dh, 1, q_offset)
    mask_u8 = mask.to(torch.uint8)
    q_elems, k_elems = b * tq * h * dh, b * tk * h * dh
    out = {}
    with torch.no_grad():
        o, lse = fa._launch_fwd(q, k, v, mask_u8, dims, "wgmma")
        _, delta = fa._launch_dq(q, k, v, mask_u8, o, lse, do, dims, "wgmma")
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        # name: (kernel, plain version, library call, matmuls a visible pair, bf16
        # elements read and written (q, o, do, dq: Tq rows; k, v, dk, dv: Tk rows),
        # fp32 rows of lse / delta)
        runs = {
            "fwd": (lambda i: fa._launch_fwd(q, k, v, mask_u8, dims, "wgmma"),
                    lambda i: fa.flash_attention_plain(q, k, v, mask, q_offset=q_offset),
                    lambda i: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=ok,
                                                             scale=1.0),
                    2, 2 * q_elems + 2 * k_elems, 1),
            "dq": (lambda i: fa._launch_dq(q, k, v, mask_u8, o, lse, do, dims, "wgmma"),
                   lambda i: fa._plain_backward(q, k, v, ok, o, lse, do, torch.float32,
                                                parts=("dq",)),
                   None, 3, 4 * q_elems + 2 * k_elems, 2),
            "dkv": (lambda i: fa._launch_dkv(q, k, v, mask_u8, lse, do, delta, dims, "wgmma"),
                    lambda i: fa._plain_backward(q, k, v, ok, o, lse, do, torch.float32,
                                                 parts=("dkv",)),
                    None, 4, 2 * q_elems + 4 * k_elems, 2),
        }
        for name, (kernel, plain, lib, matmuls, elems, lse_rows) in runs.items():
            bytes_moved = 2 * elems + 4 * b * h * tq * lse_rows + b * tk
            ops = 2 * dh * pairs * matmuls
            byte_s, op_s = bytes_moved / HBM_BYTES_PER_S, ops / BF16_OPS_PER_S
            out[name] = dict(ms=padded_ms(kernel, iters=20), plain_ms=padded_ms(plain, iters=5),
                             library_ms=None if lib is None else padded_ms(lib, iters=20),
                             bound_ms=max(byte_s, op_s) * 1e3,
                             bound_by="bytes" if byte_s >= op_s else "operations")
    print(f"  K4 wgmma at a seq=2 rank's shape (B={b}, H={h}, Tq={tq}, Tk={tk}, q_offset "
          f"{q_offset}, bf16): " + "; ".join(
              f"{n} {r['ms']:.4f} ms (plain {r['plain_ms']:.3f}"
              + ("" if r["library_ms"] is None else f", SDPA {r['library_ms']:.4f}")
              + f", bound {r['bound_ms']:.4f} {r['bound_by']})" for n, r in out.items())
          + f" ({card})")
    return dict(tq=tq, tk=tk, q_offset=q_offset, **out)


# a TP=2 rank's int8 slices of a mini-v1 decoder layer, (K, N) and launches a
# layer: q/k/v and the cross-attention q by columns, out_proj (self and cross)
# by rows, fc1 by columns, fc2 by rows
K2_TP2_SHAPES = ((1024, 512), (512, 1024), (1024, 2048), (2048, 1024))
K2_TP2_PER_LAYER = (4, 2, 1, 1)


def k2_tp_slices(dev, card):
    """K2 at each TP=2 rank slice, M=2, bf16 x, against its plain version
    (k2_check); one rank's decode layer (8 launches) timed by CUDA-graph
    replay over 24 layers' weights beside the bf16 matmul of the same
    slices and the plain version."""
    from parler_tts_tpu_torch.ops.quant_matmul import quant_matmul, quant_matmul_plain
    from parler_tts_tpu_torch.utils.quantize import quantize_kernel_torch

    g = torch.Generator(device=dev).manual_seed(8)
    out = {}
    layers = [[quantize_kernel_torch(torch.randn(k, n, generator=g, device=dev) * 0.02)
               for (k, n), per in zip(K2_TP2_SHAPES, K2_TP2_PER_LAYER) for _ in range(per)]
              for _ in range(24)]
    xs = {k: torch.randn(BATCH, k, generator=g, device=dev).to(torch.bfloat16)
          for k in (512, 1024, 2048)}
    for k, n in K2_TP2_SHAPES:
        w, s = next((w, s) for w, s in layers[0] if w.shape == (k, n))
        err, slices, _ = k2_check(xs[k], w, s, f"K2 TP=2 rank M={BATCH} {k}x{n}")
        out[f"{k}x{n}"] = dict(m=BATCH, max_abs_err=err, slices=slices)

    def k2_layer(i):
        for w, s in layers[i]:
            quant_matmul(xs[w.shape[0]], w, s)

    deq = [[w.to(torch.bfloat16) for w, _ in layer] for layer in layers]

    def mm_layer(i):
        for w in deq[i]:
            torch.matmul(xs[w.shape[0]], w)

    timing = dict(ms=graph_ms(k2_layer, 24), library_ms=graph_ms(mm_layer, 24),
                  plain_ms=padded_ms(lambda i: [quant_matmul_plain(xs[w.shape[0]], w, s)
                                                for w, s in layers[i % 24]], iters=10))
    bytes_moved = sum(per * (k * n + BATCH * k * 2 + n * 4 + BATCH * n * 2)
                      for (k, n), per in zip(K2_TP2_SHAPES, K2_TP2_PER_LAYER))
    ops = sum(per * 2 * BATCH * k * n for (k, n), per in zip(K2_TP2_SHAPES, K2_TP2_PER_LAYER))
    byte_s, op_s = bytes_moved / HBM_BYTES_PER_S, ops / INT8_OPS_PER_S
    timing.update(bound_ms=max(byte_s, op_s) * 1e3,
                  bound_by="bytes" if byte_s >= op_s else "operations")
    del layers, deq
    print(f"  K2 at a TP=2 rank's slices, M={BATCH}: " + ", ".join(
        f"{kn} error {v['max_abs_err']:.3e} over {v['slices']} slices" for kn, v in out.items())
        + f" within k2_close, repeats bit for bit, a dropped K slice caught; one rank's decode "
        f"layer (8 launches) {timing['ms'] * 1e3:.2f} us by graph replay, bf16 matmul "
        f"{timing['library_ms'] * 1e3:.2f} us, plain {timing['plain_ms'] * 1e3:.2f} us, bound "
        f"{timing['bound_ms'] * 1e3:.2f} us ({timing['bound_by']}) ({card})")
    return dict(out, layer=timing)


def p_train_model(dev, dtype, cfg=None):
    """phase (i)'s trainer (mini-v1, fp32 parameters, K4, remat) at `dtype`
    compute, from seed 0, with the optimizer of the (p) steps."""
    from parler_tts_tpu_torch.config import mini_v1_config
    from parler_tts_tpu_torch.models.layers import init_weights
    from parler_tts_tpu_torch.models.parler import ParlerTTS
    from parler_tts_tpu_torch.training import TrainState, make_optimizer

    model = ParlerTTS(cfg or mini_v1_config(), device=dev, dtype=dtype,
                      param_dtype=torch.float32, use_chunked_attention="pallas",
                      remat_layers=True)
    init_weights(model, torch.Generator(device=dev).manual_seed(0))
    tx = make_optimizer(learning_rate=P_TRAIN_LR, warmup_steps=0)
    return model, tx, TrainState.create(model, tx)


def phase_p1(dev, card, source, out_b, backend="nccl"):
    """NCCL at world size 1: `make_generate(mesh=)` over phase (b)'s request
    and one train step over a mesh and under FSDP, each bit-identical to the
    run without a mesh (`backend` is for a rehearsal on the CPU)."""
    import socket

    import torch.distributed as dist

    from parler_tts_tpu_torch.parallel import make_mesh
    from parler_tts_tpu_torch.runtime.generate import make_generate
    from parler_tts_tpu_torch.training import make_train_step
    from parler_tts_tpu_torch.training.train_state import shard_train_state

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}", rank=0,
                            world_size=1)
    try:
        mesh = make_mesh(1, 1, device=dev)
        request = [torch.as_tensor(x, device=dev) for x in request_ids(0)]
        t0 = time.perf_counter()
        out = make_generate(source.model, source.generation_config, torch.bfloat16,
                            mesh=mesh)(*request)
        torch.cuda.synchronize()
        gen_s = time.perf_counter() - t0
        same_gen = torch.equal(out.delayed_ids, out_b.delayed_ids) and out.steps == out_b.steps
        print(f"  NCCL world 1: make_generate(mesh=make_mesh(1, 1)) over phase (b)'s request, "
              f"{out.steps} columns in {gen_s:.2f} s: delayed ids bit-identical to phase (b)'s: "
              f"{same_gen}")
        batch = train_batch(dev)
        results = {}
        for mode in ("no mesh", "mesh", "fsdp"):
            model, tx, state = p_train_model(dev, torch.bfloat16)
            m = None
            if mode != "no mesh":
                m = mesh
                shard_train_state(state, mesh, fsdp=mode == "fsdp")
            _, metrics = make_train_step(model, tx, mesh=m)(state, batch, 0)
            torch.cuda.synchronize()
            params = {n: p.detach().clone() for n, p in model.named_parameters()}
            if mode == "no mesh":
                results[mode] = (float(metrics["loss"]), float(metrics["grad_norm"]), params)
            else:
                want = results["no mesh"]
                same = (float(metrics["loss"]) == want[0] and float(metrics["grad_norm"]) == want[1]
                        and all(torch.equal(p, want[2][n]) for n, p in params.items()))
                results[mode] = same
                print(f"  NCCL world 1: one train step {mode}: loss {float(metrics['loss']):.6f}, "
                      f"grad_norm {float(metrics['grad_norm']):.6f}, loss, grad_norm and every "
                      f"parameter bit-identical to the step without a mesh: {same}")
            del model, tx, state, params
            torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    if not (same_gen and results["mesh"] and results["fsdp"]):
        raise AssertionError(f"NCCL world 1 is not the run without a mesh: generate {same_gen}, "
                             f"train {results['mesh']}, fsdp {results['fsdp']}")
    del results
    torch.cuda.empty_cache()


def sampled_entries(named, positions):
    """{name: the flat entries at `positions[name]`} of (name, tensor) pairs."""
    return {n: t.detach().reshape(-1)[positions[n].to(t.device)].float().cpu()
            for n, t in named if n in positions}


def sample_positions(model):
    """P_SAMPLES seeded flat positions a parameter of `model` (all of a small one)."""
    g = torch.Generator().manual_seed(5)
    out = {}
    for n, p in model.named_parameters():
        out[n] = (torch.arange(p.numel()) if p.numel() <= P_SAMPLES
                  else torch.randint(0, p.numel(), (P_SAMPLES,), generator=g))
    return out


def update_flips(a, b, lr):
    """(share of sampled entries whose values differ by more than lr / 2,
    largest difference): two AdamW steps from one point differ there by an
    update's sign."""
    n = flips = 0
    worst = 0.0
    for name, x in a.items():
        d = (x - b[name]).abs()
        n, flips = n + d.numel(), flips + int((d > lr / 2).sum())
        worst = max(worst, float(d.max()))
    return flips / n, worst


def phase_p2_refs(dev, card, source):
    """The main process's generation references for (p2): the fp32 AR run
    over P_FP32_COLUMNS, the bf16 runs the ranks are held to (of (b)'s model
    and of its int8 quantization, `q8`), the one-process logits of
    the teacher-forced bf16 decode steps of each (tie_steps_logits; TP's near-tie is
    read against them), bf16's own near-tie (those steps against fp32's)
    and a row alone's (DP)."""
    import dataclasses

    from parler_tts_tpu_torch.models.layers import init_weights
    from parler_tts_tpu_torch.models.parler import ParlerTTS
    from parler_tts_tpu_torch.runtime.generate import make_generate

    request = [torch.as_tensor(x, device=dev) for x in request_ids(0)]
    gen32 = dataclasses.replace(source.generation_config, max_length=P_FP32_COLUMNS,
                                min_new_tokens=P_FP32_COLUMNS)
    fp32 = fp32_copy(source.model, dev)
    with torch.inference_mode():
        ar32 = make_generate(fp32, gen32, torch.float32)(*request).delayed_ids
    tie_steps32 = tie_steps_logits(fp32, dev, torch.float32)
    del fp32
    torch.cuda.empty_cache()
    ar16 = {}
    for cols in (P_TP_COLUMNS, P_DP_COLUMNS):
        g = dataclasses.replace(source.generation_config, max_length=cols, min_new_tokens=cols)
        ar16[cols] = (g, make_generate(source.model, g, torch.bfloat16)(*request).delayed_ids)

    # near-ties over the same teacher-forced steps: bf16's own (one process's
    # bf16 logits against fp32's) and DP's (a rank decodes its row alone, M = 1)
    model = source.model
    tie_steps = tie_steps_logits(model, dev, torch.bfloat16)
    bf16_moves = top_two_moves(tie_steps, tie_steps32)
    dp_tie = max(top_two_moves(tie_steps[r:r + 1], tie_steps_logits(
        model, dev, torch.bfloat16, row=r)).max().item() for r in range(BATCH))
    del tie_steps32
    # the int8 model the ranks build (the quantization of (b)'s float weights) in one process
    q8 = ParlerTTS(model.config, device=dev, dtype=torch.bfloat16, weight_quant=True)
    init_weights(q8, torch.Generator(device=dev).manual_seed(0))
    g = ar16[P_TP_COLUMNS][0]
    int8 = (g, make_generate(q8, g, torch.bfloat16)(*request).delayed_ids)
    int8_steps = tie_steps_logits(q8, dev, torch.bfloat16).float().cpu()
    print(f"  references: over {P_TIE_STEPS} teacher-forced decode steps after each of the "
          f"prefixes {P_TIE_PREFIXES} the bf16 logits move the top-two gap from fp32's by at "
          f"most {bf16_moves.max().item():.3e} ({per_prefix(bf16_moves)} by prefix; median "
          f"{bf16_moves.median().item():.3e}), a row alone by at most {dp_tie:.3e} ({card})")
    return dict(ar32=ar32, ar16=ar16, dp_tie=dp_tie, bf16_tie=bf16_moves.max().item(),
                bf16_moves=bf16_moves.float().cpu(),
                tie_steps=tie_steps.float().cpu(), int8=int8, int8_steps=int8_steps, q8=q8)


def p2_train_refs(dev, card):
    """One single-process train step at dropout 0.1 over phase (i)'s batch,
    in bf16, in fp32 and in bf16 with fp32 products at the sites TP makes
    row-parallel (fp32_partial_sums): the references of (p2)'s steps."""
    from parler_tts_tpu_torch.training import Batch, make_train_step

    batch, train = train_batch(dev), {}
    for label, dtype, fp32_sums in (("bf16", torch.bfloat16, False),
                                    ("fp32", torch.float32, False),
                                    ("bf16, fp32 products", torch.bfloat16, True)):
        model_t, tx, state = p_train_model(dev, dtype, p_train_config())
        positions = sample_positions(model_t)
        with fp32_partial_sums(model_t) if fp32_sums else contextlib.nullcontext():
            _, metrics = make_train_step(model_t, tx)(state, Batch(*batch), 0)
        train[label] = dict(loss=float(metrics["loss"]), grad_norm=float(metrics["grad_norm"]),
                            num_items=float(metrics["num_items"]),
                            params=sampled_entries(model_t.named_parameters(), positions))
        del model_t, tx, state
        torch.cuda.empty_cache()
    flips, worst = update_flips(train["fp32"]["params"], train["bf16"]["params"], P_TRAIN_LR)
    train["flips"] = flips
    print(f"  references: one mini-v1 train step at dropout 0.1, bf16 loss "
          f"{train['bf16']['loss']:.6f} grad_norm {train['bf16']['grad_norm']:.6f}, fp32 loss "
          f"{train['fp32']['loss']:.6f} grad_norm {train['fp32']['grad_norm']:.6f}, bf16 with "
          f"fp32 products at the row-parallel sites loss "
          f"{train['bf16, fp32 products']['loss']:.6f} grad_norm "
          f"{train['bf16, fp32 products']['grad_norm']:.6f}; the bf16 and fp32 steps' updates "
          f"part on {flips:.3%} of the sampled entries (largest {worst:.2e}) ({card})")
    return train


@contextlib.contextmanager
def fp32_partial_sums(model):
    """A diagnostic of (p2)'s bf16 train steps: inside it, the projections
    that tensor parallelism makes row-parallel (the decoder's out_proj and
    fc2, T5's o and wo) form their products in fp32 from the operands
    rounded to the compute dtype (fp32 holds those products exactly) and
    round the sum once: a tensor-parallel `model` all-reduces its fp32
    partial sums and rounds after, one process rounds its product. The port
    itself rounds each rank's partial sum to bf16 and all-reduces in bf16;
    one process's bf16 product is cuBLAS's."""
    from unittest import mock

    from parler_tts_tpu_torch.models import decoder, t5_encoder
    from parler_tts_tpu_torch.parallel import collectives

    def fp32_product(dense, whole):
        def forward(x):
            y = x.to(dense.dtype).float() @ dense.kernel.to(dense.dtype).float()
            return y.to(dense.dtype) if whole else y
        return forward

    def rounded(y, shard):
        return collectives.reduce_from(y, shard).to(model.dtype)

    rows = ([(m, m.out_proj) for m in model.modules() if isinstance(m, decoder.Attention)]
            + [(m, m.fc2) for m in model.modules() if isinstance(m, decoder.DecoderLayer)]
            + [(m, m.o) for m in model.modules() if isinstance(m, t5_encoder.T5SelfAttention)]
            + [(m, m.wo) for m in model.modules() if isinstance(m, t5_encoder.T5FeedForward)])
    if any(d.bias is not None or d.__class__.__name__ != "Dense" for _, d in rows):
        raise AssertionError("fp32_partial_sums: a row-parallel projection is not a bias-free "
                             "Dense")
    for owner, d in rows:
        d.forward = fp32_product(d, owner.tp is None)
    try:
        with mock.patch.object(decoder, "reduce_from", rounded), \
                mock.patch.object(t5_encoder, "reduce_from", rounded):
            yield len(rows)
    finally:
        for _, d in rows:
            del d.forward


def block_kinds(model):
    """{allocator block bytes: what a block of that size may hold}: a
    parameter as this rank holds it or gathered over two ranks, in fp32 or
    bf16 (the allocator rounds a block up to 512 bytes)."""
    kinds = {}
    for name, p in model.named_parameters():
        for times, whose in ((1, "a rank's"), (2, "a gathered")):
            for dtype, width in (("fp32", 4), ("bf16", 2)):
                size = -(-p.numel() * times * width // 512) * 512
                kind = f"{dtype} {whose}"
                seen = kinds.setdefault(size, [[], name])[0]
                if kind not in seen:
                    seen.append(kind)
    return {size: f"{' or '.join(k)} parameter, e.g. {name}" for size, (k, name) in kinds.items()}


def peak_sites(trace, kinds, top=6):
    """(bytes above the recording's start at the recorded peak, its largest
    groups of live allocations as (bytes, blocks, what)) from one device's
    allocator trace (`torch.cuda.memory._snapshot()["device_traces"]`),
    replaying its alloc and free_completed events. Blocks are grouped by
    size, named by `kinds` (block_kinds) where a parameter has that size."""
    cur = peak = 0
    at = -1
    for i, e in enumerate(trace):
        if e["action"] == "alloc":
            cur += e["size"]
        elif e["action"] == "free_completed":
            cur -= e["size"]
        if cur > peak:
            peak, at = cur, i
    live = {}
    for e in trace[:at + 1]:
        if e["action"] == "alloc":
            live[e["addr"]] = e
        elif e["action"] == "free_completed":
            live.pop(e["addr"], None)
    groups = {}
    for e in live.values():
        what = f"{e['size'] / 2**20:.2f} MiB blocks" + (
            f" ({kinds[e['size']]})" if e["size"] in kinds else "")
        size, n = groups.get(what, (0, 0))
        groups[what] = (size + e["size"], n + 1)
    return peak, sorted(((size, n, what) for what, (size, n) in groups.items()),
                        reverse=True)[:top]


class StepMemory:
    """One train step's device memory in this process, by phase: at rest
    (the placed state), held after the model's forward (what the backward
    needs), the peak before the optimizer (forward, backward, gradient
    collectives), the step's peak; and the allocations live at the peak
    (peak_sites over the allocator's alloc and free events, recorded inside
    it without tracebacks: capturing python stacks broke remat's recompute
    on autograd's thread)."""

    def __init__(self, model, tx):
        self.model, self.tx = model, tx

    def __enter__(self):
        forward, update = self.model.forward, self.tx.update

        def held_forward(*a, **k):
            out = forward(*a, **k)
            self.after_forward = torch.cuda.memory_allocated()
            return out

        def peaked_update(*a, **k):
            self.before_update = torch.cuda.max_memory_allocated()
            return update(*a, **k)

        self.model.forward, self.tx.update = held_forward, peaked_update
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        self.rest = torch.cuda.memory_allocated()
        self.kinds = block_kinds(self.model)
        torch.cuda.memory._record_memory_history(context=None, max_entries=2_000_000)
        return self

    def __exit__(self, *exc):
        torch.cuda.synchronize()
        self.peak = torch.cuda.max_memory_allocated()
        snap = torch.cuda.memory._snapshot()
        torch.cuda.memory._record_memory_history(enabled=None)
        del self.model.forward, self.tx.update
        grown, self.sites = peak_sites(snap["device_traces"][torch.cuda.current_device()],
                                       self.kinds)
        self.replayed = self.rest + grown

    def numbers(self):
        gib = 2.0 ** 30
        return dict(rest_gib=self.rest / gib, after_forward_gib=self.after_forward / gib,
                    before_update_peak_gib=self.before_update / gib, peak_gib=self.peak / gib,
                    replayed_peak_gib=self.replayed / gib,
                    sites=[(b / gib, n, what) for b, n, what in self.sites])

    @staticmethod
    def line(m):
        return (f"at rest {m['rest_gib']:.2f} GiB, held after the forward "
                f"{m['after_forward_gib']:.2f}, peak before the optimizer "
                f"{m['before_update_peak_gib']:.2f}, peak {m['peak_gib']:.2f} (replayed "
                f"{m['replayed_peak_gib']:.2f}); live at the peak: "
                + "; ".join(f"{b:.2f} GiB in {n} {what}" for b, n, what in m["sites"]))


def p_train_config():
    import dataclasses

    from parler_tts_tpu_torch.config import mini_v1_config

    cfg = mini_v1_config()
    return dataclasses.replace(cfg, decoder=dataclasses.replace(cfg.decoder, dropout=0.1))


def launch_ranks(payload, card, meanwhile):
    """Two ranks of `chip_smoke.py --phase-p-rank` sharing the card over gloo
    (LOCAL_RANK 0 for both), with `meanwhile()` run in this process beside
    them (work that needs no rank's result: gloo holds the ranks on the
    host, so the card has room). Returns (the ranks' results in rank order,
    meanwhile's result). Each rank's output is printed; a rank that fails,
    or a pair that outlives P_RANKS_TIMEOUT_S, fails the phase (the ranks
    are killed, as they are when `meanwhile` fails)."""
    import os
    import pickle
    import socket
    import subprocess
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        with open(os.path.join(tmp, "payload.pkl"), "wb") as f:
            pickle.dump(payload, f)
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = str(s.getsockname()[1])
        logs = [os.path.join(tmp, f"log-{r}.txt") for r in range(2)]
        procs = []
        for r in range(2):
            with open(logs[r], "w") as log:  # a file, so a rank never waits on a full pipe
                procs.append(subprocess.Popen(
                    [sys.executable, __file__, "--phase-p-rank", tmp],
                    env=dict(os.environ, RANK=str(r), WORLD_SIZE="2", LOCAL_RANK="0",
                             MASTER_ADDR="127.0.0.1", MASTER_PORT=port),
                    stdout=log, stderr=subprocess.STDOUT, text=True))
        deadline = time.monotonic() + P_RANKS_TIMEOUT_S
        try:
            mine = meanwhile()
            for p in procs:
                p.wait(timeout=max(deadline - time.monotonic(), 1))
        except subprocess.TimeoutExpired:
            raise AssertionError(f"(p2) ranks did not finish in {P_RANKS_TIMEOUT_S} s")
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for r, (p, log) in enumerate(zip(procs, logs)):
            with open(log) as f:
                log = f.read()
            for line in log.splitlines():
                if r == 0 or p.returncode != 0 or "rank 1" in line:
                    print(f"  [rank {r}] {line}")
            if p.returncode != 0:
                raise AssertionError(f"(p2) rank {r} exited {p.returncode}")
        out = []
        for r in range(2):
            with open(os.path.join(tmp, f"result-{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out, mine


def phase_p_rank(tmp):
    """One of (p2)'s two ranks on the shared card (gloo, CUDA tensors)."""
    import dataclasses
    import os
    import pickle

    from parler_tts_tpu_torch.config import mini_v1_config
    from parler_tts_tpu_torch.convert import tensor_tree
    from parler_tts_tpu_torch.models import decoder
    from parler_tts_tpu_torch.models.layers import init_weights
    from parler_tts_tpu_torch.models.parler import ParlerTTS, fused_qkv_model
    from parler_tts_tpu_torch.ops.flash_attention import flash_attention
    from parler_tts_tpu_torch.ops.flash_decode import flash_decode_attention
    from parler_tts_tpu_torch.ops.quant_matmul import quant_matmul
    from parler_tts_tpu_torch.parallel import (
        collectives,
        local_seq_slice,
        make_mesh,
        maybe_init_distributed,
    )
    from parler_tts_tpu_torch.parallel.mesh import gather_full, shard_params
    from parler_tts_tpu_torch.runtime.generate import make_generate
    from parler_tts_tpu_torch.runtime.speculative import make_generate_speculative
    from parler_tts_tpu_torch.training import Batch, make_train_step
    from parler_tts_tpu_torch.training import run_training as rt
    from parler_tts_tpu_torch.training.train_state import shard_train_state

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with open(os.path.join(tmp, "payload.pkl"), "rb") as f:
        payload = pickle.load(f)
    dev = torch.device(payload["device"])  # LOCAL_RANK 0 on both ranks: the one card
    rank, _ = maybe_init_distributed(backend="gloo", device=dev.type)
    res = {}
    say = (lambda *a: print(*a, flush=True)) if rank == 0 else (lambda *a: None)
    request = [torch.as_tensor(x, device=dev) for x in request_ids(0)]
    gen = payload["gen"]
    cfg = mini_v1_config()
    n_layers = cfg.decoder.num_hidden_layers

    # the bf16 and fp32 all-reduce and all-gather on CUDA tensors over gloo, bit
    # for bit against the sum and concatenation of both ranks' seeded tensors
    both = make_mesh(2, 1, device=dev).data
    exact = {}
    for dtype in (torch.bfloat16, torch.float32):
        parts = [torch.randn(1 << 20, generator=torch.Generator(device=dev).manual_seed(100 + r),
                             device=dev).to(dtype) for r in range(2)]
        exact[str(dtype)] = (
            torch.equal(collectives.all_reduce_sum(parts[rank], both), parts[0] + parts[1])
            and torch.equal(collectives.all_gather_dim(parts[rank], 0, both), torch.cat(parts)))
    res["collectives_exact"] = exact

    def served(fn, args, columns):
        collectives.STATS.update(calls=0, seconds=0.0)
        flash_decode_attention.launches = quant_matmul.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args)
        torch.cuda.synchronize()
        s = time.perf_counter() - t0
        steps = columns - 2
        return out, dict(seconds=s, steps_per_s=steps / s, k1=flash_decode_attention.launches,
                         k1_want=n_layers * steps, k2=quant_matmul.launches,
                         collectives_per_step=collectives.STATS["calls"] / steps,
                         host_ms_per_collective=(collectives.STATS["seconds"]
                                                 / max(collectives.STATS["calls"], 1) * 1e3))

    def serve_modes(model, mesh, label, columns, want):
        """A bf16 B=2 run over `columns` after a warm-up, held to `want`
        (the one-process run) at every column: SampleHook records where
        this rank's rows part from it, as (column, row of `want`,
        codebook, own token, wanted token, gap) and forces the wanted
        token."""
        warm = dataclasses.replace(gen, max_length=P_WARM_COLUMNS, min_new_tokens=P_WARM_COLUMNS)
        make_generate(model, warm, torch.bfloat16, mesh=mesh)(*request)
        g = dataclasses.replace(gen, max_length=columns, min_new_tokens=columns)
        first = mesh.data.rank * BATCH // mesh.data.size
        with SampleHook(want=want[first:first + BATCH // mesh.data.size].to(dev)) as hook:
            out, num = served(make_generate(model, g, torch.bfloat16, mesh=mesh), request,
                              columns)
        partings = [(t, b + first, *rest) for t, b, *rest in hook.partings]
        say(f"{label} bf16 B=2 over {columns} columns (the check hook syncs each step): "
            f"{num['steps_per_s']:.1f} decode steps/s, K1 {num['k1']} launches on this rank "
            f"(24 x {columns - 2}: {num['k1'] == num['k1_want']}), "
            f"{num['collectives_per_step']:.1f} collectives a decode step, "
            f"{num['host_ms_per_collective']:.3f} host ms each; {len(partings)} tokens of this "
            f"rank's rows forced to the one-process run's")
        return out.delayed_ids.cpu(), num, partings

    # ---- DP=2: each rank one row of (b)'s request, the whole bf16 model
    model = ParlerTTS(cfg, device=dev, dtype=torch.bfloat16)
    init_weights(model, torch.Generator(device=dev).manual_seed(0))
    dp = make_mesh(2, 1, device=dev)
    res["dp2_bf16"] = serve_modes(model, dp, "DP=2", P_DP_COLUMNS, payload["want_dp"])
    tp = make_mesh(1, 2, device=dev)
    # ---- TP=2 bf16 with one q|k|v kernel a self-attention, each rank its heads' columns
    fused = shard_params(fused_qkv_model(model), tp)
    res["tp2_fused_bf16"] = serve_modes(fused, tp, "TP=2 fused q|k|v", P_TP_COLUMNS,
                                        payload["want_tp"])
    res["tp2_fused_steps"] = tie_steps_logits(fused, dev, torch.bfloat16).float().cpu()
    del fused
    # ---- TP=2 fp32: greedy B=2 and speculative W=24 B=1 (row 0)
    fp32 = ParlerTTS(cfg, device=dev, dtype=torch.float32)
    fp32_tree = tensor_tree(model)
    shard_params(fp32, tp)
    from parler_tts_tpu_torch.convert import load_jax_params

    load_jax_params(fp32, fp32_tree)
    del fp32_tree
    gen32 = dataclasses.replace(gen, max_length=P_FP32_COLUMNS, min_new_tokens=P_FP32_COLUMNS)
    out, num = served(make_generate(fp32, gen32, torch.float32, mesh=tp), request,
                      P_FP32_COLUMNS)
    res["tp2_fp32"] = (out.delayed_ids.cpu(), num)
    say(f"TP=2 fp32 B=2 over {P_FP32_COLUMNS} columns: {num['steps_per_s']:.1f} decode steps/s, "
        f"K1 {num['k1']} (want {num['k1_want']})")
    spec = make_generate_speculative(fp32, gen32, window=P_WINDOW, cache_dtype=torch.float32,
                                     mesh=tp)
    (out, stats), num = served(spec, [x[:1] for x in request], P_FP32_COLUMNS)
    res["tp2_spec_fp32"] = (out.delayed_ids.cpu(), num, tuple(stats))
    say(f"TP=2 speculative fp32 W={P_WINDOW} B=1 over {P_FP32_COLUMNS} columns: {stats}, "
        f"K1 {num['k1']} = 24 x (forwards + frozen): "
        f"{num['k1'] == n_layers * (stats.forwards + stats.frozen)}")
    del fp32, spec
    # ---- TP=2 bf16 over (b)'s request, and its decode-step logits
    shard_params(model, tp)
    res["tp2_bf16"] = serve_modes(model, tp, "TP=2", P_TP_COLUMNS, payload["want_tp"])
    res["tp2_steps"] = tie_steps_logits(model, dev, torch.bfloat16).float().cpu()
    del model
    torch.cuda.empty_cache()
    # ---- K2 under DP: int8 weights, each rank one row over 256 columns
    q8 = ParlerTTS(cfg, device=dev, dtype=torch.bfloat16, weight_quant=True)
    init_weights(q8, torch.Generator(device=dev).manual_seed(0))
    g8 = dataclasses.replace(gen, max_length=P_INT8_COLUMNS, min_new_tokens=P_INT8_COLUMNS)
    out, num = served(make_generate(q8, g8, torch.bfloat16, mesh=dp), request, P_INT8_COLUMNS)
    steps = P_INT8_COLUMNS - 2
    num["k2_want"] = 8 * n_layers * (steps + 1) + 2 * n_layers
    res["dp2_int8"] = (out.delayed_ids.cpu(), num)
    say(f"DP=2 int8 B=2 over {P_INT8_COLUMNS} columns: K2 {num['k2']} launches on this rank "
        f"at M=1 (want {num['k2_want']}), K1 {num['k1']} (want {num['k1_want']})")
    # ---- K2 under TP: each rank its columns of q/k/v/fc1 and rows of out_proj/fc2
    shard_params(q8, tp)
    ids, num, partings = serve_modes(q8, tp, "TP=2 int8", P_TP_COLUMNS, payload["want_tp_int8"])
    num["k2_want"] = 8 * n_layers * (P_TP_COLUMNS - 1) + 2 * n_layers
    res["tp2_int8_bf16"] = (ids, num, partings)
    say(f"TP=2 int8 B=2: K2 {num['k2']} launches on this rank at its slices (want "
        f"{num['k2_want']} = 192 a decode step + 48), K1 {num['k1']} (want {num['k1_want']})")
    res["tp2_int8_steps"] = tie_steps_logits(q8, dev, torch.bfloat16).float().cpu()
    del q8
    torch.cuda.empty_cache()

    # ---- one train step per mode of P_TRAIN_MODES at dropout 0.1 over phase (i)'s batch
    batch = train_batch(dev)
    res["train"] = {}
    k4_shapes = set()  # (Tq, Tk, q_offset) of the self-attention's K4 calls
    k4 = decoder.flash_attention

    def k4_recorded(q, k, v, mask, causal=True, q_offset=0):
        k4_shapes.add((q.shape[1], k.shape[1], q_offset))
        return k4(q, k, v, mask, causal=causal, q_offset=q_offset)

    decoder.flash_attention = k4_recorded
    for mode, shape, fsdp, dtype, fp32_sums in P_TRAIN_MODES:
        mesh = make_mesh(*shape, device=dev)
        tmodel, tx, state = p_train_model(dev, dtype, p_train_config())
        positions = sample_positions(tmodel)
        shard_train_state(state, mesh, fsdp=fsdp)
        rows = slice(mesh.data.rank * BATCH // mesh.data.size,
                     (mesh.data.rank + 1) * BATCH // mesh.data.size)
        cols = local_seq_slice(T_FRAMES_TRAIN, mesh)
        local = Batch(*(x[rows] for x in batch[:-1]), batch.labels[rows, cols])
        for key in flash_attention.launches:
            flash_attention.launches[key] = flash_attention.launches_wgmma[key] = 0
        k4_shapes.clear()
        step = make_train_step(tmodel, tx, mesh=mesh)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        with contextlib.ExitStack() as stack:
            if fp32_sums:
                stack.enter_context(fp32_partial_sums(tmodel))
            memory = stack.enter_context(StepMemory(tmodel, tx))
            start.record()
            state, metrics = step(state, local, 0)
            end.record()
        ms = start.elapsed_time(end)
        specs = tmodel.shard_specs
        params = sampled_entries(((n, gather_full(p.detach(), specs[n], mesh))
                                  for n, p in tmodel.named_parameters()), positions)
        res["train"][mode] = dict(loss=float(metrics["loss"]),
                                  grad_norm=float(metrics["grad_norm"]),
                                  num_items=float(metrics["num_items"]), ms=ms,
                                  memory=memory.numbers(),
                                  k4=dict(flash_attention.launches),
                                  k4_wgmma=dict(flash_attention.launches_wgmma),
                                  k4_shapes=sorted(k4_shapes),
                                  params=params if rank == 0 else None)
        say(f"{mode} train step: loss {float(metrics['loss']):.6f}, grad_norm "
            f"{float(metrics['grad_norm']):.6f}, {ms:.1f} ms (the memory recorder on), K4 "
            f"{dict(flash_attention.launches)} on this rank at (Tq, Tk, q_offset) "
            f"{sorted(k4_shapes)}; memory on this rank: "
            + StepMemory.line(res["train"][mode]["memory"]))
        del tmodel, tx, state, params, step, memory
        torch.cuda.empty_cache()
    decoder.flash_attention = k4

    # ---- the CLI at world 2 (mesh_data=2) over phase (n)'s features, fp32: 3
    # steps and a checkpoint at step 3
    margs, dargs, targs = payload["cli_args"]
    from parler_tts_tpu_torch.runtime.pipeline import ParlerTTSPipeline

    cli_model = ParlerTTSPipeline.from_random(payload["cli_cfg"], seed=0, device=dev).model
    losses = []
    log = rt.log_metric

    def record(tracker, metrics, *a, prefix="train", **k):
        if prefix == "train":
            losses.append(float(metrics["loss"]))
        return log(tracker, metrics, *a, prefix=prefix, **k)

    rt.log_metric = record
    t0 = time.perf_counter()
    _, step = rt.run_training(margs, dargs, targs, cli_model, payload["cli_features"], device=dev)
    res["cli"] = dict(losses=losses, step=step, seconds=time.perf_counter() - t0)
    say(f"CLI at world 2 (mesh_data=2): {step} steps, losses {losses}, "
        f"{time.perf_counter() - t0:.1f} s with the checkpoint")
    with open(os.path.join(tmp, f"result-{rank}.pkl"), "wb") as f:
        pickle.dump(res, f)
    torch.distributed.destroy_process_group()


def cli_losses(rt, margs, dargs, targs, model, features, dev):
    """`rt.run_training` over `features` with its train losses recorded:
    (losses, final state, final step)."""
    losses = []
    log = rt.log_metric

    def record(tracker, metrics, *a, prefix="train", **k):
        if prefix == "train":
            losses.append(float(metrics["loss"]))
        return log(tracker, metrics, *a, prefix=prefix, **k)

    rt.log_metric = record
    try:
        state, step = rt.run_training(margs, dargs, targs, model, features, device=dev)
    finally:
        rt.log_metric = log
    return losses, state, step


def phase_p(dev, card, source, out_b, loss_gap, cli):
    """(p): parallelism on the card. Returns the `parallel` entries of K1,
    K2 and K4 for the kernels line."""
    import copy
    import dataclasses
    import os
    import shutil
    import tempfile

    from parler_tts_tpu_torch.runtime.generate import make_generate
    from parler_tts_tpu_torch.runtime.pipeline import ParlerTTSPipeline
    from parler_tts_tpu_torch.training import run_training as rt
    from parler_tts_tpu_torch.training.checkpoints import get_last_checkpoint

    fails = []

    def need(ok, what):
        if not ok:
            fails.append(what)
        return ok

    t0 = time.perf_counter()
    p0 = phase_p0(dev, card)
    print(f"  (p0) kernels at the sharded shapes: {time.perf_counter() - t0:.2f} s")

    t0 = time.perf_counter()
    refs = phase_p2_refs(dev, card, source)
    cfg_n, (margs, dargs, targs), feats = cli["cfg"], cli["args"], cli["features"]
    root = tempfile.mkdtemp()
    try:
        lr = targs.learning_rate
        # fp32, so that world 2's summation order is all that parts it from world 1
        w2 = dataclasses.replace(targs, output_dir=os.path.join(root, "w2"), max_steps=3,
                                 save_steps=3, save_total_limit=None, eval_steps=100,
                                 mesh_data=2, dtype="float32")
        w1 = dataclasses.replace(w2, mesh_data=None, max_steps=4, save_steps=100,
                                 per_device_train_batch_size=2 * w2.per_device_train_batch_size)
        base = ParlerTTSPipeline.from_random(cfg_n, seed=0, device=dev).model
        payload = dict(device=str(dev), gen=source.generation_config, cli_cfg=cfg_n,
                       cli_args=(margs, dargs, w2), cli_features=feats["train"],
                       want_tp=refs["ar16"][P_TP_COLUMNS][1].cpu(),
                       want_tp_int8=refs["int8"][1].cpu(),
                       want_dp=refs["ar16"][P_DP_COLUMNS][1].cpu())

        def meanwhile():
            """This process's work that needs no rank's result: (p1), the
            train references and world 1's uninterrupted CLI run."""
            t = time.perf_counter()
            phase_p1(dev, card, source, out_b)
            print(f"  (p1) NCCL at world size 1, beside the ranks: "
                  f"{time.perf_counter() - t:.2f} s")
            train = p2_train_refs(dev, card)
            losses, state_a, _ = cli_losses(rt, margs, dargs, dataclasses.replace(
                w1, output_dir=os.path.join(root, "w1")), copy.deepcopy(base), feats["train"],
                dev)
            params_a = sampled_entries(state_a.model.named_parameters(),
                                       sample_positions(state_a.model))
            del state_a
            shutil.rmtree(os.path.join(root, "w1"))
            torch.cuda.empty_cache()
            return train, losses, params_a

        (r0, r1), (t_ref, run_a, params_a) = launch_ranks(payload, card, meanwhile)
        print(f"  (p2) two ranks on the shared card: {time.perf_counter() - t0:.2f} s")
        modes = [m[0] for m in P_TRAIN_MODES]
        missing = [f"rank {i}: {k}" for i, r in enumerate((r0, r1))
                   for k in ["cli"] + [f"train {m}" for m in modes]
                   if (k not in r if k == "cli" else k[6:] not in r["train"])]
        if missing:
            raise AssertionError(f"(p2) results missing: {missing}")

        exact = [r["collectives_exact"] for r in (r0, r1)]
        print(f"  gloo on CUDA tensors: all-reduce and all-gather of 2^20 seeded values a rank "
              f"bit-identical to their sum and concatenation: {exact}")
        need(all(all(e.values()) for e in exact), f"gloo collectives not exact: {exact}")

        # generation: every rank returns the global ids
        for key in ("dp2_bf16", "tp2_bf16", "tp2_fp32", "tp2_spec_fp32", "dp2_int8",
                    "tp2_int8_bf16", "tp2_fused_bf16"):
            need(torch.equal(r0[key][0], r1[key][0]), f"{key}: the ranks' ids differ")
            for r in (r0, r1):
                num = r[key][1]
                need(num["k1"] == (n := num["k1_want"]) or key == "tp2_spec_fp32",
                     f"{key}: K1 {num['k1']} launches on a rank, want {n}")
        # bf16: held to the one-process run at every column. A partition moves
        # the one-process top-two gap by no more than bf16 moves fp32's over the
        # same teacher-forced steps, and each parting lies within the
        # partition's own near-tie
        bf16_tie = refs["bf16_tie"]
        one_steps = {"want_tp": refs["tie_steps"], "want_tp_int8": refs["int8_steps"]}
        moves = {key: top_two_moves(one_steps[want], r0[steps])
                 for key, want, steps in P_HELD_RUNS if steps is not None}
        tie = {key: m.max().item() for key, m in moves.items()}
        tie["dp2_bf16"] = refs["dp_tie"]
        print(f"  near-ties over {P_TIE_STEPS} teacher-forced bf16 decode steps after each of "
              f"the prefixes {P_TIE_PREFIXES} ({moves['tp2_bf16'].numel()} rows, codebooks and "
              f"columns), the largest move of the one-process top-two gap: " + ", ".join(
                  f"{key} {tie[key]:.3e} ({per_prefix(m)} by prefix; median "
                  f"{m.median().item():.3e})" for key, m in moves.items())
              + f", a row alone (DP=2) {refs['dp_tie']:.3e}, fp32 against bf16 {bf16_tie:.3e} "
              f"({per_prefix(refs['bf16_moves'])} by prefix)")
        request = [torch.as_tensor(x, device=dev) for x in request_ids(0)]
        ties = {}
        for key, want_key, _ in P_HELD_RUNS:
            cols = P_DP_COLUMNS if key == "dp2_bf16" else P_TP_COLUMNS
            g, want = refs["int8"] if want_key == "want_tp_int8" else refs["ar16"][cols]
            one = refs["q8"] if want_key == "want_tp_int8" else source.model
            need(tie[key] <= bf16_tie, f"{key}: the partition moves the top-two gap by "
                                       f"{tie[key]:.3e}, more than bf16 does ({bf16_tie:.3e})")
            need(torch.equal(r0[key][0].to(dev), want),
                 f"{key}: the forced run did not follow the one-process run")
            partings = sorted(set(r0[key][2] + r1[key][2]))
            print(f"    {key} vs one process: {len(partings)} of the "
                  f"{(cols - 2) * BATCH * 9} (column, row, codebook) entries of {cols - 2} "
                  f"decoded columns part, each held to the partition's near-tie {tie[key]:.3e}")
            near_ties(f"{key} vs one process", partings,
                      lambda g=g, one=one: make_generate(one, g, torch.bfloat16)(*request),
                      want, need, tie=tie[key], top_two=False)
            ties[key] = dict(tie=tie[key], bf16_tie=bf16_tie, partings=len(partings),
                             columns=cols, prefixes=P_TIE_PREFIXES,
                             by_prefix=per_prefix(moves[key]) if key in moves else None,
                             bf16_by_prefix=per_prefix(refs["bf16_moves"]))
        for key in ("dp2_int8", "tp2_int8_bf16"):
            for r in (r0, r1):
                num = r[key][1]
                need(num["k2"] == num["k2_want"], f"{key}: K2 {num['k2']}, want {num['k2_want']}")
        del refs["q8"]
        fp32_model = fp32_copy(source.model, dev)
        gen32 = dataclasses.replace(source.generation_config, max_length=P_FP32_COLUMNS,
                                    min_new_tokens=P_FP32_COLUMNS)
        pipe32 = ParlerTTSPipeline(fp32_model, source.dac, gen32, cache_dtype=torch.float32,
                                   device=dev)
        for key, rows in (("tp2_fp32", [0, 1]), ("tp2_spec_fp32", [0])):
            got = r0[key][0].to(dev)
            partings = first_partings(f"{key} vs the fp32 AR run", got, refs["ar32"], rows)
            near_ties(f"{key} vs the fp32 AR run", partings,
                      lambda: pipe32.generate_codes(*request_ids(0), seed=0), refs["ar32"],
                      need)
        forwards, columns, frozen = r0["tp2_spec_fp32"][2]
        need(0 < forwards < columns, f"speculative TP=2: {forwards} forwards, {columns} columns")
        del fp32_model, pipe32
        torch.cuda.empty_cache()

        # train steps against the single-process step of their dtype, within this
        # run's gaps between its bf16 and fp32 steps
        loss_tol = abs(t_ref["fp32"]["loss"] - t_ref["bf16"]["loss"])
        norm_tol = abs(t_ref["fp32"]["grad_norm"] - t_ref["bf16"]["grad_norm"])
        flip_limit = max(t_ref["flips"], 1e-4)
        n_train = p_train_config().decoder.num_hidden_layers
        k4_want = {"fwd": 2 * n_train, "dq": n_train, "dkv": n_train}
        # bf16 TP=2 rounds each rank's partial sums to bf16 before the all-reduce;
        # the step that sums them in fp32 differs from it in that rounding alone,
        # so the two steps' distance reads what that rounding moves
        tp_b, tp_f = r0["train"]["TP=2 bf16"], r0["train"]["TP=2 bf16, fp32 partial sums"]
        tp_rounding = dict(loss=abs(tp_b["loss"] - tp_f["loss"]),
                           grad_norm=abs(tp_b["grad_norm"] - tp_f["grad_norm"]))
        fp32p = t_ref["bf16, fp32 products"]
        cause_flips, _ = update_flips(tp_f["params"], fp32p["params"], P_TRAIN_LR)
        print(f"  TP=2 bf16 with fp32 partial sums against one process with fp32 products at the "
              f"same sites: loss {tp_f['loss']:.6f} vs {fp32p['loss']:.6f} (off by "
              f"{abs(tp_f['loss'] - fp32p['loss']):.3e}), grad_norm {tp_f['grad_norm']:.6f} vs "
              f"{fp32p['grad_norm']:.6f}, updates part on {cause_flips:.3%}; one process with "
              f"and without those fp32 products: loss off by "
              f"{abs(fp32p['loss'] - t_ref['bf16']['loss']):.3e}, grad_norm by "
              f"{abs(fp32p['grad_norm'] - t_ref['bf16']['grad_norm']):.3e} ({card})")
        train_out = {}
        t_train = T_PROMPT_TRAIN + T_FRAMES_TRAIN
        for mode, shape, _, dtype, _ in P_TRAIN_MODES:
            m0, m1 = r0["train"][mode], r1["train"][mode]
            bf16 = dtype == torch.bfloat16
            # the self-attention's K4 calls a rank: its rows against the gathered keys
            # under SP (rank 0 holds the prompt), the whole sequence otherwise
            rank_rows = seq_rank_rows() if shape[2] > 1 else [(t_train, 0)] * 2
            shapes_want = [[(tq, t_train, off)] for tq, off in rank_rows]
            one = t_ref["bf16" if bf16 else "fp32"]
            # bf16 TP sums its row-parallel partial products rounded to bf16 over the
            # ranks: it gets the allowance TP's fp32-partial-sum step measures. DP, FSDP
            # and SP keep the plain bf16-fp32 gap
            tp_bf16 = bf16 and shape[1] > 1
            loss_limit = loss_tol + (tp_rounding["loss"] if tp_bf16 else 0.0)
            norm_limit = norm_tol + (tp_rounding["grad_norm"] if tp_bf16 else 0.0)
            flips, worst = update_flips(m0["params"], one["params"], P_TRAIN_LR)
            ok = [abs(m["loss"] - one["loss"]) <= loss_limit for m in (m0, m1)]
            ok += [abs(m["grad_norm"] - one["grad_norm"]) <= norm_limit for m in (m0, m1)]
            ok += [m["num_items"] == one["num_items"] for m in (m0, m1)]
            ok += [flips <= flip_limit, worst <= 2 * P_TRAIN_LR * 1.01]
            ok += [m["k4"] == k4_want and (m["k4_wgmma"] == k4_want if bf16
                                           else not any(m["k4_wgmma"].values())) for m in (m0, m1)]
            ok += [[tuple(x) for x in m["k4_shapes"]] == w
                   for m, w in zip((m0, m1), shapes_want)]
            need(all(ok), f"{mode} train step: checks {ok}")
            limit_text = f"the bf16-fp32 gap {loss_tol:.3e}" + (
                f" + the partial sums' rounding {tp_rounding['loss']:.3e}" if tp_bf16 else "")
            print(f"  {mode} train step: loss {m0['loss']:.6f} / {m1['loss']:.6f} (ranks) vs "
                  f"{one['loss']:.6f} one process, off by {abs(m0['loss'] - one['loss']):.3e} "
                  f"within {limit_text}; grad_norm {m0['grad_norm']:.6f} vs "
                  f"{one['grad_norm']:.6f} within {norm_limit:.3e}; num_items "
                  f"{m0['num_items']:.0f}; updates part from the single step's on {flips:.3%} of "
                  f"sampled entries (limit {flip_limit:.3%}, the bf16-fp32 steps' share), largest "
                  f"{worst:.2e}; {m0['ms']:.1f} ms a step; K4 {m0['k4']} a rank on the "
                  f"{'wgmma' if bf16 else 'SIMT'} route at (Tq, Tk, q_offset) "
                  f"{m0['k4_shapes']} / {m1['k4_shapes']} (ranks); all {all(ok)} (two "
                  f"processes on one card, gloo through the host) ({card})")
            for i, m in enumerate((m0, m1)):
                print(f"    {mode} rank {i} memory: " + StepMemory.line(m["memory"]))
            train_out[mode] = dict(ms=m0["ms"], peak_gib=[m0["memory"]["peak_gib"],
                                                          m1["memory"]["peak_gib"]],
                                   memory=m0["memory"], k4=m0["k4"], k4_wgmma=m0["k4_wgmma"],
                                   k4_shapes=[m0["k4_shapes"], m1["k4_shapes"]],
                                   loss_off=abs(m0["loss"] - one["loss"]), loss_limit=loss_limit,
                                   flips=flips)

        # the CLI: world 2's checkpoint resumed at world 1 against world 1 uninterrupted
        run_r, state_r, step_r = cli_losses(rt, margs, dargs, dataclasses.replace(
            w1, output_dir=os.path.join(root, "resumed"),
            resume_from_checkpoint=get_last_checkpoint(w2.output_dir)), base, feats["train"],
            dev)
        params_r = sampled_entries(state_r.model.named_parameters(),
                                   sample_positions(state_r.model))
        del state_r, base
        torch.cuda.empty_cache()
        flips, worst = update_flips(params_r, params_a, lr)
        w2_losses = r0["cli"]["losses"]
        gaps = [abs(a - b) for a, b in zip(w2_losses + run_r, run_a)]
        ok = [len(w2_losses) == 3 and len(run_r) == 1 and step_r == 4,
              max(gaps) <= loss_gap, flips <= max(t_ref["flips"], 1e-4),
              worst <= 2 * lr * 1.01]
        need(all(ok), f"CLI world 2 -> world 1: checks {ok}")
        print(f"  CLI mesh_data=2: losses {w2_losses} at world 2, then {run_r} resumed at "
              f"world 1 from its step-3 checkpoint, against {run_a} uninterrupted at world "
              f"1: largest gap {max(gaps):.3e} within phase (i)'s bf16 gap {loss_gap:.3e}; "
              f"parameters after step 4 part on {flips:.3%} of sampled entries, largest "
              f"{worst:.2e} ({r0['cli']['seconds']:.1f} s at world 2) ({card})")
        cli_out = dict(world2_losses=w2_losses, resumed_losses=run_r, world1_losses=run_a,
                       seconds=r0["cli"]["seconds"])
    finally:
        shutil.rmtree(root, ignore_errors=True)
    if fails:
        raise AssertionError(f"phase p: {fails}")
    rate = {k: r0[k][1]["steps_per_s"] for k in ("dp2_bf16", "tp2_bf16", "tp2_int8_bf16",
                                                 "tp2_fused_bf16")}
    coll = {k: (r0[k][1]["collectives_per_step"], r0[k][1]["host_ms_per_collective"])
            for k in rate}
    print(f"  shared card, two processes, gloo through the host (not a scaling figure): "
          f"decode steps/s at B=2 bf16 " + ", ".join(f"{k} {v:.1f}" for k, v in rate.items())
          + f"; TP=2 {coll['tp2_bf16'][0]:.1f} collectives a decode step at "
          f"{coll['tp2_bf16'][1]:.3f} host ms each; train ms a step "
          + ", ".join(f"{m} {v['ms']:.1f}" for m, v in train_out.items()) + f" ({card})")
    return dict(
        k1=dict(p0["k1"], launches_per_rank={k: r0[k][1]["k1"] for k in (
            "dp2_bf16", "tp2_bf16", "tp2_fp32", "tp2_spec_fp32", "dp2_int8", "tp2_int8_bf16",
            "tp2_fused_bf16")},
            steps_per_s=rate, collectives=coll, near_ties=ties),
        k2=dict(p0["k2"], dp2_int8_launches_per_rank=r0["dp2_int8"][1]["k2"],
                tp2_int8_launches_per_rank=r0["tp2_int8_bf16"][1]["k2"]),
        k4=dict(p0["k4"], train=train_out, cli=cli_out, tp_bf16_rounding=tp_rounding,
                tp_fp32_partial_sums_vs_one_process=abs(tp_f["loss"] - fp32p["loss"])),
    )


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    stay_offline()
    from parler_tts_tpu_torch.ops._cuda import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = card_line()
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNEL_SOURCES)) as pool:  # one nvcc per source, all at once
        logs = list(pool.map(build, KERNEL_SOURCES))
    print(f"[build] nvcc of {', '.join(KERNEL_SOURCES)}: {time.perf_counter() - t0:.2f} s "
          f"({card})")
    for name, log in zip(KERNEL_SOURCES, logs):
        for line in log.splitlines():  # every line of the tensor-core kernels, and warnings
            if (name == "flash_attention_wgmma" and "Compile time" not in line
                    or "Used" in line or "spill" in line or "arning" in line
                    or name.startswith("flash_decode") and "Function properties" in line):
                print(f"  ptxas {name}:", line.strip())

    t0 = time.perf_counter()
    max_err, timing = phase_a(dev, card)
    print(f"[phase a] K1 vs plain: {time.perf_counter() - t0:.2f} s ({card})")
    t0 = time.perf_counter()
    launches, source, out_b = phase_b(dev, card)
    print(f"[phase b] mini-v1 pipeline: {time.perf_counter() - t0:.2f} s ({card})")
    t0 = time.perf_counter()
    phase_c(dev, card)
    print(f"[phase c] decode step K1 vs dense: {time.perf_counter() - t0:.2f} s ({card})")
    t0 = time.perf_counter()
    k2_err, k2_timing = phase_d(dev, card)
    print(f"[phase d] K2 vs plain: {time.perf_counter() - t0:.2f} s ({card})")
    t0 = time.perf_counter()
    k2_launches, stream_e = phase_e(dev, card)
    print(f"[phase e] mini-v1 int8 pipeline: {time.perf_counter() - t0:.2f} s ({card})")
    t0 = time.perf_counter()
    k3_err, k3_norm_rel, k3_timing = phase_f(dev, card)
    print(f"[phase f] K3 vs plain: {time.perf_counter() - t0:.2f} s ({card})")
    t0 = time.perf_counter()
    k3_launches, stream_g = phase_g(dev, card)
    print(f"[phase g] mini-v1 fused B=1 pipeline: {time.perf_counter() - t0:.2f} s ({card})")
    t0 = time.perf_counter()
    stream_k = phase_k(dev, card, source)
    print(f"[phase k] voice-steered mini-v1 streams: {time.perf_counter() - t0:.2f} s ({card})")
    t0 = time.perf_counter()
    phase_j(dev, card, source, out_b, stream_e, stream_g)
    del stream_g
    torch.cuda.empty_cache()
    print(f"[phase j] a saved mini-v1 served from disk: {time.perf_counter() - t0:.2f} s "
          f"({card})")

    t0 = time.perf_counter()
    k4_timing = phase_h(dev, card)
    print(f"[phase h] K4 vs plain: {time.perf_counter() - t0:.2f} s ({card})")
    t0 = time.perf_counter()
    k4_launches, loss_gap = phase_i(dev, card)
    print(f"[phase i] mini-v1 trainer: {time.perf_counter() - t0:.2f} s ({card})")
    t0 = time.perf_counter()
    cli = phase_n(dev, card, loss_gap)
    cli_run = {k: cli.pop(k) for k in ("cfg", "args", "features")}  # for phase (p)
    torch.cuda.empty_cache()
    print(f"[phase n] the training CLI at mini-v1 width: {time.perf_counter() - t0:.2f} s "
          f"({card})")
    t0 = time.perf_counter()
    encodec = phase_o(dev, card)
    torch.cuda.empty_cache()
    print(f"[phase o] Encodec on the card: {time.perf_counter() - t0:.2f} s ({card})")
    t0 = time.perf_counter()
    scripts = phase_q(dev, card)
    print(f"[phase q] helper scripts at mini-v1 width: {time.perf_counter() - t0:.2f} s "
          f"({card})")
    t0 = time.perf_counter()
    large, large_eager, large_out = phase_l(dev, card)
    print(f"[phase l] large-v1 kernels and serving: {time.perf_counter() - t0:.2f} s ({card})")
    t0 = time.perf_counter()
    spec = phase_m(dev, card, source, out_b.delayed_ids, stream_e, large_eager, large_out)
    window = spec.pop("k1")
    del stream_e, large_eager, large_out
    torch.cuda.empty_cache()
    print(f"[phase m] speculative and decoder-only serving: {time.perf_counter() - t0:.2f} s "
          f"({card})")
    t0 = time.perf_counter()
    parallel = phase_p(dev, card, source, out_b, loss_gap, cli_run)
    del source, out_b, cli_run
    torch.cuda.empty_cache()
    print(f"[phase p] parallelism: sharded kernels, NCCL at world 1, two ranks on the card: "
          f"{time.perf_counter() - t0:.2f} s ({card})")
    print("  time to first chunk (phase k): " + "; ".join(
        f"{label} {v['first_chunk_s']:.3f} s, {v['steps_per_s']:.1f} decode steps/s, "
        f"{v['chunks']} chunks" for label, v in stream_k.items()) + f" ({card})")

    kernels = [
        dict(name="flash_decode_attention", route="cuda",
             source="parler_tts_tpu_torch/csrc/flash_decode.cu",
             replaces="parler_tts_tpu/ops/pallas/flash_decode.py:192",
             launches=launches, max_abs_err=max_err, **timing, large_v1=large["k1"],
             training_cli_eval_generation=cli["k1_eval_generation"], encodec=encodec,
             parallel={k: v for k, v in parallel["k1"].items() if k != "mini_v1_tp2_window"},
             helper_scripts=scripts),
        # K1's W-column form (G x W > 8 rows a kv head, bf16): its times at
        # mini-v1 W=24 B=2, its launches in the bf16 W=24 B=1 serving run
        dict(name="flash_decode_window", route="cuda",
             source="parler_tts_tpu_torch/csrc/flash_decode_window.cu",
             replaces="parler_tts_tpu/ops/pallas/flash_decode.py:192",
             launches=spec["spec W=24 B=1"]["k1_window_launches"],
             max_abs_err=max(v["max_abs_err"] for v in window.values()),
             **{k: window["mini-v1 W=24 B=2"][k]
                for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
             cases=window, speculative=spec, parallel=parallel["k1"]["mini_v1_tp2_window"],
             helper_scripts_demo=scripts["demo_k1_window"]),
        dict(name="quant_matmul", route="cuda",
             source="parler_tts_tpu_torch/csrc/quant_matmul.cu",
             replaces="parler_tts_tpu/ops/pallas/quant_matmul.py:39",
             launches=k2_launches, max_abs_err=k2_err, **k2_timing, large_v1=large["k2"],
             parallel=parallel["k2"]),
        dict(name="fused_decode_layers", route="cuda",
             source="parler_tts_tpu_torch/csrc/fused_decode_step.cu",
             replaces="parler_tts_tpu/ops/pallas/fused_decode_step.py:352",
             launches=k3_launches, max_abs_err=k3_err, max_norm_rel_err=k3_norm_rel,
             **k3_timing, large_v1=large["k3"]),
    ] + [
        dict(name=f"flash_attention{tag}_{name}", route="cuda",
             source=f"parler_tts_tpu_torch/csrc/flash_attention{tag}.cu",
             replaces=f"parler_tts_tpu/ops/pallas/flash_attention.py:{line}",
             launches=k4_launches[route][name], **k4_timing[route][name],
             **({"training_cli_per_step": cli["k4_per_step"][name]} if route == "wgmma" else {}))
        for route, tag in (("wgmma", "_wgmma"), ("simt", ""))
        for name, line in (("fwd", 67), ("dq", 144), ("dkv", 180))
    ]
    kernels[4]["training_cli"] = {k: v for k, v in cli.items() if k != "k4_per_step"}
    for entry in kernels[4:]:
        entry["parallel"] = parallel["k4"]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--phase-p-rank"]:  # a rank of phase (p2), started by phase_p
        phase_p_rank(sys.argv[2])
        sys.exit(0)
    sys.exit(main())
