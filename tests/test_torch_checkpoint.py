"""Checkpoints between the JAX package and the port, on the CPU, fp32, with
the tiny configs of `tests/test_torch_pipeline.py`.

  * `ParlerTTSConfig` JSON written by either package loads in the other to
    an equal config; `load_hf_config` gives the JAX package's config
    (`dataclasses.asdict`-equal) on the same `config.json`.
  * The safetensors reader, which does not use the safetensors package,
    returns tensors bit-equal to `safetensors.numpy.load_file` and
    `safetensors.torch.load_file` over all ten dtypes and a two-shard
    directory, and rejects truncated, overlapping or unknown-dtype headers
    and a name in two shards; `chip_smoke.py`'s writer is read back by
    safetensors itself.
  * An HF directory the JAX package writes (`export_composite_to_hf_tensors`,
    `export_dac_params` at v_scale 1.7, `safetensors.numpy.save_file`, two
    shards), in both weight-norm forms, loads into the port: every model
    parameter equal to the JAX tree carried by `load_jax_params`, folded DAC
    kernels within 1e-6 of their scale (max |diff| / max |w| per tensor;
    both fold in float64 and round to fp32), the greedy delayed ids
    identical to the JAX package's and the waveform within
    `test_torch_pipeline.py`'s 1e-5 / 1e-4.
  * The native layout both ways: JAX `save_pretrained` -> port
    `from_pretrained` and port `save_pretrained` -> JAX `from_pretrained`,
    equal parameters and identical greedy ids, `generation_config.json`
    honoured.
"""

import dataclasses
import json
import os
import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import safetensors.numpy
import safetensors.torch
import torch

import chip_smoke
from parler_tts_tpu import config as jc
from parler_tts_tpu.codec.convert import export_dac_params as jax_export_dac
from parler_tts_tpu.codec.encodec_model import EncodecCodecConfig as JEncodecConfig
from parler_tts_tpu.runtime.generate import make_generate
from parler_tts_tpu.runtime.pipeline import ParlerTTSPipeline as JPipeline
from parler_tts_tpu.runtime.pipeline import load_hf_config as jax_load_hf_config
from parler_tts_tpu.utils.hf_export import export_composite_to_hf_tensors as jax_export
from parler_tts_tpu.utils.quantize import quantize_decoder_params as jax_quantize
from parler_tts_tpu_torch import config as tc
from parler_tts_tpu_torch.codec.convert import export_dac_params
from parler_tts_tpu_torch.codec.dac_model import DACModel
from parler_tts_tpu_torch.codec.encodec_model import EncodecCodecConfig
from parler_tts_tpu_torch.convert import load_jax_dac_params, load_jax_params, tensor_tree
from parler_tts_tpu_torch.models.parler import ParlerTTS
from parler_tts_tpu_torch.runtime.checkpoint import (
    load_hf_config,
    load_safetensors_dir,
    read_safetensors,
)
from parler_tts_tpu_torch.runtime.pipeline import ParlerTTSPipeline
from parler_tts_tpu_torch.utils.hf_export import export_composite_to_hf_tensors
from test_torch_models import host, port_config
from test_torch_pipeline import CFG, GEN, PAD, ids, jax_params

FOLD_REL = 1e-6
# weight-norm-folded leaves of the port's codec (conv weights, in/out-projections)
FOLDED = ("weight", "in_proj_kernel", "out_proj_kernel")


def stub_tokenizer(texts):
    return {"input_ids": [[b % 100 for b in t.encode()] for t in texts]}


def port_gen(gen):
    return tc.GenerationConfig(**dataclasses.asdict(gen))


def reference_port(params, dac_params, cfg=CFG):
    """The JAX trees carried into port modules by `load_jax_params`."""
    model, dac = ParlerTTS(port_config(cfg)), DACModel(port_config(cfg.audio_encoder))
    load_jax_params(model, params)
    load_jax_dac_params(dac, dac_params)
    return model, dac


def assert_same_params(model, dac, ref_model, ref_dac):
    """Model exact; the codec exact but for folded kernels, within FOLD_REL
    of each tensor's scale. Returns the worst folded deviation."""
    got, want = dict(model.named_parameters()), dict(ref_model.named_parameters())
    assert got.keys() == want.keys()
    for name, w in want.items():
        assert got[name].dtype == w.dtype and torch.equal(got[name], w), name
    worst = 0.0
    got, want = dict(dac.named_parameters()), dict(ref_dac.named_parameters())
    assert got.keys() == want.keys()
    for name, w in want.items():
        if name.split(".")[-1] in FOLDED:
            rel = float((got[name] - w).abs().max() / w.abs().max())
            assert rel <= FOLD_REL, (name, rel)
            worst = max(worst, rel)
        else:
            assert torch.equal(got[name], w), name
    return worst


@pytest.fixture(scope="module")
def pair():
    """JAX params (the flash-decode model), the codec's params and the JAX
    greedy ids of `ids(seed=7)` with an fp32 cache."""
    jm, params, jdac, dac_params = jax_params(CFG, seed=2)
    desc, dm, prompt, pm = ids(seed=7)
    want = make_generate(jm, GEN, cache_dtype=jnp.float32)(
        params, desc, dm, prompt, pm, jax.random.key(0))
    return jm, params, jdac, dac_params, want


# ------------------------------------------------------------ config JSON
def jax_configs():
    dec = dataclasses.replace(CFG.decoder, num_key_value_heads=2, sliding_window=6,
                              codebook_weights=(1.0, 2.0, 0.5, 1.5), rope_embeddings=True)
    return {
        "pipeline": CFG,
        "gqa_window_weights": dataclasses.replace(CFG, decoder=dec, prompt_cross_attention=True),
        "mini_v1": jc.ParlerTTSConfig.from_json(tc.mini_v1_config().to_json()),
    }


@pytest.mark.parametrize("name", ["pipeline", "gqa_window_weights", "mini_v1"])
def test_config_json_round_trips_between_packages(name):
    jcfg = jax_configs()[name]
    pcfg = port_config(jcfg)
    assert tc.ParlerTTSConfig.from_json(jcfg.to_json()) == pcfg
    assert jc.ParlerTTSConfig.from_json(pcfg.to_json()) == jcfg
    assert tc.ParlerTTSConfig.from_json(pcfg.to_json()) == pcfg
    assert isinstance(tc.ParlerTTSConfig.from_json(pcfg.to_json()).audio_encoder.decoder_rates,
                      tuple)


def test_config_json_encodec_names_its_roadmap_item():
    """An Encodec composite's JSON (ROADMAP item 17, ported) loads in the
    port to the JAX package's config, and back."""
    jcfg = dataclasses.replace(CFG, audio_encoder=JEncodecConfig(
        audio_channels=2, num_codebooks=4, upsampling_ratios=(4, 4), normalize=True))
    pcfg = tc.ParlerTTSConfig.from_json(jcfg.to_json())
    assert isinstance(pcfg.audio_encoder, EncodecCodecConfig)
    assert pcfg == port_config(jcfg)
    assert isinstance(pcfg.audio_encoder.upsampling_ratios, tuple)
    assert jc.ParlerTTSConfig.from_json(pcfg.to_json()) == jcfg


# ------------------------------------------------------------ load_hf_config
def hf_config(cfg=CFG, minimal=False, **audio):
    if minimal:
        te = {k: getattr(cfg.text_encoder, k)
              for k in ("vocab_size", "d_model", "d_kv", "d_ff", "num_layers", "num_heads")}
        de = {k: getattr(cfg.decoder, k) for k in (
            "vocab_size", "num_hidden_layers", "ffn_dim", "num_attention_heads", "hidden_size")}
        return {"text_encoder": te, "audio_encoder": dict(audio), "decoder": de}
    return {
        "text_encoder": dataclasses.asdict(cfg.text_encoder),
        "audio_encoder": dict(dataclasses.asdict(cfg.audio_encoder),
                              **(audio or {"model_type": "dac_on_the_hub"})),
        "decoder": dataclasses.asdict(cfg.decoder),
        "vocab_size": cfg.vocab_size,
        "prompt_cross_attention": cfg.prompt_cross_attention,
        "pad_token_id": cfg.pad_token_id,
        "decoder_start_token_id": cfg.decoder_start_token_id,
    }


def write_config(path, raw):
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(raw, f)


HF_CONFIGS = {
    "full": lambda: hf_config(),
    "minimal": lambda: hf_config(minimal=True),
    "gqa_window_weights": lambda: hf_config(jax_configs()["gqa_window_weights"]),
    "dac_model_type": lambda: hf_config(model_type="dac"),
}


@pytest.mark.parametrize("name", list(HF_CONFIGS))
def test_load_hf_config_matches_jax(tmp_path, name):
    write_config(tmp_path, HF_CONFIGS[name]())
    got = load_hf_config(str(tmp_path))
    want = jax_load_hf_config(str(tmp_path))
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    if name == "minimal":
        assert got.text_encoder.feed_forward_proj == "relu"


def test_load_hf_config_encodec_and_unknown_codecs(tmp_path):
    """An `audio_encoder` of model_type "encodec" loads as the JAX package
    loads it (ROADMAP item 17, ported); an unknown codec raises in both."""
    write_config(tmp_path / "encodec", hf_config(model_type="encodec"))
    want = jax_load_hf_config(str(tmp_path / "encodec"))
    got = load_hf_config(str(tmp_path / "encodec"))
    assert want.audio_encoder.codec_type == got.audio_encoder.codec_type == "encodec"
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    write_config(tmp_path / "other", hf_config(model_type="snac"))
    for load in (load_hf_config, jax_load_hf_config):
        with pytest.raises(ValueError, match="snac"):
            load(str(tmp_path / "other"))


# ------------------------------------------------------------ safetensors
DTYPES = ["F64", "F32", "F16", "BF16", "I64", "I32", "I16", "I8", "U8", "BOOL"]
TORCH_DTYPES = dict(zip(DTYPES, [torch.float64, torch.float32, torch.float16, torch.bfloat16,
                                 torch.int64, torch.int32, torch.int16, torch.int8,
                                 torch.uint8, torch.bool]))


def sample(dtype, shape, seed):
    g = torch.Generator().manual_seed(seed)
    if dtype.is_floating_point:
        return (torch.randn(shape, generator=g) * 3).to(dtype)
    if dtype == torch.bool:
        return torch.rand(shape, generator=g) > 0.5
    info = torch.iinfo(dtype)
    return torch.randint(info.min, info.max, shape, generator=g, dtype=torch.int64).to(dtype)


def tensors_of(code, seed=0):
    dtype = TORCH_DTYPES[code]
    shapes = {"matrix": (5, 7), "scalar": (), "empty": (0, 3), "cube": (2, 3, 4)}
    return {f"{code}.{name}": sample(dtype, shape, seed) for name, shape in shapes.items()}


def same_bits(a, b):
    def bits(x):
        return x.reshape(-1).clone().view(torch.uint8)

    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(bits(a), bits(b))


@pytest.mark.parametrize("code", DTYPES)
def test_reader_is_bit_equal_to_safetensors(tmp_path, code):
    tensors = tensors_of(code)
    path = str(tmp_path / "x.safetensors")
    safetensors.torch.save_file(tensors, path, metadata={"format": "pt"})
    got = read_safetensors(path)
    want = safetensors.torch.load_file(path)
    assert got.keys() == want.keys() == tensors.keys()
    for name in want:
        assert same_bits(got[name], want[name]), name
    if code != "BF16":  # numpy has no bf16
        for name, arr in safetensors.numpy.load_file(path).items():
            assert same_bits(got[name], torch.from_numpy(arr)), name


def test_reader_reads_a_two_shard_directory(tmp_path):
    shards = [{**tensors_of("BF16", 1), **tensors_of("F32", 2)},
              {**tensors_of("I8", 3), **tensors_of("BOOL", 4)}]
    for i, shard in enumerate(shards):
        safetensors.torch.save_file(shard, str(tmp_path / f"model-{i:05d}-of-00002.safetensors"))
    (tmp_path / "notes.txt").write_text("not a shard")
    got = load_safetensors_dir(str(tmp_path))
    assert got.keys() == shards[0].keys() | shards[1].keys()
    for shard in shards:
        for name, t in shard.items():
            assert same_bits(got[name], t), name


def test_reader_rejects_a_name_in_two_shards(tmp_path):
    safetensors.torch.save_file({"a": torch.zeros(2)}, str(tmp_path / "a.safetensors"))
    safetensors.torch.save_file({"a": torch.ones(2)}, str(tmp_path / "b.safetensors"))
    with pytest.raises(ValueError, match="two shards"):
        load_safetensors_dir(str(tmp_path))


def raw_file(path, header, data=b""):
    head = json.dumps(header).encode()
    path.write_bytes(struct.pack("<Q", len(head)) + head + data)
    return str(path)


@pytest.mark.parametrize("case", ["truncated_data", "truncated_header", "overlap",
                                  "unknown_dtype", "wrong_size", "short_file"])
def test_reader_rejects_malformed_files(tmp_path, case):
    f32 = {"dtype": "F32", "shape": [2], "data_offsets": [0, 8]}
    if case == "truncated_data":
        path = raw_file(tmp_path / "x", {"a": f32}, bytes(4))
    elif case == "truncated_header":
        path = str(tmp_path / "x")
        (tmp_path / "x").write_bytes(struct.pack("<Q", 400) + b'{"a": 1}')
    elif case == "overlap":
        path = raw_file(tmp_path / "x", {"a": f32, "b": {"dtype": "F32", "shape": [2],
                                                          "data_offsets": [4, 12]}}, bytes(12))
    elif case == "unknown_dtype":
        path = raw_file(tmp_path / "x", {"a": dict(f32, dtype="F8_E4M3")}, bytes(8))
    elif case == "wrong_size":
        path = raw_file(tmp_path / "x", {"a": dict(f32, shape=[3])}, bytes(8))
    else:
        path = str(tmp_path / "x")
        (tmp_path / "x").write_bytes(b"\x01\x00")
    with pytest.raises(ValueError):
        read_safetensors(path)


def test_chip_smoke_writer_is_read_back_by_safetensors(tmp_path):
    tensors = {}
    for i, code in enumerate(DTYPES):
        tensors.update(tensors_of(code, seed=10 + i))
    tensors["F32.transposed"] = sample(torch.float32, (4, 6), 99).t()
    path = str(tmp_path / "w.safetensors")
    n = chip_smoke.write_safetensors(path, tensors)
    assert n == os.path.getsize(path)
    want = safetensors.torch.load_file(path)
    ours = read_safetensors(path)
    for name, t in tensors.items():
        assert same_bits(want[name], t.contiguous()), name
        assert same_bits(ours[name], t.contiguous()), name
    numpy_view = safetensors.numpy.load_file(path)
    assert np.array_equal(numpy_view["I16.cube"], tensors["I16.cube"].numpy())


# ------------------------------------------------------------ HF layout
def hf_dir_from_jax(path, params, dac_params, cfg=CFG, form="weight_g", fused_heads=False):
    """The JAX package's exporters, saved by `safetensors.numpy.save_file`
    in two shards, beside an HF-style config.json."""
    tensors = jax_export(params, cfg)
    tensors.update(jax_export_dac(dac_params, cfg.audio_encoder, prefix="audio_encoder.model.",
                                  weight_norm=True, v_scale=1.7))
    if form == "parametrizations":
        tensors = {k.replace(".weight_g", ".parametrizations.weight.original0")
                   .replace(".weight_v", ".parametrizations.weight.original1"): v
                   for k, v in tensors.items()}
    if fused_heads:
        k = cfg.decoder.num_codebooks
        tensors["decoder.lm_heads.weight"] = np.concatenate(
            [tensors.pop(f"decoder.lm_heads.{i}.weight") for i in range(k)])
    names = sorted(tensors)
    os.makedirs(path, exist_ok=True)
    for i, part in enumerate((names[: len(names) // 2], names[len(names) // 2:])):
        safetensors.numpy.save_file({k: np.ascontiguousarray(tensors[k]) for k in part},
                                    os.path.join(path, f"model-{i + 1:05d}-of-00002.safetensors"))
    write_config(path, hf_config(cfg))
    return str(path)


@pytest.mark.parametrize("form", ["weight_g", "parametrizations"])
def test_jax_written_hf_directory_loads_into_the_port(tmp_path, pair, form):
    jm, params, jdac, dac_params, want = pair
    path = hf_dir_from_jax(tmp_path / "hf", params, dac_params, form=form)
    pipe = ParlerTTSPipeline.from_pretrained(path, generation_config=port_gen(GEN),
                                             device="cpu", cache_dtype=torch.float32,
                                             frame_bucket=8)
    assert pipe.config == port_config(CFG)
    worst = assert_same_params(pipe.model, pipe.dac, *reference_port(params, dac_params))
    assert worst > 0.0  # v_scale 1.7: the fold did real work
    desc, dm, prompt, pm = ids(seed=7)
    out = pipe.generate_codes(desc, dm, prompt, pm)
    np.testing.assert_array_equal(out.delayed_ids.numpy(), np.asarray(want.delayed_ids))
    assert out.steps == int(want.steps)
    lengths = np.asarray(want.lengths)
    bucket = min(-(-int(lengths.max()) // 8) * 8, want.codes.shape[-1])
    codes = jnp.clip(want.codes[:, :, :bucket], 0, PAD - 1)
    wave = np.asarray(jdac.apply({"params": dac_params}, codes, method="decode"))[:, :, 0]
    audio, audio_lengths = pipe.decode_codes(out.codes, out.lengths)
    np.testing.assert_array_equal(audio_lengths, lengths * CFG.audio_encoder.hop_length)
    np.testing.assert_allclose(audio, wave, atol=1e-5, rtol=1e-4)


def test_hf_directory_with_fused_heads_and_a_relu_t5(tmp_path):
    """The fused (K*V, D) LM head and a non-gated T5 FFN map onto the same
    parameters as the JAX trees."""
    cfg = dataclasses.replace(CFG, text_encoder=dataclasses.replace(
        CFG.text_encoder, feed_forward_proj="relu"))
    _, params, _, dac_params = jax_params(cfg, seed=4)
    path = hf_dir_from_jax(tmp_path / "hf", params, dac_params, cfg=cfg,
                           form="parametrizations", fused_heads=True)
    pipe = ParlerTTSPipeline.from_pretrained(path, device="cpu")
    assert pipe.config.text_encoder.feed_forward_proj == "relu"
    assert_same_params(pipe.model, pipe.dac, *reference_port(params, dac_params, cfg))


@pytest.mark.parametrize("weight_quant", [True, "xla"])
def test_from_pretrained_quantizes_as_the_jax_package(tmp_path, pair, weight_quant):
    _, params, _, dac_params, _ = pair
    path = hf_dir_from_jax(tmp_path / "hf", params, dac_params)
    pipe = ParlerTTSPipeline.from_pretrained(path, device="cpu", weight_quant=weight_quant)
    ref = ParlerTTS(port_config(CFG), weight_quant=True)
    load_jax_params(ref, host(jax_quantize(params)))
    for (name, got), (_, w) in zip(pipe.model.named_parameters(), ref.named_parameters()):
        assert got.dtype == w.dtype and torch.equal(got, w), name
    assert pipe.model.decoder.decoder.layers[1].fc1.xla == (weight_quant == "xla")


def test_port_exporters_match_the_jax_exporters(pair):
    _, params, _, dac_params, _ = pair
    model, dac = reference_port(params, dac_params)
    got = export_composite_to_hf_tensors(tensor_tree(model), port_config(CFG))
    want = jax_export(params, CFG)
    assert got.keys() == want.keys()
    for name, w in want.items():
        np.testing.assert_array_equal(got[name].numpy(), w, err_msg=name)
    got = export_dac_params(tensor_tree(dac), port_config(CFG.audio_encoder), v_scale=1.7)
    want = jax_export_dac(dac_params, CFG.audio_encoder, v_scale=1.7)
    assert got.keys() == want.keys()
    assert any(".encoder." in f".{k}" for k in want) and any(".in_proj." in k for k in want)
    for name, w in want.items():
        np.testing.assert_array_equal(got[name].numpy(), w, err_msg=name)


def test_port_written_hf_directory_round_trips(tmp_path, pair):
    """What `chip_smoke.py` phase (j) does at mini-v1 size: the port's
    exporters, `write_safetensors` in two shards (bf16 model tensors as
    BF16), `from_pretrained`; every parameter equal, folds within FOLD_REL."""
    _, params, _, dac_params, _ = pair
    model, dac = reference_port(params, dac_params)
    src = ParlerTTS(port_config(CFG), dtype=torch.bfloat16)
    load_jax_params(src, params)
    tensors = export_composite_to_hf_tensors(tensor_tree(src), port_config(CFG))
    tensors.update(export_dac_params(tensor_tree(dac), port_config(CFG.audio_encoder),
                                     prefix="audio_encoder.model.", v_scale=1.7))
    names = sorted(tensors)
    for i, part in enumerate((names[::2], names[1::2])):
        chip_smoke.write_safetensors(str(tmp_path / f"m{i}.safetensors"),
                                     {k: tensors[k] for k in part})
    write_config(str(tmp_path), hf_config())
    on_disk = load_safetensors_dir(str(tmp_path))
    assert on_disk["decoder.model.decoder.layers.0.fc1.weight"].dtype == torch.bfloat16
    assert on_disk["audio_encoder.model.decoder.model.0.weight_v"].dtype == torch.float32
    pipe = ParlerTTSPipeline.from_pretrained(str(tmp_path), device="cpu", dtype=torch.bfloat16)
    assert_same_params(pipe.model, pipe.dac, src, dac)


# ------------------------------------------------------------ native layout
def test_jax_save_pretrained_loads_into_the_port(tmp_path, pair):
    jm, params, jdac, dac_params, _ = pair
    gen = dataclasses.replace(GEN, max_length=20, min_new_tokens=5, codebook_guard=80)
    JPipeline(jm, params, jdac, dac_params, gen, tokenizer=stub_tokenizer).save_pretrained(
        str(tmp_path))
    pipe = ParlerTTSPipeline.from_pretrained(str(tmp_path), device="cpu",
                                             cache_dtype=torch.float32)
    assert pipe.generation_config == port_gen(gen)
    ref_model, ref_dac = reference_port(params, dac_params)
    for (name, got), (_, w) in zip(pipe.model.named_parameters(), ref_model.named_parameters()):
        assert torch.equal(got, w), name
    for (name, got), (_, w) in zip(pipe.dac.named_parameters(), ref_dac.named_parameters()):
        assert torch.equal(got, w), name
    desc, dm, prompt, pm = ids(seed=8)
    want = make_generate(jm, gen, cache_dtype=jnp.float32)(
        params, desc, dm, prompt, pm, jax.random.key(0))
    out = pipe.generate_codes(desc, dm, prompt, pm)
    np.testing.assert_array_equal(out.delayed_ids.numpy(), np.asarray(want.delayed_ids))
    assert out.steps == int(want.steps) == gen.max_length


def test_native_layout_without_dac_params_draws_a_seeded_codec(tmp_path, pair):
    jm, params, jdac, dac_params, _ = pair
    JPipeline(jm, params, jdac, dac_params, GEN, tokenizer=stub_tokenizer).save_pretrained(
        str(tmp_path))
    os.remove(tmp_path / "dac_params.pkl")
    a, b = (ParlerTTSPipeline.from_pretrained(str(tmp_path), device="cpu") for _ in range(2))
    for (name, x), (_, y) in zip(a.dac.named_parameters(), b.dac.named_parameters()):
        assert torch.equal(x, y), name
    assert a.dac.quantizer.codebooks.std() > 0.5


def test_port_save_pretrained_loads_into_the_jax_package(tmp_path, pair):
    jm, params, jdac, dac_params, want = pair
    model, dac = reference_port(params, dac_params)
    gen = dataclasses.replace(GEN, codebook_guard=80)
    ParlerTTSPipeline(model, dac, port_gen(gen), device="cpu").save_pretrained(str(tmp_path))
    loaded = JPipeline.from_pretrained(str(tmp_path), tokenizer=stub_tokenizer)
    assert loaded.config == CFG and loaded.generation_config == gen
    for (path, got), (_, w) in zip(
            jax.tree_util.tree_flatten_with_path(host(loaded.params))[0],
            jax.tree_util.tree_flatten_with_path(params)[0]):
        np.testing.assert_array_equal(got, w, err_msg=jax.tree_util.keystr(path))
    jax.tree.map(np.testing.assert_array_equal, host(loaded.dac_params), host(dac_params))
    desc, dm, prompt, pm = ids(seed=7)
    got = make_generate(jm, GEN, cache_dtype=jnp.float32)(
        loaded.params, desc, dm, prompt, pm, jax.random.key(0))
    np.testing.assert_array_equal(np.asarray(got.delayed_ids), np.asarray(want.delayed_ids))


def test_save_pretrained_refuses_int8_and_fused_weights(tmp_path):
    pcfg = port_config(CFG)
    for kw, pipe_kw in ((dict(weight_quant=True), {}), ({}, dict(fused_qkv=True))):
        pipe = ParlerTTSPipeline.from_random(pcfg, device="cpu", **kw, **pipe_kw)
        with pytest.raises(ValueError, match="save_pretrained"):
            pipe.save_pretrained(str(tmp_path))


def test_checkpoint_pickles_admit_arrays_only(tmp_path, pair):
    import pickle

    jm, params, jdac, dac_params, _ = pair
    JPipeline(jm, params, jdac, dac_params, GEN, tokenizer=stub_tokenizer).save_pretrained(
        str(tmp_path))
    with open(tmp_path / "dac_params.pkl", "wb") as f:
        pickle.dump({"decoder": print}, f)
    with pytest.raises(pickle.UnpicklingError, match="builtins.print"):
        ParlerTTSPipeline.from_pretrained(str(tmp_path), device="cpu")


def test_from_pretrained_without_a_gpu_raises(tmp_path, monkeypatch, pair):
    jm, params, jdac, dac_params, _ = pair
    JPipeline(jm, params, jdac, dac_params, GEN, tokenizer=stub_tokenizer).save_pretrained(
        str(tmp_path))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ParlerTTSPipeline.from_pretrained(str(tmp_path))
    assert ParlerTTSPipeline.from_pretrained(str(tmp_path), device="cpu").device.type == "cpu"
