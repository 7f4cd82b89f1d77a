"""The port's helper scripts (`parler_tts_tpu_torch/scripts/`) against the
JAX package's `helpers/` scripts, loaded from their files, on the CPU:

  * the init scripts write the JAX scripts' `config.json` (and
    `generation_config.json` where the JAX script writes one) and a
    `params.pkl` with the JAX `model.init` tree's leaf names and shapes; the
    two tiny ones are run for real, the 600M and large-v1 ones compared
    without drawing a weight (`jax.eval_shape` of the JAX script's own
    `model.init`, a port model on the `meta` device). The Encodec dummy
    parts from the JAX script in its audio encoder only (fault F6 of the
    JAX script: a `DACConfig` in `config.json`, the codec in a file no
    loader reads);
  * the tiny directories, and the JAX dummy script's own, load in both
    packages' `from_pretrained` and give identical fp32 greedy ids (the
    weights cannot match the JAX scripts': threefry and Philox differ);
  * `push_dac_to_hub` on a `.safetensors` and a `.pth` of one tiny DAC
    (the four encoder and decoder rates of `DACConfig()`) gives the JAX
    script's tree within 1e-6 of each kernel's scale (the weight norm folded
    in float64 by both), and the two packages decode it alike;
  * `push_trained_parler_tts_to_hub` writes the JAX script's tensors bit
    for bit from a params `.pkl`, the same from the port's train state,
    and a directory the port's `from_pretrained` loads (fault F7 of the JAX
    script: its output has no `config.json` and no codec); a push without
    `huggingface_hub` is logged and skipped;
  * the demo's CLI loop writes the JAX demo's waveform (fp32 greedy over
    the speculative window of 16) and ends at EOF, where the JAX loop
    raises;
  * every script refuses to run without a GPU unless given `--device cpu`;
  * `quantize_stacked_heads`, `dequantize_for_reference` and
    `torch_state_dict_to_numpy` equal the JAX package's bit for bit, and
    the four `helpers/training_configs` parse to the same arguments in both
    packages.
"""

import contextlib
import dataclasses
import functools
import importlib
import importlib.util
import json
import logging
import os
import pickle
import shutil
import sys
import types
import wave
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parler_tts_tpu.codec.dac_model import DACModel as JDAC
from parler_tts_tpu.config import GenerationConfig as JGenerationConfig
from parler_tts_tpu.config import ParlerTTSConfig as JParlerConfig
from parler_tts_tpu.models.parler import ParlerTTS as JParler
from parler_tts_tpu.runtime.generate import make_generate
from parler_tts_tpu.runtime.pipeline import ParlerTTSPipeline as JPipeline
from parler_tts_tpu.runtime.speculative import make_generate_speculative
from parler_tts_tpu.training import arguments as ja
from parler_tts_tpu.utils import hf_bridge as jbridge
from parler_tts_tpu.utils import quantize as jquant
from parler_tts_tpu_torch import config as tc
from parler_tts_tpu_torch.codec.convert import export_dac_params
from parler_tts_tpu_torch.codec.registry import build_codec, init_codec_params
from parler_tts_tpu_torch.convert import dac_to_jax_tree, load_jax_dac_params, tensor_tree
from parler_tts_tpu_torch.models.parler import ParlerTTS
from parler_tts_tpu_torch.runtime.checkpoint import read_safetensors, write_safetensors
from parler_tts_tpu_torch.runtime.pipeline import ParlerTTSPipeline, load_pickle
from parler_tts_tpu_torch.scripts import gradio_demo
from parler_tts_tpu_torch.scripts import init_dummy_model_with_encodec as t_encodec
from parler_tts_tpu_torch.scripts import push_dac_to_hub, push_trained_parler_tts_to_hub
from parler_tts_tpu_torch.training import arguments as ta
from parler_tts_tpu_torch.training.checkpoints import save_train_state
from parler_tts_tpu_torch.training.train_state import TrainState, make_optimizer
from parler_tts_tpu_torch.utils import hf_bridge as tbridge
from parler_tts_tpu_torch.utils import quantize as tquant
from test_torch_models import output_in_unit_range, port_config
from test_torch_pipeline import CFG as TINY_CFG

ROOT = Path(__file__).resolve().parent.parent
HELPERS = ROOT / "helpers"
INIT_SCRIPTS = {"dummy": "init_dummy_model", "encodec": "init_dummy_model_with_encodec",
                "600M": "init_model_600M", "large": "init_large_model"}
SCRIPTS = [*INIT_SCRIPTS.values(), "push_dac_to_hub", "push_trained_parler_tts_to_hub",
           "gradio_demo"]
WAVE_TOL = dict(atol=1e-5, rtol=1e-4)  # tests/test_torch_pipeline.py's waveform tolerance


def stub_tokenizer(texts):
    """One id a byte (mod 32000), a list of ids a string."""
    return {"input_ids": [[b % 32000 for b in t.encode()] for t in texts]}


def jax_script(relpath: str):
    """A `helpers/` script, loaded from its file under a name of its own."""
    name = "jax_helpers_" + relpath.replace("/", "_").removesuffix(".py")
    spec = importlib.util.spec_from_file_location(name, HELPERS / relpath)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@contextlib.contextmanager
def argv(*args):
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(sys, "argv", ["script", *map(str, args)])
        yield mp


def run_jax_init(name: str, out: Path, shapes_only: bool = False):
    """Run the JAX init script `name` into `out`. With `shapes_only` its
    `jax.jit(model.init)` (and the Encodec's `init`) is `jax.eval_shape` of
    the same init and its pickles are caught: it writes its json files and
    returns {file name: tree of ShapeDtypeStructs} without drawing a
    weight."""
    module = jax_script(f"model_init_scripts/{name}.py")
    caught = {}
    with argv(out) as mp:
        if shapes_only:
            mp.setattr(module, "jax", types.SimpleNamespace(
                jit=lambda f: functools.partial(jax.eval_shape, f), random=jax.random,
                tree=types.SimpleNamespace(map=lambda f, tree: tree)))
            mp.setattr(module, "pickle", types.SimpleNamespace(
                dump=lambda obj, f: caught.setdefault(os.path.basename(f.name), obj)))
            if hasattr(module, "EncodecCodec"):
                codec = module.EncodecCodec
                mp.setattr(module, "EncodecCodec", lambda cfg: types.SimpleNamespace(
                    init=functools.partial(jax.eval_shape, codec(cfg).init)))
        module.main()
    return caught


def flat_leaves(tree, prefix=""):
    out = {}
    for key, value in tree.items():
        if isinstance(value, dict):
            out.update(flat_leaves(value, f"{prefix}{key}/"))
        else:
            out[prefix + key] = value
    return out


def unflat(flat):
    tree = {}
    for name, leaf in flat.items():
        *path, key = name.split("/")
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        node[key] = leaf
    return tree


def flat_shapes(tree):
    """{leaf path: (shape, dtype name)} of a tree of arrays, tensors or
    ShapeDtypeStructs."""
    return {name: (tuple(leaf.shape), str(leaf.dtype).removeprefix("torch."))
            for name, leaf in flat_leaves(tree).items()}


def read_json(path):
    with open(path) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    """Each tiny init script of both packages run into a directory of its
    own (the port's on the CPU, seed 0). The JAX Encodec script runs shapes
    only (its eager Encodec init takes ~25 s on the CPU): its trees'
    ShapeDtypeStructs are kept under `("jax", "encodec", file name)`."""
    out = {}
    for kind in ("dummy", "encodec"):
        name = INIT_SCRIPTS[kind]
        out["port", kind] = tmp_path_factory.mktemp(f"port_{kind}")
        importlib.import_module(f"parler_tts_tpu_torch.scripts.{name}").main(
            [str(out["port", kind]), "--device", "cpu"])
        out["jax", kind] = tmp_path_factory.mktemp(f"jax_{kind}")
        trees = run_jax_init(name, out["jax", kind], shapes_only=kind == "encodec")
        for file, tree in trees.items():
            out["jax", kind, file] = tree
    return out


@pytest.fixture(scope="module")
def shape_runs(tmp_path_factory):
    """The JAX 600M and large-v1 scripts run shapes only: {kind: (directory,
    the params tree's ShapeDtypeStructs)}."""
    out = {}
    for kind in ("600M", "large"):
        path = tmp_path_factory.mktemp(f"jax_{kind}")
        out[kind] = path, run_jax_init(INIT_SCRIPTS[kind], path, shapes_only=True)["params.pkl"]
    return out


# ------------------------------------------------------------ init scripts
@pytest.mark.parametrize("kind", list(INIT_SCRIPTS))
def test_init_scripts_write_the_jax_scripts_configs(kind, dirs, shape_runs):
    module = importlib.import_module(f"parler_tts_tpu_torch.scripts.{INIT_SCRIPTS[kind]}")
    cfg, gen = module.configs()
    if kind in ("dummy", "encodec"):
        port_dir, jax_dir = dirs["port", kind], dirs["jax", kind]
        got = read_json(port_dir / "config.json")
        assert got == json.loads(cfg.to_json())
    else:
        jax_dir, got = shape_runs[kind][0], json.loads(cfg.to_json())
    want = read_json(jax_dir / "config.json")
    if kind == "encodec":
        # F6: the JAX script writes a DACConfig of the codec's geometry, the
        # port the Encodec it draws (the JAX `from_json` reads either)
        codec = dataclasses.asdict(t_encodec.configs()[0].audio_encoder)
        assert got.pop("audio_encoder") == json.loads(json.dumps(codec))
        assert want.pop("audio_encoder") == json.loads(json.dumps(dataclasses.asdict(
            tc.DACConfig(num_codebooks=8, codebook_size=2048, sampling_rate=32000,
                         frame_rate=50))))
        assert codec["codec_type"] == "encodec" and codec["sampling_rate"] == 32000
    assert got == want
    if gen is not None:
        assert read_json(jax_dir / "generation_config.json") == dataclasses.asdict(gen)
        assert gen.max_length == 30 * 86 and gen.do_sample
    else:
        assert not (jax_dir / "generation_config.json").exists()
        dcfg = cfg.decoder
        assert read_json(dirs["port", kind] / "generation_config.json") == dataclasses.asdict(
            tc.GenerationConfig(bos_token_id=dcfg.bos_token_id, pad_token_id=dcfg.pad_token_id,
                                eos_token_id=dcfg.eos_token_id))


@pytest.mark.parametrize("kind", list(INIT_SCRIPTS))
def test_init_scripts_write_the_jax_init_tree(kind, dirs, shape_runs):
    """The port's tree has the JAX `model.init` tree's leaf names, shapes and
    dtypes: the written `params.pkl` of the tiny scripts, a `meta`-device
    model against `jax.eval_shape` at mini-v1 and large-v1 widths."""
    if kind in ("dummy", "encodec"):
        got = flat_shapes(load_pickle(dirs["port", kind] / "params.pkl"))
        if kind == "dummy":
            with open(dirs["jax", kind] / "params.pkl", "rb") as f:
                want = flat_shapes(pickle.load(f))
        else:
            want = flat_shapes(dirs["jax", kind, "params.pkl"])
    else:
        module = importlib.import_module(f"parler_tts_tpu_torch.scripts.{INIT_SCRIPTS[kind]}")
        got = flat_shapes(tensor_tree(ParlerTTS(module.configs()[0], device="meta")))
        want = flat_shapes(shape_runs[kind][1])
        n = sum(int(np.prod(s)) for s, _ in got.values())
        # full width and depth, text encoder included (the codec is not in the tree)
        assert n == {"600M": 566_180_992, "large": 1_554_990_592}[kind], n
    assert got == want
    if kind == "encodec":  # the Encodec tree, in the file the loaders read
        got = flat_shapes(load_pickle(dirs["port", kind] / "dac_params.pkl"))
        assert got == flat_shapes(dirs["jax", kind, "encodec_params.pkl"])


@pytest.fixture(scope="module")
def greedy():
    """fp32 greedy generation over 24 columns of a directory in each
    package, one JAX program per decoder geometry. A directory with a codec
    loads in the JAX `from_pretrained`; one without (the JAX dummy script's)
    is read as that method reads it, without drawing the JAX codec it does
    not use here."""
    fns = {}

    def run(path):
        if (path / "dac_params.pkl").exists():
            jpipe = JPipeline.from_pretrained(str(path), tokenizer=stub_tokenizer)
            jmodel, jparams = jpipe.model, jpipe.params
        else:
            jpipe, jmodel = None, JParler(JParlerConfig.from_json(
                (path / "config.json").read_text()))
            with open(path / "params.pkl", "rb") as f:
                jparams = pickle.load(f)
        dcfg = jmodel.config.decoder
        ids = dict(bos_token_id=dcfg.bos_token_id, pad_token_id=dcfg.pad_token_id,
                   eos_token_id=dcfg.eos_token_id)
        jgen = JGenerationConfig(max_length=24, do_sample=False, **ids)
        if dcfg not in fns:
            fns[dcfg] = make_generate(jmodel, jgen, cache_dtype=jnp.float32)
        request = request_ids()
        want = fns[dcfg](jparams, *request, jax.random.key(0))
        pipe = ParlerTTSPipeline.from_pretrained(
            str(path), device="cpu", cache_dtype=torch.float32,
            generation_config=tc.GenerationConfig(**dataclasses.asdict(jgen)))
        return jpipe, pipe, want, pipe.generate_codes(*request)

    return run


def request_ids():
    rng = np.random.default_rng(0)
    prompt_mask = np.ones((2, 6), np.int32)
    prompt_mask[1, :2] = 0
    return (rng.integers(0, 32000, (2, 8)).astype(np.int32), np.ones((2, 8), np.int32),
            rng.integers(0, 32000, (2, 6)).astype(np.int32), prompt_mask)


@pytest.mark.parametrize("source", [("port", "dummy"), ("port", "encodec"), ("jax", "dummy")],
                         ids=["port-dummy", "port-encodec", "jax-dummy"])
def test_directories_serve_the_same_greedy_ids_in_both_packages(source, dirs, greedy):
    jpipe, pipe, want, got = greedy(dirs[source])
    np.testing.assert_array_equal(got.delayed_ids.numpy(), np.asarray(want.delayed_ids))
    np.testing.assert_array_equal(got.codes.numpy(), np.asarray(want.codes))
    assert got.steps == int(want.steps) == 24
    if source[0] == "port":  # both packages serve the codec the script drew
        codec = "EncodecCodec" if source[1] == "encodec" else "DACModel"
        assert type(jpipe.dac).__name__ == type(pipe.dac).__name__ == codec
        want = flat_leaves(load_pickle(dirs[source] / "dac_params.pkl"))
        for tree in (dac_to_jax_tree(pipe.dac), jax.tree.map(np.asarray, jpipe.dac_params)):
            got = flat_leaves(tree)
            assert got.keys() == want.keys()
            for name, w in want.items():
                np.testing.assert_array_equal(got[name], w, err_msg=name)


def test_the_jax_encodec_script_directory_names_a_dac(dirs):
    """F6: the JAX Encodec dummy's `config.json` reads as a DAC in both
    packages, and its Encodec lies in `encodec_params.pkl`, which neither
    `from_pretrained` reads: its directory serves a random DAC. The port's
    directory names the Encodec and keeps it in `dac_params.pkl`."""
    text = (dirs["jax", "encodec"] / "config.json").read_text()
    assert JParlerConfig.from_json(text).audio_encoder.codec_type == "dac"
    assert tc.ParlerTTSConfig.from_json(text).audio_encoder.codec_type == "dac"
    assert sorted(os.listdir(dirs["jax", "encodec"])) == ["config.json", "encodec_params.pkl",
                                                         "params.pkl"]
    text = (dirs["port", "encodec"] / "config.json").read_text()
    assert JParlerConfig.from_json(text).audio_encoder.codec_type == "encodec"
    assert "dac_params.pkl" in os.listdir(dirs["port", "encodec"])


# ------------------------------------------------------------ export scripts
TINY_DAC = tc.DACConfig(num_codebooks=9, codebook_size=32, codebook_dim=4, latent_dim=16,
                        encoder_dim=4, decoder_dim=16)  # DACConfig()'s rates


def test_push_dac_to_hub_matches_the_jax_script(tmp_path, capsys):
    assert (TINY_DAC.encoder_rates, TINY_DAC.decoder_rates) == (
        tc.DACConfig().encoder_rates, tc.DACConfig().decoder_rates)
    codec = init_codec_params(build_codec(TINY_DAC), torch.Generator().manual_seed(5))
    state = export_dac_params(output_in_unit_range(dac_to_jax_tree(codec)), TINY_DAC,
                              prefix="", v_scale=1.7)
    write_safetensors(str(tmp_path / "dac.safetensors"), state)
    torch.save({"state_dict": state, "metadata": {"kwargs": {"sample_rate": 44100}}},
               tmp_path / "dac.pth")
    with argv(tmp_path / "dac.safetensors", tmp_path / "jax"):
        jax_script("push_to_hub_scripts/push_dac_to_hub.py").main()
    with open(tmp_path / "jax" / "dac_params.pkl", "rb") as f:
        want = flat_leaves(pickle.load(f))
    codes = np.random.default_rng(1).integers(0, 32, (2, 9, 6))
    jdecode = np.asarray(JDAC(TINY_DAC).apply(
        {"params": unflat(want)}, jnp.asarray(codes, jnp.int32), method="decode"))
    for form in ("safetensors", "pth"):
        push_dac_to_hub.main([str(tmp_path / f"dac.{form}"), str(tmp_path / form),
                              "--device", "cpu"])
        got = flat_leaves(load_pickle(tmp_path / form / "dac_params.pkl"))
        assert got.keys() == want.keys()
        for name, w in want.items():
            assert got[name].dtype == np.float32 and got[name].shape == w.shape, name
            assert np.abs(got[name] - w).max() <= 1e-6 * np.abs(w).max(), name
        dac = build_codec(TINY_DAC)
        load_jax_dac_params(dac, unflat(got))
        with torch.no_grad():
            audio = dac.decode(torch.from_numpy(codes)).numpy()
        np.testing.assert_allclose(audio, jdecode, **WAVE_TOL)
    assert "converted" in capsys.readouterr().out


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """A tiny native checkpoint (`params.pkl`, `config.json`,
    `dac_params.pkl`) and the JAX script's export of it."""
    src = tmp_path_factory.mktemp("trained")
    pipe = ParlerTTSPipeline.from_random(port_config(TINY_CFG), seed=3, device="cpu")
    pipe.save_pretrained(str(src))
    out = tmp_path_factory.mktemp("jax_export")
    with argv(src / "params.pkl", src / "config.json", out):
        jax_script("push_to_hub_scripts/push_trained_parler_tts_to_hub.py").main()
    assert sorted(os.listdir(out)) == ["model.safetensors"]  # F7: no config, no codec
    return pipe, src, read_safetensors(str(out / "model.safetensors"))


def assert_same_tensors(got, want):
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        assert got[name].dtype == w.dtype and torch.equal(got[name], w), name


def test_push_trained_from_a_params_pkl_matches_the_jax_script(trained, tmp_path):
    pipe, src, want = trained
    push_trained_parler_tts_to_hub.main([str(src / "params.pkl"), str(src / "config.json"),
                                         str(tmp_path), "--device", "cpu"])
    assert sorted(os.listdir(tmp_path)) == ["config.json", "dac_params.pkl",
                                            "model.safetensors"]
    assert_same_tensors(read_safetensors(str(tmp_path / "model.safetensors")), want)
    loaded = ParlerTTSPipeline.from_pretrained(str(tmp_path), device="cpu")
    assert loaded.config == pipe.config
    for module, source in ((loaded.model, pipe.model), (loaded.dac, pipe.dac)):
        want_params = dict(source.named_parameters())
        for name, p in module.named_parameters():
            assert torch.equal(p, want_params[name]), name


def test_push_trained_from_the_ports_train_state(trained, tmp_path):
    """A train-state checkpoint directory, or the run's directory (its last
    checkpoint), exports the tensors the `.pkl` of the same weights does."""
    pipe, src, want = trained
    state = TrainState.create(pipe.model, make_optimizer())
    ckpt = save_train_state(state, str(tmp_path / "run"), step=3, epoch=0)
    for source in (ckpt, str(tmp_path / "run")):
        out = tmp_path / f"out_{len(source)}"
        push_trained_parler_tts_to_hub.main([source, str(src / "config.json"), str(out),
                                             "--device", "cpu"])
        assert_same_tensors(read_safetensors(str(out / "model.safetensors")), want)
    with pytest.raises(SystemExit, match="not a params .pkl"):
        push_trained_parler_tts_to_hub.main([str(tmp_path / "nothing"),
                                             str(src / "config.json"), str(tmp_path / "x"),
                                             "--device", "cpu"])


def test_push_trained_without_codec_or_hub_says_so(trained, tmp_path, monkeypatch, caplog,
                                                   capsys):
    _, src, want = trained
    shutil.copy(src / "config.json", tmp_path / "config.json")  # no dac_params.pkl beside it
    monkeypatch.setitem(sys.modules, "huggingface_hub", None)  # import raises
    with caplog.at_level(logging.WARNING):
        push_trained_parler_tts_to_hub.main([str(src / "params.pkl"),
                                             str(tmp_path / "config.json"), str(tmp_path / "out"),
                                             "--push-to", "someone/model", "--device", "cpu"])
    assert "hub push skipped" in caplog.text
    assert "no dac_params.pkl beside" in capsys.readouterr().out
    assert sorted(os.listdir(tmp_path / "out")) == ["config.json", "model.safetensors"]
    assert_same_tensors(read_safetensors(str(tmp_path / "out" / "model.safetensors")), want)


# ------------------------------------------------------------ the demo
class Answers:
    """`input` for a CLI loop: the given answers, then EOF."""

    def __init__(self, *answers):
        self.answers = list(answers)

    def __call__(self, prompt=""):
        if not self.answers:
            raise EOFError
        return self.answers.pop(0)


def tiny_tokenizer(texts):
    """One id a byte, within the tiny config's text vocabulary (120)."""
    return {"input_ids": [[b % 120 for b in t.encode()] for t in texts]}


def test_demo_cli_loop_writes_the_jax_demos_waveform(trained, tmp_path, monkeypatch, capsys):
    """The default prompt and description, fp32 greedy over the speculative
    window of 16, on a tiny directory: the waveforms agree within
    tests/test_torch_pipeline.py's tolerance. (On the real-width DAC of the
    init scripts fp32 rounding alone parts the packages' decodes by up to
    4.5e-5, so this check runs on a small codec; the init directories' ids
    are held above, and chip_smoke.py runs the demo on the mini-v1 one.)
    The codec's output is scaled into the unit range, as there."""
    _, src, _ = trained
    path = tmp_path / "model"
    shutil.copytree(src, path)
    with open(path / "dac_params.pkl", "rb") as f:
        dac_params = output_in_unit_range(pickle.load(f))
    with open(path / "dac_params.pkl", "wb") as f:
        pickle.dump(dac_params, f, protocol=4)
    dcfg = TINY_CFG.decoder
    jgen = JGenerationConfig(max_length=24, min_new_tokens=24, do_sample=False,
                             codebook_guard=TINY_CFG.audio_encoder.codebook_size,
                             bos_token_id=dcfg.bos_token_id, pad_token_id=dcfg.pad_token_id,
                             eos_token_id=dcfg.eos_token_id)
    monkeypatch.setitem(sys.modules, "gradio", None)  # import raises: the CLI loop

    japp = jax_script("gradio_demo/app.py")
    jwaves = []

    def jax_load(model_path, speculative_window=None):
        jpipe = JPipeline.from_pretrained(model_path, generation_config=jgen,
                                          tokenizer=tiny_tokenizer, frame_bucket=8,
                                          speculative_window=speculative_window)
        jpipe._generate_spec_fn = make_generate_speculative(  # the fp32 cache
            jpipe.model, jgen, window=speculative_window, cache_dtype=jnp.float32)
        return jpipe

    monkeypatch.setattr(japp, "load_pipeline", jax_load)
    monkeypatch.setattr(japp, "input", Answers("", ""), raising=False)
    monkeypatch.setattr(japp, "_write_wav", lambda out, rate, wav: jwaves.append((rate, wav)))
    with argv("--model", path):
        with pytest.raises(EOFError):  # the JAX loop raises at EOF
            japp.main()

    waves = []
    real_write = gradio_demo.write_wav
    monkeypatch.setattr(gradio_demo, "OUTPUT_WAV", str(tmp_path / "demo.wav"))
    monkeypatch.setattr(gradio_demo, "input", Answers("", ""), raising=False)
    monkeypatch.setattr(gradio_demo, "write_wav",
                        lambda out, rate, wav: waves.append((rate, wav)) or real_write(
                            out, rate, wav))
    gradio_demo.main(["--model", str(path), "--device", "cpu"], tokenizer=tiny_tokenizer,
                     generation_config=tc.GenerationConfig(**dataclasses.asdict(jgen)),
                     cache_dtype=torch.float32, frame_bucket=8)
    assert "gradio not installed" in capsys.readouterr().out

    (rate, got), = waves
    (jrate, want), = jwaves
    frames = 24 - dcfg.num_codebooks
    assert rate == jrate == 16000
    assert got.shape == want.shape == (frames * TINY_CFG.audio_encoder.hop_length,)
    np.testing.assert_allclose(got, np.asarray(want), **WAVE_TOL)
    with wave.open(str(tmp_path / "demo.wav")) as f:
        assert (f.getframerate(), f.getnframes(), f.getsampwidth()) == (rate, got.size, 2)
    with pytest.raises(ValueError, match="needs a tokenizer"):
        gradio_demo.main(["--model", str(path), "--device", "cpu"])


@pytest.mark.parametrize("script", SCRIPTS)
def test_scripts_default_to_the_gpu(script, tmp_path, monkeypatch):
    """Without `--device cpu` a script asks for `cuda`, and raises where
    there is none (no silent CPU fallback)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    module = importlib.import_module(f"parler_tts_tpu_torch.scripts.{script}")
    out = str(tmp_path / "out")
    args = {"push_dac_to_hub": [str(tmp_path / "w.safetensors"), out],
            "push_trained_parler_tts_to_hub": [str(tmp_path / "params.pkl"),
                                               str(tmp_path / "config.json"), out],
            "gradio_demo": ["--model", out]}.get(script, [out])
    kw = {"tokenizer": stub_tokenizer} if script == "gradio_demo" else {}
    with pytest.raises(RuntimeError, match="no CUDA device"):
        module.main(args, **kw)
    assert not os.listdir(tmp_path)


# ------------------------------------------------------------ utils and configs
@pytest.mark.parametrize("fn", ["quantize_stacked_heads", "dequantize_for_reference",
                                "torch_state_dict_to_numpy"])
def test_utils_functions_match_jax_bit_for_bit(fn):
    rng = np.random.default_rng(2)
    heads = (rng.standard_normal((3, 16, 40)) * np.linspace(0.01, 3, 40)).astype(np.float32)
    heads[1, :, 7] = 0.0  # a zero column: the 1e-12 floor
    if fn == "quantize_stacked_heads":
        got, want = tquant.quantize_stacked_heads(heads), jquant.quantize_stacked_heads(heads)
        assert got.keys() == want.keys() == {"w_q", "scale"}
        for key in got:
            assert got[key].dtype == want[key].dtype and got[key].shape == want[key].shape
            np.testing.assert_array_equal(got[key], want[key])
    elif fn == "dequantize_for_reference":
        for qtree in (jquant.quantize_stacked_heads(heads), jquant.quantize_kernel(heads[0])):
            want = np.asarray(jquant.dequantize_for_reference(qtree))
            got = tquant.dequantize_for_reference(qtree)
            assert got.dtype == torch.float32
            np.testing.assert_array_equal(got.numpy(), want)
            tensors = {k: torch.from_numpy(v) for k, v in qtree.items()}
            np.testing.assert_array_equal(tquant.dequantize_for_reference(tensors).numpy(), want)
    else:
        state = {"w": torch.from_numpy(heads[0]).requires_grad_(),
                 "i": torch.arange(5, dtype=torch.int64), "h": torch.ones(3, dtype=torch.float16)}
        got, want = tbridge.torch_state_dict_to_numpy(state), jbridge.torch_state_dict_to_numpy(
            state)
        assert list(got) == list(want)
        for key in got:
            assert got[key].dtype == want[key].dtype
            np.testing.assert_array_equal(got[key], want[key])


TRAINING_CONFIGS = sorted((HELPERS / "training_configs").glob("*.json"))


@pytest.mark.parametrize("path", TRAINING_CONFIGS, ids=lambda p: p.stem)
def test_training_configs_parse_alike_in_both_packages(path):
    """The port's `parse_args([path])` gives the JAX package's field names
    and values. JSON lists stay lists in both: no field of these files
    parses to a tuple in one package and a list in the other."""
    assert len(TRAINING_CONFIGS) == 4
    blob = read_json(path)
    for got, want in zip(ta.parse_args([str(path)]), ja.parse_args([str(path)])):
        assert type(got).__name__ == type(want).__name__
        got, want = dataclasses.asdict(got), dataclasses.asdict(want)
        assert list(got) == list(want)
        as_lists = {k for k in got if isinstance(got[k], (list, tuple))
                    and type(got[k]) is not type(want[k])}
        assert as_lists == set(), as_lists
        assert got == want
        assert {k: got[k] for k in blob if k in got} == {k: v for k, v in blob.items()
                                                          if k in got}
