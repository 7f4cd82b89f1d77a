"""The port's `run_training` against the JAX package's, on the CPU, fp32, on
`tests/test_training_step.py`'s tiny config with dropout 0 and chunked
attention, from the same parameters and features: every step's loss within
1e-5 (relative) and every parameter leaf after the last step within 1e-4 of
the JAX leaf's norm (||port - jax|| / ||jax||), in batch and in microbatch
mode. The JAX loop runs over the test session's 8 virtual CPU devices, so
its global batch is 8 x its per-device batch; the port's per-device batch
is that global batch.

Then the port against itself: a run resumed from its step-2 checkpoint
restores every saved tensor bit for bit and ends with the uninterrupted
run's losses and parameters, bit for bit; rotation keeps
`save_total_limit` checkpoints; `export_and_push` writes a directory that
`from_pretrained` loads with every parameter equal to the last
checkpoint's, as it loads the JAX package's own export (F4 of ROADMAP
queue 3: the JAX package's `from_pretrained` cannot); what the CLI still
refuses raises, naming it: a mesh larger than the world, a model axis that
does not divide the heads, the seq axis (ROADMAP item 23b) and tensor
parallelism with int8 weights (23c). The CLI over more than one process is
held in `tests/test_torch_parallel_cli.py`.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from parler_tts_tpu.config import DACConfig as JDACConfig
from parler_tts_tpu.models.parler import ParlerTTS as JParler
from parler_tts_tpu.runtime.pipeline import ParlerTTSPipeline as JPipeline
from parler_tts_tpu.training import arguments as ja
from parler_tts_tpu.training import run_training as jrt
from parler_tts_tpu_torch.codec.registry import build_codec, init_codec_params
from parler_tts_tpu_torch.convert import dac_to_jax_tree, load_jax_params, to_jax_tree
from parler_tts_tpu_torch.models.parler import ParlerTTS
from parler_tts_tpu_torch.parallel import make_mesh
from parler_tts_tpu_torch.runtime.pipeline import ParlerTTSPipeline
from parler_tts_tpu_torch.training import arguments as ta
from parler_tts_tpu_torch.training import checkpoints as tck
from parler_tts_tpu_torch.training import run_training as trt
from test_torch_models import host, port_config
from test_torch_training import flat, norm_rel
from test_training_step import PAD, tiny_config
from torch_dist_worker import _free_port

DEVICES = 8  # the JAX session's virtual CPU devices (tests/conftest.py)
STEPS, ACCUM = 3, 2
CFG = dataclasses.replace(
    tiny_config(),
    decoder=dataclasses.replace(tiny_config().decoder, dropout=0.0),
    audio_encoder=JDACConfig(num_codebooks=4, codebook_size=PAD, codebook_dim=4, latent_dim=32,
                             encoder_dim=4, encoder_rates=(2, 4), decoder_dim=32,
                             decoder_rates=(4, 2), sampling_rate=8000, frame_rate=1000))


def features(n, seed=0):
    rng = np.random.default_rng(seed)
    return [{"labels": rng.integers(0, PAD, size=(int(t), 4)),
             "input_ids": list(rng.integers(0, 120, size=int(rng.integers(4, 12)))),
             "prompt_input_ids": list(rng.integers(0, 256, size=int(rng.integers(2, 7))))}
            for t in rng.integers(8, 15, size=n)]


FEATURES = features(DEVICES * ACCUM * STEPS + 5)


def targs(pkg, out, per_device, **kw):
    base = dict(output_dir=str(out), per_device_train_batch_size=per_device,
                gradient_accumulation_steps=ACCUM, learning_rate=1e-3, warmup_steps=1,
                max_steps=STEPS, logging_steps=1, save_steps=100, eval_steps=100,
                report_to="none", dtype="float32", attention_impl="chunked", seed=3)
    base.update(kw)
    return pkg.TrainingArguments(**base)


def recorder(monkeypatch, module):
    """Each step's train loss, from the module's `log_metric`."""
    losses = []
    log = module.log_metric

    def record(tracker, metrics, *a, prefix="train", **k):
        if prefix == "train":
            losses.append(float(metrics["loss"]))
        return log(tracker, metrics, *a, prefix=prefix, **k)

    monkeypatch.setattr(module, "log_metric", record)
    return losses


@pytest.fixture(scope="module")
def jax_init():
    model = JParler(CFG, use_chunked_attention=True)
    params = model.init(
        jax.random.key(0), np.zeros((1, 4), np.int32), np.ones((1, 4), np.int32),
        np.zeros((1, 3), np.int32), np.ones((1, 3), np.int32), np.zeros((1, 2, 4), np.int32),
    )["params"]
    return model, host(params)


def port_model(params):
    model = ParlerTTS(port_config(CFG), use_chunked_attention=True)
    load_jax_params(model, params)
    return model


def run_port(tmp, params, mode, monkeypatch, **kw):
    losses = recorder(monkeypatch, trt)
    state, step = trt.run_training(
        ta.ModelArguments(max_length=32), ta.DataTrainingArguments(),
        targs(ta, tmp, DEVICES, gradient_accumulation_mode=mode, **kw), port_model(params),
        FEATURES, device="cpu")
    return state, step, list(losses)


@pytest.fixture(scope="module")
def jax_runs(jax_init, tmp_path_factory):
    """JAX `run_training` in both accumulation modes: (losses, params, the
    output directory)."""
    model, params = jax_init
    out = {}
    for mode in ("batch", "microbatch"):
        tmp = tmp_path_factory.mktemp(f"jax_{mode}")
        with pytest.MonkeyPatch.context() as mp:
            losses = recorder(mp, jrt)
            state, step = jrt.run_training(
                ja.ModelArguments(max_length=32), ja.DataTrainingArguments(),
                targs(ja, tmp, 1, gradient_accumulation_mode=mode), model,
                jax.tree.map(np.array, params), FEATURES)
        assert step == STEPS
        out[mode] = (losses, flat(host(state.params)), tmp)
    return out


@pytest.mark.parametrize("mode", ["batch", "microbatch"])
def test_run_training_matches_jax(tmp_path, jax_init, jax_runs, mode, monkeypatch):
    _, params = jax_init
    want_losses, want_params, _ = jax_runs[mode]
    state, step, losses = run_port(tmp_path, params, mode, monkeypatch)
    assert step == STEPS == state.step and len(losses) == STEPS
    np.testing.assert_allclose(losses, want_losses, rtol=1e-5)
    got = flat(to_jax_tree(state.model.named_parameters()))
    assert got.keys() == want_params.keys()
    moved = 0
    for name, w in want_params.items():
        assert norm_rel(got[name], w) <= 1e-4, name
        moved += not np.array_equal(got[name], flat(params)[name])
    assert moved > len(want_params) // 2  # the run did train
    last = tck.get_last_checkpoint(str(tmp_path))
    assert tck.parse_checkpoint_name(last) == (STEPS, 0)


def test_resume_equals_the_uninterrupted_run(tmp_path, jax_init, monkeypatch):
    _, params = jax_init
    kw = dict(save_steps=2, save_total_limit=1)
    whole, _, whole_losses = run_port(tmp_path / "whole", params, "microbatch", monkeypatch,
                                      **kw)
    assert tck.sorted_checkpoints(str(tmp_path / "whole")) == [f"checkpoint-{STEPS}-epoch-0"]
    _, step, first = run_port(tmp_path / "cut", params, "microbatch", monkeypatch,
                              max_steps=2, **kw)
    saved = tck.load_state_dict(tck.get_last_checkpoint(str(tmp_path / "cut")))
    assert step == 2 and saved["step"] == saved["count"] == 2
    # a resumed run restores every saved tensor bit for bit before it steps
    state = trt.TrainState.create(port_model(params), trt.make_optimizer())
    tck.restore_train_state(tck.get_last_checkpoint(str(tmp_path / "cut")), state)
    for key, tensors in (("params", dict(state.model.named_parameters())),
                         ("mu", state.opt_state.mu), ("nu", state.opt_state.nu)):
        assert saved[key].keys() == tensors.keys()
        for name, t in tensors.items():
            assert torch.equal(t, saved[key][name]), (key, name)
    resumed, step, rest = run_port(tmp_path / "cut", params, "microbatch", monkeypatch, **kw)
    assert step == STEPS and resumed.step == STEPS and resumed.opt_state.count == STEPS
    assert first + rest == whole_losses
    for (name, p), (_, q) in zip(resumed.model.named_parameters(),
                                 whole.model.named_parameters()):
        assert torch.equal(p, q), name
    for name in whole.opt_state.mu:
        assert torch.equal(resumed.opt_state.mu[name], whole.opt_state.mu[name]), name
        assert torch.equal(resumed.opt_state.nu[name], whole.opt_state.nu[name]), name


def test_export_loads_in_the_port(tmp_path, jax_runs, jax_init, monkeypatch):
    """The port's export of its run, and the JAX package's export of its
    run, load in the port's `from_pretrained` with the last checkpoint's
    parameters; the JAX package's `from_pretrained` does not read its own
    export (no codec tensors in `model.safetensors`)."""
    _, params = jax_init
    state, _, _ = run_port(tmp_path / "run", params, "batch", monkeypatch)
    codec = init_codec_params(build_codec(port_config(CFG).audio_encoder),
                              torch.Generator().manual_seed(1))
    pcfg = port_config(CFG)
    final = trt.export_and_push(str(tmp_path / "run"), str(tmp_path / "final"), pcfg, codec)
    pipe = ParlerTTSPipeline.from_pretrained(final, device="cpu")
    assert pipe.config == pcfg
    saved = tck.load_state_dict(tck.get_last_checkpoint(str(tmp_path / "run")))["params"]
    for name, p in pipe.model.named_parameters():
        assert torch.equal(p, saved[name]), name
    for name, p in pipe.dac.named_parameters():
        assert torch.equal(p, dict(codec.named_parameters())[name]), name
    assert trt.export_and_push(str(tmp_path / "none"), str(tmp_path / "x"), pcfg, codec) is None

    _, want, jax_out = jax_runs["batch"]
    jax_final = jrt.export_and_push(str(jax_out), str(tmp_path / "jax_final"), CFG,
                                    dac_to_jax_tree(codec))
    jpipe = ParlerTTSPipeline.from_pretrained(jax_final, device="cpu")
    got = flat(to_jax_tree(jpipe.model.named_parameters()))
    for name, w in want.items():
        np.testing.assert_array_equal(got[name], w, err_msg=name)
    with pytest.raises(KeyError):
        JPipeline.from_pretrained(jax_final)


@pytest.mark.parametrize("rebuilt", [False, True], ids=["as_given", "recast"])
def test_run_training_trains_the_model_passed_in(tmp_path, jax_init, rebuilt):
    """The trainer updates the caller's parameters in place and holds no
    second copy: a model already configured as the run asks is trained
    itself; one with another compute dtype is rebuilt around the same fp32
    parameter tensors."""
    kw = dict(dtype=torch.bfloat16, param_dtype=torch.float32) if rebuilt else {}
    model = ParlerTTS(port_config(CFG), use_chunked_attention=True, **kw)
    load_jax_params(model, jax_init[1])
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    args = targs(ta, tmp_path, DEVICES, max_steps=1, warmup_steps=0)
    state, step = trt.run_training(ta.ModelArguments(max_length=32), ta.DataTrainingArguments(),
                                   args, model, FEATURES, device="cpu")
    assert step == 1 and (state.model is not model) == rebuilt
    assert state.model.dtype == torch.float32
    theirs = dict(state.model.named_parameters())
    moved = 0
    for name, p in model.named_parameters():
        assert p.data_ptr() == theirs[name].data_ptr(), name
        moved += not torch.equal(p, before[name])
    assert moved > len(before) // 2


@pytest.mark.parametrize("case", ["mesh_data", "mesh_model", "fsdp", "world_size"])
def test_more_than_one_device_names_item_23(tmp_path, jax_init, case):
    """What the CLI still refuses at world 1 (the name is kept from when it
    refused every mesh): a 2x1x1 mesh over one rank ("mesh_data"), a model
    axis of 3 over 4 heads ("mesh_model"), and training int8 weights over a
    model axis ("world_size": int8 weights train in neither package). Case
    "fsdp": the CLI's arguments have no seq axis, as the JAX package's have
    none, and the mesh builder the CLI calls takes one (a 1x2x1 mesh is
    refused only for not being the world of one rank)."""
    if case == "fsdp":
        assert not any("seq" in f.name for f in dataclasses.fields(ta.TrainingArguments))
        torch.distributed.init_process_group(
            "gloo", init_method=f"tcp://127.0.0.1:{_free_port()}", rank=0, world_size=1)
        try:
            with pytest.raises(ValueError, match="mesh 1x2x1 != 1 ranks"):
                make_mesh(1, 1, n_seq=2)
            assert make_mesh(1, 1, n_seq=1).shape == {"data": 1, "seq": 1, "model": 1}
        finally:
            torch.distributed.destroy_process_group()
        return
    kw, model, error, match = {
        "mesh_data": (dict(mesh_data=2), None, ValueError, "mesh 2x1x1 != 1 ranks"),
        "mesh_model": (dict(mesh_model=3), None, ValueError, "model axis 3 does not divide"),
        "world_size": (dict(mesh_model=2), ParlerTTS(port_config(CFG), weight_quant=True),
                       ValueError, "float, unfused ParlerTTS: int8 and fused q|k|v weights"),
    }[case]
    args = targs(ta, tmp_path, DEVICES, **kw)
    model = model or port_model(jax_init[1])
    with pytest.raises(error, match=match):
        trt.run_training(ta.ModelArguments(), ta.DataTrainingArguments(), args, model,
                         FEATURES, device="cpu")
    with pytest.raises(error, match=match):
        trt.check_parallel(args, model, 1)


def test_bad_arguments_and_no_gpu_raise(tmp_path, jax_init, monkeypatch):
    model = port_model(jax_init[1])
    for kw, match in ((dict(remat_policy="some"), "remat_policy"),
                      (dict(gradient_accumulation_mode="x"), "gradient_accumulation_mode"),
                      (dict(attention_impl="chunked:0"), "positive"),
                      (dict(attention_impl="flash"), "attention_impl"),
                      (dict(dtype="int7"), "dtype"), (dict(adam_mu_dtype="fp8"), "adam_mu_dtype")):
        with pytest.raises(ValueError, match=match):
            trt.run_training(ta.ModelArguments(), ta.DataTrainingArguments(),
                             targs(ta, tmp_path, DEVICES, **kw), model, FEATURES, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        trt.run_training(ta.ModelArguments(), ta.DataTrainingArguments(),
                         targs(ta, tmp_path, DEVICES), model, FEATURES)
