"""The training CLI's `run_training` at world 2 (two gloo ranks of
`tests/torch_dist_worker.py`) against the port's own world-1 run, on the
CPU, fp32, dropout 0, over the synthetic features of
`tests/test_torch_run_training.py`: once with `mesh_data=2` and once with
`fsdp`, each at half the world-1 run's per-device batch, so both take the
same global batches.

  * every step's train loss (logged on rank 0) within 1e-5 of world 1's;
  * the checkpoint the world-2 run writes at step 2 resumes at world 1 to
    the uninterrupted world-1 run's parameters, and its step-3 checkpoint
    holds them: checkpoints are written full;
  * the eval loss (`run_eval`) and the eval generation's delayed ids
    (`run_eval_generation`) agree across ranks (the JAX contract of
    `tests/test_multihost.py`);
  * the world-2 run's export loads in `ParlerTTSPipeline.from_pretrained`
    with the parameters of its last checkpoint.
"""

import shutil

import numpy as np
import pytest
import torch

from parler_tts_tpu_torch.codec.registry import build_codec, init_codec_params
from parler_tts_tpu_torch.convert import dac_to_jax_tree, load_jax_params, to_jax_tree
from parler_tts_tpu_torch.models.layers import init_weights
from parler_tts_tpu_torch.models.parler import ParlerTTS
from parler_tts_tpu_torch.runtime.pipeline import ParlerTTSPipeline
from parler_tts_tpu_torch.training import arguments as ta
from parler_tts_tpu_torch.training import checkpoints as tck
from parler_tts_tpu_torch.training import run_training as trt
from test_torch_models import port_config
from test_torch_run_training import CFG, features, recorder
from torch_dist_worker import launch

PCFG = port_config(CFG)
FEATURES = features(8 * 2 * 3 + 5)
EVAL = features(6, seed=9)
MARGS = ta.ModelArguments(max_length=12, do_sample=False)


def targs(out, per_device, **kw):
    base = dict(output_dir=str(out), per_device_train_batch_size=per_device,
                gradient_accumulation_steps=2, learning_rate=1e-3, warmup_steps=1, max_steps=3,
                logging_steps=1, save_steps=2, eval_steps=100, report_to="none",
                dtype="float32", attention_impl="chunked", seed=3,
                per_device_eval_batch_size=2, compute_clap_similarity_metric=False,
                compute_noise_level_metric=False)
    base.update(kw)
    return ta.TrainingArguments(**base)


def model_from(params):
    model = ParlerTTS(PCFG, use_chunked_attention=True)
    load_jax_params(model, params)
    return model


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("cli")
    model = ParlerTTS(PCFG, use_chunked_attention=True)
    init_weights(model, torch.Generator().manual_seed(0))
    params = to_jax_tree(model.named_parameters())
    codec = build_codec(PCFG.audio_encoder)
    init_codec_params(codec, torch.Generator().manual_seed(1))
    runs = {"mesh_data": targs(tmp / "dp", 4, mesh_data=2),
            "fsdp": targs(tmp / "fsdp", 4, fsdp=True)}
    payload = dict(cfg=PCFG, params=params, dac_params=dac_to_jax_tree(codec),
                   features=FEATURES, eval_features=EVAL,
                   runs=[(MARGS, ta.DataTrainingArguments(), a) for a in runs.values()])
    ranks = launch(2, "cli", payload)
    with pytest.MonkeyPatch.context() as mp:
        losses = recorder(mp, trt)
        state, step = trt.run_training(MARGS, ta.DataTrainingArguments(),
                                       targs(tmp / "one", 8), model_from(params), FEATURES,
                                       device="cpu")
    one = dict(losses=list(losses), step=step,
               params={n: p.detach().clone() for n, p in state.model.named_parameters()})
    return tmp, params, codec, runs, {name: [r[i] for r in ranks]
                                      for i, name in enumerate(runs)}, one


@pytest.mark.parametrize("name", ["mesh_data", "fsdp"])
def test_world_two_trains_as_world_one(runs, name):
    tmp, _, _, args, got, one = runs
    rank0, rank1 = got[name]
    assert rank0["step"] == rank1["step"] == one["step"] == 3
    assert rank1["losses"] == []  # metrics are logged on rank 0
    np.testing.assert_allclose(rank0["losses"], one["losses"], rtol=1e-5)
    last = tck.load_state_dict(tck.get_last_checkpoint(args[name].output_dir))
    assert last["step"] == 3
    for n, p in one["params"].items():
        torch.testing.assert_close(last["params"][n], p, rtol=0, atol=1e-6)
    if name == "fsdp":  # the ranks held halves of the large leaves
        assert any(rank0["shards"][n] != tuple(p.shape) for n, p in one["params"].items())


@pytest.mark.parametrize("name", ["mesh_data", "fsdp"])
def test_eval_agrees_across_ranks(runs, name):
    _, _, _, _, got, _ = runs
    rank0, rank1 = got[name]
    assert np.isfinite(rank0["eval_loss"]) and rank0["eval_loss"] == rank1["eval_loss"]
    assert rank0["codes"].shape == (2, PCFG.decoder.num_codebooks, MARGS.max_length)
    np.testing.assert_array_equal(rank0["codes"], rank1["codes"])


def test_world_two_checkpoint_resumes_at_world_one(runs, tmp_path):
    tmp, params, _, args, _, one = runs
    out = tmp_path / "resume"
    shutil.copytree(args["mesh_data"].output_dir, out)
    shutil.rmtree(out / "checkpoint-3-epoch-0")
    state, step = trt.run_training(MARGS, ta.DataTrainingArguments(), targs(out, 8),
                                   model_from(params), FEATURES, device="cpu")
    assert step == 3
    for n, p in state.model.named_parameters():
        torch.testing.assert_close(p.detach(), one["params"][n], rtol=0, atol=1e-6)


def test_world_two_export_loads(runs, tmp_path):
    _, _, codec, args, _, _ = runs
    out = trt.export_and_push(args["fsdp"].output_dir, str(tmp_path / "final"), PCFG, codec)
    pipe = ParlerTTSPipeline.from_pretrained(out, device="cpu", dtype=torch.float32)
    last = tck.load_state_dict(tck.get_last_checkpoint(args["fsdp"].output_dir))["params"]
    got = dict(pipe.model.named_parameters())
    assert got.keys() == last.keys()
    for n, p in last.items():
        torch.testing.assert_close(got[n].detach(), p, rtol=0, atol=0)


def test_batch_rows_must_divide_over_the_data_ranks():
    collator = trt.DataCollatorParlerTTSWithPadding()
    with pytest.raises(ValueError, match="not divisible by 3"):
        next(trt.data_iterator(FEATURES, collator, 8, 0, 0, process_index=0, process_count=3))
    rows = [next(trt.data_iterator(FEATURES, collator, 8, 0, 0, i, 2)) for i in range(2)]
    whole = next(trt.data_iterator(FEATURES, collator, 8, 0, 0))
    for a, b, w in zip(*rows, whole):
        np.testing.assert_array_equal(np.concatenate([a, b]), w)
