"""The training CLI's host side in the port against the JAX package, on the
CPU: argument parsing (from JSON and from flags, field for field) and
`dump_args`, both collators (arrays equal), `length_grouped_order`,
`convert_dataset_str_to_list`, `build_labels_from_codes` (equal, dtype
too), checkpoint names and rotation, the stage-1 codec shards (readable by
both packages), `data_iterator`'s batches, the native WER, the logging
helpers, and `main` with `preprocessing_only` + `save_to_disk` writing the
JAX `main`'s `features.pkl` under the JAX CLI test's stand-ins (a fake
dataset and a one-id-per-character tokenizer). Everything here is exact.
"""

import dataclasses
import json
import logging
import os
import pickle
import sys

import numpy as np
import pytest
import torch

from parler_tts_tpu.config import DACConfig as JDACConfig
from parler_tts_tpu.runtime.pipeline import ParlerTTSPipeline as JPipeline
from parler_tts_tpu.training import arguments as ja
from parler_tts_tpu.training import checkpoints as jck
from parler_tts_tpu.training import data as jd
from parler_tts_tpu.training import eval_metrics as jm
from parler_tts_tpu.training import run_training as jrt
from parler_tts_tpu.utils import logging_utils as jlog
from parler_tts_tpu_torch.training import arguments as ta
from parler_tts_tpu_torch.training import checkpoints as tck
from parler_tts_tpu_torch.training import data as td
from parler_tts_tpu_torch.training import eval_metrics as tm
from parler_tts_tpu_torch.training import run_training as trt
from parler_tts_tpu_torch.utils import logging_utils as tlog
from test_training_cli import SR, FakeDataset, FakeTokenizer, _rows
from test_training_step import PAD, tiny_config


def batches_equal(got, want):
    assert type(got).__name__ == type(want).__name__
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
        assert np.asarray(g).dtype == np.asarray(w).dtype


# -------------------------------------------------------------- arguments
def test_parse_args_from_json_and_flags_match_jax(tmp_path):
    blob = {"learning_rate": 0.001, "train_dataset_name": "x", "freeze_text_encoder": False,
            "output_dir": str(tmp_path), "max_steps": 6, "adam_mu_dtype": "bfloat16",
            "codebook_weights": [1.0, 2.0], "eval_generation_steps": 3, "unknown": 1}
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps(blob))
    flags = ["--learning_rate", "0.01", "--num_train_epochs", "2", "--freeze_text_encoder",
             "true", "--max_length=24", "--group_by_length", "yes", "--save_total_limit", "1",
             "--noise_level_to_compute_clean_wer", "30", "--attention_impl", "pallas_flash",
             "--eval_dataset_name", "e", "--do_eval", "0"]
    for argv in ([str(path)], flags):
        got, want = ta.parse_args(argv), ja.parse_args(argv)
        for g, w in zip(got, want):
            assert dataclasses.asdict(g) == dataclasses.asdict(w)
    assert [f.name for f in dataclasses.fields(ta.TrainingArguments)] == [
        f.name for f in dataclasses.fields(ja.TrainingArguments)]
    with pytest.raises(ValueError, match="unexpected"):
        ta.parse_args(["positional"])


def test_list_flags_parse_in_the_port(tmp_path):
    """`--codebook_weights 1,2` (F3 of ROADMAP queue 3): the port reads the
    list; the JAX package tests "float" before "List[float]" in the
    annotation and raises ValueError on it."""
    argv = ["--codebook_weights", "1,2,0.5"]
    assert ta.parse_args(argv)[2].codebook_weights == [1.0, 2.0, 0.5]
    with pytest.raises(ValueError):
        ja.parse_args(argv)


def test_dump_args_matches_jax(tmp_path):
    args = ta.parse_args(["--learning_rate", "0.02", "--train_dataset_name", "a+b"])
    ta.dump_args(*args, str(tmp_path / "port.json"))
    ja.dump_args(*ja.parse_args(["--learning_rate", "0.02", "--train_dataset_name", "a+b"]),
                 str(tmp_path / "jax.json"))
    assert json.loads((tmp_path / "port.json").read_text()) == json.loads(
        (tmp_path / "jax.json").read_text())
    assert ta.parse_args([str(tmp_path / "port.json")]) == args


# -------------------------------------------------------------- collators
def features(n=7, seed=0, k=4):
    rng = np.random.default_rng(seed)
    return [{"labels": rng.integers(0, PAD, size=(int(t), k)),
             "input_ids": list(rng.integers(0, 120, size=int(rng.integers(3, 19)))),
             "prompt_input_ids": list(rng.integers(0, 256, size=int(rng.integers(1, 9))))}
            for t in rng.integers(5, 40, size=n)]


@pytest.mark.parametrize("kw", [
    dict(), dict(prompt_padding_side="right", pad_token_id=3, prompt_pad_token_id=5),
    dict(audio_max_length=48, token_bucket=8), dict(label_bucket=16, max_total_length=40),
])
def test_parler_collator_matches_jax(kw, caplog):
    feats = features()
    got = td.DataCollatorParlerTTSWithPadding(**kw)(feats)
    want = jd.DataCollatorParlerTTSWithPadding(**kw)(feats)
    batches_equal(got, want)
    assert isinstance(got.labels, np.ndarray)


def test_encodec_collator_matches_jax():
    feats = [{"audio": {"array": np.random.default_rng(i).normal(size=n).astype(np.float32)}}
             for i, n in enumerate((5000, 7000, 17000))]
    kw = dict(sampling_rate=16000, hop_length=320, max_length_seconds=1.0, bucket_seconds=0.5)
    got = td.DataCollatorEncodecWithPadding(**kw)(feats)
    want = jd.DataCollatorEncodecWithPadding(**kw)(feats)
    assert got.keys() == want.keys()
    for key in got:
        np.testing.assert_array_equal(got[key], want[key])
        assert got[key].dtype == want[key].dtype


def test_length_grouped_order_and_dataset_specs_match_jax():
    lengths = np.random.default_rng(3).integers(1, 100, size=230)
    for bs, seed, mult in ((4, 0, 50), (3, 7, 2), (5, 11, 1)):
        np.testing.assert_array_equal(td.length_grouped_order(lengths, bs, seed, mult),
                                      jd.length_grouped_order(lengths, bs, seed, mult))
    args = ("a+b", "c1+c2")
    kw = dict(metadata_dataset_names="m1+m2", splits="train+test", dataset_samples="3+1")
    assert td.convert_dataset_str_to_list(*args, **kw) == jd.convert_dataset_str_to_list(
        *args, **kw)
    assert td.convert_dataset_str_to_list("a", "") == jd.convert_dataset_str_to_list("a", "")
    for bad in (("a+b", "c1"), ("a", "c", "m1+m2")):
        for fn in (td.convert_dataset_str_to_list, jd.convert_dataset_str_to_list):
            with pytest.raises(ValueError):
                fn(*bad)


def test_load_multiple_datasets_imports_datasets_lazily(monkeypatch):
    monkeypatch.setitem(sys.modules, "datasets", None)
    for fn in (td.load_multiple_datasets, jd.load_multiple_datasets):
        with pytest.raises(ImportError):
            fn([{"name": "x", "config": None, "split": "train"}], 16000)


@pytest.mark.parametrize("k,t,max_length", [(3, 4, 64), (4, 9, 10), (9, 20, 2580)])
def test_build_labels_from_codes_matches_jax(k, t, max_length):
    codes = np.random.default_rng(t).integers(0, PAD, size=(k, t)).astype(np.int32)
    got = trt.build_labels_from_codes(codes, PAD + 1, PAD, max_length)
    want = jrt.build_labels_from_codes(codes, PAD + 1, PAD, max_length)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == want.dtype


@pytest.mark.parametrize("group", [False, True])
def test_data_iterator_matches_jax(group):
    feats = features(n=23, seed=4)
    coll = dict(label_bucket=8, token_bucket=8)
    got = list(trt.data_iterator(feats, td.DataCollatorParlerTTSWithPadding(**coll), 4, 5, 2,
                                 group_by_length=group))
    want = list(jrt.data_iterator(feats, jd.DataCollatorParlerTTSWithPadding(**coll), 4, 5, 2,
                                  group_by_length=group))
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        batches_equal(g, w)


# ------------------------------------------------------------- checkpoints
def test_checkpoint_names_and_rotation_match_jax(tmp_path):
    for pkg in ("port", "jax"):
        for step, epoch in [(10, 0), (20, 0), (30, 1), (40, 1), (5, 0)]:
            os.makedirs(tmp_path / pkg / f"checkpoint-{step}-epoch-{epoch}")
        os.makedirs(tmp_path / pkg / "checkpoint-x")
    port, jax_dir = str(tmp_path / "port"), str(tmp_path / "jax")
    assert tck.sorted_checkpoints(port) == jck.sorted_checkpoints(jax_dir)
    assert tck.parse_checkpoint_name(tck.get_last_checkpoint(port)) == (40, 1)
    assert tck.get_last_checkpoint(str(tmp_path / "none")) is None
    with pytest.raises(ValueError):
        tck.parse_checkpoint_name("checkpoint-x")
    for limit in (None, 0, 3, 1):
        tck.rotate_checkpoints(port, limit)
        jck.rotate_checkpoints(jax_dir, limit)
        assert tck.sorted_checkpoints(port) == jck.sorted_checkpoints(jax_dir)
    assert tck.sorted_checkpoints(port) == ["checkpoint-40-epoch-1"]


def test_codec_shards_round_trip_between_packages(tmp_path):
    """Shards of ragged labels and of one shape, written by either package,
    read back by the port as arrays equal to the labels."""
    rng = np.random.default_rng(6)
    ragged = [rng.integers(0, PAD, size=(int(t), 4)).astype(np.int32) for t in (7, 9, 8)]
    same = [rng.integers(0, PAD, size=(6, 4)).astype(np.int32) for _ in range(2)]
    tck.save_codec_checkpoint(str(tmp_path / "port"), ragged, 3)
    tck.save_codec_checkpoint(str(tmp_path / "port"), same, 5)
    jck.save_codec_checkpoint(str(tmp_path / "jax"), ragged, 3)
    jck.save_codec_checkpoint(str(tmp_path / "jax"), same, 5)  # stacked into one array
    for d in ("port", "jax"):
        assert tck.get_last_codec_checkpoint_step(str(tmp_path / d)) == 5
        got = tck.load_all_codec_checkpoints(str(tmp_path / d))
        assert len(got) == 5
        for g, w in zip(got, ragged + same):
            np.testing.assert_array_equal(g, w)
    for g, w in zip(jck.load_all_codec_checkpoints(str(tmp_path / "port")), ragged + same):
        np.testing.assert_array_equal(g, w)  # the JAX reader reads the port's shards
    # F5 (ROADMAP queue 3): the JAX reader gives its own stacked shard back as lists
    assert not isinstance(jck.load_all_codec_checkpoints(str(tmp_path / "jax"))[3], np.ndarray)
    assert tck.get_last_codec_checkpoint_step(str(tmp_path / "none")) == 0


# ----------------------------------------------------------------- metrics
def test_word_error_rate_matches_jax():
    cases = [(["a b c"], ["a b c"]), (["a x c"], ["a b c"]), (["a x c", "d"], ["a b c", "d e"]),
             (["a b c d"], ["a b c"]), ([""], ["a b"]), (["x y"], [""])]
    for pred, ref in cases:
        assert tm.word_error_rate(pred, ref) == jm.word_error_rate(pred, ref)
        assert tm._NativeWerMetric().compute(pred, ref) == tm.word_error_rate(pred, ref)


def test_metric_models_that_cannot_load_are_skipped():
    def offline():
        raise OSError("offline")

    def broken():
        raise RuntimeError("a bug")

    assert tm._load_model_or_skip("m", offline) is None
    with pytest.raises(RuntimeError):
        tm._load_model_or_skip("m", broken)
    assert tm._load_model_or_skip("m", lambda: 3) == 3


# ----------------------------------------------------------------- logging
class Tracker:
    def __init__(self):
        self.logged = []

    def log(self, payload, step):
        self.logged.append((payload, step))


def test_logging_helpers_match_jax(tmp_path, monkeypatch):
    metrics = {"loss": torch.tensor(1.5), "per_codebook_loss": torch.tensor([1.0, 2.0]),
               "num_items": 7}
    got, want = Tracker(), Tracker()
    tlog.log_metric(got, metrics, 2.5, 3, 1, learning_rate=1e-3)
    jlog.log_metric(want, {k: np.asarray(v) for k, v in metrics.items()}, 2.5, 3, 1,
                    learning_rate=1e-3)
    assert got.logged == want.logged
    tlog.log_metric(None, metrics, 0.0, 1, 0, prefix="eval")  # to the logger only
    assert tlog.init_tracker("p", None, {}, report_to="none") is None
    monkeypatch.setitem(sys.modules, "wandb", None)
    assert tlog.init_tracker("p", None, {}) is None
    tlog.log_pred(Tracker(), ["d"], ["p"], ["t"], [np.zeros(4)], 16000, 1)  # no wandb: nothing
    timer = tlog.PhaseTimer()
    for _ in range(2):
        with timer.phase("train"):
            pass
    assert set(timer.totals) == {"train"} and timer.totals["train"] >= 0
    with tlog.profile_trace(str(tmp_path / "trace")):
        torch.ones(8) @ torch.ones(8)
    assert os.listdir(tmp_path / "trace")
    with tlog.profile_trace(None):
        pass


# ---------------------------------------------------- main, preprocessing only
def test_main_preprocessing_writes_the_jax_features(tmp_path, monkeypatch, caplog):
    """`main` with `preprocessing_only` and `save_to_disk` on the JAX CLI
    test's stand-ins: the same `features.pkl` (labels, ids, texts) as the
    JAX `main`, two rows filtered (one too short, one whose description is
    too long); the port reads the JAX-written checkpoint and encodes with
    its codec. Without tokenizers the port's `main` raises."""
    import transformers

    cfg = dataclasses.replace(tiny_config(), audio_encoder=JDACConfig(
        num_codebooks=4, codebook_size=PAD, codebook_dim=4, latent_dim=32, encoder_dim=4,
        encoder_rates=(2, 4), decoder_dim=32, decoder_rates=(4, 2), sampling_rate=SR,
        frame_rate=1000))
    ckpt = tmp_path / "init_ckpt"
    JPipeline.from_random(cfg, seed=0).save_pretrained(str(ckpt))
    rows = _rows()
    monkeypatch.setattr(jd, "load_multiple_datasets",
                        lambda specs, sampling_rate, **kw: FakeDataset(rows))
    monkeypatch.setattr(td, "load_multiple_datasets",
                        lambda specs, sampling_rate, **kw: FakeDataset(rows))
    monkeypatch.setattr(transformers.AutoTokenizer, "from_pretrained",
                        classmethod(lambda cls, *a, **k: FakeTokenizer()))

    def argv(name):
        return ["--model_name_or_path", str(ckpt), "--train_dataset_name", "fake/train",
                "--train_dataset_config_name", "default", "--min_duration_in_seconds", "0.01",
                "--max_duration_in_seconds", "0.05", "--max_description_token_length", "50",
                "--preprocessing_only", "true", "--save_to_disk", str(tmp_path / name),
                "--output_dir", str(tmp_path / "out"), "--do_eval", "false",
                "--max_length", "24", "--report_to", "none",
                "--audio_encoder_per_device_batch_size", "4"]

    with pytest.raises(ValueError, match="tokenizers"):
        trt.main(argv("port"), device="cpu")
    jrt.main(argv("jax"))
    with caplog.at_level(logging.INFO):
        trt.main(argv("port"), tokenizers=(FakeTokenizer(), FakeTokenizer()), device="cpu")
    assert "(1 filtered by duration, 1 by text/token length)" in caplog.text
    blobs = {}
    for name in ("port", "jax"):
        with open(tmp_path / name / "features.pkl", "rb") as f:
            blobs[name] = pickle.load(f)
    got, want = blobs["port"]["train"], blobs["jax"]["train"]
    assert blobs["port"]["eval"] is None and blobs["jax"]["eval"] is None
    assert len(got) == len(want) == 20
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for key in g:
            np.testing.assert_array_equal(np.asarray(g[key]), np.asarray(w[key]))
        assert g["labels"].dtype == np.asarray(w["labels"]).dtype
