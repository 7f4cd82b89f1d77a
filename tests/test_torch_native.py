"""The port's native audio runtime (`parler_tts_tpu_torch/native`, g++ and
ctypes) against its numpy versions and the JAX package's, after
`tests/test_native_runtime.py`: the build, float -> PCM16, WAV files, the
delayed training labels, and the bounded, thread-safe ring buffer."""

import threading
import wave

import numpy as np
import pytest
import torch

from parler_tts_tpu.native import build_delayed_labels as jax_build_delayed_labels
from parler_tts_tpu.native import float_to_pcm16 as jax_float_to_pcm16
from parler_tts_tpu_torch import native
from parler_tts_tpu_torch.ops.delay_pattern import build_delay_pattern_mask


def test_native_library_builds_into_the_package_build_directory():
    lib = native.get_native()
    assert native.library_path().is_file()
    assert lib.ring_size.restype is not None


def test_a_failed_build_raises(monkeypatch, tmp_path):
    """No numpy fallback: a source that does not compile raises g++'s output."""
    bad = tmp_path / "audio_runtime.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "BUILD", tmp_path / "build")
    native.get_native.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
            native.get_native()
    finally:
        native.get_native.cache_clear()


def test_float_to_pcm16_matches_numpy_and_the_jax_package():
    rng = np.random.default_rng(0)
    x = (rng.normal(size=4096) * 0.8).astype(np.float32)
    x[:4] = [-2.0, 2.0, -1.0, 1.0]  # clamp cases
    got = native.float_to_pcm16(x)
    assert got == native.float_to_pcm16_plain(x) == jax_float_to_pcm16(x)
    assert native.float_to_pcm16(np.zeros(0, np.float32)) == b""


def test_write_wav_roundtrip(tmp_path):
    rng = np.random.default_rng(1)
    x = (rng.normal(size=2048) * 0.5).astype(np.float32)
    path = str(tmp_path / "out.wav")
    assert native.write_wav(path, 44100, x) == 2048
    with wave.open(path, "rb") as w:
        assert (w.getframerate(), w.getnchannels(), w.getsampwidth()) == (44100, 1, 2)
        data = w.readframes(w.getnframes())
    assert data == native.float_to_pcm16_plain(x)
    with pytest.raises(OSError):
        native.write_wav(str(tmp_path / "missing" / "out.wav"), 44100, x)


def test_build_delayed_labels_matches_the_delay_pattern():
    rng = np.random.default_rng(2)
    k, t, bos, eos = 4, 11, 1025, 1024
    codes = rng.integers(0, 1024, size=(k, t)).astype(np.int32)
    labels = native.build_delayed_labels(codes, bos, eos)
    assert labels.shape == (t + 1 + k, k) and labels.dtype == np.int32
    np.testing.assert_array_equal(labels, native.build_delayed_labels_plain(codes, bos, eos))
    np.testing.assert_array_equal(labels, jax_build_delayed_labels(codes, bos, eos))
    start = torch.cat([torch.full((1, k, 1), bos), torch.from_numpy(codes).long()[None]], -1)
    _, pattern = build_delay_pattern_mask(start, bos, eos, t + 1 + k)
    np.testing.assert_array_equal(labels, torch.where(pattern == -1, eos, pattern)[0].T.numpy())


def test_ring_buffer_bounded_and_ordered():
    rb = native.make_ring_buffer(16)
    assert rb.push(b"abcdefgh") == 8
    assert rb.push(b"ijklmnopXYZ") == 8  # capacity bound: only 8 more fit
    assert rb.size() == 16
    assert rb.pop(4) == b"abcd"
    assert rb.push(b"1234") == 4
    assert rb.pop(100) == b"efghijklmnop1234"
    assert rb.size() == 0 and rb.pop(10) == b""
    with pytest.raises(ValueError):
        native.make_ring_buffer(0)


def test_ring_buffer_threaded():
    rb = native.make_ring_buffer(1 << 12)
    payload = bytes(range(256)) * 256

    def producer():
        sent = 0
        while sent < len(payload):
            sent += rb.push(payload[sent:sent + 3000])

    thread = threading.Thread(target=producer)
    thread.start()
    got = bytearray()
    while len(got) < len(payload):
        got.extend(rb.pop(4096))
    thread.join(timeout=60)
    assert not thread.is_alive() and bytes(got) == payload
