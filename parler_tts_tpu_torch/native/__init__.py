"""The port's native host runtime (`audio_runtime.cpp`), built with g++ at
first use and bound with ctypes.

The C++ source has a plain C interface, so the build needs no Python headers;
the shared library goes into the package's `build/` (listed in `.gitignore`),
named by a hash of the source and the flags, as `ops/_cuda.py` does for the
CUDA kernels. Nothing is built at import. A failed build raises: there is no
fallback. The numpy functions `*_plain` compute the same results and are
what the tests hold the native ones against.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess

import numpy as np

from ..ops._cuda import BUILD, PACKAGE

SOURCE = PACKAGE / "native" / "audio_runtime.cpp"
GXX_FLAGS = ("-O3", "-shared", "-std=c++17", "-fPIC")

_p, _ll = ctypes.c_void_p, ctypes.c_longlong
_SIGNATURES = {
    "float_to_pcm16": ([_p, _ll, _p], None),
    "write_wav": ([ctypes.c_char_p, ctypes.c_int, _p, _ll], _ll),
    "build_delayed_labels": ([_p] + [ctypes.c_int] * 4 + [_p], None),
    "ring_create": ([_ll], _p),
    "ring_destroy": ([_p], None),
    "ring_push": ([_p, _p, _ll], _ll),
    "ring_pop": ([_p, _p, _ll], _ll),
    "ring_size": ([_p], _ll),
}


def library_path():
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(GXX_FLAGS).encode()).hexdigest()
    return BUILD / f"libaudio_runtime-{digest[:16]}.so"


@functools.lru_cache(maxsize=None)
def get_native() -> ctypes.CDLL:
    """The loaded library, compiled first if needed; raises if g++ fails."""
    out = library_path()
    if not out.exists():
        gxx = shutil.which("g++")
        if gxx is None:
            raise RuntimeError("g++ not found: the native audio runtime cannot be built")
        BUILD.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        proc = subprocess.run([gxx, *GXX_FLAGS, str(SOURCE), "-o", str(tmp)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                              timeout=300)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed for {SOURCE.name}:\n{proc.stdout}")
        os.replace(tmp, out)
    lib = ctypes.CDLL(str(out))
    for name, (args, res) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = args, res
    return lib


def _f32(audio) -> np.ndarray:
    return np.ascontiguousarray(audio, dtype=np.float32).reshape(-1)


# ------------------------------------------------------------ plain versions
def float_to_pcm16_plain(audio) -> bytes:
    return (np.clip(_f32(audio), -1.0, 1.0) * 32767.0).astype(np.int16).tobytes()


def build_delayed_labels_plain(codes, bos_token_id: int, eos_token_id: int) -> np.ndarray:
    codes = np.asarray(codes, dtype=np.int32)
    k, t = codes.shape
    out = np.full((t + 1 + k, k), eos_token_id, dtype=np.int32)
    for cb in range(k):
        out[: cb + 1, cb] = bos_token_id
        out[cb + 1: cb + 1 + t, cb] = codes[cb]
    return out


# ------------------------------------------------------------ native
def float_to_pcm16(audio) -> bytes:
    """float32 in [-1, 1] -> int16 PCM bytes (clamped, scaled by 32767)."""
    src = _f32(audio)
    dst = np.empty(src.shape, np.int16)
    get_native().float_to_pcm16(src.ctypes.data, src.size, dst.ctypes.data)
    return dst.tobytes()


def write_wav(path: str, rate: int, audio) -> int:
    """Write mono 16-bit PCM WAV; returns the samples written."""
    src = _f32(audio)
    n = get_native().write_wav(os.fsencode(path), int(rate), src.ctypes.data, src.size)
    if n < 0:
        raise OSError(f"cannot write {path}")
    return int(n)


def build_delayed_labels(codes, bos_token_id: int, eos_token_id: int) -> np.ndarray:
    """Codec codes (K, T) -> labels (T+K+1, K) int32: BOS prepended,
    codebook k delayed by k, EOS after (the training labels' delay pattern)."""
    codes = np.ascontiguousarray(codes, dtype=np.int32)
    k, t = codes.shape
    out = np.empty((t + 1 + k, k), np.int32)
    get_native().build_delayed_labels(codes.ctypes.data, k, t, int(bos_token_id),
                                      int(eos_token_id), out.ctypes.data)
    return out


class RingBuffer:
    """A bounded, thread-safe byte ring in native memory: `push` copies what
    fits and returns that count, `pop(n)` returns up to n bytes."""

    def __init__(self, capacity: int):
        if capacity <= 0:
            raise ValueError("capacity must be positive")
        self._lib = get_native()
        self._ring = self._lib.ring_create(capacity)

    def push(self, data: bytes) -> int:
        return int(self._lib.ring_push(self._ring, data, len(data)))

    def pop(self, n: int) -> bytes:
        buf = ctypes.create_string_buffer(max(0, min(n, self.size())))
        got = self._lib.ring_pop(self._ring, buf, len(buf))
        return buf.raw[:got]

    def size(self) -> int:
        return int(self._lib.ring_size(self._ring))

    def __del__(self):
        ring, self._ring = getattr(self, "_ring", None), None
        if ring:
            self._lib.ring_destroy(ring)


def make_ring_buffer(capacity: int) -> RingBuffer:
    return RingBuffer(capacity)
