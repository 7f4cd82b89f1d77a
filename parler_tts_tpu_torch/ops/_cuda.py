"""Build the port's CUDA sources with `nvcc` and load them with `ctypes`.

Each `csrc/<name>.cu` has a plain C interface and includes no PyTorch header,
so `nvcc` compiles it in seconds (a source that includes PyTorch's headers
takes minutes through `torch.utils.cpp_extension`). The shared library goes
into `build/` inside the package (listed in `.gitignore`), named by a hash of
the source and the flags, so an edited source is rebuilt and an unchanged one
is reused. Nothing is built at import: the first launch builds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict

PACKAGE = Path(__file__).resolve().parent.parent
CSRC = PACKAGE / "csrc"
BUILD = PACKAGE / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers, shared memory and spills of each kernel
)

_loaded: Dict[str, ctypes.CDLL] = {}


def find_nvcc() -> str:
    """`nvcc` from CUDA_HOME, /usr/local/cuda or the PATH."""
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root:
            cand = Path(root) / "bin" / "nvcc"
            if cand.is_file():
                return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on the PATH)")
    return found


def library_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD / f"lib{name}-{digest[:16]}.so"


def build(name: str) -> str:
    """Compile `csrc/<name>.cu` unless its library exists. Returns the
    compiler's output ("" when nothing was built); raises with it if the
    compile fails."""
    out = library_path(name)
    if out.exists():
        return ""
    BUILD.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}:\n{proc.stdout}")
    os.replace(tmp, out)
    return proc.stdout


def load(name: str) -> ctypes.CDLL:
    """The loaded library of `csrc/<name>.cu`, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        build(name)
        lib = _loaded[name] = ctypes.CDLL(str(library_path(name)))
    return lib
