"""PyTorch/CUDA port of the Parler-TTS serving path for NVIDIA Hopper.

A second package beside the JAX reference `parler_tts_tpu`: same module
layout and names, PyTorch only (torch, numpy and the standard library; no
jax, flax, safetensors or transformers). Decode attention runs through a
hand-written CUDA kernel (`csrc/flash_decode.cu`), built with `nvcc` at first
use and bound with `ctypes`.

Entry points take an explicit `device` and default to `cuda`; without a GPU
they raise unless the caller passes `device="cpu"`.
"""

__version__ = "0.1.0"
