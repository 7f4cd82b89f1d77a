"""The port stands alone: every module of `parler_tts_tpu_torch`, and
`chip_smoke.py`, imports in a fresh interpreter where `jax`, `flax`,
`optax`, `orbax`, `safetensors`, `transformers`, `datasets`, `wandb`,
`gradio`, `huggingface_hub` and the JAX package `parler_tts_tpu` cannot be
imported (`sys.modules[name] = None` makes any import of them raise). A leak
then fails here on the CPU rather than on the machine with the card, which
has none of them."""

import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
BLOCKED = ("jax", "flax", "optax", "orbax", "safetensors", "transformers", "datasets", "wandb",
           "gradio", "huggingface_hub", "parler_tts_tpu")


def port_modules():
    import parler_tts_tpu_torch

    return ["parler_tts_tpu_torch"] + sorted(
        m.name for m in pkgutil.walk_packages(parler_tts_tpu_torch.__path__,
                                              "parler_tts_tpu_torch."))


@pytest.mark.parametrize("target", ["package", "chip_smoke"])
def test_imports_without_jax(target):
    modules = port_modules() if target == "package" else ["chip_smoke"]
    code = "\n".join([
        "import importlib, sys",
        f"for name in {BLOCKED!r}:",
        "    sys.modules[name] = None",
        f"for module in {modules!r}:",
        "    importlib.import_module(module)",
        f"leaked = [m for m in sys.modules if m.split('.')[0] in {BLOCKED!r} "
        "and sys.modules[m] is not None]",
        "assert not leaked, leaked",
        "print(len(sys.modules))",
    ])
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert len(modules) > (10 if target == "package" else 0)
    if target == "package":
        assert {"parler_tts_tpu_torch.native", "parler_tts_tpu_torch.runtime.streamer",
                "parler_tts_tpu_torch.runtime.generate",
                "parler_tts_tpu_torch.runtime.speculative",
                "parler_tts_tpu_torch.codec.registry", "parler_tts_tpu_torch.codec.encodec_model",
                "parler_tts_tpu_torch.training.run_training",
                "parler_tts_tpu_torch.training.data", "parler_tts_tpu_torch.training.arguments",
                "parler_tts_tpu_torch.training.checkpoints",
                "parler_tts_tpu_torch.training.eval_metrics",
                "parler_tts_tpu_torch.utils.logging_utils",
                "parler_tts_tpu_torch.parallel.distributed", "parler_tts_tpu_torch.parallel.mesh",
                "parler_tts_tpu_torch.parallel.collectives",
                "parler_tts_tpu_torch.parallel.rows",
                *(f"parler_tts_tpu_torch.scripts.{name}" for name in (
                    "init_dummy_model", "init_dummy_model_with_encodec", "init_model_600M",
                    "init_large_model", "push_dac_to_hub", "push_trained_parler_tts_to_hub",
                    "gradio_demo"))} <= set(modules)
