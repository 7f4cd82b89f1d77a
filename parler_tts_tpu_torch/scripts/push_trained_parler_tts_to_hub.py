"""Export a trained checkpoint to the HF layout (port of
`helpers/push_to_hub_scripts/push_trained_parler_tts_to_hub.py`):

    python -m parler_tts_tpu_torch.scripts.push_trained_parler_tts_to_hub \\
        CHECKPOINT CONFIG_JSON OUT_DIR [--push-to REPO] [--device cuda]

CHECKPOINT is a params `.pkl` (the flax-named numpy tree: `params.pkl` of a
native checkpoint, read by the pipeline's numpy-only unpickler) or the
port's train state: a `checkpoint-{step}-epoch-{epoch}` directory, or a
run's output directory, whose last checkpoint is taken. CONFIG_JSON is the
`config.json` that `ParlerTTSConfig.to_json` writes.

OUT_DIR gets the files `training/run_training.py:export_and_push` writes:
`model.safetensors` (the reference's tensor names, per-codebook embeddings
and heads, torch (out, in) weights), `config.json`, and the codec's
`dac_params.pkl` copied from beside CONFIG_JSON; `from_pretrained` loads the
directory. Without a `dac_params.pkl` there, the export holds no codec, and
the script says so. (The JAX script writes only the tensors, which neither
package's `from_pretrained` can load.) `--push-to` uploads the directory; a
failed push is logged and skipped.
"""

from __future__ import annotations

import argparse
import os
import shutil
from typing import Any, Dict

from ..config import ParlerTTSConfig
from ..convert import as_tensor, to_jax_tree
from ..runtime.checkpoint import write_safetensors
from ..runtime.generate import resolve_device
from ..runtime.pipeline import load_pickle
from ..training.checkpoints import STATE_FILE, get_last_checkpoint, load_state_dict
from ..utils.hf_export import export_composite_to_hf_tensors, push_folder


def read_params(checkpoint: str) -> Dict[str, Any]:
    """The flax-named parameter tree of a params `.pkl` or of the port's
    train-state checkpoint (a checkpoint directory or a run's output
    directory)."""
    if checkpoint.endswith(".pkl"):
        return load_pickle(checkpoint)
    path = (checkpoint if os.path.exists(os.path.join(checkpoint, STATE_FILE))
            else get_last_checkpoint(checkpoint))
    if path is None:
        raise SystemExit(f"{checkpoint}: not a params .pkl, and no {STATE_FILE} or "
                         "checkpoint-* directory there")
    return to_jax_tree(load_state_dict(path)["params"].items())


def _to(tree, dev):
    return {k: _to(v, dev) if isinstance(v, dict) else as_tensor(v).to(dev)
            for k, v in tree.items()}


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("checkpoint_dir", type=str,
                        help="params .pkl, or a train-state checkpoint directory")
    parser.add_argument("config_json", type=str, help="framework config.json")
    parser.add_argument("output_dir", type=str)
    parser.add_argument("--push-to", type=str, default=None, help="hub repo id")
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)

    dev = resolve_device(args.device)
    with open(args.config_json) as f:
        cfg = ParlerTTSConfig.from_json(f.read())
    params = _to(read_params(args.checkpoint_dir), dev)
    tensors = {name: t.contiguous() for name, t in
               export_composite_to_hf_tensors(params, cfg).items()}
    os.makedirs(args.output_dir, exist_ok=True)
    write_safetensors(os.path.join(args.output_dir, "model.safetensors"), tensors)
    with open(os.path.join(args.output_dir, "config.json"), "w") as f:
        f.write(cfg.to_json())
    codec = os.path.join(os.path.dirname(os.path.abspath(args.config_json)), "dac_params.pkl")
    if os.path.exists(codec):
        shutil.copyfile(codec, os.path.join(args.output_dir, "dac_params.pkl"))
    else:
        print(f"no dac_params.pkl beside {args.config_json}: the export holds no codec, "
              "and from_pretrained cannot load it until one is put there")
    if args.push_to:
        push_folder(args.output_dir, args.push_to)
    print(f"exported to {args.output_dir}")
    return tensors


if __name__ == "__main__":
    main()
