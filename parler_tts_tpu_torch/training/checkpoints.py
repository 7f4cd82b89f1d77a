"""Train-state checkpoints, their rotation and resume, and the stage-1 codec
shards (port of `parler_tts_tpu/training/checkpoints.py`).

The directory names are the JAX package's, `checkpoint-{step}-epoch-{epoch}`,
and so are the codec shards, `codec-{step}.npy`. In place of Orbax, a
checkpoint holds one `train_state.pt` written by `torch.save`: the
parameters under the port's names, both AdamW moments, the step and the
schedule's count, all on the host; `torch.load(weights_only=True)` reads it
back bit for bit, and admits tensors and plain containers only.

A train state sharded over a mesh is saved full: every rank all-gathers the
parameters and moments, rank 0 writes them, and the others wait at a
barrier. Resume loads the full state and takes the rank's shards, so a
checkpoint written at one world size resumes at any other.
"""

from __future__ import annotations

import os
import re
import shutil
from typing import Any, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..parallel.collectives import barrier
from ..parallel.mesh import gather_full, local_part

CHECKPOINT_PATTERN = re.compile(r"^checkpoint-(\d+)-epoch-(\d+)$")
CODEC_PATTERN = re.compile(r"^codec-(\d+)\.npy$")
STATE_FILE = "train_state.pt"


def checkpoint_dirs(output_dir: str) -> List[str]:
    if not os.path.isdir(output_dir):
        return []
    return [d for d in os.listdir(output_dir) if CHECKPOINT_PATTERN.match(d)]


def sorted_checkpoints(output_dir: str) -> List[str]:
    """Oldest first, by step."""
    return sorted(checkpoint_dirs(output_dir),
                  key=lambda d: int(CHECKPOINT_PATTERN.match(d).group(1)))


def get_last_checkpoint(output_dir: str) -> Optional[str]:
    ckpts = sorted_checkpoints(output_dir)
    return os.path.join(output_dir, ckpts[-1]) if ckpts else None


def parse_checkpoint_name(path: str) -> Tuple[int, int]:
    m = CHECKPOINT_PATTERN.match(os.path.basename(path))
    if not m:
        raise ValueError(f"not a checkpoint dir: {path}")
    return int(m.group(1)), int(m.group(2))


def rotate_checkpoints(output_dir: str, save_total_limit: Optional[int]) -> None:
    """Delete the oldest checkpoints beyond `save_total_limit` (None or <= 0
    keeps them all)."""
    if not save_total_limit or save_total_limit <= 0:
        return
    ckpts = sorted_checkpoints(output_dir)
    for d in ckpts[: max(0, len(ckpts) - save_total_limit)]:
        shutil.rmtree(os.path.join(output_dir, d), ignore_errors=True)


def save_train_state(state, output_dir: str, step: int, epoch: int,
                     save_total_limit: Optional[int] = None) -> str:
    """Write `state` (`train_state.TrainState`) to
    `output_dir/checkpoint-{step}-epoch-{epoch}/train_state.pt`, then rotate.
    A sharded state is gathered full and written by rank 0 (every rank
    calls this). Returns the checkpoint's directory."""
    path = os.path.abspath(os.path.join(output_dir, f"checkpoint-{step}-epoch-{epoch}"))
    model, opt = state.model, state.opt_state
    specs = getattr(model, "shard_specs", None)

    def host(tensors):
        if specs is None:
            return {n: t.detach().cpu() for n, t in tensors}
        return {n: gather_full(t.detach(), specs[n], model.mesh).cpu() for n, t in tensors}

    saved = {
        "step": int(state.step),
        "count": int(opt.count),
        "params": host(model.named_parameters()),
        "mu": host(opt.mu.items()),
        "nu": host(opt.nu.items()),
    }
    if specs is None or dist.get_rank() == 0:
        if os.path.exists(path):
            shutil.rmtree(path)
        os.makedirs(path)
        torch.save(saved, os.path.join(path, STATE_FILE))
        rotate_checkpoints(output_dir, save_total_limit)
    if specs is not None:
        barrier()
    return path


def load_state_dict(path: str) -> dict:
    """A checkpoint's saved dict (tensors on the host)."""
    return torch.load(os.path.join(path, STATE_FILE), map_location="cpu", weights_only=True)


def restore_train_state(path: str, state) -> Any:
    """Copy a checkpoint written by `save_train_state` into `state` (its
    model's parameters, its moments, its step and schedule count), on their
    devices and in their dtypes, which must be the saved ones. Every saved
    tensor must have a place and every place a tensor. A sharded state takes
    its shards of the full saved tensors. Returns `state`."""
    saved = load_state_dict(path)
    opt = state.opt_state
    specs, mesh = getattr(state.model, "shard_specs", None), getattr(state.model, "mesh", None)
    with torch.no_grad():
        for key, target in (("params", dict(state.model.named_parameters())),
                            ("mu", opt.mu), ("nu", opt.nu)):
            if saved[key].keys() != target.keys():
                raise KeyError(f"{path}: {key} names differ from the train state's: "
                               f"{sorted(set(saved[key]) ^ set(target))[:5]}")
            for name, t in target.items():
                src = saved[key][name]
                if specs is not None:
                    src = local_part(src, specs[name], mesh)
                if src.shape != t.shape or src.dtype != t.dtype:
                    raise ValueError(f"{path}: {key} {name} is {src.dtype} {tuple(src.shape)}, "
                                     f"the train state's {t.dtype} {tuple(t.shape)}")
                t.copy_(src)
    state.step, opt.count = saved["step"], saved["count"]
    return state


# ------------------------------------------------ codec-label stage shards
def save_codec_checkpoint(output_dir: str, data: List[np.ndarray], step: int) -> None:
    """Resumable stage-1 shards: `codec-{step}.npy`, an object array of the
    labels written since the last shard. Each label is its own element,
    also when all have one shape."""
    os.makedirs(output_dir, exist_ok=True)
    arr = np.empty(len(data), dtype=object)
    for i, x in enumerate(data):
        arr[i] = np.asarray(x)
    np.save(os.path.join(output_dir, f"codec-{step}.npy"), arr, allow_pickle=True)


def load_all_codec_checkpoints(output_dir: str) -> List[np.ndarray]:
    """Every shard's labels, in step order, each as an array (also from a
    shard whose labels were stacked into one array when written)."""
    files = sorted((f for f in os.listdir(output_dir) if CODEC_PATTERN.match(f)),
                   key=lambda f: int(CODEC_PATTERN.match(f).group(1)))
    out: List[np.ndarray] = []
    for f in files:
        for x in np.load(os.path.join(output_dir, f), allow_pickle=True):
            x = np.asarray(x)
            out.append(np.array(x.tolist()) if x.dtype == object else x)
    return out


def get_last_codec_checkpoint_step(output_dir: str) -> int:
    if not os.path.isdir(output_dir):
        return 0
    steps = [int(m.group(1)) for f in os.listdir(output_dir) if (m := CODEC_PATTERN.match(f))]
    return max(steps) if steps else 0
