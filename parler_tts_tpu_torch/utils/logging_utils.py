"""Metrics and observability of the trainer (port of
`parler_tts_tpu/utils/logging_utils.py`): scalar logging with train/eval
prefixes, a wandb table of transcriptions and audio clips, profiler traces
over `torch.profiler`, and per-phase wall-clock totals.

`wandb` is imported inside the functions that use it, as in the JAX package:
without it `init_tracker` logs a warning and the metrics go to the logger
(stdout) only, and `log_pred` does nothing.
"""

from __future__ import annotations

import contextlib
import logging
import time
from typing import Dict, List, Optional

logger = logging.getLogger("parler_tts_tpu_torch")


def log_metric(
    tracker,
    metrics: Dict,
    train_time: float,
    step: int,
    epoch: int,
    learning_rate: Optional[float] = None,
    prefix: str = "train",
) -> None:
    """Scalars under `{prefix}/{name}`; a vector metric (per-codebook losses)
    as one scalar per codebook, `{prefix}/codebook_{i}_{name}`. Tensors are
    read to the host here."""
    log_metrics = {}
    for k, v in metrics.items():
        if hasattr(v, "shape") and getattr(v, "ndim", 0) > 0:
            for i, vi in enumerate(list(v)):
                log_metrics[f"{prefix}/codebook_{i}_{k}"] = float(vi)
        else:
            log_metrics[f"{prefix}/{k}"] = float(v)
    log_metrics[f"{prefix}/time"] = train_time
    log_metrics[f"{prefix}/epoch"] = epoch
    if learning_rate is not None:
        log_metrics[f"{prefix}/learning_rate"] = learning_rate
    if tracker is not None:
        tracker.log(log_metrics, step=step)
    logger.info("step %d: %s", step, {k: round(v, 5) for k, v in log_metrics.items()})


def log_pred(
    tracker,
    pred_descriptions: List[str],
    pred_prompts: List[str],
    transcriptions: List[str],
    audios: List,
    sampling_rate: int,
    step: int,
    prefix: str = "eval",
    num_lines: int = 20,
    max_audios: int = 100,
) -> None:
    """A wandb table of the first `num_lines` descriptions, prompts and
    transcriptions, and up to `max_audios` clips; nothing without a tracker
    or without wandb."""
    if tracker is None:
        return
    try:
        import wandb
    except ImportError:
        return
    table = wandb.Table(
        columns=["Target descriptions", "Target prompts", "Predicted transcriptions"],
        data=[[d, p, t] for d, p, t in zip(pred_descriptions[:num_lines],
                                           pred_prompts[:num_lines],
                                           transcriptions[:num_lines])],
    )
    payload = {f"{prefix}/predictions": table}
    for i, audio in enumerate(audios[:max_audios]):
        payload[f"{prefix}/audio_{i}"] = wandb.Audio(
            audio, sample_rate=sampling_rate,
            caption=pred_prompts[i] if i < len(pred_prompts) else "")
    tracker.log(payload, step=step)


def init_tracker(project: str, run_name: Optional[str], config: Dict, report_to: str = "wandb"):
    """The wandb module after `wandb.init`, or None: when `report_to` is not
    "wandb", or when wandb cannot be imported or started (a warning; the
    metrics then go to the logger only)."""
    if report_to != "wandb":
        return None
    try:
        import wandb

        wandb.init(project=project, name=run_name, config=config)
        return wandb
    except Exception:
        logger.warning("wandb unavailable; falling back to stdout logging")
        return None


# ------------------------------------------------------------------- profiling
@contextlib.contextmanager
def profile_trace(trace_dir: Optional[str]):
    """A `torch.profiler` trace of the block, CPU and (when there is one) CUDA
    activity, written to `trace_dir` as a Chrome trace (TensorBoard's
    profiler plugin reads it); no trace when `trace_dir` is empty."""
    if not trace_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(trace_dir)):
        yield


class PhaseTimer:
    """Per-phase wall-clock totals in seconds (`totals[name]`)."""

    def __init__(self):
        self.totals: Dict[str, float] = {}

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] = self.totals.get(name, 0.0) + time.perf_counter() - t0
