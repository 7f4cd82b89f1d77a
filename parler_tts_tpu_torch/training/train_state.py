"""The train step (port of `parler_tts_tpu/training/train_state.py`), on one
device or over a mesh of ranks (`parallel/mesh.py`).

The optimizer reproduces the JAX package's optax chain, not torch's
defaults:
  * `clip_by_global_norm(max_norm)`: the trained gradients are scaled by
    max_norm / norm when their global norm reaches max_norm (no epsilon);
  * AdamW: moments mu, nu; bias correction by the incremented count, fp32's
    1 - b^count as optax computes it;
    update mu_hat / (sqrt(nu_hat) + eps) plus weight_decay x param
    (decoupled), times -lr; every parameter decays;
  * `mu_dtype=torch.bfloat16` keeps the first moment in bf16, in optax's
    order: b1 x mu is taken in bf16 (b1 itself rounded to bf16, as JAX
    casts a Python scalar to the array's dtype), added in fp32 to the fp32
    (1 - b1) x g, bias-corrected and used in fp32, and stored rounded to
    bf16;
  * the learning-rate schedules of `make_optimizer`, evaluated at the count
    before the increment: with warmup, step 1 runs at lr 0;
  * with `freeze_text_encoder` the text encoder's parameters get no update
    and no moments, and the clip sees only the trained parameters, as under
    optax's `multi_transform`; the `grad_norm` metric still covers every
    gradient, the text encoder's included, as `optax.global_norm(grads)`
    does, so autograd computes them.

The loss is the reference's token-sum cross-entropy divided by the number of
codebooks and by the batch's valid-token count; `microbatch_steps=G` runs G
forward/backward passes over slices of the batch, sums their raw gradients
and divides once by the whole batch's count, which is the full-batch step up
to fp32 summation order. Dropout keys derive from the step's integer seed
(`models/layers.py:fold_in`), one per micro-batch.

Over a mesh (`make_train_step(mesh=)`, the model sharded by
`shard_train_state`) each rank is given its `data` share of the batch's
rows and, with a `seq` axis, its `seq` share of their label columns
(`parallel.mesh.local_seq_slice`, as JAX's `P("data", "seq")` cuts them);
its `model` group runs tensor parallelism and its `seq` group sequence
parallelism inside the forward (`models/parler.py:ParlerTTS.forward`):
  * the valid-token count, the loss sum and the per-codebook sums are
    all-reduced over `data` x `seq` (`mesh.batch`), so the loss divides by
    the global count, as the JAX psum does; the gradients are summed over
    `data` x `seq` (each rank's share already carries the global division),
    in buckets of one all-reduce each: the parameters are replicated over
    `seq`, and each `seq` rank holds the part of a gradient its rows give;
  * dropout masks are drawn for the global batch, each rank keeping its
    rows (and under tensor parallelism its columns), so a step at dropout
    0.1 equals the single-process step; with micro-batches each rank's
    micro-batch i holds its share of its own rows;
  * `grad_norm` and the clip see the logical global gradient: the squares
    of a leaf sharded over an axis are summed over that axis's group, a
    replicated leaf (every leaf over `seq`, once summed) is counted once;
  * FSDP (`shard_train_state(fsdp=True)`): at rest the parameters and both
    moments are 1/n_data shards on the dim `fsdp_params_shardings` picks.
    The step all-gathers the full parameters at its start, sums each
    gradient over `seq` and reduce-scatters it over `data` after the
    backward, and runs AdamW on the shards. The
    whole model is gathered at once: per-layer gathering overlapped with
    compute is not done.
"""

from __future__ import annotations

import contextlib
import functools
import math
from dataclasses import dataclass, field
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..models.layers import fold_in
from ..models.parler import ParlerTTS
from ..ops.losses import chunked_per_codebook_cross_entropy, per_codebook_cross_entropy
from ..parallel.collectives import all_gather_dim, all_reduce_sum, reduce_scatter_dim
from ..parallel.mesh import (
    fsdp_params_shardings,
    local_part,
    params_shardings,
    shard_params,
    spec_axes,
)
from ..parallel.rows import row_share

Schedule = Callable[[int], float]
ADAM_EPS = 1e-8  # optax.adamw's eps, added after the square root


class Batch(NamedTuple):
    input_ids: torch.Tensor              # (B, S_desc)
    attention_mask: torch.Tensor         # (B, S_desc)
    prompt_input_ids: torch.Tensor       # (B, S_p)
    prompt_attention_mask: torch.Tensor  # (B, S_p)
    labels: torch.Tensor                 # (B, T, K), -100 = padding


def _linear(init: float, end: float, steps: int) -> Schedule:
    """optax.linear_schedule."""
    if steps <= 0:
        return lambda count: init
    return lambda count: (init - end) * (1.0 - min(max(count, 0), steps) / steps) + end


def _join(first: Schedule, then: Schedule, boundary: int) -> Schedule:
    """optax.join_schedules with one boundary."""
    return lambda count: first(count) if count < boundary else then(count - boundary)


def _cosine(init: float, steps: int) -> Schedule:
    """optax.cosine_decay_schedule with alpha 0."""
    if steps <= 0:
        raise ValueError(f"cosine decay needs positive decay steps, got {steps}")
    return lambda count: init * 0.5 * (1.0 + math.cos(math.pi * min(count, steps) / steps))


@dataclass
class OptState:
    count: int
    mu: Dict[str, torch.Tensor]
    nu: Dict[str, torch.Tensor]


@dataclass
class AdamW:
    """clip_by_global_norm + adamw under a learning-rate schedule, with the
    text encoder optionally frozen (see the module docstring)."""

    learning_rate: Schedule
    b1: float
    b2: float
    weight_decay: float
    max_grad_norm: float
    freeze_text_encoder: bool
    mu_dtype: Optional[torch.dtype] = None

    def trains(self, name: str) -> bool:
        return not (self.freeze_text_encoder and name.split(".")[0] == "text_encoder")

    def init(self, model: torch.nn.Module) -> OptState:
        trained = {n: p for n, p in model.named_parameters() if self.trains(n)}
        return OptState(
            count=0,
            mu={n: torch.zeros_like(p, dtype=self.mu_dtype) for n, p in trained.items()},
            nu={n: torch.zeros_like(p) for n, p in trained.items()},
        )

    @torch.no_grad()
    def update(self, model: torch.nn.Module, grads: Dict[str, torch.Tensor],
               state: OptState, norm_fn=None) -> None:
        """Apply one step to the model's parameters in place. `norm_fn(names,
        tensors)` is the clip's global norm (default `global_norm`)."""
        names = list(state.mu)
        params = dict(model.named_parameters())
        p = [params[n] for n in names]
        g = [grads[n] for n in names]
        mu = [state.mu[n] for n in names]
        nu = [state.nu[n] for n in names]
        norm = global_norm(g) if norm_fn is None else norm_fn(names, g)
        clip = torch.where(norm < self.max_grad_norm, torch.ones_like(norm),
                           self.max_grad_norm / norm)
        g = torch._foreach_mul(g, clip)
        torch._foreach_mul_(nu, self.b2)
        torch._foreach_addcmul_(nu, g, g, value=1.0 - self.b2)
        lr = self.learning_rate(state.count)
        state.count += 1
        if self.mu_dtype is None:
            torch._foreach_mul_(mu, self.b1)
            torch._foreach_add_(mu, g, alpha=1.0 - self.b1)
            mu_hat = torch._foreach_div(mu, _bias_correction(self.b1, state.count))
        else:
            b1_low = torch.tensor(self.b1, dtype=self.mu_dtype).item()
            mu_hat = torch._foreach_mul(g, 1.0 - self.b1)
            for m_new, m in zip(mu_hat, mu):  # one tensor's temporaries at a time
                m_new.add_((m * b1_low).float())
            torch._foreach_copy_(mu, mu_hat)
            torch._foreach_div_(mu_hat, _bias_correction(self.b1, state.count))
        nu_hat = torch._foreach_div(nu, _bias_correction(self.b2, state.count))
        denom = torch._foreach_sqrt(nu_hat)
        torch._foreach_add_(denom, ADAM_EPS)
        upd = torch._foreach_div(mu_hat, denom)
        torch._foreach_add_(upd, p, alpha=self.weight_decay)
        torch._foreach_add_(p, upd, alpha=-lr)


def _bias_correction(decay: float, count: int) -> float:
    """optax's fp32 1 - decay^count (an integer power by squaring)."""
    power, base, n = np.float32(1.0), np.float32(decay), count
    while n:
        if n & 1:
            power = np.float32(power * base)
        base, n = np.float32(base * base), n >> 1
    return float(np.float32(1.0) - power)


def make_optimizer(
    learning_rate: float = 9.5e-4,
    schedule: str = "constant_with_warmup",
    warmup_steps: int = 20_000,
    total_steps: int = 50_000,
    b1: float = 0.9,
    b2: float = 0.99,
    weight_decay: float = 0.01,
    max_grad_norm: float = 1.0,
    freeze_text_encoder: bool = True,
    mu_dtype: Optional[torch.dtype] = None,
) -> AdamW:
    """AdamW + clip + schedule, the JAX package's defaults (the reference
    recipe's). `mu_dtype` (None or torch.bfloat16) is the first moment's
    dtype, as optax's `adamw(mu_dtype=)`; the second moment has the
    parameters' dtype."""
    warmup = _linear(0.0, learning_rate, warmup_steps)
    if schedule == "constant_with_warmup":
        lr = _join(warmup, lambda count: learning_rate, warmup_steps)
    elif schedule == "cosine":
        lr = _join(warmup, _cosine(learning_rate, total_steps - warmup_steps), warmup_steps)
    elif schedule == "linear":
        lr = _join(warmup, _linear(learning_rate, 0.0, max(total_steps - warmup_steps, 1)),
                   warmup_steps)
    else:
        raise ValueError(f"unknown schedule {schedule}")
    return AdamW(lr, b1, b2, weight_decay, max_grad_norm, freeze_text_encoder, mu_dtype)


def global_norm(tensors: List[torch.Tensor]) -> torch.Tensor:
    """optax.global_norm: sqrt of the sum of squares of every element."""
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(tensors)))


@dataclass
class TrainState:
    """The step count, the model (whose parameters are the trained state)
    and the optimizer's moments."""

    step: int
    model: ParlerTTS
    opt_state: OptState = field(repr=False)

    @classmethod
    def create(cls, model: ParlerTTS, tx: AdamW) -> "TrainState":
        """Turns on `requires_grad` for every parameter: the frozen text
        encoder's gradients are computed too, for the `grad_norm` metric."""
        model.requires_grad_(True)
        return cls(step=0, model=model, opt_state=tx.init(model))


def make_train_step(
    model: ParlerTTS,
    tx: AdamW,
    mesh=None,
    loss_chunk_size: Optional[int] = None,
    microbatch_steps: Optional[int] = None,
) -> Callable[[TrainState, Batch, int], Tuple[TrainState, Dict[str, torch.Tensor]]]:
    """`train_step(state, batch, dropout_seed) -> (state, metrics)`, updating
    the model's parameters in place. Metrics are device tensors: loss,
    grad_norm, num_items, per_codebook_loss (K,).

    `mesh`: the step over a mesh (module docstring); `batch` is this rank's
    `data` share of the global batch (and its `seq` share of the label
    columns), the metrics are the global batch's.
    `loss_chunk_size`: fuse the LM heads with the cross-entropy chunk by
    chunk over T (`ops/losses.py:chunked_per_codebook_cross_entropy`)
    instead of materialising (B, K, T, V) logits. `microbatch_steps=G`:
    gradient accumulation over G slices of the batch."""
    dcfg = model.config.decoder
    if mesh is not None and model.mesh is not mesh:
        raise ValueError("the model is not sharded on this mesh: shard_train_state first")
    specs = model.shard_specs

    def total(x: torch.Tensor) -> torch.Tensor:
        """A sum over the batch: over every `data` rank's rows and every
        `seq` rank's columns."""
        return x if mesh is None else all_reduce_sum(x, mesh.batch)

    def raw_loss(batch: Batch, key: int):
        out, dec_ids = model(*batch, deterministic=False,
                             return_hidden=loss_chunk_size is not None, dropout_key=key)
        kw = dict(bos_token_id=dcfg.bos_token_id, eos_token_id=dcfg.eos_token_id,
                  codebook_weights=dcfg.codebook_weights)
        if loss_chunk_size is not None:
            sums = chunked_per_codebook_cross_entropy(
                out, model.decoder.full_heads(), batch.labels, dec_ids,
                chunk_size=loss_chunk_size, head_dtype=model.dtype, **kw)
        else:
            sums = per_codebook_cross_entropy(out, batch.labels, dec_ids, **kw)
        sum_loss, num_items, per_cb_mean, per_cb_count = sums
        return sum_loss / dcfg.num_codebooks, num_items, per_cb_mean, per_cb_count

    def shared_rows(rows: int):
        """The row share of a forward over `rows` local rows."""
        if mesh is None:
            return contextlib.nullcontext()
        return row_share(rows * mesh.data.size, rows * mesh.data.rank)

    def train_step(state: TrainState, batch: Batch, dropout_seed: int):
        params = dict(model.named_parameters())
        for p in params.values():
            p.grad = None
        shards = _gather_fsdp(params, specs, mesh)
        g = microbatch_steps or 1
        rows = batch.input_ids.shape[0]
        if g > 1:
            if rows % g:
                raise ValueError(f"batch rows {rows} not divisible by microbatch_steps={g}")
            raw_sum = items = 0.0
            cb_sum = cb_cnt = 0.0
            for i in range(g):
                part = Batch(*(x[i * rows // g:(i + 1) * rows // g] for x in batch))
                with shared_rows(rows // g):  # remat's recompute in the backward draws too
                    raw, n, cb_mean, cb_c = raw_loss(part, fold_in(dropout_seed, "micro", i))
                    raw.backward()
                raw_sum, items = raw_sum + raw.detach(), items + n
                cb_sum, cb_cnt = cb_sum + cb_mean.detach() * cb_c, cb_cnt + cb_c
            items, raw_sum = total(items), total(raw_sum)
            denom = items.clamp_min(1.0)
            with torch.no_grad():
                for p in params.values():
                    if p.grad is not None:
                        p.grad /= denom
            loss, num_items = raw_sum / denom, items
            per_cb = total(cb_sum) / total(cb_cnt).clamp_min(1.0)
        elif mesh is None:
            raw, num_items, per_cb, _ = raw_loss(batch, dropout_seed)
            loss = raw / num_items.clamp_min(1.0)
            loss.backward()
            loss, per_cb = loss.detach(), per_cb.detach()
        else:
            with shared_rows(rows):  # remat's recompute in the backward draws too
                raw, n, cb_mean, cb_c = raw_loss(batch, dropout_seed)
                num_items = total(n)
                (raw / num_items.clamp_min(1.0)).backward()
            loss = total(raw.detach()) / num_items.clamp_min(1.0)
            per_cb = total(cb_mean.detach() * cb_c) / total(cb_c).clamp_min(1.0)
        grads = {n: p.grad if p.grad is not None else torch.zeros_like(p)
                 for n, p in params.items()}
        norm_fn = None
        if mesh is not None:
            grads = _reduce_grads(grads, specs, mesh)
            _restore_fsdp(params, shards)
            norm_fn = functools.partial(sharded_norm, specs=specs, mesh=mesh)
        grad_norm = (global_norm(list(grads.values())) if norm_fn is None
                     else norm_fn(list(grads), list(grads.values())))
        metrics = {"loss": loss, "grad_norm": grad_norm, "num_items": num_items,
                   "per_codebook_loss": per_cb}
        tx.update(model, grads, state.opt_state, norm_fn)
        state.step += 1
        return state, metrics

    return train_step


# ------------------------------------------------------------------ mesh
GRAD_BUCKET = 2 ** 26  # elements summed by one all-reduce


def _data_dim(spec) -> Optional[int]:
    axes = spec_axes(spec)
    return axes.index("data") if "data" in axes else None


def _gather_fsdp(params, specs, mesh) -> Dict[str, torch.Tensor]:
    """FSDP: swap each data-sharded parameter for its all-gathered whole
    (over `data`; the model shard stays), returning the shards."""
    shards = {}
    if mesh is None:
        return shards
    with torch.no_grad():
        for n, p in params.items():
            dim = _data_dim(specs[n])
            if dim is not None:
                shards[n] = p.data
                p.data = all_gather_dim(p.data, dim, mesh.data)
    return shards


def _restore_fsdp(params, shards) -> None:
    for n, shard in shards.items():
        params[n].data = shard


@contextlib.contextmanager
def gathered_params(model: ParlerTTS):
    """The model with its FSDP shards all-gathered over `data` inside (its
    `model` shards kept), the shards back after: the evaluation's forward
    and generation over an FSDP state. A no-op for any other model."""
    params = dict(model.named_parameters())
    shards = _gather_fsdp(params, model.shard_specs, model.mesh)
    try:
        yield model
    finally:
        _restore_fsdp(params, shards)


def _reduce_grads(grads, specs, mesh) -> Dict[str, torch.Tensor]:
    """Sum each gradient over `data` x `seq`: all-reduced over `seq` and
    reduce-scattered over `data` to the rank's shard for an FSDP leaf,
    all-reduced over both in buckets (per dtype) for the rest."""
    out = {}
    bucket: List[str] = []

    def flush():
        if not bucket:
            return
        flat = all_reduce_sum(torch.cat([grads[n].reshape(-1) for n in bucket]), mesh.batch)
        for n, part in zip(bucket, flat.split([grads[n].numel() for n in bucket])):
            out[n] = part.view_as(grads[n])
        bucket.clear()

    with torch.no_grad():
        for n, g in grads.items():
            dim = _data_dim(specs[n])
            if dim is not None:
                if mesh.seq.size > 1:
                    g = all_reduce_sum(g, mesh.seq)
                out[n] = reduce_scatter_dim(g, dim, mesh.data)
                continue
            if bucket and (grads[bucket[0]].dtype != g.dtype or sum(
                    grads[m].numel() for m in bucket) + g.numel() > GRAD_BUCKET):
                flush()
            bucket.append(n)
        flush()
    return {n: out[n] for n in grads}


def sharded_norm(names: List[str], tensors: List[torch.Tensor], specs, mesh) -> torch.Tensor:
    """`global_norm` of the logical global tree whose rank shards are
    `tensors`: the squares of the leaves sharded over an axis are summed
    over its group, a replicated leaf counted once. With every leaf whole
    it is `global_norm` itself."""
    norms = torch._foreach_norm(tensors)
    by_axes: Dict[Tuple[str, ...], List[torch.Tensor]] = {}
    for n, v in zip(names, norms):
        axes = tuple(a for a in ("data", "model")
                     if a in spec_axes(specs[n]) and mesh.axis(a).size > 1)
        by_axes.setdefault(axes, []).append(v)
    if set(by_axes) <= {()}:
        return torch.linalg.vector_norm(torch.stack(norms))
    squares = []
    for axes in sorted(by_axes):  # the same collectives in the same order on every rank
        sq = torch.stack(by_axes[axes]).square().sum()
        for a in axes:
            sq = all_reduce_sum(sq, mesh.axis(a))
        squares.append(sq)
    return torch.stack(squares).sum().sqrt()


def state_shardings(state: TrainState, mesh, fsdp: bool = False) -> Dict[str, Dict]:
    """The plan of a TrainState: the parameters' (`params_shardings`, or
    `fsdp_params_shardings` with `fsdp`), each moment its parameter's; the
    step and count are host ints."""
    plan = (fsdp_params_shardings if fsdp else params_shardings)(state.model, mesh)
    opt = state.opt_state
    return {"params": plan, "mu": {n: plan[n] for n in opt.mu},
            "nu": {n: plan[n] for n in opt.nu}}


def shard_train_state(state: TrainState, mesh, fsdp: bool = False) -> TrainState:
    """Slice a full TrainState in place to the rank's shards: the model
    (`parallel.mesh.shard_params`) and both moments by their parameter's
    plan. Returns `state`."""
    plan = state_shardings(state, mesh, fsdp)
    shard_params(state.model, mesh, fsdp)
    opt = state.opt_state
    for key in ("mu", "nu"):
        moments = getattr(opt, key)
        for n in moments:
            moments[n] = local_part(moments[n], plan[key][n], mesh).clone()
    return state
