"""The training CLI (port of `parler_tts_tpu/training/run_training.py`), on
one device or over a mesh of processes:

  stage 1 - the corpus encoded to codec labels by the registry's codec
            (`encode_corpus_stage`), resumable through `codec-{step}.npy`
            shards, then the duration and text-length filters;
  stage 2 - the train loop over the labels (`run_training`): AdamW under an
            LR schedule with clipping (`train_state.py`), the loss divided
            by the batch's valid-token count, micro-batching, periodic
            logging, checkpoints with rotation and resume, eval loss and
            eval generation;
  export  - the last checkpoint's parameters as `model.safetensors` beside
            `config.json` and the codec's `dac_params.pkl`
            (`export_and_push`), which `ParlerTTSPipeline.from_pretrained`
            loads.

`run_training`, `main`, `encode_corpus_stage`, `run_eval` and
`run_eval_generation` run on the GPU unless the caller passes
`device="cpu"`. `attention_impl="pallas_flash"` trains through kernel K4
(`ops/flash_attention.py`), and eval generation serves through kernel K1
(`ops/flash_decode.py`); on the card each launches its kernel or raises.

Over more than one process (`torchrun --nproc_per_node N -m
parler_tts_tpu_torch.training.run_training cfg.json`, or any launcher that
sets torchrun's environment; `parallel/distributed.py`) the ranks form a
`mesh_data` x `mesh_model` mesh (`mesh_data` defaults to the world over
`mesh_model`): the global batch is per-device x (world / mesh_model) x
accumulation steps, each data rank keeps its rows of every collated batch
(`data_iterator`), `fsdp` shards the parameters and moments over `data`,
and the metrics are logged on rank 0. Every rank encodes the corpus in
stage 1, as every JAX process does; rank 0 alone writes the codec shards,
the features and the export. Checkpoints are gathered full and written by
rank 0 (`checkpoints.py`), so they resume at any world size. `run_eval`
gives the global eval loss; `run_eval_generation` gathers the FSDP
parameters or runs tensor-parallel, so every rank produces the same clips.
The arguments have no `seq` axis, as the JAX package's have none: sequence
parallelism is a library surface (`parallel.mesh.make_mesh(n_seq=)` and
`training.make_train_step(mesh=)`).

Differences from the JAX package, each a consequence of the port's scope:
  - `main` takes the description and prompt tokenizers from its caller
    (callables mapping a string to {"input_ids": [...]}); the port imports
    no tokenizer library;
  - the train state is saved with `torch.save` (`checkpoints.py`), and the
    export is written by the port's own safetensors writer; the final save
    is skipped when the last step's checkpoint was just written (the JAX
    loop writes it again).
Dropout seeds restart from `seed` in every run, resumed or not, as the JAX
loop restarts its RNG: only dropout-free runs resume to the bits of an
uninterrupted one.
"""

from __future__ import annotations

import logging
import math
import os
import pickle
import time
from typing import Any, Iterator, List, Optional, Tuple

import numpy as np
import torch

from ..config import GenerationConfig, ParlerTTSConfig
from ..convert import dac_to_jax_tree, to_jax_tree
from ..models.layers import fold_in
from ..models.parler import ParlerTTS
from ..ops.delay_pattern import build_delay_pattern_mask
from ..ops.losses import mean_loss_reference_style
from ..runtime.checkpoint import write_safetensors
from ..ops.losses import per_codebook_cross_entropy
from ..parallel import make_mesh, maybe_init_distributed
from ..parallel.collectives import all_reduce_sum, barrier
from ..parallel.distributed import host_local_to_global, local_batch_slice, rank_device
from ..parallel.mesh import check_model_axis
from ..runtime.generate import resolve_device
from ..runtime.pipeline import ParlerTTSPipeline
from ..utils.hf_export import export_composite_to_hf_tensors, push_folder
from ..utils.logging_utils import init_tracker, log_metric, log_pred
from . import data as data_mod
from .arguments import DataTrainingArguments, ModelArguments, TrainingArguments
from .checkpoints import (
    get_last_checkpoint,
    get_last_codec_checkpoint_step,
    load_all_codec_checkpoints,
    load_state_dict,
    parse_checkpoint_name,
    restore_train_state,
    save_codec_checkpoint,
    save_train_state,
)
from .data import DataCollatorParlerTTSWithPadding, length_grouped_order
from .train_state import (
    Batch,
    TrainState,
    gathered_params,
    make_optimizer,
    make_train_step,
    shard_train_state,
)

logger = logging.getLogger(__name__)

COMPUTE_DTYPES = {
    "bfloat16": torch.bfloat16, "bf16": torch.bfloat16,
    "float16": torch.float16, "fp16": torch.float16,
    "float32": torch.float32, "fp32": torch.float32,
}


def world() -> Tuple[int, int]:
    """(rank, world size) of the initialised process group, else (0, 1)."""
    if torch.distributed.is_available() and torch.distributed.is_initialized():
        return torch.distributed.get_rank(), torch.distributed.get_world_size()
    return 0, 1


def check_parallel(training_args: TrainingArguments, model: ParlerTTS, n_ranks: int) -> int:
    """What the arguments ask of the model and the mesh, refused where it
    does not train or does not fit: int8 or fused q|k|v weights (serving
    layouts, trained in neither package), heads and MLP widths that
    `mesh_model` does not divide, a mesh whose size is not the world. The
    arguments have no `seq` axis, as the JAX package's have none. Returns
    n_data."""
    if model.weight_quant or model.fused_qkv:
        raise ValueError("the trainer takes a float, unfused ParlerTTS: int8 and fused "
                         "q|k|v weights are serving layouts")
    n_model = training_args.mesh_model
    check_model_axis(model, n_model)
    n_data = training_args.mesh_data or max(n_ranks // n_model, 1)
    if n_data * n_model != n_ranks:
        raise ValueError(f"mesh {n_data}x1x{n_model} != {n_ranks} ranks")
    return n_data


def build_labels_from_codes(codes: np.ndarray, bos_token_id: int, eos_token_id: int,
                            max_length: int) -> np.ndarray:
    """Codec codes (K, T) -> int32 training labels (T', K): BOS prepended,
    the delay pattern applied, EOS where the model must predict the tail."""
    k, t = codes.shape
    ids = torch.from_numpy(np.concatenate(
        [np.full((1, k, 1), bos_token_id, np.int64), np.asarray(codes, np.int64)[None]], -1))
    _, pattern = build_delay_pattern_mask(ids, bos_token_id, eos_token_id,
                                          min(t + 1 + k, max_length))
    pattern = pattern[0].numpy()
    return np.where(pattern == -1, eos_token_id, pattern).T.astype(np.int32)


@torch.inference_mode()
def encode_corpus_stage(
    codec: torch.nn.Module,
    audio_batches: Iterator[dict],
    bos_token_id: int,
    eos_token_id: int,
    max_label_length: int,
    hop_length: int,
    save_dir: Optional[str] = None,
    save_steps: Optional[int] = 500,
    device=None,
    write: bool = True,
) -> List[np.ndarray]:
    """Stage 1: each batch of `DataCollatorEncodecWithPadding` through the
    codec's encode on `device` (the codec is moved there), each clip's first
    ceil(len / hop) frames made into labels. With `save_dir`, every
    `save_steps` batches the new labels go to a `codec-{step}.npy` shard
    (unless `write` is False: the ranks but one of a multi-process run), and
    a run resumes after the last shard."""
    dev = resolve_device(device)
    codec = codec.to(dev).eval()
    start_step = get_last_codec_checkpoint_step(save_dir) if save_dir else 0
    labels: List[np.ndarray] = (load_all_codec_checkpoints(save_dir)
                                if save_dir and start_step else [])
    pending: List[np.ndarray] = []
    for step, batch in enumerate(audio_batches):
        if step < start_step:
            continue
        audio = torch.from_numpy(np.asarray(batch["input_values"])).to(dev).transpose(1, 2)
        codes = codec.encode(audio).cpu().numpy()  # (B, K, T')
        for i, n_audio in enumerate(np.asarray(batch["len_audio"])):
            n = int(math.ceil(n_audio / hop_length))
            pending.append(build_labels_from_codes(codes[i, :, :n], bos_token_id,
                                                   eos_token_id, max_label_length))
        if save_dir and save_steps and (step + 1) % save_steps == 0:
            if write:
                save_codec_checkpoint(save_dir, pending, step + 1)
            labels.extend(pending)
            pending = []
    labels.extend(pending)
    return labels


def data_iterator(features: List[dict], collator, batch_size: int, seed: int, epoch: int,
                  process_index: int = 0, process_count: int = 1,
                  group_by_length: bool = False):
    """The epoch's batches, collated on the host: a `default_rng(seed +
    epoch)` permutation, or with `group_by_length` the length-grouped order
    from the same seed; a last partial batch is dropped. Every process
    collates the whole global batch (its padded shapes depend on all its
    rows, and every rank must agree on them) and keeps the rows of data
    rank `process_index` of `process_count`."""
    if group_by_length:
        order = length_grouped_order([np.asarray(f["labels"]).shape[0] for f in features],
                                     batch_size, seed + epoch)
    else:
        order = np.random.default_rng(seed + epoch).permutation(len(features))
    rows = local_batch_slice(batch_size, process_index, process_count)
    for i in range(0, len(order) - batch_size + 1, batch_size):
        batch = collator([features[j] for j in order[i: i + batch_size]])
        yield type(batch)(*(x[rows] for x in batch)) if process_count > 1 else batch


def to_device(batch: Batch, device) -> Batch:
    return Batch(*(torch.as_tensor(np.asarray(x)).to(device) for x in batch))


def _attention_route(impl: str) -> Any:
    """`attention_impl` -> the model's `use_chunked_attention`."""
    if impl == "pallas_flash":
        return "pallas"
    if impl == "chunked":
        return True
    if impl.startswith("chunked:"):
        try:
            chunk = int(impl.split(":", 1)[1])
        except ValueError:
            chunk = 0
        if chunk < 1:
            raise ValueError(f"attention_impl {impl!r}: chunk size must be a positive integer "
                             "(0 would select dense attention)")
        return chunk
    raise ValueError(f"unknown attention_impl {impl!r} "
                     "(expected 'chunked', 'chunked:N' or 'pallas_flash')")


def _reconcile(model: ParlerTTS, device, **changes) -> ParlerTTS:
    """`model`, moved to `device`, with its constructor arguments changed by
    `changes`: the model itself when nothing changes, else one built anew
    around the same parameter tensors (cast only where `param_dtype`
    changes), so that one copy of the parameters stays on the device."""
    kw = dict(dtype=model.dtype, param_dtype=model.param_dtype,
              use_chunked_attention=model.use_chunked_attention,
              remat_layers=model.remat_layers, remat_policy=model.remat_policy)
    model.to(device)
    if all(type(kw[k]) is type(v) and kw[k] == v for k, v in changes.items()):
        return model
    kw.update(changes)
    built = ParlerTTS(model.config, device=device, **kw)  # uninitialised tensors
    want = built.state_dict()
    built.load_state_dict({k: v.to(want[k].dtype) for k, v in model.state_dict().items()},
                          assign=True)
    return built


def run_training(
    model_args: ModelArguments,
    data_args: DataTrainingArguments,
    training_args: TrainingArguments,
    model: ParlerTTS,
    train_features: List[dict],
    eval_features: Optional[List[dict]] = None,
    dac: Optional[torch.nn.Module] = None,
    tokenizers=None,
    device=None,
):
    """Stage 2 over pre-tokenized features (each holds `input_ids`,
    `prompt_input_ids` and `labels` (T, K)). Trains `model`, moved to
    `device`, with fp32 parameters and `training_args.dtype` compute, and
    returns (state, step). Fp32 parameters are updated in place; others are
    trained as an fp32 copy.

    Labels of 512 frames or more turn on `attention_impl` and per-layer
    remat under `remat_policy`; shorter ones keep the model's attention.
    Resumes from `resume_from_checkpoint` or the last checkpoint in
    `output_dir`, skipping the batches already taken. With `eval_features`,
    every `eval_steps` steps runs `run_eval` and, with a codec `dac`, every
    `eval_generation_steps` (default `eval_steps`) `run_eval_generation`.

    In an initialised process group every rank calls it with the same
    arguments: the ranks form the mesh the arguments ask for
    (`check_parallel`), and each rank computes on `cuda:LOCAL_RANK` (or the
    CPU)."""
    rank, n_ranks = world()
    n_data = check_parallel(training_args, model, n_ranks)
    dev = resolve_device(rank_device(device) if n_ranks > 1 else device)
    cfg: ParlerTTSConfig = model.config
    max_t = max(np.asarray(f["labels"]).shape[0] for f in train_features)
    if training_args.remat_policy not in ("full", "dots"):
        raise ValueError(f"unknown remat_policy {training_args.remat_policy!r} "
                         "(expected 'full' or 'dots')")
    remat_policy = None if training_args.remat_policy == "full" else "dots"
    if training_args.gradient_accumulation_mode not in ("batch", "microbatch"):
        raise ValueError("unknown gradient_accumulation_mode "
                         f"{training_args.gradient_accumulation_mode!r} "
                         "(expected 'batch' or 'microbatch')")
    attn_impl = _attention_route(training_args.attention_impl)
    changes = {}
    if max_t >= 512 and not (model.use_chunked_attention and model.remat_layers):
        logger.info("enabling %s attention + per-layer remat for T=%d",
                    training_args.attention_impl, max_t)
        changes.update(use_chunked_attention=attn_impl, remat_layers=True,
                       remat_policy=remat_policy)
    else:
        if model.use_chunked_attention and model.use_chunked_attention != attn_impl:
            logger.info("applying attention_impl=%s", training_args.attention_impl)
            changes["use_chunked_attention"] = attn_impl
        if model.remat_layers and model.remat_policy != remat_policy:
            logger.info("applying remat_policy=%s", training_args.remat_policy)
            changes["remat_policy"] = remat_policy
    compute_dtype = COMPUTE_DTYPES.get(training_args.dtype)
    if compute_dtype is None:
        raise ValueError(f"unknown training dtype {training_args.dtype!r}")
    if training_args.adam_mu_dtype not in (None, "bfloat16", "bf16"):
        raise ValueError(f"unknown adam_mu_dtype {training_args.adam_mu_dtype!r} "
                         "(expected 'bfloat16' or unset; Adam's first moment is fp32 "
                         "by default)")
    model = _reconcile(model, dev, dtype=compute_dtype, param_dtype=torch.float32, **changes)

    global_bs = (training_args.per_device_train_batch_size * n_data
                 * training_args.gradient_accumulation_steps)
    steps_per_epoch = len(train_features) // global_bs
    total_steps = (training_args.max_steps if training_args.max_steps > 0
                   else int(steps_per_epoch * training_args.num_train_epochs))
    tx = make_optimizer(
        learning_rate=training_args.learning_rate,
        schedule=training_args.lr_scheduler_type,
        warmup_steps=training_args.warmup_steps,
        total_steps=total_steps,
        b1=training_args.adam_beta1,
        b2=training_args.adam_beta2,
        weight_decay=training_args.weight_decay,
        max_grad_norm=training_args.max_grad_norm,
        freeze_text_encoder=model_args.freeze_text_encoder,
        mu_dtype=torch.bfloat16 if training_args.adam_mu_dtype is not None else None,
    )
    state = TrainState.create(model, tx)

    start_step, start_epoch = 0, 0
    resume = (training_args.resume_from_checkpoint
              or get_last_checkpoint(training_args.output_dir))
    if resume:
        restore_train_state(resume, state)
        start_step, start_epoch = parse_checkpoint_name(resume)
        logger.info("resumed from %s (step %d epoch %d)", resume, start_step, start_epoch)
    mesh = None
    if torch.distributed.is_available() and torch.distributed.is_initialized():
        mesh = make_mesh(n_data, training_args.mesh_model, device=dev)
        shard_train_state(state, mesh, fsdp=training_args.fsdp)

    step_fn = make_train_step(
        model, tx, mesh=mesh, loss_chunk_size=training_args.loss_chunk_size,
        microbatch_steps=(training_args.gradient_accumulation_steps
                          if training_args.gradient_accumulation_mode == "microbatch"
                          else None),
    )
    collator = DataCollatorParlerTTSWithPadding(
        prompt_padding_side=model_args.prompt_padding_side,
        audio_max_length=model_args.max_length if data_args.pad_to_max_length else None,
        # padded prompt + frames stay within the decoder's position table
        # (the prompt takes decoder positions unless it rides cross-attention)
        max_total_length=(None if cfg.prompt_cross_attention
                          else cfg.decoder.max_position_embeddings),
    )
    tracker = init_tracker(data_args.wandb_project, data_args.wandb_run_name,
                           {"total_steps": total_steps, "global_bs": global_bs},
                           report_to=training_args.report_to) if rank == 0 else None
    data_rank = (mesh.data.rank, n_data) if mesh is not None else (0, 1)
    eval_pipe_cache: dict = {}
    step, epoch, draws, saved_at = start_step, start_epoch, 0, None
    train_start = time.perf_counter()
    for epoch in range(start_epoch, int(math.ceil(training_args.num_train_epochs))):
        it = data_iterator(train_features, collator, global_bs, training_args.seed, epoch,
                           *data_rank, group_by_length=training_args.group_by_length)
        if epoch == start_epoch and start_step > epoch * steps_per_epoch:
            for _ in range(start_step - epoch * steps_per_epoch):  # the batches taken
                next(it, None)
        for batch in it:
            if step >= total_steps:
                break
            batch = (to_device(batch, dev) if mesh is None
                     else host_local_to_global(batch, mesh))
            state, metrics = step_fn(state, batch, fold_in(training_args.seed, "step", draws))
            draws += 1
            step += 1
            if step % training_args.logging_steps == 0 and rank == 0:
                log_metric(tracker, metrics, train_time=time.perf_counter() - train_start,
                           step=step, epoch=epoch, prefix="train")
            if step % training_args.save_steps == 0:
                save_train_state(state, training_args.output_dir, step, epoch,
                                 training_args.save_total_limit)
                saved_at = step
            if eval_features and step % training_args.eval_steps == 0:
                run_eval(state, collator, eval_features, training_args, tracker, step, epoch)
                gen_every = training_args.eval_generation_steps or training_args.eval_steps
                if dac is not None and step % gen_every == 0:
                    run_eval_generation(state, dac, eval_features, model_args, training_args,
                                        tracker, step, epoch, tokenizers=tokenizers,
                                        pipe_cache=eval_pipe_cache)
        if step >= total_steps:
            break
    if saved_at != step:  # the last step's state, unless its checkpoint is just written
        save_train_state(state, training_args.output_dir, step, epoch,
                         training_args.save_total_limit)
    return state, step


def main(argv=None, tokenizers=None, device=None):
    """CLI entry: `python -m parler_tts_tpu_torch.training.run_training
    cfg.json` (or `--flag value` pairs), with `tokenizers` = (description,
    prompt) callables passed by a caller (a ValueError names the argument
    without them). Loads the checkpoint `model_name_or_path` and its codec,
    reads the datasets (`data.load_multiple_datasets`), encodes them to
    labels (stage 1), drops rows outside the duration window or over the
    text and token caps, optionally saves the features (`save_to_disk`,
    `features.pkl`) and stops (`preprocessing_only`), trains (stage 2), and
    exports `output_dir/final`.

    Under torchrun's environment (WORLD_SIZE set) it first joins the process
    group (`parallel.distributed.maybe_init_distributed`: NCCL on the GPU,
    gloo on the CPU) and runs on `cuda:LOCAL_RANK`; rank 0 alone writes the
    codec shards, the features and the export."""
    from .arguments import parse_args
    from .data import DataCollatorEncodecWithPadding, convert_dataset_str_to_list

    logging.basicConfig(level=logging.INFO)
    model_args, data_args, training_args = parse_args(argv)
    if tokenizers is None:
        raise ValueError("main needs tokenizers=(description_tokenizer, prompt_tokenizer): "
                         "the port imports no tokenizer library")
    desc_tok, prompt_tok = tokenizers
    rank, n_ranks = maybe_init_distributed(device=device)
    dev = resolve_device(rank_device(device) if n_ranks > 1 else device)

    pipe = ParlerTTSPipeline.from_pretrained(model_args.model_name_or_path, device=dev)
    cfg, codec = pipe.config, pipe.dac
    sr = cfg.audio_encoder.sampling_rate
    frame_rate = cfg.audio_encoder.frame_rate

    def prepare_split(dataset_name, config_name, split_name, metadata_name,
                      dataset_samples, max_samples, save_tag):
        """One split: load, stage-1 encode, tokenize and filter."""
        specs = convert_dataset_str_to_list(
            dataset_name, config_name, metadata_dataset_names=metadata_name,
            splits=split_name, dataset_samples=dataset_samples)
        ds = data_mod.load_multiple_datasets(
            specs, sr, id_column_name=data_args.id_column_name,
            num_proc=data_args.preprocessing_num_workers,
            streaming=data_args.streaming, seed=training_args.seed)
        if data_args.streaming:
            # an IterableDataset has no length: draw the requested rows
            if not max_samples:
                raise SystemExit("streaming=True requires max_train_samples / "
                                 "max_eval_samples to bound the draw")
            import itertools

            ds = list(itertools.islice(iter(ds), max_samples))
        elif max_samples:
            ds = ds.select(range(min(max_samples, len(ds))))

        coll = DataCollatorEncodecWithPadding(
            sampling_rate=sr, hop_length=cfg.audio_encoder.hop_length,
            audio_column_name=data_args.target_audio_column_name,
            max_length_seconds=data_args.max_duration_in_seconds)
        bs = training_args.audio_encoder_per_device_batch_size

        def audio_batches():
            for i in range(0, len(ds), bs):
                yield coll([ds[j] for j in range(i, min(i + bs, len(ds)))])

        save_dir = (os.path.join(data_args.temporary_save_to_disk, save_tag)
                    if data_args.temporary_save_to_disk else None)
        labels = encode_corpus_stage(
            codec, audio_batches(), bos_token_id=cfg.decoder.bos_token_id,
            eos_token_id=cfg.decoder.eos_token_id, max_label_length=model_args.max_length,
            hop_length=cfg.audio_encoder.hop_length, save_dir=save_dir,
            save_steps=data_args.save_codec_steps, device=dev, write=rank == 0)

        # the duration filter on codec frames; the text and token-length caps
        min_frames = data_args.min_duration_in_seconds * frame_rate
        max_frames = data_args.max_duration_in_seconds * frame_rate
        k_cb = cfg.decoder.num_codebooks
        features, n_dur, n_tok = [], 0, 0
        for i, lab in enumerate(labels):
            n_frames = lab.shape[0] - k_cb - 1  # less BOS and the delay tail
            if not (min_frames <= n_frames <= max_frames):
                n_dur += 1
                continue
            row = ds[i]
            desc_text = row[data_args.description_column_name]
            prompt_text = row[data_args.prompt_column_name]
            if len(str(desc_text)) > data_args.max_text_length:
                n_tok += 1
                continue
            desc_ids = desc_tok(desc_text)["input_ids"]
            prompt_ids = prompt_tok(prompt_text)["input_ids"]
            if (data_args.max_description_token_length
                    and len(desc_ids) > data_args.max_description_token_length):
                n_tok += 1
                continue
            if (data_args.max_prompt_token_length
                    and len(prompt_ids) > data_args.max_prompt_token_length):
                n_tok += 1
                continue
            features.append({"labels": lab, "input_ids": desc_ids,
                             "prompt_input_ids": prompt_ids,
                             "description_text": str(desc_text),
                             "prompt_text": str(prompt_text)})
        logger.info("%s: %d features (%d filtered by duration, %d by text/token length)",
                    save_tag, len(features), n_dur, n_tok)
        return features

    features = prepare_split(
        data_args.train_dataset_name, data_args.train_dataset_config_name,
        data_args.train_split_name, data_args.train_metadata_dataset_name,
        data_args.train_dataset_samples, data_args.max_train_samples, "train")
    eval_features = None
    if training_args.do_eval and data_args.eval_dataset_name:
        eval_features = prepare_split(
            data_args.eval_dataset_name,
            data_args.eval_dataset_config_name or data_args.train_dataset_config_name,
            data_args.eval_split_name, data_args.eval_metadata_dataset_name,
            None, data_args.max_eval_samples, "eval")

    if n_ranks > 1:
        barrier()  # every rank's stage 1 done before any reads the shards again
    if data_args.save_to_disk and rank == 0:
        os.makedirs(data_args.save_to_disk, exist_ok=True)
        with open(os.path.join(data_args.save_to_disk, "features.pkl"), "wb") as f:
            pickle.dump({"train": features, "eval": eval_features}, f)
    if data_args.preprocessing_only:
        logger.info("preprocessing_only: wrote %d features, exiting", len(features))
        return

    model = pipe.model  # handed over: the trainer updates these parameters in place
    del pipe
    run_training(model_args, data_args, training_args, model, features,
                 eval_features=eval_features, dac=codec, tokenizers=(desc_tok, prompt_tok),
                 device=dev)
    if rank == 0:
        export_and_push(training_args.output_dir,
                        os.path.join(training_args.output_dir, "final"), cfg, codec,
                        hub_model_id=training_args.hub_model_id if training_args.push_to_hub
                        else None)
    if n_ranks > 1:
        barrier()


def export_and_push(output_dir: str, export_dir: str, cfg: ParlerTTSConfig,
                    dac: torch.nn.Module, hub_model_id: Optional[str] = None
                    ) -> Optional[str]:
    """The last checkpoint's parameters as HF-named `model.safetensors`,
    with `config.json` (`cfg.to_json()`) and the codec's tree in
    `dac_params.pkl`, in `export_dir`; `ParlerTTSPipeline.from_pretrained`
    loads the directory. With `hub_model_id` the directory is pushed to the
    hub, a push that fails being logged and skipped. Returns `export_dir`, or
    None without a checkpoint."""
    last = get_last_checkpoint(output_dir)
    if last is None:
        logger.warning("no checkpoint found under %s; skipping export", output_dir)
        return None
    params = to_jax_tree(load_state_dict(last)["params"].items())
    tensors = {name: t.contiguous() for name, t in
               export_composite_to_hf_tensors(params, cfg).items()}
    os.makedirs(export_dir, exist_ok=True)
    write_safetensors(os.path.join(export_dir, "model.safetensors"), tensors)
    with open(os.path.join(export_dir, "config.json"), "w") as f:
        f.write(cfg.to_json())
    with open(os.path.join(export_dir, "dac_params.pkl"), "wb") as f:
        pickle.dump(dac_to_jax_tree(dac), f, protocol=4)
    if hub_model_id:
        push_folder(export_dir, hub_model_id)
    return export_dir


@torch.no_grad()
def run_eval(state: TrainState, collator, eval_features, training_args: TrainingArguments,
             tracker, step: int, epoch: int) -> Optional[float]:
    """The eval loss of `state.model` (dropout off): batches of
    `per_device_eval_batch_size` rows and a last, smaller one for the
    remainder, their mean losses weighted by row count; logged under eval/.

    Over a mesh a batch is per-device x world rows (as the JAX loop's) and
    each data rank computes its share: the per-codebook sums and counts are
    all-reduced over `data`, so every rank returns the global loss. A
    remainder is cut to a multiple of the data ranks."""
    model = state.model
    dcfg = model.config.decoder
    device = next(model.parameters()).device
    mesh = model.mesh
    losses = []  # (the batch's mean loss, its rows)

    def run_one(feats):
        batch = collator(feats)
        if mesh is not None:
            rows = local_batch_slice(len(feats), mesh.data.rank, mesh.data.size)
            batch = type(batch)(*(x[rows] for x in batch))
        batch = to_device(batch, device)
        logits, dec_in = model(*batch)
        kw = dict(bos_token_id=dcfg.bos_token_id, eos_token_id=dcfg.eos_token_id)
        if mesh is None:
            loss, _ = mean_loss_reference_style(logits, batch.labels, dec_in,
                                                codebook_weights=dcfg.codebook_weights, **kw)
        else:
            _, _, cb_mean, cb_cnt = per_codebook_cross_entropy(logits, batch.labels, dec_in,
                                                               **kw)
            cb_cnt_all = all_reduce_sum(cb_cnt, mesh.data)
            cb_mean = all_reduce_sum(cb_mean * cb_cnt, mesh.data) / cb_cnt_all.clamp_min(1.0)
            w = torch.tensor(dcfg.codebook_weights or [1.0] * cb_mean.shape[0],
                             dtype=torch.float32, device=device)
            loss = (cb_mean * w).sum() / w.sum()
        losses.append((float(loss), len(feats)))

    n_ranks = world()[1]
    div = mesh.data.size if mesh is not None else 1
    bs = training_args.per_device_eval_batch_size * n_ranks
    n_full = (len(eval_features) // bs) * bs
    with gathered_params(model):
        for i in range(0, n_full, bs):
            run_one(eval_features[i: i + bs])
        rem = (len(eval_features) - n_full) // div * div
        if rem:
            if n_full == 0:
                logger.warning("eval set (%d) smaller than the eval batch (%d); running one "
                               "remainder batch", len(eval_features), bs)
            run_one(eval_features[n_full:n_full + rem])
    if not losses:
        return None
    avg = sum(loss * n for loss, n in losses) / sum(n for _, n in losses)
    log_metric(tracker, {"loss": avg}, 0.0, step, epoch, prefix="eval")
    return avg


def run_eval_generation(state: TrainState, dac: torch.nn.Module, eval_features,
                        model_args: ModelArguments, training_args: TrainingArguments,
                        tracker, step: int, epoch: int, tokenizers=None, max_samples: int = 8,
                        pipe_cache: Optional[dict] = None) -> dict:
    """Generation from the first `max_samples` eval features through a
    `ParlerTTSPipeline` over `state.model` (the eager decode loop, kernel K1
    on the card; seed `step`), scored by WER, CLAP and SI-SDR when their
    libraries and models load, logged with the clips. `pipe_cache` keeps the
    pipeline across eval steps while it serves `state.model`.

    Over a mesh every rank generates every clip: over the gathered FSDP
    parameters, tensor-parallel inside its `model` group, so all ranks
    produce the same clips; rank 0 scores and logs them."""
    from .eval_metrics import clap_similarity, si_sdr, wer

    cfg = state.model.config
    pipe = pipe_cache.get("pipe") if pipe_cache is not None else None
    if pipe is None or pipe.model is not state.model:
        gen = GenerationConfig(
            max_length=min(model_args.max_length, 860),
            do_sample=model_args.do_sample,
            temperature=model_args.temperature,
            bos_token_id=cfg.decoder.bos_token_id,
            pad_token_id=cfg.decoder.pad_token_id,
            eos_token_id=cfg.decoder.eos_token_id,
            codebook_guard=cfg.audio_encoder.codebook_size,
        )
        pipe = ParlerTTSPipeline(state.model, dac, gen,
                                 device=next(state.model.parameters()).device)
        if pipe_cache is not None:
            pipe_cache["pipe"] = pipe

    feats = eval_features[:max_samples]
    coll = DataCollatorParlerTTSWithPadding(
        prompt_padding_side=model_args.prompt_padding_side,
        max_total_length=(None if cfg.prompt_cross_attention
                          else cfg.decoder.max_position_embeddings))
    batch = coll(feats)
    with gathered_params(state.model):
        audios, lengths = pipe.generate(batch.input_ids, batch.prompt_input_ids,
                                        desc_mask=batch.attention_mask,
                                        prompt_mask=batch.prompt_attention_mask, seed=step)
    clips = [np.asarray(audios[i, : lengths[i]]) for i in range(len(feats))]
    sr = cfg.audio_encoder.sampling_rate
    if world()[0] != 0:
        return {}

    metrics = {}
    descriptions = [f.get("description_text", "") for f in feats]
    prompts = [f.get("prompt_text", "") for f in feats]
    if any(descriptions) and training_args.compute_clap_similarity_metric:
        clap = clap_similarity(model_args.clap_model_name_or_path, descriptions, clips, sr)
        if clap is not None:
            metrics["clap"] = clap
    sdr = si_sdr(clips, sr) if training_args.compute_noise_level_metric else None
    if sdr is not None:
        metrics["si_sdr"] = float(np.mean(sdr))
    transcriptions = []
    if any(prompts):
        wer_out = wer(model_args.asr_model_name_or_path, prompts, clips, sr,
                      training_args.per_device_eval_batch_size,
                      training_args.noise_level_to_compute_clean_wer, sdr)
        if wer_out is not None:
            metrics["wer"], clean, transcriptions = wer_out
            if clean is not None:
                metrics["clean_wer"] = clean
    if metrics:
        log_metric(tracker, metrics, 0.0, step, epoch, prefix="eval")
    log_pred(tracker, descriptions, prompts, transcriptions, clips, sr, step)
    return metrics


if __name__ == "__main__":
    main()
