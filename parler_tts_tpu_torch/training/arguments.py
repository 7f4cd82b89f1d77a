"""Training arguments (own copy of `parler_tts_tpu/training/arguments.py`,
which imports no JAX): the three dataclasses with the JAX package's fields
and defaults, parsed from `--flag value` pairs or from one JSON file, and
written back by `dump_args`.

The mesh fields (`mesh_data`, `mesh_model`, `fsdp`) are the JAX package's;
the port's trainer builds its process mesh from them (`run_training.py`).
"""

from __future__ import annotations

import dataclasses
import json
import sys
from dataclasses import dataclass, fields
from typing import List, Optional


@dataclass
class ModelArguments:
    """The model and tokenizer arguments."""

    model_name_or_path: str = ""
    config_name: Optional[str] = None
    feature_extractor_name: Optional[str] = None
    description_tokenizer_name: Optional[str] = None
    prompt_tokenizer_name: Optional[str] = None
    use_fast_tokenizer: bool = True
    freeze_text_encoder: bool = True
    do_sample: bool = True
    temperature: float = 1.0
    max_length: int = 2580
    pad_token_id: Optional[int] = None
    decoder_start_token_id: Optional[int] = None
    asr_model_name_or_path: str = "distil-whisper/distil-large-v2"
    clap_model_name_or_path: str = "laion/larger_clap_music_and_speech"
    prompt_padding_side: str = "left"


@dataclass
class DataTrainingArguments:
    """The data arguments ("+"-separated multi-dataset specs)."""

    train_dataset_name: str = ""
    train_dataset_config_name: str = ""
    train_split_name: str = "train"
    train_metadata_dataset_name: Optional[str] = None
    train_dataset_samples: Optional[str] = None
    eval_dataset_name: Optional[str] = None
    eval_dataset_config_name: Optional[str] = None
    eval_split_name: str = "test"
    eval_metadata_dataset_name: Optional[str] = None
    target_audio_column_name: str = "audio"
    description_column_name: str = "description"
    prompt_column_name: str = "text"
    id_column_name: Optional[str] = None
    max_duration_in_seconds: float = 35.0
    min_duration_in_seconds: float = 0.0
    max_text_length: int = 500
    max_prompt_token_length: Optional[int] = None
    max_description_token_length: Optional[int] = None
    max_train_samples: Optional[int] = None
    max_eval_samples: Optional[int] = None
    # splits load as IterableDatasets (probability-weighted interleave across
    # "+"-specs) and the first max_*_samples rows are drawn, so
    # max_train_samples / max_eval_samples are required with streaming
    streaming: bool = False
    preprocessing_num_workers: Optional[int] = None
    preprocessing_only: bool = False
    save_to_disk: Optional[str] = None
    temporary_save_to_disk: Optional[str] = None
    save_codec_steps: Optional[int] = 500
    pad_to_max_length: bool = False
    add_audio_samples_to_wandb: bool = False
    wandb_project: str = "parler-tts-tpu"
    wandb_run_name: Optional[str] = None


@dataclass
class TrainingArguments:
    """The trainer's arguments."""

    output_dir: str = "./output"
    overwrite_output_dir: bool = False
    do_train: bool = True
    do_eval: bool = True
    per_device_train_batch_size: int = 6
    per_device_eval_batch_size: int = 6
    gradient_accumulation_steps: int = 4
    # "batch": the G accumulation micro-batches make one step over a G-fold
    #   batch; "microbatch": G forward/backward passes over slices of the
    #   batch sum their gradients, so activation memory is one slice's. The
    #   gradients are equal either way (one division by the batch's valid
    #   token count).
    gradient_accumulation_mode: str = "batch"
    learning_rate: float = 9.5e-4
    adam_beta1: float = 0.9
    adam_beta2: float = 0.99
    weight_decay: float = 0.01
    max_grad_norm: float = 1.0
    num_train_epochs: float = 4.0
    max_steps: int = -1
    lr_scheduler_type: str = "constant_with_warmup"
    warmup_steps: int = 20000
    logging_steps: int = 50
    save_steps: int = 5000
    eval_steps: int = 5000
    eval_generation_steps: Optional[int] = None
    save_total_limit: Optional[int] = 5
    seed: int = 42
    # compute dtype of the forward/backward; parameters and optimizer state
    # stay fp32: "bfloat16" | "float32"
    dtype: str = "bfloat16"
    # Adam's first moment in bf16 ("bfloat16") or in fp32 (None)
    adam_mu_dtype: Optional[str] = None
    # long-T training attention: "chunked" (online-softmax scan,
    # ops/chunked_attention.py), "chunked:N" (chunk size N) or "pallas_flash"
    # (kernel K4, ops/flash_attention.py)
    attention_impl: str = "chunked"
    # per-layer remat once long T turns it on: "full" recomputes each layer in
    # the backward; "dots" keeps the outputs of its non-batched matrix
    # products and recomputes the rest
    remat_policy: str = "full"
    # fuse the LM heads and the cross-entropy chunk by chunk over T (the
    # (B, K, T, V) logits are never materialised); None = off
    loss_chunk_size: Optional[int] = None
    # batch rows of similar label length (less padding under the bucketing
    # collator)
    group_by_length: bool = False
    # shard the parameters and both AdamW moments over the data axis
    fsdp: bool = False
    audio_encoder_per_device_batch_size: int = 8
    compute_clap_similarity_metric: bool = True
    compute_noise_level_metric: bool = True
    noise_level_to_compute_clean_wer: Optional[float] = 25.0
    codebook_weights: Optional[List[float]] = None
    resume_from_checkpoint: Optional[str] = None
    report_to: str = "wandb"
    push_to_hub: bool = False
    hub_model_id: Optional[str] = None
    mesh_data: Optional[int] = None
    mesh_model: int = 1


def parse_args(argv: Optional[List[str]] = None):
    """`--flag value` (or `--flag=value`) pairs, or one positional path to a
    JSON file whose keys are the dataclasses' field names -> (model, data,
    training) arguments. Flags are coerced by the field's annotation: bool
    ("1", "true", "yes"), int, float, comma-separated floats."""
    argv = list(sys.argv[1:] if argv is None else argv)
    classes = (ModelArguments, DataTrainingArguments, TrainingArguments)

    if len(argv) == 1 and argv[0].endswith(".json"):
        with open(argv[0]) as f:
            blob = json.load(f)
        out = []
        for cls in classes:
            names = {f.name for f in fields(cls)}
            out.append(cls(**{k: v for k, v in blob.items() if k in names}))
        return tuple(out)

    # --flag value parsing
    kv = {}
    i = 0
    while i < len(argv):
        tok = argv[i]
        if not tok.startswith("--"):
            raise ValueError(f"unexpected argument {tok}")
        key = tok[2:]
        if "=" in key:
            key, val = key.split("=", 1)
            kv[key] = val
            i += 1
        else:
            kv[key] = argv[i + 1]
            i += 2

    def coerce(cls, raw):
        out = {}
        for f in fields(cls):
            if f.name not in raw:
                continue
            v = raw[f.name]
            anno = str(f.type)
            if "bool" in anno:
                out[f.name] = str(v).lower() in ("1", "true", "yes")
            elif "int" in anno:
                out[f.name] = int(v)
            elif "List[float]" in anno:  # before "float", which it contains
                out[f.name] = [float(x) for x in str(v).split(",")]
            elif "float" in anno:
                out[f.name] = float(v)
            else:
                out[f.name] = v
        return cls(**out)

    return tuple(coerce(cls, kv) for cls in classes)


def dump_args(model_args, data_args, training_args, path: str):
    blob = {}
    for a in (model_args, data_args, training_args):
        blob.update(dataclasses.asdict(a))
    with open(path, "w") as f:
        json.dump(blob, f, indent=2)
