"""Data assembly and collation for training (port of
`parler_tts_tpu/training/data.py`).

The collators bucket every padded length (audio to a multiple of
`bucket_seconds` and of the hop, tokens to `token_bucket`, labels to
`label_bucket`), so a run sees few distinct shapes. They return numpy arrays
on the host: `DataCollatorParlerTTSWithPadding` a `Batch` of them, which the
trainer moves to its device. `load_multiple_datasets` imports `datasets`
inside the function, as the JAX package does.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from .train_state import Batch

logger = logging.getLogger(__name__)


def round_to_bucket(n: int, bucket: int, max_len: Optional[int] = None) -> int:
    out = max(bucket, ((n + bucket - 1) // bucket) * bucket)
    return min(out, max_len) if max_len is not None else out


@dataclass
class DataCollatorEncodecWithPadding:
    """Raw audio -> {"input_values": (B, 1, T) float32, "len_audio": (B,)}
    for the stage-1 codec encode, T a hop multiple of the bucket."""

    sampling_rate: int
    hop_length: int = 512
    audio_column_name: str = "audio"
    max_length_seconds: float = 35.0
    bucket_seconds: float = 5.0

    def __call__(self, features: Sequence[Dict[str, Any]]):
        audios = [np.asarray(f[self.audio_column_name]["array"], np.float32) for f in features]
        len_audio = np.asarray([len(a) for a in audios], np.int32)
        max_samples = int(self.max_length_seconds * self.sampling_rate)
        bucket = int(self.bucket_seconds * self.sampling_rate)
        target = round_to_bucket(int(len_audio.max()), bucket, max_samples)
        target = ((target + self.hop_length - 1) // self.hop_length) * self.hop_length
        batch = np.zeros((len(audios), target), np.float32)
        for i, a in enumerate(audios):
            a = a[:target]
            batch[i, : len(a)] = a
        return {"input_values": batch[:, None, :], "len_audio": np.minimum(len_audio, target)}


@dataclass
class DataCollatorParlerTTSWithPadding:
    """Tokenized features -> a `Batch` of numpy arrays.

    - labels (B, T, K) padded with -100 (optionally to a fixed audio_max_length)
    - description ids padded right, prompt ids padded on
      `prompt_padding_side` (left by default)
    - all lengths bucketed.
    """

    prompt_padding_side: str = "left"
    pad_token_id: int = 0
    prompt_pad_token_id: int = 0
    audio_max_length: Optional[int] = None
    token_bucket: int = 16
    label_bucket: int = 128
    # a cap on padded prompt + padded frames: the decoder's position table
    # (max_position_embeddings) covers the prompt prefix and the frames, and
    # the model raises past it. The trainer sets it from the model config.
    max_total_length: Optional[int] = None

    def _pad_tokens(self, seqs: List[np.ndarray], side: str, pad_id: int):
        target = round_to_bucket(max(len(s) for s in seqs), self.token_bucket)
        ids = np.full((len(seqs), target), pad_id, np.int32)
        mask = np.zeros((len(seqs), target), np.int32)
        for i, s in enumerate(seqs):
            if side == "left":
                ids[i, target - len(s):] = s
                mask[i, target - len(s):] = 1
            else:
                ids[i, : len(s)] = s
                mask[i, : len(s)] = 1
        return ids, mask

    def __call__(self, features: Sequence[Dict[str, Any]]) -> Batch:
        desc = [np.asarray(f["input_ids"], np.int64) for f in features]
        desc_ids, desc_mask = self._pad_tokens(desc, "right", self.pad_token_id)
        prompt = [np.asarray(f["prompt_input_ids"], np.int64) for f in features]
        p_ids, p_mask = self._pad_tokens(
            prompt, self.prompt_padding_side, self.prompt_pad_token_id
        )

        labels = [np.asarray(f["labels"], np.int64) for f in features]  # (T, K)
        t_max = max(l.shape[0] for l in labels)
        t_pad = self.audio_max_length or round_to_bucket(t_max, self.label_bucket)
        if self.max_total_length is not None:
            capped = min(t_pad, self.max_total_length - p_ids.shape[1])
            if capped <= 0:
                raise ValueError(
                    f"padded prompt ({p_ids.shape[1]}) leaves no room for audio "
                    f"frames under max_total_length={self.max_total_length}"
                )
            if capped < t_max:
                # truncation cuts the delay-pattern tail (and its EOS
                # supervision) from over-long rows: a safety net, not a
                # filter; the duration and token-length filters should make
                # rows fit
                logger.warning(
                    "truncating labels %d -> %d frames to fit max_total_length=%d "
                    "(prompt %d); over-long rows lose EOS supervision — prefer "
                    "duration filtering",
                    t_max, capped, self.max_total_length, p_ids.shape[1],
                )
            t_pad = capped
        k = labels[0].shape[1]
        lab = np.full((len(labels), t_pad, k), -100, np.int64)
        for i, l in enumerate(labels):
            l = l[:t_pad]
            lab[i, : l.shape[0]] = l
        return Batch(
            input_ids=desc_ids,
            attention_mask=desc_mask,
            prompt_input_ids=p_ids,
            prompt_attention_mask=p_mask,
            labels=lab.astype(np.int32),
        )


def length_grouped_order(
    lengths: Sequence[int], batch_size: int, seed: int, mega_batch_mult: int = 50
) -> np.ndarray:
    """Length-grouped shuffling (`group_by_length`): shuffle globally with a
    `default_rng(seed)` permutation, then sort longest first within
    mega-batches of `mega_batch_mult * batch_size`, so co-batched samples
    have similar lengths."""
    rng = np.random.default_rng(seed)
    lengths = np.asarray(lengths)
    indices = rng.permutation(len(lengths))
    mb = batch_size * mega_batch_mult
    out = []
    for i in range(0, len(indices), mb):
        chunk = indices[i : i + mb]
        out.append(chunk[np.argsort(lengths[chunk])[::-1]])
    return np.concatenate(out)


def convert_dataset_str_to_list(
    dataset_names: str,
    dataset_config_names: str,
    metadata_dataset_names: Optional[str] = None,
    splits: Optional[str] = None,
    dataset_samples: Optional[str] = None,
    default_split: str = "train",
) -> List[Dict[str, Any]]:
    """Parse "+"-separated names, configs, splits, sample counts and metadata
    datasets into one dict per dataset, with sampling probabilities when
    `dataset_samples` is given."""
    names = dataset_names.split("+")
    configs = dataset_config_names.split("+")
    splits_l = splits.split("+") if splits else [default_split] * len(names)
    meta = metadata_dataset_names.split("+") if metadata_dataset_names else [None] * len(names)
    samples = dataset_samples.split("+") if dataset_samples else [None] * len(names)

    if len(configs) != len(names):
        raise ValueError(
            f"Ensure one config per dataset: got {len(names)} datasets, {len(configs)} configs."
        )
    if len(splits_l) != len(names):
        raise ValueError("Ensure one split per dataset.")
    if len(meta) != len(names):
        raise ValueError("Ensure one metadata dataset per dataset.")

    if dataset_samples is not None:
        samples = [float(s) for s in samples]
        total = sum(samples)
        probs = [s / total for s in samples]
    else:
        probs = None

    out = []
    for i, name in enumerate(names):
        out.append(
            {
                "name": name,
                "config": configs[i] or None,
                "split": splits_l[i],
                "metadata_dataset_name": meta[i],
                "samples": samples[i] if probs else None,
                "prob": probs[i] if probs else None,
            }
        )
    return out


def load_multiple_datasets(
    dataset_specs: List[Dict[str, Any]],
    sampling_rate: int,
    columns_to_keep: Optional[set] = None,
    id_column_name: Optional[str] = None,
    num_proc: Optional[int] = None,
    streaming: bool = False,
    stopping_strategy: str = "first_exhausted",
    seed: Optional[int] = None,
):
    """Load, resample, metadata-join and combine datasets with the `datasets`
    package (hub or cached data; host side only).

    Not streaming: the parts are concatenated. Streaming: they are mixed by
    `interleave_datasets` with the sampling probabilities of
    `convert_dataset_str_to_list`."""
    from datasets import Audio, concatenate_datasets, load_dataset

    parts = []
    for spec in dataset_specs:
        kw = {} if streaming else {"num_proc": num_proc}
        ds = load_dataset(
            spec["name"], spec["config"], split=spec["split"], streaming=streaming, **kw
        )
        # streaming IterableDatasets may expose features=None until resolved
        audio_cols = [c for c, f in (ds.features or {}).items()
                      if getattr(f, "sampling_rate", None)]
        for c in audio_cols:
            ds = ds.cast_column(c, Audio(sampling_rate=sampling_rate))
        if spec.get("metadata_dataset_name"):
            if streaming:
                # `datasets` cannot axis=1-concatenate IterableDatasets, and
                # the whole-corpus id check below needs a materialized join
                raise ValueError(
                    "metadata_dataset joins require streaming=False; "
                    "pre-join the metadata or disable streaming"
                )
            meta = load_dataset(
                spec["metadata_dataset_name"], spec["config"], split=spec["split"],
                streaming=streaming, **kw,
            )
            if id_column_name is not None:
                meta = meta.rename_column(id_column_name, f"metadata_{id_column_name}")
            dup = [c for c in meta.column_names if c in ds.column_names]
            meta = meta.remove_columns(dup)
            ds = concatenate_datasets([ds, meta], axis=1)
            # every row's id against its metadata row's id
            if id_column_name is not None:
                mism = ds.filter(
                    lambda a, b: a != b,
                    input_columns=[id_column_name, f"metadata_{id_column_name}"],
                    num_proc=num_proc,
                )
                if len(mism) != 0:
                    raise ValueError(
                        f"metadata join misaligned: {len(mism)} rows of "
                        f"{spec['name']} have ids that differ from "
                        f"{spec['metadata_dataset_name']}"
                    )
        if columns_to_keep is not None:
            ds = ds.remove_columns(set(ds.column_names) - columns_to_keep)
        parts.append(ds)
    if len(parts) == 1:
        return parts[0]
    if streaming:
        from datasets import interleave_datasets

        probs = [spec.get("prob") for spec in dataset_specs]
        probabilities = probs if all(p is not None for p in probs) else None
        return interleave_datasets(
            parts, probabilities=probabilities, seed=seed,
            stopping_strategy=stopping_strategy,
        )
    return concatenate_datasets(parts)
