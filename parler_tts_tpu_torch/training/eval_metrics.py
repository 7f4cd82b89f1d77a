"""Evaluation metrics of eval generation: WER through an ASR model, CLAP
text-audio similarity, SQUIM's SI-SDR (own copy of
`parler_tts_tpu/training/eval_metrics.py`, which imports no JAX).

Each metric imports its libraries (`transformers`, `torchaudio`,
`evaluate`) inside the function and loads its model there; a missing
library, or a model that cannot load offline, skips the metric (None), as
in the JAX package. `word_error_rate` is the corpus WER the trainer falls
back on when `evaluate` cannot give one.
"""

from __future__ import annotations

import logging
from typing import List, Optional, Tuple

import numpy as np

logger = logging.getLogger(__name__)


def _load_model_or_skip(metric_name: str, loader):
    """Load a hub-backed metric model, returning None ONLY for the
    expected offline/missing-checkpoint failures (OSError covers the HF hub's
    offline + local-cache-miss errors and urllib fetch failures; ValueError
    covers hub repo-id validation). Anything else — OOM, a code bug, a corrupt
    checkpoint tensor — propagates so eval regressions stay visible."""
    try:
        return loader()
    except (OSError, ValueError, ConnectionError) as e:
        logger.warning(
            "eval metric %r skipped: model load failed (%s: %s)",
            metric_name, type(e).__name__, e,
        )
        return None


def clap_similarity(
    clap_model_name_or_path: str,
    texts: List[str],
    audios: List[np.ndarray],
    sampling_rate: int,
) -> Optional[float]:
    """Mean cosine similarity between CLAP text and audio embeddings."""
    try:
        import torch
        from transformers import AutoProcessor, ClapModel
    except ImportError:
        return None
    loaded = _load_model_or_skip(
        "clap_similarity",
        lambda: (
            ClapModel.from_pretrained(clap_model_name_or_path),
            AutoProcessor.from_pretrained(clap_model_name_or_path),
        ),
    )
    if loaded is None:
        return None
    clap, processor = loaded
    inputs = processor(
        text=texts, audios=[a.astype(np.float32) for a in audios],
        padding=True, return_tensors="pt", sampling_rate=sampling_rate,
    )
    with torch.no_grad():
        text_emb = clap.get_text_features(
            input_ids=inputs["input_ids"], attention_mask=inputs.get("attention_mask")
        )
        audio_emb = clap.get_audio_features(inputs["input_features"])
        sim = torch.nn.functional.cosine_similarity(audio_emb, text_emb, dim=1)
    return float(sim.mean())


def si_sdr(audios: List[np.ndarray], sampling_rate: int) -> Optional[List[float]]:
    """SQUIM objective's SI-SDR estimate of each clip's first 15 s."""
    try:
        import torch
        from torchaudio.pipelines import SQUIM_OBJECTIVE
    except ImportError:
        return None
    import torchaudio

    model = _load_model_or_skip("si_sdr", SQUIM_OBJECTIVE.get_model)
    if model is None:
        return None
    max_len = 15 * SQUIM_OBJECTIVE.sample_rate
    out = []
    for audio in audios:
        wav = torch.tensor(audio, dtype=torch.float32)[None]
        if sampling_rate != SQUIM_OBJECTIVE.sample_rate:
            wav = torchaudio.functional.resample(
                wav, sampling_rate, SQUIM_OBJECTIVE.sample_rate
            )
        with torch.no_grad():
            _, _, sdr = model(wav[:, :max_len])
        out.append(float(sdr[0]))
    return out


def word_error_rate(predictions: List[str], references: List[str]) -> float:
    """Corpus word error rate: total word edit distance / total reference
    words (substitutions + insertions + deletions over the pooled
    references), the definition of `evaluate.load("wer")`."""
    total_edits, total_words = 0, 0
    for pred, ref in zip(predictions, references):
        p, r = pred.split(), ref.split()
        # Levenshtein over words, two-row DP
        prev = list(range(len(p) + 1))
        for i, rw in enumerate(r, 1):
            cur = [i] + [0] * len(p)
            for j, pw in enumerate(p, 1):
                cur[j] = min(
                    prev[j] + 1,                       # deletion
                    cur[j - 1] + 1,                    # insertion
                    prev[j - 1] + (rw != pw),          # substitution
                )
            prev = cur
        total_edits += prev[-1]
        total_words += len(r)
    return total_edits / max(total_words, 1)


class _NativeWerMetric:
    def compute(self, predictions, references):
        return word_error_rate(predictions, references)


def _load_wer_metric():
    """`evaluate.load("wer")` when it loads; `word_error_rate` otherwise
    (evaluate fetches its metric script from the hub)."""
    try:
        import evaluate

        return evaluate.load("wer")
    except Exception:
        return _NativeWerMetric()


def wer(
    asr_model_name_or_path: str,
    prompts: List[str],
    audios: List[np.ndarray],
    sampling_rate: int,
    per_device_eval_batch_size: int = 8,
    noise_level_to_compute_clean_wer: Optional[float] = None,
    si_sdr_measures: Optional[List[float]] = None,
) -> Optional[Tuple[float, Optional[float], List[str]]]:
    """Whisper transcription -> normalized WER, plus the WER of the clips
    whose SI-SDR reaches `noise_level_to_compute_clean_wer`. Returns (wer %,
    clean wer % or None, transcriptions), or None when the ASR model cannot
    load."""
    try:
        from transformers import pipeline
        from transformers.models.whisper.english_normalizer import (
            BasicTextNormalizer,
            EnglishTextNormalizer,
        )
    except ImportError:
        return None

    metric = _load_wer_metric()
    # the task named explicitly: hub task inference is refused offline; an
    # ASR checkpoint that cannot load skips the metric
    asr = _load_model_or_skip(
        "wer",
        lambda: pipeline(
            "automatic-speech-recognition", model=asr_model_name_or_path,
            device="cpu",
        ),
    )
    if asr is None:
        return None
    return_language = "whisper" in asr_model_name_or_path.lower()

    transcriptions = asr(
        [{"raw": a.astype(np.float32), "sampling_rate": sampling_rate} for a in audios],
        batch_size=int(per_device_eval_batch_size),
        return_language=return_language,
    )
    if return_language:
        tokenizer = asr.tokenizer
        english_normalizer = EnglishTextNormalizer(tokenizer.english_spelling_normalizer)
        basic_normalizer = BasicTextNormalizer()
        norm = lambda t: (  # noqa: E731
            english_normalizer(t["text"])
            if t.get("chunks", [{}])[0].get("language", "english") == "english"
            else basic_normalizer(t["text"])
        )
    else:
        basic = BasicTextNormalizer()
        norm = lambda t: basic(t["text"])  # noqa: E731

    normalized_predictions = [norm(t) for t in transcriptions]
    normalized_references = []
    for p in prompts:
        np_ref = norm({"text": p, "chunks": [{"language": "english"}]})
        normalized_references.append(np_ref if np_ref.strip() else p.lower())

    word_error = 100 * metric.compute(
        predictions=normalized_predictions, references=normalized_references
    )
    clean_word_error = None
    if noise_level_to_compute_clean_wer is not None and si_sdr_measures is not None:
        mask = np.asarray(si_sdr_measures) >= noise_level_to_compute_clean_wer
        if mask.any():
            clean_word_error = 100 * metric.compute(
                predictions=[p for p, m in zip(normalized_predictions, mask) if m],
                references=[r for r, m in zip(normalized_references, mask) if m],
            )
    return word_error, clean_word_error, [t["text"] for t in transcriptions]
