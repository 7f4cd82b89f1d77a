"""Build an untrained parler-tts-mini-v1 (600M decoder) checkpoint (port of
`helpers/model_init_scripts/init_model_600M.py`): flan-t5-base, the mini-v1
decoder, the 44.1 kHz DAC, and a generation config of 30 s:

    python -m parler_tts_tpu_torch.scripts.init_model_600M DIR [--seed 0] [--device cuda]
"""

from __future__ import annotations

from ..config import (
    DACConfig,
    GenerationConfig,
    ParlerTTSConfig,
    T5Config,
    mini_v1_decoder_config,
)
from . import write_random_model


def flan_t5_base() -> T5Config:
    return T5Config(vocab_size=32128, d_model=768, d_kv=64, d_ff=2048,
                    num_layers=12, num_heads=12)


def configs():
    """(the mini-v1 composite, sampling over 30 s of frames)."""
    dac = DACConfig()
    decoder = mini_v1_decoder_config()
    cfg = ParlerTTSConfig(
        text_encoder=flan_t5_base(),
        audio_encoder=dac,
        decoder=decoder,
        vocab_size=32128,
        pad_token_id=dac.codebook_size,
        decoder_start_token_id=dac.codebook_size + 1,
    )
    gen = GenerationConfig(
        max_length=int(30 * dac.frame_rate),
        do_sample=True,
        bos_token_id=decoder.bos_token_id,
        pad_token_id=decoder.pad_token_id,
        eos_token_id=decoder.eos_token_id,
    )
    return cfg, gen


def main(argv=None):
    cfg, gen = configs()
    return write_random_model(cfg, gen, argv, "untrained mini-v1")


if __name__ == "__main__":
    main()
