"""Build an untrained parler-tts-large-v1 (2.3B) checkpoint (port of
`helpers/model_init_scripts/init_large_model.py`): flan-t5-large, the
large-v1 decoder (30 layers x 1536, 24 heads, FFN 6144), the 44.1 kHz DAC,
and a generation config of 30 s:

    python -m parler_tts_tpu_torch.scripts.init_large_model DIR [--seed 0] [--device cuda]
"""

from __future__ import annotations

from ..config import (
    DACConfig,
    GenerationConfig,
    ParlerTTSConfig,
    T5Config,
    large_v1_decoder_config,
)
from . import write_random_model


def flan_t5_large() -> T5Config:
    return T5Config(vocab_size=32128, d_model=1024, d_kv=64, d_ff=2816,
                    num_layers=24, num_heads=16)


def configs():
    """(the large-v1 composite, sampling over 30 s of frames)."""
    dac = DACConfig()
    decoder = large_v1_decoder_config()
    cfg = ParlerTTSConfig(
        text_encoder=flan_t5_large(),
        audio_encoder=dac,
        decoder=decoder,
        vocab_size=32128,
        pad_token_id=dac.codebook_size,
        decoder_start_token_id=dac.codebook_size + 1,
    )
    gen = GenerationConfig(
        max_length=int(30 * dac.frame_rate), do_sample=True,
        bos_token_id=decoder.bos_token_id, pad_token_id=decoder.pad_token_id,
        eos_token_id=decoder.eos_token_id,
    )
    return cfg, gen


def main(argv=None):
    cfg, gen = configs()
    return write_random_model(cfg, gen, argv, "untrained large-v1")


if __name__ == "__main__":
    main()
