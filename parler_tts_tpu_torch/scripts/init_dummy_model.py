"""Build the canonical tiny (4 layers x 512) smoke-test checkpoint (port of
`helpers/model_init_scripts/init_dummy_model.py`):

    python -m parler_tts_tpu_torch.scripts.init_dummy_model DIR [--seed 0] [--device cuda]
"""

from __future__ import annotations

from ..config import DACConfig, ParlerTTSConfig, T5Config, dummy_decoder_config
from . import write_random_model


def configs():
    """(the tiny composite over the 44.1 kHz DAC, None: the decoder's ids)."""
    dac = DACConfig()
    cfg = ParlerTTSConfig(
        text_encoder=T5Config(vocab_size=32128, d_model=256, d_kv=64, d_ff=512,
                              num_layers=2, num_heads=4),
        audio_encoder=dac,
        decoder=dummy_decoder_config(),
        vocab_size=32128,
        pad_token_id=dac.codebook_size,
        decoder_start_token_id=dac.codebook_size + 1,
    )
    return cfg, None


def main(argv=None):
    cfg, gen = configs()
    return write_random_model(cfg, gen, argv, "dummy model")


if __name__ == "__main__":
    main()
