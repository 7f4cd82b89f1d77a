"""Build a tiny smoke-test checkpoint over the Encodec codec, 8 codebooks of
2048 at 32 kHz (port of
`helpers/model_init_scripts/init_dummy_model_with_encodec.py`):

    python -m parler_tts_tpu_torch.scripts.init_dummy_model_with_encodec DIR [--seed 0]

The text encoder, the decoder and the token ids are the JAX script's. The
composite's audio encoder is the Encodec config itself, and its weights go
to `dac_params.pkl`, the file both packages' `from_pretrained` read, so the
directory serves with the Encodec drawn here. (The JAX script writes a
`DACConfig` of the same geometry and an `encodec_params.pkl` that no loader
reads: its directory serves a random DAC.)
"""

from __future__ import annotations

from ..codec.encodec_model import EncodecCodecConfig
from ..config import ParlerTTSConfig, T5Config, dummy_decoder_config
from . import write_random_model


def configs():
    """(the tiny composite over a 32 kHz Encodec, None: the decoder's ids)."""
    codec_cfg = EncodecCodecConfig(
        sampling_rate=32000, num_codebooks=8, codebook_size=2048,
        codebook_dim=128, hidden_size=128,
    )
    decoder = dummy_decoder_config(
        vocab_size=2048 + 64, num_codebooks=8,
        pad_token_id=2048, eos_token_id=2048, bos_token_id=2049,
    )
    cfg = ParlerTTSConfig(
        text_encoder=T5Config(vocab_size=32128, d_model=256, d_kv=64, d_ff=512,
                              num_layers=2, num_heads=4),
        audio_encoder=codec_cfg,
        decoder=decoder,
        vocab_size=32128,
        pad_token_id=2048,
        decoder_start_token_id=2049,
    )
    return cfg, None


def main(argv=None):
    cfg, gen = configs()
    return write_random_model(cfg, gen, argv, "dummy-with-encodec model")


if __name__ == "__main__":
    main()
