"""The helper scripts of the port: the JAX package's `helpers/` scripts,
under their file names and with their arguments, plus `--device`:

    python -m parler_tts_tpu_torch.scripts.init_dummy_model DIR [--seed 0]
    python -m parler_tts_tpu_torch.scripts.init_dummy_model_with_encodec DIR
    python -m parler_tts_tpu_torch.scripts.init_model_600M DIR
    python -m parler_tts_tpu_torch.scripts.init_large_model DIR
    python -m parler_tts_tpu_torch.scripts.push_dac_to_hub WEIGHTS OUT_DIR \\
        [--prefix model.] [--push-to REPO]
    python -m parler_tts_tpu_torch.scripts.push_trained_parler_tts_to_hub \\
        CHECKPOINT CONFIG_JSON OUT_DIR [--push-to REPO]
    python -m parler_tts_tpu_torch.scripts.gradio_demo --model DIR  (from Python:
        gradio_demo.main(argv, tokenizer=...), as the port has no tokenizer)

Each runs on the GPU unless given `--device cpu`, and raises without one.
The init scripts draw the weights on the device from a `torch.Generator`
seeded with `--seed` (`ParlerTTSPipeline.from_random`) and write the native
layout (`save_pretrained`): `config.json`, `generation_config.json`,
`params.pkl` and the codec's `dac_params.pkl`, which both packages'
`from_pretrained` load. Each init script's `configs()` returns its
`(ParlerTTSConfig, GenerationConfig or None)` without drawing a weight.
"""

from __future__ import annotations

import argparse
from typing import List, Optional

from ..config import GenerationConfig, ParlerTTSConfig
from ..runtime.pipeline import ParlerTTSPipeline


def write_random_model(cfg: ParlerTTSConfig, gen: Optional[GenerationConfig],
                       argv: Optional[List[str]], label: str) -> ParlerTTSPipeline:
    """The init scripts' body: parse `save_directory`, `--seed` and
    `--device`, draw a `cfg` model and its codec on the device, and write
    them in the native layout (with `gen`, or the pipeline's default
    generation config from the decoder's token ids). Returns the pipeline."""
    parser = argparse.ArgumentParser()
    parser.add_argument("save_directory", type=str)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)
    pipe = ParlerTTSPipeline.from_random(cfg, seed=args.seed, generation_config=gen,
                                         device=args.device)
    pipe.save_pretrained(args.save_directory)
    print(f"saved {label} to {args.save_directory}")
    return pipe
