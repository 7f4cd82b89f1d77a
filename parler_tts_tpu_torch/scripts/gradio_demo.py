"""Demo: a prompt and a voice description in, speech out (port of
`helpers/gradio_demo/app.py`): a fixed seed, two text boxes, one audio
widget. With `gradio` installed it serves the web form; without it, a loop
on stdin that writes each result to `OUTPUT_WAV` and ends at EOF.

The port has no tokenizer library, so the caller passes one (a callable
mapping a list of strings to `{"input_ids": [[int, ...], ...]}`):

    from parler_tts_tpu_torch.scripts import gradio_demo
    gradio_demo.main(["--model", DIR], tokenizer=tokenizer)

It serves speculatively by default (`--speculative_window 16`; 0 serves the
one-column loop), on the GPU unless given `--device cpu`.
"""

from __future__ import annotations

import argparse
import os
import tempfile

import numpy as np

from ..native import write_wav
from ..runtime.pipeline import ParlerTTSPipeline

DEFAULT_DESCRIPTION = (
    "A female speaker with a slightly low-pitched voice delivers her words quite "
    "expressively, in a very confined sounding environment with clear audio quality."
)
DEFAULT_PROMPT = "Hey, how are you doing today?"
SEED = 42
OUTPUT_WAV = os.path.join(tempfile.gettempdir(), "parler_tts_demo.wav")


def load_pipeline(path: str, speculative_window=None, **kw) -> ParlerTTSPipeline:
    """`from_pretrained(path)` with the window; `kw` (device, tokenizer,
    generation_config, dtype, ...) go to `from_pretrained`."""
    return ParlerTTSPipeline.from_pretrained(path, speculative_window=speculative_window, **kw)


def generate(pipe: ParlerTTSPipeline, prompt: str, description: str):
    """(sampling rate, the waveform of one request) at the demo's seed."""
    audio, lengths = pipe.generate([description], [prompt], seed=SEED)
    return pipe.config.sampling_rate, np.asarray(audio[0, : lengths[0]])


def cli_loop(pipe: ParlerTTSPipeline) -> None:
    """Read a prompt and a description per request (empty: the defaults),
    write the speech to `OUTPUT_WAV`; return at EOF."""
    while True:
        try:
            prompt = input("prompt> ") or DEFAULT_PROMPT
            desc = input("description> ") or DEFAULT_DESCRIPTION
        except EOFError:
            return
        rate, wav = generate(pipe, prompt, desc)
        write_wav(OUTPUT_WAV, rate, wav)
        print(f"wrote {OUTPUT_WAV} ({len(wav) / rate:.2f}s)")


def main(argv=None, tokenizer=None, **kw):
    """The demo over the checkpoint `--model`; `tokenizer` is required, `kw`
    go to `load_pipeline`. Returns the pipeline when the CLI loop ends."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--model", type=str, required=True, help="checkpoint dir")
    parser.add_argument("--share", action="store_true")
    parser.add_argument(
        "--speculative_window", type=int, default=16,
        help="speculative decoding window (0 disables)",
    )
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)
    if tokenizer is None:
        raise ValueError("the demo needs a tokenizer: call main(argv, tokenizer=...) with a "
                         "callable mapping a list of strings to {'input_ids': [[...], ...]}")

    pipe = load_pipeline(args.model, speculative_window=args.speculative_window or None,
                         device=args.device, tokenizer=tokenizer, **kw)
    try:
        import gradio as gr
    except ImportError:
        print("gradio not installed; running CLI loop instead")
        cli_loop(pipe)
        return pipe

    demo = gr.Interface(
        fn=lambda prompt, description: generate(pipe, prompt, description),
        inputs=[
            gr.Textbox(label="Prompt", value=DEFAULT_PROMPT),
            gr.Textbox(label="Description", value=DEFAULT_DESCRIPTION),
        ],
        outputs=gr.Audio(label="Generated speech"),
        title="Parler-TTS",
    )
    demo.launch(share=args.share)


if __name__ == "__main__":
    main()
