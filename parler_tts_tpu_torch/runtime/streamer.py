"""ParlerTTSStreamer: iterate waveform chunks while generation runs (port of
`parler_tts_tpu/runtime/streamer.py`).

The producer is the pipeline's `stream` on a worker thread; the consumer
iterates its chunks (`for chunk in streamer`) with the same `play_steps`
semantics, a `timeout` on each wait, and the producer's exception raised on
the consumer's side. `pcm_stream` hands int16 PCM bytes through the native
ring buffer (`native/audio_runtime.cpp`), as an audio device's callback
would take them. The pipeline runs on its device (the GPU unless it was
built with `device="cpu"`).
"""

from __future__ import annotations

import queue
import threading
from typing import Optional

import numpy as np


class ParlerTTSStreamer:
    """Iterate waveform chunks (float32 numpy, 1-D) of one B=1 request:

        streamer = ParlerTTSStreamer(pipe, play_steps=86)
        streamer.start(desc_ids, desc_mask, prompt_ids, prompt_mask, seed=0)
        for chunk in streamer:
            play(chunk)
    """

    def __init__(self, pipeline, play_steps: int = 86, timeout: Optional[float] = None):
        self.pipeline = pipeline
        self.play_steps = play_steps  # the hold-back stride follows from it (`stream`)
        self.timeout = timeout
        self.sampling_rate = pipeline.config.sampling_rate
        self.audio_queue: "queue.Queue" = queue.Queue()
        self.stop_signal = None
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def start(self, desc_ids, desc_mask, prompt_ids, prompt_mask, seed: int = 0):
        if np.shape(desc_ids)[0] > 1:
            raise ValueError("ParlerTTSStreamer only supports batch size 1")

        def worker():
            try:
                for chunk in self.pipeline.stream(desc_ids, desc_mask, prompt_ids, prompt_mask,
                                                  play_steps=self.play_steps, seed=seed):
                    self.audio_queue.put(chunk[0], timeout=self.timeout)
            except BaseException as e:  # noqa: BLE001 - raised on the consumer's side
                self._error = e
            finally:
                self.audio_queue.put(self.stop_signal, timeout=self.timeout)

        self._thread = threading.Thread(target=worker, daemon=True)
        self._thread.start()
        return self

    def __iter__(self):
        return self

    def __next__(self):
        value = self.audio_queue.get(timeout=self.timeout)
        if self._error is not None:
            raise self._error
        if value is self.stop_signal:
            raise StopIteration()
        return value

    # ------------------------------------------------------------- PCM stream
    def pcm_stream(self, desc_ids, desc_mask, prompt_ids, prompt_mask, seed: int = 0,
                   ring_capacity: int = 1 << 22):
        """Yield int16 PCM byte chunks of one B=1 request through the native
        ring buffer: a producer thread converts each waveform chunk to PCM
        (`float_to_pcm16`) and pushes it; this generator pops up to 64 KiB at
        a time. A failure of the producer is raised here; when the consumer
        stops early, the producer stops after its current chunk."""
        from ..native import float_to_pcm16, make_ring_buffer

        ring = make_ring_buffer(ring_capacity)
        done = threading.Event()
        error: list = []

        def producer():
            try:
                for chunk in self.pipeline.stream(desc_ids, desc_mask, prompt_ids, prompt_mask,
                                                  play_steps=self.play_steps, seed=seed):
                    data = float_to_pcm16(chunk[0])
                    off = 0
                    while off < len(data) and not done.is_set():
                        off += ring.push(data[off:])
                    if done.is_set():  # the consumer has gone
                        break
            except BaseException as e:  # noqa: BLE001 - raised on the consumer's side
                error.append(e)
            finally:
                done.set()

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        try:
            while not (done.is_set() and ring.size() == 0):
                chunk = ring.pop(65536)
                if chunk:
                    yield chunk
                elif not done.is_set():
                    thread.join(timeout=0.005)
            if error:
                raise error[0]
        finally:
            done.set()
            thread.join()
