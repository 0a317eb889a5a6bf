"""Text-to-speech session: streaming PCM synthesis plumbing.

Role parity with nagare's TextToSpeechSession (crates/nagare/src/
text_to_speech/mod.rs): a session holds a synthesizer instance, exposes an
Idle/Synthesizing state machine, `synthesize` (whole utterance) and
`synthesize_stream` (PCM chunks as they are produced), cancellation, and
per-reply stats. The reference's synthesis backend is an Apple-specific
audio stack; here the synthesizer is a pluggable callable so any TTS
model (audio-codec-token LM + codec decoder) slots in — the session layer
is model-agnostic plumbing in both designs.

The port's copy of `uzu_tpu/sessions/tts.py`; `TokenLMSynthesizer` streams
from the port's `LanguageModel`.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable, Iterator, Optional

import numpy as np


@dataclasses.dataclass
class PcmBatch:
    """A chunk of PCM samples (shoji types::basic::PcmBatch)."""

    samples: np.ndarray  # [N] float32 in [-1, 1]
    sample_rate: int

    @property
    def duration_s(self) -> float:
        return len(self.samples) / self.sample_rate if self.sample_rate else 0.0


@dataclasses.dataclass
class TextToSpeechStats:
    """Parity with shoji TextToSpeechStats: wall time vs audio time."""

    synthesis_seconds: float = 0.0
    audio_seconds: float = 0.0

    @property
    def real_time_factor(self) -> float:
        return self.synthesis_seconds / self.audio_seconds if self.audio_seconds else 0.0


@dataclasses.dataclass
class TextToSpeechOutput:
    pcm: PcmBatch
    stats: TextToSpeechStats


class CancelToken:
    def __init__(self):
        self._event = threading.Event()

    def cancel(self) -> None:
        self._event.set()

    @property
    def cancelled(self) -> bool:
        return self._event.is_set()


# A synthesizer turns text into an iterator of PCM chunks.
Synthesizer = Callable[[str], Iterator[PcmBatch]]


class TextToSpeechSession:
    """States: "idle" | "synthesizing" (text_to_speech/mod.rs:58-62)."""

    def __init__(self, synthesizer: Synthesizer):
        self._synthesizer = synthesizer
        self._state = "idle"
        self._lock = threading.Lock()

    @property
    def state(self) -> str:
        return self._state

    def synthesize_stream(
        self, text: str, cancel: Optional[CancelToken] = None
    ) -> Iterator[TextToSpeechOutput]:
        """Yields one TextToSpeechOutput per produced PCM chunk; stats
        accumulate across the stream (the last chunk carries totals)."""
        with self._lock:
            if self._state != "idle":
                raise RuntimeError("session is already synthesizing")
            self._state = "synthesizing"
        stats = TextToSpeechStats()
        t0 = time.perf_counter()
        try:
            for chunk in self._synthesizer(text):
                if cancel is not None and cancel.cancelled:
                    break
                stats.synthesis_seconds = time.perf_counter() - t0
                stats.audio_seconds += chunk.duration_s
                yield TextToSpeechOutput(
                    pcm=chunk,
                    stats=dataclasses.replace(stats),
                )
        finally:
            self._state = "idle"

    def synthesize(self, text: str, cancel: Optional[CancelToken] = None) -> TextToSpeechOutput:
        """Whole-utterance synthesis: concatenates the streamed chunks
        (mod.rs synthesize() folds the stream the same way)."""
        outputs = list(self.synthesize_stream(text, cancel))
        if not outputs:
            raise RuntimeError("no response from synthesizer")
        rate = outputs[0].pcm.sample_rate
        samples = np.concatenate([o.pcm.samples for o in outputs])
        return TextToSpeechOutput(
            pcm=PcmBatch(samples=samples, sample_rate=rate),
            stats=outputs[-1].stats,
        )


class TokenLMSynthesizer:
    """Audio-token-LM synthesizer: the structure of modern TTS
    (text -> prompt tokens -> the LM streams AUDIO-CODEC tokens on the
    engine's fused decode path -> each token decodes to a PCM frame via a
    codebook with overlap-add crossfade). The reference's synthesis
    backend is an Apple audio stack behind the same session plumbing; here
    any codec-token TTS model drops in as (LanguageModel, tokenizer,
    codebook [V, frame]) — `codebook_sine` supplies a deterministic
    offline codebook so the full pipeline runs and tests without model
    downloads.

    frame_hop < frame_len gives 50%-style overlap-add (Hann-windowed), the
    standard codec-decoder reconstruction.
    """

    def __init__(self, lm, tokenizer, codebook: np.ndarray, *,
                 sample_rate: int = 16000, frame_hop: int | None = None,
                 max_frames: int = 400, tokens_per_chunk: int = 16,
                 seed: int = 0):
        self.lm = lm
        self.tokenizer = tokenizer
        self.codebook = np.asarray(codebook, np.float32)  # [V, frame]
        self.sample_rate = sample_rate
        self.frame_len = self.codebook.shape[1]
        self.frame_hop = frame_hop or self.frame_len // 2
        self.max_frames = max_frames
        self.tokens_per_chunk = tokens_per_chunk
        self.seed = seed
        w = np.hanning(self.frame_len).astype(np.float32)
        self._window = w / max(1e-6, w[: self.frame_len - self.frame_hop].max())

    def __call__(self, text: str) -> Iterator[PcmBatch]:
        prompt = np.asarray(self.tokenizer.encode(text), np.int32)
        stop = list(self.lm.config.generation_config.stop_token_ids)
        stream = self.lm.generate(prompt, self.max_frames,
                                  stop_token_ids=stop, seed=self.seed)
        tail = np.zeros(self.frame_len - self.frame_hop, np.float32)
        pending: list[int] = []
        v = len(self.codebook)

        def flush():
            nonlocal tail
            frames = [self.codebook[t % v] * self._window for t in pending]
            pending.clear()
            out = np.zeros(self.frame_hop * len(frames) + len(tail), np.float32)
            out[: len(tail)] = tail
            for i, f in enumerate(frames):
                out[i * self.frame_hop : i * self.frame_hop + self.frame_len] += f
            emit, tail = (out[: self.frame_hop * len(frames)].copy(),
                          out[self.frame_hop * len(frames):].copy())
            return emit

        for tok in stream:
            if tok in stop:
                break
            pending.append(int(tok))
            if len(pending) >= self.tokens_per_chunk:
                yield PcmBatch(samples=flush(), sample_rate=self.sample_rate)
        if pending:
            yield PcmBatch(samples=flush(), sample_rate=self.sample_rate)
        if len(tail):
            yield PcmBatch(samples=tail, sample_rate=self.sample_rate)


def codebook_sine(vocab_size: int, frame_len: int = 320,
                  sample_rate: int = 16000) -> np.ndarray:
    """Deterministic offline codebook: token id -> windowless sine frame
    with id-mapped pitch (the synthetic-artifact role; a real codec model's
    decoder table drops in with the same shape)."""
    t = np.arange(frame_len, dtype=np.float32) / sample_rate
    freqs = 100.0 + 900.0 * (np.arange(vocab_size) % 97) / 97.0
    return 0.2 * np.sin(2 * np.pi * freqs[:, None] * t[None, :]).astype(np.float32)


def sine_test_synthesizer(sample_rate: int = 16000, chunk_ms: int = 200) -> Synthesizer:
    """Deterministic test synthesizer: one tone per word, pitched by word
    hash — exercises the streaming/cancel/stats plumbing without a model
    (the role of mock-registry's synthetic artifacts in the reference's
    test strategy)."""

    def synth(text: str) -> Iterator[PcmBatch]:
        n = int(sample_rate * chunk_ms / 1000)
        for word in text.split() or [""]:
            freq = 200.0 + (hash(word) % 600)
            t = np.arange(n, dtype=np.float32) / sample_rate
            yield PcmBatch(
                samples=0.2 * np.sin(2 * np.pi * freq * t).astype(np.float32),
                sample_rate=sample_rate,
            )

    return synth
