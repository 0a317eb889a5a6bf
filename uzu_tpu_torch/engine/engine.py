"""The inference engine: model load, chunked prefill, chunked decode, stream.

Counterpart of `uzu_tpu/engine/engine.py` (`LanguageModel`,
`StreamMetrics`), redesigned for PyTorch's eager execution:

- prefill runs in fixed-size chunks; a ragged tail pads up to a small
  bucket set — padding lands in future cache slots the causal mask hides;
- decode runs in chunks of K steps with a device-side halt flag, budget
  and stop ids: the K steps are a Python loop whose token never leaves the
  device, and the host reads the chunk's K tokens with one sync at its end
  (the JAX package fuses the same K steps into one `lax.scan` dispatch);
- attention reads only the smallest power-of-two context bucket covering
  the current position (CTX_BUCKET_MIN upward).

The model runs on the card unless the caller passes `device="cpu"`.
"""

from __future__ import annotations

import dataclasses
import os
import time

import numpy as np
import torch

from ..config import LanguageModelConfig, load_language_model_config
from ..models.decoder import decoder_forward
from ..models.loader import load_decoder
from ..models.state import init_state
from ..params.tree import ParameterLoader
from ..runtime import resolve_device
from .sampling import SamplingParams, push_ring, sample

DEFAULT_PREFILL_BUCKETS = (16, 64, 256)
CTX_BUCKET_MIN = 1024


class ContextOverflowError(RuntimeError):
    """Prompt + generated tokens exceed the state's max context."""


@dataclasses.dataclass
class StreamMetrics:
    num_forward_passes: int = 0
    num_tokens_prefilled: int = 0
    num_tokens_generated: int = 0
    prefill_seconds: float = 0.0
    decode_seconds: float = 0.0

    @property
    def prefill_tokens_per_second(self) -> float:
        return self.num_tokens_prefilled / self.prefill_seconds if self.prefill_seconds else 0.0

    @property
    def decode_tokens_per_second(self) -> float:
        return self.num_tokens_generated / self.decode_seconds if self.decode_seconds else 0.0


class LanguageModel:
    def __init__(
        self,
        config: LanguageModelConfig,
        params,
        *,
        device=None,
        max_context: int = 4096,
        prefill_buckets=DEFAULT_PREFILL_BUCKETS,
        kv_quant: bool = False,
        ring_windows: bool = False,
    ):
        self.device = resolve_device(device)
        self.config = config
        self.decoder_config = config.decoder_config
        self.max_context = max_context
        self.prefill_buckets = tuple(sorted(prefill_buckets))
        # largest number of decode steps per chunk (one host read per
        # chunk; chunks grow 8, 16, 32, ... up to this)
        self.max_decode_chunk = 64
        self.kv_quant = kv_quant
        self.ring_windows = ring_windows
        self.params = _to_device(params, self.device)

    # -- loading ---------------------------------------------------------

    @classmethod
    def from_dir(cls, model_dir: str, *, device=None, **kw) -> "LanguageModel":
        device = resolve_device(device)
        config = load_language_model_config(os.path.join(model_dir, "config.json"))
        loader = ParameterLoader(os.path.join(model_dir, "model.safetensors"))
        tree = loader.tree()
        params = load_decoder(tree, config.decoder_config, device=device)
        tree.assert_all_validated()
        return cls(config, params, device=device, **kw)

    # -- state -----------------------------------------------------------

    def new_state(self, ring_size: int = 0) -> dict:
        """Fresh decoding state on the model's device."""
        state = init_state(
            self.decoder_config, self.max_context, device=self.device,
            kv_quant=self.kv_quant, ring_windows=self.ring_windows,
            ring_extra=max(self.prefill_buckets))
        if ring_size:
            state["ring"] = torch.full((ring_size,), -1, dtype=torch.int32, device=self.device)
        return state

    def _ctx_bucket(self, needed: int) -> int | None:
        """Smallest context bucket covering `needed` slots; None = full."""
        if self.max_context <= CTX_BUCKET_MIN:
            return None
        b = CTX_BUCKET_MIN
        while b < needed:
            b *= 2
        return None if b >= self.max_context else b

    # -- steps -----------------------------------------------------------

    def _forward(self, tokens, state, true_length, ctx_bucket):
        ring = state.pop("ring", None)
        logits, state = decoder_forward(
            self.decoder_config, self.params, tokens, state, last_only=True,
            true_length=true_length, ctx_limit=ctx_bucket)
        return logits[0], state, ring

    def _decode_chunk(self, state, token, halted, remaining, steps: int,
                      sampling: SamplingParams, stop_ids: torch.Tensor | None,
                      ctx_bucket, generator):
        """`steps` decode steps with the device-side halt: after a stop token
        or past the budget every remaining step is an identity transition
        (true_length 0: pos frozen, the KV write lands in the invisible slot
        at pos). Returns (state, tokens [steps], halted), all on the
        device."""
        emitted = []
        for _ in range(steps):
            true_length = (~halted).to(torch.int32)
            logits, state, ring = self._forward(token.reshape(1), state, true_length,
                                                ctx_bucket)
            next_token = sample(logits, sampling, generator=generator, ring=ring)
            next_token = torch.where(halted, token, next_token)
            if ring is not None:
                state["ring"] = torch.where(halted, ring, push_ring(ring, next_token))
            remaining = remaining - true_length
            halted = halted | (remaining <= 0)
            if stop_ids is not None:
                halted = halted | torch.isin(next_token, stop_ids)
            emitted.append(next_token)
            token = next_token
        return state, torch.stack(emitted), halted

    # -- public API --------------------------------------------------------

    def prefill(self, state: dict, tokens) -> tuple[torch.Tensor, dict]:
        """Feed prompt tokens through the model in chunks; returns
        (last_logits [V] f32, state)."""
        tokens = np.asarray(tokens, np.int64)
        n = len(tokens)
        if n == 0:
            raise ValueError("prefill requires at least one token")
        pos = int(state["pos"])
        if pos + n > self.max_context:
            raise ContextOverflowError(
                f"prompt of {n} tokens at position {pos} exceeds max_context={self.max_context}")
        max_chunk = self.prefill_buckets[-1]
        logits = None
        i = 0
        while i < n:
            take = min(n - i, max_chunk)
            bucket = next(b for b in self.prefill_buckets if b >= take)
            chunk = np.zeros(bucket, np.int64)
            chunk[:take] = tokens[i:i + take]
            ring = state.get("ring")
            logits, state, _ = self._forward(
                torch.from_numpy(chunk).to(self.device), state, take,
                self._ctx_bucket(pos + i + bucket))
            if ring is not None:
                state["ring"] = _ring_push_chunk(ring, chunk[:take])
            i += take
        return logits, state

    def generate(self, prompt_tokens, max_new_tokens: int,
                 sampling: SamplingParams | None = None, stop_token_ids=None,
                 seed: int = 0, metrics: StreamMetrics | None = None):
        """Token generator. Yields ints; stops on a stop token or the limit."""
        sampling = sampling or SamplingParams.from_generation_config(
            self.config.generation_config)
        stop = set(stop_token_ids if stop_token_ids is not None
                   else self.config.generation_config.stop_token_ids)
        ring_size = sampling.suffix_repetition_length if sampling.repetition_penalty else 0
        state = self.new_state(ring_size=ring_size)
        dev = self.device

        t0 = time.perf_counter()
        logits, state = self.prefill(state, prompt_tokens)
        gen = torch.Generator(device=dev).manual_seed(seed)
        token = sample(logits, sampling, generator=gen, ring=state.get("ring"))
        val = int(token)
        t1 = time.perf_counter()
        if metrics is not None:
            metrics.num_tokens_prefilled += len(prompt_tokens)
            metrics.prefill_seconds += t1 - t0
            metrics.num_forward_passes += -(-len(prompt_tokens) // self.prefill_buckets[-1])

        stop_ids = (torch.as_tensor(sorted(stop), dtype=torch.long, device=dev)
                    if stop else None)
        gen = torch.Generator(device=dev).manual_seed(seed ^ 0x5EED)
        if state.get("ring") is not None:
            state["ring"] = push_ring(state["ring"], token)
        # stop before the KV cache would overflow (one slot per step)
        budget = min(max_new_tokens, self.max_context - len(prompt_tokens))
        produced = 1
        t2 = time.perf_counter()
        yield val
        done = val in stop or produced >= budget
        halted = torch.zeros((), dtype=torch.bool, device=dev)
        chunk_idx = 0
        while not done:
            rem = budget - produced
            # powers of two from 8 up to max_decode_chunk; the tail rounds
            # up and the device budget halt makes the overrun steps no-ops
            k = min(8 << chunk_idx, self.max_decode_chunk)
            while k // 2 >= rem:
                k //= 2
            chunk_idx += 1
            ctx = self._ctx_bucket(len(prompt_tokens) + produced + k)
            state, toks, halted = self._decode_chunk(
                state, token, halted, torch.tensor(rem, dtype=torch.int32, device=dev),
                k, sampling, stop_ids, ctx, gen)
            token = toks[-1]
            if metrics is not None:
                metrics.num_forward_passes += k
            for v in toks.tolist():  # the chunk's one host sync
                produced += 1
                yield v
                if v in stop or produced >= budget:
                    done = True
                    break
        if metrics is not None:
            metrics.num_tokens_generated += produced
            metrics.decode_seconds += time.perf_counter() - t2

    def generate_list(self, prompt_tokens, max_new_tokens: int, **kw) -> list[int]:
        return list(self.generate(prompt_tokens, max_new_tokens, **kw))


def _ring_push_chunk(ring: torch.Tensor, tokens: np.ndarray) -> torch.Tensor:
    """Push a chunk's real tokens into the recent-token ring."""
    new = torch.as_tensor(tokens, dtype=ring.dtype, device=ring.device)
    return torch.cat([ring, new])[-ring.shape[0]:]


def _to_device(tree, device):
    """Move a parameter tree (dicts, lists, tensors, QuantizedTensors)."""
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_device(v, device) for v in tree]
    return tree.to(device)
