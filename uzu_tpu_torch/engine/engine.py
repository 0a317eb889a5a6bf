"""The inference engine: model load, chunked prefill, chunked decode, stream.

Counterpart of `uzu_tpu/engine/engine.py` (`LanguageModel`,
`StreamMetrics`, `TokenStream`), redesigned for PyTorch's eager execution:

- prefill runs in fixed-size chunks; a ragged tail pads up to a small
  bucket set — padding lands in future cache slots the causal mask hides,
  and recurrent mixers take padded rows as identity transitions;
- decode runs in chunks of K steps with a device-side halt flag, budget
  and stop ids: the K steps are a Python loop whose token never leaves the
  device, and the host reads the chunk's K tokens with one sync at its end
  (the JAX package fuses the same K steps into one `lax.scan` dispatch);
- attention reads only the smallest power-of-two context bucket covering
  the current position (CTX_BUCKET_MIN upward);
- `generate_resumable` continues an existing decoding state and returns a
  `TokenStream` with the final state and, on request, each token's
  log-probability and top alternatives (computed on the device inside the
  chunk, read with its tokens);
- the first prefill chunk and the first decode chunk can be captured by
  the profiler (`tools/profile.py`, armed by UZU_TPU_PROFILE).

The model runs on the card unless the caller passes `device="cpu"`.
"""

from __future__ import annotations

import dataclasses
import os
import time

import numpy as np
import torch

from ..config import LanguageModelConfig, load_language_model_config
from ..config.model import AttentionConfig
from ..models.decoder import decoder_forward
from ..models.loader import load_decoder
from ..models.state import init_state
from ..params.tree import ParameterLoader
from ..runtime import resolve_device
from ..tools.profile import profiled
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
        self.params = _map_leaves(params, lambda t: t.to(self.device))

    # -- loading ---------------------------------------------------------

    @classmethod
    def from_dir(cls, model_dir: str, *, device=None, random_seed: int | None = None,
                 **kw) -> "LanguageModel":
        """`random_seed`: fill every tensor with the loader's seeded random
        content (the JAX package's bytes) instead of reading the file's."""
        device = resolve_device(device)
        config = load_language_model_config(os.path.join(model_dir, "config.json"))
        loader = ParameterLoader(os.path.join(model_dir, "model.safetensors"),
                                 random_seed=random_seed)
        tree = loader.tree()
        params = load_decoder(tree, config.decoder_config, device=device)
        tree.assert_all_validated()
        return cls(config, params, device=device, **kw)

    # -- state -----------------------------------------------------------

    def new_state(self, ring_size: int = 0, batch_size: int = 0,
                  ctx_capacity: int | None = None) -> dict:
        """Fresh decoding state on the model's device. batch_size > 0 gives
        the batched state of the dense batch engine: every leaf with a
        leading [B] dimension (KV [B, C, G, Dh], recurrent states [B, ...],
        pos [B]). ctx_capacity < max_context allocates shorter KV caches
        (the batch engine grows them by context bucket)."""
        state = init_state(
            self.decoder_config, ctx_capacity or self.max_context, device=self.device,
            kv_quant=self.kv_quant, ring_windows=self.ring_windows,
            ring_extra=max(self.prefill_buckets))
        if ring_size:
            state["ring"] = torch.full((ring_size,), -1, dtype=torch.int32, device=self.device)
        if batch_size:
            state = _map_leaves(state, lambda t: t.unsqueeze(0).repeat(
                batch_size, *([1] * t.dim())))
        return state

    def recommended_max_context(self, memory_budget_bytes: int | None = None,
                                batch_size: int = 1) -> int:
        """Largest max_context the device memory supports for this model,
        the JAX package's formula: 90% of the budget less the weights and a
        workspace reserve, over the KV bytes per token (KV-sharing layers
        skipped) times `batch_size`, rounded down to a power of two in
        [1k, 1M] and clamped to the RoPE config's trained context. The
        budget defaults to the card's total memory (the counterpart of
        JAX's `bytes_limit`); off the card it must be given."""
        if memory_budget_bytes is None:
            if self.device.type != "cuda":
                raise ValueError("recommended_max_context needs memory_budget_bytes "
                                 f"on {self.device.type}: only the card reports its memory")
            memory_budget_bytes = torch.cuda.mem_get_info(self.device)[1]
        weight_bytes = sum(t.numel() * t.element_size() for t in _tensors(self.params))
        kv_per_token = 0
        for lc in self.decoder_config.transformer_config.layer_configs:
            m = lc.mixer_config
            if isinstance(m, AttentionConfig) and not m.is_kv_sharing \
                    and lc.kv_source_layer_index is None:
                dtype_bytes = 1 if self.kv_quant else 2
                kv_per_token += 2 * m.num_groups * m.head_dim * dtype_bytes
        workspace = max(256 * 1024**2, weight_bytes // 8)
        avail = int(memory_budget_bytes * 0.9) - weight_bytes - workspace
        if kv_per_token <= 0 or avail <= 0:
            ctx = 4096 if avail > 0 else 1024
        else:
            ctx = avail // (kv_per_token * max(1, batch_size))
        p = 1024
        while p * 2 <= ctx and p < (1 << 20):
            p *= 2
        ctx = p
        for lc in self.decoder_config.transformer_config.layer_configs:
            trained = getattr(lc.rope_config, "max_sequence_length", None)
            if trained:
                ctx = min(ctx, trained)
                break
        return max(1024, ctx)

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
                      ctx_bucket, generator, logprobs: int = 0):
        """`steps` decode steps with the device-side halt: after a stop token
        or past the budget every remaining step is an identity transition
        (true_length 0: pos frozen, the KV write lands in the invisible slot
        at pos). Returns (state, tokens [steps], halted), all on the
        device; with `logprobs` > 0 the tokens are (tokens [steps], their
        f32 log-softmax [steps], top values [steps, n], top ids [steps, n])."""
        emitted, lps = [], []
        for _ in range(steps):
            true_length = (~halted).to(torch.int32)
            logits, state, ring = self._forward(token.reshape(1), state, true_length,
                                                ctx_bucket)
            next_token = sample(logits, sampling, generator=generator, ring=ring)
            next_token = torch.where(halted, token, next_token)
            if logprobs:
                lps.append(_logprobs(logits, next_token, logprobs))
            if ring is not None:
                state["ring"] = torch.where(halted, ring, push_ring(ring, next_token))
            remaining = remaining - true_length
            halted = halted | (remaining <= 0)
            if stop_ids is not None:
                halted = halted | torch.isin(next_token, stop_ids)
            emitted.append(next_token)
            token = next_token
        toks = torch.stack(emitted)
        if logprobs:
            toks = (toks, *(torch.stack(x) for x in zip(*lps)))
        return state, toks, halted

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
            logits, state, _ = profiled(
                "prefill", self._forward, torch.from_numpy(chunk).to(self.device), state,
                take, self._ctx_bucket(pos + i + bucket))
            if ring is not None:
                state["ring"] = _ring_push_chunk(ring, chunk[:take])
            i += take
        return logits, state

    def generate(self, prompt_tokens, max_new_tokens: int,
                 sampling: SamplingParams | None = None, stop_token_ids=None,
                 seed: int = 0, metrics: StreamMetrics | None = None) -> "TokenStream":
        """Token stream from a fresh state. Yields ints; stops on a stop
        token or the limit."""
        return self.generate_resumable(None, prompt_tokens, max_new_tokens, sampling=sampling,
                                       stop_token_ids=stop_token_ids, seed=seed,
                                       metrics=metrics)

    def generate_resumable(self, state: dict | None, prompt_tokens, max_new_tokens: int,
                           sampling: SamplingParams | None = None, stop_token_ids=None,
                           seed: int = 0, metrics: StreamMetrics | None = None,
                           logprobs: int = 0) -> "TokenStream":
        """Like generate(), but continues an existing decoding state (a
        chat session's prefix cache: the state holds every token but the
        last one yielded) and sets the final state as `.state` on the
        returned TokenStream once iteration finishes. `logprobs` > 0 fills
        `.logprob_content` with one (token_logprob, [(alt_id,
        alt_logprob), ...]) entry per yielded token."""
        return TokenStream(self, state, prompt_tokens, max_new_tokens, sampling,
                           stop_token_ids, seed, metrics, logprobs)

    def _generate_impl(self, init_state, prompt_tokens, max_new_tokens: int, sampling,
                       stop_token_ids, seed: int, metrics, logprobs: int, out: "TokenStream"):
        sampling = sampling or SamplingParams.from_generation_config(
            self.config.generation_config)
        stop = set(stop_token_ids if stop_token_ids is not None
                   else self.config.generation_config.stop_token_ids)
        ring_size = sampling.suffix_repetition_length if sampling.repetition_penalty else 0
        dev = self.device
        if init_state is None:
            state = self.new_state(ring_size=ring_size)
        else:
            state = init_state
            if ring_size and "ring" not in state:
                state["ring"] = torch.full((ring_size,), -1, dtype=torch.int32, device=dev)
        start_pos = int(state["pos"])

        t0 = time.perf_counter()
        logits, state = self.prefill(state, prompt_tokens)
        gen = torch.Generator(device=dev).manual_seed(seed)
        token = sample(logits, sampling, generator=gen, ring=state.get("ring"))
        val = int(token)
        if logprobs:
            out.logprob_content.append(_logprob_entry(
                *(x.tolist() for x in _logprobs(logits, token, logprobs))))
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
        base = start_pos + len(prompt_tokens)
        budget = min(max_new_tokens, self.max_context - base)
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
            ctx = self._ctx_bucket(base + produced + k)
            state, emitted, halted = profiled(
                "decode", self._decode_chunk, state, token, halted,
                torch.tensor(rem, dtype=torch.int32, device=dev), k, sampling, stop_ids, ctx,
                gen, logprobs)
            toks = emitted[0] if logprobs else emitted
            token = toks[-1]
            if metrics is not None:
                metrics.num_forward_passes += k
            # the chunk's one host sync (its log-probabilities come after it)
            rows = zip(*(x.tolist() for x in emitted)) if logprobs else \
                ((v,) for v in toks.tolist())
            for row in rows:
                if logprobs:
                    out.logprob_content.append(_logprob_entry(*row[1:]))
                produced += 1
                yield row[0]
                if row[0] in stop or produced >= budget:
                    done = True
                    break
        if metrics is not None:
            metrics.num_tokens_generated += produced
            metrics.decode_seconds += time.perf_counter() - t2
        out.state = state

    def generate_list(self, prompt_tokens, max_new_tokens: int, **kw) -> list[int]:
        return list(self.generate(prompt_tokens, max_new_tokens, **kw))


class TokenStream:
    """Iterable of generated token ids; `.state` holds the final decoding
    state once iteration completes (the session layer's prefix cache), and
    `.logprob_content` one entry per yielded token when logprobs were
    asked for."""

    def __init__(self, lm, state, prompt_tokens, max_new_tokens, sampling, stop_token_ids,
                 seed, metrics, logprobs: int = 0):
        self.state = None
        self.logprob_content: list = []
        self._gen = lm._generate_impl(state, prompt_tokens, max_new_tokens, sampling,
                                      stop_token_ids, seed, metrics, logprobs, self)

    def __iter__(self):
        return self._gen

    def __next__(self):
        return next(self._gen)


def _logprobs(logits: torch.Tensor, token: torch.Tensor, n: int):
    """(the f32 log-softmax of `logits` at `token`, the top `n` values and
    their ids), on the device."""
    lp = torch.log_softmax(logits.float(), dim=-1)
    top_v, top_i = torch.topk(lp, n)
    return lp[token], top_v, top_i


def _logprob_entry(lp, top_v, top_i) -> tuple:
    return float(lp), [(int(i), float(v)) for i, v in zip(top_i, top_v)]


def _ring_push_chunk(ring: torch.Tensor, tokens: np.ndarray) -> torch.Tensor:
    """Push a chunk's real tokens into the recent-token ring."""
    new = torch.as_tensor(tokens, dtype=ring.dtype, device=ring.device)
    return torch.cat([ring, new])[-ring.shape[0]:]


def _tensors(tree):
    """Every tensor of a parameter tree, inside quantized and hybrid
    leaves too."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _tensors(v)
    elif dataclasses.is_dataclass(tree):
        for f in dataclasses.fields(tree):
            yield from _tensors(getattr(tree, f.name))


def _map_leaves(tree, fn):
    """Apply `fn` to every leaf of a tree of dicts and lists (tensors,
    QuantizedTensors; None stays None)."""
    if isinstance(tree, dict):
        return {k: _map_leaves(v, fn) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map_leaves(v, fn) for v in tree]
    return None if tree is None else fn(tree)
