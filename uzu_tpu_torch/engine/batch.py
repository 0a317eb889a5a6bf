"""Continuous batching: requests, slots and the host-side scheduler parts.

Counterpart of the pieces of `uzu_tpu/engine/batch.py` that the paged
engine (`engine/paged_batch.py`) uses: `Request`, `_Slot`, and the
host-side methods `PagedBatchEngine` borrows from `BatchEngine`
(submission, cancel, prefix matching, per-slot sampling rows, count
penalties). They sit on `BatchEngineBase`, so the dense slot-per-request
`BatchEngine` can build on them when it is ported.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from .sampling import SamplingParams, pack_dynamic


@dataclasses.dataclass
class Request:
    id: int
    prompt: list[int]
    max_new_tokens: int
    seed: int = 0
    # grammar constraints need the speculative engines (not ported yet);
    # the chunked engines reject them at submit
    grammar: Optional[object] = None
    # per-request sampling override (OpenAI temperature/top_k/top_p/min_p):
    # the decode step samples every row with its own parameters
    sampling: Optional[SamplingParams] = None
    # OpenAI logprobs: top alternatives to report per emitted token (0 =
    # off), log-softmax of the raw model logits; filled as
    # [(token_logprob, [(alt_id, alt_logprob), ...]), ...]
    logprobs: int = 0
    logprob_content: list = dataclasses.field(default_factory=list)
    # OpenAI presence/frequency penalties over the generated token counts
    presence_penalty: float = 0.0
    frequency_penalty: float = 0.0
    # filled by the engine:
    tokens: list[int] = dataclasses.field(default_factory=list)
    finished: bool = False
    finish_reason: str = ""
    preempted: int = 0  # times evicted for recompute (paged engine)
    submitted_at: float = 0.0
    first_token_at: float = 0.0
    finished_at: float = 0.0

    @property
    def ttft(self) -> float:
        return self.first_token_at - self.submitted_at if self.first_token_at else 0.0


@dataclasses.dataclass
class _Slot:
    request: Optional[Request] = None
    produced: int = 0
    pos: int = 0  # host mirror of the device position
    # first token of a freshly admitted request, still on the device:
    # fetched with the next chunk's tokens, so admission never blocks
    pending_first: Optional[object] = None

    @property
    def free(self) -> bool:
        return self.request is None


class BatchEngineBase:
    """Host-side state and methods shared by the batch engines. A subclass
    sets `lm`, `batch_size`, `sampling`, `stop_ids`, `slots`, `queue`,
    `_admitting`, `_samp` and implements `_finish` and `_cancel_admitting`."""

    #: grammar-constrained requests need per-round host masks, which the
    #: fused K-step chunk engines do not have
    supports_grammar = False
    supports_count_penalties = True

    def _init_host_state(self, lm, batch_size: int, sampling, stop_token_ids) -> None:
        self.lm = lm
        self.batch_size = batch_size
        self.sampling = sampling or SamplingParams()
        self.stop_ids = tuple(sorted(
            stop_token_ids if stop_token_ids is not None
            else lm.config.generation_config.stop_token_ids))
        self.slots = [_Slot() for _ in range(batch_size)]
        self._next_id = 0
        self._admitting = None
        self._seeds = np.zeros(batch_size, np.int64)
        self._steps = np.zeros(batch_size, np.int64)
        # per-slot sampling rows (engine default until a request overrides)
        self._samp = np.tile(np.asarray(pack_dynamic(self.sampling), np.float32),
                             (batch_size, 1))
        self._counts = None

    def submit(self, prompt, max_new_tokens: int, seed: int = 0, grammar=None,
               sampling: SamplingParams | None = None, logprobs: int = 0,
               presence_penalty: float = 0.0, frequency_penalty: float = 0.0) -> Request:
        if not 0 <= logprobs <= 20:
            raise ValueError("logprobs must be in [0, 20]")
        if (presence_penalty or frequency_penalty) and not self.supports_count_penalties:
            raise ValueError("presence/frequency penalties are not supported by this engine")
        if grammar is not None and not self.supports_grammar:
            raise ValueError("grammar-constrained requests need per-round masks, which "
                             "this engine does not have")
        if sampling == self.sampling:
            sampling = None  # the engine default
        self._check_sampling_override(sampling)
        req = Request(id=self._next_id, prompt=[int(t) for t in prompt],
                      max_new_tokens=max_new_tokens, seed=seed, grammar=grammar,
                      sampling=sampling, logprobs=logprobs,
                      presence_penalty=float(presence_penalty),
                      frequency_penalty=float(frequency_penalty),
                      submitted_at=time.perf_counter())
        self._next_id += 1
        self.queue.append(req)
        return req

    @property
    def num_active(self) -> int:
        return sum(0 if s.free else 1 for s in self.slots)

    def cancel(self, req: Request, reason: str = "cancelled") -> bool:
        """Cancel a queued, admitting or running request. Safe while a chunk
        is in flight: the device runs work in stream order, so that chunk's
        writes land before any later admission into the reused slot, and
        the router drops emissions of finished requests."""
        if req.finished:
            return False
        if req in self.queue:
            self.queue.remove(req)
        elif self._admitting is not None and self._admitting[0] is req:
            self._cancel_admitting()
        else:
            for b, slot in enumerate(self.slots):
                if slot.request is req:
                    self._finish(b, reason)
                    return True
            return False
        req.finished = True
        req.finish_reason = reason
        req.finished_at = time.perf_counter()
        return True

    def _check_sampling_override(self, sampling: SamplingParams | None) -> None:
        """Reject overrides of fields the per-row path cannot honour,
        compared against the engine default."""
        if sampling is None:
            return
        if sampling.repetition_penalty != self.sampling.repetition_penalty:
            raise ValueError("per-request repetition_penalty is not supported in batched "
                             "serving (no per-slot recent-token ring)")
        if tuple(sampling.banned_tokens) != tuple(self.sampling.banned_tokens):
            raise ValueError("per-request banned_tokens is not supported in batched "
                             "serving (set it on the engine's default SamplingParams)")

    @staticmethod
    def _common_prefix(hist: list[int], prompt: list[int]) -> int:
        """Shared-prefix length, capped at len(prompt) - 1 so the tail
        prefill always feeds at least one token (and, in the paged engine,
        writes at or past the shared-page boundary)."""
        common = 0
        for a, c in zip(hist, prompt):
            if a != c:
                break
            common += 1
        return min(common, len(prompt) - 1)

    def _best_prefix(self, prompt: list[int]):
        """(src_slot, L): the longest common prefix between the prompt and
        a live slot's KV-resident history (its prompt and every routed
        token but the last, whose row may not be written yet)."""
        best_b, best_l = None, 0
        for b, s in enumerate(self.slots):
            if s.free:
                continue
            common = self._common_prefix(s.request.prompt + s.request.tokens[:-1], prompt)
            if common > best_l:
                best_b, best_l = b, common
        return best_b, best_l

    def _set_slot_sampling(self, slot_i: int, req: Request) -> None:
        sp = req.sampling if req.sampling is not None else self.sampling
        row = np.asarray(pack_dynamic(sp), np.float32)
        row[4] = req.presence_penalty
        row[5] = req.frequency_penalty
        self._samp[slot_i] = row

    def _live(self):
        return [b for b, s in enumerate(self.slots) if not s.free]

    def _penalized_now(self) -> bool:
        return any(self._samp[b, 4] != 0.0 or self._samp[b, 5] != 0.0 for b in self._live())

    def _ensure_counts(self) -> torch.Tensor:
        """Per-slot generated-token counts [B, V] int32 on the device,
        allocated once a penalized request arrives."""
        if self._counts is None:
            self._counts = torch.zeros((self.batch_size, self.lm.decoder_config.vocab_size),
                                       dtype=torch.int32, device=self.lm.device)
        return self._counts

    def _note_admission_counts(self, slot_i: int, req: Request, first) -> None:
        """Zero the admitted slot's count row and count its first token (the
        decode steps count only the tokens they sample)."""
        if req.presence_penalty == 0.0 and req.frequency_penalty == 0.0:
            return
        counts = self._ensure_counts()
        counts[slot_i].zero_()
        counts[slot_i].index_fill_(0, first.reshape(1).long(), 1)
