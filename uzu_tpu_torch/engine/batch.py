"""Continuous batching: multi-request serving on one model.

Counterpart of `uzu_tpu/engine/batch.py`: `Request`, `_Slot`, the
host-side scheduler shared by both batch engines (`BatchEngineBase`:
submission, cancel, prefix matching, per-slot sampling rows, count
penalties, grammar masks for the first token, the chunk pipeline of
`step`), and the dense slot-per-request
`BatchEngine`, which serves every model the port runs, recurrent hybrids
included (the paged engine, `engine/paged_batch.py`, takes standard
attention-only models).

`BatchEngine`'s design:
- the engine owns B slots; the batched decoding state is the per-slot
  state stacked on a leading [B] dimension (`LanguageModel.new_state(
  batch_size=B)`): KV [B, C, G, Dh], recurrent states [B, ...], pos [B];
- decode runs K fused steps per dispatch (`models/batch_decode.py`, one
  [B, D] step for all slots, then sampling, all on the device) with a
  per-slot halt flag and token budget: finished and empty slots take
  identity transitions, so ragged completion costs nothing extra; the
  host reads a chunk's [K, B] tokens with one copy, one chunk behind;
- a request is prefilled into a fresh single-sequence state with the
  ordinary chunked prefill (one chunk per scheduler step for a long
  prompt, so live streams keep decoding), then inserted into its slot;
  a prompt sharing a prefix of 64+ tokens with a live slot's history
  copies those KV rows instead (attention-only full-layout models: a
  recurrent state cannot be cut at an arbitrary prefix length, and a ring
  does not hold position j in slot j);
- the KV capacity starts at one context bucket and grows when a slot
  crosses it; with `ring_windows` it is pinned at max_context (a ring is
  position-modulo and cannot be row-copied across capacities), and each
  sliding-window layer keeps its ring of window + the largest prefill
  bucket slots;
- over a mesh (`LanguageModel(mesh=...)`), tp splits each slot's heads
  and widths inside the model and every dp rank holds and steps every
  slot, as the paged engines do (so every rank's host bookkeeping is the
  same with no exchange); B must still be a multiple of dp, the
  reference's check, where dp shards the slots.

Greedy outputs equal single-request generation up to summation order
(tests pin the streams). The model runs where `lm` runs (the card unless
it was loaded with `device="cpu"`).
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Optional

import numpy as np
import torch

from ..config.model import AttentionConfig
from ..models.batch_decode import batch_decode_step
from .sampling import (
    SamplingParams,
    apply_count_penalties,
    gumbel_noise,
    pack_dynamic,
    sample_dynamic,
)


class _HostCopy:
    """One device-to-host copy of several tensors, started now and waited
    for in `get` (values travel as f64: token ids and f32 values are
    exact in it). `n_lp` is the number of top logprobs the chunk carries."""

    def __init__(self, tensors: list[torch.Tensor], n_lp: int = 0):
        self.n_lp = n_lp
        self.shapes = [tuple(t.shape) for t in tensors]
        flat = torch.cat([t.reshape(-1).double() for t in tensors])
        self.event = None
        if flat.is_cuda:
            self.host = torch.empty(flat.shape, dtype=flat.dtype, pin_memory=True)
            self.host.copy_(flat, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record()
        else:
            self.host = flat

    def get(self) -> list[np.ndarray]:
        if self.event is not None:
            self.event.synchronize()
        flat = self.host.numpy()
        out, i = [], 0
        for shape in self.shapes:
            n = int(np.prod(shape))
            out.append(flat[i:i + n].reshape(shape))
            i += n
        return out


@dataclasses.dataclass
class Request:
    id: int
    prompt: list[int]
    max_new_tokens: int
    seed: int = 0
    # a GrammarSession: only the speculative engines (engine/batch_spec.py)
    # take one; the chunked engines reject it at submit
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
    calls `_init_host_state`, sets `queue`, `decode_chunk`, `admit_greedy`
    and `_pending`, and implements `_admit`, `_dispatch_decode`, `_finish`
    and `_cancel_admitting`. A dispatched chunk is (`_HostCopy` of its
    [K, B] tokens, then the first tokens of the slots admitted before it;
    snapshot {slot: (request, has_first, preemption count)})."""

    #: grammar-constrained requests need per-round host masks, which the
    #: fused K-step chunk engines do not have (the speculative engines do)
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
        if grammar is not None:
            if not self.supports_grammar:
                raise ValueError("grammar-constrained requests need per-round masks; use a "
                                 "speculative engine (SpeculativeBatchEngine / "
                                 "SpeculativePagedBatchEngine)")
            grammar.stop_token_ids = sorted(self.stop_ids) or grammar.stop_token_ids
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

    def _sample_rows(self, logits, rows, key0, key1, sampled: bool, counts=None,
                     bitmask=None):
        """Sample logits [N, V] with sampling rows [N, 6] (f32, on the
        device) and noise keys key0/key1 [N]; `sampled` is False when every
        row is greedy (no noise is drawn); count penalties where `counts`
        is given, grammar masks [N, V] where `bitmask` is."""
        if counts is not None:
            logits = apply_count_penalties(logits.float(), counts, rows[:, 4:5], rows[:, 5:6])
        noise = gumbel_noise(key0, key1, logits.shape[-1]) if sampled else None
        return sample_dynamic(logits, rows[:, 0], rows[:, 1], rows[:, 2], rows[:, 3], noise,
                              bitmask=bitmask, banned_tokens=self.sampling.banned_tokens)

    def _grammar_first_mask(self, req: Request):
        """[1, V] mask of a grammar request's first token (the constrained
        loop masks the prefill's sample too); None when unconstrained or
        the grammar's trigger has not engaged."""
        if req.grammar is None:
            return None
        m = req.grammar.current_mask()
        if m is None:
            return None
        from ..grammar.decode import _pad_mask

        vocab = self.lm.decoder_config.vocab_size
        return torch.from_numpy(_pad_mask(m, vocab)[None].copy()).to(self.lm.device)

    @staticmethod
    def _logprobs(logits, tokens, n: int):
        """(token logprob [N], top values [N, n], top ids [N, n]) of the raw
        logits' log-softmax."""
        lp = torch.log_softmax(logits.float(), dim=-1)
        top_v, top_i = torch.topk(lp, n, dim=-1)
        return lp.gather(-1, tokens[:, None].long())[:, 0], top_v, top_i

    def _first_token(self, slot_i: int, req: Request, logits: torch.Tensor) -> list:
        """Sample an admitted request's first token from its prefill logits
        [V] with its own sampling row (noise keys (0, seed)); returns the
        device tensors that ride the next chunk's host copy: [token [1]],
        and its logprobs where the request asks for them."""
        self._set_slot_sampling(slot_i, req)
        dev = self.lm.device
        rows = torch.as_tensor(self._samp[slot_i:slot_i + 1], device=dev)
        first = self._sample_rows(
            logits[None], rows, torch.zeros(1, dtype=torch.long, device=dev),
            torch.full((1,), req.seed, dtype=torch.long, device=dev),
            bool(self._samp[slot_i, 0] > 0), bitmask=self._grammar_first_mask(req))
        pending = [first]
        if req.logprobs:
            pending += list(self._logprobs(logits[None], first, req.logprobs))
        return pending

    def _noise_keys(self, k: int):
        """Per-slot noise key words for a K-step chunk: key0 [B] from the
        request's seed, key1 [K, B] from its step index since admission, so
        a stream depends only on its seed and its own steps."""
        dev = self.lm.device
        key0 = torch.as_tensor(self._seeds & 0xFFFFFFFF, device=dev)
        key1 = torch.as_tensor((self._steps[None, :] * k + np.arange(k)[:, None])
                               & 0xFFFFFFFF, device=dev)
        return key0, key1

    def _snapshot(self, parts: list, live: list, n_lp: int):
        """Count the chunk as a step of every live slot, hand its pending
        first tokens to the chunk's host copy, and return (copy, snapshot)."""
        snapshot = {}
        for b in live:
            slot = self.slots[b]
            self._steps[b] += 1
            first = slot.pending_first
            snapshot[b] = (slot.request, first is not None, slot.request.preempted)
            if first is not None:
                parts += first
            slot.pending_first = None
        return _HostCopy(parts, n_lp), snapshot

    def _process_emitted(self, copy: _HostCopy, snapshot):
        """Route a dispatched chunk's tokens (and the first tokens of
        requests admitted before it) to their requests. Finishing mirrors
        the device-side halt exactly, so the host may lag one chunk. A
        request preempted while its chunk was in flight is skipped: its
        stream restarts on re-admission."""
        arrays = copy.get()
        vals = arrays[0]  # [K, B]
        lp_pack = arrays[1:4] if copy.n_lp else None
        rest = arrays[4 if copy.n_lp else 1:]
        k = vals.shape[0]
        now = time.perf_counter()
        for b, (req, has_first, preempted) in snapshot.items():
            stream = []
            if has_first:
                tok = rest.pop(0)
                entry = None
                if req.logprobs:
                    lp, top_v, top_i = rest.pop(0), rest.pop(0), rest.pop(0)
                    entry = (float(lp[0]), [(int(i), float(v))
                                            for i, v in zip(top_i[0], top_v[0])])
                stream.append((int(tok[0]), 0, entry))
            if req is None or req.finished or req.preempted != preempted:
                continue
            if has_first:
                req.first_token_at = now
            slot = self.slots[b]
            for s in range(k):
                entry = None
                if lp_pack is not None:
                    lp, top_v, top_i = lp_pack
                    entry = (float(lp[s, b]), [(int(i), float(v)) for i, v in
                                               zip(top_i[s, b][:req.logprobs],
                                                   top_v[s, b][:req.logprobs])])
                stream.append((int(vals[s, b]), 1, entry))
            for v, adv, lpe in stream:
                req.tokens.append(v)
                if req.logprobs and lpe is not None:
                    req.logprob_content.append(lpe)
                slot.produced += 1
                slot.pos += adv
                if v in self.stop_ids:
                    self._finish(b, "stop")
                    break
                if slot.produced >= req.max_new_tokens:
                    self._finish(b, "length")
                    break
                if slot.pos >= self.lm.max_context - 1:
                    self._finish(b, "length")
                    break

    def _drains_all(self, snapshot) -> bool:
        """True if the in-flight chunk surely finishes every active slot,
        so another chunk would only run discarded identity steps."""
        k = self.decode_chunk
        for b, slot in enumerate(self.slots):
            if slot.free:
                continue
            entry = snapshot.get(b)
            if entry is None:
                return False  # admitted after the dispatch; needs a chunk
            req, has_first, _ = entry
            budget = slot.produced + (1 if has_first else 0) + k
            if budget < req.max_new_tokens and slot.pos + k < self.lm.max_context - 1:
                return False
        return True

    def step(self) -> bool:
        """One scheduling action; returns False when fully idle. Admission
        fills every free slot before a decode chunk is paid for (unless
        `admit_greedy` is off: at most one admission between chunks)."""
        admitted = False
        while self._admit():
            admitted = True
            if self.num_active and not self.admit_greedy:
                break
            if self.num_active >= self.batch_size:
                break
        pending, self._pending = self._pending, None
        # drain first: if the in-flight chunk surely finishes every active
        # slot and nothing is queued, read it instead of dispatching a chunk
        # of identity steps
        if pending is not None and not self.queue and self._drains_all(pending[1]):
            self._process_emitted(*pending)
            pending = None
        if self.num_active:
            self._pending = self._dispatch_decode()
        if pending is not None:
            self._process_emitted(*pending)
        return bool(self._pending or pending or admitted or self.queue or self._admitting)

    def run(self) -> None:
        """Drive until all submitted requests finish."""
        while self.queue or self.num_active or self._pending or self._admitting:
            self.step()


class BatchEngine(BatchEngineBase):
    """Dense continuous batching: one whole-context state per slot."""

    def __init__(
        self,
        lm,
        *,
        batch_size: int = 4,
        decode_chunk: int = 8,
        sampling: SamplingParams | None = None,
        stop_token_ids=None,
        prefix_min: int = 64,
        admit_greedy: bool = True,
    ):
        """prefix_min: shortest shared prompt prefix worth admitting through
        the KV-row copy (0 turns sharing off); it applies to attention-only
        models only. admit_greedy: fill every free slot before a decode
        chunk (False: at most one admission between decode chunks)."""
        self._init_host_state(lm, batch_size, sampling, stop_token_ids)
        if lm.mesh is not None:
            from ..parallel.mesh import dp_size

            if batch_size % dp_size(lm.mesh):
                raise ValueError(f"batch_size={batch_size} must be a multiple of the mesh's "
                                 f"dp={dp_size(lm.mesh)}")
        self.decode_chunk = decode_chunk
        self.admit_greedy = admit_greedy
        self.queue: deque[Request] = deque()
        # KV capacity starts at one context bucket and grows on crossing;
        # ring layouts are position-modulo and cannot be row-copied across
        # capacities, so they pin it at max_context
        self._ctx_cap = (lm.max_context if lm.ring_windows
                         else lm._ctx_bucket(1) or lm.max_context)
        self._state = lm.new_state(batch_size=batch_size, ctx_capacity=self._ctx_cap)
        dev = lm.device
        self._tokens = torch.zeros(batch_size, dtype=torch.long, device=dev)
        self._halted = torch.ones(batch_size, dtype=torch.bool, device=dev)  # empty slots halt
        # device-side budget, mirroring the host's finish conditions so an
        # in-flight chunk cannot overrun them while the host lags a chunk
        self._remaining = torch.zeros(batch_size, dtype=torch.int32, device=dev)
        self._stop = (torch.as_tensor(self.stop_ids, dtype=torch.long, device=dev)
                      if self.stop_ids else None)
        self._pending = None
        # slots whose request overrides the engine's sampling (or carries
        # count penalties): only then do the chunk's rows leave the host
        self._samp_custom = np.zeros(batch_size, bool)
        self._default_rows = torch.as_tensor(self._samp, device=dev)
        # shared-prefix admission: attention-only full-layout models (a
        # recurrent state cannot be cut at an arbitrary prefix length, and
        # a ring does not hold position j in slot j)
        self.prefix_min = prefix_min if not lm.ring_windows and all(
            isinstance(lc.mixer_config, AttentionConfig)
            for lc in lm.decoder_config.transformer_config.layer_configs) else 0
        # work counts: prefill chunks run, decode chunks dispatched, prompt
        # tokens whose prefill the prefix copy skipped
        self.stats = {"prefill_chunks": 0, "decode_chunks": 0, "shared_prefix_tokens": 0}

    # -- slot state ----------------------------------------------------------

    def _set_slot_sampling(self, slot_i: int, req: Request) -> None:
        super()._set_slot_sampling(slot_i, req)
        self._samp_custom[slot_i] = (req.sampling is not None or req.presence_penalty != 0.0
                                     or req.frequency_penalty != 0.0)

    def _dynamic_now(self) -> bool:
        return any(self._samp_custom[b] for b in self._live())

    def _ensure_ctx(self, needed: int) -> None:
        """Grow the batched KV capacity to the context bucket covering
        `needed` positions (and the admission in progress with it)."""
        cap = self.lm._ctx_bucket(needed) or self.lm.max_context
        if cap <= self._ctx_cap:
            return
        self._ctx_cap = cap
        self._state = self._grown(self._state, cap, batch=True)
        if self._admitting is not None:
            self._admitting[1] = self._grown(self._admitting[1], cap, batch=False)

    def _grown(self, state: dict, new_cap: int, *, batch: bool) -> dict:
        """A fresh state of capacity `new_cap` holding `state`'s rows (the
        context axis is 1 in the batched state, 0 in a single one)."""
        fresh = self.lm.new_state(batch_size=self.batch_size if batch else 0,
                                  ctx_capacity=new_cap)
        axis = 1 if batch else 0

        def copy(f, o):
            if f.shape == o.shape:
                return o
            f.narrow(axis, 0, o.shape[axis]).copy_(o)
            return f

        fresh["layers"] = [None if f is None else {k: copy(f[k], o[k]) for k in f}
                           for f, o in zip(fresh["layers"], state["layers"])]
        fresh["pos"] = state["pos"]
        return fresh

    def _insert(self, slot_i: int, slot_state: dict, first: torch.Tensor,
                remaining0: int) -> None:
        """A single-sequence state into slot `slot_i` of the batched state,
        with its first token, budget and halt flag (the JAX engine's
        `_insert_fn`)."""
        for f, o in zip(self._state["layers"], slot_state["layers"]):
            if f is not None:
                for k in f:
                    f[k][slot_i].copy_(o[k])
        self._state["pos"][slot_i] = slot_state["pos"]
        self._tokens[slot_i] = first.reshape(())
        self._halted[slot_i] = False
        self._remaining[slot_i] = remaining0

    def _copy_prefix(self, src: int, prefix_len: int) -> dict:
        """A fresh single-sequence state whose first `prefix_len` cache rows
        are live slot `src`'s (slot j holds position j, so they are what the
        new request's own prefill would write), with pos = prefix_len."""
        fresh = self.lm.new_state(ctx_capacity=self._ctx_cap)
        for f, b in zip(fresh["layers"], self._state["layers"]):
            if f is not None:
                for k in f:
                    f[k][:prefix_len].copy_(b[k][src, :prefix_len])
        fresh["pos"].fill_(prefix_len)
        return fresh

    # -- scheduling ----------------------------------------------------------

    def _admit(self) -> bool:
        """Advance admission by one prefill chunk. A prompt that fits the
        largest prefill bucket admits at once (the JAX engine's fused
        `_admit_fn`); a longer one prefills one chunk per call into a
        reserved slot's fresh state and is inserted after its last chunk."""
        if self._admitting is not None:
            return self._admit_advance_long()
        if not self.queue:
            return False
        slot_i = next((i for i, s in enumerate(self.slots) if s.free), None)
        if slot_i is None:
            return False
        req = self.queue.popleft()
        n = len(req.prompt)
        # capacity before anything touches the batched state
        self._ensure_ctx(n + 2 * self.decode_chunk + 1)
        if self.prefix_min:
            src, pl = self._best_prefix(req.prompt)
            if src is not None and pl >= self.prefix_min:
                self.stats["shared_prefix_tokens"] += pl
                self._admitting = [req, self._copy_prefix(src, pl), pl, slot_i]
                return self._admit_advance_long()
        self._admitting = [req, self.lm.new_state(ctx_capacity=self._ctx_cap), 0, slot_i]
        return self._admit_advance_long()

    def _admit_advance_long(self) -> bool:
        """One prefill chunk of the admission in progress; after the last
        one, sample the first token and insert the state into its slot."""
        req, state, i, slot_i = self._admitting
        lm = self.lm
        n = len(req.prompt)
        take = min(n - i, lm.prefill_buckets[-1])
        bucket = next(b for b in lm.prefill_buckets if b >= take)
        chunk = np.zeros(bucket, np.int64)
        chunk[:take] = req.prompt[i:i + take]
        logits, state, _ = lm._forward(torch.from_numpy(chunk).to(lm.device), state, take,
                                       lm._ctx_bucket(i + bucket))
        self.stats["prefill_chunks"] += 1
        i += take
        if i < n:
            self._admitting = [req, state, i, slot_i]
            return True
        self._admitting = None
        pending = self._first_token(slot_i, req, logits)
        self._insert(slot_i, state, pending[0], max(0, req.max_new_tokens - 1))
        self._finish_admission(slot_i, req, pending)
        return True

    def _finish_admission(self, slot_i: int, req: Request, pending: list) -> None:
        # no host read here: the first token rides the next chunk's copy
        slot = self.slots[slot_i]
        slot.request = req
        slot.produced = 0
        slot.pos = len(req.prompt)
        slot.pending_first = pending
        self._seeds[slot_i] = req.seed ^ 0xBA7C
        self._steps[slot_i] = 0
        self._note_admission_counts(slot_i, req, pending[0])

    def _cancel_admitting(self) -> None:
        self._admitting = None

    def _finish(self, slot_i: int, reason: str):
        slot = self.slots[slot_i]
        req = slot.request
        req.finished = True
        req.finish_reason = reason
        req.finished_at = time.perf_counter()
        slot.request = None
        self._halted[slot_i] = True

    def _decode_chunk(self, k: int, rows, sampled: bool, counts, n_lp: int, ctx):
        """K fused decode steps over every slot, all on the device; returns
        the emitted [token [B], (logprobs)] of each step."""
        lm = self.lm
        cfg = lm.decoder_config
        key0, key1 = self._noise_keys(k)
        tokens, halted, remaining = self._tokens, self._halted, self._remaining
        state = self._state
        ctx_last = lm.max_context - 1
        emitted = []
        for t in range(k):
            fed = (~halted).to(torch.int32)
            logits, state = batch_decode_step(cfg, lm.params, tokens, state, fed, ctx)
            nxt = self._sample_rows(logits, rows, key0, key1[t], sampled, counts)
            nxt = torch.where(halted, tokens, nxt)
            if counts is not None:
                counts.index_put_((torch.arange(self.batch_size, device=lm.device), nxt), fed,
                                  accumulate=True)
            emitted.append([nxt, *self._logprobs(logits, nxt, n_lp)] if n_lp else [nxt])
            remaining = remaining - fed
            if self._stop is not None:
                halted = halted | torch.isin(nxt, self._stop)
            # the device-side budget and context halt mirror the host's
            # finish conditions, so an in-flight chunk cannot overrun them
            halted = halted | (remaining <= 0) | (state["pos"] >= ctx_last)
            tokens = nxt
        self._state = state
        self._tokens, self._halted, self._remaining = tokens, halted, remaining
        return emitted

    def _dispatch_decode(self):
        """Enqueue one fused K-step chunk and start the copy of its tokens;
        returns (host copy, snapshot) without waiting for either."""
        k = self.decode_chunk
        live = self._live()
        # context bucket from the host's position mirror; the 2k margin
        # covers the chunk in flight that the mirror has not read yet
        max_pos = max(self.slots[b].pos for b in live)
        self._ensure_ctx(max_pos + 2 * k + 1)
        penalized = self._penalized_now()
        rows = (torch.as_tensor(self._samp, device=self.lm.device) if self._dynamic_now()
                else self._default_rows)
        n_lp = max(self.slots[b].request.logprobs for b in live)
        emitted = self._decode_chunk(
            k, rows, any(self._samp[b, 0] > 0 for b in live),
            self._ensure_counts() if penalized else None, n_lp,
            self.lm._ctx_bucket(max_pos + 2 * k + 1))
        self.stats["decode_chunks"] += 1
        parts = [torch.stack(col) for col in zip(*emitted)]  # [K, B, ...] each
        return self._snapshot(parts, live, n_lp)
