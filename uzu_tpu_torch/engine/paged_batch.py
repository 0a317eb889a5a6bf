"""Continuous batching over a PAGED KV cache.

Counterpart of `uzu_tpu/engine/paged_batch.py`. Slots draw fixed pages
from shared per-layer pools (`models/paged_kv.py`), so KV memory follows
the tokens actually held, and a shared prompt prefix is one set of
physical pages. Over a mesh the pools are made from the model's
rank-local config, so they split on the KV-group dim over tp; every dp
rank holds every slot, as in the reference.

- Admission prefills one chunk per scheduler step straight into the
  slot's pages (`paged_prefill_chunk`); a prompt that shares full pages
  with a live slot's history, or with a finished request's history kept
  by the automatic prefix cache, points at those pages and starts its
  prefill past them.
- Decode runs K fused steps per dispatch (`paged_decode_step`, then
  sampling, all on the device) with a device-side halt flag and token
  budget per slot. The host reads a chunk's [K, B] tokens with one copy,
  one chunk behind the dispatch: the copy is started when the chunk is
  enqueued and waited for after the next chunk has been enqueued, so the
  device never waits for the host to read tokens.
- Under pool pressure the prefix cache yields first, then the youngest
  request is preempted and recomputed later; its stream comes out the
  same, because its sampling noise depends only on its seed and its step
  index since admission.

The model runs where `lm` runs (the card unless it was loaded with
`device="cpu"`).
"""

from __future__ import annotations

import time
from collections import OrderedDict, deque

import numpy as np
import torch

from ..models.paged_decode import paged_decode_step, paged_prefill_chunk, paged_supported
from ..models.paged_kv import PagePool, PagePoolOverflow, init_pools
from ..tools.profile import SPANS, torch_profiler
from .batch import BatchEngineBase, Request
from .engine import LanguageModel
from .sampling import SamplingParams


class PagedBatchEngine(BatchEngineBase):
    def __init__(
        self,
        lm: LanguageModel,
        *,
        batch_size: int = 4,
        decode_chunk: int = 8,
        num_pages: int = 256,
        page_size: int | None = None,
        sampling: SamplingParams | None = None,
        stop_token_ids=None,
        apc_max_entries: int = 16,
        admit_greedy: bool = True,
    ):
        """apc_max_entries: the automatic prefix cache keeps finished
        requests' full KV pages (refcounted, at most this many entries in
        LRU order; 0 turns it off), so a later request that extends their
        history shares them instead of prefilling again; pool pressure
        evicts these entries before any live request is preempted.
        admit_greedy: admit until every slot is live before a decode chunk
        (False: at most one admission between decode chunks)."""
        if not paged_supported(lm.decoder_config):
            raise ValueError("paged engine supports standard attention-only models")
        if lm.ring_windows:
            raise ValueError("paged engine uses full-layout pools (no ring)")
        if page_size is None:
            # the JAX package's rule, chosen from its TPU page sweeps; kept
            # so that both allocate pages alike (not tuned for the H100)
            if lm.max_context >= 4096 and lm.max_context % 512 == 0:
                page_size = 512
            else:
                page_size = next((p for p in (256, 128, 64)
                                  if lm.max_context % p == 0 and lm.max_context >= 4 * p), 64)
        if lm.max_context % page_size:
            raise ValueError("max_context must be a multiple of page_size")
        self._init_host_state(lm, batch_size, sampling, stop_token_ids)
        self.decode_chunk = decode_chunk
        self.admit_greedy = admit_greedy
        self.page_size = page_size
        self.max_pages = -(-lm.max_context // page_size)
        # the last page takes every write that must land nowhere
        self.pool = PagePool(num_pages=num_pages - 1, page_size=page_size)
        self._trash_page = num_pages - 1
        self.pools = init_pools(lm.decoder_config, num_pages, page_size,
                                quantized=lm.kv_quant, device=lm.device)
        self.queue: deque[Request] = deque()
        self._admit_order: dict[int, int] = {}  # slot -> admission sequence
        self._admit_seq = 0
        # automatic prefix cache: retired id (negative pool keys, apart from
        # slot indices) -> KV-resident history, in LRU order
        self.apc_max_entries = apc_max_entries
        self._retired: OrderedDict[int, list[int]] = OrderedDict()
        self._retire_seq = -1
        dev = lm.device
        self._tokens = torch.zeros(batch_size, dtype=torch.long, device=dev)
        self._positions = torch.zeros(batch_size, dtype=torch.int32, device=dev)
        self._halted = torch.ones(batch_size, dtype=torch.bool, device=dev)
        # device-side budget, mirroring the host's finish conditions so an
        # in-flight chunk cannot overrun them while the host lags a chunk
        self._remaining = torch.zeros(batch_size, dtype=torch.int32, device=dev)
        self._stop = (torch.as_tensor(self.stop_ids, dtype=torch.long, device=dev)
                      if self.stop_ids else None)
        self._pending = None  # (host copy of the in-flight chunk, snapshot)
        # work counts: prefill chunks run, fused decode chunks dispatched,
        # prompt tokens whose prefill page sharing skipped, requests taken
        # from the queue, requests preempted, the prompt and sampled tokens
        # those preemptions threw away (computed again on re-admission),
        # prefix-cache entries evicted
        self.stats = {"prefill_chunks": 0, "decode_chunks": 0, "shared_prefix_tokens": 0,
                      "admissions": 0, "preemptions": 0, "recomputed_tokens": 0,
                      "prefix_cache_evictions": 0}

    # -- device work -------------------------------------------------------

    def _ctx_pages(self, needed_tokens: int) -> int:
        """Pages covering the smallest context bucket for `needed_tokens`
        (bounds a prefill chunk's gathered view as the dense engine's
        bucket bounds its cache reads)."""
        b = self.lm._ctx_bucket(needed_tokens)
        ctx = b if b is not None else self.lm.max_context
        return min(-(-ctx // self.page_size), self.max_pages)

    # -- scheduling ----------------------------------------------------------

    def _admit(self) -> bool:
        if self._admitting is not None:
            return self._admit_advance()
        if not self.queue:
            return False
        slot_i = next((i for i, s in enumerate(self.slots) if s.free), None)
        if slot_i is None:
            return False
        # backpressure: a prompt that can never fit fails at once; one that
        # can fit later waits until releases free enough pages
        peek = self.queue[0]
        needed = -(-(len(peek.prompt) + 1) // self.page_size)
        if needed > self.pool.num_pages:
            self.queue.popleft()
            if torch_profiler._is_profiler_enabled:
                SPANS.gauge("engine.queued", len(self.queue))
            peek.finished = True
            peek.finish_reason = "length"
            peek.finished_at = time.perf_counter()
            return True
        if peek.preempted:
            # a preempted request re-enters only when its full need fits,
            # or admission and preemption would take turns forever
            needed = min(-(-(len(peek.prompt) + peek.max_new_tokens + 1) // self.page_size),
                         self.pool.num_pages)

        # match the prefix first: sharing lowers the new pages needed and
        # names the donor that eviction must spare. Full pages of the
        # longest common prefix with a live slot's or a retired entry's
        # KV-resident history are shared, and the prefill starts past them;
        # the match is capped at len(prompt) - 1, so the admission never
        # writes a donor's page and decode writes land past the shared ones
        n = len(peek.prompt)
        best_src, common = self._best_prefix(peek.prompt)
        shared_pages = common // self.page_size if best_src is not None else 0
        for rid in reversed(self._retired):  # most recently used first
            cand = self._common_prefix(self._retired[rid], peek.prompt) // self.page_size
            if cand > shared_pages:
                best_src, shared_pages = rid, cand
        needed_new = max(0, needed - shared_pages)
        if needed_new > self.pool.free_pages:
            self._evict_retired(needed_new, keep=best_src)
        if needed_new > self.pool.free_pages:
            return False
        req = self.queue.popleft()
        self.stats["admissions"] += 1
        if torch_profiler._is_profiler_enabled:
            SPANS.gauge("engine.queued", len(self.queue))

        if best_src is not None and shared_pages > 0:
            self.pool.share_prefix(best_src, slot_i, shared_pages)
            if best_src in self._retired:
                self._retired.move_to_end(best_src)
        else:
            self.pool.release(slot_i)
        pages = self.pool.ensure(slot_i, n + 1)
        # unused entries and the sentinel entry [max_pages] are the trash
        # page (padded prefill rows write there)
        table_row = np.full(self.max_pages + 1, self._trash_page, np.int32)
        table_row[: len(pages)] = pages
        # prefill at least one token, so the last chunk gives the first
        # sample's logits even for a prompt shared page for page
        start = min(shared_pages * self.page_size, max(0, n - 1))
        self.stats["shared_prefix_tokens"] += start
        self._admitting = [req, start, slot_i,
                           torch.as_tensor(table_row, device=self.lm.device)]
        return self._admit_advance()

    def _admit_advance(self) -> bool:
        """One paged prefill chunk of the admission in progress; the last
        chunk's logits sample the first token."""
        req, i, slot_i, table_row = self._admitting
        lm = self.lm
        n = len(req.prompt)
        take = min(n - i, lm.prefill_buckets[-1])
        bucket = next(b for b in lm.prefill_buckets if b >= take)
        chunk = np.zeros(bucket, np.int64)
        chunk[:take] = req.prompt[i:i + take]
        logits = paged_prefill_chunk(
            lm.decoder_config, lm.params, self.pools,
            torch.from_numpy(chunk).to(lm.device), table_row, i, take,
            self._ctx_pages(i + bucket))
        self.stats["prefill_chunks"] += 1
        i += take
        if i < n:
            self._admitting = [req, i, slot_i, table_row]
            return True
        self._admitting = None
        pending = self._first_token(slot_i, req, logits)
        first = pending[0]
        self._tokens[slot_i] = first[0]
        self._positions[slot_i] = n
        self._halted[slot_i] = False
        self._remaining[slot_i] = max(0, req.max_new_tokens - 1)

        slot = self.slots[slot_i]
        slot.request = req
        slot.produced = 0
        slot.pos = n
        slot.pending_first = pending
        self._seeds[slot_i] = req.seed ^ 0xBA7C
        self._steps[slot_i] = 0
        self._note_admission_counts(slot_i, req, first)
        self._admit_order[slot_i] = self._admit_seq
        self._admit_seq += 1
        return True

    def _cancel_admitting(self) -> None:
        _, _, slot_i, _ = self._admitting
        self._admitting = None
        self.pool.release(slot_i)

    def _retire_slot(self, slot_i: int, req: Request) -> None:
        """Keep the slot's complete KV pages in the automatic prefix cache
        before release: only pages wholly inside the request's KV-resident
        history (prompt + routed tokens but the last), so an in-flight
        chunk's writes, which land past that history, never touch them."""
        if not self.apc_max_entries:
            return
        hist = req.prompt + req.tokens[:-1]
        full = min(len(hist) // self.page_size, len(self.pool.pages(slot_i)))
        if full <= 0:
            return
        rid = self._retire_seq
        self._retire_seq -= 1
        self.pool.share_prefix(slot_i, rid, full)
        self._retired[rid] = hist[: full * self.page_size]
        while len(self._retired) > self.apc_max_entries:
            old, _ = self._retired.popitem(last=False)
            self.pool.release(old)
            self.stats["prefix_cache_evictions"] += 1

    def _evict_retired(self, need_pages: int, keep=None) -> bool:
        """Free LRU prefix-cache entries until `need_pages` pages are free
        or the cache is empty, sparing `keep`. True if any was evicted."""
        evicted = False
        for rid in list(self._retired):
            if self.pool.free_pages >= need_pages:
                break
            if rid == keep:
                continue
            del self._retired[rid]
            self.pool.release(rid)
            self.stats["prefix_cache_evictions"] += 1
            evicted = True
        return evicted

    def _finish(self, slot_i: int, reason: str):
        slot = self.slots[slot_i]
        req = slot.request
        req.finished = True
        req.finish_reason = reason
        req.finished_at = time.perf_counter()
        slot.request = None
        self._retire_slot(slot_i, req)
        self.pool.release(slot_i)
        self._admit_order.pop(slot_i, None)
        self._halted[slot_i] = True

    def _preempt(self, slot_i: int):
        """Evict a slot for recompute: release its pages and requeue its
        request at the front, from scratch."""
        slot = self.slots[slot_i]
        req = slot.request
        self.stats["preemptions"] += 1
        self.stats["recomputed_tokens"] += len(req.prompt) + len(req.tokens)
        req.tokens = []
        req.logprob_content = []
        req.preempted += 1
        if req.grammar is not None:
            # the replayed stream observes every token again from the start
            req.grammar.reset()
        slot.request = None
        self.pool.release(slot_i)
        self._admit_order.pop(slot_i, None)
        self._halted[slot_i] = True
        self.queue.appendleft(req)
        if torch_profiler._is_profiler_enabled:
            SPANS.gauge("engine.queued", len(self.queue))

    def _tables_host(self) -> np.ndarray:
        """[B, MAXP] page tables on the host. Free slots and unused entries
        point at the trash page, where a free or halted slot's stale K/V
        writes are harmless (its reads are masked by length)."""
        rows = np.full((self.batch_size, self.max_pages), self._trash_page, np.int32)
        for i, slot in enumerate(self.slots):
            if not slot.free:
                pages = self.pool.pages(i)
                rows[i, : len(pages)] = pages
        return rows

    def _grow_or_preempt(self, k: int) -> None:
        """Reserve pages for this chunk and the one in flight (the host's
        position mirror lags by up to one chunk: a 2K margin)."""
        self._reserve_pages(lambda slot: slot.pos + min(
            2 * k, max(slot.request.max_new_tokens - slot.produced, 1)))

    def _reserve_pages(self, tokens_of) -> None:
        """Pages for `tokens_of(slot)` tokens of every live slot (at most
        max_context). On overflow the prefix cache yields first, then the
        youngest live request is preempted; a request alone in the pool
        that still cannot grow finishes as "length"."""
        for i, slot in enumerate(self.slots):
            while not slot.free:
                want = min(tokens_of(slot), self.lm.max_context)
                try:
                    self.pool.ensure(i, want)
                    break
                except PagePoolOverflow:
                    short = -(-want // self.page_size) - len(self.pool.pages(i))
                    if self._evict_retired(short):
                        continue
                    live = [j for j in self._admit_order if not self.slots[j].free]
                    youngest = max(live, key=self._admit_order.__getitem__)
                    if youngest == i and len(live) == 1:
                        self._finish(i, "length")
                    else:
                        self._preempt(youngest)

    def _dispatch_decode(self):
        """Enqueue one fused K-step chunk and start the copy of its tokens;
        returns (host copy, snapshot) without waiting for either."""
        sp = (SPANS.begin("engine.decode_dispatch") if torch_profiler._is_profiler_enabled
              else None)
        k = self.decode_chunk
        self._grow_or_preempt(k)
        if not self.num_active:
            if sp is not None:
                SPANS.end(sp, steps=0)
            return None
        lm = self.lm
        dev = lm.device
        live = self._live()
        penalized = self._penalized_now()
        sampled = any(self._samp[b, 0] > 0 for b in live)
        n_lp = max(self.slots[b].request.logprobs for b in live)
        rows = torch.as_tensor(self._samp, device=dev)
        key0, key1 = self._noise_keys(k)
        counts = self._ensure_counts() if penalized else None
        # tables cut to the pages of the live context bucket, plus one
        # trash column: the host mirror lags the in-flight chunk by <= k
        # and this chunk advances <= k more, so cover pos + 2k
        max_pos = max(self.slots[b].pos for b in live)
        ctx_pages = self._ctx_pages(max_pos + 2 * k + 1)
        th = self._tables_host()
        tables = torch.as_tensor(np.concatenate(
            [th[:, :ctx_pages], np.full((self.batch_size, 1), self._trash_page, np.int32)],
            axis=1), device=dev)

        tokens, positions = self._tokens, self._positions
        halted, remaining = self._halted, self._remaining
        max_pos_dev = lm.max_context - 1
        emitted = []
        for t in range(k):
            fed = (~halted).to(torch.int32)
            logits = paged_decode_step(lm.decoder_config, lm.params, self.pools, tokens,
                                       tables, positions)
            nxt = self._sample_rows(logits, rows, key0, key1[t], sampled, counts)
            nxt = torch.where(halted, tokens, nxt)
            if counts is not None:
                counts.index_put_((torch.arange(self.batch_size, device=dev), nxt), fed,
                                  accumulate=True)
            emitted.append([nxt, *self._logprobs(logits, nxt, n_lp)] if n_lp else [nxt])
            remaining = remaining - fed
            if self._stop is not None:
                halted = halted | torch.isin(nxt, self._stop)
            # every slot that fed a real token advances, the step that
            # samples a stop included, so a held token's writes land past
            # the history rows that sharing and the prefix cache hand out
            positions = positions + fed
            halted = halted | (positions >= max_pos_dev) | (remaining <= 0)
            tokens = nxt
        self._tokens, self._positions = tokens, positions
        self._halted, self._remaining = halted, remaining
        self.stats["decode_chunks"] += 1

        parts = [torch.stack(col) for col in zip(*emitted)]  # [K, B, ...] each
        out = self._snapshot(parts, live, n_lp)
        if sp is not None:
            SPANS.end(sp, steps=k)
        return out
