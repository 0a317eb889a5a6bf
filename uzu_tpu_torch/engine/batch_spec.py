"""Speculative continuous batching: per-slot chain drafts, one batched verify.

Counterpart of `uzu_tpu/engine/batch_spec.py`: the slot engines
(`engine/batch.py`, `engine/paged_batch.py`) with the single stream's
chain verify (`engine/speculation.py`) in place of their K-step chunks.

- every live slot drafts up to `draft_block` (m) tokens: on the host (a
  per-slot n-gram speculator over the request's own history, clipped to
  its remaining budget), or on the device (`draft_layers=n`: a greedy
  chain of the target's first n layers over the slots' own state, whose
  KV writes the verify rewrites with the same tokens; `device_ngram` in
  fused rounds: `ops/ngram.py` over each slot's history);
- one verify advances every slot by m+1 rows (`batch_verify_step` over the
  dense per-slot states, `paged_verify_step` over the page pools), samples
  a token at every row, accepts the longest matching draft prefix, clips
  at the first stop token and at the budget, and commits, all on the
  device; a halted slot commits 0, an identity transition;
- the host reads (sampled, commit) once a round and routes each slot's
  first `commit` rows; with `spec_rounds` R > 1 (device drafts only, no
  grammar or logprob slot in flight) R whole rounds run back to back with
  no host sync and one read.

Sampling noise is keyed by the slot's produced-token count (key words
(seed, produced + row)), not by the round: a rejected row consumes no key,
so a stream is a function of its prompt and seed alone, and the paged
engine's recompute preemption replays a sampled stream exactly. The keys
are the port's counter hash (`sampling.gumbel_noise`), not the JAX
package's threefry, so sampled streams differ from its; greedy streams
equal it and the single stream.

Grammar-constrained requests ride the same verify: their drafts are always
host drafts, and each row of their block samples under the lookahead mask
of the matcher state after the drafts before it
(`GrammarSession.lookahead_masks`); their first token samples under the
matcher's first mask at admission.
"""

from __future__ import annotations

import time

import numpy as np
import torch
import torch.nn.functional as F

from ..models.batch_decode import batch_commit_deferred, batch_decode_step, batch_verify_step
from ..models.paged_decode import paged_decode_step, paged_verify_step
from ..ops.ngram import ngram_propose_batched
from .batch import BatchEngine, _HostCopy
from .paged_batch import PagedBatchEngine
from .sampling import apply_count_penalties, gumbel_noise, sample_dynamic
from .speculation import (
    NgramSpeculator,
    SpeculationMetrics,
    accepted_drafts,
    max_block,
    speculation_supported,
)


def _check_spec_rounds(spec_rounds, draft_layers, device_ngram):
    """Fused rounds need a draft source on the device: a layer-truncated
    self-draft or the device n-gram matcher. Host n-gram proposals re-plan
    between rounds and cannot ride them."""
    if spec_rounds > 1 and draft_layers is None and not device_ngram:
        raise ValueError("spec_rounds > 1 requires draft_layers or "
                         "device_ngram (host drafts re-plan every round)")
    if device_ngram and spec_rounds <= 1:
        raise ValueError("device_ngram rides the fused rounds; per-round "
                         "engines already draft on host (make_speculator)")
    if device_ngram and draft_layers is not None:
        raise ValueError("device_ngram and draft_layers are exclusive "
                         "draft sources")


class _SpecScheduling:
    """Host-side round scheduling and the device round shared by the dense
    and paged speculative engines. An engine supplies `_round_ctx`
    (capacity for the coming rows and the read bound), `_draft_chain`
    (the self-draft's greedy steps), `_verify_forward` (the block's
    logits) and `_commit_round` (positions after the commits)."""

    supports_grammar = True
    supports_count_penalties = True

    def _init_spec(self, lm, draft_block, make_speculator, draft_layers, spec_rounds,
                   device_ngram, ngram_window):
        self.draft_block = draft_block
        self.draft_layers = draft_layers
        self.spec_rounds = spec_rounds
        self.device_ngram = device_ngram
        self.ngram_window = ngram_window
        self._vocab = lm.decoder_config.vocab_size
        if draft_layers is not None:
            n_total = len(lm.decoder_config.transformer_config.layer_configs)
            if not 0 < draft_layers < n_total:
                raise ValueError(f"draft_layers must be in [1, {n_total - 1}]")
            from .speculation import self_draft_model

            # the target's own first layers: config and parameter views
            draft = self_draft_model(lm, draft_layers)
            self._draft_cfg, self._draft_params = draft.decoder_config, draft.params
        self._make_spec = make_speculator or (lambda: NgramSpeculator(max_ngram=3, k=draft_block))
        self._slot_spec = [None] * self.batch_size
        self.metrics = SpeculationMetrics()
        self.stats.update(verify_rounds=0, verify_dispatches=0)

    # -- host side -------------------------------------------------------------

    def _ngram_hist(self, m: int, rounds: int):
        """(hist [B, W + rounds*(m+1)], hlen [B]): each live slot's token
        history tail for the device n-gram proposer, rebuilt from the
        host's bookkeeping at every dispatch."""
        w = self.ngram_window
        hist = np.zeros((self.batch_size, w + rounds * (m + 1)), np.int64)
        hlen = np.zeros(self.batch_size, np.int64)
        for b, slot in enumerate(self.slots):
            if slot.free:
                continue
            tail = (slot.request.prompt + slot.request.tokens)[-w:]
            hist[b, :len(tail)] = tail
            hlen[b] = len(tail)
        return hist, hlen

    def _new_slot_spec(self, slot_i: int) -> None:
        self._slot_spec[slot_i] = self._make_spec()
        if hasattr(self._slot_spec[slot_i], "reset"):
            self._slot_spec[slot_i].reset()

    def _fetch_first_tokens(self) -> None:
        """Route freshly admitted slots' first tokens (one host read), so
        every live slot's history ends at its root token. Runs before any
        horizon or finish decision: a slot admitted at the edge of the
        context still emits its first token."""
        firsts = [(b, s.pending_first) for b, s in enumerate(self.slots)
                  if not s.free and s.pending_first is not None]
        if not firsts:
            return
        vals = _HostCopy([t for _, parts in firsts for t in parts]).get()
        now = time.perf_counter()
        for b, parts in firsts:
            tok, *lp = vals[:len(parts)]
            vals = vals[len(parts):]
            slot = self.slots[b]
            req = slot.request
            slot.pending_first = None
            req.first_token_at = now
            tok = int(tok[0])
            if req.logprobs:
                lp_v, top_v, top_i = lp
                req.logprob_content.append((float(lp_v[0]), [
                    (int(i), float(x)) for i, x in zip(top_i[0], top_v[0])]))
            req.tokens.append(tok)
            slot.produced += 1
            if tok in self.stop_ids:
                self._finish(b, "stop")
            elif slot.produced >= req.max_new_tokens:
                self._finish(b, "length")
            elif req.grammar is not None:
                # the first token is the root of the next verify round: its
                # lookahead masks start from the state after it
                req.grammar.observe(tok)

    def _build_drafts(self, m: int):
        """(drafts [B, m], draft_len [B], tracked {slot: request}, masks
        [B, m+1, V] or None, host_draft [B]). Host proposals are clipped to
        the remaining budget. A grammar slot always drafts on the host (its
        lookahead masks come from the proposed chain), and `host_draft`
        marks it so a device self-draft leaves it alone; `masks` is None
        when no live slot is constrained."""
        from ..grammar.decode import _pad_mask

        drafts = np.zeros((self.batch_size, m), np.int64)
        draft_len = np.zeros(self.batch_size, np.int64)
        host_draft = np.zeros(self.batch_size, bool)
        masks = None
        tracked = {}
        for b, slot in enumerate(self.slots):
            if slot.free:
                continue
            req = slot.request
            budget = max(0, req.max_new_tokens - slot.produced - 1)
            if req.grammar is None and self.draft_layers is not None:
                # drafted on the device; the budget clip mirrors the
                # device's, so the metrics count what can be accepted
                draft_len[b] = min(m, budget)
                tracked[b] = req
                continue
            proposal = list(self._slot_spec[b].propose(req.prompt + req.tokens))[:m]
            proposal = proposal[:budget]
            if req.grammar is not None:
                look = req.grammar.lookahead_masks(proposal)
                proposal = proposal[:len(look) - 1]
                host_draft[b] = True
                if any(mk is not None for mk in look):
                    if masks is None:
                        masks = np.ones((self.batch_size, m + 1, self._vocab), bool)
                    for i, mk in enumerate(look):
                        if mk is not None:
                            masks[b, i] = _pad_mask(mk, self._vocab)
            drafts[b, :len(proposal)] = proposal
            draft_len[b] = len(proposal)
            tracked[b] = req
        return drafts, draft_len, tracked, masks, host_draft

    def _route_round(self, tracked, vals, commits, draft_len, lp_pack=None) -> None:
        """Route one round's committed tokens to their requests; finishing
        mirrors the device's halt conditions."""
        if tracked:
            # one verify dispatch is one verify pass, as in the single stream
            self.metrics.num_verify_passes += 1
        for b, req in tracked.items():
            if req.finished:
                continue
            c = int(commits[b])
            slot = self.slots[b]
            self.metrics.num_tokens_proposed += int(draft_len[b])
            self.metrics.num_tokens_accepted += max(0, c - 1)
            slot.pos += c
            for j in range(c):
                v = int(vals[b, j])
                req.tokens.append(v)
                if req.logprobs and lp_pack is not None:
                    lp, top_v, top_i = lp_pack
                    n = req.logprobs
                    req.logprob_content.append((float(lp[b, j]), [
                        (int(i), float(x)) for i, x in zip(top_i[b, j][:n], top_v[b, j][:n])]))
                slot.produced += 1
                if v in self.stop_ids:
                    self._finish(b, "stop")
                    break
                if slot.produced >= req.max_new_tokens:
                    self._finish(b, "length")
                    break
                if req.grammar is not None:
                    # the single-stream constrained loop's order: observe
                    # only tokens the stream continues past
                    req.grammar.observe(v)
            else:
                if slot.pos >= self.lm.max_context - 1:
                    self._finish(b, "length")

    def _finish_horizon(self, m: int) -> None:
        """A verify writes m+1 rows, so a slot finishes once fewer than
        m+2 positions of context remain."""
        for b, slot in enumerate(self.slots):
            if not slot.free and slot.pos >= self.lm.max_context - (m + 2):
                self._finish(b, "length")

    def step(self) -> bool:
        # greedy-fill admission: a verify round costs about the same at any
        # occupancy, so fill slots before paying for one
        admitted = False
        while self._admit():
            admitted = True
            if self.num_active and not self.admit_greedy:
                break
            if self.num_active >= self.batch_size:
                break
        if self.num_active:
            self._verify_round()
        return bool(admitted or self.queue or self.num_active or self._admitting)

    def run(self) -> None:
        while self.queue or self.num_active or self._admitting:
            self.step()

    # -- the round on the device -------------------------------------------------

    def _device_inputs(self):
        """(sampling rows [B, 6], whether any live slot samples, noise key
        words [B], counts or None) for a dispatch."""
        dev = self.lm.device
        live = self._live()
        rows = torch.as_tensor(self._samp, device=dev)
        noisy = any(self._samp[b, 0] > 0 for b in live)
        key0 = torch.as_tensor(self._seeds & 0xFFFFFFFF, device=dev)
        counts = self._ensure_counts() if self._penalized_now() else None
        return rows, noisy, key0, counts

    def _round(self, ctx, tokens, drafts, draft_len, halted, remaining, produced, rows, noisy,
               key0, counts, hd=None, masks=None, n_lp: int = 0):
        """One verify round over every slot, all on the device: the
        self-draft chains (where `draft_layers`; `hd` [B] keeps a slot's
        host draft), the block's forward, a sample per row (key words
        (seed, produced + row), the chain prefix counted into a penalized
        row, `masks` [B, m+1, V] where given), acceptance, clipping and the
        commit. Returns (tokens, halted, remaining, sampled [B, m+1],
        commit [B], logprobs or None)."""
        m = self.draft_block
        s = m + 1
        bsz = self.batch_size
        dev = tokens.device
        if self.draft_layers is not None:
            self_drafts = self._draft_chain(ctx, tokens, halted, m)
            dev_len = torch.clamp(remaining.long() - 1, 0, m)
            if hd is None:
                drafts, draft_len = self_drafts, dev_len
            else:
                drafts = torch.where(hd[:, None], drafts, self_drafts)
                draft_len = torch.where(hd, draft_len, dev_len)
        blk = torch.cat([tokens[:, None], drafts], dim=1)  # [B, S]
        logits = self._verify_forward(ctx, blk, halted)  # [B, S, V]
        vocab = logits.shape[-1]
        flat = logits.reshape(bsz * s, vocab)
        rows_f = rows.repeat_interleave(s, dim=0)
        src = flat
        if counts is not None:
            # row i counts the chain prefix blk[1..i] on top of the slot's
            # counts: exact, since row i's sample commits only when every
            # earlier draft was accepted, and those drafts are then the
            # generated tokens
            chain = torch.zeros((bsz, s, vocab), dtype=torch.int32, device=dev)
            chain[:, 1:] = torch.cumsum(F.one_hot(blk[:, 1:], vocab).to(torch.int32), dim=1)
            src = apply_count_penalties(flat.float(), (counts[:, None] + chain).reshape(bsz * s, -1),
                                        rows_f[:, 4:5], rows_f[:, 5:6])
        noise = None
        if noisy:
            key1 = produced.long()[:, None] + torch.arange(s, device=dev)[None, :]
            noise = gumbel_noise(key0.repeat_interleave(s), key1.reshape(-1), vocab)
        sampled = sample_dynamic(
            src, rows_f[:, 0], rows_f[:, 1], rows_f[:, 2], rows_f[:, 3], noise,
            bitmask=None if masks is None else masks.reshape(bsz * s, -1),
            banned_tokens=self.sampling.banned_tokens).reshape(bsz, s)

        idx = torch.arange(s, device=dev)[None, :]
        commit = 1 + accepted_drafts(sampled, blk, draft_len)
        is_stop = None
        if self._stop is not None:
            is_stop = torch.isin(sampled, self._stop)
            first_stop = torch.where(is_stop & (idx < commit[:, None]), idx, s).amin(dim=1)
            commit = torch.minimum(commit, first_stop + 1)
        commit = torch.minimum(commit, remaining)
        commit = torch.where(halted, 0, commit).to(torch.int32)
        nxt = sampled.gather(1, torch.clamp(commit.long() - 1, min=0)[:, None])[:, 0]
        nxt = torch.where(halted, tokens, nxt)
        positions = self._commit_round(commit)
        remaining = remaining - commit
        kept = idx < commit[:, None]
        halted = halted | (remaining <= 0) | (positions >= self.lm.max_context - 1)
        if is_stop is not None:
            halted = halted | (is_stop & kept).any(dim=1)
        if counts is not None:
            counts.scatter_add_(1, sampled, kept.to(torch.int32))
        lps = None
        if n_lp:
            lp, top_v, top_i = self._logprobs(flat, sampled.reshape(-1), n_lp)
            lps = (lp.reshape(bsz, s), top_v.reshape(bsz, s, -1), top_i.reshape(bsz, s, -1))
        return nxt, halted, remaining, sampled, commit, lps

    def _verify_round(self) -> None:
        m = self.draft_block
        self._fetch_first_tokens()
        self._finish_horizon(m)
        if not self.num_active:
            return
        if self.spec_rounds > 1 and not any(
                not s.free and (s.request.grammar is not None or s.request.logprobs)
                for s in self.slots):
            return self._verify_round_fused(m)
        ctx = self._round_ctx(m + 2, m + 2)
        if not self.num_active:
            return
        drafts, draft_len, tracked, masks, host_draft = self._build_drafts(m)
        dev = self.lm.device
        rows, noisy, key0, counts = self._device_inputs()
        produced = torch.as_tensor(
            [0 if s.free else s.produced for s in self.slots], device=dev)
        n_lp = max((s.request.logprobs for s in self.slots if not s.free), default=0)
        self._tokens, self._halted, self._remaining, sampled, commit, lps = self._round(
            ctx, self._tokens, torch.as_tensor(drafts, device=dev),
            torch.as_tensor(draft_len, device=dev), self._halted, self._remaining, produced,
            rows, noisy, key0, counts,
            hd=(torch.as_tensor(host_draft, device=dev)
                if self.draft_layers is not None else None),
            masks=None if masks is None else torch.as_tensor(masks, device=dev), n_lp=n_lp)
        self.stats["verify_rounds"] += 1
        self.stats["verify_dispatches"] += 1
        vals, commits, *lp_pack = _HostCopy([sampled, commit, *(lps or ())]).get()
        self._route_round(tracked, vals, commits, draft_len, lp_pack or None)

    def _verify_round_fused(self, m: int) -> None:
        """R whole rounds with no host sync between them and one read
        (spec_rounds > 1): self-drafts or device n-gram drafts only. The
        rounds are the per-round path's (`_round`, the same produced-count
        key schedule, advanced on the device), so the streams are its."""
        rounds = self.spec_rounds
        # no slot can commit more than its budget: rounds past the largest
        # one would only run identity transitions
        rounds = min(rounds, max(s.request.max_new_tokens - s.produced
                                 for s in self.slots if not s.free))
        ctx = self._round_ctx(rounds * (m + 1) + 2, (rounds + 1) * (m + 2))
        if not self.num_active:
            return
        tracked = {b: s.request for b, s in enumerate(self.slots) if not s.free}
        dev = self.lm.device
        rows, noisy, key0, counts = self._device_inputs()
        produced = torch.as_tensor(
            [0 if s.free else s.produced for s in self.slots], device=dev)
        hist = hlen = None
        if self.device_ngram:
            h, n = self._ngram_hist(m, rounds)
            hist, hlen = torch.as_tensor(h, device=dev), torch.as_tensor(n, device=dev)
        sampled_r, commit_r, prop_r, active_r = self._fused_rounds(
            ctx, rounds, produced, rows, noisy, key0, counts, hist, hlen)
        self.stats["verify_rounds"] += rounds
        self.stats["verify_dispatches"] += 1
        vals, commits, props, actives = _HostCopy(
            [sampled_r, commit_r, prop_r, active_r]).get()
        for r in range(rounds):
            if not actives[r]:
                break
            self._route_round(tracked, vals[r], commits[r], props[r])

    def _fused_rounds(self, ctx, rounds: int, produced, rows, noisy, key0, counts, hist, hlen):
        """The device side of `_verify_round_fused`: every input is already
        on the device and nothing is read back, so no launch waits for the
        host. -> (sampled [R, B, m+1], commit [R, B], proposed [R, B],
        active [R])."""
        m = self.draft_block
        s = m + 1
        bsz = self.batch_size
        dev = self.lm.device
        horizon = self.lm.max_context - (m + 2)  # _finish_horizon, on the device
        zero_d = torch.zeros((bsz, m), dtype=torch.long, device=dev)
        zero_l = torch.zeros(bsz, dtype=torch.long, device=dev)
        tokens, halted, remaining = self._tokens, self._halted, self._remaining
        out = []
        for _ in range(rounds):
            halted = halted | (self._positions_now() >= horizon)
            active = ~halted.all()
            budget = torch.clamp(remaining.long() - 1, min=0)
            if self.device_ngram:
                drafts, dlen = ngram_propose_batched(hist, hlen, m)
                drafts, dlen = drafts.long(), torch.minimum(dlen.long(), budget)
                proposed = torch.where(halted, 0, dlen)
            else:
                drafts, dlen = zero_d, zero_l
                proposed = torch.where(halted, 0, torch.clamp(budget, max=m))
            tokens, halted, remaining, sampled, commit, _ = self._round(
                ctx, tokens, drafts, dlen, halted, remaining, produced, rows, noisy, key0,
                counts)
            if self.device_ngram:
                at = torch.clamp(hlen.long()[:, None] + torch.arange(s, device=dev)[None, :],
                                 max=hist.shape[1] - 1)
                hist = hist.scatter(1, at, sampled.to(hist.dtype))
                hlen = hlen + commit
            produced = produced + commit
            out.append((sampled, commit, proposed, active))
        self._tokens, self._halted, self._remaining = tokens, halted, remaining
        sampled_r, commit_r, prop_r, active_r = zip(*out)
        return (torch.stack(sampled_r), torch.stack(commit_r), torch.stack(prop_r),
                torch.stack(active_r))


class SpeculativeBatchEngine(_SpecScheduling, BatchEngine):
    """`BatchEngine` whose decode path is the batched chain verify over the
    dense per-slot states: the batched engine for the hybrids and ring
    models (module docstring for the draft sources and the keys). On a
    ring layout the block is cut to the single stream's `max_block`."""

    def __init__(self, lm, *, draft_block: int = 8, make_speculator=None,
                 draft_layers: int | None = None, spec_rounds: int = 1,
                 device_ngram: bool = False, ngram_window: int = 512, **kw):
        if not speculation_supported(lm.decoder_config):
            raise ValueError("chain speculation unsupported (KV-shared attention)")
        _check_spec_rounds(spec_rounds, draft_layers, device_ngram)
        super().__init__(lm, **kw)
        self._init_spec(lm, min(draft_block, max_block(lm) - 1), make_speculator, draft_layers,
                        spec_rounds, device_ngram, ngram_window)

    def _finish_admission(self, slot_i, req, pending) -> None:
        super()._finish_admission(slot_i, req, pending)
        self._new_slot_spec(slot_i)

    def _round_ctx(self, rows: int, capacity_rows: int):
        """Grow the batched KV capacity for `capacity_rows` more positions
        per slot; the read bound covers `rows` past the furthest slot."""
        max_pos = max((s.pos for s in self.slots if not s.free), default=0)
        self._ensure_ctx(max_pos + capacity_rows)
        return self.lm._ctx_bucket(max_pos + rows)

    def _positions_now(self):
        return self._state["pos"]

    def _draft_chain(self, ctx, tokens, halted, m: int):
        """m greedy steps of the first `draft_layers` layers over a view of
        the slots' state: the recurrent states it makes are dropped, and
        its KV rows at pos.. are rewritten by the verify."""
        view = {"layers": self._state["layers"][:self.draft_layers], "pos": self._state["pos"]}
        fed = torch.ones(self.batch_size, dtype=torch.int32, device=tokens.device)
        t, out = tokens, []
        for _ in range(m):
            logits, view = batch_decode_step(self._draft_cfg, self._draft_params, t, view, fed,
                                             ctx)
            t = torch.argmax(logits, dim=-1)
            out.append(t)
        return torch.stack(out, dim=1)

    def _verify_forward(self, ctx, blk, halted):
        logits, self._verify_pending = batch_verify_step(
            self.lm.decoder_config, self.lm.params, blk, self._state, ctx)
        return logits

    def _commit_round(self, commit):
        self._state = batch_commit_deferred(self.lm.decoder_config, self._verify_pending,
                                            commit)
        self._verify_pending = None
        return self._state["pos"]


class SpeculativePagedBatchEngine(_SpecScheduling, PagedBatchEngine):
    """Chain speculation over the paged engine: the same per-slot drafts
    verified by one batched forward straight into the page pools
    (`paged_verify_step`). Rollback is the pools' visibility rule:
    positions advance by the accepted length, and rejected rows stay behind
    the lengths until the next round overwrites them."""

    def __init__(self, lm, *, draft_block: int = 8, make_speculator=None,
                 draft_layers: int | None = None, spec_rounds: int = 1,
                 device_ngram: bool = False, ngram_window: int = 512, **kw):
        _check_spec_rounds(spec_rounds, draft_layers, device_ngram)
        super().__init__(lm, **kw)
        self._init_spec(lm, draft_block, make_speculator, draft_layers, spec_rounds,
                        device_ngram, ngram_window)

    def _admit_advance(self) -> bool:
        done_before = self._admitting
        out = super()._admit_advance()
        if self._admitting is None and done_before is not None:
            self._new_slot_spec(done_before[2])
        return out

    def _round_ctx(self, rows: int, capacity_rows: int):
        """Pages for `rows` more rows per slot, then (tables [B, ctx_pages
        + 1] cut to the context bucket with the trash column last,
        ctx_pages); the tables stay fixed through a fused dispatch."""
        self._reserve_pages(lambda slot: slot.pos + rows)
        max_pos = max((s.pos for s in self.slots if not s.free), default=0)
        ctx_pages = self._ctx_pages(max_pos + rows)
        th = self._tables_host()
        tables = np.concatenate(
            [th[:, :ctx_pages], np.full((self.batch_size, 1), self._trash_page, np.int32)],
            axis=1)
        return torch.as_tensor(tables, device=self.lm.device), ctx_pages

    def _positions_now(self):
        return self._positions

    def _draft_chain(self, ctx, tokens, halted, m: int):
        """m greedy decode steps of the first `draft_layers` layers over
        their pools; the verify rewrites the rows they write."""
        tables, _ = ctx
        pools = self.pools[:self.draft_layers]
        t, pos, out = tokens, self._positions, []
        for _ in range(m):
            logits = paged_decode_step(self._draft_cfg, self._draft_params, pools, t, tables, pos)
            t = torch.where(halted, t, torch.argmax(logits, dim=-1))
            out.append(t)
            pos = pos + 1
        return torch.stack(out, dim=1)

    def _verify_forward(self, ctx, blk, halted):
        tables, ctx_pages = ctx
        return paged_verify_step(self.lm.decoder_config, self.lm.params, self.pools, blk, tables,
                                 self._positions, ~halted, ctx_pages)

    def _commit_round(self, commit):
        self._positions = self._positions + commit
        return self._positions
