"""Fused multi-round speculative decoding: R draft+verify rounds per fetch.

Counterpart of `uzu_tpu/engine/fused_spec.py`. The per-round decoder
(`speculation.py`) reads each round's result on the host before it plans
the next. Here the whole round (the device-side greedy draft chain, the
(k+1)-row deferred verify, exact-match acceptance, stop and budget
clipping, the state commit) stays on the device for R rounds, and the host
reads them with ONE fetch. The JAX package runs the rounds in one
`lax.scan`; here they are a Python loop whose values never leave the
device: there is no host sync between the rounds' launches.

- draft chain: k greedy steps on a VIEW of the draft state
  (`speculation.draft_chain`), for attention and recurrent drafts alike;
  a self-draft (the target's first `draft_layers` layers) views the
  target's committed state, and an n-gram draft is `ops/ngram.py`'s
  device proposer over a history buffer;
- verify: the same functions as `SpeculativeDecoder._verify`, so the
  fused output equals the per-round decoder's (and plain greedy
  decoding's);
- draft-state sync: a separate draft model replays the verify block
  through its own deferred forward and commits to the same length; a
  self-draft needs nothing (the target's commit wrote those layers);
- rounds after a stop token or the budget do nothing through masks (their
  commit is 0: pos stays, the recurrent replay is the identity, and their
  KV rows lie past pos), not through a host branch. The host sizes each
  dispatch so that no round can reach past the context
  (`(context - pos) // (k + 1)` rounds at most), which the JAX package
  checks inside the scan instead.

Greedy output equals plain decoding. Sampled rounds draw from one
`torch.Generator` per call, seeded from the call's seed.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.decoder import decoder_commit_deferred, decoder_forward
from ..ops.ngram import ngram_propose
from .sampling import SamplingParams, sample
from .speculation import (
    SpecStream,
    SpeculationMetrics,
    _fetch,
    _stop_tensor,
    accepted_length,
    commit_length,
    draft_chain,
    sample_rows,
    self_draft_model,
    speculation_supported,
)


class FusedSpeculativeDecoder:
    """Chain speculation with R rounds per fetch.

    Exactly one of `draft_lm` (a separate smaller LanguageModel sharing the
    tokenizer), `draft_layers` (self-speculation on the target's first n
    layers, no extra weights) or `ngram` (device prompt lookup over the
    last `ngram_window` tokens) selects the draft. `k` drafts per round,
    `rounds` rounds per fetch.
    """

    def __init__(self, lm, *, draft_lm=None, draft_layers: int | None = None,
                 ngram: bool = False, ngram_window: int = 512, k: int = 4, rounds: int = 8,
                 sampling: SamplingParams | None = None):
        if not speculation_supported(lm.decoder_config):
            raise ValueError("chain speculation unsupported (KV-shared attention)")
        if (draft_lm is not None) + (draft_layers is not None) + ngram != 1:
            raise ValueError("exactly one of draft_lm / draft_layers / ngram required")
        if k < 1 or rounds < 1:
            raise ValueError("k and rounds must be >= 1")
        self.lm = lm
        self.k = k
        self.rounds = rounds
        self.sampling = sampling or SamplingParams()
        self.draft = None
        self._self_layers = None
        self._ngram_window = ngram_window if ngram else None
        self._draft_ctx = lm.max_context
        if draft_lm is not None:
            if not speculation_supported(draft_lm.decoder_config):
                raise ValueError("draft model has KV-shared attention")
            self.draft = draft_lm
            self._draft_ctx = draft_lm.max_context
        elif draft_layers is not None:
            # a config and parameter view: the target's own tensors
            self.draft = self_draft_model(lm, draft_layers)
            self._self_layers = draft_layers

    # -- the rounds on the device ---------------------------------------------

    def _rounds(self, tstate: dict, dstate, token: torch.Tensor, remaining: torch.Tensor,
                rounds: int, stop_ids, generator, needed: int, hist=None, hlen=None):
        """`rounds` draft+verify rounds with no host sync. token and
        remaining are 0-d device tensors; `needed` bounds the slots any
        round touches (attention reads that context bucket); hist [C] and
        hlen feed the n-gram draft. -> (tstate, dstate, sampled [R, k+1], commit [R], accepted
        [R], proposed [R], active [R]), every value on the device; round r
        emitted sampled[r, :commit[r]]."""
        lm = self.lm
        k, n = self.k, self.k + 1
        tcfg = lm.decoder_config
        dev = token.device
        rows = torch.arange(n, device=dev)
        done = torch.zeros((), dtype=torch.bool, device=dev)
        token = token.to(torch.int32)
        ctx_limit = lm._ctx_bucket(needed)
        if self.draft is not None:
            dcfg, dparams = self.draft.decoder_config, self.draft.params
            dctx = ctx_limit if self._self_layers is not None else self.draft._ctx_bucket(needed)
        outs = []
        for _ in range(rounds):
            if self._ngram_window is not None:
                draft_toks, dlen = ngram_propose(hist, hlen, k)
            else:
                view = ({"layers": tstate["layers"][:self._self_layers], "pos": tstate["pos"]}
                        if self._self_layers is not None else dstate)
                draft_toks = draft_chain(dcfg, dparams, view, token, k, dctx)
                dlen = torch.full((), k, dtype=torch.int32, device=dev)
            # clip the acceptance window to the budget before the match, as
            # the per-round decoder clips its drafts before its verify
            dlen = torch.minimum(dlen, torch.clamp(remaining - 1, min=0)).to(torch.int32)
            block = torch.cat([token.reshape(1), draft_toks])
            logits, pending = decoder_forward(tcfg, lm.params, block, tstate, last_only=False,
                                              defer_ssm=True, ctx_limit=ctx_limit)
            sampled = sample_rows(logits, self.sampling, generator)
            accepted = accepted_length(sampled, block, dlen)
            active = ~done
            commit = torch.where(active, commit_length(sampled, accepted, remaining, stop_ids),
                                 0).to(torch.int32)
            tstate = decoder_commit_deferred(tcfg, pending, commit)
            if self.draft is not None and self._self_layers is None:
                _, dpending = decoder_forward(dcfg, dparams, block, dstate, last_only=True,
                                              defer_ssm=True, ctx_limit=dctx)
                dstate = decoder_commit_deferred(dcfg, dpending, commit)
            if hist is not None:
                # rows past hlen are not history: writing the whole block
                # there is harmless
                hist = hist.index_copy(0, (hlen + rows).long(), sampled.to(hist.dtype))
                hlen = hlen + commit
            token = torch.where(active, sampled.gather(
                0, torch.clamp(commit - 1, min=0).reshape(1).long())[0].to(torch.int32), token)
            remaining = remaining - commit
            hit = torch.zeros((), dtype=torch.bool, device=dev)
            if stop_ids is not None:
                hit = (torch.isin(sampled, stop_ids) & (rows < commit)).any()
            done = done | hit | (remaining <= 0)
            outs.append((sampled, commit, torch.where(active, accepted, 0),
                         torch.where(active, dlen, 0), active))
        sampled, commit, acc, prop, act = (torch.stack(x) for x in zip(*outs))
        return tstate, dstate, sampled, commit, acc, prop, act

    # -- host loop ----------------------------------------------------------

    def generate(self, prompt_tokens, max_new_tokens: int, stop_token_ids=None, seed: int = 0,
                 metrics: SpeculationMetrics | None = None, state=None, history_tokens=None):
        """Same contract as SpeculativeDecoder.generate: a SpecStream whose
        `.state` carries the final decoding state once iteration ends."""
        return SpecStream(self, prompt_tokens, max_new_tokens, stop_token_ids, seed, metrics,
                          state, history_tokens)

    def _generate_impl(self, prompt_tokens, max_new_tokens, stop_token_ids, seed, metrics,
                       init_state, history_tokens, out):
        lm = self.lm
        dev = lm.device
        stop = set(stop_token_ids if stop_token_ids is not None
                   else lm.config.generation_config.stop_token_ids)
        n = self.k + 1
        state = init_state if init_state is not None else lm.new_state()
        base = int(state["pos"])
        logits, state = lm.prefill(state, np.asarray(prompt_tokens, np.int64))
        first = int(sample(logits, self.sampling,
                           generator=torch.Generator(device=dev).manual_seed(seed)))
        pos = base + len(prompt_tokens)
        dstate = None
        history = None
        if self.draft is not None and self._self_layers is None:
            # the draft absorbs the full committed history; the root token
            # reaches it inside each round as block[0]
            hist0 = np.asarray(history_tokens if history_tokens is not None
                               else prompt_tokens, np.int64)
            dstate = self.draft.new_state()
            if len(hist0):
                _, dstate = self.draft.prefill(dstate, hist0)
        if self._ngram_window is not None:
            history = [int(t) for t in (history_tokens if history_tokens is not None
                                        else prompt_tokens)] + [first]

        stop_ids = _stop_tensor(stop, dev)
        gen = torch.Generator(device=dev).manual_seed(seed ^ 0xF5ED)
        ctx = min(lm.max_context, self._draft_ctx)
        produced = 1
        token = first
        yield first
        while token not in stop and produced < max_new_tokens and pos + n <= ctx:
            out.state = None  # invalidated while a dispatch is in flight
            # no round of this dispatch can reach past the context
            rounds = min(self.rounds, (ctx - pos) // n)
            hist = hlen = None
            if history is not None:
                w = self._ngram_window
                tail = history[-w:]
                hbuf = np.zeros(w + rounds * n, np.int64)  # room for the rounds' appends
                hbuf[:len(tail)] = tail
                hist = torch.from_numpy(hbuf).to(dev)
                hlen = torch.tensor(len(tail), dtype=torch.int32, device=dev)
            state, dstate, sampled, commit, acc, prop, active = self._rounds(
                state, dstate, torch.tensor(token, device=dev),
                torch.tensor(max_new_tokens - produced, dtype=torch.int32, device=dev),
                rounds, stop_ids, gen, pos + rounds * n, hist, hlen)
            got = _fetch(sampled, commit, acc, prop, active)  # the dispatch's one read
            r = rounds
            blocks = [got[i * n:(i + 1) * n] for i in range(r)]
            commits = got[r * n:r * n + r]
            emitted = [v for blk, c in zip(blocks, commits) for v in blk[:c]]
            if metrics is not None:
                metrics.num_verify_passes += sum(got[r * n + 3 * r:r * n + 4 * r])
                metrics.num_tokens_proposed += sum(got[r * n + 2 * r:r * n + 3 * r])
                metrics.num_tokens_accepted += sum(got[r * n + r:r * n + 2 * r])
            for v in emitted:
                yield v
            if history is not None:
                history.extend(emitted)
            produced += len(emitted)
            pos += len(emitted)
            token = emitted[-1] if emitted else token
        state["pos"] = torch.tensor(base + len(prompt_tokens) + max(0, produced - 1),
                                    dtype=torch.int32, device=dev)
        out.state = state


def fused_self_speculative_decoder(lm, *, draft_layers: int | None = None, k: int = 4,
                                   rounds: int = 8, sampling=None):
    """Self-speculation with fused rounds: no extra weights."""
    num = len(lm.decoder_config.transformer_config.layer_configs)
    return FusedSpeculativeDecoder(lm, draft_layers=draft_layers or max(1, num // 2), k=k,
                                   rounds=rounds, sampling=sampling)
