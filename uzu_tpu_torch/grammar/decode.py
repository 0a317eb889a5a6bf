"""Grammar-constrained generation loop, one stream.

Counterpart of `uzu_tpu/grammar/decode.py`. The matcher advances on the
host between steps, and its mask rides into the step, where sampling
applies it (`sample`'s bitmask). The plain loop steps one token per
forward, since each mask depends on the previous token; with a
speculator, each round's draft chain gets per-row lookahead masks
(`GrammarSession.lookahead_masks`), and one verify samples every row
under its mask, accepts on the device and commits the kept tokens
(`decoder_commit_deferred`), so recurrent mixers speculate under a
grammar too. Sampled rounds draw from a `torch.Generator` seeded from the
call's seed (the JAX package's keys are threefry); greedy streams equal
the JAX package's.

This loop is what the speculative batch engines' grammar slots are held
to (`engine/batch_spec.py`).
"""

from __future__ import annotations

import numpy as np
import torch

from ..engine.sampling import SamplingParams, sample
from ..models.decoder import decoder_commit_deferred, decoder_forward
from .matcher import GrammarSession


def _masked_decode_step(lm, sampling: SamplingParams, state: dict, token: torch.Tensor,
                        mask: torch.Tensor, generator) -> tuple[dict, torch.Tensor]:
    """One decode step whose sample is drawn under `mask` [V] bool."""
    pos = int(state["pos"])
    logits, state, _ = lm._forward(token.reshape(1), state, 1, lm._ctx_bucket(pos + 1))
    return state, sample(logits, sampling, generator=generator, bitmask=mask)


def constrained_generate(
    lm,
    prompt_tokens,
    max_new_tokens: int,
    grammar: GrammarSession,
    *,
    sampling: SamplingParams | None = None,
    stop_token_ids=None,
    seed: int = 0,
    state=None,
    speculator=None,
    metrics=None,
):
    """Token generator with per-step grammar masks; with `speculator` (e.g.
    NgramSpeculator) each round verifies a draft chain under its lookahead
    masks and yields 1 + accepted tokens."""
    if speculator is not None:
        yield from _speculative_constrained(
            lm, prompt_tokens, max_new_tokens, grammar, speculator,
            sampling=sampling, stop_token_ids=stop_token_ids, seed=seed,
            state=state, metrics=metrics,
        )
        return
    sampling = sampling or SamplingParams()
    stop = set(stop_token_ids if stop_token_ids is not None
               else lm.config.generation_config.stop_token_ids)
    grammar.stop_token_ids = sorted(stop) or grammar.stop_token_ids
    vocab = lm.decoder_config.vocab_size
    dev = lm.device

    if state is None:
        state = lm.new_state()
    logits, state = lm.prefill(state, np.asarray(prompt_tokens, np.int64))
    gen = torch.Generator(device=dev).manual_seed(seed)
    mask = grammar.current_mask()
    token = sample(logits, sampling, generator=gen,
                   bitmask=None if mask is None else _dev_mask(mask, vocab, dev))
    # the loop yields `budget` tokens plus the final in-flight one
    budget = max(0, min(max_new_tokens - 1, lm.max_context - int(state["pos"]) - 1))
    full = torch.ones(vocab, dtype=torch.bool, device=dev)
    for _ in range(budget):
        val = int(token)
        yield val
        if val in stop:
            return
        grammar.observe(val)
        mask = grammar.current_mask()
        state, token = _masked_decode_step(
            lm, sampling, state, token, full if mask is None else _dev_mask(mask, vocab, dev),
            gen)
    yield int(token)


def _masked_verify(lm, sampling: SamplingParams, state: dict, block: torch.Tensor,
                   masks: torch.Tensor, draft_len: int, generator, ctx_limit):
    """One grammar-speculative round on the device: the block's deferred
    forward, a sample per row under its mask [n, V], exact-match
    acceptance, and the commit of the 1 + accepted kept tokens. ->
    (state, sampled [n], accepted)."""
    from ..engine.speculation import accepted_length

    cfg = lm.decoder_config
    logits, pending = decoder_forward(cfg, lm.params, block, state, last_only=False,
                                      defer_ssm=True, ctx_limit=ctx_limit)
    sampled = torch.stack([sample(row, sampling, generator=generator, bitmask=m)
                           for row, m in zip(logits, masks)])
    accepted = accepted_length(sampled, block, draft_len)
    return decoder_commit_deferred(cfg, pending, 1 + accepted), sampled, accepted


def _speculative_constrained(lm, prompt_tokens, max_new_tokens, grammar, speculator, *,
                             sampling, stop_token_ids, seed, state, metrics=None):
    from ..engine.speculation import _fetch, max_block, speculation_supported

    if not speculation_supported(lm.decoder_config):
        raise ValueError("grammar speculation unsupported (KV-shared attention)")
    sampling = sampling or SamplingParams()
    stop = set(stop_token_ids if stop_token_ids is not None
               else lm.config.generation_config.stop_token_ids)
    grammar.stop_token_ids = sorted(stop) or grammar.stop_token_ids
    vocab = lm.decoder_config.vocab_size
    dev = lm.device
    cap = max_block(lm)

    if hasattr(speculator, "reset"):
        speculator.reset()
    history = [int(t) for t in prompt_tokens]
    if state is None:
        state = lm.new_state()
    start = int(state["pos"])
    logits, state = lm.prefill(state, np.asarray(prompt_tokens, np.int64))
    m0 = grammar.current_mask()
    first = int(sample(logits, sampling,
                       generator=torch.Generator(device=dev).manual_seed(seed),
                       bitmask=None if m0 is None else _dev_mask(m0, vocab, dev)))
    gen = torch.Generator(device=dev).manual_seed(seed ^ 0x6A3)
    pos = start + len(history)
    produced = 0
    token = first

    while produced < max_new_tokens:
        yield token
        history.append(token)
        produced += 1
        if token in stop or produced >= max_new_tokens:
            return  # budget exhausted: skip the wasted final verify
        grammar.observe(token)
        room = lm.max_context - pos - 1
        if room <= 0:
            return
        draft = list(speculator.propose(history)) if room > 1 else []
        draft = draft[:min(len(draft), room - 1, max_new_tokens - produced, cap - 1)]
        masks = grammar.lookahead_masks(draft)
        draft = draft[:len(masks) - 1]
        n = 1 + len(draft)
        n_pad = 1
        while n_pad < n:
            n_pad *= 2
        n_pad = min(n_pad, cap)
        block = np.zeros(n_pad, np.int64)
        block[0] = token
        block[1:1 + len(draft)] = draft
        mask_rows = np.ones((n_pad, vocab), bool)
        for i, m in enumerate(masks[:n_pad]):
            if m is not None:
                mask_rows[i] = _pad_mask(m, vocab)

        state, sampled, accepted_d = _masked_verify(
            lm, sampling, state, torch.from_numpy(block).to(dev),
            torch.from_numpy(mask_rows).to(dev), len(draft), gen,
            lm._ctx_bucket(pos + n_pad))
        *vals, accepted = _fetch(sampled, accepted_d)
        if metrics is not None:
            metrics.num_verify_passes += 1
            metrics.num_tokens_proposed += len(draft)
            metrics.num_tokens_accepted += accepted
        emit = vals[:accepted + 1]
        # the round committed 1 + accepted tokens (pos and the replayed
        # recurrent state); mirror the position on the host
        pos += 1 + accepted

        for v in emit[:-1]:
            yield v
            history.append(v)
            produced += 1
            if v in stop or produced >= max_new_tokens:
                return
            grammar.observe(v)
        token = emit[-1]


def _pad_mask(mask: np.ndarray, vocab: int) -> np.ndarray:
    """A matcher mask over the tokenizer's ids, widened to the model's
    vocabulary (ids past the tokenizer are not allowed)."""
    if len(mask) == vocab:
        return mask
    out = np.zeros(vocab, bool)
    out[:len(mask)] = mask
    return out


def _dev_mask(mask: np.ndarray, vocab: int, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(_pad_mask(mask, vocab))).to(device)
