"""Speculative decoding: draft proposal and one-fetch verification.

Counterpart of `uzu_tpu/engine/speculation.py`, with its names and
structure, in PyTorch's eager form:

- the chain verify is one (k+1)-row forward with logits at every row and
  a sampled token per row; acceptance (the exact-match rule), the clip at
  the first stop token and at the budget, and the state commit run on the
  device, and the host reads the round's tokens, acceptance and commit
  with ONE fetch;
- rollback is free for attention: the KV cache is slot-per-position, and a
  rejected row lies at a slot >= the committed pos, which the causal mask
  hides until a later write overwrites it. The port writes KV caches in
  place (the JAX package's arrays are immutable), so the rows of a
  rejected block really are in the cache; nothing reads them. A ring
  layout keeps ring_extra = max(prefill_buckets) extra slots, and a block
  is cut to ring_extra + 1 rows (at most 32) so its rejected rows cannot
  evict a key a later query still sees;
- recurrent mixers (GDN, Mamba2, ShortConv) verify by DEFERRED COMMIT: the
  forward returns replay inputs instead of committed state (`defer_ssm`),
  and the state is replayed over just the accepted prefix
  (`decoder_commit_deferred`); recurrent states are new tensors, so a
  draft's chain on a view of the state never touches the committed one;
- tree verification writes node i at slot pos + i with RoPE position
  pos + depth, masks the tree's slots with the ancestor matrix, and
  compacts the accepted path's KV rows to consecutive slots afterwards.

Speculators: `NgramSpeculator` (prompt lookup), `DraftModelSpeculator` (a
smaller LanguageModel's greedy chain), `self_draft_model` (the target's
first layers, sharing its weight tensors), `NgramTreeSpeculator` (a trie
of n-gram continuations), and the DFlash draft (`engine/dflash.py`).
Sampled rounds draw from a `torch.Generator` seeded from the call's seed,
so the same seed gives the same stream (the JAX package's threefry keys
are not Philox: sampled streams differ from its streams).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..config.model import AttentionConfig
from ..models.decoder import decoder_commit_deferred, decoder_forward
from ..models.ssm import ssm_tree_commit
from .sampling import SamplingParams, sample

MAX_BLOCK = 1 << 5  # rows of the largest padded chain-verify block


def speculation_supported(decoder_config) -> bool:
    """Chain speculation works for every mixer family: attention rolls back
    by pos, recurrent mixers by deferred commit and prefix replay. Only
    KV-shared attention is excluded (the shared read would see the source
    layer's uncommitted speculative rows)."""
    return all(
        not (isinstance(lc.mixer_config, AttentionConfig) and lc.mixer_config.is_kv_sharing)
        for lc in decoder_config.transformer_config.layer_configs
    )


def tree_speculation_supported(decoder_config) -> bool:
    """Attention-only, non-KV-shared: every layer's state rolls back by pos
    alone (a draft model of this kind needs no view)."""
    return all(
        isinstance(lc.mixer_config, AttentionConfig) and not lc.mixer_config.is_kv_sharing
        for lc in decoder_config.transformer_config.layer_configs
    )


@dataclasses.dataclass
class SpeculationMetrics:
    """Speculation counters of one or more generate calls."""

    num_tokens_proposed: int = 0
    num_tokens_accepted: int = 0
    num_verify_passes: int = 0

    @property
    def acceptance_rate(self) -> float:
        return (self.num_tokens_accepted / self.num_tokens_proposed
                if self.num_tokens_proposed else 0.0)


class NgramSpeculator:
    """Prompt-lookup decoding: propose the continuation of the longest
    recent occurrence of the current suffix n-gram."""

    def __init__(self, max_ngram: int = 3, k: int = 8):
        self.max_ngram = max_ngram
        self.k = k

    def propose(self, history: list[int]) -> list[int]:
        h = history
        for n in range(self.max_ngram, 0, -1):
            if len(h) < n + 1:
                continue
            suffix = h[-n:]
            # scan backwards for the most recent earlier occurrence
            for start in range(len(h) - n - 1, -1, -1):
                if h[start:start + n] == suffix:
                    cont = h[start + n:start + n + self.k]
                    if cont:
                        return cont
        return []

    def observe(self, tokens: list[int]) -> None:
        pass  # history passed on every propose


# --------------------------------------------------------------------------
# Device-side pieces of a round (shared with engine/fused_spec.py)
# --------------------------------------------------------------------------


def sample_rows(logits: torch.Tensor, sampling: SamplingParams,
                generator: torch.Generator | None = None) -> torch.Tensor:
    """A token per row of logits [N, V] -> [N] int64 on the device, each as
    `sample` draws it (no host sync)."""
    if sampling.is_greedy and not sampling.banned_tokens:
        return torch.argmax(logits, dim=-1)
    return torch.stack([sample(row, sampling, generator=generator) for row in logits])


def accepted_drafts(sampled: torch.Tensor, blk: torch.Tensor, draft_len) -> torch.Tensor:
    """[B] drafts accepted per block of blk [B, n]: the longest prefix of
    blk[:, 1:] equal to the tokens sampled at the rows before it, among
    each block's first `draft_len` drafts ([B], or one int for all)."""
    if isinstance(draft_len, torch.Tensor):
        draft_len = draft_len.reshape(-1, 1)
    match = (sampled[:, :-1] == blk[:, 1:]) & (
        torch.arange(blk.shape[1] - 1, device=blk.device)[None, :] < draft_len)
    return torch.cumprod(match.to(torch.int32), dim=1).sum(dim=1)


def accepted_length(sampled: torch.Tensor, block: torch.Tensor, draft_len) -> torch.Tensor:
    """Drafts accepted (0-d int32) of one block: `accepted_drafts` at B = 1."""
    return accepted_drafts(sampled[None], block[None], draft_len)[0].to(torch.int32)


def commit_length(sampled: torch.Tensor, accepted: torch.Tensor, remaining,
                  stop_ids: torch.Tensor | None) -> torch.Tensor:
    """Tokens a verify commits (0-d int32): the root and the accepted
    drafts, clipped after the first stop token among the emitted ones and
    at the remaining budget (an int or a 0-d device tensor)."""
    n = sampled.shape[0]
    commit = 1 + accepted
    if stop_ids is not None:
        rows = torch.arange(n, device=sampled.device)
        is_stop = torch.isin(sampled, stop_ids) & (rows < commit)
        first_stop = torch.where(is_stop, rows, n).min()
        commit = torch.minimum(commit, first_stop + 1)
    if isinstance(remaining, torch.Tensor):
        commit = torch.minimum(commit, remaining)
    else:
        commit = torch.clamp(commit, max=remaining)
    return commit.to(torch.int32)


def draft_chain(cfg, params, state: dict, token: torch.Tensor, k: int,
                ctx_limit: int | None = None) -> torch.Tensor:
    """k greedy steps from `token` on a VIEW of `state` -> tokens [k] int32
    on the device. The view's recurrent states are new tensors and are
    dropped; its KV rows land at slots >= state["pos"], which the causal
    mask hides until real tokens overwrite them. The caller's state keeps
    covering real history only."""
    view = {"layers": list(state["layers"]), "pos": state["pos"]}
    t = token.reshape(1)
    toks = []
    for _ in range(k):
        logits, view = decoder_forward(cfg, params, t, view, last_only=True,
                                       ctx_limit=ctx_limit)
        t = torch.argmax(logits[0]).reshape(1)
        toks.append(t)
    return torch.cat(toks).to(torch.int32)


def max_block(lm) -> int:
    """Rows of the largest verify block: MAX_BLOCK, and on a ring layout at
    most ring_extra + 1 (a power of two): a block writes its rows at
    positions pos .. pos + n - 1, and keys older than pos + n - c are then
    evicted from a ring of c = window + ring_extra slots, so n - 1 <=
    ring_extra keeps every key within the window of a later query."""
    n = MAX_BLOCK
    if getattr(lm, "ring_windows", False):
        while n > 1 and n - 1 > max(lm.prefill_buckets):
            n //= 2
    return n


def _fetch(*tensors) -> list[int]:
    """One device-to-host read of integer tensors, concatenated flat."""
    return torch.cat([t.reshape(-1).long() for t in tensors]).tolist()


def _stop_tensor(stop, device) -> torch.Tensor | None:
    return torch.as_tensor(sorted(stop), dtype=torch.long, device=device) if stop else None


# --------------------------------------------------------------------------
# Draft models
# --------------------------------------------------------------------------


class DraftModelSpeculator:
    """Greedy k-step draft from a smaller model sharing the tokenizer.

    The draft keeps its own prefix state across proposals and rolls back
    rejected tokens; the k steps stay on the device and the host reads
    them once:

    - attention-only drafts: the engine's decode chunk, then pos reset
      (the speculative KV slots are masked);
    - HYBRID drafts (recurrent mixers): the chain runs on a view of the
      committed state (`draft_chain`), and the committed state only ever
      advances by real history tokens, prefilled on the next propose.
    """

    def __init__(self, draft_lm, k: int = 4):
        if not speculation_supported(draft_lm.decoder_config):
            raise ValueError("draft model has KV-shared attention")
        self.draft = draft_lm
        self.k = k
        # recurrent state cannot pos-reset; those drafts chain on a view
        self._hybrid = not tree_speculation_supported(draft_lm.decoder_config)
        self._state = None
        self._fed = 0  # tokens of history the draft state covers

    def reset(self):
        self._state = None
        self._fed = 0

    def propose(self, history: list[int]) -> list[int]:
        lm = self.draft
        if self._state is None:
            self._state = lm.new_state()
            self._fed = 0
        new = history[self._fed:]
        if not new:
            return []
        if self._fed + len(new) + self.k + 1 > lm.max_context:
            return []
        if len(new) > 1:
            _, self._state = lm.prefill(self._state, np.asarray(new[:-1], np.int64))
        root = torch.tensor(new[-1], device=lm.device)
        ctx = lm._ctx_bucket(self._fed + len(new) + self.k)
        if self._hybrid:
            # all real history EXCEPT the root is committed; the chain runs
            # from the root on a view, and the root joins the committed
            # state as part of the NEXT propose's `new`
            self._fed += len(new) - 1
            return draft_chain(lm.decoder_config, lm.params, self._state, root, self.k,
                               ctx).tolist()
        self._state, emitted, _ = lm._decode_chunk(
            self._state, root, torch.zeros((), dtype=torch.bool, device=lm.device),
            torch.tensor(self.k, dtype=torch.int32, device=lm.device), self.k,
            SamplingParams(), None, ctx, None)
        out = emitted.tolist()
        # the state also covers the root and k-1 speculative tokens; keep
        # only the real history (pos reset, the other slots masked)
        self._fed += len(new)
        self._state["pos"] = torch.tensor(self._fed, dtype=torch.int32, device=lm.device)
        return out


def self_draft_model(lm, num_layers: int):
    """A layer-truncated view of `lm` usable as a draft model
    (self-speculative decoding): the first `num_layers` layers plus the
    shared embedding, output norm and readout. Its parameters are the
    target's own tensors, not copies: the draft costs only its KV state."""
    from .engine import LanguageModel

    dc = lm.decoder_config
    tc = dc.transformer_config
    if not 0 < num_layers <= len(tc.layer_configs):
        raise ValueError(f"num_layers must be in [1, {len(tc.layer_configs)}]")
    for lc in tc.layer_configs[:num_layers]:
        src = lc.kv_source_layer_index
        if src is not None and src >= num_layers:
            raise ValueError("truncation cuts a KV-share source layer")
    cfg = dataclasses.replace(lm.config, decoder_config=dataclasses.replace(
        dc, transformer_config=dataclasses.replace(
            tc, layer_configs=tc.layer_configs[:num_layers])))
    params = dict(lm.params)
    params["layers"] = list(lm.params["layers"][:num_layers])
    return LanguageModel(cfg, params, device=lm.device, max_context=lm.max_context,
                         prefill_buckets=lm.prefill_buckets, kv_quant=lm.kv_quant,
                         ring_windows=lm.ring_windows)


def self_speculative_decoder(lm, *, draft_layers: int | None = None, k: int = 4,
                             sampling=None):
    """SpeculativeDecoder whose draft is the target's own first layers
    (half the stack by default): no extra weights."""
    n = len(lm.decoder_config.transformer_config.layer_configs)
    draft = self_draft_model(lm, draft_layers or max(1, n // 2))
    return SpeculativeDecoder(lm, DraftModelSpeculator(draft, k=k), sampling=sampling)


# --------------------------------------------------------------------------
# Chain speculation
# --------------------------------------------------------------------------


class SpeculativeDecoder:
    """Chain-speculative generation loop over a LanguageModel."""

    def __init__(self, lm, speculator, *, sampling: SamplingParams | None = None):
        if not speculation_supported(lm.decoder_config):
            raise ValueError("chain speculation unsupported (KV-shared attention)")
        self.lm = lm
        self.speculator = speculator
        self.sampling = sampling or SamplingParams()
        self.max_block = max_block(lm)

    def _verify(self, state, block, draft_len: int, remaining: int, stop_ids, generator,
                ctx_limit):
        """ONE round on the device: the block's deferred forward, a sampled
        token at every row, exact-match acceptance, and a state commit
        clipped to the tokens the host loop will keep (first stop token,
        budget), so recurrent state never needs a rewind. -> (state,
        sampled [n], accepted, commit), all on the device."""
        cfg = self.lm.decoder_config
        logits, pending = decoder_forward(cfg, self.lm.params, block, state, last_only=False,
                                          defer_ssm=True, ctx_limit=ctx_limit)
        sampled = sample_rows(logits, self.sampling, generator)
        accepted = accepted_length(sampled, block, draft_len)
        commit = commit_length(sampled, accepted, remaining, stop_ids)
        return decoder_commit_deferred(cfg, pending, commit), sampled, accepted, commit

    def generate(self, prompt_tokens, max_new_tokens: int, stop_token_ids=None, seed: int = 0,
                 metrics: SpeculationMetrics | None = None, state=None, history_tokens=None):
        """Returns a SpecStream (iterable of token ids; `.state` carries the
        final decoding state). `state` resumes an existing state, whose
        uncovered suffix `prompt_tokens` then is; `history_tokens` gives
        the speculator the full token history."""
        return SpecStream(self, prompt_tokens, max_new_tokens, stop_token_ids, seed, metrics,
                          state, history_tokens)

    def _generate_impl(self, prompt_tokens, max_new_tokens: int, stop_token_ids, seed: int,
                       metrics: SpeculationMetrics | None, init_state, history_tokens, out):
        lm = self.lm
        dev = lm.device
        stop = set(stop_token_ids if stop_token_ids is not None
                   else lm.config.generation_config.stop_token_ids)
        if hasattr(self.speculator, "reset"):
            self.speculator.reset()
        history = [int(t) for t in (history_tokens if history_tokens is not None
                                    else prompt_tokens)]
        state = init_state if init_state is not None else lm.new_state()
        start = int(state["pos"])
        logits, state = lm.prefill(state, np.asarray(prompt_tokens, np.int64))
        first = int(sample(logits, self.sampling,
                           generator=torch.Generator(device=dev).manual_seed(seed)))
        pos = start + len(prompt_tokens)  # tokens covered by KV
        base = pos
        produced = 0
        token = first
        stop_ids = _stop_tensor(stop, dev)
        gen = torch.Generator(device=dev).manual_seed(seed ^ 0xD15C)

        while produced < max_new_tokens:
            yield token
            history.append(token)
            produced += 1
            if token in stop or produced >= max_new_tokens:
                break  # the next verify's commit would clip to 0
            out.state = None  # invalidated while a round is in flight
            room = lm.max_context - pos - 1
            if room <= 0:
                break
            draft = list(self.speculator.propose(history)) if room > 1 else []
            # clip to room, budget and the padded-block cap
            draft = draft[:min(len(draft), room - 1, max_new_tokens - produced,
                               self.max_block - 1)]
            n = 1 + len(draft)
            n_pad = 1
            while n_pad < n:
                n_pad *= 2
            n_pad = min(n_pad, self.max_block)
            block = np.zeros(n_pad, np.int64)
            block[0] = token
            block[1:1 + len(draft)] = draft

            state, sampled, accepted_d, commit_d = self._verify(
                state, torch.from_numpy(block).to(dev), len(draft), max_new_tokens - produced,
                stop_ids, gen, lm._ctx_bucket(pos + n_pad))
            *vals, accepted, commit = _fetch(sampled, accepted_d, commit_d)
            if metrics is not None:
                metrics.num_verify_passes += 1
                metrics.num_tokens_proposed += len(draft)
                metrics.num_tokens_accepted += accepted
            emit = vals[:accepted + 1]
            # the round committed exactly the tokens the loop below keeps
            pos += commit

            for v in emit[:-1]:
                yield v
                history.append(v)
                produced += 1
                if v in stop or produced >= max_new_tokens:
                    state["pos"] = torch.tensor(base + produced - 1, dtype=torch.int32,
                                                device=dev)
                    out.state = state
                    return
            token = emit[-1]
        # the state covers every yielded token except the last one
        state["pos"] = torch.tensor(base + max(0, produced - 1), dtype=torch.int32, device=dev)
        out.state = state


class SpecStream:
    """Iterable of speculatively decoded tokens; `.state` holds the final
    decoding state after iteration completes (session prefix cache)."""

    def __init__(self, decoder, prompt_tokens, max_new_tokens, stop_token_ids, seed, metrics,
                 state, history_tokens):
        self.state = None
        self._gen = decoder._generate_impl(prompt_tokens, max_new_tokens, stop_token_ids, seed,
                                           metrics, state, history_tokens, self)

    def __iter__(self):
        return self._gen

    def __next__(self):
        return next(self._gen)


# --------------------------------------------------------------------------
# Tree speculation
# --------------------------------------------------------------------------


class TokenTree:
    """Host-side linearized token tree: node 0 is the root (current token);
    parents[i] < i."""

    def __init__(self, root_token: int):
        self.tokens: list[int] = [int(root_token)]
        self.parents: list[int] = [-1]

    def add(self, parent: int, token: int) -> int:
        self.tokens.append(int(token))
        self.parents.append(int(parent))
        return len(self.tokens) - 1

    def add_chain(self, parent: int, tokens) -> None:
        for t in tokens:
            parent = self.add(parent, t)

    def __len__(self) -> int:
        return len(self.tokens)

    def depths(self) -> list[int]:
        out = [0] * len(self.tokens)
        for i, p in enumerate(self.parents):
            if p >= 0:
                out[i] = out[p] + 1
        return out

    def ancestor_mask(self, size: int) -> np.ndarray:
        """[size, size] bool: mask[q, k] = node k is q or an ancestor of q
        (padded rows see only themselves, which keeps the softmax finite).
        A tree larger than `size` contributes its first `size` nodes:
        parents precede children, so that is a valid forest."""
        n = min(len(self.tokens), size)
        mask = np.zeros((size, size), bool)
        for i in range(n):
            j = i
            while j >= 0:
                mask[i, j] = True
                j = self.parents[j]
        for i in range(n, size):
            mask[i, i] = True
        return mask

    def children(self, node: int) -> list[int]:
        return [i for i, p in enumerate(self.parents) if p == node]


class NgramTreeSpeculator:
    """Builds a tree by merging up to `branches` distinct n-gram
    continuations of the recent history into a prefix trie."""

    def __init__(self, max_ngram: int = 3, depth: int = 4, branches: int = 3):
        self.max_ngram = max_ngram
        self.depth = depth
        self.branches = branches

    def reset(self):
        pass

    def propose(self, history: list[int], root_token: int) -> TokenTree:
        tree = TokenTree(root_token)
        h = history + [root_token]
        candidates: list[list[int]] = []
        for n in range(self.max_ngram, 0, -1):
            if len(h) < n + 1:
                continue
            suffix = h[-n:]
            for start in range(len(h) - n - 1, -1, -1):
                if h[start:start + n] == suffix:
                    cont = h[start + n:start + n + self.depth]
                    if cont and cont not in candidates:
                        candidates.append(cont)
                if len(candidates) >= self.branches:
                    break
            if len(candidates) >= self.branches:
                break
        # merge candidates into the trie (longest first for prefix sharing)
        for cand in sorted(candidates, key=len, reverse=True):
            node = 0
            for tok in cand:
                nxt = next((c for c in tree.children(node) if tree.tokens[c] == tok), None)
                node = nxt if nxt is not None else tree.add(node, tok)
        return tree


def compact_kv(layers, pos0, idx: torch.Tensor) -> None:
    """Move the accepted nodes' KV rows (slots pos0 + idx) to consecutive
    slots pos0 .. pos0 + len(idx) - 1 of every attention cache in
    `layers`, in place; entries without KV (recurrent states, None) are
    left alone."""
    dst = pos0 + torch.arange(idx.shape[0], device=idx.device)
    src = pos0 + idx
    for cache in layers:
        if cache is None or ("k" not in cache and "k_q" not in cache):
            continue
        for name in ("k", "v", "k_q", "v_q", "k_s", "v_s"):
            if name in cache:
                buf = cache[name]
                buf.index_copy_(0, dst.long(), buf.index_select(0, src.long()))


def _deferred_tree_accept(lcs, pending: dict, idx: torch.Tensor, path_idx, conv_commit: dict,
                          new_pos: torch.Tensor) -> dict:
    """Accept for a tree verify on a model WITH recurrent mixers (shared by
    TreeSpeculativeDecoder and DFlashSpeculativeDecoder): compact the
    attention rows at the pending write base (its pos, which the deferred
    verify left alone) and replay each recurrent state over the accepted
    path (`ssm_tree_commit`)."""
    attn = [isinstance(lc.mixer_config, AttentionConfig) for lc in lcs]
    compact_kv([e for e, a in zip(pending["layers"], attn) if a], pending["pos"], idx)
    layers = [entry if a else ssm_tree_commit(lc.mixer_config, entry, path_idx,
                                              conv_commit[lc.mixer_config.kernel_size])
              for lc, entry, a in zip(lcs, pending["layers"], attn)]
    return {"layers": layers, "pos": new_pos}


def _tree_conv_windows(parents: np.ndarray, k: int) -> np.ndarray:
    """[M, K] i32: each node's causal-conv tap sources, linearized into
    concat([conv state rows (k-1, oldest first), node input rows (M)]).
    Tap k-1 is the node itself; earlier taps walk the ancestor chain and
    spill into the conv state's tail past the root."""
    m = len(parents)
    src = np.zeros((m, k), np.int32)
    for j in range(m):
        chain = []
        c = j
        while c >= 0 and len(chain) < k:
            chain.append(c)
            c = parents[c]
        for t in range(k):
            back = k - 1 - t  # steps back from node j
            if back < len(chain):
                src[j, t] = (k - 1) + chain[back]
            else:
                src[j, t] = (k - 2) - (back - len(chain))
    return src


def _tree_conv_commit_idx(parents: np.ndarray, last: int, k: int) -> np.ndarray:
    """[k-1] i32: the committed conv state's rows (oldest first), the last
    k-1 inputs along the accepted path ending at node `last`, in
    `_tree_conv_windows`'s linearization."""
    out = np.zeros(max(k - 1, 0), np.int32)
    chain = []
    c = last
    while c >= 0 and len(chain) < k - 1:
        chain.append(c)
        c = parents[c]
    for i in range(k - 1):
        back = k - 2 - i
        if back < len(chain):
            out[i] = (k - 1) + chain[back]
        else:
            out[i] = (k - 2) - (back - len(chain))
    return out


class _TreeVerifier:
    """The verify / accept half shared by the tree decoders: one forward
    over the padded tree (deferred, along ancestor edges, on models with
    recurrent mixers), the host's accept walk, and the accept that
    compacts KV rows and replays recurrent state."""

    def __init__(self, lm, sampling, max_nodes: int):
        if not speculation_supported(lm.decoder_config):
            raise ValueError("tree speculation unsupported (KV-shared attention)")
        if getattr(lm, "ring_windows", False):
            raise ValueError("tree speculation requires the full KV layout")
        self.lm = lm
        self.sampling = sampling or SamplingParams()
        self.max_nodes = max_nodes
        lcs = lm.decoder_config.transformer_config.layer_configs
        self._recurrent = any(not isinstance(lc.mixer_config, AttentionConfig) for lc in lcs)
        self._kernel_sizes = sorted({lc.mixer_config.kernel_size for lc in lcs
                                     if not isinstance(lc.mixer_config, AttentionConfig)})

    def _accept(self, state: dict, idx: torch.Tensor, new_pos: torch.Tensor, m: int) -> dict:
        """Compact accepted node rows (slots pos0 + idx) to consecutive
        slots pos0 .. pos0 + a, then set pos. pos0 is the verify's WRITE
        base: the verify forward advanced the state's pos by its m rows,
        so the base is pos - m (an off-by-m here turns the compaction into
        a no-op on the live region, which only a non-consecutive accept
        path shows)."""
        compact_kv(state["layers"], state["pos"] - m, idx)
        return dict(state, pos=new_pos)

    def _tree_round(self, state, tree: TokenTree, pos: int, pad_position: int, generator,
                    taps: tuple = ()):
        """Verify `tree` (its first max_nodes nodes, padded to a power of
        two) and accept its longest matching path. -> (state, emitted
        tokens, nodes proposed, nodes accepted, features of the accepted
        rows [max_nodes, n_tap, D] or None)."""
        lm = self.lm
        dev = lm.device
        m_real = min(len(tree), self.max_nodes)
        m = 1
        while m < m_real:
            m *= 2
        m = min(m, self.max_nodes)
        tokens = np.zeros(m, np.int64)
        tokens[:m_real] = tree.tokens[:m_real]
        positions = np.full(m, pad_position, np.int64)
        positions[:m_real] = [pos + d for d in tree.depths()[:m_real]]
        positions = np.minimum(positions, lm.max_context - 1)
        mask = torch.from_numpy(tree.ancestor_mask(m)).to(dev)

        kw = dict(positions=torch.from_numpy(positions).to(dev), tree_mask=mask,
                  collect_layers=taps, ctx_limit=lm._ctx_bucket(pos + m))
        parents_np = None
        if self._recurrent:
            parents_np = np.arange(-1, m - 1, dtype=np.int32)
            parents_np[:m_real] = tree.parents[:m_real]
            kw.update(defer_ssm=True, tree_parents=parents_np, tree_conv_src={
                k: torch.from_numpy(_tree_conv_windows(parents_np, k)).to(dev)
                for k in self._kernel_sizes})
        out = decoder_forward(lm.decoder_config, lm.params, torch.from_numpy(tokens).to(dev),
                              state, last_only=False, **kw)
        logits, state = out[0], out[1]
        vals = sample_rows(logits, self.sampling, generator).tolist()

        # the host accept walk: follow the child matching the token sampled
        # at each accepted node
        path = [0]
        node = 0
        while True:
            want = vals[node]
            nxt = next((c for c in tree.children(node)
                        if c < m_real and tree.tokens[c] == want), None)
            if nxt is None:
                break
            path.append(nxt)
            node = nxt
        emit = [vals[n] for n in path]  # sampled at each path node

        # compact accepted rows to consecutive slots; the root already
        # sits at slot pos (node 0)
        a = len(path)
        idx = np.zeros(self.max_nodes, np.int64)
        idx[:a] = path
        idx[a:] = path[-1]
        idx_t = torch.from_numpy(idx).to(dev)
        new_pos = torch.tensor(pos + a, dtype=torch.int32, device=dev)
        if self._recurrent:
            path_idx = np.full(self.max_nodes, -1, np.int64)
            path_idx[:a] = path
            conv_commit = {k: torch.from_numpy(_tree_conv_commit_idx(parents_np, path[-1], k))
                           .to(dev) for k in self._kernel_sizes}
            state = _deferred_tree_accept(
                lm.decoder_config.transformer_config.layer_configs, state, idx_t, path_idx,
                conv_commit, new_pos)
        else:
            state = self._accept(state, idx_t, new_pos, m)
        feats = out[2].index_select(0, idx_t) if taps else None
        return state, emit, m_real - 1, a - 1, feats


class TreeSpeculativeDecoder(_TreeVerifier):
    """Tree-speculative generation: one forward verifies a whole token
    tree; the host walks the accept path (the sampled token must match the
    child); the accepted nodes' KV rows are compacted to consecutive slots.
    Recurrent mixers verify over the tree too: each mixer's recurrence
    runs along ancestor edges (`ssm_tree_forward`) without committing, and
    the accept replays the state over just the accepted path."""

    def __init__(self, lm, speculator=None, *, sampling: SamplingParams | None = None,
                 max_nodes: int = 16):
        super().__init__(lm, sampling, max_nodes)
        self.speculator = speculator or NgramTreeSpeculator()

    def generate(self, prompt_tokens, max_new_tokens: int, stop_token_ids=None, seed: int = 0,
                 metrics: SpeculationMetrics | None = None):
        lm = self.lm
        dev = lm.device
        stop = set(stop_token_ids if stop_token_ids is not None
                   else lm.config.generation_config.stop_token_ids)
        self.speculator.reset()
        history = [int(t) for t in prompt_tokens]
        state = lm.new_state()
        logits, state = lm.prefill(state, np.asarray(prompt_tokens, np.int64))
        token = int(sample(logits, self.sampling,
                           generator=torch.Generator(device=dev).manual_seed(seed)))
        pos = len(history)
        produced = 0
        gen = torch.Generator(device=dev).manual_seed(seed ^ 0x7EEE)

        while produced < max_new_tokens:
            yield token
            history.append(token)
            produced += 1
            if token in stop or produced >= max_new_tokens:
                return
            if pos + self.max_nodes + 1 > lm.max_context:
                return
            tree = self.speculator.propose(history[:-1], token)
            # padded rows sit in the far future
            state, emit, proposed, accepted, _ = self._tree_round(state, tree, pos, pos + 63,
                                                                   gen)
            if metrics is not None:
                metrics.num_verify_passes += 1
                metrics.num_tokens_proposed += proposed
                metrics.num_tokens_accepted += accepted
            pos += len(emit)
            for v in emit[:-1]:
                yield v
                history.append(v)
                produced += 1
                if v in stop or produced >= max_new_tokens:
                    return
            token = emit[-1]


class DFlashSpeculativeDecoder(_TreeVerifier):
    """Tree speculation driven by a DFlash draft: the target's forward taps
    hidden features; the accepted tokens' features are written into the
    draft's KV (`DFlashDraft.accept`); each step the draft predicts the
    whole lookahead block in one forward, and the per-depth top candidates
    are assembled on the host into a tree, verified like
    TreeSpeculativeDecoder's."""

    def __init__(self, lm, dflash, *, sampling: SamplingParams | None = None,
                 max_nodes: int = 16, children: int = 2):
        super().__init__(lm, sampling, max_nodes)
        self.dflash = dflash
        self.children = children
        self.taps = tuple(dflash.cfg.target_layer_ids)

    def _build_tree(self, root_token: int, ids, vals) -> TokenTree:
        """Host weaver: a chain of top-1 candidates with top-`children`
        branches at each depth, bounded by max_nodes."""
        tree = TokenTree(root_token)
        parent = 0
        for depth in range(ids.shape[0]):
            if len(tree) >= self.max_nodes:
                break
            row = ids[depth]
            first = None
            for c in range(min(self.children, row.shape[0])):
                if len(tree) >= self.max_nodes:
                    break
                node = tree.add(parent, int(row[c]))
                if first is None:
                    first = node
            if first is None:
                break
            parent = first  # the chain continues through the top-1 candidate
        return tree

    def generate(self, prompt_tokens, max_new_tokens: int, stop_token_ids=None, seed: int = 0,
                 metrics: SpeculationMetrics | None = None):
        lm = self.lm
        dev = lm.device
        stop = set(stop_token_ids if stop_token_ids is not None
                   else lm.config.generation_config.stop_token_ids)
        state = lm.new_state()
        dstate = self.dflash.new_state()
        ecfg = lm.decoder_config.embedding_config
        eparams = lm.params["embedding"]

        # chunked prefill with feature taps feeding the draft KV
        prompt = [int(t) for t in prompt_tokens]
        chunk = max(lm.prefill_buckets)
        logits = None
        i = 0
        while i < len(prompt):
            take = min(chunk, len(prompt) - i)
            padded = np.zeros(chunk, np.int64)
            padded[:take] = prompt[i:i + take]
            logits, state, feats = decoder_forward(
                lm.decoder_config, lm.params, torch.from_numpy(padded).to(dev), state,
                last_only=True, true_length=take, collect_layers=self.taps,
                ctx_limit=lm._ctx_bucket(i + chunk))
            logits = logits[0]
            dstate = self.dflash.accept(dstate, feats, take)
            i += take

        token = int(sample(logits, self.sampling,
                           generator=torch.Generator(device=dev).manual_seed(seed)))
        pos = len(prompt)
        produced = 0
        gen = torch.Generator(device=dev).manual_seed(seed ^ 0xDF1A)

        while produced < max_new_tokens:
            yield token
            produced += 1
            if token in stop or produced >= max_new_tokens:
                return
            if pos + self.max_nodes + 1 > lm.max_context:
                return
            ids, vals = self.dflash.draft(dstate, eparams, ecfg, token,
                                          candidate_count=self.children)
            tree = self._build_tree(token, ids, vals)
            state, emit, proposed, accepted, packed = self._tree_round(
                state, tree, pos, pos, gen, self.taps)
            if metrics is not None:
                metrics.num_verify_passes += 1
                metrics.num_tokens_proposed += proposed
                metrics.num_tokens_accepted += accepted
            # the accepted nodes' target features into the draft KV
            dstate = self.dflash.accept(dstate, packed, len(emit))
            pos += len(emit)
            for v in emit[:-1]:
                yield v
                produced += 1
                if v in stop or produced >= max_new_tokens:
                    return
            token = emit[-1]
