"""Device-side n-gram prompt-lookup proposer (vectorized, fixed shape).

Counterpart of `uzu_tpu/ops/ngram.py`: the rule of the host
`NgramSpeculator` (`engine/speculation.py`) over a history buffer on the
device, so prompt-lookup drafts can ride the fused multi-round decoder
(`engine/fused_spec.py`) with no host sync. For n = max_n .. 1 every
window of the history is compared with the current suffix n-gram in one
vector op, the most recent earlier match with at least one continuation
token wins, and up to k of its continuation tokens are the draft.
"""

from __future__ import annotations

import torch


def ngram_propose(hist: torch.Tensor, hlen: torch.Tensor, k: int, max_n: int = 3):
    """Propose up to `k` continuation tokens from the history buffer.

    hist: [C] integer token buffer whose rows [0, hlen) are the history,
    oldest first; hlen: a 0-d device tensor. Returns (draft [k] int32,
    draft_len 0-d int32); rows past draft_len are garbage the caller masks
    out of acceptance (they are safe to feed a causal verify)."""
    draft, dlen = ngram_propose_batched(hist[None], hlen.reshape(1), k, max_n)
    return draft[0], dlen[0]


def ngram_propose_batched(hist: torch.Tensor, hlen: torch.Tensor, k: int, max_n: int = 3):
    """`ngram_propose` for B histories at once: hist [B, C], hlen [B] ->
    (draft [B, k] int32, draft_len [B] int32), each row the single
    proposer's result on its own history (the speculative batch engines'
    fused rounds)."""
    b, c = hist.shape
    dev = hist.device
    idx = torch.arange(c, device=dev)[None, :]
    hist = hist.long()
    hist_pad = torch.cat([hist, torch.zeros((b, k), dtype=hist.dtype, device=dev)], dim=1)
    draft = torch.zeros((b, k), dtype=torch.int32, device=dev)
    dlen = torch.zeros(b, dtype=torch.int32, device=dev)
    found_any = torch.zeros(b, dtype=torch.bool, device=dev)
    hlen = hlen.long().reshape(b, 1)
    for n in range(max_n, 0, -1):
        ok = (idx + n <= hlen - 1) & (hlen >= n + 1)
        for i in range(n):
            s_i = hist.gather(1, torch.clamp(hlen - n + i, min=0))
            # w[j] = hist[j + i]; the wrapped rows are outside the ok bounds
            ok = ok & (torch.roll(hist, -i, dims=1) == s_i)
        best = torch.where(ok, idx, -1).amax(dim=1)
        found = best >= 0
        start = torch.clamp(best, min=0) + n
        cont = hist_pad.gather(1, torch.clamp(
            start[:, None] + torch.arange(k, device=dev)[None, :], max=c + k - 1))
        c_len = torch.clamp(hlen[:, 0] - start, 0, k).to(torch.int32)
        use = found & ~found_any
        draft = torch.where(use[:, None], cont.to(torch.int32), draft)
        dlen = torch.where(use, c_len, dlen)
        found_any = found_any | found
    return draft, dlen
