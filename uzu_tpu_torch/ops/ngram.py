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
    c = hist.shape[0]
    dev = hist.device
    idx = torch.arange(c, device=dev)
    hist = hist.long()
    hist_pad = torch.cat([hist, torch.zeros(k, dtype=hist.dtype, device=dev)])
    draft = torch.zeros(k, dtype=torch.int32, device=dev)
    dlen = torch.zeros((), dtype=torch.int32, device=dev)
    found_any = torch.zeros((), dtype=torch.bool, device=dev)
    hlen = hlen.long()
    for n in range(max_n, 0, -1):
        ok = (idx + n <= hlen - 1) & (hlen >= n + 1)
        for i in range(n):
            s_i = hist.gather(0, torch.clamp(hlen - n + i, min=0).reshape(1))
            # w[j] = hist[j + i]; the wrapped rows are outside the ok bounds
            ok = ok & (torch.roll(hist, -i) == s_i)
        best = torch.where(ok, idx, -1).max()
        found = best >= 0
        start = torch.clamp(best, min=0) + n
        cont = hist_pad.gather(0, torch.clamp(start + torch.arange(k, device=dev), max=c + k - 1))
        c_len = torch.clamp(hlen - start, 0, k).to(torch.int32)
        use = found & ~found_any
        draft = torch.where(use, cont.to(torch.int32), draft)
        dlen = torch.where(use, c_len, dlen)
        found_any = found_any | found
    return draft, dlen
