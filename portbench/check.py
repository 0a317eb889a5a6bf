"""Whether the timed path's outputs are correct.

After the window closes and the engine is freed, a sample of the requests
that ended in the window, drawn from the seed with the longest among them,
is run through the plain reference (`reference/`) once, teacher-forced
over prompt and served tokens. The number compared is the widest gap by
which a served token's reference logit lies below the reference's best
logit at its position (`max_logit_gap`): 0 where every served token is
the reference's greedy choice, small where bf16 rounding breaks a
near-tie, large where a token is wrong. Every request of the window must
also have served exactly its asked number of tokens (`wrong_lengths`).

The control (`control_gaps`) puts the reference in the program's place at
the next precision down (fp8 activations): at each position of the same
prompts and tokens, the gap of the token the control ranks first.
"""

from __future__ import annotations

import numpy as np
import torch

from .reference import model as reference


def draw_sample(ended: list, seed: int, target_tokens: int) -> list:
    """The longest request that ended in the window, then others in an
    order drawn from the seed, until `target_tokens` served tokens."""
    if not ended:
        return []
    order = sorted(ended, key=lambda r: (r["n_prompt"] + len(r["tokens"]), r["index"]))
    picks = [order[-1]]
    rest = order[:-1]
    rng = np.random.default_rng([int(seed), 9])
    for i in rng.permutation(len(rest)):
        if sum(len(r["tokens"]) for r in picks) >= target_tokens:
            break
        picks.append(rest[int(i)])
    return picks


def _inputs(picks):
    seqs = [r["prompt"] + r["tokens"][:-1] for r in picks]
    rows = [list(range(r["n_prompt"] - 1, r["n_prompt"] - 1 + len(r["tokens"]))) for r in picks]
    return seqs, rows


def served_gaps(spec, raw: dict, picks: list) -> tuple[list, list]:
    """Per sampled request, the gap of each served token; and the
    reference's logits (kept for the control)."""
    seqs, rows = _inputs(picks)
    ref = reference.logits(spec, raw, seqs, rows)
    gaps = []
    for r, lg in zip(picks, ref):
        served = torch.as_tensor(r["tokens"], device=lg.device, dtype=torch.long)
        gaps.append((lg.max(dim=-1).values - lg.gather(1, served[:, None])[:, 0]).tolist())
    return gaps, ref


def control_gaps(spec, raw: dict, picks: list, ref: list) -> list:
    seqs, rows = _inputs(picks)
    low = reference.logits(spec, raw, seqs, rows, lowp=True)
    out = []
    for lg, lo in zip(ref, low):
        top = lo.argmax(dim=-1)
        out.append((lg.max(dim=-1).values - lg.gather(1, top[:, None])[:, 0]).tolist())
    return out


def wrong_lengths(ended: list) -> int:
    return sum(1 for r in ended
               if len(r["tokens"]) != r["max_new"] or r["finish_reason"] != "length")
