"""The one traffic generator: a mix is a data file under `traffic/`.

A closed-loop mix has `clients` clients; client c's j-th request is entry
j * clients + c of the stream. The stream comes in rounds of `clients`
requests, and every round holds the same set of sizes: prompt length i of
a round is the (i + 1/2)/clients quantile of the prompt distribution,
paired with output quantile (i * PAIR_STRIDE) mod clients, and the round
deals them to the clients in an order fixed by the round's index alone.
The seed draws the token ids (uniform over the vocabulary): every seed
asks for the same sizes in the same order. (Dealt by the seed, the order
moved a cell's throughput by 10-15% and its p90 TTFT by 40% between
seeds on an H100, where two runs of one seed agreed within 2%.)

Distributions: {"dist": "log_uniform" | "uniform", "min": a, "max": b}.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

DEAL_SEED = 0x5EED5  # the fixed order in which each round's sizes are dealt
PAIR_STRIDE = 13  # pairs prompt quantile i with output quantile 13 i mod clients


def quantile(dist: dict, u: float) -> int:
    a, b = dist["min"], dist["max"]
    if dist["dist"] == "log_uniform":
        return int(round(math.exp(math.log(a) + u * (math.log(b) - math.log(a)))))
    if dist["dist"] == "uniform":
        return int(round(a + u * (b - a)))
    raise ValueError(f"unknown distribution {dist['dist']!r}")


def round_sizes(mix: dict) -> list[tuple[int, int]]:
    """The (prompt, output) sizes of one round, in quantile order."""
    c = mix["clients"]
    if math.gcd(PAIR_STRIDE, c) != 1:
        raise ValueError(f"the number of clients must be prime to {PAIR_STRIDE}")
    prompts = [quantile(mix["prompt"], (i + 0.5) / c) for i in range(c)]
    outputs = [quantile(mix["output"], (i + 0.5) / c) for i in range(c)]
    return [(prompts[i], outputs[(i * PAIR_STRIDE) % c]) for i in range(c)]


@dataclasses.dataclass
class Request:
    index: int  # position in the stream
    client: int
    prompt: list
    max_new_tokens: int


class Stream:
    """Requests of one mix under one seed, made on demand."""

    def __init__(self, mix: dict, seed: int, vocab: int):
        self.mix, self.seed, self.vocab = mix, int(seed), vocab
        self.clients = mix["clients"]
        self.sizes = round_sizes(mix)
        self._deals: dict[int, np.ndarray] = {}

    def _deal(self, r: int) -> np.ndarray:
        if r not in self._deals:
            self._deals[r] = np.random.default_rng([DEAL_SEED, r]).permutation(self.clients)
        return self._deals[r]

    def request(self, client: int, j: int) -> Request:
        n_prompt, n_out = self.sizes[int(self._deal(j)[client])]
        ids = np.random.default_rng([self.seed, 2, j, client]).integers(0, self.vocab, n_prompt)
        return Request(index=j * self.clients + client, client=client,
                       prompt=ids.tolist(), max_new_tokens=n_out)


def buckets_used(mix: dict, buckets) -> list[int]:
    """The prefill buckets a mix's prompts reach: whole chunks of the
    largest bucket, then the remainder's bucket."""
    buckets = sorted(buckets)
    top = buckets[-1]
    lo, hi = mix["prompt"]["min"], mix["prompt"]["max"]
    used = set()
    for n in range(lo, hi + 1):
        if n >= top:
            used.add(top)
        r = n - top * ((n - 1) // top)
        used.add(next(b for b in buckets if b >= r))
        if len(used) == len(buckets):
            break
    return sorted(used)
