"""The traffic generator: a seed repeats exactly, sizes follow the stated
ranges, and every seed asks for the same set of sizes in another order."""

import collections
import json
import os

import pytest

from portbench import traffic
from portbench.spec import HERE

MIXES = sorted(f[:-5] for f in os.listdir(os.path.join(HERE, "traffic")) if f.endswith(".json"))


def _mix(name):
    with open(os.path.join(HERE, "traffic", name + ".json")) as f:
        return json.load(f)


def _requests(mix, seed, rounds=2, vocab=65536):
    s = traffic.Stream(mix, seed, vocab)
    return [s.request(c, j) for j in range(rounds) for c in range(mix["clients"])]


@pytest.mark.parametrize("name", MIXES)
def test_same_seed_same_requests(name):
    mix = _mix(name)
    a, b = _requests(mix, 2 ** 31 + 12345), _requests(mix, 2 ** 31 + 12345)
    assert [(r.prompt, r.max_new_tokens) for r in a] == [(r.prompt, r.max_new_tokens) for r in b]


@pytest.mark.parametrize("name", MIXES)
def test_sizes_in_stated_ranges(name):
    mix = _mix(name)
    for r in _requests(mix, 7):
        assert mix["prompt"]["min"] <= len(r.prompt) <= mix["prompt"]["max"]
        assert mix["output"]["min"] <= r.max_new_tokens <= mix["output"]["max"]
        assert all(0 <= t < 65536 for t in r.prompt[:100])


@pytest.mark.parametrize("name", MIXES)
def test_every_seed_asks_the_same_sizes_in_the_same_order(name):
    mix = _mix(name)
    c = mix["clients"]
    rounds = []
    for seed in (1, 2 ** 32 + 5):
        reqs = _requests(mix, seed, rounds=3)
        for j in range(3):
            rounds.append(collections.Counter(
                (len(r.prompt), r.max_new_tokens) for r in reqs[j * c:(j + 1) * c]))
    assert all(r == rounds[0] for r in rounds)
    a, b = _requests(mix, 1), _requests(mix, 2)
    assert [(len(r.prompt), r.max_new_tokens) for r in a] == \
        [(len(r.prompt), r.max_new_tokens) for r in b]
    assert [len(r.prompt) for r in a[:c]] != [len(r.prompt) for r in a[c:2 * c]]
    assert all(x.prompt[:8] != y.prompt[:8] for x, y in zip(a, b))


def test_quantiles_span_the_distribution():
    mix = {"clients": 4, "prompt": {"dist": "log_uniform", "min": 100, "max": 1600},
           "output": {"dist": "uniform", "min": 10, "max": 50}}
    sizes = traffic.round_sizes(mix)
    assert [p for p, _ in sizes] == [141, 283, 566, 1131]
    assert sorted(o for _, o in sizes) == [15, 25, 35, 45]


def test_buckets_used():
    buckets = [64, 256, 1024, 2048, 4096]
    assert traffic.buckets_used(_mix("long-prompt"), buckets) == buckets
    assert traffic.buckets_used({"prompt": {"min": 4096, "max": 4096}}, buckets) == [4096]
    assert traffic.buckets_used({"prompt": {"min": 4097, "max": 4100}}, buckets) == [64, 4096]
