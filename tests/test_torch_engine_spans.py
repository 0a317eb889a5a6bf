"""The batch engines' program spans and counters, on the CPU.

`BatchEngine` and `PagedBatchEngine` record spans (`tools/profile.py`)
only while a `torch.profiler` session runs: each nested under its parent
and inside its interval, on the `perf_counter` clock, with the queue's
length and the decode steps they dispatched, and the queue's gauge at its
every change. Greedy streams do not change with the spans on. The
always-on counters (`stats`) count admissions, preemptions with the
tokens they recompute, prefix-cache evictions and KV growth, and the
batched server's `GET /v1/stats` serves them.
"""

import json
import time
import urllib.request

import numpy as np
import pytest
import torch

from uzu_tpu_torch import LanguageModel
from uzu_tpu_torch.engine.batch import BatchEngine
from uzu_tpu_torch.engine.paged_batch import PagedBatchEngine
from uzu_tpu_torch.server import serve_batched
from uzu_tpu_torch.sessions import Tokenizer
from uzu_tpu_torch.tools import profile
from uzu_tpu_torch.tools.synth import llama_config, synth_chat_model, synthesize

torch.set_num_threads(1)

TINY = dict(num_layers=2, model_dim=128, hidden_dim=256, num_heads=8, num_groups=2,
            head_dim=16, vocab_size=256, tied=False)
# a one-chunk prompt, a three-chunk one (buckets of 16) and a short one
PROMPTS = [[1, 2, 3, 4, 5], [(i * 7) % 256 for i in range(40)], [9, 8, 7]]
NEW = [10, 7, 12]
NAMES = {"engine.step", "engine.decode_dispatch", "engine.queued"}


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    return synthesize(llama_config(**TINY), str(tmp_path_factory.mktemp("spans")), seed=13,
                      dtype=np.float32)


def _lm(model_dir):
    return LanguageModel.from_dir(model_dir, device="cpu", max_context=128, prefill_buckets=(16,))


def _engine(model_dir, kind, num_pages=33):
    if kind == "paged":
        return PagedBatchEngine(_lm(model_dir), batch_size=2, decode_chunk=4,
                                num_pages=num_pages, page_size=8, stop_token_ids=[])
    return BatchEngine(_lm(model_dir), batch_size=2, decode_chunk=4, stop_token_ids=[])


def _cpu_profiler():
    return torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])


def _serve(eng, profiled: bool):
    """Submit PROMPTS and run the engine to its end, under a CPU profiler
    when `profiled`; returns (requests, spans recorded, t0, t1)."""
    t0 = time.perf_counter()
    reqs = [eng.submit(p, n) for p, n in zip(PROMPTS, NEW)]
    if profiled:
        with _cpu_profiler():
            eng.run()
    else:
        eng.run()
    t1 = time.perf_counter()
    return reqs, profile.spans(t0, t1), t0, t1


@pytest.mark.parametrize("kind", ["dense", "paged"])
def test_no_span_without_a_profiler(model_dir, kind):
    eng = _engine(model_dir, kind)
    reqs, spans, _, _ = _serve(eng, profiled=False)
    assert all(r.finished for r in reqs)
    assert spans == []


@pytest.mark.parametrize("kind", ["dense", "paged"])
def test_spans_nest_under_their_parents(model_dir, kind):
    eng = _engine(model_dir, kind)
    reqs, spans, t0, t1 = _serve(eng, profiled=True)
    assert {s[0] for s in spans} == NAMES
    assert all(r.finished for r in reqs)
    by_id = {s[3]: s for s in spans}
    for name, start, end, sid, parent, rid, info in spans:
        assert t0 <= start <= end <= t1 and rid == -1
        if name == "engine.queued":
            assert start == end and parent == -1
            assert 0 <= info["value"] <= len(PROMPTS)
        elif name == "engine.step":
            assert parent == -1 and 0 <= info["queued"] <= len(PROMPTS)
        else:
            up = by_id[parent]
            assert up[0] == "engine.step" and up[1] <= start <= end <= up[2]
    steps = [s for s in spans if s[0] == "engine.step"]
    # all three were queued before the first step; none is left at the end
    assert steps[0][6]["queued"] == len(PROMPTS) and steps[-1][6]["queued"] == 0
    dispatches = [s for s in spans if s[0] == "engine.decode_dispatch"]
    assert len(dispatches) == eng.stats["decode_chunks"]


@pytest.mark.parametrize("kind", ["dense", "paged"])
def test_queue_gauge_follows_the_queue(model_dir, kind):
    """The gauge is sampled at every submit, admission and cancel: each
    sample differs from the one before by one request, and it ends at 0."""
    eng = _engine(model_dir, kind)
    t0 = time.perf_counter()
    with _cpu_profiler():
        reqs = [eng.submit(p, n) for p, n in zip(PROMPTS, NEW)]
        gone = eng.submit([3, 3, 3], 5)
        eng.cancel(gone)
        eng.run()
    values = [s[6]["value"] for s in profile.spans(t0, time.perf_counter())
              if s[0] == "engine.queued"]
    assert all(r.finished for r in reqs) and gone.finish_reason == "cancelled"
    assert values[:5] == [1, 2, 3, 4, 3] and values[-1] == 0
    assert all(abs(b - a) == 1 for a, b in zip(values, values[1:]))
    assert sum(b < a for a, b in zip(values, values[1:])) == 1 + eng.stats["admissions"] == 4


@pytest.mark.parametrize("kind", ["dense", "paged"])
def test_decode_steps_of_the_profiled_part(model_dir, kind):
    """Steps summed over the decode spans equal the decode chunks that the
    profiled steps dispatched, times K; the counter agrees."""
    eng = _engine(model_dir, kind)
    reqs = [eng.submit(p, n) for p, n in zip(PROMPTS, NEW)]
    for _ in range(3):
        eng.step()
    before = dict(eng.stats)
    t0 = time.perf_counter()
    with _cpu_profiler():
        eng.run()
    spans = profile.spans(t0, time.perf_counter())
    chunks = eng.stats["decode_chunks"] - before["decode_chunks"]
    assert all(r.finished for r in reqs) and chunks > 0
    steps = [s[6]["steps"] for s in spans if s[0] == "engine.decode_dispatch"]
    assert sum(steps) == chunks * eng.decode_chunk
    assert set(steps) == {eng.decode_chunk}


def test_a_dispatch_that_enqueues_nothing_records_zero_steps(model_dir):
    """A request alone in a pool it cannot grow in finishes as "length"
    inside the dispatch, which then enqueues no chunk."""
    eng = _engine(model_dir, "paged", num_pages=5)
    t0 = time.perf_counter()
    with _cpu_profiler():
        req = eng.submit([5, 4, 3], 60)
        eng.run()
    spans = profile.spans(t0, time.perf_counter())
    assert req.finish_reason == "length"
    steps = [s[6]["steps"] for s in spans if s[0] == "engine.decode_dispatch"]
    assert steps.count(0) == 1 and steps[-1] == 0
    assert sum(steps) == eng.stats["decode_chunks"] * eng.decode_chunk


def test_span_times_fall_between_clock_reads(model_dir):
    eng = _engine(model_dir, "paged")
    before = time.perf_counter()
    with _cpu_profiler():
        eng.submit(PROMPTS[0], 6)
        eng.run()
    after = time.perf_counter()
    new = [s for s in profile.spans(float("-inf"), float("inf")) if s[2] >= before]
    assert len(new) > 5 and {s[0] for s in new} <= NAMES
    assert all(before <= s[1] <= s[2] <= after for s in new)


@pytest.mark.parametrize("kind", ["dense", "paged"])
def test_greedy_streams_equal_with_spans_on_and_off(model_dir, kind):
    off, _, _, _ = _serve(_engine(model_dir, kind), profiled=False)
    on, spans, _, _ = _serve(_engine(model_dir, kind), profiled=True)
    assert spans and [r.tokens for r in on] == [r.tokens for r in off]
    assert all(len(r.tokens) == n for r, n in zip(on, NEW))


def test_preemption_and_recompute_counters(model_dir):
    """4 usable pages of 8 tokens: the two requests cannot coexist, so the
    younger is preempted and recomputed; each preemption throws away its
    prompt and the tokens it had sampled, and the request is admitted
    again. The queue's gauge rises at each submit and each requeue."""
    eng = _engine(model_dir, "paged", num_pages=5)
    lm = eng.lm
    thrown = []
    preempt = eng._preempt

    def counting(slot_i):
        req = eng.slots[slot_i].request
        thrown.append(len(req.prompt) + len(req.tokens))
        preempt(slot_i)

    eng._preempt = counting
    t0 = time.perf_counter()
    with _cpu_profiler():
        ra, rb = eng.submit([1, 2, 3], 20), eng.submit([9, 8, 7], 20)
        eng.run()
    values = [s[6]["value"] for s in profile.spans(t0, time.perf_counter())
              if s[0] == "engine.queued"]
    assert ra.tokens == lm.generate_list(np.asarray([1, 2, 3]), 20, stop_token_ids=[])
    assert rb.tokens == lm.generate_list(np.asarray([9, 8, 7]), 20, stop_token_ids=[])
    n = ra.preempted + rb.preempted
    assert n >= 1 and eng.stats["preemptions"] == n == len(thrown)
    assert eng.stats["recomputed_tokens"] == sum(thrown) > 3 * n
    assert eng.stats["admissions"] == 2 + n
    assert sum(b > a for a, b in zip([0] + values, values)) == 2 + n
    # the finished request's pages went to the prefix cache, which yields
    # them before any live request is preempted
    assert eng.stats["prefix_cache_evictions"] >= 1


def test_dense_counters_count_admissions_and_growth(model_dir):
    lm = LanguageModel.from_dir(model_dir, device="cpu", max_context=4096,
                                prefill_buckets=(512,))
    eng = BatchEngine(lm, batch_size=2, decode_chunk=4, stop_token_ids=[])
    assert eng._ctx_cap == 1024
    reqs = [eng.submit([(i * 3) % 256 for i in range(1100)], 5), eng.submit([4, 5], 9)]
    eng.run()
    assert all(r.finished for r in reqs)
    assert eng._ctx_cap == 2048 and eng.stats["ctx_grows"] == 1
    assert eng.stats["admissions"] == 2


def test_v1_stats_serves_the_engine_counters(tmp_path):
    """An operator reads admissions, preemptions and the recomputed tokens
    from GET /v1/stats, with no profiler running: two requests, queued
    together, that cannot share a 4-page pool, so one is preempted."""
    d = synth_chat_model(str(tmp_path / "chat"), seed=5, vocab_size=512, num_layers=2,
                         model_dim=64, hidden_dim=160, num_heads=4, num_groups=2, head_dim=16)
    lm = LanguageModel.from_dir(d, device="cpu", max_context=256, prefill_buckets=(16, 64))
    httpd = serve_batched(lm, Tokenizer(d), port=0, batch_size=2, decode_chunk=4, paged=True,
                          num_pages=5, page_size=16)
    server = httpd.batch_server
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        with server._lock:  # both queued before the scheduler's next step
            reqs = [server.engine.submit(list(range(s, s + 10)), 36) for s in (3, 40)]
        server._wake.set()
        deadline = time.monotonic() + 120
        while not all(r.finished for r in reqs) and time.monotonic() < deadline:
            time.sleep(0.02)
        assert all(r.finished for r in reqs)
        with urllib.request.urlopen(f"{base}/v1/stats") as r:
            stats = json.load(r)
        counters = stats["counters"]
        assert counters == server.engine.stats
        assert counters["preemptions"] == sum(r.preempted for r in reqs) >= 1
        assert counters["recomputed_tokens"] >= 10 * counters["preemptions"]
        assert counters["admissions"] == 2 + counters["preemptions"]
        assert "prefix_cache_evictions" in counters
        assert server.errors == []
    finally:
        server.shutdown()
        httpd.shutdown()
        httpd.server_close()
