"""The port's speculative continuous batching against the JAX package, on the CPU.

`uzu_tpu_torch.engine.batch_spec` (the dense `SpeculativeBatchEngine`
and the paged `SpeculativePagedBatchEngine`), the paged verify step
(`models/paged_decode.py::paged_verify_step`) and the batched verify and
deferred commit (`models/batch_decode.py`), on tiny f32 models written
by the port's synthesizer (the JAX package loads the same files):

- `paged_verify_step` logits and pools equal JAX's on a windowed model
  with sinks, a soft cap and a KV-sharing layer, bf16 and INT8 pools, with
  a `valid=False` slot whose only write is the trash page;
- the batched verify and its [B] commit equal JAX's `decoder_forward(
  defer_ssm=True)` and `decoder_commit_deferred` slot by slot, on a
  Llama, a GDN hybrid and a ring layout within `max_block`;
- greedy streams of both engines (host n-gram, `draft_layers`,
  `device_ngram` + `spec_rounds`) equal the port's single stream and
  JAX's engines (wherever the top-2 margin clears MARGIN_TOL), and their
  `SpeculationMetrics` equal JAX's;
- penalties and logprobs against the plain engines, the argument checks,
  the replay of a sampled stream after recompute preemption, and a verify
  row past a cut page table going to the trash page.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uzu_tpu import LanguageModel as JaxLM
from uzu_tpu.engine import batch_spec as jbs
from uzu_tpu.models import decoder as jdec
from uzu_tpu.models import paged_decode as jpd
from uzu_tpu.models.paged_kv import init_pools as jax_init_pools
from uzu_tpu_torch import LanguageModel
from uzu_tpu_torch.engine.batch import BatchEngine
from uzu_tpu_torch.engine.batch_spec import (
    SpeculativeBatchEngine,
    SpeculativePagedBatchEngine,
    _check_spec_rounds,
)
from uzu_tpu_torch.engine.paged_batch import PagedBatchEngine
from uzu_tpu_torch.engine.sampling import SamplingParams
from uzu_tpu_torch.models.batch_decode import batch_commit_deferred, batch_verify_step
from uzu_tpu_torch.models.decoder import decoder_forward
from uzu_tpu_torch.models.paged_decode import paged_verify_step, verify_columns
from uzu_tpu_torch.models.paged_kv import init_pools
from uzu_tpu_torch.tools import synth

torch.set_num_threads(1)

MARGIN_TOL = 1e-3  # streams are compared up to the first step with a smaller top-2 margin
LLAMA = dict(num_layers=2, model_dim=64, hidden_dim=160, num_heads=4, num_groups=2,
             head_dim=16, vocab_size=256, tied=False)
PROMPTS = [[1, 2, 3, 4, 1, 2, 3], [9, 8, 7, 6, 5], list(range(30, 60)), [42, 17]]
LM_KW = dict(max_context=128, prefill_buckets=(16,))


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("batch_spec")
    return {
        "llama": synth.synthesize(synth.llama_config(**LLAMA), str(root / "llama"), seed=7,
                                  dtype=np.float32),
        "qwen35": synth.synthesize(synth.qwen35_config(vocab_size=256), str(root / "qwen35"),
                                   seed=3, dtype=np.float32),
        # windows, sinks and a soft cap; the last layer shares layer 2's KV
        "windowed": synth.synthesize(synth.windowed_config(sliding_window=12),
                                     str(root / "windowed"), seed=5, dtype=np.float32),
        "windowed_own": synth.synthesize(synth.windowed_config(sliding_window=12,
                                                               kv_share_last=0),
                                         str(root / "windowed_own"), seed=5,
                                         dtype=np.float32),
    }


def _lm(d, **kw):
    return LanguageModel.from_dir(d, device="cpu", **{**LM_KW, **kw})


@pytest.fixture(scope="module")
def llama(dirs):
    return _lm(dirs["llama"])


@pytest.fixture(scope="module")
def jllama(dirs):
    return JaxLM.from_dir(dirs["llama"], **LM_KW)


@pytest.fixture(scope="module")
def plain(llama):
    return [llama.generate_list(np.asarray(p), 20, stop_token_ids=[]) for p in PROMPTS]


def _agree(lm, prompt, got, want):
    """got equals want up to the first step whose top-2 margin (the port's
    teacher-forced logits) is under MARGIN_TOL."""
    toks = torch.as_tensor(np.concatenate([prompt, want[:-1]]).astype(np.int64))
    logits, _ = decoder_forward(lm.decoder_config, lm.params, toks, lm.new_state(),
                                last_only=False)
    top = torch.topk(logits[len(prompt) - 1:], 2).values
    margins = (top[:, 0] - top[:, 1]).tolist()
    clear = next((i for i, m in enumerate(margins) if m < MARGIN_TOL), len(want))
    assert got[:clear] == want[:clear], (clear, got, want)


def _err_over_rms(got, want) -> float:
    want = np.asarray(want, np.float64)
    return float(np.abs(np.asarray(got, np.float64) - want).max() / np.sqrt((want ** 2).mean()))


# -- the paged verify step ---------------------------------------------------------------


def _pool_arrays(pools):
    return [None if p is None else [np.asarray(t.float() if isinstance(t, torch.Tensor)
                                               else jnp.asarray(t, jnp.float32)) for t in p]
            for p in pools]


@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
def test_paged_verify_step_matches_jax(dirs, quant):
    """Three slots of 5-row blocks over random pools (the windowed model:
    windows of 12, sinks, soft cap 30, layer 3 reading layer 2's pool);
    slot 2 is invalid. Logits of the live slots agree to 1e-4 of RMS; the
    written rows agree to one bf16 ulp (bf16 pools) or one code (INT8,
    the scales to 1e-5); every other page is untouched, the invalid slot's
    pages included (its rows went to the trash page only)."""
    d = dirs["windowed"]
    jlm = JaxLM.from_dir(d, kv_quant=quant, **LM_KW)
    lm = _lm(d, kv_quant=quant)
    page, num_pages, maxp, s = 8, 14, 16, 5
    trash = num_pages - 1
    rng = np.random.default_rng(2)
    jpools = jax_init_pools(jlm.decoder_config, num_pages, page, quantized=quant)
    tpools = init_pools(lm.decoder_config, num_pages, page, quantized=quant)
    for i, (jp, tp) in enumerate(zip(jpools, tpools)):
        if jp is None:
            continue
        filled_j, filled_t = [], []
        for t in tp:
            if t.dtype == torch.int8:
                a = rng.integers(-127, 128, t.shape).astype(np.int8)
                filled_t.append(torch.from_numpy(a))
                filled_j.append(jnp.asarray(a))
            else:
                a = (rng.random(t.shape) * 0.02 if t.dim() == 3
                     else rng.standard_normal(t.shape)).astype(np.float32)
                filled_t.append(torch.from_numpy(a).to(t.dtype))
                filled_j.append(jnp.asarray(a, jnp.float32).astype(jnp.asarray(jp[0]).dtype
                                                                    if t.dim() == 4 else
                                                                    jnp.float32))
        tpools[i] = tuple(filled_t)
        jpools[i] = tuple(filled_j)
    before = _pool_arrays(tpools)
    pages = [[0, 1, 2, 3], [4, 5], [6, 7, 8]]
    tables = np.full((3, maxp + 1), trash, np.int32)
    for b, pg in enumerate(pages):
        tables[b, :len(pg)] = pg
    pos0 = np.asarray([22, 9, 17], np.int32)
    valid = np.asarray([True, True, False])
    tokens = rng.integers(0, 256, (3, s)).astype(np.int32)
    want, jnew = jpd.paged_verify_step(
        jlm.decoder_config, jlm.params, jpools, jnp.asarray(tokens), jnp.asarray(tables),
        jnp.asarray(pos0), jnp.asarray(valid), 4)
    got = paged_verify_step(lm.decoder_config, lm.params, tpools, torch.from_numpy(tokens).long(),
                            torch.from_numpy(tables), torch.from_numpy(pos0),
                            torch.from_numpy(valid), 4)
    assert got.shape == (3, s, 256)
    assert _err_over_rms(got[:2].numpy(), np.asarray(want)[:2]) <= 1e-4
    after, jafter = _pool_arrays(tpools), _pool_arrays(jnew)
    written = set()
    for b in range(2):
        for r in range(s):
            p = pos0[b] + r
            written.add((pages[b][p // page], p % page))
    for old, new, jn in zip(before, after, jafter):
        if old is None:
            continue
        for name, (o, n, j) in enumerate(zip(old, new, jn)):
            live = np.ones(o.shape[1:3], bool)
            live[trash] = False
            for pg, off in written:
                live[pg, off] = False
            # every page but the trash page and the live slots' new rows
            # is untouched, in both packages
            assert np.array_equal(n[:, live], o[:, live])
            assert np.array_equal(j[:, live], o[:, live])
            rows = np.asarray(sorted(written))
            wn, wj = n[:, rows[:, 0], rows[:, 1]], j[:, rows[:, 0], rows[:, 1]]
            if o.ndim == 3:  # INT8 scales
                np.testing.assert_allclose(wn, wj, rtol=1e-5, atol=0)
            elif quant:  # INT8 codes
                assert np.abs(wn - wj).max() <= 1
            else:  # bf16 rows
                np.testing.assert_allclose(wn, wj, rtol=2 ** -7, atol=1e-6)


def test_verify_row_past_a_cut_table_goes_to_trash(dirs):
    """A live slot whose block crosses the cut table (ctx_pages = 2 of 4
    pages, rows at 13..17 with pages of 8): the rows past the cut go to
    the trash column, so the slot's last live page keeps its rows, where
    the JAX package clips such a row into that page (ROADMAP.md section 3)."""
    lm = _lm(dirs["llama"])
    page, num_pages, trash = 8, 10, 9
    pools = init_pools(lm.decoder_config, num_pages, page)
    for kp, vp in pools:
        kp.normal_()
        vp.normal_()
    tables = torch.full((1, 5), trash, dtype=torch.int32)
    tables[0, :4] = torch.tensor([3, 4, 5, 6])
    pos0 = torch.tensor([13], dtype=torch.int32)
    cols = verify_columns(pos0[:, None] + torch.arange(5, dtype=torch.int32), torch.tensor([True]),
                          3, page)
    assert cols.tolist() == [[1, 1, 1, 2, 2]]  # rows 16 and 17: the trash column of the cut
    snap = [(k[:, 4].clone(), v[:, 4].clone(), k[:, 5].clone()) for k, v in pools]
    paged_verify_step(lm.decoder_config, lm.params, pools, torch.tensor([[5, 6, 7, 8, 9]]),
                      tables, pos0, torch.tensor([True]), 2)
    for (k, v), (k4, v4, k5) in zip(pools, snap):
        # page 4 (the cut's last live column) changed only at offsets 5-7
        assert torch.equal(k[:, 4, :5], k4[:, :5]) and torch.equal(v[:, 4, :5], v4[:, :5])
        assert not torch.equal(k[:, 4, 5:], k4[:, 5:])
        assert torch.equal(k[:, 5], k5)  # past the cut: nothing written


def test_parked_slot_past_the_cut_table_cannot_corrupt_pages(dirs):
    """The engine-level form, as in tests/test_torch_paged.py: with
    max_context 2048 the verify tables are cut to the live context bucket
    plus the trash column; request A (1100-token prompt, 2 tokens)
    finishes while C runs. C's page 0 stays bit-identical and C's stream is
    the single stream's."""
    lm = _lm(dirs["llama"], max_context=2048, prefill_buckets=(16, 64, 256))
    prompt_c = [(i * 13 + 5) % 256 for i in range(12)]
    prompt_a = [(i * 31 + 7) % 256 for i in range(1100)]
    want_c = lm.generate_list(np.asarray(prompt_c), 40, stop_token_ids=[])
    eng = SpeculativePagedBatchEngine(lm, batch_size=2, draft_block=4, num_pages=200,
                                      page_size=8, stop_token_ids=[])
    rc = eng.submit(prompt_c, 40)
    ra = eng.submit(prompt_a, 2)
    eng.step()
    page0 = eng.pool.pages(0)[0]
    assert page0 == 0
    snaps = [(kp[:, 0].clone(), vp[:, 0].clone()) for kp, vp in eng.pools]
    cut_seen = False
    while not rc.finished:
        eng.step()
        if ra.finished and not rc.finished:
            cut_seen |= eng._ctx_pages(eng.slots[0].pos + 6) < 1101 // 8
    assert ra.finished and cut_seen
    for (kp, vp), (ks, vs) in zip(eng.pools, snaps):
        assert torch.equal(kp[:, 0], ks) and torch.equal(vp[:, 0], vs)
    assert rc.tokens == want_c


# -- the batched verify and commit ---------------------------------------------------------


def _stack(states):
    """Single-sequence states -> one batched state (leaves stacked on [B])."""
    return {"layers": [None if ls[0] is None else {k: torch.stack([s[k] for s in ls])
                                                   for k in ls[0]}
                       for ls in zip(*[s["layers"] for s in states])],
            "pos": torch.stack([s["pos"] for s in states]).to(torch.int32)}


@pytest.mark.parametrize("model,ring", [("llama", False), ("qwen35", False),
                                        ("windowed_own", True)])
def test_batch_verify_and_commit_match_jax(dirs, model, ring):
    """Three slots at different positions verify 8-row blocks in one
    batched step (a ring of window + 16 slots takes blocks within its
    `max_block` of 16); the logits of every slot equal JAX's single-slot
    `decoder_forward(defer_ssm=True)` to 1e-4 of RMS, and after the [B]
    commit (3, 8 and 0 rows: a halted slot) the positions are exact and the
    recurrent states agree to 1e-4 of RMS."""
    d = dirs[model]
    kw = dict(ring_windows=True) if ring else {}
    lm, jlm = _lm(d, **kw), JaxLM.from_dir(d, **LM_KW, **kw)
    # prompts below the recurrent mixers' chunked-prefill threshold (32 rows)
    prompts = [(np.arange(n) * 7 + 3) % 256 for n in (5, 29, 20)]
    blocks = np.random.default_rng(4).integers(0, 256, (3, 8)).astype(np.int64)
    commits = [3, 8, 0]
    states, jstates = [], []
    for p in prompts:
        states.append(lm.prefill(lm.new_state(), p)[1])
        jstates.append(jlm.prefill(jlm.new_state(), p.astype(np.int32))[1])
    ctx = lm._ctx_bucket(29 + 8)
    logits, pending = batch_verify_step(lm.decoder_config, lm.params, torch.from_numpy(blocks),
                                        _stack(states), ctx)
    new = batch_commit_deferred(lm.decoder_config, pending, torch.tensor(commits,
                                                                          dtype=torch.int32))
    assert new["pos"].tolist() == [len(p) + c for p, c in zip(prompts, commits)]
    for b in range(3):
        jl, jp = jdec.decoder_forward(jlm.decoder_config, jlm.params,
                                      jnp.asarray(blocks[b], jnp.int32), jstates[b],
                                      last_only=False, defer_ssm=True, ctx_limit=ctx)
        assert _err_over_rms(logits[b].numpy(), np.asarray(jl)) <= 1e-4
        jnew = jdec.decoder_commit_deferred(jlm.decoder_config, jp, commits[b])
        for got_l, want_l in zip(new["layers"], jnew["layers"]):
            if got_l is None or "ssm" not in got_l:
                continue
            for k in ("ssm", "conv"):
                assert _err_over_rms(got_l[k][b].float().numpy(),
                                     np.asarray(want_l[k], np.float32)) <= 1e-4


# -- the engines ---------------------------------------------------------------------------

VARIANTS = {
    "ngram": dict(),
    "self_draft": dict(draft_layers=1),
    "device_ngram": dict(device_ngram=True, spec_rounds=4),
}


def _run(engine_cls, lm, prompts, n, **kw):
    eng = engine_cls(lm, batch_size=3, draft_block=4, stop_token_ids=[], **kw)
    reqs = [eng.submit(p, n) for p in prompts]
    eng.run()
    return [r.tokens for r in reqs], eng


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_engine_greedy_streams_match_single_stream_and_jax(llama, jllama, plain, variant,
                                                           paged):
    """4 requests through 3 slots: every stream equals the port's single
    stream exactly, and the JAX engine's up to the first near-tie; where
    the two engines' streams are equal (on this model, in every variant),
    the speculation metrics are JAX's too."""
    kw = dict(VARIANTS[variant], **(dict(num_pages=40, page_size=8) if paged else {}))
    ours, eng = _run(SpeculativePagedBatchEngine if paged else SpeculativeBatchEngine, llama,
                     PROMPTS, 20, **kw)
    assert ours == plain
    jcls = jbs.SpeculativePagedBatchEngine if paged else jbs.SpeculativeBatchEngine
    theirs, jeng = _run(jcls, jllama, PROMPTS, 20, **kw)
    for p, t, o in zip(PROMPTS, theirs, ours):
        _agree(llama, np.asarray(p), t, o)
    if theirs == ours:
        m, jm = eng.metrics, jeng.metrics
        assert (m.num_tokens_proposed, m.num_tokens_accepted, m.num_verify_passes) == \
            (jm.num_tokens_proposed, jm.num_tokens_accepted, jm.num_verify_passes)


@pytest.mark.parametrize("variant", ["ngram", "self_draft"])
def test_hybrid_dense_engine_matches_single_stream_and_jax(dirs, variant):
    """The 4-layer GDN hybrid through the dense engine: the recurrent
    states commit each slot's own accepted length (deferred verify)."""
    lm, jlm = _lm(dirs["qwen35"]), JaxLM.from_dir(dirs["qwen35"], **LM_KW)
    prompts = PROMPTS[:3]
    want = [lm.generate_list(np.asarray(p), 12, stop_token_ids=[]) for p in prompts]
    ours, _ = _run(SpeculativeBatchEngine, lm, prompts, 12, **VARIANTS[variant])
    assert ours == want
    theirs, _ = _run(jbs.SpeculativeBatchEngine, jlm, prompts, 12, **VARIANTS[variant])
    for p, t, o in zip(prompts, theirs, ours):
        _agree(lm, np.asarray(p), t, o)


def test_ring_engine_cuts_blocks_to_max_block(dirs):
    """On a ring layout (window 12, ring_extra 8: blocks of at most 8
    rows) a draft block of 15 is cut to 7, and the streams equal the ring
    model's single stream."""
    lm = _lm(dirs["windowed_own"], ring_windows=True, prefill_buckets=(8,))
    eng = SpeculativeBatchEngine(lm, batch_size=2, draft_block=15, stop_token_ids=[])
    assert eng.draft_block == 7
    prompts = PROMPTS[:3]
    reqs = [eng.submit(p, 16) for p in prompts]
    eng.run()
    assert [r.tokens for r in reqs] == [lm.generate_list(np.asarray(p), 16, stop_token_ids=[])
                                        for p in prompts]


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_stop_tokens_budgets_and_context_edge(llama, paged):
    """A stop token inside a verify block, budgets that end inside a block,
    and a request at the context's edge finish as the single stream does."""
    base = llama.generate_list(np.asarray(PROMPTS[0]), 20, stop_token_ids=[])
    stop = base[6]
    kw = dict(num_pages=40, page_size=8) if paged else {}
    cls = SpeculativePagedBatchEngine if paged else SpeculativeBatchEngine
    eng = cls(llama, batch_size=3, draft_block=4, stop_token_ids=[stop], **kw)
    long_prompt = list((np.arange(118) * 3) % 256)
    reqs = [eng.submit(PROMPTS[0], 20), eng.submit(PROMPTS[1], 3), eng.submit(long_prompt, 20)]
    eng.run()
    want0 = llama.generate_list(np.asarray(PROMPTS[0]), 20, stop_token_ids=[stop])
    assert reqs[0].tokens == want0 and reqs[0].finish_reason == "stop"
    assert reqs[1].tokens == llama.generate_list(np.asarray(PROMPTS[1]), 3,
                                                 stop_token_ids=[stop])
    edge = reqs[2]
    assert edge.finish_reason in ("length", "stop") and 0 < len(edge.tokens) < 10
    assert edge.tokens == llama.generate_list(np.asarray(long_prompt), len(edge.tokens),
                                              stop_token_ids=[stop])


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_penalties_and_logprobs_match_the_plain_engines(llama, paged):
    """Presence/frequency penalties (chain-cumulative counts in the verify)
    and top-3 logprobs: greedy streams equal the plain engine's, and the
    logprobs agree to 1e-5."""
    kw = dict(num_pages=40, page_size=8) if paged else {}
    spec_cls, plain_cls = ((SpeculativePagedBatchEngine, PagedBatchEngine) if paged
                           else (SpeculativeBatchEngine, BatchEngine))
    out = []
    for eng in (spec_cls(llama, batch_size=3, draft_block=4, stop_token_ids=[], **kw),
                plain_cls(llama, batch_size=3, decode_chunk=4, stop_token_ids=[], **kw)):
        reqs = [eng.submit(PROMPTS[0], 16, presence_penalty=0.7, frequency_penalty=0.4,
                           logprobs=3),
                eng.submit(PROMPTS[2], 16, logprobs=2), eng.submit(PROMPTS[1], 16)]
        eng.run()
        out.append(reqs)
    spec, base = out
    for r, w in zip(spec, base):
        assert r.tokens == w.tokens
        assert len(r.logprob_content) == len(w.logprob_content) == (len(r.tokens)
                                                                    if r.logprobs else 0)
        for (lp, top), (wlp, wtop) in zip(r.logprob_content, w.logprob_content):
            assert abs(lp - wlp) <= 1e-5
            assert [i for i, _ in top] == [i for i, _ in wtop]
            np.testing.assert_allclose([x for _, x in top], [x for _, x in wtop], atol=1e-5)
    assert spec[0].tokens != llama.generate_list(np.asarray(PROMPTS[0]), 16,
                                                 stop_token_ids=[])


@pytest.mark.parametrize("rounds,layers,ngram,match", [
    (2, None, False, "requires draft_layers"),
    (1, None, True, "rides the fused rounds"),
    (4, 1, True, "exclusive"),
])
def test_check_spec_rounds_errors(llama, rounds, layers, ngram, match):
    with pytest.raises(ValueError, match=match):
        _check_spec_rounds(rounds, layers, ngram)
    for cls in (SpeculativeBatchEngine, SpeculativePagedBatchEngine):
        with pytest.raises(ValueError, match=match):
            cls(llama, spec_rounds=rounds, draft_layers=layers, device_ngram=ngram)
    _check_spec_rounds(4, 1, False)
    _check_spec_rounds(4, None, True)


def test_preempted_sampled_stream_replays_exactly(llama):
    """Sampling keys follow the produced-token count, so a request
    preempted for recompute (5 usable pages of 8 tokens for two requests
    of 30 tokens) emits the stream it emits unpreempted, and the same seed
    gives the same streams."""
    sp = SamplingParams(temperature=0.9, top_k=40)
    prompts = [[1, 2, 3], [9, 8, 7]]
    outs = []
    for pages in (6, 40, 40):
        eng = SpeculativePagedBatchEngine(llama, batch_size=2, draft_block=4, num_pages=pages,
                                          page_size=8, stop_token_ids=[], sampling=sp)
        reqs = [eng.submit(p, 30, seed=5 + i) for i, p in enumerate(prompts)]
        eng.run()
        outs.append(([r.tokens for r in reqs], [r.preempted for r in reqs]))
    (small, pre), (big, none), (again, _) = outs
    assert max(pre) >= 1 and none == [0, 0]
    assert small == big == again
    assert big != [llama.generate_list(np.asarray(p), 30, stop_token_ids=[]) for p in prompts]
