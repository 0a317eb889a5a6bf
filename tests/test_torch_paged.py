"""The port's paged continuous-batching path against the JAX package, on the CPU.

Kernels K5/K6 (`ops/cuda/paged_attention.py`, plain version), the page
pool, the per-row sampler, the paged decode step and prefill chunk, and
`PagedBatchEngine` as a whole on tiny f32 Llamas at `device="cpu"`. Inputs
come from seeded numpy generators; each tolerance is stated where it is
used. Greedy streams are held to the port's own single-stream
`generate_list` and, where said, to the JAX `PagedBatchEngine`.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uzu_tpu import LanguageModel as JaxLM
from uzu_tpu.engine import sampling as jsampling
from uzu_tpu.engine.paged_batch import PagedBatchEngine as JaxPagedEngine
from uzu_tpu.models import paged_decode as jpd
from uzu_tpu.models.paged_kv import init_pools as jax_init_pools
from uzu_tpu.ops.attention import attention_reference as jax_attention
from uzu_tpu.ops.pallas.paged_attention import paged_attention_reference, paged_decode_attention as jax_paged
from uzu_tpu.tools.synth import synthesize as jax_synth, windowed_config
from uzu_tpu_torch import LanguageModel, SamplingParams
from uzu_tpu_torch.engine import paged_batch
from uzu_tpu_torch.engine.paged_batch import PagedBatchEngine
from uzu_tpu_torch.engine.sampling import (
    DYNAMIC_OFF,
    apply_count_penalties,
    gumbel_noise,
    pack_dynamic,
    sample_dynamic,
)
from uzu_tpu_torch.models.decoder import decoder_forward
from uzu_tpu_torch.models.paged_decode import paged_decode_step, paged_prefill_chunk, paged_supported
from uzu_tpu_torch.models.paged_kv import PagePool, PagePoolOverflow, append_token, init_pools
from uzu_tpu_torch.ops.cuda import build
from uzu_tpu_torch.ops.cuda.paged_attention import paged_decode_attention
from uzu_tpu_torch.tools.synth import llama_config, synthesize

torch.set_num_threads(1)

# untied: random tied models collapse into repeating the input token
TINY = dict(num_layers=2, model_dim=128, hidden_dim=256, num_heads=8, num_groups=2,
            head_dim=16, vocab_size=256, tied=False)


# -- the page pool -------------------------------------------------------------------

def test_page_pool_alloc_share_release():
    pool = PagePool(num_pages=8, page_size=4)
    pages = pool.ensure(0, 10)  # 3 pages
    assert len(pages) == 3 and pool.free_pages == 5
    assert pool.ensure(0, 11) == pages
    pool.ensure(1, 4)
    assert pool.free_pages == 4
    pool.share_prefix(0, 2, 2)
    assert pool.table(2, 4)[:2].tolist() == pages[:2]
    pool.release(0)
    assert pool.free_pages == 5  # the third page freed; the first two still shared
    pool.release(2)
    assert pool.free_pages == 7
    pool.release(1)
    assert pool.free_pages == 8
    with pytest.raises(PagePoolOverflow):
        pool.ensure(9, 8 * 4 + 1)


def test_share_prefix_self_share_accounting():
    pool = PagePool(num_pages=8, page_size=4)
    pages = pool.ensure(0, 12)
    pool.share_prefix(0, 0, 2)
    assert pool.pages(0) == pages[:2]
    assert pool.free_pages == 6
    grabbed = pool.ensure(1, 24)  # every free page
    assert not set(grabbed) & set(pages[:2])


# -- K5/K6: paged decode attention ---------------------------------------------------

def test_paged_append_and_attend_matches_dense():
    """Tokens written one by one through page tables (`append_token`)
    attend as the dense [C, G, Dh] cache does (the JAX package's
    `attention_reference` on the same rows), at 1e-5."""
    rng = np.random.default_rng(6)
    g, dh, h, page, num_pages, maxp = 2, 32, 8, 8, 12, 4
    pool = PagePool(num_pages=num_pages, page_size=page)
    kv = (torch.zeros((g, num_pages, page, dh)), torch.zeros((g, num_pages, page, dh)))
    lengths = [19, 7]
    dense = []
    for slot, n in enumerate(lengths):
        ks = rng.standard_normal((n, g, dh)).astype(np.float32)
        vs = rng.standard_normal((n, g, dh)).astype(np.float32)
        dense.append((ks, vs))
        for pos in range(n):
            pages = pool.ensure(slot, pos + 1)
            kv = append_token(kv, torch.from_numpy(ks[pos]), torch.from_numpy(vs[pos]),
                              pages[pos // page], pos % page)
    q = rng.standard_normal((2, h, dh)).astype(np.float32)
    table = np.stack([pool.table(s, maxp) for s in range(2)])
    got = paged_decode_attention(torch.from_numpy(q), *kv, torch.from_numpy(table),
                                 torch.tensor(lengths), scale=dh ** -0.5)
    for slot, (ks, vs) in enumerate(dense):
        n = lengths[slot]
        k_dense = np.zeros((maxp * page, g, dh), np.float32)
        v_dense = np.zeros((maxp * page, g, dh), np.float32)
        k_dense[:n], v_dense[:n] = ks, vs
        want = jax_attention(jnp.asarray(q[slot:slot + 1]), jnp.asarray(k_dense),
                             jnp.asarray(v_dense), jnp.asarray([n - 1], jnp.int32),
                             scale=dh ** -0.5)
        np.testing.assert_allclose(got[slot].numpy(), np.asarray(want[0]), rtol=1e-5, atol=1e-5)


def _pool_case(seed, page, quant, b=3, h=8, g=2, dh=32, p=12, maxp=5):
    """Ragged lengths 1, a page boundary and the table's maximum; slot 2
    repeats slot 0's physical pages (a shared prefix)."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, dh)).astype(np.float32)
    if quant:
        pools = [rng.integers(-127, 128, (g, p, page, dh)).astype(np.int8),
                 rng.uniform(0.005, 0.03, (g, p, page)).astype(np.float32),
                 rng.integers(-127, 128, (g, p, page, dh)).astype(np.int8),
                 rng.uniform(0.005, 0.03, (g, p, page)).astype(np.float32)]
    else:  # bf16 pools: round once, hand both packages the same values
        kv = [torch.from_numpy(rng.standard_normal((g, p, page, dh)).astype(np.float32))
              .to(torch.bfloat16) for _ in range(2)]
        pools = [kv[0], None, kv[1], None]
    table = rng.integers(0, p, (b, maxp)).astype(np.int32)
    table[2] = table[0]
    lengths = np.asarray([1, 2 * page, maxp * page], np.int32)
    sinks = rng.standard_normal(h).astype(np.float32)
    return q, pools, table, lengths, sinks


VARIANTS = {
    "plain": {},
    "softcap": {"logit_soft_cap": 25.0},
    "window": {"sliding_window_size": 40},
    "sinks": {"sinks": True},
    "window_sinks": {"sliding_window_size": 40, "sinks": True},
}


def _both_args(case, variant):
    q, pools, table, lengths, sinks = case
    kw = dict(VARIANTS[variant], scale=q.shape[-1] ** -0.5)
    if kw.pop("sinks", False):
        kw["sinks"] = sinks
    kj, ksj, vj, vsj = (None if a is None else jnp.asarray(
        a.float().numpy() if isinstance(a, torch.Tensor) else a) for a in pools)
    if ksj is None:
        kj, vj = kj.astype(jnp.bfloat16), vj.astype(jnp.bfloat16)
    jargs = (jnp.asarray(q), kj, vj, jnp.asarray(table), jnp.asarray(lengths))
    jkw = dict(kw, k_scales=ksj, v_scales=vsj)
    if "sinks" in kw:
        jkw["sinks"] = jnp.asarray(sinks)
    kt, kst, vt, vst = (None if a is None else torch.as_tensor(a) for a in pools)
    targs = (torch.from_numpy(q), kt, vt, torch.from_numpy(table), torch.from_numpy(lengths))
    tkw = dict(kw, k_scales=kst, v_scales=vst)
    if "sinks" in kw:
        tkw["sinks"] = torch.from_numpy(sinks)
    return jargs, jkw, targs, tkw


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("page", [8, 32])
@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
def test_paged_plain_matches_jax_reference(variant, page, quant):
    """GQA with rep 4, f32 math on both sides: 1e-5."""
    jargs, jkw, targs, tkw = _both_args(_pool_case(page + quant, page, quant), variant)
    want = np.asarray(paged_attention_reference(*jargs, **jkw))
    got = paged_decode_attention(*targs, **tkw)
    assert got.dtype == torch.float32 and got.shape == (3, 8, 32)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("variant", ["plain", "softcap", "window_sinks"])
@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
def test_paged_plain_matches_pallas_interpret(variant, quant):
    """The JAX kernels round q and p to bf16 for their dots: their own
    tests' 2e-2."""
    jargs, jkw, targs, tkw = _both_args(_pool_case(7, 32, quant), variant)
    want = np.asarray(jax_paged(*jargs, interpret=True, **jkw))
    got = paged_decode_attention(*targs, **tkw)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("variant", ["sinks", "window_sinks"])
@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
def test_paged_plain_matches_jax_at_gptoss_heads(variant, quant):
    """gpt-oss's attention shape: 8 query heads per KV group (H 16 over G
    2), Dh 64, sinks, and its window of 128 over slots of up to 160
    tokens. The reference at 1e-5, the interpreted kernels at 2e-2."""
    jargs, jkw, targs, tkw = _both_args(_pool_case(31 + quant, 32, quant, h=16, dh=64),
                                        variant)
    if "sliding_window_size" in jkw:
        jkw["sliding_window_size"] = tkw["sliding_window_size"] = 128
    got = paged_decode_attention(*targs, **tkw)
    assert got.shape == (3, 16, 64)
    want = np.asarray(paged_attention_reference(*jargs, **jkw))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    interp = np.asarray(jax_paged(*jargs, interpret=True, **jkw))
    np.testing.assert_allclose(got.numpy(), interp, rtol=2e-2, atol=2e-2)


def test_paged_wrapper_launches_nothing_on_cpu_and_checks_shapes(monkeypatch):
    _, _, targs, tkw = _both_args(_pool_case(3, 8, True, dh=64), "plain")
    before = dict(build.LAUNCHES)
    paged_decode_attention(*targs, **tkw)
    assert build.LAUNCHES == before
    q, k, v, table, lengths = targs
    monkeypatch.setattr(torch.Tensor, "device", property(lambda t: torch.device("cuda")))
    with pytest.raises(ValueError, match="int8"):
        paged_decode_attention(q, k, v, table, lengths, scale=0.1)
    with pytest.raises(ValueError, match="scales must be"):
        paged_decode_attention(q, k, v, table, lengths, scale=0.1,
                               k_scales=tkw["k_scales"][:, :3], v_scales=tkw["v_scales"])
    with pytest.raises(ValueError, match="do not fit"):
        paged_decode_attention(q, k, v, table[:2], lengths, **tkw)


# -- per-row sampling ------------------------------------------------------------------

# (temperature, top_k, top_p, min_p)
COMBOS = [(0.0, 0, 1.0, 0.0), (0.8, 0, 1.0, 0.0), (1.0, 5, 1.0, 0.0), (0.7, 0, 0.9, 0.0),
          (1.2, 0, 1.0, 0.1), (0.9, 20, 0.8, 0.05), (0.5, 64, 0.3, 0.0)]


@pytest.mark.parametrize("combo", COMBOS)
def test_sample_dynamic_allows_the_tokens_jax_allows(combo, monkeypatch):
    """Probe noise: row j gets a huge bonus on token j only, so token j
    comes out iff the masks allow it. JAX's gumbel draw is replaced by the
    same probe (keyed by the key's second word)."""
    v = 64
    rng = np.random.default_rng(sum(int(c * 10) for c in combo))
    logits = (rng.standard_normal(v) * 3).astype(np.float32)
    logits[10] = logits[11]  # a tie
    t, k, p, mp = combo
    banned = (7,)
    monkeypatch.setattr(jax.random, "gumbel",
                        lambda key, shape, dtype=jnp.float32: jax.nn.one_hot(key[1], shape[0]) * 1e6)
    keys = jnp.stack([jnp.zeros(v, jnp.uint32), jnp.arange(v, dtype=jnp.uint32)], axis=1)
    jt = np.asarray(jax.vmap(lambda key: jsampling.sample_dynamic(
        jnp.asarray(logits), jnp.float32(t), jnp.int32(k), jnp.float32(p), jnp.float32(mp),
        key, banned_tokens=banned))(keys))
    rows = torch.from_numpy(logits)[None].expand(v, v)
    full = lambda x: torch.full((v,), x)  # noqa: E731
    tt = sample_dynamic(rows, full(t), full(k), full(p), full(mp), torch.eye(v) * 1e6,
                        banned_tokens=banned).numpy()
    allowed = {j for j in range(v) if tt[j] == j}
    assert allowed == {j for j in range(v) if jt[j] == j}
    assert 7 not in allowed and allowed
    if t == 0.0:
        masked = logits.copy()
        masked[7] = -1e30
        assert allowed == {int(np.argmax(masked))}


@pytest.mark.parametrize("params", [
    SamplingParams(), SamplingParams(temperature=0.7, top_k=40),
    SamplingParams(temperature=1.1, top_p=0.9, min_p=0.05)])
def test_pack_dynamic_rows_match_jax(params):
    """The per-row encoding is the JAX package's; default parameters pack
    to the all-off row."""
    want = jsampling.pack_dynamic(jsampling.SamplingParams(
        temperature=params.temperature, top_k=params.top_k, top_p=params.top_p,
        min_p=params.min_p))
    assert pack_dynamic(params) == want
    if params == SamplingParams():
        assert pack_dynamic(params) == DYNAMIC_OFF


def test_greedy_rows_take_the_argmax_without_noise():
    logits = torch.from_numpy(np.random.default_rng(0).standard_normal((4, 50)).astype(np.float32))
    zeros = torch.zeros(4)
    got = sample_dynamic(logits, zeros, zeros, torch.ones(4), zeros, None)
    assert torch.equal(got, logits.argmax(-1))


def test_gumbel_noise_is_a_function_of_each_rows_keys():
    key0, key1 = torch.tensor([1, 2, 1, 99]), torch.tensor([5, 5, 5, 0])
    noise = gumbel_noise(key0, key1, 50000)
    for i in range(4):
        assert torch.equal(noise[i], gumbel_noise(key0[i:i + 1], key1[i:i + 1], 50000)[0])
    assert torch.equal(noise[0], noise[2]) and not torch.equal(noise[0], noise[1])
    # a standard gumbel: mean 0.5772 (Euler's constant), sd pi / sqrt(6) = 1.2825
    assert abs(noise[3].mean().item() - 0.5772) < 0.03
    assert abs(noise[3].std().item() - 1.2825) < 0.03


def test_gumbel_uniforms_stay_inside_the_open_interval():
    """The hash's extremes map strictly inside (0, 1), so the noise is
    finite and a masked logit (-1e30) can never win the argmax; the largest
    hash once mapped to 1.0 (+inf noise) and sampled masked tokens on the
    card."""
    from uzu_tpu_torch.engine.sampling import unit_uniform

    u = unit_uniform(torch.tensor([0, 1, 0x1FF, 0xFFFFFE00, 0xFFFFFFFF], dtype=torch.int64))
    assert bool((u > 0).all()) and bool((u < 1).all())
    assert u[-1].item() == 1.0 - 2.0 ** -24 and u[0].item() == 2.0 ** -24
    g = -torch.log(-torch.log(u))
    assert bool(torch.isfinite(g).all())
    logits = torch.full((1, 5), -1e30)
    logits[0, 0] = 0.0
    got = sample_dynamic(logits, torch.ones(1), torch.zeros(1), torch.ones(1), torch.zeros(1),
                         g[None])  # the masked tokens draw the largest noise
    assert got.tolist() == [0]
    assert bool(torch.isfinite(gumbel_noise(torch.arange(8), torch.arange(8), 100000)).all())


def test_count_penalties_follow_their_definition():
    rng = np.random.default_rng(1)
    logits = rng.standard_normal((3, 20)).astype(np.float32)
    counts = rng.integers(0, 3, (3, 20)).astype(np.int32)
    pres = np.asarray([[0.0], [0.5], [1.0]], np.float32)
    freq = np.asarray([[0.0], [0.25], [2.0]], np.float32)
    got = apply_count_penalties(*(torch.from_numpy(a) for a in (logits, counts, pres, freq)))
    want = np.asarray(jsampling.apply_count_penalties(*(jnp.asarray(a) for a in (
        logits, counts, pres, freq))))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got.numpy(), logits - pres * (counts > 0) - freq * counts,
                               rtol=1e-6, atol=1e-6)


# -- the paged decode step and prefill chunk ---------------------------------------------

@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    return synthesize(llama_config(**TINY), str(tmp_path_factory.mktemp("paged")), seed=13,
                      dtype=np.float32)


def _lm(model_dir, **kw):
    kw = {"max_context": 128, "prefill_buckets": (16,), **kw}
    return LanguageModel.from_dir(model_dir, device="cpu", **kw)


def _rel_l2(got, want):
    want = np.asarray(want, np.float32)
    return float(np.linalg.norm(np.asarray(got, np.float32) - want) / np.linalg.norm(want))


@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
def test_paged_prefill_and_decode_logits_match_jax(model_dir, quant):
    """Two slots prefilled chunk by chunk into shared pools, then one
    decode step for both, through both packages on the same weights: the
    logits agree to 1e-4 relative L2 (f32 weights, bf16 or INT8 pools)."""
    jlm = JaxLM.from_dir(model_dir, max_context=128, prefill_buckets=(16,), kv_quant=quant)
    lm = _lm(model_dir, kv_quant=quant)
    page, num_pages, maxp = 8, 12, 16
    trash = num_pages - 1
    jpools = jax_init_pools(jlm.decoder_config, num_pages, page, quantized=quant)
    tpools = init_pools(lm.decoder_config, num_pages, page, quantized=quant)
    prompts = [(np.arange(19) * 7 + 3) % 256, (np.arange(7) * 5 + 1) % 256]
    pages = [[0, 1, 2], [3]]
    tables = np.full((2, maxp + 1), trash, np.int32)
    for b, pg in enumerate(pages):
        tables[b, :len(pg)] = pg
    for b, prompt in enumerate(prompts):
        for pos0 in range(0, len(prompt), 16):
            take = min(16, len(prompt) - pos0)
            chunk = np.zeros(16, np.int32)
            chunk[:take] = prompt[pos0:pos0 + take]
            want, jpools = jpd.paged_prefill_chunk(
                jlm.decoder_config, jlm.params, jpools, jnp.asarray(chunk),
                jnp.asarray(tables[b]), jnp.int32(pos0), jnp.int32(take), maxp)
            got = paged_prefill_chunk(lm.decoder_config, lm.params, tpools,
                                      torch.from_numpy(chunk).long(), torch.from_numpy(tables[b]),
                                      pos0, take, maxp)
            assert _rel_l2(got.numpy(), want) < 1e-4
    tokens = np.asarray([11, 22], np.int32)
    positions = np.asarray([19, 7], np.int32)
    want, _ = jpd.paged_decode_step(jlm.decoder_config, jlm.params, jpools, jnp.asarray(tokens),
                                    jnp.asarray(tables), jnp.asarray(positions))
    got = paged_decode_step(lm.decoder_config, lm.params, tpools, torch.from_numpy(tokens).long(),
                            torch.from_numpy(tables), torch.from_numpy(positions))
    assert got.shape == (2, 256)
    assert _rel_l2(got.numpy(), want) < 1e-4


def test_paged_supported_gates_unimplemented_features():
    cfg = llama_config(**TINY).decoder_config
    assert paged_supported(cfg)

    def variant(**kw):
        tc = cfg.transformer_config
        lcs = list(tc.layer_configs)
        lcs[1] = dataclasses.replace(
            lcs[1], mixer_config=dataclasses.replace(lcs[1].mixer_config, **kw))
        return dataclasses.replace(cfg, transformer_config=dataclasses.replace(
            tc, layer_configs=tuple(lcs)))

    assert not paged_supported(variant(normalize_values=True))
    assert not paged_supported(variant(is_causal=False))


# -- the engine ----------------------------------------------------------------------

PROMPTS = [[1, 2, 3], [9, 8, 7, 6, 5], [42, 17], [5, 5, 5, 5], list(range(30, 60))]


def test_paged_engine_matches_single_stream_and_jax(model_dir):
    """Ragged prompts (one of two chunks), slot reuse (5 requests, 3 slots)
    and a pool of 28 usable pages of 8 tokens, less than 3 x 128: the
    streams equal the port's single-stream greedy and the JAX paged
    engine's, and every page is free after the run."""
    lm = _lm(model_dir)
    wants = [lm.generate_list(np.asarray(p), 10, stop_token_ids=[]) for p in PROMPTS]
    eng = PagedBatchEngine(lm, batch_size=3, decode_chunk=4, num_pages=29, page_size=8,
                           stop_token_ids=[], apc_max_entries=0)
    reqs = [eng.submit(p, 10) for p in PROMPTS]
    eng.run()
    assert [r.tokens for r in reqs] == wants
    assert all(r.finished and r.finish_reason == "length" for r in reqs)
    assert eng.pool.free_pages == 28

    jlm = JaxLM.from_dir(model_dir, max_context=128, prefill_buckets=(16,))
    jeng = JaxPagedEngine(jlm, batch_size=3, decode_chunk=4, num_pages=29, page_size=8,
                          stop_token_ids=[], apc_max_entries=0)
    jreqs = [jeng.submit(p, 10) for p in PROMPTS]
    jeng.run()
    assert [r.tokens for r in jreqs] == wants


def test_paged_engine_stop_tokens(model_dir):
    lm = _lm(model_dir)
    base = lm.generate_list(np.asarray([1, 2, 3]), 12, stop_token_ids=[])
    stop = base[5]
    want = lm.generate_list(np.asarray([1, 2, 3]), 12, stop_token_ids=[stop])
    eng = PagedBatchEngine(lm, batch_size=2, decode_chunk=4, num_pages=33, page_size=8,
                           stop_token_ids=[stop])
    r = eng.submit([1, 2, 3], 12)
    eng.run()
    assert r.finish_reason == "stop" and r.tokens == want


SHARED = [(i * 7) % 256 for i in range(20)]  # 2 full pages of 8 + a tail


def test_paged_prefix_sharing(model_dir):
    """Two live requests with a common 20-token prefix point at the same 2
    physical pages, and both streams stay the single-stream ones."""
    lm = _lm(model_dir, prefill_buckets=(32,))
    p1, p2 = SHARED + [3, 4], SHARED + [200, 201, 202]
    w1 = lm.generate_list(np.asarray(p1), 8, stop_token_ids=[])
    w2 = lm.generate_list(np.asarray(p2), 8, stop_token_ids=[])
    eng = PagedBatchEngine(lm, batch_size=2, decode_chunk=4, num_pages=33, page_size=8,
                           stop_token_ids=[], apc_max_entries=0)
    r1, r2 = eng.submit(p1, 8), eng.submit(p2, 8)
    while eng._admit():
        pass
    t1, t2 = eng.pool.table(0, eng.max_pages), eng.pool.table(1, eng.max_pages)
    assert t1[:2].tolist() == t2[:2].tolist() and t1[2] != t2[2]
    eng.run()
    assert r1.tokens == w1 and r2.tokens == w2
    assert eng.pool.free_pages == 32


def test_paged_prefill_skips_shared_prefix(model_dir, monkeypatch):
    """The second admission's first prefill chunk starts at token 16, past
    the 2 shared pages, and its stream is still the single-stream one."""
    lm = _lm(model_dir, prefill_buckets=(32,))
    p1, p2 = SHARED + [3, 4], SHARED + [200, 201, 202]
    w2 = lm.generate_list(np.asarray(p2), 8, stop_token_ids=[])
    eng = PagedBatchEngine(lm, batch_size=2, decode_chunk=4, num_pages=33, page_size=8,
                           stop_token_ids=[], apc_max_entries=0)
    eng.submit(p1, 8)
    eng.step()
    calls = []
    orig = paged_batch.paged_prefill_chunk

    def spy(cfg, params, pools, tokens, table, pos0, take, ctx_pages):
        calls.append((pos0, take))
        return orig(cfg, params, pools, tokens, table, pos0, take, ctx_pages)

    monkeypatch.setattr(paged_batch, "paged_prefill_chunk", spy)
    r2 = eng.submit(p2, 8)
    eng.run()
    assert r2.tokens == w2
    assert calls and calls[0] == (16, 7), calls


def test_automatic_prefix_cache_serves_a_follow_up(model_dir, monkeypatch):
    """A finished request's full pages stay in the prefix cache; a
    follow-up that extends its history shares them and prefills only past
    them, with the single-stream stream."""
    lm = _lm(model_dir, prefill_buckets=(32,))
    first = SHARED + [3, 4]
    eng = PagedBatchEngine(lm, batch_size=2, decode_chunk=4, num_pages=33, page_size=8,
                           stop_token_ids=[])
    r1 = eng.submit(first, 8)
    eng.run()
    follow = first + r1.tokens + [9, 9]
    want = lm.generate_list(np.asarray(follow), 6, stop_token_ids=[])
    calls = []
    orig = paged_batch.paged_prefill_chunk
    monkeypatch.setattr(paged_batch, "paged_prefill_chunk", lambda *a: (
        calls.append(a[5]), orig(*a))[1])
    r2 = eng.submit(follow, 6)
    eng.run()
    assert r2.tokens == want
    assert calls[0] == 24  # 3 of the first request's pages were reused
    eng._evict_retired(eng.pool.num_pages)
    assert eng.pool.free_pages == 32


def test_finished_slot_cannot_corrupt_live_pages(model_dir):
    """A free slot keeps writing stale K/V each decode step: its table row
    is all trash, so the first page the allocator hands out (page 0, held
    by a live slot) keeps its prompt rows."""
    lm = _lm(model_dir)
    eng = PagedBatchEngine(lm, batch_size=2, decode_chunk=4, num_pages=33, page_size=8,
                           stop_token_ids=[])
    assert (eng._tables_host() == eng._trash_page).all()
    ra = eng.submit(list(range(1, 13)), 24)
    rb = eng.submit([7, 7], 2)
    for _ in range(6):
        eng.step()
        if rb.finished:
            break
    assert rb.finished
    page0 = eng.pool.pages(0)[0]
    assert page0 == 0
    snaps = [kp[:, page0].clone() for kp, _ in eng.pools]
    assert (eng._tables_host()[1] == eng._trash_page).all()
    while not ra.finished:
        eng.step()
    for (kp, _), snap in zip(eng.pools, snaps):
        assert torch.equal(kp[:, page0], snap)


def test_parked_slot_past_the_cut_table_cannot_corrupt_page0(model_dir):
    """Regression for the reference engine's fault: with max_context >
    1024 the decode tables are cut to the live context bucket plus one
    trash column; request A (1100-token prompt, 2 new tokens) finishes and
    its free slot stays parked at position ~1101, past the cut table. Its
    writes must go to the trash page, not to physical page 0, which holds
    request C's prompt. C's page 0 stays bit-identical and C's stream is
    the port's single-stream one."""
    lm = _lm(model_dir, max_context=2048, prefill_buckets=(16, 64, 256))
    prompt_c = [(i * 13 + 5) % 256 for i in range(12)]
    prompt_a = [(i * 31 + 7) % 256 for i in range(1100)]
    want_c = lm.generate_list(np.asarray(prompt_c), 40, stop_token_ids=[])
    eng = PagedBatchEngine(lm, batch_size=2, decode_chunk=8, num_pages=200, page_size=8,
                           stop_token_ids=[])
    rc = eng.submit(prompt_c, 40)
    ra = eng.submit(prompt_a, 2)
    eng.step()  # admits C, then A (5 chunks), and dispatches a decode chunk
    page0 = eng.pool.pages(0)[0]
    assert page0 == 0
    snaps = [(kp[:, 0].clone(), vp[:, 0].clone()) for kp, vp in eng.pools]
    cut_seen = False
    while not rc.finished:
        eng.step()
        if ra.finished and not rc.finished:
            cut_seen |= eng._ctx_pages(eng.slots[0].pos + 2 * 8 + 1) < 1101 // 8
    assert ra.finished and cut_seen
    for (kp, vp), (ks, vs) in zip(eng.pools, snaps):
        assert torch.equal(kp[:, 0], ks) and torch.equal(vp[:, 0], vs)
    assert rc.tokens == want_c


def test_pool_overflow_backpressure_and_exact_preemption(model_dir):
    """4 usable pages of 8 tokens: the two requests cannot coexist, so the
    younger is preempted and recomputed with the same stream; a prompt that
    can never fit fails at once; growth past the pool finishes as
    "length" with the single-stream prefix."""
    lm = _lm(model_dir)
    w1 = lm.generate_list(np.asarray([1, 2, 3]), 20, stop_token_ids=[])
    w2 = lm.generate_list(np.asarray([9, 8, 7]), 20, stop_token_ids=[])
    eng = PagedBatchEngine(lm, batch_size=2, decode_chunk=4, num_pages=5, page_size=8,
                           stop_token_ids=[])
    ra, rb = eng.submit([1, 2, 3], 20), eng.submit([9, 8, 7], 20)
    eng.run()
    assert ra.tokens == w1 and rb.tokens == w2
    assert rb.preempted >= 1
    rc = eng.submit(list(range(1, 40)), 4)
    eng.run()
    assert rc.finished and rc.finish_reason == "length" and rc.tokens == []
    rd = eng.submit([5, 4, 3], 60)
    eng.run()
    assert rd.finish_reason == "length" and 0 < len(rd.tokens) < 60
    assert rd.tokens == lm.generate_list(np.asarray([5, 4, 3]), len(rd.tokens),
                                         stop_token_ids=[])


def test_int8_pools_match_dense_int8(model_dir):
    """INT8 pools (codes + per-(token, kv-head) scales) give the dense
    INT8-KV single stream's tokens; the 40-token prompt's 16-row chunks
    take K4's plain version, decode takes K6's."""
    lm = _lm(model_dir, kv_quant=True)
    prompts = [[1, 2, 3], [(i * 7) % 256 for i in range(40)]]
    wants = [lm.generate_list(np.asarray(p), 12, stop_token_ids=[]) for p in prompts]
    eng = PagedBatchEngine(lm, batch_size=2, decode_chunk=4, num_pages=33, page_size=8,
                           stop_token_ids=[])
    assert len(eng.pools[0]) == 4 and eng.pools[0][0].dtype == torch.int8
    reqs = [eng.submit(p, 12) for p in prompts]
    eng.run()
    assert [r.tokens for r in reqs] == wants


def test_windowed_sinks_kv_sharing_match_single(tmp_path):
    """Alternating sliding-window layers, attention sinks, a tanh soft cap
    and a trailing KV-sharing layer (the JAX synthesizer's windowed config,
    which the port's loader builds): paged streams equal single-stream."""
    d = jax_synth(windowed_config(num_layers=4, sliding_window=24, has_sinks=True,
                                  kv_share_last=1), str(tmp_path / "win"), seed=13,
                  dtype=np.float32)
    lm = _lm(d)
    prompts = [[1, 2, 3], list(range(2, 40)), [9, 8, 7, 6, 5]]
    wants = [lm.generate_list(np.asarray(p), 10, stop_token_ids=[]) for p in prompts]
    eng = PagedBatchEngine(lm, batch_size=2, decode_chunk=4, num_pages=33, page_size=8,
                           stop_token_ids=[])
    assert eng.pools[-1] is None  # the KV-sharing layer owns no pool
    reqs = [eng.submit(p, 10) for p in prompts]
    eng.run()
    assert [r.tokens for r in reqs] == wants


def test_context_bucket_crossing(model_dir):
    """Decode crosses the 1024 context bucket: the tables' width changes
    mid-request and the stream stays the single-stream one."""
    lm = _lm(model_dir, max_context=2048, prefill_buckets=(64,))
    prompt = np.random.default_rng(5).integers(0, 256, 1000)
    want = lm.generate_list(prompt, 48, stop_token_ids=[])
    eng = PagedBatchEngine(lm, batch_size=2, decode_chunk=8, num_pages=40, page_size=64,
                           stop_token_ids=[], apc_max_entries=0)
    req = eng.submit(prompt, 48)
    eng.run()
    assert req.tokens == want


SAMPLED = SamplingParams(temperature=0.9, top_k=50)


def _sampled_run(lm, others, num_pages=33, seeds=(41,)):
    eng = PagedBatchEngine(lm, batch_size=3, decode_chunk=4, num_pages=num_pages, page_size=8,
                           sampling=SAMPLED, stop_token_ids=[])
    reqs = [eng.submit([5, 6, 7, 8], 24, seed=s) for s in seeds]
    reqs += [eng.submit(p, 24, seed=7 + i) for i, p in enumerate(others)]
    eng.run()
    return reqs


def test_sampled_stream_is_the_same_alone_and_in_a_full_batch(model_dir):
    lm = _lm(model_dir)
    alone = _sampled_run(lm, [])[0].tokens
    crowded = _sampled_run(lm, [[1, 2, 3], [9, 9, 9, 9, 9], [4, 4]])[0].tokens
    assert len(alone) == 24 and crowded == alone
    other_seed = _sampled_run(lm, [], seeds=(42,))[0].tokens
    greedy = lm.generate_list(np.asarray([5, 6, 7, 8]), 24, stop_token_ids=[])
    assert other_seed != alone and alone != greedy


def test_sampled_preemption_is_lossless(model_dir):
    """Recompute preemption under sampling: the noise depends on the seed
    and the step index since admission, so a replay gives the same tokens."""
    lm = _lm(model_dir)
    others = [[1, 2, 3], [9, 8, 7]]
    roomy = _sampled_run(lm, others, num_pages=41)
    tight = _sampled_run(lm, others, num_pages=9)
    assert any(r.preempted for r in tight)
    assert [r.tokens for r in tight] == [r.tokens for r in roomy]


def _teacher_forced(lm, prompt, tokens):
    seq = torch.as_tensor(list(prompt) + list(tokens))
    logits, _ = decoder_forward(lm.decoder_config, lm.params, seq, lm.new_state(),
                                last_only=False)
    return logits[len(prompt) - 1: len(prompt) - 1 + len(tokens)]


def test_logprobs_are_the_raw_logits_log_softmax(model_dir):
    lm = _lm(model_dir)
    eng = PagedBatchEngine(lm, batch_size=2, decode_chunk=4, num_pages=33, page_size=8,
                           stop_token_ids=[])
    r = eng.submit([3, 1, 4, 1, 5], 10, logprobs=3)
    plain = eng.submit([2, 7, 1, 8], 10)
    eng.run()
    assert plain.logprob_content == [] and len(r.logprob_content) == 10
    lp = torch.log_softmax(_teacher_forced(lm, [3, 1, 4, 1, 5], r.tokens), dim=-1)
    top_v, top_i = torch.topk(lp, 3, dim=-1)
    for s, (tok_lp, alts) in enumerate(r.logprob_content):
        assert [i for i, _ in alts] == top_i[s].tolist()
        assert alts[0][0] == r.tokens[s]  # greedy: the token is the top one
        np.testing.assert_allclose(tok_lp, lp[s, r.tokens[s]].item(), rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose([v for _, v in alts], top_v[s].numpy(), rtol=1e-4, atol=1e-4)


def test_count_penalties_steer_greedy_as_defined(model_dir):
    """Each emitted token is the argmax of the raw logits minus presence *
    (count > 0) + frequency * count over the tokens generated before it."""
    lm = _lm(model_dir)
    eng = PagedBatchEngine(lm, batch_size=2, decode_chunk=4, num_pages=33, page_size=8,
                           stop_token_ids=[])
    prompt = [5, 6, 7, 8]
    r = eng.submit(prompt, 16, presence_penalty=0.5, frequency_penalty=1.5)
    free = eng.submit(prompt, 16)
    eng.run()
    assert free.tokens == lm.generate_list(np.asarray(prompt), 16, stop_token_ids=[])
    logits = _teacher_forced(lm, prompt, r.tokens)
    counts = torch.zeros(256)
    for s, tok in enumerate(r.tokens):
        pen = logits[s] - 0.5 * (counts > 0) - 1.5 * counts
        assert int(pen.argmax()) == tok
        counts[tok] += 1
    assert r.tokens != free.tokens


def test_per_request_sampling_beside_greedy_and_submit_checks(model_dir):
    lm = _lm(model_dir)
    eng = PagedBatchEngine(lm, batch_size=2, decode_chunk=4, num_pages=33, page_size=8,
                           stop_token_ids=[])
    g = eng.submit([1, 2, 3], 12)
    s = eng.submit([1, 2, 3], 12, seed=3, sampling=SamplingParams(temperature=1.5, top_p=0.9))
    eng.run()
    assert g.tokens == lm.generate_list(np.asarray([1, 2, 3]), 12, stop_token_ids=[])
    assert len(s.tokens) == 12 and s.tokens != g.tokens
    with pytest.raises(ValueError):
        eng.submit([1], 4, sampling=SamplingParams(repetition_penalty=1.2))
    with pytest.raises(ValueError):
        eng.submit([1], 4, logprobs=21)
    with pytest.raises(ValueError):
        eng.submit([1], 4, grammar=object())


def test_cancel_queued_and_running_requests(model_dir):
    lm = _lm(model_dir)
    eng = PagedBatchEngine(lm, batch_size=1, decode_chunk=4, num_pages=33, page_size=8,
                           stop_token_ids=[])
    running, queued = eng.submit([1, 2, 3], 50), eng.submit([4, 5], 5)
    eng.step()
    assert eng.cancel(queued) and queued.finish_reason == "cancelled"
    assert eng.cancel(running) and not eng.cancel(running)
    eng.run()
    assert queued.tokens == [] and len(running.tokens) < 50
    eng._evict_retired(eng.pool.num_pages)
    assert eng.pool.free_pages == 32
