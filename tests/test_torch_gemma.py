"""The port's Gemma slice against the JAX package, on the CPU.

The sliding-window ring KV layout (`models/kv_cache.py`), per-layer
embeddings (`models/ple.py`) and the synthesizer configs that use them
(`gemma_config`, `windowed_config`, with `qwen3_config` beside them). The
same numpy-seeded inputs go through the JAX functions and the port's, at
f32: ring `append`/`read`, `ple_inputs`/`ple_project`, byte-identical
synthesis, teacher-forced logits and greedy streams of tiny models in both
layouts, chunked against token-at-a-time prefill, the dense `BatchEngine`
over rings and PLE, and `capture_trace` on a PLE model.
"""

import filecmp
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from uzu_tpu import LanguageModel as JaxLM
from uzu_tpu.models import kv_cache as jkv
from uzu_tpu.models import ple as jple
from uzu_tpu.models.decoder import decoder_forward as jax_forward
from uzu_tpu.tools import quality as jquality
from uzu_tpu.tools import synth as jsynth
from uzu_tpu_torch import LanguageModel
from uzu_tpu_torch.convert import from_numpy_tree
from uzu_tpu_torch.engine.batch import BatchEngine
from uzu_tpu_torch.engine.paged_batch import PagedBatchEngine
from uzu_tpu_torch.models import kv_cache as pkv
from uzu_tpu_torch.models import ple as pple
from uzu_tpu_torch.models.batch_decode import _write_block
from uzu_tpu_torch.models.decoder import decoder_forward
from uzu_tpu_torch.tools import quality as pquality
from uzu_tpu_torch.tools import synth as psynth

torch.set_num_threads(1)

# both configs with their KV source on a global layer (kv_share_last=2
# puts it on layer 1 of 4): ring and full layouts agree at every length
CONFIGS = {"gemma": ("gemma_config", {"kv_share_last": 2}),
           "windowed": ("windowed_config", {"kv_share_last": 2})}
LM_KW = dict(max_context=256, prefill_buckets=(16, 64))


def _cfgs(name, **over):
    fn, kw = CONFIGS[name]
    kw = {**kw, **over}
    return getattr(jsynth, fn)(**kw), getattr(psynth, fn)(**kw)


@pytest.fixture(scope="module")
def model_dirs(tmp_path_factory):
    """{name: dir} of tiny f32 models written by the JAX synthesizer: the
    two configs above, and gemma_config's defaults (a global layer
    sharing a windowed layer's KV)."""
    root = tmp_path_factory.mktemp("torch_gemma")
    out = {name: jsynth.synthesize(_cfgs(name)[0], str(root / name), seed=21,
                                   dtype=np.float32) for name in CONFIGS}
    out["gemma_default"] = jsynth.synthesize(jsynth.gemma_config(), str(root / "gd"),
                                             seed=21, dtype=np.float32)
    return out


def _vocab(lm):
    return lm.decoder_config.vocab_size


def _prompt(n, vocab, mul=19, off=3):
    return (np.arange(n) * mul + off) % vocab


def _logits_both(model_dir, toks, ring, **kw):
    jlm = JaxLM.from_dir(model_dir, ring_windows=ring, **{**LM_KW, **kw})
    lm = LanguageModel.from_dir(model_dir, device="cpu", ring_windows=ring, **{**LM_KW, **kw})
    want, _ = jax_forward(jlm.decoder_config, jlm.params, jnp.asarray(toks, jnp.int32),
                          jlm.new_state(), last_only=False)
    got, _ = decoder_forward(lm.decoder_config, lm.params, torch.as_tensor(toks),
                             lm.new_state(), last_only=False)
    return got.numpy(), np.asarray(want), jlm, lm


# -- the ring layout -----------------------------------------------------------------

def _caches(window, extra, quantized, g=2, dh=8):
    j = jkv.make_cache(g, dh, 64, jnp.float32, quantized=quantized, window=window,
                       ring_extra=extra)
    p = pkv.make_cache(g, dh, 64, torch.float32, quantized=quantized, window=window,
                       ring_extra=extra)
    return j, p


def test_ring_cache_layout():
    """c = min(window + ring_extra, max_context) slots, positions NEG_POS;
    no ring where the window covers the context."""
    j, p = _caches(12, 4, False)
    assert p["k"].shape == j["k"].shape == (16, 2, 8)
    assert pkv.is_ring(p) and p["pos"].dtype == torch.int32
    assert (p["pos"] == pkv.NEG_POS).all() and pkv.NEG_POS == jkv.NEG_POS
    j, p = _caches(12, 4, True)
    assert set(p) == set(j) == {"k_q", "k_s", "v_q", "v_s", "pos"}
    assert not pkv.is_ring(pkv.make_cache(2, 8, 64, window=64))
    assert pkv.make_cache(2, 8, 64, window=60, ring_extra=16)["k"].shape[0] == 64


@settings(max_examples=40, deadline=None)
@given(window=st.sampled_from([4, 8, 12]), extra=st.sampled_from([0, 4]),
       quantized=st.booleans(),
       chunks=st.lists(st.tuples(st.integers(1, 20), st.integers(0, 20)), min_size=1,
                       max_size=6),
       seed=st.integers(0, 2 ** 16))
def test_ring_append_and_read_match_jax(window, extra, quantized, chunks, seed):
    """Chunks of S rows, `true_length` of them real (padded rows dropped),
    at consecutive positions; S past the ring's size too (the gathered
    branch). Positions and true_length as device tensors, as the decoder
    passes them. Codes, scales, values and positions equal JAX's."""
    rng = np.random.default_rng(seed)
    j, p = _caches(window, extra, quantized)
    pos = 0
    for s, tl in chunks:
        tl = min(tl, s)
        k = rng.standard_normal((s, 2, 8)).astype(np.float32)
        v = rng.standard_normal((s, 2, 8)).astype(np.float32)
        positions = np.arange(pos, pos + s, dtype=np.int32)
        j = jkv.append(j, jnp.asarray(k), jnp.asarray(v), jnp.asarray(positions),
                       jnp.asarray(tl, jnp.int32))
        pkv.append(p, torch.from_numpy(k), torch.from_numpy(v), torch.from_numpy(positions),
                   torch.tensor(tl, dtype=torch.int32))
        pos += tl
    for name in j:
        np.testing.assert_array_equal(p[name].numpy(), np.asarray(j[name]), err_msg=name)
    jk, jv, jpos = jkv.read(j)
    pk, pv, ppos = pkv.read(p)
    np.testing.assert_allclose(pk.numpy(), np.asarray(jk), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(pv.numpy(), np.asarray(jv), rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(ppos.numpy(), np.asarray(jpos))


@pytest.mark.parametrize("quantized", [False, True])
def test_batched_ring_write_equals_single_append(quantized):
    """The dense engine's row write into a [B, c] ring: each slot's row
    at its position % c with its position recorded, as a one-row append
    to that slot's own ring."""
    rng = np.random.default_rng(3)
    b, c = 3, 12
    single = [pkv.make_cache(2, 8, 64, torch.float32, quantized=quantized, window=8,
                             ring_extra=4) for _ in range(b)]
    batched = {k: torch.stack([s[k] for s in single]) for k in single[0]}
    for step in range(30):
        positions = torch.tensor([step, 2 * step + 1, step + 7], dtype=torch.int32)
        k = torch.from_numpy(rng.standard_normal((b, 2, 8)).astype(np.float32))
        v = torch.from_numpy(rng.standard_normal((b, 2, 8)).astype(np.float32))
        _write_block(batched, k[:, None], v[:, None], positions[:, None])
        for i in range(b):
            pkv.append(single[i], k[i:i + 1], v[i:i + 1], positions[i:i + 1])
    assert batched["pos"].shape == (b, c)
    for name in batched:
        for i in range(b):
            torch.testing.assert_close(batched[name][i], single[i][name], rtol=0, atol=0)


# -- per-layer embeddings ------------------------------------------------------------

def _ple_params(rng, cfg_model, d, vocab_rows):
    pm = cfg_model
    total = pm.num_layers * pm.ple_dim
    return {
        "token_embedding": rng.standard_normal((vocab_rows, total)).astype(np.float32),
        "model_projection": {"w": (rng.standard_normal((total, d)) * 0.2).astype(np.float32)},
        "projection_norm": {"scales": (1 + 0.1 * rng.standard_normal(pm.ple_dim))
                            .astype(np.float32)},
    }


def _to_jax(tree):
    return {k: _to_jax(v) if isinstance(v, dict) else jnp.asarray(v) for k, v in tree.items()}


def _to_torch(tree):
    return {k: _to_torch(v) if isinstance(v, dict) else torch.from_numpy(v)
            for k, v in tree.items()}


def test_ple_inputs_match_jax():
    """Ids at and past ple_vocab read zero rows; the folded-epsilon norm."""
    jcfg, pcfg = _cfgs("gemma")
    jm, pm = jcfg.decoder_config.ple_model_config, pcfg.decoder_config.ple_model_config
    d = pcfg.decoder_config.transformer_config.model_dim
    rng = np.random.default_rng(7)
    params = _ple_params(rng, pm, d, pm.ple_vocab_size)
    tokens = np.array([0, 5, 255, 256, 300, 511, 17, 256], np.int64)
    x = rng.standard_normal((len(tokens), d)).astype(np.float32)
    want = jple.ple_inputs(jm, _to_jax(params), jnp.asarray(tokens, jnp.int32), jnp.asarray(x))
    got = pple.ple_inputs(pm, _to_torch(params), torch.from_numpy(tokens), torch.from_numpy(x))
    assert got.shape == (len(tokens), pm.num_layers, pm.ple_dim)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    # the table's part is zero past ple_vocab: those rows are the projection alone
    params["token_embedding"][:] = 0.0
    zeroed = pple.ple_inputs(pm, _to_torch(params), torch.from_numpy(tokens),
                             torch.from_numpy(x))
    past = tokens >= pm.ple_vocab_size
    np.testing.assert_allclose(got.numpy()[past], zeroed.numpy()[past], rtol=0, atol=0)


@pytest.mark.parametrize("pls", [1.0, 0.37])
def test_ple_project_matches_jax(pls):
    jcfg, pcfg = _cfgs("gemma")
    jl = jcfg.decoder_config.transformer_config.layer_configs[0].ple_config
    pl = pcfg.decoder_config.transformer_config.layer_configs[0].ple_config
    d = pcfg.decoder_config.transformer_config.model_dim
    rng = np.random.default_rng(8)
    params = {"gate": {"w": (rng.standard_normal((pl.ple_dim, d)) * 0.2).astype(np.float32)},
              "projection": {"w": (rng.standard_normal((d, pl.ple_dim)) * 0.2)
                             .astype(np.float32)},
              "norm": {"scales": (1 + 0.1 * rng.standard_normal(d)).astype(np.float32)}}
    x = rng.standard_normal((6, d)).astype(np.float32)
    pli = rng.standard_normal((6, pl.ple_dim)).astype(np.float32)
    want = jple.ple_project(jl, _to_jax(params), jnp.asarray(x), jnp.asarray(pli), pls)
    got = pple.ple_project(pl, _to_torch(params), torch.from_numpy(x), torch.from_numpy(pli),
                           pls)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


# -- the synthesizer configs ---------------------------------------------------------

@pytest.mark.parametrize("fn", ["qwen3_config", "windowed_config", "gemma_config"])
@pytest.mark.parametrize("dtype", [np.float32, "bf16"])
def test_synthesis_is_byte_identical(tmp_path, fn, dtype):
    kw = {} if dtype == "bf16" else {"dtype": dtype}
    a = jsynth.synthesize(getattr(jsynth, fn)(), str(tmp_path / "j"), seed=5, **kw)
    b = psynth.synthesize(getattr(psynth, fn)(), str(tmp_path / "p"), seed=5, **kw)
    for f in ("config.json", "model.safetensors"):
        assert filecmp.cmp(os.path.join(a, f), os.path.join(b, f), shallow=False), f


# -- logits and streams against the JAX package --------------------------------------

@pytest.mark.parametrize("name", sorted(CONFIGS))
@pytest.mark.parametrize("ring", [False, True])
def test_teacher_forced_logits_match_jax(model_dirs, name, ring):
    """100 tokens: past each window + the largest bucket, so the rings
    wrap; gemma's prompt holds ids past its PLE vocabulary."""
    toks = _prompt(100, 512 if name == "gemma" else 256)
    got, want, _, _ = _logits_both(model_dirs[name], toks, ring)
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("name", sorted(CONFIGS))
@pytest.mark.parametrize("ring", [False, True])
def test_greedy_stream_matches_jax(model_dirs, name, ring):
    lm = LanguageModel.from_dir(model_dirs[name], device="cpu", ring_windows=ring, **LM_KW)
    jlm = JaxLM.from_dir(model_dirs[name], ring_windows=ring, **LM_KW)
    toks = _prompt(70, _vocab(lm))
    got = lm.generate_list(toks, 16, stop_token_ids=[])
    assert got == jlm.generate_list(toks, 16, stop_token_ids=[])


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_ring_logits_equal_full_layout(model_dirs, name):
    """The invariant of `tests/test_model.py:160`: a 150-token prompt
    prefilled in 16/64-token chunks (past window + bucket), then decoded."""
    kw = dict(device="cpu", **LM_KW)
    full = LanguageModel.from_dir(model_dirs[name], **kw)
    ring = LanguageModel.from_dir(model_dirs[name], ring_windows=True, **kw)
    toks = _prompt(150, _vocab(full))
    l1, _ = full.prefill(full.new_state(), toks)
    l2, _ = ring.prefill(ring.new_state(), toks)
    np.testing.assert_allclose(l2.numpy(), l1.numpy(), rtol=2e-4, atol=2e-4)
    assert (full.generate_list(toks, 12, stop_token_ids=[])
            == ring.generate_list(toks, 12, stop_token_ids=[]))


@pytest.mark.parametrize("n", [10, 60, 120])
def test_ring_global_layer_sharing_a_windowed_ring_matches_jax(model_dirs, n):
    """The reference's quirk, kept: gemma_config's defaults share layer 2,
    a windowed layer, with the global layer 3, which then reads that ring
    through a causal mask alone. The ring's empty slots (position NEG_POS)
    pass it, and past c = 16 + 64 positions the evicted ones are gone, so
    the ring's logits part from the full layout's at every length. The
    port's ring equals JAX's ring, prefill and decode."""
    d = model_dirs["gemma_default"]
    ring = LanguageModel.from_dir(d, device="cpu", ring_windows=True, **LM_KW)
    full = LanguageModel.from_dir(d, device="cpu", **LM_KW)
    jring = JaxLM.from_dir(d, ring_windows=True, **LM_KW)
    toks = _prompt(n, 512)
    got = ring.prefill(ring.new_state(), toks)[0].numpy()
    want = np.asarray(jring.prefill(jring.new_state(), toks)[0])
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3)
    assert np.abs(got - full.prefill(full.new_state(), toks)[0].numpy()).max() > 1e-3
    assert (ring.generate_list(toks, 8, stop_token_ids=[])
            == jring.generate_list(toks, 8, stop_token_ids=[]))


def test_int8_ring_logits_match_jax(model_dirs):
    toks = _prompt(100, 256)
    got, want, _, _ = _logits_both(model_dirs["windowed"], toks, True, kv_quant=True)
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("ring", [False, True])
def test_chunked_prefill_matches_token_at_a_time(model_dirs, ring):
    """Mirrors `tests/test_ssm.py::test_gemma_ple_kv_sharing`: PLE, KV
    sharing, soft caps and windows across chunk boundaries."""
    toks = _prompt(40, 512)
    lm1 = LanguageModel.from_dir(model_dirs["gemma"], device="cpu", max_context=64,
                                 prefill_buckets=(16,), ring_windows=ring)
    l1, _ = lm1.prefill(lm1.new_state(), toks)
    lm2 = LanguageModel.from_dir(model_dirs["gemma"], device="cpu", max_context=64,
                                 prefill_buckets=(1,), ring_windows=ring)
    s2 = lm2.new_state()
    for t in toks:
        l2, s2 = lm2.prefill(s2, np.array([t]))
    np.testing.assert_allclose(l1.numpy(), l2.numpy(), rtol=5e-4, atol=5e-4)


def test_convert_carries_ple_leaves(model_dirs):
    jlm = JaxLM.from_dir(model_dirs["gemma"], **LM_KW)
    lm = LanguageModel.from_dir(model_dirs["gemma"], device="cpu", **LM_KW)
    import jax

    converted = from_numpy_tree(jax.tree.map(np.asarray, jlm.params))
    assert set(converted["per_layer_embedding"]) == set(lm.params["per_layer_embedding"])
    assert set(converted["layers"][0]["ple"]) == {"gate", "projection", "norm"}
    toks = torch.as_tensor(_prompt(30, 512))
    a, _ = decoder_forward(lm.decoder_config, converted, toks, lm.new_state(), last_only=False)
    b, _ = decoder_forward(lm.decoder_config, lm.params, toks, lm.new_state(), last_only=False)
    torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_capture_trace_on_a_ple_model_matches_jax(model_dirs):
    jlm = JaxLM.from_dir(model_dirs["gemma"], **LM_KW)
    lm = LanguageModel.from_dir(model_dirs["gemma"], device="cpu", **LM_KW)
    toks = _prompt(24, 512, mul=37)
    want = jquality.capture_trace(jlm, toks)
    got = pquality.capture_trace(lm, toks)
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-3, atol=1e-3, err_msg=key)


# -- engines -------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_batch_engine_over_rings_equals_generate_list(model_dirs, name):
    """Five requests over three slots, prompts up to 90 tokens and 24
    generated: every ring wraps; slots are reused."""
    lm = LanguageModel.from_dir(model_dirs[name], device="cpu", ring_windows=True, **LM_KW)
    v = _vocab(lm)
    prompts = [list(_prompt(n, v, 13, 3 + n)) for n in (3, 30, 90, 12, 70)]
    wants = [lm.generate_list(np.asarray(p), 24, stop_token_ids=[]) for p in prompts]
    eng = BatchEngine(lm, batch_size=3, decode_chunk=4, stop_token_ids=[])
    reqs = [eng.submit(p, 24) for p in prompts]
    eng.run()
    assert [r.tokens for r in reqs] == wants


def test_batch_engine_ring_pins_capacity_and_turns_sharing_off(model_dirs):
    kw = dict(device="cpu", max_context=2048, prefill_buckets=(16, 64))
    ring = LanguageModel.from_dir(model_dirs["windowed"], ring_windows=True, **kw)
    full = LanguageModel.from_dir(model_dirs["windowed"], **kw)
    eng = BatchEngine(ring, batch_size=2)
    assert eng._ctx_cap == 2048 and eng.prefix_min == 0
    layers = eng._state["layers"]
    assert layers[0]["k"].shape[:2] == (2, 24 + 64) and layers[0]["pos"].shape == (2, 88)
    assert layers[1]["k"].shape[:2] == (2, 2048) and "pos" not in layers[1]
    eng_full = BatchEngine(full, batch_size=2)
    assert eng_full._ctx_cap == 1024 and eng_full.prefix_min == 64


def test_paged_engine_refuses_rings_and_ple(model_dirs):
    ring = LanguageModel.from_dir(model_dirs["windowed"], device="cpu", ring_windows=True,
                                  **LM_KW)
    with pytest.raises(ValueError, match="ring"):
        PagedBatchEngine(ring, batch_size=2, num_pages=16, page_size=8)
    ple = LanguageModel.from_dir(model_dirs["gemma"], device="cpu", **LM_KW)
    with pytest.raises(ValueError, match="attention-only"):
        PagedBatchEngine(ple, batch_size=2, num_pages=16, page_size=8)


def test_no_ring_or_ple_raise_is_left():
    """Nothing in the port raises NotImplementedError for the ring layout
    or for per-layer embeddings any more."""
    root = os.path.join(os.path.dirname(os.path.dirname(__file__)), "uzu_tpu_torch")
    for dirpath, _, files in os.walk(root):
        for f in files:
            if f.endswith(".py"):
                text = open(os.path.join(dirpath, f)).read()
                for line in text.splitlines():
                    if "NotImplementedError" in line:
                        assert "ring" not in line and "per-layer" not in line, (f, line)


def test_gemma_model_configs_of_the_card_run():
    """chip_smoke's two Gemma-shaped models: gemma3_1b's windows on five
    layers of six and no KV sharing; gemma_e4b_8l's KV source (layer 5) is
    global; both at Dh 256, which K3-K6 are built for."""
    import chip_smoke
    from uzu_tpu_torch.ops.cuda import flash_attention as fa, paged_attention as pa

    one = chip_smoke.model_config("gemma3_1b").decoder_config.transformer_config
    assert [lc.mixer_config.sliding_window_size for lc in one.layer_configs] == [
        None if i % 6 == 5 else 512 for i in range(26)]
    assert all(lc.kv_source_layer_index is None for lc in one.layer_configs)
    e4b = chip_smoke.model_config("gemma_e4b_8l").decoder_config
    srcs = {lc.kv_source_layer_index for lc in e4b.transformer_config.layer_configs} - {None}
    assert srcs == {5}
    assert e4b.transformer_config.layer_configs[5].mixer_config.sliding_window_size is None
    assert e4b.ple_model_config.ple_vocab_size == 262144 and e4b.vocab_size == 262400
    for cfg in (one, e4b.transformer_config):
        dh = cfg.layer_configs[0].mixer_config.head_dim
        assert fa.head_dim_instance(dh) == pa.head_dim_instance(dh) == 256
