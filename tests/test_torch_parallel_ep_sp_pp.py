"""Expert, sequence and pipeline parallelism of the port on CPU ranks.

Mirrors `tests/test_parallel.py`'s EP, ring-attention, sequence-parallel
and pipeline cases on a world of 4 gloo ranks (the JAX tests' 8-device EP
mesh becomes 4 ranks, pp=2 x tp=4 becomes pp=2 x tp=2, and the hybrid's
pp=2 runs with tp=2 inside each stage), held to the JAX package on one
device: EP with ample capacity to the port's `moe_forward` at 1e-5 and
the JAX one at 2e-4, ring attention to the attention reference at 1e-5,
prefill and decode logits at the JAX tests' tolerances.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from torch_parallel_pool import RankPool
from uzu_tpu import LanguageModel as JaxLM
from uzu_tpu.models.decoder import decoder_forward as jax_decoder_forward
from uzu_tpu.tools import synth as jsynth

import torch_parallel_cases as cases


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    p = RankPool(4, str(tmp_path_factory.mktemp("ranks")))
    yield p
    p.close()


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    cfg = jsynth.llama_config(num_layers=2, model_dim=64, hidden_dim=128, num_heads=8,
                              num_groups=4, head_dim=16, vocab_size=256)
    return jsynth.synthesize(cfg, str(tmp_path_factory.mktemp("sp_llama")), seed=3,
                             dtype=np.float32)


def _one(results):
    for r in results[1:]:
        np.testing.assert_array_equal(r, results[0])
    return results[0]


def test_expert_parallel_all_to_all(pool, tmp_path):
    """test_expert_parallel_all_to_all: 8 experts over 4 ranks, tokens
    dispatched with all_to_all; ample capacity equals moe_forward, starved
    capacity still runs."""
    import torch

    from uzu_tpu.models.moe import moe_forward as jax_moe_forward
    from uzu_tpu_torch.models.moe import moe_forward
    from uzu_tpu_torch.parallel.expert import default_capacity

    cfg = jsynth.moe_config(num_layers=1, model_dim=64, num_experts=8, num_active=2,
                            expert_hidden_dim=96)
    d = jsynth.synthesize(cfg, str(tmp_path / "moe_ep"), seed=9, dtype=np.float32)
    lm = cases._lm(d)
    moe_cfg = lm.decoder_config.transformer_config.layer_configs[0].mlp_config
    x = np.random.default_rng(0).standard_normal((4 * 16, 64)).astype(np.float32)
    want = moe_forward(moe_cfg, lm.params["layers"][0]["mlp"], torch.from_numpy(x)).numpy()
    jlm = JaxLM.from_dir(d, max_context=64)
    want_jax = np.asarray(jax_moe_forward(
        jlm.decoder_config.transformer_config.layer_configs[0].mlp_config,
        jlm.params["layers"][0]["mlp"], jnp.asarray(x)))
    got = _one(pool.run("ep_forward", d, x, 16 * moe_cfg.num_active_routed_experts))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, want_jax, rtol=2e-4, atol=2e-4)
    small = _one(pool.run("ep_forward", d, x, 8))
    assert np.isfinite(small).all() and np.abs(small - want).max() > 1e-3  # assignments drop
    assert default_capacity(128, moe_cfg, 8) >= 8


@pytest.mark.parametrize("kw", [{}, dict(sliding_window_size=9, logit_soft_cap=30.0)])
def test_ring_attention_matches_reference(pool, kw):
    """test_ring_attention_matches_reference, plain and windowed/soft-capped."""
    from uzu_tpu.ops.attention import attention_reference

    rng = np.random.default_rng(2)
    s, h, g, dh = 32, 4, 2, 16
    q = rng.standard_normal((s, h, dh)).astype(np.float32)
    k = rng.standard_normal((s, g, dh)).astype(np.float32)
    v = rng.standard_normal((s, g, dh)).astype(np.float32)
    pos = np.arange(s, dtype=np.int32)
    scale = dh ** -0.5
    want = np.asarray(attention_reference(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                          jnp.asarray(pos), scale=scale, is_causal=True, **kw))
    got = _one(pool.run("ring", q, k, v, pos, scale=scale, **kw))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_sequence_parallel_prefill_matches_single(pool, model_dir):
    """test_sequence_parallel_prefill_matches_single: 13 tokens over 4 ranks
    (end-padded to 16), and one decode step from the state it leaves."""
    toks = (np.arange(13) * 5) % 256
    lm = JaxLM.from_dir(model_dir, max_context=64, prefill_buckets=(16,))
    want, state = lm.prefill(lm.new_state(), toks)
    nxt = int(np.argmax(np.asarray(want)))
    want_next, _ = jax_decoder_forward(lm.decoder_config, lm.params,
                                       jnp.asarray([nxt], jnp.int32), state)
    got = pool.run("sp_prefill", model_dir, toks, nxt)
    for logits, step in got:
        np.testing.assert_allclose(logits, np.asarray(want), rtol=2e-4, atol=2e-4)
        np.testing.assert_allclose(step, np.asarray(want_next[0]), rtol=2e-4, atol=2e-4)


def test_sequence_parallel_prefill_gemma(pool, tmp_path):
    """test_sequence_parallel_prefill_gemma: PLE, KV sharing, windows, caps."""
    cfg = jsynth.gemma_config(num_heads=4, num_groups=2, model_dim=96)
    d = jsynth.synthesize(cfg, str(tmp_path / "gemma_sp"), seed=12, dtype=np.float32)
    toks = (np.arange(11) * 3) % 512
    lm = JaxLM.from_dir(d, max_context=64, prefill_buckets=(16,))
    want, _ = lm.prefill(lm.new_state(), toks)
    for logits, _ in pool.run("sp_prefill", d, toks):
        np.testing.assert_allclose(logits, np.asarray(want), rtol=2e-3, atol=2e-3)


def _jax_reference(d, tokens, steps, **cfg_kw):
    """Per-sequence JAX prefill and `steps` greedy decode steps: (logits
    [B, V] per forward, the decode tokens fed, the final states)."""
    lm = JaxLM.from_dir(d, max_context=64, prefill_buckets=(8,))
    states, logits = [], []
    for t in tokens:
        lg, st = jax_decoder_forward(lm.decoder_config, lm.params, jnp.asarray(t),
                                     lm.new_state(), true_length=len(t))
        states.append(st)
        logits.append(np.asarray(lg[0]))
    out, feeds = [np.stack(logits)], []
    for _ in range(steps):
        nxt = out[-1].argmax(-1)
        feeds.append(nxt)
        logits = []
        for b in range(len(tokens)):
            lg, states[b] = jax_decoder_forward(lm.decoder_config, lm.params,
                                                jnp.asarray(nxt[b:b + 1], jnp.int32),
                                                states[b], true_length=1)
            logits.append(np.asarray(lg[0]))
        out.append(np.stack(logits))
    return out, feeds, states


def test_pipeline_parallel_matches_single_device(pool, tmp_path):
    """test_pipeline_parallel_matches_single_device: pp=4 over 4 layers, a
    prefill and two decode steps, and the pipelined KV equals the
    reference's."""
    cfg = jsynth.llama_config(num_layers=4, model_dim=64, hidden_dim=128, num_heads=4,
                              num_groups=2, head_dim=16, vocab_size=256)
    d = jsynth.synthesize(cfg, str(tmp_path / "pp_llama"), seed=21, dtype=np.float32)
    tokens = np.random.default_rng(0).integers(0, 256, (4, 8)).astype(np.int32)
    want, feeds, states = _jax_reference(d, tokens, 2)
    for got, kv in pool.run("pp_forward", d, 4, 1, tokens, feeds):
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, rtol=2e-4, atol=2e-4)
        for li in range(4):
            for key in ("k", "v"):
                ref = np.stack([np.asarray(st["layers"][li][key], np.float32) for st in states])
                np.testing.assert_allclose(kv[li][key], ref, rtol=2e-4, atol=2e-4)


def test_validate_pp_rejects_nonuniform():
    from uzu_tpu_torch.parallel import validate_pp
    from uzu_tpu_torch.tools import synth

    with pytest.raises(ValueError):
        validate_pp(synth.qwen35_config(num_layers=4).decoder_config, 2)
    cfg = synth.llama_config(num_layers=4, model_dim=64, hidden_dim=128, num_heads=4,
                             num_groups=2, head_dim=16, vocab_size=256)
    with pytest.raises(ValueError):
        validate_pp(cfg.decoder_config, 3)
    validate_pp(cfg.decoder_config, 2)


def test_pipeline_times_tensor_parallel(pool, tmp_path):
    """test_pipeline_times_tensor_parallel: pp=2 x tp=2; each stage's layers
    split over tp, each tp rank sending to its counterpart."""
    cfg = jsynth.llama_config(num_layers=4, model_dim=64, hidden_dim=128, num_heads=8,
                              num_groups=4, head_dim=16, vocab_size=256)
    d = jsynth.synthesize(cfg, str(tmp_path / "pptp_llama"), seed=22, dtype=np.float32)
    tokens = np.random.default_rng(1).integers(0, 256, (4, 8)).astype(np.int32)
    want, _, _ = _jax_reference(d, tokens, 0)
    for got, _ in pool.run("pp_forward", d, 2, 2, tokens, []):
        np.testing.assert_allclose(got[0], want[0], rtol=2e-4, atol=2e-4)


def test_pipeline_parallel_hybrid_model(pool, tmp_path):
    """test_pipeline_parallel_hybrid_model: a periodic GDN + attention hybrid
    over pp=2 (x tp=2): recurrent conv/ssm states ride the pipeline through
    a prefill and a decode step."""
    cfg = jsynth.qwen35_config(num_layers=4, model_dim=64, hidden_dim=128, num_heads=4,
                               num_groups=2, head_dim=16, value_head_dim=16, attn_every=2)
    d = jsynth.synthesize(cfg, str(tmp_path / "pp_hybrid"), seed=23, dtype=np.float32)
    tokens = np.random.default_rng(2).integers(0, 512, (4, 8)).astype(np.int32)
    want, feeds, _ = _jax_reference(d, tokens, 1)
    for got, _ in pool.run("pp_forward", d, 2, 2, tokens, feeds):
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, rtol=2e-4, atol=2e-4)
