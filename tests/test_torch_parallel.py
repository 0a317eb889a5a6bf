"""Tensor/data parallelism of the port (`uzu_tpu_torch/parallel/`) on CPU
ranks over gloo, held to the JAX package on one device.

Each case mirrors one of `tests/test_parallel.py`'s: the same models and
tokens, the port's ranks (spawned, one torch thread each, a `file://`
store) against the JAX `LanguageModel` single-device logits at the JAX
tests' tolerances (2e-4 f32; 2e-3 for quantized, MoE, Gemma, recurrent
and HybridSpec models). The JAX tests' tp=4, dp=2 meshes (8 devices)
become tp=2, dp=2 and tp=4 worlds of 4 ranks. The negative cases plant
the faults a tensor-parallel split can make (a bias added on every rank
before the reduction, a contiguous [up | gate] cut) and hold the logits
check to fail on them.
"""

import numpy as np
import pytest

from torch_parallel_pool import RankPool
from uzu_tpu import LanguageModel as JaxLM
from uzu_tpu.config.model import IntSpec, Layout
from uzu_tpu.tools import synth as jsynth

F32_TOL = 2e-4
TOL = 2e-3


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    p = RankPool(4, str(tmp_path_factory.mktemp("ranks")))
    yield p
    p.close()


def _llama(**kw):
    return jsynth.llama_config(num_layers=2, model_dim=64, hidden_dim=128, num_heads=8,
                               num_groups=4, head_dim=16, vocab_size=256, **kw)


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    return jsynth.synthesize(_llama(), str(tmp_path_factory.mktemp("tp_llama")), seed=3,
                             dtype=np.float32)


@pytest.fixture(scope="module")
def quant_model_dir(tmp_path_factory):
    spec = IntSpec(bits=4, group_size=32, is_symmetric=True, layout=Layout.OUTPUT_INPUT)
    return jsynth.synthesize(_llama(), str(tmp_path_factory.mktemp("tp_llama_q4")), seed=3,
                             dtype=np.float32, linear_spec=spec)


def _jax_logits(model_dir, toks, **kw):
    lm = JaxLM.from_dir(model_dir, max_context=kw.pop("max_context", 64),
                        prefill_buckets=(16,), **kw)
    logits, _ = lm.prefill(lm.new_state(), np.asarray(toks))
    return np.asarray(logits)


def _close_on_every_rank(got, want, tol):
    for g in got:
        np.testing.assert_allclose(g, want, rtol=tol, atol=tol)
    for g in got[1:]:
        np.testing.assert_array_equal(g, got[0])  # the ranks' logits are one


def _dist(got, want) -> float:
    return float(np.abs(got - want).max())


@pytest.mark.parametrize("tp,dp", [(4, 1), (2, 2)])
def test_tp_matches_single_device(pool, model_dir, tp, dp):
    """test_pure_tp4_matches_single_device / test_tp4_dp2_matches_single_device."""
    toks = (np.arange(9) * 5) % 256
    _close_on_every_rank(pool.run("tp_logits", model_dir, tp, dp, toks),
                         _jax_logits(model_dir, toks), F32_TOL)


@pytest.mark.parametrize("tp,dp", [(2, 2), (4, 1)])
def test_tp_quantized_params(pool, quant_model_dir, tp, dp):
    """test_tp_quantized_params: INT4 g32 column slices (K/tp = 32 at tp 4)."""
    toks = (np.arange(9) * 5) % 256
    _close_on_every_rank(pool.run("tp_logits", quant_model_dir, tp, dp, toks),
                         _jax_logits(quant_model_dir, toks), TOL)


def test_validate_tp_rejects_indivisible(model_dir):
    from uzu_tpu_torch.config import load_language_model_config
    from uzu_tpu_torch.parallel import validate_tp

    cfg = load_language_model_config(f"{model_dir}/config.json").decoder_config
    with pytest.raises(ValueError):
        validate_tp(cfg, 3)
    validate_tp(cfg, 4)


@pytest.mark.parametrize("make", ["initialize", "make_mesh", "make_hybrid_mesh",
                                  "make_sp_mesh", "make_pp_mesh"])
def test_mesh_defaults_to_the_card(monkeypatch, make):
    """With no device_type a process group and a mesh are the card's: with
    no card they raise before joining a group; CPU ranks come only from an
    explicit device_type="cpu"."""
    import torch
    import torch.distributed as dist

    from uzu_tpu_torch import parallel

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        getattr(parallel, make)()
    assert not dist.is_initialized()


def test_dp_batched_decode(pool, model_dir):
    """test_dp_batched_decode: slots over dp (one per dp rank), KV over tp."""
    toks = np.asarray([[1, 2, 3, 4], [9, 8, 7, 6]])
    got = pool.run("dp_batched_prefill", model_dir, 2, 2, toks)
    want = np.stack([_jax_logits(model_dir, t) for t in toks])
    _close_on_every_rank(got, want, F32_TOL)


def test_tp_moe_model(pool, tmp_path):
    """test_tp_moe_model: dense expert stacks keep their hidden slice."""
    cfg = jsynth.moe_config(num_layers=2, model_dim=64, hidden_dim=128, num_experts=4,
                            num_active=2, expert_hidden_dim=96, attn_heads=8,
                            attn_groups=4, attn_head_dim=16)
    d = jsynth.synthesize(cfg, str(tmp_path / "moe_tp"), seed=6, dtype=np.float32)
    toks = (np.arange(9) * 5) % 512
    _close_on_every_rank(pool.run("tp_logits", d, 2, 2, toks), _jax_logits(d, toks), TOL)


def test_tp_gemma_model(pool, tmp_path):
    """test_tp_gemma_model: PLE whole, attention split, KV sharing."""
    cfg = jsynth.gemma_config(num_heads=4, num_groups=2, model_dim=96)
    d = jsynth.synthesize(cfg, str(tmp_path / "gemma_tp"), seed=8, dtype=np.float32)
    toks = (np.arange(9) * 7) % 512
    _close_on_every_rank(pool.run("tp_logits", d, 2, 2, toks), _jax_logits(d, toks), TOL)


def _recurrent_cfg(family):
    return {
        "qwen35": lambda: jsynth.qwen35_config(num_layers=3, model_dim=64, hidden_dim=128,
                                               num_heads=4, num_groups=2, head_dim=16,
                                               value_head_dim=16, attn_every=3),
        "mamba2": lambda: jsynth.mamba2_hybrid_config(num_layers=3, model_dim=64,
                                                      hidden_dim=128, num_heads=4,
                                                      num_groups=2, head_dim=16,
                                                      state_dim=16, attn_every=3),
        "lfm2": lambda: jsynth.lfm2_config(num_layers=3, model_dim=64, hidden_dim=128,
                                           attn_every=3),
    }[family]()


@pytest.mark.parametrize("family", ["qwen35", "mamba2", "lfm2"])
def test_tp_recurrent_mixer_model(pool, tmp_path, family):
    """test_tp_recurrent_mixer_model: each section of the fused in-projection,
    the conv channels and the recurrent heads split over tp (the short
    prompt takes the per-token scan)."""
    d = jsynth.synthesize(_recurrent_cfg(family), str(tmp_path / f"{family}_tp"), seed=11,
                          dtype=np.float32)
    toks = (np.arange(9) * 7) % 512
    _close_on_every_rank(pool.run("tp_logits", d, 2, 2, toks), _jax_logits(d, toks), TOL)


def test_tp_recurrent_decode_stream(pool, tmp_path):
    """test_tp_recurrent_decode_stream: a GDN hybrid's sharded stream (40-token
    prompt: the chunked core, then the scan) equals the JAX stream."""
    d = jsynth.synthesize(_recurrent_cfg("qwen35"), str(tmp_path / "gdn_tp_stream"), seed=12,
                          dtype=np.float32)
    toks = list((np.arange(40) * 7) % 512)
    want = JaxLM.from_dir(d, max_context=128, prefill_buckets=(64,)).generate_list(
        toks, 8, stop_token_ids=[])
    got = pool.run("tp_stream", d, 2, 2, toks, 8, max_context=128, prefill_buckets=(64,))
    assert all(g == want for g in got)


def _hybrid_spec():
    from uzu_tpu.config.model import HybridSpec, IncoherenceProcessingMode, LowRankSpec

    return HybridSpec(
        quantization_spec=IntSpec(bits=4, group_size=32, is_symmetric=True,
                                  layout=Layout.OUTPUT_INPUT),
        adapter_spec=LowRankSpec(rank=4), incoherence_block_size=32,
        incoherence_processing_mode=IncoherenceProcessingMode.INPUT_OUTPUT)


def test_tp_hybrid_linear_model(pool, tmp_path):
    """test_tp_hybrid_linear_model at 8 heads over 4 groups, where every
    split side holds whole Hadamard blocks of 32 (the JAX test's 4 heads
    over 2 groups put 16 k rows on a rank: the next test)."""
    d = jsynth.synthesize(_llama(), str(tmp_path / "hybrid_tp"), seed=13,
                          linear_spec=_hybrid_spec(), dtype=np.float32)
    toks = (np.arange(9) * 5) % 256
    _close_on_every_rank(pool.run("tp_logits", d, 2, 2, toks), _jax_logits(d, toks), TOL)


def test_tp_stricter_checks_raise(pool, tmp_path):
    """Where a plain slice would cut what GSPMD reshards, every rank keeps
    that part whole and the result is the unsharded one: the JAX test's
    HybridSpec model (4 heads over 2 groups) cuts a Hadamard block of qkv's
    k rows at tp 2 (qkv kept whole, its sections taken after the
    product); an INT4 g32 model with 4 heads over 4 groups cuts a
    quantization group of out at tp 4 (K/tp = 16: out kept whole behind an
    all-gather of its input); a Qwen3.5-style hybrid with 3 GDN heads over
    1 group, which tp 2 does not divide, keeps its recurrent mixers whole
    (weights, state, compute). Each rank's logits lie within the file's
    F32 tolerance of JAX's unsharded logits (one f32 model; the quantized
    and HybridSpec ones are unquantized the same way in both packages)."""
    cfg = jsynth.llama_config(num_layers=2, model_dim=64, hidden_dim=128, num_heads=4,
                              num_groups=2, head_dim=16, vocab_size=256)
    hybrid = jsynth.synthesize(cfg, str(tmp_path / "hybrid_odd"), seed=13,
                               linear_spec=_hybrid_spec(), dtype=np.float32)
    spec = IntSpec(bits=4, group_size=32, is_symmetric=True, layout=Layout.OUTPUT_INPUT)
    cfg = jsynth.llama_config(num_layers=2, model_dim=64, hidden_dim=128, num_heads=4,
                              num_groups=4, head_dim=16, vocab_size=256)
    q4 = jsynth.synthesize(cfg, str(tmp_path / "q4_odd"), seed=13, linear_spec=spec,
                           dtype=np.float32)
    cfg = jsynth.qwen35_config(num_layers=3, model_dim=64, hidden_dim=128, num_heads=3,
                               num_groups=1, head_dim=16, value_head_dim=16, attn_every=3)
    gdn = jsynth.synthesize(cfg, str(tmp_path / "gdn_odd"), seed=11, dtype=np.float32)
    for d, tp, vocab in ((hybrid, 2, 256), (q4, 4, 256), (gdn, 2, 512)):
        toks = (np.arange(9) * 5) % vocab
        _close_on_every_rank(pool.run("tp_logits", d, tp, 4 // tp, toks),
                             _jax_logits(d, toks), F32_TOL)


def test_planted_bias_before_reduce_fails(pool, tmp_path):
    """gpt-oss-shaped attention has out biases: added on every rank before
    the all-reduce, the logits leave the tolerance; added once after it,
    they match."""
    cfg = jsynth.gptoss_config(num_layers=2, model_dim=64, num_heads=4, num_groups=2,
                               head_dim=16, vocab_size=512)
    d = jsynth.synthesize(cfg, str(tmp_path / "gptoss_tp"), seed=5, dtype=np.float32)
    toks = (np.arange(12) * 7 + 100) % 512
    want = _jax_logits(d, toks)
    _close_on_every_rank(pool.run("tp_logits", d, 2, 2, toks), want, TOL)
    bad = pool.run("tp_logits_fault", d, 2, "bias_before_reduce", toks)
    assert _dist(bad[0], want) > 10 * TOL, _dist(bad[0], want)


def test_planted_contiguous_up_gate_fails(pool, model_dir):
    """A contiguous cut of the fused [up | gate] rows gives rank 0 two up
    halves: the logits check must fail."""
    toks = (np.arange(9) * 5) % 256
    want = _jax_logits(model_dir, toks)
    bad = pool.run("tp_logits_fault", model_dir, 2, "contiguous_up_gate", toks)
    assert _dist(bad[0], want) > 10 * F32_TOL, _dist(bad[0], want)
