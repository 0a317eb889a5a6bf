"""The port's recurrent mixers and hybrid models against the JAX package, on the CPU.

- Each mixer (ShortConv, Mamba2, Gated DeltaNet) through
  `uzu_tpu.models.ssm.ssm_forward` and the port's on the same
  numpy-seeded f32 inputs: below SSM_CHUNKED_MIN_S rows (the per-token
  loop) and at or above it (the chunked cores), with a padded true length
  and a non-zero initial state; outputs and states within 1e-4 of RMS.
- The port's chunked cores against its own per-token recurrence, a full
  64-row chunk of strong decay included (the exp-overflow regression).
- Tiny `qwen35_config`, `lfm2_config` and `mamba2_hybrid_config` models:
  byte-identical files from both synthesizers, prefill-decode and mixed
  chunking consistency, teacher-forced logits within 1e-3 relative L2 of
  the JAX `LanguageModel`, greedy streams equal wherever the top-2 margin
  clears that tolerance, engine states after a prefill and after a decode
  chunk in which the stream halts, the weight carry-over, and the quality
  tools.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uzu_tpu import LanguageModel as JaxLM
from uzu_tpu.config.model import (
    DeltaNetConfig as JaxDeltaNet,
    GELU as JaxGELU,
    IntSpec as JaxIntSpec,
    Layout as JaxLayout,
    LinearConfig as JaxLinear,
    Mamba2Config as JaxMamba2,
    NormalizationConfig as JaxNorm,
    SeparableCausalConvConfig as JaxConv,
    ShortConvConfig as JaxShortConv,
    SiLU as JaxSiLU,
    UntiedEmbeddingConfig as JaxUntied,
    UpcastMode as JaxUpcast,
)
from uzu_tpu.engine.sampling import SamplingParams as JaxSampling
from uzu_tpu.models.decoder import decoder_forward as jax_forward
from uzu_tpu.models.ssm import make_ssm_state as jax_make_state, ssm_forward as jax_ssm
from uzu_tpu.tools import quality as jquality
from uzu_tpu.tools import synth as jsynth
from uzu_tpu_torch import LanguageModel
from uzu_tpu_torch.config import model as pcfg
from uzu_tpu_torch.convert import from_numpy_tree
from uzu_tpu_torch.engine.sampling import SamplingParams
from uzu_tpu_torch.models.decoder import decoder_forward
from uzu_tpu_torch.models.ssm import (
    SSM_CHUNKED_MIN_S,
    _delta_net_chunked,
    _mamba2_chunked,
    make_ssm_state,
    ssm_forward,
)
from uzu_tpu_torch.tools import quality, synth

torch.set_num_threads(1)

RMS_TOL = 1e-4  # max |port - JAX| over RMS(JAX): f32 on both sides
REL_L2 = 1e-3  # teacher-forced logits, relative L2


def _rel_l2(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def _close_rms(got, want, tol=RMS_TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    rms = max(float(np.sqrt(np.mean(want ** 2))), 1e-30)
    err = float(np.abs(got - want).max()) / rms
    assert err <= tol, f"max error {err:.3e} of RMS > {tol}"


# -- single mixers --------------------------------------------------------------------

D = 48


def _mixer_cfgs(kind: str):
    """(JAX config, port config) of one small mixer."""
    if kind == "shortconv":
        return (JaxShortConv(in_projection_config=JaxLinear(),
                             conv_config=JaxConv(has_biases=True),
                             out_projection_config=JaxLinear(), kernel_size=3),
                pcfg.ShortConvConfig(in_projection_config=pcfg.LinearConfig(),
                                     conv_config=pcfg.SeparableCausalConvConfig(has_biases=True),
                                     out_projection_config=pcfg.LinearConfig(), kernel_size=3))
    if kind in ("mamba2", "mamba2_gelu"):
        gelu = kind == "mamba2_gelu"
        kw = dict(kernel_size=4, num_heads=4, num_groups=2, head_dim=8, state_dim=12,
                  has_in_biases=True, has_out_biases=True)
        return (JaxMamba2(in_projection_config=JaxLinear(), out_projection_config=JaxLinear(),
                          conv_config=JaxConv(has_biases=True),
                          activation=JaxGELU(approximate=True) if gelu else JaxSiLU(alpha=1.0),
                          **kw),
                pcfg.Mamba2Config(in_projection_config=pcfg.LinearConfig(),
                                  out_projection_config=pcfg.LinearConfig(),
                                  conv_config=pcfg.SeparableCausalConvConfig(has_biases=True),
                                  activation=(pcfg.GELU(approximate=True) if gelu
                                              else pcfg.SiLU(alpha=1.0)), **kw))
    kw = dict(num_heads=4, num_groups=2, head_dim=16, value_head_dim=12, kernel_size=4)
    return (JaxDeltaNet(in_proj_config=JaxLinear(), conv_config=JaxConv(has_biases=True),
                        out_proj_config=JaxLinear(),
                        norm_config=JaxNorm(epsilon=1e-6, scale_offset=None,
                                            upcast_mode=JaxUpcast.FULL_LAYER,
                                            subtract_mean=False, has_biases=False), **kw),
            pcfg.DeltaNetConfig(in_proj_config=pcfg.LinearConfig(),
                                conv_config=pcfg.SeparableCausalConvConfig(has_biases=True),
                                out_proj_config=pcfg.LinearConfig(),
                                norm_config=pcfg.NormalizationConfig(
                                    epsilon=1e-6, scale_offset=None,
                                    upcast_mode=pcfg.UpcastMode.FULL_LAYER,
                                    subtract_mean=False, has_biases=False), **kw))


def _mixer_params(kind: str, cfg, rng) -> dict:
    """Random f32 parameters as numpy, named as both loaders name them."""
    def rnd(*shape, scale=0.2):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    if kind == "shortconv":
        return {"in": {"w": rnd(3 * D, D)}, "out": {"w": rnd(D, D)},
                "conv_w": rnd(D, cfg.kernel_size, scale=0.4), "conv_b": rnd(D)}
    if kind.startswith("mamba2"):
        inner = cfg.num_heads * cfg.head_dim
        conv_dim = inner + 2 * cfg.num_groups * cfg.state_dim
        return {"in": {"w": rnd(conv_dim + inner + cfg.num_heads, D),
                       "b": rnd(conv_dim + inner + cfg.num_heads)},
                "out": {"w": rnd(D, inner), "b": rnd(D)},
                "gate_bias": rnd(inner), "conv_w": rnd(conv_dim, cfg.kernel_size, scale=0.4),
                "conv_b": rnd(conv_dim), "skip_weight": rnd(cfg.num_heads, scale=0.5)}
    key_dim, value_dim = cfg.num_groups * cfg.head_dim, cfg.num_heads * cfg.value_head_dim
    conv_dim = 2 * key_dim + value_dim
    return {"in": {"w": rnd(conv_dim + value_dim + 2 * cfg.num_heads, D)},
            "out": {"w": rnd(D, value_dim)},
            "conv_w": rnd(conv_dim, cfg.kernel_size, scale=0.4), "conv_b": rnd(conv_dim),
            "a_log": rnd(cfg.num_heads, scale=0.3), "dt_bias": rnd(cfg.num_heads, scale=0.3),
            "norm_scales": 1.0 + rnd(cfg.value_head_dim, scale=0.05)}


def _tree(p, fn):
    return {k: _tree(v, fn) if isinstance(v, dict) else fn(v) for k, v in p.items()}


# (rows, true length, non-zero initial state): the per-token loop, the
# chunked cores over a ragged tail, padded rows in both, a carried state
MIXER_CASES = [(12, 12, False), (12, 7, True), (70, 70, False), (70, 61, True),
               (SSM_CHUNKED_MIN_S, SSM_CHUNKED_MIN_S, True), (1, 1, True)]


@pytest.mark.parametrize("kind", ["shortconv", "mamba2", "mamba2_gelu", "gdn"])
@pytest.mark.parametrize("s,true_length,warm", MIXER_CASES)
def test_mixer_matches_jax(kind, s, true_length, warm):
    rng = np.random.default_rng(hash((kind, s, true_length, warm)) % 2**32)
    jcfg, cfg = _mixer_cfgs(kind)
    params = _mixer_params(kind, cfg, rng)
    x = rng.standard_normal((s, D)).astype(np.float32)
    jstate = jax_make_state(jcfg, D, jnp.float32)
    state = {k: np.zeros(v.shape, np.float32) for k, v in jstate.items()}
    if warm:
        state = {k: (rng.standard_normal(v.shape) * 0.3).astype(np.float32)
                 for k, v in state.items()}
    want, want_state = jax_ssm(jcfg, _tree(params, jnp.asarray), jnp.asarray(x), None,
                               _tree(state, jnp.asarray), true_length)
    got, got_state = ssm_forward(cfg, _tree(params, torch.from_numpy), torch.from_numpy(x),
                                 None, _tree(state, torch.from_numpy), true_length)
    _close_rms(got.numpy()[:true_length], np.asarray(want)[:true_length])
    assert sorted(got_state) == sorted(want_state)
    for name in want_state:
        _close_rms(got_state[name].numpy(), np.asarray(want_state[name]))


def test_mixer_takes_a_device_true_length():
    """A decode step's 0-d true length (0 for a halted stream) leaves the
    state as it was; 1 is the step itself."""
    rng = np.random.default_rng(0)
    _, cfg = _mixer_cfgs("gdn")
    params = _tree(_mixer_params("gdn", cfg, rng), torch.from_numpy)
    state = {k: torch.randn(v.shape, generator=torch.Generator().manual_seed(1))
             for k, v in make_ssm_state(cfg, D).items()}
    x = torch.from_numpy(rng.standard_normal((1, D)).astype(np.float32))
    _, held = ssm_forward(cfg, params, x, None, state, torch.tensor(0, dtype=torch.int32))
    for k in state:
        assert torch.equal(held[k], state[k])
    _, moved = ssm_forward(cfg, params, x, None, state, torch.tensor(1, dtype=torch.int32))
    _, want = ssm_forward(cfg, params, x, None, state, 1)
    for k in state:
        assert torch.equal(moved[k], want[k])


def test_make_ssm_state_matches_jax():
    for kind in ("shortconv", "mamba2", "gdn"):
        jcfg, cfg = _mixer_cfgs(kind)
        want = jax_make_state(jcfg, D)
        got = make_ssm_state(cfg, D)
        assert sorted(got) == sorted(want)
        for k in want:
            assert tuple(got[k].shape) == want[k].shape
            assert str(got[k].dtype).split(".")[-1] == str(want[k].dtype)


def test_defer_raises():
    """Deferred state is ported: defer=True returns the JAX package's
    replay inputs, committing all S rows gives the plain forward's state,
    and a commit of a config that is not a recurrent mixer raises."""
    from uzu_tpu_torch.models.ssm import ssm_commit

    rng = np.random.default_rng(5)
    for kind in ("shortconv", "mamba2", "gdn"):
        jcfg, cfg = _mixer_cfgs(kind)
        params = _tree(_mixer_params(kind, cfg, rng), torch.from_numpy)
        x = torch.from_numpy(rng.standard_normal((6, D)).astype(np.float32))
        state = make_ssm_state(cfg, D, torch.float32)
        _, aux = ssm_forward(cfg, params, x, None, state, defer=True)
        _, want_aux = jax_ssm(jcfg, _tree(_mixer_params(kind, cfg, rng), jnp.asarray),
                              jnp.zeros((6, D)), None,
                              {k: jnp.zeros(v.shape) for k, v in state.items()}, defer=True)
        assert sorted(aux) == sorted(want_aux)
        _, plain = ssm_forward(cfg, params, x, None, state)
        got = ssm_commit(cfg, aux, 6)
        for k in plain:
            torch.testing.assert_close(got[k], plain[k], rtol=0, atol=0)
    with pytest.raises(ValueError):
        ssm_commit(pcfg.AttentionConfig.__new__(pcfg.AttentionConfig), aux, 1)


# -- chunked cores against the per-token recurrence ----------------------------------

def _gdn_scan(qs, ks, vs, beta, log_decay, ssm0):
    decay = torch.exp(log_decay)
    ssm, outs = ssm0, []
    for t in range(qs.shape[1]):
        q_t, k_t, v_t, b_t, d_t = qs[:, t], ks[:, t], vs[:, t], beta[:, t], decay[:, t]
        sk = torch.einsum("bhvk,bhk->bhv", ssm, k_t)
        sq = torch.einsum("bhvk,bhk->bhv", ssm, q_t)
        delta = b_t[..., None] * (v_t - d_t[..., None] * sk)
        outs.append(d_t[..., None] * sq + delta * (k_t * q_t).sum(-1)[..., None])
        ssm = d_t[..., None, None] * ssm + delta[..., :, None] * k_t[..., None, :]
    return ssm, torch.stack(outs, dim=1)


def _t(rng, *shape, scale=1.0):
    return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32))


@pytest.mark.parametrize("case", ["ragged", "strong_decay"])
def test_delta_net_chunked_equals_scan(case):
    rng = np.random.default_rng(3)
    b, h, dk, dv = 2, 3, 16, 24
    if case == "ragged":  # 3 chunks of 32, a padded tail past row 61
        s, chunk, real = 70, 32, 61
        log_decay = -torch.from_numpy(rng.random((b, s, h)).astype(np.float32)) * 0.3
    else:  # one full 64-row chunk whose decay ratios overflow above the diagonal
        s, chunk, real = 64, 64, 64
        log_decay = -torch.from_numpy(rng.random((b, s, h)).astype(np.float32)) * 2.0 - 0.5
    # q and k L2-normalized (q scaled) as the mixer feeds them: the delta
    # rule is a contraction for unit keys
    qs = torch.nn.functional.normalize(_t(rng, b, s, h, dk), dim=-1) * dk ** -0.5
    ks = torch.nn.functional.normalize(_t(rng, b, s, h, dk), dim=-1)
    vs = _t(rng, b, s, h, dv)
    beta = torch.from_numpy(rng.random((b, s, h)).astype(np.float32))
    valid = (torch.arange(s) < real)[None, :, None]
    beta, log_decay = torch.where(valid, beta, 0.0), torch.where(valid, log_decay, 0.0)
    ssm0 = _t(rng, b, h, dv, dk, scale=0.1)
    ssm_ref, o_ref = _gdn_scan(qs, ks, vs, beta, log_decay, ssm0)
    ssm_chk, o_chk = _delta_net_chunked(qs, ks, vs, beta, log_decay, ssm0, chunk)
    assert torch.isfinite(o_chk).all()
    np.testing.assert_allclose(o_chk[:, :real], o_ref[:, :real], rtol=5e-4, atol=5e-4)
    np.testing.assert_allclose(ssm_chk, ssm_ref, rtol=5e-4, atol=5e-4)


@pytest.mark.parametrize("case", ["ragged", "strong_decay"])
def test_mamba2_chunked_equals_scan(case):
    rng = np.random.default_rng(5)
    b, h, dh, n = 2, 2, 8, 12
    if case == "ragged":
        s, chunk, real = 50, 16, 45
        log_decay = -torch.from_numpy(rng.random((b, s, h)).astype(np.float32)) * 0.5
    else:
        s, chunk, real = 64, 64, 64
        log_decay = -torch.from_numpy(rng.random((b, s, h)).astype(np.float32)) * 2.0 - 0.5
    xs, bs, cs = _t(rng, b, s, h, dh), _t(rng, b, s, h, n), _t(rng, b, s, h, n)
    valid = (torch.arange(s) < real)[None, :, None]
    xs = torch.where(valid[..., None], xs, 0.0)
    log_decay = torch.where(valid, log_decay, 0.0)
    ssm0 = _t(rng, b, h, dh, n, scale=0.1)
    ssm, ys = ssm0, []
    for t in range(s):
        ssm = ssm * torch.exp(log_decay[:, t])[..., None, None] + xs[:, t, :, :, None] * \
            bs[:, t, :, None, :]
        ys.append(torch.einsum("bhdn,bhn->bhd", ssm, cs[:, t]))
    ssm_chk, y_chk = _mamba2_chunked(xs, bs, cs, log_decay, ssm0, chunk)
    assert torch.isfinite(y_chk).all()
    np.testing.assert_allclose(y_chk[:, :real], torch.stack(ys, 1)[:, :real], rtol=2e-4,
                               atol=2e-4)
    np.testing.assert_allclose(ssm_chk, ssm, rtol=2e-4, atol=2e-4)


# -- tiny hybrid models ---------------------------------------------------------------

FAMILIES = {"qwen35": (jsynth.qwen35_config, synth.qwen35_config),
            "lfm2": (jsynth.lfm2_config, synth.lfm2_config),
            "mamba2": (jsynth.mamba2_hybrid_config, synth.mamba2_hybrid_config)}
VOCAB = 512


def untied(cfg):
    """A JAX-package config with untied embeddings: random tied models
    collapse into repeating the input token, so streams of the untied ones
    say more."""
    dc = dataclasses.replace(cfg.decoder_config, embedding_config=JaxUntied(
        input_scale=None, logit_soft_cap=None))
    return dataclasses.replace(cfg, decoder_config=dc)


@pytest.fixture(scope="module")
def hybrid_dirs(tmp_path_factory):
    """{name: dir} of tiny untied f32 hybrids written by the JAX synthesizer."""
    root = tmp_path_factory.mktemp("torch_hybrids")
    return {name: jsynth.synthesize(untied(jb()), str(root / name), seed=11, dtype=np.float32)
            for name, (jb, _) in FAMILIES.items()}


@pytest.fixture(scope="module")
def jax_lms(hybrid_dirs):
    return {name: JaxLM.from_dir(d, max_context=128, prefill_buckets=(16, 64))
            for name, d in hybrid_dirs.items()}


def _port(d, **kw):
    kw = {"max_context": 128, "prefill_buckets": (16, 64), **kw}
    return LanguageModel.from_dir(d, device="cpu", **kw)


@pytest.mark.parametrize("name", list(FAMILIES))
@pytest.mark.parametrize("spec", ["f32", "int4"])
def test_synthesize_writes_identical_files(tmp_path, name, spec):
    jb, pb = FAMILIES[name]
    jkw, pkw = {"dtype": np.float32}, {"dtype": np.float32}
    if spec == "int4":
        jkw = {"linear_spec": JaxIntSpec(bits=4, group_size=32, is_symmetric=True,
                                         layout=JaxLayout.OUTPUT_INPUT)}
        pkw = {"linear_spec": pcfg.IntSpec(bits=4, group_size=32, is_symmetric=True,
                                           layout=pcfg.Layout.OUTPUT_INPUT)}
    a = jsynth.synthesize(jb(), str(tmp_path / "jax"), seed=2, **jkw)
    b = synth.synthesize(pb(), str(tmp_path / "port"), seed=2, **pkw)
    for f in ("config.json", "model.safetensors"):
        with open(f"{a}/{f}", "rb") as fa, open(f"{b}/{f}", "rb") as fb:
            assert fa.read() == fb.read(), f


@pytest.mark.parametrize("name", list(FAMILIES))
def test_prefill_decode_consistency(hybrid_dirs, name):
    """One-shot prefill == token-at-a-time prefill (the state carry)."""
    toks = (np.arange(12) * 13) % VOCAB
    lm1 = _port(hybrid_dirs[name], max_context=64, prefill_buckets=(16,))
    l1, _ = lm1.prefill(lm1.new_state(), toks)
    lm2 = _port(hybrid_dirs[name], max_context=64, prefill_buckets=(1,))
    s2 = lm2.new_state()
    for t in toks:
        l2, s2 = lm2.prefill(s2, np.array([t]))
    np.testing.assert_allclose(l1.numpy(), l2.numpy(), rtol=5e-4, atol=5e-4)


@pytest.mark.parametrize("name", list(FAMILIES))
def test_mixed_chunking(hybrid_dirs, name):
    toks = (np.arange(11) * 29) % VOCAB
    lm1 = _port(hybrid_dirs[name], max_context=64, prefill_buckets=(16,))
    l1, _ = lm1.prefill(lm1.new_state(), toks)
    lm2 = _port(hybrid_dirs[name], max_context=64, prefill_buckets=(4, 16))
    _, s2 = lm2.prefill(lm2.new_state(), toks[:7])
    l2, _ = lm2.prefill(s2, toks[7:])
    np.testing.assert_allclose(l1.numpy(), l2.numpy(), rtol=5e-4, atol=5e-4)


@pytest.mark.parametrize("name", list(FAMILIES))
def test_chunked_prefill_matches_token_at_a_time(hybrid_dirs, name):
    """A 64-row bucket (the chunked cores) == per-token prefill."""
    toks = (np.arange(40) * 7) % VOCAB
    lm1 = _port(hybrid_dirs[name], prefill_buckets=(64,))
    l1, _ = lm1.prefill(lm1.new_state(), toks)
    lm2 = _port(hybrid_dirs[name], prefill_buckets=(1,))
    s2 = lm2.new_state()
    for t in toks:
        l2, s2 = lm2.prefill(s2, np.array([t]))
    assert _rel_l2(l1.numpy(), l2.numpy()) <= 2e-3


@pytest.mark.parametrize("name", list(FAMILIES))
@pytest.mark.parametrize("n", [12, 40, 100])
def test_teacher_forced_logits_match_jax(hybrid_dirs, jax_lms, name, n):
    jlm, lm = jax_lms[name], _port(hybrid_dirs[name])
    toks = (np.arange(n) * 37 + 5) % VOCAB
    want, _ = jax_forward(jlm.decoder_config, jlm.params, jnp.asarray(toks, jnp.int32),
                          jlm.new_state(), last_only=False)
    got, _ = decoder_forward(lm.decoder_config, lm.params, torch.as_tensor(toks),
                             lm.new_state(), last_only=False)
    assert _rel_l2(got.numpy(), np.asarray(want)) <= REL_L2


@pytest.mark.parametrize("name", list(FAMILIES))
@pytest.mark.parametrize("n", [5, 20, 70])
def test_greedy_stream_matches_jax(hybrid_dirs, jax_lms, name, n):
    """The streams agree up to the first step whose top-2 margin is inside
    the logits' tolerance (there either token is right)."""
    lm = _port(hybrid_dirs[name])
    toks = (np.arange(n) * 101 + 3) % VOCAB
    got = lm.generate_list(toks, 16, stop_token_ids=[])
    want = jax_lms[name].generate_list(toks, 16, stop_token_ids=[])
    seq = np.concatenate([toks, got])
    logits, _ = decoder_forward(lm.decoder_config, lm.params, torch.as_tensor(seq),
                                lm.new_state(), last_only=False)
    rows = logits[len(toks) - 1: len(toks) - 1 + len(got)]
    assert rows.argmax(-1).tolist() == got
    top2 = torch.topk(rows, 2).values
    scale = rows.abs().max().item()
    for i, (a, b) in enumerate(zip(got, want)):
        if (top2[i, 0] - top2[i, 1]).item() <= REL_L2 * scale:
            break
        assert a == b, f"step {i}: port {a}, JAX {b}"


def _state_leaves(state):
    """{name: (f32 values, stored in bf16)} of the position and every
    recurrent layer's leaves."""
    out = {"pos": (np.asarray(state["pos"]), False)}
    for i, layer in enumerate(state["layers"]):
        if layer is not None and "conv" in layer:  # a recurrent layer's leaves
            for k, v in layer.items():
                if isinstance(v, torch.Tensor):
                    out[f"{i}.{k}"] = (v.float().numpy(), v.dtype == torch.bfloat16)
                else:
                    out[f"{i}.{k}"] = (np.asarray(v, np.float32), str(v.dtype) == "bfloat16")
    return out


def _states_close(got, want):
    """f32 leaves within 1e-3 of RMS; a bf16 leaf (a ShortConv tail) holds
    values that agree to that before rounding, so each element may land one
    bf16 step apart (up to 2^-7 relative, at the bottom of a binade)."""
    assert sorted(got) == sorted(want) and len(got) > 1
    for k, (w, bf16) in want.items():
        g, g_bf16 = got[k]
        assert g_bf16 == bf16, k
        if bf16:
            np.testing.assert_allclose(g, w, rtol=2 ** -7, atol=1e-6)
        else:
            _close_rms(g, w, 1e-3)


@pytest.mark.parametrize("name", list(FAMILIES))
def test_engine_states_match_jax(hybrid_dirs, jax_lms, name):
    """After a bucketed chunked prefill (a 64-row and a padded 16-row
    chunk), and after an 8-step decode chunk in which the stream halts at
    its budget (3 steps), the recurrent leaves and the position equal the
    JAX engine's."""
    jlm, lm = jax_lms[name], _port(hybrid_dirs[name])
    toks = (np.arange(75) * 37 + 5) % VOCAB
    jl, js = jlm.prefill(jlm.new_state(), toks)
    pl, ps = lm.prefill(lm.new_state(), toks)
    assert _rel_l2(pl.numpy(), np.asarray(jl)) <= REL_L2
    _states_close(_state_leaves(ps), _state_leaves(js))

    token = int(np.argmax(np.asarray(jl)))
    fn = jlm._decode_fn(JaxSampling(), 8, ())
    js, emitted, jhalted = fn(jlm.params, js, jnp.asarray(token, jnp.int32),
                              jnp.asarray(False), 3, jax.random.split(jax.random.PRNGKey(0), 8))
    ps, ptoks, phalted = lm._decode_chunk(
        ps, torch.tensor(token), torch.tensor(False), torch.tensor(3, dtype=torch.int32), 8,
        SamplingParams(), None, None, torch.Generator().manual_seed(0))
    assert bool(phalted) and bool(jhalted)
    assert ptoks.tolist() == np.asarray(emitted[0]).tolist()
    assert int(ps["pos"]) == int(js["pos"]) == 78
    _states_close(_state_leaves(ps), _state_leaves(js))


@pytest.mark.parametrize("name", list(FAMILIES))
def test_convert_matches_port_loader(hybrid_dirs, jax_lms, name):
    lm = _port(hybrid_dirs[name])
    converted = from_numpy_tree(jax.tree.map(np.asarray, jax_lms[name].params))

    def check(a, b):
        if isinstance(a, dict):
            assert sorted(a) == sorted(b)
            for k in a:
                check(a[k], b[k])
        elif isinstance(a, list):
            for x, y in zip(a, b):
                check(x, y)
        else:
            assert a.dtype == b.dtype and torch.equal(a, b)

    check(converted, lm.params)
    mixer = converted["layers"][0]["mixer"]
    assert all(v.dtype == torch.float32 for k, v in mixer.items() if k not in ("in", "out"))


@pytest.mark.parametrize("name", list(FAMILIES))
def test_quality_tools_on_a_hybrid(hybrid_dirs, jax_lms, name):
    """sequence_nll and capture_trace run on a hybrid; the trace taps the
    recurrent layers as it taps the attention ones."""
    lm = _port(hybrid_dirs[name])
    toks = (np.arange(90) * 13 + 1) % VOCAB
    got = quality.sequence_nll(lm, toks, chunk=64)
    want = jquality.sequence_nll(jax_lms[name], toks, chunk=64)
    assert got["count"] == want["count"]
    assert abs(got["nll"] - want["nll"]) <= 1e-4
    tg = quality.capture_trace(lm, toks[:20])
    tw = jquality.capture_trace(jax_lms[name], toks[:20])
    assert sorted(tg) == sorted(tw)
    for k in tw:
        assert _rel_l2(tg[k], tw[k]) <= REL_L2, k
