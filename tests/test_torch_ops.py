"""Parity of the PyTorch port's host-side ops with the JAX package, on the CPU.

Inputs come from a seeded numpy generator and go through both packages in
f32. Covers normalization, RoPE (every scaling), activations, the three
dequantization methods, the sampling masks, the port's import isolation
and its refusal to fall back to the CPU silently.
"""

import ast
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uzu_tpu.config import model as jcm
from uzu_tpu.engine import sampling as jsamp
from uzu_tpu.ops import activation as jact
from uzu_tpu.ops import norm as jnorm
from uzu_tpu.ops import rope as jrope
from uzu_tpu.quant import format as jq
from uzu_tpu_torch.config import model as tcm
from uzu_tpu_torch.engine import sampling as tsamp
from uzu_tpu_torch.ops import activation as tact
from uzu_tpu_torch.ops import norm as tnorm
from uzu_tpu_torch.ops import rope as trope
from uzu_tpu_torch.quant import format as tq

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-6


def _pair(cls_name, **kw):
    """The same config in both packages."""
    return getattr(jcm, cls_name)(**kw), getattr(tcm, cls_name)(**kw)


def _close(got_t, want_j, tol=TOL):
    np.testing.assert_allclose(got_t.numpy(), np.asarray(want_j), rtol=tol, atol=tol)


# -- normalization -------------------------------------------------------------

NORMS = [
    dict(epsilon=1e-5, scale_offset=None, upcast_mode="only_normalization",
         subtract_mean=False, has_biases=False),
    dict(epsilon=1e-6, scale_offset=1.0, upcast_mode="full_layer",
         subtract_mean=False, has_biases=False),
    dict(epsilon=1e-5, scale_offset=None, upcast_mode="full_layer",
         subtract_mean=True, has_biases=True),
]


@pytest.mark.parametrize("case", range(len(NORMS)))
@pytest.mark.parametrize("with_scales", [True, False])
def test_normalize_matches_jax(case, with_scales):
    rng = np.random.default_rng(case)
    kw = dict(NORMS[case])
    jcfg = jcm.NormalizationConfig(**dict(kw, upcast_mode=jcm.UpcastMode(kw["upcast_mode"])))
    tcfg = tcm.NormalizationConfig(**dict(kw, upcast_mode=tcm.UpcastMode(kw["upcast_mode"])))
    x = rng.standard_normal((5, 3, 64)).astype(np.float32) * 3
    scales = (1 + 0.1 * rng.standard_normal(64)).astype(np.float32) if with_scales else None
    biases = (0.1 * rng.standard_normal(64)).astype(np.float32) if kw["has_biases"] else None
    want = jnorm.normalize(jnp.asarray(x), jcfg,
                           None if scales is None else jnp.asarray(scales),
                           None if biases is None else jnp.asarray(biases))
    got = tnorm.normalize(torch.from_numpy(x), tcfg,
                          None if scales is None else torch.from_numpy(scales),
                          None if biases is None else torch.from_numpy(biases))
    _close(got, want)


# -- RoPE ------------------------------------------------------------------------

ROPES = {
    "unscaled": ("UnscaledRoPEConfig", dict(base=10000.0, max_sequence_length=2048)),
    "linear": ("LinearScalingRoPEConfig", dict(base=10000.0, max_sequence_length=4096,
                                                scaling_factor=4.0)),
    "llama3": ("LlamaRoPEConfig", dict(base=500000.0, max_sequence_length=8192,
                                       scaling_factor=32.0, original_context_length=8192,
                                       low_frequency_factor=1.0, high_frequency_factor=4.0)),
    "yarn": ("YARNRoPEConfig", dict(base=10000.0, max_sequence_length=32768,
                                    scaling_factor=4.0, original_context_length=4096,
                                    beta_fast=32.0, beta_slow=1.0, truncate=True)),
    "yarn_untruncated": ("YARNRoPEConfig", dict(base=10000.0, max_sequence_length=32768,
                                                scaling_factor=4.0, original_context_length=4096,
                                                beta_fast=32.0, beta_slow=1.0, truncate=False)),
    "longrope_short": ("LongRoPEConfig", dict(base=10000.0, max_sequence_length=4096,
                                              short_factor=tuple(1.0 + 0.1 * i for i in range(32)),
                                              long_factor=tuple(2.0 + 0.1 * i for i in range(32)),
                                              original_context_length=4096, scaling_factor=8.0)),
    "longrope_long": ("LongRoPEConfig", dict(base=10000.0, max_sequence_length=131072,
                                             short_factor=tuple(1.0 + 0.1 * i for i in range(32)),
                                             long_factor=tuple(2.0 + 0.1 * i for i in range(32)),
                                             original_context_length=4096, scaling_factor=32.0)),
}


@pytest.mark.parametrize("name", sorted(ROPES))
def test_rope_matches_jax(name):
    cls, kw = ROPES[name]
    jcfg, tcfg = _pair(cls, head_dim=64, **kw)
    inv_j, scale_j = jrope.inverse_frequencies(jcfg)
    inv_t, scale_t = trope.inverse_frequencies(tcfg)
    np.testing.assert_array_equal(inv_t, inv_j)
    assert scale_t == scale_j
    rng = np.random.default_rng(3)
    pos = np.array([0, 1, 7, 100, 4095, 20000], np.int32)
    x = rng.standard_normal((len(pos), 4, 64)).astype(np.float32)
    cj, sj = jrope.rope_tables(jnp.asarray(inv_j), scale_j, jnp.asarray(pos))
    ct, st = trope.rope_tables(torch.from_numpy(inv_t), scale_t, torch.from_numpy(pos))
    _close(ct, cj)
    _close(st, sj)
    want = jrope.apply_rope(jnp.asarray(x), cj, sj)
    got = trope.apply_rope(torch.from_numpy(x), torch.from_numpy(np.array(cj)),
                           torch.from_numpy(np.array(sj)))
    _close(got, want)


def test_partial_rotary_matches_jax():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((6, 2, 64)).astype(np.float32)
    cos = rng.standard_normal((6, 16)).astype(np.float32)
    sin = rng.standard_normal((6, 16)).astype(np.float32)
    want = jrope.apply_rope(jnp.asarray(x), jnp.asarray(cos), jnp.asarray(sin))
    got = trope.apply_rope(torch.from_numpy(x), torch.from_numpy(cos), torch.from_numpy(sin))
    _close(got, want)


# -- activations -------------------------------------------------------------------

ACTS = {
    "silu": ("SiLU", dict(alpha=1.0)),
    "silu_alpha": ("SiLU", dict(alpha=1.702)),
    "gelu_tanh": ("GELU", dict(approximate=True)),
    "gelu_exact": ("GELU", dict(approximate=False)),
    "identity": ("Identity", {}),
}


@pytest.mark.parametrize("name", sorted(ACTS))
@pytest.mark.parametrize("clipping", [None, ((-7.0, 7.0), (None, 1.5))])
def test_gated_act_mul_matches_jax(name, clipping):
    cls, kw = ACTS[name]
    jcfg, tcfg = _pair(cls, **kw)
    rng = np.random.default_rng(5)
    gate = rng.standard_normal((7, 96)).astype(np.float32) * 4
    up = rng.standard_normal((7, 96)).astype(np.float32)
    gc, uc = clipping if clipping else (None, None)
    want = jact.gated_act_mul(jcfg, jnp.asarray(gate), jnp.asarray(up), gc, uc)
    got = tact.gated_act_mul(tcfg, torch.from_numpy(gate), torch.from_numpy(up), gc, uc)
    _close(got, want)


# -- dequantization ------------------------------------------------------------------

@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("method", ["scale_symmetric", "scale_bias", "scale_zero_point"])
@pytest.mark.parametrize("scale_dtype", ["bf16", "f32"])
def test_dequantize_matches_jax_exactly(bits, method, scale_dtype):
    rng = np.random.default_rng(bits)
    w = rng.standard_normal((48, 192)).astype(np.float32) * 0.1
    jdt, tdt = ((jnp.bfloat16, torch.bfloat16) if scale_dtype == "bf16"
                else (jnp.float32, torch.float32))
    parts_j = jq.quantize_reference(w, bits, 32, method)
    parts_t = tq.quantize_reference(w, bits, 32, method)
    for key in parts_j:  # the port's quantizer writes the same bytes
        assert np.asarray(parts_j[key]).tobytes() == parts_t[key].tobytes(), key
    qj = jq.from_disk_tensors(method, parts_j["weights"], parts_j["scales"], bits, 32,
                              zero_points=parts_j.get("zero_points"),
                              biases=parts_j.get("biases"), dtype=jdt)
    qt = tq.from_disk_tensors(method, parts_t["weights"], parts_t["scales"], bits, 32,
                              zero_points=parts_t.get("zero_points"),
                              biases=parts_t.get("biases"), dtype=tdt)
    assert (qt.qbias is None) == (method == "scale_symmetric")
    want = np.asarray(jq.dequantize(qj, jnp.float32))
    got = tq.dequantize(qt, torch.float32).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("bits", [4, 8])
def test_pack_unpack_roundtrip(bits):
    rng = np.random.default_rng(6)
    codes = rng.integers(0, 1 << bits, size=(4, 64), dtype=np.uint8)
    packed = tq.pack_codes(codes, bits)
    np.testing.assert_array_equal(packed, jq.pack_codes(codes, bits))
    np.testing.assert_array_equal(tq.unpack_codes(torch.from_numpy(packed), bits).numpy(), codes)
    if bits == 4:  # low nibble = even k
        assert packed[0, 0] == codes[0, 0] | (codes[0, 1] << 4)


# -- sampling --------------------------------------------------------------------------

def _logits(seed, v=512):
    return np.random.default_rng(seed).standard_normal(v).astype(np.float32) * 3


@pytest.mark.parametrize("seed", range(4))
def test_greedy_sample_matches_jax(seed):
    logits = _logits(seed)
    ring = np.array([-1, 3, int(np.argmax(logits)), 7], np.int32)
    for params in (jsamp.SamplingParams(),
                   jsamp.SamplingParams(repetition_penalty=1.3),
                   jsamp.SamplingParams(banned_tokens=(int(np.argmax(logits)),))):
        tparams = tsamp.SamplingParams(**params.__dict__)
        want = int(jsamp.sample(jnp.asarray(logits), params, ring=jnp.asarray(ring)))
        got = int(tsamp.sample(torch.from_numpy(logits), tparams, ring=torch.from_numpy(ring)))
        assert got == want


@pytest.mark.parametrize("k", [1, 5, 50])
def test_top_k_mask_matches_jax(k):
    logits = _logits(10 + k)
    want = np.asarray(jsamp._mask_top_k(jnp.asarray(logits), k))
    got = tsamp._mask_top_k(torch.from_numpy(logits), k).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("p", [0.1, 0.5, 0.9])
def test_top_p_mask_matches_jax(p):
    logits = _logits(20)
    want = np.asarray(jsamp._mask_top_p(jnp.asarray(logits), p))
    got = tsamp._mask_top_p(torch.from_numpy(logits), p).numpy()
    np.testing.assert_array_equal(got <= -1e29, want <= -1e29)
    np.testing.assert_array_equal(got[got > -1e29], want[want > -1e29])


@pytest.mark.parametrize("min_p", [0.05, 0.3])
def test_min_p_mask_matches_jax(min_p):
    logits = _logits(30)
    want = np.asarray(jsamp._mask_min_p(jnp.asarray(logits), min_p))
    got = tsamp._mask_min_p(torch.from_numpy(logits), min_p).numpy()
    np.testing.assert_array_equal(got, want)


def test_repetition_penalty_matches_jax():
    logits = _logits(40)
    ring = np.array([-1, 0, 5, 5, 300], np.int32)
    want = np.asarray(jsamp.apply_repetition_penalty(jnp.asarray(logits), jnp.asarray(ring), 1.5))
    got = tsamp.apply_repetition_penalty(torch.from_numpy(logits), torch.from_numpy(ring), 1.5)
    np.testing.assert_array_equal(got.numpy(), want)


def test_sampled_tokens_respect_masks_and_seed():
    logits = torch.from_numpy(_logits(50))
    params = tsamp.SamplingParams(temperature=0.8, top_k=5)
    allowed = set(torch.topk(logits, 5).indices.tolist())
    draws = [int(tsamp.sample(logits, params, generator=torch.Generator().manual_seed(s)))
             for s in range(64)]
    assert set(draws) <= allowed and len(set(draws)) > 1
    again = [int(tsamp.sample(logits, params, generator=torch.Generator().manual_seed(s)))
             for s in range(64)]
    assert draws == again


def test_push_ring_matches_jax():
    ring = np.array([-1, 2, 3], np.int32)
    want = np.asarray(jsamp.push_ring(jnp.asarray(ring), jnp.asarray(9, jnp.int32)))
    got = tsamp.push_ring(torch.from_numpy(ring), torch.tensor(9)).numpy()
    np.testing.assert_array_equal(got, want)


# -- isolation and device policy ---------------------------------------------------------

FORBIDDEN = ("jax", "jaxlib", "ml_dtypes", "uzu_tpu")


def _port_sources():
    root = os.path.join(REPO, "uzu_tpu_torch")
    for d, _, files in os.walk(root):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)
    yield os.path.join(REPO, "chip_smoke.py")


def test_port_sources_import_no_jax():
    bad = []
    for path in _port_sources():
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
                names = [node.module]
            bad += [(path, n) for n in names if n.split(".")[0] in FORBIDDEN]
    assert not bad, bad


def test_import_loads_no_jax_module():
    code = ("import sys, uzu_tpu_torch, uzu_tpu_torch.convert, uzu_tpu_torch.tools.synth; "
            "import uzu_tpu_torch.ops.cuda.build, uzu_tpu_torch.engine.paged_batch; "
            f"bad = [m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r}]; "
            "print(bad); sys.exit(1 if bad else 0)")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_default_device_is_the_card(monkeypatch, tmp_path):
    from uzu_tpu_torch import LanguageModel
    from uzu_tpu_torch.runtime import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LanguageModel.from_dir(str(tmp_path))
    assert resolve_device("cpu").type == "cpu"
