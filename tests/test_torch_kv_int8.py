"""The port's INT8 KV cache and kernel K4 against the JAX package, on the CPU.

`models/kv_cache.py`'s INT8 layout (codes [C, G, Dh] int8 + one f32 scale
per (slot, kv-head)) must write the JAX package's codes exactly; K4's plain
version (`ops/cuda/flash_attention.py` with `k_scales`/`v_scales`) is held
against the JAX flash kernel in interpret mode and against the XLA
reference on the dequantized cache; and a tiny model with `kv_quant=True`
runs through both packages. Inputs come from seeded numpy generators.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uzu_tpu import LanguageModel as JaxLM
from uzu_tpu.models import kv_cache as jkv
from uzu_tpu.models.decoder import decoder_forward as jax_forward
from uzu_tpu.ops.attention import attention_reference as jax_attention
from uzu_tpu.ops.pallas.flash_attention import flash_attention as jax_flash
from uzu_tpu_torch import LanguageModel
from uzu_tpu_torch.models import kv_cache as tkv
from uzu_tpu_torch.models.decoder import decoder_forward
from uzu_tpu_torch.ops import attention as tattn
from uzu_tpu_torch.ops.cuda import build
from uzu_tpu_torch.ops.cuda.flash_attention import flash_attention
from uzu_tpu_torch.tools.synth import llama_config, synthesize

torch.set_num_threads(1)


# -- the INT8 layout -----------------------------------------------------------------

@pytest.mark.parametrize("shape", [(5, 2, 16), (64, 8, 64), (3, 4, 128)])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_quantize_rows_codes_equal_jax(shape, dtype):
    x = np.random.default_rng(sum(shape)).standard_normal(shape).astype(np.float32) * 3
    x[0, 0] = 0.0  # an all-zero row takes scale 1
    x[-1, -1, :4] = 127.5 / 3  # ties at the rounding step
    xj, xt = jnp.asarray(x), torch.from_numpy(x)
    if dtype == "bf16":
        xj, xt = xj.astype(jnp.bfloat16), xt.to(torch.bfloat16)
    cj, sj = jkv._quantize_rows(xj)
    ct, st = tkv.quantize_rows(xt)
    assert ct.dtype == torch.int8 and st.dtype == torch.float32
    np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
    # scales: the same f32 division, equal to one ulp
    np.testing.assert_array_max_ulp(st.numpy(), np.asarray(sj), maxulp=1)


@pytest.mark.parametrize("pos0,s", [(0, 16), (37, 5), (120, 16)])
def test_quantized_append_and_read_match_jax(pos0, s):
    """Rows written at pos0 (the start clamped so a chunk fits, as
    dynamic_update_slice does) read back dequantized as the JAX cache's."""
    rng = np.random.default_rng(pos0 + s)
    c, g, dh = 128, 2, 32
    k = rng.standard_normal((s, g, dh)).astype(np.float32)
    v = rng.standard_normal((s, g, dh)).astype(np.float32)
    pos = np.arange(s, dtype=np.int32) + pos0
    jc = jkv.append(jkv.make_cache(g, dh, c, quantized=True), jnp.asarray(k), jnp.asarray(v),
                    jnp.asarray(pos))
    tc = tkv.append(tkv.make_cache(g, dh, c, quantized=True), torch.from_numpy(k),
                    torch.from_numpy(v), torch.from_numpy(pos))
    assert tkv.is_quantized(tc) and sorted(tc) == sorted(jc)
    for name in ("k_q", "v_q", "k_s", "v_s"):
        np.testing.assert_array_equal(tc[name].numpy(), np.asarray(jc[name]))
    for got, want in zip(tkv.read(tc)[:2], jkv.read(jc)[:2]):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# -- K4: flash attention over INT8 codes -----------------------------------------------

def _case(seed, s=32, h=8, g=2, dh=32, c=128, pos0=60):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((s, h, dh)).astype(np.float32)
    k = rng.standard_normal((c, g, dh)).astype(np.float32)
    v = rng.standard_normal((c, g, dh)).astype(np.float32)
    kq, ks = jkv._quantize_rows(jnp.asarray(k))
    vq, vs = jkv._quantize_rows(jnp.asarray(v))
    pos = np.arange(s, dtype=np.int32) + pos0
    return q, [np.array(a) for a in (kq, ks, vq, vs)], pos


VARIANTS = {
    "plain": {},
    "window": {"sliding_window_size": 37},
    "softcap": {"logit_soft_cap": 20.0},
    "sinks": {"sinks": np.random.default_rng(1).standard_normal(8).astype(np.float32)},
}


def _kw(variant, to):
    return {a: to(b) if isinstance(b, np.ndarray) else b for a, b in VARIANTS[variant].items()}


def _port_k4(q, quant, pos, variant):
    kq, ks, vq, vs = (torch.from_numpy(a) for a in quant)
    return flash_attention(torch.from_numpy(q), kq, vq, torch.from_numpy(pos),
                           scale=q.shape[-1] ** -0.5, k_scales=ks, v_scales=vs,
                           **_kw(variant, torch.from_numpy))


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_k4_plain_matches_pallas_interpret(variant):
    """The JAX kernel (the case of its own INT8 test) rounds q, k, p and v
    to bf16 inside its accumulate step: its tests' 2e-2."""
    q, quant, pos = _case(11)
    kq, ks, vq, vs = (jnp.asarray(a) for a in quant)
    want = np.asarray(jax_flash(jnp.asarray(q), kq, vq, jnp.asarray(pos),
                                scale=q.shape[-1] ** -0.5, k_scales=ks, v_scales=vs,
                                interpret=True, **_kw(variant, jnp.asarray)))
    got = _port_k4(q, quant, pos, variant)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("pos0", [0, 60, 96])
def test_k4_plain_matches_reference_on_dequantized_cache(variant, pos0):
    q, quant, pos = _case(3 + pos0, pos0=pos0)
    kq, ks, vq, vs = quant
    k = kq.astype(np.float32) * ks[..., None]
    v = vq.astype(np.float32) * vs[..., None]
    want = np.asarray(jax_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                    jnp.asarray(pos), scale=q.shape[-1] ** -0.5,
                                    **_kw(variant, jnp.asarray)))
    got = _port_k4(q, quant, pos, variant)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("s", [1, 8, 16, 64])
def test_attention_dispatch_with_scales_matches_dequantized(s):
    """attention_reference takes INT8 codes + scales: K4 where the flash
    gate holds (s * rep >= 64), the dequantized einsum path below it."""
    q, quant, pos = _case(s, s=s, c=256, pos0=100)
    kq, ks, vq, vs = quant
    k = kq.astype(np.float32) * ks[..., None]
    v = vq.astype(np.float32) * vs[..., None]
    want = np.asarray(jax_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                    jnp.asarray(pos), scale=0.2))
    kq, ks, vq, vs = (torch.from_numpy(a) for a in quant)
    got = tattn.attention_reference(torch.from_numpy(q), kq, vq, torch.from_numpy(pos),
                                    scale=0.2, k_scales=ks, v_scales=vs)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_k4_wrapper_checks_before_launch(monkeypatch):
    """CPU tensors launch nothing; on a CUDA tensor, int8 K/V without both
    scale tensors, or scales of the wrong shape, raise before any build."""
    q, quant, pos = _case(5, dh=64)
    before = dict(build.LAUNCHES)
    _port_k4(q, quant, pos, "plain")
    assert build.LAUNCHES == before
    kq, ks, vq, vs = (torch.from_numpy(a) for a in quant)
    qt, pt = torch.from_numpy(q), torch.from_numpy(pos)
    monkeypatch.setattr(torch.Tensor, "device", property(lambda t: torch.device("cuda")))
    with pytest.raises(ValueError, match="int8"):
        flash_attention(qt, kq, vq, pt, scale=0.1)
    with pytest.raises(ValueError, match="k_scales"):
        flash_attention(qt, kq, vq, pt, scale=0.1, k_scales=ks)
    with pytest.raises(ValueError, match="scales must be"):
        flash_attention(qt, kq, vq, pt, scale=0.1, k_scales=ks[:4], v_scales=vs)


# -- a model with kv_quant=True ------------------------------------------------------

TINY = dict(num_layers=2, model_dim=64, hidden_dim=160, num_heads=8, num_groups=2,
            head_dim=32, vocab_size=256)


@pytest.fixture(scope="module")
def int8_models(tmp_path_factory):
    d = synthesize(llama_config(**TINY), str(tmp_path_factory.mktemp("kv_int8")), seed=13,
                   dtype=np.float32)
    return (JaxLM.from_dir(d, max_context=256, prefill_buckets=(16, 64), kv_quant=True),
            LanguageModel.from_dir(d, device="cpu", max_context=256, prefill_buckets=(16, 64),
                                   kv_quant=True))


def test_int8_state_layout(int8_models):
    _, lm = int8_models
    layer = lm.new_state()["layers"][0]
    assert sorted(layer) == ["k_q", "k_s", "v_q", "v_s"]
    assert layer["k_q"].dtype == torch.int8 and layer["k_s"].shape == (256, 2)


@pytest.mark.parametrize("n", [12, 40])
def test_int8_teacher_forced_logits_match_jax(int8_models, n):
    """40 tokens x 4 heads per group take K4's plain version; 12 stay on
    the dequantized einsum path."""
    jlm, lm = int8_models
    toks = (np.arange(n) * 37 + 5) % TINY["vocab_size"]
    want, _ = jax_forward(jlm.decoder_config, jlm.params, jnp.asarray(toks, jnp.int32),
                          jlm.new_state(), last_only=False)
    got, _ = decoder_forward(lm.decoder_config, lm.params, torch.as_tensor(toks),
                             lm.new_state(), last_only=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


def test_int8_greedy_stream_matches_jax(int8_models):
    jlm, lm = int8_models
    toks = (np.arange(70) * 101 + 3) % TINY["vocab_size"]
    got = lm.generate_list(toks, 12, stop_token_ids=[])
    assert len(got) == 12
    assert jlm.generate_list(toks, 12, stop_token_ids=[]) == got
