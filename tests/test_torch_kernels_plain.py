"""The plain PyTorch versions of the port's CUDA kernels against the JAX package.

K1/K2 (`ops/cuda/quant_matmul.py`) and K3 (`ops/cuda/flash_attention.py`)
take their plain version for a CPU tensor; these tests hold that version
against the JAX package's XLA reference and against its Pallas kernels run
in interpret mode, with the same inputs made by a seeded numpy generator.
The CUDA kernels themselves are held against the same plain versions on
the card by `chip_smoke.py`.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uzu_tpu.ops.attention import attention_reference as jax_attention
from uzu_tpu.ops.linear import _xla_quant_matmul
from uzu_tpu.ops.pallas.flash_attention import flash_attention as jax_flash
from uzu_tpu.ops.pallas.quant_matmul import quant_matmul_pallas
from uzu_tpu.quant import format as jq
from uzu_tpu_torch.ops import attention as tattn
from uzu_tpu_torch.ops import linear as tlinear
from uzu_tpu_torch.ops.cuda import build
from uzu_tpu_torch.ops.cuda.flash_attention import flash_attention, supported
from uzu_tpu_torch.ops.cuda.quant_matmul import quant_matmul
from uzu_tpu_torch.quant import format as tq

torch.set_num_threads(1)

METHODS = ["scale_symmetric", "scale_bias", "scale_zero_point"]


def _weights(seed, n, k, bits, g, method):
    w = np.random.default_rng(seed).standard_normal((n, k), dtype=np.float32) * 0.1
    parts = jq.quantize_reference(w, bits, g, method, dtype=np.float32)
    kw = dict(zero_points=parts.get("zero_points"), biases=parts.get("biases"))
    qj = jq.from_disk_tensors(method, parts["weights"], parts["scales"], bits, g,
                              dtype=jnp.float32, **kw)
    qt = tq.from_disk_tensors(method, parts["weights"], parts["scales"], bits, g,
                              dtype=torch.float32, **kw)
    return qj, qt


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("g", [32, 64, 128])
@pytest.mark.parametrize("m", [1, 5, 16])
def test_quant_matmul_plain_matches_xla(bits, g, m):
    method = METHODS[(bits + g) % 3]
    qj, qt = _weights(g + m, 200, 512, bits, g, method)  # N=200: not a tile multiple
    x = np.random.default_rng(m).standard_normal((m, 512), dtype=np.float32)
    want = np.asarray(_xla_quant_matmul(qj, jnp.asarray(x)))
    got = quant_matmul(qt, torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == (m, 200)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("m", [1, 16])
def test_quant_matmul_plain_matches_pallas_interpret(bits, method, m):
    qj, qt = _weights(bits * 7 + m, 256, 512, bits, 32, method)
    x = np.random.default_rng(m).standard_normal((m, 512), dtype=np.float32)
    want = np.asarray(quant_matmul_pallas(qj, jnp.asarray(x), interpret=True))
    got = quant_matmul(qt, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-3, atol=1e-3)


def test_quant_matmul_3d_input_folds_rows():
    qj, qt = _weights(3, 256, 512, 4, 32, "scale_symmetric")
    x = np.random.default_rng(3).standard_normal((2, 3, 512), dtype=np.float32)
    want = np.asarray(jnp.einsum("abk,nk->abn", jnp.asarray(x), jq.dequantize(qj, jnp.float32)))
    got = tlinear.linear_apply(qt, torch.from_numpy(x))
    assert got.shape == (2, 3, 256)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


def test_quant_matmul_bf16_activations_round_like_jax():
    """linear_apply returns the activation dtype, as the JAX package does."""
    qj, qt = _weights(4, 64, 256, 4, 32, "scale_symmetric")
    x = np.random.default_rng(4).standard_normal((3, 256), dtype=np.float32)
    got = tlinear.linear_apply(qt, torch.from_numpy(x).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16
    want = np.asarray(_xla_quant_matmul(qj, jnp.asarray(x)))
    np.testing.assert_allclose(got.float().numpy(), want, rtol=1e-2, atol=1e-2)


def test_cpu_tensors_launch_nothing_and_other_devices_raise():
    _, qt = _weights(5, 64, 256, 4, 32, "scale_symmetric")
    before = dict(build.LAUNCHES)
    quant_matmul(qt, torch.zeros((1, 256)))
    assert build.LAUNCHES == before
    with pytest.raises(ValueError):
        quant_matmul(qt, torch.zeros((1, 256), device="meta"))
    with pytest.raises(ValueError):
        quant_matmul(qt, torch.zeros((1, 128)))


# -- flash attention (K3) ------------------------------------------------------------

def _attn_case(seed, s=64, h=8, g=2, dh=32, c=256, pos0=40):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((s, h, dh)).astype(np.float32)
    k = rng.standard_normal((c, g, dh)).astype(np.float32)
    v = rng.standard_normal((c, g, dh)).astype(np.float32)
    pos = np.arange(s, dtype=np.int32) + pos0
    return q, k, v, pos


def _variant(name, h):
    if name == "window":
        return {"sliding_window_size": 37}
    if name == "softcap":
        return {"logit_soft_cap": 20.0}
    if name == "sinks":
        return {"sinks": np.random.default_rng(1).standard_normal(h).astype(np.float32)}
    return {}


VARIANTS = ["plain", "window", "softcap", "sinks"]


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("pos0", [0, 40, 150])
def test_flash_plain_matches_attention_reference(variant, pos0):
    q, k, v, pos = _attn_case(7 + pos0, pos0=pos0)
    kw = _variant(variant, q.shape[1])
    scale = q.shape[-1] ** -0.5
    want = np.asarray(jax_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(pos), scale=scale,
        **{a: jnp.asarray(b) if isinstance(b, np.ndarray) else b for a, b in kw.items()}))
    got = flash_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), torch.from_numpy(pos),
        scale=scale,
        **{a: torch.from_numpy(b) if isinstance(b, np.ndarray) else b for a, b in kw.items()})
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("variant", VARIANTS)
def test_flash_plain_matches_pallas_interpret(variant):
    """The JAX kernel rounds q, k, p and v to bf16 inside its accumulate
    step even in interpret mode, hence 2e-2 (its own tests' tolerance)."""
    q, k, v, pos = _attn_case(11, s=32, c=128, pos0=60)
    kw = _variant(variant, q.shape[1])
    scale = q.shape[-1] ** -0.5
    want = np.asarray(jax_flash(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(pos), scale=scale,
        interpret=True,
        **{a: jnp.asarray(b) if isinstance(b, np.ndarray) else b for a, b in kw.items()}))
    got = flash_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), torch.from_numpy(pos),
        scale=scale,
        **{a: torch.from_numpy(b) if isinstance(b, np.ndarray) else b for a, b in kw.items()})
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("variant", ["window", "sinks", "window_sinks"])
@pytest.mark.parametrize("pos0", [0, 150])
def test_flash_plain_matches_jax_at_gptoss_heads(variant, pos0):
    """gpt-oss's attention shape: 8 query heads per KV group (H 16 over G 2
    here), Dh 64, its window of 128 and sinks. The XLA reference at 1e-4;
    the Pallas kernel in interpret mode at its own 2e-2 (bf16 q, k, p, v)."""
    q, k, v, pos = _attn_case(3 + pos0, s=32, h=16, g=2, dh=64, c=256, pos0=pos0)
    kw = {}
    if "window" in variant:
        kw["sliding_window_size"] = 128
    if "sinks" in variant:
        kw["sinks"] = np.random.default_rng(pos0).standard_normal(16).astype(np.float32)
    jkw = {a: jnp.asarray(b) if isinstance(b, np.ndarray) else b for a, b in kw.items()}
    args = [jnp.asarray(a) for a in (q, k, v, pos)]
    ref = np.asarray(jax_attention(*args, scale=0.125, **jkw))
    interp = np.asarray(jax_flash(*args, scale=0.125, interpret=True, **jkw))
    got = flash_attention(
        *[torch.from_numpy(a) for a in (q, k, v, pos)], scale=0.125,
        **{a: torch.from_numpy(b) if isinstance(b, np.ndarray) else b for a, b in kw.items()})
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got.numpy(), interp, rtol=2e-2, atol=2e-2)


def test_flash_gate_is_semantic_only():
    kw = dict(is_causal=True, suffix_mask=None, kv_valid_length=None)
    assert supported(16, 8, 2, 32, 100, **kw)  # ragged C and S are fine now
    assert not supported(8, 8, 2, 32, 128, **kw)  # 32 rows < FLASH_MIN_ROWS
    assert not supported(64, 8, 2, 32, 128, **dict(kw, is_causal=False))
    assert not supported(64, 8, 2, 32, 128, **dict(kw, kv_valid_length=3))
    assert not supported(64, 8, 2, 32, 128, kv_positions=object(), **kw)


@pytest.mark.parametrize("s", [1, 8, 16, 64])
@pytest.mark.parametrize("c", [128, 1024])
def test_attention_dispatch_matches_jax(s, c):
    """The port's attention entry point (flash for s*rep >= 64, einsum or
    online softmax below) equals the JAX package's default path."""
    q, k, v, pos = _attn_case(s + c, s=s, c=c, pos0=c // 2)
    scale = q.shape[-1] ** -0.5
    want = np.asarray(jax_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                    jnp.asarray(pos), scale=scale))
    got = tattn.attention_reference(torch.from_numpy(q), torch.from_numpy(k),
                                    torch.from_numpy(v), torch.from_numpy(pos), scale=scale)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


def test_online_attention_matches_einsum_with_window_and_sinks():
    q, k, v, pos = _attn_case(21, s=64, c=2048, pos0=1500)
    sinks = torch.from_numpy(np.random.default_rng(2).standard_normal(8).astype(np.float32))
    args = [torch.from_numpy(a) for a in (q, k, v, pos)]
    kw = dict(scale=0.2, sliding_window_size=300, sinks=sinks, is_causal=False,
              kv_valid_length=1560)
    online = tattn.attention_online(*args, **kw)
    want = np.asarray(jax_attention(*[jnp.asarray(a) for a in (q, k, v, pos)],
                                    **dict(kw, sinks=jnp.asarray(sinks.numpy()))))
    np.testing.assert_allclose(online.numpy(), want, rtol=1e-4, atol=1e-4)


def test_cuda_wrappers_reject_mismatched_shapes_before_launch(monkeypatch):
    """Shape checks run before any build or launch (no card needed)."""
    _, qt = _weights(6, 64, 256, 4, 32, "scale_symmetric")
    bad = tq.QuantizedTensor(qt.codes, qt.scales[:, :4], None, 4, 32, qt.qbias_coeff)
    x = torch.zeros((1, 256))
    monkeypatch.setattr(torch.Tensor, "device", property(lambda t: torch.device("cuda")))
    with pytest.raises(ValueError, match="scales/qbias"):
        quant_matmul(bad, x)
    q = torch.zeros((16, 8, 64))
    k = torch.zeros((128, 2, 64))
    with pytest.raises(ValueError, match="do not fit"):
        flash_attention(q, k, torch.zeros((128, 2, 32)), torch.arange(16), scale=0.1)
