"""The split-KV route of K3/K4 (`ops/cuda/flash_attention.py`) on the CPU.

Where one block per (KV group, 64-row tile) cannot fill the card, the CUDA
kernel cuts the KV tiles into `split_plan` ranges, writes each range's
unnormalized (m, l, acc) and merges them in a fixed order. These tests hold
the plan and the plain versions of the two halves (`flash_partials_plain`,
`flash_combine_plain`) against `flash_attention_plain` and against the JAX
kernel in interpret mode, with inputs made by a seeded numpy generator. The
kernel itself is held against `flash_attention_plain` on the card by
`chip_smoke.py`.
"""

import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uzu_tpu.ops.pallas.flash_attention import flash_attention as jax_flash
from uzu_tpu_torch.models.kv_cache import quantize_rows
from uzu_tpu_torch.ops.cuda import build
from uzu_tpu_torch.ops.cuda.flash_attention import (
    BK,
    BQ,
    flash_attention_plain,
    flash_combine_plain,
    flash_partials_plain,
    split_plan,
)

torch.set_num_threads(1)

SMS = 132  # the H100's SM count


def _case(seed, s, h, g, dh, c):
    rng = np.random.default_rng(seed)
    q = torch.from_numpy(rng.standard_normal((s, h, dh)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((c, g, dh)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((c, g, dh)).astype(np.float32))
    sinks = torch.from_numpy(rng.standard_normal(h).astype(np.float32))
    return q, k, v, sinks


def _variant(name, sinks):
    return {"plain": {}, "window": {"sliding_window_size": 100},
            "softcap": {"logit_soft_cap": 20.0}, "sinks": {"sinks": sinks}}[name]


def _ranges(s, h, g, c):
    n, per = split_plan(s, h, g, c, SMS)
    return [(z * per * BK, min(c, (z + 1) * per * BK)) for z in range(n)]


def _split_route(q, k, v, qpos, *, scale, sinks=None, **kw):
    """What the kernel computes on its split route, in plain PyTorch."""
    s, h, _ = q.shape
    c, g, _ = k.shape
    parts = [flash_partials_plain(q, k, v, qpos, scale=scale, begin=b, end=e, **kw)
             for b, e in _ranges(s, h, g, c)]
    m, l, acc = (torch.stack(t) for t in zip(*parts))
    return flash_combine_plain(m, l, acc, sinks)


# -- the plan --------------------------------------------------------------------------

@pytest.mark.parametrize("s,h,g,c", [
    (16, 32, 8, 4096), (16, 64, 8, 1024), (64, 32, 8, 4096), (256, 32, 8, 1024),
    (256, 64, 8, 4096), (1024, 32, 8, 4096), (16, 8, 2, 100), (16, 16, 2, 4096),
    (3, 8, 2, 64), (40, 24, 8, 777),
])
def test_split_plan_covers_the_cache_once_in_whole_tiles(s, h, g, c):
    n, per = split_plan(s, h, g, c, SMS)
    tiles = -(-c // BK)
    blocks = -(-s * (h // g) // BQ) * g
    ranges = _ranges(s, h, g, c)
    assert ranges[0][0] == 0 and ranges[-1][1] == c
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    assert all(b % BK == 0 and e > b for b, e in ranges)
    assert all(e - b == per * BK for b, e in ranges[:-1])
    if blocks >= SMS:
        assert n == 1
    else:
        assert n <= tiles and (blocks * n >= SMS or n == tiles)


def test_split_plan_takes_shapes_only():
    """The plan reads no tensor: pos0 stays on the device, the prefill
    needs no host sync, and a captured step keeps its launch."""
    assert list(inspect.signature(split_plan).parameters) == ["s", "h", "g", "c", "num_sms"]
    assert split_plan(256, 32, 8, 1024, SMS) == (2, 8)
    assert split_plan(16, 32, 8, 4096, SMS) == (22, 3)
    assert split_plan(512, 32, 8, 4096, SMS) == (1, 64)


# -- partials + fixed-order combine -------------------------------------------------------

@pytest.mark.parametrize("variant", ["plain", "window", "softcap", "sinks"])
@pytest.mark.parametrize("h,dh", [(8, 64), (16, 128), (8, 32)])
def test_split_route_equals_flash_plain(variant, h, dh):
    """rep 4 (H 8 over G 2) and rep 8 (H 16), a 16-row chunk at the end of
    a 2048-slot cache: many ranges, all but the window's edge ones full."""
    s, g, c = 16, 2, 2048
    q, k, v, sinks = _case(h + dh, s, h, g, dh, c)
    qpos = torch.arange(s, dtype=torch.int32) + c - s - 3
    kw = _variant(variant, sinks)
    assert len(_ranges(s, h, g, c)) > 1
    want = flash_attention_plain(q, k, v, qpos, scale=dh ** -0.5, **kw)
    got = _split_route(q, k, v, qpos, scale=dh ** -0.5, **kw)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("h", [8, 16])
@pytest.mark.parametrize("variant", ["plain", "sinks"])
def test_split_route_at_pos0_zero_with_empty_ranges(h, variant):
    """pos0 = 0 over a 4096-slot cache: every range past the chunk's 16
    positions sees no key, writes m = -1e30 and l = 0, and drops out."""
    s, g, c, dh = 16, 2, 4096, 64
    q, k, v, sinks = _case(5 + h, s, h, g, dh, c)
    qpos = torch.arange(s, dtype=torch.int32)
    kw = _variant(variant, sinks)
    m, l, _ = flash_partials_plain(q, k, v, qpos, scale=0.125, begin=BK, end=2 * BK)
    assert bool((m == -1e30).all()) and bool((l == 0).all())
    want = flash_attention_plain(q, k, v, qpos, scale=0.125, **kw)
    got = _split_route(q, k, v, qpos, scale=0.125, **kw)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-5)


def test_combine_order_is_fixed():
    """The same partials merge to the same bits every time."""
    q, k, v, sinks = _case(9, 16, 8, 2, 64, 1024)
    qpos = torch.arange(16, dtype=torch.int32) + 1000
    a = _split_route(q, k, v, qpos, scale=0.125, sinks=sinks)
    b = _split_route(q, k, v, qpos, scale=0.125, sinks=sinks)
    assert torch.equal(a, b)


def test_sinks_folded_per_range_fail_the_comparison():
    """Sinks belong to the row once, after the merge: a kernel that folded
    them into every range would count each sink n times."""
    s, h, g, dh, c = 16, 8, 2, 64, 2048
    q, k, v, sinks = _case(13, s, h, g, dh, c)
    qpos = torch.arange(s, dtype=torch.int32) + c - s
    want = flash_attention_plain(q, k, v, qpos, scale=0.125, sinks=sinks)
    parts = [flash_partials_plain(q, k, v, qpos, scale=0.125, begin=b, end=e)
             for b, e in _ranges(s, h, g, c)]
    m, l, acc = (torch.stack(t) for t in zip(*parts))
    once = flash_combine_plain(m, l, acc, sinks)
    np.testing.assert_allclose(once.numpy(), want.numpy(), rtol=1e-5, atol=1e-5)
    # fold per range: each range's (m, l, acc) takes the sink as one more logit
    top = torch.maximum(m, sinks[None, None, :])
    corr = torch.exp(m - top)
    l_bad = l * corr + torch.exp(sinks[None, None, :] - top)
    bad = flash_combine_plain(top, l_bad, acc * corr[..., None])
    assert not np.allclose(bad.numpy(), want.numpy(), rtol=1e-3, atol=1e-3)


# -- K4: scales folded outside the products ------------------------------------------------

@pytest.mark.parametrize("variant", ["plain", "window", "softcap", "sinks"])
@pytest.mark.parametrize("split", [False, True])
def test_k4_folded_scales_equal_the_dequantized_plain_version(variant, split):
    """score = (q . code_k) * k_scale * scale and acc = sum p * v_scale *
    code_v equal attention over codes * scale."""
    s, h, g, dh, c = 16, 8, 2, 64, 1024
    q, k, v, sinks = _case(17, s, h, g, dh, c)
    kq, ks = quantize_rows(k)
    vq, vs = quantize_rows(v)
    qpos = torch.arange(s, dtype=torch.int32) + c - s - 1
    kw = _variant(variant, sinks)
    want = flash_attention_plain(q, kq, vq, qpos, scale=0.125, k_scales=ks, v_scales=vs, **kw)
    if split:
        got = _split_route(q, kq, vq, qpos, scale=0.125, k_scales=ks, v_scales=vs, **kw)
    else:
        m, l, acc = flash_partials_plain(q, kq, vq, qpos, scale=0.125, begin=0, end=c,
                                         k_scales=ks, v_scales=vs,
                                         **{a: b for a, b in kw.items() if a != "sinks"})
        got = flash_combine_plain(m[None], l[None], acc[None], kw.get("sinks"))
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-5)


# -- the whole against the JAX kernel --------------------------------------------------------

@pytest.mark.parametrize("variant", ["plain", "window", "sinks"])
@pytest.mark.parametrize("pos0", [0, 400])
def test_split_route_matches_pallas_interpret(variant, pos0):
    """The JAX kernel rounds q, k, p and v to bf16 inside its accumulate
    step even in interpret mode, hence its own tests' 2e-2."""
    s, h, g, dh, c = 16, 16, 2, 64, 512
    q, k, v, sinks = _case(23 + pos0, s, h, g, dh, c)
    qpos = torch.arange(s, dtype=torch.int32) + pos0
    kw = _variant(variant, sinks)
    jkw = {a: jnp.asarray(b.numpy()) if isinstance(b, torch.Tensor) else b for a, b in kw.items()}
    want = np.asarray(jax_flash(*[jnp.asarray(t.numpy()) for t in (q, k, v, qpos)],
                                scale=0.125, interpret=True, **jkw))
    got = _split_route(q, k, v, qpos, scale=0.125, **kw)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-2, atol=2e-2)


# -- head dim 32: the hybrids' attention layers ------------------------------------------

@pytest.mark.parametrize("variant", ["plain", "window", "softcap", "sinks"])
@pytest.mark.parametrize("quant", [False, True])
def test_split_halves_at_head_dim_32(variant, quant):
    """The hybrids' prefill shape (S=128 from position 0, 8 heads over 2
    groups, Dh 32, a 1024-slot context): 16 row blocks, so the plan splits
    the cache; the plain partials merged in order equal the whole, with
    INT8 codes and their scales as K4 folds them."""
    s, h, g, dh, c = 128, 8, 2, 32, 1024
    assert split_plan(s, h, g, c, SMS) == (16, 1)
    q, k, v, sinks = _case(31, s, h, g, dh, c)
    qpos = torch.arange(s, dtype=torch.int32)
    kw = _variant(variant, sinks)
    if quant:
        (k, ks), (v, vs) = quantize_rows(k), quantize_rows(v)
        kw.update(k_scales=ks, v_scales=vs)
    want = flash_attention_plain(q, k, v, qpos, scale=dh ** -0.5, **kw)
    got = _split_route(q, k, v, qpos, scale=dh ** -0.5, **kw)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-5)


def test_kernel_head_dims_cover_the_chip_models():
    """Every attention layer of every model `chip_smoke.py` synthesizes (the
    port's synthesizer at the chip shapes) has a head dim the K3/K4 kernel
    runs: up to 256 one it is built for, past it (the synthetic Dh-512
    models) the wide case of the Dh-256 layout; so a prefill chunk of any
    of them launches the kernel."""
    import chip_smoke

    from uzu_tpu_torch.config.model import AttentionConfig
    from uzu_tpu_torch.ops.cuda.flash_attention import _HEAD_DIMS, head_dim_instance

    seen = set()
    for name in chip_smoke.MODELS:
        cfg = chip_smoke.model_config(name)
        for lc in cfg.decoder_config.transformer_config.layer_configs:
            if isinstance(lc.mixer_config, AttentionConfig):
                seen.add((name, lc.mixer_config.head_dim))
    assert {dh for _, dh in seen if dh <= 256} <= set(_HEAD_DIMS), sorted(seen)
    assert all(head_dim_instance(dh) == 256 for _, dh in seen if dh > 256), sorted(seen)
    assert {dh for _, dh in seen if dh > 256} == {512}
    assert {name for name, _ in seen} == set(chip_smoke.MODELS)
    assert chip_smoke.HYBRID_ATTN["head_dim"] in _HEAD_DIMS


def test_gate_admits_head_dims_the_kernel_lacks(monkeypatch):
    """Repaired (ROADMAP §3): the flash gate, as the JAX gate (`dh % 8 ==
    0`), admits every head dim, and every such Dh runs on the card: up to
    256 in an instantiation at least as wide (32, 64, 128, 256; 16 and 24
    in 32), past 256 (264, 512, 1032) in the Dh-256 layout's wide case,
    `column_slices(dh)` blocks of 256 output columns. Not a multiple of 8,
    the wrapper raises on the card before any build."""
    from uzu_tpu_torch.ops.cuda.flash_attention import (
        _HEAD_DIMS,
        column_slices,
        flash_attention,
        head_dim_instance,
        launch_split_plan,
        supported,
    )

    gate = dict(is_causal=True, suffix_mask=None, kv_valid_length=None)
    assert _HEAD_DIMS == (32, 64, 128, 256)
    for dh in range(8, 1033, 8):
        assert supported(64, 8, 2, dh, 1024, **gate)
        inst = head_dim_instance(dh)
        assert inst in _HEAD_DIMS
        if dh <= 256:
            assert inst == min(i for i in _HEAD_DIMS if i >= dh) and column_slices(dh) == 1
        else:
            assert inst == 256 and column_slices(dh) == -(-dh // 256)
    assert head_dim_instance(16) == head_dim_instance(24) == 32
    assert column_slices(264) == column_slices(512) == 2 and column_slices(1032) == 5
    assert head_dim_instance(20) is None and head_dim_instance(0) is None
    # the slices are blocks: the plan fills a card of that many times fewer SMs
    assert launch_split_plan(256, 8, 2, 1024, 256, SMS) == split_plan(256, 8, 2, 1024, SMS)
    assert launch_split_plan(256, 8, 2, 1024, 512, SMS) == split_plan(256, 8, 2, 1024,
                                                                     -(-SMS // 2))
    before = dict(build.LAUNCHES)
    monkeypatch.setattr(torch.Tensor, "device", property(lambda t: torch.device("cuda")))
    for dh in (20, 12):
        q, k = torch.zeros((64, 8, dh)), torch.zeros((128, 2, dh))
        with pytest.raises(ValueError, match="multiple of 8"):
            flash_attention(q, k, k, torch.zeros(64, dtype=torch.int32), scale=0.1)
    assert build.LAUNCHES == before
