"""The split-KV route of K5/K6 (`ops/cuda/paged_attention.py`) on the CPU.

Where one block per (slot, KV group) cannot fill the card, the CUDA kernel
deals the page table's 64-token tiles to `paged_split_plan` splits (split z
takes every splits-th tile from tile z on), writes each split's
unnormalized (m, l, acc) and merges them in a fixed order with the combine
it shares with K3/K4. These tests hold the plan
and the plain versions of the two halves (`paged_partials_plain`,
`flash_combine_plain`) against `paged_attention_plain`, the JAX reference
and the JAX kernel in interpret mode, with inputs made by a seeded numpy
generator. The kernel itself is held against `paged_attention_plain` on the
card by `chip_smoke.py`.
"""

import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uzu_tpu.ops.pallas.paged_attention import (
    paged_attention_reference,
    paged_decode_attention as jax_paged,
)
from uzu_tpu_torch.ops.cuda.flash_attention import flash_combine_plain
from uzu_tpu_torch.ops.cuda.paged_attention import (
    MAX_REP,
    TILE,
    paged_attention_plain,
    paged_partials_plain,
    paged_split_plan,
    split_positions,
)

torch.set_num_threads(1)

SMS = 132  # the H100's SM count
WIDTH = 4096  # table width in tokens of the main cases


def _case(seed, page, quant, *, h, g=2, dh=64, width=WIDTH, lengths=None):
    """Pools of 64 physical pages per group, a random table over them
    (pages repeat across and within slots, as shared prefixes do), ragged
    lengths 1, one page, 777 and width - 1 by default."""
    rng = np.random.default_rng(seed)
    p_total = 64
    maxp = width // page
    q = torch.from_numpy(rng.standard_normal((4, h, dh)).astype(np.float32))
    if quant:
        k = torch.from_numpy(rng.integers(-127, 128, (g, p_total, page, dh)).astype(np.int8))
        v = torch.from_numpy(rng.integers(-127, 128, (g, p_total, page, dh)).astype(np.int8))
        scales = dict(
            k_scales=torch.from_numpy(rng.uniform(0.005, 0.03, (g, p_total, page))
                                      .astype(np.float32)),
            v_scales=torch.from_numpy(rng.uniform(0.005, 0.03, (g, p_total, page))
                                      .astype(np.float32)))
    else:  # bf16 pools, as the engine keeps them
        k, v = (torch.from_numpy(rng.standard_normal((g, p_total, page, dh)).astype(np.float32))
                .to(torch.bfloat16) for _ in range(2))
        scales = {}
    table = torch.from_numpy(rng.integers(0, p_total, (4, maxp)).astype(np.int32))
    if lengths is None:
        lengths = [1, page, 777, width - 1]
    sinks = torch.from_numpy(rng.standard_normal(h).astype(np.float32))
    return q, k, v, table, torch.tensor(lengths, dtype=torch.int32), scales, sinks


def _variant(name, sinks):
    return {"plain": {}, "window": {"sliding_window_size": 300},
            "softcap": {"logit_soft_cap": 20.0}, "sinks": {"sinks": sinks}}[name]


def _splits(b, g, width):
    n, _ = paged_split_plan(b, g, width, SMS)
    return [split_positions(z, n, width) for z in range(n)]


def _split_parts(q, k, v, table, lengths, *, scale, **kw):
    g, _, page, _ = k.shape
    parts = [paged_partials_plain(q, k, v, table, lengths, pos, scale=scale, **kw)
             for pos in _splits(q.shape[0], g, table.shape[1] * page)]
    return tuple(torch.stack(t) for t in zip(*parts))


def _split_route(q, k, v, table, lengths, *, scale, sinks=None, **kw):
    """What the kernel computes on its split route, in plain PyTorch."""
    m, l, acc = _split_parts(q, k, v, table, lengths, scale=scale, **kw)
    return flash_combine_plain(m, l, acc, sinks)


# -- the plan --------------------------------------------------------------------------

@pytest.mark.parametrize("b,g,width", [
    (8, 8, 4096), (8, 8, 1024), (8, 8, 8192), (4, 2, 4096), (1, 8, 512), (3, 2, 100),
    (8, 8, 64), (16, 8, 4096), (32, 8, 1024), (1, 1, 40000),
])
def test_paged_split_plan_covers_the_width_once_in_whole_tiles(b, g, width):
    n, per = paged_split_plan(b, g, width, SMS)
    tiles = -(-width // TILE)
    splits = _splits(b, g, width)
    every = torch.cat(splits)
    assert torch.equal(every.sort().values, torch.arange(width))  # each position once
    for z, pos in enumerate(splits):
        tile_ids = (pos // TILE).unique()
        assert torch.equal(tile_ids, torch.arange(z, tiles, n))  # every n-th tile from z
        assert len(tile_ids) <= per
        full = tile_ids[tile_ids < width // TILE]
        assert all(int((pos // TILE == t).sum()) == TILE for t in full)  # whole tiles
    if b * g >= SMS:
        assert n == 1
    else:
        assert n <= tiles and (b * g * n >= SMS or n == tiles)


def test_paged_split_plan_takes_shapes_only():
    """The plan reads no tensor: lengths stay on the device, the decode step
    needs no host sync, and a captured step keeps its launch."""
    assert list(inspect.signature(paged_split_plan).parameters) == [
        "b", "g", "width_tokens", "num_sms"]
    assert paged_split_plan(8, 8, 4096, SMS) == (4, 16)  # the flagship's table shape
    assert paged_split_plan(8, 8, 1024, SMS) == (4, 4)
    assert paged_split_plan(32, 8, 4096, SMS) == (1, 64)
    assert MAX_REP == 16  # the kernel's 16 rows of mma.sync's M


# -- partials + fixed-order combine -------------------------------------------------------

@pytest.mark.parametrize("page", [16, 64, 512])
@pytest.mark.parametrize("h", [8, 16], ids=["rep4", "rep8"])
@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("variant", ["plain", "window", "softcap", "sinks"])
def test_split_route_equals_paged_plain(variant, quant, h, page):
    """Lengths 1, one page, 777 and 4095 over a 4096-token table: many
    splits, some empty for every slot but the longest."""
    q, k, v, table, lengths, scales, sinks = _case(page + h + quant, page, quant, h=h)
    kw = dict(_variant(variant, sinks), **scales)
    assert len(_splits(4, 2, WIDTH)) > 1
    want = paged_attention_plain(q, k, v, table, lengths, scale=0.125, **kw)
    got = _split_route(q, k, v, table, lengths, scale=0.125, **kw)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("variant", ["plain", "sinks"])
def test_empty_splits_merge_to_nothing(variant, quant):
    """Short slots over a wide table, and a window past the table's end:
    every split without a live token writes m = -1e30 and l = 0, and drops
    out of the merge."""
    q, k, v, table, lengths, scales, sinks = _case(
        41 + quant, 64, quant, h=8, lengths=[1, 5, 64, WIDTH + 700])
    kw = dict(_variant(variant, sinks), **scales)
    m, l, acc = _split_parts(q, k, v, table, lengths, scale=0.125, **scales)
    assert bool((m[1:, :3] == -1e30).all()) and bool((l[1:, :3] == 0).all())
    assert bool((acc[1:, :3] == 0).all())
    want = paged_attention_plain(q, k, v, table, lengths, scale=0.125, **kw)
    got = flash_combine_plain(m, l, acc, kw.get("sinks"))
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-5)
    # a window of 500 over a slot 700 tokens past the table's end sees nothing
    m, l, _ = _split_parts(q, k, v, table, lengths, scale=0.125, sliding_window_size=500,
                           **scales)
    assert bool((m[:, 3] == -1e30).all()) and bool((l[:, 3] == 0).all())


def test_combine_order_is_fixed():
    """The same partials merge to the same bits every time."""
    q, k, v, table, lengths, scales, sinks = _case(9, 64, True, h=8)
    a = _split_route(q, k, v, table, lengths, scale=0.125, sinks=sinks, **scales)
    b = _split_route(q, k, v, table, lengths, scale=0.125, sinks=sinks, **scales)
    assert torch.equal(a, b)


def test_sinks_folded_per_range_fail_the_comparison():
    """Sinks belong to the row once, after the merge: a kernel that folded
    them into every split would count each sink once per split. Four
    splits of 64 live tokens each, sinks near the largest scores."""
    q, k, v, table, lengths, _, sinks = _case(13, 32, False, h=8, width=256,
                                              lengths=[256] * 4)
    sinks = sinks + 4.0
    assert len(_splits(4, 2, 256)) == 4
    want = paged_attention_plain(q, k, v, table, lengths, scale=0.125, sinks=sinks)
    m, l, acc = _split_parts(q, k, v, table, lengths, scale=0.125)
    once = flash_combine_plain(m, l, acc, sinks)
    np.testing.assert_allclose(once.numpy(), want.numpy(), rtol=1e-5, atol=1e-5)
    top = torch.maximum(m, sinks[None, None, :])
    corr = torch.exp(m - top)
    l_bad = l * corr + torch.exp(sinks[None, None, :] - top)
    bad = flash_combine_plain(top, l_bad, acc * corr[..., None])
    assert not np.allclose(bad.numpy(), want.numpy(), rtol=1e-3, atol=1e-3)


# -- the whole against the JAX package -------------------------------------------------------

def _jax(t):
    if t.dtype == torch.bfloat16:
        return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
    return jnp.asarray(t.numpy())


@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("h", [8, 16], ids=["rep4", "rep8"])
@pytest.mark.parametrize("variant", ["plain", "window", "softcap", "sinks"])
def test_split_route_matches_jax(variant, h, quant):
    """A 256-token table of 32-token pages (four one-tile splits). The JAX
    reference at 1e-5; the JAX kernel in interpret mode rounds q and p to
    bf16 for its dots, hence its own tests' 2e-2."""
    q, k, v, table, lengths, scales, sinks = _case(
        59 + h + quant, 32, quant, h=h, width=256, lengths=[1, 32, 200, 256])
    kw = _variant(variant, sinks)
    assert len(_splits(4, 2, 256)) == 4
    got = _split_route(q, k, v, table, lengths, scale=0.125, **kw, **scales)
    jargs = [_jax(t) for t in (q, k, v, table, lengths)]
    jkw = {a: _jax(b) if isinstance(b, torch.Tensor) else b
           for a, b in dict(kw, **scales).items()}
    want = np.asarray(paged_attention_reference(*jargs, scale=0.125, **jkw))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    interp = np.asarray(jax_paged(*jargs, scale=0.125, interpret=True, **jkw))
    np.testing.assert_allclose(got.numpy(), interp, rtol=2e-2, atol=2e-2)
