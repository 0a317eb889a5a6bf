"""K9/K10's launch plan, layouts at every bm, and the kernels' index walks.

`csrc/grouped_matmul.cu` runs only on the card; what surrounds it is held
here on the CPU:
- `grouped_plan` (ops/cuda/grouped_matmul.py), the plan the wrappers
  launch: the route, bm and block geometry from shapes and the SM count
  only, at gpt-oss-20b's and the tiny test model's expert shapes, with the
  blocks filling 132 SMs or a stated reason;
- `route_layout` at bm = 8, 16, 32 and 64 against the JAX package's;
- the plain versions of K9 and K10 at every bm against the JAX kernels in
  interpret mode (E=8, N=128, K=256, T=32: shapes the JAX kernels tile);
- `moe_forward` on chunks of 5 to 33 rows (the small route's bm and the
  tile's) against the JAX package's Pallas mode, K9 called twice;
- emulations of the kernels' index arithmetic: the small route's walk of
  weight rows and K chunks, the tile route's copies, dequantization stores,
  group windows and accumulator stores, each shown to be a bijection.
"""

import functools
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import uzu_tpu.models.moe as jmoe
import uzu_tpu_torch.models.moe as tmoe
from uzu_tpu import LanguageModel as JaxLM
from uzu_tpu.config.model import IntSpec as JaxIntSpec, Layout as JaxLayout
from uzu_tpu.ops.pallas import grouped_matmul as jgm
from uzu_tpu.quant import format as jq
from uzu_tpu_torch import LanguageModel
from uzu_tpu_torch.config.model import IntSpec, Layout
from uzu_tpu_torch.ops.cuda import grouped_matmul as gm
from uzu_tpu_torch.quant.format import StackedQuantized
from uzu_tpu_torch.tools.synth import gptoss_config, synthesize

torch.set_num_threads(1)

SMS = 132  # the H100 SXM's SM count
CHUNK_ROWS = (1, 2, 4, 5, 8, 9, 16, 31, 32, 33, 64, 256, 1024, 4096)
# (name, E, k_active, N, K) of each expert matmul: gpt-oss-20b's (32 experts,
# 4 active, d = dff = 2880) and the tiny gpt-oss model's below
SHAPES = (("oss_up", 32, 4, 5760, 2880), ("oss_down", 32, 4, 2880, 2880),
          ("tiny_up", 8, 2, 256, 64), ("tiny_down", 8, 2, 64, 128))
TINY = dict(num_layers=2, model_dim=64, num_heads=4, num_groups=2, head_dim=16,
            vocab_size=512, num_experts=8, num_active=2, expert_hidden_dim=128)


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.sqrt(np.mean(want ** 2)))


# -- the plan ------------------------------------------------------------------------


def test_plan_takes_shapes_only():
    assert list(inspect.signature(gm.grouped_plan).parameters) == [
        "s", "k_active", "e", "n", "k", "bits", "sms"]
    assert list(inspect.signature(gm.launch_plan).parameters) == [
        "tiles", "bm", "e", "n", "k", "bits", "sms"]


@pytest.mark.parametrize("bits", [4, 16, 32])
@pytest.mark.parametrize("name,e,k_active,n,k", SHAPES)
@pytest.mark.parametrize("s", CHUNK_ROWS)
def test_plan_routes_every_chunk(bits, name, e, k_active, n, k, s):
    """INT4 chunks of S <= 32 rows take the small route with bm >= S (a
    token's k experts are distinct, so one expert holds at most S rows),
    the rest 64-row tiles; the blocks fill the SMs or the plan says why;
    the wrappers rebuild the same plan from the layout's shapes."""
    plan = gm.grouped_plan(s, k_active, e, n, k, bits, SMS)
    small = bits == 4 and s <= gm.GEMV_MAX_M  # every K of SHAPES stages at every bm
    assert plan.route == ("small" if small else "tile" if bits in (4, 16) else "mma")
    if small:
        assert plan.bm in gm.SMALL_BMS and plan.bm >= s
        assert plan.bm == min(b for b in gm.SMALL_BMS if b >= s)
        assert plan.kw == gm.small_kw(k) and plan.bn == 0
    else:
        assert plan.bm == gm.GROUP_ROWS
    if plan.route == "tile":
        assert plan.bn in gm.TILE_BNS[bits]
        fills = plan.blocks >= gm.RESIDENT[bits][plan.bn] * SMS
        # K10 with no expert's second tile: BN 64; else the largest BN whose
        # blocks fill the resident slots, else the smallest
        assert fills or plan.bn == gm.TILE_BNS[bits][-1]
        if bits == 16 and plan.tiles <= e:
            assert plan.bn == 64
        else:
            larger = [b for b in gm.TILE_BNS[bits] if b > plan.bn]
            assert all(plan.tiles * -(-n // b) < gm.RESIDENT[bits][b] * SMS for b in larger)
    else:
        fills = plan.blocks >= SMS
    assert fills == (plan.short == ""), plan
    # the launch's m dimension lies between the row tiles and every tile
    t = s * k_active
    tiles = -(-t // plan.bm) + e
    assert -(-t // plan.bm) <= plan.tiles <= tiles
    assert gm.launch_plan(tiles, plan.bm, e, n, k, bits, SMS) == plan


@pytest.mark.parametrize("name,e,k_active,n,k", SHAPES[:2])
def test_gptoss_chunks_fill_the_card(name, e, k_active, n, k):
    """At gpt-oss's widths every chunk from the paged step (S = 8) up fills
    the SMs on both routes."""
    for s in (8, 16, 32, 33, 64, 256, 1024, 4096):
        for bits in (4, 16):
            plan = gm.grouped_plan(s, k_active, e, n, k, bits, SMS)
            assert plan.short == "", (s, bits, plan)
    assert gm.grouped_plan(8, k_active, e, n, k, 4, SMS).bm == 8  # the paged step's 8 slots


@pytest.mark.parametrize("t,bn", [(256, 64), (1024, 64), (4096, 256)])
def test_k10_bn_follows_the_experts_second_tiles(t, bn):
    """gpt-oss's K10 chunks: at T <= 1024 routed rows every expert holds
    one tile (BN 64); the 1024-row chunk's T = 4096 gives experts a second
    tile (BN 256)."""
    for n in (5760, 2880):
        plan = gm.grouped_plan(t // 4, 4, 32, n, 2880, 16, SMS)
        assert (plan.route, plan.bn) == ("tile", bn), plan
        assert (plan.tiles <= 32) == (bn == 64)


@pytest.mark.parametrize("s", [1, 8, 9, 16, 32])
@pytest.mark.parametrize("k", [2880, 4096, 8192, 12288])
def test_long_k_takes_the_tile_route(k, s):
    """The small route stages each tile's x (bm rows of K, bf16) in shared
    memory; where that passes SMALL_STAGE_MAX the plan lays the chunk out
    in 64-row tiles instead, and the wrapper refuses a small-bm layout of
    such a K."""
    bm = min(b for b in gm.SMALL_BMS if b >= s)
    fits = gm.staged_bytes(bm, k) <= gm.SMALL_STAGE_MAX
    plan = gm.grouped_plan(s, 4, 32, 2880, k, 4, SMS)
    assert (plan.route, plan.bm) == (("small", bm) if fits else ("tile", gm.GROUP_ROWS))
    assert gm.staged_bytes(bm, k) == bm * (-(-k // 128) * 128 * 2 + 16)
    if k == 2880:  # gpt-oss stages at every bm
        assert fits


@pytest.mark.parametrize("k", [64, 128, 256, 352, 512, 2880, 4096, 8192])
def test_small_kw_depends_on_k_only_and_walks_k_once(k):
    """kw comes from K alone, so a row's product is summed in the same
    order whatever N, S or the other rows of its tile; the kw warps'
    interleaved chunks kq, kq + kw, ... cover K's chunks once, each warp
    keeping two batches of SMALL_UNROLL chunks or more when kw > 1."""
    plans = [gm.grouped_plan(s, 4, 32, n, k, 4, SMS)
             for s in range(1, gm.GEMV_MAX_M + 1) for n in (64, 2880, 5760)]
    assert plans[0].route == "small"
    assert {p.kw for p in plans if p.route == "small"} == {gm.small_kw(k)}
    kw = gm.small_kw(k)
    assert gm.SMALL_WARPS % kw == 0
    chunks = -(-k // 128)
    walked = sorted(c for kq in range(kw) for c in range(kq, chunks, kw))
    assert walked == list(range(chunks))
    assert kw == 1 or -(-chunks // kw) >= 2 * gm.SMALL_UNROLL


def test_moe_passes_the_plans_bm_to_the_layout(monkeypatch):
    seen = []
    real = tmoe.route_layout
    monkeypatch.setattr(tmoe, "route_layout",
                        lambda flat, e, bm: (seen.append(bm), real(flat, e, bm))[1])
    cfg = gptoss_config(**TINY).decoder_config.transformer_config.layer_configs[0].mlp_config
    rng = np.random.default_rng(0)
    codes = torch.from_numpy(rng.integers(0, 256, (8, 256, 32), dtype=np.uint8))
    scales = torch.full((8, 256, 2), 0.01)
    up = StackedQuantized(codes, scales, 4, 32, -8.0)
    down = StackedQuantized(torch.from_numpy(rng.integers(0, 256, (8, 64, 64), dtype=np.uint8)),
                            torch.full((8, 64, 4), 0.01), 4, 32, -8.0)
    params = {"router": {"w": torch.from_numpy(rng.standard_normal((8, 64)).astype(np.float32))},
              "up": {"w": up}, "down": {"w": down}}
    for s in (5, 8, 16, 32, 33, 64):
        seen.clear()
        tmoe.moe_forward(cfg, params, torch.from_numpy(
            rng.standard_normal((s, 64)).astype(np.float32)))
        assert seen == [gm.grouped_plan(s, 2, 8, 256, 64, 4, SMS).bm], s


# -- the layout at every bm -------------------------------------------------------------

def _router_ids(rng, s, e, k):
    """[s * k] expert ids, each token's k distinct, as a router picks them."""
    return np.concatenate([rng.permutation(e)[:k] for _ in range(s)]).astype(np.int32)


ROUTINGS = {
    "router": lambda rng, t, e: _router_ids(rng, t // 4, e, 4),
    "one_expert": lambda rng, t, e: np.full(t, 3, np.int32),
    "empty_experts": lambda rng, t, e: ((rng.integers(0, e, t) // 2) * 2).astype(np.int32),
}


@pytest.mark.parametrize("routing", list(ROUTINGS))
@pytest.mark.parametrize("t", [4, 32, 128, 200])
@pytest.mark.parametrize("bm", [8, 16, 32, 64])
def test_route_layout_matches_jax_at_every_bm(bm, t, routing):
    e = 8
    flat = ROUTINGS[routing](np.random.default_rng(t + bm), t, e)
    want = [np.asarray(a) for a in jgm.route_layout(jnp.asarray(flat), e, bm)]
    got = gm.route_layout(torch.from_numpy(flat), e, bm)
    for g, w, name in zip(got, want, ("order", "dst", "tile_expert", "used", "row_expert")):
        assert g.tolist() == w.tolist(), name
    assert got[4].shape[0] == -(-t // bm) * bm + e * bm


@pytest.mark.parametrize("bm", [8, 16, 32, 64])
@pytest.mark.parametrize("s", [1, 5, 8, 16, 32])
def test_tile_to_expert_walk_covers_the_real_rows_once(s, bm):
    """The kernels' walk of the layout: tile i < used multiplies by expert
    tile_expert[i]; every real row lies in a used tile of its own expert,
    and each used tile holds rows of one expert only. At the plan's bm
    (>= S) every routed expert owns exactly one tile."""
    e, k = 32, 4
    flat = _router_ids(np.random.default_rng(s), s, e, k)
    order, dst, te, used, row_expert = gm.route_layout(torch.from_numpy(flat), e, bm)
    used = int(used[0])
    tiles = dst.numpy() // bm
    assert tiles.max() < used
    assert np.array_equal(te.numpy()[tiles], flat[order.numpy()])
    assert len(set(dst.tolist())) == len(dst)  # one buffer row per routed row
    if bm >= s:
        assert used == len(set(flat.tolist()))
        assert sorted(te.numpy()[:used].tolist()) == sorted(set(flat.tolist()))


# -- the plain versions at every bm ----------------------------------------------------

E8, N128, K256, T32 = 8, 128, 256, 32


def _layout(rng, bm, dtype=np.float32):
    flat = _router_ids(rng, T32 // 4, E8, 4)
    order, dst, te, used, _ = jgm.route_layout(jnp.asarray(flat), E8, bm)
    tp = -(-T32 // bm) * bm + E8 * bm
    x_pad = np.zeros((tp, K256), dtype)
    x_pad[np.asarray(dst)] = rng.standard_normal((T32, K256)).astype(dtype)
    return x_pad, np.array(te), np.array(used), np.array(dst)


@pytest.mark.parametrize("scale_dtype", ["f32", "bf16"])
@pytest.mark.parametrize("bm", [8, 16, 32, 64])
def test_k9_plain_matches_pallas_interpret_at_every_bm(bm, scale_dtype):
    rng = np.random.default_rng(bm)
    codes = jq.pack_codes(rng.integers(0, 16, (E8, N128, K256), dtype=np.uint8), 4)
    scales = rng.random((E8, N128, K256 // 32)).astype(np.float32) * 0.02 + 0.01
    if scale_dtype == "bf16":
        scales = torch.from_numpy(scales).to(torch.bfloat16).float().numpy()
    jsq = jq.StackedQuantized(codes=jnp.asarray(codes), scales=jnp.asarray(scales), bits=4,
                              group_size=32, qbias_coeff=-8.0)
    sq = StackedQuantized(torch.from_numpy(codes), torch.from_numpy(scales), 4, 32, -8.0)
    x_pad, te, used, dst = _layout(rng, bm)
    want = np.asarray(jgm.grouped_matmul_quant(jnp.asarray(x_pad), jsq, jnp.asarray(te),
                                               jnp.asarray(used), bm=bm, interpret=True))
    got = gm.grouped_matmul_quant(torch.from_numpy(x_pad), sq, torch.from_numpy(te),
                                  torch.from_numpy(used))
    assert got.shape == (x_pad.shape[0], N128) and got.dtype == torch.float32
    assert _rel(got.numpy()[dst], want[dst]) <= 1e-4
    plain = gm.grouped_matmul_quant_plain(torch.from_numpy(x_pad), sq, torch.from_numpy(te),
                                          torch.from_numpy(used), bm)
    assert torch.equal(plain, got)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("bm", [8, 16, 32, 64])
def test_k10_plain_matches_pallas_interpret_at_every_bm(bm, dtype):
    rng = np.random.default_rng(100 + bm)
    x_pad, te, used, dst = _layout(rng, bm)
    w = (rng.standard_normal((E8, N128, K256)) * 0.1).astype(np.float32)
    tdt = torch.float32 if dtype == "f32" else torch.bfloat16
    tx, tw = torch.from_numpy(x_pad).to(tdt), torch.from_numpy(w).to(tdt)
    jdt = jnp.float32 if dtype == "f32" else jnp.bfloat16
    jx = jnp.asarray(tx.float().numpy()).astype(jdt)
    jw = jnp.asarray(tw.float().numpy()).astype(jdt)
    want = np.asarray(jgm.grouped_matmul(jx, jw, jnp.asarray(te), jnp.asarray(used), bm=bm,
                                         interpret=True))
    got = gm.grouped_matmul_plain(tx, tw, torch.from_numpy(te), torch.from_numpy(used), bm)
    assert _rel(got.numpy()[dst], want[dst]) <= 1e-4
    if bm == gm.GROUP_ROWS:  # the wrapper takes K10's 64-row layout
        wrapped = gm.grouped_matmul(tx, tw, torch.from_numpy(te), torch.from_numpy(used))
        assert torch.equal(wrapped, got)


def test_wrappers_read_bm_from_the_shapes_and_check_it(monkeypatch):
    x_pad = torch.zeros((96, 64))
    te, used = torch.zeros(12, dtype=torch.int32), torch.ones(1, dtype=torch.int32)
    assert gm.tile_rows(x_pad, te) == 8 and gm.tile_rows(x_pad[:90], te) == 0
    rng = np.random.default_rng(1)
    sq = StackedQuantized(torch.from_numpy(rng.integers(0, 256, (4, 64, 32), dtype=np.uint8)),
                          torch.full((4, 64, 2), 0.01), 4, 32, -8.0)
    monkeypatch.setattr(torch.Tensor, "device", property(lambda t: torch.device("cuda")))
    for bad in (x_pad[:90], torch.zeros((12 * 24, 64))):  # ragged; bm 24
        with pytest.raises(ValueError, match="do not fit"):
            gm.grouped_matmul_quant(bad, sq, te, used)
    with pytest.raises(ValueError, match="do not fit"):  # K10 takes 64-row tiles only
        gm.grouped_matmul(x_pad, torch.zeros((4, 64, 64), dtype=torch.bfloat16), te, used)
    long_k = 16384  # 32 rows of it staged pass SMALL_STAGE_MAX
    sq_long = StackedQuantized(torch.zeros((4, 64, long_k // 2), dtype=torch.uint8),
                               torch.full((4, 64, long_k // 32), 0.01), 4, 32, -8.0)
    with pytest.raises(ValueError, match="shared memory"):
        gm.grouped_matmul_quant(torch.zeros((4 * 32, long_k)), sq_long,
                                torch.zeros(4, dtype=torch.int32), used)


# -- moe_forward on small chunks ---------------------------------------------------------


@pytest.fixture(scope="module")
def int4_model(tmp_path_factory):
    spec = IntSpec(bits=4, group_size=32, is_symmetric=True, layout=Layout.OUTPUT_INPUT)
    return synthesize(gptoss_config(**TINY), str(tmp_path_factory.mktemp("grouped_plan")),
                      seed=5, expert_spec=spec, dtype=np.float32)


@pytest.mark.parametrize("s", [5, 8, 16, 32, 33])
def test_moe_forward_matches_jax_pallas_at_the_plans_bm(int4_model, s, monkeypatch):
    """An INT4 chunk of S rows through the port (bm = 8, 16, 32, 32, 64)
    against the JAX Pallas mode (K9 at bm 64, interpreted): the real rows
    agree at test_torch_moe.py's 1e-4, and K9 runs twice (up, down)."""
    monkeypatch.setenv("UZU_TPU_KERNELS", "pallas")
    jlm = JaxLM.from_dir(int4_model, max_context=128, prefill_buckets=(16,))
    lm = LanguageModel.from_dir(int4_model, device="cpu", max_context=128,
                                prefill_buckets=(16,))
    calls = []
    real = tmoe.grouped_matmul_quant
    monkeypatch.setattr(tmoe, "grouped_matmul_quant",
                        lambda *a: (calls.append(gm.tile_rows(a[0], a[2])), real(*a))[1])

    def mlp_cfg(cfg):
        return cfg.decoder_config.transformer_config.layer_configs[0].mlp_config

    x = np.random.default_rng(s).standard_normal((s, 64)).astype(np.float32)
    want = np.asarray(jmoe.moe_forward(mlp_cfg(jlm.config), jlm.params["layers"][1]["mlp"],
                                       jnp.asarray(x)))
    got = tmoe.moe_forward(mlp_cfg(lm.config), lm.params["layers"][1]["mlp"],
                           torch.from_numpy(x))
    assert got.shape == (s, 64)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    assert calls == [gm.grouped_bm(s, 4, 128)] * 2


# -- the kernels' index arithmetic -----------------------------------------------------


def _swz(r: int, c: int) -> int:
    """hopper.cuh's swz: byte offset of 16-byte chunk c of row r, 128-byte swizzle."""
    return r * 128 + (((c ^ r) & 7) << 4)


@pytest.mark.parametrize("used", [1, 5, 21])
@pytest.mark.parametrize("n", [64, 200, 720])
@pytest.mark.parametrize("k", [64, 352, 2880])
def test_small_route_walks_each_weight_row_and_chunk_once(k, n, used):
    """grouped_small's walk: the used tiles' (tile, row block) items,
    tile-major, dealt to the plan's blocks in contiguous ranges of
    ceil(items / blocks); in small_rows, warp w of row block rb takes
    16-row tile rb * (8 / kw) + w / kw and the chunks kq = w % kw, kq + kw,
    ... (unrolled by SMALL_UNROLL). Every (tile, weight row < N, chunk) is
    taken by exactly one lane group, whatever the grid."""
    kw = gm.small_kw(k)
    chunks = -(-k // 128)
    per_rb = gm.SMALL_WARPS // kw
    row_blocks = -(-(-(-n // 16)) // per_rb)
    items = used * row_blocks
    plan = gm.launch_plan(used + 32, 8, 32, n, k, 4, SMS)
    for grid in {1, 7, plan.blocks, items + 3}:
        per = -(-items // grid)
        seen = {}
        for bx in range(grid):
            for item in range(bx * per, min(items, (bx + 1) * per)):
                tile, rb = divmod(item, row_blocks)
                for w in range(gm.SMALL_WARPS):
                    n0 = (rb * per_rb + w // kw) * 16
                    if n0 >= n:
                        continue
                    for c0 in range(w % kw, chunks, gm.SMALL_UNROLL * kw):
                        for c in range(c0, min(chunks, c0 + gm.SMALL_UNROLL * kw), kw):
                            for row in range(n0, min(n, n0 + 16)):
                                seen[(tile, row, c)] = seen.get((tile, row, c), 0) + 1
        assert len(seen) == used * n * chunks and set(seen.values()) == {1}, grid


@pytest.mark.parametrize("bn", [64, 128, 256])
def test_tile_accumulators_store_each_output_once(bn):
    """store_acc: thread t (warp w, lane = 4 gid + tig) writes acc[4 j + 2 h
    + i] to row 16 w + gid + 8 h, column 8 j + 2 tig + i: a bijection from
    (thread, accumulator) onto the 64 x BN tile, as wgmma m64nBNk16 lays
    its accumulators out."""
    seen = set()
    for tid in range(128):
        w, lane = tid >> 5, tid & 31
        for j in range(bn // 8):
            for h in range(2):
                for i in range(2):
                    seen.add((w * 16 + (lane >> 2) + 8 * h, 8 * j + 2 * (lane & 3) + i,
                              tid, 4 * j + 2 * h + i))
    assert len(seen) == 128 * bn // 2
    assert {(r, c) for r, c, _, _ in seen} == {(r, c) for r in range(64) for c in range(bn)}
    assert {a for _, _, _, a in seen} == set(range(bn // 2))


@pytest.mark.parametrize("bn", [64, 128])
def test_tile_copies_and_stores_cover_their_tiles_once(bn):
    """grouped_tile_q's thread walks (i = tid + j * 128): f32 x as 64 rows x
    16 raw units, bf16 x as 64 rows x 8 swizzled chunks, codes as BN rows x
    2 units, group windows as BN rows x 2 words, the W tile's stores
    swz(r, 4 u + q) and the x tile's swz(r, c): each covers its buffer once."""
    threads = 128
    x_raw = [(i >> 4, i & 15) for j in range(8) for i in [j * threads + t for t in range(threads)]]
    assert sorted(x_raw) == [(r, u) for r in range(64) for u in range(16)]
    x_bf16 = [_swz(i >> 3, i & 7) for i in range(4 * threads)]
    assert sorted(x_bf16) == list(range(0, 64 * 128, 16))
    upt = bn * 2 // threads
    units = [(i >> 1, i & 1) for i in range(upt * threads)]
    assert sorted(units) == [(r, u) for r in range(bn) for u in range(2)]
    w_stores = [_swz(r, 4 * u + q) for r, u in units for q in range(4)]
    assert sorted(w_stores) == list(range(0, bn * 128, 16))
    windows = [(i % bn, i // bn) for i in range(bn * 2)]
    assert sorted(windows) == [(r, w) for r in range(bn) for w in range(2)]


@pytest.mark.parametrize("es", [2, 4])
@pytest.mark.parametrize("g", [32, 64, 96, 128])
@pytest.mark.parametrize("k", [2880, 256, 352])
def test_tile_group_window_holds_the_chunks_groups(k, g, es):
    """The two words copied from the one holding scale (e, n, g0), g0 =
    k0 / G, hold every group a 64-wide chunk touches, found at byte lead +
    (gi - g0) * ES with lead the first scale's byte offset in its word;
    words past the stack read zeros and hold no group of the chunk."""
    e_count, n = 3, 5
    sk = -(-k // g)
    total = e_count * n * sk
    vals = np.arange(1, total + 1, dtype=np.float32)
    raw = (vals.astype(np.float16) if es == 2 else vals).tobytes()
    raw += b"\0" * 4  # the allocation's slack past its last word
    g_bytes = total * es
    for e in range(e_count):
        for row in range(n):
            for chunk in range(-(-k // 64)):
                k0 = chunk * 64
                g0 = k0 // g
                elem = (e * n + row) * sk + g0
                word0 = elem * es // 4
                window = b"".join(raw[4 * w:4 * w + 4] if 4 * w < g_bytes else b"\0" * 4
                                  for w in (word0, word0 + 1))
                lead = elem * es & 3
                for u in range(2):
                    kk = k0 + 32 * u
                    if kk >= k:
                        continue
                    gi = min(kk // g, sk - 1)
                    at = lead + (gi - g0) * es
                    assert at + es <= 8
                    got = np.frombuffer(window[at:at + es], np.float16 if es == 2 else np.float32)
                    assert float(got[0]) == vals[(e * n + row) * sk + gi]
