"""K7/K8's launch plan, an emulation of the kernel's arithmetic, its fragment orders.

`csrc/moe_gemv.cu` runs only on the card; what surrounds it is held here
on the CPU:
- `moe_gemv_plan` (ops/cuda/moe_gemv.py), the plan the wrapper launches:
  kw from K alone (K9's `small_kw`), the (pair, row block) items dealt to
  at most 2 blocks per SM, each (pair, 16-row weight tile) walked once, at
  gpt-oss-20b's and the tiny test model's expert shapes;
- an emulation of `moe_small`'s arithmetic as a plain function: x rounded
  to bf16, each weight dequantized in the kernel's types, products summed
  per mma k-step in the kernel's permuted k order, the kw warps' chunks
  interleaved and their sums added in warp order. It is held to
  `moe_expert_gemv_plain` and to the JAX package's `_moe_gemv_p` in
  interpret mode within 2e-2 of RMS (bf16 operands against f32), and to
  itself bit for bit: a pair's row is the same whatever the other pairs;
- an emulation of the staged x fragment reads (stage_x's INT4 and INT8
  orders, read at row stride 0): a bijection that pairs each x with its
  own weight;
- the wrapper's refusals before any launch.
"""

import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uzu_tpu.ops.pallas.moe_gemv import _moe_gemv_p
from uzu_tpu.quant import format as jq
from uzu_tpu_torch.ops.cuda import build
from uzu_tpu_torch.ops.cuda import moe_gemv as mg
from uzu_tpu_torch.ops.cuda.quant_matmul import SMALL_WARPS, small_chunk, small_kw
from uzu_tpu_torch.quant.format import StackedQuantized

torch.set_num_threads(1)

SMS = 132  # the H100 SXM's SM count
PAIRS = (*range(1, 17), 32)
# (name, N, K) of each expert matmul: gpt-oss-20b's (d = dff = 2880) and the
# tiny gpt-oss model's of tests/test_torch_grouped_plan.py (d 64, dff 128)
SHAPES = (("oss_up", 5760, 2880), ("oss_down", 2880, 2880),
          ("tiny_up", 256, 64), ("tiny_down", 64, 128))


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.sqrt(np.mean(want ** 2)))


# -- the plan ------------------------------------------------------------------------


def test_plan_takes_shapes_only():
    assert list(inspect.signature(mg.moe_gemv_plan).parameters) == ["p", "n", "k", "bits",
                                                                     "sms"]


def _ranges(plan: mg.MoePlan) -> list[range]:
    """The items each block of the plan takes (csrc moe_small's dealing):
    the first `first` blocks per_first each, the others per_second."""
    out = []
    for b in range(plan.blocks):
        if b < plan.first:
            start, count = b * plan.per_first, plan.per_first
        else:
            start = plan.first * plan.per_first + (b - plan.first) * plan.per_second
            count = plan.per_second
        out.append(range(min(start, plan.items), min(plan.items, start + count)))
    return out


def _walk(plan: mg.MoePlan, p: int, n: int):
    """moe_small's walk: items pair-major, each block a contiguous range
    (`_ranges`); warp w of row block rb takes 16-row tile rb * (SMALL_WARPS
    / kw) + w / kw. Yields (block, pair, tile) for each warp group that has
    rows."""
    per_rb = SMALL_WARPS // plan.kw
    row_blocks = -(-(-(-n // 16)) // per_rb)
    assert plan.items == p * row_blocks
    for b, items in enumerate(_ranges(plan)):
        for item in items:
            pair, rb = divmod(item, row_blocks)
            for w in range(0, SMALL_WARPS, plan.kw):
                tile = rb * per_rb + w // plan.kw
                if tile * 16 < n:
                    yield b, pair, tile


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("name,n,k", SHAPES)
@pytest.mark.parametrize("p", PAIRS)
def test_plan_walks_each_pair_tile_once(p, name, n, k, bits):
    """Every (pair, 16-row weight tile) is taken by exactly one block's
    item; at most 2 blocks per SM, and an SM's two blocks (b and b +
    first) hold at most ceil(items / SMs) items; kw is small_kw(k, bits),
    K9's small_kw(k) at INT4, whatever P or N; `short` is set exactly when
    the items do not fill the SMs."""
    plan = mg.moe_gemv_plan(p, n, k, bits, SMS)
    assert plan.kw == small_kw(k, bits) and SMALL_WARPS % plan.kw == 0
    if bits == 4:
        assert plan.kw == small_kw(k)
    assert 1 <= plan.blocks <= 2 * SMS and plan.first <= SMS
    ranges = _ranges(plan)
    assert all(len(r) for r in ranges)  # no block is launched without work
    per_sm = -(-plan.items // SMS)
    for b in range(plan.first):
        pair = len(ranges[b]) + (len(ranges[b + plan.first]) if b + plan.first < plan.blocks
                                 else 0)
        assert pair <= per_sm
    seen: dict = {}
    for _, pair, tile in _walk(plan, p, n):
        seen[(pair, tile)] = seen.get((pair, tile), 0) + 1
    assert set(seen) == {(i, t) for i in range(p) for t in range(-(-n // 16))}
    assert set(seen.values()) == {1}
    assert bool(plan.short) == (plan.items < SMS)


def test_gptoss_plans():
    """gpt-oss's single-stream decode (P = 4): INT4 kw 2 (K9's), up 360
    items over 132 + 96 blocks (2 + 1 an SM), down 180 over 132 + 48; INT8
    kw 4 (twice the chunks of INT4), up 720 items over 132 + 108 blocks."""
    up = mg.moe_gemv_plan(4, 5760, 2880, 4, SMS)
    down = mg.moe_gemv_plan(4, 2880, 2880, 4, SMS)
    up8 = mg.moe_gemv_plan(4, 5760, 2880, 8, SMS)
    assert up == mg.MoePlan(2, 360, 228, 132, 2, 1)
    assert down == mg.MoePlan(2, 180, 180, 132, 1, 1)
    assert up8 == mg.MoePlan(4, 720, 240, 132, 3, 3)


# -- an emulation of moe_small's arithmetic ---------------------------------------------


def _bf16(a) -> np.ndarray:
    """f32 values rounded to bf16 (round to nearest even), as float64."""
    u = np.asarray(a, np.float32).view(np.uint32).astype(np.uint64)
    u = (u + 0x7FFF + ((u >> 16) & 1)) >> 16 << 16
    return u.astype(np.uint32).view(np.float32).astype(np.float64)


def _bf16_once(a64) -> np.ndarray:
    """float64 values rounded once to bf16 (one bf16 FMA of the exact result)."""
    m, e = np.frexp(np.asarray(a64, np.float64))
    return np.ldexp(np.round(m * 256.0), e - 8)


def _weights(codes, scales, coeff, bits, g, scale_bf16) -> np.ndarray:
    """[N, K] codes (unpacked) and [N, ceil(K/g)] scales -> the bf16 weights
    the kernel feeds the tensor cores, as float64: INT4 with bf16 scales one
    bf16 FMA n * s + coeff * s rounded once; otherwise f32 FMA, rounded to
    bf16."""
    s = np.repeat(scales.astype(np.float32), g, axis=1)[:, :codes.shape[1]].astype(np.float64)
    if scale_bf16:
        s = _bf16(s)
    b = coeff * s  # coeff a power of two: exact
    exact = codes.astype(np.float64) * s + b
    if bits == 4 and scale_bf16:
        return _bf16_once(exact)
    return _bf16(exact.astype(np.float32))


def _steps(k: int, bits: int) -> list[np.ndarray]:
    """The k of each mma k-step of each chunk, in the kernel's order: a
    chunk is 4 lanes (tig) x 16 code bytes; INT4 word q of a lane gives two
    steps h of the pairs (n_2h, n_2h+4), (n_2h+1, n_2h+5); INT8 word q one
    step of its 4 codes. Returns per chunk an [steps, 16] array (k past K
    dropped by the caller)."""
    ck = small_chunk(bits)
    span = ck // 4
    out = []
    for c in range(-(-k // ck)):
        rows = []
        for q in range(4):
            for h in range(2 if bits == 4 else 1):
                offs = [2 * h, 2 * h + 4, 2 * h + 1, 2 * h + 5] if bits == 4 else [0, 1, 2, 3]
                word = 8 * q if bits == 4 else 4 * q
                rows.append([c * ck + tig * span + word + o for tig in range(4) for o in offs])
        out.append(np.asarray(rows))
    return out


def _emulate_rows(w: np.ndarray, xb: np.ndarray, bits: int, kw: int) -> np.ndarray:
    """One pair's output rows: w [R, K] bf16 weights, xb [K] bf16 x. Warp kq
    takes chunks kq, kq + kw, ...; each k-step's 16 exact products are summed
    and added to the warp's f32 accumulator; the warps' sums are added in
    warp order in f32."""
    k = w.shape[1]
    prod = w * xb[None, :]  # exact: bf16 x bf16
    acc = np.zeros((kw, w.shape[0]), np.float32)
    for c, steps in enumerate(_steps(k, bits)):
        for ks in steps:
            ks = ks[ks < k]
            acc[c % kw] = (acc[c % kw] + prod[:, ks].sum(1).astype(np.float32)).astype(np.float32)
    total = acc[0].copy()
    for j in range(1, kw):
        total = (total + acc[j]).astype(np.float32)
    return total


def emulate_moe_small(codes, scales, coeff, bits, g, x, ids, scale_bf16, sms=SMS):
    """out [P, N] as moe_small computes it, by the plan's walk: codes [E, N,
    K] unpacked, scales [E, N, ceil(K/g)], x [P, K] f32, ids [P]. Each
    (pair, tile) is written once."""
    e, n, k = codes.shape
    p = x.shape[0]
    plan = mg.moe_gemv_plan(p, n, k, bits, sms)
    out = np.full((p, n), np.nan, np.float32)
    planes: dict = {}
    for _, pair, tile in _walk(plan, p, n):
        ex = min(max(int(ids[pair]), 0), e - 1)
        if ex not in planes:
            planes[ex] = _weights(codes[ex], scales[ex], coeff, bits, g, scale_bf16)
        rows = slice(tile * 16, min(n, tile * 16 + 16))
        assert np.isnan(out[pair, rows]).all()
        out[pair, rows] = _emulate_rows(planes[ex][rows], _bf16(x[pair]), bits, plan.kw)
    assert not np.isnan(out).any()
    return out


def _case(seed, e, n, k, bits, p, scale_bf16):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 1 << bits, (e, n, k), dtype=np.uint8)
    scales = rng.random((e, n, -(-k // 32))).astype(np.float32) * 0.02 + 0.01
    if scale_bf16:
        scales = _bf16(scales).astype(np.float32)
    x = rng.standard_normal((p, k)).astype(np.float32)
    ids = rng.integers(0, e, p).astype(np.int32)
    return codes, scales, x, ids


# the four cases of tests/test_torch_moe.py's K7/K8 test, and gpt-oss's K
CASES = [(4, 256, 512), (4, 256, 352), (8, 256, 512), (4, 512, 4096), (4, 128, 2880),
         (8, 128, 2880)]


@pytest.mark.parametrize("scale_dtype", ["f32", "bf16"])
@pytest.mark.parametrize("bits,n,k", CASES)
def test_emulation_matches_plain_and_pallas_interpret(bits, n, k, scale_dtype):
    """bf16 operands against the f32 oracles: within 2e-2 of RMS (chip_smoke's
    TOL), on pairs that repeat experts as a routed step does."""
    bf = scale_dtype == "bf16"
    codes, scales, x, ids = _case(bits + n + k, 5, n, k, bits, 6, bf)
    coeff = -float(1 << (bits - 1))
    got = emulate_moe_small(codes, scales, coeff, bits, 32, x, ids, bf)
    packed = jq.pack_codes(codes, bits)
    sq = StackedQuantized(torch.from_numpy(packed),
                          torch.from_numpy(scales).to(torch.bfloat16 if bf else torch.float32),
                          bits, 32, coeff)
    plain = mg.moe_expert_gemv_plain(sq, torch.from_numpy(x), torch.from_numpy(ids)).numpy()
    jscales = jnp.asarray(scales).astype(jnp.bfloat16 if bf else jnp.float32)
    pallas = np.asarray(_moe_gemv_p(jnp.asarray(x), jnp.asarray(packed), jscales,
                                    jnp.asarray(ids), bits=bits, group_size=32,
                                    qbias_coeff=coeff, interpret=True))
    assert _rel(got, plain) <= 2e-2
    assert _rel(got, pallas) <= 2e-2
    assert _rel(plain, pallas) <= 1e-4  # the two f32 oracles agree


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("n,k", [(256, 352), (720, 2880)])
def test_emulated_rows_do_not_depend_on_the_other_pairs(n, k, bits):
    """Row p of a P-pair launch is bit for bit the one-pair launch of pair p,
    at P = 4 and 16 (another plan, another block walk, the same kw)."""
    codes, scales, x, ids = _case(n + bits, 9, n, k, bits, 16, True)
    coeff = -float(1 << (bits - 1))
    ones = np.concatenate([emulate_moe_small(codes, scales, coeff, bits, 32, x[i:i + 1],
                                             ids[i:i + 1], True) for i in range(16)])
    for p in (4, 16):
        got = emulate_moe_small(codes, scales, coeff, bits, 32, x[:p], ids[:p], True)
        assert np.array_equal(got, ones[:p])


# -- the staged x fragments -------------------------------------------------------------


def _prmt(a: int, b: int, sel: int) -> int:
    """PTX prmt (__byte_perm) in its default mode."""
    src = (b << 32) | a
    return sum(((src >> (8 * ((sel >> (4 * i)) & 7))) & 0xFF) << (8 * i) for i in range(4))


def _bits(v: float) -> int:
    return int(np.array(v, np.float32).view(np.uint32)) >> 16


def _halves(r: int) -> tuple[float, float]:
    lo = np.array([(r & 0xFFFF) << 16], np.uint32).view(np.float32)[0]
    hi = np.array([(r >> 16) << 16], np.uint32).view(np.float32)[0]
    return float(lo), float(hi)


def _stage(x_row: np.ndarray, bits: int) -> list[list[int]]:
    """stage_x<bits> of one row: per 8 k a 16-byte unit of 4 words; INT4
    (k0, k4), (k1, k5), (k2, k6), (k3, k7); INT8 k order."""
    units = []
    for u in range(len(x_row) // 8):
        v = [_bits(x_row[8 * u + 2 * j]) | _bits(x_row[8 * u + 2 * j + 1]) << 16
             for j in range(4)]
        if bits == 4:
            units.append([_prmt(v[0], v[2], 0x5410), _prmt(v[0], v[2], 0x7632),
                          _prmt(v[1], v[3], 0x5410), _prmt(v[1], v[3], 0x7632)])
        else:
            units.append(v)
    return units


def _emulate_staged_chunk(bits: int, codes: np.ndarray, x_row: np.ndarray) -> np.ndarray:
    """One small_rows chunk of one warp reading x from one staged row at row
    stride 0 (XStaged{s, 0}: every lane group reads row 0, so each of the
    n8 operand's 8 columns holds the pair's x): codes [16, CK] (chunk-local
    k), x_row [CK]. Lanes build A as the kernel does (int4 pairs (n_i,
    n_i+4) / int8 pairs (c0, c1), (c2, c3) at scale 1 and qbias 0) and B
    from the staged unit; D [16, 8] = sum over the k-steps of A B."""
    ck = small_chunk(bits)
    span = ck // 4
    staged = _stage(x_row, bits)  # the one staged row
    ld = 0  # the row stride moe_small reads it at
    d = np.zeros((16, 8))

    def words_of(row, tig):
        vals = codes[row, tig * span:(tig + 1) * span]
        if bits == 4:
            by = [int(vals[2 * j]) | int(vals[2 * j + 1]) << 4 for j in range(16)]
        else:
            by = [int(v) for v in vals]
        return [by[4 * q] | by[4 * q + 1] << 8 | by[4 * q + 2] << 16 | by[4 * q + 3] << 24
                for q in range(4)]

    def pairs(w):
        if bits == 4:
            return [_bits(float((w >> (4 * i)) & 15)) | _bits(float((w >> (4 * i + 16)) & 15))
                    << 16 for i in range(4)]
        c = [(w >> (8 * b)) & 0xFF for b in range(4)]
        return [_bits(float(c[0])) | _bits(float(c[1])) << 16,
                _bits(float(c[2])) | _bits(float(c[3])) << 16]

    for s in range(ck // 16):
        a_mat = np.zeros((16, 16))
        b_mat = np.zeros((16, 8))
        for gid in range(8):
            for tig in range(4):
                kb = tig * span
                p0, p1 = pairs(words_of(gid, tig)[s // 2 if bits == 4 else s]), \
                    pairs(words_of(gid + 8, tig)[s // 2 if bits == 4 else s])
                if bits == 4:
                    q, h = divmod(s, 2)
                    a = [p0[2 * h], p1[2 * h], p0[2 * h + 1], p1[2 * h + 1]]
                    xq = staged[gid * ld + kb // 8 + q]
                    b = [xq[2] if h else xq[0], xq[3] if h else xq[1]]
                else:
                    q = s
                    a = [p0[0], p1[0], p0[1], p1[1]]
                    x8 = staged[gid * ld + kb // 8 + (q >> 1)]
                    b = [x8[2 * (q & 1)], x8[2 * (q & 1) + 1]]
                c = 2 * tig
                a_mat[gid, c:c + 2] = _halves(a[0])
                a_mat[gid + 8, c:c + 2] = _halves(a[1])
                a_mat[gid, c + 8:c + 10] = _halves(a[2])
                a_mat[gid + 8, c + 8:c + 10] = _halves(a[3])
                b_mat[c:c + 2, gid] = _halves(b[0])
                b_mat[c + 8:c + 10, gid] = _halves(b[1])
        d += a_mat @ b_mat
    return d


@pytest.mark.parametrize("bits", [4, 8])
def test_staged_fragment_order_is_a_bijection_pairing_x_with_its_weight(bits):
    """x one-hot at each k of a chunk in turn: every column of D is exactly
    the weight column of that k, so each staged x meets its own weight,
    once, and no other, in all 8 columns."""
    ck = small_chunk(bits)
    codes = np.random.default_rng(bits).integers(0, 1 << bits, (16, ck))
    for k in range(ck):
        x = np.zeros(ck)
        x[k] = 1.0
        d = _emulate_staged_chunk(bits, codes, x)
        assert np.array_equal(d, np.repeat(codes[:, k:k + 1].astype(np.float64), 8, axis=1)), k


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("seed", range(2))
def test_staged_fragment_product_equals_the_dot(bits, seed):
    ck = small_chunk(bits)
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 1 << bits, (16, ck))
    x = _bf16(rng.standard_normal(ck).astype(np.float32))
    d = _emulate_staged_chunk(bits, codes, x)
    np.testing.assert_allclose(d, np.repeat((codes @ x)[:, None], 8, axis=1), rtol=1e-12,
                               atol=1e-12)


# -- the wrapper's refusals ---------------------------------------------------------------


def _stack(e, n, k, bits, g=32, scale_dtype=torch.bfloat16):
    codes = torch.zeros((e, n, k * bits // 8), dtype=torch.uint8)
    scales = torch.ones((e, n, -(-k // g)), dtype=scale_dtype)
    return StackedQuantized(codes, scales, bits, g, -float(1 << (bits - 1)))


def _as_cuda(monkeypatch):
    monkeypatch.setattr(torch.Tensor, "device", property(lambda t: torch.device("cuda")))


@pytest.mark.parametrize("case,match", [
    ("bits", "bits in"), ("k8", "K % 8"), ("g8", "g % 8"), ("pairs", "P <="),
    ("stage", "shared memory"), ("x_dtype", "f32 x_pairs"), ("scale_dtype", "scales bf16 or f32"),
    ("aligned", "16-byte aligned")])
def test_wrapper_refuses_before_any_launch(case, match, monkeypatch):
    """On a (pretended) CUDA tensor each refusal raises before the plan, the
    build or a launch; nothing is counted."""
    k, p, sq = 64, 3, _stack(4, 32, 64, 4)
    x = torch.zeros((p, k))
    if case == "bits":
        sq = StackedQuantized(torch.zeros((4, 32, 16), dtype=torch.uint8),
                              torch.ones((4, 32, 2)), 2, 32, -2.0)
    elif case == "k8":
        k, sq = 36, _stack(4, 32, 36, 8, g=12)
        x = torch.zeros((p, k))
    elif case == "g8":
        sq = _stack(4, 32, 64, 8, g=12)
    elif case == "pairs":
        p = mg.MAX_PAIRS + 1
        x = torch.zeros((p, k))
    elif case == "stage":  # a staged bf16 row past SMALL_STAGE_MAX (200 KB)
        k, sq = 102528, _stack(1, 16, 102528, 8, g=128)
        x = torch.zeros((p, k))
    elif case == "x_dtype":
        x = x.to(torch.bfloat16)
    elif case == "scale_dtype":
        sq = _stack(4, 32, 64, 4, scale_dtype=torch.float16)
    elif case == "aligned":
        x = torch.zeros(p * k + 1)[1:].view(p, k)
    ids = torch.zeros(p, dtype=torch.int32)
    before = dict(build.LAUNCHES)
    _as_cuda(monkeypatch)
    with pytest.raises(ValueError, match=match):
        mg.moe_expert_gemv(sq, x, ids)
    assert build.LAUNCHES == before


def test_cpu_tensors_take_the_plain_version():
    sq = _stack(4, 32, 64, 4)
    x = torch.randn((3, 64))
    ids = torch.tensor([0, 3, 1])
    before = dict(build.LAUNCHES)
    assert torch.equal(mg.moe_expert_gemv(sq, x, ids), mg.moe_expert_gemv_plain(sq, x, ids))
    assert build.LAUNCHES == before
