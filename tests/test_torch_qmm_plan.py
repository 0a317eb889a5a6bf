"""K1/K2's launch plan, split-K route, bit-trick dequantization and fragment order.

`csrc/quant_matmul.cu` runs only on the card; what surrounds it is held
here on the CPU:
- `qmm_plan` (ops/cuda/quant_matmul.py), the plan the wrapper launches:
  it covers N and K once in whole tiles and chunks, takes shapes only,
  gives every flagship and gpt-oss shape a route, and on the tile route
  fills a wave of 132 SMs or says why not;
- `ops/linear.py`'s route: bf16 x at every row count reaches K1's wrapper,
  f32 x past GEMM_THRESHOLD_M keeps the dequantize-then-matmul (counted);
  the tile's plan at the benchmark configurations' prefill shapes;
- `quant_matmul_split_plain`, the plain version of a plan's split-K tile
  (per-split partials, then the fixed-order merge), against
  `quant_matmul_plain`, the JAX package's XLA reference and its Pallas
  kernel in interpret mode, with numpy-seeded inputs;
- an emulation of the kernels' bit tricks: INT4 codes made bf16 through a
  magic exponent and one bf16 FMA, INT8 codes made f32 through a magic
  exponent, the byte permutes that put the tile's W in k order;
- an emulation of `qmm_small`'s register assembly (shifts, masks, byte
  permutes, mma.sync m16n8k16's fragment layout), which shows that its
  permuted k order is a bijection that pairs each x with its own weight.
"""

import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uzu_tpu.ops.linear import _xla_quant_matmul
from uzu_tpu.ops.pallas.quant_matmul import _quant_matmul_p, quant_matmul_pallas
from uzu_tpu.quant import format as jq
from uzu_tpu_torch.ops.cuda import quant_matmul as qmm
from uzu_tpu_torch.quant import format as tq

torch.set_num_threads(1)

SMS = 132  # the H100 SXM's SM count
M_ROWS = (1, 8, 16, 64, 256, 1024, 2048, 4096)
# (name, N, K) of every K1/K2 linear of the flagship (Llama-1B widths) and
# of gpt-oss-20b's widths (d 2880, 64 query / 8 KV heads of 64, vocab 201088)
SHAPES = (("qkv", 3072, 2048), ("out", 2048, 2048), ("up|gate", 16384, 2048),
          ("down", 2048, 8192), ("readout", 128256, 2048),
          ("oss_qkv", 5120, 2880), ("oss_out", 2880, 4096), ("oss_readout", 201088, 2880))


# -- the plan ------------------------------------------------------------------------


def test_plan_takes_shapes_only():
    assert list(inspect.signature(qmm.qmm_plan).parameters) == [
        "m", "n", "k", "bits", "sms", "x_bf16"]


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("name,n,k", SHAPES)
@pytest.mark.parametrize("m", M_ROWS)
def test_plan_routes_every_main_path_shape(bits, name, n, k, m):
    """A route for each shape; the tile's blocks fill one wave of 132 SMs,
    or a stated reason holds: one more split would spill into a second
    wave, or K has no chunks left for one."""
    plan = qmm.qmm_plan(m, n, k, bits, SMS)
    assert plan.route == ("small" if m <= qmm.GEMV_MAX_M else "tile")
    blocks = qmm.plan_blocks(plan, m, n)
    if plan.route == "small":
        assert plan.kw in (1, 2, 4, 8)
        # at least a wave of blocks, or each row tile already walked by 8 warps
        assert blocks >= SMS or plan.kw == qmm.SMALL_WARPS
        return
    base = blocks // plan.splits
    chunks = -(-k // qmm.TILE_K)
    fills_a_wave = blocks >= SMS
    next_split_spills = base * (plan.splits + 1) > SMS
    k_too_short = plan.splits + 1 > chunks // qmm.TILE_MIN_CHUNKS
    assert fills_a_wave or next_split_spills or k_too_short, (blocks, plan)
    assert blocks <= SMS or plan.splits == 1  # a split never makes a second wave


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("m", [33, 64, 100, 256, 1024, 1025, 2049, 4095])
@pytest.mark.parametrize("n,k", [(200, 512), (3072, 2048), (2048, 8192), (300, 2880),
                                 (136, 2888), (5120, 2880)])
def test_tile_plan_covers_n_and_k_once(bits, m, n, k):
    plan = qmm.qmm_plan(m, n, k, bits, SMS)
    assert plan.route == "tile" and plan.bm == (128 if m <= 128 else 256)
    chunks = -(-k // qmm.TILE_K)
    # every split takes whole chunks, none is empty, together they cover K once
    assert (plan.splits - 1) * plan.chunks_per_split < chunks <= plan.splits * \
        plan.chunks_per_split
    ranges = [range(z * plan.chunks_per_split, min(chunks, (z + 1) * plan.chunks_per_split))
              for z in range(plan.splits)]
    assert sorted(c for r in ranges for c in r) == list(range(chunks))
    assert plan.splits == 1 or all(len(r) >= qmm.TILE_MIN_CHUNKS for r in ranges[:-1])
    # the n and m blocks cover N and M once
    assert -(-n // qmm.TILE_N) * qmm.TILE_N - n < qmm.TILE_N
    assert -(-m // plan.bm) * plan.bm - m < plan.bm


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("n,k", [(200, 512), (3072, 2048), (16384, 2048), (2048, 8192),
                                 (128256, 2048), (300, 2880), (136, 2888)])
def test_small_plan_is_one_arithmetic_for_every_m(bits, n, k):
    """kw does not depend on m (so every row of an m-row product is summed
    as the 1-row product is), and the kw warps' interleaved chunks kq, kq +
    kw, ... cover K once."""
    plans = {qmm.qmm_plan(m, n, k, bits, SMS) for m in range(1, qmm.GEMV_MAX_M + 1)}
    assert len(plans) == 1
    (plan,) = plans
    assert plan.route == "small" and qmm.SMALL_WARPS % plan.kw == 0
    chunks = -(-k // qmm.small_chunk(bits))
    walked = sorted(c for kq in range(plan.kw) for c in range(kq, chunks, plan.kw))
    assert walked == list(range(chunks))
    assert -(-chunks // plan.kw) >= 2 or plan.kw == 1


def test_f32_x_keeps_the_f32_gemv_at_small_m():
    assert qmm.qmm_plan(1, 256, 512, 4, SMS, x_bf16=False).route == "gemv_f32"
    assert qmm.qmm_plan(32, 256, 512, 8, SMS, x_bf16=False).route == "gemv_f32"
    assert qmm.qmm_plan(33, 256, 512, 4, SMS, x_bf16=False).route == "tile"


# -- prefill M: ops/linear.py's route and the tile's plan ----------------------------

# (name, N, K) of the linears of Qwen3-4B and LFM2-1.2B as the port fuses them
# (qkv, up|gate; LFM2's ShortConv in_proj 3d), the rows of their 2048- and
# 4096-row prefill chunks, and the device ms of qmm_tile at bm 128 and 256
# (splits 1) on an H100 SXM (chip_smoke.py --qmm-only, QMM_PREFILL_BM)
PREFILL_MS = {
    ("qwen3/qkv", 6144, 2560, 2048): (0.2757, 0.1859),
    ("qwen3/qkv", 6144, 2560, 4096): (0.5428, 0.3580),
    ("qwen3/out", 2560, 4096, 2048): (0.2223, 0.1859),
    ("qwen3/out", 2560, 4096, 4096): (0.3574, 0.2759),
    ("qwen3/up|gate", 19456, 2560, 2048): (0.8501, 0.5774),
    ("qwen3/up|gate", 19456, 2560, 4096): (1.6457, 1.0776),
    ("qwen3/down", 2560, 9728, 2048): (0.5092, 0.4330),
    ("qwen3/down", 2560, 9728, 4096): (0.8145, 0.6235),
    ("lfm2/qkv", 3072, 2048, 2048): (0.1176, 0.1022),
    ("lfm2/qkv", 3072, 2048, 4096): (0.2266, 0.1553),
    ("lfm2/out", 2048, 2048, 2048): (0.0801, 0.0545),
    ("lfm2/out", 2048, 2048, 4096): (0.1533, 0.1052),
    ("lfm2/conv_in", 6144, 2048, 2048): (0.2263, 0.1541),
    ("lfm2/conv_in", 6144, 2048, 4096): (0.4393, 0.2956),
    ("lfm2/up|gate", 16384, 2048, 2048): (0.5791, 0.3814),
    ("lfm2/up|gate", 16384, 2048, 4096): (1.1388, 0.7364),
    ("lfm2/down", 2048, 8192, 2048): (0.2800, 0.1805),
    ("lfm2/down", 2048, 8192, 4096): (0.5511, 0.3522),
}


def _qweight(n, k, bits=4, g=32, seed=0):
    gen = torch.Generator().manual_seed(seed)
    codes = torch.randint(0, 256, (n, k * bits // 8), dtype=torch.uint8, generator=gen)
    scales = (torch.rand((n, k // g), generator=gen) * 0.01 + 0.001).to(torch.bfloat16)
    return tq.QuantizedTensor(codes, scales, None, bits, g, -float(1 << (bits - 1)))


def _spy(monkeypatch):
    from uzu_tpu_torch.ops import linear as tlinear

    calls = []
    real = qmm.quant_matmul

    def spy(w, x2, plan=None):
        calls.append((tuple(x2.shape), x2.dtype))
        return real(w, x2, plan)

    monkeypatch.setattr(qmm, "quant_matmul", spy)
    return tlinear, calls


@pytest.mark.parametrize("m", [33, 1024, 1025, 2048, 4096])
def test_linear_sends_bf16_x_to_k1_at_every_m(monkeypatch, m):
    """bf16 x of any row count above the small-M routes reaches K1's
    wrapper, whose plan there is the tile; the dequantize-then-matmul is
    not taken, and the result is K1's plain product rounded to bf16."""
    from uzu_tpu_torch.ops.cuda.build import LAUNCHES

    tlinear, calls = _spy(monkeypatch)
    n, k = 256, 128
    w = _qweight(n, k)
    x = torch.randn((m, k), generator=torch.Generator().manual_seed(m)).to(torch.bfloat16)
    before = LAUNCHES["linear_dequant_matmul"]
    y = tlinear.linear_apply(w, x.reshape(1, m, k))
    assert calls == [((m, k), torch.bfloat16)]
    assert qmm.qmm_plan(m, n, k, 4, SMS).route == "tile"
    assert LAUNCHES["linear_dequant_matmul"] == before
    assert y.dtype == torch.bfloat16 and y.shape == (1, m, n)
    assert torch.equal(y[0], qmm.quant_matmul_plain(w, x).to(torch.bfloat16))


def test_f32_x_above_the_threshold_keeps_the_dequantize_then_matmul(monkeypatch):
    """f32 x past GEMM_THRESHOLD_M rows is contracted in f32 over the
    dequantized weight, not rounded to bf16 for K1's tile, and is counted;
    at the threshold it still reaches K1's wrapper."""
    from uzu_tpu_torch.ops.cuda.build import LAUNCHES
    from uzu_tpu_torch.quant.format import dequantize

    tlinear, calls = _spy(monkeypatch)
    w = _qweight(256, 128)
    m = tlinear.GEMM_THRESHOLD_M + 1
    x = torch.randn((m, 128), generator=torch.Generator().manual_seed(1))
    before = LAUNCHES["linear_dequant_matmul"]
    y = tlinear.linear_apply(w, x)
    assert calls == [] and LAUNCHES["linear_dequant_matmul"] == before + 1
    assert y.dtype == torch.float32
    assert torch.equal(y, torch.matmul(x, dequantize(w, torch.float32).t()))
    tlinear.linear_apply(w, x[:-1])
    assert calls == [((m - 1, 128), torch.float32)]
    assert LAUNCHES["linear_dequant_matmul"] == before + 1


@pytest.mark.parametrize("name,n,k,m", sorted(PREFILL_MS))
def test_prefill_plan_at_the_benchmark_shapes(name, n, k, m):
    """At the prefill chunks of both benchmark configurations the tile's
    plan covers N and K once, takes no split (each row summed as at any
    other M of the shape), and its bm is the one measured faster: a bm-128
    block costs 0.73-0.80 of a bm-256 block there, so bm 128 lost even
    where its last wave was the fuller one."""
    plan = qmm.qmm_plan(m, n, k, 4, SMS)
    chunks = -(-k // qmm.TILE_K)
    assert plan.route == "tile" and plan.splits == 1 and plan.chunks_per_split == chunks
    assert qmm.plan_blocks(plan, m, n) == -(-n // qmm.TILE_N) * -(-m // plan.bm)
    ms128, ms256 = PREFILL_MS[(name, n, k, m)]
    assert plan.bm == (128 if ms128 < ms256 else 256)


# -- the split-K route's plain version ------------------------------------------------------

METHODS = ["scale_symmetric", "scale_bias", "scale_zero_point"]


def _weights(seed, n, k, bits, g, method, pad_to=None):
    """One weight in both packages; scale (and qbias) rows zero-padded to
    `pad_to` groups where given."""
    w = np.random.default_rng(seed).standard_normal((n, k), dtype=np.float32) * 0.1
    parts = jq.quantize_reference(w, bits, g, method, dtype=np.float32)
    kw = dict(zero_points=parts.get("zero_points"), biases=parts.get("biases"))
    qj = jq.from_disk_tensors(method, parts["weights"], parts["scales"], bits, g,
                              dtype=jnp.float32, **kw)
    scales = np.asarray(qj.scales)
    qbias = None if qj.qbias is None else np.asarray(qj.qbias)
    if pad_to is not None:
        def pad(a):
            out = np.zeros((n, pad_to), np.float32)
            out[:, :a.shape[1]] = a
            return out
        scales = pad(scales)
        qbias = None if qbias is None else pad(qbias)
    qt = tq.QuantizedTensor(torch.from_numpy(np.asarray(parts["weights"])),
                            torch.from_numpy(np.array(scales)),
                            None if qbias is None else torch.from_numpy(np.array(qbias)), bits, g,
                            qj.qbias_coeff)
    return parts["weights"], scales, qbias, qj, qt


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("m", [40, 64])
def test_split_plain_matches_plain_xla_and_pallas(bits, method, m):
    """N 256, K 1024: the plan splits K into 4 ranges of 4 chunks."""
    *_, qj, qt = _weights(bits + m, 256, 1024, bits, 32, method)
    plan = qmm.qmm_plan(m, 256, 1024, bits, SMS)
    assert plan.route == "tile" and plan.splits == 4
    x = np.random.default_rng(m).standard_normal((m, 1024), dtype=np.float32)
    got = qmm.quant_matmul_split_plain(qt, torch.from_numpy(x), plan).numpy()
    np.testing.assert_allclose(got, qmm.quant_matmul_plain(qt, torch.from_numpy(x)).numpy(),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, np.asarray(_xla_quant_matmul(qj, jnp.asarray(x))),
                               rtol=1e-4, atol=1e-4)
    if m == 64:  # the Pallas kernel in interpret mode (M padded to 8 inside)
        want = np.asarray(quant_matmul_pallas(qj, jnp.asarray(x), interpret=True))
        np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("method", ["scale_symmetric", "scale_bias"])
@pytest.mark.parametrize("pad_to", [128, 32])
def test_split_plain_takes_padded_scale_rows(method, pad_to):
    """The bisect probe's N 256, K 512 at M 64 (2 splits of 4 chunks), scale
    rows zero-padded past their 16 groups, against `_quant_matmul_p` in
    interpret mode with the same rows: within 1e-4 of RMS."""
    codes, scales, qbias, qj, qt = _weights(pad_to, 256, 512, 4, 32, method, pad_to)
    plan = qmm.qmm_plan(64, 256, 512, 4, SMS)
    assert plan.splits == 2
    x = np.random.default_rng(pad_to).standard_normal((64, 512)).astype(np.float32)
    want = np.asarray(_quant_matmul_p(
        jnp.asarray(x), jnp.asarray(codes), jnp.asarray(scales),
        None if qbias is None else jnp.asarray(qbias), bits=4, group_size=32,
        interpret=True, qbias_coeff=qj.qbias_coeff))
    got = qmm.quant_matmul_split_plain(qt, torch.from_numpy(x), plan).numpy()
    rms = np.sqrt(np.mean(want.astype(np.float64) ** 2))
    assert np.max(np.abs(got - want)) <= 1e-4 * rms


def test_split_merge_is_in_split_order():
    """The merge adds split 0, then 1, ...: a partial that only the last
    split holds changes nothing but the sum's last term."""
    *_, qt = _weights(3, 64, 1024, 4, 32, "scale_symmetric")
    plan = qmm.qmm_plan(64, 64, 1024, 4, SMS)
    x = torch.from_numpy(np.random.default_rng(3).standard_normal((64, 1024),
                                                                  dtype=np.float32))
    got = qmm.quant_matmul_split_plain(qt, x, plan)
    wd = qmm._dequantize_f32(qt)
    step = plan.chunks_per_split * qmm.TILE_K
    want = sum((x[:, z * step:(z + 1) * step] @ wd[:, z * step:(z + 1) * step].t()
                for z in range(1, plan.splits)), x[:, :step] @ wd[:, :step].t())
    assert torch.equal(got, want)


# -- bit-trick dequantization ---------------------------------------------------------


def _bf16_round(a) -> np.ndarray:
    """float64 or float32 values rounded to bf16 (round to nearest even), as
    float64."""
    f = np.asarray(a, np.float32)
    u = f.view(np.uint32).astype(np.uint64)
    u = (u + 0x7FFF + ((u >> 16) & 1)) >> 16 << 16
    return u.astype(np.uint32).view(np.float32).astype(np.float64)


def _bf16_exact_round(a64) -> np.ndarray:
    """float64 values rounded once to bf16 (what one bf16 FMA returns from
    the exact result)."""
    a64 = np.asarray(a64, np.float64)
    m, e = np.frexp(a64)  # a = m * 2^e, 0.5 <= |m| < 1
    return np.ldexp(np.round(m * 256.0), e - 8)  # 8 significant bits, ties to even


def _bf16_from_bits(b) -> np.ndarray:
    return (np.asarray(b, np.uint32) << 16).view(np.float32).astype(np.float64)


def _ulp_bf16(a) -> np.ndarray:
    _, e = np.frexp(np.abs(a))
    return np.ldexp(1.0, e - 8)


def _sampled_groups(seed, count=4096):
    """bf16 scales over many binades and bf16 qbias: stored (any sign) and
    symmetric (-8 * scale, exact)."""
    rng = np.random.default_rng(seed)
    s = _bf16_round(np.exp(rng.uniform(-14, 2, count)) * rng.choice([1, 1, 1, -1], count))
    b = _bf16_round(rng.standard_normal(count) * np.exp(rng.uniform(-12, 1, count)))
    return np.concatenate([s, s]), np.concatenate([b, -8.0 * s])


def test_int4_magic_exponent_and_bf16_fma_within_one_ulp():
    """All 16 nibbles: 0x4300 | n is 128 + n in bf16, 128 comes off exactly,
    and one FMA rounds n * s + b once; against the f32 dequantization
    rounded to bf16, at most 1 bf16 ulp apart (equal unless the f32 sum
    rounds to a bf16 tie)."""
    n = np.arange(16)
    v = _bf16_from_bits(0x4300 | n)
    assert np.array_equal(v, 128.0 + n) and np.array_equal(v - 128.0, n)
    s, b = _sampled_groups(0)
    exact = n[None, :] * s[:, None] + b[:, None]  # exact in float64
    fma = _bf16_exact_round(exact)
    f32 = _bf16_round((n[None, :].astype(np.float32) * s[:, None].astype(np.float32)
                       + b[:, None].astype(np.float32)).astype(np.float32))
    assert np.all(np.abs(fma - f32) <= _ulp_bf16(np.maximum(np.abs(fma), np.abs(f32))))
    assert np.mean(fma == f32) > 0.99


def test_int8_magic_exponent_is_exact():
    """All 256 bytes: (0x4B000000 | c) as f32 less 2^23 is c."""
    c = np.arange(256, dtype=np.uint32)
    f = (np.uint32(0x4B000000) | c).view(np.float32) - np.float32(8388608.0)
    assert np.array_equal(f, c.astype(np.float32))


def _prmt(a: int, b: int, sel: int) -> int:
    """PTX prmt (__byte_perm) in its default mode."""
    src = (b << 32) | a
    return sum(((src >> (8 * ((sel >> (4 * i)) & 7))) & 0xFF) << (8 * i) for i in range(4))


def _int4_pairs(w: int) -> list[int]:
    """int4_pairs at scale 1 and qbias 0: pair i holds (n_i, n_i+4) as bf16
    bits, lo and hi halves."""
    out = []
    for i in range(4):
        v = ((w >> (4 * i)) & 0x000F000F) | 0x43004300
        lo, hi = _bf16_from_bits(v & 0xFFFF) - 128, _bf16_from_bits(v >> 16) - 128
        out.append(_bits(lo) | _bits(hi) << 16)
    return out


def _bits(v: float) -> int:
    return int(np.array(v, np.float32).view(np.uint32)) >> 16


def _halves(r: int) -> tuple[float, float]:
    return float(_bf16_from_bits(r & 0xFFFF)), float(_bf16_from_bits(r >> 16))


@pytest.mark.parametrize("seed", range(8))
def test_tile_int4_word_lands_in_k_order(seed):
    """qmm_tile's byte permutes turn the pairs (n_i, n_i+4) of a word into
    the 16-byte swizzle chunk n0, n1, ..., n7."""
    nib = np.random.default_rng(seed).integers(0, 16, 8)
    w = sum(int(x) << (4 * i) for i, x in enumerate(nib))
    p = _int4_pairs(w)
    chunk = [_prmt(p[0], p[1], 0x5410), _prmt(p[2], p[3], 0x5410),
             _prmt(p[0], p[1], 0x7632), _prmt(p[2], p[3], 0x7632)]
    assert [v for r in chunk for v in _halves(r)] == list(map(float, nib))


# -- qmm_small's fragment order ---------------------------------------------------------


def _emulate_small_chunk(bits: int, codes: np.ndarray, x: np.ndarray) -> np.ndarray:
    """One qmm_small chunk of one warp: codes [16, CK] (the warp's 16 weight
    rows, chunk-local k), x [8, CK] (bf16 values; row m = column m of the n8
    operand). Each lane (gid, tig) builds its registers as the kernel does
    (16 code bytes per row at k = tig * SPAN, int4_pairs / int8_pairs at
    scale 1 and qbias 0, x words and byte permutes), the fragments are laid
    out as mma.sync m16n8k16 reads them (A row-major 16x16, B 16x8, two
    bf16 a register, low half first) and D [16, 8] = sum over the k-steps
    of A B."""
    ck = 512 // bits
    span = ck // 4
    d = np.zeros((16, 8))

    def words_of(row, tig):
        vals = codes[row, tig * span:(tig + 1) * span]
        if bits == 4:
            by = [int(vals[2 * j]) | int(vals[2 * j + 1]) << 4 for j in range(16)]
        else:
            by = [int(v) for v in vals]
        return [by[4 * q] | by[4 * q + 1] << 8 | by[4 * q + 2] << 16 | by[4 * q + 3] << 24
                for q in range(4)]

    def x_words(m, tig, v):  # the 16-byte load of x[m, tig * span + 8 v ..]
        k0 = tig * span + 8 * v
        return [_bits(x[m, k0 + 2 * j]) | _bits(x[m, k0 + 2 * j + 1]) << 16 for j in range(4)]

    def int8_pairs(w):
        c = [(w >> (8 * b)) & 0xFF for b in range(4)]
        return [_bits(c[0]) | _bits(c[1]) << 16, _bits(c[2]) | _bits(c[3]) << 16]

    steps = ck // 16
    for s in range(steps):
        a_mat = np.zeros((16, 16))
        b_mat = np.zeros((16, 8))
        for gid in range(8):
            for tig in range(4):
                w0, w1 = words_of(gid, tig), words_of(gid + 8, tig)
                if bits == 4:
                    q, h = divmod(s, 2)
                    p0, p1 = _int4_pairs(w0[q]), _int4_pairs(w1[q])
                    a = [p0[2 * h], p1[2 * h], p0[2 * h + 1], p1[2 * h + 1]]
                    xw = x_words(gid, tig, q)
                    b = [_prmt(xw[h], xw[h + 2], 0x5410), _prmt(xw[h], xw[h + 2], 0x7632)]
                else:
                    q = s
                    p0, p1 = int8_pairs(w0[q]), int8_pairs(w1[q])
                    a = [p0[0], p1[0], p0[1], p1[1]]
                    xw = x_words(gid, tig, q >> 1)
                    b = [xw[2 * (q & 1)], xw[2 * (q & 1) + 1]]
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
def test_small_fragment_order_is_a_bijection_pairing_x_with_its_weight(bits):
    """x one-hot at each k of a chunk in turn: D's columns are exactly the
    weight column of that k, so every x meets its own weight, once, and no
    other."""
    ck = 512 // bits
    rng = np.random.default_rng(bits)
    codes = rng.integers(0, 1 << bits, (16, ck))
    for k in range(ck):
        x = np.zeros((8, ck))
        x[:, k] = 1.0
        d = _emulate_small_chunk(bits, codes, x)
        assert np.array_equal(d, np.repeat(codes[:, k:k + 1].astype(np.float64), 8, axis=1)), k


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("seed", range(3))
def test_small_fragment_product_equals_the_dot(bits, seed):
    ck = 512 // bits
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 1 << bits, (16, ck))
    x = _bf16_round(rng.standard_normal((8, ck)))
    d = _emulate_small_chunk(bits, codes, x)
    np.testing.assert_allclose(d, codes @ x.T, rtol=1e-12, atol=1e-12)
