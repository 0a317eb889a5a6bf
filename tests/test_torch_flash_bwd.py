"""K3's row log-sum-exp and K3b (`uzu_tpu_torch/csrc/flash_attention_bwd.cu`)
against the JAX package, on the CPU.

The card's kernels cannot run here; their plain versions and launch plans
can. `flash_attention_lse_plain` (K3's L) is held to `jax.nn.logsumexp`
of the JAX attention reference's masked, scaled scores, and
`flash_attention_bwd_plain` given L to its own recompute path. A plain
model of K3b's rounding (bf16 q, k, v as they are, f32 ones as bf16 hi +
lo pairs; dO, P and dS as pairs for both) is held to `jax.grad` of the
JAX reference within 1e-4 of RMS, far inside the card's 2e-2
(chip_smoke's TOL); rounding dO, P and dS to bf16 alone misses that 2e-2,
which is why the kernel carries them as pairs. The launch plan
(`bwd_plan`, `bwd_parts`, `bwd_scratch_bytes`) is checked as a pure
function of shapes; that the plan is the kernel's own (csrc `Plan`, whose
static_assert holds every block within 227 KB of shared memory) is
checked on the card, by chip_smoke.py's K3b rows.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uzu_tpu.ops.attention import attention_reference as jax_attention
from uzu_tpu_torch.ops.cuda.flash_attention import (
    bwd_parts,
    bwd_plan,
    bwd_scratch_bytes,
    flash_attention_bwd,
    flash_attention_bwd_plain,
    flash_attention_lse_plain,
    flash_attention_plain,
)

torch.set_num_threads(1)

S, G, DH, C, POS0 = 24, 2, 32, 48, 7  # pos0 > 0 and a cache longer than the chunk
CASES = [(2, None), (2, 13), (4, None), (4, 13)]  # (rep, window)


def _inputs(rep, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    h = G * rep
    q, do = (rng.standard_normal((S, h, DH)).astype(np.float32) for _ in range(2))
    k, v = (rng.standard_normal((C, G, DH)).astype(np.float32) for _ in range(2))
    if dtype == "bf16":  # bf16 values, carried in f32 on both sides
        q, k, v = (torch.from_numpy(x).bfloat16().float().numpy() for x in (q, k, v))
    pos = np.arange(POS0, POS0 + S, dtype=np.int32)
    return q, k, v, do, pos


def _jax_scores(q, k, pos, scale, window):
    """The JAX reference's masked, scaled scores [G, rep, S, C] (its
    einsum path's mask: causal, and the window where given)."""
    s, h, dh = q.shape
    c, g, _ = k.shape
    scores = jnp.einsum("sgrd,cgd->grsc", jnp.asarray(q).reshape(s, g, h // g, dh),
                        jnp.asarray(k), precision=jax.lax.Precision.HIGHEST) * scale
    qpos = jnp.asarray(pos)[:, None]
    kpos = jnp.arange(c)[None, :]
    valid = kpos <= qpos
    if window is not None:
        valid = valid & (kpos > qpos - window)
    return jnp.where(valid[None, None], scores, -jnp.inf)


@pytest.mark.parametrize("rep,window", CASES)
def test_lse_plain_matches_jax_logsumexp(rep, window):
    """K3's L plainly, f32, within 1e-6 of the largest |L| of the JAX
    logsumexp (one f32 function, another summation order); and
    exp(S - L) V is the JAX reference's output (1e-5 of its max), so L is
    that attention's normalizer."""
    q, k, v, _, pos = _inputs(rep, seed=rep * 10 + (window or 0))
    scale = DH ** -0.5
    want = jax.nn.logsumexp(_jax_scores(q, k, pos, scale, window), axis=-1)  # [G, rep, S]
    want = np.asarray(want).transpose(2, 0, 1).reshape(S, G * rep)
    got = flash_attention_lse_plain(torch.from_numpy(q), torch.from_numpy(k),
                                    torch.from_numpy(v), torch.from_numpy(pos), scale=scale,
                                    sliding_window_size=window).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * np.abs(want).max())
    scores = np.asarray(_jax_scores(q, k, pos, scale, window))
    p = np.exp(scores - got.reshape(S, G, rep).transpose(1, 2, 0)[..., None])
    out = np.einsum("grsc,cgd->sgrd", p, v).reshape(S, G * rep, DH)
    ref = np.asarray(jax_attention(q, k, v, jnp.asarray(pos), scale=scale,
                                   sliding_window_size=window))
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5 * np.abs(ref).max())


@pytest.mark.parametrize("rep,window", CASES)
def test_bwd_plain_given_lse_matches_recompute(rep, window):
    """K3b's plain version given L equals its recompute path within 1e-6
    of each gradient's max (the same L up to rounding); through the
    wrapper on the CPU too."""
    q, k, v, do, pos = (torch.from_numpy(x) for x in _inputs(rep, seed=rep + 3))
    scale = DH ** -0.5
    out = flash_attention_plain(q, k, v, pos, scale=scale, sliding_window_size=window)
    lse = flash_attention_lse_plain(q, k, v, pos, scale=scale, sliding_window_size=window)
    want = flash_attention_bwd_plain(q, k, v, pos, out, do, scale=scale,
                                     sliding_window_size=window)
    for got in (flash_attention_bwd_plain(q, k, v, pos, out, do, scale=scale,
                                          sliding_window_size=window, lse=lse),
                flash_attention_bwd(q, k, v, pos, out, do, scale=scale,
                                    sliding_window_size=window, lse=lse)):
        for a, b in zip(got, want):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                       atol=1e-6 * b.abs().max().item())


def _bf(x):
    return x.bfloat16().float()


def _pair(x):
    """bf16 hi and lo = bf16(x - hi), as the kernel's split_bf16x2 rounds."""
    hi = _bf(x)
    return hi, _bf(x - hi)


def _prod(spec, a, b, a_split, b_split):
    """einsum of two operands as the kernel's wgmma take them, each product
    summed in f32: hi.hi, + hi.lo where b is a pair, + lo.hi where a is;
    an operand that is not a pair is rounded to bf16."""
    (ah, al), (bh, bl) = _pair(a), _pair(b)
    out = torch.einsum(spec, ah, bh)
    if b_split:
        out = out + torch.einsum(spec, ah, bl)
    if a_split:
        out = out + torch.einsum(spec, al, bh)
    return out


def _kernel_model(q, k, v, pos, out, do, scale, window, split, pairs=True):
    """K3b's arithmetic with its rounding: q, k, v as bf16 (their values,
    for bf16 inputs) or, where `split`, as pairs; dO, P and dS as pairs
    (`pairs`), or else each rounded to bf16 once. P = exp(S scale - L), L
    K3's; D = rowsum(dO O) and dS = P (dP - D) in f32."""
    s, h, dh = q.shape
    c, g, _ = k.shape
    rep = h // g
    qf = q.reshape(s, g, rep, dh)
    do4 = do.reshape(s, g, rep, dh)
    lse = flash_attention_lse_plain(q, k, v, pos, scale=scale, sliding_window_size=window)
    scores = _prod("sgrd,cgd->grsc", qf, k, split, split) * scale
    qpos = pos[0].long() + torch.arange(s)
    kpos = torch.arange(c)
    valid = kpos[None, :] <= qpos[:, None]
    if window is not None:
        valid = valid & (kpos[None, :] > qpos[:, None] - window)
    p = torch.exp(scores - lse.reshape(s, g, rep).permute(1, 2, 0)[..., None])
    p = p.masked_fill(~valid, 0.0)
    delta = (do4 * out.reshape(s, g, rep, dh)).sum(-1)
    dp = _prod("sgrd,cgd->grsc", do4, v, pairs, split)
    ds = p * (dp - delta.permute(1, 2, 0)[..., None])
    dq = _prod("grsc,cgd->sgrd", ds, k, pairs, split) * scale
    dk = _prod("grsc,sgrd->cgd", ds, qf, pairs, split) * scale
    dv = _prod("grsc,sgrd->cgd", p, do4, pairs, pairs)
    return dq.reshape(s, h, dh), dk, dv


def _jax_grads(q, k, v, do, pos, scale, window):
    def f(q_, k_, v_):
        o = jax_attention(q_, k_, v_, jnp.asarray(pos), scale=scale,
                          sliding_window_size=window)
        return jnp.sum(o * do)

    return jax.grad(f, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))


def _err_over_rms(got, want) -> float:
    want = np.asarray(want, np.float64)
    return float(np.abs(got.numpy() - want).max() / np.sqrt(np.mean(want ** 2)))


@pytest.mark.parametrize("rep,window", CASES)
@pytest.mark.parametrize("dtype,tol", [("bf16", 1e-4), ("f32", 2e-4)])
def test_kernel_rounding_model_matches_jax_grad(rep, window, dtype, tol):
    """The model of K3b's rounding against jax.grad of the JAX reference
    (f32 on the CPU) of sum(O * dO): each gradient within `tol` of its RMS
    (max abs error, chip_smoke's measure), 100x or more inside the card's
    TOL of 2e-2. bf16 inputs (their values) read up to 5.3e-5 here; f32
    inputs, whose q, k and v are pairs too, up to 1.23e-4: a pair holds
    ~17 bits and each product drops lo.lo (~2^-17 relative), and the max
    element of a small case sits several RMS out. Slots past the last
    query get zero gradient."""
    q, k, v, do, pos = _inputs(rep, seed=rep * 7 + (window or 0), dtype=dtype)
    scale = DH ** -0.5
    want = _jax_grads(q, k, v, do, pos, scale, window)
    tq, tk, tv, tdo, tpos = (torch.from_numpy(x) for x in (q, k, v, do, pos))
    out = flash_attention_plain(tq, tk, tv, tpos, scale=scale, sliding_window_size=window)
    got = _kernel_model(tq, tk, tv, tpos, out, tdo, scale, window, split=dtype == "f32")
    for a, b in zip(got, want):
        assert _err_over_rms(a, b) <= tol, dtype
    assert torch.all(got[1][POS0 + S:] == 0) and torch.all(got[2][POS0 + S:] == 0)


def test_bf16_rounded_do_p_ds_miss_tol():
    """Why dO, P and dS are pairs: rounded to bf16 once each (K3's rounding
    of P, applied to all three), bf16 inputs' gradient lands past
    chip_smoke's TOL of 2e-2 of RMS against jax.grad (worst of the four
    cases: 3.47e-2, without a window; 1.9e-2 and 2.0e-2 with one)."""
    worst = 0.0
    for rep, window in CASES:
        q, k, v, do, pos = _inputs(rep, seed=rep * 7 + (window or 0), dtype="bf16")
        scale = DH ** -0.5
        want = _jax_grads(q, k, v, do, pos, scale, window)
        tq, tk, tv, tdo, tpos = (torch.from_numpy(x) for x in (q, k, v, do, pos))
        out = flash_attention_plain(tq, tk, tv, tpos, scale=scale, sliding_window_size=window)
        got = _kernel_model(tq, tk, tv, tpos, out, tdo, scale, window, split=False, pairs=False)
        worst = max([worst] + [_err_over_rms(a, b) for a, b in zip(got, want)])
    assert worst > 2e-2


def test_pairs_keep_more_digits_than_bf16():
    """The f32 pairs' model lies at least 30x closer to the exact f32
    gradient than the one that rounds every operand to bf16 once, on the
    same f32 inputs: what the extra products buy."""
    q, k, v, do, pos = (torch.from_numpy(x) for x in _inputs(2, seed=5))
    scale = DH ** -0.5
    out = flash_attention_plain(q, k, v, pos, scale=scale)
    exact = flash_attention_bwd_plain(q, k, v, pos, out, do, scale=scale)
    pairs = _kernel_model(q, k, v, pos, out, do, scale, None, split=True)
    bf16 = _kernel_model(q, k, v, pos, out, do, scale, None, split=False, pairs=False)
    for x, y, e in zip(pairs, bf16, exact):
        assert 30 * (x - e).abs().max() < (y - e).abs().max()


@pytest.mark.parametrize("dh", [32, 64, 128, 256])
@pytest.mark.parametrize("f32", [False, True])
def test_bwd_plan_fits_and_slices(dh, f32):
    """Every instantiation streams tiles of 64 rows (32 for f32 at Dh 256,
    where one 64-row stage of hi + lo would not fit 227 KB), cuts Dh 128 /
    256 into 2 / 4 dK/dV column slices of 64, and keeps three dK/dV blocks
    a SM up to Dh 64 for bf16 inputs (two for f32), one past it."""
    plan = bwd_plan(dh, f32)
    assert plan.tile == (32 if f32 and dh == 256 else 64)
    assert plan.dkdv_slices == max(1, dh // 64)
    assert plan.blocks_per_sm == ((2 if f32 else 3) if dh <= 64 else 1)


def test_bwd_plan_is_a_function_of_the_instantiation():
    """A head dim runs in the next instantiation up (24 in 32, 200 in
    256) with that plan; past 256 and off multiples of 8 K3b has none."""
    assert bwd_plan(24) == bwd_plan(32) and bwd_plan(200, True) == bwd_plan(256, True)
    assert bwd_plan(128) == bwd_plan(128, True) and bwd_plan(256) != bwd_plan(256, True)
    for dh in (264, 512, 20, 0):
        with pytest.raises(ValueError):
            bwd_plan(dh)


@pytest.mark.parametrize("s,h,g,c,dh,f32,want", [
    (512, 6, 2, 1024, 64, True, 8),  # the trainer's shape: 24 query tiles, 8 key tiles with work
    (256, 32, 8, 1024, 64, False, 4),  # the flagship's heads
    (256, 4, 1, 1024, 256, False, 3),  # Dh 256: 4 column slices of 16 key tiles, one block a SM
    (256, 4, 1, 1024, 256, True, 3),  # f32 at Dh 256: 32-row query tiles
    (16, 32, 8, 4096, 64, False, 1),  # a chunk over a long cache: blocks fill the card
])
def test_bwd_parts(s, h, g, c, dh, f32, want):
    """The dK/dV launch's parts from shapes only, each whole tiles and
    none empty, with the f32 plans' tile and blocks per SM."""
    parts = bwd_parts(s, h, g, c, dh, 132, f32)
    row_tiles = -(-s * (h // g) // bwd_plan(dh, f32).tile)
    per = -(-row_tiles // parts)
    assert parts == want and (parts - 1) * per < row_tiles <= parts * per


@pytest.mark.parametrize("f32", [False, True])
@pytest.mark.parametrize("parts", [1, 3])
def test_bwd_scratch_bytes(f32, parts):
    """K3b's scratch: D, dO's bf16 pair, for f32 the bf16 pairs of q, k
    and v, and with parts the partial dK and dV, each piece rounded to 256
    bytes in the kernel's order."""
    s, h, g, c, dh = 5, 6, 2, 37, 24

    def r(n):
        return -(-n // 256) * 256

    nq, nkv = s * h * dh, c * g * dh
    want = r(4 * s * h) + (4 if f32 else 2) * r(2 * nq) + (4 * r(2 * nkv) if f32 else 0)
    want += 2 * r(4 * parts * nkv) if parts > 1 else 0
    assert bwd_scratch_bytes(s, h, g, c, dh, f32, parts) == want
