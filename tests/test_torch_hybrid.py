"""The port's HybridSpec linears (QLoRA adapter + Hadamard incoherence)
against the JAX package, on the CPU.

The same numpy-seeded inputs go through `uzu_tpu.ops.rht` and the port's
`ops/rht.py`, through the JAX `linear_apply` and the port's
`hybrid_apply` (f32 and bf16), through both synthesizers (identical
bytes) and both loaders (identical arrays, the same refusals), and, as
whole tiny Llama models with HybridSpec linears, through both packages'
`from_dir`: teacher-forced logits, greedy streams, and the port's
`BatchEngine` and `PagedBatchEngine` held to its single stream.
"""

import filecmp

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from uzu_tpu import LanguageModel as JaxLM
from uzu_tpu.config import model as jcfg
from uzu_tpu.models import loader as jloader
from uzu_tpu.models.decoder import decoder_forward as jax_forward
from uzu_tpu.ops import rht as jrht
from uzu_tpu.ops.linear import linear_apply as jax_linear_apply
from uzu_tpu.params import safetensors_io as jio
from uzu_tpu.params.tree import ParameterError as JaxParameterError
from uzu_tpu.params.tree import ParameterLoader as JaxLoader
from uzu_tpu.tools import synth as jsynth
from uzu_tpu_torch import LanguageModel
from uzu_tpu_torch.config import dumps as port_dumps
from uzu_tpu_torch.config import model as pcfg
from uzu_tpu_torch.convert import from_numpy_tree
from uzu_tpu_torch.engine.batch import BatchEngine
from uzu_tpu_torch.engine.paged_batch import PagedBatchEngine
from uzu_tpu_torch.models import loader as ploader
from uzu_tpu_torch.models.decoder import decoder_forward
from uzu_tpu_torch.ops import rht as prht
from uzu_tpu_torch.ops.linear import hybrid_apply, linear_apply
from uzu_tpu_torch.params import safetensors_io as pio
from uzu_tpu_torch.params.tree import ParameterError, ParameterLoader
from uzu_tpu_torch.quant.format import HybridLinear, QuantizedTensor
from uzu_tpu_torch.tools import synth as psynth

torch.set_num_threads(1)

BF16_EPS = 2.0 ** -7  # bf16's machine epsilon: one ulp at 1
TINY = dict(num_layers=2, model_dim=64, hidden_dim=160, num_heads=4, num_groups=2,
            head_dim=16, vocab_size=256)
# (adapter rank, incoherence): every combination the loader takes
VARIANTS = [(None, True), (4, True), (4, False), (None, False)]


def _spec(mod, rank, incoherence, block=32, mode="INPUT_OUTPUT", adapter=None):
    return mod.HybridSpec(
        quantization_spec=mod.IntSpec(bits=4, group_size=32, is_symmetric=True,
                                      layout=mod.Layout.OUTPUT_INPUT),
        adapter_spec=adapter if adapter is not None else (
            mod.LowRankSpec(rank=rank) if rank else None),
        incoherence_block_size=block if incoherence else None,
        incoherence_processing_mode=getattr(mod.IncoherenceProcessingMode, mode),
    )


def _bf16(a: np.ndarray) -> np.ndarray:
    """f32 values rounded to bf16 (nearest even), back in f32."""
    return pio.bf16_to_f32(pio.to_bf16(a))


# -- the Hadamard transform ----------------------------------------------------------


@settings(max_examples=30, deadline=None)
@given(blocks=st.integers(1, 8), lead=st.lists(st.integers(1, 3), max_size=2),
       seed=st.integers(0, 2**16))
def test_rht_matches_jax(blocks, lead, seed):
    """input_rht / output_rht of f32 x [*lead, K], K = 32 * blocks: within
    1e-6 of JAX (JAX sums 32 terms in f32, the port in f64 rounded once);
    of bf16 x, within one bf16 ulp of each value, or that same 1e-6 where
    a sum cancels to near zero (JAX's f32 sum leaves ~6e-8 there where the
    port's f64 one gives 0)."""
    rng = np.random.default_rng(seed)
    k = 32 * blocks
    x = rng.standard_normal((*lead, k)).astype(np.float32)
    signs = rng.choice([-1, 1], k).astype(np.float32)
    for fn in ("input_rht", "output_rht"):
        want = np.asarray(getattr(jrht, fn)(jnp.asarray(x), jnp.asarray(signs)))
        got = getattr(prht, fn)(torch.from_numpy(x), torch.from_numpy(signs))
        assert got.dtype == torch.float32 and tuple(got.shape) == x.shape
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
        xb = _bf16(x)
        want = np.asarray(getattr(jrht, fn)(jnp.asarray(xb).astype(jnp.bfloat16),
                                            jnp.asarray(signs)).astype(jnp.float32))
        got = getattr(prht, fn)(torch.from_numpy(xb).to(torch.bfloat16),
                                torch.from_numpy(signs))
        assert got.dtype == torch.bfloat16
        np.testing.assert_allclose(got.float().numpy(), want, rtol=BF16_EPS, atol=1e-6)


def test_rht_needs_whole_blocks():
    with pytest.raises(AssertionError, match="K % 32"):
        prht.input_rht(torch.zeros(3, 48), torch.ones(48))


def test_transform_weight_for_storage_equals_jax():
    rng = np.random.default_rng(3)
    w = rng.standard_normal((96, 64)).astype(np.float32)
    si = rng.choice([-1, 1], 64).astype(np.int32)
    so = rng.choice([-1, 1], 96).astype(np.int32)
    want = jrht.transform_weight_for_storage(w, si, so)
    got = prht.transform_weight_for_storage(w, si, so)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    # and it composes to identity: output_rht(W' @ input_rht(x)) == W @ x
    x = rng.standard_normal((3, 64)).astype(np.float32)
    xb = prht.input_rht(torch.from_numpy(x), torch.from_numpy(si.astype(np.float32)))
    y = prht.output_rht(xb @ torch.from_numpy(got.astype(np.float32)).t(),
                        torch.from_numpy(so.astype(np.float32)))
    np.testing.assert_allclose(y.numpy(), x @ w.T, rtol=1e-4, atol=1e-4)


# -- one linear: loaders and hybrid_apply -------------------------------------------


def _linear_file(tmp_path, rank, incoherence, dtype, k=64, n=96, seed=7, biases=False,
                 pow2_scales=False):
    """One HybridSpec linear "lin" [n, k] written by the JAX synthesizer;
    with `pow2_scales` its base's scales are rounded to powers of two, so
    every dequantized weight is exact in bf16."""
    b = jsynth.ModelBuilder(seed=seed, dtype=dtype)
    b.linear("lin", k, n, _spec(jcfg, rank, incoherence), biases)
    if pow2_scales:
        key = "lin.weights.quantized.scales"
        sc = b.tensors[key].astype(np.float32)
        b.tensors[key] = (np.sign(sc) * 2.0 ** np.round(np.log2(np.abs(sc)))).astype(
            b.tensors[key].dtype)
    path = str(tmp_path / "lin.safetensors")
    jio.save_file(path, b.tensors, b.metadata)
    return path


def _both_linears(path, k=64, n=96, biases=False):
    jl = jloader.load_linear(JaxLoader(path).tree().subtree("lin"), k, n, biases)
    pl = ploader.load_linear(ParameterLoader(path).tree().subtree("lin"), k, n, biases)
    return jl, pl


@pytest.mark.parametrize("rank,incoherence", VARIANTS)
@pytest.mark.parametrize("dtype", ["f32", "bf16_pow2_scales", "bf16"])
def test_hybrid_apply_matches_jax(tmp_path, rank, incoherence, dtype):
    """hybrid_apply against the JAX `linear_apply` on [5, 64] x, the same
    file loaded by both. f32: within 1e-5 of RMS. bf16 (weights, adapter
    and x) take the same roundings in the same order: the adapter's down
    product on the raw x in f32, the base on input_rht(x) rounded to bf16,
    the adapter's up product added in f32, one bf16 rounding, output_rht
    rounded once. With the base's scales powers of two, both packages'
    dequantized weights are exact, and the outputs agree within one bf16
    ulp of their RMS. With the scales as drawn, JAX's XLA route rounds the
    dequantized weights to bf16 before its product where K1's plain
    version keeps them in f32, which alone moves the outputs by up to 3.1
    bf16 ulps of RMS over 48 draws (as much without adapter and signs):
    held at 4."""
    np_dtype = np.float32 if dtype == "f32" else jio._DTYPES["BF16"]
    path = _linear_file(tmp_path, rank, incoherence, np_dtype,
                        pow2_scales=dtype == "bf16_pow2_scales")
    jl, pl = _both_linears(path)
    assert isinstance(pl["w"], HybridLinear) and isinstance(pl["w"].base, QuantizedTensor)
    assert (pl["w"].adapter_down is None) == (rank is None)
    assert (pl["w"].input_signs is None) == (not incoherence)
    x = np.random.default_rng(11).standard_normal((5, 64)).astype(np.float32)
    if dtype == "f32":
        want = np.asarray(jax_linear_apply(jl["w"], jnp.asarray(x)))
        got = linear_apply(pl["w"], torch.from_numpy(x))
        assert got.dtype == torch.float32
        tol = 1e-5
    else:
        xb = _bf16(x)
        want = np.asarray(jax_linear_apply(jl["w"], jnp.asarray(xb).astype(jnp.bfloat16))
                          .astype(jnp.float32))
        got = hybrid_apply(pl["w"], torch.from_numpy(xb).to(torch.bfloat16))
        assert got.dtype == torch.bfloat16
        tol = BF16_EPS if dtype == "bf16_pow2_scales" else 4 * BF16_EPS
    rms = float(np.sqrt(np.mean(want.astype(np.float64) ** 2)))
    err = float(np.abs(got.float().numpy() - want).max())
    assert err <= tol * rms, (err / rms, tol)


@pytest.mark.parametrize("rank,incoherence", VARIANTS)
def test_loaders_agree_on_hybrid_arrays(tmp_path, rank, incoherence):
    """Both loaders read the same arrays: codes and scales, the adapter in
    the file's own dtype, the signs int32 on disk and f32 in memory; and
    `from_numpy_tree` carries the JAX `HybridLinear` across unchanged."""
    path = _linear_file(tmp_path, rank, incoherence, jio._DTYPES["BF16"])
    jl, pl = _both_linears(path)
    converted = from_numpy_tree(jax.tree.map(np.asarray, jl))["w"]
    for port in (pl["w"], converted):
        assert isinstance(port, HybridLinear)
        assert port.shape == (96, 64) and port.dtype == torch.bfloat16
        ref = jl["w"]
        pairs = [(port.base.codes, ref.base.codes), (port.base.scales, ref.base.scales)]
        for f in ("adapter_down", "adapter_up", "input_signs", "output_signs"):
            a, b = getattr(port, f), getattr(ref, f)
            assert (a is None) == (b is None), f
            if a is not None:
                pairs.append((a, b))
        for t, a in pairs:
            a = np.asarray(a)
            assert tuple(t.shape) == a.shape
            assert str(t.dtype).split(".")[-1] == ("bfloat16" if a.dtype.name == "bfloat16"
                                                   else a.dtype.name)
            np.testing.assert_array_equal(t.float().numpy(), a.astype(np.float32))
    if incoherence:
        assert pl["w"].input_signs.dtype == torch.float32
    x = torch.randn(3, 64, generator=torch.Generator().manual_seed(0)).to(torch.bfloat16)
    assert torch.equal(hybrid_apply(pl["w"], x), hybrid_apply(converted, x))


def _refused(tmp_path, name, bad_spec, biases=False):
    """A valid HybridSpec linear's file with its spec replaced by
    `bad_spec` (and biases where asked)."""
    b = psynth.ModelBuilder(seed=1, dtype=np.float32)
    b.linear("lin", 64, 32, _spec(pcfg, 4, True), biases)
    b.metadata["lin.weights.spec"] = port_dumps(bad_spec)
    path = str(tmp_path / f"{name}.safetensors")
    pio.save_file(path, b.tensors, b.metadata)
    return path


@pytest.mark.parametrize("case", ["biases", "adapter", "block", "mode", "base"])
def test_hybrid_loader_refusals_match_jax(tmp_path, case):
    """The port's loader raises `ParameterError` where the JAX loader does,
    with the same message: an adapter with biases, a non-LowRank adapter,
    an incoherence block other than 32, a mode other than INPUT_OUTPUT, a
    full-precision base."""
    fp = pcfg.FullPrecisionSpec(layout=pcfg.Layout.OUTPUT_INPUT)
    bad = {"biases": _spec(pcfg, 4, True),
           "adapter": _spec(pcfg, None, True, adapter=fp),
           "block": _spec(pcfg, 4, True, block=16),
           "mode": _spec(pcfg, 4, True, mode="INPUT"),
           "base": pcfg.HybridSpec(quantization_spec=fp, adapter_spec=None,
                                   incoherence_block_size=None,
                                   incoherence_processing_mode=(
                                       pcfg.IncoherenceProcessingMode.INPUT_OUTPUT))}[case]
    biases = case == "biases"
    path = _refused(tmp_path, case, bad, biases=biases)
    with pytest.raises(JaxParameterError) as jerr:
        jloader.load_linear(JaxLoader(path).tree().subtree("lin"), 64, 32, biases)
    with pytest.raises(ParameterError) as perr:
        ploader.load_linear(ParameterLoader(path).tree().subtree("lin"), 64, 32, biases)
    assert str(perr.value) == str(jerr.value)


# -- whole models -------------------------------------------------------------------


@pytest.mark.parametrize("rank,incoherence", VARIANTS[:3])
@pytest.mark.parametrize("fill", ["normal", "fast"])
def test_synthesizers_write_identical_hybrid_files(tmp_path, rank, incoherence, fill):
    """The port's synthesizer draws the JAX one's numbers in its order
    (weights, input signs, output signs, then the adapter) and writes the
    same bytes, bf16 included."""
    int4 = dict(bits=4, group_size=32, is_symmetric=True)
    a = jsynth.synthesize(jsynth.llama_config(**TINY), str(tmp_path / "jax"), seed=5,
                          linear_spec=_spec(jcfg, rank, incoherence), fill=fill,
                          embedding_spec=jcfg.IntSpec(**int4, layout=jcfg.Layout.OUTPUT_INPUT))
    b = psynth.synthesize(psynth.llama_config(**TINY), str(tmp_path / "port"), seed=5,
                          linear_spec=_spec(pcfg, rank, incoherence), fill=fill,
                          embedding_spec=pcfg.IntSpec(**int4, layout=pcfg.Layout.OUTPUT_INPUT))
    for f in ("config.json", "model.safetensors"):
        assert filecmp.cmp(f"{a}/{f}", f"{b}/{f}", shallow=False), f


@pytest.fixture(scope="module")
def hybrid_models(tmp_path_factory):
    """{(rank, incoherence, dtype): dir} of tiny untied Llamas whose every
    linear is HybridSpec (INT4 g32 base), written by the JAX synthesizer."""
    root = tmp_path_factory.mktemp("torch_hybrid")
    out = {}
    for rank, inc in VARIANTS[:3]:
        for name, dtype in (("f32", np.float32), ("bf16", jio._DTYPES["BF16"])):
            out[(rank, inc, name)] = jsynth.synthesize(
                jsynth.llama_config(**TINY, tied=False), str(root / f"{rank}_{inc}_{name}"),
                seed=5, linear_spec=_spec(jcfg, rank, inc), dtype=dtype)
    return out


def _prompt(n, mul=37, off=5):
    return (np.arange(n) * mul + off) % TINY["vocab_size"]


@pytest.mark.parametrize("rank,incoherence", VARIANTS[:3])
@pytest.mark.parametrize("n", [12, 40])
def test_hybrid_model_logits_match_jax(hybrid_models, rank, incoherence, n):
    """Teacher-forced logits of the f32 model through `from_dir` in both
    packages: within 1e-4 (f32 sums in another order)."""
    d = hybrid_models[(rank, incoherence, "f32")]
    jlm = JaxLM.from_dir(d, max_context=128, prefill_buckets=(16, 64))
    lm = LanguageModel.from_dir(d, device="cpu", max_context=128, prefill_buckets=(16, 64))
    toks = _prompt(n)
    want, _ = jax_forward(jlm.decoder_config, jlm.params, jnp.asarray(toks, jnp.int32),
                          jlm.new_state(), last_only=False)
    got, _ = decoder_forward(lm.decoder_config, lm.params, torch.as_tensor(toks),
                             lm.new_state(), last_only=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


MARGIN = 1e-3  # 10x the 1e-4 by which the two packages' f32 logits part (above)


@pytest.mark.parametrize("rank,incoherence", VARIANTS[:3])
def test_hybrid_greedy_stream_matches_jax(hybrid_models, rank, incoherence):
    """Greedy streams of the f32 model in both packages are equal up to
    the first step whose top-2 margin (on the port's own history) is under
    MARGIN, where the noise above may break the tie either way; past it
    the histories differ."""
    d = hybrid_models[(rank, incoherence, "f32")]
    lm = LanguageModel.from_dir(d, device="cpu", max_context=128, prefill_buckets=(16, 64))
    toks = _prompt(20)
    got = lm.generate_list(toks, 12, stop_token_ids=[])
    seq = np.concatenate([toks, got])
    logits, _ = decoder_forward(lm.decoder_config, lm.params, torch.as_tensor(seq),
                                lm.new_state(), last_only=False)
    rows = logits[len(toks) - 1: len(toks) - 1 + len(got)]
    assert rows.argmax(-1).tolist() == got
    top2 = torch.topk(rows, 2).values
    margins = (top2[:, 0] - top2[:, 1]).tolist()
    jlm = JaxLM.from_dir(d, max_context=128, prefill_buckets=(16, 64))
    want = jlm.generate_list(toks, 12, stop_token_ids=[])
    same = next((i for i, (a, b) in enumerate(zip(got, want)) if a != b), len(got))
    assert same == len(got) or margins[same] < MARGIN, (same, margins[same])
    assert min(margins[:same], default=0.0) >= 0.0 and same >= 1


@pytest.mark.parametrize("engine", ["dense", "paged"])
def test_batched_engines_run_hybrid_linears(hybrid_models, engine):
    """The dense `BatchEngine` and `PagedBatchEngine` over the bf16 model
    with adapter and incoherence: every greedy stream equals the port's
    single stream (one bf16 row at a time in both)."""
    d = hybrid_models[(4, True, "bf16")]
    lm = LanguageModel.from_dir(d, device="cpu", max_context=128, prefill_buckets=(16,))
    prompts = [_prompt(3), _prompt(30, 13, 2), _prompt(9, 7, 1)]
    if engine == "dense":
        eng = BatchEngine(lm, batch_size=2, decode_chunk=4, stop_token_ids=[])
    else:
        eng = PagedBatchEngine(lm, batch_size=2, decode_chunk=4, num_pages=40, page_size=8,
                               stop_token_ids=[])
    reqs = [eng.submit(p.tolist(), 8) for p in prompts]
    eng.run()
    for r, p in zip(reqs, prompts):
        assert r.tokens == lm.generate_list(p, 8, stop_token_ids=[])


@pytest.mark.parametrize("rank,incoherence", VARIANTS)
@pytest.mark.parametrize("x_dtype", [torch.bfloat16, torch.float32])
def test_hybrid_apply_rows_do_not_depend_on_the_row_count(tmp_path, rank, incoherence,
                                                           x_dtype, monkeypatch):
    """Each row of an 8-row `hybrid_apply` (K 2048, rank 16; bf16 x, and
    f32 x as the card-against-host checks run it) is bitwise the
    row's own one-row result: the Hadamard and adapter products run in f64,
    rounded to f32 once, where an f32 product's summation order (and so a
    bf16 rounding downstream) changes with the row count. The base runs
    row by row here, as K1's rows on the card do (its plain version, an
    f32 matmul on the host, does not)."""
    import uzu_tpu_torch.ops.linear as plinear

    real = plinear.quant_matmul
    monkeypatch.setattr(plinear, "quant_matmul", lambda w, x: torch.cat(
        [real(w, x[i:i + 1]) for i in range(x.shape[0])]))
    path = _linear_file(tmp_path, rank and 16, incoherence, jio._DTYPES["BF16"], k=2048,
                        n=1024)
    _, pl = _both_linears(path, k=2048, n=1024)
    x = torch.randn(8, 2048, generator=torch.Generator().manual_seed(3)).to(x_dtype)
    full = hybrid_apply(pl["w"], x)
    rows = torch.cat([hybrid_apply(pl["w"], x[i:i + 1]) for i in range(8)])
    assert torch.equal(full, rows)
    xs = torch.randn(5, 3, 96, generator=torch.Generator().manual_seed(4))
    signs = torch.from_numpy(np.random.default_rng(4).choice([-1.0, 1.0], 96).astype(np.float32))
    for fn in (prht.input_rht, prht.output_rht):
        assert torch.equal(fn(xs, signs)[2:3], fn(xs[2:3], signs))
