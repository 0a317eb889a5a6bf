"""The PyTorch port's model path against the JAX package, on the CPU.

Tiny Llama-shaped INT4 flagships (4 layers, d 256, as `bench.py` makes
for the CPU) are synthesized by both packages' synthesizers, loaded by
both, and run through both: files, configs, arrays, the weight carry-over,
teacher-forced logits and greedy streams, with the JAX package both in its
default (XLA) kernel mode and in its Pallas mode (interpret mode on the
CPU).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uzu_tpu import LanguageModel as JaxLM
from uzu_tpu.config import dump as jax_dump
from uzu_tpu.config.model import IntSpec as JaxIntSpec, Layout as JaxLayout, MLXSpec as JaxMLX
from uzu_tpu.models.decoder import decoder_forward as jax_forward
from uzu_tpu.tools.synth import llama_config as jax_llama, synthesize as jax_synth
from uzu_tpu_torch import LanguageModel
from uzu_tpu_torch.config import dump as port_dump
from uzu_tpu_torch.config.model import IntSpec, Layout, MLXSpec
from uzu_tpu_torch.convert import from_numpy_tree
from uzu_tpu_torch.engine.engine import ContextOverflowError
from uzu_tpu_torch.models.decoder import decoder_forward
from uzu_tpu_torch.quant.format import QuantizedTensor
from uzu_tpu_torch.tools.synth import llama_config, synthesize

torch.set_num_threads(1)

TINY = dict(num_layers=4, model_dim=256, hidden_dim=1024, num_heads=8, num_groups=2,
            head_dim=32, vocab_size=2048)  # bench.py's CPU flagship
SPEC = dict(bits=4, group_size=32, is_symmetric=True)


def _jax_spec(kind="int4"):
    if kind == "mlx4":
        return JaxMLX(bits=4, group_size=32, layout=JaxLayout.OUTPUT_INPUT)
    bits, sym = {"int4": (4, True), "int8_zp": (8, False)}[kind]
    return JaxIntSpec(bits=bits, group_size=32, is_symmetric=sym, layout=JaxLayout.OUTPUT_INPUT)


def _port_spec(kind="int4"):
    if kind == "mlx4":
        return MLXSpec(bits=4, group_size=32, layout=Layout.OUTPUT_INPUT)
    bits, sym = {"int4": (4, True), "int8_zp": (8, False)}[kind]
    return IntSpec(bits=bits, group_size=32, is_symmetric=sym, layout=Layout.OUTPUT_INPUT)


@pytest.fixture(scope="module")
def model_dirs(tmp_path_factory):
    """{name: dir} of tiny INT4 flagships written by the JAX synthesizer."""
    root = tmp_path_factory.mktemp("torch_port_models")
    out = {}
    for name, kw, dtype in (("bf16", {}, None), ("f32", {}, np.float32),
                            ("untied", {"tied": False}, None)):
        extra = {} if dtype is None else {"dtype": dtype}
        out[name] = jax_synth(jax_llama(**TINY, **kw), str(root / name), seed=0,
                              linear_spec=_jax_spec(), embedding_spec=_jax_spec(), **extra)
    return out


@pytest.fixture(scope="module")
def jax_models():
    """JAX models cached per (model, kernel mode): each traces its steps once."""
    return {}


def _jax_lm(cache, model_dirs, name, mode, monkeypatch):
    if mode == "pallas":
        monkeypatch.setenv("UZU_TPU_KERNELS", "pallas")
    else:
        monkeypatch.delenv("UZU_TPU_KERNELS", raising=False)
    key = (name, mode)
    if key not in cache:
        cache[key] = JaxLM.from_dir(model_dirs[name], max_context=512)
    return cache[key]


# -- files, configs, arrays ----------------------------------------------------------

@pytest.mark.parametrize("kind", ["int4", "int8_zp", "mlx4"])
@pytest.mark.parametrize("tied", [True, False])
def test_synthesize_writes_identical_files(tmp_path, kind, tied):
    dims = dict(TINY, num_layers=2, model_dim=64, hidden_dim=128, vocab_size=256, tied=tied)
    a = jax_synth(jax_llama(**dims), str(tmp_path / "jax"), seed=3,
                  linear_spec=_jax_spec(kind), embedding_spec=_jax_spec("int4"))
    b = synthesize(llama_config(**dims), str(tmp_path / "port"), seed=3,
                   linear_spec=_port_spec(kind), embedding_spec=_port_spec("int4"))
    for f in ("config.json", "model.safetensors"):
        with open(f"{a}/{f}", "rb") as fa, open(f"{b}/{f}", "rb") as fb:
            assert fa.read() == fb.read(), f


def test_synthesize_full_precision_bf16_identical(tmp_path):
    dims = dict(TINY, num_layers=1, model_dim=64, hidden_dim=128, vocab_size=256)
    a = jax_synth(jax_llama(**dims), str(tmp_path / "jax"), seed=1)
    b = synthesize(llama_config(**dims), str(tmp_path / "port"), seed=1)
    with open(f"{a}/model.safetensors", "rb") as fa, open(f"{b}/model.safetensors", "rb") as fb:
        assert fa.read() == fb.read()


def _assert_tree_equal(port, ref):
    """port: the port's parameter tree; ref: the JAX tree with numpy leaves."""
    if isinstance(port, QuantizedTensor):
        assert (port.bits, port.group_size, port.qbias_coeff) == (
            ref.bits, ref.group_size, ref.qbias_coeff)
        assert (port.qbias is None) == (ref.qbias is None)
        pairs = [(port.codes, ref.codes), (port.scales, ref.scales)]
        if port.qbias is not None:
            pairs.append((port.qbias, ref.qbias))
    elif isinstance(port, dict):
        assert sorted(port) == sorted(ref)
        for k in port:
            _assert_tree_equal(port[k], ref[k])
        return
    elif isinstance(port, list):
        assert len(port) == len(ref)
        for p, r in zip(port, ref):
            _assert_tree_equal(p, r)
        return
    else:
        pairs = [(port, ref)]
    for t, a in pairs:
        a = np.asarray(a)
        assert tuple(t.shape) == a.shape
        np.testing.assert_array_equal(t.float().numpy(), a.astype(np.float32))


@pytest.mark.parametrize("name", ["bf16", "f32", "untied"])
def test_loaders_agree_on_config_and_arrays(model_dirs, jax_models, name, monkeypatch):
    jlm = _jax_lm(jax_models, model_dirs, name, "default", monkeypatch)
    lm = LanguageModel.from_dir(model_dirs[name], device="cpu", max_context=512)
    assert json.dumps(port_dump(lm.config)) == json.dumps(jax_dump(jlm.config))
    _assert_tree_equal(lm.params, jax.tree.map(np.asarray, jlm.params))


@pytest.mark.parametrize("name", ["bf16", "untied"])
def test_convert_matches_port_loader(model_dirs, jax_models, name, monkeypatch):
    jlm = _jax_lm(jax_models, model_dirs, name, "default", monkeypatch)
    lm = LanguageModel.from_dir(model_dirs[name], device="cpu", max_context=512)
    converted = from_numpy_tree(jax.tree.map(np.asarray, jlm.params))

    def check(a, b):
        if isinstance(a, QuantizedTensor):
            assert (a.bits, a.group_size, a.qbias_coeff) == (b.bits, b.group_size, b.qbias_coeff)
            for x, y in ((a.codes, b.codes), (a.scales, b.scales)):
                assert x.dtype == y.dtype and torch.equal(x, y)
        elif isinstance(a, dict):
            assert sorted(a) == sorted(b)
            for k in a:
                check(a[k], b[k])
        elif isinstance(a, list):
            for x, y in zip(a, b):
                check(x, y)
        else:
            assert a.dtype == b.dtype and torch.equal(a, b)

    check(converted, lm.params)


# -- logits and streams --------------------------------------------------------------

def _prompt(n, mul, off):
    return (np.arange(n) * mul + off) % TINY["vocab_size"]


def _logits_both(jlm, lm, toks):
    want, _ = jax_forward(jlm.decoder_config, jlm.params, jnp.asarray(toks, jnp.int32),
                          jlm.new_state(), last_only=False)
    got, _ = decoder_forward(lm.decoder_config, lm.params, torch.as_tensor(toks),
                             lm.new_state(), last_only=False)
    return got.numpy(), np.asarray(want)


@pytest.mark.parametrize("n", [12, 40, 100])
def test_teacher_forced_logits_match_default_mode(model_dirs, jax_models, n, monkeypatch):
    jlm = _jax_lm(jax_models, model_dirs, "f32", "default", monkeypatch)
    lm = LanguageModel.from_dir(model_dirs["f32"], device="cpu", max_context=512)
    got, want = _logits_both(jlm, lm, _prompt(n, 37, 5))
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3)


def test_teacher_forced_logits_match_pallas_mode(model_dirs, jax_models, monkeypatch):
    """12 tokens x 4 heads per group stay below the flash gate (64 rows):
    every linear runs through the JAX Pallas quant-matmul kernel."""
    jlm = _jax_lm(jax_models, model_dirs, "f32", "pallas", monkeypatch)
    lm = LanguageModel.from_dir(model_dirs["f32"], device="cpu", max_context=512)
    got, want = _logits_both(jlm, lm, _prompt(12, 37, 5))
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3)


def test_teacher_forced_logits_match_pallas_flash(model_dirs, jax_models, monkeypatch):
    """40 tokens engage the JAX flash kernel, which rounds q, k, p and v to
    bf16 inside its accumulate step: held at its own tests' 2e-2."""
    jlm = _jax_lm(jax_models, model_dirs, "f32", "pallas", monkeypatch)
    lm = LanguageModel.from_dir(model_dirs["f32"], device="cpu", max_context=512)
    got, want = _logits_both(jlm, lm, _prompt(40, 37, 5))
    np.testing.assert_allclose(got, want, rtol=2e-2, atol=2e-2)


# (prompt length, multiplier, offset): 20 tokens pad into the 64 bucket;
# 300 tokens take a 256 chunk and a padded 64 chunk
PROMPTS = [(20, 37, 5), (300, 101, 3)]


@pytest.mark.parametrize("name", ["bf16", "untied"])
@pytest.mark.parametrize("mode", ["default", "pallas"])
@pytest.mark.parametrize("prompt", PROMPTS)
def test_greedy_stream_matches_jax(model_dirs, jax_models, name, mode, prompt, monkeypatch):
    lm = LanguageModel.from_dir(model_dirs[name], device="cpu", max_context=512)
    toks = _prompt(*prompt)
    got = lm.generate_list(toks, 16, stop_token_ids=[])
    # precondition: every step's choice is clear of the numeric noise
    seq = np.concatenate([toks, got])
    logits, _ = decoder_forward(lm.decoder_config, lm.params, torch.as_tensor(seq),
                                lm.new_state(), last_only=False)
    rows = logits[len(toks) - 1: len(toks) - 1 + len(got)]
    top2 = torch.topk(rows, 2).values
    assert rows.argmax(-1).tolist() == got
    assert (top2[:, 0] - top2[:, 1]).min().item() > 1e-2
    jlm = _jax_lm(jax_models, model_dirs, name, mode, monkeypatch)
    assert jlm.generate_list(toks, 16, stop_token_ids=[]) == got


def test_chunked_prefill_matches_one_pass(model_dirs):
    lm = LanguageModel.from_dir(model_dirs["f32"], device="cpu", max_context=512)
    toks = _prompt(300, 37, 5)
    last, state = lm.prefill(lm.new_state(), toks)
    assert int(state["pos"]) == 300
    full, _ = decoder_forward(lm.decoder_config, lm.params, torch.as_tensor(toks),
                              lm.new_state(), last_only=False)
    np.testing.assert_allclose(last.numpy(), full[-1].numpy(), rtol=1e-4, atol=1e-4)


def test_stop_tokens_and_context_overflow(model_dirs):
    lm = LanguageModel.from_dir(model_dirs["untied"], device="cpu", max_context=512)
    toks = _prompt(300, 101, 3)
    stream = lm.generate_list(toks, 16, stop_token_ids=[])
    stopped = lm.generate_list(toks, 16, stop_token_ids=[stream[3]])
    assert stopped == stream[:stream.index(stream[3]) + 1]
    with pytest.raises(ContextOverflowError):
        lm.prefill(lm.new_state(), _prompt(513, 1, 0))
    assert len(lm.generate_list(_prompt(500, 1, 0), 64, stop_token_ids=[])) == 12


def test_context_buckets_match_full_context(model_dirs):
    """max_context 2048 reads 1024-slot buckets; 512 reads the whole cache."""
    toks = _prompt(300, 101, 3)
    for name, tol in (("f32", 1e-5), ("untied", None)):
        small = LanguageModel.from_dir(model_dirs[name], device="cpu", max_context=512)
        large = LanguageModel.from_dir(model_dirs[name], device="cpu", max_context=2048)
        assert large._ctx_bucket(300 + 64) == 1024 and small._ctx_bucket(364) is None
        if tol is not None:
            a, _ = small.prefill(small.new_state(), toks)
            b, _ = large.prefill(large.new_state(), toks)
            np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=tol, atol=tol)
        else:
            assert (large.generate_list(toks, 12, stop_token_ids=[])
                    == small.generate_list(toks, 12, stop_token_ids=[]))


def test_sampled_generation_reproducible_with_penalty_ring(model_dirs):
    from uzu_tpu_torch import SamplingParams

    lm = LanguageModel.from_dir(model_dirs["untied"], device="cpu", max_context=512)
    toks = _prompt(20, 37, 5)
    params = SamplingParams(temperature=0.9, top_k=40, top_p=0.95,
                            repetition_penalty=1.3, suffix_repetition_length=8)
    a = lm.generate_list(toks, 20, sampling=params, seed=7, stop_token_ids=[])
    b = lm.generate_list(toks, 20, sampling=params, seed=7, stop_token_ids=[])
    c = lm.generate_list(toks, 20, sampling=params, seed=8, stop_token_ids=[])
    assert a == b and len(a) == 20 and a != c
    assert all(0 <= t < TINY["vocab_size"] for t in a)
