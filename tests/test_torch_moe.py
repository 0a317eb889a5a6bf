"""The port's mixture-of-experts path against the JAX package, on the CPU.

Kernels K7/K8 (`ops/cuda/moe_gemv.py`) and K9/K10
(`ops/cuda/grouped_matmul.py`) through their plain versions, the router and
the grouped layout, `moe_forward` on every branch of its routing table, and
tiny gpt-oss models (INT4, INT8 and f32 dense expert stacks) single-stream
and through `PagedBatchEngine`. Inputs come from seeded numpy generators
and go to both packages; the JAX package runs in its default (XLA) mode and
in its Pallas mode (kernels interpreted on the CPU). Tolerances are 1e-4 in
f32 unless a case says why it differs.
"""

import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import uzu_tpu.models.moe as jmoe
import uzu_tpu_torch.models.moe as tmoe
from uzu_tpu import LanguageModel as JaxLM
from uzu_tpu.config.model import IntSpec as JaxIntSpec, Layout as JaxLayout
from uzu_tpu.models.decoder import decoder_forward as jax_forward
from uzu_tpu.ops.pallas import grouped_matmul as jgm
from uzu_tpu.ops.pallas.moe_gemv import moe_expert_gemv as jax_gemv
from uzu_tpu.quant import format as jq
from uzu_tpu.tools.synth import gptoss_config as jax_gptoss, moe_config as jax_moe_cfg
from uzu_tpu.tools.synth import synthesize as jax_synth
from uzu_tpu_torch import LanguageModel
from uzu_tpu_torch.config.model import IntSpec, Layout
from uzu_tpu_torch.convert import from_numpy_tree
from uzu_tpu_torch.engine.paged_batch import PagedBatchEngine
from uzu_tpu_torch.models.decoder import decoder_forward
from uzu_tpu_torch.models.paged_decode import paged_supported
from uzu_tpu_torch.ops.cuda import build
from uzu_tpu_torch.ops.cuda.grouped_matmul import (
    grouped_matmul,
    grouped_matmul_quant,
    route_layout,
)
from uzu_tpu_torch.ops.cuda.moe_gemv import moe_expert_gemv
from uzu_tpu_torch.quant.format import StackedQuantized, dequantize_stacked
from uzu_tpu_torch.tools.synth import gptoss_config, moe_config, synthesize

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BM = 64  # the port's m-tile; the JAX kernels are called with the same bm

# dff a multiple of 64, so that the JAX side's grouped gates take K9/K10
GPTOSS = dict(num_layers=2, model_dim=64, num_heads=4, num_groups=2, head_dim=16,
              vocab_size=512, num_experts=8, num_active=2, expert_hidden_dim=128)


def _specs(bits):
    if bits is None:
        return None, None
    kw = dict(bits=bits, group_size=32, is_symmetric=True)
    return (JaxIntSpec(layout=JaxLayout.OUTPUT_INPUT, **kw),
            IntSpec(layout=Layout.OUTPUT_INPUT, **kw))


def _np(a):
    return np.asarray(a.float().numpy() if isinstance(a, torch.Tensor) else a, np.float32)


# -- the synthesizer and the converter -----------------------------------------------------

@pytest.mark.parametrize("fill", ["normal", "fast"])
@pytest.mark.parametrize("bits", [None, 4, 8], ids=["dense", "int4", "int8"])
@pytest.mark.parametrize("which", ["gptoss", "moe"])
def test_synthesize_writes_identical_moe_files(tmp_path, which, bits, fill):
    jcfg, pcfg = ((jax_gptoss(**GPTOSS), gptoss_config(**GPTOSS)) if which == "gptoss"
                  else (jax_moe_cfg(), moe_config()))
    jspec, pspec = _specs(bits)
    a = jax_synth(jcfg, str(tmp_path / "jax"), seed=4, expert_spec=jspec, fill=fill)
    b = synthesize(pcfg, str(tmp_path / "port"), seed=4, expert_spec=pspec, fill=fill)
    for f in ("config.json", "model.safetensors"):
        with open(f"{a}/{f}", "rb") as fa, open(f"{b}/{f}", "rb") as fb:
            assert fa.read() == fb.read(), f


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    """{name: dir} of tiny f32 gpt-oss models with INT4, INT8 and dense
    expert stacks (bf16 would round the activations differently per
    package; f32 keeps the comparison at the algorithm)."""
    root = tmp_path_factory.mktemp("torch_moe")
    out = {}
    for name, bits in (("int4", 4), ("int8", 8), ("dense", None)):
        out[name] = synthesize(gptoss_config(**GPTOSS), str(root / name), seed=5,
                               expert_spec=_specs(bits)[1], dtype=np.float32)
    return out


@pytest.fixture(scope="module")
def jax_models():
    return {}


def _jax_lm(cache, models, name, mode, monkeypatch):
    if mode == "pallas":
        monkeypatch.setenv("UZU_TPU_KERNELS", "pallas")
    else:
        monkeypatch.delenv("UZU_TPU_KERNELS", raising=False)
    if (name, mode) not in cache:
        cache[(name, mode)] = JaxLM.from_dir(models[name], max_context=128,
                                             prefill_buckets=(16,))
    return cache[(name, mode)]


def _port_lm(models, name):
    return LanguageModel.from_dir(models[name], device="cpu", max_context=128,
                                  prefill_buckets=(16,))


@pytest.mark.parametrize("name", ["int4", "int8", "dense"])
def test_loader_and_convert_agree_with_jax_without_lane_padding(models, jax_models, name,
                                                                monkeypatch):
    """d = 64: the JAX loader pads the down stack's rows to 128; the
    converter cuts them, and the result equals the port's own loader
    exactly, expert stacks, biases and all."""
    jlm = _jax_lm(jax_models, models, name, "default", monkeypatch)
    lm = _port_lm(models, name)
    jmlp = jlm.params["layers"][0]["mlp"]
    assert jmlp["down"]["w"].shape[1] == 128 and jmlp["down"]["b"].shape == (8, 128)
    converted = from_numpy_tree(jax.tree.map(np.asarray, jlm.params))

    def check(a, b):
        if isinstance(a, StackedQuantized):
            assert isinstance(b, StackedQuantized)
            assert (a.bits, a.group_size, a.qbias_coeff) == (b.bits, b.group_size, b.qbias_coeff)
            check(a.codes, b.codes)
            check(a.scales, b.scales)
        elif isinstance(a, dict):
            assert sorted(a) == sorted(b)
            for k in a:
                check(a[k], b[k])
        elif isinstance(a, list):
            assert len(a) == len(b)
            for x, y in zip(a, b):
                check(x, y)
        else:
            assert a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)

    check(converted, lm.params)
    mlp = lm.params["layers"][0]["mlp"]
    assert mlp["down"]["b"].shape == (8, 64)
    if name != "dense":
        assert isinstance(mlp["up"]["w"], StackedQuantized)
        assert mlp["up"]["w"].shape == (8, 256, 64) and mlp["down"]["w"].shape == (8, 64, 128)


# -- router and layout ---------------------------------------------------------------------

def _mlp_cfg(cfg=None):
    cfg = cfg or gptoss_config(**GPTOSS)
    return cfg.decoder_config.transformer_config.layer_configs[0].mlp_config


def test_router_topk_ties_go_to_the_lower_expert():
    """Planted ties: every logit equals its bias (w = 0), and experts 2 and
    5 share their weights (same logit for every x). Both packages take the
    lower id first."""
    cfg = _mlp_cfg()
    rng = np.random.default_rng(3)
    x = rng.standard_normal((6, 64)).astype(np.float32)
    w = rng.standard_normal((8, 64)).astype(np.float32)
    w[5] = w[2]
    b = np.zeros(8, np.float32)
    b[[2, 5]] = 50.0  # 2 and 5 top every row, tied
    cases = [(w, b, [2, 5]),
             (np.zeros_like(w), np.asarray([1, 3, 3, 2, 3, 0, 0, 1], np.float32), [1, 2])]
    for wi, bi, want in cases:
        jids, jprobs = jmoe.router_topk(_mlp_cfg(jax_gptoss(**GPTOSS)), {"router": {"w": jnp.asarray(wi),
                                                          "b": jnp.asarray(bi)}},
                                        jnp.asarray(x))
        ids, probs = tmoe.router_topk(cfg, {"router": {"w": torch.from_numpy(wi),
                                                        "b": torch.from_numpy(bi)}},
                                      torch.from_numpy(x))
        assert ids.tolist() == np.asarray(jids).tolist() == [want] * 6
        np.testing.assert_allclose(probs.numpy(), np.asarray(jprobs), rtol=1e-6, atol=1e-6)


ROUTINGS = {
    "uniform": lambda t, e: np.arange(t) % e,
    "one_expert": lambda t, e: np.full(t, 3),
    "empty_experts": lambda t, e: (np.random.default_rng(t).integers(0, e, t) // 2) * 2,
}


@pytest.mark.parametrize("routing", list(ROUTINGS))
@pytest.mark.parametrize("t", [1, 32, 200])
def test_route_layout_matches_jax(routing, t):
    e = 8
    flat = ROUTINGS[routing](t, e).astype(np.int32)
    want = [np.asarray(a) for a in jgm.route_layout(jnp.asarray(flat), e, BM)]
    got = route_layout(torch.from_numpy(flat), e)
    for g, w, name in zip(got, want, ("order", "dst", "tile_expert", "used", "row_expert")):
        assert g.tolist() == w.tolist(), name
    assert got[0].shape[0] == t and got[4].shape[0] == -(-t // BM) * BM + e * BM


# -- K7/K8 (moe_gemv) and K9/K10 (grouped matmul) plain versions ---------------------------

def _stack(rng, e, n, k, bits, g=32):
    """(JAX StackedQuantized, port StackedQuantized) of the same codes and
    f32 scales."""
    codes = jq.pack_codes(rng.integers(0, 1 << bits, (e, n, k), dtype=np.uint8), bits)
    scales = (rng.random((e, n, k // g)).astype(np.float32) * 0.02 + 0.01)
    coeff = -float(1 << (bits - 1))
    return (jq.StackedQuantized(codes=jnp.asarray(codes), scales=jnp.asarray(scales),
                                bits=bits, group_size=g, qbias_coeff=coeff),
            StackedQuantized(torch.from_numpy(codes), torch.from_numpy(scales), bits, g, coeff))


@pytest.mark.parametrize("bits,n,k", [(4, 256, 512), (4, 256, 352), (8, 256, 512),
                                      (4, 512, 4096)])
def test_moe_gemv_plain_matches_pallas_interpret(bits, n, k):
    """The four cases of the JAX package's own K7/K8 test; pairs repeat
    experts and tokens as a routed step does."""
    rng = np.random.default_rng(bits + n + k)
    jsq, sq = _stack(rng, 5, n, k, bits)
    ids = np.asarray([0, 3, 3, 4, 1, 0], np.int32)
    x = rng.standard_normal((6, k)).astype(np.float32)
    want = np.asarray(jax_gemv(jsq, jnp.asarray(x), jnp.asarray(ids), interpret=True))
    got = moe_expert_gemv(sq, torch.from_numpy(x), torch.from_numpy(ids))
    assert got.dtype == torch.float32 and got.shape == (6, n)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


def _routed(rng, t, e, k):
    flat = rng.integers(0, e, t).astype(np.int32)
    order, dst, te, used, _ = jgm.route_layout(jnp.asarray(flat), e, BM)
    tp = -(-t // BM) * BM + e * BM
    x_pad = np.zeros((tp, k), np.float32)
    x_pad[np.asarray(dst)] = rng.standard_normal((t, k)).astype(np.float32)
    return x_pad, np.array(te), np.array(used), np.array(dst)


@pytest.mark.parametrize("n,k", [(256, 128), (128, 384), (512, 4096)])
def test_grouped_quant_plain_matches_pallas_interpret(n, k):
    """K9: interpret mode runs its dots in f32, as the plain version does;
    only the real rows (dst) are defined output."""
    rng = np.random.default_rng(n + k)
    jsq, sq = _stack(rng, 5, n, k, 4)
    x_pad, te, used, dst = _routed(rng, 70, 5, k)
    want = np.asarray(jgm.grouped_matmul_quant(jnp.asarray(x_pad), jsq, jnp.asarray(te),
                                               jnp.asarray(used), bm=BM, interpret=True))
    got = grouped_matmul_quant(torch.from_numpy(x_pad), sq, torch.from_numpy(te),
                               torch.from_numpy(used))
    np.testing.assert_allclose(got.numpy()[dst], want[dst], rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("n,k", [(256, 128), (128, 384)])
def test_grouped_plain_matches_pallas_interpret_and_xla(n, k, dtype):
    """K10 over dense stacks; bf16 inputs are rounded once and handed to
    both packages, whose products of bf16 values sum in f32."""
    rng = np.random.default_rng(n * k)
    x_pad, te, used, dst = _routed(rng, 90, 6, k)
    w = (rng.standard_normal((6, n, k)) * 0.1).astype(np.float32)
    tdt = torch.float32 if dtype == "f32" else torch.bfloat16
    tx, tw = torch.from_numpy(x_pad).to(tdt), torch.from_numpy(w).to(tdt)
    jdt = jnp.float32 if dtype == "f32" else jnp.bfloat16
    jx, jw = jnp.asarray(_np(tx)).astype(jdt), jnp.asarray(_np(tw)).astype(jdt)
    got = grouped_matmul(tx, tw, torch.from_numpy(te), torch.from_numpy(used)).numpy()
    interp = np.asarray(jgm.grouped_matmul(jx, jw, jnp.asarray(te), jnp.asarray(used), bm=BM,
                                           interpret=True))
    xla = np.asarray(jgm.grouped_matmul_xla(jx, jw, jnp.asarray(te), jnp.asarray(used), bm=BM))
    np.testing.assert_allclose(got[dst], interp[dst], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got, xla, rtol=1e-4, atol=1e-4)


def test_plain_dequantize_stacked_equals_jax():
    """Dequantization exact in f32 and bf16; shape, nbytes and each
    expert's plane as a `QuantizedTensor` as in the JAX package."""
    from uzu_tpu_torch.quant.format import dequantize

    rng = np.random.default_rng(8)
    for bits in (4, 8):
        jsq, sq = _stack(rng, 3, 64, 96, bits)
        assert sq.shape == jsq.shape == (3, 64, 96) and sq.nbytes == jsq.nbytes
        for jdt, tdt in ((jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)):
            want = np.asarray(jq.dequantize_stacked(jsq, jdt).astype(jnp.float32))
            got = dequantize_stacked(sq, tdt).float().numpy()
            np.testing.assert_array_equal(got, want)
        for i in range(3):
            want = np.asarray(jq.dequantize(jsq.expert(i), jnp.float32))
            np.testing.assert_array_equal(dequantize(sq.expert(i), torch.float32).numpy(), want)


def test_wrappers_launch_nothing_on_cpu_and_check_before_launch(monkeypatch):
    rng = np.random.default_rng(9)
    _, sq4 = _stack(rng, 4, 64, 128, 4)
    _, sq8 = _stack(rng, 4, 64, 128, 8)
    x = torch.from_numpy(rng.standard_normal((3, 128)).astype(np.float32))
    ids = torch.tensor([0, 3, 1])
    x_pad = torch.zeros((128, 128))
    te, used = torch.zeros(2, dtype=torch.int32), torch.ones(1, dtype=torch.int32)
    before = dict(build.LAUNCHES)
    moe_expert_gemv(sq4, x, ids)
    grouped_matmul_quant(x_pad, sq4, te, used)
    grouped_matmul(x_pad, dequantize_stacked(sq4), te, used)
    assert build.LAUNCHES == before
    with pytest.raises(ValueError, match="do not fit"):
        moe_expert_gemv(sq4, x[:, :64], ids)
    monkeypatch.setattr(torch.Tensor, "device", property(lambda t: torch.device("cuda")))
    with pytest.raises(ValueError, match="f32 x_pairs"):
        moe_expert_gemv(sq4, x.to(torch.bfloat16), ids)
    with pytest.raises(ValueError, match="INT4 stack"):
        grouped_matmul_quant(x_pad, sq8, te, used)
    with pytest.raises(ValueError, match="do not fit"):
        grouped_matmul_quant(x_pad[:100], sq4, te, used)
    with pytest.raises(ValueError, match="bf16 or f32 stack"):
        grouped_matmul(x_pad, torch.zeros((4, 64, 128), dtype=torch.float16), te, used)


def test_moe_path_has_no_host_sync():
    """No call that waits for the device sits in the MoE path or its kernel
    wrappers, so the paged engine's fused K-step decode chunk stays one
    host sync per chunk (the card run also checks it with the sync
    debug mode)."""
    for rel in ("models/moe.py", "ops/cuda/moe_gemv.py", "ops/cuda/grouped_matmul.py"):
        with open(os.path.join(REPO, "uzu_tpu_torch", rel)) as f:
            src = f.read()
        for call in (".item(", ".cpu(", ".tolist(", ".numpy(", "nonzero(", "bincount("):
            assert call not in src, (rel, call)


# -- moe_forward on every branch -----------------------------------------------------------

# rows per branch: the gather (decode) width, a prefill chunk, and the
# grouped width with GROUPED_PATH_MIN_TOKENS lowered to 16 in both packages
BRANCHES = {"gather": 3, "chunk": 12, "grouped": 16}


@pytest.mark.parametrize("branch", list(BRANCHES))
@pytest.mark.parametrize("name", ["int4", "int8", "dense"])
@pytest.mark.parametrize("mode", ["default", "pallas"])
def test_moe_forward_matches_jax_on_every_branch(models, jax_models, name, branch, mode,
                                                 monkeypatch):
    """The port routes as the JAX Pallas mode does. Against that mode (its
    K10 branch run through `_grouped_forward` in interpret mode, since
    Pallas on the CPU needs it) every branch agrees at 1e-4. The JAX default
    mode takes the same arithmetic except where it rounds differently:
    INT4 chunks multiply a bf16-materialized stack where K9 dequantizes in
    f32, and INT8 grouped chunks feed f32 rows to its masked loop where K10
    takes the stack's bf16 rows; those two agree at 2e-2."""
    jlm = _jax_lm(jax_models, models, name, mode, monkeypatch)
    lm = _port_lm(models, name)
    monkeypatch.setattr(jmoe, "GROUPED_PATH_MIN_TOKENS", 16)
    monkeypatch.setattr(tmoe, "GROUPED_PATH_MIN_TOKENS", 16)
    if mode == "pallas":
        monkeypatch.setattr(jmoe, "_grouped_forward",
                            functools.partial(jmoe._grouped_forward, interpret=True))
    cfg = _mlp_cfg()
    s = BRANCHES[branch]
    x = np.random.default_rng(s).standard_normal((s, 64)).astype(np.float32)
    want = np.asarray(jmoe.moe_forward(_mlp_cfg(jlm.config), jlm.params["layers"][1]["mlp"],
                                       jnp.asarray(x)))
    got = tmoe.moe_forward(cfg, lm.params["layers"][1]["mlp"], torch.from_numpy(x))
    assert got.shape == (s, 64) and got.dtype == torch.float32
    rounds_apart = mode == "default" and (
        (name == "int4" and branch != "gather") or (name == "int8" and branch == "grouped"))
    tol = 2e-2 if rounds_apart else 1e-4
    np.testing.assert_allclose(got.numpy(), want, rtol=tol, atol=tol)


def test_moe_forward_takes_the_tables_kernels(models, monkeypatch):
    """Which wrapper each branch calls (counted through the port's modules)."""
    monkeypatch.setattr(tmoe, "GROUPED_PATH_MIN_TOKENS", 16)
    calls = []
    for fn in ("moe_expert_gemv", "grouped_matmul_quant", "grouped_matmul"):
        real = getattr(tmoe, fn)
        monkeypatch.setattr(tmoe, fn, functools.partial(
            lambda real, fn, *a: (calls.append(fn), real(*a))[1], real, fn))
    cfg = _mlp_cfg()
    want = {
        "int4": {"gather": "moe_expert_gemv", "chunk": "grouped_matmul_quant",
                 "grouped": "grouped_matmul_quant"},
        "int8": {"gather": "moe_expert_gemv", "chunk": None, "grouped": "grouped_matmul"},
        "dense": {"gather": None, "chunk": None, "grouped": "grouped_matmul"},
    }
    for name, branches in want.items():
        params = _port_lm(models, name).params["layers"][0]["mlp"]
        for branch, fn in branches.items():
            calls.clear()
            tmoe.moe_forward(cfg, params, torch.zeros((BRANCHES[branch], 64)))
            assert calls == ([] if fn is None else [fn, fn]), (name, branch)


# -- whole models --------------------------------------------------------------------------

PROMPT = (np.arange(12) * 7 + 100) % 512  # one chunk of the 16-row bucket


@pytest.mark.parametrize("grouped", [False, True], ids=["chunk", "grouped"])
@pytest.mark.parametrize("name", ["int4", "int8", "dense"])
@pytest.mark.parametrize("mode", ["default", "pallas"])
def test_teacher_forced_logits_match_jax(models, jax_models, name, mode, grouped,
                                         monkeypatch):
    """12 tokens: 12 x 2 heads per group stays below the JAX flash gate, so
    the JAX Pallas mode differs only in the expert kernels. Tolerance as in
    the branch test above (2e-2 where the JAX default mode rounds its
    expert inputs to bf16 and the port does not, or the other way)."""
    jlm = _jax_lm(jax_models, models, name, mode, monkeypatch)
    lm = _port_lm(models, name)
    if grouped:
        monkeypatch.setattr(jmoe, "GROUPED_PATH_MIN_TOKENS", 12)
        monkeypatch.setattr(tmoe, "GROUPED_PATH_MIN_TOKENS", 12)
        if mode == "pallas":
            monkeypatch.setattr(jmoe, "_grouped_forward",
                                functools.partial(jmoe._grouped_forward, interpret=True))
    want, _ = jax_forward(jlm.decoder_config, jlm.params, jnp.asarray(PROMPT, jnp.int32),
                          jlm.new_state(), last_only=False)
    got, _ = decoder_forward(lm.decoder_config, lm.params, torch.as_tensor(PROMPT),
                             lm.new_state(), last_only=False)
    rounds_apart = mode == "default" and (name == "int4" or (name == "int8" and grouped))
    tol = 2e-2 if rounds_apart else 1e-4
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol, atol=tol)


def _greedy_clear(lm, prompt, tokens):
    """Every step of the port's stream is its teacher-forced argmax with a
    top-2 margin clear of the two packages' numeric differences."""
    seq = np.concatenate([prompt, tokens])
    logits, _ = decoder_forward(lm.decoder_config, lm.params, torch.as_tensor(seq),
                                lm.new_state(), last_only=False)
    rows = logits[len(prompt) - 1: len(prompt) - 1 + len(tokens)]
    top2 = torch.topk(rows, 2).values
    assert rows.argmax(-1).tolist() == tokens
    assert (top2[:, 0] - top2[:, 1]).min().item() > 1e-2


@pytest.mark.parametrize("name", ["int4", "int8", "dense"])
@pytest.mark.parametrize("mode", ["default", "pallas"])
def test_greedy_stream_matches_jax(models, jax_models, name, mode, monkeypatch):
    """Prefill through the chunk branch, decode through the gather branch
    (K7/K8 for the quantized stacks): the port's stream is its own
    teacher-forced greedy stream and the JAX package's."""
    lm = _port_lm(models, name)
    got = lm.generate_list(PROMPT, 10, stop_token_ids=[])
    _greedy_clear(lm, PROMPT, got)
    jlm = _jax_lm(jax_models, models, name, mode, monkeypatch)
    assert jlm.generate_list(PROMPT, 10, stop_token_ids=[]) == got


@pytest.mark.parametrize("name", ["int4", "dense"])
def test_paged_engine_serves_moe_as_the_single_stream(models, name):
    """Six slots: the paged decode step routes 6 rows, past the gather
    width, so it takes the chunk branch (K9 for INT4) while the single
    stream decodes through the gather branch (K7); the streams agree."""
    lm = _port_lm(models, name)
    assert paged_supported(lm.decoder_config)
    prompts = [[1, 2, 3], list(range(2, 30)), [9, 8, 7], [400, 3], list(range(50, 61)),
               [7] * 5, [300, 200, 100, 50]]
    wants = [lm.generate_list(np.asarray(p), 8, stop_token_ids=[]) for p in prompts]
    eng = PagedBatchEngine(lm, batch_size=6, decode_chunk=4, num_pages=60, page_size=8,
                           stop_token_ids=[])
    reqs = [eng.submit(p, 8) for p in prompts]
    eng.run()
    assert [r.tokens for r in reqs] == wants
    assert all(r.finished for r in reqs)


def test_moe_decoder_prefill_equals_decode(models):
    """Prefill of 9 tokens at once (chunk branch) and token by token
    (gather branch) give the same last logits on the INT4 model."""
    lm = _port_lm(models, "int4")
    toks = (np.arange(9) * 7) % 512
    one, _ = lm.prefill(lm.new_state(), toks)
    state = lm.new_state()
    for t in toks:
        step, state = lm.prefill(state, np.asarray([t]))
    np.testing.assert_allclose(one.numpy(), step.numpy(), rtol=1e-4, atol=1e-4)


# -- shared experts ------------------------------------------------------------------------

def _shared(rng, d, width, scale=0.1):
    """A "shared" subtree (up [2*width, d], down [d, width]) as numpy f32."""
    return {"up": {"w": (rng.standard_normal((2 * width, d)) * scale).astype(np.float32)},
            "down": {"w": (rng.standard_normal((d, width)) * scale).astype(np.float32)}}


@pytest.mark.parametrize("branch", list(BRANCHES))
@pytest.mark.parametrize("name", ["int4", "int8", "dense"])
@pytest.mark.parametrize("shared", [1, 2])
def test_moe_forward_with_shared_experts_matches_jax(models, jax_models, name, branch, shared,
                                                      monkeypatch):
    """The JAX `_finish_moe` term on every branch (gather, the chunk: K9
    for INT4, the dequantized INT8 stack's masked loop, the dense masked
    loop; grouped at GROUPED_PATH_MIN_TOKENS lowered to 16), against the
    JAX Pallas mode with its K10 branch interpreted: within 1e-5 of RMS
    (f32 throughout)."""
    jlm = _jax_lm(jax_models, models, name, "pallas", monkeypatch)
    lm = _port_lm(models, name)
    monkeypatch.setattr(jmoe, "GROUPED_PATH_MIN_TOKENS", 16)
    monkeypatch.setattr(tmoe, "GROUPED_PATH_MIN_TOKENS", 16)
    monkeypatch.setattr(jmoe, "_grouped_forward",
                        functools.partial(jmoe._grouped_forward, interpret=True))
    rng = np.random.default_rng(shared * 10 + BRANCHES[branch])
    sh = _shared(rng, 64, 128 * shared)
    cfg = dataclasses.replace(_mlp_cfg(), num_shared_experts=shared)
    jcfg = dataclasses.replace(_mlp_cfg(jlm.config), num_shared_experts=shared)
    jparams = dict(jlm.params["layers"][1]["mlp"], shared=jax.tree.map(jnp.asarray, sh))
    params = dict(lm.params["layers"][1]["mlp"], shared=jax.tree.map(torch.from_numpy, sh))
    s = BRANCHES[branch]
    x = rng.standard_normal((s, 64)).astype(np.float32)
    want = np.asarray(jmoe.moe_forward(jcfg, jparams, jnp.asarray(x)))
    got = tmoe.moe_forward(cfg, params, torch.from_numpy(x)).numpy()
    without = tmoe.moe_forward(cfg, lm.params["layers"][1]["mlp"], torch.from_numpy(x)).numpy()
    rms = np.sqrt(np.mean(want.astype(np.float64) ** 2))
    assert np.max(np.abs(got - want)) <= 1e-5 * rms
    assert np.max(np.abs(got - without)) > 0.1 * rms  # the shared term is no rounding error


def _with_shared_experts(src: str, dst: str, spec: IntSpec | None = None) -> str:
    """Copy a model directory, adding one shared expert (dff wide) to every
    MoE layer, written with the port's safetensors_io: full precision, or
    quantized per `spec`."""
    import json

    from uzu_tpu_torch.config import dumps as config_dumps
    from uzu_tpu_torch.params.safetensors_io import SafetensorsFile, save_file
    from uzu_tpu_torch.quant.format import quantize_reference

    os.makedirs(dst)
    f = SafetensorsFile(os.path.join(src, "model.safetensors"))
    tensors = {k: f.read(k) for k in f.keys()}
    metadata = dict(f.metadata)
    with open(os.path.join(src, "config.json")) as fc:
        cfg = json.load(fc)

    def set_shared(node):
        if isinstance(node, dict):
            if "num_shared_experts" in node:
                node["num_shared_experts"] = 1
            for v in node.values():
                set_shared(v)
        elif isinstance(node, list):
            for v in node:
                set_shared(v)

    set_shared(cfg)
    rng = np.random.default_rng(21)
    layers = {k.split(".")[2] for k in tensors if k.startswith("transformer.layers.")}
    for i in sorted(layers):
        p = f"transformer.layers.{i}.mlp"
        for role, shape in (("up_projection", (256, 64)), ("down_projection", (64, 128))):
            prefix = f"{p}.shared_experts.{role}.weights"
            w = (rng.standard_normal(shape) * 0.1).astype(np.float32)
            if spec is None:
                metadata[f"{prefix}.spec"] = metadata[f"{p}.router.weights.spec"]
                tensors[f"{prefix}.weights"] = w
            else:
                metadata[f"{prefix}.spec"] = config_dumps(spec)
                for leaf, arr in quantize_reference(w, spec.bits, spec.group_size,
                                                    dtype=np.float32).items():
                    tensors[f"{prefix}.{leaf}"] = arr
    save_file(os.path.join(dst, "model.safetensors"), tensors, metadata)
    with open(os.path.join(dst, "config.json"), "w") as fc:
        json.dump(cfg, fc)
    return dst


@pytest.mark.parametrize("name", ["dense", "int4"])
def test_model_with_shared_experts_loads_and_matches_jax(models, tmp_path, name):
    """`load_moe` reads `shared_experts.*` written with the port's
    safetensors_io; the tree equals the JAX package's converted one, and
    teacher-forced logits match the JAX default mode's at 1e-4 (dense) or
    2e-2 (INT4: the JAX default mode multiplies its chunk by a
    bf16-materialized stack)."""
    d = _with_shared_experts(models[name], str(tmp_path / "shared"))
    lm = LanguageModel.from_dir(d, device="cpu", max_context=128, prefill_buckets=(16,))
    jlm = JaxLM.from_dir(d, max_context=128, prefill_buckets=(16,))
    mlp = lm.params["layers"][0]["mlp"]
    assert mlp["shared"]["up"]["w"].shape == (256, 64)
    assert mlp["shared"]["down"]["w"].shape == (64, 128)
    converted = from_numpy_tree(jax.tree.map(np.asarray, jlm.params))
    for i, layer in enumerate(lm.params["layers"]):
        for role in ("up", "down"):
            assert torch.equal(converted["layers"][i]["mlp"]["shared"][role]["w"],
                               layer["mlp"]["shared"][role]["w"])
    want, _ = jax_forward(jlm.decoder_config, jlm.params, jnp.asarray(PROMPT, jnp.int32),
                          jlm.new_state(), last_only=False)
    got, _ = decoder_forward(lm.decoder_config, lm.params, torch.as_tensor(PROMPT),
                             lm.new_state(), last_only=False)
    tol = 1e-4 if name == "dense" else 2e-2
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol, atol=tol)


def test_quantized_shared_experts_are_refused(models, tmp_path):
    """The JAX package multiplies shared experts as dense arrays, so the
    port serves no quantized one either: the loader says so."""
    from uzu_tpu_torch.params.tree import ParameterError

    spec = IntSpec(bits=4, group_size=32, is_symmetric=True, layout=Layout.OUTPUT_INPUT)
    d = _with_shared_experts(models["dense"], str(tmp_path / "shared_q"), spec)
    with pytest.raises(ParameterError, match="full-precision"):
        LanguageModel.from_dir(d, device="cpu", max_context=128)
