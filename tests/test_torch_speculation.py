"""The port's single-stream speculative decoding against the JAX package, on the CPU.

Tiny models at the JAX tests' sizes (`tests/test_speculation.py`), written
once by the port's synthesizer (whose files the JAX package loads as they
are) and run by both packages in f32:

- exact equality: `NgramSpeculator`, `TokenTree`, `NgramTreeSpeculator`,
  `_tree_conv_windows` / `_tree_conv_commit_idx` on random inputs, the
  speculation gates, the DFlash files of both synthesizers (byte for
  byte) and the speculation metrics of a greedy run;
- 1e-4 of RMS: `decoder_forward` with `positions` / `tree_mask` and with
  `collect_layers` taps, `defer_ssm` + `decoder_commit_deferred` at every
  commit length, `ssm_tree_forward` + `ssm_tree_commit` on
  non-consecutive paths for GDN, ShortConv and Mamba2, and
  `DFlashDraft.accept` state and `draft` logits (weights from the files and
  carried over from the JAX draft through `convert.py`);
- greedy streams: each decoder's stream equals the port's plain
  `generate_list` for the llama target, each hybrid family and a tiny
  gpt-oss (MoE, sinks, window), and the JAX decoder's stream wherever the
  top-2 logit margin clears MARGIN_TOL for the llama target and gpt-oss
  (the hybrids' verify forward and commit are held to JAX above); stop
  tokens inside a block, budget clipping, context exhaustion, resumption
  through `.state`;
- the port's in-place KV writes: a ring and a full cache give the same
  stream through rejected rounds, two DFlash drafts from one state give
  the same candidates, a self-draft shares the target's tensors, and a
  non-consecutive tree path leaves the state of the accepted sequence.
"""

import filecmp

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uzu_tpu import LanguageModel as JaxLM
from uzu_tpu.engine import dflash as jdflash
from uzu_tpu.engine import speculation as jspec
from uzu_tpu.models import ssm as jssm
from uzu_tpu.models.decoder import (
    decoder_commit_deferred as jax_commit,
    decoder_forward as jax_forward,
)
from uzu_tpu.tools import synth as jsynth
from uzu_tpu_torch import LanguageModel
from uzu_tpu_torch.config.model import IntSpec, Layout
from uzu_tpu_torch.convert import from_numpy_tree
from uzu_tpu_torch.engine import speculation as spec
from uzu_tpu_torch.engine.dflash import DFlashDraft
from uzu_tpu_torch.models import ssm
from uzu_tpu_torch.models.decoder import decoder_commit_deferred, decoder_forward
from uzu_tpu_torch.tools import synth

torch.set_num_threads(1)

RMS_TOL = 1e-4  # max |port - JAX| over RMS(JAX): f32 on both sides
MARGIN_TOL = 1e-3  # streams are compared up to the first step with a smaller top-2 margin

LLAMA = dict(num_layers=2, model_dim=64, hidden_dim=160, num_heads=4, num_groups=2,
             head_dim=16, vocab_size=256)
DRAFT = dict(num_layers=1, model_dim=32, hidden_dim=64, num_heads=2, num_groups=1,
             head_dim=16, vocab_size=256)
GPTOSS = dict(num_layers=2, model_dim=64, num_heads=4, num_groups=2, head_dim=16,
              vocab_size=512, num_experts=8, num_active=2, expert_hidden_dim=128)
HYBRIDS = ("qwen35", "lfm2", "mamba2")
REPEAT = np.array([1, 2, 3, 4, 1, 2, 3, 4, 1, 2])


def _close_rms(got, want, tol=RMS_TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    rms = max(float(np.sqrt(np.mean(want ** 2))), 1e-30)
    err = float(np.abs(got - want).max()) / rms
    assert err <= tol, f"max error {err:.3e} of RMS > {tol}"


def _close_state(got, want):
    """A state leaf: 1e-4 of RMS in f32; a bf16 leaf (ShortConv's conv
    tail) within one bf16 step, since f32 sums that differ in the last
    bits (another row count, another package) may round to neighbouring
    bf16 values."""
    if got.dtype == torch.bfloat16:
        np.testing.assert_allclose(_np(got), _np(want), rtol=2 ** -7, atol=1e-6)
    else:
        _close_rms(_np(got), _np(want))


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)


class _Models:
    """The tiny targets, synthesized and loaded on first use: {name: (port
    LanguageModel, JAX LanguageModel, model dir)}."""

    def __init__(self, root):
        self.root = root
        self.cache = {}

    def config(self, name):
        if name in ("llama", "draft"):
            return synth.llama_config(**(LLAMA if name == "llama" else DRAFT))
        if name == "gptoss":
            return synth.gptoss_config(**GPTOSS)
        return {"qwen35": synth.qwen35_config, "lfm2": synth.lfm2_config,
                "mamba2": synth.mamba2_hybrid_config}[name]()

    def get(self, name, max_context=128):
        key = (name, max_context)
        if key not in self.cache:
            d = str(self.root / name)
            if not any(n == name for n, _ in self.cache):
                kw = {}
                if name == "gptoss":
                    kw["expert_spec"] = IntSpec(bits=4, group_size=32, is_symmetric=True,
                                                layout=Layout.OUTPUT_INPUT)
                synth.synthesize(self.config(name), d, seed=7 if name in ("llama", "draft")
                                 else 3, dtype=np.float32, **kw)
            lm = LanguageModel.from_dir(d, device="cpu", max_context=max_context,
                                        prefill_buckets=(16,))
            jlm = JaxLM.from_dir(d, max_context=max_context, prefill_buckets=(16,))
            self.cache[key] = (lm, jlm, d)
        return self.cache[key]


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    return _Models(tmp_path_factory.mktemp("spec_models"))


def _margins(lm, prompt, stream):
    """Top-2 logit margin of each step of `stream`, from the port's
    teacher-forced logits."""
    toks = torch.as_tensor(np.concatenate([prompt, stream[:-1]]).astype(np.int64))
    logits, _ = decoder_forward(lm.decoder_config, lm.params, toks, lm.new_state(),
                                last_only=False)
    top = torch.topk(logits[len(prompt) - 1:], 2).values
    return (top[:, 0] - top[:, 1]).tolist()


def _agree(lm, prompt, got, want):
    """got equals want up to the first step whose margin is under MARGIN_TOL."""
    margins = _margins(lm, prompt, want)
    clear = next((i for i, m in enumerate(margins) if m < MARGIN_TOL), len(want))
    assert got[:clear] == want[:clear], (clear, got, want)
    return clear


# -- host code: exact equality ----------------------------------------------------------


@pytest.mark.parametrize("seed", range(3))
def test_ngram_speculator_matches_jax(seed):
    rng = np.random.default_rng(seed)
    for _ in range(60):
        hist = rng.integers(0, 5, int(rng.integers(1, 40))).tolist()
        n, k = int(rng.integers(1, 4)), int(rng.integers(1, 6))
        assert (spec.NgramSpeculator(n, k).propose(hist)
                == jspec.NgramSpeculator(n, k).propose(hist))


def _random_tree(rng, tree_cls, size):
    tree = tree_cls(int(rng.integers(0, 50)))
    for _ in range(size - 1):
        tree.add(int(rng.integers(0, len(tree))), int(rng.integers(0, 50)))
    return tree


@pytest.mark.parametrize("seed", range(3))
def test_token_tree_matches_jax(seed):
    rng = np.random.default_rng(seed)
    for _ in range(20):
        size = int(rng.integers(1, 12))
        a = _random_tree(np.random.default_rng(seed * 100 + size), spec.TokenTree, size)
        b = _random_tree(np.random.default_rng(seed * 100 + size), jspec.TokenTree, size)
        assert (a.tokens, a.parents, a.depths()) == (b.tokens, b.parents, b.depths())
        for pad in (size, 16):
            np.testing.assert_array_equal(a.ancestor_mask(pad), b.ancestor_mask(pad))
        assert [a.children(i) for i in range(size)] == [b.children(i) for i in range(size)]
    t = spec.TokenTree(5)
    t.add_chain(0, [1, 2, 3])
    assert t.parents == [-1, 0, 1, 2] and t.depths() == [0, 1, 2, 3]


@pytest.mark.parametrize("seed", range(3))
def test_ngram_tree_speculator_matches_jax(seed):
    rng = np.random.default_rng(seed)
    for _ in range(40):
        hist = rng.integers(0, 4, int(rng.integers(0, 30))).tolist()
        root = int(rng.integers(0, 4))
        kw = dict(max_ngram=int(rng.integers(1, 4)), depth=int(rng.integers(1, 5)),
                  branches=int(rng.integers(1, 4)))
        a = spec.NgramTreeSpeculator(**kw).propose(hist, root)
        b = jspec.NgramTreeSpeculator(**kw).propose(hist, root)
        assert (a.tokens, a.parents) == (b.tokens, b.parents)


@pytest.mark.parametrize("k", [2, 3, 4])
def test_tree_conv_indices_match_jax(k):
    rng = np.random.default_rng(k)
    for _ in range(30):
        m = int(rng.integers(1, 17))
        parents = np.array([-1] + [int(rng.integers(0, j)) for j in range(1, m)], np.int32)
        np.testing.assert_array_equal(spec._tree_conv_windows(parents, k),
                                      jspec._tree_conv_windows(parents, k))
        for last in range(m):
            np.testing.assert_array_equal(spec._tree_conv_commit_idx(parents, last, k),
                                          jspec._tree_conv_commit_idx(parents, last, k))


def test_speculation_gates_match_jax():
    for name in ("llama", "lfm2", "qwen35", "mamba2", "gptoss", "windowed", "gemma"):
        if name == "windowed":
            cfgs = (synth.windowed_config(), jsynth.windowed_config())
        elif name == "gemma":
            cfgs = (synth.gemma_config(), jsynth.gemma_config())
        else:
            cfgs = (_Models(None).config(name),
                    getattr(jsynth, {"llama": "llama_config", "lfm2": "lfm2_config",
                                     "qwen35": "qwen35_config", "mamba2": "mamba2_hybrid_config",
                                     "gptoss": "gptoss_config"}[name])(
                        **(LLAMA if name == "llama" else GPTOSS if name == "gptoss" else {})))
        got, want = (c.decoder_config for c in cfgs)
        assert spec.speculation_supported(got) == jspec.speculation_supported(want)
        assert spec.tree_speculation_supported(got) == jspec.tree_speculation_supported(want)


@pytest.mark.parametrize("target", ["llama", "qwen35"])
@pytest.mark.parametrize("dtype", [np.float32, None])
def test_dflash_files_byte_identical(tmp_path, target, dtype):
    kw = LLAMA if target == "llama" else {}
    cfg = getattr(synth, f"{target}_config")(**kw)
    jcfg = getattr(jsynth, f"{target}_config")(**kw)
    a = synth.synth_dflash_speculator(str(tmp_path / "port"), cfg, block_size=4,
                                      target_layer_ids=(0, 1), seed=3, dtype=dtype)
    b = jsynth.synth_dflash_speculator(str(tmp_path / "jax"), jcfg, block_size=4,
                                       target_layer_ids=(0, 1), seed=3, dtype=dtype)
    for f in ("config.json", "model.safetensors"):
        assert filecmp.cmp(f"{a}/{f}", f"{b}/{f}", shallow=False), f


def test_speculation_metrics_match_jax(models):
    lm, jlm, _ = models.get("llama")
    prompt = np.array([1, 2, 3] * 6)
    got, want = spec.SpeculationMetrics(), jspec.SpeculationMetrics()
    a = list(spec.SpeculativeDecoder(lm, spec.NgramSpeculator(3, 4)).generate(
        prompt, 16, stop_token_ids=[], metrics=got))
    b = list(jspec.SpeculativeDecoder(jlm, jspec.NgramSpeculator(3, 4)).generate(
        prompt, 16, stop_token_ids=[], metrics=want))
    assert a == b
    assert (got.num_tokens_proposed, got.num_tokens_accepted, got.num_verify_passes) == (
        want.num_tokens_proposed, want.num_tokens_accepted, want.num_verify_passes)
    assert got.acceptance_rate == want.acceptance_rate


# -- the decoder's tree, tap and deferred arguments: 1e-4 of RMS --------------------------


def _both_prefilled(lm, jlm, prompt):
    """The port's state after prefilling `prompt`, and the same state as
    the JAX package's arrays (each leaf in the dtype of JAX's own state;
    the two packages' prefills agree, `tests/test_torch_ssm.py`)."""
    _, state = lm.prefill(lm.new_state(), prompt)

    def to_jax(t, like):
        if t is None:
            return None
        if isinstance(t, dict):
            return {k: to_jax(t[k], like[k]) for k in like}
        return jnp.asarray(t.float().numpy() if t.is_floating_point() else t.numpy(),
                           like.dtype)

    template = jlm.new_state()
    jstate = {"layers": [to_jax(t, like) for t, like in zip(state["layers"],
                                                             template["layers"])],
              "pos": jnp.asarray(int(state["pos"]), jnp.int32)}
    return state, jstate


def _tree_inputs(lm, pos, m=8):
    tree = spec.TokenTree(11)
    tree.add(0, 22)
    n2 = tree.add(0, 33)
    tree.add(n2, 44)
    tree.add(1, 55)
    tree.add(n2, 66)
    m_real = len(tree)
    tokens = np.zeros(m, np.int64)
    tokens[:m_real] = tree.tokens
    positions = np.full(m, pos + 63, np.int64)
    positions[:m_real] = [pos + d for d in tree.depths()]
    parents = np.arange(-1, m - 1, dtype=np.int32)
    parents[:m_real] = tree.parents
    return tree, tokens, np.minimum(positions, lm.max_context - 1), tree.ancestor_mask(m), parents


def _jax_moe_mode(name, monkeypatch):
    """gpt-oss's INT4 experts: the JAX package's Pallas mode (its K9 in
    interpret mode) dequantizes as the port does; its default mode rounds
    the stacks to bf16 (`tests/test_torch_moe.py`)."""
    if name == "gptoss":
        monkeypatch.setenv("UZU_TPU_KERNELS", "pallas")


@pytest.mark.parametrize("name", ["llama", "gptoss", *HYBRIDS])
def test_tree_verify_forward_matches_jax(models, name, monkeypatch):
    """decoder_forward over a padded token tree (positions pos + depth,
    the ancestor mask; deferred along ancestor edges on recurrent mixers):
    every row's logits and the attention layers' suffix KV rows."""
    _jax_moe_mode(name, monkeypatch)
    lm, jlm, _ = models.get(name)
    prompt = np.array([5, 9, 2, 7, 3])
    state, jstate = _both_prefilled(lm, jlm, prompt)
    _, tokens, positions, mask, parents = _tree_inputs(lm, len(prompt))
    kw, jkw = {}, {}
    ks = sorted({lc.mixer_config.kernel_size for lc in
                 lm.decoder_config.transformer_config.layer_configs
                 if hasattr(lc.mixer_config, "kernel_size")})
    if ks:
        kw = dict(defer_ssm=True, tree_parents=parents, tree_conv_src={
            k: torch.from_numpy(spec._tree_conv_windows(parents, k)) for k in ks})
        jkw = dict(defer_ssm=True, tree_parents=jnp.asarray(parents), tree_conv_src={
            k: jnp.asarray(jspec._tree_conv_windows(parents, k)) for k in ks})
    logits, out = decoder_forward(lm.decoder_config, lm.params, torch.from_numpy(tokens),
                                  state, last_only=False, positions=torch.from_numpy(positions),
                                  tree_mask=torch.from_numpy(mask), **kw)
    jlogits, jout = jax_forward(jlm.decoder_config, jlm.params, jnp.asarray(tokens), jstate,
                                last_only=False, positions=jnp.asarray(positions),
                                tree_mask=jnp.asarray(mask), **jkw)
    _close_rms(_np(logits), jlogits)
    assert int(out["pos"]) == int(jout["pos"]) == len(prompt) + (0 if ks else len(tokens))
    for layer, jlayer in zip(out["layers"], jout["layers"]):
        if "k" in layer:  # the tree's rows at slots pos .. pos + m - 1
            rows = slice(len(prompt), len(prompt) + len(tokens))
            _close_rms(_np(layer["k"][rows]), np.asarray(jlayer["k"][rows], np.float32))
        else:
            for key in jlayer:
                _close_state(layer[key], jlayer[key])


def test_collect_layers_and_readout_row_match_jax(models):
    lm, jlm, _ = models.get("llama")
    toks = np.array([3, 1, 4, 1, 5, 9, 2, 6, 0, 0, 0, 0, 0, 0, 0, 0])
    taps = (0, 1)
    logits, _, feats = decoder_forward(lm.decoder_config, lm.params, torch.from_numpy(toks),
                                       lm.new_state(), true_length=8, collect_layers=taps)
    jlogits, _, jfeats = jax_forward(jlm.decoder_config, jlm.params, jnp.asarray(toks),
                                     jlm.new_state(), true_length=8, collect_layers=taps)
    assert tuple(feats.shape) == (16, 2, lm.decoder_config.transformer_config.model_dim)
    _close_rms(_np(feats[:8]), np.asarray(jfeats)[:8])
    _close_rms(_np(logits), jlogits)
    row, _ = decoder_forward(lm.decoder_config, lm.params, torch.from_numpy(toks),
                             lm.new_state(), true_length=8, readout_row=3)
    jrow, _ = jax_forward(jlm.decoder_config, jlm.params, jnp.asarray(toks), jlm.new_state(),
                          true_length=8, readout_row=3)
    _close_rms(_np(row), jrow)


_DEFERRED = {}


def _deferred(models, name):
    """The deferred forward of one 6-row block after a prompt, in both
    packages (computed once per model)."""
    if name not in _DEFERRED:
        lm, jlm, _ = models.get(name)
        prompt = np.array([5, 9, 2, 7, 3, 8, 1])
        block = np.array([4, 4, 17, 2, 9, 30])
        state, jstate = _both_prefilled(lm, jlm, prompt)
        logits, pending = decoder_forward(lm.decoder_config, lm.params, torch.from_numpy(block),
                                          state, last_only=False, defer_ssm=True)
        jlogits, jpending = jax_forward(jlm.decoder_config, jlm.params, jnp.asarray(block),
                                        jstate, last_only=False, defer_ssm=True)
        _DEFERRED[name] = (prompt, block, logits, pending, jlogits, jpending)
    return _DEFERRED[name]


@pytest.mark.parametrize("name", HYBRIDS)
@pytest.mark.parametrize("commit", range(1, 7))
def test_deferred_commit_matches_jax(models, name, commit):
    """defer_ssm + decoder_commit_deferred at commit lengths 1..S: logits
    and every committed recurrent state within 1e-4 of RMS of JAX's, and
    the commit equals the port's plain prefill of the committed prefix."""
    lm, jlm, _ = models.get(name)
    prompt, block, logits, pending, jlogits, jpending = _deferred(models, name)
    _close_rms(_np(logits), jlogits)
    assert int(pending["pos"]) == len(prompt)
    got = decoder_commit_deferred(lm.decoder_config, pending,
                                  torch.tensor(commit, dtype=torch.int32))
    want = jax_commit(jlm.decoder_config, jpending, jnp.asarray(commit, jnp.int32))
    assert int(got["pos"]) == int(want["pos"]) == len(prompt) + commit
    # the plain path at the same chunk boundary: a ShortConv tail is
    # stored in bf16 between chunks
    _, plain = lm.prefill(lm.prefill(lm.new_state(), prompt)[1], block[:commit])
    for layer, jlayer, player in zip(got["layers"], want["layers"], plain["layers"]):
        if "ssm" in layer or "conv" in layer:
            for key in jlayer:
                _close_state(layer[key], jlayer[key])
                _close_state(layer[key], player[key])


def _mixer_layer(lm, jlm):
    """(port config, port params, JAX params) of the model's first recurrent layer."""
    lcs = lm.decoder_config.transformer_config.layer_configs
    i = next(i for i, lc in enumerate(lcs) if hasattr(lc.mixer_config, "kernel_size"))
    return (lcs[i].mixer_config, jlm.decoder_config.transformer_config.layer_configs[i]
            .mixer_config, lm.params["layers"][i]["mixer"], jlm.params["layers"][i]["mixer"])


@pytest.mark.parametrize("name", HYBRIDS)
@pytest.mark.parametrize("path", [[0, 2, 3], [0, 1, 4], [0, 2, 5, 6], [0]])
def test_ssm_tree_forward_and_commit_match_jax(models, name, path):
    """ssm_tree_forward on a tree with two branches from the root and an
    incoming non-zero state, then ssm_tree_commit of an accepted path
    (non-consecutive ones included): outputs, replay inputs and the
    committed state within 1e-4 of RMS of JAX's, and the committed state
    equals the plain forward over the path's rows."""
    lm, jlm, _ = models.get(name)
    cfg, jcfg, params, jparams = _mixer_layer(lm, jlm)
    d = lm.decoder_config.transformer_config.model_dim
    rng = np.random.default_rng(len(path) * 7 + path[-1])
    parents = np.array([-1, 0, 0, 2, 1, 2, 5, 6], np.int32)
    x = rng.standard_normal((len(parents), d)).astype(np.float32)
    state = {k: (rng.standard_normal(v.shape) * 0.3).astype(np.float32)
             for k, v in ssm.make_ssm_state(cfg, d, torch.float32).items()}
    k = cfg.kernel_size
    out, aux = ssm.ssm_tree_forward(cfg, params, torch.from_numpy(x),
                                    {n: torch.from_numpy(v) for n, v in state.items()}, parents,
                                    torch.from_numpy(spec._tree_conv_windows(parents, k)))
    jout, jaux = jssm.ssm_tree_forward(jcfg, jparams, jnp.asarray(x),
                                       {n: jnp.asarray(v) for n, v in state.items()},
                                       jnp.asarray(parents),
                                       jnp.asarray(jspec._tree_conv_windows(parents, k)))
    _close_rms(_np(out), jout)
    assert sorted(aux) == sorted(jaux)
    for key in jaux:
        _close_rms(_np(aux[key]), jaux[key])
    path_idx = np.full(8, -1, np.int64)
    path_idx[:len(path)] = path
    conv_idx = spec._tree_conv_commit_idx(parents, path[-1], k)
    got = ssm.ssm_tree_commit(cfg, aux, path_idx, torch.from_numpy(conv_idx))
    want = jssm.ssm_tree_commit(jcfg, jaux, jnp.asarray(path_idx), jnp.asarray(conv_idx))
    _, plain = ssm.ssm_forward(cfg, params, torch.from_numpy(x[path]), None,
                               {n: torch.from_numpy(v) for n, v in state.items()})
    for key in want:
        _close_rms(_np(got[key]), want[key])
        _close_rms(_np(got[key]), _np(plain[key]))


# -- DFlash --------------------------------------------------------------------------------


@pytest.fixture(scope="module")
def dflash_dir(tmp_path_factory):
    return synth.synth_dflash_speculator(
        str(tmp_path_factory.mktemp("dflash")), synth.llama_config(**LLAMA), block_size=4,
        target_layer_ids=(0, 1), seed=3, dtype=np.float32)


def test_dflash_accept_and_draft_match_jax(models, dflash_dir):
    lm, jlm, _ = models.get("llama")
    draft = DFlashDraft.from_dir(dflash_dir, max_context=64, device="cpu")
    jdraft = jdflash.DFlashDraft.from_dir(dflash_dir, max_context=64)
    feats = np.random.default_rng(0).standard_normal((8, 2, 64)).astype(np.float32)
    state = draft.accept(draft.new_state(), torch.from_numpy(feats), 5)
    jstate = jdraft.accept(jdraft.new_state(), feats, 5)
    assert int(state["pos"]) == int(jstate["pos"]) == 5
    for layer, jlayer in zip(state["layers"], jstate["layers"]):
        for key in ("k", "v"):
            _close_rms(_np(layer[key][:5]), np.asarray(jlayer[key][:5], np.float32))
    ecfg = lm.decoder_config.embedding_config
    ids, vals = draft.draft(state, lm.params["embedding"], ecfg, 7, candidate_count=3)
    jids, jvals = jdraft.draft(jstate, jlm.params["embedding"],
                               jlm.decoder_config.embedding_config, 7, candidate_count=3)
    assert ids.shape == (3, 3)
    np.testing.assert_array_equal(ids, jids)
    _close_rms(vals, jvals)


def test_dflash_draft_is_repeatable_and_accept_after_it_matches_jax(models, dflash_dir):
    """The in-place block rows of `draft` change no later result: two
    drafts from one state give the same candidates, and an accept after
    them leaves JAX's state (whose draft writes nothing)."""
    lm, jlm, _ = models.get("llama")
    draft = DFlashDraft.from_dir(dflash_dir, max_context=64, device="cpu")
    jdraft = jdflash.DFlashDraft.from_dir(dflash_dir, max_context=64)
    rng = np.random.default_rng(1)
    f1, f2 = (rng.standard_normal((4, 2, 64)).astype(np.float32) for _ in range(2))
    state = draft.accept(draft.new_state(), torch.from_numpy(f1), 3)
    jstate = jdraft.accept(jdraft.new_state(), f1, 3)
    ecfg = lm.decoder_config.embedding_config
    a = draft.draft(state, lm.params["embedding"], ecfg, 9, candidate_count=2)
    b = draft.draft(state, lm.params["embedding"], ecfg, 9, candidate_count=2)
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])
    state = draft.accept(state, torch.from_numpy(f2), 2)
    jstate = jdraft.accept(jstate, f2, 2)
    for layer, jlayer in zip(state["layers"], jstate["layers"]):
        for key in ("k", "v"):
            _close_rms(_np(layer[key][:5]), np.asarray(jlayer[key][:5], np.float32))
    ids, vals = draft.draft(state, lm.params["embedding"], ecfg, 4, candidate_count=2)
    jids, jvals = jdraft.draft(jstate, jlm.params["embedding"],
                               jlm.decoder_config.embedding_config, 4, candidate_count=2)
    np.testing.assert_array_equal(ids, jids)
    _close_rms(vals, jvals)


def test_convert_carries_the_dflash_draft(models, dflash_dir):
    """The JAX draft's parameters through `from_numpy_tree` make a port
    draft whose logits are the file-loaded port draft's."""
    lm, _, _ = models.get("llama")
    jdraft = jdflash.DFlashDraft.from_dir(dflash_dir, max_context=64)
    loaded = DFlashDraft.from_dir(dflash_dir, max_context=64, device="cpu")
    carried = DFlashDraft(loaded.cfg, from_numpy_tree(jax.tree.map(np.asarray, jdraft.params)),
                          max_context=64, device="cpu")
    feats = torch.from_numpy(np.random.default_rng(2).standard_normal((4, 128))
                             .astype(np.float32))
    ecfg = lm.decoder_config.embedding_config
    outs = []
    for draft in (carried, loaded):
        st = draft.accept(draft.new_state(), feats, 4)
        outs.append(draft.draft(st, lm.params["embedding"], ecfg, 5, candidate_count=2))
    np.testing.assert_array_equal(outs[0][0], outs[1][0])
    _close_rms(outs[0][1], outs[1][1])


# -- greedy streams ---------------------------------------------------------------------------


def _decoders(name, lm, jlm, models, kind):
    """(port decoder, JAX decoder or None) of one kind."""
    if kind == "ngram":
        return (spec.SpeculativeDecoder(lm, spec.NgramSpeculator(3, 4)),
                jspec.SpeculativeDecoder(jlm, jspec.NgramSpeculator(3, 4)))
    if kind == "self":
        return (spec.self_speculative_decoder(lm, draft_layers=1, k=4),
                jspec.self_speculative_decoder(jlm, draft_layers=1, k=4))
    if kind == "draft":
        dlm, djlm, _ = models.get("draft")
        return (spec.SpeculativeDecoder(lm, spec.DraftModelSpeculator(dlm, k=4)),
                jspec.SpeculativeDecoder(jlm, jspec.DraftModelSpeculator(djlm, k=4)))
    return (spec.TreeSpeculativeDecoder(lm, spec.NgramTreeSpeculator(3, 3, 2), max_nodes=8),
            jspec.TreeSpeculativeDecoder(jlm, jspec.NgramTreeSpeculator(3, 3, 2), max_nodes=8))


STREAM_CASES = [("llama", "ngram"), ("llama", "self"), ("llama", "draft"), ("llama", "tree"),
                ("gptoss", "ngram"), ("gptoss", "tree"),
                *[(h, kind) for h in HYBRIDS for kind in ("ngram", "self", "tree")]]


# the cases also held to the JAX decoder's stream
JAX_STREAMS = {("llama", "ngram"), ("llama", "self"), ("llama", "draft"), ("llama", "tree"),
               ("gptoss", "ngram")}


@pytest.mark.parametrize("name,kind", STREAM_CASES)
def test_greedy_stream_equals_plain_and_jax(models, name, kind, monkeypatch):
    _jax_moe_mode(name, monkeypatch)
    lm, jlm, _ = models.get(name)
    prompt = REPEAT if name != "llama" else np.array([1, 2, 3, 4, 1, 2, 3])
    want = lm.generate_list(prompt, 20, stop_token_ids=[])
    dec, jdec = _decoders(name, lm, jlm, models, kind)
    metrics = spec.SpeculationMetrics()
    got = list(dec.generate(prompt, 20, stop_token_ids=[], metrics=metrics))
    assert got == want
    assert metrics.num_verify_passes > 0
    assert 0 <= metrics.num_tokens_accepted <= metrics.num_tokens_proposed
    if (name, kind) in JAX_STREAMS:
        _agree(lm, prompt, got, list(jdec.generate(prompt, 20, stop_token_ids=[])))


@pytest.mark.parametrize("name", ["llama", "qwen35"])
def test_dflash_stream_equals_plain_and_jax(models, name, tmp_path):
    lm, jlm, _ = models.get(name)
    d = synth.synth_dflash_speculator(str(tmp_path / "s"), models.config(name), block_size=4,
                                      target_layer_ids=(0, 1), seed=3, dtype=np.float32)
    prompt = np.array([5, 6, 7, 8, 9])
    want = lm.generate_list(prompt, 16, stop_token_ids=[])
    dec = spec.DFlashSpeculativeDecoder(lm, DFlashDraft.from_dir(d, max_context=128,
                                                                  device="cpu"),
                                        max_nodes=8, children=2)
    assert dec._recurrent == (name != "llama")
    metrics = spec.SpeculationMetrics()
    got = list(dec.generate(prompt, 16, stop_token_ids=[], metrics=metrics))
    assert got == want
    assert metrics.num_verify_passes > 0 and metrics.num_tokens_proposed > 0
    if name == "llama":
        jdec = jspec.DFlashSpeculativeDecoder(
            jlm, jdflash.DFlashDraft.from_dir(d, max_context=128), max_nodes=8, children=2)
        _agree(lm, prompt, got, list(jdec.generate(prompt, 16, stop_token_ids=[])))


@pytest.mark.parametrize("name,kind", [("llama", "ngram"), ("llama", "tree"),
                                       ("qwen35", "ngram"), ("qwen35", "tree"),
                                       ("mamba2", "self")])
def test_stop_token_inside_a_block(models, name, kind):
    lm, jlm, _ = models.get(name)
    plain = lm.generate_list(REPEAT, 24, stop_token_ids=[])
    stop = plain[6]
    want = lm.generate_list(REPEAT, 24, stop_token_ids=[stop])
    dec, _ = _decoders(name, lm, jlm, models, kind)
    got = list(dec.generate(REPEAT, 24, stop_token_ids=[stop]))
    assert got == want and got[-1] == stop


@pytest.mark.parametrize("name,kind", [("llama", "ngram"), ("qwen35", "ngram"),
                                       ("lfm2", "self"), ("llama", "tree")])
@pytest.mark.parametrize("budget", [1, 2, 5])
def test_budget_clips_the_commit(models, name, kind, budget):
    lm, jlm, _ = models.get(name)
    want = lm.generate_list(REPEAT, budget, stop_token_ids=[])
    dec, _ = _decoders(name, lm, jlm, models, kind)
    got = list(dec.generate(REPEAT, budget, stop_token_ids=[]))
    assert got == want and len(got) == budget


@pytest.mark.parametrize("kind", ["ngram", "self", "tree"])
def test_context_exhaustion(models, kind):
    """A context too small for the budget: the stream is a prefix of the
    plain one and ends within one block of the wall."""
    lm, jlm, _ = models.get("llama", max_context=32)
    prompt = np.array([1, 2, 3, 4, 1, 2, 3])
    want = lm.generate_list(prompt, 64, stop_token_ids=[])
    dec, _ = _decoders("llama", lm, jlm, models, kind)
    got = list(dec.generate(prompt, 64, stop_token_ids=[]))
    assert got == want[:len(got)]
    assert len(got) >= 32 - len(prompt) - 16


@pytest.mark.parametrize("name", ["llama", "qwen35"])
def test_resumption_through_state(models, name):
    """The state after a speculative run continues as plain decoding does
    (the session prefix-cache contract), its pos covering every yielded
    token but the last."""
    lm, _, _ = models.get(name)
    prompt = np.array([1, 2, 3, 4] * 4)
    dec = spec.SpeculativeDecoder(lm, spec.NgramSpeculator(3, 4))
    stream = dec.generate(prompt, 10, stop_token_ids=[])
    got = list(stream)
    assert int(stream.state["pos"]) == len(prompt) + len(got) - 1
    cont = list(dec.generate(np.array([got[-1]]), 8, stop_token_ids=[], state=stream.state,
                             history_tokens=list(prompt) + got))
    assert cont == lm.generate_list(np.concatenate([prompt, got]), 8, stop_token_ids=[])


def test_recurrent_speculation_gates(models):
    lm, _, _ = models.get("lfm2")
    assert spec.speculation_supported(lm.decoder_config)
    assert not spec.tree_speculation_supported(lm.decoder_config)
    assert spec.TreeSpeculativeDecoder(lm)._recurrent
    assert spec.DraftModelSpeculator(lm)._hybrid

    class _Shared:  # a model with a KV-sharing layer
        decoder_config = synth.windowed_config(kv_share_last=1).decoder_config

    for make in (lambda m: spec.SpeculativeDecoder(m, spec.NgramSpeculator()),
                 spec.TreeSpeculativeDecoder, spec.DraftModelSpeculator):
        with pytest.raises(ValueError):
            make(_Shared())


# -- the port's in-place writes ----------------------------------------------------------


class _WrongSpeculator:
    """Proposes tokens the model will not sample: every round is rejected
    and leaves its block's rows in the cache."""

    def propose(self, history):
        return [(history[-1] + 101 + i) % 256 for i in range(7)]


def test_rejected_rounds_ring_equals_full(tmp_path):
    """Rejected verify rows are written in place: a ring of window + 16
    slots (blocks cut to 16 rows) and the full layout give the plain
    stream, through a window that wraps many times."""
    cfg = synth.windowed_config(sliding_window=6, kv_share_last=0, has_sinks=True)
    d = synth.synthesize(cfg, str(tmp_path / "w"), seed=4, dtype=np.float32)
    kw = dict(device="cpu", max_context=96, prefill_buckets=(16,))
    full = LanguageModel.from_dir(d, **kw)
    ring = LanguageModel.from_dir(d, ring_windows=True, **kw)
    assert "pos" in ring.new_state()["layers"][0]
    assert spec.max_block(ring) == 16 and spec.max_block(full) == 32
    prompt = np.arange(20) % 7
    want = full.generate_list(prompt, 40, stop_token_ids=[])
    for lm in (full, ring):
        metrics = spec.SpeculationMetrics()
        got = list(spec.SpeculativeDecoder(lm, _WrongSpeculator()).generate(
            prompt, 40, stop_token_ids=[], metrics=metrics))
        assert got == want
        assert metrics.num_tokens_accepted < metrics.num_tokens_proposed


def test_self_draft_shares_the_target_tensors(models):
    lm, _, _ = models.get("llama")
    draft = spec.self_draft_model(lm, 1)
    assert len(draft.decoder_config.transformer_config.layer_configs) == 1
    qkv, tqkv = draft.params["layers"][0]["mixer"]["qkv"]["w"], \
        lm.params["layers"][0]["mixer"]["qkv"]["w"]
    assert qkv.data_ptr() == tqkv.data_ptr()
    emb = draft.params["embedding"]["tied"]
    temb = lm.params["embedding"]["tied"]
    assert emb.data_ptr() == temb.data_ptr()
    with pytest.raises(ValueError):
        spec.self_draft_model(lm, 3)


@pytest.mark.parametrize("name", ["llama", "qwen35", "lfm2"])
def test_tree_accept_compacts_a_nonconsecutive_path(models, name):
    """Accepting a non-first branch (path [0, 2, 3], skipping node 1)
    leaves the state of the accepted sequence: a probe after it gives the
    teacher-forced prefill's logits."""
    lm, _, _ = models.get(name)
    prompt = np.array([5, 9, 2, 7])
    _, state = lm.prefill(lm.new_state(), prompt)
    pos = len(prompt)
    tree = spec.TokenTree(11)
    tree.add(0, 22)
    n2 = tree.add(0, 33)
    tree.add(n2, 44)

    class _Fixed:
        def reset(self):
            pass

        def propose(self, history, root):
            return tree

    dec = spec.TreeSpeculativeDecoder(lm, _Fixed(), max_nodes=8)
    # the walk accepts node 2 if the root samples 33, and node 3 if node 2
    # samples 44: force it by making those the model's choices
    gen = torch.Generator().manual_seed(0)
    orig = spec.sample_rows
    spec.sample_rows = lambda logits, sampling, generator=None: torch.tensor(
        [33, 0, 44, 0] + [0] * (logits.shape[0] - 4))
    try:
        state, emit, proposed, accepted, _ = dec._tree_round(state, tree, pos, pos + 63, gen)
    finally:
        spec.sample_rows = orig
    assert (emit, proposed, accepted) == ([33, 44, 0], 3, 2)
    # the teacher-forced path at the same chunk boundary (a ShortConv tail
    # is stored in bf16 between chunks)
    _, want_state = lm.prefill(lm.prefill(lm.new_state(), prompt)[1], np.array([11, 33, 44]))
    la, _ = lm.prefill(state, np.array([77]))
    lb, _ = lm.prefill(want_state, np.array([77]))
    torch.testing.assert_close(la, lb, rtol=1e-5, atol=1e-5)
