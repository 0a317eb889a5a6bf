"""The port's in-repo trainer (`uzu_tpu_torch/tools/train_tiny.py`) and
K3b's plain version against the JAX package, on the CPU.

The same f32 model (the JAX synthesizer's, its params carried across by
`convert.py`), the same corpus windows and the same optimizer schedule go
through `uzu_tpu.tools.train_tiny` (jax.value_and_grad, optax AdamW) and
the port's trainer (autograd, torch AdamW). On the CPU the port's
attention is `flash_attention_plain`, differentiated by autograd; on the
card it is K3 forward and K3b backward, whose plain version
`flash_attention_bwd_plain` is held here to `jax.grad` of the JAX
attention reference.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uzu_tpu import LanguageModel as JaxLM
from uzu_tpu.config.model import IntSpec as JaxIntSpec, Layout as JaxLayout
from uzu_tpu.ops.attention import attention_reference as jax_attention
from uzu_tpu.tools import train_tiny as jtt
from uzu_tpu_torch import LanguageModel
from uzu_tpu_torch.config.model import IntSpec, Layout
from uzu_tpu_torch.convert import from_numpy_tree
from uzu_tpu_torch.ops.cuda.flash_attention import (
    flash_attention_bwd_plain,
    flash_attention_plain,
    grad_unsupported,
)
from uzu_tpu_torch.tools import train_tiny as ptt

torch.set_num_threads(1)

DIMS = dict(num_layers=2, model_dim=128, hidden_dim=256, num_heads=4,
            num_groups=2, head_dim=32, vocab_size=256, max_seq=512)  # tests/test_train_tiny.py
STEPS, BATCH, SEQ, CORPUS = 10, 4, 64, 100_000


def _host(x) -> np.ndarray:
    return np.asarray(jax.device_get(x), np.float32)


def _rel_l2(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def _flat(tree, prefix=""):
    """{path: leaf} of a params tree (dicts and lists)."""
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items() for k2, v2 in _flat(v, f"{prefix}{k}.").items()}
    if isinstance(tree, (list, tuple)):
        return {k2: v2 for i, v in enumerate(tree)
                for k2, v2 in _flat(v, f"{prefix}{i}.").items()}
    return {prefix[:-1]: tree}


@pytest.fixture(scope="module")
def jax_init(tmp_path_factory):
    """The JAX package's initial model at DIMS (seed 0, f32) and its dir."""
    d = str(tmp_path_factory.mktemp("jax_init"))
    return jtt._build_init(DIMS, 0, d), d


def test_one_step_loss_and_gradients_match_jax(jax_init):
    """The port's `_loss_fn` + autograd against jax.value_and_grad of the
    JAX `_loss_fn`, same params and batch, f32: the two sum in other
    orders, so the loss within 1e-5 relative and each leaf's gradient
    within 1e-4 relative L2 (the KV cache is bf16 in both packages, so
    dK and dV are rounded to bf16 on both sides, which a last-bit
    difference can flip)."""
    from uzu_tpu_torch.config import load_language_model_config

    lm, model_dir = jax_init
    data = ptt.train_data(DIMS, steps=1, batch=BATCH, seq=SEQ, corpus_tokens=CORPUS)
    want_loss, want_grads = jax.value_and_grad(
        lambda p: jtt._loss_fn(lm.decoder_config, p, lm.new_state(), jnp.asarray(data[0])))(
            lm.params)
    port = LanguageModel(load_language_model_config(os.path.join(model_dir, "config.json")),
                         _carry(lm.params), device="cpu", max_context=DIMS["max_seq"])
    leaves = _flat(port.params)
    for t in leaves.values():
        t.requires_grad_(True)
    loss = ptt._loss_fn(port.decoder_config, port.params, port.new_state(),
                        torch.from_numpy(data[0]))
    loss.backward()
    assert abs(loss.item() - float(want_loss)) <= 1e-5 * abs(float(want_loss))
    want = _flat(jax.tree.map(_host, want_grads))
    assert set(want) == set(leaves)
    for path, t in leaves.items():
        assert _rel_l2(t.grad.numpy(), want[path]) < 1e-4, path


def _carry(params):
    return from_numpy_tree(jax.tree.map(_host, params))


@pytest.fixture(scope="module")
def trained_pair():
    """Both trainers, STEPS steps at DIMS with the same arguments."""
    kw = dict(steps=STEPS, batch=BATCH, seq=SEQ, corpus_tokens=CORPUS, scan_k=5,
              log=lambda *a: None)
    j = jtt.train(DIMS, **kw)
    p = ptt.train(DIMS, device="cpu", **kw)
    return j, p


def test_train_trajectory_matches_jax(trained_pair):
    """Each step's loss and every trained leaf against JAX's `train` with
    the same arguments: within 1e-3 (Adam's normalized steps carry the
    last-bit differences of the gradients into the weights; 10 steps at
    lr 3e-3 stay far inside it)."""
    (_, jparams, jlosses), (_, pparams, plosses) = trained_pair
    assert len(plosses) == len(jlosses) == STEPS
    np.testing.assert_allclose(plosses, jlosses, rtol=1e-3)
    want = _flat(jax.tree.map(_host, jparams))
    got = _flat(pparams)
    assert set(got) == set(want)
    for path, t in got.items():
        assert _rel_l2(t.detach().numpy(), want[path]) < 1e-3, path
        assert not t.requires_grad


def test_schedule_is_optax():
    """The learning rate at every count of a 30- and a 1000-step run equals
    optax's warmup_cosine_decay_schedule (f32 on the JAX side)."""
    import optax

    for steps in (30, 1000):
        warm = min(100, steps // 10 + 1)
        want = optax.warmup_cosine_decay_schedule(0.0, 3e-3, warmup_steps=warm,
                                                   decay_steps=steps, end_value=1.5e-4)
        got = ptt.warmup_cosine_decay(0.0, 3e-3, warm, steps, 1.5e-4)
        counts = np.arange(steps + 5)
        np.testing.assert_allclose([got(int(c)) for c in counts],
                                   [float(want(c)) for c in counts], rtol=1e-6, atol=1e-12)
        assert got(0) == 0.0


@pytest.fixture(scope="module")
def port_trained(tmp_path_factory):
    """The port's trainer at tests/test_train_tiny.py's run (30 steps, batch
    8, seq 128), written in both arms."""
    lm, params, losses = ptt.train(DIMS, steps=30, batch=8, seq=128, corpus_tokens=CORPUS,
                                   scan_k=10, log=lambda *a: None, device="cpu")
    out = tmp_path_factory.mktemp("port_tiny")
    d_bf = ptt.write_trained(lm, params, str(out / "bf16"))
    d_i4 = ptt.write_trained(lm, params, str(out / "int4"), linear_spec=IntSpec(
        bits=4, group_size=32, is_symmetric=True, layout=Layout.OUTPUT_INPUT))
    return losses, d_bf, d_i4


def test_loss_decreases(port_trained):
    """tests/test_train_tiny.py::test_loss_decreases, on the port."""
    losses = port_trained[0]
    first, last = np.mean(losses[:5]), np.mean(losses[-5:])
    assert np.all(np.isfinite(losses))
    assert last < first * 0.75, (first, last)


@pytest.mark.parametrize("arm", ["bf16", "int4"])
def test_write_trained_bytes_match_jax(trained_pair, tmp_path, arm):
    """JAX's trained params, carried across, written by both packages'
    `write_trained`: byte-identical directories."""
    (jlm, jparams, _), (plm, _, _) = trained_pair
    jspec = pspec = None
    if arm == "int4":
        jspec = JaxIntSpec(bits=4, group_size=32, is_symmetric=True,
                           layout=JaxLayout.OUTPUT_INPUT)
        pspec = IntSpec(bits=4, group_size=32, is_symmetric=True, layout=Layout.OUTPUT_INPUT)
    dj = jtt.write_trained(jlm, jparams, str(tmp_path / "jax"), linear_spec=jspec)
    dp = ptt.write_trained(plm, _carry(jparams), str(tmp_path / "port"), linear_spec=pspec)
    assert sorted(os.listdir(dj)) == sorted(os.listdir(dp))
    for name in os.listdir(dj):
        with open(os.path.join(dj, name), "rb") as a, open(os.path.join(dp, name), "rb") as b:
            assert a.read() == b.read(), name


def test_int4_arm_loads_in_both_and_tracks_bf16(port_trained):
    """The port's INT4 directory loads in both packages and generates; its
    held-out NLL holds tests/test_train_tiny.py:61's bound against the bf16
    arm (|dNLL| < 0.25 max(NLL_bf16, 1)) in the port, and the two packages'
    INT4 NLLs agree within 1e-3."""
    from uzu_tpu.tools.quality import sequence_nll as jax_nll
    from uzu_tpu_torch.tools.corpus import generate_tokens, heldout_prompts
    from uzu_tpu_torch.tools.quality import sequence_nll

    _, d_bf, d_i4 = port_trained
    p = heldout_prompts(k=1, length=32)[0]
    lm_bf = LanguageModel.from_dir(d_bf, device="cpu", max_context=512, prefill_buckets=(32,))
    lm_i4 = LanguageModel.from_dir(d_i4, device="cpu", max_context=512, prefill_buckets=(32,))
    jlm_i4 = JaxLM.from_dir(d_i4, max_context=512, prefill_buckets=(32,))
    assert len(lm_i4.generate_list(np.asarray(p), 16, stop_token_ids=[])) == 16
    assert len(jlm_i4.generate_list(np.asarray(p), 16, stop_token_ids=[])) == 16
    ev = generate_tokens(600, seed=12345)
    nll_bf = sequence_nll(lm_bf, ev[:512])["nll"]
    nll_i4 = sequence_nll(lm_i4, ev[:512])["nll"]
    assert abs(nll_i4 - nll_bf) < 0.25 * max(nll_bf, 1.0), (nll_bf, nll_i4)
    assert abs(jax_nll(jlm_i4, ev[:512])["nll"] - nll_i4) < 1e-3


@pytest.mark.parametrize("rep,window", [(2, None), (2, 9), (4, None), (4, 9)])
def test_flash_attention_bwd_plain_matches_jax_grad(rep, window):
    """K3b's plain version against jax.grad of the JAX attention reference
    (its XLA path, f32 on the CPU) of sum(O * dO): queries from position 5,
    a cache longer than the chunk (slots past the last query get zero
    gradient), f32, within 1e-5 of each gradient's max."""
    rng = np.random.default_rng(rep * 10 + (window or 0))
    s, g, dh, c, pos0 = 12, 2, 16, 24, 5
    h = g * rep
    q = rng.standard_normal((s, h, dh)).astype(np.float32)
    k = rng.standard_normal((c, g, dh)).astype(np.float32)
    v = rng.standard_normal((c, g, dh)).astype(np.float32)
    do = rng.standard_normal((s, h, dh)).astype(np.float32)
    pos = np.arange(pos0, pos0 + s, dtype=np.int32)
    scale = dh ** -0.5

    def f(q_, k_, v_):
        o = jax_attention(q_, k_, v_, jnp.asarray(pos), scale=scale,
                          sliding_window_size=window)
        return jnp.sum(o * do)

    want = jax.grad(f, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    qpos = torch.from_numpy(pos)
    out = flash_attention_plain(tq, tk, tv, qpos, scale=scale, sliding_window_size=window)
    got = flash_attention_bwd_plain(tq, tk, tv, qpos, out, torch.from_numpy(do), scale=scale,
                                    sliding_window_size=window)
    for a, b in zip(got, want):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, atol=1e-5 * np.abs(b).max(), rtol=0)
    assert torch.all(got[1][pos0 + s:] == 0) and torch.all(got[2][pos0 + s:] == 0)


@pytest.mark.parametrize("case,why", [
    (dict(), None),
    (dict(logit_soft_cap=30.0), "soft cap"),
    (dict(sinks=torch.zeros(4)), "sinks"),
    (dict(quantized=True), "INT8"),
])
def test_gradient_gate(case, why):
    """K3b differentiates K3 over a bf16 or f32 cache only: a soft cap,
    sinks or an INT8 cache (K4) name why no gradient kernel serves them
    (the card raises NotImplementedError with that reason)."""
    got = grad_unsupported(**case)
    assert (got is None) if why is None else (why in got)


@pytest.mark.parametrize("s,h,g,c,dh", [(512, 6, 2, 1024, 64), (256, 32, 8, 1024, 64),
                                        (16, 32, 8, 4096, 64), (128, 8, 2, 1024, 32),
                                        (256, 4, 1, 1024, 256), (64, 8, 2, 256, 128)])
def test_bwd_parts_fill_the_card_without_empty_parts(s, h, g, c, dh):
    """K3b's dK/dV launch cuts the query tiles into parts (shapes only): at
    least one, none empty (each part holds whole tiles, the last one too),
    and more than half the parts that would give the plan's blocks a SM
    to every SM from the (64-key tile, group, column slice, part) blocks
    (or one part a query tile)."""
    from uzu_tpu_torch.ops.cuda.flash_attention import (
        BWD_BM,
        bwd_parts,
        bwd_plan,
    )

    sms = 132
    plan = bwd_plan(dh)
    row_tiles = -(-s * (h // g) // plan.tile)
    parts = bwd_parts(s, h, g, c, dh, sms)
    per = -(-row_tiles // parts)  # the kernel's tiles per part
    assert 1 <= parts <= row_tiles and (parts - 1) * per < row_tiles
    blocks = -(-c // BWD_BM) * g * plan.dkdv_slices
    target = min(row_tiles, -(-plan.blocks_per_sm * sms // blocks))
    assert 2 * parts > target
