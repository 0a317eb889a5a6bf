"""The port's fused multi-round speculative decoding against the JAX package, on the CPU.

`uzu_tpu_torch.engine.fused_spec` runs R draft+verify rounds on the device
and reads them with one fetch; the rounds after a stop token or the
budget do nothing through masks. Tiny models at the JAX tests' sizes
(`tests/test_fused_spec.py`), written by the port's synthesizer:

- `ops/ngram.py::ngram_propose` equals the JAX device proposer and the
  host `NgramSpeculator` on random histories (exact);
- fused greedy streams (self draft, separate draft, device n-gram) equal
  the port's plain stream and the JAX fused decoder's (wherever the top-2
  margin clears MARGIN_TOL), across stop tokens inside the rounds, budgets
  that end inside a round, context exhaustion, a GDN hybrid and a tiny
  gpt-oss; the totals match the per-round decoder's; `.state` covers
  every token but the last; a sampled run repeats under its seed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uzu_tpu import LanguageModel as JaxLM
from uzu_tpu.engine import fused_spec as jfused
from uzu_tpu.engine.speculation import NgramSpeculator as JaxNgram
from uzu_tpu.ops.ngram import ngram_propose as jax_ngram
from uzu_tpu_torch import LanguageModel
from uzu_tpu_torch.config.model import IntSpec, Layout
from uzu_tpu_torch.engine.fused_spec import (
    FusedSpeculativeDecoder,
    fused_self_speculative_decoder,
)
from uzu_tpu_torch.engine.sampling import SamplingParams
from uzu_tpu_torch.engine.speculation import (
    DraftModelSpeculator,
    NgramSpeculator,
    SpeculationMetrics,
    SpeculativeDecoder,
)
from uzu_tpu_torch.models.decoder import decoder_forward
from uzu_tpu_torch.ops.ngram import ngram_propose
from uzu_tpu_torch.tools import synth

torch.set_num_threads(1)

MARGIN_TOL = 1e-3  # streams are compared up to the first step with a smaller top-2 margin
LLAMA = dict(num_layers=2, model_dim=64, hidden_dim=160, num_heads=4, num_groups=2,
             head_dim=16, vocab_size=256)
PROMPT = np.array([1, 2, 3, 4, 1, 2, 3])


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("fused")
    out = {"target": synth.synthesize(synth.llama_config(**LLAMA), str(root / "target"), seed=7,
                                      dtype=np.float32)}
    # synth models repeat their root token, so a chain draft matches a chain
    # target; an untied draft with its readout rolled by one id is rejected
    out["draft"] = synth.synthesize(
        synth.llama_config(num_layers=1, model_dim=32, hidden_dim=64, num_heads=2, num_groups=1,
                           head_dim=16, vocab_size=256, tied=False),
        str(root / "draft"), seed=23, dtype=np.float32)
    out["qwen35"] = synth.synthesize(synth.qwen35_config(), str(root / "qwen35"), seed=3,
                                     dtype=np.float32)
    out["gptoss"] = synth.synthesize(
        synth.gptoss_config(num_layers=2, model_dim=64, num_heads=4, num_groups=2, head_dim=16,
                            vocab_size=512, num_experts=8, num_active=2, expert_hidden_dim=128),
        str(root / "gptoss"), seed=3, dtype=np.float32,
        expert_spec=IntSpec(bits=4, group_size=32, is_symmetric=True, layout=Layout.OUTPUT_INPUT))
    return out


def _lm(d, max_context=128):
    return LanguageModel.from_dir(d, device="cpu", max_context=max_context,
                                  prefill_buckets=(16,))


@pytest.fixture(scope="module")
def target(dirs):
    return _lm(dirs["target"])


@pytest.fixture(scope="module")
def disagreeing_draft(dirs):
    lm = _lm(dirs["draft"])
    lm.params["embedding"]["output"] = torch.roll(lm.params["embedding"]["output"], 1, 0)
    return lm


def _agree(lm, prompt, got, want):
    """got equals want up to the first step whose top-2 margin (the port's
    teacher-forced logits) is under MARGIN_TOL."""
    toks = torch.as_tensor(np.concatenate([prompt, want[:-1]]).astype(np.int64))
    logits, _ = decoder_forward(lm.decoder_config, lm.params, toks, lm.new_state(),
                                last_only=False)
    top = torch.topk(logits[len(prompt) - 1:], 2).values
    margins = (top[:, 0] - top[:, 1]).tolist()
    clear = next((i for i, m in enumerate(margins) if m < MARGIN_TOL), len(want))
    assert got[:clear] == want[:clear], (clear, got, want)


# -- the device n-gram proposer ---------------------------------------------------------


@pytest.mark.parametrize("seed", range(4))
def test_device_ngram_matches_jax_and_the_host_rule(seed):
    rng = np.random.default_rng(seed)
    jf = jax.jit(lambda h, n: jax_ngram(h, n, 4, 3))
    host, jhost = NgramSpeculator(max_ngram=3, k=4), JaxNgram(max_ngram=3, k=4)
    for _ in range(30):
        n = int(rng.integers(1, 64))
        hist = rng.integers(0, 6, n).tolist()
        buf = np.zeros(64 + 4, np.int64)
        buf[:n] = hist
        d, dl = ngram_propose(torch.from_numpy(buf), torch.tensor(n), 4)
        jd, jdl = jf(jnp.asarray(buf, jnp.int32), jnp.asarray(n))
        assert int(dl) == int(jdl)
        got = d[:int(dl)].tolist()
        assert got == np.asarray(jd)[:int(jdl)].tolist() == host.propose(hist) == \
            jhost.propose(hist)


# -- fused streams ------------------------------------------------------------------------


def test_fused_self_equals_plain_and_jax(target, dirs):
    want = target.generate_list(PROMPT, 24, stop_token_ids=[])
    m = SpeculationMetrics()
    got = list(fused_self_speculative_decoder(target, draft_layers=1, k=3, rounds=4).generate(
        PROMPT, 24, stop_token_ids=[], metrics=m))
    assert got == want
    assert m.num_verify_passes > 0 and m.num_tokens_accepted <= m.num_tokens_proposed
    jlm = JaxLM.from_dir(dirs["target"], max_context=128, prefill_buckets=(16,))
    jdec = jfused.fused_self_speculative_decoder(jlm, draft_layers=1, k=3, rounds=4)
    _agree(target, PROMPT, got, list(jdec.generate(PROMPT, 24, stop_token_ids=[])))


def test_fused_separate_draft_partial_acceptance(target, disagreeing_draft):
    prompt = np.array([9, 3, 57, 12, 88, 41, 7])
    want = target.generate_list(prompt, 24, stop_token_ids=[])
    m = SpeculationMetrics()
    got = list(FusedSpeculativeDecoder(target, draft_lm=disagreeing_draft, k=3,
                                       rounds=4).generate(prompt, 24, stop_token_ids=[],
                                                          metrics=m))
    assert got == want
    # the rolled readout is rejected: the commit-1 rounds and the draft's
    # block replay between rounds run
    assert m.num_tokens_accepted < m.num_tokens_proposed
    assert m.num_verify_passes >= 4


@pytest.mark.parametrize("kind", ["self", "ngram", "draft"])
def test_fused_stop_token_inside_the_rounds(target, disagreeing_draft, kind):
    plain = target.generate_list(PROMPT, 24, stop_token_ids=[])
    stop = plain[5]
    want = target.generate_list(PROMPT, 24, stop_token_ids=[stop])
    dec = _fused(target, disagreeing_draft, kind)
    got = list(dec.generate(PROMPT, 24, stop_token_ids=[stop]))
    assert got == want and got[-1] == stop


def _fused(lm, draft, kind, **kw):
    kw = dict(dict(k=3, rounds=4), **kw)
    if kind == "self":
        return fused_self_speculative_decoder(lm, draft_layers=1, **kw)
    if kind == "ngram":
        return FusedSpeculativeDecoder(lm, ngram=True, **kw)
    return FusedSpeculativeDecoder(lm, draft_lm=draft, **kw)


@pytest.mark.parametrize("kind", ["self", "ngram", "draft"])
@pytest.mark.parametrize("budget", [1, 2, 5, 7])
def test_fused_budget_clips_inside_the_rounds(target, disagreeing_draft, kind, budget):
    want = target.generate_list(PROMPT, budget, stop_token_ids=[])
    got = list(_fused(target, disagreeing_draft, kind).generate(PROMPT, budget,
                                                                stop_token_ids=[]))
    assert got == want and len(got) == budget


@pytest.mark.parametrize("kind", ["self", "ngram"])
def test_fused_context_exhaustion(dirs, kind):
    """A context too small for the budget: the stream is a prefix of the
    plain one, ends within one block of the wall, and no round of a
    dispatch reaches past the context."""
    lm = _lm(dirs["target"], max_context=32)
    want = lm.generate_list(PROMPT, 64, stop_token_ids=[])
    got = list(_fused(lm, None, kind).generate(PROMPT, 64, stop_token_ids=[]))
    assert got == want[:len(got)]
    assert len(got) >= 32 - len(PROMPT) - 4 - 1


def test_fused_hybrid_recurrent(dirs):
    """A GDN hybrid target: the rounds' deferred commits replay the
    recurrent state across rounds, stop and budget edges included."""
    lm = _lm(dirs["qwen35"])
    prompt = np.array([1, 2, 3, 4, 1, 2, 3, 4, 1, 2])
    want = lm.generate_list(prompt, 24, stop_token_ids=[])
    dec = fused_self_speculative_decoder(lm, k=3, rounds=3)
    assert list(dec.generate(prompt, 24, stop_token_ids=[])) == want
    stop = want[7]
    want_s = lm.generate_list(prompt, 24, stop_token_ids=[stop])
    got_s = list(dec.generate(prompt, 24, stop_token_ids=[stop]))
    assert got_s == want_s and got_s[-1] == stop
    assert list(dec.generate(prompt, 5, stop_token_ids=[])) == \
        lm.generate_list(prompt, 5, stop_token_ids=[])
    got_n = list(FusedSpeculativeDecoder(lm, ngram=True, k=4, rounds=3).generate(
        prompt, 24, stop_token_ids=[]))
    assert got_n == want


def test_fused_moe_target(dirs):
    """A tiny gpt-oss (MoE, sinks, sliding window): verify blocks of 4 rows
    take the gather path, of 8 the grouped one."""
    lm = _lm(dirs["gptoss"])
    prompt = np.array([1, 2, 3, 4, 1, 2, 3, 4, 1, 2])
    want = lm.generate_list(prompt, 20, stop_token_ids=[])
    for k in (3, 7):
        assert list(FusedSpeculativeDecoder(lm, ngram=True, k=k, rounds=3).generate(
            prompt, 20, stop_token_ids=[])) == want


def test_fused_matches_the_per_round_decoder(target, disagreeing_draft):
    """The same draft fused and per round: the same stream and the same
    acceptance up to a final budget-clipped round."""
    prompt = np.array([9, 3, 57, 12, 88, 41, 7])
    mf, mp = SpeculationMetrics(), SpeculationMetrics()
    got_f = list(FusedSpeculativeDecoder(target, draft_lm=disagreeing_draft, k=3,
                                         rounds=4).generate(prompt, 20, stop_token_ids=[],
                                                            metrics=mf))
    got_p = list(SpeculativeDecoder(target, DraftModelSpeculator(disagreeing_draft, k=3))
                 .generate(prompt, 20, stop_token_ids=[], metrics=mp))
    assert got_f == got_p
    assert abs(mf.num_tokens_accepted - mp.num_tokens_accepted) <= 3


@pytest.mark.parametrize("kind", ["self", "ngram", "draft"])
def test_fused_state_contract(target, disagreeing_draft, kind):
    """`.state` covers every yielded token but the in-flight last one, and
    continues as plain decoding does."""
    s = _fused(target, disagreeing_draft, kind).generate(PROMPT, 10, stop_token_ids=[])
    toks = list(s)
    assert int(s.state["pos"]) == len(PROMPT) + len(toks) - 1
    la, _ = target.prefill(s.state, np.array([toks[-1]]))
    lb, _ = target.prefill(target.new_state(), np.concatenate([PROMPT, toks]))
    torch.testing.assert_close(la, lb, rtol=1e-5, atol=1e-5)


def test_fused_rejects_invalid_config(target, disagreeing_draft):
    with pytest.raises(ValueError):
        FusedSpeculativeDecoder(target)  # no draft
    with pytest.raises(ValueError):
        FusedSpeculativeDecoder(target, draft_lm=disagreeing_draft, draft_layers=1)  # two
    with pytest.raises(ValueError):
        FusedSpeculativeDecoder(target, draft_layers=1, k=0)
    with pytest.raises(ValueError):
        FusedSpeculativeDecoder(target, ngram=True, rounds=0)


def test_fused_ngram_single_stream(target):
    want = target.generate_list(PROMPT, 24, stop_token_ids=[])
    m = SpeculationMetrics()
    got = list(FusedSpeculativeDecoder(target, ngram=True, k=4, rounds=4).generate(
        PROMPT, 24, stop_token_ids=[], metrics=m))
    assert got == want
    assert m.num_tokens_accepted > 0  # the repetitive prompt's lookups hit


@pytest.mark.parametrize("kind", ["fused", "chain"])
def test_sampled_speculation_repeats_under_its_seed(target, kind):
    """Sampled rounds draw from a generator seeded by the call: the same
    seed gives the same tokens, another seed other tokens."""
    sp = SamplingParams(temperature=1.0, top_k=40)

    def run(seed):
        dec = (fused_self_speculative_decoder(target, draft_layers=1, k=3, rounds=4,
                                              sampling=sp) if kind == "fused" else
               SpeculativeDecoder(target, NgramSpeculator(3, 4), sampling=sp))
        return list(dec.generate(PROMPT, 24, stop_token_ids=[], seed=seed))

    a, b, c = run(5), run(5), run(6)
    assert a == b and len(a) == 24
    assert a != c
