"""The rest of the port's single-stream engine API against the JAX
package, on the CPU.

`generate_resumable` and its `TokenStream` (a continued state, `.state`,
`.logprob_content`), `recommended_max_context`, the loader's seeded-random
mode (`from_dir(random_seed=...)`) and the parallel safetensors read
(`read_many`). Tiny f32 models are synthesized by the JAX synthesizer and
loaded by both packages; the same prompts go through both.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uzu_tpu import LanguageModel as JaxLM
from uzu_tpu.models.decoder import decoder_forward as jax_forward
from uzu_tpu.params import tree as jtree
from uzu_tpu.params.safetensors_io import SafetensorsFile as JaxFile
from uzu_tpu.tools import synth as jsynth
from uzu_tpu_torch import LanguageModel
from uzu_tpu_torch.engine.engine import TokenStream, _tensors
from uzu_tpu_torch.models.decoder import decoder_forward
from uzu_tpu_torch.params import tree as ptree
from uzu_tpu_torch.params.safetensors_io import SafetensorsFile

torch.set_num_threads(1)

LLAMA = dict(num_layers=2, model_dim=64, hidden_dim=128, num_heads=4, num_groups=2,
             head_dim=16, vocab_size=256, tied=False)
LM_KW = dict(max_context=128, prefill_buckets=(16, 64))
MARGIN = 1e-3  # 10x the 1e-4 by which the packages' f32 logits part


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    """{name: dir}: an untied f32 Llama (normal fill), the same with INT4
    g32 linears and embeddings (bf16 scales), and gemma_config's f32
    defaults (PLE, a global layer sharing a windowed layer's KV)."""
    root = tmp_path_factory.mktemp("torch_engine_api")
    int4 = jsynth.IntSpec(bits=4, group_size=32, is_symmetric=True,
                          layout=jsynth.Layout.OUTPUT_INPUT)
    return {
        "llama": jsynth.synthesize(jsynth.llama_config(**LLAMA), str(root / "llama"), seed=9,
                                   dtype=np.float32),
        "llama_int4": jsynth.synthesize(jsynth.llama_config(**LLAMA), str(root / "int4"),
                                        seed=9, linear_spec=int4, embedding_spec=int4),
        "gemma": jsynth.synthesize(jsynth.gemma_config(), str(root / "gemma"), seed=9,
                                   dtype=np.float32),
    }


def _both(d, **kw):
    return (JaxLM.from_dir(d, **LM_KW, **kw),
            LanguageModel.from_dir(d, device="cpu", **LM_KW, **kw))


def _prompt(n, mul=37, off=5, vocab=256):
    return (np.arange(n) * mul + off) % vocab


def _margins(lm, history, n_new):
    """Top-2 margins of the port's teacher-forced logits at the last
    n_new + 1 positions of `history` (the steps that chose its last
    n_new tokens and the one after)."""
    logits, _ = decoder_forward(lm.decoder_config, lm.params, torch.as_tensor(history),
                                lm.new_state(), last_only=False)
    top2 = torch.topk(logits[len(history) - n_new - 1:], 2).values
    return (top2[:, 0] - top2[:, 1]).tolist()


def _agree_until_near_tie(got, want, margins):
    """Streams equal up to the first step whose margin is under MARGIN;
    past it the histories differ and nothing more is compared."""
    same = next((i for i, (a, b) in enumerate(zip(got, want)) if a != b), None)
    if same is None:
        assert len(got) == len(want)
    else:
        assert margins[same] < MARGIN, (same, margins[same])


def _turns(lm, p1, p2, n1, n2):
    s1 = lm.generate_resumable(None, p1, n1, stop_token_ids=[])
    t1 = list(s1)
    pos1 = int(s1.state["pos"])
    s2 = lm.generate_resumable(s1.state, np.asarray([t1[-1], *p2]), n2, stop_token_ids=[])
    t2 = list(s2)
    return t1, t2, pos1, int(s2.state["pos"])


def test_generate_resumable_two_turns_match_jax(dirs):
    """Two turns, the second continuing the first's state with its last
    token and a new prompt (as the chat session layer feeds it): the
    tokens and each turn's final position equal JAX's, and the state holds
    every token but the last one yielded."""
    jlm, lm = _both(dirs["llama"])
    p1, p2 = _prompt(20), _prompt(9, 11, 3)
    t1, t2, pos1, pos2 = _turns(lm, p1, p2, 8, 6)
    j1, j2, jpos1, jpos2 = _turns(jlm, p1, p2, 8, 6)
    assert (pos1, pos2) == (jpos1, jpos2) == (20 + 8 - 1, 20 + 8 + len(p2) + 6 - 1)
    hist1 = np.concatenate([p1, t1])
    _agree_until_near_tie(t1, j1, _margins(lm, hist1, len(t1)))
    if t1 == j1:
        hist2 = np.concatenate([hist1, p2, t2])
        _agree_until_near_tie(t2, j2, _margins(lm, hist2, len(t2)))
    stream = lm.generate_resumable(None, p1, 3, stop_token_ids=[])
    assert isinstance(stream, TokenStream) and stream.state is None
    assert len(list(stream)) == 3 and stream.state is not None
    assert stream.logprob_content == []


def test_two_turns_match_one_generate_over_their_concatenation(dirs):
    """The second turn continues where one `generate` over the first
    turn's prompt, its tokens and the second prompt would: the same tokens
    up to the first near-tie."""
    lm = LanguageModel.from_dir(dirs["llama"], device="cpu", **LM_KW)
    p1, p2 = _prompt(20), _prompt(9, 11, 3)
    t1, t2, _, _ = _turns(lm, p1, p2, 8, 6)
    whole = lm.generate_list(np.concatenate([p1, t1, p2]), 6, stop_token_ids=[])
    hist = np.concatenate([p1, t1, p2, t2])
    _agree_until_near_tie(t2, whole, _margins(lm, hist, len(t2)))


def test_continuation_near_max_context_stops_at_the_same_token(dirs):
    """A second turn whose budget is cut by max_context (the state's
    position counts against it): both packages stop after the same number
    of tokens, max_context - start_pos - prompt."""
    jlm, lm = _both(dirs["llama"])
    p1, p2 = _prompt(100), _prompt(10, 7, 2)
    t1, t2, pos1, pos2 = _turns(lm, p1, p2, 8, 50)
    j1, j2, _, _ = _turns(jlm, p1, p2, 8, 50)
    budget = LM_KW["max_context"] - pos1 - (len(p2) + 1)
    assert len(t2) == len(j2) == budget == 10
    assert pos2 == pos1 + len(p2) + 1 + budget - 1
    if t1 == j1:
        _agree_until_near_tie(t2, j2, _margins(lm, np.concatenate([p1, t1, p2, t2]),
                                               len(t2)))


def test_resumable_with_a_penalty_ring_adds_the_ring(dirs):
    """A continued state without a ring gets one when the sampling asks
    for a repetition penalty, as in JAX."""
    from uzu_tpu_torch.engine.sampling import SamplingParams

    lm = LanguageModel.from_dir(dirs["llama"], device="cpu", **LM_KW)
    s1 = lm.generate_resumable(None, _prompt(12), 4, stop_token_ids=[])
    list(s1)
    assert "ring" not in s1.state
    sp = SamplingParams(repetition_penalty=1.3, suffix_repetition_length=16)
    s2 = lm.generate_resumable(s1.state, _prompt(5), 4, sampling=sp, stop_token_ids=[])
    assert len(list(s2)) == 4 and s2.state["ring"].shape == (16,)


@pytest.mark.parametrize("n_lp", [1, 5])
def test_logprob_content_matches_jax(dirs, n_lp):
    """One entry per yielded token, the first from the prefill's logits
    and the rest from the decode chunks: each token's log-probability and
    the sorted top values within 1e-4 of JAX's (f32); the top ids where a
    value is clear of its neighbours by MARGIN (torch.topk and
    jax.lax.top_k may order ties differently)."""
    jlm, lm = _both(dirs["llama"])
    p = _prompt(20)
    s = lm.generate_resumable(None, p, 12, stop_token_ids=[], logprobs=n_lp)
    toks = list(s)
    js = jlm.generate_resumable(None, p.astype(np.int32), 12, stop_token_ids=[],
                                logprobs=n_lp)
    jtoks = list(js)
    assert len(s.logprob_content) == len(toks) == 12
    same = next((i for i, (a, b) in enumerate(zip(toks, jtoks)) if a != b), len(toks))
    for i in range(same):
        (lp, tops), (jlp, jtops) = s.logprob_content[i], js.logprob_content[i]
        assert abs(lp - jlp) <= 1e-4
        vals, jvals = [v for _, v in tops], [v for _, v in jtops]
        np.testing.assert_allclose(vals, jvals, rtol=0, atol=1e-4)
        for j in range(n_lp - 1):
            clear = vals[j] - vals[j + 1] > MARGIN and (j == 0 or vals[j - 1] - vals[j] > MARGIN)
            if clear:
                assert tops[j][0] == jtops[j][0]
        # the greedy token is the top alternative, and its log-probability
        assert tops[0][0] == toks[i] and abs(tops[0][1] - lp) == 0.0
    # the logprobs are those of the teacher-forced logits
    logits, _ = decoder_forward(lm.decoder_config, lm.params,
                                torch.as_tensor(np.concatenate([p, toks])),
                                lm.new_state(), last_only=False)
    lsm = torch.log_softmax(logits[len(p) - 1:-1].float(), dim=-1)
    want = lsm[torch.arange(len(toks)), torch.as_tensor(toks)]
    np.testing.assert_allclose([lp for lp, _ in s.logprob_content], want.numpy(),
                               rtol=0, atol=1e-4)


@pytest.mark.parametrize("name,kw,budgets", [
    ("llama", {}, (2**20, 2**30, 64 * 2**30)),
    ("llama_int4", {"kv_quant": True}, (2**28, 2**30, 80 * 2**30)),
    ("gemma", {}, (2**27, 2**30, 16 * 2**30)),
])
@pytest.mark.parametrize("batch_size", [1, 4])
def test_recommended_max_context_matches_jax(dirs, name, kw, budgets, batch_size):
    """The same context for explicit budgets: llama, INT4 with the INT8 KV
    cache, gemma (its KV-sharing layer is skipped), one and four streams.
    The weights are counted from each package's own leaves; for these
    models the two counts are equal (the port cuts MoE's lane padding,
    which none of them has)."""
    jlm, lm = _both(dirs[name], **kw)
    import jax

    jbytes = sum(x.nbytes for x in jax.tree.leaves(jlm.params))
    assert sum(t.numel() * t.element_size() for t in _tensors(lm.params)) == jbytes
    for b in budgets:
        got = lm.recommended_max_context(memory_budget_bytes=b, batch_size=batch_size)
        assert got == jlm.recommended_max_context(memory_budget_bytes=b,
                                                  batch_size=batch_size)
    assert lm.recommended_max_context(2**20) == 1024  # the floor
    with pytest.raises(ValueError, match="memory_budget_bytes"):
        lm.recommended_max_context()


def test_fill_random_bytes_match_jax(dirs):
    """The seeded-random mode fills every tensor of a file (f32, bf16,
    uint8 codes) with the JAX package's bytes."""
    for name in ("llama_int4", "gemma"):
        path = f"{dirs[name]}/model.safetensors"
        jfile, pfile = JaxFile(path), SafetensorsFile(path)
        assert list(jfile.tensors) == list(pfile.tensors)
        for key, jinfo in jfile.tensors.items():
            for seed in (0, 12345):
                a = jtree._fill_random(jinfo, seed)
                b = ptree._fill_random(pfile.tensors[key], seed)
                assert a.shape == b.shape and a.tobytes() == b.tobytes(), key


def test_from_dir_random_seed_matches_jax(dirs):
    """`from_dir(random_seed=s)` builds the model from the header alone:
    its teacher-forced logits equal JAX's within 1e-4 (f32), differ from
    the file's weights, and repeat for the same seed."""
    d = dirs["llama"]
    jlm = JaxLM.from_dir(d, random_seed=3, **LM_KW)
    lm = LanguageModel.from_dir(d, device="cpu", random_seed=3, **LM_KW)
    toks = _prompt(12)
    want, _ = jax_forward(jlm.decoder_config, jlm.params, jnp.asarray(toks, jnp.int32),
                          jlm.new_state(), last_only=False)
    got, _ = decoder_forward(lm.decoder_config, lm.params, torch.as_tensor(toks),
                             lm.new_state(), last_only=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)
    again = LanguageModel.from_dir(d, device="cpu", random_seed=3, **LM_KW)
    file_lm = LanguageModel.from_dir(d, device="cpu", **LM_KW)
    for t, u, v in zip(_tensors(lm.params), _tensors(again.params), _tensors(file_lm.params)):
        assert torch.equal(t, u)
    assert not all(torch.equal(t, v) for t, v in zip(_tensors(lm.params),
                                                    _tensors(file_lm.params)))


@pytest.mark.parametrize("threads", [0, 1, 3])
def test_read_many_equals_read(dirs, threads):
    """The parallel reader returns every tensor with `read`'s dtype, shape
    and bytes, for all tensors and for a subset; the prefetching loader
    and the lazy one build equal trees."""
    for name in ("llama_int4", "gemma"):
        f = SafetensorsFile(f"{dirs[name]}/model.safetensors")
        many = f.read_many(threads=threads)
        assert list(many) == list(f.tensors)
        for key, arr in many.items():
            one = f.read(key)
            assert arr.dtype == one.dtype and arr.shape == one.shape
            assert arr.tobytes() == one.tobytes(), key
        subset = list(f.tensors)[1::3]
        assert list(f.read_many(subset, threads=threads)) == subset
    path = f"{dirs['llama_int4']}/model.safetensors"
    eager, lazy = ptree.ParameterLoader(path), ptree.ParameterLoader(path, prefetch=False)
    for key in eager.keys():
        assert eager._read(key).tobytes() == lazy._read(key).tobytes()
