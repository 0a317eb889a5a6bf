"""The port's dense `BatchEngine` against its single stream and the JAX engine, on the CPU.

Tiny models: an INT4 Llama-shaped flagship (attention only, so prompts
that share a prefix admit through the KV-row copy) and a Gated DeltaNet
hybrid (recurrent state per slot, never shared). Greedy batched streams
equal `generate_list`'s with slot reuse, late admission, long prompts
prefilled one chunk per scheduler step and context growth, and equal the
JAX `BatchEngine`'s; cancel, per-request sampling, logprobs and count
penalties run on the same engine.
"""

import dataclasses

import numpy as np
import pytest
import torch

from uzu_tpu import LanguageModel as JaxLM
from uzu_tpu.config.model import (
    IntSpec as JaxIntSpec,
    Layout as JaxLayout,
    UntiedEmbeddingConfig as JaxUntied,
)
from uzu_tpu.engine.batch import BatchEngine as JaxBatchEngine
from uzu_tpu.tools import synth as jsynth
from uzu_tpu_torch import LanguageModel
from uzu_tpu_torch.engine.batch import BatchEngine
from uzu_tpu_torch.engine.sampling import SamplingParams
from uzu_tpu_torch.models.batch_decode import batch_decode_step
from uzu_tpu_torch.models.decoder import decoder_forward

torch.set_num_threads(1)

VOCAB = 512
INT4 = JaxIntSpec(bits=4, group_size=32, is_symmetric=True, layout=JaxLayout.OUTPUT_INPUT)


def untied(cfg):
    """A JAX-package config with untied embeddings (random tied models
    collapse into repeating the input token)."""
    dc = dataclasses.replace(cfg.decoder_config, embedding_config=JaxUntied(
        input_scale=None, logit_soft_cap=None))
    return dataclasses.replace(cfg, decoder_config=dc)


@pytest.fixture(scope="module")
def model_dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_batch")
    flagship = jsynth.llama_config(num_layers=2, model_dim=128, hidden_dim=256, num_heads=8,
                                   num_groups=2, head_dim=16, vocab_size=VOCAB, tied=False)
    return {
        "flagship": jsynth.synthesize(flagship, str(root / "flagship"), seed=13,
                                      linear_spec=INT4, dtype=np.float32),
        "hybrid": jsynth.synthesize(untied(jsynth.qwen35_config(vocab_size=VOCAB)),
                                    str(root / "hybrid"), seed=11, dtype=np.float32),
    }


def _lm(model_dirs, name, **kw):
    kw = {"max_context": 256, "prefill_buckets": (16, 64), **kw}
    return LanguageModel.from_dir(model_dirs[name], device="cpu", **kw)


def _prompts():
    return [list((np.arange(n) * m + o) % VOCAB)
            for n, m, o in ((3, 7, 1), (5, 11, 2), (30, 13, 3), (2, 17, 4), (90, 19, 5),
                            (12, 23, 6))]


@pytest.mark.parametrize("name", ["flagship", "hybrid"])
@pytest.mark.parametrize("batch_size,chunk", [(3, 4), (2, 8)])
def test_greedy_streams_equal_single_stream(model_dirs, name, batch_size, chunk):
    """More requests than slots (slot reuse); the 90-token prompt takes two
    prefill chunks interleaved with decode chunks; two requests arrive
    while the others decode (late admission)."""
    lm = _lm(model_dirs, name)
    eng = BatchEngine(lm, batch_size=batch_size, decode_chunk=chunk, stop_token_ids=[])
    prompts = _prompts()
    reqs = [eng.submit(p, 10 + i) for i, p in enumerate(prompts[:4])]
    for _ in range(3):
        eng.step()
    reqs += [eng.submit(p, 9) for p in prompts[4:]]
    eng.run()
    for r, p in zip(reqs, prompts):
        want = lm.generate_list(np.asarray(p), r.max_new_tokens, stop_token_ids=[])
        assert r.finished and r.finish_reason == "length"
        assert r.tokens == want
    assert eng.stats["prefill_chunks"] >= len(prompts) + 1
    assert eng.num_active == 0


@pytest.mark.parametrize("name", ["flagship", "hybrid"])
def test_greedy_streams_match_jax_engine(model_dirs, name):
    lm = _lm(model_dirs, name)
    jlm = JaxLM.from_dir(model_dirs[name], max_context=256, prefill_buckets=(16, 64))
    prompts = _prompts()
    eng = BatchEngine(lm, batch_size=3, decode_chunk=4, stop_token_ids=[])
    jeng = JaxBatchEngine(jlm, batch_size=3, decode_chunk=4, stop_token_ids=[])
    reqs = [eng.submit(p, 12) for p in prompts]
    jreqs = [jeng.submit(p, 12) for p in prompts]
    eng.run()
    jeng.run()
    assert [r.tokens for r in reqs] == [r.tokens for r in jreqs]


def test_stop_tokens_finish_streams(model_dirs):
    lm = _lm(model_dirs, "hybrid")
    p = _prompts()[2]
    stream = lm.generate_list(np.asarray(p), 12, stop_token_ids=[])
    stop = stream[4]
    eng = BatchEngine(lm, batch_size=2, decode_chunk=4, stop_token_ids=[stop])
    r = eng.submit(p, 12)
    other = eng.submit(_prompts()[0], 12)
    eng.run()
    assert r.finish_reason == "stop" and r.tokens == stream[:stream.index(stop) + 1]
    assert other.finished


def test_prefix_sharing_for_attention_only_models(model_dirs):
    """A prompt that shares 70 tokens with a live slot's history copies
    those KV rows and prefills only its tail: the stream is unchanged. A
    hybrid never shares."""
    base = list((np.arange(70) * 29 + 7) % VOCAB)
    prompts = [base + [1, 2, 3], base + [9, 8]]
    for name, shared in (("flagship", True), ("hybrid", False)):
        lm = _lm(model_dirs, name)
        eng = BatchEngine(lm, batch_size=2, decode_chunk=4, stop_token_ids=[])
        assert (eng.prefix_min > 0) == shared
        first = eng.submit(prompts[0], 8)
        eng.step()
        second = eng.submit(prompts[1], 8)
        eng.run()
        assert (eng.stats["shared_prefix_tokens"] > 0) == shared
        for r, p in ((first, prompts[0]), (second, prompts[1])):
            assert r.tokens == lm.generate_list(np.asarray(p), 8, stop_token_ids=[])


def test_context_growth(model_dirs):
    """max_context 2048: the batched caches start at one 1024-slot bucket
    and grow when a slot's prompt crosses it."""
    lm = _lm(model_dirs, "flagship", max_context=2048, prefill_buckets=(16, 256))
    eng = BatchEngine(lm, batch_size=2, decode_chunk=4, stop_token_ids=[])
    assert eng._ctx_cap == 1024
    short = eng.submit(_prompts()[1], 6)
    eng.step()
    long_prompt = list((np.arange(1100) * 7 + 3) % VOCAB)
    long = eng.submit(long_prompt, 6)
    eng.run()
    assert eng._ctx_cap == 2048
    assert short.tokens == lm.generate_list(np.asarray(_prompts()[1]), 6, stop_token_ids=[])
    assert long.tokens == lm.generate_list(np.asarray(long_prompt), 6, stop_token_ids=[])


def test_cancel(model_dirs):
    lm = _lm(model_dirs, "hybrid")
    # one admission step between decode chunks, so the long prompt's
    # admission is caught between its two prefill chunks
    eng = BatchEngine(lm, batch_size=2, decode_chunk=4, stop_token_ids=[],
                      admit_greedy=False)
    prompts = _prompts()
    running = eng.submit(prompts[0], 40)
    admitting = eng.submit(prompts[4], 40)  # 90 tokens: two prefill chunks
    queued = eng.submit(prompts[1], 40)
    eng.step()
    eng.step()
    assert eng._admitting is not None and eng._admitting[0] is admitting
    assert eng.cancel(admitting) and eng._admitting is None
    assert eng.cancel(queued) and queued not in eng.queue
    eng.step()
    assert eng.cancel(running, "client") and running.finish_reason == "client"
    assert not eng.cancel(running)
    late = eng.submit(prompts[3], 5)
    eng.run()
    assert [r.finished for r in (running, admitting, queued, late)] == [True] * 4
    assert late.tokens == lm.generate_list(np.asarray(prompts[3]), 5, stop_token_ids=[])


def test_sampled_requests_are_reproducible(model_dirs):
    """Per-request sampling rows and seeds: a rerun gives the same tokens,
    another seed other tokens, and the greedy request beside them stays
    the single stream."""
    lm = _lm(model_dirs, "hybrid")
    samp = SamplingParams(temperature=0.9, top_k=40, top_p=0.95, min_p=0.02)
    prompts = _prompts()

    def run(seed):
        eng = BatchEngine(lm, batch_size=3, decode_chunk=4, stop_token_ids=[])
        a = eng.submit(prompts[2], 16, seed=seed, sampling=samp)
        b = eng.submit(prompts[0], 16, seed=seed + 1, sampling=samp,
                       presence_penalty=0.5, frequency_penalty=0.3, logprobs=3)
        g = eng.submit(prompts[1], 16)
        assert eng._samp_custom.sum() == 0
        eng.run()
        assert len(b.logprob_content) == 16
        return a.tokens, b.tokens, g.tokens

    first, again, other = run(7), run(7), run(8)
    assert first == again and first[:2] != other[:2]
    assert first[2] == lm.generate_list(np.asarray(prompts[1]), 16, stop_token_ids=[])


def test_grammar_and_ring_layouts_are_refused(model_dirs):
    lm = _lm(model_dirs, "flagship")
    eng = BatchEngine(lm, batch_size=2)
    with pytest.raises(ValueError):
        eng.submit([1, 2, 3], 4, grammar=object())
    # ring layouts are served since the Gemma slice: the engine pins its
    # capacity at max_context and turns prefix sharing off, as the JAX one
    ring = _lm(model_dirs, "flagship", ring_windows=True, max_context=2048)
    eng = BatchEngine(ring, batch_size=2)
    assert eng._ctx_cap == 2048 and eng.prefix_min == 0


def test_batched_state_layout(model_dirs):
    lm = _lm(model_dirs, "hybrid")
    state = lm.new_state(batch_size=3, ctx_capacity=64)
    single = lm.new_state(ctx_capacity=64)
    assert tuple(state["pos"].shape) == (3,)
    for b, s in zip(state["layers"], single["layers"]):
        for k in s:
            assert tuple(b[k].shape) == (3, *s[k].shape) and b[k].dtype == s[k].dtype


@pytest.mark.parametrize("name", ["flagship", "hybrid"])
def test_batch_decode_step_rows_equal_single_steps(model_dirs, name):
    """Each slot's row of one batched step equals the single-sequence
    decoder at that slot's position, and a slot with fed 0 keeps its state."""
    lm = _lm(model_dirs, name)
    cfg = lm.decoder_config
    prompts = [_prompts()[i] for i in (0, 2, 4)]
    batch = lm.new_state(batch_size=3)
    singles = []
    for i, p in enumerate(prompts):
        _, st = lm.prefill(lm.new_state(), p)
        singles.append(st)
        for f, o in zip(batch["layers"], st["layers"]):
            for k in f:
                f[k][i].copy_(o[k])
        batch["pos"][i] = st["pos"]
    tokens = torch.tensor([5, 6, 7])
    fed = torch.tensor([1, 0, 1], dtype=torch.int32)
    before = [{k: v[1].clone() for k, v in layer.items()} for layer in batch["layers"]
              if "conv" in layer]
    logits, out = batch_decode_step(cfg, lm.params, tokens, batch, fed)
    for i in (0, 2):
        want, _ = decoder_forward(cfg, lm.params, tokens[i:i + 1], singles[i])
        np.testing.assert_allclose(logits[i].numpy(), want[0].numpy(), rtol=1e-4, atol=1e-4)
    assert out["pos"].tolist() == [len(prompts[0]) + 1, len(prompts[1]), len(prompts[2]) + 1]
    after = [layer for layer in out["layers"] if "conv" in layer]
    for b, a in zip(before, after):
        for k in b:
            assert torch.equal(a[k][1], b[k])


def test_hybrid_on_a_machine_without_a_card_raises(model_dirs, monkeypatch):
    """The entry points default to the card and never drop to the CPU on
    their own."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LanguageModel.from_dir(model_dirs["hybrid"])


@pytest.mark.parametrize("name", ["flagship", "hybrid"])
def test_int8_kv_cache_streams_equal_single_stream(model_dirs, name):
    """With the INT8 KV cache, the batched step writes codes and scales per
    slot and reads them back as the single stream does."""
    lm = _lm(model_dirs, name, kv_quant=True)
    eng = BatchEngine(lm, batch_size=2, decode_chunk=4, stop_token_ids=[])
    prompts = [_prompts()[i] for i in (0, 2, 4)]
    reqs = [eng.submit(p, 8) for p in prompts]
    eng.run()
    for r, p in zip(reqs, prompts):
        assert r.tokens == lm.generate_list(np.asarray(p), 8, stop_token_ids=[])
