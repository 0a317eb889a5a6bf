"""The check against planted faults and against the control, at a tiny
size on the CPU: each fault the served cells can have turns `correct`
false through a whole run, and the control (the reference at fp8) reads a
wider gap than the program on the same prompts and tokens."""

import numpy as np
import pytest
import torch

from portbench import check, harness, model, traffic, weights
from portbench.spec import model_spec
from portbench.tests import tiny

CONFIGS = [tiny.QWEN, tiny.LFM2]
IDS = ["qwen3", "lfm2"]


def _run(config, limit=0.25):
    out = harness.run_cell(tiny.loaded(config, limit), seed=2 ** 32 + 3, seconds=1.0,
                           trace=False, device="cpu", t_process=0.0, log=lambda **kw: None)
    return out["result"]


@pytest.mark.parametrize("config", CONFIGS, ids=IDS)
def test_token_altered_where_sampled(config, monkeypatch):
    from uzu_tpu_torch.engine.batch import BatchEngineBase

    inner = BatchEngineBase._sample_rows
    vocab = config["vocab_size"]
    monkeypatch.setattr(BatchEngineBase, "_sample_rows",
                        lambda self, *a, **k: (inner(self, *a, **k) + 1) % vocab)
    assert not _run(config)["correct"]


@pytest.mark.parametrize("config", CONFIGS, ids=IDS)
def test_first_token_altered(config, monkeypatch):
    from uzu_tpu_torch.engine.batch import BatchEngineBase

    inner = BatchEngineBase._first_token
    vocab = config["vocab_size"]

    def first(self, *a, **k):
        out = inner(self, *a, **k)
        return [(out[0] + 7) % vocab] + out[1:]

    monkeypatch.setattr(BatchEngineBase, "_first_token", first)
    assert not _run(config)["correct"]


def test_decode_step_returns_state_unchanged_paged(monkeypatch):
    """The paged decode step's KV writes are dropped: its pools stay as
    they were."""
    from uzu_tpu_torch.models import paged_decode

    monkeypatch.setattr(paged_decode, "write_rows", lambda *a, **k: None)
    assert not _run(tiny.QWEN)["correct"]


def test_decode_step_returns_state_unchanged_dense(monkeypatch):
    """The dense decode step hands back the state it was given: positions
    and recurrent states do not advance."""
    from uzu_tpu_torch.engine import batch

    inner = batch.batch_decode_step

    def stale(cfg, params, tokens, state, fed, ctx=None):
        logits, _ = inner(cfg, params, tokens, state, fed, ctx)
        return logits, state

    monkeypatch.setattr(batch, "batch_decode_step", stale)
    assert not _run(tiny.LFM2)["correct"]


def _served(config, seed, n=6):
    """Requests of the tiny mix served to completion (no clock involved)."""
    spec = model_spec(config)
    raw = weights.make_raw(spec, seed, "cpu")
    lm = model.language_model(spec, raw, config["engine"], "cpu")
    import importlib

    engine = importlib.import_module(f"portbench.engines.{config['engine']['kind']}").build(
        lm, config["engine"])
    stream = traffic.Stream(tiny.MIX, seed, spec.vocab)
    reqs = [stream.request(i % 3, i // 3) for i in range(n)]
    subs = [engine.submit(r.prompt, r.max_new_tokens) for r in reqs]
    engine.run()
    picks = [{"prompt": s.prompt, "tokens": list(s.tokens), "n_prompt": len(s.prompt)}
             for s in subs]
    return spec, raw, picks


@pytest.mark.parametrize("seed", [11, 12, 13])
@pytest.mark.parametrize("config", CONFIGS, ids=IDS)
def test_control_reads_wider_than_the_program(config, seed):
    spec, raw, picks = _served(config, seed)
    gaps, ref = check.served_gaps(spec, raw, picks)
    ctl = check.control_gaps(spec, raw, picks, ref)
    program = max(max(g) for g in gaps)
    control = max(max(g) for g in ctl)
    assert control > 2 * max(program, 0.02), (program, control)
    assert np.isfinite(program)
