"""Jamba2-3B's pieces of the benchmark at a tiny size on the CPU: the
reference (Mamba-1 scanned in blocks, NoPE attention) equals the port's
forward in f32; a served run is correct; planted faults in the Mamba
state (the decode step handing back the old state, the prefill dropping
the carry between chunks) turn `correct` false; the control reads wider
than the program; the cell's configuration maps onto the published
shapes."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from portbench import check, harness, model, traffic, weights
from portbench.kinds import mamba1 as kind
from portbench.reference import mamba1 as ref_mamba1
from portbench.reference import model as reference
from portbench.spec import find, load_json, model_spec
from portbench.tests import tiny

JAMBA = {"name": "tiny-jamba", "model_type": "jamba", "hidden_size": 64,
         "intermediate_size": 128, "num_hidden_layers": 4, "attn_layer_period": 4,
         "attn_layer_offset": 2, "num_attention_heads": 4, "num_key_value_heads": 1,
         "rms_norm_eps": 1e-6, "vocab_size": 256, "max_position_embeddings": 4096,
         "num_experts": 1, "mamba_expand": 2, "mamba_d_state": 16, "mamba_dt_rank": 32,
         "mamba_d_conv": 4,
         "engine": {"kind": "dense", "batch_size": 3, "decode_chunk": 4, "max_context": 256,
                    "prefill_buckets": [16, 32, 64]}}


# one bucket of 16 rows: a prompt is many chunks, the last of them short,
# so what crosses a chunk boundary reaches the sampled logits
SHORT_CHUNKS = dict(JAMBA, engine=dict(JAMBA["engine"], prefill_buckets=[16]))


def _run(config=JAMBA, limit=0.25):
    """A 3-second window: long enough, on a loaded CPU, for requests to end
    in it (the plain per-token scan is slow)."""
    out = harness.run_cell(tiny.loaded(config, limit), seed=2 ** 32 + 7, seconds=3.0,
                           trace=False, device="cpu", t_process=0.0, log=lambda **kw: None)
    return out["result"]


@pytest.mark.parametrize("block,chunk", [(2048, 64), (32, 8)])
def test_reference_equals_port_forward_in_f32(block, chunk, monkeypatch):
    """Whole-sequence logits; the reference's scan in one block, and in
    blocks of 32 rows cut into chunks of 8 (the carry between blocks and
    chunks in play)."""
    from uzu_tpu_torch.models.decoder import decoder_forward
    from uzu_tpu_torch.models.state import init_state

    monkeypatch.setattr(ref_mamba1, "BLOCK", block)
    monkeypatch.setattr(ref_mamba1, "CHUNK", chunk)
    spec = model_spec(JAMBA)
    raw = weights.make_raw(spec, 2 ** 31 + 101, "cpu")
    raw32 = {k: (v.float() if k.endswith(".scales") else v) for k, v in raw.items()}
    lm = model.language_model(spec, raw32, JAMBA["engine"], "cpu")
    toks = np.random.default_rng(1).integers(0, spec.vocab, 90)
    state = init_state(lm.decoder_config, 256, torch.float32)
    logits, _ = decoder_forward(lm.decoder_config, lm.params, torch.as_tensor(toks), state,
                                last_only=False)
    ref = reference.logits(spec, raw32, [toks.tolist()], [list(range(90))])[0]
    err = (logits - ref).norm() / ref.norm()
    assert err < 2e-5, float(err)
    assert ref.std() > 1.0


def test_served_run_is_correct():
    res = _run()
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0


def test_decode_step_hands_back_the_old_mamba_state(monkeypatch):
    """The dense decode step advances positions and KV but returns each
    Mamba-1 layer's state as it was given."""
    from uzu_tpu_torch.config.model import Mamba1Config
    from uzu_tpu_torch.engine import batch

    inner = batch.batch_decode_step

    def stale(cfg, params, tokens, state, fed, ctx=None):
        logits, new = inner(cfg, params, tokens, state, fed, ctx)
        layers = [old if isinstance(lc.mixer_config, Mamba1Config) else nw
                  for lc, old, nw in zip(cfg.transformer_config.layer_configs, state["layers"],
                                         new["layers"])]
        return logits, {"layers": layers, "pos": new["pos"]}

    monkeypatch.setattr(batch, "batch_decode_step", stale)
    assert not _run()["correct"]


def test_prefill_drops_the_carry_between_chunks(monkeypatch):
    """Every prefill chunk's scan starts from a zero state; the decode
    steps (one row) keep theirs."""
    from uzu_tpu_torch.models import ssm

    inner = ssm.selective_scan

    def dropped(x, dt, z, b, c, a_log, dt_bias, d_skip, h0, lengths):
        if x.shape[1] > 1:
            h0 = torch.zeros_like(h0)
        return inner(x, dt, z, b, c, a_log, dt_bias, d_skip, h0, lengths)

    assert _run(SHORT_CHUNKS)["correct"]
    monkeypatch.setattr(ssm, "selective_scan", dropped)
    assert not _run(SHORT_CHUNKS)["correct"]


@pytest.mark.parametrize("seed", [21, 22, 23])
def test_control_reads_wider_than_the_program(seed):
    spec = model_spec(JAMBA)
    raw = weights.make_raw(spec, seed, "cpu")
    lm = model.language_model(spec, raw, JAMBA["engine"], "cpu")
    from portbench.engines import dense

    engine = dense.build(lm, JAMBA["engine"])
    stream = traffic.Stream(tiny.MIX, seed, spec.vocab)
    reqs = [stream.request(i % 3, i // 3) for i in range(6)]
    subs = [engine.submit(r.prompt, r.max_new_tokens) for r in reqs]
    engine.run()
    picks = [{"prompt": s.prompt, "tokens": list(s.tokens), "n_prompt": len(s.prompt)}
             for s in subs]
    gaps, ref = check.served_gaps(spec, raw, picks)
    ctl = check.control_gaps(spec, raw, picks, ref)
    program = max(max(g) for g in gaps)
    control = max(max(g) for g in ctl)
    assert control > 2 * max(program, 0.02), (program, control)


def test_mapped_vectors_follow_the_published_initialisation():
    spec = model_spec(JAMBA)
    raw = weights.make_raw(spec, 5, "cpu")
    m = kind.mapped(raw, "L0.")
    assert torch.allclose(m["a_log"], torch.log(torch.arange(1.0, 17.0)).expand(128, 16))
    dt = torch.nn.functional.softplus(m["dt_bias"])
    assert dt.min() >= 1e-3 * 0.999 and dt.max() <= 1e-1 * 1.001
    assert dt.max() / dt.min() > 10  # spread over the range, not one value
    assert m["conv_bias"].abs().max() < 0.6 and m["conv_bias"].std() > 0.05


def test_published_shapes():
    c = load_json(find("configs", "jamba2-3b"))
    c["name"] = "jamba2-3b"
    spec = model_spec(c)
    assert [i for i, k in enumerate(spec.kinds) if k == "attention_nope"] == [7, 21]
    assert spec.count("mamba1") == 26 and spec.num_layers == 28
    assert (spec.inner, spec.state, spec.dt_rank, spec.conv_kernel) == (5120, 16, 160, 4)
    assert (spec.heads, spec.kv_heads, spec.head_dim) == (20, 1, 128)
    from portbench.work import linear_params

    params = linear_params(spec) + spec.vocab * spec.d
    assert 2.95e9 < params < 3.1e9, params
    assert kind.linears(spec) == [("in", 10240, 2560), ("x", 192, 5120), ("dt", 5120, 160),
                                  ("out", 2560, 5120)]
    # a row of the scan reads x, dt, z and B, C and writes y: ~41 KB
    assert kind.scan_work(spec, 1, 0)[1] == 8 * 5120 + 4 * 16


def test_new_reference_modules_import_nothing_of_the_port():
    code = ("import sys; import portbench.reference.mamba1, "
            "portbench.reference.attention_nope; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'uzu_tpu', 'uzu_tpu_torch', 'jax', 'jaxlib', 'flax'}))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=harness.ROOT, check=True)
    assert out.stdout.strip() == "[]"


def test_traced_cpu_run_reads_the_new_metrics_as_nothing():
    """Without a card there is no slice: both readers return None."""
    out = harness.run_cell(dict(tiny.loaded(JAMBA), per_layer=[
        {"name": "ssm_scan_roofline", "unit": "%"},
        {"name": "model.ssm_mixer_share", "unit": "%"}]), seed=9, seconds=0.5, trace=True,
        device="cpu", t_process=0.0, log=lambda **kw: None)
    assert out["result"]["metrics"] == {}
    assert os.path.exists(os.path.join(harness.HERE, "kernel_groups", "ssm_scan"))
