"""Mamba-1 (Jamba) in the port, on the CPU, against a plain f32 reference.

A tiny Jamba (4 layers, attention at layer 2, d 256, Di 512, N 16, dt rank
16, f32 weights) runs through the port's normal path: chunked prefill
(`decoder_forward` and `BatchEngine` admission, chunks of 1, 7, 64 and
100 rows) and the dense `BatchEngine`'s decode step, each against
`jamba_reference.py`'s full forward in logits. The plain selective scan
is held to a float64 per-token recurrence with a warm state and padded
lengths; the config round-trips; the `model.ssm_mixer` span is recorded
only under a profiler; and a prefill that drops the carried state at a
chunk boundary fails the same comparison.

Tolerances: every path here is f32 (weights, activations, states and, by
the patched `init_state`, the engine's KV caches), so port and reference
differ only by the order of f32 sums (chunked against whole products,
the conv's taps, the scan's per-step order): a relative L2 error of
~1e-6. LOGIT_TOL = 1e-4 leaves two decades for that, and a dropped
carry reads two decades above it.
"""

import numpy as np
import pytest
import torch

import jamba_reference
from uzu_tpu_torch import LanguageModel
from uzu_tpu_torch.config import dumps, loads
from uzu_tpu_torch.config.model import FullPrecisionSpec, Layout, Mamba1Config
from uzu_tpu_torch.engine import batch as batch_mod
from uzu_tpu_torch.engine import engine as engine_mod
from uzu_tpu_torch.engine.batch import BatchEngine
from uzu_tpu_torch.models import ssm
from uzu_tpu_torch.models.decoder import decoder_forward
from uzu_tpu_torch.models.state import init_state
from uzu_tpu_torch.ops.cuda import build
from uzu_tpu_torch.ops.cuda.selective_scan import selective_scan, selective_scan_plain
from uzu_tpu_torch.tools import profile
from uzu_tpu_torch.tools.synth import ModelBuilder, jamba_config

torch.set_num_threads(2)

CFG = jamba_config()
DIMS = dict(num_layers=4, attn_period=4, attn_offset=2, inner_dim=512, state_dim=16,
            dt_rank=16, heads=4, kv_heads=1, head_dim=64, eps=1e-6)
LOGIT_TOL = 1e-4
VOCAB = CFG.decoder_config.vocab_size
PROMPTS = [[int(t) for t in np.random.default_rng(5).integers(0, VOCAB, 150)],
           [int(t) for t in np.random.default_rng(6).integers(0, VOCAB, 37)]]
NEW = 9


def _rel(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got - want).norm() / want.norm())


@pytest.fixture(scope="module")
def model(tmp_path_factory):
    """(model dir, the reference's weights by file name, reference logits
    of each prompt followed by its greedy continuation)."""
    b = ModelBuilder(seed=24, dtype=np.float32)
    b.build_decoder(CFG.decoder_config, FullPrecisionSpec(layout=Layout.OUTPUT_INPUT),
                    FullPrecisionSpec(layout=Layout.INPUT_OUTPUT))
    d = b.write(str(tmp_path_factory.mktemp("jamba")), CFG)
    w = {k: torch.from_numpy(np.asarray(v, np.float32)) for k, v in b.tensors.items()}
    return d, w


def _lm(model_dir, chunk: int) -> LanguageModel:
    return LanguageModel.from_dir(model_dir, device="cpu", max_context=256,
                                  prefill_buckets=(chunk,))


@pytest.mark.parametrize("chunk", [1, 7, 64, 100])
def test_chunked_prefill_matches_reference(model, chunk):
    """Chunks of `chunk` real rows, each padded by 3 rows past its true
    length, carry the conv tail and the state from chunk to chunk."""
    model_dir, w = model
    lm = _lm(model_dir, chunk)
    prompt = PROMPTS[0]
    state = init_state(lm.decoder_config, 256, torch.float32)
    rows = []
    for i in range(0, len(prompt), chunk):
        take = min(chunk, len(prompt) - i)
        toks = torch.zeros(take + 3, dtype=torch.long)
        toks[:take] = torch.as_tensor(prompt[i:i + take])
        logits, state = decoder_forward(lm.decoder_config, lm.params, toks, state,
                                        last_only=False, true_length=take)
        rows.append(logits[:take])
    ref = jamba_reference.logits(w, prompt, DIMS)
    assert _rel(torch.cat(rows), ref) < LOGIT_TOL
    assert int(state["pos"]) == len(prompt)


@pytest.mark.parametrize("chunk", [1, 7, 64, 100])
def test_batch_engine_matches_reference(model, chunk, monkeypatch):
    """Both prompts admitted through chunked prefill into the dense engine's
    slots, then decoded together: the first token's prefill logits and
    every decode step's logits (teacher-forced by the served tokens in the
    reference) agree with the reference."""
    model_dir, w = model
    monkeypatch.setattr(engine_mod, "init_state",
                        lambda cfg, ctx, **kw: init_state(cfg, ctx, torch.float32, **kw))
    lm = _lm(model_dir, chunk)
    steps = []
    inner = batch_mod.batch_decode_step

    def recorded(cfg, params, tokens, state, fed, ctx=None):
        logits, new = inner(cfg, params, tokens, state, fed, ctx)
        steps.append((logits.clone(), fed.clone()))
        return logits, new

    monkeypatch.setattr(batch_mod, "batch_decode_step", recorded)
    eng = BatchEngine(lm, batch_size=2, decode_chunk=4, stop_token_ids=[])
    reqs = [eng.submit(p, NEW) for p in PROMPTS]
    eng.run()
    for slot, (req, prompt) in enumerate(zip(reqs, PROMPTS)):
        assert len(req.tokens) == NEW
        ref = jamba_reference.logits(w, prompt + req.tokens[:-1], DIMS)
        fed = [lg[slot] for lg, f in steps if int(f[slot])][:NEW - 1]
        got = torch.stack(fed)
        want = ref[len(prompt):]
        assert _rel(got, want) < LOGIT_TOL, (slot, _rel(got, want))
        assert req.tokens[0] == int(ref[len(prompt) - 1].argmax())


def test_scan_plain_matches_recurrence():
    """The plain scan against a float64 loop over tokens, channels and
    states, from a warm state, with one sequence padded past its length and
    one of length 0 (every row an identity transition)."""
    g = torch.Generator().manual_seed(3)
    b, s, di, n = 3, 11, 8, 16
    x, dt, z = (torch.randn(b, s, di, generator=g) for _ in range(3))
    bm, cm = (torch.randn(b, s, n, generator=g) for _ in range(2))
    a_log = torch.log(torch.arange(1, n + 1, dtype=torch.float32)).repeat(di, 1)
    a_log = a_log + 0.1 * torch.randn(di, n, generator=g)
    dt_bias, d_skip = torch.randn(di, generator=g) - 3.0, torch.randn(di, generator=g)
    h0 = torch.randn(b, di, n, generator=g)
    lengths = torch.tensor([s, s - 4, 0], dtype=torch.int32)
    y, h = selective_scan_plain(x, dt, z, bm, cm, a_log, dt_bias, d_skip, h0, lengths)

    dd = {k: v.double().numpy() for k, v in dict(
        x=x, dt=dt, z=z, b=bm, c=cm, a_log=a_log, dt_bias=dt_bias, d=d_skip, h0=h0).items()}
    want_y = np.zeros((b, s, di))
    want_h = dd["h0"].copy()
    for bi in range(b):
        for t in range(s):
            for ch in range(di):
                v = dd["dt"][bi, t, ch] + dd["dt_bias"][ch]
                delta = v if v > 20 else np.log1p(np.exp(v))
                if t < int(lengths[bi]):
                    for k in range(n):
                        decay = np.exp(-delta * np.exp(dd["a_log"][ch, k]))
                        want_h[bi, ch, k] = decay * want_h[bi, ch, k] + \
                            delta * dd["b"][bi, t, k] * dd["x"][bi, t, ch]
                yv = want_h[bi, ch] @ dd["c"][bi, t] + dd["d"][ch] * dd["x"][bi, t, ch]
                zv = dd["z"][bi, t, ch]
                want_y[bi, t, ch] = yv * zv / (1 + np.exp(-zv))
    np.testing.assert_allclose(y.double().numpy(), want_y, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(h.double().numpy(), want_h, rtol=1e-5, atol=1e-5)
    assert torch.equal(h[2], h0[2])
    # the dispatching wrapper takes the plain version for CPU tensors
    y2, h2 = selective_scan(x, dt, z, bm, cm, a_log, dt_bias, d_skip, h0, lengths)
    assert torch.equal(y2, y) and torch.equal(h2, h)


def test_config_round_trip():
    text = dumps(CFG)
    assert loads(type(CFG), text) == CFG
    mixers = [lc.mixer_config for lc in CFG.decoder_config.transformer_config.layer_configs]
    assert [type(m).__name__ for m in mixers] == ["Mamba1Config", "Mamba1Config",
                                                  "AttentionConfig", "Mamba1Config"]
    assert '"type": "Mamba1Config"' in text.replace('":"', '": "')
    assert all(lc.rope_config is None
               for lc in CFG.decoder_config.transformer_config.layer_configs)


def test_span_and_counters_only_while_profiling(model):
    """`model.ssm_mixer` spans (rows, layer) for each Mamba-1 call of a
    prefill chunk and of each decode step under a profiler session, none
    outside one; the CPU path launches no kernel."""
    model_dir, _ = model
    lm = _lm(model_dir, 16)
    build.reset_launches()
    t0 = profile.time.perf_counter()
    lm.generate_list(np.asarray(PROMPTS[1][:10]), 3, stop_token_ids=[])
    assert not [s for s in profile.spans(t0, profile.time.perf_counter())
                if s[0] == "model.ssm_mixer"]
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        t0 = profile.time.perf_counter()
        lm.generate_list(np.asarray(PROMPTS[1][:10]), 3, stop_token_ids=[])
        t1 = profile.time.perf_counter()
    spans = [s for s in profile.spans(t0, t1) if s[0] == "model.ssm_mixer"]
    mamba_layers = [0, 1, 3]
    # one prefill chunk (16 rows) and two decode steps (one row each)
    assert [s[6]["layer"] for s in spans] == mamba_layers * 3
    assert [s[6]["rows"] for s in spans] == [16] * 3 + [1] * 6
    assert all(t0 <= s[1] <= s[2] <= t1 for s in spans)
    assert build.LAUNCHES["selective_scan"] == build.LAUNCHES["selective_scan_step"] == 0


def test_speculation_raises_for_mamba1():
    m = CFG.decoder_config.transformer_config.layer_configs[0].mixer_config
    assert isinstance(m, Mamba1Config)
    state = ssm.make_ssm_state(m, 256, device="cpu")
    assert state["ssm"].shape == (512, 16) and state["conv"].shape == (3, 512)
    with pytest.raises(NotImplementedError, match="Mamba-1"):
        ssm.ssm_forward(m, {}, torch.zeros(2, 256), None, state, defer=True)
    with pytest.raises(NotImplementedError, match="Mamba-1"):
        ssm.ssm_tree_forward(m, {}, torch.zeros(2, 256), state, [-1, 0], None)
    with pytest.raises(NotImplementedError, match="Mamba-1"):
        ssm.ssm_commit_batched(m, {}, torch.ones(1, dtype=torch.int32))


def test_dropped_carry_fails_the_comparison(model, monkeypatch):
    """A planted fault: every prefill chunk's scan starts from a zero state
    (the carry dropped at each boundary). The chunked comparison that the
    sound port passes reads far above its tolerance."""
    inner = ssm.selective_scan

    def dropped(x, dt, z, b, c, a_log, dt_bias, d_skip, h0, lengths):
        return inner(x, dt, z, b, c, a_log, dt_bias, d_skip, torch.zeros_like(h0), lengths)

    monkeypatch.setattr(ssm, "selective_scan", dropped)
    model_dir, w = model
    lm = _lm(model_dir, 7)
    prompt = PROMPTS[0]
    state = init_state(lm.decoder_config, 256, torch.float32)
    rows = []
    for i in range(0, len(prompt), 7):
        take = min(7, len(prompt) - i)
        logits, state = decoder_forward(lm.decoder_config, lm.params,
                                        torch.as_tensor(prompt[i:i + take]), state,
                                        last_only=False)
        rows.append(logits)
    err = _rel(torch.cat(rows), jamba_reference.logits(w, prompt, DIMS))
    assert err > 100 * LOGIT_TOL, err
