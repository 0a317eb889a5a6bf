"""The port's measurement tools (`uzu_tpu_torch/tools/`) and kernel P1, on the CPU.

Quality (teacher-forced NLL, activation traces), the corpus, telemetry,
logs and the profiler hook against the JAX package's `uzu_tpu/tools/` on
the same synthesized models (both synthesizers write identical files);
the microbench and step-breakdown timers on a tiny model (positive times,
every key, a failing probe raises); P1's plain version against the JAX
bisect probe's Pallas block copy run in interpret mode; K1's plain version
with zero-padded scale rows against the JAX kernel in interpret mode; and
the bisect probe itself with the plain versions. Inputs come from seeded
numpy generators; each test states its tolerance.
"""

import functools
import json
import logging
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from uzu_tpu import LanguageModel as JaxLM
from uzu_tpu.ops.pallas.quant_matmul import _quant_matmul_p
from uzu_tpu.quant import format as jq
from uzu_tpu.tools import corpus as jcorpus
from uzu_tpu.tools import quality as jquality
from uzu_tpu_torch import LanguageModel
from uzu_tpu_torch.config.model import IntSpec, Layout
from uzu_tpu_torch.ops.cuda import build
from uzu_tpu_torch.ops.cuda.block_copy import scale_block_copy, scale_block_copy_plain
from uzu_tpu_torch.ops.cuda.quant_matmul import quant_matmul
from uzu_tpu_torch.quant import format as tq
from uzu_tpu_torch.tools import corpus, exp_qmm_bisect, logs, microbench, profile, quality
from uzu_tpu_torch.tools import exp_step_breakdown as sb
from uzu_tpu_torch.tools import telemetry
from uzu_tpu_torch.tools.synth import llama_config, synthesize

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    """The JAX quality tests' model: a 2-layer f32 Llama (f32 keeps the
    comparison at the algorithm)."""
    cfg = llama_config(num_layers=2, model_dim=64, hidden_dim=160, num_heads=4,
                       num_groups=2, head_dim=16, vocab_size=256)
    return synthesize(cfg, str(tmp_path_factory.mktemp("tools_model")), seed=3,
                      dtype=np.float32)


def _port(model_dir, **kw):
    return LanguageModel.from_dir(model_dir, device="cpu", max_context=64,
                                  prefill_buckets=(8,), **kw)


def _jax(model_dir, **kw):
    return JaxLM.from_dir(model_dir, max_context=64, prefill_buckets=(8,), **kw)


# -- quality -------------------------------------------------------------------------------

@pytest.mark.parametrize("chunk", [8, 64])
def test_sequence_nll_matches_jax(model_dir, chunk):
    """Ragged chunks (8, 8, 3) and one chunk: NLL within rtol 1e-5."""
    toks = (np.arange(20) * 7) % 256
    got = quality.sequence_nll(_port(model_dir), toks, chunk=chunk)
    want = jquality.sequence_nll(_jax(model_dir), toks, chunk=chunk)
    assert got["count"] == want["count"] == len(toks) - 1
    np.testing.assert_allclose(got["nll"], want["nll"], rtol=1e-5)
    np.testing.assert_allclose(got["ppl"], want["ppl"], rtol=1e-5)


def test_sequence_nll_rejects_bad_input(model_dir):
    lm = _port(model_dir)
    with pytest.raises(ValueError, match="max_context"):
        quality.sequence_nll(lm, np.zeros(65, np.int64))
    with pytest.raises(ValueError, match="at least 2"):
        quality.sequence_nll(lm, [3])


@pytest.mark.parametrize("kv_quant", [False, True], ids=["bf16_kv", "int8_kv"])
def test_capture_trace_matches_jax(model_dir, kv_quant):
    """Every entry of the trace (embedding, each layer, the final norm, the
    logits) within 1e-4 of its RMS of the JAX package's."""
    toks = (np.arange(10) * 3) % 256
    got = quality.capture_trace(_port(model_dir, kv_quant=kv_quant), toks)
    want = jquality.capture_trace(_jax(model_dir, kv_quant=kv_quant), toks)
    assert sorted(got) == sorted(want) == sorted(
        ["embedding", "layers.0", "layers.1", "output_norm", "logits"])
    for key, w in want.items():
        assert got[key].shape == w.shape and got[key].dtype == np.float32
        rms = np.sqrt(np.mean(w.astype(np.float64) ** 2))
        assert np.max(np.abs(got[key] - w)) <= 1e-4 * rms, key


def test_trace_roundtrip_and_compare(model_dir, tmp_path):
    trace = quality.capture_trace(_port(model_dir), (np.arange(10) * 3) % 256)
    path = str(tmp_path / "trace.safetensors")
    quality.save_trace(path, trace)
    loaded = quality.load_trace(path)
    assert all(np.array_equal(loaded[k], v) for k, v in trace.items())
    report = quality.compare_traces(trace, loaded)
    assert all(v["ok"] for k, v in report.items() if k != "__missing__")
    assert report["__missing__"] == []
    # the JAX package reads the port's file
    assert sorted(jquality.load_trace(path)) == sorted(trace)
    bad = quality.compare_traces({**trace, "extra": trace["logits"]},
                                 {**loaded, "logits": loaded["logits"] + 1.0})
    assert not bad["logits"]["ok"] and bad["__missing__"] == ["extra"]


def test_kv_quant_trace_delta(model_dir):
    """INT8 KV stays within the JAX test's per-layer activation delta of
    full precision (rtol 0.15, atol 0.05)."""
    toks = (np.arange(16) * 5) % 256
    t_fp = quality.capture_trace(_port(model_dir), toks)
    t_q = quality.capture_trace(_port(model_dir, kv_quant=True), toks)
    report = quality.compare_traces(t_q, t_fp, rtol=0.15, atol=0.05)
    bad = {k: v for k, v in report.items() if k != "__missing__" and not v["ok"]}
    assert not bad, bad


def test_capture_trace_rejects_ple(tmp_path):
    """Repaired with the Gemma slice: `capture_trace` no longer rejects a
    model with per-layer embeddings; it threads each layer's PLE input,
    so its logits are the decoder's (`tests/test_torch_gemma.py` holds the
    trace to the JAX package's)."""
    from uzu_tpu_torch.models.decoder import decoder_forward
    from uzu_tpu_torch.tools.synth import gemma_config, synthesize

    d = synthesize(gemma_config(), str(tmp_path / "gemma"), seed=2, dtype=np.float32)
    lm = LanguageModel.from_dir(d, device="cpu", max_context=64)
    toks = [1, 2, 3, 300, 511]  # ids past the PLE vocabulary (256) included
    trace = quality.capture_trace(lm, toks)
    assert {f"layers.{i}" for i in range(4)} <= set(trace)
    want, _ = decoder_forward(lm.decoder_config, lm.params, torch.as_tensor(toks),
                              lm.new_state(), last_only=False)
    np.testing.assert_allclose(trace["logits"], want.numpy(), rtol=1e-5, atol=1e-5)


# -- corpus, telemetry, logs ---------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 7])
def test_corpus_equals_jax(seed):
    assert corpus.generate_text(3000, seed) == jcorpus.generate_text(3000, seed)
    got = corpus.generate_tokens(2048, seed)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, jcorpus.generate_tokens(2048, seed))
    assert corpus.heldout_prompts(3, 32, seed) == jcorpus.heldout_prompts(3, 32, seed)
    assert corpus.record_schema() == jcorpus.record_schema()


def test_telemetry_meter():
    s = telemetry.sample()
    assert s.host.rss_bytes > 0
    assert s.host.peak_rss_bytes >= s.host.rss_bytes // 2
    assert s.cpu_seconds > 0
    assert s.device is None  # no card here
    m = telemetry.ResourceMeter()
    with pytest.raises(RuntimeError, match="not started"):
        m.stop()
    m.start()
    keep = [torch.ones((256, 256)) for _ in range(4)]
    r = m.stop()
    assert r.duration_s > 0 and r.cpu_seconds >= 0 and r.peak_rss_bytes > 0
    assert r.device_buffer_delta_bytes == 0
    assert keep


def test_device_memory_reads_the_caching_allocator(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "memory_stats", lambda: {
        "allocated_bytes.all.current": 4096, "allocation.all.current": 3})
    assert telemetry.device_memory() == telemetry.DeviceMemory(4096, 3)


def test_logs_and_event_journal(tmp_path, monkeypatch):
    path = logs.start(str(tmp_path / "logs"))
    logs.logger("uzu_tpu_torch.test").info("hello log")
    logs.event("reply_finished", tokens=42, model="m")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda *a: "NVIDIA H100 80GB HBM3")
    logs.event("on_card")
    for h in logging.getLogger("uzu_tpu_torch").handlers:
        h.flush()
    assert "hello log" in open(path).read()
    with open(tmp_path / "logs" / "events.jsonl") as f:
        events = [json.loads(line) for line in f]
    assert events[0]["event"] == "reply_finished" and events[0]["tokens"] == 42
    assert "device" not in events[0]
    assert events[1]["device"] == "NVIDIA H100 80GB HBM3"


# -- the profiler hook ---------------------------------------------------------------------

def test_profile_capture_one_shot(model_dir, tmp_path, monkeypatch):
    """UZU_TPU_PROFILE arms a one-shot capture of the first prefill chunk
    and the first decode chunk; a second run adds none. Each trace is a
    Chrome trace of the call's host ops."""
    out = tmp_path / "traces"
    monkeypatch.setenv("UZU_TPU_PROFILE", "prefill,decode")
    monkeypatch.setenv("UZU_TPU_PROFILE_DIR", str(out))
    profile.reset()
    try:
        lm = _port(model_dir)
        first = lm.generate_list(np.asarray([1, 2, 3]), 4, stop_token_ids=[])
        entries = sorted(os.listdir(out))
        assert [e.split("_")[0] for e in entries] == ["decode", "prefill"], entries
        for e in entries:
            with open(out / e / "trace.json") as f:
                events = json.load(f)["traceEvents"]
            assert any(ev.get("cat") == "cpu_op" for ev in events)
        assert lm.generate_list(np.asarray([1, 2, 3]), 4, stop_token_ids=[]) == first
        assert sorted(os.listdir(out)) == entries
    finally:
        profile.reset()


def test_profile_runs_unprofiled_when_capture_fails(monkeypatch, tmp_path, capsys):
    monkeypatch.setenv("UZU_TPU_PROFILE", "decode")
    monkeypatch.setenv("UZU_TPU_PROFILE_DIR", str(tmp_path))

    def refuse(self):
        raise RuntimeError("no profiler here")

    monkeypatch.setattr(torch.profiler.profile, "start", refuse)
    profile.reset()
    calls = []
    try:
        assert profile.profiled("decode", lambda a: calls.append(a) or a + 1, 4) == 5
        assert profile.profiled("prefill", lambda a: calls.append(a) or a, 6) == 6
    finally:
        profile.reset()
    assert calls == [4, 6] and os.listdir(tmp_path) == []
    assert "unavailable" in capsys.readouterr().err


# -- microbench and step breakdown ---------------------------------------------------------

@pytest.fixture(scope="module")
def tiny_dir(tmp_path_factory):
    cfg = llama_config(num_layers=2, model_dim=64, hidden_dim=128, num_heads=4, num_groups=2,
                       head_dim=16, vocab_size=256)
    spec = IntSpec(bits=4, group_size=32, is_symmetric=True, layout=Layout.OUTPUT_INPUT)
    return synthesize(cfg, str(tmp_path_factory.mktemp("tools_tiny")), seed=0,
                      linear_spec=spec, embedding_spec=spec)


@pytest.fixture
def short_loops(monkeypatch):
    """Short differential loops, and the MoE probe at a small width: the
    JAX shapes take minutes on one CPU thread."""
    real = microbench.scan_diff_ms

    def short(fn, args, make_xs, k_small=16, k_big=80, pairs=5):
        return real(fn, args, make_xs, k_small=4, k_big=68, pairs=3)

    monkeypatch.setattr(microbench, "scan_diff_ms", short)
    monkeypatch.setattr(sb, "scan_diff_ms", short)
    monkeypatch.setattr(microbench, "_moe_probe_setup", functools.partial(
        microbench._moe_probe_setup, d=64, dff=96, e=8, k_active=2))


def test_kernel_micros_on_the_cpu(tiny_dir, short_loops):
    lm = LanguageModel.from_dir(tiny_dir, device="cpu", max_context=1024)
    out = microbench.kernel_micros(lm)
    assert sorted(out) == sorted(["attention_c512_ms", "paged_attn_b8_c512_ms",
                                  "moe_decode_ms", "moe_prefill256_ms", "sample_topk_ms"])
    assert all(v > 0 for v in out.values()), out


@pytest.mark.parametrize("fault", ["probe_raises", "no_positive_time"])
def test_a_failing_probe_raises(tiny_dir, short_loops, monkeypatch, fault):
    """No -1 or clamped number stands for a probe that failed."""
    lm = LanguageModel.from_dir(tiny_dir, device="cpu", max_context=1024)
    if fault == "probe_raises":
        def broken(*a, **kw):
            raise ValueError("kernel failed")

        monkeypatch.setattr(microbench, "paged_attention_micro", broken)
        with pytest.raises(ValueError, match="kernel failed"):
            microbench.kernel_micros(lm)
    else:
        monkeypatch.setattr(microbench, "_elapsed_ms", lambda device, run: 1.0)
        with pytest.raises(RuntimeError, match="not positive"):
            microbench.attention_micro(lm)


def test_scan_diff_ms_measures_the_marginal_call():
    """A call that sleeps 2 ms reads about 2 ms, whatever each loop pays
    once (the make_xs tensors ride along)."""
    import time

    def one(args, x):
        time.sleep(2e-3)
        return x.sum()

    ms = microbench.scan_diff_ms(one, None, lambda k: torch.zeros((k, 3)), k_small=2,
                                 k_big=12, pairs=3)
    assert 1.5 < ms < 10


def test_step_breakdown_on_the_cpu(tiny_dir, short_loops):
    out = sb.main(tiny_dir, 1, "cpu")
    assert sorted(out) == sorted(["per_shape", "n_layers", "matmul_sum_ms", "step_ms",
                                  "residual_ms", "residual_pct"])
    assert sorted(out["per_shape"]) == sorted(["qkv", "out", "up|gate", "down", "readout"])
    assert all(r["ms"] > 0 and r["mb"] >= 0 and "gbs" in r for r in out["per_shape"].values())
    assert out["n_layers"] == 2 and out["step_ms"] > 0
    assert out["residual_ms"] == pytest.approx(out["step_ms"] - out["matmul_sum_ms"], abs=2e-3)
    pre = sb.prefill_main(tiny_dir, 16, "cpu")
    assert sorted(pre) == sorted(["per_shape", "matmul_sum_ms", "prefill_chunk_ms",
                                  "residual_ms", "residual_pct"])
    assert sorted(pre["per_shape"]) == sorted(["qkv", "out", "up|gate", "down"])
    assert pre["prefill_chunk_ms"] > 0


def test_weight_nbytes_counts_codes_and_scales():
    rng = np.random.default_rng(2)
    parts = jq.quantize_reference(rng.standard_normal((64, 128)).astype(np.float32), 4, 32,
                                  "scale_bias", dtype=np.float32)
    qt = tq.from_disk_tensors("scale_bias", parts["weights"], parts["scales"], 4, 32,
                              biases=parts["biases"], dtype=torch.bfloat16)
    assert sb.weight_nbytes(qt) == 64 * 64 + 2 * (64 * 4 * 2)
    assert sb.weight_nbytes(torch.zeros((3, 5), dtype=torch.bfloat16)) == 30


# -- P1 and K1 with padded scale rows ------------------------------------------------------

def _jax_block_copy(s: np.ndarray, width: int = 128) -> np.ndarray:
    """The bisect probe's kernel (`tools/exp_qmm_bisect.py` copy_kernel) in
    interpret mode."""
    r, kg = s.shape

    def copy_kernel(s_ref, o_ref):
        o_ref[:] = jnp.pad(s_ref[:], ((0, 0), (0, width - s_ref.shape[1])))

    return np.asarray(pl.pallas_call(
        copy_kernel,
        in_specs=[pl.BlockSpec((r, kg), lambda: (0, 0))],
        out_specs=pl.BlockSpec((r, width), lambda: (0, 0)),
        out_shape=jax.ShapeDtypeStruct((r, width), jnp.float32),
        interpret=True,
    )(jnp.asarray(s)))


@pytest.mark.parametrize("kg", [16, 1, 64, 128])
def test_scale_block_copy_plain_equals_pallas_interpret(kg):
    """Bitwise, at the probe's 256 rows."""
    s = np.random.default_rng(kg).random((256, kg)).astype(np.float32) * 0.02 + 0.01
    got = scale_block_copy(torch.from_numpy(s))
    np.testing.assert_array_equal(got.numpy(), _jax_block_copy(s))
    np.testing.assert_array_equal(scale_block_copy_plain(torch.from_numpy(s), 128).numpy(),
                                  got.numpy())


def test_scale_block_copy_wrapper_checks(monkeypatch):
    before = dict(build.LAUNCHES)
    scale_block_copy(torch.ones((4, 16)), 32)
    assert build.LAUNCHES == before  # the CPU takes the plain version
    with pytest.raises(ValueError, match="does not fit"):
        scale_block_copy(torch.ones((4, 16)), 8)
    with pytest.raises(ValueError, match="does not fit"):
        scale_block_copy(torch.ones(16))
    monkeypatch.setattr(torch.Tensor, "device", property(lambda t: torch.device("cuda")))
    with pytest.raises(ValueError, match="f32"):
        scale_block_copy(torch.ones((4, 16), dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="multiple of 4"):
        scale_block_copy(torch.ones((4, 16)), 18)


def _padded_weights(method: str, pad_to: int):
    """The bisect probe's N 256, K 512, g 32 weight with its scale (and
    stored qbias) rows zero-padded to `pad_to` groups, in both packages."""
    rng = np.random.default_rng(pad_to)
    w = rng.standard_normal((256, 512)).astype(np.float32) * 0.1
    parts = jq.quantize_reference(w, 4, 32, method, dtype=np.float32)
    qj = jq.from_disk_tensors(method, parts["weights"], parts["scales"], 4, 32,
                              biases=parts.get("biases"), dtype=jnp.float32)

    def pad(a):
        out = np.zeros((256, pad_to), np.float32)
        out[:, :16] = np.asarray(a)
        return out

    scales = pad(qj.scales)
    qbias = None if qj.qbias is None else pad(qj.qbias)
    qt = tq.QuantizedTensor(torch.from_numpy(np.asarray(parts["weights"])),
                            torch.from_numpy(scales),
                            None if qbias is None else torch.from_numpy(qbias), 4, 32,
                            qj.qbias_coeff)
    return parts["weights"], scales, qbias, qj.qbias_coeff, qt


@pytest.mark.parametrize("method", ["scale_symmetric", "scale_bias"])
@pytest.mark.parametrize("pad_to", [128, 64, 32])
@pytest.mark.parametrize("m", [1, 64])
def test_quant_matmul_plain_takes_padded_scales_like_pallas(method, pad_to, m):
    """K1's plain version with scale rows wider than ceil(K/g), against
    `_quant_matmul_p` in interpret mode with the same padded rows: within
    1e-4 of RMS."""
    codes, scales, qbias, coeff, qt = _padded_weights(method, pad_to)
    x = np.random.default_rng(m).standard_normal((m, 512)).astype(np.float32)
    want = np.asarray(_quant_matmul_p(
        jnp.asarray(x), jnp.asarray(codes), jnp.asarray(scales),
        None if qbias is None else jnp.asarray(qbias), bits=4, group_size=32,
        interpret=True, qbias_coeff=coeff))[:m]
    got = quant_matmul(qt, torch.from_numpy(x)).numpy()
    rms = np.sqrt(np.mean(want.astype(np.float64) ** 2))
    assert np.max(np.abs(got - want)) <= 1e-4 * rms


def test_quant_matmul_wrapper_checks_scale_rows(monkeypatch):
    """Rows at least ceil(K/g) wide pass the wrapper's checks; fewer, or a
    stored qbias of another shape, are refused before any launch."""
    *_, qt = _padded_weights("scale_bias", 64)
    x = torch.zeros((1, 512))
    monkeypatch.setattr(torch.Tensor, "device", property(lambda t: torch.device("cuda")))
    for bad in (tq.QuantizedTensor(qt.codes, qt.scales[:, :15], qt.qbias[:, :15], 4, 32),
                tq.QuantizedTensor(qt.codes, qt.scales, qt.qbias[:, :32], 4, 32)):
        with pytest.raises(ValueError, match="scales/qbias"):
            quant_matmul(bad, x)
    with pytest.raises(Exception) as err:  # past the checks, the build needs nvcc
        quant_matmul(qt, x)
    assert "scales/qbias" not in str(err.value)


def test_bisect_probe_on_the_cpu(capsys):
    """`--device cpu` runs every cell through the plain versions (f32):
    each f32-scale cell within 1e-4 of RMS of its numpy oracle, the
    bf16-scale cell within 1e-2, the block read exact; one JSON line per
    cell under the JAX script's names."""
    before = dict(build.LAUNCHES)
    cells = exp_qmm_bisect.main("cpu")
    assert build.LAUNCHES == before
    lines = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    names = ["prod_kg16", "blockread_kg16_err", "prod_pad128", "prod_pad64", "prod_pad32",
             "pad128_m64", "pad128_bf16"]
    assert [next(iter(line)) for line in lines] == names == list(cells)
    assert cells["blockread_kg16_err"]["value"] == 0.0
    for name in names[2:-1] + names[:1]:
        assert cells[name]["err_over_rms"] <= 1e-4, name
    assert cells["pad128_bf16"]["err_over_rms"] <= 1e-2


def test_kernel_ab_compares_rows_present_in_every_log(tmp_path):
    """`tools/kernel_ab.py` keys rows by kernel and shape, takes the
    median device time of each version's runs (first and last log: A;
    the middle ones: B) and reports B over A per kernel and head dim;
    rows missing from a log and head dims not asked for are left out."""
    import json as _json

    from uzu_tpu_torch.tools import kernel_ab

    def log(name, rows):
        path = tmp_path / name
        path.write_text("CARD x\n" + "".join(
            "KERNEL " + _json.dumps(dict(kernel=k, Dh=dh, S=s, device_ms=t, ms=2 * t)) + "\n"
            for k, dh, s, t in rows))
        return str(path)

    a1 = log("a1", [("flash", 64, 16, 1.0), ("flash", 64, 256, 2.0), ("paged", 512, 8, 5.0)])
    b1 = log("b1", [("flash", 64, 16, 1.1), ("flash", 64, 256, 2.0), ("paged", 512, 8, 4.0)])
    b2 = log("b2", [("flash", 64, 16, 0.9), ("flash", 64, 256, 2.4), ("paged", 512, 8, 4.0)])
    a2 = log("a2", [("flash", 64, 16, 1.0), ("flash", 64, 256, 2.0)])
    parsed = [kernel_ab.rows(p) for p in (a1, b1, b2, a2)]
    out = kernel_ab.compare([parsed[0], parsed[-1]], parsed[1:-1])
    assert set(out) == {"flash/Dh64", "all"}  # the paged row is missing from a2
    assert out["flash/Dh64"]["rows"] == 2
    assert out["flash/Dh64"]["min"] == pytest.approx(1.0)
    assert out["flash/Dh64"]["max"] == pytest.approx(1.1)
    assert kernel_ab.compare([parsed[0], parsed[-1]], parsed[1:-1], {128}) == {}
