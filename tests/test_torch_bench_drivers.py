"""The port's bench tools (`uzu_tpu_torch/tools/{bench8b,benchmoe,
bench_qwen08,compare_bench,decode_probe}.py`) against the JAX package's on
the CPU.

Each model bench runs in both packages at tiny widths (`DIMS`
monkeypatched in both modules, a repo directory under tmp_path, a short
`gen_len`): the synthesized files are byte-equal, the byte accounting
(`weight_bytes`, `state_bytes`, `active_bytes`) is equal exactly, the
returned keys are the same, and `sol_tok_s` is equal (the same nominal CPU
rate over the same bytes). The JAX benches' probe is the repo-root
`bench.HbmProbe` with a 1 GiB buffer; the tests give it the host's size.
`compare_bench` gives the JAX tool's rows, table and exit code on the
same records. Times are not compared: they are host timings.
"""

import json
import os

import numpy as np
import pytest
import torch

import bench
from uzu_tpu.tools import bench8b as jbench8b
from uzu_tpu.tools import bench_qwen08 as jbench_qwen08
from uzu_tpu.tools import benchmoe as jbenchmoe
from uzu_tpu.tools import compare_bench as jcompare
from uzu_tpu_torch.tools import bench8b, bench_qwen08, benchmoe, compare_bench, decode_probe

torch.set_num_threads(1)

# widths multiple of 128 where the JAX loader pads (the MoE down stack)
TINY = {
    "bench8b": dict(num_layers=2, model_dim=64, hidden_dim=128, num_heads=4, num_groups=2,
                    head_dim=16, vocab_size=256, max_seq=2048, rope_base=500000.0,
                    llama3_rope_scaling=True, tied=False),
    "benchmoe": dict(num_layers=2, model_dim=128, num_heads=4, num_groups=2, head_dim=32,
                     vocab_size=256, num_experts=4, num_active=2, expert_hidden_dim=64,
                     sliding_window=16, max_seq=4096),
    "bench_qwen08": dict(num_layers=4, model_dim=64, hidden_dim=128, vocab_size=256,
                         num_heads=2, num_groups=1, head_dim=32, value_head_dim=32,
                         kernel_size=4, attn_every=4),
}
# the model's directory under each package's cache
DIRS = {"bench8b": "llama8b_int4", "benchmoe": "gptoss_small_eq4",
        "bench_qwen08": "qwen08_int4"}
BYTE_KEYS = ("weight_bytes", "state_bytes", "active_bytes")


class _HostProbe(bench.HbmProbe):
    """The JAX benches' probe at the host's size (they ask for the TPU's)."""

    def __init__(self, on_tpu: bool):
        super().__init__(False)


def _run(name, tmp_path, monkeypatch):
    jmod = {"bench8b": jbench8b, "benchmoe": jbenchmoe, "bench_qwen08": jbench_qwen08}[name]
    tmod = {"bench8b": bench8b, "benchmoe": benchmoe, "bench_qwen08": bench_qwen08}[name]
    monkeypatch.setattr(jmod, "DIMS", TINY[name])
    monkeypatch.setattr(tmod, "DIMS", TINY[name])
    monkeypatch.setattr(bench, "HbmProbe", _HostProbe)
    fn = {"bench8b": "bench_8b", "benchmoe": "bench_moe", "bench_qwen08": "bench_qwen08"}[name]
    kw = dict(gen_len=8, paged=True) if name == "bench8b" else dict(gen_len=8)
    repo = str(tmp_path)
    want = getattr(jmod, fn)(repo, **kw)
    got = getattr(tmod, fn)(repo, device="cpu", **kw)
    return repo, want, got


@pytest.mark.parametrize("name", sorted(TINY))
def test_bench_matches_jax(name, tmp_path, monkeypatch):
    """Byte-equal files, equal byte accounting and keys, equal sol_tok_s;
    every rate finite and positive; the printed line loads through the
    port's compare_bench."""
    repo, want, got = _run(name, tmp_path, monkeypatch)
    with open(os.path.join(repo, ".bench_cache", DIRS[name], "model.safetensors"), "rb") as f:
        jbytes = f.read()
    with open(os.path.join(repo, ".port_cache", "bench", DIRS[name], "model.safetensors"),
              "rb") as f:
        assert f.read() == jbytes
    assert set(got) == set(want)
    for key in BYTE_KEYS:
        assert got.get(key) == want.get(key), key
    assert got["sol_tok_s"] == want["sol_tok_s"]
    for key, v in got.items():
        assert np.isfinite(v) and v > 0, (key, v)
    metric = {"bench8b": "llama8b_decode_tok_s", "benchmoe": "gptoss_small_decode_tok_s",
              "bench_qwen08": "qwen08_decode_tok_s"}[name]
    line = os.path.join(repo, "out.txt")
    with open(line, "w") as f:
        f.write(f"[{name}] done\n" + json.dumps({"metric": metric, **got}) + "\n")
    assert compare_bench.load_record(line) == {k: float(v) for k, v in got.items()}


def test_active_bytes_by_hand(tmp_path, monkeypatch):
    """The MoE's active bytes, counted by hand: the layers' and the
    embedding's weights (the final norm is not counted, as in the JAX
    bench) with K/E of the expert stacks, and each layer's KV at the
    context clamped to its window."""
    from uzu_tpu_torch import LanguageModel

    monkeypatch.setattr(benchmoe, "DIMS", TINY["benchmoe"])
    lm = LanguageModel.from_dir(benchmoe.model_dir(str(tmp_path)), device="cpu",
                                max_context=4096, prefill_buckets=(32, 512))
    d = TINY["benchmoe"]
    total = decode_probe.weight_bytes([lm.params["layers"], lm.params["embedding"]])
    experts = sum(decode_probe.weight_bytes(layer["mlp"][k])
                  for layer in lm.params["layers"] for k in ("up", "down"))
    kv = sum(2 * min(1000, 16 if i % 2 == 0 else 1000) * d["num_groups"] * d["head_dim"] * 2
             for i in range(d["num_layers"]))
    windows = [lc.mixer_config.sliding_window_size
               for lc in lm.decoder_config.transformer_config.layer_configs]
    assert windows == [16, None]
    assert benchmoe.active_bytes_per_step(lm, 1000) == \
        total - experts + experts * d["num_active"] // d["num_experts"] + kv


def test_device_bandwidth(monkeypatch):
    """The H100's spec rate; an unknown card raises and names itself; the
    host's nominal rate is the JAX package's."""
    assert decode_probe.device_bandwidth("cpu") == ("cpu", bench.HBM_BW["cpu"])
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda d=None: "NVIDIA H100 80GB HBM3")
    assert decode_probe.device_bandwidth() == ("NVIDIA H100 80GB HBM3", 3.35e12)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda d=None: "NVIDIA Mystery 7")
    with pytest.raises(ValueError, match="NVIDIA Mystery 7"):
        decode_probe.device_bandwidth("cuda")


def test_hbm_probe_on_the_host():
    probe = decode_probe.HbmProbe("cpu")
    assert probe._x.numel() == 1 << 22
    assert probe.measure(reps=2) > 0


@pytest.mark.parametrize("call", [
    lambda repo: bench8b.bench_8b(repo),
    lambda repo: benchmoe.bench_moe(repo),
    lambda repo: bench_qwen08.bench_qwen08(repo),
    lambda repo: bench8b.main([]),
    lambda repo: benchmoe.main([]),
    lambda repo: bench_qwen08.main([repo]),
], ids=["bench_8b", "bench_moe", "bench_qwen08", "bench8b_main", "benchmoe_main",
        "bench_qwen08_main"])
def test_entry_points_need_the_card(call, tmp_path, monkeypatch):
    """Without a card every entry point raises before it synthesizes
    anything, unless given device="cpu"."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call(str(tmp_path))
    assert not os.path.exists(os.path.join(tmp_path, ".port_cache"))


# -- compare_bench ---------------------------------------------------------------------------

R1 = {"metric": "decode_tok_s", "value": 200.0, "batch4_tok_s": 520.0,
      "ttft_s": 0.04, "practical_bw_gbs": 220.0, "weight_bytes": 695,
      "micro": {"decode_step_ms": 5.0, "quant_matmul_up_ms": 0.066}}
R8B = {"metric": "llama8b_decode_tok_s", "load_s": 3.1, "weight_bytes": 4_600_000_000,
       "decode_tok_s": 60.0, "sol_tok_s": 700.0, "vs_baseline": 0.0857,
       "practical_bw_gbs": 2900.0, "vs_practical": 0.099, "paged8_tok_s": 300.0}
SECOND = {
    "noise": dict(R1, value=170.0, practical_bw_gbs=187.0),
    "latency_noise": dict(R1, practical_bw_gbs=187.0,
                          micro={"decode_step_ms": 5.0 * 220.0 / 187.0,
                                 "quant_matmul_up_ms": 0.066 * 220.0 / 187.0}),
    "latency_regression": dict(R1, practical_bw_gbs=253.0,
                               micro={"decode_step_ms": 7.0, "quant_matmul_up_ms": 0.066}),
    "regression": dict(R1, value=100.0),
    "better": dict(R1, value=210.0, weight_bytes=600),
    "bench_line": dict(R8B, decode_tok_s=58.0, practical_bw_gbs=3000.0, paged8_tok_s=310.0),
}


@pytest.mark.parametrize("case", sorted(SECOND))
@pytest.mark.parametrize("form", ["raw", "wrapped", "log"])
def test_compare_bench_matches_jax(case, form, tmp_path, capsys):
    """load_record, build_comparison's rows (threshold 0.1 and the
    default), format_table's text and main's exit code and output equal
    the JAX tool's, for a raw record, a wrapped one and a log whose last
    bench line is followed by a non-bench JSON line."""
    first = R8B if case == "bench_line" else R1
    paths = []
    for i, rec in enumerate((first, SECOND[case])):
        p = tmp_path / f"{case}_{i}.json"
        if form == "raw":
            p.write_text(json.dumps(rec))
        elif form == "wrapped":
            p.write_text(json.dumps({"n": i, "rc": 0, "parsed": rec}))
        else:
            p.write_text("[stage] x\n" + json.dumps(rec) + "\n"
                         + json.dumps({"stage": "done", "elapsed": 1.0}) + "\n")
        paths.append(str(p))
    a, b = (compare_bench.load_record(p) for p in paths)
    assert (a, b) == tuple(jcompare.load_record(p) for p in paths)
    for threshold in (0.1, 0.2):
        rows = compare_bench.build_comparison(a, b, threshold)
        want = jcompare.build_comparison(a, b, threshold)
        assert [vars(r) for r in rows] == [vars(r) for r in want]
        assert compare_bench.format_table(rows, "a", "b") == jcompare.format_table(want, "a", "b")
    rc = compare_bench.main(paths)
    out = capsys.readouterr().out
    assert (rc, out) == (jcompare.main(paths), capsys.readouterr().out)
    assert (rc == 1) == (case in ("regression", "latency_regression")) == ("REGRESSION" in out)


def test_compare_bench_rejects_what_the_jax_tool_rejects(tmp_path):
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"value": 1.0}))
    for tool in (compare_bench, jcompare):
        with pytest.raises(ValueError, match="not a bench record"):
            tool.load_record(str(bad))
    none = tmp_path / "none.txt"
    none.write_text("nothing here\n{not json\n")
    for tool in (compare_bench, jcompare):
        with pytest.raises(ValueError, match="no bench JSON record"):
            tool.load_record(str(none))
