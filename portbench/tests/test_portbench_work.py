"""The yardstick's counts against hand counts, and rooflines that cannot
pass 100% when every kernel takes at least its bound."""

import random

import pytest

from portbench import work
from portbench.spec import find, load_json, model_spec
from portbench.harness import Context
from portbench.trace import kernel_groups

PK = work.peaks("NVIDIA H100 80GB HBM3")


def _spec(name):
    c = load_json(find("configs", name))
    c["name"] = name
    return model_spec(c)


def test_qwen3_4b_hand_counts():
    s = _spec("qwen3-4b")
    # q 4096 + k 1024 + v 1024 rows of 2560, out 2560 x 4096, up|gate and down
    per_layer = 6144 * 2560 + 2560 * 4096 + 2 * 9728 * 2560 + 2560 * 9728
    assert per_layer == 100_925_440
    assert work.linear_params(s) == 36 * per_layer
    assert work.kv_bytes_per_token(s) == 147_456
    assert 32 * 12544 * work.kv_bytes_per_token(s) == pytest.approx(59.2e9, rel=1e-3)
    int4 = work.linear_params(s) + s.vocab * s.d
    assert int4 * 0.5625 == pytest.approx(2.26e9, rel=2e-3)


def test_lfm2_hand_counts():
    s = _spec("lfm2-1.2b")
    assert (s.ffn, s.head_dim, s.count("conv"), s.count("full_attention")) == (8192, 64, 10, 6)
    attn = 3072 * 2048 + 2048 * 2048
    conv = 6144 * 2048 + 2048 * 2048
    mlp = 3 * 8192 * 2048
    assert work.linear_params(s) == 6 * (attn + mlp) + 10 * (conv + mlp)
    assert work.kv_bytes_per_token(s) == 6 * 2048 == 12_288
    assert (work.linear_params(s) + s.vocab * s.d) * 0.5625 == pytest.approx(0.66e9, rel=5e-3)


def test_prefill_and_decode_work():
    s = _spec("qwen3-4b")
    w = work.Work(s, PK, "attention")
    w.prefill(4096, 4096)
    lin = 2 * 4096 * work.linear_params(s) + 2 * s.vocab * s.d
    # causal rows 4097..8192 keys each, 36 layers, 32 heads, Dh 128, QK and PV
    keys = sum(range(4097, 8193))
    assert w.model_flops == lin + 36 * 4 * 32 * 128 * keys
    assert w.attention_bound_s == pytest.approx(36 * 4 * 32 * 128 * keys / PK["bf16_flops"])
    w2 = work.Work(s, PK, None)
    w2.decode(2, [100, 200])
    assert w2.decode_steps == 2 and w2.attention_bound_s == 0.0
    w3 = work.Work(s, PK, "attention")
    w3.decode(1, [1000])
    kv = 1001 * 4 * 8 * 128 + 4 * 32 * 128
    assert w3.attention_bound_s == pytest.approx(36 * kv / PK["hbm_bytes_per_s"])


def test_unknown_card_raises():
    with pytest.raises(ValueError):
        work.peaks("Some Other Card")


def _synthetic(spec, engine_group, slack, seed):
    """A slice whose every call's kernel takes its own bound times a
    factor of at least 1, tagged with the group that serves it."""
    rnd = random.Random(seed)
    w = work.Work(spec, PK, engine_group)
    device, t = [], 0.0

    def add(name, seconds):
        nonlocal t
        device.append((name, t, t + seconds, True, t))
        t += seconds * 1.01

    calls = [("prefill", (rnd.randrange(0, 8000), rnd.randrange(1, 4097))) for _ in range(3)]
    calls += [("decode", (8, [rnd.randrange(10, 9000) for _ in range(rnd.randrange(1, 33))]))
              for _ in range(3)]
    for kind, info in calls:
        before = (w.linear_bound_s, w.attention_bound_s)
        getattr(w, kind)(*info)
        add("void qmm_tile<128>", (w.linear_bound_s - before[0]) * (1 + slack * rnd.random()))
        if w.attention_bound_s > before[1]:
            add("void flash_fwd<64>", (w.attention_bound_s - before[1]) * (1 + slack * rnd.random()))
    return w, {"window_s": t, "t0": 0.0, "t1": t, "device": device}


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("name,group", [("qwen3-4b", "attention"), ("lfm2-1.2b", None)])
def test_roofline_of_synthetic_timing_stays_under_100(seed, name, group):
    import importlib.util
    import os

    from portbench.spec import HERE

    spec = _spec(name)
    w, sliced = _synthetic(spec, group, slack=seed * 0.5, seed=seed)
    ctx = Context.__new__(Context)
    ctx.spec, ctx.peaks, ctx.slice, ctx.work = spec, PK, sliced, w
    ctx.groups = kernel_groups()
    ctx.window_s = sliced["window_s"]
    for metric in ("linear_roofline", "attention_roofline", "mfu"):
        path = os.path.join(HERE, "metrics", metric + ".py")
        m = importlib.util.module_from_spec(importlib.util.spec_from_file_location(metric, path))
        m.__spec__.loader.exec_module(m)
        v = m.read(ctx)
        assert v is not None and 0 < v <= 100.0 + 1e-9, (metric, v)
        if metric != "mfu" and seed == 0:
            assert v == pytest.approx(100.0)
