"""K1's launch-plan autotuner (`uzu_tpu_torch/ops/cuda/autotune.py`) and
the CLI's `autotune`, on the CPU: the shape set against the JAX
package's, the table's round trip, `qmm_plan`'s use of it bucket by
bucket, and the refusal without a card (measuring needs one)."""

import json
import os

import numpy as np
import pytest
import torch

from uzu_tpu.ops.pallas import autotune as jax_autotune
from uzu_tpu.tools import synth as jsynth
from uzu_tpu_torch.ops.cuda import autotune, quant_matmul as qmm
from uzu_tpu_torch.tools import synth as psynth

SMS = 132  # an H100's SM count: the plan is computed, never launched


@pytest.fixture()
def table(tmp_path, monkeypatch):
    """A table file at UZU_TPU_TILE_TABLE, read afresh."""
    path = tmp_path / "tiles.json"
    monkeypatch.setenv("UZU_TPU_TILE_TABLE", str(path))
    autotune._load_table.cache_clear()
    yield path
    autotune._load_table.cache_clear()


@pytest.mark.parametrize("family", ["llama", "qwen3", "qwen35"])
def test_model_linear_shapes_match_jax(family):
    make = {"llama": lambda m: m.llama_config(), "qwen3": lambda m: m.qwen3_config(),
            "qwen35": lambda m: m.qwen35_config()}[family]
    want = jax_autotune.model_linear_shapes(make(jsynth).decoder_config)
    assert autotune.model_linear_shapes(make(psynth).decoder_config) == want


@pytest.mark.parametrize("m,bucket", [(1, "small"), (32, "small"), (33, "bm128"),
                                      (128, "bm128"), (129, "bm256"), (4096, "bm256")])
def test_m_buckets_follow_the_routes(m, bucket):
    assert autotune.m_bucket(m) == bucket
    route = qmm.heuristic_plan(m, 2048, 2048, 4, SMS).route
    assert route == ("small" if bucket == "small" else "tile")
    if bucket != "small":
        assert qmm.heuristic_plan(m, 2048, 2048, 4, SMS).bm == int(bucket[2:])


def test_save_table_lookup_roundtrip(table):
    entries = {"4:3072:2048:small": {"route": "small", "kw": 2},
               "4:3072:2048:bm256": {"route": "tile", "bm": 128, "splits": 2}}
    assert autotune.save_table(entries, str(table)) == str(table)
    assert json.loads(table.read_text()) == entries
    assert autotune.lookup(4, 3072, 2048, 1) == qmm.QmmPlan("small", kw=2)
    assert autotune.lookup(4, 3072, 2048, 512) == qmm.QmmPlan(
        "tile", bm=128, splits=2, chunks_per_split=16)
    assert autotune.lookup(4, 3072, 2048, 64) is None  # no bm128 entry
    assert autotune.lookup(8, 3072, 2048, 1) is None  # other bits
    autotune.save_table({"4:3072:2048:bm128": {"route": "tile", "bm": 256, "splits": 1}},
                        str(table))
    assert set(json.loads(table.read_text())) == set(entries) | {"4:3072:2048:bm128"}


@pytest.mark.parametrize("m,entry,want", [
    (1, {"route": "small", "kw": 2}, qmm.QmmPlan("small", kw=2)),
    (64, {"route": "tile", "bm": 256, "splits": 4},
     qmm.QmmPlan("tile", bm=256, splits=4, chunks_per_split=8)),
    (256, {"route": "tile", "bm": 128, "splits": 1},
     qmm.QmmPlan("tile", bm=128, splits=1, chunks_per_split=32)),
])
def test_qmm_plan_takes_the_entry_of_each_bucket(table, m, entry, want):
    n, k = 1024, 2048
    table.write_text(json.dumps({f"4:{n}:{k}:{autotune.m_bucket(m)}": entry}))
    assert qmm.qmm_plan(m, n, k, 4, SMS) == want
    assert want != qmm.heuristic_plan(m, n, k, 4, SMS)  # the table, not the rules
    assert qmm.qmm_plan(m, n + 16, k, 4, SMS) == qmm.heuristic_plan(m, n + 16, k, 4, SMS)


@pytest.mark.parametrize("m,entry", [
    (1, {"route": "small", "kw": 3}),               # kw the kernel lacks
    (1, {"route": "small", "kw": 16}),
    (1, {"route": "tile", "bm": 128, "splits": 1}),  # a tile entry in the small bucket
    (64, {"route": "small", "kw": 2}),               # a small entry in a tile bucket
    (64, {"route": "tile", "bm": 64, "splits": 1}),  # bm the kernel is not built for
    (256, {"route": "tile", "bm": 128, "splits": 16}),  # splits of < 4 chunks
    (256, {"route": "tile", "bm": 128, "splits": 0}),
    (256, [128, 512]),                               # a Mosaic-style entry
])
def test_entry_that_cannot_serve_keeps_the_heuristics(table, m, entry):
    n, k = 1024, 2048
    table.write_text(json.dumps({f"4:{n}:{k}:{autotune.m_bucket(m)}": entry}))
    assert autotune.lookup(4, n, k, m) is None
    assert qmm.qmm_plan(m, n, k, 4, SMS) == qmm.heuristic_plan(m, n, k, 4, SMS)


def test_small_route_entry_never_varies_with_m(table):
    """One small entry serves every M of the route (bf16 x) with one kw, so
    each row sums in the same order at every M; f32 x keeps its GEMV."""
    table.write_text(json.dumps({"4:2048:8192:small": {"route": "small", "kw": 4}}))
    plans = {qmm.qmm_plan(m, 2048, 8192, 4, SMS) for m in range(1, qmm.GEMV_MAX_M + 1)}
    assert plans == {qmm.QmmPlan("small", kw=4)}
    assert qmm.qmm_plan(1, 2048, 8192, 4, SMS, x_bf16=False).route == "gemv_f32"


def test_no_table_is_the_heuristics(table):
    rng = np.random.default_rng(0)
    for _ in range(50):
        m, n, k = (int(rng.integers(1, 600)), int(rng.integers(1, 64)) * 64,
                   int(rng.integers(1, 64)) * 128)
        assert qmm.qmm_plan(m, n, k, 4, SMS) == qmm.heuristic_plan(m, n, k, 4, SMS)


def test_tile_splits_hold_min_chunks():
    assert autotune.tile_splits(2048) == (1, 2, 4, 8)  # 32 chunks of 64
    assert autotune.tile_splits(192) == (1,)
    for k in (512, 2048, 8192):
        chunks = k // qmm.TILE_K
        assert all(s == 1 or chunks // s >= qmm.TILE_MIN_CHUNKS for s in autotune.tile_splits(k))


def test_autotune_shapes_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        autotune.autotune_shapes([(256, 512)], reps=2, verbose=False)


def test_a_table_read_is_named_and_logged(table, capsys):
    """A table changes K1's plans, so reading one is never silent: its path
    goes to stderr once a read, and `table_in_use` names it; an empty table
    or /dev/null is the heuristics, and says nothing."""
    table.write_text(json.dumps({"4:1024:2048:small": {"route": "small", "kw": 2}}))
    assert autotune.table_in_use() == str(table)
    autotune.lookup(4, 1024, 2048, 1)
    err = capsys.readouterr().err
    assert err.count(str(table)) == 1 and "1 entries" in err
    for empty in ("{}", None):
        if empty is None:
            os.environ["UZU_TPU_TILE_TABLE"] = os.devnull
        else:
            table.write_text(empty)
        autotune._load_table.cache_clear()
        assert autotune.table_in_use() is None
        assert autotune.lookup(4, 1024, 2048, 1) is None
        assert capsys.readouterr().err == ""


def test_cli_autotune_writes_its_out_path_and_nothing_in_the_package(tmp_path, monkeypatch,
                                                                    capsys):
    """`cli autotune --out PATH` saves there and leaves `tile_tables/` as it
    was (the measurement itself is replaced: it needs a card)."""
    from uzu_tpu_torch.cli import main

    model = tmp_path / "m"
    psynth.synthesize(psynth.llama_config(num_layers=1, model_dim=32, hidden_dim=64,
                                          num_heads=2, num_groups=1, head_dim=16,
                                          vocab_size=128), str(model), seed=2)
    entry = {"4:128:32:small": {"route": "small", "kw": 1}}
    seen = {}

    def fake(shapes, reps):
        seen["shapes"], seen["reps"] = shapes, reps
        return dict(entry)

    monkeypatch.setattr(autotune, "autotune_shapes", fake)
    monkeypatch.delenv("UZU_TPU_TILE_TABLE", raising=False)
    before = sorted(os.listdir(autotune.TABLE_DIR)) if os.path.isdir(autotune.TABLE_DIR) else []
    out = tmp_path / "tiles.json"
    try:
        assert main(["autotune", str(model), "--reps", "3", "--out", str(out)]) == 0
        assert json.loads(out.read_text()) == entry
        assert seen == {"shapes": autotune.model_linear_shapes(
            psynth.llama_config(num_layers=1, model_dim=32, hidden_dim=64, num_heads=2,
                                num_groups=1, head_dim=16, vocab_size=128).decoder_config),
            "reps": 3}
        assert str(out) in capsys.readouterr().out
        after = (sorted(os.listdir(autotune.TABLE_DIR))
                 if os.path.isdir(autotune.TABLE_DIR) else [])
        assert after == before
    finally:
        os.environ.pop("UZU_TPU_TILE_TABLE", None)
        autotune._load_table.cache_clear()
