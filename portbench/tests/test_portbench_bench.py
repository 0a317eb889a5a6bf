"""BENCHMARK.json against the harness: every cell finds its files, every
metric it reports has a quantity the harness measures or a reader, and
every per-layer metric moves an end-to-end metric of the same cells."""

import pytest

from portbench import harness
from portbench.spec import load_json

BENCH = load_json(harness.os.path.join(harness.ROOT, "BENCHMARK.json"))
CELLS = [w["name"] for w in BENCH["workloads"]]
MEASURED = ("output_tok_s", "ttft_p90_ms", "tpot_p90_ms", "setup_s")


def test_quantity_drops_a_cell_qualifier_only():
    assert harness.quantity("output_tok_s.long-doc", MEASURED) == "output_tok_s"
    assert harness.quantity("output_tok_s", MEASURED) == "output_tok_s"
    readers = {"engine.decode_step_ms", "mfu"}
    assert harness.quantity("engine.decode_step_ms", readers) == "engine.decode_step_ms"
    assert harness.quantity("engine.decode_step_ms.long-doc", readers) == "engine.decode_step_ms"
    assert harness.quantity("mfu.long-doc", readers) == "mfu"


@pytest.mark.parametrize("cell", CELLS)
def test_cell_metrics_resolve(cell):
    loaded = harness.load_cell(cell, BENCH)
    e2e = {m["name"] for m in loaded["end_to_end"]}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert all(harness.quantity(n, MEASURED) in MEASURED for n in e2e)
    assert loaded["per_layer"]
    for m in loaded["per_layer"]:
        assert callable(harness._metric_reader(m["name"]))
        assert m["moves"] in e2e, (m["name"], m["moves"])
