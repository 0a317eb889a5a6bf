"""On the card: each cell at its own size with the control beside it. The
program's widest gap stays within the cell's limit and the control's
(the reference at fp8 in the program's place, on the same prompts and
tokens) passes it. Skips without a card; the README gives the command."""

import json
import os
import subprocess
import sys

import pytest

from portbench import harness
from portbench.spec import find, load_json

CELLS = [w["name"] for w in load_json(os.path.join(harness.ROOT, "BENCHMARK.json"))["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_where_the_program_passes(cell):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", cell, "--seed",
                          "3141592653", "--seconds", "20", "--trace", "0", "--control", "1"],
                         capture_output=True, text=True, cwd=harness.ROOT, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = [json.loads(x) for x in out.stdout.splitlines()]
    readings = {}
    for line in lines[:-1]:
        readings.update(line["info"])
    limit = load_json(find("limits", cell))["max_logit_gap"]["limit"]
    assert lines[-1]["correct"], lines[-1]["checks"]
    assert readings["program_max_gap"] <= limit < readings["control_max_gap"]
