"""The port's serving smoke (`uzu_tpu_torch/tools/exp_serving_smoke.py`) on
the CPU over a tiny synthesized model: every stage of the JAX package's
smoke, in its order, with its in-run checks passing."""

import ast
import inspect
import json

import numpy as np
import pytest
import torch

from uzu_tpu.tools import exp_serving_smoke as jax_smoke
from uzu_tpu_torch.tools import exp_serving_smoke
from uzu_tpu_torch.tools.synth import llama_config, synthesize

torch.set_num_threads(1)


def _stage_names(module) -> list[str]:
    """The names of the `stage("...")` calls in a module's source, in order."""
    tree = ast.parse(inspect.getsource(module))
    return [node.args[0].value for node in ast.walk(tree)
            if isinstance(node, ast.Call) and getattr(node.func, "id", None) == "stage"
            and node.args and isinstance(node.args[0], ast.Constant)]


def test_serving_smoke_stages_match_jax(tmp_path):
    cfg = llama_config(num_layers=2, model_dim=64, hidden_dim=128, num_heads=4,
                       num_groups=2, head_dim=16, vocab_size=256)
    d = synthesize(cfg, str(tmp_path / "smoke"), seed=0, dtype=np.float32)
    lines: list[str] = []
    exp_serving_smoke.main(d, device="cpu", log=lines.append)
    got = [json.loads(line)["stage"] for line in lines]
    want = _stage_names(jax_smoke)
    assert got == want == list(exp_serving_smoke.STAGES), (got, want)


def test_serving_smoke_defaults_to_the_card(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        exp_serving_smoke.cli([str(tmp_path)])
