"""A model configuration file, read into the shapes the benchmark needs.

The file under `configs/` holds the published config's keys as they are
run, plus the benchmark's own keys (`source`, `reduced`, `assumed`,
`deployment`, `engine`, `quantization`). Its `model_type` names the family
module under `families/` that maps the published keys onto `ModelSpec`.
Nothing here imports the port, so the reference and the work counts can
use it on their own.
"""

from __future__ import annotations

import dataclasses
import importlib
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    """The shapes of one decoder: every width as published."""

    name: str
    d: int  # hidden size
    ffn: int  # SwiGLU hidden width
    vocab: int
    kinds: tuple  # mixer kind per layer: "full_attention" or "conv"
    heads: int
    kv_heads: int
    head_dim: int
    norm_eps: float
    qk_norm_eps: float
    rope_theta: float
    max_positions: int
    conv_kernel: int = 0  # ShortConv taps (L)
    bits: int = 4
    group_size: int = 32

    @property
    def num_layers(self) -> int:
        return len(self.kinds)

    def count(self, kind: str) -> int:
        return sum(1 for k in self.kinds if k == kind)


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def find(folder: str, name: str) -> str:
    """The file `<folder>/<name>.json` under the benchmark's directory."""
    path = os.path.join(HERE, folder, name + ".json")
    if not os.path.exists(path):
        raise FileNotFoundError(f"no {folder}/{name}.json in {HERE}")
    return path


def model_spec(config: dict) -> ModelSpec:
    """The family module named by `model_type` maps the file's keys."""
    family = importlib.import_module(f"portbench.families.{config['model_type']}")
    return family.spec(config)
