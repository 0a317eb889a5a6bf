"""The yardstick's arithmetic: the work each call does, from the config's
shapes and the real rows the spans recorded (never padded bucket rows,
never launch arguments), and the card's peaks.

A kernel's bound is max(bytes / memory rate, FLOPs / bf16 peak). Every
input byte is counted once and every output byte once: a linear reads its
INT4 codes and bf16 scales and its bf16 rows and writes bf16 rows; the
readout reads the tied table once for all rows of a call.
"""

from __future__ import annotations

import json
import os

from .spec import HERE
from .weights import kind_module


def peaks(card_name: str) -> dict:
    """{"bf16_flops", "hbm_bytes_per_s"} of a card by its name. A card not
    listed raises: another card's figures would be wrong by their ratio."""
    with open(os.path.join(HERE, "peaks.json")) as f:
        table = json.load(f)["cards"]
    for key, entry in table.items():
        if key in card_name:
            return entry
    raise ValueError(f"no peaks are known for {card_name!r}; add them to peaks.json")


def linear_shapes(spec) -> list[tuple[int, int]]:
    """(N, K) of every quantized linear of one token's pass, the tied
    readout last."""
    out = []
    for kind in spec.kinds:
        out += [(n, k) for _, n, k in kind_module(kind).linears(spec)]
        out += [(2 * spec.ffn, spec.d), (spec.d, spec.ffn)]
    return out


def linear_params(spec) -> int:
    """Parameters of every linear but the readout."""
    return sum(n * k for n, k in linear_shapes(spec))


def kv_bytes_per_token(spec) -> int:
    """bf16 K and V of one token over every attention layer."""
    per_layer = 2 * spec.kv_heads * spec.head_dim * 2
    return per_layer * sum(1 for k in spec.kinds if getattr(kind_module(k), "KERNEL_GROUP", None))


def quant_bytes(spec, n: int, k: int) -> float:
    return n * k * spec.bits / 8 + n * (k // spec.group_size) * 2


def linear_call(spec, rows: int, n: int, k: int) -> tuple[float, float]:
    """(FLOPs, bytes) of one quantized linear over `rows` rows."""
    return 2.0 * rows * n * k, quant_bytes(spec, n, k) + 2.0 * rows * (n + k)


def bound_s(flops: float, nbytes: float, pk: dict) -> float:
    return max(nbytes / pk["hbm_bytes_per_s"], flops / pk["bf16_flops"])


class Work:
    """Running totals over the calls of a slice: bound seconds of the
    linears and of the attention calls that a hand kernel serves, and the
    model's FLOPs (linears, mixers, readout)."""

    def __init__(self, spec, pk: dict, decode_attention_group):
        self.spec, self.pk = spec, pk
        self.decode_attention_group = decode_attention_group
        self.linear_bound_s = 0.0
        self.attention_bound_s = 0.0
        self.model_flops = 0.0
        self.prefill_rows = 0
        self.decode_steps = 0

    def _linears(self, rows: int, readout_rows: int) -> None:
        for n, k in linear_shapes(self.spec):
            f, b = linear_call(self.spec, rows, n, k)
            self.linear_bound_s += bound_s(f, b, self.pk)
            self.model_flops += f
        f, b = linear_call(self.spec, readout_rows, self.spec.vocab, self.spec.d)
        self.linear_bound_s += bound_s(f, b, self.pk)
        self.model_flops += f

    def prefill(self, pos0: int, take: int) -> None:
        """A prefill chunk of `take` real rows from `pos0`; logits of its
        last row only."""
        self.prefill_rows += take
        self._linears(take, 1)
        for kind in self.spec.kinds:
            km = kind_module(kind)
            f, b = km.prefill_work(self.spec, pos0, take)
            self.model_flops += f
            if getattr(km, "KERNEL_GROUP", None) == "attention":
                self.attention_bound_s += bound_s(f, b, self.pk)

    def decode(self, steps: int, positions: list) -> None:
        """`steps` decode steps of the live slots at host positions
        `positions` (step t attends to pos + t + 1 keys)."""
        rows = len(positions)
        if not steps or not rows:
            return
        self.decode_steps += steps
        for t in range(steps):
            self._linears(rows, rows)
            lengths = [p + t + 1 for p in positions]
            for kind in self.spec.kinds:
                km = kind_module(kind)
                f, b = km.decode_work(self.spec, lengths)
                self.model_flops += f
                if (getattr(km, "KERNEL_GROUP", None) == "attention"
                        and self.decode_attention_group == "attention"):
                    self.attention_bound_s += bound_s(f, b, self.pk)
