"""The model's weights, made on the device from the seed.

Both sides get the same raw tensors: the port as `QuantizedTensor`s over
them (`model.py`), the reference (`reference/`) by dequantizing them
itself. Every linear and the tied embedding are INT4 with symmetric
groups of 32 along the input, in the published file layout: codes uint8
[N, K/2] (low nibble = even k), w = scale * (code - 8), scales bf16
[N, K/32]. Codes are drawn from 1..15 (q in -7..7, mean 0), scales from
a base of 1 / (std(q) * sqrt(K)) times a factor uniform in [0.75, 1.25],
so every linear keeps its input's scale; the embedding's base puts the
logits' spread near LOGIT_STD. Norm scales are 1 + 0.1 N(0, 1) and conv
taps 0.5 N(0, 1), each rounded to bf16 and kept in f32.

All codes come from one random draw and all scales from another, then
are cut into views: a few large calls on the card, not one per leaf.
"""

from __future__ import annotations

import importlib
import math

import torch

Q_STD = math.sqrt((15 ** 2 - 1) / 12.0)  # std of q uniform on -7..7
LOGIT_STD = 2.0
_SEED_MASK = (1 << 63) - 1


def kind_module(kind: str):
    return importlib.import_module(f"portbench.kinds.{kind}")


def leaves(spec):
    """(quantized linears [(name, N, K, base scale)], vectors [(name,
    shape, std)]) of the whole model; MLP rows are [up | gate]."""
    d, f = spec.d, spec.ffn
    quant = [("embed", spec.vocab, d, LOGIT_STD / (Q_STD * math.sqrt(d)))]
    vec = []
    for i, kind in enumerate(spec.kinds):
        p = f"L{i}."
        for name, n, k in kind_module(kind).linears(spec):
            quant.append((p + name, n, k, 1.0 / (Q_STD * math.sqrt(k))))
        quant.append((p + "up", 2 * f, d, 1.0 / (Q_STD * math.sqrt(d))))
        quant.append((p + "down", d, f, 1.0 / (Q_STD * math.sqrt(f))))
        vec += [(p + "norm1", (d,), 0.1), (p + "norm2", (d,), 0.1)]
        vec += [(p + name, shape, std) for name, shape, std in kind_module(kind).vectors(spec)]
    vec.append(("final_norm", (d,), 0.1))
    return quant, vec


def make_raw(spec, seed: int, device) -> dict:
    """name.codes / name.scales per quantized linear, name per vector."""
    g = spec.group_size
    quant, vec = leaves(spec)
    for name, n, k, _ in quant:
        if k % g or k % 2:
            raise ValueError(f"{name}: K={k} is not a multiple of the group size {g}")
    gen = torch.Generator(device=device)
    gen.manual_seed((int(seed) ^ 0x57E1647) & _SEED_MASK)
    total_codes = sum(n * k // 2 for _, n, k, _ in quant)
    total_groups = sum(n * k // g for _, n, k, _ in quant)
    total_vec = sum(math.prod(shape) for _, shape, _ in vec)
    # one byte draw gives both nibbles: v = 15 * (hi - 1) + (lo - 1)
    v = torch.randint(0, 225, (total_codes,), generator=gen, device=device, dtype=torch.uint8)
    codes = (v % 15 + 1) | ((v // 15 + 1) << 4)
    del v
    u = torch.rand(total_groups, generator=gen, device=device)
    z = torch.randn(total_vec, generator=gen, device=device)
    raw = {}
    oc = og = ov = 0
    for name, n, k, base in quant:
        raw[name + ".codes"] = codes[oc:oc + n * k // 2].view(n, k // 2)
        raw[name + ".scales"] = ((0.75 + 0.5 * u[og:og + n * k // g]) * base).to(
            torch.bfloat16).view(n, k // g)
        oc += n * k // 2
        og += n * k // g
    for name, shape, std in vec:
        m = math.prod(shape)
        center = 0.0 if name.endswith("conv") else 1.0
        raw[name] = (center + std * z[ov:ov + m]).to(torch.bfloat16).float().view(*shape)
        ov += m
    return raw

