"""The reference decoder: tied INT4 embedding, for each layer RMSNorm,
the mixer of its kind (`reference/<kind>.py`) and a residual, RMSNorm, a
SwiGLU MLP (fused rows [up | gate]: down(up * silu(gate))) and a
residual; the final RMSNorm and the tied readout. Float32 throughout, TF32
off; `lowp=True` is the control, the same pass with fp8 activations.

`logits(spec, raw, seqs, rows)` runs several sequences layer by layer (each
layer's weights dequantized once) and returns, for each sequence, the
logits [len(rows), V] at its given rows.
"""

from __future__ import annotations

import importlib

import torch

from .common import Ops, dequantize, rms_norm


def _kind(kind: str):
    return importlib.import_module(f"portbench.reference.{kind}")


def _mlp(h: torch.Tensor, up: torch.Tensor, down: torch.Tensor, ops) -> torch.Tensor:
    f = down.shape[1]
    out = []
    for i in range(0, h.shape[0], 4096):
        fused = ops.linear(h[i:i + 4096], up)
        out.append(ops.linear(fused[:, :f] * torch.nn.functional.silu(fused[:, f:]), down))
    return torch.cat(out)


@torch.no_grad()
def logits(spec, raw: dict, seqs: list, rows: list, lowp: bool = False) -> list:
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        return _logits(spec, raw, seqs, rows, Ops(lowp))
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32


def _logits(spec, raw, seqs, rows, ops) -> list:
    g = spec.group_size
    dev = raw["final_norm"].device
    emb = dequantize(raw, "embed", g)
    xs = [emb[torch.as_tensor(s, device=dev, dtype=torch.long)] for s in seqs]
    for i, kind in enumerate(spec.kinds):
        p = f"L{i}."
        ref = _kind(kind)
        w = ref.weights(spec, raw, p)
        up, down = dequantize(raw, p + "up", g), dequantize(raw, p + "down", g)
        for j, x in enumerate(xs):
            x = x + ref.forward(spec, w, rms_norm(x, raw[p + "norm1"], spec.norm_eps), ops)
            xs[j] = x + _mlp(rms_norm(x, raw[p + "norm2"], spec.norm_eps), up, down, ops)
        del w, up, down
    out = []
    for x, r in zip(xs, rows):
        h = rms_norm(x[torch.as_tensor(r, device=dev, dtype=torch.long)], raw["final_norm"],
                     spec.norm_eps)
        out.append(ops.linear(h, emb))
    return out
