"""Weight carry-over from the JAX package's parameters to the port's.

`from_numpy_tree` takes the JAX package's parameter pytree with its leaves
already numpy arrays (for example `jax.tree.map(np.asarray, lm.params)`)
and returns the port's tree of torch tensors, so a model loaded once by
the JAX package runs in the port without reading its files again.
Quantized leaves are recognised by their attributes (`codes`, `scales`,
`bits`, `group_size`, `qbias_coeff`, and `qbias` on a 2-D tensor but not
on an expert stack), never by importing the JAX package. bf16 arrays
(numpy dtype named "bfloat16") keep their bits. The JAX loader pads an
MoE down stack's output rows (and its biases) to a multiple of 128, a TPU
lane rule; the port keeps the model's d rows, so the padding is cut here.
An MoE block's shared experts (`"shared"`) are plain linears, unpadded in
both packages, and convert as such. A recurrent mixer's leaves (`conv_w`,
`conv_b`, `a_log`, `dt_bias`, `norm_scales`, `gate_bias`, `skip_weight`)
are f32 arrays in both packages and carry over as they are, and so do the
per-layer embeddings (`"per_layer_embedding"` and each layer's `"ple"`:
a table, linears and norm scales). A HybridSpec linear (the attributes
`base`, `adapter_down`, `adapter_up`, `input_signs`, `output_signs`)
becomes a `HybridLinear` over its converted leaves. A DFlash draft's
tree (`context_projection`, `context_norm`, `state_kv_projection`,
`layers`, `output_norm`: linears, norms and attention layers) converts
the same way, into the parameters of `engine.dflash.DFlashDraft`.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .quant.format import HybridLinear, QuantizedTensor, StackedQuantized

_SQ_FIELDS = ("codes", "scales", "bits", "group_size", "qbias_coeff")
_HYBRID_FIELDS = ("base", "adapter_down", "adapter_up", "input_signs", "output_signs")


def array_to_torch(a, device=None) -> torch.Tensor:
    """numpy array (a bfloat16 one included) -> torch tensor."""
    a = np.ascontiguousarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a.copy())
    return t.to(device) if device is not None else t


def _moe_without_lane_padding(mlp: dict) -> dict:
    """Keep the d output rows of an MoE down stack and its biases."""
    d = mlp["router"]["w"].shape[1]
    down = dict(mlp["down"])
    w = down["w"]
    if isinstance(w, StackedQuantized):
        down["w"] = dataclasses.replace(w, codes=w.codes[:, :d].contiguous(),
                                        scales=w.scales[:, :d].contiguous())
    else:
        down["w"] = w[:, :d].contiguous()
    if "b" in down:
        down["b"] = down["b"][:, :d].contiguous()
    return {**mlp, "down": down}


def from_numpy_tree(tree, device=None):
    """Convert a nested dict/list/tuple tree with numpy and quantized leaves."""
    if all(hasattr(tree, f) for f in _HYBRID_FIELDS):
        return HybridLinear(**{f: from_numpy_tree(getattr(tree, f), device)
                               for f in _HYBRID_FIELDS})
    if all(hasattr(tree, f) for f in _SQ_FIELDS):
        codes = array_to_torch(tree.codes, device)
        scales = array_to_torch(tree.scales, device)
        if not hasattr(tree, "qbias"):
            return StackedQuantized(codes=codes, scales=scales, bits=int(tree.bits),
                                    group_size=int(tree.group_size),
                                    qbias_coeff=float(tree.qbias_coeff))
        return QuantizedTensor(
            codes=codes,
            scales=scales,
            qbias=None if tree.qbias is None else array_to_torch(tree.qbias, device),
            bits=int(tree.bits),
            group_size=int(tree.group_size),
            qbias_coeff=None if tree.qbias_coeff is None else float(tree.qbias_coeff),
        )
    if isinstance(tree, dict):
        out = {k: from_numpy_tree(v, device) for k, v in tree.items()}
        return _moe_without_lane_padding(out) if {"router", "up", "down"} <= set(out) else out
    if isinstance(tree, (list, tuple)):
        return [from_numpy_tree(v, device) for v in tree]
    if tree is None:
        return None
    return array_to_torch(np.asarray(tree), device)
