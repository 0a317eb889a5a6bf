"""Weight carry-over from the JAX package's parameters to the port's.

`from_numpy_tree` takes the JAX package's parameter pytree with its leaves
already numpy arrays (for example `jax.tree.map(np.asarray, lm.params)`)
and returns the port's tree of torch tensors, so a model loaded once by
the JAX package runs in the port without reading its files again.
Quantized leaves are recognised by their attributes (`codes`, `scales`,
`qbias`, `bits`, `group_size`, `qbias_coeff`), never by importing the JAX
package. bf16 arrays (numpy dtype named "bfloat16") keep their bits.
"""

from __future__ import annotations

import numpy as np
import torch

from .quant.format import QuantizedTensor

_QT_FIELDS = ("codes", "scales", "qbias", "bits", "group_size", "qbias_coeff")


def array_to_torch(a, device=None) -> torch.Tensor:
    """numpy array (a bfloat16 one included) -> torch tensor."""
    a = np.ascontiguousarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a.copy())
    return t.to(device) if device is not None else t


def from_numpy_tree(tree, device=None):
    """Convert a nested dict/list/tuple tree with numpy and quantized leaves."""
    if all(hasattr(tree, f) for f in _QT_FIELDS):
        return QuantizedTensor(
            codes=array_to_torch(tree.codes, device),
            scales=array_to_torch(tree.scales, device),
            qbias=None if tree.qbias is None else array_to_torch(tree.qbias, device),
            bits=int(tree.bits),
            group_size=int(tree.group_size),
            qbias_coeff=None if tree.qbias_coeff is None else float(tree.qbias_coeff),
        )
    if isinstance(tree, dict):
        return {k: from_numpy_tree(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [from_numpy_tree(v, device) for v in tree]
    if tree is None:
        return None
    return array_to_torch(np.asarray(tree), device)
