"""Random Hadamard transform (incoherence processing), block size 32.

Counterpart of `uzu_tpu/ops/rht.py`. The 32-point butterfly equals a
product with the Sylvester Hadamard matrix H / sqrt(32) (orthogonal,
symmetric; its f32 entries), so the transform is a [..., K/32, 32] @
[32, 32] product, as the JAX package leaves it to XLA outside any kernel.
It runs in f64 and is rounded to f32 once: an f32 product's summation
order depends on its shape, so a row's f32 result would change with the
number of rows in the call, and the batched engines, which run M rows
where the single stream runs one, would part from it by bf16 rounding
flips. The f64 sum rounds to the same f32 whatever the shape, and lies
within JAX's own f32 rounding of its result.

- input RHT:  per block, H @ (signs * x)
- output RHT: per block, signs * (H @ x)

`transform_weight_for_storage` stays numpy: the synthesizer writes with it.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

BLOCK = 32


@lru_cache(maxsize=None)
def _hadamard_matrix() -> np.ndarray:
    h = np.array([[1.0]], np.float32)
    while h.shape[0] < BLOCK:
        h = np.block([[h, h], [h, -h]])
    return h / np.sqrt(BLOCK)


@lru_cache(maxsize=None)
def _hadamard_on(device: torch.device) -> torch.Tensor:
    """The JAX package's f32 matrix, held in f64 on `device` (copied there
    once)."""
    return torch.from_numpy(_hadamard_matrix().astype(np.float32).astype(np.float64)).to(device)


def _blockwise(x: torch.Tensor) -> torch.Tensor:
    """f32 x [..., K] -> per-32-block Hadamard, f32."""
    k = x.shape[-1]
    assert k % BLOCK == 0, f"RHT needs K % {BLOCK} == 0, got {k}"
    h = _hadamard_on(x.device)
    xb = x.double().reshape(*x.shape[:-1], k // BLOCK, BLOCK)
    return torch.matmul(xb, h).float().reshape(x.shape)


def input_rht(x: torch.Tensor, signs: torch.Tensor) -> torch.Tensor:
    xf = x.float() * signs.float()
    return _blockwise(xf).to(x.dtype)


def output_rht(x: torch.Tensor, signs: torch.Tensor) -> torch.Tensor:
    xf = _blockwise(x.float())
    return (xf * signs.float()).to(x.dtype)


def transform_weight_for_storage(
    w: np.ndarray, input_signs: np.ndarray, output_signs: np.ndarray
) -> np.ndarray:
    """W -> W' such that output_rht(W' @ input_rht(x)) == W @ x: with x' =
    H S_i x and y = S_o H y', W' = H S_o W S_i H (H block-diagonal,
    orthogonal, H^T = H). The synthesizer quantizes W', where incoherence
    has flattened the outliers."""
    h = _hadamard_matrix()

    def block_h(m, axis):
        if axis == 0:
            mb = m.reshape(m.shape[0] // BLOCK, BLOCK, m.shape[1])
            return np.einsum("ij,bjm->bim", h, mb).reshape(m.shape)
        mb = m.reshape(m.shape[0], m.shape[1] // BLOCK, BLOCK)
        return np.einsum("mbj,ij->mbi", mb, h).reshape(m.shape)

    scaled = output_signs[:, None].astype(np.float32) * w * input_signs[None, :].astype(np.float32)
    return block_h(block_h(scaled, 0), 1)
