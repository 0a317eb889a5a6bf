"""Quant-matmul probe at a small group count and with lane-padded scales.

Counterpart of `tools/exp_qmm_bisect.py`, with the same cells, inputs and
JSON lines. The JAX script bisected a Mosaic miscompile of the TPU kernel
at N 256, K 512, g 32 (kg = 16 groups, f32 scales, M 1): whether the
unchunked [tn, kg] scale block with a 16-wide lane dimension read garbled,
or the scale-expansion dot with a contraction of kg < 128 miscompiled on
the MXU, and whether zero-padding the scale rows to 128 lanes fixed both.
Those hypotheses are about Mosaic's layouts and the MXU; they do not
carry over to Hopper, where neither a lane width nor an expansion dot
exists. Here the probe checks what remains to check: that K1 is right at
a small group count, and that it takes scale rows zero-padded past their
groups (the kernel's scale row stride) as the JAX kernel does.

Cells (each a JSON line, the cell's name with the JAX script's metric,
max |got - want| / (|want| + 1e-3), and `err_over_rms`, max |got - want|
over the RMS of the numpy oracle, which does not blow up at near-zero
outputs):
  prod_kg16            K1 at M 1 with the [256, 16] f32 scales
  blockread_kg16_err   max abs error of the [256, 16] block read back
                       through P1 (`scale_block_copy`) into [256, 128]
  prod_pad128/64/32    K1 with the scales zero-padded to that many groups
  pad128_m64           M 64 (the tile, which rounds x and W to bf16)
  pad128_bf16          bf16 scales against the f32-scale oracle

    python -m uzu_tpu_torch.tools.exp_qmm_bisect [--device cpu]
"""

from __future__ import annotations

import json

import numpy as np
import torch


def _errs(got: torch.Tensor, want: np.ndarray) -> tuple[float, float]:
    """(the JAX script's max-rel metric, max abs error over RMS(want))."""
    d = np.abs(got.float().cpu().numpy() - want)
    rms = np.sqrt(np.mean(want.astype(np.float64) ** 2))
    return float(np.max(d / (np.abs(want) + 1e-3))), float(np.max(d) / rms)


def main(device=None) -> dict:
    """Run every cell on `device` (the card unless "cpu"); prints one JSON
    line per cell and returns {cell: {"value": the line's metric, and
    "err_over_rms" for the K1 cells}}."""
    from ..ops.cuda.block_copy import scale_block_copy
    from ..ops.cuda.quant_matmul import quant_matmul
    from ..quant.format import QuantizedTensor
    from ..runtime import resolve_device

    dev = resolve_device(device)
    rng = np.random.default_rng(0)

    n, kdim, g, m = 256, 512, 32, 1
    kg = kdim // g
    codes = rng.integers(0, 16, (n, kdim), dtype=np.uint8)
    scales = rng.random((n, kg)).astype(np.float32) * 0.02 + 0.01
    x = rng.standard_normal((m, kdim)).astype(np.float32)
    lo, hi = codes[:, 0::2], codes[:, 1::2]
    inter = np.stack([lo, hi], axis=-1).reshape(n, kdim)
    w = (inter.astype(np.float32) - 8.0) * np.repeat(scales, g, axis=-1)
    packed = torch.from_numpy((codes[:, 0::2] | (codes[:, 1::2] << 4)).astype(np.uint8)).to(dev)

    out: dict = {}

    def report(cell: str, value: float, **extra) -> None:
        out[cell] = dict(value=value, **extra)
        print(json.dumps({cell: value, **extra}), flush=True)

    def run(cell, scales_np, sdt=torch.float32, xm=None):
        xin = x if xm is None else xm
        qt = QuantizedTensor(codes=packed, scales=torch.from_numpy(scales_np).to(dev, sdt),
                             qbias=None, bits=4, group_size=g, qbias_coeff=-8.0)
        max_rel, err = _errs(quant_matmul(qt, torch.from_numpy(xin).to(dev)), xin @ w.T)
        report(cell, max_rel, err_over_rms=err)

    # 1. the group count of the JAX miscompile, unpadded
    run("prod_kg16", scales)

    # 2. the raw block read: the [256, 16] block into a [256, 128] output
    got = scale_block_copy(torch.from_numpy(scales).to(dev)).cpu().numpy()
    report("blockread_kg16_err", float(np.max(np.abs(got[:, :kg] - scales))))

    # 3. lane-padded scales through K1
    for pad_to in (128, 64, 32):
        sp = np.zeros((n, pad_to), np.float32)
        sp[:, :kg] = scales
        run(f"prod_pad{pad_to}", sp)

    # 4. the JAX script's other failing cells, with pad128
    sp = np.zeros((n, 128), np.float32)
    sp[:, :kg] = scales
    x64 = rng.standard_normal((64, kdim)).astype(np.float32)
    run("pad128_m64", sp, xm=x64)
    run("pad128_bf16", sp, sdt=torch.bfloat16)
    return out


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cpu, or the card (default)")
    main(ap.parse_args().device)
