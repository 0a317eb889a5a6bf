"""S1: Mamba-1's selective scan, over a prefill chunk or one decode step.

Wrapper and plain PyTorch version of `csrc/selective_scan.cu`, which
replaces no TPU kernel (the JAX package has no Mamba-1 mixer; see the
source's note). `models/ssm.py`'s Mamba-1 forward calls `selective_scan`
once a layer: a chunk of S > 1 rows launches `selective_scan_chunk`, one
row (the batch engines' decode step, B slots) `selective_scan_step`. A CPU
tensor takes `selective_scan_plain`; a CUDA tensor launches the kernel or
raises.

    delta = softplus(dt + dt_bias); h_t = exp(delta A) h_{t-1} + delta B_t x_t
    y_t = (h_t C_t + D x_t) * silu(z_t),  A = -exp(a_log)

Rows at and past a sequence's length are identity transitions: the state
stays, and y is still computed from it.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from .build import LAUNCHES, check, library

N_STATE = 16  # the kernel's state width
CHANNELS = 16  # channels a block

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_ARGTYPES = [_P] * 12 + [_I] * 3 + [_L] * 10 + [_P]


def _softplus(x: torch.Tensor) -> torch.Tensor:
    return torch.where(x > 20.0, x, torch.log1p(torch.exp(x)))


def selective_scan_plain(x, dt, z, b, c, a_log, dt_bias, d_skip, h0, lengths):
    """x, dt, z [B, S, Di]; b, c [B, S, N]; a_log [Di, N]; dt_bias, d_skip
    [Di]; h0 f32 [B, Di, N]; lengths [B] int -> (y [B, S, Di] in x's dtype,
    h f32 [B, Di, N]). f32 arithmetic in the kernel's order, one step at a
    time."""
    s = x.shape[1]
    xf, zf = x.float(), z.float()
    delta = _softplus(dt.float() + dt_bias.float())
    a = -torch.exp(a_log.float())
    valid = torch.arange(s, device=x.device)[None, :] < lengths.reshape(-1, 1).to(x.device)
    bf, cf = b.float(), c.float()
    h = h0
    ys = []
    for t in range(s):
        dt_t = delta[:, t, :, None]
        hn = torch.exp(dt_t * a) * h + (dt_t * xf[:, t, :, None]) * bf[:, t, None, :]
        h = torch.where(valid[:, t, None, None], hn, h)
        ys.append(torch.einsum("bdn,bn->bd", h, cf[:, t]))
    y = torch.stack(ys, dim=1) + d_skip.float() * xf
    return (y * F.silu(zf)).to(x.dtype), h


def _lib(name: str):
    fn = getattr(library("selective_scan"), name)
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = _I
    return fn


def _staged(t: torch.Tensor) -> torch.Tensor:
    """t itself where the kernel can read it in 16-byte pieces (last dim
    contiguous, strides multiples of 8 elements, 16-byte aligned base),
    else a contiguous copy."""
    if (t.stride(-1) == 1 and all(st % 8 == 0 for st in t.stride()[:-1])
            and t.data_ptr() % 16 == 0):
        return t
    return t.contiguous()


def selective_scan(x, dt, z, b, c, a_log, dt_bias, d_skip, h0, lengths):
    """`selective_scan_plain`'s result; on the card x, dt, z, b and c are
    bf16 and y comes back bf16."""
    bsz, s, di = x.shape
    n = a_log.shape[1]
    if dt.shape != x.shape or z.shape != x.shape or b.shape != (bsz, s, n) or \
            c.shape != (bsz, s, n) or h0.shape != (bsz, di, n) or lengths.shape != (bsz,):
        raise ValueError(f"selective_scan: shapes x {tuple(x.shape)}, dt {tuple(dt.shape)}, "
                         f"z {tuple(z.shape)}, b {tuple(b.shape)}, c {tuple(c.shape)}, "
                         f"h0 {tuple(h0.shape)}, lengths {tuple(lengths.shape)} do not agree")
    if x.device.type == "cpu":
        return selective_scan_plain(x, dt, z, b, c, a_log, dt_bias, d_skip, h0, lengths)
    if x.device.type != "cuda":
        raise ValueError(f"selective_scan: unsupported device {x.device}")
    if n != N_STATE or di % CHANNELS:
        raise ValueError(f"selective_scan kernel takes N = {N_STATE} and Di % {CHANNELS} == 0 "
                         f"(N={n}, Di={di})")
    if any(t.dtype != torch.bfloat16 for t in (x, dt, z, b, c)):
        raise ValueError("selective_scan kernel takes bf16 x, dt, z, B and C")
    if any(t.dtype != torch.float32 for t in (a_log, dt_bias, d_skip, h0)) or \
            lengths.dtype != torch.int32:
        raise ValueError("selective_scan kernel takes f32 A_log, dt_bias, D and h0 and int32 "
                         "lengths")
    x, dt, z, b, c = (_staged(t) for t in (x, dt, z, b, c))
    a_log, dt_bias, d_skip, h0, lengths = (
        t.contiguous() for t in (a_log, dt_bias, d_skip, h0, lengths))
    if a_log.data_ptr() % 16 or h0.data_ptr() % 16:
        raise ValueError("selective_scan kernel needs 16-byte aligned A_log and h0")
    y = torch.empty((bsz, s, di), dtype=torch.bfloat16, device=x.device)
    h = torch.empty_like(h0)
    name = "uz_selective_scan_step" if s == 1 else "uz_selective_scan"
    strides = [v for t in (x, dt, z, b, c) for v in t.stride()[:2]]
    with torch.cuda.device(x.device):
        rc = _lib(name)(x.data_ptr(), dt.data_ptr(), z.data_ptr(), b.data_ptr(), c.data_ptr(),
                        a_log.data_ptr(), dt_bias.data_ptr(), d_skip.data_ptr(), h0.data_ptr(),
                        lengths.data_ptr(), y.data_ptr(), h.data_ptr(), bsz, s, di, *strides,
                        torch.cuda.current_stream().cuda_stream)
    check(rc, "selective_scan")
    LAUNCHES["selective_scan_step" if s == 1 else "selective_scan"] += 1
    return y, h
