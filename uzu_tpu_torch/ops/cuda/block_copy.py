"""P1: zero-padded copy of a block of group scales.

Wrapper and plain PyTorch version of `csrc/block_copy.cu`, which replaces
`tools/exp_qmm_bisect.py::copy_kernel`, the bisect probe's block read
(`uzu_tpu_torch/tools/exp_qmm_bisect.py` runs it). A CPU tensor takes
`scale_block_copy_plain`; a CUDA tensor launches the kernel or raises.
`empty_launch` launches a kernel that does nothing, the launch floor that
P1's time is read against; no path runs it, so it has no launch count.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from .build import LAUNCHES, check, library

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = [_P, _P, _I, _I, _I, _P]


def scale_block_copy_plain(s: torch.Tensor, width: int = 128) -> torch.Tensor:
    """s [R, kg] -> [R, width]: s in the first kg columns, zeros after."""
    return F.pad(s, (0, width - s.shape[1]))


def _lib():
    fn = library("block_copy").uz_scale_block_copy
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = _I
    return fn


def scale_block_copy(s: torch.Tensor, width: int = 128) -> torch.Tensor:
    """f32 s [R, kg] -> f32 [R, width], zero-padded past column kg."""
    if s.dim() != 2 or not 1 <= s.shape[1] <= width or s.shape[0] < 1:
        raise ValueError(f"scale_block_copy: s {tuple(s.shape)} does not fit width {width}")
    if s.device.type == "cpu":
        return scale_block_copy_plain(s, width)
    if s.device.type != "cuda":
        raise ValueError(f"scale_block_copy: unsupported device {s.device}")
    if s.dtype != torch.float32:
        raise ValueError(f"scale_block_copy kernel takes f32 scales, not {s.dtype}")
    if width % 4:
        raise ValueError(f"scale_block_copy kernel writes 4-column vectors: width {width} "
                         f"is not a multiple of 4")
    s = s.contiguous()
    r, kg = s.shape
    out = torch.empty((r, width), dtype=torch.float32, device=s.device)
    with torch.cuda.device(s.device):
        rc = _lib()(s.data_ptr(), out.data_ptr(), r, kg, width,
                    torch.cuda.current_stream().cuda_stream)
    check(rc, "scale_block_copy")
    LAUNCHES["scale_block_copy"] += 1
    return out


def empty_launch(device: torch.device) -> None:
    """One launch of an empty kernel (one warp, no memory traffic) on the
    current stream of the CUDA `device`."""
    if device.type != "cuda":
        raise ValueError(f"empty_launch needs a CUDA device, not {device}")
    fn = library("block_copy").uz_empty_launch
    if fn.argtypes is None:
        fn.argtypes = [_P]
        fn.restype = _I
    with torch.cuda.device(device):
        check(fn(torch.cuda.current_stream().cuda_stream), "empty_launch")
