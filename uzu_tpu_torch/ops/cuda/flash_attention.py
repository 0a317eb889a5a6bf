"""K3/K4: causal GQA flash attention over a contiguous KV cache.

Wrapper and plain PyTorch version of `csrc/flash_attention.cu`, which
replaces `uzu_tpu/ops/pallas/flash_attention.py::_kernel_plain` (K3, bf16
or f32 K/V) and `::_kernel_quant` (K4, INT8 codes [C, G, Dh] with f32
scales [C, G] given as `k_scales`/`v_scales`). A CPU tensor takes
`flash_attention_plain`; a CUDA tensor launches the kernel or raises. Both
return f32 [S, H, Dh]; queries sit at q_positions[0] + arange(S).
"""

from __future__ import annotations

import ctypes

import torch

from ...models.kv_cache import dequantize_rows
from .build import LAUNCHES, check, library

# enough query rows per KV group to fill a block of the kernel; below this
# the einsum path is cheap anyway (the JAX package's FLASH_MIN_ROWS)
FLASH_MIN_ROWS = 64
_HEAD_DIMS = (64, 128)
NEG_INF = -1e30

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_ARGTYPES = [_P, _P, _P, _I, _P, _P, _P, _I, _I, _I, _I, _I, _F, _F, _I, _P]
_ARGTYPES_I8 = [_P, _P, _P, _P, _P, _I, _P, _P, _P, _I, _I, _I, _I, _I, _F, _F, _I, _P]


def supported(s, h, g, dh, c, *, is_causal, suffix_mask, kv_valid_length,
              kv_positions=None) -> bool:
    """The semantic gate of the JAX kernel: causal, contiguous layout, no
    tree mask, no padding mask, enough rows. Its tile-divisibility half was
    a Mosaic constraint and is gone: the kernel masks ragged edges."""
    return (
        is_causal
        and suffix_mask is None
        and kv_valid_length is None
        and kv_positions is None
        and s * (h // g) >= FLASH_MIN_ROWS
    )


def flash_attention_plain(q, k_cache, v_cache, q_positions, *, scale,
                          sliding_window_size=None, logit_soft_cap=None,
                          sinks=None, k_scales=None, v_scales=None) -> torch.Tensor:
    """q [S, H, Dh], k/v [C, G, Dh] -> f32 [S, H, Dh], all math in f32.
    INT8 codes with scales are dequantized first (codes * scale in f32)."""
    if k_scales is not None:
        k_cache = dequantize_rows(k_cache, k_scales)
        v_cache = dequantize_rows(v_cache, v_scales)
    s, h, dh = q.shape
    c, g, _ = k_cache.shape
    rep = h // g
    qf = q.float().reshape(s, g, rep, dh)
    scores = torch.einsum("sgrd,cgd->grsc", qf, k_cache.float()) * scale
    if logit_soft_cap is not None:
        scores = logit_soft_cap * torch.tanh(scores / logit_soft_cap)
    qpos = q_positions[0].to(torch.int64) + torch.arange(s, device=q.device)
    kpos = torch.arange(c, device=q.device)
    valid = kpos[None, :] <= qpos[:, None]
    if sliding_window_size is not None:
        valid = valid & (kpos[None, :] > qpos[:, None] - sliding_window_size)
    scores = scores.masked_fill(~valid, NEG_INF)
    if sinks is not None:
        sink = sinks.float().reshape(g, rep, 1, 1).expand(g, rep, s, 1)
        logits = torch.cat([scores, sink], dim=-1)
        probs = torch.softmax(logits, dim=-1)[..., :c]
    else:
        probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("grsc,cgd->sgrd", probs, v_cache.float())
    return out.reshape(s, h, dh)


def _lib(quantized: bool = False):
    lib = library("flash_attention")
    fn = lib.uz_flash_attention_i8 if quantized else lib.uz_flash_attention
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES_I8 if quantized else _ARGTYPES
        fn.restype = _I
    return fn


def flash_attention(q, k_cache, v_cache, q_positions, *, scale,
                    sliding_window_size=None, logit_soft_cap=None,
                    sinks=None, k_scales=None, v_scales=None) -> torch.Tensor:
    if q.device.type == "cpu":
        return flash_attention_plain(
            q, k_cache, v_cache, q_positions, scale=scale,
            sliding_window_size=sliding_window_size,
            logit_soft_cap=logit_soft_cap, sinks=sinks,
            k_scales=k_scales, v_scales=v_scales)
    s, h, dh = q.shape
    c, g, _ = k_cache.shape
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    if k_cache.shape != v_cache.shape or k_cache.shape[2] != dh or q_positions.numel() < 1:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k {tuple(k_cache.shape)}, "
                         f"v {tuple(v_cache.shape)} do not fit together")
    if h % g or dh not in _HEAD_DIMS:
        raise ValueError(f"flash_attention kernel needs H % G == 0 and Dh in "
                         f"{_HEAD_DIMS} (H={h}, G={g}, Dh={dh})")
    quantized = k_scales is not None or v_scales is not None
    kv_dtype = torch.int8 if quantized else q.dtype
    if q.dtype not in (torch.bfloat16, torch.float32) or k_cache.dtype != kv_dtype \
            or v_cache.dtype != kv_dtype:
        raise ValueError("flash_attention kernel needs q bf16 or f32 and k, v of q's dtype, "
                         "or int8 k, v together with both k_scales and v_scales")
    q = q.contiguous()
    tensors = [q, k_cache, v_cache]
    if quantized:
        if k_scales is None or v_scales is None:
            raise ValueError("flash_attention: int8 K/V need both k_scales and v_scales")
        for t in (k_scales, v_scales):
            if t.shape != (c, g) or t.dtype != torch.float32:
                raise ValueError(f"flash_attention: scales must be f32 [{c}, {g}], got "
                                 f"{t.dtype} {tuple(t.shape)}")
        tensors += [k_scales, v_scales]
    for t in tensors:
        if not t.is_contiguous() or t.data_ptr() % 16 or t.device != q.device:
            raise ValueError("flash_attention: q/k/v/scales must be contiguous, 16-byte "
                             "aligned and on one device")
    qpos = q_positions.to(device=q.device, dtype=torch.int32).contiguous()
    sk = None
    if sinks is not None:
        sk = sinks.to(device=q.device, dtype=torch.float32).contiguous()
    out = torch.empty((s, h, dh), dtype=torch.float32, device=q.device)
    tail = (qpos.data_ptr(), None if sk is None else sk.data_ptr(), out.data_ptr(),
            s, h, g, c, dh, float(scale), float(logit_soft_cap or 0.0),
            int(sliding_window_size or 0))
    is_bf16 = int(q.dtype == torch.bfloat16)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        if quantized:
            rc = _lib(True)(q.data_ptr(), k_cache.data_ptr(), k_scales.data_ptr(),
                            v_cache.data_ptr(), v_scales.data_ptr(), is_bf16, *tail, stream)
        else:
            rc = _lib()(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), is_bf16,
                        *tail, stream)
    name = "flash_attention_int8" if quantized else "flash_attention"
    check(rc, name)
    LAUNCHES[name] += 1
    return out
