"""K5/K6: decode attention through page tables over shared KV pools.

Wrapper and plain PyTorch version of `csrc/paged_attention.cu`, which
replaces `uzu_tpu/ops/pallas/paged_attention.py::_kernel` (K5, bf16 or f32
pools) and `::_kernel_i8` (K6, INT8 codes with per-(token, kv-head) f32
scales [G, P, page] given as `k_scales`/`v_scales`). A CPU tensor takes
`paged_attention_plain`; a CUDA tensor launches the kernel or raises.
Both return f32 [B, H, Dh].
"""

from __future__ import annotations

import ctypes

import torch

from ...models.kv_cache import dequantize_rows
from .build import LAUNCHES, check, library

NEG_INF = -1e30
_HEAD_DIMS = (64, 128)
MAX_REP = 16  # query heads per KV group the kernel takes (one warp each)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_ARGTYPES = [_P, _P, _P, _P, _P, _I, _I, _P, _P, _P, _P,
             _I, _I, _I, _I, _I, _I, _I, _F, _F, _I, _P]


def paged_attention_plain(q, k_pool, v_pool, page_table, lengths, *, scale,
                          logit_soft_cap=None, sliding_window_size=None,
                          sinks=None, k_scales=None, v_scales=None) -> torch.Tensor:
    """The JAX package's `paged_attention_reference`: gather every table
    page, dequantize INT8 pools on the gathered slice, mask by length and
    window, softmax with the sinks as one extra logit. f32 math."""
    bsz, h, dh = q.shape
    g, _, page, _ = k_pool.shape
    rep = h // g
    maxp = page_table.shape[1]
    tbl = page_table.long()
    k = k_pool[:, tbl].transpose(0, 1).reshape(bsz, g, maxp * page, dh)
    v = v_pool[:, tbl].transpose(0, 1).reshape(bsz, g, maxp * page, dh)
    if k_scales is not None:
        ks = k_scales[:, tbl].transpose(0, 1).reshape(bsz, g, maxp * page)
        vs = v_scales[:, tbl].transpose(0, 1).reshape(bsz, g, maxp * page)
        k, v = dequantize_rows(k, ks), dequantize_rows(v, vs)
    qf = q.float().reshape(bsz, g, rep, dh)
    scores = torch.einsum("bgrd,bgcd->bgrc", qf, k.float()) * scale
    if logit_soft_cap is not None:
        scores = logit_soft_cap * torch.tanh(scores / logit_soft_cap)
    pos = torch.arange(maxp * page, device=q.device)[None, None, None, :]
    length = lengths.to(q.device).long()[:, None, None, None]
    valid = pos < length
    if sliding_window_size is not None:
        valid = valid & (pos >= length - sliding_window_size)
    scores = scores.masked_fill(~valid, NEG_INF)
    if sinks is not None:
        sink = sinks.float().reshape(1, g, rep, 1).expand(bsz, g, rep, 1)
        probs = torch.softmax(torch.cat([scores, sink], dim=-1), dim=-1)[..., :-1]
    else:
        probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bgrc,bgcd->bgrd", probs, v.float())
    return out.reshape(bsz, h, dh)


def _lib():
    fn = library("paged_attention").uz_paged_attention
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = _I
    return fn


def paged_decode_attention(q, k_pool, v_pool, page_table, lengths, *, scale,
                           logit_soft_cap=None, sliding_window_size=None,
                           sinks=None, k_scales=None, v_scales=None) -> torch.Tensor:
    """q [B, H, Dh] (one decode token per slot), pools [G, P, page, Dh],
    page_table [B, MAXP] (every entry a valid physical page), lengths [B]
    visible tokens per slot -> f32 [B, H, Dh]."""
    kw = dict(scale=scale, logit_soft_cap=logit_soft_cap,
              sliding_window_size=sliding_window_size, sinks=sinks,
              k_scales=k_scales, v_scales=v_scales)
    if q.device.type == "cpu":
        return paged_attention_plain(q, k_pool, v_pool, page_table, lengths, **kw)
    if q.device.type != "cuda":
        raise ValueError(f"paged_decode_attention: unsupported device {q.device}")
    bsz, h, dh = q.shape
    g, p_total, page, _ = k_pool.shape
    maxp = page_table.shape[1]
    if k_pool.shape != v_pool.shape or k_pool.shape[3] != dh \
            or tuple(page_table.shape) != (bsz, maxp) or tuple(lengths.shape) != (bsz,):
        raise ValueError(f"paged_decode_attention: q {tuple(q.shape)}, pools "
                         f"{tuple(k_pool.shape)}/{tuple(v_pool.shape)}, table "
                         f"{tuple(page_table.shape)}, lengths {tuple(lengths.shape)} "
                         "do not fit together")
    if h % g or not 1 <= h // g <= MAX_REP or dh not in _HEAD_DIMS:
        raise ValueError(f"paged attention kernel needs H % G == 0, H/G <= {MAX_REP} and "
                         f"Dh in {_HEAD_DIMS} (H={h}, G={g}, Dh={dh})")
    quantized = k_scales is not None or v_scales is not None
    kv_dtype = torch.int8 if quantized else q.dtype
    if q.dtype not in (torch.bfloat16, torch.float32) or k_pool.dtype != kv_dtype \
            or v_pool.dtype != kv_dtype:
        raise ValueError("paged attention kernel needs q bf16 or f32 and pools of q's "
                         "dtype, or int8 pools together with both k_scales and v_scales")
    tensors = [q.contiguous(), k_pool, v_pool]
    if quantized:
        if k_scales is None or v_scales is None:
            raise ValueError("paged_decode_attention: int8 pools need both k_scales "
                             "and v_scales")
        for t in (k_scales, v_scales):
            if t.shape != (g, p_total, page) or t.dtype != torch.float32:
                raise ValueError(f"paged_decode_attention: scales must be f32 "
                                 f"[{g}, {p_total}, {page}], got {t.dtype} {tuple(t.shape)}")
        tensors += [k_scales, v_scales]
    for t in tensors:
        if not t.is_contiguous() or t.data_ptr() % 16 or t.device != q.device:
            raise ValueError("paged_decode_attention: q/pools/scales must be contiguous, "
                             "16-byte aligned and on one device")
    q = tensors[0]
    table = page_table.to(device=q.device, dtype=torch.int32).contiguous()
    lens = lengths.to(device=q.device, dtype=torch.int32).contiguous()
    sk = None if sinks is None else sinks.to(device=q.device, dtype=torch.float32).contiguous()
    out = torch.empty((bsz, h, dh), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        rc = _lib()(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            k_scales.data_ptr() if quantized else None,
            v_scales.data_ptr() if quantized else None,
            int(quantized), int(q.dtype == torch.bfloat16), table.data_ptr(),
            lens.data_ptr(), None if sk is None else sk.data_ptr(), out.data_ptr(),
            bsz, h, g, p_total, page, maxp, dh, float(scale),
            float(logit_soft_cap or 0.0), int(sliding_window_size or 0),
            torch.cuda.current_stream().cuda_stream)
    name = "paged_attention_int8" if quantized else "paged_attention"
    check(rc, name)
    LAUNCHES[name] += 1
    return out
