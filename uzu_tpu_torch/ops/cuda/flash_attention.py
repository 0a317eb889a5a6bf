"""K3/K4: causal GQA flash attention over a contiguous KV cache.

Wrapper and plain PyTorch version of `csrc/flash_attention.cu`, which
replaces `uzu_tpu/ops/pallas/flash_attention.py::_kernel_plain` (K3, bf16
or f32 K/V) and `::_kernel_quant` (K4, INT8 codes [C, G, Dh] with f32
scales [C, G] given as `k_scales`/`v_scales`). A CPU tensor takes
`flash_attention_plain`; a CUDA tensor launches the kernel or raises. Both
return f32 [S, H, Dh]; queries sit at q_positions[0] + arange(S).

Where one block per (KV group, 64-row tile) cannot fill the card, the
kernel splits the KV tiles into `split_plan` ranges and merges them in a
fixed order. `flash_partials_plain` and `flash_combine_plain` are the plain
versions of those two halves; nothing on the main path calls them.
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
BQ = 64  # query rows per block of the kernel
BK = 64  # KV slots per tile of the kernel

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_ARGTYPES = [_P, _P, _P, _I, _P, _P, _P, _I, _I, _I, _I, _I, _F, _F, _I, _I, _I, _P, _P]
_ARGTYPES_I8 = [_P, _P, _P, _P, _P, _I, _P, _P, _P, _I, _I, _I, _I, _I, _F, _F, _I, _I, _I,
                _P, _P]
_SMS: dict[int, int] = {}


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


def split_plan(s: int, h: int, g: int, c: int, num_sms: int) -> tuple[int, int]:
    """(ranges, KV tiles per range) of the kernel's split over [0, C).
    One range where the (64-row tile, group) blocks fill `num_sms`; else
    equal ranges of whole tiles, enough for blocks >= num_sms, at most one
    per tile. Shapes only: the plan never reads q_positions."""
    blocks = -(-s * (h // g) // BQ) * g
    tiles = -(-c // BK)
    if blocks >= num_sms:
        return 1, tiles
    per = max(1, tiles // -(-num_sms // blocks))
    return -(-tiles // per), per


def flash_partials_plain(q, k_cache, v_cache, q_positions, *, scale, begin, end,
                         sliding_window_size=None, logit_soft_cap=None,
                         k_scales=None, v_scales=None):
    """One split range's unnormalized state over key slots [begin, end):
    (m [S, H], l [S, H], acc [S, H, Dh]), f32, m in natural-log units
    (NEG_INF where a row sees no key of the range). INT8 codes take their
    scales as the kernel folds them: score = (q . code_k) * k_scale * scale,
    and acc sums p * v_scale times the codes."""
    s, h, dh = q.shape
    c, g, _ = k_cache.shape
    rep = h // g
    qf = q.float().reshape(s, g, rep, dh)
    scores = torch.einsum("sgrd,cgd->grsc", qf, k_cache.float())
    if k_scales is not None:
        scores = scores * k_scales.float().t()[:, None, None, :]
    scores = scores * scale
    if logit_soft_cap is not None:
        scores = logit_soft_cap * torch.tanh(scores / logit_soft_cap)
    qpos = q_positions[0].to(torch.int64) + torch.arange(s, device=q.device)
    kpos = torch.arange(c, device=q.device)
    valid = (kpos[None, :] <= qpos[:, None]) & (kpos >= begin) & (kpos < end)
    if sliding_window_size is not None:
        valid = valid & (kpos[None, :] > qpos[:, None] - sliding_window_size)
    scores = scores.masked_fill(~valid, NEG_INF)
    m = scores.amax(dim=-1)
    p = torch.where(valid, torch.exp(scores - m[..., None]), torch.zeros_like(scores))
    l = p.sum(dim=-1)
    if v_scales is not None:
        p = p * v_scales.float().t()[:, None, None, :]
    acc = torch.einsum("grsc,cgd->sgrd", p, v_cache.float()).reshape(s, h, dh)
    return m.permute(2, 0, 1).reshape(s, h), l.permute(2, 0, 1).reshape(s, h), acc


def flash_combine_plain(m, l, acc, sinks=None) -> torch.Tensor:
    """Merge split ranges m, l [n, S, H], acc [n, S, H, Dh] in range order,
    fold the sinks [H] once, normalize: f32 [S, H, Dh]."""
    top = m.amax(dim=0)
    w = torch.exp(m - top)
    total = (l * w).sum(dim=0)
    out = (acc * w[..., None]).sum(dim=0)
    if sinks is not None:
        sink = sinks.float()[None, :]
        top2 = torch.maximum(top, sink)
        corr = torch.exp(top - top2)
        total = total * corr + torch.exp(sink - top2)
        out = out * corr[..., None]
    return out / total.clamp_min(1e-30)[..., None]


def num_sms(device: torch.device) -> int:
    """The SM count of a CUDA device, read once per device."""
    idx = device.index if device.index is not None else torch.cuda.current_device()
    if idx not in _SMS:
        _SMS[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return _SMS[idx]


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
    splits, per = split_plan(s, h, g, c, num_sms(q.device))
    scratch = None
    if splits > 1:
        scratch = torch.empty(splits * s * h * (dh + 2), dtype=torch.float32, device=q.device)
    tail = (qpos.data_ptr(), None if sk is None else sk.data_ptr(), out.data_ptr(),
            s, h, g, c, dh, float(scale), float(logit_soft_cap or 0.0),
            int(sliding_window_size or 0), splits, per,
            None if scratch is None else scratch.data_ptr())
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
