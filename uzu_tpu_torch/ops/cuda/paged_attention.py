"""K5/K6: decode attention through page tables over shared KV pools.

Wrapper and plain PyTorch version of `csrc/paged_attention.cu`, which
replaces `uzu_tpu/ops/pallas/paged_attention.py::_kernel` (K5, bf16 or f32
pools) and `::_kernel_i8` (K6, INT8 codes with per-(token, kv-head) f32
scales [G, P, page] given as `k_scales`/`v_scales`). A CPU tensor takes
`paged_attention_plain`; a CUDA tensor launches the kernel or raises.
Both return f32 [B, H, Dh].

Where one block per (slot, KV group) cannot fill the card, the kernel
deals the table's 64-token tiles to `paged_split_plan` splits and merges
them in a fixed order (`flash_combine` of `csrc/split_combine.cuh`, shared
with K3/K4). `paged_partials_plain` is the plain version of one split;
`flash_combine_plain` merges them. Nothing on the main path calls either.
"""

from __future__ import annotations

import ctypes

import torch

from ...models.kv_cache import dequantize_rows
from .build import LAUNCHES, check, library
from .flash_attention import num_sms as device_sms

NEG_INF = -1e30
_HEAD_DIMS = (64, 128)
MAX_REP = 16  # query heads per KV group the kernel takes: the 16 rows of mma.sync's M
TILE = 64  # tokens per tile of the kernel

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_ARGTYPES = [_P, _P, _P, _P, _P, _I, _I, _P, _P, _P, _P,
             _I, _I, _I, _I, _I, _I, _I, _F, _F, _I, _I, _P, _P]


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


def paged_split_plan(b: int, g: int, width_tokens: int, num_sms: int) -> tuple[int, int]:
    """(splits, most tiles a split takes) of the kernel's split over the
    64-token tiles of [0, width_tokens), the table's width in tokens. One
    split where the B * G (slot, group) blocks fill `num_sms`; else enough
    splits for blocks >= num_sms, at most one per tile. Split z takes the
    tiles z, z + splits, z + 2 splits, ...: the live tokens are a prefix of
    the width (or a window ending at the length), and interleaved tiles
    spread any prefix over every split, where equal ranges would leave the
    ranges past a short slot idle. Shapes only: the plan never reads
    lengths, so the step needs no host sync and a captured step keeps its
    launch."""
    blocks = b * g
    tiles = -(-width_tokens // TILE)
    if blocks >= num_sms:
        return 1, tiles
    per = max(1, tiles // -(-num_sms // blocks))
    splits = -(-tiles // per)
    return splits, -(-tiles // splits)


def split_positions(z: int, splits: int, width_tokens: int) -> torch.Tensor:
    """The token positions of split z: its tiles z, z + splits, ... of the
    width, in order."""
    tiles = torch.arange(z, -(-width_tokens // TILE), splits)
    pos = (tiles[:, None] * TILE + torch.arange(TILE)).reshape(-1)
    return pos[pos < width_tokens]


def paged_partials_plain(q, k_pool, v_pool, page_table, lengths, positions, *, scale,
                         logit_soft_cap=None, sliding_window_size=None,
                         k_scales=None, v_scales=None):
    """One split's unnormalized state over the token positions `positions`
    (1-D, inside the table's width; `split_positions` gives a split's) of
    each slot: (m [B, H], l [B, H], acc [B, H, Dh]), f32, m in natural-log
    units (NEG_INF where a slot has no live token among them). Only those
    rows are gathered. INT8 codes take their scales as the kernel folds
    them: score = (q . code_k) * k_scale * scale, and acc sums p * v_scale
    times the codes."""
    bsz, h, dh = q.shape
    g, _, page, _ = k_pool.shape
    rep = h // g
    pos = positions.to(q.device).long()
    pages = page_table.long()[:, pos // page]  # [B, n]
    off = pos % page

    def rows(t):  # [G, P, page, ...] -> [B, G, n, ...] at the positions
        return t[:, pages, off].transpose(0, 1).float()

    qf = q.float().reshape(bsz, g, rep, dh)
    scores = torch.einsum("bgrd,bgcd->bgrc", qf, rows(k_pool))
    if k_scales is not None:
        scores = scores * rows(k_scales)[:, :, None, :]
    scores = scores * scale
    if logit_soft_cap is not None:
        scores = logit_soft_cap * torch.tanh(scores / logit_soft_cap)
    length = lengths.to(q.device).long()[:, None, None, None]
    valid = pos[None, None, None, :] < length
    if sliding_window_size is not None:
        valid = valid & (pos[None, None, None, :] >= length - sliding_window_size)
    valid = valid.expand_as(scores)
    scores = scores.masked_fill(~valid, NEG_INF)
    m = scores.amax(dim=-1)
    p = torch.where(valid, torch.exp(scores - m[..., None]), torch.zeros_like(scores))
    l = p.sum(dim=-1)
    if v_scales is not None:
        p = p * rows(v_scales)[:, :, None, :]
    acc = torch.einsum("bgrc,bgcd->bgrd", p, rows(v_pool))
    return m.reshape(bsz, h), l.reshape(bsz, h), acc.reshape(bsz, h, dh)


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
    splits, _ = paged_split_plan(bsz, g, maxp * page, device_sms(q.device))
    scratch = None
    if splits > 1:
        scratch = torch.empty(splits * bsz * h * (dh + 2), dtype=torch.float32,
                              device=q.device)
    with torch.cuda.device(q.device):
        rc = _lib()(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            k_scales.data_ptr() if quantized else None,
            v_scales.data_ptr() if quantized else None,
            int(quantized), int(q.dtype == torch.bfloat16), table.data_ptr(),
            lens.data_ptr(), None if sk is None else sk.data_ptr(), out.data_ptr(),
            bsz, h, g, p_total, page, maxp, dh, float(scale),
            float(logit_soft_cap or 0.0), int(sliding_window_size or 0), splits,
            None if scratch is None else scratch.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    name = "paged_attention_int8" if quantized else "paged_attention"
    check(rc, name)
    LAUNCHES[name] += 1
    return out
