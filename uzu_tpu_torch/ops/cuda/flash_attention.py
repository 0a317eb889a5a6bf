"""K3/K4: causal GQA flash attention over a contiguous KV cache.

Wrapper and plain PyTorch version of `csrc/flash_attention.cu`, which
replaces `uzu_tpu/ops/pallas/flash_attention.py::_kernel_plain` (K3, bf16
or f32 K/V) and `::_kernel_quant` (K4, INT8 codes [C, G, Dh] with f32
scales [C, G] given as `k_scales`/`v_scales`). A CPU tensor takes
`flash_attention_plain`; a CUDA tensor launches the kernel or raises. Both
return f32 [S, H, Dh]; queries sit at q_positions[0] + arange(S).

The kernel is built for head dims 32, 64, 128 and 256 (`_HEAD_DIMS`). Any
other Dh that is a multiple of 8 up to 256 runs in the next instantiation
up (`head_dim_instance`: 24 in 32, 200 in 256), with the columns past Dh
zero-filled on load and never stored. A Dh past 256 (264, 512, ...) runs
in the kernel's wide case of the Dh-256 layout: `column_slices(dh)`
blocks per row tile, each owning 256 columns of the output and summing
the scores over Dh in 256-column pieces. A Dh that is not a multiple of 8
raises on the card.

Where one block per (KV group, 64-row tile) cannot fill the card, the
kernel splits the KV tiles into `split_plan` ranges and merges them in a
fixed order. `flash_partials_plain` and `flash_combine_plain` are the plain
versions of those two halves; nothing on the main path calls them.

Gradient (K3b, `csrc/flash_attention_bwd.cu`). A CUDA call whose q, k or
v needs a gradient runs through `FlashAttention`, a
`torch.autograd.Function`: K3 forward, asked for each row's log-sum-exp L
([S, H] f32, written beside the same output bits), and K3b backward (dQ,
dK, dV of K3's function in f32 from dO, K3's output and its L, on the
tensor cores, up to Dh 256; `bwd_plan` gives its streamed tile, dK/dV
column slices and blocks per SM, `bwd_parts` its split of the query
tiles).
A CPU tensor keeps `flash_attention_plain`, which autograd differentiates.
A gradient under a logit soft cap, sinks or an INT8 cache (K4) raises
NotImplementedError on the card (`grad_unsupported`).
`flash_attention_bwd_plain` is K3b's plain version and
`flash_attention_lse_plain` that of K3's L; nothing on the main path calls
them.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from ...models.kv_cache import dequantize_rows
from .build import LAUNCHES, check, library

# enough query rows per KV group to fill a block of the kernel; below this
# the einsum path is cheap anyway (the JAX package's FLASH_MIN_ROWS)
FLASH_MIN_ROWS = 64
_HEAD_DIMS = (32, 64, 128, 256)  # the kernel's instantiations (csrc dispatch)
SLICE = 256  # output columns a block of the wide case (Dh > 256) owns
NEG_INF = -1e30
BQ = 64  # query rows per block of the kernel
BK = 64  # KV slots per tile of the kernel

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_ARGTYPES = [_P, _P, _P, _I, _P, _P, _P, _I, _I, _I, _I, _I, _F, _F, _I, _I, _I, _P, _P, _P]
_ARGTYPES_I8 = [_P, _P, _P, _P, _P, _I, _P, _P, _P, _I, _I, _I, _I, _I, _F, _F, _I, _I, _I,
                _P, _P]
_ARGTYPES_BWD = [_P, _P, _P, _I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _I,
                 _I, _P]
BWD_MAX_DH = 256  # K3b's widest instantiation
BWD_BM = 64  # rows a K3b block owns: query rows (dQ launch), keys (dK/dV launch)
_SMS: dict[int, int] = {}


def head_dim_instance(dh: int, instances=_HEAD_DIMS) -> int | None:
    """The instantiation a head dim runs in: the smallest of `instances`
    at least `dh`, and past the widest (256) the widest itself, in
    `column_slices(dh)` slices; None unless dh is a positive multiple of 8."""
    if dh <= 0 or dh % 8:
        return None
    return next((i for i in instances if i >= dh), instances[-1])


def column_slices(dh: int) -> int:
    """Blocks the kernel gives each row tile (K3/K4) or (slot, group)
    (K5/K6): one up to Dh 256, else one per 256 output columns."""
    return -(-dh // SLICE) if dh > SLICE else 1


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


def launch_split_plan(s: int, h: int, g: int, c: int, dh: int,
                      num_sms: int) -> tuple[int, int]:
    """The wrapper's `split_plan`: past Dh 256 every (row tile, group)
    block is `column_slices(dh)` blocks, so the plan fills a card of that
    many times fewer SMs."""
    return split_plan(s, h, g, c, -(-num_sms // column_slices(dh)))


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


def grad_unsupported(logit_soft_cap=None, sinks=None, quantized: bool = False) -> str | None:
    """Why K3b cannot give this call's gradient (None if it can): it
    differentiates K3 over a bf16 or f32 cache with neither a logit soft
    cap nor sinks."""
    if quantized:
        return "an INT8 KV cache (K4)"
    if logit_soft_cap is not None:
        return "a logit soft cap"
    if sinks is not None:
        return "attention sinks"
    return None


def flash_attention(q, k_cache, v_cache, q_positions, *, scale,
                    sliding_window_size=None, logit_soft_cap=None,
                    sinks=None, k_scales=None, v_scales=None) -> torch.Tensor:
    if q.device.type == "cpu":
        return flash_attention_plain(
            q, k_cache, v_cache, q_positions, scale=scale,
            sliding_window_size=sliding_window_size,
            logit_soft_cap=logit_soft_cap, sinks=sinks,
            k_scales=k_scales, v_scales=v_scales)
    needs_grad = torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in (q, k_cache, v_cache, sinks))
    if not needs_grad:
        return _launch(q, k_cache, v_cache, q_positions, scale=scale,
                       sliding_window_size=sliding_window_size,
                       logit_soft_cap=logit_soft_cap, sinks=sinks,
                       k_scales=k_scales, v_scales=v_scales)
    why = grad_unsupported(logit_soft_cap, sinks, k_scales is not None or v_scales is not None)
    if why is not None:
        raise NotImplementedError(f"flash_attention: no gradient kernel (K3b) under {why}")
    return FlashAttention.apply(q, k_cache, v_cache, q_positions, float(scale),
                                sliding_window_size)


class FlashAttention(torch.autograd.Function):
    """K3 forward and K3b backward of a CUDA call (no soft cap, sinks or
    INT8 cache). The forward asks K3 for each row's log-sum-exp and saves
    it with q, k, v, the positions and K3's output; the gradients come back
    in the inputs' dtypes."""

    @staticmethod
    def forward(ctx, q, k_cache, v_cache, q_positions, scale, sliding_window_size):
        lse = torch.empty(q.shape[:2], dtype=torch.float32, device=q.device)
        out = _launch(q, k_cache, v_cache, q_positions, scale=scale,
                      sliding_window_size=sliding_window_size, lse=lse)
        ctx.save_for_backward(q, k_cache, v_cache, q_positions, out, lse)
        ctx.scale, ctx.window = scale, sliding_window_size
        return out

    @staticmethod
    def backward(ctx, d_out):
        q, k_cache, v_cache, q_positions, out, lse = ctx.saved_tensors
        # the forward checked and allocated what it saved
        dq, dk, dv = _launch_bwd(q, k_cache, v_cache, q_positions, out, d_out, lse,
                                 ctx.scale, ctx.window)
        return (dq.to(q.dtype), dk.to(k_cache.dtype), dv.to(v_cache.dtype), None, None, None)


def _masked_scores(q, k_cache, q_positions, scale, sliding_window_size):
    """The scaled scores [G, rep, S, C] in f32 with -inf outside each row's
    visible keys, and that mask."""
    s, h, dh = q.shape
    c, g, _ = k_cache.shape
    qf = q.float().reshape(s, g, h // g, dh)
    scores = torch.einsum("sgrd,cgd->grsc", qf, k_cache.float()) * scale
    qpos = q_positions[0].to(torch.int64) + torch.arange(s, device=q.device)
    kpos = torch.arange(c, device=q.device)
    valid = kpos[None, :] <= qpos[:, None]
    if sliding_window_size is not None:
        valid = valid & (kpos[None, :] > qpos[:, None] - sliding_window_size)
    return scores.masked_fill(~valid, float("-inf")), valid


def flash_attention_lse_plain(q, k_cache, v_cache, q_positions, *, scale,
                              sliding_window_size=None) -> torch.Tensor:
    """K3's L, plainly: f32 [S, H], each row's logsumexp over its visible
    keys of the scaled scores (no soft cap or sinks; -inf for a row that
    sees no key). v_cache is unused; it keeps K3's argument order."""
    s, h, _ = q.shape
    scores, _ = _masked_scores(q, k_cache, q_positions, scale, sliding_window_size)
    return torch.logsumexp(scores, dim=-1).permute(2, 0, 1).reshape(s, h)


def flash_attention_bwd_plain(q, k_cache, v_cache, q_positions, out, d_out, *, scale,
                              sliding_window_size=None, lse=None):
    """K3b's plain version: (dq [S, H, Dh], dk, dv [C, G, Dh]) f32 of K3's
    function (no soft cap or sinks), with L the given `lse` [S, H] or, when
    None, recomputed, and D_i = rowsum(dO_i * O_i) from the given output,
    all math in f32."""
    s, h, dh = q.shape
    c, g, _ = k_cache.shape
    rep = h // g
    qf = q.float().reshape(s, g, rep, dh)
    kf, vf = k_cache.float(), v_cache.float()
    do = d_out.float().reshape(s, g, rep, dh)
    scores, valid = _masked_scores(q, k_cache, q_positions, scale, sliding_window_size)
    if lse is None:
        lse = torch.logsumexp(scores, dim=-1, keepdim=True)
    else:
        lse = lse.float().reshape(s, g, rep).permute(1, 2, 0)[..., None]
    p = torch.exp(scores - lse).masked_fill(~valid, 0.0)  # [G, rep, S, C]
    delta = (do * out.float().reshape(s, g, rep, dh)).sum(-1)  # [S, G, rep]
    dp = torch.einsum("sgrd,cgd->grsc", do, vf)
    ds = p * (dp - delta.permute(1, 2, 0)[..., None])
    dq = torch.einsum("grsc,cgd->sgrd", ds, kf) * scale
    dk = torch.einsum("grsc,sgrd->cgd", ds, qf) * scale
    dv = torch.einsum("grsc,sgrd->cgd", p, do)
    return dq.reshape(s, h, dh), dk, dv


class BwdPlan(NamedTuple):
    """What K3b's wrapper needs of an instantiation's launch shapes (csrc
    `Plan`, reported by `uz_flash_attention_bwd_plan`)."""
    tile: int  # rows of a streamed tile: keys in the dQ launch, query rows in dK/dV's
    dkdv_slices: int  # dK/dV column slices (blocks per 64-key tile and part)
    blocks_per_sm: int  # dK/dV blocks that share one SM (the block's shared memory)


# csrc Plan<f32, instantiation>: tiles of 64 (32 for f32 at Dh 256, so
# one ring stage of hi + lo fits), a dK/dV block owning 64 columns of each
# of dK and dV (Dh 128: 2 slices, 256: 4), three blocks a SM up to Dh 64
# for bf16 inputs, two for f32
_BWD_PLANS = {
    (32, False): BwdPlan(64, 1, 3), (32, True): BwdPlan(64, 1, 2),
    (64, False): BwdPlan(64, 1, 3), (64, True): BwdPlan(64, 1, 2),
    (128, False): BwdPlan(64, 2, 1), (128, True): BwdPlan(64, 2, 1),
    (256, False): BwdPlan(64, 4, 1), (256, True): BwdPlan(32, 4, 1),
}


@functools.lru_cache(maxsize=None)
def bwd_plan(dh: int, f32: bool = False) -> BwdPlan:
    """K3b's plan at a head dim and input dtype (f32: q, k and v as bf16
    hi + lo pairs): that of the instantiation that takes dh."""
    inst = head_dim_instance(dh)
    if inst is None or dh > BWD_MAX_DH:
        raise ValueError(f"K3b takes Dh a positive multiple of 8 up to {BWD_MAX_DH}, not {dh}")
    return _BWD_PLANS[inst, bool(f32)]


@functools.lru_cache(maxsize=256)
def bwd_parts(s: int, h: int, g: int, c: int, dh: int, num_sms: int,
              f32: bool = False) -> int:
    """The parts K3b's dK/dV launch cuts the query tiles into: enough that
    the (key tile, group, column slice, part) blocks fill the SMs at the
    plan's blocks per SM, each part at least one query tile, none empty.
    Shapes only."""
    plan = bwd_plan(dh, f32)
    row_tiles = -(-s * (h // g) // plan.tile)
    blocks = -(-c // BWD_BM) * g * plan.dkdv_slices
    parts = min(row_tiles, max(1, -(-plan.blocks_per_sm * num_sms // blocks)))
    per = -(-row_tiles // parts)
    return -(-row_tiles // per)


def bwd_scratch_bytes(s: int, h: int, g: int, c: int, dh: int, f32: bool, parts: int) -> int:
    """K3b's scratch, in the kernel's order of 256-byte aligned pieces: D
    (f32 [S, H]), dO as bf16 hi + lo, for f32 q, k and v as bf16 hi + lo,
    and with parts > 1 the partial dK and dV."""
    def piece(n: int) -> int:
        return -(-n // 256) * 256

    nq, nkv = s * h * dh, c * g * dh
    total = piece(4 * s * h) + 2 * piece(2 * nq)
    if f32:
        total += 2 * piece(2 * nq) + 4 * piece(2 * nkv)
    if parts > 1:
        total += 2 * piece(4 * parts * nkv)
    return total


def flash_attention_bwd(q, k_cache, v_cache, q_positions, out, d_out, *, scale,
                        sliding_window_size=None, lse=None):
    """K3b: (dq [S, H, Dh], dk, dv [C, G, Dh]) f32. A CPU tensor takes
    `flash_attention_bwd_plain`; a CUDA one launches the kernel or raises.
    `lse` is K3's L [S, H] of the same call; on the card without it, one K3
    launch that asks for L computes it first."""
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k_cache, v_cache, q_positions, out, d_out,
                                         scale=scale, sliding_window_size=sliding_window_size,
                                         lse=lse)
    s, h, dh = q.shape
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_bwd: unsupported device {q.device}")
    if (k_cache.shape != v_cache.shape or k_cache.shape[2] != dh or h % k_cache.shape[1]
            or out.shape != q.shape or d_out.shape != q.shape or q_positions.numel() < 1
            or (lse is not None and tuple(lse.shape) != (s, h))):
        raise ValueError(f"flash_attention_bwd: q {tuple(q.shape)}, k {tuple(k_cache.shape)}, "
                         f"v {tuple(v_cache.shape)}, out {tuple(out.shape)}, d_out "
                         f"{tuple(d_out.shape)}, lse {None if lse is None else tuple(lse.shape)}"
                         f" do not fit together")
    if head_dim_instance(dh) is None or dh > BWD_MAX_DH:
        raise NotImplementedError(f"flash_attention_bwd: Dh {dh} (K3b takes multiples of 8 "
                                  f"up to {BWD_MAX_DH})")
    if q.dtype not in (torch.bfloat16, torch.float32) or k_cache.dtype != q.dtype \
            or v_cache.dtype != q.dtype:
        raise ValueError("flash_attention_bwd: q, k and v must be one dtype, bf16 or f32")
    for t in (k_cache, v_cache, out, d_out) + (() if lse is None else (lse,)):
        if t.device != q.device:
            raise ValueError("flash_attention_bwd: every tensor must be on one device")
    k_cache, v_cache = _aligned(k_cache), _aligned(v_cache)
    if lse is None:
        lse = torch.empty((s, h), dtype=torch.float32, device=q.device)
        _launch(q, k_cache, v_cache, q_positions, scale=scale,
                sliding_window_size=sliding_window_size, lse=lse)
    return _launch_bwd(q, k_cache, v_cache, q_positions, out.float(), d_out,
                       _aligned(lse.float()), scale, sliding_window_size)


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """t contiguous and 16-byte aligned: itself where it is, else a copy."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _launch_bwd(q, k_cache, v_cache, q_positions, out, d_out, lse, scale, window):
    """One K3b launch on CUDA tensors that fit together, with k, v and lse
    (f32) contiguous and 16-byte aligned, as K3's forward left them; q, out
    and d_out (f32) are made so here."""
    s, h, dh = q.shape
    c, g, _ = k_cache.shape
    q, out, d_out = _aligned(q), _aligned(out), _aligned(d_out.float())
    qpos = q_positions.to(device=q.device, dtype=torch.int32).contiguous()
    dq = torch.empty((s, h, dh), dtype=torch.float32, device=q.device)
    dk = torch.empty((c, g, dh), dtype=torch.float32, device=q.device)
    dv = torch.empty_like(dk)
    f32 = q.dtype == torch.float32
    parts = bwd_parts(s, h, g, c, dh, num_sms(q.device), f32)
    scratch = torch.empty(bwd_scratch_bytes(s, h, g, c, dh, f32, parts), dtype=torch.uint8,
                          device=q.device)
    if s and c:
        with torch.cuda.device(q.device):
            stream = torch.cuda.current_stream().cuda_stream
            rc = _lib_bwd()(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), int(not f32),
                            qpos.data_ptr(), out.data_ptr(), d_out.data_ptr(),
                            lse.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                            scratch.data_ptr(), s, h, g, c, dh, float(scale), int(window or 0),
                            parts, stream)
        check(rc, "flash_attention_bwd")
        LAUNCHES["flash_attention_bwd"] += 1
    return dq, dk, dv


def _lib_bwd():
    fn = library("flash_attention_bwd").uz_flash_attention_bwd
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES_BWD
        fn.restype = _I
    return fn


def _launch(q, k_cache, v_cache, q_positions, *, scale, sliding_window_size=None,
            logit_soft_cap=None, sinks=None, k_scales=None, v_scales=None,
            lse=None) -> torch.Tensor:
    """One K3/K4 launch on CUDA tensors (no autograd). `lse`, an f32 [S, H]
    tensor (K3 only), receives each row's log-sum-exp of its scaled scores
    (sinks left out); the output's bits do not depend on it."""
    s, h, dh = q.shape
    c, g, _ = k_cache.shape
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    if k_cache.shape != v_cache.shape or k_cache.shape[2] != dh or q_positions.numel() < 1:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k {tuple(k_cache.shape)}, "
                         f"v {tuple(v_cache.shape)} do not fit together")
    if h % g or head_dim_instance(dh) is None:
        raise ValueError(f"flash_attention kernel needs H % G == 0 and Dh a positive "
                         f"multiple of 8 (H={h}, G={g}, Dh={dh})")
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
    if lse is not None:
        if quantized or tuple(lse.shape) != (s, h) or lse.dtype != torch.float32:
            raise ValueError("flash_attention: lse is K3's f32 [S, H] (not K4's)")
        tensors.append(lse)
    for t in tensors:
        if not t.is_contiguous() or t.data_ptr() % 16 or t.device != q.device:
            raise ValueError("flash_attention: q/k/v/scales must be contiguous, 16-byte "
                             "aligned and on one device")
    qpos = q_positions.to(device=q.device, dtype=torch.int32).contiguous()
    sk = None
    if sinks is not None:
        sk = sinks.to(device=q.device, dtype=torch.float32).contiguous()
    out = torch.empty((s, h, dh), dtype=torch.float32, device=q.device)
    splits, per = launch_split_plan(s, h, g, c, dh, num_sms(q.device))
    scratch = None
    if splits > 1:
        scratch = torch.empty(splits * s * h * (dh + 2), dtype=torch.float32, device=q.device)
    tail = (qpos.data_ptr(), None if sk is None else sk.data_ptr(), out.data_ptr(),
            s, h, g, c, dh, float(scale), float(logit_soft_cap or 0.0),
            int(sliding_window_size or 0), splits, per,
            None if scratch is None else scratch.data_ptr())
    lse_ptr = None if lse is None else lse.data_ptr()
    is_bf16 = int(q.dtype == torch.bfloat16)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        if quantized:
            rc = _lib(True)(q.data_ptr(), k_cache.data_ptr(), k_scales.data_ptr(),
                            v_cache.data_ptr(), v_scales.data_ptr(), is_bf16, *tail, stream)
        else:
            rc = _lib()(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), is_bf16,
                        *tail, lse_ptr, stream)
    name = "flash_attention_int8" if quantized else "flash_attention"
    check(rc, name)
    LAUNCHES[name] += 1
    return out
