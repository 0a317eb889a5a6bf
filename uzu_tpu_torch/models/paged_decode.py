"""Batched decode step and prefill chunk over a paged KV cache.

Counterpart of `uzu_tpu/models/paged_decode.py` (the decode step, the
prefill chunk and the speculative verify step). Per layer, the rows run
the dense path's projections, norms and MLP (`models/decoder.py` helpers;
rows are independent), the new K/V rows go into the shared page pools
with one indexed write per pool tensor, and attention reads through the
page tables:

- decode: B slots advance one token each; attention is K5/K6
  (`ops/cuda/paged_attention.py`), which walks each slot's live pages;
- verify: B slots advance S rows each, with logits at every row; every
  row's K/V is written first, then one K5/K6 launch per layer reads the
  B*S rows, each slot's table repeated S times and row i's length its
  position + 1, which is causal within the block (the JAX package reads
  a gathered dense view per slot instead, as the prefill does);
- prefill: S rows of one slot; attention reads a dense slot-per-position
  view gathered from the slot's first `ctx_pages` pages, through K3 (bf16
  pools) or K4 (INT8 pools, codes + scales) where the flash gate holds.

Pools are updated in place. Every page table's trash page takes the rows
that must land nowhere: a prefill chunk's padded rows go to the table's
sentinel entry, and in the decode and verify steps a row whose logical
page lies past the (cut) table's width writes through the table's last
column, which the engine keeps pointing at the trash page; a verify slot
with `valid` False writes only there.
"""

from __future__ import annotations

import torch

from ..config.model import AttentionConfig, DecoderConfig
from ..ops.attention import attention_reference
from ..ops.cuda.paged_attention import paged_decode_attention
from .decoder import attention_output, embed, project_qkv, readout, residual_block
from .paged_kv import write_rows


def paged_supported(cfg: DecoderConfig) -> bool:
    """Attention-only models whose features the paged paths implement:
    value-head norm and non-causal layers need the dense path."""
    if cfg.ple_model_config is not None:
        return False
    for lc in cfg.transformer_config.layer_configs:
        m = lc.mixer_config
        if not isinstance(m, AttentionConfig) or lc.ple_config is not None:
            return False
        if m.normalize_values or not m.is_causal:
            return False
    return True


def _scale(cfg: AttentionConfig) -> float:
    return cfg.scale if cfg.scale is not None else float(cfg.head_dim) ** -0.5


def _split(pool):
    """(k, k_scales, v, v_scales) of a bf16 (scales None) or INT8 pool."""
    if len(pool) == 4:
        return pool
    return pool[0], None, pool[1], None


def _attention_paged(cfg, layer_cfg, params, x, positions, pool_kv, pages, offsets,
                     tables, lengths, shared_kv=None):
    """x [B, D], one token per slot -> (attn_out [B, D], the layer's pool).

    pages/offsets [B]: where each slot's new K/V row goes; tables [B, W];
    lengths [B]: tokens visible after the write. A KV-sharing layer passes
    its source layer's already written pool as `shared_kv`."""
    q, k_new, v_new = project_qkv(cfg, layer_cfg, params, x, positions)
    if shared_kv is None:
        write_rows(pool_kv, k_new, v_new, pages, offsets)
        read_pool = pool_kv
    else:
        read_pool = shared_kv
    k_pool, k_s, v_pool, v_s = _split(read_pool)
    attn = paged_decode_attention(
        q, k_pool, v_pool, tables, lengths, scale=_scale(cfg),
        logit_soft_cap=cfg.logit_soft_cap, sliding_window_size=cfg.sliding_window_size,
        sinks=params.get("sinks"), k_scales=k_s, v_scales=v_s)
    attn = attn.to(q.dtype).reshape(x.shape[0], -1)
    return attention_output(params, x, attn), (None if shared_kv is not None else pool_kv)


def _attention_paged_prefill(cfg, layer_cfg, params, x, positions, pool_kv, table,
                             ctx_pages: int, true_length: int, shared_kv=None):
    """S rows of ONE slot straight into its pages. Row i writes at
    (table[pos // page], pos % page); rows at or past `true_length` go to
    the trash page in the table's sentinel entry table[-1]. The read is the
    slot's first `ctx_pages` pages gathered into a contiguous [C, G, Dh]
    view (codes + scales for an INT8 pool) through the dense attention
    core, so the paged prefill computes what the dense engine's does."""
    s = x.shape[0]
    q, k_new, v_new = project_qkv(cfg, layer_cfg, params, x, positions)
    if shared_kv is None:
        page = pool_kv[0].shape[2]
        maxp = table.shape[0] - 1
        valid = torch.arange(s, device=x.device) < true_length
        logical = torch.clamp(positions.long() // page, 0, maxp - 1)
        pidx = torch.where(valid, table[logical], table[maxp])
        write_rows(pool_kv, k_new, v_new, pidx, positions % page)
        read_pool = pool_kv
    else:
        read_pool = shared_kv
    sel = table[:ctx_pages].long()

    def dense(t):  # [G, P, page, ...] -> contiguous [ctx_pages * page, G, ...]
        v = t.index_select(1, sel)
        return v.reshape(v.shape[0], -1, *v.shape[3:]).transpose(0, 1).contiguous()

    k_pool, k_s, v_pool, v_s = _split(read_pool)
    scales = {}
    if k_s is not None:
        scales = {"k_scales": dense(k_s), "v_scales": dense(v_s)}
    attn = attention_reference(
        q, dense(k_pool), dense(v_pool), positions, scale=_scale(cfg), is_causal=True,
        sliding_window_size=cfg.sliding_window_size, logit_soft_cap=cfg.logit_soft_cap,
        sinks=params.get("sinks"), **scales)
    return (attention_output(params, x, attn.reshape(s, -1)),
            None if shared_kv is not None else pool_kv)


def _layers(cfg: DecoderConfig, params: dict, x: torch.Tensor, pools: list, attend):
    """Run every layer with `attend(layer_cfg, params, h, pool, shared)` as
    the mixer; KV-sharing layers read their source layer's pool."""
    owned = []
    for i, layer_cfg in enumerate(cfg.transformer_config.layer_configs):
        src = layer_cfg.kv_source_layer_index
        p = params["layers"][i]
        shared = owned[src] if src is not None else None
        x, pool = residual_block(layer_cfg, p, x, lambda h: attend(
            layer_cfg, p["mixer"], h, pools[i], shared))
        owned.append(pool)
    return x


def paged_prefill_chunk(
    cfg: DecoderConfig,
    params: dict,
    pools: list,  # per-layer pool tuples (None on KV-sharing layers)
    tokens: torch.Tensor,  # [S] one slot's (end-padded) prompt chunk
    table: torch.Tensor,  # [MAXP + 1] int32, entry MAXP (and unused ones) = trash
    pos0: int,  # absolute position of row 0
    true_length: int,  # real rows in the chunk
    ctx_pages: int,  # pages of context visible to this chunk
) -> torch.Tensor:
    """One prefill chunk of one slot written into the pools in place;
    returns the last real row's logits [V] f32."""
    s = tokens.shape[0]
    positions = pos0 + torch.arange(s, dtype=torch.int32, device=tokens.device)

    def attend(layer_cfg, p, h, pool, shared):
        return _attention_paged_prefill(layer_cfg.mixer_config, layer_cfg, p, h, positions,
                                        pool, table, ctx_pages, true_length, shared)

    x = _layers(cfg, params, embed(cfg, params, tokens), pools, attend)
    return readout(cfg, params, x[true_length - 1:true_length])[0]


def paged_decode_step(
    cfg: DecoderConfig,
    params: dict,
    pools: list,
    tokens: torch.Tensor,  # [B] input token per slot
    tables: torch.Tensor,  # [B, W] int32; column W-1 must be the trash page
    positions: torch.Tensor,  # [B] absolute position of each input token
) -> torch.Tensor:
    """Advance every slot one token: append each input token's K/V at its
    position and attend over lengths = positions + 1. Returns logits
    [B, V] f32; the pools are updated in place.

    A slot's logical page is looked up with its column clamped to the
    table's last one, so a free slot parked at a position past the (cut)
    table writes to the trash page, never into a live slot's page."""
    page = next(p for p in pools if p is not None)[0].shape[2]
    col = torch.clamp(positions.long() // page, max=tables.shape[1] - 1)
    pages = tables.gather(1, col[:, None])[:, 0]
    offsets = positions % page
    lengths = positions + 1

    def attend(layer_cfg, p, h, pool, shared):
        return _attention_paged(layer_cfg.mixer_config, layer_cfg, p, h, positions, pool,
                                pages, offsets, tables, lengths, shared)

    x = _layers(cfg, params, embed(cfg, params, tokens), pools, attend)
    return readout(cfg, params, x)


def verify_columns(positions: torch.Tensor, valid: torch.Tensor, width: int,
                   page: int) -> torch.Tensor:
    """[B, S] table columns of the verify rows' writes in a table of
    `width` columns whose last is the trash page: a row past the cut table
    and every row of an invalid slot go to that column, never to a live
    column of the slot's own table (the JAX package clips such a row to its
    table's last live column; see ROADMAP.md section 3)."""
    col = torch.clamp(positions.long() // page, max=width - 1)
    return torch.where(valid[:, None], col, width - 1)


def paged_verify_step(
    cfg: DecoderConfig,
    params: dict,
    pools: list,
    tokens: torch.Tensor,  # [B, S] verify block per slot (root + drafts)
    tables: torch.Tensor,  # [B, W] int32; column W-1 must be the trash page
    pos0: torch.Tensor,  # [B] absolute position of each slot's row 0
    valid: torch.Tensor,  # [B] bool: False sends every write of the slot to trash
    ctx_pages: int,  # pages of context visible to the reads
) -> torch.Tensor:
    """Advance every slot S tokens at once with logits at every row:
    returns logits [B, S, V] f32; the pools are updated in place. The
    table is cut to its first `ctx_pages` columns plus the trash column;
    the caller advances positions by the accepted length, and rows written
    past it stay invisible behind the lengths until the next round
    overwrites them."""
    b, s = tokens.shape
    page = next(p for p in pools if p is not None)[0].shape[2]
    if ctx_pages < tables.shape[1] - 1:
        tables = torch.cat([tables[:, :ctx_pages], tables[:, -1:]], dim=1)
    positions = pos0.to(torch.int32)[:, None] + torch.arange(
        s, dtype=torch.int32, device=tokens.device)[None, :]
    col = verify_columns(positions, valid.to(tokens.device), tables.shape[1], page)
    pages = tables.gather(1, col).reshape(-1)
    flat = positions.reshape(-1)
    offsets = flat % page
    rows_tables = tables.repeat_interleave(s, dim=0)  # [B*S, W]
    lengths = flat + 1

    def attend(layer_cfg, p, h, pool, shared):
        return _attention_paged(layer_cfg.mixer_config, layer_cfg, p, h, flat, pool,
                                pages, offsets, rows_tables, lengths, shared)

    x = _layers(cfg, params, embed(cfg, params, tokens.reshape(-1)), pools, attend)
    return readout(cfg, params, x).reshape(b, s, -1)
