"""Batched decode step over dense per-slot states.

The dense `BatchEngine` (`engine/batch.py`) keeps one decoding state per
slot stacked on a leading [B] dimension: KV caches [B, C, G, Dh] (or INT8
codes and scales), recurrent states [B, ...] and positions [B]. The JAX
package maps its single-sequence decoder over the slots; here one step
runs every slot's token as a row of one [B, D] activation, so each linear
is one product at M = B (K1's small route for quantized weights, whose
rows are bitwise the M = 1 rows), and:

- attention writes each slot's new K/V row at that slot's position (a
  ring: at position % c, recording the position in the slot's "pos" row)
  and reads the slot's own cache up to its position, masked by the
  per-slot positions on a ring (`attention_block_batched` at S = 1,
  plain einsums, as the JAX decode is an einsum);
- recurrent mixers advance [B, ...] states (`ssm_forward_batched` at S = 1);
- a slot with `fed` 0 (halted or free) takes an identity transition: its
  position stays, its recurrent state is unchanged, and its K/V write
  lands at its position, which no read of that slot sees before it is
  written again.

The speculative batch engine's verify (`batch_verify_step`) runs S = m+1
rows per slot the same way: every linear is one product over the B*S flat
rows (past K1's small route at the engines' shapes, so its rows are not
bitwise the decode step's), attention writes rows pos..pos+S-1 of each
slot and reads the slot's own cache causally (the same `_attend`), and
recurrent mixers defer (`ssm_forward_batched(defer=True)`):
`batch_commit_deferred` then commits each slot to its own accepted length
(`ssm_commit_batched`; a halted slot commits 0, an identity transition).
Neither has a host sync.

Caches are updated in place; recurrent states and positions come back as
new tensors in the returned state.
"""

from __future__ import annotations

import torch

from ..config.model import AttentionConfig, DecoderConfig
from ..ops.attention import attention_block_batched
from .decoder import (
    attention_output,
    embed,
    ple_apply,
    ple_layer_inputs,
    project_qkv,
    readout,
    residual_block,
)
from .kv_cache import is_quantized, is_ring, quantize_rows
from .ssm import ssm_commit_batched, ssm_forward_batched


def _write_block(cache: dict, k_new: torch.Tensor, v_new: torch.Tensor,
                 positions: torch.Tensor) -> None:
    """Rows [B, S, G, Dh] into cache[b, positions[b, i]] (clamped into the
    cache, as the single-sequence append clamps its start); on a ring into
    cache[b, positions[b, i] % c], with pos[b, that slot] = the position.
    One write per cache tensor: within a slot the positions are distinct,
    so no two rows land on one cache row."""
    b, s = positions.shape
    c = next(iter(cache.values())).shape[1]
    rows = torch.arange(b, device=k_new.device).repeat_interleave(s)
    flat = positions.reshape(-1)
    k_new, v_new = k_new.reshape(b * s, *k_new.shape[2:]), v_new.reshape(b * s, *v_new.shape[2:])
    if is_quantized(cache):
        (k_q, k_s), (v_q, v_s) = quantize_rows(k_new), quantize_rows(v_new)
        new = {"k_q": k_q, "k_s": k_s, "v_q": v_q, "v_s": v_s}
    else:
        new = {"k": k_new, "v": v_new}
    if is_ring(cache):
        idx = flat.long() % c
        new["pos"] = flat.to(torch.int32)
    else:
        idx = torch.clamp(flat.long(), 0, c - 1)
    for name, t in new.items():
        cache[name].index_put_((rows, idx), t.to(cache[name].dtype))


def _attend(cfg: AttentionConfig, layer_cfg, params: dict, x: torch.Tensor,
            positions: torch.Tensor, cache: dict, owns: bool, ctx_limit):
    """x [B*S, D] at positions [B, S] (S = 1 in the decode step): write
    every row, then attend."""
    b, s = positions.shape
    q, k_new, v_new = project_qkv(cfg, layer_cfg, params, x, positions.reshape(-1))
    if owns:
        _write_block(cache, k_new.reshape(b, s, *k_new.shape[1:]),
                     v_new.reshape(b, s, *v_new.shape[1:]), positions)
    read = cache
    c_full = next(iter(cache.values())).shape[1]
    # a ring is already compact and is read whole, masked by its positions
    if ctx_limit is not None and ctx_limit < c_full and not is_ring(cache):
        read = {name: t[:, :ctx_limit] for name, t in cache.items()}
    if is_quantized(read):
        k, v = read["k_q"], read["v_q"]
        scales = {"k_scales": read["k_s"], "v_scales": read["v_s"]}
    else:
        k, v, scales = read["k"], read["v"], {}
    scale = cfg.scale if cfg.scale is not None else float(cfg.head_dim) ** -0.5
    attn = attention_block_batched(
        q.reshape(b, s, *q.shape[1:]), k, v, positions, scale=scale,
        sliding_window_size=cfg.sliding_window_size, logit_soft_cap=cfg.logit_soft_cap,
        sinks=params.get("sinks"), kv_positions=read.get("pos"), **scales)
    return attention_output(params, x, attn.reshape(b * s, -1)), cache if owns else None


def batch_decode_step(
    cfg: DecoderConfig,
    params: dict,
    tokens: torch.Tensor,  # [B] input token per slot
    state: dict,  # batched: {"layers": [...], "pos": [B] int32}
    fed: torch.Tensor,  # [B] int32: 1 where the slot advances, 0 where it halts
    ctx_limit: int | None = None,  # attention reads cache slots [0, ctx_limit)
):
    """Advance every slot one token; returns (logits [B, V] f32, state)."""
    positions = state["pos"]
    x = embed(cfg, params, tokens)
    per_layer = ple_layer_inputs(cfg, params, tokens, x)
    new_layers = []
    for i, layer_cfg in enumerate(cfg.transformer_config.layer_configs):
        m = layer_cfg.mixer_config
        p = params["layers"][i]
        layer_state = state["layers"][i]
        if isinstance(m, AttentionConfig):
            src = layer_cfg.kv_source_layer_index
            owns = layer_state is not None
            cache = layer_state if owns else new_layers[src]
            x, new = residual_block(layer_cfg, p, x, lambda h: _attend(
                m, layer_cfg, p["mixer"], h, positions[:, None], cache, owns, ctx_limit))
        else:
            def recurrent(h):
                out, new_state = ssm_forward_batched(m, p["mixer"], h[:, None], layer_state,
                                                     fed, layer=i)
                return out[:, 0], new_state

            x, new = residual_block(layer_cfg, p, x, recurrent)
        x = ple_apply(layer_cfg, p, x, None if per_layer is None else per_layer[:, i])
        new_layers.append(new)
    logits = readout(cfg, params, x)
    return logits, {"layers": new_layers, "pos": positions + fed}


def batch_verify_step(
    cfg: DecoderConfig,
    params: dict,
    tokens: torch.Tensor,  # [B, S] verify block per slot (root + drafts)
    state: dict,  # batched: {"layers": [...], "pos": [B] int32}
    ctx_limit: int | None = None,  # attention reads cache slots [0, ctx_limit)
):
    """Every slot's S-row block at positions pos..pos+S-1 with logits at
    every row: returns (logits [B, S, V] f32, pending). Attention caches
    are written in place; `pending` holds the recurrent mixers' replay
    inputs and the unchanged positions, for `batch_commit_deferred`."""
    b, s = tokens.shape
    positions = state["pos"].to(torch.int32)[:, None] + torch.arange(
        s, dtype=torch.int32, device=tokens.device)[None, :]
    flat = tokens.reshape(-1)
    x = embed(cfg, params, flat)
    per_layer = ple_layer_inputs(cfg, params, flat, x)
    new_layers = []
    for i, layer_cfg in enumerate(cfg.transformer_config.layer_configs):
        m = layer_cfg.mixer_config
        p = params["layers"][i]
        layer_state = state["layers"][i]
        if isinstance(m, AttentionConfig):
            src = layer_cfg.kv_source_layer_index
            owns = layer_state is not None
            cache = layer_state if owns else new_layers[src]
            x, new = residual_block(layer_cfg, p, x, lambda h: _attend(
                m, layer_cfg, p["mixer"], h, positions, cache, owns, ctx_limit))
        else:
            def recurrent(h):
                out, aux = ssm_forward_batched(m, p["mixer"], h.reshape(b, s, -1), layer_state,
                                               s, defer=True)
                return out.reshape(b * s, -1), aux

            x, new = residual_block(layer_cfg, p, x, recurrent)
        x = ple_apply(layer_cfg, p, x, None if per_layer is None else per_layer[:, i])
        new_layers.append(new)
    logits = readout(cfg, params, x).reshape(b, s, -1)
    return logits, {"layers": new_layers, "pos": state["pos"]}


def batch_commit_deferred(cfg: DecoderConfig, pending: dict, commit: torch.Tensor) -> dict:
    """A `batch_verify_step` resolved into a batched state committed to
    `commit` [B] tokens per slot: attention layers are already written
    (positions govern visibility), recurrent layers replay their accepted
    prefixes, positions advance by the commits."""
    layers = []
    for layer_cfg, entry in zip(cfg.transformer_config.layer_configs, pending["layers"]):
        if entry is not None and not isinstance(layer_cfg.mixer_config, AttentionConfig):
            entry = ssm_commit_batched(layer_cfg.mixer_config, entry, commit)
        layers.append(entry)
    pos = pending["pos"]
    return {"layers": layers, "pos": (pos + commit).to(pos.dtype)}
