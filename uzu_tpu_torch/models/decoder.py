"""Decoder forward pass built from the config.

Counterpart of `uzu_tpu/models/decoder.py`. One code path serves prefill
chunks and decode steps: tokens carry absolute positions derived from
state["pos"] (a device tensor), the KV cache is slot-per-position, and
causal masking makes end-padding invisible (padded rows sit at future
slots that later writes overwrite; a sliding-window ring layout is
compact, drops padded rows at write time and is read whole). Recurrent
mixers (`models/ssm.py`) take `true_length` and turn padded rows into
identity transitions. Speculative verification passes `defer_ssm`
(recurrent mixers return replay inputs, committed later by
`decoder_commit_deferred`) and, for a token tree, `positions` (RoPE
positions pos + depth), `tree_mask` (the ancestor matrix; node i is
written to slot pos + i) and, on recurrent mixers, `tree_parents` and
`tree_conv_src`. Sequence-parallel prefill (`parallel/seqpar.py`) passes
`seq_group`: each rank holds a slice of the chunk's rows, and K/V and
their positions are all-gathered over the group before the cache append,
so every rank's cache holds the whole chunk and its queries see the whole
context.

Residual discipline:
    h = pre_mixer_norm(x)            (layer 0 may have no pre-norm)
    a = post_mixer_norm(mixer(h))
    x = (x + a) * post_layer_scalar?
    m = post_mlp_norm(mlp(pre_mlp_norm(x))) * post_layer_scalar?
    x = x + m
    x = ple_project(x, per_layer_input)   (PLE layers; post_layer_scalar
                                           goes here instead of above)
"""

from __future__ import annotations

from functools import lru_cache

import torch

from ..config.model import (
    AttentionConfig,
    DecoderConfig,
    DenseMLPConfig,
    MixtureOfExpertsConfig,
    TransformerLayerConfig,
)
from ..ops.activation import gated_act_mul
from ..ops.attention import attention_reference
from ..ops.linear import linear_apply
from ..ops.norm import normalize
from ..ops.rope import apply_rope, inverse_frequencies, rope_tables
from ..quant.format import QuantizedTensor, unpack_codes
from .kv_cache import append as kv_append, is_quantized, read as kv_read, read_quantized
from .moe import moe_forward
from .ple import ple_inputs, ple_project
from .ssm import ssm_commit, ssm_forward, ssm_tree_forward


# --------------------------------------------------------------------------
# Embedding
# --------------------------------------------------------------------------


def embedding_lookup(table, tokens: torch.Tensor, dtype=None) -> torch.Tensor:
    """tokens [S] -> [S, D]; quantized tables dequantize only gathered rows."""
    dtype = dtype or table.dtype
    tokens = tokens.long()
    if isinstance(table, QuantizedTensor):
        codes = unpack_codes(table.codes[tokens], table.bits).float()
        g = table.group_size
        k = codes.shape[-1]
        scales = torch.repeat_interleave(table.scales[tokens].float(), g, dim=-1)[:, :k]
        if table.qbias is None:  # symmetric: qbias from the gathered scales
            qbias = scales * table.qbias_coeff
        else:
            qbias = torch.repeat_interleave(table.qbias[tokens].float(), g, dim=-1)[:, :k]
        return (codes * scales + qbias).to(dtype)
    return table[tokens].to(dtype)


def embedding_readout(table, hidden: torch.Tensor, soft_cap: float | None) -> torch.Tensor:
    """hidden [S, D] -> logits [S, V] f32."""
    logits = linear_apply(table, hidden).float()
    if soft_cap is not None:
        logits = soft_cap * torch.tanh(logits / soft_cap)
    return logits


# --------------------------------------------------------------------------
# Attention mixer
# --------------------------------------------------------------------------


@lru_cache(maxsize=None)
def _inv_freq(rope_cfg, device: str) -> tuple[torch.Tensor, float]:
    """Inverse frequencies of one RoPE config, computed once per device."""
    inv, scale = inverse_frequencies(rope_cfg)
    return torch.from_numpy(inv).to(device), scale


def project_qkv(cfg: AttentionConfig, layer_cfg: TransformerLayerConfig, params: dict,
                x: torch.Tensor, positions: torch.Tensor):
    """x [N, D] at positions [N] -> (q [N, H, Dh], k_new, v_new [N, G, Dh]):
    QKV linear, head norms and RoPE. k_new and v_new are None on a
    KV-sharing layer. Rows are independent, so N may be a prefill chunk
    of one sequence or one decode token of each of N slots."""
    n = x.shape[0]
    h, g, dh = cfg.num_heads, cfg.num_groups, cfg.head_dim
    q_dim = h * dh

    qkv = linear_apply(params["qkv"]["w"], x, params["qkv"].get("b"))
    if cfg.is_kv_sharing:
        q = qkv.reshape(n, h, dh)
        k_new = v_new = None
    else:
        q = qkv[:, :q_dim].reshape(n, h, dh)
        k_new = qkv[:, q_dim: q_dim + g * dh].reshape(n, g, dh)
        v_new = qkv[:, q_dim + g * dh:].reshape(n, g, dh)

    if cfg.query_norm_config is not None:
        q = normalize(q, cfg.query_norm_config, params["q_norm_scales"])
    if k_new is not None and cfg.key_norm_config is not None:
        k_new = normalize(k_new, cfg.key_norm_config, params["k_norm_scales"])
    if k_new is not None and cfg.normalize_values:
        v_new = normalize(v_new, cfg.value_norm_config(), params.get("v_norm_scales"))

    if layer_cfg.rope_config is not None:
        inv_freq, attn_scale = _inv_freq(layer_cfg.rope_config, str(x.device))
        cos, sin = rope_tables(inv_freq, attn_scale, positions)
        q = apply_rope(q, cos, sin)
        if k_new is not None:
            k_new = apply_rope(k_new, cos, sin)
    return q, k_new, v_new


def attention_output(params: dict, x: torch.Tensor, attn: torch.Tensor) -> torch.Tensor:
    """attn [N, H*Dh] -> [N, D]: the optional sigmoid gate from x, then
    the out linear."""
    if "gate" in params:
        gate = linear_apply(params["gate"]["w"], x)
        attn = (attn.float() * torch.sigmoid(gate.float())).to(attn.dtype)
    return linear_apply(params["out"]["w"], attn, params["out"].get("b"))


def attention_forward(
    cfg: AttentionConfig,
    layer_cfg: TransformerLayerConfig,
    params: dict,
    x: torch.Tensor,  # [S, D]
    positions: torch.Tensor,  # [S]
    kv,  # own cache dict or shared source cache dict
    owns_cache: bool,
    true_length=None,
    ctx_limit: int | None = None,  # attention reads only cache slots
    # [0, ctx_limit): the cache stays max_context-sized, but a step at
    # position p reads only the smallest bucket covering p
    tree=None,  # (suffix_start, ancestor_mask [S, S]) for tree verification
    seq_group=None,  # sequence-parallel prefill: x/positions are this rank's
    # row slice; K/V are all-gathered over the group before the cache append
):
    s = x.shape[0]
    q, k_new, v_new = project_qkv(cfg, layer_cfg, params, x, positions)
    if owns_cache:
        # tree nodes land at CONSECUTIVE SLOTS suffix_start + node index,
        # not at their positions: siblings share a position
        write_positions = positions if tree is None else tree[0] + torch.arange(
            s, dtype=torch.int32, device=x.device)
        if seq_group is not None and k_new is not None:
            k_new, v_new, write_positions = (
                _gather_rows(t, seq_group) for t in (k_new, v_new, write_positions))
        new_kv = kv_append(kv, k_new, v_new, write_positions, true_length)
    else:
        new_kv = kv

    read_kv = new_kv
    # ring layouts are already compact and are left alone
    if ctx_limit is not None and "pos" not in new_kv:
        c_full = next(iter(new_kv.values())).shape[0]
        if ctx_limit < c_full:
            read_kv = {kk: vv[:ctx_limit] for kk, vv in new_kv.items()}
    scales = {}
    if is_quantized(read_kv):
        # INT8 codes + scales: K4 reads them where the flash gate holds,
        # attention_reference dequantizes them everywhere else
        k_cache, ks, v_cache, vs = read_quantized(read_kv)
        kv_positions = read_kv.get("pos")
        scales = {"k_scales": ks, "v_scales": vs}
    else:
        k_cache, v_cache, kv_positions = kv_read(read_kv)

    scale = cfg.scale if cfg.scale is not None else float(cfg.head_dim) ** -0.5
    kv_valid = None
    if not cfg.is_causal and true_length is not None:
        kv_valid = positions[0] + true_length
    attn = attention_reference(
        q, k_cache, v_cache, positions, scale=scale, is_causal=cfg.is_causal,
        sliding_window_size=cfg.sliding_window_size,
        logit_soft_cap=cfg.logit_soft_cap, sinks=params.get("sinks"),
        kv_valid_length=kv_valid, kv_positions=kv_positions,
        suffix_start=None if tree is None else tree[0],
        suffix_mask=None if tree is None else tree[1], **scales,
    )
    return attention_output(params, x, attn.reshape(s, -1)), new_kv


def _gather_rows(t: torch.Tensor, group) -> torch.Tensor:
    """Every rank's rows of `t`, concatenated in rank order."""
    import torch.distributed as dist

    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t, group=group)
    return torch.cat(parts, dim=0)


# --------------------------------------------------------------------------
# MLP
# --------------------------------------------------------------------------


def mlp_forward(cfg, params: dict, x: torch.Tensor) -> torch.Tensor:
    if isinstance(cfg, DenseMLPConfig):
        fused = linear_apply(params["up"]["w"], x, params["up"].get("b"))
        half = fused.shape[-1] // 2
        # fused rows are [up | gate]: out = up * act(gate)
        up, gate = fused[:, :half], fused[:, half:]
        hidden = gated_act_mul(cfg.activation, gate, up, cfg.gate_clipping, cfg.up_clipping)
        return linear_apply(params["down"]["w"], hidden, params["down"].get("b"))
    if isinstance(cfg, MixtureOfExpertsConfig):
        return moe_forward(cfg, params, x)
    raise NotImplementedError(f"{type(cfg).__name__} MLPs are not ported yet")


# --------------------------------------------------------------------------
# Layer + decoder
# --------------------------------------------------------------------------


def _norm(params_key, cfg, params, x):
    p = params[params_key]
    return normalize(x, cfg, p["scales"], p.get("biases"))


def residual_block(layer_cfg: TransformerLayerConfig, params: dict, x: torch.Tensor,
                   mixer):
    """One layer's norms and residuals around `mixer(h) -> (a, state)`;
    returns (x, state). On a PLE layer the post-layer scalar scales
    neither the residual nor the MLP output: `ple_apply` takes it."""
    pls = params.get("post_layer_scalar") if layer_cfg.ple_config is None else None
    h = (_norm("pre_mixer_norm", layer_cfg.pre_mixer_norm_config, params, x)
         if layer_cfg.pre_mixer_norm_config else x)
    a, new_state = mixer(h)
    if layer_cfg.post_mixer_norm_config is not None:
        a = _norm("post_mixer_norm", layer_cfg.post_mixer_norm_config, params, a)

    x = (x.float() + a.float()).to(x.dtype)
    if pls is not None:
        x = (x.float() * pls[0]).to(x.dtype)

    h = _norm("pre_mlp_norm", layer_cfg.pre_mlp_norm_config, params, x)
    m = mlp_forward(layer_cfg.mlp_config, params["mlp"], h)
    if layer_cfg.post_mlp_norm_config is not None:
        m = _norm("post_mlp_norm", layer_cfg.post_mlp_norm_config, params, m)
        if pls is not None:
            m = (m.float() * pls[0]).to(m.dtype)

    x = (x.float() + m.float()).to(x.dtype)
    return x, new_state


def ple_layer_inputs(cfg: DecoderConfig, params: dict, tokens: torch.Tensor,
                     x: torch.Tensor):
    """The per-layer embedding inputs [N, L, ple_dim] of tokens [N] with
    their scaled embedding x [N, D]; None for a model without PLE."""
    if cfg.ple_model_config is None:
        return None
    return ple_inputs(cfg.ple_model_config, params["per_layer_embedding"], tokens, x)


def ple_apply(layer_cfg: TransformerLayerConfig, params: dict, x: torch.Tensor,
              per_layer_input) -> torch.Tensor:
    """A layer's PLE projection of its input [N, ple_dim] after the MLP
    residual (x unchanged on a layer without one), scaled by the post-layer
    scalar (1 without one)."""
    if layer_cfg.ple_config is None:
        return x
    pls = params.get("post_layer_scalar")
    return ple_project(layer_cfg.ple_config, params["ple"], x, per_layer_input,
                       pls[0] if pls is not None else 1.0)


def layer_forward(
    layer_cfg: TransformerLayerConfig,
    params: dict,
    x: torch.Tensor,
    positions: torch.Tensor,
    layer_state,
    shared_kv,
    true_length=None,
    ctx_limit=None,
    per_layer_input=None,  # [N, ple_dim]: this layer's PLE input
    tree=None,
    defer_ssm: bool = False,
    tree_parents=None,
    tree_conv_src=None,
    seq_group=None,
    layer_index: int = -1,
):
    mixer_cfg = layer_cfg.mixer_config
    if not isinstance(mixer_cfg, AttentionConfig):
        if seq_group is not None:
            raise NotImplementedError(
                "sequence-parallel prefill supports attention mixers only (a recurrent "
                "state would have to pass from rank to rank)")
        if tree_parents is not None:
            # tree verification: the recurrence runs along ancestor edges
            # and nothing commits (replay inputs come back instead)
            def mixer(h):
                return ssm_tree_forward(mixer_cfg, params["mixer"], h, layer_state,
                                        tree_parents, tree_conv_src[mixer_cfg.kernel_size])
        else:
            def mixer(h):
                return ssm_forward(mixer_cfg, params["mixer"], h, positions, layer_state,
                                   true_length, defer=defer_ssm, layer=layer_index)
        x, new_state = residual_block(layer_cfg, params, x, mixer)
    else:
        owns = layer_state is not None
        x, new_state = residual_block(layer_cfg, params, x, lambda h: attention_forward(
            mixer_cfg, layer_cfg, params["mixer"], h, positions,
            layer_state if owns else shared_kv, owns, true_length, ctx_limit, tree,
            seq_group))
        new_state = new_state if owns else None
    return ple_apply(layer_cfg, params, x, per_layer_input), new_state


def embed(cfg: DecoderConfig, params: dict, tokens: torch.Tensor) -> torch.Tensor:
    """tokens [N] -> input activations [N, D]."""
    table = params["embedding"].get("tied", params["embedding"].get("input"))
    x = embedding_lookup(table, tokens)
    scale = cfg.embedding_config.input_scale
    return x if scale is None else (x.float() * scale).to(x.dtype)


def readout(cfg: DecoderConfig, params: dict, x: torch.Tensor) -> torch.Tensor:
    """Final norm and readout: x [N, D] -> logits [N, V] f32."""
    tcfg = cfg.transformer_config
    x = normalize(x, tcfg.output_norm_config, params["output_norm"]["scales"],
                  params["output_norm"].get("biases"))
    table = params["embedding"].get("tied", params["embedding"].get("output"))
    return embedding_readout(table, x, cfg.embedding_config.logit_soft_cap)


def decoder_forward(
    cfg: DecoderConfig,
    params: dict,
    tokens: torch.Tensor,  # [S] integer
    state: dict,
    *,
    last_only: bool = True,
    true_length=None,  # int or 0-d device tensor
    ctx_limit: int | None = None,  # context bucket for attention reads
    positions: torch.Tensor | None = None,  # override (tree nodes: pos + depth)
    tree_mask: torch.Tensor | None = None,  # [S, S] ancestor matrix
    collect_layers: tuple = (),  # layer indices whose outputs to tap
                                 # (the DFlash draft's hidden features)
    readout_row=None,  # explicit row for the last_only readout
    defer_ssm: bool = False,  # speculative verify: recurrent mixers return
                              # replay inputs instead of committed state;
                              # pair with decoder_commit_deferred
    tree_parents=None,  # [S] host ints, node parents (tree verify on
                        # recurrent mixers; -1 reads the incoming state)
    tree_conv_src=None,  # {kernel_size: [S, K] int tensor}: each node's
                         # conv window into [state rows; node rows]
    seq_group=None,  # sequence-parallel prefill: tokens/positions are this
                     # rank's slice (see attention_forward); the readout row
                     # is `readout_row`, on its owner rank
):
    """Run the decoder; returns (logits, new_state), and with
    `collect_layers` also the tapped layer outputs [S, n_tap, D].

    tokens may be end-padded: `true_length` (default S) is how many are
    real. pos advances by true_length (not at all with `defer_ssm`);
    padded rows land in future cache slots that the causal mask hides and
    later writes overwrite, and are identity transitions of the recurrent
    mixers. The KV caches in `state` are updated in place; recurrent
    states come back as new tensors. With `tree_mask`, row i is written
    to slot pos + i and sees the slots before pos causally and the tree's
    slots through the mask.
    """
    tcfg = cfg.transformer_config
    s = tokens.shape[0]
    if true_length is None:
        true_length = s
    if positions is None:
        positions = state["pos"] + torch.arange(s, dtype=torch.int32, device=tokens.device)
    tree = (state["pos"], tree_mask) if tree_mask is not None else None
    x = embed(cfg, params, tokens)
    per_layer = ple_layer_inputs(cfg, params, tokens, x)

    new_layer_states = []
    features = {}
    for i, layer_cfg in enumerate(tcfg.layer_configs):
        src = layer_cfg.kv_source_layer_index
        shared_kv = new_layer_states[src] if src is not None else None
        x, new_state = layer_forward(
            layer_cfg, params["layers"][i], x, positions, state["layers"][i], shared_kv,
            true_length, ctx_limit, None if per_layer is None else per_layer[:, i],
            tree=tree, defer_ssm=defer_ssm, tree_parents=tree_parents,
            tree_conv_src=tree_conv_src, seq_group=seq_group, layer_index=i,
        )
        new_layer_states.append(new_state)
        if i in collect_layers:
            features[i] = x

    if last_only:
        # the final norm is per row, so picking the row first is the same
        row = true_length - 1 if readout_row is None else readout_row
        if isinstance(row, torch.Tensor):
            # a device-side true_length of 0 (a halted decode step) reads
            # row 0, as the JAX package's clamped dynamic slice does
            x = x.index_select(0, torch.clamp(row, min=0).reshape(1).long())
        else:
            row = max(row, 0)
            x = x[row:row + 1]

    logits = readout(cfg, params, x)
    out_state = {
        "layers": new_layer_states,
        # deferred: pos stays put; decoder_commit_deferred advances it by
        # the accepted length along with the recurrent-state replays
        "pos": state["pos"] if defer_ssm else state["pos"] + true_length,
    }
    if collect_layers:
        feats = torch.stack([features[i] for i in collect_layers], dim=1)  # [S, n_tap, D]
        return logits, out_state, feats
    return logits, out_state


def decoder_commit_deferred(cfg: DecoderConfig, pending: dict, commit_length) -> dict:
    """Resolve a `defer_ssm=True` forward into a decoding state committed
    to `commit_length` tokens (an int or a 0-d device tensor decided after
    the forward, e.g. by acceptance on the device). Attention layers are
    already slot-committed (pos governs visibility); recurrent layers
    replay their recurrence over the accepted prefix (`ssm_commit`)."""
    layers = []
    for layer_cfg, entry in zip(cfg.transformer_config.layer_configs, pending["layers"]):
        if entry is not None and not isinstance(layer_cfg.mixer_config, AttentionConfig):
            entry = ssm_commit(layer_cfg.mixer_config, entry, commit_length)
        layers.append(entry)
    pos = pending["pos"]
    return {"layers": layers, "pos": (pos + commit_length).to(pos.dtype)}
