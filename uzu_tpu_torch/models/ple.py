"""Per-layer embeddings (Gemma-3n/E4B PLE); counterpart of `uzu_tpu/models/ple.py`.

Two pieces, with the JAX functions' arithmetic:

- decoder-level `ple_inputs`: the token's row of a dedicated table
  [ple_vocab, L * ple_dim] scaled by ple_embed_scale * input_scale (ids >=
  ple_vocab read zero rows), plus the scaled embedding projected D -> L *
  ple_dim and RMS-normalized per ple_dim row with the folded epsilon
  eps / model_projection_scale^2, times input_scale;
- per-layer `ple_project`, after the MLP residual:
  x += post_layer_scalar * norm(projection(act(gate(x)) * per_layer_input)).

Products run in f32 and are rounded to x's dtype where the JAX functions
round them.
"""

from __future__ import annotations

import dataclasses

import torch

from ..config.model import DecoderConfig, PLELayerConfig, PLEModelConfig
from ..ops.activation import apply_activation
from ..ops.linear import linear_apply
from ..ops.norm import normalize
from ..params.safetensors_io import to_torch


def load_ple(tree, cfg: DecoderConfig, tcfg, device=None) -> dict:
    from .loader import load_linear, load_norm

    ple = cfg.ple_model_config
    total = ple.num_layers * ple.ple_dim
    sub = tree.subtree("per_layer_embedding")
    dt = sub.leaf_info("token_embedding").dtype
    return {
        "token_embedding": to_torch(
            sub.leaf("token_embedding", (ple.ple_vocab_size, total), dt), device),
        "model_projection": load_linear(sub.subtree("model_projection"), tcfg.model_dim,
                                        total, False, device),
        "projection_norm": load_norm(sub.subtree("projection_norm"), ple.ple_dim,
                                     ple.norm_config, device),
    }


def load_ple_layer(tree, ple_cfg: PLELayerConfig, model_dim: int, device=None) -> dict:
    from .loader import load_linear, load_norm

    sub = tree.subtree("ple")
    return {
        "gate": load_linear(sub.subtree("gate"), model_dim, ple_cfg.ple_dim, False, device),
        "projection": load_linear(sub.subtree("projection"), ple_cfg.ple_dim, model_dim,
                                  False, device),
        "norm": load_norm(sub.subtree("norm"), model_dim, ple_cfg.norm_config, device),
    }


def ple_inputs(ple_cfg: PLEModelConfig, params: dict, tokens: torch.Tensor,
               x: torch.Tensor) -> torch.Tensor:
    """tokens [S], x [S, D] (the scaled embedding) -> per-layer inputs
    [S, L, ple_dim] in x's dtype."""
    s = tokens.shape[0]
    n_layers, pd = ple_cfg.num_layers, ple_cfg.ple_dim
    tokens = tokens.long()
    in_range = tokens < ple_cfg.ple_vocab_size
    safe = torch.where(in_range, tokens, torch.zeros_like(tokens))
    tok_ple = params["token_embedding"][safe].float() * (
        ple_cfg.ple_embed_scale * ple_cfg.input_scale)
    tok_ple = torch.where(in_range[:, None], tok_ple, torch.zeros_like(tok_ple))

    projected = linear_apply(params["model_projection"]["w"], x)  # [S, L * pd]
    rows = projected.reshape(s * n_layers, pd)
    eps = ple_cfg.norm_config.epsilon / (
        ple_cfg.model_projection_scale * ple_cfg.model_projection_scale)
    normed = normalize(rows, dataclasses.replace(ple_cfg.norm_config, epsilon=eps),
                       params["projection_norm"]["scales"])
    normed = normed.float() * ple_cfg.input_scale
    return (tok_ple.reshape(s, n_layers, pd) + normed.reshape(s, n_layers, pd)).to(x.dtype)


def ple_project(ple_cfg: PLELayerConfig, params: dict, x: torch.Tensor,
                per_layer_input: torch.Tensor, post_layer_scalar) -> torch.Tensor:
    """x [S, D] (after the MLP residual), per_layer_input [S, ple_dim] (this
    layer's slice) -> x + post_layer_scalar * norm(projection(act(gate(x))
    * per_layer_input))."""
    gate = linear_apply(params["gate"]["w"], x)
    activated = (apply_activation(ple_cfg.activation, gate).float()
                 * per_layer_input.float()).to(x.dtype)
    projected = linear_apply(params["projection"]["w"], activated)
    normed = normalize(projected, ple_cfg.norm_config, params["norm"]["scales"])
    return (x.float() + normed.float() * post_layer_scalar).to(x.dtype)
