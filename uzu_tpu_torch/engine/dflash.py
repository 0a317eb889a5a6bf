"""DFlash draft model: target-feature-conditioned block drafting.

Counterpart of `uzu_tpu/engine/dflash.py`:

- the draft's per-layer KV cache is written FROM TARGET FEATURES, not from
  its own forward: the accepted tokens' tapped hidden states
  (target_layer_ids) are packed, projected (context_projection),
  normalized, and mapped to every draft layer's K/V rows by one
  state_kv_projection; K gets the key norm and RoPE at append;
- drafting runs the whole lookahead block in ONE forward: tokens =
  [target output, mask, mask, ...], each block row attending only itself
  within the block plus the feature-derived prefix;
- rows 1..block-1 are read out through the TARGET embedding and top-k'd
  into per-depth candidates, which the decoder assembles into a tree.

The draft's own block KV rows are never committed: `draft` writes them in
place at slots pos .. pos + block - 1 (the JAX package drops them by not
returning its caches), where the next `accept` overwrites the first ones
and the rest lie past every later query's causal horizon, so two drafts
from one state give the same candidates.
"""

from __future__ import annotations

import json
import os

import torch

from ..config.model import AttentionConfig, DFlashDraftConfig, SpeculatorModelConfig
from ..config.serde import parse
from ..models.decoder import _inv_freq, embedding_lookup, embedding_readout, layer_forward
from ..models.kv_cache import append as kv_append
from ..models.loader import load_layer, load_linear, load_norm
from ..ops.linear import linear_apply
from ..ops.norm import normalize
from ..ops.rope import apply_rope, rope_tables
from ..params.tree import ParameterLoader
from ..runtime import resolve_device


class DFlashDraft:
    def __init__(self, cfg: DFlashDraftConfig, params: dict, max_context: int = 4096,
                 device=None):
        from .engine import _map_leaves

        self.device = resolve_device(device)
        self.cfg = cfg
        self.params = _map_leaves(params, lambda t: t.to(self.device))
        self.max_context = max_context
        first = cfg.layer_configs[0].mixer_config
        if not isinstance(first, AttentionConfig):
            raise ValueError("DFlash layers must be attention")
        self.num_groups = first.num_groups
        self.head_dim = first.head_dim
        self.key_norm_config = first.key_norm_config

    # -- loading -----------------------------------------------------------

    @classmethod
    def from_dir(cls, model_dir: str, max_context: int = 4096, device=None) -> "DFlashDraft":
        device = resolve_device(device)
        with open(os.path.join(model_dir, "config.json")) as f:
            model_cfg = parse(SpeculatorModelConfig, json.load(f))
        cfg = model_cfg.speculator_config.draft_config
        loader = ParameterLoader(os.path.join(model_dir, "model.safetensors"))
        tree = loader.tree().subtree("speculator.draft_model")
        return cls(cfg, cls._load(tree, cfg, device), max_context=max_context, device=device)

    @staticmethod
    def _load(tree, cfg: DFlashDraftConfig, device=None) -> dict:
        d = cfg.model_dim
        n_tap = len(cfg.target_layer_ids)
        first = cfg.layer_configs[0].mixer_config
        layer_kv_dim = 2 * first.num_groups * first.head_dim
        return {
            "context_projection": load_linear(tree.subtree("context_projection"), d * n_tap, d,
                                              False, device),
            "context_norm": load_norm(tree.subtree("context_norm"), d, cfg.context_norm_config,
                                      device),
            "state_kv_projection": load_linear(tree.subtree("state_kv_projection"), d,
                                               len(cfg.layer_configs) * layer_kv_dim, False,
                                               device),
            "layers": [load_layer(tree.subtree(f"layers.{i}"), lc, d, cfg.hidden_dim, device)
                       for i, lc in enumerate(cfg.layer_configs)],
            "output_norm": load_norm(tree.subtree("output_norm"), d, cfg.output_norm_config,
                                     device),
        }

    # -- state ---------------------------------------------------------------

    def new_state(self) -> dict:
        c = min(self.max_context, self.cfg.rope_config.max_sequence_length)
        layers = [{name: torch.zeros((c, self.num_groups, self.head_dim), dtype=torch.bfloat16,
                                     device=self.device) for name in ("k", "v")}
                  for _ in self.cfg.layer_configs]
        return {"layers": layers, "pos": torch.zeros((), dtype=torch.int32, device=self.device)}

    # -- accept: write target features into the draft KV ---------------------

    def accept(self, state: dict, packed_features, n_real: int) -> dict:
        """packed_features [n, n_tap, D] or [n, n_tap * D] (token-major, tap
        chunks in target_layer_ids order); rows past n_real are padding.
        Writes the draft KV rows in place and returns the state with pos
        advanced by n_real."""
        cfg = self.cfg
        packed = torch.as_tensor(packed_features, device=self.device)
        n = packed.shape[0]
        packed = packed.reshape(n, -1)
        p = self.params
        projected = linear_apply(p["context_projection"]["w"], packed)
        normed = normalize(projected, cfg.context_norm_config, p["context_norm"]["scales"],
                           p["context_norm"].get("biases"))
        kv = linear_apply(p["state_kv_projection"]["w"], normed)
        kv = kv.reshape(n, len(cfg.layer_configs), 2, self.num_groups, self.head_dim)
        positions = state["pos"] + torch.arange(n, dtype=torch.int32, device=self.device)
        inv_freq, attn_scale = _inv_freq(cfg.rope_config, str(self.device))
        cos, sin = rope_tables(inv_freq, attn_scale, positions)
        layers = []
        for li in range(len(cfg.layer_configs)):
            k_new, v_new = kv[:, li, 0], kv[:, li, 1]
            if self.key_norm_config is not None:
                k_new = normalize(k_new, self.key_norm_config,
                                  p["layers"][li]["mixer"]["k_norm_scales"])
            k_new = apply_rope(k_new, cos, sin)
            layers.append(kv_append(state["layers"][li], k_new, v_new, positions, n_real))
        return {"layers": layers, "pos": state["pos"] + n_real}

    # -- draft: one block forward -> per-depth candidates --------------------

    def draft(self, state: dict, target_embedding_params, target_ecfg, root_token: int,
              candidate_count: int = 4):
        """-> (ids [block-1, k], logits [block-1, k]) as numpy. The block's
        KV rows are not committed (see the module docstring): `state`
        stays valid."""
        cfg = self.cfg
        b = cfg.block_size
        table = target_embedding_params.get("tied", target_embedding_params.get("input"))
        tokens = torch.full((b,), cfg.mask_token_id, dtype=torch.long, device=self.device)
        tokens[0] = int(root_token)
        x = embedding_lookup(table, tokens)
        if target_ecfg.input_scale is not None:
            x = (x.float() * target_ecfg.input_scale).to(x.dtype)
        positions = state["pos"] + torch.arange(b, dtype=torch.int32, device=self.device)
        # block rows attend only themselves within the block, plus the
        # feature prefix
        tree = (state["pos"], torch.eye(b, dtype=torch.bool, device=self.device))
        for li, lc in enumerate(cfg.layer_configs):
            x, _ = layer_forward(lc, self.params["layers"][li], x, positions,
                                 state["layers"][li], None, b, tree=tree)
        x = normalize(x, cfg.output_norm_config, self.params["output_norm"]["scales"],
                      self.params["output_norm"].get("biases"))
        logits = embedding_readout(table, x[1:], target_ecfg.logit_soft_cap)  # [b-1, V]
        vals, ids = torch.topk(logits, candidate_count)
        return ids.int().cpu().numpy(), vals.cpu().numpy()
