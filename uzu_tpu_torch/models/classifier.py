"""Classifier model: encoder-style transformer + pooling + prediction head.

Reference: crates/backend-uzu/src/engine/classifier_model.rs:97-148 and
encodable_block/{classifier.rs,prediction_head.rs}. Pipeline: embedding
lookup -> embedding norm -> transformer with BIDIRECTIONAL attention ->
mean pooling over real rows -> dense + activation + norm + readout ->
per-label sigmoid probabilities.

The port's counterpart of `uzu_tpu/models/classifier.py`: one eager
forward per power-of-two length bucket through the port's `layer_forward`
(`is_causal=False` with `true_length`, so keys past the real rows are
masked). Non-causal attention takes the plain path: K3's gate admits
causal chunks only.
"""

from __future__ import annotations

import dataclasses
import json
import os
import types

import numpy as np
import torch

from ..config.model import AttentionConfig, ClassifierConfig, ClassifierModelConfig, PoolingType
from ..config.serde import parse
from ..ops.activation import apply_activation
from ..ops.linear import linear_apply
from ..ops.norm import normalize
from ..params.tree import ParameterLoader
from ..runtime import resolve_device
from .decoder import embedding_lookup, layer_forward
from .loader import load_embedding, load_layer, load_linear, load_norm
from .state import init_state


def _noncausal(tcfg):
    layers = tuple(
        dataclasses.replace(
            lc,
            mixer_config=dataclasses.replace(lc.mixer_config, is_causal=False)
            if isinstance(lc.mixer_config, AttentionConfig)
            else lc.mixer_config,
        )
        for lc in tcfg.layer_configs
    )
    return dataclasses.replace(tcfg, layer_configs=layers)


class ClassifierModel:
    def __init__(self, config: ClassifierConfig, params: dict, *, device=None):
        if config.classifier_pooling != PoolingType.MEAN:
            raise ValueError("only mean pooling is supported (matches the reference)")
        self.device = resolve_device(device)
        self.config = config
        self.tcfg = _noncausal(config.transformer_config)
        self.params = params
        self.output_labels = list(
            config.output_labels or [f"class_{i}" for i in range(config.num_labels)]
        )

    @classmethod
    def from_dir(cls, model_dir: str, *, device=None) -> "ClassifierModel":
        device = resolve_device(device)
        with open(os.path.join(model_dir, "config.json")) as f:
            model_cfg = parse(ClassifierModelConfig, json.load(f))
        cfg = model_cfg.classifier_config
        loader = ParameterLoader(os.path.join(model_dir, "model.safetensors"))
        tree = loader.tree().subtree("classifier")
        params = cls._load(tree, cfg, device)
        loader.tree().assert_all_validated()
        return cls(cfg, params, device=device)

    @staticmethod
    def _load(tree, cfg: ClassifierConfig, device) -> dict:
        d = cfg.model_dim
        ph = cfg.prediction_head_config
        head = tree.subtree("prediction_head")
        return {
            "embedding": load_embedding(tree, cfg.embedding_config, cfg.vocab_size, d, device),
            "embedding_norm": load_norm(tree.subtree("embedding_norm"), d,
                                        cfg.embedding_norm_config, device),
            "layers": [
                load_layer(tree.subtree(f"transformer.layers.{i}"), lc, d,
                           cfg.transformer_config.hidden_dim, device)
                for i, lc in enumerate(cfg.transformer_config.layer_configs)
            ],
            "head": {
                "dense": load_linear(head.subtree("dense"), cfg.hidden_dim, cfg.hidden_dim,
                                     ph.use_dense_bias, device),
                "norm": load_norm(head.subtree("norm"), cfg.hidden_dim, ph.normalization_config,
                                  device),
                "readout": load_linear(head.subtree("readout"), cfg.hidden_dim,
                                       cfg.num_labels, False, device),
            },
        }

    @torch.inference_mode()
    def forward(self, tokens: torch.Tensor, true_length: int) -> torch.Tensor:
        """tokens [S] (the bucket, zero-padded past true_length) -> logits
        [num_labels] f32."""
        cfg, params = self.config, self.params
        s = tokens.shape[0]
        x = embedding_lookup(params["embedding"].get("tied", params["embedding"].get("input")),
                             tokens)
        if cfg.embedding_config.input_scale is not None:
            x = (x.float() * cfg.embedding_config.input_scale).to(x.dtype)
        x = normalize(x, cfg.embedding_norm_config, params["embedding_norm"]["scales"],
                      params["embedding_norm"].get("biases"))
        positions = torch.arange(s, dtype=torch.int32, device=self.device)
        state = init_state(types.SimpleNamespace(transformer_config=self.tcfg), s, x.dtype,
                           device=self.device)
        for i, lc in enumerate(self.tcfg.layer_configs):
            x, _ = layer_forward(lc, params["layers"][i], x, positions, state["layers"][i],
                                 None, true_length)
        # mean over the real rows only
        pooled = (x[:true_length].float().sum(0) / true_length).to(x.dtype)[None]
        ph = cfg.prediction_head_config
        h = linear_apply(params["head"]["dense"]["w"], pooled, params["head"]["dense"].get("b"))
        h = apply_activation(ph.activation, h)
        h = normalize(h, ph.normalization_config, params["head"]["norm"]["scales"],
                      params["head"]["norm"].get("biases"))
        return linear_apply(params["head"]["readout"]["w"], h)[0].float()

    def classify(self, token_ids) -> dict:
        """Returns {"logits": [...], "probabilities": {label: p}} with
        per-label sigmoid (classifier_model.rs:137-141)."""
        ids = np.asarray(token_ids, np.int64)
        if ids.size == 0:
            raise ValueError("empty input")
        s = 1 << max(0, int(ids.size - 1)).bit_length()
        padded = np.zeros(s, np.int64)
        padded[: ids.size] = ids
        logits = self.forward(torch.from_numpy(padded).to(self.device), int(ids.size))
        logits = logits.cpu().numpy()
        probs = 1.0 / (1.0 + np.exp(-logits))
        return {
            "logits": logits.tolist(),
            "probabilities": {label: float(p) for label, p in zip(self.output_labels, probs)},
        }
