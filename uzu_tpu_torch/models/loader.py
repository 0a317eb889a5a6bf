"""Build the model parameter tree from config + safetensors tree.

Counterpart of `uzu_tpu/models/loader.py`, with the same tensor names,
shapes and dtypes, so model directories written for the JAX package load
unchanged. The parameters are a nested dict of torch tensors and
`QuantizedTensor` leaves on one device, shaped like the JAX package's
pytree; everything static lives in the config objects. A HybridSpec
linear becomes a `HybridLinear` leaf (quantized base, LowRank adapter,
Hadamard signs).
"""

from __future__ import annotations

import numpy as np
import torch

from ..config.model import (
    AttentionConfig,
    DecoderConfig,
    DenseMLPConfig,
    FullPrecisionSpec,
    HybridSpec,
    IncoherenceProcessingMode,
    IntSpec,
    Layout,
    LowRankSpec,
    MLXSpec,
    MixtureOfExpertsConfig,
    NormalizationConfig,
    TiedEmbeddingConfig,
    UntiedEmbeddingConfig,
)
from ..params.safetensors_io import BF16, to_torch
from ..params.tree import ParameterError, ParameterTree
from ..quant.format import HybridLinear, StackedQuantized, from_disk_tensors

_FLOAT_DTYPES = {
    BF16: torch.bfloat16,
    np.dtype(np.float32): torch.float32,
    np.dtype(np.float16): torch.float16,
}


def _weights_dtype(tree: ParameterTree, leaf: str) -> np.dtype:
    dt = tree.leaf_info(leaf).dtype
    if dt not in _FLOAT_DTYPES:
        raise ParameterError(f"unsupported float dtype {dt}")
    return dt


def load_linear(tree: ParameterTree, input_dim: int, output_dim: int, has_biases: bool,
                device=None) -> dict:
    """Load one linear (full-precision or quantized) at `tree`."""
    spec = tree.spec("weights")
    weights_tree = tree.subtree("weights")
    out: dict = {}
    if isinstance(spec, FullPrecisionSpec):
        if spec.layout != Layout.OUTPUT_INPUT:
            raise ParameterError(f"unsupported linear layout {spec.layout}")
        dt = _weights_dtype(weights_tree, "weights")
        out["w"] = to_torch(weights_tree.leaf("weights", (output_dim, input_dim), dt), device)
    elif isinstance(spec, (IntSpec, MLXSpec)):
        out["w"] = _load_quantized(spec, weights_tree, input_dim, output_dim, device)
    elif isinstance(spec, HybridSpec):
        out["w"] = _load_hybrid(spec, weights_tree, input_dim, output_dim, has_biases, device)
    else:
        raise ParameterError(f"unsupported weight spec {type(spec).__name__}")
    if has_biases:
        dt = tree.leaf_info("biases").dtype
        out["b"] = to_torch(tree.leaf("biases", (output_dim,), dt), device)
    return out


def _load_quantized(spec, weights_tree: ParameterTree, input_dim: int, output_dim: int,
                    device=None):
    if isinstance(spec, MLXSpec):
        method = "scale_bias"
    else:
        method = "scale_symmetric" if spec.is_symmetric else "scale_zero_point"
    bits, group = spec.bits, spec.group_size
    if spec.layout != Layout.OUTPUT_INPUT:
        raise ParameterError(f"unsupported quantized layout {spec.layout}")
    if bits not in (4, 8):
        raise ParameterError(f"unsupported bits={bits}")
    pack = 8 // bits
    kg = -(-input_dim // group)
    dt = _weights_dtype(weights_tree, "scales")
    codes = weights_tree.leaf("weights", (output_dim, input_dim // pack), np.uint8)
    scales = weights_tree.leaf("scales", (output_dim, kg), dt)
    zero_points = biases = None
    if method == "scale_bias":
        biases = weights_tree.leaf("biases", (output_dim, kg), dt)
    elif method == "scale_zero_point":
        zero_points = weights_tree.leaf("zero_points", (output_dim, -(-kg // pack)), np.uint8)
    return from_disk_tensors(method, codes, scales, bits, group, zero_points=zero_points,
                             biases=biases, dtype=_FLOAT_DTYPES[dt], device=device)


def _load_hybrid(spec: HybridSpec, weights_tree: ParameterTree, input_dim: int,
                 output_dim: int, has_biases: bool, device=None) -> HybridLinear:
    """HybridSpec, as `uzu_tpu/models/loader.py::_load_hybrid`: the
    quantized base under "quantized", an optional LowRank adapter under
    "adapter" in the file's own dtype, optional incoherence signs (int32 on
    disk, f32 in memory)."""
    base_spec = spec.quantization_spec
    if not isinstance(base_spec, (IntSpec, MLXSpec)):
        raise ParameterError(f"unsupported hybrid base {type(base_spec).__name__}")
    base = _load_quantized(base_spec, weights_tree.subtree("quantized"), input_dim, output_dim,
                           device)

    adapter_down = adapter_up = None
    if spec.adapter_spec is not None:
        if has_biases:
            raise ParameterError("QLoRA linear with biases is not supported")
        if not isinstance(spec.adapter_spec, LowRankSpec):
            raise ParameterError(f"unsupported adapter {type(spec.adapter_spec).__name__}")
        rank = spec.adapter_spec.rank
        dt = _weights_dtype(weights_tree, "adapter.down_projection")
        adapter_down = to_torch(
            weights_tree.leaf("adapter.down_projection", (rank, input_dim), dt), device)
        adapter_up = to_torch(
            weights_tree.leaf("adapter.up_projection", (output_dim, rank), dt), device)

    input_signs = output_signs = None
    if spec.incoherence_block_size is not None:
        if spec.incoherence_block_size != 32:
            raise ParameterError(f"unsupported incoherence block {spec.incoherence_block_size}")
        if spec.incoherence_processing_mode != IncoherenceProcessingMode.INPUT_OUTPUT:
            raise ParameterError(
                f"unsupported incoherence mode {spec.incoherence_processing_mode}")
        input_signs = to_torch(weights_tree.leaf(
            "incoherence_signs.input_signs", (input_dim,), np.int32), device).float()
        output_signs = to_torch(weights_tree.leaf(
            "incoherence_signs.output_signs", (output_dim,), np.int32), device).float()

    return HybridLinear(base=base, adapter_down=adapter_down, adapter_up=adapter_up,
                        input_signs=input_signs, output_signs=output_signs)


def load_norm(tree: ParameterTree, dim: int, cfg: NormalizationConfig, device=None) -> dict:
    out = {"scales": to_torch(tree.leaf("scales", (dim,), np.float32), device)}
    if cfg.has_biases:
        out["biases"] = to_torch(tree.leaf("biases", (dim,), np.float32), device)
    return out


def load_embedding(tree: ParameterTree, cfg, vocab_size: int, model_dim: int,
                   device=None) -> dict:
    """Tied or untied embedding (full precision or quantized)."""

    def load_one(sub: ParameterTree):
        spec = sub.spec(name=None)
        if isinstance(spec, FullPrecisionSpec):
            dt = _weights_dtype(sub, "weights")
            return to_torch(sub.leaf("weights", (vocab_size, model_dim), dt), device)
        if isinstance(spec, (IntSpec, MLXSpec)):
            return _load_quantized(spec, sub, model_dim, vocab_size, device)
        raise ParameterError(f"unsupported embedding spec {type(spec).__name__}")

    if isinstance(cfg, TiedEmbeddingConfig):
        return {"tied": load_one(tree.subtree("embedding"))}
    if isinstance(cfg, UntiedEmbeddingConfig):
        return {
            "input": load_one(tree.subtree("input_embedding")),
            "output": load_one(tree.subtree("output_embedding")),
        }
    raise ParameterError(f"unsupported embedding config {type(cfg).__name__}")


def load_attention(tree: ParameterTree, cfg: AttentionConfig, model_dim: int,
                   device=None) -> dict:
    q_dim = cfg.num_heads * cfg.head_dim
    qkv_out = q_dim if cfg.is_kv_sharing else q_dim + 2 * cfg.num_groups * cfg.head_dim
    out = {
        "qkv": load_linear(tree.subtree("qkv_projection"), model_dim, qkv_out,
                           cfg.has_qkv_biases, device),
        "out": load_linear(tree.subtree("out_projection"), q_dim, model_dim,
                           cfg.has_out_biases, device),
    }
    if cfg.gate_projection_config is not None:
        out["gate"] = load_linear(tree.subtree("gate_projection"), model_dim, q_dim, False, device)
    if cfg.query_norm_config is not None:
        out["q_norm_scales"] = to_torch(
            tree.leaf("query_norm.scales", (cfg.head_dim,), np.float32), device)
    if cfg.key_norm_config is not None and not cfg.is_kv_sharing:
        out["k_norm_scales"] = to_torch(
            tree.leaf("key_norm.scales", (cfg.head_dim,), np.float32), device)
    if cfg.has_sinks:
        dt = tree.leaf_info("sinks").dtype
        out["sinks"] = to_torch(tree.leaf("sinks", (cfg.num_heads,), dt), device)
    return out


def load_mlp(tree: ParameterTree, cfg, model_dim: int, hidden_dim: int, device=None) -> dict:
    if isinstance(cfg, DenseMLPConfig):
        return {
            "up": load_linear(tree.subtree("up_projection"), model_dim, 2 * hidden_dim,
                              cfg.has_up_biases, device),
            "down": load_linear(tree.subtree("down_projection"), hidden_dim, model_dim,
                                cfg.has_down_biases, device),
        }
    if isinstance(cfg, MixtureOfExpertsConfig):
        return load_moe(tree, cfg, model_dim, device)
    raise ParameterError(f"unsupported mlp config {type(cfg).__name__}")


def _load_expert_stack(experts: ParameterTree, role: str, e: int, n: int, kdim: int,
                       device=None):
    """One expert weight stack: dense [E, N, K] float, or a
    `StackedQuantized` when the role carries a symmetric 4- or 8-bit
    IntSpec. Returns (stack, float dtype of the file)."""
    sub = experts.subtree(f"{role}.weights")
    try:
        spec = experts.subtree(role).spec("weights")
    except ParameterError:
        spec = None
    if spec is None:
        dt = _weights_dtype(sub, "weights")
        return to_torch(sub.leaf("weights", (e, n, kdim), dt), device), dt
    if not (isinstance(spec, IntSpec) and spec.is_symmetric and spec.bits in (4, 8)):
        raise ParameterError(f"expert stacks support symmetric IntSpec only, got {spec}")
    pack = 8 // spec.bits
    kg = -(-kdim // spec.group_size)
    dt = _weights_dtype(sub, "scales")
    codes = sub.leaf("weights", (e, n, kdim // pack), np.uint8)
    scales = sub.leaf("scales", (e, n, kg), dt)
    return StackedQuantized(
        codes=to_torch(codes, device), scales=to_torch(scales, device), bits=spec.bits,
        group_size=spec.group_size, qbias_coeff=-float(1 << (spec.bits - 1))), dt


def load_moe(tree: ParameterTree, cfg: MixtureOfExpertsConfig, model_dim: int,
             device=None) -> dict:
    """Router, expert stacks, expert biases and shared experts, named as in
    the JAX package's `load_moe`. The down stack keeps its d output rows:
    the JAX loader pads them to a multiple of 128 (a TPU lane rule) and
    slices the results back; here no path needs the padding. Shared experts
    must be full-precision linears: the JAX package multiplies them as dense
    arrays, so it serves no quantized one either."""
    e, dff = cfg.num_routed_experts, cfg.expert_hidden_dim
    out = {"router": load_linear(tree.subtree("router"), model_dim, e,
                                 cfg.router_has_biases, device)}
    experts = tree.subtree("experts")
    w13, dt = _load_expert_stack(experts, "up_projection", e, 2 * dff, model_dim, device)
    w2, _ = _load_expert_stack(experts, "down_projection", e, model_dim, dff, device)
    out["up"] = {"w": w13}
    out["down"] = {"w": w2}
    if cfg.expert_config.has_up_biases:
        out["up"]["b"] = to_torch(experts.leaf("up_projection.biases", (e, 2 * dff), dt),
                                  device)
    if cfg.expert_config.has_down_biases:
        out["down"]["b"] = to_torch(experts.leaf("down_projection.biases", (e, model_dim), dt),
                                    device)
    if cfg.num_shared_experts:
        shared = tree.subtree("shared_experts")
        width = dff * cfg.num_shared_experts
        out["shared"] = {
            "up": load_linear(shared.subtree("up_projection"), model_dim, 2 * width, False,
                              device),
            "down": load_linear(shared.subtree("down_projection"), width, model_dim, False,
                                device),
        }
        if not all(isinstance(lin["w"], torch.Tensor) for lin in out["shared"].values()):
            raise ParameterError("shared experts must be full-precision linears")
    return out


def load_layer(tree: ParameterTree, layer_cfg, model_dim: int, hidden_dim: int,
               device=None) -> dict:
    out: dict = {}
    mixer_cfg = layer_cfg.mixer_config
    if isinstance(mixer_cfg, AttentionConfig):
        out["mixer"] = load_attention(tree.subtree("mixer"), mixer_cfg, model_dim, device)
    else:
        from .ssm import load_ssm_mixer

        out["mixer"] = load_ssm_mixer(tree.subtree("mixer"), mixer_cfg, model_dim, device)
    for key in ("pre_mixer_norm", "post_mixer_norm", "pre_mlp_norm", "post_mlp_norm"):
        norm_cfg = getattr(layer_cfg, key + "_config")
        if norm_cfg is not None:
            out[key] = load_norm(tree.subtree(key), model_dim, norm_cfg, device)
    out["mlp"] = load_mlp(tree.subtree("mlp"), layer_cfg.mlp_config, model_dim,
                          layer_cfg.hidden_dim or hidden_dim, device)
    if layer_cfg.has_post_layer_scalar:
        dt = tree.leaf_info("post_layer_scalar").dtype
        out["post_layer_scalar"] = to_torch(
            tree.leaf("post_layer_scalar", (1,), dt), device).float()
    if layer_cfg.ple_config is not None:
        from .ple import load_ple_layer

        out["ple"] = load_ple_layer(tree, layer_cfg.ple_config, model_dim, device)
    return out


def load_decoder(tree: ParameterTree, cfg: DecoderConfig, device=None) -> dict:
    tcfg = cfg.transformer_config
    model_dim = tcfg.model_dim
    params = {
        "embedding": load_embedding(tree, cfg.embedding_config, cfg.vocab_size, model_dim,
                                    device),
        "layers": [
            load_layer(tree.subtree(f"transformer.layers.{i}"), layer_cfg, model_dim,
                       tcfg.hidden_dim, device)
            for i, layer_cfg in enumerate(tcfg.layer_configs)
        ],
        "output_norm": load_norm(tree.subtree("transformer.output_norm"), model_dim,
                                 tcfg.output_norm_config, device),
    }
    if cfg.ple_model_config is not None:
        from .ple import load_ple

        params["per_layer_embedding"] = load_ple(tree, cfg, tcfg, device)
    return params
