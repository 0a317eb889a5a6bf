"""Synthesize model directories (config.json + model.safetensors), numpy only.

Counterpart of `uzu_tpu/tools/synth.py` for the decoder shapes the port
runs (attention mixers, dense and mixture-of-experts MLPs, full-precision /
IntSpec / MLXSpec weights, dense or symmetric-quantized expert stacks):
with the same seed, fill and specs it draws the same random numbers in the
same order and writes the same bytes, bf16 included, without `ml_dtypes`.
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np

from ..config import dumps as config_dumps
from ..config.model import (
    AttentionConfig,
    DecoderConfig,
    DenseMLPConfig,
    FullPrecisionSpec,
    GenerationConfig,
    IntSpec,
    LanguageModelConfig,
    Layout,
    LinearConfig,
    LlamaRoPEConfig,
    MixtureOfExpertsConfig,
    MLXSpec,
    NormalizationConfig,
    SiLU,
    SoftmaxRouting,
    TiedEmbeddingConfig,
    TransformerConfig,
    TransformerLayerConfig,
    UnscaledRoPEConfig,
    UntiedEmbeddingConfig,
    UpcastMode,
)
from ..config.serde import dump as dump_cfg
from ..params.safetensors_io import BF16, cast, save_file
from ..quant.format import quantize_reference


def _method(spec) -> str:
    if isinstance(spec, MLXSpec):
        return "scale_bias"
    return "scale_symmetric" if spec.is_symmetric else "scale_zero_point"


class ModelBuilder:
    """Accumulates tensors + metadata, then writes a model dir."""

    def __init__(self, seed: int = 0, weight_scale: float = 0.02, dtype=BF16,
                 fill: str = "normal"):
        self.rng = np.random.default_rng(seed)
        self.tensors: dict[str, np.ndarray] = {}
        self.metadata: dict[str, str] = {}
        self.weight_scale = weight_scale
        self.dtype = np.dtype(dtype)
        self.fill = fill  # "normal" | "fast" (raw random bytes, ~30x faster)

    def _random(self, shape, scale: float) -> np.ndarray:
        """Random weights; fill="fast" draws raw bytes as int8 (uniform,
        std ~74) instead of normals, for full-width models."""
        if self.fill == "fast":
            n = int(np.prod(shape))
            raw = np.frombuffer(self.rng.bytes(n), np.int8)
            return raw.astype(np.float32).reshape(shape) * (scale / 74.0)
        return self.rng.standard_normal(shape, dtype=np.float32) * scale

    # -- tensor emitters -----------------------------------------------------

    def dense(self, name: str, shape, dtype=None, scale=None) -> np.ndarray:
        dtype = self.dtype if dtype is None else dtype
        scale = self.weight_scale if scale is None else scale
        arr = cast(self._random(shape, scale), dtype)
        self.tensors[name] = arr
        return arr

    def norm_scales(self, prefix: str, dim: int, has_biases: bool) -> None:
        self.tensors[f"{prefix}.scales"] = np.ones(dim, np.float32) + (
            self.rng.standard_normal(dim).astype(np.float32) * 0.02
        )
        if has_biases:
            self.tensors[f"{prefix}.biases"] = (
                self.rng.standard_normal(dim).astype(np.float32) * 0.02
            )

    def linear(self, prefix: str, input_dim: int, output_dim: int, spec,
               has_biases: bool) -> None:
        """Emit one linear's tensors under `prefix` per the weight spec."""
        self.metadata[f"{prefix}.weights.spec"] = config_dumps(spec)
        if isinstance(spec, FullPrecisionSpec):
            self.dense(f"{prefix}.weights.weights", (output_dim, input_dim))
        elif isinstance(spec, (IntSpec, MLXSpec)):
            weights = self._random((output_dim, input_dim), self.weight_scale)
            parts = quantize_reference(weights, spec.bits, spec.group_size, _method(spec),
                                       dtype=self.dtype)
            for leaf, arr in parts.items():
                self.tensors[f"{prefix}.weights.{leaf}"] = arr
        else:
            raise NotImplementedError(f"{type(spec).__name__} weights are not ported yet")
        if has_biases:
            self.dense(f"{prefix}.biases", (output_dim,))

    def embedding(self, prefix: str, vocab: int, dim: int, spec) -> None:
        self.metadata[f"{prefix}.spec"] = config_dumps(spec)
        if isinstance(spec, FullPrecisionSpec):
            self.dense(f"{prefix}.weights", (vocab, dim))
        elif isinstance(spec, (IntSpec, MLXSpec)):
            weights = self._random((vocab, dim), self.weight_scale)
            parts = quantize_reference(weights, spec.bits, spec.group_size, _method(spec),
                                       dtype=self.dtype)
            for leaf, arr in parts.items():
                self.tensors[f"{prefix}.{leaf}"] = arr
        else:
            raise ValueError(f"unsupported embedding spec {type(spec).__name__}")

    # -- model assembly --------------------------------------------------

    def build_decoder(self, cfg: DecoderConfig, linear_spec, embedding_spec,
                      expert_spec=None) -> None:
        if cfg.ple_model_config is not None:
            raise NotImplementedError("per-layer embeddings are not ported yet")
        tcfg = cfg.transformer_config
        d = tcfg.model_dim
        if isinstance(cfg.embedding_config, TiedEmbeddingConfig):
            self.embedding("embedding", cfg.vocab_size, d, embedding_spec)
        else:
            self.embedding("input_embedding", cfg.vocab_size, d, embedding_spec)
            self.embedding("output_embedding", cfg.vocab_size, d, embedding_spec)
        for i, lc in enumerate(tcfg.layer_configs):
            self.layer_tensors(f"transformer.layers.{i}", lc, d, tcfg.hidden_dim, linear_spec,
                               expert_spec)
        self.norm_scales("transformer.output_norm", d, tcfg.output_norm_config.has_biases)

    def layer_tensors(self, p: str, lc, d: int, default_hidden: int, linear_spec,
                      expert_spec=None) -> None:
        m = lc.mixer_config
        if not isinstance(m, AttentionConfig):
            raise NotImplementedError(f"{type(m).__name__} mixers are not ported yet")
        if lc.ple_config is not None:
            raise NotImplementedError("per-layer embeddings are not ported yet")
        q_dim = m.num_heads * m.head_dim
        qkv_out = q_dim if m.is_kv_sharing else q_dim + 2 * m.num_groups * m.head_dim
        self.linear(f"{p}.mixer.qkv_projection", d, qkv_out, linear_spec, m.has_qkv_biases)
        self.linear(f"{p}.mixer.out_projection", q_dim, d, linear_spec, m.has_out_biases)
        if m.gate_projection_config is not None:
            self.linear(f"{p}.mixer.gate_projection", d, q_dim, linear_spec, False)
        if m.query_norm_config is not None:
            self.tensors[f"{p}.mixer.query_norm.scales"] = np.ones(m.head_dim, np.float32)
        if m.key_norm_config is not None and not m.is_kv_sharing:
            self.tensors[f"{p}.mixer.key_norm.scales"] = np.ones(m.head_dim, np.float32)
        if m.has_sinks:
            self.dense(f"{p}.mixer.sinks", (m.num_heads,), scale=1.0)
        if lc.pre_mixer_norm_config is not None:
            self.norm_scales(f"{p}.pre_mixer_norm", d, lc.pre_mixer_norm_config.has_biases)
        if lc.post_mixer_norm_config is not None:
            self.norm_scales(f"{p}.post_mixer_norm", d, lc.post_mixer_norm_config.has_biases)
        self.norm_scales(f"{p}.pre_mlp_norm", d, lc.pre_mlp_norm_config.has_biases)
        if lc.post_mlp_norm_config is not None:
            self.norm_scales(f"{p}.post_mlp_norm", d, lc.post_mlp_norm_config.has_biases)
        if lc.has_post_layer_scalar:
            self.tensors[f"{p}.post_layer_scalar"] = cast(np.full((1,), 1.0, np.float32),
                                                          self.dtype)
        mlp = lc.mlp_config
        hid = lc.hidden_dim or default_hidden
        if isinstance(mlp, DenseMLPConfig):
            self.linear(f"{p}.mlp.up_projection", d, 2 * hid, linear_spec, mlp.has_up_biases)
            self.linear(f"{p}.mlp.down_projection", hid, d, linear_spec, mlp.has_down_biases)
        elif isinstance(mlp, MixtureOfExpertsConfig):
            self.moe_tensors(f"{p}.mlp", mlp, d,
                             expert_spec if expert_spec is not None else linear_spec)
        else:
            raise NotImplementedError(f"{type(mlp).__name__} MLPs are not ported yet")

    def moe_tensors(self, p: str, mlp: MixtureOfExpertsConfig, d: int, e_spec) -> None:
        """Router and expert stacks. A symmetric IntSpec whose group divides
        d and dff quantizes the stacks expert by expert; any other spec
        keeps them dense in the model dtype."""
        e, dff = mlp.num_routed_experts, mlp.expert_hidden_dim
        self.linear(f"{p}.router", d, e, FullPrecisionSpec(layout=Layout.OUTPUT_INPUT),
                    mlp.router_has_biases)
        quant = (isinstance(e_spec, IntSpec) and e_spec.is_symmetric
                 and d % e_spec.group_size == 0 and dff % e_spec.group_size == 0)
        for role, shape in (("up_projection", (e, 2 * dff, d)),
                            ("down_projection", (e, d, dff))):
            prefix = f"{p}.experts.{role}.weights"
            if quant:
                self.metadata[f"{prefix}.spec"] = config_dumps(e_spec)
                parts = [quantize_reference(self._random(shape[1:], self.weight_scale),
                                            e_spec.bits, e_spec.group_size,
                                            "scale_symmetric", dtype=self.dtype)
                         for _ in range(e)]
                self.tensors[f"{prefix}.weights"] = np.stack([q["weights"] for q in parts])
                self.tensors[f"{prefix}.scales"] = np.stack([q["scales"] for q in parts])
            else:
                self.dense(f"{prefix}.weights", shape)
        if mlp.expert_config.has_up_biases:
            self.dense(f"{p}.experts.up_projection.biases", (e, 2 * dff))
        if mlp.expert_config.has_down_biases:
            self.dense(f"{p}.experts.down_projection.biases", (e, d))

    def write(self, out_dir: str, cfg: LanguageModelConfig) -> str:
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, "config.json"), "w") as f:
            json.dump(dump_cfg(cfg), f, indent=1)
        # write-then-rename: a killed synth must not leave a partial
        # model.safetensors that existence checks mistake for complete
        final = os.path.join(out_dir, "model.safetensors")
        tmp = final + ".tmp"
        save_file(tmp, self.tensors, self.metadata)
        os.replace(tmp, final)
        return out_dir


def synthesize(cfg: LanguageModelConfig, out_dir: str, *, seed: int = 0, linear_spec=None,
               embedding_spec=None, expert_spec=None, dtype=BF16, fill: str = "normal") -> str:
    """expert_spec: the spec of MoE expert stacks only (default
    linear_spec); gpt-oss pairs full-precision linears with quantized
    experts."""
    linear_spec = linear_spec or FullPrecisionSpec(layout=Layout.OUTPUT_INPUT)
    embedding_spec = embedding_spec or FullPrecisionSpec(layout=Layout.INPUT_OUTPUT)
    b = ModelBuilder(seed=seed, dtype=dtype, fill=fill)
    b.build_decoder(cfg.decoder_config, linear_spec, embedding_spec, expert_spec)
    return b.write(out_dir, cfg)


# --------------------------------------------------------------------------
# Canonical architecture configs for tests/benchmarks
# --------------------------------------------------------------------------


def _rms(eps=1e-5, offset=None, upcast=UpcastMode.ONLY_NORMALIZATION):
    return NormalizationConfig(
        epsilon=eps, scale_offset=offset, upcast_mode=upcast, subtract_mean=False, has_biases=False
    )


def llama_config(
    *,
    num_layers: int = 4,
    model_dim: int = 256,
    hidden_dim: int = 1024,
    num_heads: int = 8,
    num_groups: int = 2,
    head_dim: int = 32,
    vocab_size: int = 1024,
    max_seq: int = 2048,
    rope_base: float = 500000.0,
    tied: bool = True,
    llama3_rope_scaling: bool = False,
) -> LanguageModelConfig:
    """A Llama-3.2-style config (GQA, SiLU MLP, RMSNorm, tied embeddings)."""
    if llama3_rope_scaling:
        rope = LlamaRoPEConfig(
            base=rope_base,
            max_sequence_length=max_seq,
            head_dim=head_dim,
            scaling_factor=32.0,
            original_context_length=8192,
            low_frequency_factor=1.0,
            high_frequency_factor=4.0,
        )
    else:
        rope = UnscaledRoPEConfig(base=rope_base, max_sequence_length=max_seq, head_dim=head_dim)
    attn = AttentionConfig(
        qkv_projection_config=LinearConfig(),
        out_projection_config=LinearConfig(),
        query_norm_config=None,
        key_norm_config=None,
        num_heads=num_heads,
        num_groups=num_groups,
        head_dim=head_dim,
        is_causal=True,
        scale=None,
        sliding_window_size=None,
        logit_soft_cap=None,
        has_sinks=False,
        has_qkv_biases=False,
        has_out_biases=False,
        gate_projection_config=None,
        normalize_values=False,
        is_kv_sharing=False,
    )
    mlp = DenseMLPConfig(
        linear_config=LinearConfig(),
        activation=SiLU(alpha=1.0),
        has_up_biases=False,
        has_down_biases=False,
        gate_clipping=None,
        up_clipping=None,
    )
    layer = TransformerLayerConfig(
        pre_mixer_norm_config=_rms(),
        mixer_config=attn,
        post_mixer_norm_config=None,
        pre_mlp_norm_config=_rms(),
        mlp_config=mlp,
        post_mlp_norm_config=None,
        hidden_dim=None,
        ple_config=None,
        has_post_layer_scalar=False,
        kv_source_layer_index=None,
        rope_config=rope,
    )
    decoder = DecoderConfig(
        embedding_config=TiedEmbeddingConfig(input_scale=None, logit_soft_cap=None)
        if tied
        else UntiedEmbeddingConfig(input_scale=None, logit_soft_cap=None),
        transformer_config=TransformerConfig(
            layer_configs=tuple([layer] * num_layers),
            output_norm_config=_rms(),
            model_dim=model_dim,
            hidden_dim=hidden_dim,
        ),
        vocab_size=vocab_size,
        ple_model_config=None,
    )
    return LanguageModelConfig(
        decoder_config=decoder,
        generation_config=GenerationConfig(
            stop_token_ids=(0,),
            temperature=None,
            top_k=None,
            top_p=None,
            min_p=None,
            banned_tokens=None,
            repetition_penalty=None,
            presence_penalty=None,
            frequency_penalty=None,
            suffix_repetition_length=None,
        ),
    )


def _with_mlp(base: LanguageModelConfig, layers, hidden_dim: int) -> LanguageModelConfig:
    dc = base.decoder_config
    decoder = DecoderConfig(
        embedding_config=dc.embedding_config,
        transformer_config=TransformerConfig(
            layer_configs=tuple(layers),
            output_norm_config=dc.transformer_config.output_norm_config,
            model_dim=dc.transformer_config.model_dim,
            hidden_dim=hidden_dim,
        ),
        vocab_size=dc.vocab_size,
        ple_model_config=None,
    )
    return LanguageModelConfig(decoder_config=decoder, generation_config=base.generation_config)


def _moe(expert: DenseMLPConfig, num_experts: int, num_active: int, expert_hidden_dim: int,
         router_biases: bool) -> MixtureOfExpertsConfig:
    return MixtureOfExpertsConfig(
        expert_config=expert,
        router_config=LinearConfig(),
        routing_function=SoftmaxRouting(),
        num_routed_experts=num_experts,
        num_active_routed_experts=num_active,
        router_has_biases=router_biases,
        num_shared_experts=0,
        expert_hidden_dim=expert_hidden_dim,
        gate_config=None,
    )


def moe_config(
    *, num_layers: int = 2, model_dim: int = 64, hidden_dim: int = 128,
    vocab_size: int = 512, num_experts: int = 8, num_active: int = 2,
    expert_hidden_dim: int = 96, with_biases: bool = True,
    attn_heads: int = 4, attn_groups: int = 2, attn_head_dim: int = 16,
) -> LanguageModelConfig:
    """gpt-oss-style MoE decoder (every layer MoE, softmax routing)."""
    base = llama_config(
        num_layers=num_layers, model_dim=model_dim, hidden_dim=hidden_dim,
        num_heads=attn_heads, num_groups=attn_groups, head_dim=attn_head_dim,
        vocab_size=vocab_size,
    )
    expert = DenseMLPConfig(
        linear_config=LinearConfig(),
        activation=SiLU(alpha=1.0),
        has_up_biases=with_biases,
        has_down_biases=with_biases,
        gate_clipping=None,
        up_clipping=None,
    )
    moe = _moe(expert, num_experts, num_active, expert_hidden_dim, with_biases)
    layers = [dataclasses.replace(lc, mlp_config=moe)
              for lc in base.decoder_config.transformer_config.layer_configs]
    return _with_mlp(base, layers, hidden_dim)


def gptoss_config(
    *, num_layers: int = 2, model_dim: int = 64, num_heads: int = 4,
    num_groups: int = 2, head_dim: int = 16, vocab_size: int = 512,
    num_experts: int = 8, num_active: int = 2, expert_hidden_dim: int = 96,
    sliding_window: int = 24, max_seq: int = 2048, rope_base: float = 150000.0,
) -> LanguageModelConfig:
    """gpt-oss-style decoder: every layer MoE with softmax-after-top-k
    routing and biased routers and experts, attention sinks on every layer,
    sliding and full attention alternating (sliding first), qkv and out
    biases, untied embeddings. The expert activation is SiLU(1.702) with
    gate clipped to (-inf, 7] and up to [-6, 8]: the published formula's
    "+1" on up is folded into the up bias, so converters add 1 to it."""
    base = llama_config(
        num_layers=num_layers, model_dim=model_dim, hidden_dim=expert_hidden_dim,
        num_heads=num_heads, num_groups=num_groups, head_dim=head_dim,
        vocab_size=vocab_size, max_seq=max_seq, rope_base=rope_base, tied=False,
    )
    expert = DenseMLPConfig(
        linear_config=LinearConfig(),
        activation=SiLU(alpha=1.702),
        has_up_biases=True,
        has_down_biases=True,
        gate_clipping=(None, 7.0),
        up_clipping=(-6.0, 8.0),
    )
    moe = _moe(expert, num_experts, num_active, expert_hidden_dim, True)
    layers = [
        dataclasses.replace(lc, mlp_config=moe, mixer_config=dataclasses.replace(
            lc.mixer_config, has_sinks=True, has_qkv_biases=True, has_out_biases=True,
            sliding_window_size=sliding_window if (i + 1) % 2 else None))
        for i, lc in enumerate(base.decoder_config.transformer_config.layer_configs)
    ]
    return _with_mlp(base, layers, expert_hidden_dim)
