"""Model config schema — on-disk compatible with the reference engine.

Field names, "type" tags, and nesting mirror uzu's config structs so that
uzu-exported `config.json` files load unchanged:
  - reference: crates/backend-uzu/src/config/model/language_model.rs,
    decoder.rs, transformer.rs, transformer_layer.rs, token_mixer/*.rs,
    mlp/*.rs, rope/*.rs, weight_matrix/*.rs, normalization.rs, embedding/*.rs,
    activation/*.rs, per_layer_embedding.rs, model/generation.rs.

Polymorphic nodes carry `"type": "<StructName>"` (uzu's monostate MustBe! tag,
reference: crates/proc-macros/src/uzu_config.rs:146-160).
"""

from __future__ import annotations

import enum
from typing import Optional

from .serde import Family, config, config_member


class Layout(enum.Enum):
    OUTPUT_INPUT = "output_input"
    INPUT_OUTPUT = "input_output"


class UpcastMode(enum.Enum):
    ONLY_NORMALIZATION = "only_normalization"
    FULL_LAYER = "full_layer"


class IncoherenceProcessingMode(enum.Enum):
    INPUT = "input"
    OUTPUT = "output"
    INPUT_OUTPUT = "input_output"


# --------------------------------------------------------------------------
# Weight matrix specs (reference: config/weight_matrix/*.rs)
# --------------------------------------------------------------------------


@config_member("WeightMatrixSpec")
class FullPrecisionSpec:
    layout: Layout


@config_member("WeightMatrixSpec")
class IntSpec:
    bits: int
    group_size: int
    is_symmetric: bool
    layout: Layout


@config_member("WeightMatrixSpec")
class MLXSpec:
    """Scale+bias grouped quantization (MLX layout)."""

    bits: int
    group_size: int
    layout: Layout


@config_member("WeightMatrixSpec")
class LowRankSpec:
    rank: int


@config_member("WeightMatrixSpec")
class HybridSpec:
    """Quantized base + optional low-rank adapter + optional RHT incoherence."""

    quantization_spec: Family["WeightMatrixSpec"]
    adapter_spec: Optional[Family["WeightMatrixSpec"]]
    incoherence_block_size: Optional[int]
    incoherence_processing_mode: IncoherenceProcessingMode


# --------------------------------------------------------------------------
# Common leaf configs
# --------------------------------------------------------------------------


@config
class NormalizationConfig:
    epsilon: float
    scale_offset: Optional[float]
    upcast_mode: UpcastMode
    subtract_mean: bool
    has_biases: bool


@config
class LinearConfig:
    """Empty marker (spec lives in safetensors metadata), like uzu's."""


@config
class SeparableCausalConvConfig:
    has_biases: bool


@config_member("Activation")
class SiLU:
    alpha: float = 1.0


@config_member("Activation")
class GELU:
    approximate: bool


@config_member("Activation")
class Identity:
    pass


# --------------------------------------------------------------------------
# RoPE family (reference: config/rope/*.rs). Shared "super" fields
# (base, max_sequence_length, head_dim) are inlined per variant.
# --------------------------------------------------------------------------


@config_member("RoPEConfig")
class UnscaledRoPEConfig:
    base: float
    max_sequence_length: int
    head_dim: int


@config_member("RoPEConfig")
class LlamaRoPEConfig:
    base: float
    max_sequence_length: int
    head_dim: int
    scaling_factor: float
    original_context_length: int
    low_frequency_factor: float
    high_frequency_factor: float


@config_member("RoPEConfig")
class YARNRoPEConfig:
    base: float
    max_sequence_length: int
    head_dim: int
    scaling_factor: float
    original_context_length: int
    beta_fast: float
    beta_slow: float
    truncate: bool


@config_member("RoPEConfig")
class LinearScalingRoPEConfig:
    base: float
    max_sequence_length: int
    head_dim: int
    scaling_factor: float


@config_member("RoPEConfig")
class LongRoPEConfig:
    base: float
    max_sequence_length: int
    head_dim: int
    short_factor: tuple[float, ...]
    long_factor: tuple[float, ...]
    original_context_length: int
    scaling_factor: float


# --------------------------------------------------------------------------
# Token mixers (reference: config/token_mixer/*.rs)
# --------------------------------------------------------------------------


@config_member("TokenMixerConfig")
class AttentionConfig:
    qkv_projection_config: LinearConfig
    out_projection_config: LinearConfig
    query_norm_config: Optional[NormalizationConfig]
    key_norm_config: Optional[NormalizationConfig]
    num_heads: int
    num_groups: int
    head_dim: int
    is_causal: bool
    scale: Optional[float]
    sliding_window_size: Optional[int]
    logit_soft_cap: Optional[float]
    has_sinks: bool
    has_qkv_biases: bool
    has_out_biases: bool
    gate_projection_config: Optional[LinearConfig]
    normalize_values: bool
    is_kv_sharing: bool

    def value_norm_config(self) -> Optional[NormalizationConfig]:
        if not self.normalize_values:
            return None
        return NormalizationConfig(
            epsilon=1e-6,
            scale_offset=None,
            upcast_mode=UpcastMode.FULL_LAYER,
            subtract_mean=False,
            has_biases=False,
        )


@config_member("TokenMixerConfig")
class Mamba2Config:
    in_projection_config: LinearConfig
    out_projection_config: LinearConfig
    conv_config: SeparableCausalConvConfig
    activation: Family["Activation"]
    kernel_size: int
    num_heads: int
    num_groups: int
    head_dim: int
    state_dim: int
    has_in_biases: bool
    has_out_biases: bool


@config_member("TokenMixerConfig")
class DeltaNetConfig:
    in_proj_config: LinearConfig
    conv_config: SeparableCausalConvConfig
    out_proj_config: LinearConfig
    norm_config: NormalizationConfig
    num_heads: int
    num_groups: int
    head_dim: int
    value_head_dim: int
    kernel_size: int


@config_member("TokenMixerConfig")
class ShortConvConfig:
    in_projection_config: LinearConfig
    conv_config: SeparableCausalConvConfig
    out_projection_config: LinearConfig
    kernel_size: int


# --------------------------------------------------------------------------
# MLP family (reference: config/mlp/*.rs)
# --------------------------------------------------------------------------


@config_member("RoutingFunction")
class SoftmaxRouting:
    pass


@config_member("MLPConfig")
class DenseMLPConfig:
    linear_config: LinearConfig
    activation: Family["Activation"]
    has_up_biases: bool
    has_down_biases: bool
    gate_clipping: Optional[tuple[Optional[float], Optional[float]]]
    up_clipping: Optional[tuple[Optional[float], Optional[float]]]


@config_member("MLPConfig")
class MixtureOfExpertsConfig:
    expert_config: DenseMLPConfig
    router_config: LinearConfig
    routing_function: Family["RoutingFunction"]
    num_routed_experts: int
    num_active_routed_experts: int
    router_has_biases: bool
    num_shared_experts: int
    expert_hidden_dim: int
    gate_config: Optional[LinearConfig]


# --------------------------------------------------------------------------
# Embedding family (reference: config/embedding/*.rs). Super fields
# input_scale / logit_soft_cap inlined per variant.
# --------------------------------------------------------------------------


@config_member("EmbeddingConfig")
class TiedEmbeddingConfig:
    input_scale: Optional[float]
    logit_soft_cap: Optional[float]


@config_member("EmbeddingConfig")
class UntiedEmbeddingConfig:
    input_scale: Optional[float]
    logit_soft_cap: Optional[float]


# --------------------------------------------------------------------------
# Per-layer embeddings (Gemma PLE, reference: config/per_layer_embedding.rs)
# --------------------------------------------------------------------------


@config
class PLEModelConfig:
    ple_dim: int
    num_layers: int
    ple_vocab_size: int
    ple_embed_scale: float
    model_projection_scale: float
    input_scale: float
    linear_config: LinearConfig
    norm_config: NormalizationConfig


@config
class PLELayerConfig:
    linear_config: LinearConfig
    norm_config: NormalizationConfig
    ple_dim: int
    activation: Family["Activation"]


# --------------------------------------------------------------------------
# Layer / transformer / decoder / model (reference: config/transformer_layer.rs,
# transformer.rs, decoder.rs, model/language_model.rs, model/generation.rs)
# --------------------------------------------------------------------------


@config
class TransformerLayerConfig:
    pre_mixer_norm_config: Optional[NormalizationConfig]
    mixer_config: Family["TokenMixerConfig"]
    post_mixer_norm_config: Optional[NormalizationConfig]
    pre_mlp_norm_config: NormalizationConfig
    mlp_config: Family["MLPConfig"]
    post_mlp_norm_config: Optional[NormalizationConfig]
    hidden_dim: Optional[int]
    ple_config: Optional[PLELayerConfig]
    has_post_layer_scalar: bool
    kv_source_layer_index: Optional[int]
    rope_config: Optional[Family["RoPEConfig"]]


@config
class TransformerConfig:
    layer_configs: tuple[TransformerLayerConfig, ...]
    output_norm_config: NormalizationConfig
    model_dim: int
    hidden_dim: int


@config
class DecoderConfig:
    embedding_config: Family["EmbeddingConfig"]
    transformer_config: TransformerConfig
    vocab_size: int
    ple_model_config: Optional[PLEModelConfig]


@config
class GenerationConfig:
    stop_token_ids: tuple[int, ...]
    temperature: Optional[float]
    top_k: Optional[int]
    top_p: Optional[float]
    min_p: Optional[float]
    banned_tokens: Optional[object]
    repetition_penalty: Optional[float]
    presence_penalty: Optional[object]
    frequency_penalty: Optional[object]
    suffix_repetition_length: Optional[int]


@config_member("ModelConfig")
class LanguageModelConfig:
    decoder_config: DecoderConfig
    generation_config: GenerationConfig


# --------------------------------------------------------------------------
# Classifier (reference: config/classifier.rs, config/model/classifier_model.rs)
# --------------------------------------------------------------------------


class PoolingType(enum.Enum):
    CLS = "cls"
    MEAN = "mean"


@config
class PredictionHeadConfig:
    dense_config: LinearConfig
    activation: Family["Activation"]
    normalization_config: NormalizationConfig
    readout_config: LinearConfig
    use_dense_bias: bool


@config
class ClassifierConfig:
    embedding_config: Family["EmbeddingConfig"]
    embedding_norm_config: NormalizationConfig
    transformer_config: TransformerConfig
    prediction_head_config: PredictionHeadConfig
    vocab_size: int
    model_dim: int
    hidden_dim: int
    num_labels: int
    classifier_pooling: PoolingType
    output_labels: Optional[tuple[str, ...]]


@config_member("ModelConfig")
class ClassifierModelConfig:
    classifier_config: ClassifierConfig


# --------------------------------------------------------------------------
# Speculator (DFlash draft + weaver; reference: config/{dflash,weaver}.rs,
# config/speculator/)
# --------------------------------------------------------------------------


@config
class DFlashDraftConfig:
    model_dim: int
    hidden_dim: int
    block_size: int
    mask_token_id: int
    target_layer_ids: tuple[int, ...]
    num_target_layers: int
    vocab_size: int
    context_projection_config: LinearConfig
    context_norm_config: NormalizationConfig
    rope_config: Family["RoPEConfig"]
    layer_configs: tuple[TransformerLayerConfig, ...]
    output_norm_config: NormalizationConfig


@config
class WeaverConfig:
    model_dim: int
    target_model_dim: int
    target_embedding_dim: int
    num_layers: int
    num_heads: int
    hidden_dim: int
    max_depth: int
    candidate_pool_size: int
    linear_config: LinearConfig
    norm_config: NormalizationConfig
    rope_config: Family["RoPEConfig"]


@config_member("SpeculatorConfig")
class DFlashSpeculatorConfig:
    draft_config: DFlashDraftConfig
    weaver_config: WeaverConfig


@config_member("SpeculatorConfig", tag="SpeculatorModelConfig")
class SpeculatorModelConfig:
    speculator_config: Family["SpeculatorConfig"]
