"""Synthesize model directories (config.json + model.safetensors), numpy only.

Counterpart of `uzu_tpu/tools/synth.py` for the decoder shapes the port
runs (attention, ShortConv, Mamba2, Gated DeltaNet and Mamba-1 mixers, dense and
mixture-of-experts MLPs, per-layer embeddings, full-precision / IntSpec /
MLXSpec / HybridSpec weights, dense or symmetric-quantized expert stacks):
with the same seed, fill and specs it draws the same random numbers in the
same order and writes the same bytes, bf16 included, without `ml_dtypes`.
Mamba-1 (`jamba_config`) is the port's own and has no JAX counterpart.
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np

from ..config import dumps as config_dumps
from ..config.model import (
    GELU,
    AttentionConfig,
    DecoderConfig,
    DeltaNetConfig,
    DenseMLPConfig,
    FullPrecisionSpec,
    GenerationConfig,
    HybridSpec,
    IntSpec,
    LanguageModelConfig,
    Layout,
    LinearConfig,
    LlamaRoPEConfig,
    Mamba1Config,
    Mamba2Config,
    MixtureOfExpertsConfig,
    MLXSpec,
    NormalizationConfig,
    PLELayerConfig,
    PLEModelConfig,
    SeparableCausalConvConfig,
    ShortConvConfig,
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
from ..ops.rht import transform_weight_for_storage
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
               has_biases: bool, weights: np.ndarray | None = None) -> None:
        """Emit one linear's tensors under `prefix` per the weight spec.
        `weights` (float [N, K]) gives exact values (quantized specs
        quantize them); otherwise random values are drawn."""
        self.metadata[f"{prefix}.weights.spec"] = config_dumps(spec)
        if isinstance(spec, FullPrecisionSpec):
            if weights is not None:
                self.tensors[f"{prefix}.weights.weights"] = cast(weights, self.dtype)
            else:
                self.dense(f"{prefix}.weights.weights", (output_dim, input_dim))
        elif isinstance(spec, (IntSpec, MLXSpec)):
            if weights is None:
                weights = self._random((output_dim, input_dim), self.weight_scale)
            parts = quantize_reference(weights, spec.bits, spec.group_size, _method(spec),
                                       dtype=self.dtype)
            for leaf, arr in parts.items():
                self.tensors[f"{prefix}.weights.{leaf}"] = arr
        elif isinstance(spec, HybridSpec):
            # the JAX synthesizer's draws in its order: the weights, the
            # input and output signs, then the adapter
            base = spec.quantization_spec
            stored = (self._random((output_dim, input_dim), self.weight_scale)
                      if weights is None else weights)
            if spec.incoherence_block_size is not None:
                si = self.rng.choice([-1, 1], input_dim).astype(np.int32)
                so = self.rng.choice([-1, 1], output_dim).astype(np.int32)
                self.tensors[f"{prefix}.weights.incoherence_signs.input_signs"] = si
                self.tensors[f"{prefix}.weights.incoherence_signs.output_signs"] = so
                stored = transform_weight_for_storage(stored, si, so)
            parts = quantize_reference(stored, base.bits, base.group_size, _method(base),
                                       dtype=self.dtype)
            for leaf, arr in parts.items():
                self.tensors[f"{prefix}.weights.quantized.{leaf}"] = arr
            if spec.adapter_spec is not None:
                rank = spec.adapter_spec.rank
                self.dense(f"{prefix}.weights.adapter.down_projection", (rank, input_dim))
                self.dense(f"{prefix}.weights.adapter.up_projection", (output_dim, rank))
        else:
            raise ValueError(f"unsupported spec {type(spec).__name__}")
        if has_biases:
            self.dense(f"{prefix}.biases", (output_dim,))

    def embedding(self, prefix: str, vocab: int, dim: int, spec,
                  weights: np.ndarray | None = None) -> None:
        self.metadata[f"{prefix}.spec"] = config_dumps(spec)
        if isinstance(spec, FullPrecisionSpec):
            if weights is not None:
                self.tensors[f"{prefix}.weights"] = cast(weights, self.dtype)
            else:
                self.dense(f"{prefix}.weights", (vocab, dim))
        elif isinstance(spec, (IntSpec, MLXSpec)):
            if weights is None:
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
        if cfg.ple_model_config is not None:
            pm = cfg.ple_model_config
            total = pm.num_layers * pm.ple_dim
            self.dense("per_layer_embedding.token_embedding", (pm.ple_vocab_size, total))
            self.linear("per_layer_embedding.model_projection", d, total,
                        FullPrecisionSpec(layout=Layout.OUTPUT_INPUT), False)
            self.norm_scales("per_layer_embedding.projection_norm", pm.ple_dim,
                             pm.norm_config.has_biases)

    def layer_tensors(self, p: str, lc, d: int, default_hidden: int, linear_spec,
                      expert_spec=None) -> None:
        m = lc.mixer_config
        if isinstance(m, AttentionConfig):
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
        else:
            self.recurrent_mixer_tensors(f"{p}.mixer", m, d, linear_spec)
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
        if lc.ple_config is not None:
            pc = lc.ple_config
            self.linear(f"{p}.ple.gate", d, pc.ple_dim, linear_spec, False)
            self.linear(f"{p}.ple.projection", pc.ple_dim, d, linear_spec, False)
            self.norm_scales(f"{p}.ple.norm", d, pc.norm_config.has_biases)
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

    def recurrent_mixer_tensors(self, p: str, m, d: int, linear_spec) -> None:
        """A ShortConv, Mamba2 or Gated DeltaNet mixer's tensors under `p`,
        drawn in the JAX synthesizer's order."""
        if isinstance(m, ShortConvConfig):
            self.linear(f"{p}.in_projection", d, 3 * d, linear_spec, False)
            self.linear(f"{p}.out_projection", d, d, linear_spec, False)
            self.dense(f"{p}.conv.weights", (d, m.kernel_size), np.float32, scale=0.4)
            if m.conv_config.has_biases:
                self.dense(f"{p}.conv.biases", (d,), np.float32)
        elif isinstance(m, Mamba2Config):
            inner = m.num_heads * m.head_dim
            conv_dim = inner + 2 * m.num_groups * m.state_dim
            self.linear(f"{p}.in_projection", d, conv_dim + inner + m.num_heads, linear_spec,
                        m.has_in_biases)
            self.linear(f"{p}.out_projection", inner, d, linear_spec, m.has_out_biases)
            self.dense(f"{p}.gate_bias", (inner,), np.float32)
            self.dense(f"{p}.conv.weights", (conv_dim, m.kernel_size), np.float32, scale=0.4)
            if m.conv_config.has_biases:
                self.dense(f"{p}.conv.biases", (conv_dim,), np.float32)
            self.dense(f"{p}.skip_connection_weight", (m.num_heads,), np.float32, scale=0.5)
        elif isinstance(m, DeltaNetConfig):
            key_dim = m.num_groups * m.head_dim
            value_dim = m.num_heads * m.value_head_dim
            conv_dim = 2 * key_dim + value_dim
            self.linear(f"{p}.in_proj", d, conv_dim + value_dim + 2 * m.num_heads, linear_spec,
                        False)
            self.linear(f"{p}.out_proj", value_dim, d, linear_spec, False)
            self.dense(f"{p}.conv.weights", (conv_dim, m.kernel_size), np.float32, scale=0.4)
            if m.conv_config.has_biases:
                self.dense(f"{p}.conv.biases", (conv_dim,), np.float32)
            self.dense(f"{p}.a_log", (m.num_heads,), np.float32, scale=0.3)
            self.dense(f"{p}.dt_bias", (m.num_heads,), np.float32, scale=0.3)
            self.tensors[f"{p}.norm.scales"] = np.ones(m.value_head_dim, np.float32)
        elif isinstance(m, Mamba1Config):
            # Mamba's published initialisation where it is not noise: A_log
            # = log(1..N) in every channel, dt_bias = softplus^-1 of a
            # log-uniform draw in [1e-3, 1e-1], D = 1
            di, n, r = m.inner_dim, m.state_dim, m.dt_rank
            self.linear(f"{p}.in_projection", d, 2 * di, linear_spec, False)
            self.linear(f"{p}.x_projection", di, r + 2 * n, linear_spec, False)
            self.linear(f"{p}.dt_projection", r, di, linear_spec, False)
            self.linear(f"{p}.out_projection", di, d, linear_spec, False)
            self.dense(f"{p}.conv.weights", (di, m.kernel_size), np.float32, scale=0.4)
            if m.conv_config.has_biases:
                self.dense(f"{p}.conv.biases", (di,), np.float32, scale=0.1)
            self.tensors[f"{p}.a_log"] = np.log(np.tile(np.arange(1, n + 1, dtype=np.float32),
                                                        (di, 1)))
            dt = np.exp(self.rng.uniform(np.log(1e-3), np.log(1e-1), di)).astype(np.float32)
            self.tensors[f"{p}.dt_bias"] = dt + np.log(-np.expm1(-dt))
            self.tensors[f"{p}.skip_connection_weight"] = np.ones(di, np.float32)
            for name, dim in (("dt_norm", r), ("b_norm", n), ("c_norm", n)):
                self.norm_scales(f"{p}.{name}", dim, False)
        else:
            raise ValueError(f"unsupported mixer {type(m).__name__}")

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


def _hybrid_config(
    mixer_for_layer,
    *,
    num_layers: int,
    model_dim: int,
    hidden_dim: int,
    vocab_size: int,
    max_seq: int = 4096,
    rope_base: float = 1000000.0,
    attn_heads: int = 8,
    attn_groups: int = 2,
    attn_head_dim: int = 32,
) -> LanguageModelConfig:
    """A hybrid model: `mixer_for_layer(i)` returns a recurrent mixer
    config, or None for a standard attention layer (recurrent mixers with
    periodic full-attention layers, as in LFM2 and Qwen3.5)."""
    base = llama_config(
        num_layers=num_layers, model_dim=model_dim, hidden_dim=hidden_dim,
        num_heads=attn_heads, num_groups=attn_groups, head_dim=attn_head_dim,
        vocab_size=vocab_size, max_seq=max_seq, rope_base=rope_base,
    )
    layers = []
    for i, lc in enumerate(base.decoder_config.transformer_config.layer_configs):
        mixer = mixer_for_layer(i)
        # recurrent mixers take no RoPE
        layers.append(lc if mixer is None else dataclasses.replace(
            lc, mixer_config=mixer, rope_config=None))
    return _with_mlp(base, layers, hidden_dim)


def lfm2_config(
    *, num_layers: int = 4, model_dim: int = 128, hidden_dim: int = 256,
    vocab_size: int = 512, kernel_size: int = 3, attn_every: int = 3,
) -> LanguageModelConfig:
    """LFM2-style hybrid: ShortConv mixers with periodic GQA attention."""
    conv = ShortConvConfig(
        in_projection_config=LinearConfig(),
        conv_config=SeparableCausalConvConfig(has_biases=False),
        out_projection_config=LinearConfig(),
        kernel_size=kernel_size,
    )
    return _hybrid_config(
        lambda i: None if (i % attn_every == attn_every - 1) else conv,
        num_layers=num_layers, model_dim=model_dim, hidden_dim=hidden_dim,
        vocab_size=vocab_size,
    )


def mamba2_hybrid_config(
    *, num_layers: int = 4, model_dim: int = 128, hidden_dim: int = 256,
    vocab_size: int = 512, num_heads: int = 4, num_groups: int = 2,
    head_dim: int = 16, state_dim: int = 32, kernel_size: int = 4,
    attn_every: int = 4,
) -> LanguageModelConfig:
    """Mamba2 mixers with periodic GQA attention."""
    mamba = Mamba2Config(
        in_projection_config=LinearConfig(),
        out_projection_config=LinearConfig(),
        conv_config=SeparableCausalConvConfig(has_biases=True),
        activation=SiLU(alpha=1.0),
        kernel_size=kernel_size,
        num_heads=num_heads,
        num_groups=num_groups,
        head_dim=head_dim,
        state_dim=state_dim,
        has_in_biases=False,
        has_out_biases=False,
    )
    return _hybrid_config(
        lambda i: None if (i % attn_every == attn_every - 1) else mamba,
        num_layers=num_layers, model_dim=model_dim, hidden_dim=hidden_dim,
        vocab_size=vocab_size,
    )


def jamba_config(
    *, num_layers: int = 4, model_dim: int = 256, hidden_dim: int = 512,
    vocab_size: int = 512, inner_dim: int = 512, state_dim: int = 16, dt_rank: int = 16,
    kernel_size: int = 4, attn_period: int = 4, attn_offset: int = 2, num_heads: int = 4,
    num_groups: int = 1, head_dim: int = 64, norm_eps: float = 1e-6,
) -> LanguageModelConfig:
    """Jamba-style hybrid: Mamba-1 mixers (RMS-normalized dt, B and C; conv
    bias; no projection biases) with attention at the layers where i %
    attn_period == attn_offset; no positional encoding anywhere (NoPE),
    RMSNorm of eps `norm_eps` throughout."""
    norm = _rms(norm_eps)
    mamba = Mamba1Config(
        in_projection_config=LinearConfig(), x_projection_config=LinearConfig(),
        dt_projection_config=LinearConfig(), out_projection_config=LinearConfig(),
        conv_config=SeparableCausalConvConfig(has_biases=True), kernel_size=kernel_size,
        inner_dim=inner_dim, state_dim=state_dim, dt_rank=dt_rank, dt_norm_config=norm,
        b_norm_config=norm, c_norm_config=norm, activation=SiLU(alpha=1.0))
    base = _hybrid_config(
        lambda i: None if i % attn_period == attn_offset else mamba,
        num_layers=num_layers, model_dim=model_dim, hidden_dim=hidden_dim,
        vocab_size=vocab_size, attn_heads=num_heads, attn_groups=num_groups,
        attn_head_dim=head_dim)
    layers = [dataclasses.replace(lc, rope_config=None, pre_mixer_norm_config=norm,
                                  pre_mlp_norm_config=norm)
              for lc in base.decoder_config.transformer_config.layer_configs]
    out = _with_mlp(base, layers, hidden_dim)
    tcfg = dataclasses.replace(out.decoder_config.transformer_config, output_norm_config=norm)
    return dataclasses.replace(out, decoder_config=dataclasses.replace(
        out.decoder_config, transformer_config=tcfg))


def qwen35_config(
    *, num_layers: int = 4, model_dim: int = 128, hidden_dim: int = 256,
    vocab_size: int = 512, num_heads: int = 4, num_groups: int = 2,
    head_dim: int = 32, value_head_dim: int = 32, kernel_size: int = 4,
    attn_every: int = 4,
) -> LanguageModelConfig:
    """Qwen3.5-style hybrid: Gated DeltaNet mixers with periodic GQA
    attention (at `_hybrid_config`'s attention defaults: 8 heads over 2
    groups, Dh 32)."""
    gdn = DeltaNetConfig(
        in_proj_config=LinearConfig(),
        conv_config=SeparableCausalConvConfig(has_biases=False),
        out_proj_config=LinearConfig(),
        norm_config=_rms(eps=1e-6, upcast=UpcastMode.FULL_LAYER),
        num_heads=num_heads,
        num_groups=num_groups,
        head_dim=head_dim,
        value_head_dim=value_head_dim,
        kernel_size=kernel_size,
    )
    return _hybrid_config(
        lambda i: None if (i % attn_every == attn_every - 1) else gdn,
        num_layers=num_layers, model_dim=model_dim, hidden_dim=hidden_dim,
        vocab_size=vocab_size,
    )


def qwen3_config(
    *,
    num_layers: int = 4,
    model_dim: int = 256,
    hidden_dim: int = 768,
    num_heads: int = 8,
    num_groups: int = 2,
    head_dim: int = 64,
    vocab_size: int = 1024,
    max_seq: int = 4096,
    qk_norm_eps: float = 1e-6,
) -> LanguageModelConfig:
    """Qwen3-style: GQA + per-head QK-norm, untied ok; tied by default."""
    base = llama_config(
        num_layers=num_layers,
        model_dim=model_dim,
        hidden_dim=hidden_dim,
        num_heads=num_heads,
        num_groups=num_groups,
        head_dim=head_dim,
        vocab_size=vocab_size,
        max_seq=max_seq,
        rope_base=1000000.0,
    )
    qk_norm = _rms(eps=qk_norm_eps, upcast=UpcastMode.FULL_LAYER)
    layers = tuple(
        TransformerLayerConfig(
            pre_mixer_norm_config=lc.pre_mixer_norm_config,
            mixer_config=AttentionConfig(
                **{
                    **{f: getattr(lc.mixer_config, f) for f in lc.mixer_config.__dataclass_fields__},
                    "query_norm_config": qk_norm,
                    "key_norm_config": qk_norm,
                }
            ),
            post_mixer_norm_config=lc.post_mixer_norm_config,
            pre_mlp_norm_config=lc.pre_mlp_norm_config,
            mlp_config=lc.mlp_config,
            post_mlp_norm_config=lc.post_mlp_norm_config,
            hidden_dim=lc.hidden_dim,
            ple_config=lc.ple_config,
            has_post_layer_scalar=lc.has_post_layer_scalar,
            kv_source_layer_index=lc.kv_source_layer_index,
            rope_config=lc.rope_config,
        )
        for lc in base.decoder_config.transformer_config.layer_configs
    )
    decoder = DecoderConfig(
        embedding_config=base.decoder_config.embedding_config,
        transformer_config=TransformerConfig(
            layer_configs=layers,
            output_norm_config=base.decoder_config.transformer_config.output_norm_config,
            model_dim=model_dim,
            hidden_dim=hidden_dim,
        ),
        vocab_size=vocab_size,
        ple_model_config=None,
    )
    return LanguageModelConfig(decoder_config=decoder, generation_config=base.generation_config)


def windowed_config(
    *, num_layers: int = 4, model_dim: int = 64, hidden_dim: int = 160,
    vocab_size: int = 256, num_heads: int = 4, num_groups: int = 2,
    head_dim: int = 16, sliding_window: int = 24, has_sinks: bool = True,
    kv_share_last: int = 1, logit_soft_cap: float | None = 30.0,
) -> LanguageModelConfig:
    """gpt-oss/Gemma2-flavored feature mix WITHOUT PLE: alternating
    sliding-window layers, attention sinks, tanh soft cap, and trailing
    cross-layer KV sharing — the feature set the paged engine must cover
    beyond plain GQA (ref attention config attention.rs:8-31)."""
    norm = _rms(eps=1e-6)
    rope = UnscaledRoPEConfig(base=10000.0, max_sequence_length=4096,
                              head_dim=head_dim)
    layers = []
    kv_source = num_layers - kv_share_last - 1
    for i in range(num_layers):
        shared = kv_share_last > 0 and i >= num_layers - kv_share_last
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
            sliding_window_size=sliding_window if i % 2 == 0 else None,
            logit_soft_cap=logit_soft_cap,
            has_sinks=has_sinks,
            has_qkv_biases=False,
            has_out_biases=False,
            gate_projection_config=None,
            normalize_values=False,
            is_kv_sharing=shared,
        )
        mlp = DenseMLPConfig(
            linear_config=LinearConfig(),
            activation=SiLU(alpha=1.0),
            has_up_biases=False,
            has_down_biases=False,
            gate_clipping=None,
            up_clipping=None,
        )
        layers.append(TransformerLayerConfig(
            pre_mixer_norm_config=norm,
            mixer_config=attn,
            post_mixer_norm_config=None,
            pre_mlp_norm_config=norm,
            mlp_config=mlp,
            post_mlp_norm_config=None,
            hidden_dim=None,
            ple_config=None,
            has_post_layer_scalar=False,
            kv_source_layer_index=kv_source if shared else None,
            rope_config=rope,
        ))
    decoder = DecoderConfig(
        embedding_config=TiedEmbeddingConfig(input_scale=None, logit_soft_cap=None),
        transformer_config=TransformerConfig(
            layer_configs=tuple(layers),
            output_norm_config=_rms(eps=1e-6),
            model_dim=model_dim,
            hidden_dim=hidden_dim,
        ),
        vocab_size=vocab_size,
        ple_model_config=None,
    )
    return LanguageModelConfig(
        decoder_config=decoder,
        generation_config=GenerationConfig(
            stop_token_ids=(0,), temperature=None, top_k=None, top_p=None,
            min_p=None, banned_tokens=None, repetition_penalty=None,
            presence_penalty=None, frequency_penalty=None,
            suffix_repetition_length=None,
        ),
    )


def gemma_config(
    *, num_layers: int = 4, model_dim: int = 96, hidden_dim: int = 192,
    vocab_size: int = 512, num_heads: int = 4, num_groups: int = 2,
    head_dim: int = 24, ple_dim: int = 16, ple_vocab: int = 256,
    sliding_window: int = 16, kv_share_last: int = 1,
) -> LanguageModelConfig:
    """Gemma-3n/E4B-style config: PLE, per-layer scalars, sliding-window
    attention with logit soft cap, GELU MLP, cross-layer KV sharing on the
    trailing layers, untied embedding with input scale."""
    norm = _rms(eps=1e-6)
    ple_layer = PLELayerConfig(
        linear_config=LinearConfig(),
        norm_config=norm,
        ple_dim=ple_dim,
        activation=GELU(approximate=True),
    )
    layers = []
    kv_source = num_layers - kv_share_last - 1
    for i in range(num_layers):
        shared = i >= num_layers - kv_share_last
        attn = AttentionConfig(
            qkv_projection_config=LinearConfig(),
            out_projection_config=LinearConfig(),
            query_norm_config=norm,
            key_norm_config=None if shared else norm,
            num_heads=num_heads,
            num_groups=num_groups,
            head_dim=head_dim,
            is_causal=True,
            scale=None,
            sliding_window_size=sliding_window if i % 2 == 0 else None,
            logit_soft_cap=50.0,
            has_sinks=False,
            has_qkv_biases=False,
            has_out_biases=False,
            gate_projection_config=None,
            normalize_values=False,
            is_kv_sharing=shared,
        )
        mlp = DenseMLPConfig(
            linear_config=LinearConfig(),
            activation=GELU(approximate=True),
            has_up_biases=False,
            has_down_biases=False,
            gate_clipping=None,
            up_clipping=None,
        )
        layers.append(TransformerLayerConfig(
            pre_mixer_norm_config=norm,
            mixer_config=attn,
            post_mixer_norm_config=norm,
            pre_mlp_norm_config=norm,
            mlp_config=mlp,
            post_mlp_norm_config=norm,
            hidden_dim=None,
            ple_config=ple_layer,
            has_post_layer_scalar=True,
            kv_source_layer_index=kv_source if shared else None,
            rope_config=UnscaledRoPEConfig(base=10000.0, max_sequence_length=4096, head_dim=head_dim),
        ))
    decoder = DecoderConfig(
        embedding_config=TiedEmbeddingConfig(
            input_scale=float(model_dim) ** 0.5, logit_soft_cap=30.0
        ),
        transformer_config=TransformerConfig(
            layer_configs=tuple(layers),
            output_norm_config=norm,
            model_dim=model_dim,
            hidden_dim=hidden_dim,
        ),
        vocab_size=vocab_size,
        ple_model_config=PLEModelConfig(
            ple_dim=ple_dim,
            num_layers=num_layers,
            ple_vocab_size=ple_vocab,
            ple_embed_scale=float(ple_dim) ** 0.5,
            model_projection_scale=float(model_dim) ** -0.5,
            input_scale=0.5,
            linear_config=LinearConfig(),
            norm_config=_rms(eps=1e-6),
        ),
    )
    return LanguageModelConfig(
        decoder_config=decoder,
        generation_config=GenerationConfig(
            stop_token_ids=(0,), temperature=None, top_k=None, top_p=None,
            min_p=None, banned_tokens=None, repetition_penalty=None,
            presence_penalty=None, frequency_penalty=None,
            suffix_repetition_length=None,
        ),
    )


def synth_dflash_speculator(out_dir: str, target_cfg: LanguageModelConfig, *,
                            block_size: int = 4, target_layer_ids: tuple = (0, 1),
                            num_layers: int = 1, seed: int = 0, dtype=None) -> str:
    """Write a DFlash speculator dir (config.json + model.safetensors under
    the 'speculator.draft_model' prefix) for `target_cfg`; the files are
    byte-identical to the JAX package's `synth_dflash_speculator`."""
    from ..config.model import (
        DFlashDraftConfig,
        DFlashSpeculatorConfig,
        SpeculatorModelConfig,
        WeaverConfig,
    )

    tcfg = target_cfg.decoder_config.transformer_config
    d = tcfg.model_dim
    vocab = target_cfg.decoder_config.vocab_size
    # the DFlash DRAFT is an attention transformer over feature KV even
    # when the TARGET is a recurrent hybrid: its layer is modelled on the
    # target's first attention layer
    base_layer = next((lc for lc in tcfg.layer_configs
                       if isinstance(lc.mixer_config, AttentionConfig)), tcfg.layer_configs[0])
    attn = base_layer.mixer_config
    if not isinstance(attn, AttentionConfig):
        raise ValueError("target has no attention layer to model the DFlash draft on")
    rope = base_layer.rope_config or UnscaledRoPEConfig(
        base=10000.0, max_sequence_length=4096, head_dim=attn.head_dim)
    draft_cfg = DFlashDraftConfig(
        model_dim=d, hidden_dim=tcfg.hidden_dim, block_size=block_size, mask_token_id=0,
        target_layer_ids=tuple(target_layer_ids), num_target_layers=len(tcfg.layer_configs),
        vocab_size=vocab, context_projection_config=LinearConfig(),
        context_norm_config=_rms(), rope_config=rope,
        layer_configs=tuple([base_layer] * num_layers), output_norm_config=_rms(),
    )
    weaver_cfg = WeaverConfig(
        model_dim=d, target_model_dim=d, target_embedding_dim=d, num_layers=1,
        num_heads=attn.num_heads, hidden_dim=tcfg.hidden_dim, max_depth=block_size,
        candidate_pool_size=8, linear_config=LinearConfig(), norm_config=_rms(),
        rope_config=rope,
    )
    model_cfg = SpeculatorModelConfig(speculator_config=DFlashSpeculatorConfig(
        draft_config=draft_cfg, weaver_config=weaver_cfg))

    b = ModelBuilder(seed=seed, dtype=np.dtype(dtype or BF16))
    spec = FullPrecisionSpec(layout=Layout.OUTPUT_INPUT)
    n_tap = len(target_layer_ids)
    layer_kv_dim = 2 * attn.num_groups * attn.head_dim
    pre = "speculator.draft_model"
    b.linear(f"{pre}.context_projection", d * n_tap, d, spec, False)
    b.norm_scales(f"{pre}.context_norm", d, False)
    b.linear(f"{pre}.state_kv_projection", d, num_layers * layer_kv_dim, spec, False)
    for i, lc in enumerate(draft_cfg.layer_configs):
        b.layer_tensors(f"{pre}.layers.{i}", lc, d, draft_cfg.hidden_dim, spec)
    b.norm_scales(f"{pre}.output_norm", d, False)
    return b.write(out_dir, model_cfg)


# --------------------------------------------------------------------------
# Synthetic tokenizer and chat model (offline session/server tests)
# --------------------------------------------------------------------------

SPECIAL_TOKENS = [
    "<|pad|>", "<|system|>", "<|user|>", "<|assistant|>", "<|tool|>", "<|end|>",
    "<think>", "</think>", "<tool_call>", "</tool_call>",
    # harmony formatting tokens (gpt-oss encoding)
    "<|start|>", "<|message|>", "<|channel|>", "<|constrain|>", "<|call|>", "<|return|>",
]

SYNTH_CHAT_TEMPLATE = (
    "{% if tools %}<|system|>tools:"
    "{% for t in tools %} {{ t.function.name }}{% endfor %}<|end|>"
    "{% endif %}"
    "{% for message in messages %}"
    "<|{{ message.role }}|>{% if message.tool_calls %}"
    "{% for tc in message.tool_calls %}<tool_call>"
    '{"name": "{{ tc.function.name }}", "arguments": {{ tc.function.arguments }}}'
    "</tool_call>{% endfor %}"
    "{% else %}{{ message.content }}{% endif %}<|end|>"
    "{% endfor %}"
    "{% if add_generation_prompt %}<|assistant|>{% endif %}"
)


def synth_tokenizer(out_dir: str, vocab_size: int = 512) -> str:
    """Write a deterministic byte-level BPE tokenizer.json +
    tokenizer_config.json (with chat template) into `out_dir`; the files
    are byte-identical to the JAX package's."""
    from tokenizers import Tokenizer, decoders, models, pre_tokenizers, trainers

    tok = Tokenizer(models.BPE(unk_token=None))
    tok.pre_tokenizer = pre_tokenizers.ByteLevel(add_prefix_space=False)
    tok.decoder = decoders.ByteLevel()
    corpus = [
        "hello world how are you today",
        "the quick brown fox jumps over the lazy dog",
        "tool call name arguments city weather get json",
        "thinking about the answer step by step",
        '{"name": "get_weather", "arguments": {"city": "Paris"}}',
        "0 1 2 3 4 5 6 7 8 9 10 42 100",
    ] * 4
    trainer = trainers.BpeTrainer(
        vocab_size=vocab_size - len(SPECIAL_TOKENS),
        special_tokens=[],
        show_progress=False,
        initial_alphabet=pre_tokenizers.ByteLevel.alphabet(),
    )
    tok.train_from_iterator(corpus, trainer)
    tok.add_special_tokens(SPECIAL_TOKENS)

    os.makedirs(out_dir, exist_ok=True)
    tok.save(os.path.join(out_dir, "tokenizer.json"))
    cfg = {
        "eos_token": "<|end|>",
        "pad_token": "<|pad|>",
        "chat_template": SYNTH_CHAT_TEMPLATE,
        "added_tokens_decoder": {
            str(tok.token_to_id(s)): {"content": s, "special": True} for s in SPECIAL_TOKENS
        },
    }
    with open(os.path.join(out_dir, "tokenizer_config.json"), "w") as f:
        json.dump(cfg, f, indent=1)
    return out_dir


def synth_chat_model(out_dir: str, *, seed: int = 0, vocab_size: int = 512,
                     config=None, **config_kw) -> str:
    """Full offline chat model dir: config + weights + tokenizer, with the
    model's stop ids aligned to the tokenizer's <|end|>. `config` overrides
    the default llama architecture (its vocab_size must match)."""
    cfg = config if config is not None else llama_config(vocab_size=vocab_size, **config_kw)
    synthesize(cfg, out_dir, seed=seed)
    synth_tokenizer(out_dir, vocab_size=vocab_size)
    from ..sessions.tokenizer import Tokenizer

    eos = Tokenizer(out_dir).eos_token_ids
    cfg_path = os.path.join(out_dir, "config.json")
    with open(cfg_path) as f:
        raw = json.load(f)
    raw["generation_config"]["stop_token_ids"] = eos
    with open(cfg_path, "w") as f:
        json.dump(raw, f, indent=1)
    return out_dir


# --------------------------------------------------------------------------
# Encoder classifier
# --------------------------------------------------------------------------


def classifier_config(
    *, num_layers: int = 2, model_dim: int = 64, hidden_dim: int = 160,
    num_heads: int = 4, num_groups: int = 2, head_dim: int = 16,
    vocab_size: int = 256, num_labels: int = 3, labels=None,
):
    """Encoder-classifier config (reference: config/classifier.rs)."""
    from ..config.model import (
        ClassifierConfig,
        ClassifierModelConfig,
        PoolingType,
        PredictionHeadConfig,
    )

    base = llama_config(
        num_layers=num_layers, model_dim=model_dim, hidden_dim=hidden_dim,
        num_heads=num_heads, num_groups=num_groups, head_dim=head_dim,
        vocab_size=vocab_size,
    )
    head = PredictionHeadConfig(
        dense_config=LinearConfig(),
        activation=SiLU(alpha=1.0),
        normalization_config=_rms(),
        readout_config=LinearConfig(),
        use_dense_bias=True,
    )
    return ClassifierModelConfig(
        classifier_config=ClassifierConfig(
            embedding_config=TiedEmbeddingConfig(input_scale=None, logit_soft_cap=None),
            embedding_norm_config=_rms(),
            transformer_config=base.decoder_config.transformer_config,
            prediction_head_config=head,
            vocab_size=vocab_size,
            model_dim=model_dim,
            hidden_dim=model_dim,
            num_labels=num_labels,
            classifier_pooling=PoolingType.MEAN,
            output_labels=tuple(labels) if labels else None,
        )
    )


def synthesize_classifier(model_cfg, out_dir: str, *, seed: int = 0, dtype=BF16) -> str:
    """Write a classifier model dir (tensors under the 'classifier.' prefix,
    like the reference's loader expects, classifier_model.rs:62); the files
    are byte-identical to the JAX package's."""
    cfg = model_cfg.classifier_config
    b = ModelBuilder(seed=seed, dtype=np.dtype(dtype))
    d = cfg.model_dim
    spec = FullPrecisionSpec(layout=Layout.OUTPUT_INPUT)
    emb_spec = FullPrecisionSpec(layout=Layout.INPUT_OUTPUT)

    inner = ModelBuilder(seed=seed, dtype=np.dtype(dtype))
    # the decoder emitter writes the embedding and the transformer layers
    inner.build_decoder(DecoderConfig(embedding_config=cfg.embedding_config,
                                      transformer_config=cfg.transformer_config,
                                      vocab_size=cfg.vocab_size, ple_model_config=None),
                        spec, emb_spec)
    # it also writes transformer.output_norm, which the classifier does
    # not have; drop it and add the classifier's own tensors
    for name in list(inner.tensors):
        if name.startswith("transformer.output_norm"):
            del inner.tensors[name]
    inner.norm_scales("embedding_norm", d, cfg.embedding_norm_config.has_biases)
    ph = cfg.prediction_head_config
    inner.linear("prediction_head.dense", cfg.hidden_dim, cfg.hidden_dim, spec, ph.use_dense_bias)
    inner.norm_scales("prediction_head.norm", cfg.hidden_dim, ph.normalization_config.has_biases)
    inner.linear("prediction_head.readout", cfg.hidden_dim, cfg.num_labels, spec, False)

    b.tensors = {f"classifier.{k}": v for k, v in inner.tensors.items()}
    b.metadata = {f"classifier.{k}": v for k, v in inner.metadata.items()}
    return b.write(out_dir, model_cfg)
