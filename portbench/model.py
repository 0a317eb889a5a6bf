"""The system under test, built from a config file and the raw weights:
the port's `LanguageModelConfig` from its config dataclasses, its params
as `QuantizedTensor`s over the raw codes and scales, and
`LanguageModel(config, params, device=, max_context=, prefill_buckets=)`.
"""

from __future__ import annotations

from uzu_tpu_torch.config import model as cm
from uzu_tpu_torch.engine.engine import LanguageModel
from uzu_tpu_torch.quant.format import QuantizedTensor

from .weights import kind_module


def _norm(eps: float):
    # RMSNorm as both published models compute it: normalized in f32,
    # cast to the activations' type, then times the weight
    return cm.NormalizationConfig(epsilon=eps, scale_offset=None,
                                  upcast_mode=cm.UpcastMode.ONLY_NORMALIZATION,
                                  subtract_mean=False, has_biases=False)


def port_config(spec) -> cm.LanguageModelConfig:
    mlp = cm.DenseMLPConfig(linear_config=cm.LinearConfig(), activation=cm.SiLU(alpha=1.0),
                            has_up_biases=False, has_down_biases=False, gate_clipping=None,
                            up_clipping=None)
    layers = []
    for kind in spec.kinds:
        km = kind_module(kind)
        layers.append(cm.TransformerLayerConfig(
            pre_mixer_norm_config=_norm(spec.norm_eps), mixer_config=km.port_mixer(spec, cm, _norm),
            post_mixer_norm_config=None, pre_mlp_norm_config=_norm(spec.norm_eps),
            mlp_config=mlp, post_mlp_norm_config=None, hidden_dim=None, ple_config=None,
            has_post_layer_scalar=False, kv_source_layer_index=None,
            rope_config=km.port_rope(spec, cm)))
    decoder = cm.DecoderConfig(
        embedding_config=cm.TiedEmbeddingConfig(input_scale=None, logit_soft_cap=None),
        transformer_config=cm.TransformerConfig(
            layer_configs=tuple(layers), output_norm_config=_norm(spec.norm_eps),
            model_dim=spec.d, hidden_dim=spec.ffn),
        vocab_size=spec.vocab, ple_model_config=None)
    generation = cm.GenerationConfig(
        stop_token_ids=(), temperature=None, top_k=None, top_p=None, min_p=None,
        banned_tokens=None, repetition_penalty=None, presence_penalty=None,
        frequency_penalty=None, suffix_repetition_length=None)
    return cm.LanguageModelConfig(decoder_config=decoder, generation_config=generation)


def port_params(spec, raw: dict) -> dict:
    def quantized(name):
        return QuantizedTensor(codes=raw[name + ".codes"], scales=raw[name + ".scales"],
                               qbias=None, bits=spec.bits, group_size=spec.group_size,
                               qbias_coeff=-float(1 << (spec.bits - 1)))

    layers = []
    for i, kind in enumerate(spec.kinds):
        p = f"L{i}."
        layers.append({
            "mixer": kind_module(kind).port_params(raw, p, quantized),
            "pre_mixer_norm": {"scales": raw[p + "norm1"]},
            "pre_mlp_norm": {"scales": raw[p + "norm2"]},
            "mlp": {"up": {"w": quantized(p + "up")}, "down": {"w": quantized(p + "down")}},
        })
    return {"embedding": {"tied": quantized("embed")}, "layers": layers,
            "output_norm": {"scales": raw["final_norm"]}}


def language_model(spec, raw: dict, engine_cfg: dict, device) -> LanguageModel:
    return LanguageModel(port_config(spec), port_params(spec, raw), device=device,
                         max_context=engine_cfg["max_context"],
                         prefill_buckets=tuple(engine_cfg["prefill_buckets"]))
