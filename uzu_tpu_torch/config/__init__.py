from .serde import ConfigError, Family, config, config_member, dump, dumps, loads, parse
from .model import *  # noqa: F401,F403
from .model import (
    AttentionConfig,
    DecoderConfig,
    DenseMLPConfig,
    FullPrecisionSpec,
    GenerationConfig,
    HybridSpec,
    IntSpec,
    LanguageModelConfig,
    Layout,
    LinearConfig,
    MLXSpec,
    MixtureOfExpertsConfig,
    NormalizationConfig,
    TransformerConfig,
    TransformerLayerConfig,
    UpcastMode,
)


def load_language_model_config(text_or_path) -> LanguageModelConfig:
    """Load a LanguageModelConfig from a JSON string or a config.json path."""
    import json
    import os

    if isinstance(text_or_path, (str, os.PathLike)) and os.path.exists(text_or_path):
        with open(text_or_path) as f:
            data = json.load(f)
    else:
        data = json.loads(text_or_path)
    return parse(LanguageModelConfig, data)
