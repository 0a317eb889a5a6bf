"""uzu_tpu_torch: the PyTorch/CUDA port of uzu_tpu for NVIDIA Hopper GPUs.

A package beside the JAX reference (`uzu_tpu/`), with its layout and names.
It imports torch and numpy only. Entry points run on the card unless the
caller passes `device="cpu"`; every kernel wrapper takes its plain PyTorch
version for a CPU tensor and launches its hand-written CUDA kernel
(`csrc/`, built with nvcc at first use) for a CUDA tensor.
"""

__version__ = "0.1.0"

from .config import LanguageModelConfig, load_language_model_config  # noqa: F401
from .engine.engine import LanguageModel, StreamMetrics  # noqa: F401
from .engine.sampling import SamplingParams  # noqa: F401
