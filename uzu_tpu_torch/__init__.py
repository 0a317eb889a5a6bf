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
from .engine.speculation import (  # noqa: F401
    DraftModelSpeculator,
    NgramSpeculator,
    SpeculativeDecoder,
)
from .engine.facade import Engine, LocalRegistry, ModelInfo  # noqa: F401
from .engine.batch import BatchEngine, Request  # noqa: F401
from .engine.fused_spec import (  # noqa: F401
    FusedSpeculativeDecoder,
    fused_self_speculative_decoder,
)
from .engine.remote import RemoteChatSession, RemoteConfig  # noqa: F401
from .grammar.decode import constrained_generate  # noqa: F401
from .grammar.matcher import GrammarSession  # noqa: F401
from .sessions.transform import TransformSchema  # noqa: F401
from .sessions.tts import TextToSpeechSession  # noqa: F401
from .engine.paged_batch import PagedBatchEngine  # noqa: F401
