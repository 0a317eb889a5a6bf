"""Grammar-constrained decoding: JSON schemas and regexes as per-step token
masks (the port's copy of `uzu_tpu/grammar/`, numpy and ctypes only)."""

from .decode import constrained_generate
from .matcher import GrammarError, GrammarSession, JsonMatcher, TokenMaskCache

__all__ = ["constrained_generate", "GrammarError", "GrammarSession", "JsonMatcher", "TokenMaskCache"]
