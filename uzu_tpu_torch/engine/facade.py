"""Top-level Engine: model registry, discovery, session factories.

Role parity: crates/uzu/src/engine/mod.rs (Engine::new -> registries ->
engine.chat/classification, mod.rs:259-544) with the local-directory
registry (uzu/src/registry/local/). Remote registries/downloads are a thin
optional layer over huggingface_hub when it is importable (the local
registry is the tested path — the reference likewise falls back to
cached/local catalogs, registry/cached.rs).

The port's counterpart of `uzu_tpu/engine/facade.py`. `Engine(models_dir,
device=)` loads every model on the card unless the caller asks for the
CPU; a bundled speculator is skipped only when its directory is malformed
(`SPECULATOR_DIR_ERRORS`), never on a CUDA, build or launch error.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional

from .engine import LanguageModel

#: what a malformed speculator directory raises: a missing file
#: (FileNotFoundError), unparsable JSON, a config that does not parse
#: (ConfigError), a tensor of the wrong shape (ParameterError) or a bad
#: safetensors header (ValueError). CUDA, build and launch errors are
#: RuntimeErrors and propagate.
SPECULATOR_DIR_ERRORS = (FileNotFoundError, ValueError)


@dataclasses.dataclass(frozen=True)
class ModelInfo:
    id: str
    path: str
    kind: str  # "language" | "classifier"
    size_bytes: int
    has_tokenizer: bool

    @property
    def chat_ready(self) -> bool:
        return self.kind == "language" and self.has_tokenizer


def _model_kind(config_path: str) -> Optional[str]:
    try:
        with open(config_path) as f:
            raw = json.load(f)
    except (OSError, json.JSONDecodeError):
        return None
    t = raw.get("type")
    if t == "ClassifierModelConfig" or "classifier_config" in raw:
        return "classifier"
    if "decoder_config" in raw:
        return "language"
    return None


class LocalRegistry:
    """Scan a directory tree for model dirs (config.json + model.safetensors),
    the uzu local-registry discipline (registry/local/)."""

    def __init__(self, root: str):
        self.root = root

    @property
    def identifier(self) -> str:
        return f"local:{self.root}"

    def models(self) -> list[ModelInfo]:
        out = []
        if not os.path.isdir(self.root):
            return out
        for dirpath, _dirnames, filenames in os.walk(self.root):
            if "config.json" not in filenames or "model.safetensors" not in filenames:
                continue
            kind = _model_kind(os.path.join(dirpath, "config.json"))
            if kind is None:
                continue
            rel = os.path.relpath(dirpath, self.root)
            out.append(
                ModelInfo(
                    id=rel if rel != "." else os.path.basename(self.root),
                    path=dirpath,
                    kind=kind,
                    size_bytes=os.path.getsize(os.path.join(dirpath, "model.safetensors")),
                    has_tokenizer="tokenizer.json" in filenames,
                )
            )
        return sorted(out, key=lambda m: m.id)


class Engine:
    """Product-facing engine: registry + session factories.

    The registry stack mirrors the reference's Engine::new composition
    (uzu/src/engine/mod.rs: merged(cached(local), extras...)): the local
    directory scan is cached per process (refresh() re-lists), and extra
    registries (FixedRegistry, a remote catalog, ...) merge behind it."""

    def __init__(self, models_dir: str, extra_registries=(), device=None):
        from ..runtime import resolve_device
        from .registry import CachedRegistry, MergedRegistry

        self.device = resolve_device(device)
        self._local = LocalRegistry(models_dir)
        self._cached = CachedRegistry(self._local)
        if extra_registries:
            self.registry = MergedRegistry([self._cached, *extra_registries])
        else:
            self.registry = self._cached
        self._cache: dict = {}

    def models(self) -> list[ModelInfo]:
        return self.registry.models()

    def refresh(self) -> None:
        """Drop the cached catalog (reference CachedRegistry::clear)."""
        self._cached.clear()

    def model(self, model_id: str) -> ModelInfo:
        for m in self.models():
            if m.id == model_id:
                return m
        raise KeyError(f"model {model_id!r} not found under {self._local.root}")

    def language_model(self, model_id: str, **kw) -> LanguageModel:
        info = self.model(model_id)
        if info.kind != "language":
            raise ValueError(f"{model_id} is a {info.kind} model")
        key = (model_id, tuple(sorted(kw.items())))
        if key not in self._cache:
            self._cache[key] = LanguageModel.from_dir(info.path, device=self.device, **kw)
        return self._cache[key]

    def chat(self, model_id: str, *, max_context: int = 4096, tools=None,
             speculate: str | bool = "auto", **kw):
        """speculate: "auto" engages a bundled speculator/ dir (DFlash
        block-draft decoder — the reference auto-loads it the same way,
        engine/language_model/mod.rs:54-69); False disables; "self" /
        "fused-self" engage zero-artifact self-speculation (per-round /
        fused multi-round); a proposer/decoder object is used directly."""
        from ..sessions import ChatSession, Tokenizer

        info = self.model(model_id)
        lm = self.language_model(model_id, max_context=max_context, **kw)
        speculator = None
        if speculate is True:  # a truthy flag must never silently downgrade
            speculate = "auto"
        if speculate == "auto":
            spec_dir = os.path.join(info.path, "speculator")
            if os.path.exists(os.path.join(spec_dir, "config.json")):
                try:
                    from .dflash import DFlashDraft
                    from .speculation import (
                        DFlashSpeculativeDecoder,
                        speculation_supported,
                    )

                    if speculation_supported(lm.decoder_config):
                        draft = DFlashDraft.from_dir(spec_dir, max_context=max_context,
                                                     device=self.device)
                        speculator = DFlashSpeculativeDecoder(lm, draft)
                except SPECULATOR_DIR_ERRORS:
                    speculator = None  # malformed speculator dir: plain decoding
        elif speculate and speculate is not True:
            speculator = speculate
        return ChatSession(lm, Tokenizer(info.path), tools=tools,
                           speculator=speculator)

    def classification(self, model_id: str):
        from ..models.classifier import ClassifierModel

        info = self.model(model_id)
        if info.kind != "classifier":
            raise ValueError(f"{model_id} is a {info.kind} model")
        return ClassifierModel.from_dir(info.path, device=self.device)

    def download(self, repo_id: str, *, revision: str | None = None) -> str:
        """Fetch a model from the HuggingFace hub into the registry root
        (requires network + huggingface_hub; the reference's download
        manager role)."""
        try:
            from huggingface_hub import snapshot_download
        except ImportError as e:
            raise RuntimeError("huggingface_hub not available") from e
        dest = os.path.join(self._local.root, repo_id.replace("/", "--"))
        snapshot_download(repo_id, revision=revision, local_dir=dest)
        return dest
