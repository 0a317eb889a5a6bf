"""Registry composition + persisted settings.

Role parity with the reference's registry stack (uzu/src/registry/):
- FixedRegistry (fixed.rs): a static in-memory catalog;
- CachedRegistry (cached.rs): memoizes the inner registry's first listing
  until clear() — remote catalogs list once per process;
- MergedRegistry (merged.rs): concatenates several registries, rejects
  duplicate identifiers on add, and SKIPS (with a warning) registries that
  fail to list instead of failing the whole catalog;
and Settings (uzu/src/settings/mod.rs:28-140): persisted key/value config
split into plain config (a JSON file, the confy role) and secrets. The
reference stores secrets in the OS keyring; this host build substitutes a
0600-permission JSON file next to the config (documented trade-off — a
server host has no per-user keyring daemon to rely on).

The port's copy of `uzu_tpu/engine/registry.py`.
"""

from __future__ import annotations

import json
import os
import sys
import threading
from typing import Optional

from .facade import LocalRegistry, ModelInfo

__all__ = [
    "CachedRegistry",
    "FixedRegistry",
    "LocalRegistry",
    "MergedRegistry",
    "ModelInfo",
    "RegistryError",
    "Settings",
]


class RegistryError(RuntimeError):
    pass


class FixedRegistry:
    """Static catalog (reference fixed.rs): an explicit list of models."""

    def __init__(self, identifier: str, models: list[ModelInfo]):
        self._identifier = identifier
        self._models = list(models)

    @property
    def identifier(self) -> str:
        return self._identifier

    def models(self) -> list[ModelInfo]:
        return list(self._models)


class CachedRegistry:
    """Memoize the inner registry's listing (reference cached.rs)."""

    def __init__(self, registry):
        self.registry = registry
        self._lock = threading.Lock()
        self._models: Optional[list[ModelInfo]] = None

    @property
    def identifier(self) -> str:
        return self.registry.identifier

    def clear(self) -> None:
        with self._lock:
            self._models = None

    def models(self) -> list[ModelInfo]:
        with self._lock:
            if self._models is None:
                self._models = self.registry.models()
            return list(self._models)


class MergedRegistry:
    """Concatenate registries (reference merged.rs): duplicate identifiers
    are rejected on add; a registry that fails to list is skipped with a
    warning rather than failing the merged catalog."""

    def __init__(self, registries=()):
        self.registries = []
        for r in registries:
            self.add(r)

    @property
    def identifier(self) -> str:
        return ":".join(r.identifier for r in self.registries)

    def add(self, registry) -> None:
        if any(r.identifier == registry.identifier for r in self.registries):
            raise RegistryError(
                f"registry {registry.identifier!r} already present"
            )
        self.registries.append(registry)

    def remove(self, identifier: str) -> None:
        self.registries = [
            r for r in self.registries if r.identifier != identifier
        ]

    def models(self) -> list[ModelInfo]:
        out: list[ModelInfo] = []
        for r in self.registries:
            try:
                out.extend(r.models())
            except Exception as e:  # skip, don't fail the whole catalog
                sys.stderr.write(
                    f"uzu_tpu_torch.registry: skipping {r.identifier!r} "
                    f"(failed to list models: {e})\n"
                )
        return out


class Settings:
    """Persisted key/value settings (reference settings/mod.rs).

    kind "config" -> <config_dir>/<app>/settings.json (world-readable);
    kind "secret" -> <config_dir>/<app>/secrets.json with 0600 permissions.
    save(key, None) deletes; load returns None when absent.
    """

    KINDS = ("config", "secret")

    def __init__(self, application_identifier: str,
                 config_dir: str | None = None):
        base = config_dir or os.environ.get(
            "XDG_CONFIG_HOME", os.path.join(os.path.expanduser("~"), ".config")
        )
        self.dir = os.path.join(base, application_identifier)
        self._lock = threading.Lock()

    def _path(self, kind: str) -> str:
        if kind not in self.KINDS:
            raise ValueError(f"unknown setting kind {kind!r}")
        name = "settings.json" if kind == "config" else "secrets.json"
        return os.path.join(self.dir, name)

    def _read(self, kind: str) -> dict:
        try:
            with open(self._path(kind)) as f:
                return json.load(f)
        except (OSError, json.JSONDecodeError):
            return {}

    def _write(self, kind: str, data: dict) -> None:
        os.makedirs(self.dir, exist_ok=True)
        path = self._path(kind)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(data, f, indent=1)
        if kind == "secret":
            os.chmod(tmp, 0o600)
        os.replace(tmp, path)

    def save(self, kind: str, key: str, value: Optional[str]) -> None:
        with self._lock:
            data = self._read(kind)
            if value is None:
                data.pop(key, None)
            else:
                data[key] = value
            self._write(kind, data)

    def load(self, kind: str, key: str) -> Optional[str]:
        with self._lock:
            return self._read(kind).get(key)

    def keys(self, kind: str) -> list[str]:
        with self._lock:
            return sorted(self._read(kind))
