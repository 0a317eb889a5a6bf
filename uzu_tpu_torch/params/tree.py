"""Parameter loading: dotted-name tree over a safetensors file.

Counterpart of `uzu_tpu/params/tree.py`: strict shape+dtype validation on
every leaf, subtree prefixes, per-prefix JSON metadata (quantization
`spec`), and a completeness assertion that flags any tensor the model graph
never consumed. Leaves stay numpy arrays (BF16 as raw bits); the model
loader moves them to torch.
"""

from __future__ import annotations

import json
from typing import Any

import numpy as np

from ..config.serde import Family, parse
from .safetensors_io import SafetensorsFile, TensorInfo, dtype_name


class ParameterError(ValueError):
    pass


class ParameterLoader:
    """Loads tensors by dotted name with validation + consumption tracking."""

    def __init__(self, path: str):
        self._file = SafetensorsFile(path)
        self._validated: set[str] = set()

    @property
    def metadata(self) -> dict[str, str]:
        return self._file.metadata

    def keys(self):
        return self._file.keys()

    def tree(self) -> "ParameterTree":
        return ParameterTree(self, prefix=None)

    # -- internal ----------------------------------------------------------

    def _info(self, key: str) -> TensorInfo:
        try:
            return self._file.tensors[key]
        except KeyError:
            raise ParameterError(f"array with key {key!r} not found") from None

    def _read(self, key: str) -> np.ndarray:
        return self._file.read(key)


class ParameterTree:
    def __init__(self, loader: ParameterLoader, prefix: str | None):
        self._loader = loader
        self._prefix = prefix

    def _join(self, name: str) -> str:
        return name if self._prefix is None else f"{self._prefix}.{name}"

    def subtree(self, name: str) -> "ParameterTree":
        new_prefix = self._join(name)
        probe = new_prefix + "."
        if not any(k.startswith(probe) for k in self._loader.keys()):
            raise ParameterError(f"couldn't find any arrays with prefix {new_prefix!r}")
        return ParameterTree(self._loader, new_prefix)

    def leaf(self, name: str, shape: tuple[int, ...] | list[int], dtype) -> np.ndarray:
        """Validate shape+dtype and read the tensor."""
        key = self._join(name)
        info = self._loader._info(key)
        dtype = np.dtype(dtype)
        if tuple(info.shape) != tuple(shape) or info.dtype != dtype:
            raise ParameterError(
                f"invalid tensor {key!r}: got {info.shape} @ {dtype_name(info.dtype)}, "
                f"expected {tuple(shape)} @ {dtype_name(dtype)}"
            )
        self._loader._validated.add(key)
        return self._loader._read(key)

    def leaf_info(self, name: str) -> TensorInfo:
        return self._loader._info(self._join(name))

    def spec(self, name: str | None = "weights") -> Any:
        """Read the quantization spec from safetensors metadata.

        name="weights" -> key "<prefix>.weights.spec" (linear layers);
        name=None -> key "<prefix>.spec" (embedding tables)."""
        key = self._join(name) + ".spec" if name else f"{self._prefix}.spec"
        text = self._loader.metadata.get(key)
        if text is None:
            raise ParameterError(f"metadata key {key!r} not found")
        return parse(Family["WeightMatrixSpec"], json.loads(text))

    def assert_all_validated(self) -> None:
        prefix = None if self._prefix is None else self._prefix + "."
        missing = sorted(
            k
            for k in self._loader.keys()
            if (prefix is None or k.startswith(prefix)) and k not in self._loader._validated
        )
        if missing:
            raise ParameterError(f"unvalidated tensors under {self._prefix!r}: {missing}")
