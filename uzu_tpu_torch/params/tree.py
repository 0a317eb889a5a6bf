"""Parameter loading: dotted-name tree over a safetensors file.

Counterpart of `uzu_tpu/params/tree.py`: strict shape+dtype validation on
every leaf, subtree prefixes, per-prefix JSON metadata (quantization
`spec`), a seeded-random mode that builds a full model from a header alone
(the same bytes as the JAX package's), one parallel read of every tensor
up front (`SafetensorsFile.read_many`), and a completeness assertion that
flags any tensor the model graph never consumed. Leaves stay numpy arrays
(BF16 as raw bits); the model loader moves them to torch.
"""

from __future__ import annotations

import json
from typing import Any

import numpy as np

from ..config.serde import Family, parse
from .safetensors_io import BF16, SafetensorsFile, TensorInfo, cast, dtype_name

_FLOAT_KINDS = (np.dtype(np.float32), np.dtype(np.float64), np.dtype(np.float16), BF16)


class ParameterError(ValueError):
    pass


def _fill_random(info: TensorInfo, seed: int) -> np.ndarray:
    """Deterministic pseudo-random tensor content keyed on the tensor's
    file offset (floats in [-0.1, 0.1), raw random bits for integer
    tensors): the JAX package's `_fill_random`, byte for byte."""
    rng = np.random.default_rng(seed ^ (info.offset * 2654435761 % (1 << 63)))
    n = int(np.prod(info.shape, dtype=np.int64))
    if info.dtype in _FLOAT_KINDS:
        vals = rng.uniform(-0.1, 0.1, size=n).astype(np.float32)
        return cast(vals, info.dtype).reshape(info.shape)
    raw = rng.integers(0, 256, size=n * info.dtype.itemsize, dtype=np.uint8)
    return raw.view(info.dtype).reshape(info.shape)


class ParameterLoader:
    """Loads tensors by dotted name with validation + consumption tracking.
    `random_seed`: every tensor is `_fill_random`'s, and the file's bytes
    past its header are never read. `prefetch`: every tensor is read at
    once by the parallel reader (not in random mode)."""

    def __init__(self, path: str, random_seed: int | None = None, prefetch: bool = True):
        self._file = SafetensorsFile(path)
        self._random_seed = random_seed
        self._validated: set[str] = set()
        self._prefetched: dict[str, np.ndarray] | None = None
        if prefetch and random_seed is None:
            self._prefetched = self._file.read_many()

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
        info = self._info(key)
        if self._random_seed is not None:
            return _fill_random(info, self._random_seed)
        if self._prefetched is not None:
            return self._prefetched[key]
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
