"""Minimal safetensors reader/writer with bf16 support, in numpy alone.

Counterpart of `uzu_tpu/params/safetensors_io.py`. numpy has no bfloat16
and the port does not depend on `ml_dtypes`, so a bf16 tensor stays a
2-byte record (`BF16`, raw bits) until it becomes a torch tensor
(`to_torch`). `to_bf16` rounds float32 to bf16 bits to nearest-even, the
rounding `ml_dtypes` and torch use, so files written here are
byte-identical to the JAX package's.

The format: u64 little-endian header length, then a JSON header mapping
tensor names to {dtype, shape, data_offsets}, optionally a "__metadata__"
string map, then the raw tensor bytes. `read` reads one tensor;
`read_many` reads many at once through the parallel reader
(`uzu_tpu_torch/native/io_loader.cpp`, built with g++ at first use).
"""

from __future__ import annotations

import json
import os
import struct
from dataclasses import dataclass

import numpy as np
import torch

MAX_HEADER_SIZE = 100_000_000

# bf16 as raw bits: a distinct 2-byte dtype, so it never passes for U16
BF16 = np.dtype([("bf16", "<u2")])

_DTYPES: dict[str, np.dtype] = {
    "BOOL": np.dtype(np.bool_),
    "U8": np.dtype(np.uint8),
    "I8": np.dtype(np.int8),
    "I16": np.dtype(np.int16),
    "U16": np.dtype(np.uint16),
    "F16": np.dtype(np.float16),
    "BF16": BF16,
    "I32": np.dtype(np.int32),
    "U32": np.dtype(np.uint32),
    "F32": np.dtype(np.float32),
    "F64": np.dtype(np.float64),
    "I64": np.dtype(np.int64),
    "U64": np.dtype(np.uint64),
}
_DTYPE_NAMES = {v: k for k, v in _DTYPES.items()}


def dtype_name(dt: np.dtype) -> str:
    dt = np.dtype(dt)
    try:
        return _DTYPE_NAMES[dt]
    except KeyError:
        raise ValueError(f"unsupported safetensors dtype {dt}") from None


def to_bf16(a) -> np.ndarray:
    """float array -> BF16 bits, round to nearest even (NaN stays NaN)."""
    f = np.ascontiguousarray(a, dtype=np.float32)
    u = f.view(np.uint32)
    bits = ((u + np.uint32(0x7FFF) + ((u >> np.uint32(16)) & np.uint32(1)))
            >> np.uint32(16)).astype(np.uint16)
    nan = np.isnan(f)
    if nan.any():
        bits[nan] = ((u[nan] >> np.uint32(16)) | np.uint32(0x40)).astype(np.uint16)
    return bits.view(BF16)


def bf16_to_f32(a: np.ndarray) -> np.ndarray:
    """BF16 bits -> float32 (exact)."""
    u = np.ascontiguousarray(a).view(np.uint16).astype(np.uint32) << np.uint32(16)
    return u.view(np.float32)


def cast(a, dtype) -> np.ndarray:
    """`a.astype(dtype)` that also takes BF16 as the target."""
    dtype = np.dtype(dtype)
    return to_bf16(a) if dtype == BF16 else np.asarray(a).astype(dtype)


def to_torch(a: np.ndarray, device=None) -> torch.Tensor:
    """numpy (BF16 records included) -> torch tensor on `device`."""
    a = np.ascontiguousarray(a)
    if a.dtype == BF16:
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device) if device is not None else t


@dataclass(frozen=True)
class TensorInfo:
    dtype: np.dtype
    shape: tuple[int, ...]
    offset: int  # absolute byte offset into the file
    nbytes: int


class SafetensorsFile:
    """Lazy reader: header parsed eagerly, tensor bytes read on demand."""

    def __init__(self, path: str):
        self.path = path
        with open(path, "rb") as f:
            (header_len,) = struct.unpack("<Q", f.read(8))
            if header_len > MAX_HEADER_SIZE:
                raise ValueError("safetensors header too large")
            header = json.loads(f.read(header_len).decode("utf-8"))
        self.metadata: dict[str, str] = header.pop("__metadata__", {}) or {}
        base = 8 + header_len
        self.tensors: dict[str, TensorInfo] = {}
        for name, info in header.items():
            begin, end = info["data_offsets"]
            if end < begin:
                raise ValueError(f"invalid data offsets for {name}")
            if info["dtype"] not in _DTYPES:
                raise ValueError(f"tensor {name}: unsupported dtype {info['dtype']}")
            self.tensors[name] = TensorInfo(
                dtype=_DTYPES[info["dtype"]],
                shape=tuple(info["shape"]),
                offset=base + begin,
                nbytes=end - begin,
            )

    def keys(self):
        return self.tensors.keys()

    def read(self, name: str) -> np.ndarray:
        info = self.tensors[name]
        expected = int(np.prod(info.shape, dtype=np.int64)) * info.dtype.itemsize
        if expected != info.nbytes:
            raise ValueError(
                f"tensor {name}: byte size {info.nbytes} != shape {info.shape} @ {info.dtype}"
            )
        count = info.nbytes // info.dtype.itemsize
        return np.fromfile(self.path, dtype=info.dtype, count=count,
                           offset=info.offset).reshape(info.shape)

    def read_many(self, names=None, threads: int = 0) -> dict[str, np.ndarray]:
        """Read many tensors (default: all) in one pass of the native
        parallel reader, each into its own numpy buffer; `threads` <= 0
        takes the host's hardware concurrency. The same arrays as `read`."""
        import ctypes

        from ..native import io_loader

        names = list(names if names is not None else self.tensors)
        lib = io_loader()
        arrays: dict[str, np.ndarray] = {}
        offs = (ctypes.c_uint64 * len(names))()
        sizes = (ctypes.c_uint64 * len(names))()
        dests = (ctypes.c_void_p * len(names))()
        for i, n in enumerate(names):
            info = self.tensors[n]
            expected = int(np.prod(info.shape, dtype=np.int64)) * info.dtype.itemsize
            if expected != info.nbytes:
                raise ValueError(
                    f"tensor {n}: byte size {info.nbytes} != shape {info.shape} @ {info.dtype}")
            arr = np.empty(info.shape, dtype=info.dtype)
            arrays[n] = arr
            offs[i] = info.offset
            sizes[i] = info.nbytes
            dests[i] = arr.ctypes.data
        rc = lib.uz_read_parallel(self.path.encode(), len(names), offs, sizes, dests, threads)
        if rc != 0:
            raise OSError(-rc, f"parallel read of {self.path} failed: {os.strerror(-rc)}")
        return arrays


def save_file(path: str, tensors: dict[str, np.ndarray], metadata: dict[str, str] | None = None) -> None:
    header: dict = {}
    if metadata:
        header["__metadata__"] = {k: str(v) for k, v in metadata.items()}
    offset = 0
    order = list(tensors.items())
    for name, arr in order:
        n = arr.nbytes
        header[name] = {
            "dtype": dtype_name(arr.dtype),
            "shape": list(arr.shape),
            "data_offsets": [offset, offset + n],
        }
        offset += n
    blob = json.dumps(header).encode("utf-8")
    # pad header to 8-byte alignment (convention)
    pad = (-(8 + len(blob))) % 8
    blob += b" " * pad
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(blob)))
        f.write(blob)
        for _, arr in order:
            f.write(np.ascontiguousarray(arr).tobytes())
