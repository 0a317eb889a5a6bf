"""Host-side C++ libraries of the port, built with g++ at first use.

`io_loader()` is the parallel safetensors reader (`io_loader.cpp`, the
port's copy of `uzu_tpu/native/io_loader.cpp`); `load("grammar")` and
`load("regex_dfa")` are the grammar layer's mask engines (`grammar.cpp`,
`regex_dfa.cpp`, copies of the JAX package's), whose argument types
`grammar/native_backend.py` and `grammar/regex.py` set. Each is loaded
with ctypes and compiled into the gitignored `.build/` of the checkout,
its file name carrying a hash of the source and flags, so an edited
source is rebuilt and an unchanged one reused; nothing is built at
import. A failed build raises with the compiler's message: there is no
Python fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

from ..runtime import kernel_build_dir

_DIR = os.path.dirname(os.path.abspath(__file__))
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread")
_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def _library_path(name: str) -> str:
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    with open(os.path.join(_DIR, name + ".cpp"), "rb") as f:
        h.update(f.read())
    return os.path.join(kernel_build_dir(), f"{name}_{h.hexdigest()[:16]}.so")


def build(name: str) -> str:
    """Compile `<name>.cpp` unless its library exists; returns its path."""
    out = _library_path(name)
    if not os.path.exists(out):
        os.makedirs(os.path.dirname(out), exist_ok=True)
        tmp = f"{out}.{os.getpid()}.tmp"
        proc = subprocess.run(["g++", *GXX_FLAGS, os.path.join(_DIR, name + ".cpp"), "-o", tmp],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed for {name}.cpp:\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
    return out


def load(name: str) -> ctypes.CDLL:
    """Build `<name>.cpp` if needed and dlopen it, once per process."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = _libs[name] = ctypes.CDLL(build(name))
        return lib


def io_loader() -> ctypes.CDLL:
    """The parallel reader, with `uz_read_parallel`'s argument types set."""
    with _lock:
        lib = _libs.get("io_loader")
        if lib is None:
            lib = ctypes.CDLL(build("io_loader"))
            lib.uz_read_parallel.restype = ctypes.c_int
            lib.uz_read_parallel.argtypes = [
                ctypes.c_char_p, ctypes.c_int,
                ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(ctypes.c_uint64),
                ctypes.POINTER(ctypes.c_void_p), ctypes.c_int,
            ]
            _libs["io_loader"] = lib
        return lib
