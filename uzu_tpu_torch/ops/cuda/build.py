"""Build the hand-written CUDA kernels at first use and count launches.

Each source in `uzu_tpu_torch/csrc/` is compiled by `nvcc` for `sm_90a`
into a shared library with a plain C interface, loaded with ctypes. The
library name carries a hash of its source and of the shared headers
(`csrc/*.cuh`), so an edited kernel is rebuilt and an unchanged one is
reused. Nothing here runs at import: the package
imports, and its CPU path runs, on a machine without `nvcc`.

`LAUNCHES` counts, per kernel, the launches its wrapper made; a wrapper
adds one where it launches its kernel and nowhere else.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time

from ...runtime import kernel_build_dir

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "csrc")
SOURCES = ("quant_matmul", "flash_attention", "paged_attention", "moe_gemv",
           "grouped_matmul")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

LAUNCHES: dict[str, int] = {
    "quant_matmul_int4": 0,
    "quant_matmul_int8": 0,
    "flash_attention": 0,
    "flash_attention_int8": 0,
    "paged_attention": 0,
    "paged_attention_int8": 0,
    "moe_gemv_int4": 0,
    "moe_gemv_int8": 0,
    "grouped_matmul_int4": 0,
    "grouped_matmul": 0,
}

_LIBS: dict[str, ctypes.CDLL] = {}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def _library_path(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))
    for f in [name + ".cu", *headers]:
        with open(os.path.join(CSRC, f), "rb") as src:
            h.update(src.read())
    return os.path.join(kernel_build_dir(), f"{name}_{h.hexdigest()[:16]}.so")


def build(names=SOURCES) -> float:
    """Compile every library in `names` that is not built yet, one `nvcc`
    per source, all started together. Returns the seconds it took."""
    t0 = time.perf_counter()
    todo = [(n, _library_path(n)) for n in names if not os.path.exists(_library_path(n))]
    if todo:
        os.makedirs(kernel_build_dir(), exist_ok=True)
        nvcc = _nvcc()
        procs = []
        for name, lib in todo:
            tmp = f"{lib}.{os.getpid()}.tmp"
            cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, name + ".cu")]
            procs.append((name, lib, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
        errors = []
        for name, lib, tmp, proc in procs:
            log = proc.communicate()[0].decode(errors="replace")
            if proc.returncode != 0:
                errors.append(f"nvcc failed for {name}.cu:\n{log}")
            else:
                os.replace(tmp, lib)
        if errors:
            raise RuntimeError("\n".join(errors))
    return time.perf_counter() - t0


def library(name: str) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, built on first use."""
    lib = _LIBS.get(name)
    if lib is None:
        build((name,))
        lib = ctypes.CDLL(_library_path(name))
        _LIBS[name] = lib
    return lib


def check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {rc}")
