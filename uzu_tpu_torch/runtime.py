"""Device resolution and the kernel build directory.

Counterpart of `uzu_tpu/runtime.py`. The JAX package picks its kernels
with an environment variable and may run its Pallas kernels interpreted
on the CPU. The port has no such switch: every kernel wrapper decides from
the device of the tensor it is given (a CPU tensor takes the plain PyTorch
version, a CUDA tensor launches the hand-written kernel or raises), and
entry points run on the card unless the caller asks for the CPU.
"""

from __future__ import annotations

import os

import torch


def resolve_device(device=None) -> torch.device:
    """`None` means the card. Asking for CUDA without one raises: the
    port never drops to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "port's plain PyTorch path on the host")
    return dev


def kernel_build_dir() -> str:
    """Where the CUDA kernels are compiled at first use, inside the
    checkout (`.build/` is listed in .gitignore)."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    return os.path.join(root, ".build", "uzu_tpu_torch")
