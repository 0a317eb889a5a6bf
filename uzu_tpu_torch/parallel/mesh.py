"""Device mesh construction for multi-device execution.

Counterpart of `uzu_tpu/parallel/mesh.py`. The JAX package is one
controller over every device: GSPMD places the collectives. The port runs
one process per rank (SPMD over `torch.distributed`): each rank holds only
its own slice of the weights and states as plain tensors, and the
collectives are explicit (`ops/linear.py::SplitInput`, `models/moe.py`,
the engines). Axes of the (dp, tp) mesh, tp innermost:

- ``dp``: data parallel (independent sequences / batch-engine slots)
- ``tp``: tensor parallel (attention heads, MLP hidden, recurrent heads)

A mesh is a `torch.distributed.device_mesh.DeviceMesh` over the default
process group (`distributed.initialize`), which must span dp * tp ranks.
"""

from __future__ import annotations

import dataclasses

DP_AXIS = "dp"
TP_AXIS = "tp"


def _default_device_type() -> str:
    """The card's type; without a card this raises (`resolve_device`), so
    CPU ranks come only from an explicit device_type="cpu"."""
    from ..runtime import resolve_device

    return resolve_device(None).type


def make_mesh(tp: int | None = None, dp: int | None = None, device_type: str | None = None):
    """A (dp, tp) mesh over every rank of the default process group.

    If only one of tp/dp is given the other takes the remaining ranks; if
    neither is given, every rank goes to tp (latency-oriented serving).
    With no process group yet, one is joined first (`initialize`): the
    launcher's (torchrun's variables), or else a group of one."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from .distributed import initialize

    device_type = device_type or _default_device_type()
    initialize(device_type=device_type)

    n = dist.get_world_size()
    if tp is None and dp is None:
        tp, dp = n, 1
    elif tp is None:
        if n % dp:
            raise ValueError(f"dp={dp} does not divide the world size {n}")
        tp = n // dp
    elif dp is None:
        if n % tp:
            raise ValueError(f"tp={tp} does not divide the world size {n}")
        dp = n // tp
    if dp * tp != n:
        raise ValueError(f"dp*tp = {dp}*{tp} != {n} ranks")
    return init_device_mesh(device_type, (dp, tp),
                            mesh_dim_names=(DP_AXIS, TP_AXIS))


def single_device_mesh(device_type: str | None = None):
    """A (1, 1) mesh: a world of one."""
    return make_mesh(tp=1, dp=1, device_type=device_type)


@dataclasses.dataclass(frozen=True)
class Split:
    """How a tensor is cut over a mesh axis. `dim` None keeps it whole on
    every rank. Otherwise the tensor is read as consecutive `sections`
    along `dim` (default: one section, the whole dim); each section is cut
    into equal parts, one per rank, and a rank keeps its part of every
    section, concatenated in order (the fused [q|k|v] rows, for example)."""

    dim: int | None = None
    sections: tuple | None = None
    axis: str = TP_AXIS


def replicated(mesh=None) -> Split:
    """The rule that keeps a tensor whole on every rank."""
    return Split()


def axis_size(mesh, axis: str) -> int:
    if mesh is None or axis not in (mesh.mesh_dim_names or ()):
        return 1
    return mesh.size(mesh.mesh_dim_names.index(axis))


def axis_rank(mesh, axis: str) -> int:
    if mesh is None or axis not in (mesh.mesh_dim_names or ()):
        return 0
    return mesh.get_local_rank(axis)


def tp_size(mesh) -> int:
    return axis_size(mesh, TP_AXIS)


def dp_size(mesh) -> int:
    return axis_size(mesh, DP_AXIS)
