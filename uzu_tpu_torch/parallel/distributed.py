"""Process-group initialization, multi-host meshes and sharded loading.

Counterpart of `uzu_tpu/parallel/distributed.py`. The JAX package wires
`jax.distributed` so one controller spans every host's devices; the port
runs one process per rank everywhere, so the same functions become:

- `initialize()` joins the default process group: from torchrun's
  variables (RANK, WORLD_SIZE, MASTER_ADDR/MASTER_PORT), from an explicit
  `init_method`, or, with neither, as a group of one. The backend follows
  the device: NCCL for CUDA ranks, gloo for CPU ranks; a caller may name
  gloo over CUDA tensors (several ranks sharing one card, which NCCL
  refuses). A failed NCCL init raises, it never falls back;
- `make_hybrid_mesh(tp, dp)` lays tp over the ranks of one host (tp
  innermost) and dp across hosts;
- `put_global` keeps this rank's slice of a host array;
  `shard_params_multihost` slices a full tree; `load_params_sharded`
  streams the file group by group (embedding, each layer, output norm,
  PLE), so no rank ever holds the full tree on its host.
"""

from __future__ import annotations

import os

import torch

from .mesh import DP_AXIS, TP_AXIS, Split, _default_device_type, axis_rank, axis_size, make_mesh


def initialize(init_method: str | None = None, world_size: int | None = None,
               rank: int | None = None, backend: str | None = None,
               device_type: str | None = None) -> bool:
    """Join the default process group unless one is joined already;
    returns True if this call joined it. On CUDA the rank's device becomes
    cuda:LOCAL_RANK (default: the rank modulo the visible cards)."""
    import torch.distributed as dist

    if dist.is_initialized():
        return False
    device_type = device_type or _default_device_type()
    backend = backend or ("nccl" if device_type == "cuda" else "gloo")
    env = os.environ
    launched = "RANK" in env and "WORLD_SIZE" in env
    if rank is None:
        rank = int(env["RANK"]) if launched else 0
    if world_size is None:
        world_size = int(env["WORLD_SIZE"]) if launched else 1
    if device_type == "cuda":
        local = int(env.get("LOCAL_RANK", rank % max(1, torch.cuda.device_count())))
        torch.cuda.set_device(local)
    if init_method is None and launched:
        init_method = "env://"
    if init_method is not None:
        dist.init_process_group(backend, init_method=init_method, world_size=world_size,
                                rank=rank)
    elif world_size == 1:
        # a world of one needs no rendezvous: an in-memory store
        dist.init_process_group(backend, store=dist.HashStore(), world_size=1, rank=0)
    else:
        raise ValueError(f"world_size={world_size} needs an init_method or a launcher's "
                         "RANK/WORLD_SIZE/MASTER_ADDR/MASTER_PORT")
    return True


def make_hybrid_mesh(tp: int | None = None, dp: int | None = None,
                     device_type: str | None = None):
    """(dp, tp) mesh with tp innermost: consecutive ranks (one host's,
    under torchrun) form a tp group. tp defaults to the ranks of one host
    (LOCAL_WORLD_SIZE)."""
    import torch.distributed as dist

    device_type = device_type or _default_device_type()
    initialize(device_type=device_type)
    n = dist.get_world_size()
    if tp is None:
        tp = min(n, int(os.environ.get("LOCAL_WORLD_SIZE", n)))
    if dp is None:
        dp = n // tp
    if dp * tp != n:
        raise ValueError(f"dp*tp = {dp}*{tp} != {n} ranks")
    return make_mesh(tp=tp, dp=dp, device_type=device_type)


def process_local_batch_slots(total_slots: int, mesh=None) -> tuple[int, int]:
    """(first slot, slot count) of this rank's dp replica."""
    import torch.distributed as dist

    if mesh is not None:
        n, r = axis_size(mesh, DP_AXIS), axis_rank(mesh, DP_AXIS)
    elif dist.is_initialized():
        n, r = dist.get_world_size(), dist.get_rank()
    else:
        n, r = 1, 0
    per = total_slots // n
    return per * r, per


def put_global(x, mesh, spec: Split, device=None) -> torch.Tensor:
    """This rank's slice of a host array `x` that every rank holds whole
    (weights read from the same file), on `device`."""
    from .sharding import cut
    from ..params.safetensors_io import to_torch

    t = to_torch(x) if not isinstance(x, torch.Tensor) else x
    if spec.dim is not None:
        t = cut(t, spec.dim, spec.sections, axis_rank(mesh, spec.axis),
                axis_size(mesh, spec.axis))
    return t.to(device) if device is not None else t


def shard_params_multihost(cfg, params, mesh, device=None) -> dict:
    """`sharding.shard_decoder_params` for a mesh that spans hosts:
    `params` must be identical on every rank (the same file)."""
    from .sharding import shard_decoder_params

    return shard_decoder_params(cfg, params, mesh, device=device)


def _tree_host_bytes(tree) -> int:
    from ..engine.engine import _tensors

    return sum(t.numel() * t.element_size() for t in _tensors(tree))


def load_params_sharded(model_dir: str, mesh, *, random_seed: int | None = None,
                        device=None):
    """Per-rank streamed sharded load: each group (the embedding, each
    layer, the output norm, PLE) is read from the file onto the host
    (no whole-file prefetch), this rank's slice is kept on `device`, and
    the host copy is dropped before the next group, so the host's peak is
    about one group. Returns (config, params, stats): `total_file_bytes`,
    `peak_group_host_bytes` (the largest group held on the host) and
    `addressable_param_bytes` (this rank's slice)."""
    from ..config import load_language_model_config
    from ..models.loader import load_embedding, load_layer, load_norm
    from ..params.tree import ParameterLoader
    from .sharding import _layer_specs, _whole, apply_specs, kept_whole, log_kept_whole, validate_tp

    config = load_language_model_config(os.path.join(model_dir, "config.json"))
    cfg = config.decoder_config
    tp = axis_size(mesh, TP_AXIS)
    validate_tp(cfg, tp)
    loader = ParameterLoader(os.path.join(model_dir, "model.safetensors"),
                             random_seed=random_seed, prefetch=False)
    tree = loader.tree()
    tcfg = cfg.transformer_config
    d = tcfg.model_dim
    r = axis_rank(mesh, TP_AXIS)
    group = mesh.get_group(TP_AXIS) if tp > 1 else None
    peak = 0

    def put(host, specs):
        nonlocal peak
        peak = max(peak, _tree_host_bytes(host))
        return apply_specs(host, specs, r, tp, group, device)

    emb = load_embedding(tree, cfg.embedding_config, cfg.vocab_size, d)
    params: dict = {"embedding": put(emb, _whole(emb))}
    del emb
    layers, whole = [], []
    for i, lc in enumerate(tcfg.layer_configs):
        p = load_layer(tree.subtree(f"transformer.layers.{i}"), lc, d, tcfg.hidden_dim)
        spec = _layer_specs(cfg, lc, p, tp)
        whole += kept_whole(i, spec, lc, d, tp)
        layers.append(put(p, spec))
        del p
    params["layers"] = layers
    log_kept_whole(whole)
    onorm = load_norm(tree.subtree("transformer.output_norm"), d, tcfg.output_norm_config)
    params["output_norm"] = put(onorm, _whole(onorm))
    del onorm
    if cfg.ple_model_config is not None:
        from ..models.ple import load_ple

        ple = load_ple(tree, cfg, tcfg)
        params["per_layer_embedding"] = put(ple, _whole(ple))
        del ple
    tree.assert_all_validated()
    stats = {
        "total_file_bytes": sum(info.nbytes for info in loader._file.tensors.values()),
        "peak_group_host_bytes": peak,
        "addressable_param_bytes": _tree_host_bytes(params),
    }
    return config, params, stats
