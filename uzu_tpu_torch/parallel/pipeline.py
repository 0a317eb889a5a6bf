"""Pipeline parallelism: the layer stack split into stages over a ``pp``
axis.

Counterpart of `uzu_tpu/parallel/pipeline.py` (GPipe). The L layers split
into P stages of L/P consecutive layers; the rank of stage p keeps only
its layers' params and states (that is what lets a model too large for
one device run). The batch splits into M microbatches; stage p takes each
microbatch in turn: it receives the activation from stage p-1 (stage 0
embeds), runs its layers, and sends the result on to stage p+1 with
point-to-point send/recv, so stage p works on microbatch t-p at step t and
a forward takes M+P-1 steps with the usual bubble. The last stage's
outputs are broadcast over the stage group before the replicated readout.
With a tp axis, each stage's layers are also split over tp (Megatron, as
`sharding.py`) and each tp rank talks to its counterpart in the next
stage.

Constraints (validated): the layer pattern must repeat with a period
dividing L/P (uniform attention decoders, and periodic hybrids such as
Qwen3.5's GDN + attention blocks), no cross-layer KV sharing, no
per-layer embeddings.
"""

from __future__ import annotations

import torch

from ..config.model import DecoderConfig
from .mesh import TP_AXIS, axis_rank, axis_size

PP_AXIS = "pp"


def make_pp_mesh(pp: int | None = None, tp: int = 1, device_type: str | None = None):
    """(pp, tp) mesh over every rank of the default process group: pipeline
    stages x tensor shards within each stage."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from .distributed import initialize
    from .mesh import _default_device_type

    device_type = device_type or _default_device_type()
    initialize(device_type=device_type)
    n = dist.get_world_size()
    if pp is None:
        pp = n // tp
    if pp * tp != n:
        raise ValueError(f"pp*tp = {pp}*{tp} != {n} ranks")
    return init_device_mesh(device_type, (pp, tp),
                            mesh_dim_names=(PP_AXIS, TP_AXIS))


def validate_pp(cfg: DecoderConfig, pp: int) -> None:
    """Stages must be structurally identical: layer i of every stage needs
    the same config, i.e. the layer pattern repeats with a period dividing
    L/P."""
    tcfg = cfg.transformer_config
    n = len(tcfg.layer_configs)
    if n % pp:
        raise ValueError(f"pp={pp} must divide num_layers={n}")
    lp = n // pp
    for i, lc in enumerate(tcfg.layer_configs):
        if lc != tcfg.layer_configs[i % lp]:
            raise ValueError(f"layer {i}: stages are not structurally identical (layer "
                             f"pattern must repeat with a period dividing L/P={lp})")
        if lc.kv_source_layer_index is not None:
            raise ValueError(f"layer {i}: KV sharing is unsupported under pp")
    if cfg.ple_model_config is not None:
        raise ValueError("pipeline does not support per-layer embeddings")


def _stage(mesh) -> tuple[int, int]:
    """(this rank's stage, the number of stages)."""
    return axis_rank(mesh, PP_AXIS), axis_size(mesh, PP_AXIS)


def stack_pipeline_params(cfg: DecoderConfig, params: dict, mesh) -> dict:
    """This rank's stage of full `params`: {"layers": its L/P layers (split
    over tp when the mesh has a tp axis), "embedding", "output_norm"}."""
    from .sharding import _layer_specs, apply_specs, kept_whole, log_kept_whole, validate_tp

    p, pp = _stage(mesh)
    tp = axis_size(mesh, TP_AXIS)
    validate_pp(cfg, pp)
    if tp > 1:
        validate_tp(cfg, tp)
    lp = len(cfg.transformer_config.layer_configs) // pp
    group = mesh.get_group(TP_AXIS) if tp > 1 else None
    r = axis_rank(mesh, TP_AXIS)
    layers, whole = [], []
    for i in range(p * lp, (p + 1) * lp):
        lc = cfg.transformer_config.layer_configs[i]
        spec = _layer_specs(cfg, lc, params["layers"][i], tp)
        whole += kept_whole(i, spec, lc, cfg.transformer_config.model_dim, tp)
        layers.append(apply_specs(params["layers"][i], spec, r, tp, group))
    log_kept_whole(whole)
    return {"layers": layers, "embedding": params["embedding"],
            "output_norm": params["output_norm"]}


def stack_pipeline_states(cfg: DecoderConfig, states: dict, mesh, microbatches: int) -> dict:
    """Batched full states {"layers": [per-layer leaves [B, ...]], "pos": [B]}
    -> {"kv": this stage's L/P layer states with leaves [M, B/M, ...] (split
    over tp), "pos": [B]}."""
    from .sharding import cut, state_specs

    p, pp = _stage(mesh)
    lp = len(cfg.transformer_config.layer_configs) // pp
    b = states["pos"].shape[0]
    if b % microbatches:
        raise ValueError(f"batch {b} must divide into {microbatches} microbatches")
    specs = state_specs(cfg, states, mesh, batched=True)
    tp, r = axis_size(mesh, TP_AXIS), axis_rank(mesh, TP_AXIS)
    kv = []
    for i in range(p * lp, (p + 1) * lp):
        tree = {}
        for k, v in states["layers"][i].items():
            for s in specs["layers"][i][k]:
                if s.axis == TP_AXIS:
                    v = cut(v, s.dim, s.sections, r, tp)
            tree[k] = v.reshape(microbatches, b // microbatches, *v.shape[1:]).clone()
        kv.append(tree)
    return {"kv": kv, "pos": states["pos"].clone()}


def unstack_pipeline_states(states: dict, mesh) -> dict:
    """Inverse of `stack_pipeline_states` (for parity checks): every
    stage's layer states gathered to every rank, leaves [B, ...] (still
    this rank's tp slice)."""
    import torch.distributed as dist

    group = mesh.get_group(PP_AXIS)
    pp = axis_size(mesh, PP_AXIS)
    lp = len(states["kv"])
    layers = [None] * (pp * lp)
    for i, tree in enumerate(states["kv"]):
        for k, v in tree.items():
            flat = v.reshape(v.shape[0] * v.shape[1], *v.shape[2:]).contiguous()
            parts = [torch.empty_like(flat) for _ in range(pp)]
            dist.all_gather(parts, flat, group=group)
            for j in range(pp):
                layers[j * lp + i] = {**(layers[j * lp + i] or {}), k: parts[j]}
    return {"layers": layers, "pos": states["pos"]}


def pipeline_forward(cfg: DecoderConfig, pp_params: dict, tokens: torch.Tensor,
                     pp_states: dict, mesh, *, microbatches: int, true_lengths=None):
    """One pipelined forward (a prefill chunk or a decode step) of the
    batch tokens [B, S]; returns (last-row logits [B, V], new pp_states),
    as `decoder_forward(last_only=True)` per sequence would."""
    import torch.distributed as dist

    from ..models.decoder import embed, layer_forward, readout

    from .sharding import local_config

    tcfg = cfg.transformer_config
    p, pp = _stage(mesh)
    lp = len(tcfg.layer_configs) // pp
    # the configs this rank runs: its stage's layers, heads and widths over tp
    slot_cfgs = local_config(cfg, axis_size(mesh, TP_AXIS)).transformer_config.layer_configs[
        p * lp:(p + 1) * lp]
    t = axis_rank(mesh, TP_AXIS)
    b, s = tokens.shape
    m = microbatches
    mb = b // m
    dev = tokens.device
    if true_lengths is None:
        true_lengths = torch.full((b,), s, dtype=torch.int32, device=dev)
    pos = pp_states["pos"]
    positions = pos[:, None] + torch.arange(s, dtype=torch.int32, device=dev)[None, :]
    rank_of = mesh.mesh  # [pp, tp] global ranks
    d = tcfg.model_dim
    x0 = None
    if p == 0:
        x0 = torch.stack([embed(cfg, pp_params, tokens[i]) for i in range(b)])
    outs = torch.empty((b, s, d), dtype=_act_dtype(pp_params), device=dev)
    sends = []
    for mi in range(m):
        rows = range(mi * mb, (mi + 1) * mb)
        if p == 0:
            x = x0[mi * mb:(mi + 1) * mb]
        else:
            x = torch.empty((mb, s, d), dtype=outs.dtype, device=dev)
            dist.recv(x, src=int(rank_of[p - 1, t]))
        ys = []
        for j, bi in enumerate(rows):
            xi = x[j]
            for li, lc in enumerate(slot_cfgs):
                view = {k: v[mi, j] for k, v in pp_states["kv"][li].items()}
                xi, new = layer_forward(lc, pp_params["layers"][li], xi, positions[bi], view,
                                        None, true_lengths[bi])
                for k, v in new.items():
                    if v.data_ptr() != view[k].data_ptr():
                        view[k].copy_(v)
            ys.append(xi)
        y = torch.stack(ys)
        if p < pp - 1:
            sends.append(dist.isend(y.contiguous(), dst=int(rank_of[p + 1, t])))
        else:
            outs[mi * mb:(mi + 1) * mb] = y
    for req in sends:
        req.wait()
    dist.broadcast(outs, src=int(rank_of[pp - 1, t]), group=mesh.get_group(PP_AXIS))
    logits = torch.stack([
        readout(cfg, pp_params, outs[i, int(true_lengths[i]) - 1:int(true_lengths[i])])[0]
        for i in range(b)])
    return logits, {"kv": pp_states["kv"], "pos": pos + true_lengths.to(pos.dtype)}


def _act_dtype(pp_params: dict):
    """The activations' dtype: the input embedding table's."""
    emb = pp_params["embedding"]
    table = emb.get("tied", emb.get("input"))
    return table.dtype if isinstance(table, torch.Tensor) else table.scales.dtype
