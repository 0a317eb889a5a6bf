"""Tensor-parallel slice rules for decoder params and decoding states.

Counterpart of `uzu_tpu/parallel/sharding.py`. The JAX package annotates
whole arrays with one PartitionSpec each and lets GSPMD reshard where the
model slices them; here each rank keeps only its own slice as a plain
tensor, so a fused weight is cut section by section (Megatron's split):

- qkv [q | k | v] rows: rank r keeps [q_r | k_r | v_r] (heads r·H/tp..,
  KV groups r·G/tp..); the attention gate's rows per head likewise
- out [D, H·Dh]: columns (heads), a `SplitInput`: the ranks' products are
  all-reduced, then the whole bias is added once
- dense MLP up [up | gate] rows: [up_r | gate_r] (`mlp_forward` splits at
  the half); down: columns, a `SplitInput`
- MoE: router replicated; dense expert stacks keep their hidden slice
  ([up_r | gate_r] rows, down columns); quantized stacks stay whole, as in
  the JAX package; shared experts like a dense MLP
- recurrent mixers: each section of the fused in-projection ([q|k|v|z|
  beta|a] for GDN, [x|B|C|z|dt] for Mamba2, [pre|post|x] for ShortConv)
  cut per head or channel, the depthwise conv's channels with the channels
  they convolve, per-head vectors per head; out: columns
- KV [C, G, Dh] and the INT8 scale planes [C, G] on G; a ring's position
  array whole; conv [k-1, channels] on its channel sections, ssm [H, ..]
  on heads; under dp the leading slot dim of a batched state
- norms, embeddings, PLE: whole

A quantized column slice is cut at group boundaries (codes [N, K/pack],
scales and qbias [N, K/g]) and made contiguous once, as K1 needs. Where
GSPMD would reshard, `validate_tp` raises instead: (K/tp) % g for a
quantized column slice, and the Hadamard blocks of 32 of a HybridLinear's
split side must fall inside one rank.
"""

from __future__ import annotations

import dataclasses

import torch

from ..config.model import (
    AttentionConfig,
    DecoderConfig,
    DeltaNetConfig,
    DenseMLPConfig,
    Mamba2Config,
    MixtureOfExpertsConfig,
    ShortConvConfig,
    TransformerLayerConfig,
)
from ..ops.linear import SplitInput
from ..quant.format import HybridLinear, QuantizedTensor, StackedQuantized
from .mesh import DP_AXIS, TP_AXIS, Split, axis_rank, axis_size, tp_size

RHT_BLOCK = 32


# --------------------------------------------------------------------------
# Section layouts of the fused weights and states
# --------------------------------------------------------------------------


def _qkv_sections(m: AttentionConfig) -> tuple:
    q = m.num_heads * m.head_dim
    return (q,) if m.is_kv_sharing else (q, m.num_groups * m.head_dim,
                                         m.num_groups * m.head_dim)


def _recurrent_sections(m, model_dim: int) -> tuple[tuple, tuple]:
    """(in-projection row sections, conv channel sections)."""
    if isinstance(m, ShortConvConfig):
        return (model_dim,) * 3, (model_dim,)
    if isinstance(m, Mamba2Config):
        inner, gn = m.num_heads * m.head_dim, m.num_groups * m.state_dim
        return (inner, gn, gn, inner, m.num_heads), (inner, gn, gn)
    if isinstance(m, DeltaNetConfig):
        kd, vd = m.num_groups * m.head_dim, m.num_heads * m.value_head_dim
        return (kd, kd, vd, vd, m.num_heads, m.num_heads), (kd, kd, vd)
    raise ValueError(f"unsupported mixer {type(m).__name__}")


def _hidden(lc: TransformerLayerConfig, cfg: DecoderConfig) -> int:
    return lc.hidden_dim or cfg.transformer_config.hidden_dim


# --------------------------------------------------------------------------
# Validation and the rank-local config
# --------------------------------------------------------------------------


def _check(cond: bool, where: str, msg: str) -> None:
    if not cond:
        raise ValueError(f"{where}: {msg}")


def _check_linear(w, split: Split, tp: int, where: str) -> None:
    """The port's checks beyond the JAX package's: a quantized column slice
    must hold whole groups, and the split side of a HybridLinear whole
    Hadamard blocks (GSPMD reshards there; the port cannot)."""
    if split.dim is None or tp == 1:
        return
    sections = split.sections or (w.shape[split.dim],)
    base = w.base if isinstance(w, HybridLinear) else w
    if isinstance(base, QuantizedTensor) and split.dim == 1:
        k = base.shape[1]
        _check((k // tp) % base.group_size == 0 and k % tp == 0, where,
               f"tp={tp} cuts K={k} inside a quantization group of {base.group_size} "
               f"((K/tp) % g must be 0)")
    if isinstance(w, HybridLinear):
        signs = w.output_signs if split.dim == 0 else w.input_signs
        if signs is not None:
            _check(all(s % (tp * RHT_BLOCK) == 0 for s in sections), where,
                   f"tp={tp} cuts a Hadamard block of {RHT_BLOCK} (sections {sections} "
                   f"must each split into multiples of {RHT_BLOCK})")


def validate_tp(cfg: DecoderConfig, tp: int, params: dict | None = None) -> None:
    """Raise ValueError unless every layer splits evenly over tp ranks. With
    `params`, also the weight-level checks of the module docstring."""
    tcfg = cfg.transformer_config
    for i, lc in enumerate(tcfg.layer_configs):
        m = lc.mixer_config
        where = f"layer {i}"
        if isinstance(m, AttentionConfig):
            _check(m.num_heads % tp == 0 and m.num_groups % tp == 0, where,
                   f"tp={tp} must divide num_heads={m.num_heads} and num_groups={m.num_groups}")
        elif isinstance(m, (Mamba2Config, DeltaNetConfig)):
            _check(m.num_heads % tp == 0 and m.num_groups % tp == 0, where,
                   f"tp={tp} must divide the recurrent num_heads={m.num_heads} and "
                   f"num_groups={m.num_groups}")
        elif isinstance(m, ShortConvConfig):
            _check(tcfg.model_dim % tp == 0, where,
                   f"tp={tp} must divide the ShortConv channels {tcfg.model_dim}")
        mlp = lc.mlp_config
        if isinstance(mlp, DenseMLPConfig):
            _check(_hidden(lc, cfg) % tp == 0, where,
                   f"tp={tp} must divide hidden_dim={_hidden(lc, cfg)}")
        if isinstance(mlp, MixtureOfExpertsConfig):
            _check(mlp.expert_hidden_dim % tp == 0, where,
                   f"tp={tp} must divide expert_hidden_dim={mlp.expert_hidden_dim}")
    if params is not None:
        for i, p in enumerate(params["layers"]):
            validate_layer_params(cfg, i, p, tp)


def validate_layer_params(cfg: DecoderConfig, i: int, p: dict, tp: int) -> None:
    """The weight-level checks of layer i's params (module docstring)."""
    lc = cfg.transformer_config.layer_configs[i]
    for path, w, split in _linear_rules(cfg, lc, p):
        _check_linear(w, split, tp, f"layer {i} {path}")


def local_config(cfg: DecoderConfig, tp: int, params: dict | None = None) -> DecoderConfig:
    """The config a tp rank runs: attention heads and KV groups, recurrent
    heads and groups, MLP hidden widths and (dense stacks only) expert
    hidden widths divided by tp. A ShortConv mixer's channels follow its
    weights' shapes."""
    if tp == 1:
        return cfg
    tcfg = cfg.transformer_config
    layers = []
    for i, lc in enumerate(tcfg.layer_configs):
        m, mlp = lc.mixer_config, lc.mlp_config
        if isinstance(m, (AttentionConfig, Mamba2Config, DeltaNetConfig)):
            m = dataclasses.replace(m, num_heads=m.num_heads // tp,
                                    num_groups=m.num_groups // tp)
        if isinstance(mlp, MixtureOfExpertsConfig) and not (
                params is not None
                and isinstance(params["layers"][i]["mlp"]["up"]["w"], StackedQuantized)):
            mlp = dataclasses.replace(mlp, expert_hidden_dim=mlp.expert_hidden_dim // tp)
        layers.append(dataclasses.replace(
            lc, mixer_config=m, mlp_config=mlp,
            hidden_dim=None if lc.hidden_dim is None else lc.hidden_dim // tp))
    tcfg = dataclasses.replace(tcfg, layer_configs=tuple(layers),
                               hidden_dim=tcfg.hidden_dim // tp)
    return dataclasses.replace(cfg, transformer_config=tcfg)


# --------------------------------------------------------------------------
# Param rules
# --------------------------------------------------------------------------


ROWS = 0
COLUMNS = 1


def _linear_spec(p: dict, rows: bool, sections=None) -> dict:
    """A linear's rules: rows (output dim) cut by sections, bias with them;
    or columns (input dim), a partial sum, bias whole."""
    if rows:
        out = {"w": Split(dim=ROWS, sections=sections)}
        if "b" in p:
            out["b"] = Split(dim=0, sections=sections)
    else:
        out = {"w": Split(dim=COLUMNS)}
        if "b" in p:
            out["b"] = Split()
    return out


def _whole(p):
    if isinstance(p, dict):
        return {k: _whole(v) for k, v in p.items()}
    if isinstance(p, list):
        return [_whole(v) for v in p]
    return Split()


def _attention_specs(m: AttentionConfig, p: dict) -> dict:
    out = {"qkv": _linear_spec(p["qkv"], True, _qkv_sections(m)),
           "out": _linear_spec(p["out"], False)}
    if "gate" in p:
        out["gate"] = _linear_spec(p["gate"], True)
    for k in ("q_norm_scales", "k_norm_scales", "v_norm_scales"):
        if k in p:
            out[k] = Split()
    if "sinks" in p:
        out["sinks"] = Split(dim=0)
    return out


def _mlp_specs(lc: TransformerLayerConfig, cfg: DecoderConfig, p: dict) -> dict:
    mlp = lc.mlp_config
    if isinstance(mlp, DenseMLPConfig):
        hid = p["up"]["w"].shape[0] // 2
        return {"up": _linear_spec(p["up"], True, (hid, hid)),
                "down": _linear_spec(p["down"], False)}
    if isinstance(mlp, MixtureOfExpertsConfig):
        dff = mlp.expert_hidden_dim
        if isinstance(p["up"]["w"], StackedQuantized):
            out = {"up": _whole(p["up"]), "down": _whole(p["down"])}
        else:
            out = {"up": {"w": Split(dim=1, sections=(dff, dff))},
                   "down": {"w": Split(dim=2)}}
            if "b" in p["up"]:
                out["up"]["b"] = Split(dim=1, sections=(dff, dff))
            if "b" in p["down"]:
                out["down"]["b"] = Split()
        out["router"] = _whole(p["router"])
        if "shared" in p:
            width = p["shared"]["up"]["w"].shape[0] // 2
            out["shared"] = {"up": _linear_spec(p["shared"]["up"], True, (width, width)),
                             "down": _linear_spec(p["shared"]["down"], False)}
        return out
    raise ValueError(f"unsupported mlp config {type(mlp).__name__}")


def _ssm_specs(m, model_dim: int, p: dict) -> dict:
    in_sections, conv_sections = _recurrent_sections(m, model_dim)
    out = {"in": _linear_spec(p["in"], True, in_sections),
           "out": _linear_spec(p["out"], False),
           "conv_w": Split(dim=0, sections=conv_sections)}
    if "conv_b" in p:
        out["conv_b"] = Split(dim=0, sections=conv_sections)
    for k in ("gate_bias", "skip_weight", "a_log", "dt_bias"):
        if k in p:
            out[k] = Split(dim=0)
    if "norm_scales" in p:
        out["norm_scales"] = Split()  # per-head RMSNorm over dv: the same on every head
    return out


def _layer_specs(cfg: DecoderConfig, lc: TransformerLayerConfig, p: dict) -> dict:
    m = lc.mixer_config
    if isinstance(m, AttentionConfig):
        mixer = _attention_specs(m, p["mixer"])
    else:
        mixer = _ssm_specs(m, cfg.transformer_config.model_dim, p["mixer"])
    out = {"mixer": mixer, "mlp": _mlp_specs(lc, cfg, p["mlp"])}
    for k in p:
        if k not in out:
            out[k] = _whole(p[k])
    return out


def _linear_rules(cfg, lc, p):
    """(path, weight, Split) of every linear weight of one layer."""
    spec = _layer_specs(cfg, lc, p)
    for part in ("mixer", "mlp"):
        for name, sub in spec[part].items():
            if isinstance(sub, dict) and isinstance(sub.get("w"), Split):
                yield f"{part}.{name}", p[part][name]["w"], sub["w"]
            elif name == "shared":
                for sname, ssub in sub.items():
                    yield f"{part}.shared.{sname}", p[part]["shared"][sname]["w"], ssub["w"]


def decoder_param_specs(cfg: DecoderConfig, params: dict, mesh=None) -> dict:
    """The slice rules of every parameter: a tree of `Split`s, a prefix of
    `params` (one rule covers a whole quantized or hybrid weight)."""
    specs = {
        "embedding": _whole(params["embedding"]),
        "layers": [_layer_specs(cfg, lc, params["layers"][i])
                   for i, lc in enumerate(cfg.transformer_config.layer_configs)],
        "output_norm": _whole(params["output_norm"]),
    }
    if "per_layer_embedding" in params:
        specs["per_layer_embedding"] = _whole(params["per_layer_embedding"])
    return specs


# --------------------------------------------------------------------------
# Cutting
# --------------------------------------------------------------------------


def cut(t: torch.Tensor, dim: int, sections, r: int, n: int) -> torch.Tensor:
    """Rank r's part of each section of `t` along `dim`, concatenated,
    contiguous (a copy unless the part is the whole tensor)."""
    sections = tuple(sections or (t.shape[dim],))
    if sum(sections) != t.shape[dim]:
        raise ValueError(f"sections {sections} do not cover dim {dim} of {tuple(t.shape)}")
    parts, off = [], 0
    for length in sections:
        if length % n:
            raise ValueError(f"section of {length} does not split over {n} ranks")
        part = length // n
        parts.append(t.narrow(dim, off + r * part, part))
        off += length
    out = parts[0] if len(parts) == 1 else torch.cat(parts, dim)
    return out.contiguous()


def _cut_weight(w, split: Split, r: int, n: int):
    """Rank r's slice of a weight (tensor, quantized, hybrid) under a rule;
    quantized columns are cut in codes' and groups' units."""
    if split.dim is None or n == 1:
        return w
    if isinstance(w, torch.Tensor):
        return cut(w, split.dim, split.sections, r, n)
    if isinstance(w, QuantizedTensor):
        if split.dim == ROWS:
            def f(t):
                return cut(t, 0, split.sections, r, n)
        else:
            k = w.shape[1]
            pack = 8 // w.bits

            def f(t):
                unit = pack if t is w.codes else w.group_size
                return cut(t, 1, (k // unit,), r, n)
        return dataclasses.replace(w, codes=f(w.codes), scales=f(w.scales),
                                   qbias=None if w.qbias is None else f(w.qbias))
    if isinstance(w, HybridLinear):
        def vec(t):
            return None if t is None else cut(t, 0, split.sections, r, n)

        if split.dim == ROWS:
            return HybridLinear(base=_cut_weight(w.base, split, r, n),
                                adapter_down=w.adapter_down,
                                adapter_up=None if w.adapter_up is None else cut(
                                    w.adapter_up, 0, split.sections, r, n),
                                input_signs=w.input_signs, output_signs=vec(w.output_signs))
        return HybridLinear(base=_cut_weight(w.base, split, r, n),
                            adapter_down=None if w.adapter_down is None else cut(
                                w.adapter_down, 1, None, r, n),
                            adapter_up=w.adapter_up, input_signs=vec(w.input_signs),
                            output_signs=w.output_signs)
    raise ValueError(f"cannot split a {type(w).__name__} (quantized expert stacks stay whole)")


def apply_specs(params, specs, r: int, n: int, group=None, device=None):
    """Rank r of n's slice of `params` under a rule tree; a weight cut on
    its input dimension (the last dim of a "w", a partial sum) becomes a
    `SplitInput` over `group`."""
    if isinstance(specs, Split):
        out = _cut_weight(params, specs, r, n)
        if device is not None:
            out = out.to(device)
        return out
    if isinstance(specs, dict):
        out = {}
        for k, v in params.items():
            sub = apply_specs(v, specs[k], r, n, group, device)
            s = specs[k]
            if (k == "w" and isinstance(s, Split) and s.dim is not None and n > 1
                    and s.dim == len(v.shape) - 1):
                sub = SplitInput(sub, group)
            out[k] = sub
        return out
    if isinstance(specs, list):
        return [apply_specs(v, s, r, n, group, device) for v, s in zip(params, specs)]
    raise TypeError(f"bad spec {specs!r}")


def shard_decoder_params(cfg: DecoderConfig, params: dict, mesh, device=None) -> dict:
    """This rank's tensor-parallel slice of full `params` (on the host or
    any device), moved to `device`. Replicated over dp."""
    tp = tp_size(mesh)
    validate_tp(cfg, tp, params)
    specs = decoder_param_specs(cfg, params, mesh)
    group = mesh.get_group(TP_AXIS) if tp > 1 else None
    return apply_specs(params, specs, axis_rank(mesh, TP_AXIS), tp, group, device)


# --------------------------------------------------------------------------
# State rules
# --------------------------------------------------------------------------


def state_specs(cfg: DecoderConfig, state: dict, mesh=None, *, batched: bool = False) -> dict:
    """Rules for a decoding state: per leaf a tuple of `Split`s, applied in
    turn (the slot dim over dp when batched, then tp's)."""
    lead = 1 if batched else 0
    dp = (Split(dim=0, axis=DP_AXIS),) if batched else ()
    layers = []
    for layer_state, lc in zip(state["layers"], cfg.transformer_config.layer_configs):
        m = lc.mixer_config
        if layer_state is None:
            layers.append(None)
        elif isinstance(m, AttentionConfig):
            # k/v/k_q/v_q [C, G, Dh] and scales [C, G] on G; ring positions whole
            layers.append({k: dp + ((Split(dim=lead + 1),) if v.dim() - lead >= 2 else ())
                           for k, v in layer_state.items()})
        else:
            _, conv_sections = _recurrent_sections(m, cfg.transformer_config.model_dim)
            rules = {}
            for k, v in layer_state.items():
                if k == "conv":
                    rules[k] = dp + (Split(dim=lead + 1, sections=conv_sections),)
                elif k == "ssm":
                    rules[k] = dp + (Split(dim=lead),)
                else:
                    rules[k] = dp
            layers.append(rules)
    out = {"layers": layers}
    for k in state:
        if k != "layers":
            out[k] = dp
    return out


def shard_state(cfg: DecoderConfig, state: dict, mesh, *, batched: bool = False) -> dict:
    """This rank's slice of a full decoding state under `state_specs`."""
    specs = state_specs(cfg, state, mesh, batched=batched)

    def apply(t, rules):
        for s in rules:
            t = cut(t, s.dim, s.sections, axis_rank(mesh, s.axis), axis_size(mesh, s.axis))
        return t

    layers = [None if ls is None else {k: apply(v, specs["layers"][i][k])
                                       for k, v in ls.items()}
              for i, ls in enumerate(state["layers"])]
    out = {k: apply(v, specs[k]) for k, v in state.items() if k != "layers"}
    out["layers"] = layers
    return out
