"""Recurrent token mixers: ShortConv (LFM2), Mamba2, Gated DeltaNet (Qwen3.5).

Counterpart of `uzu_tpu/models/ssm.py`, with its semantics:

- ShortConv: in_projection rows are [pre_gate | post_gate | x]; a
  depthwise causal conv over x * pre_gate; the output times post_gate;
  out_projection.
- Mamba2: in_projection rows are [conv_in (x | B | C) | z | dt_raw]; a
  depthwise conv and activation over conv_in; dt = softplus(dt_raw),
  decay = exp(-dt); S <- S * decay + x (x) B; y = S C + D x; y *=
  silu(z + gate_bias); out_projection.
- GDN: in_proj rows are [q | k | v (conv'd + SiLU) | z | beta_raw | a_raw];
  q and k L2-normalized (q scaled by dk^-1/2); beta = sigmoid(beta_raw);
  decay = exp(-exp(a_log) * softplus(a_raw + dt_bias)); the delta rule
  S <- decay S + beta (v - decay S k) (x) k; o = decay S q + delta (k . q);
  per-head RMSNorm(o) * norm_w * silu(z); out_proj.

States are f32 (a ShortConv tail keeps the state's dtype): time-major
[k-1, C] conv tails and [H, dv, dk] (GDN) / [H, dh, n] (Mamba2) states.
Rows at and past `true_length` are identity transitions (decay 1, input
0), and the conv tail is cut at `true_length`, so padded rows never enter
the state. Below SSM_CHUNKED_MIN_S rows the recurrence is a per-token
loop; at and above it the chunk-parallel cores run whole chunks of
SSM_PREFILL_CHUNK rows as batched matrix products with one state carry
per chunk. The JAX package has no Pallas kernel here either: these are
plain PyTorch products, in f32.

Every function works on a leading batch dimension: `ssm_forward` is the
single-sequence entry ([S, D], unbatched state) that the decoder calls,
and `ssm_forward_batched` takes x [B, S, D], states with a leading [B]
and one true length per row, which the dense batch engine's decode step
uses with S = 1.

Speculative verification (the JAX package's defer / commit / tree
functions): `ssm_forward(..., defer=True)` computes the outputs of every
row and commits no state; it returns the recurrence inputs instead, and
`ssm_commit` replays the per-token recurrence over the first
`commit_length` rows (a 0-d device tensor, decided after the forward) with
the rest as identity transitions (`ssm_commit_batched` commits B
sequences at once, one length each, for the speculative batch engines).
`ssm_tree_forward` runs the recurrence
over a token tree, each node from its parent's state (the host linearizes
every node's conv window into `conv_src`), and `ssm_tree_commit` replays
the accepted root-to-node path. The replays take the same per-token step
as the plain decode path (`_ssd_update`, `_delta_rule`). Every result is a
new tensor: the state handed in is never written.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..config.model import DeltaNetConfig, GELU, Mamba2Config, ShortConvConfig, SiLU
from ..ops.linear import linear_apply
from ..params.safetensors_io import to_torch

SSM_PREFILL_CHUNK = 64
# below this many rows the per-token loop wins (no padding, no [L, L] work)
SSM_CHUNKED_MIN_S = 32


def _act(cfg, x: torch.Tensor) -> torch.Tensor:
    """The conv activation as the JAX package applies it (SiLU ignores
    alpha there)."""
    if isinstance(cfg, SiLU):
        return F.silu(x)
    if isinstance(cfg, GELU):
        return F.gelu(x, approximate="tanh" if cfg.approximate else "none")
    return x


def _softplus(x: torch.Tensor) -> torch.Tensor:
    return torch.where(x > 20.0, x, torch.log1p(torch.exp(x)))


def _valid_mask(b: int, s: int, true_length, device) -> torch.Tensor:
    """[B, S, 1] bool: rows below each sequence's true length. true_length
    is an int or a tensor of B lengths (0-d when B = 1)."""
    rows = torch.arange(s, device=device)[None, :]
    if isinstance(true_length, torch.Tensor):
        return (rows < true_length.reshape(-1, 1).to(device))[..., None].expand(b, s, 1)
    return (rows < true_length)[..., None].expand(b, s, 1)


def _causal_depthwise_conv(padded: torch.Tensor, w: torch.Tensor, bias,
                           s: int) -> torch.Tensor:
    """padded [B, k-1+S, C] -> out [B, S, C]; w [C, k]; per-channel causal FIR."""
    k = w.shape[1]
    out = torch.zeros((padded.shape[0], s, padded.shape[2]), dtype=torch.float32,
                      device=padded.device)
    for tap in range(k):
        out = out + padded[:, tap:tap + s].float() * w[:, tap].float()
    if bias is not None:
        out = out + bias.float()
    return out


def _next_conv_state(padded: torch.Tensor, true_length, taps: int) -> torch.Tensor:
    """The last `taps` real rows of the packed [state; masked inputs]
    buffer of each sequence: rows [true_length, true_length + taps)."""
    if not isinstance(true_length, torch.Tensor):
        return padded[:, true_length:true_length + taps]
    idx = true_length.reshape(-1, 1).long() + torch.arange(taps, device=padded.device)
    idx = idx.expand(padded.shape[0], taps)
    return torch.gather(padded, 1, idx[..., None].expand(-1, -1, padded.shape[2]))


# --------------------------------------------------------------------------
# ShortConv (LFM2)
# --------------------------------------------------------------------------


def _short_conv_forward(cfg: ShortConvConfig, params, x, state, true_length, defer=False):
    b, s, _ = x.shape
    k = cfg.kernel_size
    proj = linear_apply(params["in"]["w"], x).float()  # [B, S, 3D]
    d = proj.shape[-1] // 3  # D, or D / tp on a tensor-parallel rank
    pre, post, xin = proj[..., :d], proj[..., d:2 * d], proj[..., 2 * d:]
    xg = torch.where(_valid_mask(b, s, true_length, x.device), xin * pre, 0.0)

    padded = torch.cat([state["conv"].float(), xg], dim=1)  # [B, k-1+S, D]
    conv = _causal_depthwise_conv(padded, params["conv_w"], params.get("conv_b"), s)
    y = (conv * post).to(x.dtype)
    if defer:
        new_state = {"padded": padded, "conv0": state["conv"]}
    else:
        new_state = {"conv": _next_conv_state(padded, true_length, k - 1).to(state["conv"].dtype)}
    return linear_apply(params["out"]["w"], y), new_state


# --------------------------------------------------------------------------
# Chunk-parallel recurrence cores (prefill)
#
# Masked rows compose exactly like the per-token path: beta=0 and
# log_decay=0 (GDN) / x=0 and log_decay=0 (SSD) are identity transitions.
# --------------------------------------------------------------------------


def _pad_chunks(arrs, s: int, chunk: int):
    """Pad [B, S, ...] tensors to a chunk multiple and reshape to
    [B, n_chunks, H, L, ...] (heads-major for batched per-head matrices)."""
    pad = (-s) % chunk
    out = []
    for a in arrs:
        if pad:
            a = torch.cat([a, a.new_zeros((a.shape[0], pad, *a.shape[2:]))], dim=1)
        a = a.reshape(a.shape[0], -1, chunk, *a.shape[2:])  # [B, nc, L, H, ...]
        out.append(a.transpose(2, 3))  # [B, nc, H, L, ...]
    return out


def _unchunk(o_c: torch.Tensor, s: int) -> torch.Tensor:
    """[B, nc, H, L, d] -> [B, S, H, d]."""
    b, nc, h, ln, dd = o_c.shape
    return o_c.transpose(2, 3).reshape(b, nc * ln, h, dd)[:, :s]


def _tri_solve(a_strict_lower: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """x = (I + strict_lower(a))^{-1} rhs, batched over leading dims."""
    return torch.linalg.solve_triangular(a_strict_lower, rhs, upper=False, unitriangular=True)


def _delta_net_chunked(qs, ks, vs, beta, log_decay, ssm0, chunk: int):
    """Gated delta rule, chunk-parallel (WY representation).

    qs/ks [B, S, H, dk] (q pre-scaled, q/k L2-normalized), vs [B, S, H, dv],
    beta/log_decay [B, S, H]; padded or masked rows carry beta=0 and
    log_decay=0. Returns (ssm [B, H, dv, dk], o [B, S, H, dv]).

    With S_i = a_i S_{i-1} (I - b_i k_i k_i^T) + b_i v_i k_i^T and gamma_i =
    prod_{j<=i} a_j, S_i = gamma_i S_0 P_i + Z_i with P_i = I - sum_{j<=i}
    w_j k_j^T and Z_i = sum_{j<=i} (gamma_i/gamma_j) u_j k_j^T, where the w
    and u rows solve unit-lower-triangular systems
        W = (I + B tril(K K^T, -1))^{-1} B K
        U = (I + B tril(K K^T (x) Gamma, -1))^{-1} B V
    (Gamma[i,j] = gamma_i/gamma_j <= 1), and
    o_i = gamma_i S_0 (q_i - sum_{j<=i} (k_j.q_i) w_j)
          + sum_{j<=i} (gamma_i/gamma_j) (k_j.q_i) u_j.
    """
    s = qs.shape[1]
    q_c, k_c, v_c, b_c, lg_c = _pad_chunks([qs, ks, vs, beta, log_decay], s, chunk)
    dev = qs.device
    low = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=dev))
    strict = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=dev), -1)

    state = ssm0
    outs = []
    for c in range(q_c.shape[1]):
        q, k, v, b, lg = q_c[:, c], k_c[:, c], v_c[:, c], b_c[:, c], lg_c[:, c]
        lgc = torch.cumsum(lg, dim=-1)  # [B, H, L]
        gam = torch.exp(lgc)
        # mask the exponent BEFORE exp: above the diagonal lgc_i - lgc_j > 0
        # and overflows to inf for long chunks, and 0 * inf = NaN survives a
        # multiplicative mask; on and below the diagonal the ratio is <= 1
        diff = lgc[..., :, None] - lgc[..., None, :]
        ratio = torch.exp(torch.where(low, diff, 0.0))
        gram = torch.einsum("bhik,bhjk->bhij", k, k)
        a0 = torch.where(strict, b[..., :, None] * gram, 0.0)
        at = torch.where(strict, a0 * ratio, 0.0)
        w = _tri_solve(a0, b[..., None] * k)  # [B, H, L, dk]
        u = _tri_solve(at, b[..., None] * v)  # [B, H, L, dv]

        qk = torch.where(low, torch.einsum("bhik,bhjk->bhij", q, k), 0.0)
        q_eff = q - torch.einsum("bhij,bhjk->bhik", qk, w)
        o = gam[..., None] * torch.einsum("bhlk,bhvk->bhlv", q_eff, state)
        o = o + torch.einsum("bhij,bhjv->bhiv", qk * ratio * low, u)

        r_last = torch.exp(lgc[..., -1:] - lgc)  # gamma_L / gamma_j
        wk = torch.einsum("bhld,bhle->bhde", w, k)  # sum_j w_j k_j^T [B, H, dk, dk]
        state = torch.exp(lgc[..., -1])[..., None, None] * (
            state - torch.einsum("bhvk,bhkd->bhvd", state, wk)
        ) + torch.einsum("bhlv,bhld->bhvd", u * r_last[..., None], k)
        outs.append(o)
    return state, _unchunk(torch.stack(outs, dim=1), s)


def _mamba2_chunked(xs, bs, cs, log_decay, ssm0, chunk: int):
    """SSD recurrence S_t = a_t S + x_t (x) b_t, y_t = S_t c_t in
    chunk-parallel form: intra-chunk decay-ratio masked attention
    P[i,j] = (c_i.b_j) gamma_i/gamma_j (j <= i) plus the inter-chunk S_0
    readout. xs [B, S, H, dh], bs/cs [B, S, H, n], log_decay [B, S, H]
    (0 = masked). Returns (ssm [B, H, dh, n], y [B, S, H, dh])."""
    s = xs.shape[1]
    x_c, b_c, c_c, lg_c = _pad_chunks([xs, bs, cs, log_decay], s, chunk)
    low = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=xs.device))

    state = ssm0
    outs = []
    for ci in range(x_c.shape[1]):
        x, bmat, c, lg = x_c[:, ci], b_c[:, ci], c_c[:, ci], lg_c[:, ci]
        lgc = torch.cumsum(lg, dim=-1)
        gam = torch.exp(lgc)
        # exponent masked before exp, as in _delta_net_chunked
        diff = lgc[..., :, None] - lgc[..., None, :]
        ratio = torch.exp(torch.where(low, diff, 0.0))
        p = torch.where(low, torch.einsum("bhin,bhjn->bhij", c, bmat) * ratio, 0.0)
        y = gam[..., None] * torch.einsum("bhin,bhdn->bhid", c, state)
        y = y + torch.einsum("bhij,bhjd->bhid", p, x)
        r_last = torch.exp(lgc[..., -1:] - lgc)
        state = torch.exp(lgc[..., -1])[..., None, None] * state + torch.einsum(
            "bhld,bhln->bhdn", x * r_last[..., None], bmat)
        outs.append(y)
    return state, _unchunk(torch.stack(outs, dim=1), s)


# --------------------------------------------------------------------------
# Mamba2
# --------------------------------------------------------------------------


def _ssd_update(ssm, x_t, b_t, decay_t):
    """One token of the SSD recurrence: S <- S * decay + x (x) b, with
    ssm [B, H, dh, n], x_t [B, H, dh], b_t [B, H, n], decay_t [B, H]."""
    return ssm * decay_t[..., None, None] + x_t[..., :, None] * b_t[..., None, :]


def _mamba2_inputs(cfg: Mamba2Config, params, x, state, valid, conv):
    """x [B, S, D] -> (padded, z, xs [B, S, H, dh], bs, cs [B, S, H, n],
    log_decay [B, S, H]): the input projection, the conv (`conv(padded)`
    gives the pre-activation conv rows [B, S, conv_dim]) and the
    recurrence inputs. Rows where `valid` [B, S, 1] is False are identity
    transitions (no mask where it is None)."""
    b, s, _ = x.shape
    h, g, dh, n = cfg.num_heads, cfg.num_groups, cfg.head_dim, cfg.state_dim
    inner = h * dh
    conv_dim = inner + 2 * g * n

    proj = linear_apply(params["in"]["w"], x, params["in"].get("b")).float()
    conv_in = proj[..., :conv_dim]
    z = proj[..., conv_dim:conv_dim + inner] + params["gate_bias"].float()
    dt_raw = proj[..., conv_dim + inner:]  # [B, S, H]
    if valid is not None:
        conv_in = torch.where(valid, conv_in, 0.0)
    padded = torch.cat([state["conv"], conv_in], dim=1)  # f32 [B, k-1+S, conv_dim]
    c = _act(cfg.activation, conv(padded))

    xs = c[..., :inner].reshape(b, s, h, dh)
    bs = c[..., inner:inner + g * n].reshape(b, s, g, n)
    cs = c[..., inner + g * n:].reshape(b, s, g, n)
    log_decay = -_softplus(dt_raw)
    if valid is not None:
        log_decay = torch.where(valid, log_decay, 0.0)
        xs = torch.where(valid[..., None], xs, 0.0)
    rep = h // g
    return (padded, z, xs, torch.repeat_interleave(bs, rep, dim=2),
            torch.repeat_interleave(cs, rep, dim=2), log_decay)


def _mamba2_output(cfg: Mamba2Config, params, x, ys, xs, z):
    """ys [B, S, H, dh] -> out [B, S, D]: the skip connection, the SiLU(z)
    gate and the out projection."""
    b, s = ys.shape[:2]
    ys = ys + params["skip_weight"].float()[None, None, :, None] * xs
    ys = ys.reshape(b, s, cfg.num_heads * cfg.head_dim) * F.silu(z)
    return linear_apply(params["out"]["w"], ys.to(x.dtype), params["out"].get("b"))


def _mamba2_forward(cfg: Mamba2Config, params, x, state, true_length, defer=False):
    b, s, _ = x.shape
    valid = _valid_mask(b, s, true_length, x.device)
    padded, z, xs, bs_h, cs_h, log_decay = _mamba2_inputs(
        cfg, params, x, state, valid,
        lambda p: _causal_depthwise_conv(p, params["conv_w"], params.get("conv_b"), s))

    if s >= SSM_CHUNKED_MIN_S:
        ssm, ys = _mamba2_chunked(xs, bs_h, cs_h, log_decay, state["ssm"], SSM_PREFILL_CHUNK)
    else:
        decay = torch.exp(log_decay)
        ssm = state["ssm"]
        ys = []
        for t in range(s):
            ssm = _ssd_update(ssm, xs[:, t], bs_h[:, t], decay[:, t])
            ys.append(torch.einsum("bhdn,bhn->bhd", ssm, cs_h[:, t]))
        ys = torch.stack(ys, dim=1)
    out = _mamba2_output(cfg, params, x, ys, xs, z)
    if defer:
        return out, {"padded": padded, "xs": xs, "bs": bs_h, "log_decay": log_decay,
                     "ssm0": state["ssm"]}
    return out, {"conv": _next_conv_state(padded, true_length, cfg.kernel_size - 1),
                 "ssm": ssm}


# --------------------------------------------------------------------------
# Gated DeltaNet (Qwen3.5 hybrid layers)
# --------------------------------------------------------------------------


def _l2norm(v: torch.Tensor) -> torch.Tensor:
    return v * torch.rsqrt(torch.sum(v * v, dim=-1, keepdim=True) + 1e-6)


def _delta_rule(ssm, k_t, v_t, beta_t, decay_t):
    """One token of the gated delta rule: ssm [B, H, dv, dk], k_t [B, H,
    dk], v_t [B, H, dv], beta_t / decay_t [B, H] -> (new state, delta
    [B, H, dv])."""
    sk = torch.einsum("bhvk,bhk->bhv", ssm, k_t)  # S k
    delta = beta_t[..., None] * (v_t - decay_t[..., None] * sk)
    return decay_t[..., None, None] * ssm + delta[..., :, None] * k_t[..., None, :], delta


def _delta_net_token(ssm, q_t, k_t, v_t, beta_t, decay_t):
    """One token's output o = decay S q + delta (k . q) and new state."""
    sq = torch.einsum("bhvk,bhk->bhv", ssm, q_t)  # S q
    new, delta = _delta_rule(ssm, k_t, v_t, beta_t, decay_t)
    kq = torch.sum(k_t * q_t, dim=-1)  # [B, H]
    return new, decay_t[..., None] * sq + delta * kq[..., None]


def _delta_net_inputs(cfg: DeltaNetConfig, params, x, state, valid, conv):
    """x [B, S, D] -> (padded, z [B, S, H, dv], qs, ks [B, S, H, dk], vs
    [B, S, H, dv], beta, log_decay [B, S, H]): the input projection, the
    conv (`conv(padded)`, pre-activation) and the delta rule's inputs. Rows
    where `valid` is False are identity transitions (no mask where None)."""
    b, s, _ = x.shape
    h, g = cfg.num_heads, cfg.num_groups
    dk, dv = cfg.head_dim, cfg.value_head_dim
    key_dim, value_dim = g * dk, h * dv
    conv_dim = 2 * key_dim + value_dim

    proj = linear_apply(params["in"]["w"], x).float()
    conv_in = proj[..., :conv_dim]
    z = proj[..., conv_dim:conv_dim + value_dim].reshape(b, s, h, dv)
    beta_raw = proj[..., conv_dim + value_dim:conv_dim + value_dim + h]
    a_raw = proj[..., conv_dim + value_dim + h:]
    if valid is not None:
        conv_in = torch.where(valid, conv_in, 0.0)
    padded = torch.cat([state["conv"], conv_in], dim=1)
    c = F.silu(conv(padded))

    rep = h // g
    qs = c[..., :key_dim].reshape(b, s, g, dk)
    ks = c[..., key_dim:2 * key_dim].reshape(b, s, g, dk)
    vs = c[..., 2 * key_dim:].reshape(b, s, h, dv)
    qs = torch.repeat_interleave(_l2norm(qs) * (float(dk) ** -0.5), rep, dim=2)  # [B, S, H, dk]
    ks = torch.repeat_interleave(_l2norm(ks), rep, dim=2)

    beta = torch.sigmoid(beta_raw)  # [B, S, H]
    log_decay = -torch.exp(params["a_log"].float()) * _softplus(a_raw + params["dt_bias"].float())
    if valid is not None:
        log_decay = torch.where(valid, log_decay, 0.0)
        beta = torch.where(valid, beta, 0.0)
    return padded, z, qs, ks, vs, beta, log_decay


def _delta_net_output(cfg: DeltaNetConfig, params, x, os_, z):
    """os_ [B, S, H, dv] -> out [B, S, D]: the per-head RMSNorm, the
    SiLU(z) gate and the out projection."""
    b, s = os_.shape[:2]
    inv_rms = torch.rsqrt(torch.mean(os_ * os_, dim=-1, keepdim=True) + cfg.norm_config.epsilon)
    gated = os_ * inv_rms * params["norm_scales"].float() * F.silu(z)
    value_dim = cfg.num_heads * cfg.value_head_dim
    return linear_apply(params["out"]["w"], gated.reshape(b, s, value_dim).to(x.dtype))


def _delta_net_forward(cfg: DeltaNetConfig, params, x, state, true_length, defer=False):
    b, s, _ = x.shape
    valid = _valid_mask(b, s, true_length, x.device)
    padded, z, qs, ks, vs, beta, log_decay = _delta_net_inputs(
        cfg, params, x, state, valid,
        lambda p: _causal_depthwise_conv(p, params["conv_w"], params.get("conv_b"), s))

    if s >= SSM_CHUNKED_MIN_S:
        ssm, os_ = _delta_net_chunked(qs, ks, vs, beta, log_decay, state["ssm"],
                                      SSM_PREFILL_CHUNK)
    else:
        decay = torch.exp(log_decay)
        ssm = state["ssm"]  # [B, H, dv, dk]
        os_ = []
        for t in range(s):
            ssm, o_t = _delta_net_token(ssm, qs[:, t], ks[:, t], vs[:, t], beta[:, t],
                                        decay[:, t])
            os_.append(o_t)
        os_ = torch.stack(os_, dim=1)

    out = _delta_net_output(cfg, params, x, os_, z)
    if defer:
        return out, {"padded": padded, "ks": ks, "vs": vs, "beta": beta,
                     "log_decay": log_decay, "ssm0": state["ssm"]}
    return out, {"conv": _next_conv_state(padded, true_length, cfg.kernel_size - 1),
                 "ssm": ssm}


# --------------------------------------------------------------------------
# Dispatch: plain, deferred and tree forwards, commits
# --------------------------------------------------------------------------


def ssm_forward_batched(mixer_cfg, params, x: torch.Tensor, state: dict, true_length,
                        defer: bool = False):
    """x [B, S, D], state leaves with a leading [B], true_length an int or
    a tensor of B lengths -> (out [B, S, D], new state, or with `defer`
    the replay inputs of `ssm_commit`, each with a leading [B])."""
    if isinstance(mixer_cfg, ShortConvConfig):
        return _short_conv_forward(mixer_cfg, params, x, state, true_length, defer)
    if isinstance(mixer_cfg, Mamba2Config):
        return _mamba2_forward(mixer_cfg, params, x, state, true_length, defer)
    if isinstance(mixer_cfg, DeltaNetConfig):
        return _delta_net_forward(mixer_cfg, params, x, state, true_length, defer)
    raise ValueError(f"unsupported mixer {type(mixer_cfg).__name__}")


def ssm_forward(mixer_cfg, params, x: torch.Tensor, positions, state: dict,
                true_length=None, defer: bool = False):
    """One sequence: x [S, D], unbatched state; true_length an int or a
    0-d device tensor (default S). Returns (out [S, D], new state).

    defer=True (speculative verify): every row is real (true_length is S)
    and no state is committed; the second result holds the recurrence
    inputs from which `ssm_commit` replays the state of any prefix."""
    if true_length is None or defer:
        true_length = x.shape[0]
    out, new = ssm_forward_batched(mixer_cfg, params, x[None],
                                   {name: v[None] for name, v in state.items()},
                                   true_length, defer)
    return out[0], {name: v[0] for name, v in new.items()}


def _tree_conv(padded: torch.Tensor, conv_src: torch.Tensor, w: torch.Tensor,
               bias) -> torch.Tensor:
    """Gathered causal depthwise conv: out[j] = sum_t w[:, t] *
    padded[conv_src[j, t]]; padded [k-1+M, C] f32, conv_src [M, K]. The
    taps add up in `_causal_depthwise_conv`'s order."""
    win = padded[conv_src.long()]  # [M, K, C]
    out = torch.zeros((win.shape[0], win.shape[2]), dtype=torch.float32, device=padded.device)
    for tap in range(w.shape[1]):
        out = out + win[:, tap] * w[:, tap].float()
    if bias is not None:
        out = out + bias.float()
    return out


def _short_conv_tree(cfg: ShortConvConfig, params, x, state, conv_src):
    proj = linear_apply(params["in"]["w"], x).float()
    d = proj.shape[1] // 3
    pre, post, xin = proj[:, :d], proj[:, d:2 * d], proj[:, 2 * d:]
    padded = torch.cat([state["conv"].float(), xin * pre])
    conv = _tree_conv(padded, conv_src, params["conv_w"], params.get("conv_b"))
    y = (conv * post).to(x.dtype)
    return linear_apply(params["out"]["w"], y), {"padded": padded, "conv0": state["conv"]}


def _mamba2_tree(cfg: Mamba2Config, params, x, state, parents, conv_src):
    padded, z, xs, bs_h, cs_h, log_decay = _mamba2_inputs(
        cfg, params, x[None], {"conv": state["conv"][None]}, None,
        lambda p: _tree_conv(p[0], conv_src, params["conv_w"], params.get("conv_b"))[None])
    decay = torch.exp(log_decay)
    states = [state["ssm"][None]]  # node j's state at j + 1; the incoming one at 0
    ys = []
    for j, parent in enumerate(parents):
        states.append(_ssd_update(states[parent + 1], xs[:, j], bs_h[:, j], decay[:, j]))
        ys.append(torch.einsum("bhdn,bhn->bhd", states[-1], cs_h[:, j]))
    out = _mamba2_output(cfg, params, x[None], torch.stack(ys, dim=1), xs, z)
    return out[0], {"padded": padded[0], "xs": xs[0], "bs": bs_h[0],
                    "log_decay": log_decay[0], "ssm0": state["ssm"]}


def _delta_net_tree(cfg: DeltaNetConfig, params, x, state, parents, conv_src):
    padded, z, qs, ks, vs, beta, log_decay = _delta_net_inputs(
        cfg, params, x[None], {"conv": state["conv"][None]}, None,
        lambda p: _tree_conv(p[0], conv_src, params["conv_w"], params.get("conv_b"))[None])
    decay = torch.exp(log_decay)
    states = [state["ssm"][None]]
    os_ = []
    for j, parent in enumerate(parents):
        new, o = _delta_net_token(states[parent + 1], qs[:, j], ks[:, j], vs[:, j],
                                  beta[:, j], decay[:, j])
        states.append(new)
        os_.append(o)
    out = _delta_net_output(cfg, params, x[None], torch.stack(os_, dim=1), z)
    return out[0], {"padded": padded[0], "ks": ks[0], "vs": vs[0], "beta": beta[0],
                    "log_decay": log_decay[0], "ssm0": state["ssm"]}


def ssm_tree_forward(mixer_cfg, params, x: torch.Tensor, state: dict, parents,
                     conv_src: torch.Tensor):
    """Recurrent-mixer forward over a token tree: x [M, D] holds one row
    per node; `parents` (M host ints, parents[j] < j, -1 for a root whose
    predecessor state is `state`) and conv_src [M, K] (each node's causal
    conv window as indices into concat([state conv rows (k-1), node
    inputs]), linearized on the host). The recurrence runs node by node,
    each from its PARENT's state. Returns (out [M, D], aux for
    `ssm_tree_commit`); no state is committed."""
    parents = [int(p) for p in parents]
    if isinstance(mixer_cfg, ShortConvConfig):
        return _short_conv_tree(mixer_cfg, params, x, state, conv_src)
    if isinstance(mixer_cfg, Mamba2Config):
        return _mamba2_tree(mixer_cfg, params, x, state, parents, conv_src)
    if isinstance(mixer_cfg, DeltaNetConfig):
        return _delta_net_tree(mixer_cfg, params, x, state, parents, conv_src)
    raise ValueError(f"unsupported mixer {type(mixer_cfg).__name__}")


def _replay(mixer_cfg, aux: dict, rows, decay) -> torch.Tensor:
    """The recurrent states [B, ...] after the per-token steps of `rows`
    (indices along S, in order) from aux["ssm0"] [B, ...], over aux leaves
    [B, S, ...] with per-row decay [B, S, H]."""
    ssm = aux["ssm0"]
    if isinstance(mixer_cfg, Mamba2Config):
        for t in rows:
            ssm = _ssd_update(ssm, aux["xs"][:, t], aux["bs"][:, t], decay[:, t])
    elif isinstance(mixer_cfg, DeltaNetConfig):
        for t in rows:
            ssm, _ = _delta_rule(ssm, aux["ks"][:, t], aux["vs"][:, t], aux["beta"][:, t],
                                 decay[:, t])
    else:
        raise ValueError(f"unsupported mixer {type(mixer_cfg).__name__}")
    return ssm


def ssm_tree_commit(mixer_cfg, aux: dict, path_idx, conv_commit_src: torch.Tensor) -> dict:
    """Commit a tree verify to an accepted root-to-node path: path_idx
    (host ints) lists the accepted nodes in order, -1 entries are padding;
    conv_commit_src [k-1] indexes the committed conv window's rows into
    aux["padded"]. The state replays the plain decode step over the path
    (a padded entry is an identity transition in the JAX package; here it
    is skipped, which is the same state)."""
    conv = aux["padded"][conv_commit_src.long()]
    if isinstance(mixer_cfg, ShortConvConfig):
        return {"conv": conv.to(aux["conv0"].dtype)}
    rows = [int(j) for j in path_idx if int(j) >= 0]
    one = {name: v[None] for name, v in aux.items()}
    return {"conv": conv, "ssm": _replay(mixer_cfg, one, rows, torch.exp(one["log_decay"]))[0]}


def ssm_commit_batched(mixer_cfg, aux: dict, commit) -> dict:
    """Commit a deferred `ssm_forward_batched` (aux leaves with a leading
    [B]) to `commit` [B] tokens per sequence (a device tensor decided after
    the forward): rows at and past a sequence's commit replay as identity
    transitions, the masking the partial-chunk prefill uses, so each state
    is the plain forward's over its accepted prefix; a commit of 0 keeps
    the state handed to the forward. No host sync."""
    if not isinstance(mixer_cfg, (ShortConvConfig, Mamba2Config, DeltaNetConfig)):
        raise ValueError(f"unsupported mixer {type(mixer_cfg).__name__}")
    k = mixer_cfg.kernel_size
    conv = _next_conv_state(aux["padded"], commit, k - 1)
    if isinstance(mixer_cfg, ShortConvConfig):
        return {"conv": conv.to(aux["conv0"].dtype)}
    b, s = aux["log_decay"].shape[:2]
    live = _valid_mask(b, s, commit, conv.device)  # [B, S, 1]
    decay = torch.exp(torch.where(live, aux["log_decay"], 0.0))
    aux = dict(aux)
    if isinstance(mixer_cfg, Mamba2Config):
        aux["xs"] = torch.where(live[..., None], aux["xs"], 0.0)
    else:
        aux["beta"] = torch.where(live, aux["beta"], 0.0)
    return {"conv": conv, "ssm": _replay(mixer_cfg, aux, range(s), decay)}


def ssm_commit(mixer_cfg, aux: dict, commit_length) -> dict:
    """Commit a deferred `ssm_forward` (one sequence) to `commit_length`
    tokens (an int or a 0-d device tensor): `ssm_commit_batched` at B = 1."""
    if not isinstance(commit_length, torch.Tensor):
        commit_length = torch.tensor(commit_length, device=aux["padded"].device)
    out = ssm_commit_batched(mixer_cfg, {name: v[None] for name, v in aux.items()},
                             commit_length.reshape(1))
    return {name: v[0] for name, v in out.items()}


def make_ssm_state(mixer_cfg, model_dim: int, dtype=torch.bfloat16, device=None) -> dict:
    k = mixer_cfg.kernel_size
    if isinstance(mixer_cfg, ShortConvConfig):
        return {"conv": torch.zeros((k - 1, model_dim), dtype=dtype, device=device)}
    if isinstance(mixer_cfg, Mamba2Config):
        inner = mixer_cfg.num_heads * mixer_cfg.head_dim
        conv_dim = inner + 2 * mixer_cfg.num_groups * mixer_cfg.state_dim
        return {
            "conv": torch.zeros((k - 1, conv_dim), dtype=torch.float32, device=device),
            "ssm": torch.zeros((mixer_cfg.num_heads, mixer_cfg.head_dim, mixer_cfg.state_dim),
                               dtype=torch.float32, device=device),
        }
    if isinstance(mixer_cfg, DeltaNetConfig):
        key_dim = mixer_cfg.num_groups * mixer_cfg.head_dim
        value_dim = mixer_cfg.num_heads * mixer_cfg.value_head_dim
        return {
            "conv": torch.zeros((k - 1, 2 * key_dim + value_dim), dtype=torch.float32,
                                device=device),
            "ssm": torch.zeros((mixer_cfg.num_heads, mixer_cfg.value_head_dim,
                                mixer_cfg.head_dim), dtype=torch.float32, device=device),
        }
    raise ValueError(f"unsupported mixer {type(mixer_cfg).__name__}")


def load_ssm_mixer(tree, mixer_cfg, model_dim: int, device=None) -> dict:
    """Tensor names and shapes of the JAX package's `load_ssm_mixer`."""
    from .loader import load_linear

    def f32(name, shape):
        return to_torch(tree.leaf(name, shape, np.float32), device)

    if isinstance(mixer_cfg, ShortConvConfig):
        k = mixer_cfg.kernel_size
        out = {
            "in": load_linear(tree.subtree("in_projection"), model_dim, 3 * model_dim, False,
                              device),
            "out": load_linear(tree.subtree("out_projection"), model_dim, model_dim, False,
                               device),
            "conv_w": f32("conv.weights", (model_dim, k)),
        }
        if mixer_cfg.conv_config.has_biases:
            out["conv_b"] = f32("conv.biases", (model_dim,))
        return out

    if isinstance(mixer_cfg, Mamba2Config):
        h, g, dh, n, k = (mixer_cfg.num_heads, mixer_cfg.num_groups, mixer_cfg.head_dim,
                          mixer_cfg.state_dim, mixer_cfg.kernel_size)
        inner = h * dh
        conv_dim = inner + 2 * g * n
        out = {
            "in": load_linear(tree.subtree("in_projection"), model_dim, conv_dim + inner + h,
                              mixer_cfg.has_in_biases, device),
            "out": load_linear(tree.subtree("out_projection"), inner, model_dim,
                               mixer_cfg.has_out_biases, device),
            "gate_bias": f32("gate_bias", (inner,)),
            "conv_w": f32("conv.weights", (conv_dim, k)),
            "skip_weight": f32("skip_connection_weight", (h,)),
        }
        if mixer_cfg.conv_config.has_biases:
            out["conv_b"] = f32("conv.biases", (conv_dim,))
        return out

    if isinstance(mixer_cfg, DeltaNetConfig):
        h, g = mixer_cfg.num_heads, mixer_cfg.num_groups
        dk, dv, k = mixer_cfg.head_dim, mixer_cfg.value_head_dim, mixer_cfg.kernel_size
        key_dim, value_dim = g * dk, h * dv
        conv_dim = 2 * key_dim + value_dim
        out = {
            "in": load_linear(tree.subtree("in_proj"), model_dim, conv_dim + value_dim + 2 * h,
                              False, device),
            "out": load_linear(tree.subtree("out_proj"), value_dim, model_dim, False, device),
            "conv_w": f32("conv.weights", (conv_dim, k)),
            "a_log": f32("a_log", (h,)),
            "dt_bias": f32("dt_bias", (h,)),
            "norm_scales": f32("norm.scales", (dv,)),
        }
        if mixer_cfg.conv_config.has_biases:
            out["conv_b"] = f32("conv.biases", (conv_dim,))
        return out

    raise ValueError(f"unsupported mixer {type(mixer_cfg).__name__}")
