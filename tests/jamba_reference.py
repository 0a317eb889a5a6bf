"""A plain float32 Jamba forward, as published (AI21's `jamba` model code),
for the port's tests: no kernel, cache or batching, and nothing of the
port or of JAX (torch alone).

Layer i runs attention where `i % attn_period == attn_offset`, a Mamba-1
mixer elsewhere; each layer is RMSNorm, mixer, residual, RMSNorm, SwiGLU
MLP, residual; the final RMSNorm and the tied readout. Attention has no
positional encoding (NoPE): causal softmax at scale head_dim^-1/2, query
head h reading KV head h // (heads / kv_heads). Mamba-1, per token t:

    [x | z] = in_proj(h);  x = silu(causal depthwise conv(x) + conv_bias)
    [dt | B | C] = x_proj(x);  dt, B, C = RMSNorm(dt), RMSNorm(B), RMSNorm(C)
    delta = softplus(dt_proj(dt) + dt_bias);  A = -exp(A_log)  [Di, N]
    h_t = exp(delta_t A) * h_{t-1} + delta_t B_t x_t;  y_t = h_t C_t + D x_t
    out = out_proj(y * silu(z))

Weights come as a flat dict of f32 tensors under the model file's names
(`transformer.layers.{i}.mixer.in_projection.weights.weights`, ...), with
full-precision [out, in] linears and the [V, D] embedding.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _rms(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps) * w


def _lin(w: dict, name: str, x: torch.Tensor) -> torch.Tensor:
    return x @ w[name + ".weights.weights"].t()


def mamba1(w: dict, p: str, h: torch.Tensor, dims: dict) -> torch.Tensor:
    """One Mamba-1 mixer over a whole sequence h [S, D] from a zero state,
    token by token."""
    s = h.shape[0]
    di, n, r, eps = dims["inner_dim"], dims["state_dim"], dims["dt_rank"], dims["eps"]
    proj = _lin(w, p + "in_projection", h)
    x, z = proj[:, :di], proj[:, di:]
    taps = w[p + "conv.weights"]  # [Di, k], the last tap on the current row
    k = taps.shape[1]
    xp = torch.cat([torch.zeros(k - 1, di), x])
    x = F.silu(sum(xp[j:j + s] * taps[:, j] for j in range(k)) + w[p + "conv.biases"])
    xbc = _lin(w, p + "x_projection", x)
    dt = _rms(xbc[:, :r], w[p + "dt_norm.scales"], eps)
    bm = _rms(xbc[:, r:r + n], w[p + "b_norm.scales"], eps)
    cm = _rms(xbc[:, r + n:], w[p + "c_norm.scales"], eps)
    delta = F.softplus(_lin(w, p + "dt_projection", dt) + w[p + "dt_bias"])  # [S, Di]
    a = -torch.exp(w[p + "a_log"])  # [Di, N]
    state = torch.zeros(di, n)
    ys = []
    for t in range(s):
        state = torch.exp(delta[t][:, None] * a) * state + \
            delta[t][:, None] * bm[t][None, :] * x[t][:, None]
        ys.append(state @ cm[t])
    y = torch.stack(ys) + w[p + "skip_connection_weight"] * x
    return _lin(w, p + "out_projection", y * F.silu(z))


def attention(w: dict, p: str, h: torch.Tensor, dims: dict) -> torch.Tensor:
    s = h.shape[0]
    hh, g, dh = dims["heads"], dims["kv_heads"], dims["head_dim"]
    qkv = _lin(w, p + "qkv_projection", h)
    q = qkv[:, :hh * dh].reshape(s, hh, dh)
    k = qkv[:, hh * dh:(hh + g) * dh].reshape(s, g, dh).repeat_interleave(hh // g, dim=1)
    v = qkv[:, (hh + g) * dh:].reshape(s, g, dh).repeat_interleave(hh // g, dim=1)
    scores = torch.einsum("qhd,khd->hqk", q, k) * dh ** -0.5
    mask = torch.ones(s, s, dtype=torch.bool).triu(1)
    probs = torch.softmax(scores.masked_fill(mask, float("-inf")), dim=-1)
    out = torch.einsum("hqk,khd->qhd", probs, v).reshape(s, hh * dh)
    return _lin(w, p + "out_projection", out)


@torch.no_grad()
def logits(w: dict, tokens, dims: dict) -> torch.Tensor:
    """The reference's logits [S, V] (f32) at every position of `tokens`.
    dims: num_layers, attn_period, attn_offset, inner_dim, state_dim,
    dt_rank, heads, kv_heads, head_dim, eps."""
    eps = dims["eps"]
    emb = w["embedding.weights"]
    x = emb[torch.as_tensor(tokens, dtype=torch.long)]
    for i in range(dims["num_layers"]):
        p = f"transformer.layers.{i}."
        mixer = attention if i % dims["attn_period"] == dims["attn_offset"] else mamba1
        x = x + mixer(w, p + "mixer.", _rms(x, w[p + "pre_mixer_norm.scales"], eps), dims)
        fused = _lin(w, p + "mlp.up_projection", _rms(x, w[p + "pre_mlp_norm.scales"], eps))
        half = fused.shape[1] // 2
        x = x + _lin(w, p + "mlp.down_projection", fused[:, :half] * F.silu(fused[:, half:]))
    return _rms(x, w["transformer.output_norm.scales"], eps) @ emb.t()
