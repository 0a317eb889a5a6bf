"""Train a tiny real-statistics model in the repository, on the card.

Counterpart of `uzu_tpu/tools/train_tiny.py`. Quantization quality and
speculation acceptance cannot be judged on seeded-random weights, and no
checkpoint can be downloaded, so this trains an ~18M-parameter
Llama-family model on the structured byte-level corpus (`tools/corpus.py`)
through the inference forward (`models/decoder.decoder_forward`,
last_only=False), so the trained weights are what the engine serves, and
writes two servable model directories from the same weights:

    <out>_bf16   FullPrecision bf16 (the full-precision arm)
    <out>_int4   INT4 group-32 symmetric (the quantized arm)

Both load with `LanguageModel.from_dir` and run every engine and
speculation path. The gradient is PyTorch's autograd through the port's
forward; on the card its attention is K3 forward and K3b backward
(`ops/cuda/flash_attention.py::FlashAttention`), on the CPU the plain
versions. The optimizer is `torch.optim.AdamW` (weight decay 0.01) under
optax's `warmup_cosine_decay_schedule` as the JAX package uses it, whose
first update is taken at learning rate 0.

    python -m uzu_tpu_torch.tools.train_tiny .port_cache/tiny_real --steps 1500
    python -m uzu_tpu_torch.tools.train_tiny /tmp/tiny --steps 30 --device cpu
"""

from __future__ import annotations

import argparse
import json
import math
import shutil
import tempfile
import time

import numpy as np
import torch

# ~18M parameters, head dim 64: big enough for layer-to-layer predictive
# structure (self-draft acceptance), small enough to train in minutes
TINY_DIMS = dict(num_layers=8, model_dim=384, hidden_dim=1536, num_heads=6,
                 num_groups=2, head_dim=64, vocab_size=256, max_seq=1024)


def _build_init(dims: dict, seed: int, tmp: str, device=None):
    """The f32 model at `dims` from the synthesizer's seed, loaded on
    `device` (default: the card)."""
    from ..engine.engine import LanguageModel
    from .synth import llama_config, synthesize

    cfg = llama_config(**dims)
    d = synthesize(cfg, tmp, seed=seed, dtype=np.float32)
    return LanguageModel.from_dir(d, device=device, max_context=dims["max_seq"],
                                  prefill_buckets=(32, 256))


def _fresh(state0: dict) -> dict:
    """A copy of the zero state `state0`: `decoder_forward` writes its KV
    caches in place, and K3 keeps a row's caches for its backward, so no
    two rows may share them."""
    return {"layers": [None if ls is None else {k: v.clone() for k, v in ls.items()}
                       for ls in state0["layers"]],
            "pos": state0["pos"].clone()}


def _loss_fn(cfg, params, state0, batch) -> torch.Tensor:
    """Mean over the rows of `batch` [B, S+1] of each row's mean next-token
    NLL, each row through `decoder_forward` from a fresh copy of the zero
    state `state0` (the JAX package maps one row over the batch)."""
    from ..models.decoder import decoder_forward

    batch = torch.as_tensor(batch)
    rows = []
    for tok in batch:
        tok = tok.long()
        logits, _ = decoder_forward(cfg, params, tok[:-1], _fresh(state0), last_only=False)
        logp = torch.log_softmax(logits.float(), dim=-1)
        picked = torch.gather(logp, 1, tok[1:, None])[:, 0]
        rows.append(-picked.mean())
    return torch.stack(rows).mean()


def warmup_cosine_decay(init_value: float, peak_value: float, warmup_steps: int,
                        decay_steps: int, end_value: float):
    """optax.warmup_cosine_decay_schedule: step count -> learning rate."""
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value

    def schedule(count: int) -> float:
        if count < warmup_steps:
            frac = 1.0 - min(max(count, 0), warmup_steps) / warmup_steps
            return (init_value - peak_value) * frac + peak_value
        t = min(count - warmup_steps, decay_steps - warmup_steps)
        cosine = 0.5 * (1.0 + math.cos(math.pi * t / (decay_steps - warmup_steps)))
        return peak_value * ((1.0 - alpha) * cosine + alpha)

    return schedule


def _leaves(params) -> list:
    """The parameter tensors of a tree, in a fixed order."""
    if isinstance(params, torch.Tensor):
        return [params]
    if isinstance(params, dict):
        return [t for k in params for t in _leaves(params[k])]
    if isinstance(params, list):
        return [t for v in params for t in _leaves(v)]
    raise TypeError(f"train_tiny trains full-precision tensors only, not {type(params).__name__}")


def train_data(dims: dict, *, steps: int, batch: int, seq: int, seed: int = 0,
               corpus_tokens: int = 30_000_000) -> np.ndarray:
    """The training windows [steps, B, S+1] int32: the JAX package's draws."""
    from .corpus import generate_tokens

    toks = generate_tokens(corpus_tokens, seed=1)
    rng = np.random.default_rng(seed + 7)
    starts = rng.integers(0, len(toks) - seq - 1, size=(steps, batch))
    return np.stack([
        np.stack([toks[s: s + seq + 1] for s in row]) for row in starts
    ]).astype(np.int32)


def train(dims: dict, *, steps: int, batch: int, seq: int, lr: float = 3e-3,
          seed: int = 0, corpus_tokens: int = 30_000_000, scan_k: int = 25,
          log=print, device=None, stats: dict | None = None):
    """Returns (lm, trained_params, losses); `log` gets a line every
    `scan_k` steps. `device` defaults to the card. `stats`, where given,
    receives the seconds of the step loop ("loop_seconds"), which ends in
    a read of the last losses."""
    # the corpus default keeps the run under one epoch (1500 steps x 16 x
    # 512 tokens of 30M): three epochs of a 4M corpus memorized it
    tmp = tempfile.mkdtemp(prefix="tiny_init_")
    try:
        lm = _build_init(dims, seed, tmp, device)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    cfg = lm.decoder_config
    state0 = lm.new_state()  # zero state; rows past pos=0 are causally masked
    data = train_data(dims, steps=steps, batch=batch, seq=seq, seed=seed,
                      corpus_tokens=corpus_tokens)

    params = lm.params
    leaves = _leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    sched = warmup_cosine_decay(0.0, lr, min(100, steps // 10 + 1), steps, lr * 0.05)
    opt = torch.optim.AdamW(leaves, lr=0.0, weight_decay=0.01)

    losses: list[float] = []
    pending = []
    t0 = time.time()
    for i in range(steps):
        for group in opt.param_groups:
            group["lr"] = sched(i)
        opt.zero_grad(set_to_none=True)
        loss = _loss_fn(cfg, params, state0,
                        torch.from_numpy(data[i]).to(lm.device))
        loss.backward()
        opt.step()
        pending.append(loss.detach())
        if len(pending) == scan_k or i == steps - 1:
            ls = torch.stack(pending).cpu().numpy()
            losses.extend(float(x) for x in ls)
            pending = []
            log(f"[train_tiny] step {i + 1}/{steps} loss {ls.mean():.4f} "
                f"({time.time() - t0:.0f}s)")
    if stats is not None:
        stats["loop_seconds"] = time.time() - t0
    for t in leaves:
        t.requires_grad_(False)
    lm.params = params
    return lm, params, losses


def write_trained(lm, params, out_dir: str, *, linear_spec=None,
                  dtype=None) -> str:
    """Serialize trained params to a servable model dir. Supports the
    llama family this trainer produces (attention + gated dense MLP, tied
    embedding, biasless). linear_spec=None writes FullPrecision at `dtype`
    (default bf16); an IntSpec quantizes the same trained weights."""
    from ..config.model import (
        AttentionConfig,
        DenseMLPConfig,
        FullPrecisionSpec,
        Layout,
        TiedEmbeddingConfig,
    )
    from ..params.safetensors_io import BF16
    from .synth import ModelBuilder

    dtype = dtype or BF16
    cfg = lm.decoder_config
    tcfg = cfg.transformer_config
    d = tcfg.model_dim
    assert isinstance(cfg.embedding_config, TiedEmbeddingConfig)
    fp = FullPrecisionSpec(layout=Layout.OUTPUT_INPUT)
    spec = linear_spec or fp

    def host(x):
        return x.detach().float().cpu().numpy()

    b = ModelBuilder(dtype=dtype)
    b.embedding("embedding", cfg.vocab_size, d, fp,
                weights=host(params["embedding"]["tied"]))
    for i, lc in enumerate(tcfg.layer_configs):
        p = f"transformer.layers.{i}"
        lp = params["layers"][i]
        m = lc.mixer_config
        assert isinstance(m, AttentionConfig) and not m.has_qkv_biases
        q_dim = m.num_heads * m.head_dim
        qkv_out = q_dim + 2 * m.num_groups * m.head_dim
        b.linear(f"{p}.mixer.qkv_projection", d, qkv_out, spec, False,
                 weights=host(lp["mixer"]["qkv"]["w"]))
        b.linear(f"{p}.mixer.out_projection", q_dim, d, spec, False,
                 weights=host(lp["mixer"]["out"]["w"]))
        b.tensors[f"{p}.pre_mixer_norm.scales"] = host(
            lp["pre_mixer_norm"]["scales"])
        b.tensors[f"{p}.pre_mlp_norm.scales"] = host(
            lp["pre_mlp_norm"]["scales"])
        ml = lc.mlp_config
        assert isinstance(ml, DenseMLPConfig)
        hid = lc.hidden_dim or tcfg.hidden_dim
        b.linear(f"{p}.mlp.up_projection", d, 2 * hid, spec, False,
                 weights=host(lp["mlp"]["up"]["w"]))
        b.linear(f"{p}.mlp.down_projection", hid, d, spec, False,
                 weights=host(lp["mlp"]["down"]["w"]))
    b.tensors["transformer.output_norm.scales"] = host(
        params["output_norm"]["scales"])
    return b.write(out_dir, lm.config)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="train the tiny model on the corpus; writes <out>_bf16 and <out>_int4")
    ap.add_argument("out", help="output prefix (writes <out>_bf16, <out>_int4)")
    # seq 512 (not 256): positions past the trained length extrapolate
    # badly; 512 covers the evaluation and speculation serving window
    ap.add_argument("--steps", type=int, default=1500)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--corpus-tokens", type=int, default=30_000_000)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu; the card raises if absent")
    args = ap.parse_args(argv)

    from ..config.model import IntSpec, Layout

    lm, params, losses = train(
        TINY_DIMS, steps=args.steps, batch=args.batch, seq=args.seq,
        lr=args.lr, corpus_tokens=args.corpus_tokens, device=args.device)
    d_bf16 = write_trained(lm, params, args.out + "_bf16")
    d_int4 = write_trained(
        lm, params, args.out + "_int4",
        linear_spec=IntSpec(bits=4, group_size=32, is_symmetric=True,
                            layout=Layout.OUTPUT_INPUT))
    print(json.dumps({
        "loss_first50": round(float(np.mean(losses[:50])), 4),
        "loss_last50": round(float(np.mean(losses[-50:])), 4),
        "bf16": d_bf16, "int4": d_int4,
    }), flush=True)
    return 0


if __name__ == "__main__":  # run as `python -m uzu_tpu_torch.tools.train_tiny`
    raise SystemExit(main())
