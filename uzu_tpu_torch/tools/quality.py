"""Quality measurement: teacher-forced NLL/perplexity + activation traces.

Counterpart of `uzu_tpu/tools/quality.py`. `sequence_nll` is the
teacher-forced negative log-likelihood of a token sequence, the measurable
form of "perplexity delta against full precision"; `capture_trace` dumps
the per-layer activations of one forward pass (the content of a model's
traces file) for offline comparison, and `compare_traces` diffs two such
dumps. Both run where the model runs: on the card through its kernels, on
the CPU through their plain versions, so the same trace taken on each
holds the card against the host.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.decoder import decoder_forward, embed, layer_forward, ple_layer_inputs, readout
from ..ops.norm import normalize


def sequence_nll(lm, tokens, chunk: int = 256) -> dict:
    """Teacher-forced negative log-likelihood of `tokens` under the model.

    Returns {"nll": mean nats/token, "ppl": perplexity, "count": N}.
    """
    tokens = np.asarray(tokens, np.int64)
    if tokens.ndim != 1 or len(tokens) < 2:
        raise ValueError("sequence_nll needs a 1-D sequence of at least 2 tokens")
    if len(tokens) > lm.max_context:
        raise ValueError(
            f"sequence of {len(tokens)} tokens exceeds max_context={lm.max_context}"
        )
    chunk = min(chunk, lm.max_context)
    cfg = lm.decoder_config
    dev = lm.device

    state = lm.new_state()
    total, count = 0.0, 0
    i = 0
    while i < len(tokens) - 1:
        take = min(chunk, len(tokens) - 1 - i)
        padded = np.zeros(chunk, np.int64)
        padded[:take] = tokens[i: i + take]
        targets = torch.zeros(chunk, dtype=torch.int64, device=dev)
        targets[:take] = torch.from_numpy(tokens[i + 1: i + 1 + take]).to(dev)
        logits, state = decoder_forward(cfg, lm.params, torch.from_numpy(padded).to(dev),
                                        state, last_only=False, true_length=take)
        logp = torch.log_softmax(logits.float(), dim=-1)
        picked = logp.gather(1, targets[:, None])[:take, 0]
        total += -float(picked.sum())
        count += take
        i += take
    nll = total / count
    return {"nll": nll, "ppl": float(np.exp(nll)), "count": count}


def capture_trace(lm, tokens) -> dict[str, np.ndarray]:
    """Per-layer activation dump for a single forward pass: the embedding
    output, each layer's hidden state, the final norm and the logits."""
    cfg = lm.decoder_config
    tcfg = cfg.transformer_config
    tokens = torch.as_tensor(np.asarray(tokens, np.int64), device=lm.device)
    state = lm.new_state()
    positions = torch.arange(tokens.shape[0], dtype=torch.int32, device=lm.device)

    def host(t):
        return t.float().cpu().numpy()

    out: dict[str, np.ndarray] = {}
    x = embed(cfg, lm.params, tokens)
    out["embedding"] = host(x)
    per_layer = ple_layer_inputs(cfg, lm.params, tokens, x)
    states = []
    for i, lc in enumerate(tcfg.layer_configs):
        src = lc.kv_source_layer_index
        shared = states[src] if src is not None else None
        x, new_state = layer_forward(lc, lm.params["layers"][i], x, positions,
                                     state["layers"][i], shared, tokens.shape[0],
                                     per_layer_input=None if per_layer is None
                                     else per_layer[:, i])
        states.append(new_state)
        out[f"layers.{i}"] = host(x)

    norm = lm.params["output_norm"]
    out["output_norm"] = host(normalize(x, tcfg.output_norm_config, norm["scales"],
                                        norm.get("biases")))
    out["logits"] = host(readout(cfg, lm.params, x))
    return out


def save_trace(path: str, trace: dict[str, np.ndarray]) -> None:
    from ..params.safetensors_io import save_file

    save_file(path, trace)


def load_trace(path: str) -> dict[str, np.ndarray]:
    from ..params.safetensors_io import SafetensorsFile

    f = SafetensorsFile(path)
    return {k: f.read(k) for k in f.keys()}


def compare_traces(a: dict, b: dict, rtol=1e-3, atol=1e-3) -> dict[str, dict]:
    """Per-tensor max abs/rel error report."""
    report = {}
    for key in sorted(set(a) & set(b)):
        x, y = np.asarray(a[key], np.float32), np.asarray(b[key], np.float32)
        if x.shape != y.shape:
            report[key] = {"shape_mismatch": (x.shape, y.shape), "ok": False}
            continue
        abs_err = float(np.max(np.abs(x - y))) if x.size else 0.0
        denom = np.maximum(np.abs(y), 1e-6)
        rel_err = float(np.max(np.abs(x - y) / denom)) if x.size else 0.0
        report[key] = {
            "max_abs_err": abs_err,
            "max_rel_err": rel_err,
            "ok": bool(np.allclose(x, y, rtol=rtol, atol=atol)),
        }
    report["__missing__"] = sorted(set(a) ^ set(b))
    return report
