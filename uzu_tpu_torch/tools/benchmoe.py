"""MoE bench: a gpt-oss-small-shaped model, single-stream decode against
the bytes a step touches, and a 3584-token prefill.

Counterpart of `uzu_tpu/tools/benchmoe.py`. A mixture-of-experts decode
step reads only the K routed experts' weights of each layer, and its
prefill runs expert-grouped matmuls. The model: sinks, sliding windows of
128 on alternating layers, biased MoE, d 1024, 16 experts of which 4 are
active, expert width 1408, 8 layers; INT4 expert stacks and bf16
attention, router and embeddings, the split gpt-oss ships (MXFP4 experts,
bf16 elsewhere). Seeded random weights, written by the port's synthesizer
(the JAX synthesizer's bytes) into `.port_cache/bench/gptoss_small_eq4`.

On the card a decode step runs K7 twice a layer (the up|gate and down
planes of its 4 experts), a 512-row prefill chunk K9 twice a layer (2048
routed rows) and K3 once a layer (16 query heads over 8 KV groups). The
bf16 attention and readout linears take `ops/linear.py`'s dense route.

The speed-of-light accounting counts ACTIVE bytes per decode step:
attention, norms, router, K/E of the expert stacks, the embedding, and
the KV rows at the step's context, clamped to each layer's window.

    python -m uzu_tpu_torch.tools.benchmoe [--device cpu]
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

DIMS = dict(
    num_layers=8, model_dim=1024, num_heads=16, num_groups=8, head_dim=64,
    vocab_size=32768, num_experts=16, num_active=4, expert_hidden_dim=1408,
    sliding_window=128, max_seq=4096,
)
REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def model_dir(repo: str) -> str:
    from ..config.model import IntSpec, Layout
    from .synth import gptoss_config, synthesize

    out = os.path.join(repo, ".port_cache", "bench", "gptoss_small_eq4")
    if not os.path.exists(os.path.join(out, "model.safetensors")):
        spec = IntSpec(bits=4, group_size=32, is_symmetric=True,
                       layout=Layout.OUTPUT_INPUT)
        synthesize(gptoss_config(**DIMS), out, seed=5, fill="fast",
                   expert_spec=spec)
    return out


def active_bytes_per_step(lm, ctx: int) -> int:
    """Weight + KV bytes a decode step actually touches: full attention/
    norm/router weights, K/E of the expert weights, embedding readout,
    and the KV reads at context `ctx` (window-clamped per layer).

    The JAX package's loader pads a quantized down stack's output rows
    to a multiple of 128 (`uzu_tpu/models/moe.py:378-386`) and counts the
    padding; the port holds no padding, so the two agree where the model
    width is a multiple of 128 (1024 here)."""
    from ..config.model import AttentionConfig, MixtureOfExpertsConfig
    from .decode_probe import weight_bytes

    total = 0
    lcs = lm.decoder_config.transformer_config.layer_configs
    for lc, layer in zip(lcs, lm.params["layers"]):
        mlp = layer.get("mlp", {})
        for name, sub in layer.items():
            nb = weight_bytes(sub)
            if name == "mlp" and isinstance(lc.mlp_config, MixtureOfExpertsConfig):
                cfg = lc.mlp_config
                expert_nb = sum(weight_bytes(mlp.get(key, {})) for key in ("up", "down"))
                rest = nb - expert_nb
                nb = rest + expert_nb * cfg.num_active_routed_experts \
                    // cfg.num_routed_experts
            total += nb
        mc = lc.mixer_config
        if isinstance(mc, AttentionConfig):
            c = ctx if mc.sliding_window_size is None else min(
                ctx, mc.sliding_window_size)
            total += 2 * c * mc.num_groups * mc.head_dim * 2
    total += weight_bytes(lm.params["embedding"])
    return total


def bench_moe(repo: str, stage=None, *, gen_len: int = 320, device=None) -> dict:
    """Measure MoE single-stream decode (active-byte accounting, TTFT) and
    a 3584-token prefill on `device` (None: the card). 320 generated
    tokens spend most decode steps in 64-step chunks, past the 8-, 16- and
    32-step ramp of the engine's first chunks."""
    from ..engine.engine import LanguageModel
    from ..engine.sampling import SamplingParams
    from ..runtime import resolve_device
    from .decode_probe import probe_interleaved_decode

    device = resolve_device(device)
    stage = stage or (lambda s: None)
    out: dict = {}
    stage("moe: synth/load")
    mdir = model_dir(repo)
    t0 = time.perf_counter()
    lm = LanguageModel.from_dir(mdir, device=device, max_context=4096,
                                prefill_buckets=(32, 512))
    out["load_s"] = round(time.perf_counter() - t0, 2)

    rng = np.random.default_rng(0)
    prompt = rng.integers(0, lm.decoder_config.vocab_size, 128)
    sampling = SamplingParams()

    stage("moe: warmup")
    list(lm.generate(prompt, gen_len, sampling=sampling, stop_token_ids=[]))

    active = active_bytes_per_step(lm, 128 + gen_len // 2)
    stage("moe: decode x2 (probe-interleaved)")
    out.update(probe_interleaved_decode(lm, prompt, gen_len, sampling,
                                        active, record_ttft=True))

    stage("moe: prefill")
    # 7 chunks of 512 rows: one host read at the end of the prompt
    n_sust = 3584
    long_prompt = rng.integers(0, lm.decoder_config.vocab_size, n_sust)
    rate = 0.0
    for _ in range(2):
        st = lm.new_state()
        t0 = time.perf_counter()
        logits, st = lm.prefill(st, long_prompt)
        logits[:1].cpu()
        rate = n_sust / (time.perf_counter() - t0)
    out["prefill_tok_s"] = round(rate, 2)

    out["active_bytes"] = active  # sol/vs_* come from the shared helper
    return out


def main(argv: list[str] | None = None) -> None:
    import argparse

    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--device", default=None, help="default: the card; 'cpu' runs the plain path")
    args = p.parse_args(argv)

    def stage(s):
        print(f"[benchmoe] {s}", file=sys.stderr, flush=True)

    res = bench_moe(REPO, stage, device=args.device)
    print(json.dumps({"metric": "gptoss_small_decode_tok_s", **res}))


if __name__ == "__main__":
    main()
