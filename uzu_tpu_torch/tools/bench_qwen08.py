"""Qwen3.5-0.8B-class bench: the hybrid of BASELINE.md's north star,
single-stream decode against the bytes a step touches, and a 2048-token
prefill.

Counterpart of `uzu_tpu/tools/bench_qwen08.py`. Gated DeltaNet mixers
with GQA attention every 4th layer (`tools/synth.qwen35_config`), so a
decode step streams the weights and the recurrent state instead of a
growing KV cache. 0.8B-class widths, INT4 g32 symmetric linears and tied
embedding, seeded random weights (seed 2), written by the port's
synthesizer (the JAX synthesizer's bytes) into
`.port_cache/bench/qwen08_int4`.

On the card a decode step runs K1 for every linear (4 a layer) and the
readout, and a prefill chunk K3 once per attention layer at Dh 32; the
recurrent mixers are plain PyTorch.

The speed-of-light accounting: bytes a step touches = weight bytes +
decode-state bytes (the GDN [H, dh, vdh] states and conv tails, read and
written each step, and the attention layers' KV at mid-context, not the
capacity `new_state()` allocates).

    python -m uzu_tpu_torch.tools.bench_qwen08 [REPO] [--device cpu]
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

# 0.8B-class hybrid: 24 layers (attention every 4th), D=1280, ff=4608,
# GDN H=8/G=4 dh=128 vdh=128, vocab 128k tied (~0.75B params)
DIMS = dict(
    num_layers=24, model_dim=1280, hidden_dim=4608, vocab_size=128256,
    num_heads=8, num_groups=4, head_dim=128, value_head_dim=128,
    kernel_size=4, attn_every=4,
)
REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def model_dir(repo: str) -> str:
    from ..config.model import IntSpec, Layout
    from .synth import qwen35_config, synthesize

    out = os.path.join(repo, ".port_cache", "bench", "qwen08_int4")
    if not os.path.exists(os.path.join(out, "model.safetensors")):
        spec = IntSpec(bits=4, group_size=32, is_symmetric=True,
                       layout=Layout.OUTPUT_INPUT)
        synthesize(qwen35_config(**DIMS), out, seed=2, linear_spec=spec,
                   embedding_spec=spec, fill="fast")
    return out


def bench_qwen08(repo: str, stage=None, *, gen_len: int = 64, device=None) -> dict:
    """Measure the hybrid's single-stream decode and a 2048-token prefill
    on `device` (None: the card)."""
    from ..config.model import AttentionConfig
    from ..engine.engine import LanguageModel, _tensors
    from ..engine.sampling import SamplingParams
    from ..runtime import resolve_device
    from .decode_probe import probe_interleaved_decode, weight_bytes

    device = resolve_device(device)
    stage = stage or (lambda s: None)
    out: dict = {}

    stage("qwen08: synth/load")
    mdir = model_dir(repo)
    t0 = time.perf_counter()
    lm = LanguageModel.from_dir(mdir, device=device, max_context=4096,
                                prefill_buckets=(32, 512))
    out["load_s"] = round(time.perf_counter() - t0, 2)
    wbytes = weight_bytes(lm.params)
    out["weight_bytes"] = wbytes

    prompt_len = 128
    gen_mid = gen_len // 2
    rng = np.random.default_rng(0)
    prompt = rng.integers(0, lm.decoder_config.vocab_size, prompt_len)
    sampling = SamplingParams()

    # per-step STREAMED state, not the state's capacity (new_state()
    # allocates attention KV at full max_context; a decode step reads
    # only ~mid-context rows): the recurrent leaves (GDN [H, dh, vdh]
    # states + conv tails, fully read and written each step) + attention
    # KV at mid-context. The state's leaves are the JAX package's, the
    # int32 position included.
    attn_cfgs = [lc.mixer_config
                 for lc in lm.decoder_config.transformer_config.layer_configs
                 if isinstance(lc.mixer_config, AttentionConfig)]
    kv_cap_bytes = sum(2 * lm.max_context * mc.num_groups * mc.head_dim * 2
                       for mc in attn_cfgs)
    mid_ctx = prompt_len + gen_mid
    kv_mid_bytes = sum(2 * mid_ctx * mc.num_groups * mc.head_dim * 2
                       for mc in attn_cfgs)
    total_state = sum(t.numel() * t.element_size() for t in _tensors(lm.new_state()))
    state_bytes = total_state - kv_cap_bytes + kv_mid_bytes
    out["state_bytes"] = state_bytes

    stage("qwen08: warmup")
    list(lm.generate(prompt, gen_len, sampling=sampling, stop_token_ids=[]))
    stage("qwen08: decode x2 (probe-interleaved)")
    out.update(probe_interleaved_decode(lm, prompt, gen_len, sampling,
                                        wbytes + state_bytes))

    stage("qwen08: prefill")
    sustain = 2048
    lp = rng.integers(0, lm.decoder_config.vocab_size, sustain)
    for _ in range(2):
        st = lm.new_state()
        t0 = time.perf_counter()
        logits, st = lm.prefill(st, lp)
        logits[:1].cpu()
        out["prefill_tok_s"] = round(sustain / (time.perf_counter() - t0), 2)
    return out


def main(argv: list[str] | None = None) -> None:
    import argparse

    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("repo", nargs="?", default=REPO,
                   help="checkout whose .port_cache/ holds the model (default: this one)")
    p.add_argument("--device", default=None, help="default: the card; 'cpu' runs the plain path")
    args = p.parse_args(argv)

    def stage(s):
        print(f"[qwen08] {s}", file=sys.stderr, flush=True)

    res = bench_qwen08(args.repo, stage, device=args.device)
    print(json.dumps({"metric": "qwen08_decode_tok_s", **res}))


if __name__ == "__main__":
    main()
