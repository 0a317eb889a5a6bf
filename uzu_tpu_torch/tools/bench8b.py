"""8B-class bench: Llama-3.1-8B's shape with INT4 weights, single stream
and, with `--paged`, `PagedBatchEngine` over 8 slots.

Counterpart of `uzu_tpu/tools/bench8b.py`. INT4 group-32 symmetric
weights of this shape (untied INT4 embedding and readout) are ~4.6 GB,
the first of the repo's models whose weight stream is large enough to
read against the card's memory rate. Seeded random weights, written by
the port's synthesizer (the JAX synthesizer's bytes) into
`.port_cache/bench/llama8b_int4`.

On the card a decode step runs K1 four times a layer (qkv, out, up|gate,
down) and once for the readout, and a prefill chunk K3 once a layer at
Dh 128 (32 query heads over 8 KV groups); the paged run's decode step runs
K5 once a layer over pages of 64 tokens.

    python -m uzu_tpu_torch.tools.bench8b [--paged] [--device cpu]
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

DIMS = dict(
    num_layers=32, model_dim=4096, hidden_dim=14336, num_heads=32,
    num_groups=8, head_dim=128, vocab_size=128256, max_seq=8192,
    rope_base=500000.0, llama3_rope_scaling=True, tied=False,
)
REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def model_dir(repo: str) -> str:
    from ..config.model import IntSpec, Layout
    from .synth import llama_config, synthesize

    out = os.path.join(repo, ".port_cache", "bench", "llama8b_int4")
    if not os.path.exists(os.path.join(out, "model.safetensors")):
        spec = IntSpec(bits=4, group_size=32, is_symmetric=True,
                       layout=Layout.OUTPUT_INPUT)
        synthesize(llama_config(**DIMS), out, seed=1, linear_spec=spec,
                   embedding_spec=spec, fill="fast")
    return out


def bench_8b(repo: str, stage=None, *, gen_len: int = 64,
             paged: bool = False, remaining=None, device=None) -> dict:
    """Measure 8B single-stream decode (and, with `paged`, B=8 paged
    decode) on `device` (None: the card) and return a result dict.
    `stage` is a progress-marker callback; `remaining` returns seconds of
    budget left (the paged stage runs only with more than 420)."""
    from ..config.model import AttentionConfig
    from ..engine.engine import LanguageModel
    from ..engine.sampling import SamplingParams
    from ..runtime import resolve_device
    from .decode_probe import probe_interleaved_decode, weight_bytes

    device = resolve_device(device)
    stage = stage or (lambda s: None)
    out: dict = {}

    stage("8b: synth/load")
    mdir = model_dir(repo)
    t0 = time.perf_counter()
    lm = LanguageModel.from_dir(mdir, device=device, max_context=1024,
                                prefill_buckets=(32, 512))
    out["load_s"] = round(time.perf_counter() - t0, 2)

    wbytes = weight_bytes(lm.params)
    out["weight_bytes"] = wbytes

    prompt_len = 128
    rng = np.random.default_rng(0)
    prompt = rng.integers(0, lm.decoder_config.vocab_size, prompt_len)
    sampling = SamplingParams()

    # bytes a decode step touches: every weight and the KV rows at the
    # middle of the generated span
    kv_dtype_bytes = 2
    mid_ctx = prompt_len + gen_len // 2
    kv_bytes = sum(
        2 * mid_ctx * lc.mixer_config.num_groups * lc.mixer_config.head_dim
        * kv_dtype_bytes
        for lc in lm.decoder_config.transformer_config.layer_configs
        if isinstance(lc.mixer_config, AttentionConfig)
    )

    stage("8b: warmup")
    list(lm.generate(prompt, gen_len, sampling=sampling, stop_token_ids=[]))
    stage("8b: decode x2 (probe-interleaved)")
    out.update(probe_interleaved_decode(lm, prompt, gen_len, sampling,
                                        wbytes + kv_bytes))

    if paged and (remaining is None or remaining() > 420):
        stage("8b: paged B=8 warmup")
        from ..engine.paged_batch import PagedBatchEngine

        def paged_run(nreq, gen_b):
            eng = PagedBatchEngine(
                lm, batch_size=8, decode_chunk=16, num_pages=128,
                page_size=64, sampling=sampling, stop_token_ids=[])
            reqs = [
                eng.submit(rng.integers(0, lm.decoder_config.vocab_size, 32),
                           gen_b)
                for _ in range(nreq)
            ]
            tb = time.perf_counter()
            eng.run()
            return sum(len(r.tokens) for r in reqs) / (time.perf_counter() - tb)

        paged_run(8, 16)
        stage("8b: paged B=8 measure")
        out["paged8_tok_s"] = round(max(paged_run(16, 48) for _ in range(2)), 2)

    return out


def main(argv: list[str] | None = None) -> None:
    import argparse

    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--paged", action="store_true", help="also measure PagedBatchEngine at B=8")
    p.add_argument("--device", default=None, help="default: the card; 'cpu' runs the plain path")
    args = p.parse_args(argv)

    def stage(s):
        print(f"[bench8b] {s}", file=sys.stderr, flush=True)

    res = bench_8b(REPO, stage, paged=args.paged, device=args.device)
    print(json.dumps({"metric": "llama8b_decode_tok_s", **res}))


if __name__ == "__main__":
    main()
