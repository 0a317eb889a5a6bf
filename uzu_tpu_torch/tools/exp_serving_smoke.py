"""Smoke run of the serving engines' variants on one model.

Counterpart of `uzu_tpu/tools/exp_serving_smoke.py`: drives each variant
of the batch engines once (dynamic per-request sampling, frequency
penalties, logprobs, prefix-shared admission, paged admission through the
automatic prefix cache, speculative verify) and prints one JSON line per
stage, so a fault in any variant is attributable to its stage. The stages
and their in-run checks are the JAX package's; the engines are the port's
`BatchEngine`, `PagedBatchEngine` and `SpeculativeBatchEngine`, on the card
by default (`--device cpu` runs the plain PyTorch path). The port runs
eagerly, so there is no compilation cache to enable.

    python -m uzu_tpu_torch.tools.exp_serving_smoke .port_cache/llama1b_int8_2l
    python -m uzu_tpu_torch.tools.exp_serving_smoke /tmp/tiny --device cpu
"""

from __future__ import annotations

import argparse
import json
import time

# the stages, in the order they print (the JAX package's)
STAGES = ("loaded", "baseline", "dense_variants", "dense_logprobs_exact",
          "dense_prefix_admission", "paged_apc", "spec_solo", "spec_dynamic", "ALL_OK")


def main(model_dir: str, device=None, log=print) -> None:
    """Run every stage on the model at `model_dir`; each stage prints one
    JSON line through `log`. A failed check raises AssertionError."""
    import numpy as np

    from ..engine.engine import LanguageModel
    from ..engine.sampling import SamplingParams

    t0 = time.time()

    def stage(name, **kw):
        log(json.dumps({"stage": name, "t": round(time.time() - t0, 1), **kw}))

    lm = LanguageModel.from_dir(model_dir, device=device, max_context=1024,
                                prefill_buckets=(32, 512))
    rng = np.random.default_rng(0)
    prompt = [int(t) for t in rng.integers(0, lm.decoder_config.vocab_size, 48)]
    stage("loaded")

    from ..engine.batch import BatchEngine

    def shared_len(a, b):
        return next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                    min(len(a), len(b)))

    # baseline: one greedy request with no neighbours; every comparison
    # across engines below is made against it
    eng0 = BatchEngine(lm, batch_size=2, decode_chunk=8, stop_token_ids=[],
                       prefix_min=0)
    base = eng0.submit(prompt, 24)
    eng0.run()
    stage("baseline", greedy=base.tokens[:4])

    # all four request kinds in one engine: slots admit pipelined, and the
    # sampled and penalized neighbours change which chunks run the dynamic
    # sampling path, so the greedy slots hold a long shared prefix only
    # (bf16 drift may flip a near-tie later)
    eng = BatchEngine(lm, batch_size=4, decode_chunk=8, stop_token_ids=[],
                      prefix_min=16)
    r1 = eng.submit(prompt, 24)  # greedy
    r2 = eng.submit(prompt[:40], 24,
                    sampling=SamplingParams(temperature=0.9, top_k=50,
                                            top_p=0.95), seed=3)
    r3 = eng.submit(prompt[:32], 24, frequency_penalty=1.5, seed=7)
    r4 = eng.submit(prompt, 24, logprobs=3)
    eng.run()
    assert all(len(r.tokens) == 24 for r in (r1, r2, r3, r4))
    assert len(r4.logprob_content) == 24
    shared_lp = shared_len(r4.tokens, r1.tokens)
    assert shared_lp >= 8, f"logprobs-slot greedy diverged too early ({shared_lp})"
    shared_mixed = shared_len(r1.tokens, base.tokens)
    assert shared_mixed >= 8, \
        f"mixed-engine greedy diverged from baseline too early ({shared_mixed})"
    stage("dense_variants", greedy=r1.tokens[:4], sampled=r2.tokens[:4],
          penalized_distinct=len(set(r3.tokens)), lp_greedy_shared=shared_lp,
          base_shared=shared_mixed,
          first_lp=round(r4.logprob_content[0][0], 3))

    # exactness within one variant: two greedy slots, one with logprobs, no
    # dynamic neighbours, prefix sharing off: the tokens must match exactly
    eng2 = BatchEngine(lm, batch_size=2, decode_chunk=8, stop_token_ids=[],
                       prefix_min=0)
    g1 = eng2.submit(prompt, 24)
    g4 = eng2.submit(prompt, 24, logprobs=3)
    eng2.run()
    assert g4.tokens == g1.tokens, "logprobs row must not change greedy"
    stage("dense_logprobs_exact")

    # shared-prefix admission through the KV-row copy from a donor slot
    peng0 = BatchEngine(lm, batch_size=2, decode_chunk=8, stop_token_ids=[],
                        prefix_min=16)
    p1 = peng0.submit(prompt, 24)
    p2 = peng0.submit(prompt, 24)  # admitted via donor KV copy from p1
    peng0.run()
    shared_p = shared_len(p2.tokens, p1.tokens)
    assert shared_p >= 8, f"prefix-admitted greedy diverged too early ({shared_p})"
    stage("dense_prefix_admission", greedy_shared=shared_p)

    from ..engine.paged_batch import PagedBatchEngine

    peng = PagedBatchEngine(lm, batch_size=4, decode_chunk=8, num_pages=64,
                            page_size=64, stop_token_ids=[])
    a = peng.submit(prompt, 18)  # history 48 + 17 = 65 > page_size: retires
    peng.run()
    assert len(peng._retired) == 1
    retired_pages = peng.pool.pages(next(iter(peng._retired)))
    follow = prompt + a.tokens[:17] + [11, 12]
    b = peng.submit(follow, 16, logprobs=2)
    peng.step()  # admission must share the retired page, not prefill it again
    slot_b = next(i for i, s in enumerate(peng.slots) if s.request is b)
    assert peng.pool.pages(slot_b)[:1] == retired_pages[:1], "APC share missed"
    peng.run()
    assert len(b.logprob_content) == 16
    stage("paged_apc", retired=len(peng._retired), b_tokens=b.tokens[:4])

    from ..engine.batch_spec import SpeculativeBatchEngine

    # speculation alone against the baseline: the verify is another
    # program than the decode chunk (m + 1 rows a step), so a near-tie may
    # flip; a long shared prefix is held and exactness reported
    ssolo = SpeculativeBatchEngine(lm, batch_size=2, draft_block=4,
                                   stop_token_ids=[])
    s0 = ssolo.submit(prompt, 24)
    ssolo.run()
    shared_s0 = shared_len(s0.tokens, base.tokens)
    assert shared_s0 >= 8, f"spec-solo greedy diverged too early ({shared_s0})"
    stage("spec_solo", exact=s0.tokens == base.tokens, greedy_shared=shared_s0)

    seng = SpeculativeBatchEngine(lm, batch_size=2, draft_block=4,
                                  stop_token_ids=[])
    s1 = seng.submit(prompt, 24)
    s2 = seng.submit(prompt[:40], 24,
                     sampling=SamplingParams(temperature=0.9, top_k=50), seed=3)
    seng.run()
    shared = shared_len(s1.tokens, base.tokens)
    assert shared >= 8, f"dynamic-variant greedy diverged too early ({shared})"
    acc = seng.metrics.num_tokens_accepted / max(
        1, seng.metrics.num_tokens_proposed)
    stage("spec_dynamic", acceptance=round(acc, 3), greedy_shared=shared)

    stage("ALL_OK")


def cli(argv=None) -> int:
    ap = argparse.ArgumentParser(description="one JSON line per serving variant's stage")
    ap.add_argument("model_dir")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu; the card raises if absent")
    args = ap.parse_args(argv)
    main(args.model_dir, device=args.device, log=lambda line: print(line, flush=True))
    return 0


if __name__ == "__main__":  # run as `python -m uzu_tpu_torch.tools.exp_serving_smoke`
    raise SystemExit(cli())
