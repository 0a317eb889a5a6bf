#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`uzu_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --flash-only   # K3/K4's rows of phase 2 alone
    python3 chip_smoke.py --paged-only   # K5/K6's rows of phase 2 alone
    python3 chip_smoke.py --qmm-only     # K1/K2's rows (prefill M too) with K7-K10's (shared headers)
    python3 chip_smoke.py --grouped-only # K7-K10's rows alone, BN / kw sweeps, ptxas, row checks
    python3 chip_smoke.py --gemma-only   # phase 14 alone, with K3-K6's Gemma rows
    python3 chip_smoke.py --hybrid-linear-only  # phase 15 alone, with K3-K6's rows past Dh 256
    python3 chip_smoke.py --spec-only    # phase 16 alone, with K1/K3's verify-shape rows
    python3 chip_smoke.py --batch-spec-only  # phase 17 alone, with K1/K5/K6/K9's verify rows
    python3 chip_smoke.py --serve-only   # phase 18 alone (the servers, the CLI, the classifier)
    python3 chip_smoke.py --parallel-only  # phase 19 alone, with its shard-shape kernel rows
    python3 chip_smoke.py --train-only   # phase 20 alone, with K3's L and K3b's rows of phase 2
    python3 chip_smoke.py --flash-bwd-only  # K3's L and K3b's rows of phase 2 alone
    python3 chip_smoke.py --step-profile-only  # STEP_REPS timed steps, one profiled; host µs
    python3 chip_smoke.py --bench-drivers-only  # phase 21 alone, with its kernel rows
    python3 chip_smoke.py --jamba-only   # S1's rows with K1/K3's at Jamba2-3B's shapes

Phases, each of which ends the run with a non-zero exit if it fails:

1. build: compile every CUDA kernel of the port from `uzu_tpu_torch/csrc/`
   (one nvcc per source, in parallel) while the flagship's models are
   synthesized (one process each); print the card's name and power limit.
   Two side processes start with the run (`side_process`), each
   synthesizing its own models (SIDE_MODELS, in the order its phases need
   them). Once phase 2's timed rows and phase 3's single stream are done,
   they share the card with this process: the second runs phases 7-8, 13
   and 14 and gpt-oss's and the hybrid's parts of phases 9-10 and 16-17,
   the third phases 19, 20, 15 (on its own copy of the INT4 flagship) and
   21 (its 8B model synthesized from the run's start by a worker of its
   own), and this one the rest; each sends back its readings, and an error in
   any fails the run. A phase that needs a model waits for that model
   alone.
2. kernels: each kernel against its plain PyTorch version on the card at
   the shapes its path gives it (bf16 inputs or INT8 codes, f32
   accumulation), with its time, the plain version's time, one PyTorch
   library call as a yardstick, and the bound (bytes over the HBM rate or
   FLOPs over the bf16 peak); the kernel and the yardstick are timed twice,
   as the time between two events (`ms`) and as device time alone
   (`device_ms`, the timer's spin): K1/K2 quant matmul (each row with its
   launch plan; ptxas's registers and spills of every instantiation; and a
   row-consistency check: for M = 2, 4, 8 each row of the product is
   bitwise the M=1 product of that row, bits 4 and 8), K3/K4 flash
   attention (bf16 / INT8 cache; at the end of the cache, the main path's
   first chunk, the split-KV shapes S=16/64 over 4096 slots, Dh 128, f32 q;
   each row with its split count and the kernel's ptxas registers and
   spills; and at the hybrid's heads, 8 over 2 groups at Dh 32, its first
   128-row chunk included), K1 at the hybrid's GDN input projection
   (N = 3088, a partial last 128-column tile, K = 1280; M = 1, 4, 128), K5/K6 paged decode attention (bf16 / INT8 pools of 16-512-token
   pages, uniform and ragged lengths up to 4096, window, soft cap, sinks,
   the paged engine's 1536-token table, Dh 128, f32 q and pools; each row
   with its split count and ptxas registers and spills),
   K3/K5 again at gpt-oss's heads (8 per KV group, window 128, sinks),
   K3-K6 at the Gemma models' heads at Dh 256 (4/1 and 8/2, window 512,
   soft cap 50, f32 q and pools, the paged engine's 1536-token table),
   at Dh 24 and 16, which run in the next instantiation up, and past Dh
   256 (512 and 264, the wide case: 256-column slices of the output) at
   gemma_e4b_8l's heads,
   K7/K8 expert-gather GEMV (each row with the launch plan it ran; with
   --grouped-only also at every kw and against contiguous dealing; ptxas's
   registers and spills of every instantiation; and a row check: each
   pair's row at P = 4 and 16 is bitwise a one-pair launch, and an INT4
   row is bitwise K9's small-route row at bm 8), K9/K10 grouped expert
   matmul (each row at its launch plan's layout, bm and geometry, through
   the wrappers; with --grouped-only also tile rows timed at every BN and
   small rows at every kw; ptxas's registers and spills of every
   instantiation; and a row check: at bm 8 each routed row's K9 output is
   bitwise the same whether its tile holds 1 or 8 rows), and P1, the bisect
   probe's zero-padded scale-block copy (bitwise equal), timed beside an
   empty kernel's launch (the launch floor); K3's row log-sum-exp at the
   flagship's heads (its K3 row, a one-split and a many-split chunk, bf16
   and f32: within LSE_TOL of `flash_attention_lse_plain`, the output
   bitwise the same with and without it), K3b's launch plan (the
   wrapper's equal to the kernel's at every instantiation, within 227 KB
   of shared memory), and K3b, K3's gradient (dQ, dK, dV each against
   `flash_attention_bwd_plain` within TOL and K3B_TOL, a second launch
   bitwise the first; each row with its parts, and PERF.md's time of the
   former kernel where it had one, printed as a constant) at the
   trainer's shape (S=512 from position 0 over 1024 slots, 6 heads over
   2 groups, f32; with --flash-bwd-only each launch's device ms), at the
   flagship's heads in bf16 and f32 and with a window, and at Dh 32 (8/2
   heads), 128 (16/4) and 256 (4/1), beside SDPA's backward (both device
   times after a BWD_SPIN spin, past the host's time to enqueue
   autograd's backward), with ptxas's registers and spills of its
   kernels.
3. path INT4: the Llama-1B-shaped INT4 flagship (16 layers, d 2048, vocab
   128256, random weights from a seed) loaded with `LanguageModel.from_dir`
   on the card; greedy generation of 64 tokens after a 128-token prompt,
   twice, with identical tokens; launch counts of K1 and K3 on that run;
   then once more with the INT8 KV cache (`kv_quant=True`), through K4.
4. paged INT4: `PagedBatchEngine` (8 slots, 8-step fused chunks, 64 pages
   of 512 tokens) over the same model: 11 greedy requests of 17 to 700
   prompt tokens (four share a 600-token prefix), then a follow-up that
   extends a finished request's history (the automatic prefix cache);
   each stream, fed step by step through the single-stream path, has
   every token within MARGIN of that path's best logit (so it takes the
   greedy choice wherever the top-2 margin is at least MARGIN), and the
   run takes the greedy choice at GREEDY_FLOOR of its steps or more; K5
   launched 16 times per step.
5. path INT8: the same shape with INT8 linears at 2 layers; K2 launched.
6. paged INT8: the 2-layer INT8 model with INT8 page pools; streams equal
   the dense INT8-KV single stream under the same rule; K4 and K6
   launched.
7. gpt-oss INT4: gpt-oss-20b's widths (d 2880, 64 query heads over 8 KV
   groups, 32 experts of which 4 are active, vocab 201088, sliding and
   full attention alternating, sinks) at 4 layers, bf16 attention and
   embeddings, INT4 g32 experts: the MoE routing runs with no host sync;
   a 128-token prompt and 64 greedy tokens, twice, identical; K7, K9 and
   K3 launched. Then `PagedBatchEngine` over it (11 requests, 8 slots),
   K9 launched twice per layer per decode step, K5 once per layer. Its
   streams are held, under the rule of phase 4, to the single stream
   (K7 in decode) taking the paged engine's expert choices, and each
   choice the single stream would not have made must be a router near-tie
   (ROUTER_MARGIN); the readings against the free single stream are
   reported too.
8. gpt-oss INT8 experts: 2 layers, prefill buckets up to 1024, an
   1100-token prompt and 16 greedy tokens: K10 (the 1024-row chunk) and K8
   (decode) launched.
9. control: the stream check must fail the streams of the paged engine
   when its K5 call reads the next slot's page table, and when it drops
   each slot's newest token; the MoE check of phase 7 must fail when K9
   multiplies by the next expert's weights, and when the router's decode
   rows take the experts ranked K+1 to 2K.
10. whole-path checks: teacher-forced logits of a 32-token prompt through
    the 2-layer INT4 flagship and through the first 2 layers of the INT4
    gpt-oss model, on the card and on the host CPU (for gpt-oss, the CPU pass takes the
    card's expert choices, each a router near-tie where they differ); a
    profiler capture of the gpt-oss model's first prefill and decode chunk
    (traces in `.port_cache/traces_gptoss/`), which must hold K9's tile
    and K3 in prefill and K7 in decode.
11. tools (`uzu_tpu_torch/tools/`), on the INT4 flagship: a profiler
    capture of its first prefill and decode chunk (UZU_TPU_PROFILE; the
    traces go to `.port_cache/traces/`), which must hold K1 and, in
    prefill, K3 kernel events, read for the top device ops and the
    decode window's device-busy share; `kernel_micros` (every time
    positive, K5 launched); the step breakdown of a decode step (M=1) and
    a 256-row prefill chunk; teacher-forced NLL and per-layer activation
    traces of a 256-token corpus sequence through the first 2 layers, on
    the card and on the host CPU (|dNLL| <= 1e-2 nats, each trace within
    2e-2 relative L2); and the quant-matmul bisect probe (P1's block read
    exact, K1 at a small group count and with zero-padded scale rows
    within its limits).
12. sampled decoding on the INT4 flagship: a single stream with
    temperature, top-k, top-p, min-p and a repetition penalty, and the
    dense `BatchEngine` with three requests each sampling with its own
    parameters; each run twice with the same seeds and identical tokens,
    and every sampled token inside the masks the plain path computes from
    the logits the card sampled it from.
13. hybrid: the Qwen3.5-class model at full width (the JAX package's
    bench_qwen08.DIMS: 24 layers, attention every 4th at Dh 32, d 1280,
    FFN 4608, GDN 8 heads over 4 groups, dk = dv = 128, vocab 128256;
    INT4 g32 linears and tied embedding, random weights from a seed): a
    128-token prompt (one 256-row bucket, the chunked GDN core) and 64
    greedy tokens, twice, identical; K1 and K3 launched; its first 4
    layers prefilled in one chunk against token at a time (TOL relative
    L2), and on the card against the host CPU with f32 activations (TOL)
    and with the served bf16 ones (each measured against the host's f32
    pass, the card at most F32_REF_RATIO times the host's distance);
    LFM2-style (ShortConv) and Mamba2 hybrids at 4 layers, d 1024, card
    against host the same way; `BatchEngine` (4 slots, 8-step chunks) over the
    full-width hybrid: 6 greedy requests of 17-300 prompt tokens, 32
    tokens each, held to the single stream under phase 4's rule, K1 at
    M = 4; a planted fault (the batched step reads the next slot's
    recurrent state) that the check must fail; a profiler capture of its
    first prefill and decode chunk (`.port_cache/traces_hybrid/`).
14. Gemma: `gemma3_1b`, `windowed_config` at Gemma-3-1B's published
    widths (26 layers, d 1152, FFN 6912, 4 query heads over 1 KV group at
    Dh 256, vocab 262144, window 512 on five layers of six), and
    `gemma_e4b_8l`, `gemma_config` at Gemma-3n-E4B's text widths cut to
    8 of 35 layers (d 2048, FFN 16384, 8/2 heads at Dh 256, vocab 262400,
    PLE 256 over 262144 ids, the last 2 layers sharing layer 5's KV);
    INT4 g32 linears and tied embedding, random weights. gemma3_1b:
    greedy twice, identical (K1, K3 at Dh 256); with `ring_windows=True`
    teacher-forced logits of a 1200-token prompt against the full layout
    (f32 activations, TOL relative L2) and its greedy stream under phase
    4's rule; INT8 KV (K4); `PagedBatchEngine` with phase 4's requests
    and checks (26 K5 launches a step), and at 2 layers with INT8 pools
    (K6); `BatchEngine` over rings (a 900-token prompt past the ring's 768
    slots among them); a profile of the ring model's first prefill and
    decode chunk (`.port_cache/traces_gemma3_1b/`). gemma_e4b_8l with the
    ring: greedy twice, identical, prompts holding ids past the PLE
    vocabulary (K1, K3 on the global layers); its first 4 layers card
    against host (f32, TOL); `BatchEngine` over rings; one batched decode
    step's logits per slot within TOL of the single stream's, and the
    check must fail with the PLE projection dropped from slot 1's row.

15. the slice of HybridSpec linears, the engine API and Dh past 256:
    the flagship's widths at HYBRID_LINEAR_LAYERS layers with every
    linear HybridSpec (an INT4 g32 symmetric base,
    a LowRank adapter of rank HYBRID_RANK, Hadamard incoherence in blocks
    of 32 on input and output; INT4 tied embedding; random weights from
    the port's synthesizer) through `from_dir` on the card: greedy twice,
    identical, K1 launched 4 times a layer and once for the readout a
    decode step, decode tok/s beside the plain flagship's; card against host at 2 layers (f32 activations,
    TOL); `PagedBatchEngine` over 4 requests under phase 4's rule;
    `generate_resumable`: two turns under phase 4's rule against the
    single stream over their whole history, `.state["pos"]`, and with
    logprobs=5 each log-probability within LOGPROB_TOL of the f32
    log-softmax of the card's teacher-forced logits; the recommended
    context on the card with a state of that context allocated;
    `read_many` against `read` over the model's file (bytes and times).
    Then a synthetic 2-layer model at gemma_e4b_8l's other widths with Dh
    512 (gemma_config: single stream, K3 at Dh 512, card against host in
    f32) and its PLE-free windowed_config twin through `PagedBatchEngine`
    (K5 at Dh 512, card against host).

16. single-stream speculative decoding (`engine/speculation.py`,
    `engine/dflash.py`, `engine/fused_spec.py`): on the flagship, after a
    repetitive 128-token prompt (one 16-token phrase eight times), a plain
    greedy stream of SPEC_TOKENS and, against it under phase 4's rule,
    chain speculation with `NgramSpeculator`, with an oracle draft of the
    plain stream's next 31 tokens (32-row verify blocks: K3), with
    `self_speculative_decoder` (SPEC_DRAFT_LAYERS draft layers) and with
    `DraftModelSpeculator` over the 2-layer INT8 flagship; tree
    speculation (16 nodes); DFlash over a synthesized draft (block 8, taps
    after layers 1, 8 and 14); `fused_self_speculative_decoder` (8 rounds
    per fetch, each dispatch's rounds under
    `torch.cuda.set_sync_debug_mode("error")`). Each run reports its tok/s
    beside the plain stream's (both over the whole generate call), its
    acceptance, tokens per verify pass, K1/K3 launches per verify round and
    its bitwise-equal share. Sampled chain and fused runs repeat under one
    seed; the stream check must fail an acceptance of one draft more than
    matched and a tree compaction with its write base off by m (clean runs
    of the same oracles pass it). On the Qwen3.5-class hybrid: chain and
    tree speculation under the same rule, and one partially accepted verify
    round whose committed GDN states lie within TOL relative L2 of the
    token-at-a-time states; oracle chain and tree runs put K3 on 16-row
    blocks and replay GDN states over non-consecutive tree paths. On gpt-oss at 4 layers: a chain verify round's
    logits at blocks of 4 rows (K7) and 8 rows (K9's small route) within
    TOL relative L2 of the single stream's along the same tokens, the
    routing pinned as in phase 10. Phase 2 holds K1 at M = 16 / 32 on the
    flagship's linears and K3 at S = 16 / 32 from position 700 over 1024
    slots (the flagship's and the hybrid's heads) to their plain versions.

17. speculative continuous batching (`engine/batch_spec.py`,
    `models/paged_decode.py::paged_verify_step`, `models/batch_decode.py`'s
    verify and commit, `grammar/`): on the full-width flagship through
    `SpeculativePagedBatchEngine` (8 slots, blocks of 9 rows) host n-gram
    drafts, a 4-layer self-draft and device n-gram drafts in fused rounds of
    8 (every dispatch under set_sync_debug_mode("error")), each stream under
    phase 4's rule, beside the plain `PagedBatchEngine`'s tok/s; a sampled
    run twice under one seed; a pool that preempts under sampling, whose
    streams equal the unpreempted ones; a JSON-schema and a regex request
    (native masks over a seeded synthetic vocabulary of all 128256 ids)
    beside six plain ones: each output closes, parses and satisfies its
    grammar, each sampled token lies in the host matcher's mask, the plain
    streams pass phase 4's rule; the stream check must fail an acceptance
    of one draft more than matched and a verify row written through a cut
    table's last live column (clean runs pass it). The 2-layer INT8 flagship
    with INT8 pools (K2, K4, K6) under the same rule; the full-depth
    Qwen3.5-class hybrid through `SpeculativeBatchEngine` (4 slots: n-gram
    and 6-layer self-draft runs beside `BatchEngine`'s tok/s, and one
    partially accepted round of 4 slots x 9 rows whose committed GDN
    states lie within TOL relative L2 of the token-at-a-time ones with K1
    kept on one route on both sides, each route in turn; the served
    round's distance, K1's tile rows against its small rows, is reported
    beside them); gpt-oss at 4 layers: one
    verify round's logits (72 rows, K9's tile route) within TOL relative L2
    of `paged_decode_step` fed the same tokens with the verify's expert
    choices. Phase 2 holds K1 at M = 72 / 36, K5 / K6 at 72 rows over
    repeated tables and K9 at 288 routed rows to their plain versions.

18. the serving front end (`sessions/`, `server/`, `cli.py`,
    `models/classifier.py`) on the flagship, with a byte-level tokenizer
    over all 128256 ids written here (`.port_cache/llama1b_chat`, its
    weights linked; stop ids `<|end|>`'s): `serve(ChatSession)` on
    127.0.0.1 answers a plain, an SSE-streamed and a JSON-schema request;
    `serve_batched(batch_size=8)` picks `PagedBatchEngine` and answers 12
    concurrent requests (11 conversations of 17-700 rendered tokens, five
    sharing a 600-token system prompt, 32-48 new tokens, every other one
    streamed; a JSON-schema request, which the plain paged engine refuses
    with HTTP 400); `serve_batched(..., speculate="ngram")` serves the
    JSON request beside three plain ones. Every prompt is the template's
    render through the tokenizer, every response text what a client reads
    of its tokens, every plain stream under phase 4's rule, no request in
    "error" and no scheduler traceback; each JSON output closes, parses,
    satisfies BSPEC_SCHEMA and has every token in its matcher's mask; the
    paged server's K5, K3 and K1 launches equal layers x decode steps,
    layers x prefill chunks and (4 x layers + 1) x both; a prompt shifted
    right by one token before admission must fail the stream check. The
    CLI's `bench` writes its BenchResult JSON with the card's name; the
    encoder classifier (12 layers, d 768, bf16) on the card against the
    host within TOL, and padded to two buckets within TOL. HTTP latency,
    first chunks and tok/s are printed beside the engines' own.

19. multi-device execution (`parallel/`, the engines and servers over a
    mesh) on the flagship at full width. A world of one: `initialize()`
    joins a process group of one over NCCL (one all-reduce probes it) and
    `LanguageModel.from_dir(tp=1, dp=1)` runs over its (1, 1) mesh: a
    greedy stream of PARALLEL_TOKENS and `PagedBatchEngine` and
    `BatchEngine` over 4 requests equal the unsharded model's token for
    token in the same run, with the same launches (K1 4 x layers + 1 a
    forward pass), tok/s beside the unsharded stream's. Then two spawned
    ranks share the card, tp=2 over gloo with CUDA tensors (NCCL refuses
    two ranks on one device), after a probe of gloo's all-reduce,
    all-gather and broadcast on CUDA tensors (a failed collective fails
    the phase): each rank holds 16 of the 32
    heads over 4 of the 8 KV groups, 8192 of up|gate's rows and 4096 of
    down's columns; the ranks' greedy streams are bitwise one and pass
    phase 4's rule against the unsharded single stream, and so do their
    `PagedBatchEngine` streams (K5 once a layer a step at half the heads);
    the same run with the fused [up | gate] rows cut contiguously must
    fail that rule; each rank's launches, decode tok/s and the mean time
    of one decode row's all-reduce over gloo are recorded. Phase 2 holds
    K1 at the shard shapes (tp=2: qkv 1536, out 2048 x 1024, up|gate
    8192, down 2048 x 4096 at M = 1 and 256; tp=4: out 2048 x 512, down
    2048 x 2048), K3 over a 256-row chunk and K5 over 8 x 1024 live tokens
    at 16 heads over 4 groups to their plain versions.

20. the in-repo trainer and what it feeds (`tools/train_tiny.py`,
    `ops/cuda/autotune.py`, `tools/exp_serving_smoke.py`): TINY_DIMS (8
    layers, d 384, 6 heads over 2 groups at Dh 64, vocab 256; ~18M
    parameters, f32) trained on the card at batch 16 x 512 for
    TRAIN_STEPS steps through `train_tiny.train` (K3 forward, K3b
    backward), after one step under the profiler (K3b's and K3's device
    ms inside the step, its device-busy share): losses finite, the last
    10's mean below TRAIN_DROP x the first 10's; step 0's loss within
    TRAIN_LOSS_RTOL and every leaf's gradient within TRAIN_GRAD_TOL rel.
    L2 of the host CPU's (a spawned process, alongside); K3 and K3b each
    launched layers x batch times a step; steps/s and tokens/s.
    `write_trained` writes bf16 and INT4 g32
    directories under `.port_cache/`; the INT4 one on the card greedy twice,
    identical (K1, K3), its held-out NLL within tests/test_train_tiny.py:61's
    bound of the bf16 one's, and the n-gram chain's acceptance on it (a
    reading). `autotune_shapes` over the flagship's linear shapes at M =
    1, 8, 256 into `.port_cache/tile_table.json`, `qmm_plan` reading back
    every entry, each tabled plan within TOL of the plain version, and a
    short `validate_e2e` on the flagship (ms/token with and without the
    table). `exp_serving_smoke` over the 2-layer INT8 flagship: every
    stage line, in order.

21. the port's bench tools (`uzu_tpu_torch/tools/{bench8b,benchmoe,
    bench_qwen08}.py` over `tools/decode_probe.py`) on the card through
    their public functions, at their DIMS, gen_len and prompts:
    `bench_8b(paged=True)` on the Llama-3.1-8B-class INT4 model at full
    width and depth (32 layers, d 4096, 32 query heads over 8 groups at Dh
    128, untied INT4 readout; single stream, then `PagedBatchEngine` over 8
    slots in 64-token pages), `bench_moe` (the gpt-oss-small shape: d 1024,
    16 experts of which 4 are active, 8 layers, window 128 and sinks,
    INT4 experts; 320 decode tokens and a 3584-token prefill) and
    `bench_qwen08` (the Qwen3.5-class hybrid, seed 2). Each tool's JSON
    line is printed on a line of its own and must load through the port's
    `compare_bench.load_record`; every number finite and positive,
    `vs_baseline` and `vs_practical` at most BENCH_RATE_SLACK and
    `practical_bw_gbs` at most BENCH_RATE_SLACK x the card's spec rate; the
    launches of each step function per call as the tool's model derives
    them (`expected_step_launches`: 8B K1 129 a decode step, K3 32 a
    prefill chunk, K5 32 a paged step; MoE K7 16 a step, K9 16 and K3 8 a
    chunk; hybrid K1 97 a step, K3 6 a chunk); and the 8B's first 2 layers
    card against host (TOL). Phase 2 holds K1 at the 8B's five linears
    (M = 1 and its 512-row chunk), K3 at Dh 128 over the 8B's first chunk
    and at the MoE's heads (16 over 8) with window 128 and sinks, K5 at Dh
    128 over 64-token pages, K7 at E = 16, P = 4 and K9 at T = 2048 to
    their plain versions.

The line before the last is the kernels' JSON record; the last line is
`{"ok": true, "device": {...}}`. Full per-shape numbers also go to
`.port_cache/chip_smoke.json`.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import json
import math
import multiprocessing
import os
import statistics
import subprocess
import sys
import threading
import time
from concurrent.futures import ProcessPoolExecutor

REPO = os.path.dirname(os.path.abspath(__file__))

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core peak
TOL = 2e-2  # max |kernel - plain| over RMS(plain): bf16 operands, f32 sums

FLAGSHIP = dict(num_layers=16, model_dim=2048, hidden_dim=8192, num_heads=32,
                num_groups=8, head_dim=64, vocab_size=128256, max_seq=8192,
                rope_base=500000.0, llama3_rope_scaling=True)
LINEAR_SHAPES = (("qkv", 3072, 2048), ("out", 2048, 2048),
                 ("up|gate", 16384, 2048), ("down", 2048, 8192),
                 ("readout", 128256, 2048))
# gpt-oss-20b's published widths; the depth is cut to 4 layers (2 for the
# INT8-expert model) so the models synthesize and load inside the run
GPTOSS = dict(model_dim=2880, num_heads=64, num_groups=8, head_dim=64, vocab_size=201088,
              num_experts=32, num_active=4, expert_hidden_dim=2880, sliding_window=128,
              max_seq=8192)
EXPERT_SHAPES = (("up", 5760, 2880), ("down", 2880, 2880))
# the repo's Qwen3.5-0.8B-class hybrid (the JAX package's bench_qwen08.DIMS):
# Gated DeltaNet mixers, GQA attention every 4th layer at the synthesizer's
# hybrid defaults (8 heads over 2 groups, Dh 32), vocab 128256 tied
QWEN08 = dict(num_layers=24, model_dim=1280, hidden_dim=4608, vocab_size=128256,
              num_heads=8, num_groups=4, head_dim=128, value_head_dim=128,
              kernel_size=4, attn_every=4)
HYBRID_ATTN = dict(num_heads=8, num_groups=2, head_dim=32)
# ShortConv and Mamba2 hybrids at 4 layers, d 1024 (their published widths
# are not in the repository): LFM2's layout (attention every 3rd layer,
# conv kernel 3) and Mamba2 mixers of 32 heads x 64 over a 128-wide state
LFM2_4L = dict(num_layers=4, model_dim=1024, hidden_dim=4096, vocab_size=65536)
MAMBA2_4L = dict(num_layers=4, model_dim=1024, hidden_dim=4096, vocab_size=65536,
                 num_heads=32, num_groups=1, head_dim=64, state_dim=128)
# the GDN input projection: 2 * 512 (q, k) + 1024 (v) + 1024 (z) + 2 * 8
# (beta, a) outputs over d = 1280
HYBRID_LINEAR_SHAPES = (("gdn_in", 3088, 1280),)
# Gemma-3-1B's published widths (google/gemma-3-1b-pt config.json), full
# depth: 26 layers, 4 query heads over 1 KV group at Dh 256, window 512 on
# five layers of every six
GEMMA3_1B = dict(num_layers=26, model_dim=1152, hidden_dim=6912, num_heads=4, num_groups=1,
                 head_dim=256, vocab_size=262144, sliding_window=512)
# Gemma-3n-E4B's published text widths (google/gemma-3n-E4B text config),
# cut to 8 of 35 layers: 8 query heads over 2 KV groups at Dh 256, window
# 512, per-layer embeddings of 256 over the first 262144 ids, the last 2
# layers sharing layer 5's KV
GEMMA_E4B = dict(num_layers=8, model_dim=2048, hidden_dim=16384, num_heads=8, num_groups=2,
                 head_dim=256, vocab_size=262400, sliding_window=512, ple_dim=256,
                 ple_vocab=262144, kv_share_last=2)
GEMMA_SOFT_CAP = 50.0  # gemma_config's attention logit soft cap
# phase 15: the flagship with every linear HybridSpec (an INT4 g32
# symmetric base, a LowRank adapter, Hadamard incoherence in blocks of 32
# on input and output); the adapter's rank is a synthetic choice
HYBRID_RANK = 16
HYBRID_LINEAR_LAYERS = 4  # the HybridSpec flagship's depth (full width)
# a synthetic 2-layer model at gemma_e4b_8l's other widths with Dh 512
# (Gemma-4's global layers' width): gemma_config single stream (PLE, K3),
# and windowed_config without PLE for the paged engine (K5)
WIDE_GEMMA = dict(GEMMA_E4B, num_layers=2, head_dim=512, kv_share_last=0)
# nats: generation's log-probabilities against the f32 log-softmax of the
# same path's teacher-forced logits (prefill, then one decode step per
# token; the same kernels in the same order)
LOGPROB_TOL = 1e-3
# head dims between two kernel instantiations (the tiny configs' 24 and 16)
ROUNDED_HEAD_DIMS = (24, 16)
# past 256: Gemma-4's global layers' width, and the smallest Dh past 256
# (both run in the Dh-256 layout's wide case, 2 column slices)
WIDE_HEAD_DIMS = (512, 264)
# phase 21: the port's bench tools (uzu_tpu_torch/tools/), each model
# synthesized by its tool's model_dir at the tool's DIMS: the
# Llama-3.1-8B-class INT4 model (32 layers, d 4096, untied INT4 readout),
# the gpt-oss-small-shaped MoE (d 1024, 16 experts of 4 active, INT4
# experts) and the Qwen3.5-class hybrid with its own seed (2)
BENCH_TOOLS = ("bench8b", "benchmoe", "bench_qwen08")
BENCH_METRICS = {"bench8b": "llama8b_decode_tok_s", "benchmoe": "gptoss_small_decode_tok_s",
                 "bench_qwen08": "qwen08_decode_tok_s"}
# the 8B's linears and its prefill chunk's rows (the 128-token prompt in
# the tool's 512-row bucket); the MoE's expert stacks, its decode step's
# pairs and the routed rows of a 512-row chunk
LLAMA8B_LINEAR_SHAPES = (("8b/qkv", 6144, 4096), ("8b/out", 4096, 4096),
                         ("8b/up|gate", 28672, 4096), ("8b/down", 4096, 14336),
                         ("8b/readout", 128256, 4096))
LLAMA8B_CHUNK = 512
# K1's tile at prefill M (--qmm-only): the linears of the benchmark's two
# configurations (Qwen3-4B, LFM2-1.2B; fused as the port fuses them), the
# rows of their 2048- and 4096-row chunks, and ragged M past a full 64-row
# box; the three weights of the kernel table's rows; their error limit, the
# worst err/RMS of K1's smaller-M rows
PREFILL_LINEAR_SHAPES = (("qwen3/qkv", 6144, 2560), ("qwen3/out", 2560, 4096),
                         ("qwen3/up|gate", 19456, 2560), ("qwen3/down", 2560, 9728),
                         ("lfm2/qkv", 3072, 2048), ("lfm2/out", 2048, 2048),
                         ("lfm2/conv_in", 6144, 2048), ("lfm2/up|gate", 16384, 2048),
                         ("lfm2/down", 2048, 8192))
PREFILL_M = (2048, 4096)
PREFILL_RAGGED_M = (1025, 2049, 4095)
PREFILL_ROW_WEIGHTS = ("qwen3/up|gate", "qwen3/down", "lfm2/up|gate")
PREFILL_TOL = 1.28e-2
# a weight narrow enough that the plan splits K at the ragged M (6, 3, 2
# splits): the f32 partials' scratch and the split sum at M past 1024
PREFILL_SPLIT_SHAPE = ("split", 512, 4096)
MOE_SMALL_EXPERT_SHAPES = (("moe_small/up", 2816, 1024), ("moe_small/down", 1024, 1408))
MOE_SMALL_CHUNK = 512
# the bench tools' readings are rates against the card's stream rate: a
# reading past it by more than this share means the byte count is wrong
BENCH_RATE_SLACK = 1.05
GEN_PROMPT, GEN_TOKENS = 128, 64
REPS = 10
# a greedy step whose single-stream top-2 logit margin is below this may
# pick the other token on another path (bf16 activations, other summation
# order); no token of a stream may lie this far below the best logit of
# the single stream fed the same history (see check_streams) ...
MARGIN = 0.125
# ... and a run's streams take the single stream's greedy choice at no
# fewer than this share of their steps
GREEDY_FLOOR = 0.9
# An MoE router's choice flips at a near-tie: the two paths' router inputs
# differ by bf16 rounding that compounds layer by layer (a few 1e-3 of
# RMS by layer 3 of gpt-oss, router logits ~N(0, 1.07): their logits differ
# by ~1e-2), and one flipped expert moves the logits far past MARGIN. So
# the single stream that the MoE streams are held to takes the expert
# choices the paged engine took (see path_paged_gptoss), and each choice
# it did not make itself may lie at most this far below its own K-th
# router logit (check_routing).
ROUTER_MARGIN = 0.125
PAGED_TOKENS = 64
GEMMA_PAGED_TOKENS = 32  # gemma3_1b's paged requests (26 layers a compared step)
CONTROL_TOKENS = 16
BATCHED_TOKENS = 32
SAMPLED_TOKENS = 32
NLL_TOL = 1e-2  # |NLL card - NLL host| in nats over a 256-token sequence
# the hybrids' served bf16 logits at 4 layers, each measured against the
# host's f32-activation pass: the card's distance may be at most this
# multiple of the host's bf16 plain path's (on the H100 the Qwen3.5-class
# model's read 3.00e-2 against 2.69e-2)
F32_REF_RATIO = 1.5
# the bisect probe's cells, each held to max abs error over RMS(oracle):
# the f32 GEMV at M=1 is f32 throughout; at M=64 the tile rounds x and the
# weight to bf16; the bf16-scale cell is held to an f32-scale oracle
BISECT_LIMITS = {"prod_kg16": 1e-4, "prod_pad128": 1e-4, "prod_pad64": 1e-4,
                 "prod_pad32": 1e-4, "pad128_m64": 2e-2, "pad128_bf16": 2e-2}
# kernel names (csrc/) that a profiler trace must hold, per model and phase
# (gpt-oss: a 128-token prefill takes K9's tile route, decode K7)
TRACE_KERNELS = {
    "flagship": {"prefill": {"K1": ("qmm_small", "qmm_tile"), "K3": ("flash_fwd",)},
                 "decode": {"K1": ("qmm_small",)}},
    "gptoss": {"prefill": {"K9": ("grouped_tile_q",), "K3": ("flash_fwd",)},
               "decode": {"K7": ("moe_small",)}},
    "hybrid": {"prefill": {"K1": ("qmm_small", "qmm_tile"), "K3": ("flash_fwd",)},
               "decode": {"K1": ("qmm_small",)}},
    "gemma3_1b": {"prefill": {"K1": ("qmm_small", "qmm_tile"), "K3": ("flash_fwd",)},
                  "decode": {"K1": ("qmm_small",)}}}
# kernel names whose launches and summed device ms each trace reports
TRACED_PORT_KERNELS = ("qmm_small", "qmm_tile", "qmm_split_sum", "flash_fwd",
                       "flash_combine", "moe_small", "grouped_small", "grouped_tile_q")
# rows of the product that the row-consistency check holds to the M=1 rows
ROW_CHECK_M = (2, 4, 8)


def log(msg: str) -> None:
    print(msg, flush=True)


class Timer:
    """Median time of `fn` between two events over REPS launches, each
    after an L2 flush (the weights of a decode step do not stay in the 50 MB
    L2). Where the host takes longer to enqueue `fn` than the card takes to
    flush, the card waits between the events and that wait is counted. With
    `spin`, the card also spins SPIN_CYCLES after the flush, so the host has
    enqueued `fn` before the start event fires: device time alone. Without
    `flush`, what the last launch left in L2 stays there."""

    SPIN_CYCLES = 200_000  # ~0.1 ms at the H100's clock

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")

    def ms(self, fn, reps: int = REPS, spin: bool = False, flush: bool = True,
           spin_cycles: int = SPIN_CYCLES) -> float:
        torch = self.torch
        fn()
        events = []
        for _ in range(reps):
            if flush:
                self.flush.zero_()
            if spin:
                torch.cuda._sleep(spin_cycles)
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            events.append((a, b))
        torch.cuda.synchronize()
        return statistics.median(a.elapsed_time(b) for a, b in events)

    def both(self, fn, spin_cycles: int = SPIN_CYCLES) -> tuple[float, float]:
        """(ms, device ms) of `fn`: without and with the spin."""
        return self.ms(fn), self.ms(fn, spin=True, spin_cycles=spin_cycles)


def bound(nbytes: float, flops: float) -> tuple[float, str]:
    tb, tf = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS
    return (max(tb, tf) * 1e3, "bytes" if tb >= tf else "operations")


def rel_err(got, want) -> tuple[float, float]:
    d = (got.float() - want.float()).abs().max().item()
    rms = want.float().pow(2).mean().sqrt().item()
    return d, d / max(rms, 1e-30)


# -- phase 2: kernels --------------------------------------------------------


def qmm_row(torch, timer, rows, w, wd, wname: str, m: int, variant: str, gen,
            tol: float = TOL) -> None:
    """One K1/K2 case: the kernel against its plain version on a random
    [M, K] bf16 x (err/RMS <= tol), its time, the plain version's, the
    dequantized matmul as the yardstick, the bound and the launch plan."""
    from uzu_tpu_torch.ops.cuda.flash_attention import num_sms
    from uzu_tpu_torch.ops.cuda.quant_matmul import (
        plan_blocks,
        qmm_plan,
        quant_matmul,
        quant_matmul_plain,
    )

    n, k = wd.shape
    bits = w.bits
    x = torch.randn((m, k), device="cuda", generator=gen).to(torch.bfloat16)
    got = quant_matmul(w, x)
    want = quant_matmul_plain(w, x)
    torch.cuda.synchronize()
    abs_err, err = rel_err(got, want)
    if not (err <= tol):
        raise AssertionError(f"quant_matmul int{bits} {wname} M={m} {variant}: "
                             f"error {err:.3e} of RMS > {tol}")
    nbytes = (m * k * 2 + w.codes.numel() + w.scales.numel() * 2
              + (w.qbias.numel() * 2 if w.qbias is not None else 0) + m * n * 4)
    b_ms, b_by = bound(nbytes, 2.0 * m * n * k)
    ms, dev_ms = timer.both(lambda: quant_matmul(w, x))
    lib_ms, lib_dev_ms = timer.both(lambda: torch.matmul(x, wd.t()))
    plan = qmm_plan(m, n, k, bits, num_sms(x.device))
    row = dict(kernel=f"quant_matmul_int{bits}", weight=wname, N=n, K=k, M=m,
               variant=variant, plan=plan._asdict(), blocks=plan_blocks(plan, m, n),
               max_abs_err=abs_err, err_over_rms=err, tol=tol, ms=ms, device_ms=dev_ms,
               plain_ms=timer.ms(lambda: quant_matmul_plain(w, x), 3),
               library_ms=lib_ms, library_device_ms=lib_dev_ms, bound_ms=b_ms, bound_by=b_by)
    rows.append(row)
    log("KERNEL " + json.dumps(row))


def random_qweights(torch, gen, n: int, k: int, bits: int, g: int = 32):
    """{variant: (QuantizedTensor, its bf16 dequantization)} over one draw
    of random codes and scales: `symmetric` with the symmetric
    coefficient, `stored_qbias` with a random qbias array."""
    from uzu_tpu_torch.quant.format import QuantizedTensor, dequantize

    kg = -(-k // g)
    codes = torch.randint(0, 256, (n, k * bits // 8), dtype=torch.uint8, device="cuda",
                          generator=gen)
    scales = (torch.rand((n, kg), device="cuda", generator=gen) * 0.01 + 0.001
              ).to(torch.bfloat16)
    qbias = (torch.randn((n, kg), device="cuda", generator=gen) * 0.01).to(torch.bfloat16)
    out = {}
    for variant in ("symmetric", "stored_qbias"):
        w = (QuantizedTensor(codes, scales, None, bits, g, -float(1 << (bits - 1)))
             if variant == "symmetric" else QuantizedTensor(codes, scales, qbias, bits, g))
        out[variant] = (w, dequantize(w, torch.bfloat16))
    return out


def check_quant_matmul(torch, timer, rows) -> None:
    """K1/K2 at the flagship's linears, both variants, M = 1 (single-stream
    decode), 8 (a paged step of 8 slots) and 16/64/256 (prefill buckets)."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    for bits in (4, 8):
        for wname, n, k in LINEAR_SHAPES:
            for variant, (w, wd) in random_qweights(torch, gen, n, k, bits).items():
                for m in (1, 8, 16, 64, 256):
                    qmm_row(torch, timer, rows, w, wd, wname, m, variant, gen)


def check_quant_matmul_hybrid(torch, timer, rows) -> None:
    """K1 at the hybrid's Gated DeltaNet input projection, N = 3088 (24
    full 128-column tiles and a partial one of 16) by K = 1280: M = 1
    (single-stream decode), 4 (the dense batch engine's 4-slot step) and
    128 (the tile route's ragged last N tile)."""
    gen = torch.Generator(device="cuda").manual_seed(13)
    for wname, n, k in HYBRID_LINEAR_SHAPES:
        w, wd = random_qweights(torch, gen, n, k, 4)["symmetric"]
        for m in (1, 4, 128):
            qmm_row(torch, timer, rows, w, wd, wname, m, "symmetric", gen)


def check_quant_matmul_prefill(torch, timer, rows) -> None:
    """K1's tile at prefill M: rows (`qmm_row`, err/RMS <= PREFILL_TOL) of
    PREFILL_ROW_WEIGHTS at every PREFILL_M and PREFILL_RAGGED_M, INT4 in
    symmetric groups of 32 as the benchmark's weights are (stored qbias too
    at the largest ragged M); then every PREFILL_LINEAR_SHAPES weight at
    PREFILL_M timed at both tile heights with splits 1 (QMM_PREFILL_BM:
    device ms of bm 128 and 256, the plan's bm, blocks and waves); then
    PREFILL_SPLIT_SHAPE's rows at the ragged M, on split plans."""
    from uzu_tpu_torch.ops.cuda.flash_attention import num_sms
    from uzu_tpu_torch.ops.cuda.quant_matmul import QmmPlan, TILE_K, qmm_plan, quant_matmul

    gen = torch.Generator(device="cuda").manual_seed(23)
    sms = num_sms(torch.device("cuda"))
    sweep = []
    for wname, n, k in PREFILL_LINEAR_SHAPES:
        both = random_qweights(torch, gen, n, k, 4)
        w, wd = both["symmetric"]
        if wname in PREFILL_ROW_WEIGHTS:
            for m in sorted(PREFILL_M + PREFILL_RAGGED_M):
                qmm_row(torch, timer, rows, w, wd, wname, m, "symmetric", gen, PREFILL_TOL)
            qmm_row(torch, timer, rows, *both["stored_qbias"], wname, max(PREFILL_RAGGED_M),
                    "stored_qbias", gen, PREFILL_TOL)
        for m in PREFILL_M:
            x = torch.randn((m, k), device="cuda", generator=gen).to(torch.bfloat16)
            chunks = -(-k // TILE_K)
            entry = dict(weight=wname, N=n, K=k, M=m, plan_bm=qmm_plan(m, n, k, 4, sms).bm)
            for bm in (128, 256):
                plan = QmmPlan("tile", bm=bm, splits=1, chunks_per_split=chunks)
                blocks = -(-n // 128) * -(-m // bm)
                entry[f"bm{bm}"] = dict(
                    blocks=blocks, waves=blocks / sms,
                    device_ms=timer.ms(lambda: quant_matmul(w, x, plan), spin=True))
            sweep.append(entry)
        del both, w, wd
        torch.cuda.empty_cache()
    log("QMM_PREFILL_BM " + json.dumps(sweep))
    wname, n, k = PREFILL_SPLIT_SHAPE
    w, wd = random_qweights(torch, gen, n, k, 4)["symmetric"]
    for m in PREFILL_RAGGED_M:
        qmm_row(torch, timer, rows, w, wd, wname, m, "symmetric", gen, PREFILL_TOL)


def check_qmm_rows(torch, info: dict) -> None:
    """K1/K2's small-M route sums every row as the one-row product does: for
    M in ROW_CHECK_M each row of the product equals, bit for bit, the M=1
    product of that row (up|gate and a ragged shape, bits 4 and 8, both
    qbias forms)."""
    from uzu_tpu_torch.ops.cuda.quant_matmul import quant_matmul
    from uzu_tpu_torch.quant.format import QuantizedTensor

    gen = torch.Generator(device="cuda").manual_seed(2)
    out = []
    for bits in (4, 8):
        for n, k in ((16384, 2048), (300, 2880)):
            codes = torch.randint(0, 256, (n, k * bits // 8), dtype=torch.uint8, device="cuda",
                                  generator=gen)
            scales = (torch.rand((n, k // 32), device="cuda", generator=gen) * 0.01
                      + 0.001).to(torch.bfloat16)
            qbias = (torch.randn((n, k // 32), device="cuda", generator=gen) * 0.01
                     ).to(torch.bfloat16)
            for w in (QuantizedTensor(codes, scales, None, bits, 32, -float(1 << (bits - 1))),
                      QuantizedTensor(codes, scales, qbias, bits, 32)):
                x = torch.randn((max(ROW_CHECK_M), k), device="cuda", generator=gen
                                ).to(torch.bfloat16)
                ones = torch.cat([quant_matmul(w, x[i:i + 1]) for i in range(x.shape[0])])
                for m in ROW_CHECK_M:
                    same = bool(torch.equal(quant_matmul(w, x[:m]), ones[:m]))
                    out.append(dict(bits=bits, N=n, K=k, M=m, stored_qbias=w.qbias is not None,
                                    bitwise=same))
    info["qmm_rows"] = out
    log("QMM_ROWS " + json.dumps(out))
    bad = [r for r in out if not r["bitwise"]]
    if bad:
        raise AssertionError(f"rows of an M-row product differ from the M=1 rows: {bad}")


def template_usage(log_text: str, stem: str) -> dict:
    """ptxas's registers and spills of each instantiation of the kernels
    named `stem`_* ("qmm_tile<4, bf16, 2, 2, 4>", "grouped_small<f32, bf16,
    1>", ...) from a build log."""
    import re

    out = {}
    for dem, use in demangled_usage(log_text).items():
        m = re.search(rf"({stem}_\w+)(<[^>]*>)?", dem)
        if m:
            name = m[1] + (m[2] or "")
            out[name.replace("__nv_bfloat16", "bf16").replace("float", "f32")] = use
    return out


FLASH_VARIANTS = ("plain", "window", "softcap", "sinks")


def flash_kwargs(variant: str, sinks) -> dict:
    return {"plain": {}, "window": {"sliding_window_size": 512},
            "softcap": {"logit_soft_cap": 30.0}, "sinks": {"sinks": sinks}}[variant]


def demangled_usage(log_text: str) -> dict:
    """ptxas's registers and spills per kernel from a build log, keyed by the
    demangled name (the mangled one where c++filt is missing)."""
    from uzu_tpu_torch.ops.cuda.build import ptxas_usage

    usage = ptxas_usage(log_text)
    names = list(usage)
    try:
        plain = subprocess.run(["c++filt"], input="\n".join(names), capture_output=True,
                               text=True, check=True).stdout.splitlines()
    except (OSError, subprocess.CalledProcessError):
        plain = names
    return {dem: usage[name] for name, dem in zip(names, plain)}


def kernel_usage(log: str, kernel: str) -> dict:
    """ptxas's registers and spills of each `kernel<TQ, TKV, DH, WIDE>`
    (flash_fwd; "/wide" where WIDE) or `kernel<TQ, TKV, DH, EXACT, WIDE>`
    (paged_decode; "/rounded" where EXACT is false) and flash_combine
    instantiation ("bf16/int8/64", "bf16/bf16/64/rounded",
    "f32/f32/256/rounded/wide", "combine/64", ...) from a build log."""
    import re

    short = {"__nv_bfloat16": "bf16", "float": "f32", "signed char": "int8"}
    out = {}
    for dem, use in demangled_usage(log).items():
        m = re.search(kernel + r"<([^,]+), ([^,]+), (\d+)((?:, (?:true|false))*)>", dem)
        c = re.search(r"flash_combine<(\d+)(?:, (true|false))?>", dem)
        if m:
            key = "/".join((short.get(m[1], m[1]), short.get(m[2], m[2]), m[3]))
            flags = [f.strip() == "true" for f in m[4].split(",")[1:]]
            exact = flags[0] if kernel == "paged_decode" and flags else True
            wide = bool(flags) and flags[-1]
            out[key + ("" if exact else "/rounded") + ("/wide" if wide else "")] = use
        elif c:
            out["combine/" + c[1] + ("/wide" if c[2] == "true" else "")] = use
    return out


def flash_row(torch, timer, rows, usage, q, kc, vc, pos0: int, variant: str, kw: dict,
              library: bool = True) -> None:
    """One K3/K4 case (K4 where kw holds scales): the kernel against its
    plain version (err/RMS <= TOL), its time, the plain version's, masked
    SDPA over the same cache (dequantized, in q's type) as the yardstick
    where `library` and no sinks or soft cap, the bound, the split plan and
    the instantiation's registers and spills. The kernel and the yardstick
    are timed as every row is (`ms`, `library_ms`) and again with the
    timer's spin (`device_ms`, `library_device_ms`)."""
    import torch.nn.functional as F

    from uzu_tpu_torch.models.kv_cache import dequantize_rows
    from uzu_tpu_torch.ops.cuda.flash_attention import (
        flash_attention,
        flash_attention_plain,
        head_dim_instance,
        launch_split_plan,
    )

    s, h, dh = q.shape
    c, g, _ = kc.shape
    rep = h // g
    quant = "k_scales" in kw
    kernel = "flash_attention_int8" if quant else "flash_attention"
    qname = "bf16" if q.dtype == torch.bfloat16 else "f32"
    scale = dh ** -0.5
    qpos = torch.arange(s, device="cuda", dtype=torch.int32) + pos0
    got = flash_attention(q, kc, vc, qpos, scale=scale, **kw)
    want = flash_attention_plain(q, kc, vc, qpos, scale=scale, **kw)
    torch.cuda.synchronize()
    abs_err, err = rel_err(got, want)
    if not (err <= TOL):
        raise AssertionError(f"{kernel} S={s} H={h} Dh={dh} C={c} pos0={pos0} q {qname} "
                             f"{variant}: error {err:.3e} of RMS > {TOL}")
    # visible keys per query row: what this run's data needs
    window = kw.get("sliding_window_size")
    qp = pos0 + torch.arange(s)
    lo = (qp - window + 1).clamp(min=0) if window else torch.zeros_like(qp)
    visible = int((qp + 1 - lo).sum())
    kv_rows = int(qp[-1] + 1 - lo[0])
    # int8 codes + one f32 scale per (slot, group), for K and V
    row_bytes = g * (dh + 4) if quant else g * dh * kc.element_size()
    nbytes = q.numel() * q.element_size() + 2 * kv_rows * row_bytes + s * h * dh * 4
    b_ms, b_by = bound(nbytes, 4.0 * visible * h * dh)
    lib_ms = lib_dev_ms = None
    if library and "sinks" not in kw and "logit_soft_cap" not in kw:
        kpos = torch.arange(c, device="cuda")
        qpd = qpos.long()[:, None]
        mask = kpos[None, :] <= qpd
        if window:
            mask &= kpos[None, :] > qpd - window
        kt, vt = ((dequantize_rows(kc, kw["k_scales"]), dequantize_rows(vc, kw["v_scales"]))
                  if quant else (kc, vc))
        qt = q.transpose(0, 1)[None]
        kt = kt.to(q.dtype).transpose(0, 1)[None].repeat_interleave(rep, dim=1)
        vt = vt.to(q.dtype).transpose(0, 1)[None].repeat_interleave(rep, dim=1)
        lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
            qt, kt, vt, attn_mask=mask, scale=scale)
        lib_ms, lib_dev_ms = timer.both(lib)
        del kt, vt, lib
    splits, _ = launch_split_plan(s, h, g, c, dh,
                                  torch.cuda.get_device_properties(0).multi_processor_count)
    kv_name = "int8" if quant else qname
    run = lambda: flash_attention(q, kc, vc, qpos, scale=scale, **kw)  # noqa: E731
    ms, dev_ms = timer.both(run)
    inst = head_dim_instance(dh)
    row = dict(kernel=kernel, S=s, H=h, G=g, Dh=dh, C=c, pos0=pos0, q=qname, variant=variant,
               splits=splits, instance=inst,
               ptxas=usage.get(f"{qname}/{kv_name}/{inst}" + ("/wide" if dh > inst else "")),
               max_abs_err=abs_err, err_over_rms=err, tol=TOL,
               ms=ms, device_ms=dev_ms,
               plain_ms=timer.ms(lambda: flash_attention_plain(
                   q, kc, vc, qpos, scale=scale, **kw), 3),
               library_ms=lib_ms, library_device_ms=lib_dev_ms, bound_ms=b_ms, bound_by=b_by)
    rows.append(row)
    log("KERNEL " + json.dumps(row))


def check_flash_attention(torch, timer, rows, usage) -> None:
    """K3 at the flagship's heads (32 over 8 groups): S 16 and 256 over C
    1024 and 4096 at the end of the cache in every variant; the main path's
    first chunk (S=256 at pos0=0 over its 1024-slot context bucket); S=64
    at C=4096 (split route); Dh=128; f32 q, k and v."""
    gen = torch.Generator(device="cuda").manual_seed(2)
    h, g = 32, 8
    sinks = torch.randn((h,), device="cuda", generator=gen)

    def case(s, c, pos0, variants, dh=64, dtype=torch.bfloat16):
        q, kc, vc = (torch.randn(shape, device="cuda", generator=gen).to(dtype)
                     for shape in ((s, h, dh), (c, g, dh), (c, g, dh)))
        for variant in variants:
            flash_row(torch, timer, rows, usage, q, kc, vc, pos0, variant,
                      flash_kwargs(variant, sinks))

    for s in (16, 256):
        for c in (1024, 4096):
            case(s, c, c - s - 3, FLASH_VARIANTS)
    case(256, 1024, 0, ("plain",))
    case(64, 4096, 4096 - 67, ("plain", "window"))
    case(256, 1024, 765, ("plain", "sinks"), dh=128)
    case(16, 4096, 4096 - 19, ("plain", "sinks"), dh=128)
    case(256, 1024, 765, ("plain", "softcap"), dtype=torch.float32)


def check_flash_attention_int8(torch, timer, rows, usage) -> None:
    """K4 at the flagship's prefill shapes: S=256 over C 1024 and 4096 in
    every variant, the main path's first chunk, S=16 at C=4096 (split
    route), Dh=128, and f32 q."""
    from uzu_tpu_torch.models.kv_cache import quantize_rows

    gen = torch.Generator(device="cuda").manual_seed(4)
    h, g = 32, 8
    sinks = torch.randn((h,), device="cuda", generator=gen)

    def case(s, c, pos0, variants, dh=64, dtype=torch.bfloat16):
        q = torch.randn((s, h, dh), device="cuda", generator=gen).to(dtype)
        kq, ks = quantize_rows(torch.randn((c, g, dh), device="cuda", generator=gen))
        vq, vs = quantize_rows(torch.randn((c, g, dh), device="cuda", generator=gen))
        for variant in variants:
            flash_row(torch, timer, rows, usage, q, kq, vq, pos0, variant,
                      dict(flash_kwargs(variant, sinks), k_scales=ks, v_scales=vs))

    for c in (1024, 4096):
        case(256, c, c - 256 - 3, FLASH_VARIANTS)
    case(256, 1024, 0, ("plain",))
    case(16, 4096, 4096 - 19, ("plain", "sinks"))
    case(256, 1024, 765, ("plain",), dh=128)
    case(256, 1024, 765, ("plain",), dtype=torch.float32)


def paged_row(torch, timer, rows, usage, q, k, v, table, lengths, lens_name: str,
              variant: str, kw: dict, splits: int | None = None, distinct_live=None,
              library=None) -> None:
    """One K5/K6 case (K6 where kw holds scales): the kernel against its
    plain version (err/RMS <= TOL), its time, the plain version's, the
    bound, the split plan and the instantiation's registers and spills.
    With `splits`, the kernel takes that many splits in place of the plan's
    (1: one launch, no combine).
    The yardstick, where there are no sinks or soft cap: SDPA over the
    pre-gathered (for K6 also pre-dequantized) cache, the gather not timed;
    cut to the live tokens where every slot holds the same number and no
    window, else over the table's width with a boolean mask of each slot's
    [max(0, length - window), length). The kernel and the yardstick are
    timed as every row is (`ms`, `library_ms`) and again with the timer's
    spin (`device_ms`, `library_device_ms`). `distinct_live` (the tokens the
    rows' tables hold once each, where several rows share a table) sets the
    bytes of the bound in place of the rows' own lengths; `library`
    replaces the yardstick."""
    from unittest import mock

    import torch.nn.functional as F

    from uzu_tpu_torch.models.kv_cache import dequantize_rows
    from uzu_tpu_torch.ops.cuda import paged_attention as pa
    from uzu_tpu_torch.ops.cuda.paged_attention import (
        head_dim_instance,
        launch_split_plan,
        paged_attention_plain,
        paged_decode_attention,
    )

    b, h, dh = q.shape
    g, _, page, _ = k.shape
    maxp = table.shape[1]
    quant = "k_scales" in kw
    kernel = "paged_attention_int8" if quant else "paged_attention"
    qname = "bf16" if q.dtype == torch.bfloat16 else "f32"
    kw = dict(kw, scale=dh ** -0.5)
    plan = launch_split_plan(b, g, maxp * page, dh,
                             torch.cuda.get_device_properties(0).multi_processor_count)

    def run():
        return paged_decode_attention(q, k, v, table, lengths, **kw)

    if splits is not None:
        tiles = -(-maxp * page // pa.TILE)
        plan = (splits, -(-tiles // splits))
        forced = run

        def run():
            with mock.patch.object(pa, "paged_split_plan", lambda *_: plan):
                return forced()

    got = run()
    want = paged_attention_plain(q, k, v, table, lengths, **kw)
    torch.cuda.synchronize()
    abs_err, err = rel_err(got, want)
    if not (err <= TOL):
        raise AssertionError(f"{kernel} page={page} H={h} q {qname} {lens_name} {variant}: "
                             f"error {err:.3e} of RMS > {TOL}")
    lens = lengths.tolist()
    window = kw.get("sliding_window_size")
    live = sum(max(0, min(n, maxp * page) - (max(0, n - window) if window else 0))
               for n in lens)
    # each live token's K and V rows once (int8: codes + one f32 scale per
    # (token, group)), q, the output, the table and lengths
    per_tok = g * (dh + 4) * 2 if quant else g * dh * k.element_size() * 2
    read = live if distinct_live is None else distinct_live
    nbytes = (q.numel() * q.element_size() + read * per_tok + b * h * dh * 4
              + table.numel() * 4 + b * 4)
    b_ms, b_by = bound(nbytes, 4.0 * live * h * dh)
    lib_ms = lib_dev_ms = None
    if library is not None:
        lib_ms, lib_dev_ms = timer.both(library)
    elif "sinks" not in kw and "logit_soft_cap" not in kw:
        uniform = len(set(lens)) == 1 and not window
        n = lens[0] if uniform else maxp * page

        def gathered(pool, sc):
            t = pool[:, table.long()].transpose(0, 1).reshape(b, g, -1, dh)
            if sc is not None:
                s_ = sc[:, table.long()].transpose(0, 1).reshape(b, g, -1)
                t = dequantize_rows(t, s_).to(q.dtype)
            return t[:, :, :n].contiguous()

        kt = gathered(k, kw.get("k_scales"))
        vt = gathered(v, kw.get("v_scales"))
        qt = q[:, :, None, :]
        mask = None
        if not uniform:
            pos = torch.arange(n, device="cuda")[None, :]
            length = lengths.long()[:, None]
            keep = pos < length
            if window:
                keep &= pos >= length - window
            mask = keep[:, None, None, :]
        lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
            qt, kt, vt, attn_mask=mask, scale=kw["scale"], enable_gqa=True)
        lib_ms, lib_dev_ms = timer.both(lib)
        del kt, vt, mask, lib
    splits, per = plan
    kv_name = "int8" if quant else qname
    ms, dev_ms = timer.both(run)
    inst = head_dim_instance(dh)
    row = dict(kernel=kernel, B=b, H=h, G=g, Dh=dh, page=page, width=maxp * page, q=qname,
               lengths=lens_name, variant=variant, live_tokens=live,
               distinct_live_tokens=read, splits=splits,
               tiles_per_split=per, instance=inst,
               ptxas=usage.get(f"{qname}/{kv_name}/{inst}" + ("/rounded" if dh != inst else "")
                               + ("/wide" if dh > inst else "")),
               max_abs_err=abs_err, err_over_rms=err, tol=TOL,
               ms=ms, device_ms=dev_ms,
               plain_ms=timer.ms(lambda: paged_attention_plain(
                   q, k, v, table, lengths, **kw), 3),
               library_ms=lib_ms, library_device_ms=lib_dev_ms, bound_ms=b_ms, bound_by=b_by)
    rows.append(row)
    log("KERNEL " + json.dumps(row))


PAGED_VARIANTS = ("plain", "window", "softcap", "sinks")


def check_paged_attention(torch, timer, rows, usage) -> None:
    """K5 (bf16 pools) and K6 (INT8 pools) against their plain version:
    8 slots of the flagship's heads, pages of 16 to 512 tokens, 8 x 1024
    live tokens (the timed main shape, with the yardstick) and ragged
    lengths up to 4096 with a repeated physical page list (a shared
    prefix), in every variant; the table the paged engine builds for 8
    slots of 1000 tokens at 512-token pages (its 1024-token context
    bucket's 2 pages and a trash column: 1536 tokens wide); at those two
    uniform shapes also with one split (one launch, no combine) beside the
    plan's; K5 with f32 q and pools; Dh 128."""
    from uzu_tpu_torch.models.kv_cache import quantize_rows

    gen = torch.Generator(device="cuda").manual_seed(5)
    b, h, g = 8, 32, 8
    sinks = torch.randn((h,), device="cuda", generator=gen)

    def case(page, variants, dh=64, dtype=torch.bfloat16, quants=(False, True),
             engine=False):
        maxp = 4096 // page
        p_total = b * maxp + 1
        k = torch.randn((g, p_total, page, dh), device="cuda", generator=gen).to(dtype)
        v = torch.randn((g, p_total, page, dh), device="cuda", generator=gen).to(dtype)
        kq, ks = quantize_rows(k)
        vq, vs = quantize_rows(v)
        table = torch.randperm(p_total - 1, device="cuda", generator=gen)[: b * maxp]
        table = table.reshape(b, maxp).to(torch.int32)
        table[3] = table[0]
        q = torch.randn((b, h, dh), device="cuda", generator=gen).to(dtype)
        lens_cases = {"uniform1024": ([1024] * b, table),
                      "ragged": ([1, page, 777, 1024, 4096, 2 * page + 1, 3000, 4095], table)}
        if engine:
            lens_cases["uniform1000"] = ([1000] * b, table[:, :3].contiguous())
        for lens_name, (lens, tbl) in lens_cases.items():
            lengths = torch.tensor(lens, device="cuda", dtype=torch.int32)
            uniform = lens_name != "ragged"
            uniform_variants = ("plain", "one_split") if engine else ("plain",)
            for variant in (uniform_variants if uniform else variants):
                for quant in quants:
                    kw = {"plain": {}, "one_split": {}, "window": {"sliding_window_size": 512},
                          "softcap": {"logit_soft_cap": 30.0},
                          "sinks": {"sinks": sinks}}[variant]
                    if quant:
                        kw = dict(kw, k_scales=ks, v_scales=vs)
                    paged_row(torch, timer, rows, usage, q, kq if quant else k,
                              vq if quant else v, tbl, lengths, lens_name, variant, kw,
                              splits=1 if variant == "one_split" else None)
        del k, v, kq, vq, ks, vs

    for page in (16, 64, 256):
        case(page, PAGED_VARIANTS)
    case(512, PAGED_VARIANTS, engine=True)
    case(512, ("plain", "sinks"), dh=128)
    case(512, ("plain", "softcap"), dtype=torch.float32, quants=(False,))


def _routing(torch, gen, tokens: int, experts: int, active: int):
    """[tokens, active] distinct experts per token, as a router picks them."""
    return torch.stack([torch.randperm(experts, device="cuda", generator=gen)[:active]
                        for _ in range(tokens)])


def _random_stack(torch, gen, e: int, n: int, k: int, bits: int, g: int = 32):
    from uzu_tpu_torch.quant.format import StackedQuantized

    codes = torch.randint(0, 256, (e, n, k * bits // 8), dtype=torch.uint8, device="cuda",
                          generator=gen)
    scales = (torch.rand((e, n, k // g), device="cuda", generator=gen) * 0.01
              + 0.001).to(torch.bfloat16)
    return StackedQuantized(codes, scales, bits, g, -float(1 << (bits - 1)))


def check_moe_gemv(torch, timer, rows, sweep: bool = False, e: int = GPTOSS["num_experts"],
                   active: int = GPTOSS["num_active"], shapes=EXPERT_SHAPES, ps=(4, 32),
                   bits_list=(4, 8), seed: int = 7) -> None:
    """K7 (INT4) and K8 (INT8) at gpt-oss's expert shapes: P = 4 pairs (one
    token's 4 experts: single-stream decode) and P = 32 (8 slots), through
    the wrapper the main path calls, each row with the `moe_gemv_plan` it
    launched. With `sweep`, the P = 4 rows also time the launch with the
    planes left in L2 by the one before, the plan's dealing at every kw,
    and the plan against contiguous ranges of ceil(items / 2 SMs) items, in
    turns (device ms). `e`, `active`, `shapes`, `ps` and `bits_list` give
    another model's stacks (e experts of which `active` route a token)."""
    from uzu_tpu_torch.ops.cuda import moe_gemv as mg
    from uzu_tpu_torch.ops.cuda.flash_attention import num_sms
    from uzu_tpu_torch.quant.format import dequantize_stacked

    gen = torch.Generator(device="cuda").manual_seed(seed)
    sms = num_sms(torch.device("cuda"))
    for bits in bits_list:
        for wname, n, k in shapes:
            sq = _random_stack(torch, gen, e, n, k, bits)
            plane_bytes = (sq.codes[0].numel() + sq.scales[0].numel() * 2)
            for p in ps:
                ids = _routing(torch, gen, p // active, e, active).reshape(-1)
                x = torch.randn((p, k), device="cuda", generator=gen)
                plan = mg.moe_gemv_plan(p, n, k, bits, sms)
                got = mg.moe_expert_gemv(sq, x, ids)
                want = mg.moe_expert_gemv_plain(sq, x, ids)
                torch.cuda.synchronize()
                abs_err, err = rel_err(got, want)
                name = f"moe_gemv_int{bits}"
                if not (err <= TOL):
                    raise AssertionError(f"{name} {wname} P={p} {plan}: error {err:.3e} of "
                                         f"RMS > {TOL}")
                distinct = len(set(ids.tolist()))
                nbytes = distinct * plane_bytes + p * k * 4 + p * 4 + p * n * 4
                b_ms, b_by = bound(nbytes, 2.0 * p * n * k)
                # yardstick: one bmm over the pairs' pre-gathered, pre-dequantized
                # bf16 planes (the gather not timed)
                wg = dequantize_stacked(mg.gather_experts(sq, ids), torch.bfloat16)
                xb = x.to(torch.bfloat16)[:, None, :]
                ms, dev_ms = timer.both(lambda: mg.moe_expert_gemv(sq, x, ids))
                lib_ms, lib_dev_ms = timer.both(lambda: torch.bmm(xb, wg.transpose(1, 2)))
                row = dict(kernel=name, weight=wname, N=n, K=k, E=e, P=p,
                           distinct_experts=distinct, plan=plan._asdict(), kw=plan.kw,
                           items=plan.items, blocks=plan.blocks,
                           max_abs_err=abs_err, err_over_rms=err,
                           tol=TOL, ms=ms, device_ms=dev_ms,
                           plain_ms=timer.ms(lambda: mg.moe_expert_gemv_plain(sq, x, ids), 3),
                           library_ms=lib_ms, library_device_ms=lib_dev_ms,
                           bound_ms=b_ms, bound_by=b_by)
                if sweep and p == 4:
                    def at(pl):
                        return functools.partial(mg.launch_moe_gemv, sq, x, ids, pl)
                    row["warm_l2_device_ms"] = timer.ms(at(plan), spin=True, flush=False)
                    row["kw_device_ms"] = {
                        kw: timer.ms(at(mg.plan_at_kw(p, n, kw, sms)), spin=True)
                        for kw in (1, 2, 4, 8)}
                    b = min(plan.items, 2 * sms)
                    even = plan._replace(blocks=b, first=b, per_first=-(-plan.items // b),
                                         per_second=0)
                    turns = row["deal_device_ms"] = {"paired": [], "contiguous": []}
                    for pl in (plan, even, even, plan):  # in turns: A, B, B, A
                        turns["paired" if pl is plan else "contiguous"].append(
                            timer.ms(at(pl), spin=True))
                rows.append(row)
                log("KERNEL " + json.dumps(row))
                del wg


def check_moe_rows(torch, info: dict) -> None:
    """K7/K8 sum each pair's row on its own: (a) at P = 4 and 16 each row
    equals, bit for bit, a one-pair launch of that pair (bits 4 and 8, up
    and down); (b) an INT4 row of K7 equals K9's small-route row of the same
    x row and expert (`grouped_matmul_quant` at bm 8 over `route_layout` of
    the same pairs, distinct experts: one row per tile)."""
    from uzu_tpu_torch.ops.cuda.grouped_matmul import grouped_matmul_quant, route_layout
    from uzu_tpu_torch.ops.cuda.moe_gemv import moe_expert_gemv

    gen = torch.Generator(device="cuda").manual_seed(11)
    e = GPTOSS["num_experts"]
    out = []
    for bits in (4, 8):
        for wname, n, k in EXPERT_SHAPES:
            sq = _random_stack(torch, gen, e, n, k, bits)
            for p in (4, 16):
                ids = torch.randperm(e, device="cuda", generator=gen)[:p]
                x = torch.randn((p, k), device="cuda", generator=gen)
                got = moe_expert_gemv(sq, x, ids)
                ones = torch.cat([moe_expert_gemv(sq, x[i:i + 1], ids[i:i + 1])
                                  for i in range(p)])
                row = dict(bits=bits, weight=wname, N=n, K=k, P=p,
                           bitwise_one_pair=bool(torch.equal(got, ones)))
                if bits == 4:
                    order, dst, te, used, _ = route_layout(ids, e, 8)
                    x_pad = torch.zeros((te.shape[0] * 8, k), device="cuda")
                    x_pad[dst] = x[order]
                    k9 = torch.empty_like(got)
                    k9[order] = grouped_matmul_quant(x_pad, sq, te, used)[dst]
                    row["bitwise_k9_bm8"] = bool(torch.equal(got, k9))
                out.append(row)
    info["moe_rows"] = out
    log("MOE_ROWS " + json.dumps(out))
    bad = [r for r in out if not all(v for key, v in r.items() if key.startswith("bitwise"))]
    if bad:
        raise AssertionError(f"K7/K8 rows depend on the other pairs or differ from K9's: {bad}")


# K9's rows: (T routed rows, bm) at the plan's layout of S = T / 4 rows (the
# paged step of 8 slots, the 16- and 32-row small chunks, the 64-, 256- and
# 1024-row prefill chunks), and T = 32 at bm 64, PR 3-7's layout of the
# paged step; K10's: the same prefill chunks at bm 64. Each T's routing and
# rows are drawn once and laid out at every bm of that T.
GROUPED_Q_CASES = ((32, 64), (32, 8), (64, 16), (128, 32), (256, 64), (1024, 64), (4096, 64))
GROUPED_DENSE_CASES = ((256, 64), (1024, 64), (4096, 64))


def check_grouped_matmul(torch, timer, rows, sweep: bool = False, cases=None,
                         e: int = GPTOSS["num_experts"], active: int = GPTOSS["num_active"],
                         shapes=EXPERT_SHAPES, seed: int = 8) -> None:
    """K9 over INT4 stacks and K10 over dense bf16 stacks at gpt-oss's
    expert shapes, at the routed rows of GROUPED_Q_CASES /
    GROUPED_DENSE_CASES, through the wrappers the main path calls, each row
    with the launch plan the wrapper launched (held to `launch_plan` of the
    layout's shapes). With `sweep`, tile rows also time every BN the route
    offers and small rows every kw (device ms). The yardstick is one bmm
    over the used tiles' pre-gathered bf16 planes and rows, at the same
    layout. Only the real rows are compared (rows of unused tiles are
    undefined). `cases` ([(kernel, T, bm)]) replaces the two lists; `e`,
    `active` and `shapes` give another model's stacks."""
    from uzu_tpu_torch.ops.cuda import grouped_matmul as gm
    from uzu_tpu_torch.ops.cuda.flash_attention import num_sms
    from uzu_tpu_torch.ops.cuda.moe_gemv import gather_experts
    from uzu_tpu_torch.quant.format import dequantize_stacked

    gen = torch.Generator(device="cuda").manual_seed(seed)
    sms = num_sms(torch.device("cuda"))
    if cases is None:
        cases = [("grouped_matmul_int4", t, bm) for t, bm in GROUPED_Q_CASES] + \
            [("grouped_matmul", t, bm) for t, bm in GROUPED_DENSE_CASES]
    routes = {t: _routing(torch, gen, t // active, e, active).reshape(-1)
              for t in sorted({t for _, t, _ in cases})}
    launched = []

    def spied(real):
        def launch(*args):
            launched.append(args[-1])
            return real(*args)
        return launch

    real_q, real_d = gm.launch_grouped_quant, gm.launch_grouped
    for wname, n, k in shapes:
        sq = _random_stack(torch, gen, e, n, k, 4)
        dense = dequantize_stacked(_random_stack(torch, gen, e, n, k, 8), torch.bfloat16)
        xs = {t: torch.randn((t, k), device="cuda", generator=gen) for t in routes}
        for name, t, bm in cases:
            quant = name == "grouped_matmul_int4"
            flat = routes[t]
            order, dst, te, used, _ = gm.route_layout(flat, e, bm)
            row_dtype = torch.float32 if quant else torch.bfloat16
            x_pad = torch.zeros((te.shape[0] * bm, k), dtype=row_dtype, device="cuda")
            x_pad[dst] = xs[t].to(row_dtype)
            plan = gm.launch_plan(te.shape[0], bm, e, n, k, 4 if quant else 16, sms)
            if quant:
                def run():
                    return gm.grouped_matmul_quant(x_pad, sq, te, used)

                def run_plan(p):
                    return real_q(x_pad, sq, te, used, p)

                def plain():
                    return gm.grouped_matmul_quant_plain(x_pad, sq, te, used, bm)
            else:
                def run():
                    return gm.grouped_matmul(x_pad, dense, te, used)

                def run_plan(p):
                    return real_d(x_pad, dense, te, used, p)

                def plain():
                    return gm.grouped_matmul_plain(x_pad, dense, te, used, bm)
            launched.clear()
            gm.launch_grouped_quant, gm.launch_grouped = spied(real_q), spied(real_d)
            try:
                got = run()
            finally:
                gm.launch_grouped_quant, gm.launch_grouped = real_q, real_d
            if launched != [plan]:
                raise AssertionError(f"{name} {wname} T={t} bm={bm}: the wrapper launched "
                                     f"{launched}, not launch_plan's {plan}")
            want = plain()
            torch.cuda.synchronize()
            abs_err, err = rel_err(got[dst], want[dst])
            if not (err <= TOL):
                raise AssertionError(f"{name} {wname} T={t} bm={bm} {plan}: error {err:.3e} "
                                     f"of RMS > {TOL}")
            n_used = int(used[0])
            distinct = len(set(flat.tolist()))
            plane = (sq.codes[0].numel() + sq.scales[0].numel() * 2) if quant \
                else dense[0].numel() * 2
            nbytes = distinct * plane + t * k * x_pad.element_size() + t * n * 4
            b_ms, b_by = bound(nbytes, 2.0 * t * n * k)
            # yardstick: one bmm over the used tiles' pre-gathered bf16 planes
            tiles = te[:n_used]
            wt = (dequantize_stacked(gather_experts(sq, tiles), torch.bfloat16) if quant
                  else dense[tiles.long()])
            xt = x_pad[: n_used * bm].to(torch.bfloat16).reshape(n_used, bm, k)
            ms, dev_ms = timer.both(run)
            lib_ms, lib_dev_ms = timer.both(lambda: torch.bmm(xt, wt.transpose(1, 2)))
            row = dict(kernel=name, weight=wname, N=n, K=k, E=e, T=t, bm=bm, Tp=x_pad.shape[0],
                       route=plan.route, kw=plan.kw, bn=plan.bn, used_tiles=n_used,
                       distinct_experts=distinct, max_abs_err=abs_err,
                       err_over_rms=err, tol=TOL, ms=ms, device_ms=dev_ms,
                       plain_ms=timer.ms(plain, 3), library_ms=lib_ms,
                       library_device_ms=lib_dev_ms, bound_ms=b_ms, bound_by=b_by)
            if sweep and plan.route == "tile":  # every BN of the route, the plan's included
                row["bn_device_ms"] = {
                    bn: timer.ms(functools.partial(run_plan, plan._replace(bn=bn)), spin=True)
                    for bn in gm.TILE_BNS[4 if quant else 16]}
            elif sweep:
                row["kw_device_ms"] = {
                    kw: timer.ms(functools.partial(run_plan, plan._replace(kw=kw)), spin=True)
                    for kw in (1, 2, 4, 8)}
            rows.append(row)
            log("KERNEL " + json.dumps(row))
            del wt, xt
        del dense


def check_grouped_rows(torch, info: dict) -> None:
    """K9's small route sums each routed row on its own: at bm = 8, the
    output of each of a token's 4 routed rows is bitwise the same in the
    layout of 8 tokens (expert 3 taken by all 8, so its tile holds 8 rows)
    as in the layout of that token alone (each tile 1 row); up and down."""
    from uzu_tpu_torch.ops.cuda.grouped_matmul import grouped_matmul_quant, route_layout

    gen = torch.Generator(device="cuda").manual_seed(10)
    e, active, bm = GPTOSS["num_experts"], GPTOSS["num_active"], 8
    out = []
    for wname, n, k in EXPERT_SHAPES:
        sq = _random_stack(torch, gen, e, n, k, 4)
        others = torch.stack([3 + 1 + torch.randperm(e - 1, device="cuda", generator=gen)
                              [:active - 1] for _ in range(8)]) % e
        ids = torch.cat([torch.full((8, 1), 3, device="cuda"), others], 1)
        x = torch.randn((8, k), device="cuda", generator=gen)

        def routed(tok):  # K9 over the tokens' layout -> [tokens, active, N]
            order, dst, te, used, _ = route_layout(ids[tok].reshape(-1), e, bm)
            x_pad = torch.zeros((te.shape[0] * bm, k), device="cuda")
            x_pad[dst] = x[tok][order // active]
            row_of_pair = torch.empty_like(dst)
            row_of_pair[order] = dst
            return grouped_matmul_quant(x_pad, sq, te, used)[row_of_pair].reshape(
                len(tok), active, n)

        together = routed(list(range(8)))
        alone = torch.cat([routed([j]) for j in range(8)])
        out.append(dict(weight=wname, N=n, K=k, bm=bm, rows_in_expert3_tile=8,
                        bitwise=bool(torch.equal(together, alone))))
    info["grouped_rows"] = out
    log("GROUPED_ROWS " + json.dumps(out))
    bad = [r for r in out if not r["bitwise"]]
    if bad:
        raise AssertionError(f"K9 rows at bm 8 depend on the other rows of their tile: {bad}")


GPTOSS_K3_CASES = ((16, 1024, ("gptoss_window_sinks", "gptoss_sinks")),
                   (256, 1024, ("gptoss_window_sinks", "gptoss_sinks")),
                   (16, 4096, ("gptoss_sinks", "plain")))


def gptoss_attention_inputs(torch):
    """The seeded inputs of the rows at gpt-oss's heads: (generator, sinks,
    [(S, C, variants, q, k, v)] of K3's cases), drawn in one order, so that
    K5's rows, which draw next from the same generator, see the same data
    whether or not K3's rows run."""
    gen = torch.Generator(device="cuda").manual_seed(9)
    h, g, dh = GPTOSS["num_heads"], GPTOSS["num_groups"], GPTOSS["head_dim"]
    sinks = torch.randn((h,), device="cuda", generator=gen)
    cases = [(s, c, variants, *(torch.randn(shape, device="cuda", generator=gen)
                                .to(torch.bfloat16)
                                for shape in ((s, h, dh), (c, g, dh), (c, g, dh))))
             for s, c, variants in GPTOSS_K3_CASES]
    return gen, sinks, cases


def check_attention_gptoss(torch, timer, rows, usage) -> None:
    """K3 at gpt-oss's heads: 64 query heads over 8 KV groups (8 per group),
    Dh 64, its sliding window of 128 with sinks, and sinks alone (the
    full-attention layers); also at S=16 over C=4096 (split route), with a
    yardstick in its plain variant."""
    win = GPTOSS["sliding_window"]
    _, sinks, cases = gptoss_attention_inputs(torch)
    for s, c, variants, q, kc, vc in cases:
        for variant in variants:
            kw = {"gptoss_window_sinks": dict(sliding_window_size=win, sinks=sinks),
                  "gptoss_sinks": dict(sinks=sinks), "plain": {}}[variant]
            flash_row(torch, timer, rows, usage, q, kc, vc, c - s - 3, variant, kw)


def check_flash_hybrid(torch, timer, rows, usage) -> None:
    """K3/K4 at the hybrid's attention heads (8 query heads over 2 KV
    groups, Dh 32: the 64-byte-swizzled instantiation): its first prefill
    chunk (S=128 from position 0 over a 1024-slot context) and a later one
    at the end of the cache in every variant, a 16-row chunk over 4096
    slots (split route), and f32 q."""
    from uzu_tpu_torch.models.kv_cache import quantize_rows

    gen = torch.Generator(device="cuda").manual_seed(12)
    h, g, dh = HYBRID_ATTN["num_heads"], HYBRID_ATTN["num_groups"], HYBRID_ATTN["head_dim"]
    sinks = torch.randn((h,), device="cuda", generator=gen)

    def case(s, c, pos0, variants, dtype=torch.bfloat16, quant=False):
        q, kc, vc = (torch.randn(shape, device="cuda", generator=gen).to(dtype)
                     for shape in ((s, h, dh), (c, g, dh), (c, g, dh)))
        scales = {}
        if quant:
            (kc, ks), (vc, vs) = quantize_rows(kc.float()), quantize_rows(vc.float())
            scales = dict(k_scales=ks, v_scales=vs)
        for variant in variants:
            flash_row(torch, timer, rows, usage, q, kc, vc, pos0, variant,
                      dict(flash_kwargs(variant, sinks), **scales))

    for quant in (False, True):
        case(128, 1024, 0, ("plain",), quant=quant)
        case(256, 1024, 765, FLASH_VARIANTS, quant=quant)
        case(16, 4096, 4096 - 19, ("plain", "sinks"), quant=quant)
        case(128, 1024, 0, ("plain",), dtype=torch.float32, quant=quant)


# device ms of K3b's former CUDA-core kernels at its first four rows, by
# (q, variant): constants from PERF.md section 6 (NVIDIA H100 80GB HBM3,
# 700.00 W), printed beside each row's reading and never measured here
K3B_CUDA_CORE_DEVICE_MS = {("f32", "train"): 0.3390, ("bf16", "plain"): 0.7674,
                           ("f32", "plain"): 0.7705, ("bf16", "window"): 0.4915}
# K3b's own limit beside TOL, max |kernel - plain| over RMS(plain): about 5x
# its readings (<= 2.04e-4) and under the 1.9e-2 a kernel that rounds dO, P
# and dS to bf16 once reads (tests/test_torch_flash_bwd.py), so a kernel
# that lost the lo halves of its pairs fails
K3B_TOL = 1e-3
LSE_TOL = 1e-4  # K3's L against flash_attention_lse_plain, absolute (natural log)
# the spin before K3b's and SDPA's backward device times: ~4 ms, past the
# host's time to enqueue autograd's SDPA backward (up to ~1.3 ms), which
# Timer's ~0.1 ms spin let into that device time
BWD_SPIN = 8_000_000


def flash_bwd_row(torch, timer, rows, q, kc, vc, pos0: int, window, variant: str,
                  breakdown: bool = False) -> None:
    """One K3b case: dQ, dK and dV against `flash_attention_bwd_plain` from
    the same K3 output and dO (each err/RMS <= TOL and <= K3B_TOL; K3b
    without L, so one K3 launch asks for it), a second launch given K3's L
    bitwise the first,
    its time (given L: K3b alone, as the trainer's backward runs it), the
    plain version's, the yardstick (SDPA's backward over the visible keys,
    is_causal where the queries start at position 0, else the same mask
    given explicitly; enable_gqa), and the bound: the five products' FLOPs
    of the visible (query, key) pairs over the bf16 tensor-core peak, as
    every kernel row (whatever hi + lo products the kernel takes for f32),
    against the bytes read and written once. With `breakdown`, each of
    K3b's launches' device ms from a profiler trace."""
    import torch.nn.functional as F

    from uzu_tpu_torch.ops.cuda.flash_attention import (
        _launch,
        bwd_parts,
        flash_attention_bwd,
        flash_attention_bwd_plain,
    )

    t_row = time.perf_counter()
    s, h, dh = q.shape
    c, g, _ = kc.shape
    scale = dh ** -0.5
    qname = "bf16" if q.dtype == torch.bfloat16 else "f32"
    qpos = torch.arange(s, device="cuda", dtype=torch.int32) + pos0
    gen = torch.Generator(device="cuda").manual_seed(7)
    d_out = torch.randn((s, h, dh), device="cuda", generator=gen)
    lse = torch.empty((s, h), device="cuda")
    out = _launch(q, kc, vc, qpos, scale=scale, sliding_window_size=window, lse=lse)

    def run():
        return flash_attention_bwd(q, kc, vc, qpos, out, d_out, scale=scale,
                                   sliding_window_size=window, lse=lse)

    got = flash_attention_bwd(q, kc, vc, qpos, out, d_out, scale=scale,
                              sliding_window_size=window)
    again = run()
    want = flash_attention_bwd_plain(q, kc, vc, qpos, out, d_out, scale=scale,
                                     sliding_window_size=window)
    torch.cuda.synchronize()
    errs = {name: rel_err(a, b) for name, a, b in zip(("dq", "dk", "dv"), got, want)}
    worst = max(e for _, e in errs.values())
    where = (f"flash_attention_bwd S={s} H={h} G={g} Dh={dh} C={c} pos0={pos0} q {qname} "
             f"{variant}")
    if not worst <= TOL:
        raise AssertionError(f"{where}: error {errs} of RMS > {TOL}")
    if not worst <= K3B_TOL:
        raise AssertionError(f"{where}: error {errs} of RMS > K3b's {K3B_TOL}")
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise AssertionError(f"{where}: two launches on the same inputs differ")
    # the work this run's data needs: (query row, key) pairs each head sees
    qp = pos0 + torch.arange(s)
    lo = (qp - window + 1).clamp(min=0) if window else torch.zeros_like(qp)
    visible = int((qp + 1 - lo).sum())
    kv_rows = int(qp[-1] + 1 - lo[0])
    esz = q.element_size()
    nbytes = (q.numel() * esz + 2 * kv_rows * g * dh * esz  # q, k and v read
              + 2 * s * h * dh * 4 + s * h * 4  # O, dO and L read
              + s * h * dh * 4 + 2 * c * g * dh * 4)  # dQ, dK and dV written
    flops = 10.0 * visible * h * dh  # S, dP, dV, dQ, dK: 2 Dh each
    b_ms, b_by = bound(nbytes, flops)
    end = int(qp[-1]) + 1
    qt = q.detach().transpose(0, 1)[None].clone().requires_grad_(True)
    kt = kc[:end].transpose(0, 1)[None].clone().requires_grad_(True)
    vt = vc[:end].transpose(0, 1)[None].clone().requires_grad_(True)
    if pos0 == 0 and not window and end == s:
        o = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, scale=scale,
                                           enable_gqa=True)
    else:
        kpos = torch.arange(end, device="cuda")
        mask = kpos[None, :] <= qpos.long()[:, None]
        if window:
            mask &= kpos[None, :] > qpos.long()[:, None] - window
        o = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask, scale=scale,
                                           enable_gqa=True)
    go = d_out.transpose(0, 1)[None].to(o.dtype)
    lib_ms, lib_dev_ms = timer.both(
        lambda: torch.autograd.grad(o, (qt, kt, vt), go, retain_graph=True), BWD_SPIN)
    del o, qt, kt, vt
    ms, dev_ms = timer.both(run, BWD_SPIN)
    row = dict(kernel="flash_attention_bwd", S=s, H=h, G=g, Dh=dh, C=c, pos0=pos0, q=qname,
               kernel_device_ms=(launch_device_ms(torch, run, f"k3b_{qname}_{variant}")
                                 if breakdown else None),
               variant=variant, window=window,
               parts=bwd_parts(s, h, g, c, dh, torch.cuda.get_device_properties(0)
                               .multi_processor_count, qname == "f32"),
               bitwise_repeat=True,
               err_over_rms_by_grad={k: e for k, (_, e) in errs.items()},
               max_abs_err_by_grad={k: a for k, (a, _) in errs.items()},
               max_abs_err=max(a for a, _ in errs.values()), err_over_rms=worst, tol=TOL,
               k3b_tol=K3B_TOL, ms=ms, device_ms=dev_ms,
               cuda_core_device_ms=(K3B_CUDA_CORE_DEVICE_MS.get((qname, variant))
                                    if dh == 64 else None),
               cuda_core_from="PERF.md section 6, a constant",
               plain_ms=timer.ms(lambda: flash_attention_bwd_plain(
                   q, kc, vc, qpos, out, d_out, scale=scale, sliding_window_size=window), 3),
               library_ms=lib_ms, library_device_ms=lib_dev_ms,
               below_library=dev_ms < lib_dev_ms, bound_ms=b_ms, bound_by=b_by,
               flops=flops, bytes=nbytes)
    row["seconds"] = time.perf_counter() - t_row
    rows.append(row)
    log("KERNEL " + json.dumps(row))


def launch_device_ms(torch, fn, name: str, reps: int = 5) -> dict | None:
    """{kernel: mean device ms a call} of the kernels `fn` launches, from a
    profiler trace of `reps` calls (.port_cache/traces_k3b/<name>.json);
    None where the trace holds no device event twice."""
    import re

    out_dir = os.path.join(REPO, ".port_cache", "traces_k3b")
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, name + ".json")
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    fn()
    torch.cuda.synchronize()
    for _ in range(2):
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        prof.export_chrome_trace(path)
        with open(path) as f:
            kernels = [e for e in json.load(f)["traceEvents"]
                       if e.get("cat") == "kernel" and "dur" in e]
        if kernels:
            break
    else:
        return None
    out: dict = {}
    for e in kernels:
        m = re.search(r"(flash_\w+)", e["name"])
        key = m[1] if m else e["name"]
        out[key] = out.get(key, 0.0) + e["dur"] / 1e3 / reps
    return out


def check_bwd_plan(info: dict) -> None:
    """The wrapper's `bwd_plan` against the kernel's own (csrc `Plan`, from
    `uz_flash_attention_bwd_plan`) at every instantiation, bf16 and f32:
    streamed tile, dK/dV column slices and blocks per SM equal, and both
    launches' blocks within 227 KB of shared memory."""
    import ctypes

    from uzu_tpu_torch.ops.cuda.build import library
    from uzu_tpu_torch.ops.cuda.flash_attention import bwd_plan

    fn = library("flash_attention_bwd").uz_flash_attention_bwd_plan
    fn.argtypes, fn.restype = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p], ctypes.c_int
    readings = []
    for dh in (32, 64, 128, 256):
        for f32 in (False, True):
            got = (ctypes.c_int * 5)()
            if fn(dh, int(not f32), got) != 0:
                raise AssertionError(f"K3b plan: no instantiation for Dh {dh}")
            tile, slices, per_sm, dq_smem, kv_smem = got
            readings.append(dict(Dh=dh, f32=f32, tile=tile, dkdv_slices=slices,
                                 blocks_per_sm=per_sm, dq_smem=dq_smem, dkdv_smem=kv_smem))
            if (tile, slices, per_sm) != tuple(bwd_plan(dh, f32)) \
                    or max(dq_smem, kv_smem) > 227 * 1024:
                raise AssertionError(f"K3b plan at Dh {dh} f32={f32}: the kernel's "
                                     f"{readings[-1]}, the wrapper's {bwd_plan(dh, f32)}")
    info["k3b_plan"] = readings
    log("K3B_PLAN " + json.dumps(readings))


def check_flash_bwd(torch, timer, rows, breakdown: bool = False) -> None:
    """K3b at the trainer's shape (S=512 from position 0 over its 1024-slot
    cache, 6 heads over 2 groups, Dh 64, f32), at the flagship's heads (32
    over 8, S=256 at position 765 over 1024 slots) in bf16 and f32 and with
    a window of 512, and at the other instantiations from the same
    positions: Dh 32 at the hybrid's 8/2 heads, Dh 128 at 16/4, Dh 256 at
    gemma3_1b's 4/1 (bf16). With `breakdown`, each row also gives each
    launch's device ms from a profiler trace (the profiler's first set-up
    takes ~10 s)."""
    from uzu_tpu_torch.tools.train_tiny import TINY_DIMS

    gen = torch.Generator(device="cuda").manual_seed(3)

    def case(s, h, g, c, pos0, dtype, window, variant, dh=64, breakdown=False):
        q, kc, vc = (torch.randn(shape, device="cuda", generator=gen).to(dtype)
                     for shape in ((s, h, dh), (c, g, dh), (c, g, dh)))
        flash_bwd_row(torch, timer, rows, q, kc, vc, pos0, window, variant, breakdown)

    case(TRAIN_SEQ, TINY_DIMS["num_heads"], TINY_DIMS["num_groups"], TINY_DIMS["max_seq"], 0,
         torch.float32, None, "train", breakdown=breakdown)
    case(256, 32, 8, 1024, 765, torch.bfloat16, None, "plain", breakdown=breakdown)
    case(256, 32, 8, 1024, 765, torch.float32, None, "plain", breakdown=breakdown)
    case(256, 32, 8, 1024, 765, torch.bfloat16, 512, "window", breakdown=breakdown)
    case(256, 8, 2, 1024, 765, torch.bfloat16, None, "dh32", dh=32, breakdown=breakdown)
    case(256, 16, 4, 1024, 765, torch.bfloat16, None, "dh128", dh=128, breakdown=breakdown)
    case(256, 4, 1, 1024, 765, torch.bfloat16, None, "dh256", dh=256, breakdown=breakdown)


def check_flash_lse(torch, info: dict) -> None:
    """K3's L at the flagship's heads (32 over 8 groups, Dh 64), bf16 and
    f32: its K3 row (S=256 at position 765 over 1024 slots; the plan's
    splits), a first 1024-row chunk (one split) and a 16-row chunk at the
    end of 4096 slots (many): within LSE_TOL of `flash_attention_lse_plain`,
    and the output with the L pointer bitwise the output without it."""
    from uzu_tpu_torch.ops.cuda.flash_attention import (
        _launch,
        flash_attention_lse_plain,
        launch_split_plan,
    )

    gen = torch.Generator(device="cuda").manual_seed(5)
    h, g, dh = 32, 8, 64
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    readings = []
    for s, c, pos0 in ((256, 1024, 765), (1024, 1024, 0), (16, 4096, 4096 - 19)):
        for dtype in (torch.bfloat16, torch.float32):
            q, kc, vc = (torch.randn(shape, device="cuda", generator=gen).to(dtype)
                         for shape in ((s, h, dh), (c, g, dh), (c, g, dh)))
            qpos = torch.arange(s, device="cuda", dtype=torch.int32) + pos0
            want = flash_attention_lse_plain(q, kc, vc, qpos, scale=dh ** -0.5)
            lse = torch.full((s, h), float("nan"), device="cuda")
            plain_out = _launch(q, kc, vc, qpos, scale=dh ** -0.5)
            out = _launch(q, kc, vc, qpos, scale=dh ** -0.5, lse=lse)
            torch.cuda.synchronize()
            err = (lse - want).abs().max().item()
            same = torch.equal(out, plain_out)
            splits = launch_split_plan(s, h, g, c, dh, sms)[0]
            readings.append(dict(S=s, C=c, pos0=pos0, q=str(dtype).split(".")[-1],
                                 splits=splits, lse_max_abs_err=err, out_bitwise=same))
            if not (err <= LSE_TOL and same):
                raise AssertionError(f"K3 lse at S={s} C={c} ({splits} splits), q {dtype}: "
                                     f"error {err:.3e} (tol {LSE_TOL}), output bitwise {same}")
    if 1 not in {r["splits"] for r in readings} or max(r["splits"] for r in readings) < 2:
        raise AssertionError(f"K3 lse: no one-split and several-split case: {readings}")
    info["k3_lse"] = readings
    log("K3_LSE " + json.dumps(readings))


def check_paged_gptoss(torch, timer, rows, usage) -> None:
    """K5 at gpt-oss's heads (8 per KV group, Dh 64, bf16 pools of 512-token
    pages): its window of 128 with sinks, and sinks alone, over 8 x 1024
    live tokens and ragged lengths."""
    h, g, dh = GPTOSS["num_heads"], GPTOSS["num_groups"], GPTOSS["head_dim"]
    win = GPTOSS["sliding_window"]
    gen, sinks, cases = gptoss_attention_inputs(torch)
    del cases
    b, page = 8, 512
    maxp = 4096 // page
    p_total = b * maxp + 1
    k = torch.randn((g, p_total, page, dh), device="cuda", generator=gen).to(torch.bfloat16)
    v = torch.randn((g, p_total, page, dh), device="cuda", generator=gen).to(torch.bfloat16)
    table = torch.randperm(p_total - 1, device="cuda", generator=gen)[: b * maxp]
    table = table.reshape(b, maxp).to(torch.int32)
    q = torch.randn((b, h, dh), device="cuda", generator=gen).to(torch.bfloat16)
    for lens_name, lens in (("uniform1024", [1024] * b),
                            ("ragged", [1, 100, 129, 777, 1024, 3000, 4095, 4096])):
        lengths = torch.tensor(lens, device="cuda", dtype=torch.int32)
        for variant, kw in (("gptoss_window_sinks", dict(sliding_window_size=win, sinks=sinks)),
                            ("gptoss_sinks", dict(sinks=sinks))):
            paged_row(torch, timer, rows, usage, q, k, v, table, lengths, lens_name, variant,
                      kw)


def check_flash_gemma(torch, timer, rows, usage, parts=("256", "rounded", "wide")) -> None:
    """K3/K4 at the Gemma models' attention heads, Dh 256 (the
    instantiation this slice adds): a 256-row chunk over a 1024-slot cache
    at H/G 4/1 (gemma3_1b) and 8/2 (gemma_e4b_8l), plain, with the window of
    512 and with the soft cap of 50, bf16 and f32 q; the first chunk from
    position 0; a 16-row chunk over 4096 slots (split route); then the
    head dims that run rounded up (24 and 16 in the Dh-32 instantiation);
    then past Dh 256 (the wide case) at gemma_e4b_8l's heads: the plain
    and windowed soft-capped chunk, the first chunk, the split route, f32.
    `parts` picks among the three."""
    from uzu_tpu_torch.models.kv_cache import quantize_rows

    gen = torch.Generator(device="cuda").manual_seed(13)
    kinds = {"plain": {}, "window": {"sliding_window_size": GEMMA3_1B["sliding_window"]},
             "softcap": {"logit_soft_cap": GEMMA_SOFT_CAP},
             "window_softcap": {"sliding_window_size": GEMMA_E4B["sliding_window"],
                                "logit_soft_cap": GEMMA_SOFT_CAP}}

    def case(h, g, dh, s, c, pos0, variants, dtype=torch.bfloat16, quants=(False, True)):
        q, kc, vc = (torch.randn(shape, device="cuda", generator=gen).to(dtype)
                     for shape in ((s, h, dh), (c, g, dh), (c, g, dh)))
        (kq, ks), (vq, vs) = quantize_rows(kc.float()), quantize_rows(vc.float())
        for quant in quants:
            for variant in variants:
                kw = dict(kinds[variant])
                if quant:
                    kw.update(k_scales=ks, v_scales=vs)
                flash_row(torch, timer, rows, usage, q, kq if quant else kc,
                          vq if quant else vc, pos0, "gemma_" + variant, kw)

    h1, g1 = GEMMA3_1B["num_heads"], GEMMA3_1B["num_groups"]
    h4, g4 = GEMMA_E4B["num_heads"], GEMMA_E4B["num_groups"]
    if "256" in parts:
        case(h1, g1, 256, 256, 1024, 765, ("plain", "window"))
        case(h1, g1, 256, 256, 1024, 0, ("plain",))
        case(h4, g4, 256, 256, 1024, 765, ("softcap", "window_softcap"))
        case(h4, g4, 256, 256, 1024, 765, ("softcap",), dtype=torch.float32)
        case(h1, g1, 256, 16, 4096, 4096 - 19, ("plain",))
    if "rounded" in parts:
        for dh in ROUNDED_HEAD_DIMS:
            case(h4, g4, dh, 256, 1024, 765, ("plain", "softcap"))
            case(h4, g4, dh, 16, 4096, 4096 - 19, ("plain",), dtype=torch.float32)
    for dh in WIDE_HEAD_DIMS if "wide" in parts else ():
        case(h4, g4, dh, 256, 1024, 765, ("plain", "window_softcap"))
        case(h4, g4, dh, 256, 1024, 0, ("plain",), quants=(False,))
        case(h4, g4, dh, 16, 4096, 4096 - 19, ("plain",))
        case(h4, g4, dh, 256, 1024, 765, ("plain",), dtype=torch.float32, quants=(False,))


def check_paged_gemma(torch, timer, rows, usage, parts=("256", "rounded", "wide")) -> None:
    """K5/K6 at the Gemma models' heads, Dh 256: 8 slots over 512-token
    pages at H/G 4/1 (the paged engine's 1536-token table of 8 x 1000
    tokens, and 8 x 1024 live tokens with the window of 512) and 8/2 with
    the soft cap; f32 q and pools (the one-stage ring); then the head dims
    that run rounded up (24 and 16 in the Dh-64 instantiation), ragged
    lengths included; then past Dh 256 (the wide case) at gemma_e4b_8l's
    heads: the engine's 1536-token table, the window and ragged lengths
    with the soft cap, f32 q and pools. `parts` picks among the three."""
    from uzu_tpu_torch.models.kv_cache import quantize_rows

    gen = torch.Generator(device="cuda").manual_seed(14)
    b, page = 8, 512

    def case(h, g, dh, variants, dtype=torch.bfloat16, quants=(False, True), width=4096,
             lens_cases=("uniform1024",)):
        maxp = width // page
        p_total = b * maxp + 1
        k = torch.randn((g, p_total, page, dh), device="cuda", generator=gen).to(dtype)
        v = torch.randn((g, p_total, page, dh), device="cuda", generator=gen).to(dtype)
        (kq, ks), (vq, vs) = quantize_rows(k.float()), quantize_rows(v.float())
        table = torch.randperm(p_total - 1, device="cuda", generator=gen)[: b * maxp]
        table = table.reshape(b, maxp).to(torch.int32)
        q = torch.randn((b, h, dh), device="cuda", generator=gen).to(dtype)
        all_lens = {"uniform1024": [1024] * b, "uniform1000": [1000] * b,
                    "ragged": [1, 100, 513, 777, 1024, 1500, width - 1, width]}
        for lens_name in lens_cases:
            lengths = torch.tensor([min(n, width) for n in all_lens[lens_name]],
                                   device="cuda", dtype=torch.int32)
            for variant in variants:
                kw = {"plain": {}, "window": {"sliding_window_size": GEMMA3_1B["sliding_window"]},
                      "softcap": {"logit_soft_cap": GEMMA_SOFT_CAP}}[variant]
                for quant in quants:
                    kwq = dict(kw, k_scales=ks, v_scales=vs) if quant else kw
                    paged_row(torch, timer, rows, usage, q, kq if quant else k,
                              vq if quant else v, table, lengths, lens_name,
                              "gemma_" + variant, kwq)
        del k, v, kq, vq

    h1, g1 = GEMMA3_1B["num_heads"], GEMMA3_1B["num_groups"]
    h4, g4 = GEMMA_E4B["num_heads"], GEMMA_E4B["num_groups"]
    if "256" in parts:
        case(h1, g1, 256, ("plain",), width=1536, lens_cases=("uniform1000",))
        case(h1, g1, 256, ("plain", "window"))
        case(h4, g4, 256, ("softcap",), lens_cases=("uniform1024", "ragged"))
        case(h1, g1, 256, ("plain",), dtype=torch.float32, quants=(False,))
    if "rounded" in parts:
        for dh in ROUNDED_HEAD_DIMS:
            case(h4, g4, dh, ("plain", "softcap"), lens_cases=("uniform1024", "ragged"))
            case(h4, g4, dh, ("plain",), dtype=torch.float32, quants=(False,))
    for dh in WIDE_HEAD_DIMS if "wide" in parts else ():
        case(h4, g4, dh, ("plain",), width=1536, lens_cases=("uniform1000",))
        case(h4, g4, dh, ("window", "softcap"), lens_cases=("ragged",))
        case(h4, g4, dh, ("plain",), dtype=torch.float32, quants=(False,), width=1536,
             lens_cases=("uniform1000",))


def check_block_copy(torch, timer, rows) -> None:
    """P1 at the bisect probe's shape, [256, 16] -> [256, 128] f32; the
    copy must equal its plain version bit for bit. Beside it, with the same
    timer, an empty kernel's launch: the floor under any launch."""
    import torch.nn.functional as F

    from uzu_tpu_torch.ops.cuda.block_copy import (
        empty_launch,
        scale_block_copy,
        scale_block_copy_plain,
    )

    gen = torch.Generator(device="cuda").manual_seed(11)
    r, kg, width = 256, 16, 128
    s = torch.rand((r, kg), device="cuda", generator=gen) * 0.02 + 0.01
    got = scale_block_copy(s, width)
    want = scale_block_copy_plain(s, width)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError("scale_block_copy differs from its plain version")
    abs_err, err = rel_err(got, want)
    b_ms, b_by = bound((r * kg + r * width) * 4, 0.0)
    ms, dev_ms = timer.both(lambda: scale_block_copy(s, width))
    lib_ms, lib_dev_ms = timer.both(lambda: F.pad(s, (0, width - kg)))
    # the launch floor: an empty kernel, one launch, no memory traffic
    floor_ms, floor_dev_ms = timer.both(lambda: empty_launch(s.device))
    row = dict(kernel="scale_block_copy", R=r, kg=kg, width=width, max_abs_err=abs_err,
               err_over_rms=err, tol=0.0, ms=ms, device_ms=dev_ms,
               launch_floor_ms=floor_ms, launch_floor_device_ms=floor_dev_ms,
               device_ms_over_floor=dev_ms / floor_dev_ms,
               plain_ms=timer.ms(lambda: scale_block_copy_plain(s, width), 3),
               library_ms=lib_ms, library_device_ms=lib_dev_ms, bound_ms=b_ms, bound_by=b_by)
    rows.append(row)
    log("KERNEL " + json.dumps(row))


# Jamba2-3B's Mamba-1 and attention widths (the benchmark's jamba2-3b):
# d 2560, Di 5120, N 16, dt rank 160; 20 query heads over 1 KV head, Dh 128
JAMBA_LINEAR_SHAPES = (("jamba/x_proj", 192, 5120), ("jamba/dt_proj", 5120, 160))
JAMBA_SCAN = dict(di=5120, n=16, chunk=4096, slots=32)
# S1's y is rounded once to bf16 (half an ulp: at most 2^-8 of itself) from
# f32 arithmetic that differs from the plain version's only in order and
# exp2 against exp (~1e-6): each element within twice that of the plain
# version's f32 y (over |y| + 1e-3 RMS, for values near 0). h is f32 in both.
SCAN_TOL_Y, SCAN_TOL_H = 2.0 ** -7, 1e-4


def scan_inputs(torch, gen, b: int, s: int, di: int, n: int):
    """Inputs of S1 as Jamba's mixer hands them over: x, dt, z bf16 with z a
    strided view of the in-projection's [x | z] rows, B and C RMS-scaled,
    A_log = log(1..N) with noise, dt_bias = softplus^-1 of a log-uniform
    draw in [1e-3, 1e-1], D = 1, a warm state."""
    proj = torch.randn((b, s, 2 * di), device="cuda", generator=gen).to(torch.bfloat16)
    x, dt = (torch.randn((b, s, di), device="cuda", generator=gen).to(torch.bfloat16)
             for _ in range(2))
    bm, cm = (torch.randn((b, s, n), device="cuda", generator=gen).to(torch.bfloat16)
              for _ in range(2))
    a_log = (torch.log(torch.arange(1, n + 1, device="cuda", dtype=torch.float32)).repeat(di, 1)
             + 0.05 * torch.randn((di, n), device="cuda", generator=gen))
    v = torch.exp(torch.empty(di, device="cuda").uniform_(math.log(1e-3), math.log(1e-1),
                                                           generator=gen))
    dt_bias = v + torch.log(-torch.expm1(-v))
    h0 = 0.1 * torch.randn((b, di, n), device="cuda", generator=gen)
    return (x, dt, proj[..., di:], bm, cm, a_log, dt_bias, torch.ones(di, device="cuda"), h0)


def check_selective_scan(torch, timer, rows) -> None:
    """S1 at Jamba2-3B's widths against its plain version: a 4096-row
    prefill chunk from a carried state (whole, and with its last 96 rows
    padded past the length), and the decode step of 32 slots (3 halted).
    Bound: bytes (x, dt, z, B, C read, y written, once; h read and written
    once); the operations counted are the recurrence's 6 per channel and
    state a row, exp2 not counted."""
    from uzu_tpu_torch.ops.cuda.build import BUILD_LOGS, ptxas_usage
    from uzu_tpu_torch.ops.cuda.selective_scan import selective_scan, selective_scan_plain

    gen = torch.Generator(device="cuda").manual_seed(29)
    di, n = JAMBA_SCAN["di"], JAMBA_SCAN["n"]
    usage = ptxas_usage(BUILD_LOGS.get("selective_scan", ""))
    cases = [("prefill", 1, JAMBA_SCAN["chunk"], [JAMBA_SCAN["chunk"]]),
             ("prefill_ragged", 1, JAMBA_SCAN["chunk"], [JAMBA_SCAN["chunk"] - 96]),
             ("decode", JAMBA_SCAN["slots"], 1, [1] * (JAMBA_SCAN["slots"] - 3) + [0] * 3)]
    for variant, b, s, lens in cases:
        args = scan_inputs(torch, gen, b, s, di, n)
        lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
        y, h = selective_scan(*args, lengths)
        # the plain version on the same values in f32: y before its rounding
        want_y, want_h = selective_scan_plain(*(a.float() for a in args), lengths)
        torch.cuda.synchronize()
        abs_y, err_y = rel_err(y, want_y)
        abs_h, err_h = rel_err(h, want_h)
        rms = want_y.pow(2).mean().sqrt()
        elem_y = ((y.float() - want_y).abs() / (want_y.abs() + 1e-3 * rms)).max().item()
        if not (elem_y <= SCAN_TOL_Y and err_h <= SCAN_TOL_H):
            raise AssertionError(f"selective_scan {variant}: y {elem_y:.3e} of itself, h "
                                 f"{err_h:.3e} of RMS > {SCAN_TOL_Y} / {SCAN_TOL_H}")
        nbytes = b * s * (4 * di * 2 + 2 * n * 2) + 2 * b * di * n * 4 + di * n * 4
        b_ms, b_by = bound(nbytes, 6.0 * b * s * di * n)
        run = lambda: selective_scan(*args, lengths)  # noqa: E731
        ms, dev_ms = timer.both(run)
        kernel = "selective_scan_step" if s == 1 else "selective_scan_chunk"
        row = dict(kernel="selective_scan", variant=variant, B=b, S=s, Di=di, N=n,
                   lengths=sorted(set(lens)),
                   ptxas={k: v for k, v in usage.items() if kernel in k},
                   max_abs_err=abs_y, err_over_rms=err_y, err_over_itself=elem_y,
                   h_err_over_rms=err_h,
                   tol=SCAN_TOL_Y, h_tol=SCAN_TOL_H, ms=ms, device_ms=dev_ms,
                   plain_ms=timer.ms(lambda: selective_scan_plain(*args, lengths), 2),
                   library_ms=None, library_device_ms=None, bound_ms=b_ms, bound_by=b_by)
        rows.append(row)
        log("KERNEL " + json.dumps(row))
        del args, y, h, want_y, want_h
        torch.cuda.empty_cache()


def check_jamba_rows(torch, timer, rows) -> None:
    """K1 at Jamba's x_proj (N = 192, K = 5120) and dt_proj (N = 5120, K =
    160, not a multiple of 64) at a decode step of 32 slots and a 4096-row
    prefill chunk; K3 at its 20 query heads over 1 KV head, Dh 128, no RoPE
    (positions enter only the causal mask), a 256-row chunk late in an
    8192-slot context and a 1024-row one at 15360 over 16384 slots."""
    from uzu_tpu_torch.ops.cuda.build import BUILD_LOGS

    from uzu_tpu_torch.ops.cuda.quant_matmul import quant_matmul, quant_matmul_plain

    gen = torch.Generator(device="cuda").manual_seed(31)
    for wname, n, k in JAMBA_LINEAR_SHAPES:
        w, wd = random_qweights(torch, gen, n, k, 4)["symmetric"]
        for m in (32, 4096):
            # the plain version against the tile's own arithmetic (weights
            # rounded to bf16, f32 sums), and K1 against that, on one x
            x = torch.randn((m, k), device="cuda", generator=gen).to(torch.bfloat16)
            plain = quant_matmul_plain(w, x)
            rounded = x.float() @ wd.float().t()
            log("QMM_JAMBA_ROUNDING " + json.dumps(dict(
                weight=wname, M=m, rounding_err_over_rms=rel_err(rounded, plain)[1],
                k1_vs_rounded_err_over_rms=rel_err(quant_matmul(w, x), rounded)[1])))
            qmm_row(torch, timer, rows, w, wd, wname, m, "symmetric", gen,
                    TOL if m <= 32 else PREFILL_TOL)
    usage = kernel_usage(BUILD_LOGS.get("flash_attention", ""), "flash_fwd")
    for s, c, pos0 in ((256, 8192, 8192 - 259), (1024, 16384, 15360)):
        q = torch.randn((s, 20, 128), device="cuda", generator=gen).to(torch.bfloat16)
        kc, vc = (torch.randn((c, 1, 128), device="cuda", generator=gen).to(torch.bfloat16)
                  for _ in range(2))
        flash_row(torch, timer, rows, usage, q, kc, vc, pos0, "plain", {})
        del q, kc, vc
        torch.cuda.empty_cache()


# -- phases 3-10: the port's main paths -----------------------------------------


def model_config(name: str):
    """The LanguageModelConfig of one of the run's models."""
    from uzu_tpu_torch.tools.synth import (
        gemma_config,
        gptoss_config,
        lfm2_config,
        llama_config,
        mamba2_hybrid_config,
        qwen35_config,
        windowed_config,
    )

    if name == "gemma3_1b":
        # windowed_config at Gemma-3-1B's widths, with Gemma-3's pattern of
        # five local layers to one global one. What it does not have of
        # Gemma-3: its MLP is SiLU (Gemma's is GELU), and it has no QK norm
        # and no post norms.
        g = dict(GEMMA3_1B)
        window = g.pop("sliding_window")
        cfg = windowed_config(**g, sliding_window=window, has_sinks=False,
                              logit_soft_cap=None, kv_share_last=0)
        tcfg = cfg.decoder_config.transformer_config
        layers = tuple(dataclasses.replace(lc, mixer_config=dataclasses.replace(
            lc.mixer_config, sliding_window_size=None if i % 6 == 5 else window))
            for i, lc in enumerate(tcfg.layer_configs))
        return dataclasses.replace(cfg, decoder_config=dataclasses.replace(
            cfg.decoder_config,
            transformer_config=dataclasses.replace(tcfg, layer_configs=layers)))
    if name == "gemma_e4b_8l":
        # gemma_config at Gemma-3n-E4B's text widths: PLE, per-layer
        # scalars, windows on even layers, soft caps, GELU, the last two
        # layers sharing layer 5's KV. The repo's config has no AltUp and
        # no LAuReL.
        return gemma_config(**GEMMA_E4B)
    if name == "gemma_dh512_2l":
        return gemma_config(**WIDE_GEMMA)
    if name == "windowed_dh512_2l":
        g = {k: v for k, v in WIDE_GEMMA.items() if k not in ("ple_dim", "ple_vocab")}
        return windowed_config(**g, has_sinks=False, logit_soft_cap=GEMMA_SOFT_CAP)
    if name.startswith("llama1b"):
        layers = {"llama1b_int8_2l": 2, "llama1b_hybrid": HYBRID_LINEAR_LAYERS}.get(name, 16)
        return llama_config(**dict(FLAGSHIP, num_layers=layers))
    if name.startswith("gptoss"):
        return gptoss_config(num_layers=4 if name == "gptoss_int4" else 2, **GPTOSS)
    if name == "qwen08_int4":
        return qwen35_config(**QWEN08)
    if name in BENCH_TOOLS:
        from uzu_tpu_torch.tools import bench8b, bench_qwen08, benchmoe

        return {"bench8b": lambda: llama_config(**bench8b.DIMS),
                "benchmoe": lambda: gptoss_config(**benchmoe.DIMS),
                "bench_qwen08": lambda: qwen35_config(**bench_qwen08.DIMS)}[name]()
    if name == "lfm2_4l":
        return lfm2_config(**LFM2_4L)
    return mamba2_hybrid_config(**MAMBA2_4L)


def synth_model(name: str) -> str:
    """Synthesize one of the run's models into .port_cache/<name>, unless a
    finished one is there: the Llama-shaped flagships (16 layers with INT4
    linears, 2 with INT8; INT4 tied embedding; normal fill, seed 0),
    gpt-oss at 4 layers with INT4 experts and at 2 with INT8 experts (bf16
    attention and untied embeddings; raw-bytes fill, seed 0), and the
    hybrids (the Qwen3.5-class model at full width, LFM2- and Mamba2-style
    ones at 4 layers; INT4 g32 linears and tied embedding; raw-bytes fill,
    seed 0); the flagship with HybridSpec linears (normal fill, seed 0) and
    the Dh-512 models (raw-bytes fill, seed 0); a DFlash draft over the
    flagship (bf16, normal fill, seed 0); and the encoder classifier of
    phase 18 (bf16, normal fill, seed 0); the bench tools' models
    (BENCH_TOOLS), each by its tool's `model_dir` into
    .port_cache/bench/. Logs the seconds it took."""
    import importlib

    t0 = time.perf_counter()
    if name in BENCH_TOOLS:
        out = importlib.import_module(f"uzu_tpu_torch.tools.{name}").model_dir(REPO)
    else:
        out = os.path.join(REPO, ".port_cache", name)
        if os.path.exists(os.path.join(out, "model.safetensors")):
            return out
        _synthesize(name, out)
    log(f"SYNTH {name} {time.perf_counter() - t0:.1f} s")
    return out


def _synthesize(name: str, out: str) -> None:
    from uzu_tpu_torch.config.model import (
        HybridSpec,
        IncoherenceProcessingMode,
        IntSpec,
        Layout,
        LowRankSpec,
    )
    from uzu_tpu_torch.tools.synth import synthesize

    if name == "clf_12l":
        from uzu_tpu_torch.tools.synth import classifier_config, synthesize_classifier

        synthesize_classifier(classifier_config(**SERVE_CLASSIFIER), out, seed=0)
        return
    if name == "dflash_flagship":
        from uzu_tpu_torch.tools.synth import synth_dflash_speculator

        synth_dflash_speculator(out, model_config("llama1b_int4"),
                                block_size=DFLASH_BLOCK, target_layer_ids=DFLASH_TAPS, seed=0)
        return

    def spec(bits):
        return IntSpec(bits=bits, group_size=32, is_symmetric=True, layout=Layout.OUTPUT_INPUT)

    cfg = model_config(name)
    if name == "llama1b_hybrid":
        hybrid = HybridSpec(quantization_spec=spec(4), adapter_spec=LowRankSpec(rank=HYBRID_RANK),
                            incoherence_block_size=32,
                            incoherence_processing_mode=IncoherenceProcessingMode.INPUT_OUTPUT)
        synthesize(cfg, out, seed=0, linear_spec=hybrid, embedding_spec=spec(4))
    elif name.startswith("llama1b"):
        bits = 4 if name == "llama1b_int4" else 8
        synthesize(cfg, out, seed=0, linear_spec=spec(bits), embedding_spec=spec(4))
    elif name.startswith("gptoss"):
        bits = 4 if name == "gptoss_int4" else 8
        synthesize(cfg, out, seed=0, expert_spec=spec(bits), fill="fast")
    else:
        synthesize(cfg, out, seed=0, linear_spec=spec(4), embedding_spec=spec(4), fill="fast")


GEMMA_MODELS = ("gemma3_1b", "gemma_e4b_8l")
SLICE_MODELS = ("llama1b_hybrid", "gemma_dh512_2l", "windowed_dh512_2l")
SPEC_MODELS = ("llama1b_int4", "llama1b_int8_2l", "gptoss_int4", "qwen08_int4",
               "dflash_flagship")
BSPEC_MODELS = ("llama1b_int4", "llama1b_int8_2l", "gptoss_int4", "qwen08_int4")
SERVE_MODELS = ("llama1b_int4", "clf_12l")
# the full run's models: the first process's (one synthesis process
# each), and each side process's (its synthesis processes, its models in
# the order its phases need them)
HEAD_MODELS = ("llama1b_int4", "llama1b_int8_2l", "dflash_flagship", "clf_12l")
SIDE_MODELS = {"second": (3, ("qwen08_int4", "gptoss_int4", "lfm2_4l", "mamba2_4l",
                              "gptoss_int8_2l", *GEMMA_MODELS)),
               # the 8B (~4.5 GB) from the run's start in a worker of its own
               "third": (2, ("bench8b", *SLICE_MODELS, "benchmoe", "bench_qwen08"))}
MODELS = (*HEAD_MODELS, *(name for _, names in SIDE_MODELS.values() for name in names))
# the first process's models that it hands to the side processes
SHARED_MODELS = ("llama1b_int4", "llama1b_int8_2l")


class ModelDirs:
    """The model directories of `names`, each synthesized by a job of
    `pool` submitted in that order, and of the finished ones `add` is
    given: a lookup waits for its model alone, and the seconds the first
    lookup of each waited are kept."""

    def __init__(self, pool, names):
        self.jobs = {name: pool.submit(synth_model, name) for name in names}
        self.given: dict = {}
        self.waited: dict = {}

    def add(self, paths: dict) -> None:
        self.given.update(paths)

    def __getitem__(self, name: str) -> str:
        if name in self.given:
            return self.given[name]
        t = time.perf_counter()
        out = self.jobs[name].result()
        self.waited.setdefault(name, time.perf_counter() - t)
        return out


def prompt_tokens(n: int, vocab: int):
    import numpy as np

    return (np.arange(n) * 37 + 11) % vocab


def single_stream_run(torch, lm, vocab: int, key: str, kernels, info: dict,
                      prompt=None) -> dict:
    """GEN_TOKENS greedy tokens after a GEN_PROMPT-token prompt (or
    `prompt`), twice: the tokens must repeat, and each kernel in `kernels`
    must have launched."""
    from uzu_tpu_torch.engine.engine import StreamMetrics
    from uzu_tpu_torch.ops.cuda.build import LAUNCHES, reset_launches

    if prompt is None:
        prompt = prompt_tokens(GEN_PROMPT, vocab)
    lm.generate_list(prompt[:16], 2, stop_token_ids=[])  # warm the allocator

    reset_launches()
    lm.prefill(lm.new_state(), prompt)
    torch.cuda.synchronize()
    per_prefill_chunk = dict(LAUNCHES)

    runs = []
    for _ in range(2):
        metrics = StreamMetrics()
        reset_launches()
        toks = lm.generate_list(prompt, GEN_TOKENS, stop_token_ids=[], metrics=metrics)
        torch.cuda.synchronize()
        runs.append((toks, metrics, dict(LAUNCHES)))
    (toks, metrics, launches), (toks2, metrics2, _) = runs
    if toks != toks2:
        raise AssertionError(f"{key}: greedy generation differs between runs:\n{toks}\n{toks2}")
    if len(toks) != GEN_TOKENS:
        raise AssertionError(f"{key}: expected {GEN_TOKENS} tokens, got {len(toks)}")
    for name in kernels:
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} was not launched on the {key} run")
    decode_steps = metrics.num_forward_passes - 1
    per_step = {n: (launches[n] - per_prefill_chunk[n]) / decode_steps for n in launches}
    info[key] = dict(
        prompt=len(prompt), generated=len(toks), tokens_head=toks[:16],
        prefill_tok_s=[m.prefill_tokens_per_second for _, m, _ in runs],
        decode_tok_s=[m.decode_tokens_per_second for _, m, _ in runs],
        launches=launches, launches_per_prefill_chunk=per_prefill_chunk,
        launches_per_decode_step=per_step, decode_steps=decode_steps)
    log(key.upper() + " " + json.dumps(info[key]))
    return launches


def path_int4(torch, model_dir: str, info: dict):
    from uzu_tpu_torch.engine.engine import LanguageModel

    lm = LanguageModel.from_dir(model_dir, device="cuda", max_context=4096)
    single_stream_run(torch, lm, FLAGSHIP["vocab_size"], "int4_path",
                      ("quant_matmul_int4", "flash_attention"), info)
    return lm


def path_int8(torch, model_dir: str, info: dict) -> dict:
    from uzu_tpu_torch.engine.engine import LanguageModel, StreamMetrics
    from uzu_tpu_torch.ops.cuda.build import LAUNCHES, reset_launches

    lm = LanguageModel.from_dir(model_dir, device="cuda", max_context=4096)
    prompt = prompt_tokens(64, FLAGSHIP["vocab_size"])
    metrics = StreamMetrics()
    reset_launches()
    toks = lm.generate_list(prompt, 16, stop_token_ids=[], metrics=metrics)
    torch.cuda.synchronize()
    launches = dict(LAUNCHES)
    if launches["quant_matmul_int8"] <= 0:
        raise AssertionError("kernel quant_matmul_int8 was not launched on the INT8 path")
    info["int8_path"] = dict(generated=len(toks), tokens_head=toks[:16], launches=launches,
                             prefill_tok_s=metrics.prefill_tokens_per_second,
                             decode_tok_s=metrics.decode_tokens_per_second)
    log("PATH_INT8 " + json.dumps(info["int8_path"]))
    return launches


def path_int4_kv_int8(torch, lm16, info: dict) -> dict:
    """The dense INT4 path once more with the INT8 KV cache: prefill
    attention goes through K4."""
    from uzu_tpu_torch.engine.engine import LanguageModel, StreamMetrics
    from uzu_tpu_torch.ops.cuda.build import LAUNCHES, reset_launches

    lm = LanguageModel(lm16.config, lm16.params, device="cuda", max_context=4096,
                       kv_quant=True)
    metrics = StreamMetrics()
    reset_launches()
    toks = lm.generate_list(prompt_tokens(GEN_PROMPT, FLAGSHIP["vocab_size"]), 16,
                            stop_token_ids=[], metrics=metrics)
    torch.cuda.synchronize()
    launches = dict(LAUNCHES)
    if launches["flash_attention_int8"] <= 0:
        raise AssertionError("kernel flash_attention_int8 was not launched on the INT8-KV path")
    info["int4_kv_int8_path"] = dict(generated=len(toks), tokens_head=toks[:16],
                                     launches=launches,
                                     prefill_tok_s=metrics.prefill_tokens_per_second,
                                     decode_tok_s=metrics.decode_tokens_per_second)
    log("PATH_INT4_KV_INT8 " + json.dumps(info["int4_kv_int8_path"]))
    return launches


def router_logits(params, x):
    """The MoE router's f32 logits for rows x, as `models.moe.router_topk`
    computes them."""
    logits = x.float() @ params["router"]["w"].float().t()
    return logits + params["router"]["b"].float() if "b" in params["router"] else logits


def pinned_router(torch, routes):
    """A stand-in for `models.moe.router_topk` that takes the expert ids
    `routes(x)` gives for the call's rows ([S, K]; None: its own choice),
    weights them as the router would, and records per row how far the
    lowest of them lies below its own K-th router logit (0 where the
    choices agree)."""
    import uzu_tpu_torch.models.moe as moe
    from uzu_tpu_torch.config.model import SoftmaxRouting

    real = moe.router_topk
    gaps = []

    def topk(cfg, params, x):
        ids = routes(x)
        if ids is None:
            return real(cfg, params, x)
        ids = ids.to(x.device).long().reshape(x.shape[0], -1)
        logits = router_logits(params, x)
        k = cfg.num_active_routed_experts
        kth = torch.sort(logits, dim=-1, descending=True).values[:, k - 1]
        vals = logits.gather(1, ids)
        gaps.append((kth - vals.min(-1).values).clamp(min=0))
        probs = torch.softmax(vals, -1) if isinstance(cfg.routing_function,
                                                      SoftmaxRouting) else vals
        return ids, probs

    return topk, gaps


def single_stream_along(torch, lm, prompt, tokens, routes=None):
    """The single-stream path of `lm` (prefill, then one decode step per
    token) fed `tokens`: per step the greedy choice, its top-2 logit margin,
    and how far the fed token's logit lies below the best one. `routes`
    ({position: ([layers, K] expert ids, [layers, D] MoE inputs)}) makes
    each decode step's MoE layers take those experts; the last two results
    are then, per routed layer and step, how far the lowest of them lies
    below the step's own K-th router logit (0 where the choices agree), and
    per layer the relative L2 distances of this path's MoE inputs from the
    given ones (empty without `routes`)."""
    import uzu_tpu_torch.models.moe as moe

    state = lm.new_state()
    logits, state = lm.prefill(state, prompt)
    at = {"pos": None, "layer": 0}
    x_dist = {}

    def current(x):
        got = routes.get(at["pos"]) if routes is not None and x.shape[0] == 1 else None
        layer = at["layer"]
        at["layer"] += 1
        if got is None:
            return None
        ids, x_other = got
        x_dist.setdefault(layer, []).append(
            (x[0].float() - x_other[layer]).norm() / x_other[layer].norm())
        return ids[layer]

    real = moe.router_topk
    moe.router_topk, router_gaps = pinned_router(torch, current)
    rows = []
    try:
        for i, tok in enumerate(tokens):
            top = torch.topk(logits, 2)
            rows.append(torch.stack([top.indices[0].float(), top.values[0] - top.values[1],
                                     top.values[0] - logits[tok]]))
            if i + 1 < len(tokens):
                at["pos"], at["layer"] = len(prompt) + i, 0
                logits, state, _ = lm._forward(torch.tensor([tok], device=logits.device),
                                               state, 1, lm._ctx_bucket(len(prompt) + i + 1))
    finally:
        moe.router_topk = real
    best, margin, gap = torch.stack(rows).cpu().double().T.tolist()
    rg = torch.cat(router_gaps).cpu().double().tolist() if router_gaps else []
    xd = {layer: torch.stack(d).cpu().double().tolist() for layer, d in x_dist.items()}
    return [int(t) for t in best], margin, gap, rg, xd


def stream_readings(torch, lm, prompts, streams, routes=None) -> list[dict]:
    """Each stream against the single-stream path of `lm` fed the stream's
    own history. Per stream: `compared`, the tokens before the first step
    whose single-stream top-2 logit margin is under MARGIN (up to there
    the stream is the single stream's greedy stream run alone);
    `clear_steps`, the steps whose margin is at least MARGIN;
    `greedy_choices`, the steps at which the stream takes the single
    stream's greedy choice; where it first leaves that choice, with the
    margin there; and `max_gap`, how far its worst token's logit lies below
    the best one. With `routes` (one per stream, see single_stream_along)
    the single stream takes the stream's expert choices, and the reading
    adds `routed_layers`, `router_flips` (choices it would not have made),
    `max_router_gap` and, per layer, the relative L2 distances of the two
    paths' MoE inputs (`moe_input_dist`)."""
    out = []
    for i, (prompt, got) in enumerate(zip(prompts, streams)):
        best, margin, gap, rg, xd = single_stream_along(
            torch, lm, prompt, got, None if routes is None else routes[i])
        part = next((j for j, (a, b) in enumerate(zip(got, best)) if a != b), None)
        r = dict(
            compared=next((j for j, m in enumerate(margin) if m < MARGIN), len(got)),
            clear_steps=sum(m >= MARGIN for m in margin),
            greedy_choices=sum(a == b for a, b in zip(got, best)), tokens=len(got),
            parted_at=part, margin_there=None if part is None else margin[part],
            max_gap=max(gap))
        if routes is not None:
            r.update(routed_layers=len(rg), router_flips=sum(g > 0 for g in rg),
                     max_router_gap=max(rg, default=0.0), moe_input_dist=xd)
        out.append(r)
    return out


def check_streams(readings) -> None:
    """On the same history the two paths' bf16 logits differ by a few bf16
    ulps (other summation orders in attention), so greedy may take the
    other side of a near-tie, and such a token's gap is at most twice that
    difference. A token MARGIN or more below the best logit fails; so, as
    a token that is not the greedy choice lies at least the margin below
    the best, does any step with a margin of at least MARGIN that chose
    otherwise (`compared` and `clear_steps` count those steps). A run whose
    streams take the greedy choice at fewer than GREEDY_FLOOR of their
    steps fails too."""
    for i, r in enumerate(readings):
        if r["max_gap"] >= MARGIN:
            raise AssertionError(f"request {i}: a token lies {r['max_gap']:.3e} below the "
                                 f"single stream's best logit (limit {MARGIN})")
    share = sum(r["greedy_choices"] for r in readings) / sum(r["tokens"] for r in readings)
    if share < GREEDY_FLOOR:
        raise AssertionError(f"the streams take the single stream's greedy choice at "
                             f"{share:.3f} of their steps (floor {GREEDY_FLOOR})")


def check_routing(readings) -> None:
    """Every expert the paged engine chose that the single stream would
    not have lies within ROUTER_MARGIN of the single stream's own K-th
    router logit: a near-tie, not a wrong route."""
    for i, r in enumerate(readings):
        if r["max_router_gap"] >= ROUTER_MARGIN:
            raise AssertionError(f"request {i}: an expert the paged engine chose lies "
                                 f"{r['max_router_gap']:.3e} below the single stream's K-th "
                                 f"router logit (limit {ROUTER_MARGIN})")


def stream_summary(readings) -> dict:
    out = dict(compared_tokens=[r["compared"] for r in readings],
               clear_steps=[r["clear_steps"] for r in readings],
               greedy_choices=[r["greedy_choices"] for r in readings],
               greedy_share=sum(r["greedy_choices"] for r in readings)
               / sum(r["tokens"] for r in readings),
               max_gaps=[r["max_gap"] for r in readings])
    if "router_flips" in readings[0]:
        dist = {}
        for r in readings:
            for layer, d in r["moe_input_dist"].items():
                dist.setdefault(layer, []).extend(d)
        out.update(routed_layers=sum(r["routed_layers"] for r in readings),
                   router_flips=[r["router_flips"] for r in readings],
                   max_router_gaps=[r["max_router_gap"] for r in readings],
                   moe_input_dist_median_max_per_layer=[
                       (statistics.median(dist[layer]), max(dist[layer]))
                       for layer in sorted(dist)])
    return out


def drive(torch, eng) -> tuple[float, list]:
    """Run the engine to idle; returns (seconds, [(seconds, decode-only)]
    per scheduler step)."""
    steps = []
    t0 = time.perf_counter()
    while True:
        before = dict(eng.stats)
        ts = time.perf_counter()
        busy = eng.step()
        steps.append((time.perf_counter() - ts,
                      eng.stats["prefill_chunks"] == before["prefill_chunks"]
                      and eng.stats["decode_chunks"] > before["decode_chunks"]))
        if not busy:
            break
    torch.cuda.synchronize()
    return time.perf_counter() - t0, steps


def paged_prompts(vocab: int):
    """11 prompts of 17 to 700 tokens; the last four share a 600-token
    prefix, a whole 512-token page of it."""
    import numpy as np

    out = [((np.arange(n) * (31 + 2 * i) + 101 * i + 7) % vocab).tolist()
           for i, n in enumerate((17, 700, 64, 300, 129, 450, 33))]
    shared = prompt_tokens(600, vocab).tolist()
    out += [shared + ((np.arange(n) * 7 + i) % vocab).tolist()
            for i, n in enumerate((5, 40, 90, 17))]
    return out


def path_paged_int4(torch, lm16, info: dict) -> dict:
    """PagedBatchEngine over the full-width INT4 flagship (bf16 pools)."""
    return paged_run(torch, lm16, FLAGSHIP["vocab_size"], "paged_int4", info)


def paged_run(torch, lm16, vocab: int, key: str, info: dict,
              tokens: int = PAGED_TOKENS) -> dict:
    """PagedBatchEngine (8 slots, 8-step chunks, 64 pages of 512 tokens,
    bf16 pools) over `lm16`: phase 4's requests and checks, K5 launched
    once per layer per decode step."""
    from uzu_tpu_torch.engine.paged_batch import PagedBatchEngine
    from uzu_tpu_torch.ops.cuda.build import LAUNCHES, reset_launches

    eng = PagedBatchEngine(lm16, batch_size=8, decode_chunk=8, num_pages=64,
                           stop_token_ids=[])
    pool_bytes = sum(t.numel() * t.element_size() for pk in eng.pools if pk for t in pk)
    prompts = paged_prompts(vocab)
    reset_launches()
    reqs = [eng.submit(p, tokens) for p in prompts]
    seconds, steps = drive(torch, eng)
    skipped_before = eng.stats["shared_prefix_tokens"]
    # a follow-up turn extending a finished request's history: its first
    # page comes from the automatic prefix cache
    follow = prompts[7] + reqs[7].tokens + [11, 12, 13]
    prompts.append(follow)
    reqs.append(eng.submit(follow, tokens))
    seconds2, steps2 = drive(torch, eng)
    launches = dict(LAUNCHES)
    apc_skipped = eng.stats["shared_prefix_tokens"] - skipped_before
    decode_steps = eng.stats["decode_chunks"] * eng.decode_chunk
    layers = len(lm16.params["layers"])
    if launches["paged_attention"] != decode_steps * layers:
        raise AssertionError(f"paged_attention launched {launches['paged_attention']} times, "
                             f"expected {decode_steps} steps x {layers} layers")
    if apc_skipped < eng.page_size:
        raise AssertionError("the follow-up request did not reuse the prefix cache's pages")
    if skipped_before < 3 * eng.page_size:
        raise AssertionError("the shared-prefix requests did not share their first page")
    if not all(r.finished and len(r.tokens) == tokens for r in reqs):
        raise AssertionError("a paged request did not produce its tokens")
    eng._evict_retired(eng.pool.num_pages)
    if eng.pool.free_pages != eng.pool.num_pages:
        raise AssertionError(f"{eng.pool.num_pages - eng.pool.free_pages} pages leaked")
    t0 = time.perf_counter()
    readings = stream_readings(torch, lm16, prompts, [r.tokens for r in reqs])
    log("COMPARED " + json.dumps(readings))
    check_streams(readings)
    chunk_ms = [1e3 * t for t, decode_only in steps + steps2 if decode_only]
    generated = sum(len(r.tokens) for r in reqs)
    info[key] = dict(
        requests=len(reqs), batch_size=8, decode_chunk=8, page_size=eng.page_size,
        num_pages=64, pool_gb=pool_bytes / 1e9, prompt_tokens=[len(p) for p in prompts],
        generated=generated, seconds=seconds + seconds2,
        aggregate_tok_s=generated / (seconds + seconds2),
        ms_per_chunk_median=statistics.median(chunk_ms), decode_only_chunks=len(chunk_ms),
        decode_tok_s_steady=8 * 8 / (statistics.median(chunk_ms) / 1e3),
        ttft_ms=[round(1e3 * r.ttft, 3) for r in reqs], decode_steps=decode_steps,
        prefill_chunks=eng.stats["prefill_chunks"], shared_prefix_tokens=skipped_before,
        prefix_cache_tokens=apc_skipped, **stream_summary(readings),
        compare_seconds=time.perf_counter() - t0, launches=launches,
        launches_per_decode_step={n: launches[n] / decode_steps for n in launches})
    log("PATH_" + key.upper() + " " + json.dumps(info[key]))
    return launches


def path_paged_int8(torch, model_dir: str, info: dict) -> dict:
    """PagedBatchEngine with INT8 pools over the 2-layer INT8 flagship:
    prefill through K4, decode through K6."""
    from uzu_tpu_torch.engine.engine import LanguageModel

    lm = LanguageModel.from_dir(model_dir, device="cuda", max_context=4096, kv_quant=True)
    return paged_int8_run(torch, lm, FLAGSHIP["vocab_size"], "paged_int8", info)


def paged_int8_run(torch, lm, vocab: int, key: str, info: dict) -> dict:
    """PagedBatchEngine with INT8 pools (8 slots, 64 pages) over `lm`
    (loaded with kv_quant): 6 of phase 4's requests, 32 tokens each, held
    to the INT8-KV single stream; K4 and K6 launched."""
    from uzu_tpu_torch.engine.paged_batch import PagedBatchEngine
    from uzu_tpu_torch.ops.cuda.build import LAUNCHES, reset_launches

    eng = PagedBatchEngine(lm, batch_size=8, decode_chunk=8, num_pages=64, stop_token_ids=[])
    prompts = paged_prompts(vocab)[:6]
    reset_launches()
    reqs = [eng.submit(p, 32) for p in prompts]
    seconds, _ = drive(torch, eng)
    launches = dict(LAUNCHES)
    for name in ("paged_attention_int8", "flash_attention_int8"):
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} was not launched on the INT8 paged path")
    readings = stream_readings(torch, lm, prompts, [r.tokens for r in reqs])
    log("COMPARED " + json.dumps(readings))
    check_streams(readings)
    info[key] = dict(requests=len(reqs), generated=sum(len(r.tokens) for r in reqs),
                     seconds=seconds, **stream_summary(readings), launches=launches,
                     decode_steps=eng.stats["decode_chunks"] * eng.decode_chunk,
                     prefill_chunks=eng.stats["prefill_chunks"])
    log("PATH_" + key.upper() + " " + json.dumps(info[key]))
    return launches


def moe_routing_has_no_host_sync(torch, lm) -> None:
    """Layer 0's MoE block at a single-stream decode step (1 row: K7) and a
    paged step of 8 slots (8 rows: K9) under the CUDA sync debug mode set
    to error: any call in the routing that waits for the device raises."""
    from uzu_tpu_torch.models.moe import moe_forward

    cfg = lm.decoder_config.transformer_config.layer_configs[0].mlp_config
    params = lm.params["layers"][0]["mlp"]
    gen = torch.Generator(device="cuda").manual_seed(10)
    for s in (1, 8):
        x = torch.randn((s, GPTOSS["model_dim"]), device="cuda", generator=gen)
        x = x.to(torch.bfloat16)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            moe_forward(cfg, params, x)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()


def path_gptoss_int4(torch, model_dir: str, info: dict):
    from uzu_tpu_torch.engine.engine import LanguageModel

    lm = LanguageModel.from_dir(model_dir, device="cuda", max_context=4096)
    moe_routing_has_no_host_sync(torch, lm)
    single_stream_run(torch, lm, GPTOSS["vocab_size"], "gptoss_int4",
                      ("moe_gemv_int4", "grouped_matmul_int4", "flash_attention"), info)
    return lm


def router_margins(torch, lm, prompt, tokens, step) -> list[float]:
    """Per layer, the gap between the K-th and the (K+1)-th router logit on
    the teacher-forced row that picks tokens[step]: how near the routing of
    that row is to a tie."""
    import uzu_tpu_torch.models.moe as moe
    from uzu_tpu_torch.models.decoder import decoder_forward

    seen = []
    real = moe.router_topk

    def spy(cfg, params, x):
        logits = router_logits(params, x[-1:])[0]
        top = torch.topk(logits, cfg.num_active_routed_experts + 1).values
        seen.append(top[-2] - top[-1])
        return real(cfg, params, x)

    seq = torch.as_tensor(list(prompt) + list(tokens[:step]), device="cuda")
    moe.router_topk = spy
    try:
        decoder_forward(lm.decoder_config, lm.params, seq, lm.new_state())
    finally:
        moe.router_topk = real
    return [float(m) for m in seen]


def recorded_routes(torch, eng):
    """Patch the paged engine's decode step so that each step records, for
    every occupied slot, the expert ids its MoE layers chose. Returns
    (restore, routes_of): routes_of(request) is that request's {position:
    ([layers, K] ids, [layers, D] MoE inputs)}, taken from the step that
    fed the token at each position (a halted slot repeats its last
    position; the first step at a position is the one that fed it)."""
    import uzu_tpu_torch.engine.paged_batch as pb
    import uzu_tpu_torch.models.moe as moe

    real_step = pb.paged_decode_step
    steps = []

    def step(cfg, params, pools, tokens, tables, positions):
        live = [(b, s.request) for b, s in enumerate(eng.slots) if not s.free]
        real_topk, ids, xs = moe.router_topk, [], []

        def topk(c, p, x):
            out = real_topk(c, p, x)
            ids.append(out[0])
            xs.append(x.float())
            return out

        moe.router_topk = topk
        try:
            logits = real_step(cfg, params, pools, tokens, tables, positions)
        finally:
            moe.router_topk = real_topk
        steps.append((live, positions, torch.stack(ids, 1), torch.stack(xs, 1)))
        return logits

    def restore():
        pb.paged_decode_step = real_step

    host = []  # each step's positions, read once after the run

    def routes_of(req):
        if not host:
            host.extend(torch.stack([pos for _, pos, _, _ in steps]).tolist())
        out = {}
        for (live, _, ids, xs), pos in zip(steps, host):
            for b, r in live:
                if r is req:
                    out.setdefault(pos[b], (ids[b], xs[b]))
        return out

    pb.paged_decode_step = step
    return restore, routes_of


def run_paged_routed(torch, eng, prompts, tokens: int):
    """Submit `prompts`, run the engine to idle while recording its expert
    choices; returns (requests, seconds, per-step times, routes per
    request)."""
    restore, routes_of = recorded_routes(torch, eng)
    try:
        reqs = [eng.submit(p, tokens) for p in prompts]
        seconds, steps = drive(torch, eng)
    finally:
        restore()
    if any(r.preempted for r in reqs):
        raise AssertionError("a request was preempted: its recorded routes would mix runs")
    return reqs, seconds, steps, [routes_of(r) for r in reqs]


def path_paged_gptoss(torch, lm, info: dict) -> dict:
    """PagedBatchEngine over the 4-layer INT4 gpt-oss model: admission
    chunks and decode steps both route their rows through K9. The streams
    are held to the single stream (K7 in decode) that takes the paged
    engine's expert choices, under check_streams and check_routing; the
    same streams against the free single stream are reported, with the
    router margins where the first one parts."""
    from uzu_tpu_torch.engine.paged_batch import PagedBatchEngine
    from uzu_tpu_torch.ops.cuda.build import LAUNCHES, reset_launches

    eng = PagedBatchEngine(lm, batch_size=8, decode_chunk=8, num_pages=64, stop_token_ids=[])
    prompts = paged_prompts(GPTOSS["vocab_size"])
    reset_launches()
    reqs, seconds, steps, routes = run_paged_routed(torch, eng, prompts, PAGED_TOKENS)
    launches = dict(LAUNCHES)
    decode_steps = eng.stats["decode_chunks"] * eng.decode_chunk
    chunks = eng.stats["prefill_chunks"]
    layers = len(lm.params["layers"])
    if launches["paged_attention"] != decode_steps * layers:
        raise AssertionError(f"paged_attention launched {launches['paged_attention']} times, "
                             f"expected {decode_steps} steps x {layers} layers")
    if launches["grouped_matmul_int4"] != 2 * layers * (decode_steps + chunks):
        raise AssertionError(f"grouped_matmul_int4 launched {launches['grouped_matmul_int4']} "
                             f"times, expected 2 x {layers} layers x ({decode_steps} decode "
                             f"steps + {chunks} prefill chunks)")
    if not all(r.finished and len(r.tokens) == PAGED_TOKENS for r in reqs):
        raise AssertionError("a paged gpt-oss request did not produce its tokens")
    eng._evict_retired(eng.pool.num_pages)
    if eng.pool.free_pages != eng.pool.num_pages:
        raise AssertionError(f"{eng.pool.num_pages - eng.pool.free_pages} pages leaked")
    streams = [r.tokens for r in reqs]
    free = stream_readings(torch, lm, prompts, streams)
    readings = stream_readings(torch, lm, prompts, streams, routes)
    log("COMPARED " + json.dumps([{k: v for k, v in r.items() if k != "moe_input_dist"}
                                  for r in readings]))
    i, r = next(((i, r) for i, r in enumerate(free) if r["parted_at"] is not None), (0, free[0]))
    step = r["parted_at"] or 0
    chunk_ms = [1e3 * t for t, decode_only in steps if decode_only]
    generated = sum(len(r.tokens) for r in reqs)
    info["paged_gptoss"] = dict(
        requests=len(reqs), batch_size=8, decode_chunk=8, page_size=eng.page_size,
        prompt_tokens=[len(p) for p in prompts], generated=generated, seconds=seconds,
        aggregate_tok_s=generated / seconds,
        ms_per_chunk_median=statistics.median(chunk_ms) if chunk_ms else None,
        decode_only_chunks=len(chunk_ms),
        decode_tok_s_steady=8 * 8 / (statistics.median(chunk_ms) / 1e3) if chunk_ms else None,
        ttft_ms=[round(1e3 * r.ttft, 3) for r in reqs], decode_steps=decode_steps,
        prefill_chunks=chunks, **stream_summary(readings),
        free_single_stream=dict(stream_summary(free), first_parted=dict(
            request=i, step=step, margin_there=r["margin_there"],
            router_kth_minus_next_per_layer=router_margins(
                torch, lm, prompts[i], streams[i], step))),
        launches=launches,
        grouped_matmul_int4_per_decode_step=(
            launches["grouped_matmul_int4"] - 2 * layers * chunks) / decode_steps,
        paged_attention_per_decode_step=launches["paged_attention"] / decode_steps)
    log("PATH_PAGED_GPTOSS " + json.dumps(info["paged_gptoss"]))
    check_streams(readings)
    check_routing(readings)
    return launches


def path_gptoss_int8(torch, model_dir: str, info: dict) -> dict:
    """The 2-layer INT8-expert gpt-oss model with a 1024-row prefill bucket:
    an 1100-token prompt takes one 1024-row chunk (dequantized stacks, K10)
    and one 256-row chunk (masked loop); decode takes K8."""
    from uzu_tpu_torch.engine.engine import LanguageModel, StreamMetrics
    from uzu_tpu_torch.ops.cuda.build import LAUNCHES, reset_launches

    lm = LanguageModel.from_dir(model_dir, device="cuda", max_context=4096,
                                prefill_buckets=(16, 64, 256, 1024))
    metrics = StreamMetrics()
    reset_launches()
    toks = lm.generate_list(prompt_tokens(1100, GPTOSS["vocab_size"]), 16, stop_token_ids=[],
                            metrics=metrics)
    torch.cuda.synchronize()
    launches = dict(LAUNCHES)
    for name in ("grouped_matmul", "moe_gemv_int8"):
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} was not launched on the INT8-expert path")
    if len(toks) != 16:
        raise AssertionError(f"expected 16 tokens, got {len(toks)}")
    info["gptoss_int8"] = dict(prompt=1100, generated=len(toks), tokens_head=toks,
                               launches=launches,
                               prefill_tok_s=metrics.prefill_tokens_per_second,
                               decode_tok_s=metrics.decode_tokens_per_second)
    log("GPTOSS_INT8 " + json.dumps(info["gptoss_int8"]))
    return launches


def control_planted_faults(torch, lm16, info: dict) -> None:
    """The stream check held to planted faults in the paged decode step,
    each wrapping the K5 wrapper where `models/paged_decode.py` calls it
    (the package is untouched): K5 sees the next slot's page table, or
    each slot's length minus one (the newest token dropped). Four requests
    of 2 to 129 prompt tokens make CONTROL_TOKENS tokens each per fault;
    each fault's streams must fail `check_streams`."""
    import uzu_tpu_torch.models.paged_decode as pd
    from uzu_tpu_torch.engine.paged_batch import PagedBatchEngine

    real = pd.paged_decode_attention
    faults = {
        "next_slot_table": lambda q, k, v, t, n, **kw: real(q, k, v, t.roll(-1, 0), n, **kw),
        "length_minus_one": lambda q, k, v, t, n, **kw: real(
            q, k, v, t, (n - 1).clamp(min=1), **kw),
    }
    prompts = [prompt_tokens(n, FLAGSHIP["vocab_size"]).tolist() for n in (2, 5, 17, 129)]
    out = {}
    for name, fault in faults.items():
        eng = PagedBatchEngine(lm16, batch_size=len(prompts), decode_chunk=8, num_pages=8,
                               stop_token_ids=[])
        pd.paged_decode_attention = fault
        try:
            reqs = [eng.submit(p, CONTROL_TOKENS) for p in prompts]
            eng.run()
        finally:
            pd.paged_decode_attention = real
        readings = stream_readings(torch, lm16, prompts, [r.tokens for r in reqs])
        try:
            check_streams(readings)
            caught = None
        except AssertionError as e:
            caught = str(e)
        out[name] = dict(stream_summary(readings), caught=caught)
        del eng
    info["control"] = dict(prompt_tokens=[len(p) for p in prompts], tokens=CONTROL_TOKENS,
                           faults=out)
    log("CONTROL " + json.dumps(info["control"]))
    missed = [name for name, r in out.items() if r["caught"] is None]
    if missed:
        raise AssertionError(f"the stream check passed planted faults: {missed}")


def control_moe_faults(torch, lm, info: dict) -> None:
    """The routed stream check of path_paged_gptoss held to planted faults
    in the paged engine's MoE blocks, each wrapped around a name that
    `models/moe.py` calls (the package is untouched): K9 multiplying each
    tile by the next expert's weights, and a router whose decode rows take
    the experts ranked K+1 to 2K. Four requests of 2 to 129 prompt tokens
    in 8 slots (so decode rows take K9) make CONTROL_TOKENS tokens each per
    fault; each fault's streams must fail check_streams or check_routing."""
    import uzu_tpu_torch.models.moe as moe
    from uzu_tpu_torch.engine.paged_batch import PagedBatchEngine

    e = GPTOSS["num_experts"]
    real_k9, real_topk = moe.grouped_matmul_quant, moe.router_topk

    def next_ranked(cfg, params, x):
        if x.shape[0] != 8:
            return real_topk(cfg, params, x)
        k = cfg.num_active_routed_experts
        vals, ids = torch.sort(router_logits(params, x), dim=-1, descending=True, stable=True)
        return ids[:, k:2 * k], torch.softmax(vals[:, k:2 * k], -1)

    faults = {
        "k9_next_expert": ("grouped_matmul_quant",
                           lambda x, sq, te, used: real_k9(x, sq, (te + 1) % e, used)),
        "router_next_ranked": ("router_topk", next_ranked),
    }
    prompts = [prompt_tokens(n, GPTOSS["vocab_size"]).tolist() for n in (2, 5, 17, 129)]
    out = {}
    for name, (attr, fault) in faults.items():
        eng = PagedBatchEngine(lm, batch_size=8, decode_chunk=8, num_pages=8,
                               stop_token_ids=[])
        real = getattr(moe, attr)
        setattr(moe, attr, fault)
        try:
            reqs, _, _, routes = run_paged_routed(torch, eng, prompts, CONTROL_TOKENS)
        finally:
            setattr(moe, attr, real)
        readings = stream_readings(torch, lm, prompts, [r.tokens for r in reqs], routes)
        caught = []
        for check in (check_streams, check_routing):
            try:
                check(readings)
            except AssertionError as err:
                caught.append(str(err))
        out[name] = dict(stream_summary(readings), caught=caught)
        del eng
    info["control_moe"] = dict(prompt_tokens=[len(p) for p in prompts], tokens=CONTROL_TOKENS,
                               faults=out)
    log("CONTROL_MOE " + json.dumps(info["control_moe"]))
    missed = [name for name, r in out.items() if not r["caught"]]
    if missed:
        raise AssertionError(f"the routed stream check passed planted faults: {missed}")


def first_layers(lm, layers: int, device: str, **kw):
    """`lm` cut to its first `layers` layers, as a LanguageModel on
    `device` with 1024 slots of context (its parameters shared where the
    device is the same); `kw` goes to LanguageModel."""
    from uzu_tpu_torch.engine.engine import LanguageModel

    cfg = lm.config
    tcfg = cfg.decoder_config.transformer_config
    dcfg = dataclasses.replace(cfg.decoder_config, transformer_config=dataclasses.replace(
        tcfg, layer_configs=tcfg.layer_configs[:layers]))
    return LanguageModel(dataclasses.replace(cfg, decoder_config=dcfg),
                         dict(lm.params, layers=lm.params["layers"][:layers]),
                         device=device, max_context=1024, **kw)


def whole_path_check(torch, lm, layers: int, vocab: int, key: str, info: dict,
                     f32: bool = False) -> None:
    """Teacher-forced logits of the first `layers` layers of `lm` for a
    32-token prompt, on the card and through the port's plain path on the
    host CPU. For an MoE model the CPU pass takes the card's expert
    choices (each a near-tie of its own router, check_routing; a flipped
    expert would move its row far past the tolerance), and the free CPU
    pass is reported beside it.

    With `f32` (the hybrids) the two passes held to TOL carry f32
    activations (the embedding rows upcast, so every layer and kernel runs
    its f32 route): in bf16 each layer's rounding flips add ~1e-2 of
    relative L2 wherever the two paths round differently, and at 4 layers
    the host's bf16 plain path alone lies ~2.7e-2 from the f32 one.
    The served bf16 passes are then measured against that f32 host pass:
    the card's distance may be at most F32_REF_RATIO times the host's."""
    import uzu_tpu_torch.models.decoder as dec
    import uzu_tpu_torch.models.moe as moe

    toks = prompt_tokens(32, vocab)
    card_routes = []
    real = moe.router_topk
    real_embed = dec.embed

    def forward(dev, router, upcast=False):
        lm2 = first_layers(lm, layers, dev)
        t = torch.as_tensor(toks, dtype=torch.int64, device=dev)
        moe.router_topk = router
        if upcast:
            dec.embed = lambda cfg, params, tokens: real_embed(cfg, params, tokens).float()
        try:
            out, _ = dec.decoder_forward(lm2.decoder_config, lm2.params, t, lm2.new_state(),
                                         last_only=False)
        finally:
            moe.router_topk = real
            dec.embed = real_embed
        return out.float().cpu()

    def recording(c, p, x):
        out = real(c, p, x)
        card_routes.append(out[0].cpu())
        return out

    card = forward("cuda", recording, f32)
    replay = iter(card_routes)
    pinned, gaps = pinned_router(torch, lambda x: next(replay))
    host = forward("cpu", pinned, f32)

    def rel(a, b):
        return ((a - b).norm() / b.norm()).item()

    info[key] = dict(tokens=len(toks), layers=layers, rel_l2=rel(card, host), tol=TOL,
                     activations="f32" if f32 else "bf16",
                     finite=bool(torch.isfinite(card).all()))
    if f32:
        card_bf16, host_bf16 = forward("cuda", real), forward("cpu", real)
        info[key].update(rel_l2_bf16=rel(card_bf16, host_bf16),
                         card_bf16_vs_f32_host=rel(card_bf16, host),
                         host_bf16_vs_f32_host=rel(host_bf16, host),
                         f32_ref_ratio=F32_REF_RATIO)
    if card_routes:
        rg = torch.cat(gaps).double().tolist()
        info[key].update(routed_rows=len(rg), router_flips=sum(g > 0 for g in rg),
                         max_router_gap=max(rg),
                         rel_l2_free_host_routing=rel(card, forward("cpu", real)))
    log(key.upper() + " " + json.dumps(info[key]))
    if not (info[key]["rel_l2"] <= TOL) or not info[key]["finite"]:
        raise AssertionError(f"{key}: card vs CPU logits: relative L2 "
                             f"{info[key]['rel_l2']:.3e} > {TOL}")
    if f32 and not (info[key]["card_bf16_vs_f32_host"]
                    <= F32_REF_RATIO * info[key]["host_bf16_vs_f32_host"]):
        raise AssertionError(f"{key}: the card's bf16 logits lie farther from the f32 host "
                             f"pass than {F32_REF_RATIO}x the host's bf16 logits do")
    if card_routes:
        check_routing([dict(max_router_gap=info[key]["max_router_gap"])])


# -- phases 11-13: the hybrid recurrent families, dense batching, sampling ---------


def path_hybrid(torch, model_dir: str, info: dict):
    """The Qwen3.5-class hybrid at full width (18 Gated DeltaNet layers, 6
    attention layers at Dh 32): GEN_TOKENS greedy tokens after a
    GEN_PROMPT-token prompt, twice, identical; the 128-row prefill runs
    the chunked GDN core; K1 and K3 launched."""
    from uzu_tpu_torch.engine.engine import LanguageModel

    lm = LanguageModel.from_dir(model_dir, device="cuda", max_context=4096)
    single_stream_run(torch, lm, QWEN08["vocab_size"], "hybrid_path",
                      ("quant_matmul_int4", "flash_attention"), info)
    return lm


def hybrid_chunking_check(torch, lm, info: dict) -> None:
    """The hybrid's first 4 layers (3 GDN, 1 attention) on the card: a
    128-token prompt prefilled in one 256-row bucket (the chunked cores)
    against the same prompt fed one token at a time (the per-token
    recurrence); the last logits within TOL relative L2."""
    prompt = prompt_tokens(GEN_PROMPT, QWEN08["vocab_size"])
    chunked = first_layers(lm, 4, "cuda")
    stepped = first_layers(lm, 4, "cuda", prefill_buckets=(1,))
    a, sa = chunked.prefill(chunked.new_state(), prompt)
    b, sb = stepped.prefill(stepped.new_state(), prompt)
    rel = ((a.float() - b.float()).norm() / b.float().norm()).item()
    state_rel = max(((x.float() - y.float()).norm() / y.float().norm()).item()
                    for la, lb in zip(sa["layers"], sb["layers"]) if "ssm" in la
                    for x, y in ((la["ssm"], lb["ssm"]), (la["conv"], lb["conv"])))
    info["hybrid_chunking"] = dict(prompt=len(prompt), layers=4, rel_l2=rel,
                                   state_rel_l2_max=state_rel, tol=TOL,
                                   finite=bool(torch.isfinite(a).all()))
    log("HYBRID_CHUNKING " + json.dumps(info["hybrid_chunking"]))
    if not (rel <= TOL) or not info["hybrid_chunking"]["finite"]:
        raise AssertionError(f"hybrid: chunked vs token-at-a-time prefill: relative L2 "
                             f"{rel:.3e} > {TOL}")


def path_recurrent_families(torch, dirs: dict, info: dict) -> None:
    """ShortConv (LFM2-style) and Mamba2 hybrids at 4 layers, d 1024, on
    the card against the host CPU (teacher-forced logits of a 32-token
    prompt with f32 activations within TOL relative L2, the served bf16
    ones against those, see whole_path_check), with 16 greedy tokens each."""
    from uzu_tpu_torch.engine.engine import LanguageModel

    for key, name, vocab in (("lfm2", "lfm2_4l", LFM2_4L["vocab_size"]),
                             ("mamba2", "mamba2_4l", MAMBA2_4L["vocab_size"])):
        lm = LanguageModel.from_dir(dirs[name], device="cuda", max_context=1024)
        toks = lm.generate_list(prompt_tokens(40, vocab), 16, stop_token_ids=[])
        if len(toks) != 16:
            raise AssertionError(f"{key}: expected 16 tokens, got {len(toks)}")
        whole_path_check(torch, lm, 4, vocab, f"whole_path_{key}", info, True)
        info[f"whole_path_{key}"]["tokens_head"] = toks
        del lm
        torch.cuda.empty_cache()


def batched_prompts(vocab: int):
    """6 prompts of 17 to 300 tokens."""
    import numpy as np

    return [((np.arange(n) * (29 + 2 * i) + 53 * i + 5) % vocab).tolist()
            for i, n in enumerate((17, 300, 64, 129, 33, 200))]


def run_batched(torch, lm, prompts, tokens: int):
    """The dense BatchEngine (4 slots, 8-step chunks) over `prompts`, each
    asking `tokens` greedy tokens: four admitted at once, the other two as
    slots free up. Returns (requests, engine, seconds, steps, K1's row
    counts M seen)."""
    from uzu_tpu_torch.engine.batch import BatchEngine
    from uzu_tpu_torch.ops import linear

    eng = BatchEngine(lm, batch_size=4, decode_chunk=8, stop_token_ids=[])
    real = linear.qmm.quant_matmul
    ms = set()

    def counting(w, x):
        ms.add(int(x.shape[0]))
        return real(w, x)

    linear.qmm.quant_matmul = counting
    try:
        reqs = [eng.submit(p, tokens) for p in prompts]
        seconds, steps = drive(torch, eng)
    finally:
        linear.qmm.quant_matmul = real
    return reqs, eng, seconds, steps, ms


def path_batched(torch, lm, info: dict, key: str = "batched", prompts=None) -> None:
    """BatchEngine over the full-width hybrid (or `lm` over `prompts`): 6
    greedy requests of 17-300 prompt tokens, 32 tokens each, 4 slots
    (admission while other slots decode); each stream held to the single
    stream under phase 4's rule; K1 launched at M = 4 (the decode step's
    rows)."""
    from uzu_tpu_torch.ops.cuda.build import LAUNCHES, reset_launches

    if prompts is None:
        prompts = batched_prompts(QWEN08["vocab_size"])
    reset_launches()
    reqs, eng, seconds, steps, ms = run_batched(torch, lm, prompts, BATCHED_TOKENS)
    launches = dict(LAUNCHES)
    if not all(r.finished and len(r.tokens) == BATCHED_TOKENS for r in reqs):
        raise AssertionError("a batched request did not produce its tokens")
    if 4 not in ms or launches["quant_matmul_int4"] <= 0:
        raise AssertionError(f"K1 did not run at M = 4 in the batched step (M seen: {ms})")
    t0 = time.perf_counter()
    readings = stream_readings(torch, lm, prompts, [r.tokens for r in reqs])
    log("COMPARED_BATCHED " + json.dumps(readings))
    check_streams(readings)
    chunk_ms = [1e3 * t for t, decode_only in steps if decode_only]
    generated = sum(len(r.tokens) for r in reqs)
    info[key] = dict(
        requests=len(reqs), batch_size=4, decode_chunk=8,
        prompt_tokens=[len(p) for p in prompts], generated=generated, seconds=seconds,
        aggregate_tok_s=generated / seconds,
        ms_per_chunk_median=statistics.median(chunk_ms) if chunk_ms else None,
        decode_only_chunks=len(chunk_ms),
        decode_tok_s_steady=(4 * 8 / (statistics.median(chunk_ms) / 1e3)
                             if chunk_ms else None),
        ttft_ms=[round(1e3 * r.ttft, 3) for r in reqs], qmm_rows_seen=sorted(ms),
        prefill_chunks=eng.stats["prefill_chunks"], decode_chunks=eng.stats["decode_chunks"],
        **stream_summary(readings), compare_seconds=time.perf_counter() - t0,
        launches=launches)
    log("PATH_" + key.upper() + " " + json.dumps(info[key]))


def control_batched_fault(torch, lm, info: dict) -> None:
    """The batched stream check held to a planted fault: the batched step's
    recurrent mixers read the next slot's state (wrapping the name that
    `models/batch_decode.py` calls; the package is untouched). Its streams
    must fail `check_streams`."""
    import uzu_tpu_torch.models.batch_decode as bd

    real = bd.ssm_forward_batched

    def next_slot(cfg, params, x, state, fed):
        return real(cfg, params, x, {k: v.roll(-1, 0) for k, v in state.items()}, fed)

    prompts = batched_prompts(QWEN08["vocab_size"])[:4]
    bd.ssm_forward_batched = next_slot
    try:
        reqs, _, _, _, _ = run_batched(torch, lm, prompts, CONTROL_TOKENS)
    finally:
        bd.ssm_forward_batched = real
    readings = stream_readings(torch, lm, prompts, [r.tokens for r in reqs])
    try:
        check_streams(readings)
        caught = None
    except AssertionError as e:
        caught = str(e)
    info["control_batched"] = dict(stream_summary(readings), caught=caught,
                                   prompt_tokens=[len(p) for p in prompts],
                                   tokens=CONTROL_TOKENS)
    log("CONTROL_BATCHED " + json.dumps(info["control_batched"]))
    if caught is None:
        raise AssertionError("the batched stream check passed the next-slot-state fault")


# -- phase 14: the Gemma slice (ring KV, PLE, Dh 256) ---------------------------


def gemma_prompt(n: int, vocab: int, ple_vocab: int | None = None):
    """prompt_tokens(n, vocab); with `ple_vocab`, every 8th token is an id
    at or past it (those read the PLE table's zero rows)."""
    toks = prompt_tokens(n, vocab)
    if ple_vocab is not None:
        toks[3::8] = ple_vocab + (toks[3::8] % (vocab - ple_vocab))
    return toks


def teacher_forced_rel_l2(torch, lms, toks, chunk: int, f32: bool) -> float:
    """Relative L2 distance of lms[0]'s teacher-forced logits of `toks`
    from lms[1]'s, both fed in lockstep chunks of `chunk` rows (a ring
    takes chunks up to its ring_extra); with `f32` the embedding rows are
    upcast, so every layer and kernel runs its f32 route."""
    import uzu_tpu_torch.models.decoder as dec

    real_embed = dec.embed
    if f32:
        dec.embed = lambda cfg, params, tokens: real_embed(cfg, params, tokens).float()
    num = den = 0.0
    try:
        states = [m.new_state() for m in lms]
        for i in range(0, len(toks), chunk):
            t = torch.as_tensor(toks[i:i + chunk], dtype=torch.int64, device="cuda")
            outs = []
            for j, m in enumerate(lms):
                logits, states[j] = dec.decoder_forward(m.decoder_config, m.params, t,
                                                        states[j], last_only=False)
                outs.append(logits.float())
            if not all(bool(torch.isfinite(o).all()) for o in outs):
                raise AssertionError("non-finite teacher-forced logits")
            num += float((outs[0] - outs[1]).pow(2).sum())
            den += float(outs[1].pow(2).sum())
            del outs
    finally:
        dec.embed = real_embed
    return (num / den) ** 0.5


def path_gemma3(torch, model_dir: str, info: dict):
    """gemma3_1b (Gemma-3-1B's widths, 26 layers, Dh 256) single stream,
    full layout: GEN_TOKENS greedy tokens after a GEN_PROMPT-token prompt,
    twice, identical; K1 and K3 (Dh 256, windowed and global layers)
    launched."""
    from uzu_tpu_torch.engine.engine import LanguageModel

    lm = LanguageModel.from_dir(model_dir, device="cuda", max_context=4096)
    single_stream_run(torch, lm, GEMMA3_1B["vocab_size"], "gemma3_1b",
                      ("quant_matmul_int4", "flash_attention"), info)
    return lm


def gemma3_ring(torch, lm, info: dict):
    """gemma3_1b with `ring_windows=True` (each windowed layer keeps 512 +
    256 slots) against its full layout: teacher-forced logits of a
    1200-token prompt, fed in 256-row chunks, with f32 activations (held
    to TOL) and with the served bf16 ones (reported); then the ring's
    greedy stream after that prompt held to the full layout's single
    stream under phase 4's rule. Returns the ring model."""
    from uzu_tpu_torch.engine.engine import LanguageModel
    from uzu_tpu_torch.ops.cuda.build import LAUNCHES, reset_launches

    ring = LanguageModel(lm.config, lm.params, device="cuda", max_context=4096,
                         ring_windows=True)
    toks = prompt_tokens(1200, GEMMA3_1B["vocab_size"])
    c = ring.new_state()["layers"][0]["k"].shape[0]
    rel = teacher_forced_rel_l2(torch, (ring, lm), toks, 256, f32=True)
    rel_bf16 = teacher_forced_rel_l2(torch, (ring, lm), toks, 256, f32=False)
    reset_launches()
    stream = ring.generate_list(toks, BATCHED_TOKENS, stop_token_ids=[])
    torch.cuda.synchronize()
    launches = dict(LAUNCHES)
    readings = stream_readings(torch, lm, [toks], [stream])
    info["gemma3_1b_ring"] = dict(prompt=len(toks), ring_slots=c, rel_l2_f32=rel,
                                  rel_l2_bf16=rel_bf16, tol=TOL, generated=len(stream),
                                  **stream_summary(readings), launches=launches)
    log("GEMMA3_1B_RING " + json.dumps(info["gemma3_1b_ring"]))
    if not (rel <= TOL):
        raise AssertionError(f"gemma3_1b ring vs full layout: relative L2 {rel:.3e} > {TOL}")
    check_streams(readings)
    return ring


def gemma3_kv_int8(torch, lm, info: dict) -> dict:
    """gemma3_1b with the INT8 KV cache: prefill attention through K4 at
    Dh 256."""
    from uzu_tpu_torch.engine.engine import LanguageModel, StreamMetrics
    from uzu_tpu_torch.ops.cuda.build import LAUNCHES, reset_launches

    lm8 = LanguageModel(lm.config, lm.params, device="cuda", max_context=4096, kv_quant=True)
    metrics = StreamMetrics()
    reset_launches()
    toks = lm8.generate_list(prompt_tokens(GEN_PROMPT, GEMMA3_1B["vocab_size"]), 16,
                             stop_token_ids=[], metrics=metrics)
    torch.cuda.synchronize()
    launches = dict(LAUNCHES)
    if launches["flash_attention_int8"] <= 0:
        raise AssertionError("kernel flash_attention_int8 was not launched on gemma3_1b's "
                             "INT8-KV path")
    info["gemma3_1b_kv_int8"] = dict(generated=len(toks), tokens_head=toks[:16],
                                     launches=launches,
                                     prefill_tok_s=metrics.prefill_tokens_per_second,
                                     decode_tok_s=metrics.decode_tokens_per_second)
    log("GEMMA3_1B_KV_INT8 " + json.dumps(info["gemma3_1b_kv_int8"]))
    return launches


def gemma_batched_prompts(vocab: int, ple_vocab: int | None = None):
    """batched_prompts, with a 900-token one beside them (past a ring's
    512 + 256 slots); with `ple_vocab`, ids past it in every prompt."""
    out = batched_prompts(vocab) + [gemma_prompt(900, vocab).tolist()]
    if ple_vocab is not None:
        for p in out:
            p[3::8] = [ple_vocab + t % (vocab - ple_vocab) for t in p[3::8]]
    return out


def path_gemma_e4b(torch, model_dir: str, info: dict):
    """gemma_e4b_8l (Gemma-3n-E4B's text widths at 8 layers: PLE, Dh 256,
    KV sharing) with `ring_windows=True`: GEN_TOKENS greedy tokens after
    a GEN_PROMPT-token prompt holding ids past the PLE vocabulary, twice,
    identical; K1 and K3 (the global layers at Dh 256) launched."""
    from uzu_tpu_torch.engine.engine import LanguageModel

    lm = LanguageModel.from_dir(model_dir, device="cuda", max_context=4096, ring_windows=True)
    vocab = GEMMA_E4B["vocab_size"]
    single_stream_run(torch, lm, vocab, "gemma_e4b_8l", ("quant_matmul_int4", "flash_attention"),
                      info, prompt=gemma_prompt(GEN_PROMPT, vocab, GEMMA_E4B["ple_vocab"]))
    return lm


def batched_step_rel_l2(torch, lm, prompts, fault=None) -> list[float]:
    """Each slot's logits of one batched decode step (`batch_decode_step`
    over the prompts' single-stream states stacked on [B], as
    `BatchEngine` holds them) against the single stream's next-step
    logits from the same state: relative L2 per slot. `fault` wraps the
    batched step's `ple_apply` (the name `models/batch_decode.py` calls;
    the package is untouched)."""
    import numpy as np

    import uzu_tpu_torch.models.batch_decode as bd

    states, firsts = [], []
    for p in prompts:
        logits, st = lm.prefill(lm.new_state(), np.asarray(p))
        states.append(st)
        firsts.append(int(torch.argmax(logits)))
    batched = {"pos": torch.stack([st["pos"] for st in states]),
               "layers": [None if layer is None else {k: torch.stack(
                   [st["layers"][i][k] for st in states]) for k in layer}
                   for i, layer in enumerate(states[0]["layers"])]}
    tokens = torch.tensor(firsts, device="cuda")
    real = bd.ple_apply
    if fault is not None:
        bd.ple_apply = fault(real)
    try:
        got, _ = bd.batch_decode_step(lm.decoder_config, lm.params, tokens, batched,
                                      torch.ones(len(prompts), dtype=torch.int32,
                                                 device="cuda"))
    finally:
        bd.ple_apply = real
    out = []
    for b, (st, tok) in enumerate(zip(states, firsts)):
        want, _, _ = lm._forward(torch.tensor([tok], device="cuda"), st, 1, None)
        out.append(((got[b].float() - want.float()).norm() / want.float().norm()).item())
    return out


def control_ple_fault(torch, lm, info: dict) -> None:
    """gemma_e4b_8l's greedy streams on random weights repeat one token,
    so a stream check cannot see a PLE fault. So the batched step is held
    at the logits: each slot's logits of one `batch_decode_step` over 4
    slots (with the ring, ids past the PLE vocabulary in every prompt)
    within TOL relative L2 of the single stream's from the same state; and
    with a planted fault, the PLE projection dropped from slot 1's row,
    slot 1 must lie past TOL."""
    def dropped(real):
        def apply(layer_cfg, params, x, per_layer_input):
            out = real(layer_cfg, params, x, per_layer_input)
            if out is x or x.shape[0] < 2:
                return out
            out = out.clone()
            out[1] = x[1]
            return out
        return apply

    prompts = gemma_batched_prompts(GEMMA_E4B["vocab_size"], GEMMA_E4B["ple_vocab"])[:4]
    clean = batched_step_rel_l2(torch, lm, prompts)
    faulty = batched_step_rel_l2(torch, lm, prompts, dropped)
    info["control_ple"] = dict(prompt_tokens=[len(p) for p in prompts], rel_l2=clean,
                               rel_l2_fault=faulty, tol=TOL)
    log("CONTROL_PLE " + json.dumps(info["control_ple"]))
    if not max(clean) <= TOL:
        raise AssertionError(f"gemma_e4b_8l batched step vs single stream: relative L2 "
                             f"{max(clean):.3e} > {TOL}")
    if not faulty[1] > TOL:
        raise AssertionError("the batched logits check passed the dropped-PLE fault")


def timed_phase(info: dict, name: str, fn, *args):
    """fn(*args), its seconds recorded under info["phase_seconds"][name]."""
    t = time.perf_counter()
    out = fn(*args)
    info["phase_seconds"][name] = time.perf_counter() - t
    return out


def gemma_phases(torch, dirs: dict, info: dict) -> None:
    """Phase 14: gemma3_1b single stream, with the ring, with INT8 KV,
    paged (bf16 pools; INT8 pools at 2 layers), batched over rings and a
    profile of the ring's first prefill and decode chunk
    (`.port_cache/traces_gemma3_1b/`);
    gemma_e4b_8l single stream with the ring, card against host, batched
    over rings, and the dropped-PLE control."""
    phase = functools.partial(timed_phase, info)
    lm_g = phase("gemma3_1b", path_gemma3, torch, dirs["gemma3_1b"], info)
    lm_gr = phase("gemma3_1b_ring", gemma3_ring, torch, lm_g, info)
    phase("gemma3_1b_kv_int8", gemma3_kv_int8, torch, lm_g, info)
    phase("paged_gemma3_1b", paged_run, torch, lm_g, GEMMA3_1B["vocab_size"],
          "paged_gemma3_1b", info, GEMMA_PAGED_TOKENS)
    phase("paged_int8_gemma3_1b", paged_int8_run, torch,
          first_layers(lm_g, 2, "cuda", kv_quant=True), GEMMA3_1B["vocab_size"],
          "paged_int8_gemma3_1b", info)
    phase("batched_gemma3_1b", path_batched, torch, lm_gr, info, "batched_gemma3_1b",
          gemma_batched_prompts(GEMMA3_1B["vocab_size"]))
    phase("tools_profile_gemma3_1b", tools_profile, torch, lm_gr, "gemma3_1b",
          GEMMA3_1B["vocab_size"], info)
    del lm_g, lm_gr
    torch.cuda.empty_cache()
    lm_e = phase("gemma_e4b_8l", path_gemma_e4b, torch, dirs["gemma_e4b_8l"], info)
    phase("whole_path_gemma_e4b", whole_path_check, torch, lm_e, 4, GEMMA_E4B["vocab_size"],
          "whole_path_gemma_e4b", info, True)
    phase("batched_gemma_e4b", path_batched, torch, lm_e, info, "batched_gemma_e4b",
          gemma_batched_prompts(GEMMA_E4B["vocab_size"], GEMMA_E4B["ple_vocab"]))
    phase("control_ple", control_ple_fault, torch, lm_e, info)
    del lm_e
    torch.cuda.empty_cache()


# -- phase 15: HybridSpec linears, the engine API, Dh past 256 ---------------------


def path_hybrid_linear(torch, model_dir: str, info: dict):
    """The flagship with every linear HybridSpec (INT4 base, rank-16
    adapter, Hadamard incoherence) through `from_dir` on the card:
    GEN_TOKENS greedy tokens after a GEN_PROMPT-token prompt, twice,
    identical; K1 launched once per linear a decode step (4 a layer and
    the readout: 65), as in the plain flagship; decode tok/s beside the
    plain flagship's of this run."""
    from uzu_tpu_torch.engine.engine import LanguageModel
    from uzu_tpu_torch.quant.format import HybridLinear

    lm = LanguageModel.from_dir(model_dir, device="cuda", max_context=4096)
    w = lm.params["layers"][0]["mlp"]["up"]["w"]
    if not isinstance(w, HybridLinear) or w.adapter_down.shape[0] != HYBRID_RANK:
        raise AssertionError(f"the hybrid flagship's linears are not rank-{HYBRID_RANK} "
                             f"HybridLinears: {type(w).__name__}")
    # each row of an 8-row product is bitwise its one-row result (K1's
    # rows are; the Hadamard and adapter products run in f64), so the
    # batched engines' rows can match the single stream's
    from uzu_tpu_torch.ops.linear import hybrid_apply

    x = torch.randn((8, w.shape[1]), device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(8)).to(torch.bfloat16)
    rows_equal = torch.equal(hybrid_apply(w, x),
                             torch.cat([hybrid_apply(w, x[i:i + 1]) for i in range(8)]))
    log(f"HYBRID_ROWS {json.dumps(dict(m=8, bitwise_equal=rows_equal))}")
    if not rows_equal:
        raise AssertionError("hybrid_apply: a row of an 8-row product differs from its "
                             "one-row result")
    single_stream_run(torch, lm, FLAGSHIP["vocab_size"], "hybrid_linear_path",
                      ("quant_matmul_int4", "flash_attention"), info)
    rec = info["hybrid_linear_path"]
    rec["rows_bitwise_equal"] = rows_equal
    per_step = rec["launches_per_decode_step"]["quant_matmul_int4"]
    expected = 4 * len(lm.params["layers"]) + 1
    rec.update(adapter_rank=HYBRID_RANK, k1_per_decode_step_expected=expected,
               plain_flagship_decode_tok_s=info.get("int4_path", {}).get("decode_tok_s"))
    log("HYBRID_LINEAR " + json.dumps(dict(adapter_rank=HYBRID_RANK, k1_per_decode_step=per_step,
                                           decode_tok_s=rec["decode_tok_s"],
                                           plain_decode_tok_s=rec["plain_flagship_decode_tok_s"])))
    if per_step != expected:
        raise AssertionError(f"K1 launched {per_step} times a decode step, expected {expected}")
    return lm


def paged_few(torch, lm, vocab: int, key: str, info: dict, tokens: int = 32) -> dict:
    """PagedBatchEngine (4 slots, 8-step chunks, 32 pages of 512 tokens)
    over `lm`: 4 of phase 4's requests, `tokens` tokens each, held to the
    single stream under phase 4's rule; K5 launched once per layer per
    decode step."""
    from uzu_tpu_torch.engine.paged_batch import PagedBatchEngine
    from uzu_tpu_torch.ops.cuda.build import LAUNCHES, reset_launches

    eng = PagedBatchEngine(lm, batch_size=4, decode_chunk=8, num_pages=32, stop_token_ids=[])
    prompts = paged_prompts(vocab)[:4]
    reset_launches()
    reqs = [eng.submit(p, tokens) for p in prompts]
    seconds, _ = drive(torch, eng)
    launches = dict(LAUNCHES)
    decode_steps = eng.stats["decode_chunks"] * eng.decode_chunk
    layers = len(lm.params["layers"])
    if launches["paged_attention"] != decode_steps * layers:
        raise AssertionError(f"{key}: paged_attention launched {launches['paged_attention']} "
                             f"times, expected {decode_steps} steps x {layers} layers")
    if not all(r.finished and len(r.tokens) == tokens for r in reqs):
        raise AssertionError(f"{key}: a paged request did not produce its tokens")
    readings = stream_readings(torch, lm, prompts, [r.tokens for r in reqs])
    log("COMPARED " + json.dumps(readings))
    check_streams(readings)
    info[key] = dict(requests=len(reqs), generated=sum(len(r.tokens) for r in reqs),
                     seconds=seconds, decode_steps=decode_steps, **stream_summary(readings),
                     launches=launches)
    log("PATH_" + key.upper() + " " + json.dumps(info[key]))
    return launches


def logits_along(torch, lm, prompt, tokens):
    """f32 logits [len(tokens), V] of the single-stream path fed `tokens`
    after `prompt`: the prefill's last row, then one decode step per
    token (the steps generation ran to choose them)."""
    state = lm.new_state()
    logits, state = lm.prefill(state, prompt)
    rows = [logits.float()]
    for i, tok in enumerate(tokens[:-1]):
        logits, state, _ = lm._forward(torch.tensor([tok], device=logits.device), state, 1,
                                       lm._ctx_bucket(len(prompt) + i + 1))
        rows.append(logits.float())
    return torch.stack(rows)


def resumable_check(torch, lm, info: dict) -> None:
    """`generate_resumable` on the card. Two turns (the second continuing
    the first's state with its last token and a new prompt): `.state["pos"]`
    counts every token consumed, and each turn's stream is held under
    phase 4's rule to the single stream over its whole history, the
    second's being one `generate` over the concatenation of the first
    prompt, the first turn's tokens and the second prompt. With
    `logprobs=5`, each reported log-probability against the f32
    log-softmax of the card's own teacher-forced logits of the same
    history fed through the single-stream path (prefill, then one decode
    step per token: the kernels generation ran), within LOGPROB_TOL, and
    each token the top alternative. The same against one prefill chunk
    over the whole history is reported, with no limit: its K1 tile and K3
    round bf16 activations elsewhere than the decode step's kernels, and
    16 layers of such flips move the logits by a few percent (phase 10's
    whole-path readings)."""
    import numpy as np

    import uzu_tpu_torch.models.decoder as dec

    vocab = FLAGSHIP["vocab_size"]
    p1 = prompt_tokens(100, vocab).tolist()
    p2 = ((np.arange(40) * 53 + 9) % vocab).tolist()
    s1 = lm.generate_resumable(None, p1, 24, stop_token_ids=[])
    t1 = list(s1)
    pos1 = int(s1.state["pos"])
    s2 = lm.generate_resumable(s1.state, [t1[-1]] + p2, 24, stop_token_ids=[])
    t2 = list(s2)
    pos2 = int(s2.state["pos"])
    whole = lm.generate_list(p1 + t1 + p2, 24, stop_token_ids=[])
    if (pos1, pos2) != (len(p1) + len(t1) - 1, pos1 + 1 + len(p2) + len(t2) - 1):
        raise AssertionError(f"resumable: state positions {pos1}, {pos2} do not count the "
                             "tokens consumed")
    readings = stream_readings(torch, lm, [p1, p1 + t1 + p2], [t1, t2])
    log("COMPARED " + json.dumps(readings))
    check_streams(readings)

    s3 = lm.generate_resumable(None, p1, 16, stop_token_ids=[], logprobs=5)
    t3 = list(s3)
    along = torch.log_softmax(logits_along(torch, lm, p1, t3), dim=-1).cpu()
    hist = torch.as_tensor(p1 + t3, dtype=torch.int64, device="cuda")
    logits, _ = dec.decoder_forward(lm.decoder_config, lm.params, hist, lm.new_state(),
                                    last_only=False)
    chunk = torch.log_softmax(logits[len(p1) - 1:-1].float(), dim=-1).cpu()
    lp_err, top_err, chunk_err = [], [], []
    for i, (tok, (lp, tops)) in enumerate(zip(t3, s3.logprob_content)):
        lp_err.append(abs(lp - float(along[i, tok])))
        top_err.append(max(abs(v - float(along[i, j])) for j, v in tops))
        chunk_err.append(max(abs(v - float(chunk[i, j])) for j, v in [(tok, lp), *tops]))
        if tops[0][0] != tok or tops[0][1] != lp or len(tops) != 5:
            raise AssertionError(f"resumable: logprob entry {i} does not lead with its token")
    info["resumable"] = dict(
        turn_tokens=[len(t1), len(t2)], positions=[pos1, pos2],
        second_turn_equals_one_generate=sum(a == b for a, b in zip(t2, whole)),
        **stream_summary(readings), logprob_entries=len(s3.logprob_content),
        max_logprob_err=max(lp_err), max_top5_err=max(top_err), logprob_tol=LOGPROB_TOL,
        max_err_against_one_chunk=max(chunk_err))
    log("RESUMABLE " + json.dumps(info["resumable"]))
    if len(s3.logprob_content) != len(t3) or max(lp_err + top_err) > LOGPROB_TOL:
        raise AssertionError(f"resumable: logprobs {max(lp_err + top_err):.3e} from the "
                             f"teacher-forced log-softmax (limit {LOGPROB_TOL})")


def context_and_read_check(torch, lm, model_dir: str, info: dict) -> None:
    """`recommended_max_context` for the hybrid flagship on the card (the
    card's memory as the budget), a state of that context allocated; and
    `read_many` against sequential `read` over the model's file: the same
    bytes, both times."""
    import numpy as np

    from uzu_tpu_torch.engine.engine import LanguageModel
    from uzu_tpu_torch.params.safetensors_io import SafetensorsFile

    ctx = lm.recommended_max_context()
    ctx4 = lm.recommended_max_context(batch_size=4)
    lm_ctx = LanguageModel(lm.config, lm.params, device="cuda", max_context=ctx)
    before = torch.cuda.memory_allocated()
    state = lm_ctx.new_state()
    torch.cuda.synchronize()
    state_bytes = torch.cuda.memory_allocated() - before
    del state, lm_ctx
    f = SafetensorsFile(os.path.join(model_dir, "model.safetensors"))
    t0 = time.perf_counter()
    many = f.read_many()
    t_many = time.perf_counter() - t0
    t0 = time.perf_counter()
    one = {n: f.read(n) for n in f.tensors}
    t_one = time.perf_counter() - t0
    equal = all(np.array_equal(many[n].view(np.uint8), one[n].view(np.uint8)) for n in one)
    nbytes = sum(a.nbytes for a in one.values())
    info["context_and_read"] = dict(
        recommended_max_context=ctx, recommended_max_context_batch4=ctx4,
        card_total_bytes=torch.cuda.mem_get_info()[1], state_bytes=state_bytes,
        file_bytes=nbytes, tensors=len(one), read_many_s=t_many, read_s=t_one,
        read_many_equal=equal)
    log("CONTEXT_AND_READ " + json.dumps(info["context_and_read"]))
    if not equal:
        raise AssertionError("read_many and read give different bytes")
    if not (1024 <= ctx <= FLAGSHIP["max_seq"]) or state_bytes <= 0:
        raise AssertionError(f"recommended_max_context {ctx}: no state allocated")


def path_wide_heads(torch, dirs: dict, info: dict) -> None:
    """The synthetic Dh-512 models (2 layers at gemma_e4b_8l's other
    widths): gemma_config single stream, twice, identical, K3 at Dh 512
    launched, and card against host (f32 activations, TOL);
    windowed_config (no PLE) through PagedBatchEngine, K5 at Dh 512
    launched, and card against host."""
    from uzu_tpu_torch.engine.engine import LanguageModel

    vocab = WIDE_GEMMA["vocab_size"]
    lm = LanguageModel.from_dir(dirs["gemma_dh512_2l"], device="cuda", max_context=4096)
    single_stream_run(torch, lm, vocab, "gemma_dh512", ("quant_matmul_int4", "flash_attention"),
                      info, prompt=gemma_prompt(GEN_PROMPT, vocab, WIDE_GEMMA["ple_vocab"]))
    whole_path_check(torch, lm, 2, vocab, "whole_path_gemma_dh512", info, True)
    del lm
    lm_w = LanguageModel.from_dir(dirs["windowed_dh512_2l"], device="cuda", max_context=4096)
    paged_few(torch, lm_w, vocab, "paged_windowed_dh512", info)
    whole_path_check(torch, lm_w, 2, vocab, "whole_path_windowed_dh512", info, True)
    del lm_w
    torch.cuda.empty_cache()


def slice_phases(torch, dirs: dict, info: dict) -> None:
    """Phase 15: the hybrid-linear flagship single stream, card against
    host, paged; `generate_resumable` with logprobs; the recommended
    context and the parallel read; the Dh-512 models."""
    phase = functools.partial(timed_phase, info)
    lm = phase("hybrid_linear", path_hybrid_linear, torch, dirs["llama1b_hybrid"], info)
    phase("whole_path_hybrid_linear", whole_path_check, torch, lm, 2, FLAGSHIP["vocab_size"],
          "whole_path_hybrid_linear", info, True)
    phase("paged_hybrid_linear", paged_few, torch, lm, FLAGSHIP["vocab_size"],
          "paged_hybrid_linear", info)
    phase("resumable", resumable_check, torch, lm, info)
    phase("context_and_read", context_and_read_check, torch, lm, dirs["llama1b_hybrid"], info)
    del lm
    torch.cuda.empty_cache()
    phase("wide_heads", path_wide_heads, torch, dirs, info)


def plain_allowed(torch, logits, sp, ring=None):
    """The tokens the plain sampling path allows from f32 logits [V]: the
    repetition penalty over `ring`, the temperature, then the top-k, top-p
    and min-p masks (`engine/sampling.py`'s single-stream functions)."""
    from uzu_tpu_torch.engine import sampling as smp

    x = logits.float()
    if sp.repetition_penalty is not None and ring is not None:
        x = smp.apply_repetition_penalty(x, ring, sp.repetition_penalty)
    x = x / sp.temperature
    if sp.top_k:
        x = smp._mask_top_k(x, sp.top_k)
    if sp.top_p is not None:
        x = smp._mask_top_p(x, sp.top_p)
    if sp.min_p:
        x = smp._mask_min_p(x, sp.min_p)
    return x > 0.5 * smp.NEG_INF


def sample_miss(torch, logits, sp, tok: int) -> dict:
    """Where a sampled token lies against each mask, in f64: its rank, the
    probability mass of the tokens above it after top-k (top-p keeps it
    while that mass is below p), and its probability over the largest."""
    x = logits.double() / sp.temperature
    rank = int((x > x[tok]).sum())
    if sp.top_k:
        x = torch.where(x < torch.topk(x, sp.top_k).values[-1], torch.full_like(x, -1e300), x)
    p = torch.softmax(x, dim=-1)
    return dict(token=tok, rank=rank, mass_above=float(p[x > x[tok]].sum()),
                prob_over_max=float(p[tok] / p.max()), top_k=sp.top_k, top_p=sp.top_p,
                min_p=sp.min_p)


def path_sampled(torch, lm16, info: dict) -> None:
    """Sampled decoding on the flagship, single stream (temperature, top-k,
    top-p, min-p and a repetition penalty over a 16-token ring) and through
    the BatchEngine (three requests with their own temperature, top-k,
    top-p and min-p; the repetition penalty has no per-slot ring in batched
    serving): the same seed gives the same tokens twice, and every sampled
    token lies inside the masks the plain path computes from the logits
    the card sampled it from (recorded where the engines call the
    sampler)."""
    import uzu_tpu_torch.engine.engine as eng_mod
    from uzu_tpu_torch.engine.batch import BatchEngine
    from uzu_tpu_torch.engine.sampling import SamplingParams

    vocab = FLAGSHIP["vocab_size"]
    prompt = prompt_tokens(GEN_PROMPT, vocab)
    sp = SamplingParams(temperature=0.8, top_k=50, top_p=0.9, min_p=0.05,
                        repetition_penalty=1.3, suffix_repetition_length=16)
    real = eng_mod.sample
    runs = []
    for _ in range(2):
        seen = []

        def recording(logits, params, generator=None, ring=None, bitmask=None):
            tok = real(logits, params, generator=generator, ring=ring, bitmask=bitmask)
            seen.append((logits.detach().clone(), None if ring is None else ring.clone(), tok))
            return tok

        eng_mod.sample = recording
        try:
            toks = lm16.generate_list(prompt, SAMPLED_TOKENS, sampling=sp, seed=5,
                                      stop_token_ids=[])
        finally:
            eng_mod.sample = real
        runs.append((toks, seen))
    (toks, seen), (toks2, _) = runs
    if toks != toks2:
        raise AssertionError(f"sampled single stream differs between runs:\n{toks}\n{toks2}")
    outside = 0
    for (logits, ring, tok), want in zip(seen, toks):
        if int(tok) != want:
            raise AssertionError("the recorded samples are not the stream's tokens")
        outside += not bool(plain_allowed(torch, logits, sp, ring)[want])
    single = dict(tokens=len(toks), tokens_head=toks[:16], distinct=len(set(toks)),
                  outside_masks=outside, greedy_equal=None)
    single["greedy_equal"] = toks == lm16.generate_list(prompt, SAMPLED_TOKENS,
                                                        stop_token_ids=[])

    per_req = [SamplingParams(temperature=t, top_k=k, top_p=p, min_p=m)
               for t, k, p, m in ((0.7, 40, 0.95, 0.0), (1.0, 0, 0.8, 0.1),
                                  (0.9, 20, 1.0, 0.05))]
    prompts = [prompt_tokens(n, vocab).tolist() for n in (17, 64, 129)]
    batched = []
    for _ in range(2):
        eng = BatchEngine(lm16, batch_size=4, decode_chunk=8, stop_token_ids=[])
        rec = []
        real_rows = eng._sample_rows

        def rows_recording(logits, rows, key0, key1, sampled, counts=None, bitmask=None,
                           _r=real_rows, _rec=rec):
            out = _r(logits, rows, key0, key1, sampled, counts, bitmask)
            _rec.append((logits.detach().clone(), rows.clone(), out))
            return out

        eng._sample_rows = rows_recording
        reqs = [eng.submit(p, SAMPLED_TOKENS, seed=11 + i, sampling=s)
                for i, (p, s) in enumerate(zip(prompts, per_req))]
        eng.run()
        batched.append(([r.tokens for r in reqs], rec))
    (streams, rec), (streams2, _) = batched
    if streams != streams2:
        raise AssertionError("sampled batched streams differ between runs")
    checked = b_outside = 0
    misses = []
    for logits, rows, out in rec:
        for r in range(logits.shape[0]):
            row = rows[r].tolist()
            if row[0] <= 0:  # a greedy (free or default) row
                continue
            srow = SamplingParams(temperature=row[0], top_k=int(row[1]) or None,
                                  top_p=row[2] if row[2] < 1.0 else None, min_p=row[3] or None)
            checked += 1
            tok = int(out[r])
            if not bool(plain_allowed(torch, logits[r], srow)[tok]):
                b_outside += 1
                misses.append(sample_miss(torch, logits[r], srow, tok))
    info["sampled"] = dict(single=single, batched=dict(
        requests=len(prompts), streams_head=[t[:8] for t in streams], checked_rows=checked,
        outside_masks=b_outside, misses=misses,
        params=[dataclasses.asdict(s) for s in per_req]))
    log("SAMPLED " + json.dumps(info["sampled"]))
    if outside or b_outside or not checked:
        raise AssertionError(f"sampled tokens outside the plain masks: {outside} single, "
                             f"{b_outside} batched of {checked}")


# -- phase 11: the measurement tools -----------------------------------------------


def trace_device_time(path: str) -> tuple[dict, float, float]:
    """Read a torch.profiler Chrome trace: ({kernel name: [launches, summed
    ms]}, device-busy ms (the union of the kernel, memcpy and memset
    intervals), window ms (from the first host op to the last event of the
    host or the device))."""
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X" and "dur" in e]
    device = [e for e in events if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    host = [e for e in events if e.get("cat") in ("cpu_op", "cuda_runtime", "cuda_driver")]
    if not device or not host:
        raise AssertionError(f"{path}: {len(device)} device and {len(host)} host events")
    kernels: dict = {}
    for e in device:
        if e["cat"] == "kernel":
            k = kernels.setdefault(e["name"], [0, 0.0])
            k[0] += 1
            k[1] += e["dur"] / 1e3
    busy, end = 0.0, float("-inf")
    for e in sorted(device, key=lambda e: e["ts"]):
        t0, t1 = float(e["ts"]), float(e["ts"]) + e["dur"]
        busy += max(0.0, t1 - max(t0, end))
        end = max(end, t1)
    start = min(float(e["ts"]) for e in host)
    stop = max(float(e["ts"]) + e["dur"] for e in host + device)
    return kernels, busy / 1e3, (stop - start) / 1e3


def tools_profile(torch, lm, model: str, vocab: int, info: dict) -> None:
    """One greedy generation of GEN_TOKENS after a GEN_PROMPT-token prompt
    with the prefill and decode captures armed: each phase must leave one
    trace that holds the kernels TRACE_KERNELS[model] names."""
    import shutil

    from uzu_tpu_torch.tools import profile

    out_dir = os.path.join(REPO, ".port_cache", "traces" if model == "flagship"
                           else f"traces_{model}")
    shutil.rmtree(out_dir, ignore_errors=True)
    os.environ.update(UZU_TPU_PROFILE="prefill,decode", UZU_TPU_PROFILE_DIR=out_dir)
    profile.reset()
    try:
        lm.generate_list(prompt_tokens(GEN_PROMPT, vocab), GEN_TOKENS, stop_token_ids=[])
    finally:
        del os.environ["UZU_TPU_PROFILE"], os.environ["UZU_TPU_PROFILE_DIR"]
        profile.reset()
    out = {}
    for phase, wanted in TRACE_KERNELS[model].items():
        found = [d for d in os.listdir(out_dir) if d.startswith(phase + "_")]
        if len(found) != 1:
            raise AssertionError(f"expected one {phase} trace in {out_dir}, found {found}")
        path = os.path.join(out_dir, found[0], "trace.json")
        kernels, busy_ms, window_ms = trace_device_time(path)
        for label, names in wanted.items():
            if not any(n in k for k in kernels for n in names):
                raise AssertionError(f"the {phase} trace holds no {label} kernel ({names})")
        top = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:8]
        out[phase] = dict(
            trace=os.path.relpath(path, REPO), trace_bytes=os.path.getsize(path),
            kernel_launches=sum(c for c, _ in kernels.values()),
            kernel_ms=sum(t for _, t in kernels.values()), device_busy_ms=busy_ms,
            window_ms=window_ms, device_busy_share=busy_ms / window_ms,
            top_device_ops=[dict(name=name[:100], launches=c, ms=t) for name, (c, t) in top],
            port_kernels={n: [sum(c for k, (c, _) in kernels.items() if n in k),
                              sum(t for k, (_, t) in kernels.items() if n in k)]
                          for n in TRACED_PORT_KERNELS})
    key = "tools_profile" if model == "flagship" else f"tools_profile_{model}"
    info[key] = out
    log(f"{key.upper()} " + json.dumps(out))


def tools_microbench(torch, lm16, info: dict) -> None:
    """`kernel_micros` on the flagship: every time positive, K5 launched."""
    from uzu_tpu_torch.ops.cuda.build import LAUNCHES, reset_launches
    from uzu_tpu_torch.tools.microbench import kernel_micros

    reset_launches()
    micros = kernel_micros(lm16)
    torch.cuda.synchronize()
    launches = {k: v for k, v in LAUNCHES.items() if v}
    info["tools_microbench"] = dict(ms=micros, launches=launches)
    log("TOOLS_MICROBENCH " + json.dumps(info["tools_microbench"]))
    bad = [k for k, v in micros.items() if not v > 0]
    if bad:
        raise AssertionError(f"microbench probes without a positive time: {bad}")
    if not launches.get("paged_attention"):
        raise AssertionError("paged_attention_micro did not launch K5")


def tools_step_breakdown(torch, model_dir: str, info: dict) -> None:
    """The step breakdown of the flagship's decode step (M=1) and of a
    256-row prefill chunk."""
    from uzu_tpu_torch.tools import exp_step_breakdown as sb

    info["tools_step_breakdown"] = dict(decode=sb.main(model_dir, 1, "cuda"),
                                        prefill=sb.prefill_main(model_dir, 256, "cuda"))
    log("TOOLS_STEP_BREAKDOWN " + json.dumps(info["tools_step_breakdown"]))


def tools_quality(torch, lm16, info: dict) -> None:
    """Teacher-forced NLL and the activation trace of a 256-token corpus
    sequence through the flagship's first 2 layers, on the card and on the
    host CPU: |dNLL| <= NLL_TOL, every trace entry within TOL relative L2."""
    import numpy as np

    from uzu_tpu_torch.tools import corpus, quality

    toks = corpus.generate_tokens(256, seed=0)
    nll, traces = {}, {}
    for dev in ("cuda", "cpu"):
        lm = first_layers(lm16, 2, dev)
        nll[dev] = quality.sequence_nll(lm, toks)
        traces[dev] = quality.capture_trace(lm, toks)
        del lm
    rel = {k: float(np.linalg.norm(traces["cuda"][k] - v) / np.linalg.norm(v))
           for k, v in traces["cpu"].items()}
    finite = all(bool(np.isfinite(v).all()) for v in traces["cuda"].values())
    info["tools_quality"] = dict(tokens=len(toks), layers=2, nll=nll,
                                 nll_delta=nll["cuda"]["nll"] - nll["cpu"]["nll"],
                                 nll_tol=NLL_TOL, trace_rel_l2=rel, tol=TOL, finite=finite)
    log("TOOLS_QUALITY " + json.dumps(info["tools_quality"]))
    if not abs(info["tools_quality"]["nll_delta"]) <= NLL_TOL:
        raise AssertionError(f"NLL on the card and the host differ by "
                             f"{info['tools_quality']['nll_delta']:.3e} nats > {NLL_TOL}")
    bad = {k: v for k, v in rel.items() if not v <= TOL}
    if bad or not finite:
        raise AssertionError(f"activation traces, card against host: {bad} > {TOL} "
                             f"(finite: {finite})")


def tools_bisect(torch, info: dict) -> None:
    """The quant-matmul bisect probe on the card: P1's block read exact,
    each K1 cell within BISECT_LIMITS of RMS of its numpy oracle."""
    from uzu_tpu_torch.ops.cuda.build import LAUNCHES, reset_launches
    from uzu_tpu_torch.tools import exp_qmm_bisect

    reset_launches()
    cells = exp_qmm_bisect.main("cuda")
    torch.cuda.synchronize()
    launches = dict(LAUNCHES)
    info["bisect"] = dict(cells=cells, limits=BISECT_LIMITS, launches=launches)
    log("TOOLS_BISECT " + json.dumps(info["bisect"]))
    if cells["blockread_kg16_err"]["value"] != 0.0:
        raise AssertionError(f"P1 read the scale block back with error "
                             f"{cells['blockread_kg16_err']['value']}")
    bad = {c: cells[c]["err_over_rms"] for c, lim in BISECT_LIMITS.items()
           if not cells[c]["err_over_rms"] <= lim}
    if bad:
        raise AssertionError(f"bisect cells past their limits {BISECT_LIMITS}: {bad}")
    if launches["scale_block_copy"] != 1 or launches["quant_matmul_int4"] != 6:
        raise AssertionError(f"the bisect probe launched {launches}, expected P1 once and "
                             "K1 six times")


# -- phase 16: single-stream speculative decoding ---------------------------------------

SPEC_TOKENS = 48  # the flagship's streams (cut from 64 to make room for phase 20)
SPEC_HYBRID_TOKENS = 32
SPEC_CONTROL_TOKENS = 32
SPEC_DRAFT_LAYERS = 4  # the self-drafts' depth
SPEC_POS0 = 700  # K3's verify rows sit here in a 1024-slot context bucket
SPEC_ROWS = (16, 32)  # verify blocks: K3 rows (S) and K1 rows (M)
# the DFlash draft over the flagship: a block of 8 (a tree of 15 nodes at
# two children per depth), taps after layers 1, 8 and 14
DFLASH_BLOCK, DFLASH_TAPS = 8, (1, 8, 14)


def check_spec_rows(torch, timer, rows, usage) -> None:
    """K1 and K3 at the chain verify's shapes: K1 at M = 16 and 32 on the
    flagship's four linears (INT4, symmetric); K3 at S = 16 and 32 from
    position SPEC_POS0 over a 1024-slot context bucket, at the flagship's
    heads (32 over 8 groups, Dh 64) and the hybrid's (8 over 2, Dh 32)."""
    gen = torch.Generator(device="cuda").manual_seed(16)
    for wname, n, k in LINEAR_SHAPES:
        w, wd = random_qweights(torch, gen, n, k, 4)["symmetric"]
        for m in SPEC_ROWS:
            qmm_row(torch, timer, rows, w, wd, wname, m, "symmetric", gen)
    for h, g, dh in ((32, 8, 64), (HYBRID_ATTN["num_heads"], HYBRID_ATTN["num_groups"],
                                   HYBRID_ATTN["head_dim"])):
        for s in SPEC_ROWS:
            q, kc, vc = (torch.randn(shape, device="cuda", generator=gen).to(torch.bfloat16)
                         for shape in ((s, h, dh), (1024, g, dh), (1024, g, dh)))
            flash_row(torch, timer, rows, usage, q, kc, vc, SPEC_POS0, "plain", {})


def spec_prompt(vocab: int):
    """A repetitive 128-token prompt: one 16-token phrase eight times."""
    import numpy as np

    return np.tile(prompt_tokens(16, vocab), 8)


class OracleSpeculator:
    """Proposes the plain greedy stream's next tokens (`right` of them,
    then `wrong` tokens that are not), from the position the history has
    reached: a draft whose acceptance is known, for the K3 verify blocks and
    the controls."""

    def __init__(self, prompt_len: int, plain: list, right: int, wrong: int = 0):
        self.prompt_len, self.plain, self.right, self.wrong = prompt_len, plain, right, wrong

    def propose(self, history):
        at = len(history) - self.prompt_len  # plain[at] comes next
        good = self.plain[at:at + self.right]
        return good + [(t + 1) % 1000 for t in self.plain[at + len(good):][:self.wrong]]


class OracleTreeSpeculator:
    """A tree whose first `depth` children of the root are decoys and whose
    next child starts the plain stream's next `depth` tokens: an accepted
    path skips nodes 1..depth, so the accept must move every accepted row,
    and a compaction that moves none leaves the decoys in the context."""

    def __init__(self, prompt_len: int, plain: list, depth: int = 7):
        self.prompt_len, self.plain, self.depth = prompt_len, plain, depth

    def reset(self):
        pass

    def propose(self, history, root):
        from uzu_tpu_torch.engine.speculation import TokenTree

        at = len(history) + 1 - self.prompt_len
        tree = TokenTree(root)
        nxt = self.plain[at:at + self.depth]
        for i in range(len(nxt)):
            tree.add(0, (nxt[0] + 1 + i) % 1000)
        tree.add_chain(0, nxt)
        return tree


def spec_stream(torch, lm, dec, prompt, tokens: int, prefill_launches: dict, plain: list,
                plain_tok_s: float, **kw) -> tuple[list, dict]:
    """One speculative decoder's stream after a warm-up: its tokens and a
    reading (tok/s beside the plain stream's, both over the whole generate
    call; acceptance; tokens per verify pass; K1/K3 launches per verify
    round, the prefill's taken off and the draft's included; the share of
    tokens equal to the plain stream's and the length of the common
    prefix)."""
    from uzu_tpu_torch.engine.speculation import SpeculationMetrics
    from uzu_tpu_torch.ops.cuda.build import LAUNCHES, reset_launches

    list(dec.generate(prompt[:16], 4, stop_token_ids=[], **kw))
    m = SpeculationMetrics()
    reset_launches()
    t0 = time.perf_counter()
    got = list(dec.generate(prompt, tokens, stop_token_ids=[], metrics=m, **kw))
    secs = time.perf_counter() - t0  # the stream's last read synced the card
    launches = dict(LAUNCHES)
    rounds = max(m.num_verify_passes, 1)
    same = sum(a == b for a, b in zip(got, plain))
    return got, dict(
        tokens=len(got), seconds=secs, tok_s=len(got) / secs, plain_tok_s=plain_tok_s,
        verify_passes=m.num_verify_passes, proposed=m.num_tokens_proposed,
        accepted=m.num_tokens_accepted, acceptance_rate=m.acceptance_rate,
        tokens_per_pass=(len(got) - 1) / rounds, equal_share=same / len(got),
        equal_prefix=next((i for i, (a, b) in enumerate(zip(got, plain)) if a != b), len(got)),
        launches=launches,
        launches_per_round={k: (launches[k] - prefill_launches.get(k, 0)) / rounds
                            for k in ("quant_matmul_int4", "quant_matmul_int8",
                                      "flash_attention", "moe_gemv_int4",
                                      "grouped_matmul_int4") if launches[k]})


def spec_checked(torch, lm, prompt, runs: dict, key: str, info: dict,
                 must_launch=("quant_matmul_int4",)) -> None:
    """Each run's stream under phase 4's rule against the single stream of
    `lm` fed its history; each run launched the kernels in `must_launch`."""
    for name, (stream, reading) in runs.items():
        r = stream_readings(torch, lm, [prompt], [stream])
        reading.update(stream_summary(r))
        log(f"{key.upper()} {name} " + json.dumps(reading))
        check_streams(r)
        for k in must_launch:
            if not reading["launches"].get(k):
                raise AssertionError(f"{key} {name}: kernel {k} was not launched")
    info[key] = dict(info.get(key, {}), **{n: r for n, (_, r) in runs.items()})


def caught_by_check(torch, lm, prompt, stream) -> str | None:
    """The stream check's failure message for `stream`, or None."""
    try:
        check_streams(stream_readings(torch, lm, [prompt], [stream]))
    except AssertionError as e:
        return str(e)
    return None


def spec_flagship(torch, lm16, dirs: dict, info: dict) -> None:
    """Phase 16 on the flagship: a plain greedy stream of SPEC_TOKENS after
    the repetitive prompt, then chain speculation (n-gram, an oracle draft
    that puts K3 on its 32-row verify blocks, the self-draft of
    SPEC_DRAFT_LAYERS layers, the 2-layer INT8 flagship as a draft model),
    tree speculation (16 nodes), DFlash (the synthesized draft) and fused
    rounds (self-draft, k = 4, 8 rounds per fetch, every round under
    torch.cuda.set_sync_debug_mode("error")), each held to phase 4's rule;
    sampled chain and fused runs repeat under their seed; and the stream
    check must fail an acceptance that takes one draft more than matched
    and a tree compaction whose write base is off by m."""
    import uzu_tpu_torch.engine.speculation as spec
    from uzu_tpu_torch.engine.dflash import DFlashDraft
    from uzu_tpu_torch.engine.engine import LanguageModel, StreamMetrics
    from uzu_tpu_torch.engine.fused_spec import fused_self_speculative_decoder
    from uzu_tpu_torch.engine.sampling import SamplingParams
    from uzu_tpu_torch.ops.cuda.build import LAUNCHES, reset_launches

    dev = lm16.device
    vocab = lm16.decoder_config.vocab_size
    prompt = spec_prompt(vocab)
    lm16.generate_list(prompt[:16], 2, stop_token_ids=[])
    reset_launches()
    lm16.prefill(lm16.new_state(), prompt)
    prefill_launches = dict(LAUNCHES)
    m = StreamMetrics()
    t0 = time.perf_counter()
    plain = lm16.generate_list(prompt, SPEC_TOKENS, stop_token_ids=[], metrics=m)
    plain_s = time.perf_counter() - t0
    plain_tok_s = len(plain) / plain_s
    info["spec_flagship"] = dict(prompt=len(prompt), plain_tok_s=plain_tok_s,
                                 plain_decode_tok_s=m.decode_tokens_per_second,
                                 plain_head=plain[:16])
    log("SPEC_PLAIN " + json.dumps(info["spec_flagship"]))

    draft_lm = LanguageModel.from_dir(dirs["llama1b_int8_2l"], device=dev, max_context=4096)
    dflash = DFlashDraft.from_dir(dirs["dflash_flagship"], max_context=4096, device=dev)
    decoders = {
        "chain_ngram": spec.SpeculativeDecoder(lm16, spec.NgramSpeculator(k=15)),
        "chain_oracle": spec.SpeculativeDecoder(lm16, OracleSpeculator(len(prompt), plain, 31)),
        "chain_self": spec.self_speculative_decoder(lm16, draft_layers=SPEC_DRAFT_LAYERS, k=4),
        "chain_draft_model": spec.SpeculativeDecoder(lm16, spec.DraftModelSpeculator(draft_lm,
                                                                                     k=4)),
        "tree_ngram": spec.TreeSpeculativeDecoder(lm16, max_nodes=16),
        "dflash": spec.DFlashSpeculativeDecoder(lm16, dflash, max_nodes=16, children=2),
    }
    runs = {name: spec_stream(torch, lm16, dec, prompt, SPEC_TOKENS, prefill_launches, plain,
                              plain_tok_s) for name, dec in decoders.items()}
    fused = fused_self_speculative_decoder(lm16, draft_layers=SPEC_DRAFT_LAYERS, k=4, rounds=8)
    real_rounds, dispatches = fused._rounds, []

    def no_sync_rounds(*a, **kw):
        # every launch of the rounds runs with host syncs turned into errors
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = real_rounds(*a, **kw)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        dispatches.append(a[4])
        return out

    fused._rounds = no_sync_rounds
    runs["fused_self"] = spec_stream(torch, lm16, fused, prompt, SPEC_TOKENS, prefill_launches,
                                     plain, plain_tok_s)
    runs["fused_self"][1].update(sync_debug_dispatches=len(dispatches),
                                 rounds_per_dispatch=dispatches)
    spec_checked(torch, lm16, prompt, runs, "spec_flagship", info)
    for name in ("chain_oracle",):
        if not runs[name][1]["launches"].get("flash_attention"):
            raise AssertionError(f"spec_flagship {name}: K3 was not launched on its verify "
                                 "blocks")

    # sampled: the same seed twice gives the same tokens
    sp = SamplingParams(temperature=0.8, top_k=64, top_p=0.95)
    sampled = {}
    for name, make in (("chain_ngram", lambda: spec.SpeculativeDecoder(
            lm16, spec.NgramSpeculator(k=7), sampling=sp)),
                       ("fused_self", lambda: fused_self_speculative_decoder(
                           lm16, draft_layers=SPEC_DRAFT_LAYERS, k=4, rounds=8, sampling=sp))):
        a, b = (list(make().generate(prompt, SPEC_CONTROL_TOKENS, stop_token_ids=[], seed=11))
                for _ in range(2))
        sampled[name] = dict(tokens=len(a), repeat=a == b, head=a[:8])
        if a != b or len(a) != SPEC_CONTROL_TOKENS:
            raise AssertionError(f"sampled {name}: the same seed gave other tokens")
    info["spec_flagship"]["sampled"] = sampled
    log("SPEC_SAMPLED " + json.dumps(sampled))

    # controls: each planted fault must fail the stream check
    n = SPEC_CONTROL_TOKENS
    half = OracleSpeculator(len(prompt), plain, 2, 13)
    real_accept = spec.accepted_length
    spec.accepted_length = lambda s, b, d: torch.clamp(real_accept(s, b, d) + 1, max=d)
    try:
        over = list(spec.SpeculativeDecoder(lm16, half).generate(prompt, n, stop_token_ids=[]))
    finally:
        spec.accepted_length = real_accept
    clean = list(spec.SpeculativeDecoder(lm16, half).generate(prompt, n, stop_token_ids=[]))

    class OffByM(spec.TreeSpeculativeDecoder):
        def _accept(self, state, idx, new_pos, m):  # the write base at pos, not pos - m
            spec.compact_kv(state["layers"], state["pos"], idx)
            return dict(state, pos=new_pos)

    tree_spec = OracleTreeSpeculator(len(prompt), plain)
    off = list(OffByM(lm16, tree_spec, max_nodes=16).generate(prompt, n, stop_token_ids=[]))
    tree_clean = list(spec.TreeSpeculativeDecoder(lm16, tree_spec, max_nodes=16).generate(
        prompt, n, stop_token_ids=[]))
    controls = dict(
        accept_one_more=caught_by_check(torch, lm16, prompt, over),
        accept_clean=caught_by_check(torch, lm16, prompt, clean),
        tree_base_off_by_m=caught_by_check(torch, lm16, prompt, off),
        tree_clean=caught_by_check(torch, lm16, prompt, tree_clean))
    info["spec_flagship"]["controls"] = controls
    log("SPEC_CONTROLS " + json.dumps(controls))
    if controls["accept_clean"] or controls["tree_clean"]:
        raise AssertionError(f"a control's clean run failed the stream check: {controls}")
    missed = [k for k in ("accept_one_more", "tree_base_off_by_m") if controls[k] is None]
    if missed:
        raise AssertionError(f"the stream check passed planted faults: {missed}")


def spec_hybrid(torch, lm_h, info: dict) -> None:
    """Phase 16 on the Qwen3.5-class hybrid: chain and tree speculation
    (n-gram drafts, and oracle drafts of the plain stream: 16-row blocks,
    trees behind seven decoys) under phase 4's rule; then one chain verify
    round with a
    partial acceptance (the plain stream's next two tokens, then wrong
    ones), whose committed GDN states must lie within TOL relative L2 of
    the states the accepted tokens give fed one at a time."""
    import uzu_tpu_torch.engine.speculation as spec
    from uzu_tpu_torch.ops.cuda.build import LAUNCHES, reset_launches

    vocab = lm_h.decoder_config.vocab_size
    prompt = spec_prompt(vocab)
    lm_h.generate_list(prompt[:16], 2, stop_token_ids=[])
    reset_launches()
    lm_h.prefill(lm_h.new_state(), prompt)
    prefill_launches = dict(LAUNCHES)
    t0 = time.perf_counter()
    plain = lm_h.generate_list(prompt, SPEC_HYBRID_TOKENS, stop_token_ids=[])
    plain_tok_s = len(plain) / (time.perf_counter() - t0)
    decoders = {
        "chain_ngram": spec.SpeculativeDecoder(lm_h, spec.NgramSpeculator(k=15)),
        "tree_ngram": spec.TreeSpeculativeDecoder(lm_h, max_nodes=16),
        # the plain stream's next tokens: 16-row verify blocks (K3 at Dh
        # 32), and trees whose accepted paths skip seven decoys (the GDN
        # replay over non-consecutive nodes)
        "chain_oracle": spec.SpeculativeDecoder(lm_h, OracleSpeculator(len(prompt), plain, 15)),
        "tree_oracle": spec.TreeSpeculativeDecoder(
            lm_h, OracleTreeSpeculator(len(prompt), plain), max_nodes=16),
    }
    runs = {name: spec_stream(torch, lm_h, dec, prompt, SPEC_HYBRID_TOKENS, prefill_launches,
                              plain, plain_tok_s) for name, dec in decoders.items()}
    spec_checked(torch, lm_h, prompt, runs, "spec_hybrid", info)
    if not runs["chain_oracle"][1]["launches"].get("flash_attention"):
        raise AssertionError("spec_hybrid chain_oracle: K3 was not launched on its verify "
                             "blocks")

    # the committed state of a partial acceptance
    dev = lm_h.device
    _, state = lm_h.prefill(lm_h.new_state(), prompt)
    block = [plain[0], plain[1], plain[2]] + [(t + 1) % vocab for t in plain[3:8]]
    dec = spec.SpeculativeDecoder(lm_h, spec.NgramSpeculator())
    got, sampled, accepted, commit = dec._verify(
        state, torch.tensor(block, device=dev), len(block) - 1, 64, None, None,
        lm_h._ctx_bucket(len(prompt) + len(block)))
    commit = int(commit)
    _, ref = lm_h.prefill(lm_h.new_state(), prompt)
    for t in block[:commit]:
        _, ref, _ = lm_h._forward(torch.tensor([t], device=dev), ref, 1,
                                  lm_h._ctx_bucket(len(prompt) + len(block)))
    dist = []
    for layer, want in zip(got["layers"], ref["layers"]):
        if "ssm" in layer:
            dist.append(max(float((layer[k].float() - want[k].float()).norm()
                                  / want[k].float().norm().clamp(min=1e-30))
                            for k in ("ssm", "conv")))
    info["spec_hybrid"]["partial_commit"] = dict(
        block=len(block), accepted=int(accepted), commit=commit,
        pos=int(got["pos"]), gdn_layers=len(dist), max_rel_l2=max(dist), tol=TOL)
    log("SPEC_HYBRID_STATE " + json.dumps(info["spec_hybrid"]["partial_commit"]))
    if not 1 <= commit < len(block):
        raise AssertionError(f"spec_hybrid: the verify round committed {commit} of "
                             f"{len(block)} rows, not a partial acceptance")
    if int(got["pos"]) != len(prompt) + commit:
        raise AssertionError("spec_hybrid: the committed pos is not the prompt plus the commit")
    if not max(dist) <= TOL:
        raise AssertionError(f"spec_hybrid: a committed GDN state lies {max(dist):.3e} "
                             f"(relative L2) from the token-at-a-time one (limit {TOL})")


def spec_gptoss(torch, lm_oss, info: dict) -> None:
    """Phase 16 on gpt-oss (4 layers): one chain verify round's logits at
    blocks of 4 rows (the MoE gather path, K7) and 8 rows (K9's small
    route) against the single stream's per-token logits along the same
    tokens, the single stream taking the verify's expert choices (each a
    router near-tie where it would not have made it); relative L2 <= TOL."""
    import uzu_tpu_torch.models.moe as moe
    from uzu_tpu_torch.models.decoder import decoder_forward
    from uzu_tpu_torch.ops.cuda.build import LAUNCHES, reset_launches

    dev = lm_oss.device
    vocab = lm_oss.decoder_config.vocab_size
    prompt = prompt_tokens(64, vocab)
    layers = len(lm_oss.decoder_config.transformer_config.layer_configs)
    out = {}
    for n in (4, 8):
        block = prompt_tokens(n + 7, vocab)[7:]
        _, state = lm_oss.prefill(lm_oss.new_state(), prompt)
        routes = []
        real = moe.router_topk

        def recording(c, p, x):
            r = real(c, p, x)
            routes.append(r[0])
            return r

        moe.router_topk = recording
        reset_launches()
        try:
            logits, _ = decoder_forward(lm_oss.decoder_config, lm_oss.params,
                                        torch.tensor(block, device=dev), state,
                                        last_only=False, defer_ssm=True,
                                        ctx_limit=lm_oss._ctx_bucket(len(prompt) + n))
        finally:
            moe.router_topk = real
        launches = dict(LAUNCHES)
        calls = []

        def replay(x):  # the i-th router call: layer i % layers of token i // layers
            i = len(calls)
            calls.append(i)
            return routes[i % layers][i // layers].reshape(1, -1)

        pinned, gaps = pinned_router(torch, replay)
        _, ref_state = lm_oss.prefill(lm_oss.new_state(), prompt)
        rows = []
        moe.router_topk = pinned
        try:
            for t in block:
                lg, ref_state, _ = lm_oss._forward(torch.tensor([t], device=dev), ref_state, 1,
                                                   lm_oss._ctx_bucket(len(prompt) + n))
                rows.append(lg)
        finally:
            moe.router_topk = real
        ref = torch.stack(rows).float()
        rel = float((logits.float() - ref).norm() / ref.norm())
        rg = torch.cat(gaps).double().tolist()
        out[n] = dict(rel_l2=rel, tol=TOL, launches={k: v for k, v in launches.items() if v},
                      routed_rows=len(rg), router_flips=sum(g > 0 for g in rg),
                      max_router_gap=max(rg))
        kernel = "moe_gemv_int4" if n <= 4 else "grouped_matmul_int4"
        if not launches.get(kernel):
            raise AssertionError(f"spec_gptoss: a verify block of {n} rows launched no {kernel}")
        if not rel <= TOL:
            raise AssertionError(f"spec_gptoss: the {n}-row verify's logits lie {rel:.3e} "
                                 f"(relative L2) from the single stream's (limit {TOL})")
        check_routing([dict(max_router_gap=out[n]["max_router_gap"])])
    info["spec_gptoss"] = dict(prompt=len(prompt), blocks=out)
    log("SPEC_GPTOSS " + json.dumps(info["spec_gptoss"]))


# -- phase 17: speculative continuous batching ------------------------------------------

BSPEC_SLOTS, BSPEC_BLOCK = 8, 8  # the paged engine's slots; drafts per slot (9-row blocks)
BSPEC_TOKENS = 24  # cut from 32 to make room for phase 20
BSPEC_HYBRID_SLOTS, BSPEC_HYBRID_TOKENS = 4, 32
BSPEC_DRAFT_LAYERS = {"flagship": 4, "hybrid": 6}
BSPEC_ROUNDS = 8  # fused rounds per dispatch
# K1's rows on the verify: 8 slots x 9 rows (the flagship), 4 x 9 (the hybrid)
BSPEC_M = (BSPEC_SLOTS * (BSPEC_BLOCK + 1), BSPEC_HYBRID_SLOTS * (BSPEC_BLOCK + 1))
BSPEC_POS = 1000  # K5/K6's verify rows: 8 slots at 1000-1007 in 512-token pages
# the grammar requests: a JSON object (integer bounds keep it short) and
# an e-mail regex, in the exact format (no free whitespace)
BSPEC_SCHEMA = {"type": "object",
                "properties": {"city": {"enum": ["Paris", "Rome"]},
                               "days": {"type": "integer", "minimum": 1, "maximum": 30}},
                "required": ["city"]}
BSPEC_REGEX = r"[a-z]{2,5}@[a-z]{1,6}\.(com|org)"
BSPEC_EOS = 128001
GRAMMAR_FRAGMENTS = ('{"', '"}', '":', '","', '":"', ',"', '{"city":"', 'city', 'days', 'Paris',
                     'Rome', 'Par', 'is', '12', '30', '7', '.com', '.org', '@', 'co', 'org',
                     'ab', 'xy', '}', '{', '"', ',', ':')


class SynthTokenizer:
    """Token strings over all of the flagship's ids, from a seed: id
    BSPEC_EOS is the end-of-sequence special, the printable ASCII
    characters and GRAMMAR_FRAGMENTS sit at seeded random ids, and every
    other id is a filler of 2-5 lowercase letters. It exposes what a
    GrammarSession reads (vocab_size, special_token_strings, id_to_token,
    decode)."""

    def __init__(self, vocab: int, seed: int = 17):
        import numpy as np

        rng = np.random.default_rng(seed)
        letters = np.array(list("abcdefghijklmnopqrstuvwxyz"))
        pieces = ["".join(rng.choice(letters, int(rng.integers(2, 6)))) for _ in range(vocab)]
        useful = [chr(c) for c in range(32, 127)] + list(GRAMMAR_FRAGMENTS)
        ids = [int(i) for i in rng.permutation(vocab) if i != BSPEC_EOS][:len(useful)]
        for i, piece in zip(ids, useful):
            pieces[i] = piece
        pieces[BSPEC_EOS] = "<eos>"
        self.pieces = pieces
        self.vocab_size = vocab
        self.special_token_strings = {"<eos>"}

    def id_to_token(self, i: int):
        return self.pieces[i] if 0 <= i < self.vocab_size else None

    def decode(self, ids) -> str:
        return "".join(self.pieces[i] for i in ids if i != BSPEC_EOS)


def check_batch_spec_rows(torch, timer, rows, usage) -> None:
    """The verify's shapes (phase 17): K1 at M = 72 and 36 on the
    flagship's linears (INT4, symmetric; the tile route); K5 and K6 at 72
    query rows (8 slots of 9 rows, each slot's cut table of 2 pages and the
    trash column repeated 9 times, row i of a slot at length pos + i + 1),
    the bound counting each slot's live tokens once, against SDPA over the
    gathered view with each slot's 9 rows as queries; K9 at the verify's
    288 routed rows (72 tokens x 4 experts, 64-row tiles)."""
    import torch.nn.functional as F

    from uzu_tpu_torch.models.kv_cache import dequantize_rows, quantize_rows

    gen = torch.Generator(device="cuda").manual_seed(17)
    for wname, n, k in LINEAR_SHAPES:
        w, wd = random_qweights(torch, gen, n, k, 4)["symmetric"]
        for m in BSPEC_M:
            qmm_row(torch, timer, rows, w, wd, wname, m, "symmetric", gen)
    b, s, h, g, dh, page = BSPEC_SLOTS, BSPEC_BLOCK + 1, 32, 8, 64, 512
    p_total = b * 2 + 1
    k = torch.randn((g, p_total, page, dh), device="cuda", generator=gen).to(torch.bfloat16)
    v = torch.randn((g, p_total, page, dh), device="cuda", generator=gen).to(torch.bfloat16)
    kq, ks = quantize_rows(k)
    vq, vs = quantize_rows(v)
    table = torch.cat([torch.randperm(p_total - 1, device="cuda", generator=gen)
                       .reshape(b, 2).to(torch.int32),
                       torch.full((b, 1), p_total - 1, dtype=torch.int32, device="cuda")], 1)
    pos = torch.arange(b, device="cuda", dtype=torch.int32) + BSPEC_POS
    lengths = (pos[:, None] + torch.arange(1, s + 1, device="cuda", dtype=torch.int32)
               ).reshape(-1)
    q = torch.randn((b * s, h, dh), device="cuda", generator=gen).to(torch.bfloat16)
    rows_table = table.repeat_interleave(s, 0)
    distinct = int((pos + s).sum())
    width = 2 * page
    keep = (torch.arange(width, device="cuda")[None, None, :]
            < lengths.reshape(b, s)[:, :, None])[:, None]  # [B, 1, S, width]
    for quant in (False, True):
        kp, vp = (kq, vq) if quant else (k, v)
        kw = dict(k_scales=ks, v_scales=vs) if quant else {}

        def gathered(pool, sc):
            t = pool[:, table[:, :2].long()].transpose(0, 1).reshape(b, g, width, dh)
            if sc is not None:
                t = dequantize_rows(t, sc[:, table[:, :2].long()].transpose(0, 1)
                                    .reshape(b, g, width)).to(torch.bfloat16)
            return t.contiguous()

        kt, vt = gathered(kp, kw.get("k_scales")), gathered(vp, kw.get("v_scales"))
        qt = q.reshape(b, s, h, dh).transpose(1, 2).contiguous()
        lib = functools.partial(F.scaled_dot_product_attention, qt, kt, vt, attn_mask=keep,
                                scale=dh ** -0.5, enable_gqa=True)
        paged_row(torch, timer, rows, usage, q, kp, vp, rows_table, lengths, "verify9",
                  "plain", kw, distinct_live=distinct, library=lib)
        del kt, vt
    del k, v, kq, vq
    check_grouped_matmul(torch, timer, rows, cases=[(
        "grouped_matmul_int4", BSPEC_SLOTS * (BSPEC_BLOCK + 1) * GPTOSS["num_active"], 64)])


def bspec_prompts(vocab: int):
    """8 prompts: four repetitive ones (a 16-token phrase 3 to 6 times,
    where n-gram drafts find matches) and four of paged_prompts' (17, 700,
    64 and 300 tokens)."""
    import numpy as np

    rep = [np.tile((np.arange(16) * 37 + 11 + 1000 * i) % vocab, 3 + i).tolist()
           for i in range(4)]
    return rep + paged_prompts(vocab)[:4]


def bspec_run(torch, lm, eng, prompts, tokens: int, check: bool = True, no_sync: bool = False,
              **submit_kw) -> tuple[list, dict]:
    """Run the speculative engine `eng` over `prompts` (`tokens` each) to
    idle. Its reading: tok/s over the run (admission included), verify
    rounds and dispatches, acceptance, tokens per verify pass, launches per
    round after admission (the rounds start once every slot is admitted).
    With `check`, the streams under phase 4's rule against the single
    stream; with `no_sync`, every fused dispatch under
    torch.cuda.set_sync_debug_mode("error")."""
    from uzu_tpu_torch.ops.cuda.build import LAUNCHES, reset_launches

    snap, dispatches = {}, []
    real_round = eng._verify_round

    def first_round():
        snap.setdefault("admitted", dict(LAUNCHES))
        return real_round()

    eng._verify_round = first_round
    if no_sync:
        real_fused = eng._fused_rounds

        def fused(*a, **kw):
            torch.cuda.set_sync_debug_mode("error")
            try:
                return real_fused(*a, **kw)
            finally:
                torch.cuda.set_sync_debug_mode("default")
                dispatches.append(a[1])

        eng._fused_rounds = fused
    reset_launches()
    t0 = time.perf_counter()
    reqs = [eng.submit(p, tokens, **submit_kw) for p in prompts]
    eng.run()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    m = eng.metrics
    generated = sum(len(r.tokens) for r in reqs)
    rounds = max(eng.stats["verify_rounds"], 1)
    pre = snap.get("admitted", {})
    reading = dict(
        requests=len(reqs), slots=eng.batch_size, draft_block=eng.draft_block,
        generated=generated, seconds=secs, tok_s=generated / secs,
        verify_rounds=eng.stats["verify_rounds"], verify_dispatches=eng.stats["verify_dispatches"],
        verify_passes=m.num_verify_passes, proposed=m.num_tokens_proposed,
        accepted=m.num_tokens_accepted, acceptance_rate=m.acceptance_rate,
        tokens_per_pass=(generated - len(reqs)) / max(m.num_verify_passes, 1),
        tokens_per_slot_verify=(generated - len(reqs))
        / max(generated - len(reqs) - m.num_tokens_accepted, 1),
        prefill_chunks=eng.stats["prefill_chunks"], launches=launches,
        launches_per_round={k: (launches[k] - pre.get(k, 0)) / rounds for k in launches
                            if launches[k] - pre.get(k, 0)},
        preempted=[r.preempted for r in reqs])
    if no_sync:
        reading.update(sync_debug_dispatches=len(dispatches), rounds_per_dispatch=dispatches)
    if any(not r.finished or not r.tokens for r in reqs):
        raise AssertionError("a speculative batched request did not finish")
    if check:
        readings = stream_readings(torch, lm, prompts, [r.tokens for r in reqs])
        reading.update(stream_summary(readings))
        check_streams(readings)
    return reqs, reading


def plain_run(torch, eng, prompts, tokens: int) -> dict:
    """tok/s of a plain chunked engine over the same requests."""
    t0 = time.perf_counter()
    reqs = [eng.submit(p, tokens) for p in prompts]
    eng.run()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    generated = sum(len(r.tokens) for r in reqs)
    return dict(generated=generated, seconds=secs, tok_s=generated / secs,
                decode_chunk=eng.decode_chunk)


def bspec_log(info: dict, key: str, name: str, reading: dict) -> None:
    info.setdefault(key, {})[name] = reading
    log(f"{key.upper()} {name} " + json.dumps(reading))


class WrongSpeculator:
    """Proposes `k` tokens that follow no stream (last + 1, last + 2, ...):
    a draft that is rejected, for the cut-table and acceptance controls."""

    def __init__(self, vocab: int, k: int = BSPEC_BLOCK):
        self.vocab, self.k = vocab, k

    def propose(self, history):
        return [(history[-1] + 1 + i) % self.vocab for i in range(self.k)]


def bspec_controls(torch, lm16, info: dict) -> None:
    """The stream check held to two planted faults of the paged verify, on
    one slot of the flagship with rejected drafts (WrongSpeculator): the
    acceptance takes one draft more than matched; and, with the tables cut
    to the pages of the committed positions (so the rejected rows of a
    block pass the cut whenever it lies within 8 rows, in 16-token pages),
    a row past the cut is written through the table's last live column
    (the JAX package's clip) instead of the trash column. Each clean run
    passes the check; each planted one must fail it."""
    import uzu_tpu_torch.engine.batch_spec as bs
    import uzu_tpu_torch.models.paged_decode as pd

    vocab = lm16.decoder_config.vocab_size
    prompt = prompt_tokens(20, vocab).tolist()
    real_accept, real_cols = bs.accepted_drafts, pd.verify_columns

    def one_more(sampled, blk, draft_len):
        return torch.minimum(real_accept(sampled, blk, draft_len) + 1, draft_len)

    def clipped(positions, valid, width, page):
        return torch.clamp(positions.long() // page, max=width - 2)

    def engine(tight: bool):
        eng = bs.SpeculativePagedBatchEngine(
            lm16, batch_size=1, draft_block=BSPEC_BLOCK, num_pages=32, page_size=16,
            stop_token_ids=[], make_speculator=lambda: WrongSpeculator(vocab))
        if tight:  # the pages of positions up to the slot's own
            eng._ctx_pages = lambda needed: -(-(needed - BSPEC_BLOCK - 1) // eng.page_size)
        return eng

    out = {}
    for name, tight, patch in (("accept_clean", False, None),
                               ("accept_one_more", False, ("accepted_drafts", one_more)),
                               ("cut_clean", True, None),
                               ("cut_live_column", True, ("verify_columns", clipped))):
        eng = engine(tight)
        if patch is not None:
            setattr(bs if patch[0] == "accepted_drafts" else pd, patch[0], patch[1])
        try:
            r = eng.submit(prompt, CONTROL_TOKENS * 2)
            eng.run()
        finally:
            bs.accepted_drafts, pd.verify_columns = real_accept, real_cols
        readings = stream_readings(torch, lm16, [prompt], [r.tokens])
        try:
            check_streams(readings)
            caught = None
        except AssertionError as e:
            caught = str(e)
        out[name] = dict(stream_summary(readings), caught=caught,
                         accepted=eng.metrics.num_tokens_accepted,
                         verify_passes=eng.metrics.num_verify_passes)
    info["batch_spec_controls"] = out
    log("BATCH_SPEC_CONTROLS " + json.dumps(out))
    if out["accept_clean"]["caught"] or out["cut_clean"]["caught"]:
        raise AssertionError(f"a control's clean run failed the stream check: {out}")
    missed = [k for k in ("accept_one_more", "cut_live_column") if out[k]["caught"] is None]
    if missed:
        raise AssertionError(f"the stream check passed planted faults: {missed}")


def bspec_grammar(torch, lm16, plain_streams: dict, info: dict) -> None:
    """Two sampled grammar requests (BSPEC_SCHEMA and BSPEC_REGEX on the
    native backend, over SynthTokenizer's strings) share the paged engine
    with six greedy plain ones (bspec_prompts' first six): every
    constrained output ends on the stop token, parses and satisfies its
    grammar; every token it sampled lies in the mask the host's matcher
    gives for its prefix; the plain streams pass phase 4's rule and are
    compared with the grammar-free n-gram run's (`plain_streams`)."""
    import re

    from uzu_tpu_torch.engine.batch_spec import SpeculativePagedBatchEngine
    from uzu_tpu_torch.engine.sampling import SamplingParams
    from uzu_tpu_torch.grammar import GrammarSession

    vocab = lm16.decoder_config.vocab_size
    t0 = time.perf_counter()
    tok = SynthTokenizer(vocab)

    def session(kind):
        if kind == "json":
            return GrammarSession(tok, schema=BSPEC_SCHEMA, stop_token_ids=[BSPEC_EOS],
                                  backend="native", any_whitespace=False)
        return GrammarSession(tok, regex=BSPEC_REGEX, stop_token_ids=[BSPEC_EOS],
                              backend="native")

    built = time.perf_counter() - t0
    prompts = bspec_prompts(vocab)
    eng = SpeculativePagedBatchEngine(lm16, batch_size=BSPEC_SLOTS, draft_block=BSPEC_BLOCK,
                                      num_pages=64, stop_token_ids=[BSPEC_EOS])
    sp = SamplingParams(temperature=1.0)
    t0 = time.perf_counter()
    greqs = [eng.submit(prompts[6 + i], 64, seed=31 + i, grammar=session(kind), sampling=sp)
             for i, kind in enumerate(("json", "regex"))]
    preqs = [eng.submit(p, BSPEC_TOKENS) for p in prompts[:6]]
    eng.run()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    outputs = {}
    for kind, r in zip(("json", "regex"), greqs):
        text = tok.decode(r.tokens)
        replay = session(kind)
        misses = 0
        for t in r.tokens:
            mask = replay.current_mask()
            misses += int(mask is not None and not mask[t])
            if t == BSPEC_EOS:
                break
            replay.observe(t)
        closed = r.tokens[-1] == BSPEC_EOS
        valid = False
        if closed and kind == "json":
            try:
                value = json.loads(text)
                valid = (set(value) <= {"city", "days"} and value.get("city") in ("Paris", "Rome")
                         and 1 <= value.get("days", 1) <= 30)
            except ValueError:
                valid = False
        elif closed:
            valid = re.fullmatch(BSPEC_REGEX, text) is not None
        outputs[kind] = dict(text=text, tokens=len(r.tokens), closed=closed, valid=valid,
                             mask_misses=misses, backend=replay.backend)
    readings = stream_readings(torch, lm16, prompts[:6], [r.tokens for r in preqs])
    equal = [r.tokens == plain_streams.get(i) for i, r in enumerate(preqs)]
    m = eng.metrics
    reading = dict(grammar=outputs, session_build_seconds=built, seconds=secs,
                   generated=sum(len(r.tokens) for r in greqs + preqs),
                   verify_passes=m.num_verify_passes, acceptance_rate=m.acceptance_rate,
                   plain_equal_to_grammar_free=equal, **stream_summary(readings))
    bspec_log(info, "batch_spec_flagship", "grammar", reading)
    for kind, o in outputs.items():
        if not (o["closed"] and o["valid"]) or o["mask_misses"] or o["backend"] != "native":
            raise AssertionError(f"grammar request {kind}: {o}")
    check_streams(readings)


def batch_spec_flagship(torch, lm16, info: dict) -> None:
    """Phase 17 on the full-width flagship through SpeculativePagedBatchEngine
    (8 slots, blocks of 9 rows, 64 pages of 512 tokens): host n-gram drafts,
    the self-draft of 4 layers, device n-gram drafts in fused rounds of 8
    (each dispatch under set_sync_debug_mode("error")), each stream under
    phase 4's rule, with the plain PagedBatchEngine's tok/s over the same
    requests; a sampled run twice under one seed; a pool small enough to
    preempt under sampling, whose streams equal the unpreempted ones; the
    grammar requests beside plain ones; the planted controls."""
    import numpy as np

    from uzu_tpu_torch.engine.batch_spec import SpeculativePagedBatchEngine
    from uzu_tpu_torch.engine.paged_batch import PagedBatchEngine
    from uzu_tpu_torch.engine.sampling import SamplingParams

    vocab = lm16.decoder_config.vocab_size
    prompts = bspec_prompts(vocab)

    def engine(**kw):
        kw = dict(dict(batch_size=BSPEC_SLOTS, num_pages=64), **kw)
        return SpeculativePagedBatchEngine(lm16, draft_block=BSPEC_BLOCK, stop_token_ids=[],
                                           **kw)

    bspec_run(torch, lm16, engine(), [p[:16] for p in prompts], 4, check=False)  # warm-up
    key = "batch_spec_flagship"
    bspec_log(info, key, "plain_paged", plain_run(
        torch, PagedBatchEngine(lm16, batch_size=BSPEC_SLOTS, decode_chunk=8, num_pages=64,
                                stop_token_ids=[]), prompts, BSPEC_TOKENS))
    runs = {"ngram": dict(), "self_draft": dict(draft_layers=BSPEC_DRAFT_LAYERS["flagship"]),
            "fused_device_ngram": dict(device_ngram=True, spec_rounds=BSPEC_ROUNDS)}
    streams = {}
    for name, kw in runs.items():
        reqs, reading = bspec_run(torch, lm16, engine(**kw), prompts, BSPEC_TOKENS,
                                  no_sync=name.startswith("fused"))
        for k in ("quant_matmul_int4", "paged_attention"):
            if not reading["launches_per_round"].get(k):
                raise AssertionError(f"{key} {name}: {k} was not launched by the verify rounds")
        bspec_log(info, key, name, reading)
        streams[name] = [r.tokens for r in reqs]
    if not info[key]["fused_device_ngram"]["sync_debug_dispatches"]:
        raise AssertionError(f"{key}: no fused dispatch ran")

    sp = SamplingParams(temperature=0.8, top_k=64, top_p=0.95)
    sampled = []
    for _ in range(2):
        reqs, reading = bspec_run(torch, lm16, engine(sampling=sp), prompts, BSPEC_TOKENS // 2,
                                  check=False, seed=7)
        sampled.append([r.tokens for r in reqs])
    bspec_log(info, key, "sampled", dict(reading, repeat=sampled[0] == sampled[1]))
    if sampled[0] != sampled[1]:
        raise AssertionError(f"{key}: a sampled run gave other tokens under the same seed")

    # recompute preemption under sampling: two live requests of 200 prompt
    # tokens and 96 new ones grow to 5 pages of 64 each; the pool holds 9
    pre_prompts = [((np.arange(200) * (41 + 2 * i) + 7 * i) % vocab).tolist() for i in range(3)]
    outs = {}
    for name, pages in (("preempting_pool", 10), ("roomy_pool", 64)):
        reqs, reading = bspec_run(torch, lm16, engine(batch_size=3, num_pages=pages,
                                                      page_size=64, sampling=sp),
                                  pre_prompts, 96, check=False, seed=3)
        outs[name] = ([r.tokens for r in reqs], reading)
    (small, rs), (big, rb) = outs["preempting_pool"], outs["roomy_pool"]
    bspec_log(info, key, "preemption", dict(preempted=rs["preempted"], equal=small == big,
                                            seconds=rs["seconds"], tok_s=rs["tok_s"]))
    if not max(rs["preempted"]) or small != big:
        raise AssertionError(f"{key}: preemption {rs['preempted']}, replay equal {small == big}")

    bspec_grammar(torch, lm16, dict(enumerate(streams["ngram"][:6])), info)
    bspec_controls(torch, lm16, info)


def batch_spec_int8(torch, model_dir: str, info: dict) -> None:
    """Phase 17 on the 2-layer INT8 flagship with INT8 pools (K2 linears,
    K4 admission, K6 verify): the n-gram run under phase 4's rule."""
    from uzu_tpu_torch.engine.batch_spec import SpeculativePagedBatchEngine
    from uzu_tpu_torch.engine.engine import LanguageModel

    lm = LanguageModel.from_dir(model_dir, device="cuda", max_context=4096, kv_quant=True)
    prompts = bspec_prompts(lm.decoder_config.vocab_size)
    eng = SpeculativePagedBatchEngine(lm, batch_size=BSPEC_SLOTS, draft_block=BSPEC_BLOCK,
                                      num_pages=64, stop_token_ids=[])
    _, reading = bspec_run(torch, lm, eng, prompts, BSPEC_TOKENS)
    for k in ("quant_matmul_int8", "paged_attention_int8", "flash_attention_int8"):
        if not reading["launches"].get(k):
            raise AssertionError(f"batch_spec_int8: {k} was not launched")
    bspec_log(info, "batch_spec_int8", "ngram", reading)


def batch_spec_hybrid(torch, lm_h, info: dict) -> None:
    """Phase 17 on the full-depth Qwen3.5-class hybrid through
    SpeculativeBatchEngine (4 slots, blocks of 9): n-gram and self-draft
    (6 layers) runs under phase 4's rule beside the plain BatchEngine's
    tok/s; then one verify round of 4 slots x 9 rows whose drafts are each
    slot's plain stream for two tokens and wrong after: with K1 kept on
    one route on both sides (`k1_one_route`, "small" then "tile"), every
    slot's committed GDN states lie within TOL relative L2 of the states
    the committed tokens give fed one at a time through the engine's
    decode step; the served round (no route kept) is reported beside."""
    from uzu_tpu_torch.engine.batch import BatchEngine
    from uzu_tpu_torch.engine.batch_spec import SpeculativeBatchEngine

    vocab = lm_h.decoder_config.vocab_size
    prompts = bspec_prompts(vocab)[:2] + batched_prompts(vocab)[:2]
    key = "batch_spec_hybrid"

    def engine(**kw):
        return SpeculativeBatchEngine(lm_h, batch_size=BSPEC_HYBRID_SLOTS,
                                      draft_block=BSPEC_BLOCK, stop_token_ids=[], **kw)

    bspec_run(torch, lm_h, engine(), [p[:16] for p in prompts], 4, check=False)  # warm-up
    bspec_log(info, key, "plain_batched", plain_run(
        torch, BatchEngine(lm_h, batch_size=BSPEC_HYBRID_SLOTS, decode_chunk=8,
                           stop_token_ids=[]), prompts, BSPEC_HYBRID_TOKENS))
    for name, kw in (("ngram", {}), ("self_draft",
                                     dict(draft_layers=BSPEC_DRAFT_LAYERS["hybrid"]))):
        _, reading = bspec_run(torch, lm_h, engine(**kw), prompts, BSPEC_HYBRID_TOKENS)
        if not reading["launches_per_round"].get("quant_matmul_int4"):
            raise AssertionError(f"{key} {name}: K1 was not launched by the verify rounds")
        bspec_log(info, key, name, reading)

    # held: the runs' 4 slots of 9 rows (M = 36) with K1 kept on one route
    # on both sides (`k1_one_route`), so that every K1 row of the verify is
    # bitwise the decode step's and what is left is the verify and commit
    # path's own distance; reported beside them: the served round, K1's
    # tile rows at M = 36 against qmm_small's at M = 4 (sums in another
    # order, carried on through bf16 activations over 24 layers)
    served = bspec_partial_commit(torch, lm_h, prompts, BSPEC_BLOCK)
    held = {}
    for route in ("small", "tile"):
        with k1_one_route(route):
            held[route] = bspec_partial_commit(torch, lm_h, prompts, BSPEC_BLOCK)
    bspec_log(info, key, "partial_commit", dict(k1_small=held["small"], k1_tile=held["tile"],
                                                tol=TOL, served=served))
    for route, part in held.items():
        if not all(1 < c < part["block"] for c in part["commits"]):
            raise AssertionError(f"{key} (K1 {route}): commits {part['commits']} are not "
                                 f"partial acceptances")
        if part["pos"] != [len(p) + c for p, c in zip(prompts, part["commits"])]:
            raise AssertionError(f"{key} (K1 {route}): committed positions {part['pos']}")
        if not part["max_rel_l2"] <= TOL:
            raise AssertionError(f"{key} (K1 {route}): a committed GDN state lies "
                                 f"{part['max_rel_l2']:.3e} (relative L2) from the "
                                 f"token-at-a-time one (limit {TOL})")


@contextlib.contextmanager
def k1_one_route(route: str):
    """While open, K1 (`ops/cuda/quant_matmul.py::quant_matmul`, as
    `ops/linear.py` calls it) runs every product on one route, so that a
    row's sum does not depend on how many rows share its launch: "small"
    cuts a product of more than GEMV_MAX_M rows into pieces of at most
    GEMV_MAX_M (qmm_small's rows are bitwise its M = 1 rows); "tile" pads
    a product of at most GEMV_MAX_M rows with zero rows to GEMV_MAX_M + 1
    (qmm_tile's plan is the same for every M from 33 to 128, and a row's
    sum does not depend on the other rows). A witness for the partial-commit
    check only; the engines' runs never open it."""
    import torch
    from uzu_tpu_torch.ops.cuda import quant_matmul as qmm

    launch, cut = qmm.quant_matmul, qmm.GEMV_MAX_M

    def pieces(w, x2):
        return torch.cat([launch(w, x2[i:i + cut]) for i in range(0, x2.shape[0], cut)])

    def padded(w, x2):
        m = x2.shape[0]
        if m > cut:
            return launch(w, x2)
        return launch(w, torch.cat([x2, x2.new_zeros((cut + 1 - m, x2.shape[1]))]))[:m]

    qmm.quant_matmul = {"small": pieces, "tile": padded}[route]
    try:
        yield
    finally:
        qmm.quant_matmul = launch


def bspec_partial_commit(torch, lm_h, prompts, m: int) -> dict:
    """One round of the dense speculative engine over the hybrid (a slot
    per prompt, blocks of m + 1 rows) whose drafts are each slot's plain
    stream for two tokens and wrong after. The reference feeds each slot's
    committed tokens one at a time through the engine's own decode step
    (`batch_decode_step`, a slot with nothing left to feed taking identity
    steps) from a copy of the state the round started from. Returns the
    commits and, per GDN layer, the largest relative L2 distance (ssm or
    conv state, over the slots)."""
    from uzu_tpu_torch.engine.batch_spec import SpeculativeBatchEngine
    from uzu_tpu_torch.models.batch_decode import batch_decode_step

    dev = lm_h.device
    vocab = lm_h.decoder_config.vocab_size
    slots = len(prompts)
    eng = SpeculativeBatchEngine(lm_h, batch_size=slots, draft_block=m, stop_token_ids=[])
    plains = [lm_h.generate_list(p, 3, stop_token_ids=[]) for p in prompts]
    reqs = [eng.submit(p, 64) for p in prompts]
    while eng._admit():
        pass
    eng._fetch_first_tokens()
    drafts = torch.tensor([pl[1:3] + [(t + 1) % vocab for t in range(m - 2)]
                           for pl in plains], device=dev)
    ctx = eng._round_ctx(m + 2, m + 2)
    ref = {"layers": [None if lr is None else {k: v.clone() for k, v in lr.items()}
                      for lr in eng._state["layers"]], "pos": eng._state["pos"].clone()}
    rows, noisy, key0, counts = eng._device_inputs()
    produced = torch.ones(slots, dtype=torch.long, device=dev)
    block = torch.cat([eng._tokens[:, None], drafts], 1)
    _, _, _, _, commit, _ = eng._round(
        ctx, eng._tokens, drafts, torch.full((slots,), m, device=dev), eng._halted,
        eng._remaining, produced, rows, noisy, key0, counts)
    for i in range(int(commit.max())):
        fed = (i < commit).to(torch.int32)
        _, ref = batch_decode_step(lm_h.decoder_config, lm_h.params, block[:, i], ref, fed, ctx)
    commit = commit.tolist()
    per_layer = {}
    for i, (layer, want) in enumerate(zip(eng._state["layers"], ref["layers"])):
        if layer is not None and "ssm" in layer:
            per_layer[i] = max(float((layer[k][b].float() - want[k][b].float()).norm()
                                     / want[k][b].float().norm().clamp(min=1e-30))
                               for k in ("ssm", "conv") for b in range(slots))
    return dict(block=m + 1, k1_rows=slots * (m + 1), commits=commit,
                firsts_equal_plain=[r.tokens[0] == pl[0] for r, pl in zip(reqs, plains)],
                gdn_layers=len(per_layer), max_rel_l2=max(per_layer.values()),
                rel_l2_per_gdn_layer=[per_layer[i] for i in sorted(per_layer)],
                pos=[int(x) for x in eng._state["pos"]],
                ref_pos=[int(x) for x in ref["pos"]],
                prompt_tokens=[len(p) for p in prompts])


def batch_spec_gptoss(torch, lm_oss, info: dict) -> None:
    """Phase 17 on gpt-oss (4 layers) through SpeculativePagedBatchEngine:
    8 slots admitted, then one verify round of 9-row blocks (72 rows: K9's
    tile route) through the engine's verify, against paged_decode_step fed
    the same tokens one row at a time into the same pools, each MoE layer
    taking the verify's expert choices (phase 16's pinning); relative L2
    <= TOL, and every pinned choice a router near-tie (check_routing)."""
    import uzu_tpu_torch.models.moe as moe
    from uzu_tpu_torch.engine.batch_spec import SpeculativePagedBatchEngine
    from uzu_tpu_torch.models.paged_decode import paged_decode_step
    from uzu_tpu_torch.ops.cuda.build import LAUNCHES, reset_launches

    vocab = lm_oss.decoder_config.vocab_size
    layers = len(lm_oss.decoder_config.transformer_config.layer_configs)
    dev = lm_oss.device
    m, b = BSPEC_BLOCK, BSPEC_SLOTS
    eng = SpeculativePagedBatchEngine(lm_oss, batch_size=b, draft_block=m, num_pages=64,
                                      stop_token_ids=[])
    prompts = paged_prompts(vocab)[:b]
    for p in prompts:
        eng.submit(p, 32)
    while eng._admit():
        pass
    eng._fetch_first_tokens()
    drafts = torch.as_tensor(prompt_tokens(b * m + 5, vocab)[5:].reshape(b, m), device=dev)
    blk = torch.cat([eng._tokens[:, None], drafts.long()], 1)
    ctx = eng._round_ctx(m + 2, m + 2)
    pos0 = eng._positions.clone()
    routes = []
    real = moe.router_topk

    def recording(c, p, x):
        r = real(c, p, x)
        routes.append(r[0])
        return r

    moe.router_topk = recording
    reset_launches()
    try:
        logits = eng._verify_forward(ctx, blk, eng._halted)
    finally:
        moe.router_topk = real
    launches = dict(LAUNCHES)
    calls = []

    def replay(x):  # the i-th router call: layer i % layers of row i // layers
        i = len(calls)
        calls.append(i)
        return routes[i % layers].reshape(b, m + 1, -1)[:, i // layers]

    pinned, gaps = pinned_router(torch, replay)
    ref = []
    moe.router_topk = pinned
    try:
        for i in range(m + 1):
            ref.append(paged_decode_step(lm_oss.decoder_config, lm_oss.params, eng.pools,
                                         blk[:, i], ctx[0], pos0 + i))
    finally:
        moe.router_topk = real
    ref = torch.stack(ref, 1).float()
    rel = float((logits.float() - ref).norm() / ref.norm())
    rg = torch.cat(gaps).double().tolist()
    reading = dict(rows=b * (m + 1), rel_l2=rel, tol=TOL, launches={
        k: v for k, v in launches.items() if v}, launches_per_round={
        k: v for k, v in launches.items() if v}, routed_rows=len(rg),
        router_flips=sum(g > 0 for g in rg), max_router_gap=max(rg))
    bspec_log(info, "batch_spec_gptoss", "verify", reading)
    if not launches.get("grouped_matmul_int4") or not launches.get("paged_attention"):
        raise AssertionError(f"batch_spec_gptoss: the verify launched {launches}")
    if not rel <= TOL:
        raise AssertionError(f"batch_spec_gptoss: the verify's logits lie {rel:.3e} (relative "
                             f"L2) from the paged decode steps' (limit {TOL})")
    check_routing([dict(max_router_gap=reading["max_router_gap"])])


# -- phase 18: the serving front end ---------------------------------------------------

SERVE_MODEL = "llama1b_chat"  # the flagship's weights with a full-vocabulary tokenizer
SERVE_VOCAB_SEED = 18
SERVE_SLOTS = 8  # serve_batched picks PagedBatchEngine from 8 slots
# prompts of the batched server (rendered tokens, about): seven alone, five
# sharing a 600-token system prompt (a whole 512-token page of it)
SERVE_LENGTHS = (17, 700, 64, 300, 129, 450, 33)
SERVE_SHARED_USERS = (5, 40, 90, 17, 60)
SERVE_CLASSIFIER = dict(num_layers=12, model_dim=768, hidden_dim=3072, num_heads=12,
                        num_groups=12, head_dim=64, vocab_size=128256, num_labels=8)
SERVE_CLASSIFIER_TOKENS = 100  # classified at buckets 128 and 256


def serve_model_dir(model_dir: str) -> str:
    """`.port_cache/llama1b_chat`: the flagship's weights (linked) and a
    config whose stop ids are `<|end|>`'s, with a byte-level tokenizer
    over all 128256 ids, written here: ids 0-255 are the bytes (the
    ByteLevel table), ids up to 128239 seeded strings of 2-7 lowercase
    letters (half with a leading space), the top 16 ids the synthesizer's
    special tokens; the chat template is the synthesizer's. It has no
    merges, so text encodes byte by byte and every generated id decodes
    to text."""
    import numpy as np
    from tokenizers import Tokenizer, decoders, models, pre_tokenizers

    from uzu_tpu_torch.tools.synth import SPECIAL_TOKENS, SYNTH_CHAT_TEMPLATE

    out = os.path.join(REPO, ".port_cache", SERVE_MODEL)
    os.makedirs(out, exist_ok=True)
    weights = os.path.join(out, "model.safetensors")
    if not os.path.lexists(weights):
        os.symlink(os.path.join(model_dir, "model.safetensors"), weights)
    vocab_size = FLAGSHIP["vocab_size"]
    # the GPT-2 bytes-to-unicode table that ByteLevel reads
    bs = (list(range(ord("!"), ord("~") + 1)) + list(range(0xA1, 0xAD))
          + list(range(0xAE, 0x100)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    byte2char = {b: chr(c) for b, c in zip(bs, cs)}
    vocab = {byte2char[i]: i for i in range(256)}
    rng = np.random.default_rng(SERVE_VOCAB_SEED)
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz"))
    while len(vocab) < vocab_size - len(SPECIAL_TOKENS):
        word = "".join(rng.choice(letters, int(rng.integers(2, 8))))
        vocab.setdefault(("Ġ" if rng.random() < 0.5 else "") + word, len(vocab))
    tok = Tokenizer(models.BPE(vocab=vocab, merges=[], unk_token=None))
    tok.pre_tokenizer = pre_tokenizers.ByteLevel(add_prefix_space=False)
    tok.decoder = decoders.ByteLevel()
    tok.add_special_tokens(SPECIAL_TOKENS)
    if tok.get_vocab_size() != vocab_size:
        raise AssertionError(f"the serving tokenizer has {tok.get_vocab_size()} ids")
    tok.save(os.path.join(out, "tokenizer.json"))
    with open(os.path.join(out, "tokenizer_config.json"), "w") as f:
        json.dump({"eos_token": "<|end|>", "pad_token": "<|pad|>",
                   "chat_template": SYNTH_CHAT_TEMPLATE,
                   "added_tokens_decoder": {str(tok.token_to_id(s)): {"content": s,
                                                                      "special": True}
                                            for s in SPECIAL_TOKENS}}, f, indent=1)
    with open(os.path.join(model_dir, "config.json")) as f:
        raw = json.load(f)
    raw["generation_config"]["stop_token_ids"] = [tok.token_to_id("<|end|>")]
    with open(os.path.join(out, "config.json"), "w") as f:
        json.dump(raw, f, indent=1)
    return out


def serve_lm(torch, lm16, serve_dir: str):
    """The loaded flagship under the serving directory's config (its stop
    ids), sharing lm16's tensors."""
    from uzu_tpu_torch.config import load_language_model_config
    from uzu_tpu_torch.engine.engine import LanguageModel

    return LanguageModel(load_language_model_config(os.path.join(serve_dir, "config.json")),
                         lm16.params, device=lm16.device, max_context=lm16.max_context)


def serve_text(n: int, seed: int) -> str:
    """n characters of seeded lowercase words (one token a character)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    words, size = [], 0
    while size < n:
        w = "".join(rng.choice(list("abcdefghijklmnopqrstuvwxyz"), int(rng.integers(2, 9))))
        words.append(w)
        size += len(w) + 1
    return " ".join(words)[:n]


def serve_messages() -> list[list[dict]]:
    """The batched server's 12 conversations (rendered 17-700 tokens)."""
    # each rendered prompt adds 4 special tokens around a lone user turn
    # and 7 with a system turn before it
    out = [[{"role": "user", "content": serve_text(n - 4, 100 + i)}]
           for i, n in enumerate(SERVE_LENGTHS)]
    system = {"role": "system", "content": serve_text(600, 99)}
    out += [[system, {"role": "user", "content": serve_text(n, 200 + i)}]
            for i, n in enumerate(SERVE_SHARED_USERS)]
    return out


def http_chat(base: str, body: dict) -> tuple:
    """POST /v1/chat/completions -> (response or SSE chunks, content, finish
    reason, timings: latency and, streamed, the first content chunk's)."""
    import urllib.request

    t0 = time.perf_counter()
    req = urllib.request.Request(f"{base}/v1/chat/completions", data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=600) as r:
        if not body.get("stream"):
            res = json.load(r)
            choice = res["choices"][0]
            return (res, choice["message"]["content"], choice["finish_reason"],
                    dict(latency_s=time.perf_counter() - t0, first_chunk_s=None))
        chunks, first = [], None
        for raw in r:
            line = raw.decode().strip()
            if not line.startswith("data: "):
                continue
            if line == "data: [DONE]":
                break
            chunk = json.loads(line[6:])
            if first is None and chunk["choices"] and chunk["choices"][0]["delta"].get("content"):
                first = time.perf_counter() - t0
            chunks.append(chunk)
    content = "".join(c["choices"][0]["delta"].get("content", "") for c in chunks
                      if c["choices"])
    finish = next(c["choices"][0]["finish_reason"] for c in reversed(chunks)
                  if c["choices"] and c["choices"][0].get("finish_reason"))
    return chunks, content, finish, dict(latency_s=time.perf_counter() - t0,
                                          first_chunk_s=first)


def http_get(base: str, path: str) -> dict:
    import urllib.request

    with urllib.request.urlopen(base + path, timeout=60) as r:
        return json.load(r)


def client_text(tok, tokens) -> str:
    """What a client reads for `tokens`: the tokenizer's decode (special
    tokens skipped) of the longest prefix whose decode ends on a whole
    character."""
    for k in range(len(tokens), -1, -1):
        text = tok.decode(tokens[:k], skip_special_tokens=True)
        if not text.endswith("�"):
            return text
    return ""


def grammar_replay(tok, body: dict, tokens: list, stop_ids) -> dict:
    """A constrained output against a fresh matcher of its request: the
    tokens outside the mask of their prefix, whether it closed on a stop
    id, and whether its text parses and satisfies BSPEC_SCHEMA."""
    from uzu_tpu_torch.server.common import grammar_from_request

    replay = grammar_from_request(tok, body)
    replay.stop_token_ids = sorted(stop_ids)  # as the engines set them
    misses = 0
    for t in tokens:
        mask = replay.current_mask()
        misses += int(mask is not None and not mask[t])
        if t in stop_ids:
            break
        replay.observe(t)
    text = tok.decode(tokens, skip_special_tokens=True)
    try:
        value = json.loads(text)
        valid = (set(value) <= {"city", "days"} and value.get("city") in ("Paris", "Rome")
                 and 1 <= value.get("days", 1) <= 30)
    except ValueError:
        valid = False
    return dict(text=text, tokens=len(tokens), closed=bool(tokens) and tokens[-1] in stop_ids,
                valid=valid, mask_misses=misses, backend=replay.backend)


def grammar_body(max_tokens: int = 48) -> dict:
    return dict(messages=[{"role": "user", "content": "plan a trip as json"}],
                max_tokens=max_tokens, temperature=0,
                response_format={"type": "json_schema", "json_schema": {"schema": BSPEC_SCHEMA},
                                 "any_whitespace": False})


def serve_single(torch, lm16, serve_dir: str, info: dict) -> None:
    """`serve(ChatSession(...))` on 127.0.0.1 over the flagship: a plain,
    an SSE-streamed and a JSON-schema request, one after another. Each
    request's prompt ids are the template's render through the tokenizer;
    its text is what a client reads of its tokens; the plain and streamed
    tokens pass phase 4's rule against the single stream; the JSON output
    closes, parses, satisfies BSPEC_SCHEMA and every token lies in its
    matcher's mask. K3 launches 16 times a request (one prefill chunk
    each) and K1 65 times a forward pass. Readings: HTTP latency and first
    chunk, tok/s, beside the engine's own on the same prompt."""
    from uzu_tpu_torch.engine.engine import StreamMetrics
    from uzu_tpu_torch.ops.cuda.build import LAUNCHES, reset_launches
    from uzu_tpu_torch.server import serve
    from uzu_tpu_torch.sessions import ChatSession, Tokenizer

    lm = serve_lm(torch, lm16, serve_dir)
    tok = Tokenizer(serve_dir)
    session = ChatSession(lm, tok)
    stop_ids = session._stop_ids()
    httpd = serve(session, host="127.0.0.1", port=0)
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    # every prompt fits one 256-row prefill chunk
    msgs = [{"role": "system", "content": serve_text(40, 7)},
            {"role": "user", "content": serve_text(150, 8)}]
    bodies = {"plain": dict(messages=msgs, max_tokens=48, temperature=0),
              "stream": dict(messages=msgs[1:], max_tokens=40, temperature=0, stream=True),
              "json": grammar_body()}
    try:
        models = http_get(base, "/v1/models")
        http_chat(base, dict(messages=msgs, max_tokens=4, temperature=0))  # warm-up
        reset_launches()
        out, prompts, streams = {}, [], []
        for name, body in bodies.items():
            _, content, finish, timing = http_chat(base, body)
            reply = session.last_reply
            ids = tok.encode(session.template.render(body["messages"]))
            if reply.stats.tokens_count_input != len(ids):
                raise AssertionError(f"serve {name}: the session prefilled "
                                     f"{reply.stats.tokens_count_input} tokens, the template "
                                     f"renders {len(ids)}")
            want = client_text(tok, reply.tokens)
            if content != want:
                raise AssertionError(f"serve {name}: the response text {content!r} is not the "
                                     f"decode of its tokens {want!r}")
            out[name] = dict(prompt=len(ids), tokens=len(reply.tokens), finish=finish,
                             text_head=content[:48], **timing,
                             http_tok_s=len(reply.tokens) / timing["latency_s"],
                             session_ttft_s=reply.stats.time_to_first_token,
                             session_decode_tok_s=reply.stats.generate_tokens_per_second)
            if name == "json":
                out[name]["grammar"] = grammar_replay(tok, body, reply.tokens, stop_ids)
            else:
                prompts.append(ids)
                streams.append(list(reply.tokens))
        torch.cuda.synchronize()
        launches = dict(LAUNCHES)
    finally:
        httpd.shutdown()
        httpd.server_close()
    # the engine alone on the plain request's prompt
    metrics = StreamMetrics()
    t0 = time.perf_counter()
    lm.generate_list(prompts[0], 48, stop_token_ids=stop_ids, metrics=metrics)
    torch.cuda.synchronize()
    engine_s = time.perf_counter() - t0
    readings = stream_readings(torch, lm, prompts, streams)
    g = out["json"]["grammar"]
    layers = len(lm.params["layers"])
    info["serve_single"] = dict(
        requests=out, models=[m["id"] for m in models["data"]], launches=launches,
        engine_tok_s=len(streams[0]) / engine_s, engine_ttft_s=metrics.prefill_seconds,
        engine_decode_tok_s=metrics.decode_tokens_per_second, **stream_summary(readings))
    log("SERVE_SINGLE " + json.dumps(info["serve_single"]))
    if not (g["closed"] and g["valid"]) or g["mask_misses"]:
        raise AssertionError(f"serve json: {g}")
    if launches["flash_attention"] != layers * len(bodies):
        raise AssertionError(f"serve: K3 launched {launches['flash_attention']} times, "
                             f"expected {layers} for each of {len(bodies)} prefill chunks")
    k1 = launches["quant_matmul_int4"]
    if k1 == 0 or k1 % (4 * layers + 1):
        raise AssertionError(f"serve: K1 launched {k1} times, not {4 * layers + 1} a forward "
                             "pass")
    check_streams(readings)


class SubmitRecorder:
    """Wraps a BatchedChatServer's `submit`: keeps each (prompt ids, engine
    request); `shift` admits the rendered prompt shifted right by one token
    (the first token twice, the last one gone: the planted control)."""

    def __init__(self, server, shift: bool = False):
        self.server, self.real, self.shift, self.log = server, server.submit, shift, []
        server.submit = self

    def __call__(self, prompt_ids, max_tokens, **kw):
        ids = list(prompt_ids)
        req, done = self.real(ids[:1] + ids[:-1] if self.shift else ids, max_tokens, **kw)
        self.log.append((ids, req))
        return req, done


def concurrent_chats(base: str, bodies: list) -> tuple[list, float]:
    results = [None] * len(bodies)

    def send(i):
        try:
            results[i] = http_chat(base, bodies[i])
        except Exception as e:  # read by the caller
            results[i] = e

    t0 = time.perf_counter()
    threads = [threading.Thread(target=send, args=(i,)) for i in range(len(bodies))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    if any(t.is_alive() for t in threads):
        raise AssertionError("an HTTP request did not return within 600 s")
    return results, time.perf_counter() - t0


def serve_batched_phase(torch, lm16, serve_dir: str, info: dict) -> None:
    """`serve_batched(batch_size=8)` over the flagship: it must pick
    `PagedBatchEngine`. 12 concurrent requests from threads: 11 plain
    conversations (rendered 17-700 tokens, five sharing a 600-token system
    prompt, 32-48 tokens each, every other one streamed) and one
    JSON-schema request, which the plain paged engine refuses (HTTP 400,
    as the JAX package's does). Each plain request's prompt ids are the
    template's render; its text is what a client reads of its tokens; its
    stream passes phase 4's rule; none ends in "error" and the scheduler
    keeps no traceback; /v1/models and /v1/stats answer; K5 launches 16
    times a decode step, K3 16 times a prefill chunk and K1 65 times a
    step or chunk. The planted control: one request's prompt shifted by
    one token before admission must fail the stream check. Then
    `serve_batched(batch_size=8, speculate="ngram")`
    (`SpeculativePagedBatchEngine`) serves the JSON request beside three
    plain ones: the output closes, parses and satisfies its schema with
    every token in its matcher's mask; the plain streams pass phase 4's
    rule. Readings: HTTP latency and first chunk per request, aggregate
    tok/s, beside PagedBatchEngine's own on the same prompts."""
    import urllib.error

    from uzu_tpu_torch.engine.paged_batch import PagedBatchEngine
    from uzu_tpu_torch.ops.cuda.build import LAUNCHES, reset_launches
    from uzu_tpu_torch.server import serve_batched
    from uzu_tpu_torch.sessions import Tokenizer

    lm = serve_lm(torch, lm16, serve_dir)
    tok = Tokenizer(serve_dir)
    convs = serve_messages()
    bodies = [dict(messages=m, max_tokens=32 + (5 * i) % 17, temperature=0, stream=i % 2 == 1)
              for i, m in enumerate(convs)]
    httpd = serve_batched(lm, tok, host="127.0.0.1", port=0, batch_size=SERVE_SLOTS,
                          num_pages=64)
    server = httpd.batch_server
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        if type(server.engine) is not PagedBatchEngine:
            raise AssertionError(f"serve_batched picked {type(server.engine).__name__}")
        eng = server.engine
        http_chat(base, dict(messages=convs[0], max_tokens=4, temperature=0))  # warm-up
        rec = SubmitRecorder(server)
        before = dict(eng.stats)
        reset_launches()
        results, wall = concurrent_chats(base, bodies[:11] + [grammar_body()])
        torch.cuda.synchronize()
        launches = dict(LAUNCHES)
        stats = {k: eng.stats[k] - before.get(k, 0) for k in eng.stats}
        refused = results[11]
        if not (isinstance(refused, urllib.error.HTTPError) and refused.code == 400):
            raise AssertionError(f"the plain paged server answered a grammar request: "
                                 f"{refused!r}")
        models, srv_stats = http_get(base, "/v1/models"), http_get(base, "/v1/stats")
        by_prompt = {tuple(ids): req for ids, req in rec.log}
        prompts, streams, per_request = [], [], []
        for body, res in zip(bodies, results[:11]):
            if isinstance(res, Exception):
                raise res
            _, content, finish, timing = res
            ids = tok.encode(server.template.render(body["messages"]))
            req = by_prompt[tuple(ids)]
            if finish == "error" or req.finish_reason == "error":
                raise AssertionError(f"a request ended in error: {req.finish_reason}")
            want = client_text(tok, req.tokens)
            if content != want:
                raise AssertionError(f"batched: the response text {content!r} is not the "
                                     f"decode of its tokens {want!r}")
            prompts.append(ids)
            streams.append(list(req.tokens))
            per_request.append(dict(prompt=len(ids), tokens=len(req.tokens), finish=finish,
                                    stream=bool(body.get("stream")), **timing,
                                    engine_ttft_s=req.ttft))
        if server.errors:
            raise AssertionError("the scheduler kept tracebacks:\n" + "\n".join(server.errors))
        generated = sum(len(s) for s in streams)
        decode_steps = stats["decode_chunks"] * eng.decode_chunk
        layers = len(lm.params["layers"])
        expect = {"paged_attention": layers * decode_steps,
                  "flash_attention": layers * stats["prefill_chunks"],
                  "quant_matmul_int4": (4 * layers + 1) * (decode_steps
                                                           + stats["prefill_chunks"])}
        # the control: the same server, one request shifted by one token
        control = SubmitRecorder(server, shift=True)
        http_chat(base, dict(bodies[3], stream=False))
        server.submit = control.real
        (cids, creq), = control.log
    finally:
        server.shutdown()
        httpd.shutdown()
        httpd.server_close()
    del server, httpd, eng
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    engine = PagedBatchEngine(lm, batch_size=SERVE_SLOTS, decode_chunk=8, num_pages=64,
                              stop_token_ids=list(lm.config.generation_config.stop_token_ids))
    direct = [engine.submit(p, b["max_tokens"]) for p, b in zip(prompts, bodies)]
    engine.run()
    torch.cuda.synchronize()
    engine_s = time.perf_counter() - t0
    del engine
    torch.cuda.empty_cache()
    readings = stream_readings(torch, lm, prompts, streams)
    caught = caught_by_check(torch, lm, cids, creq.tokens)
    info["serve_batched"] = dict(
        engine="PagedBatchEngine", requests=per_request,
        refused_grammar=refused.code, http_seconds=wall, generated=generated,
        http_tok_s=generated / wall, engine_seconds=engine_s,
        engine_tok_s=sum(len(r.tokens) for r in direct) / engine_s,
        engine_equal=[r.tokens == s for r, s in zip(direct, streams)],
        stats=stats, decode_steps=decode_steps, launches=launches, expected_launches=expect,
        models=[m["id"] for m in models["data"]], server_stats=srv_stats,
        control_shift_one_token=caught, **stream_summary(readings))
    log("SERVE_BATCHED " + json.dumps(info["serve_batched"]))
    for k, v in expect.items():
        if launches[k] != v:
            raise AssertionError(f"serve_batched: {k} launched {launches[k]} times, "
                                 f"expected {v}")
    check_streams(readings)
    if caught is None:
        raise AssertionError("the stream check passed a prompt shifted by one token")
    serve_batched_grammar(torch, lm, tok, info)


def serve_batched_grammar(torch, lm, tok, info: dict) -> None:
    """The JSON-schema request beside three plain ones on
    `serve_batched(batch_size=8, speculate="ngram")`."""
    from uzu_tpu_torch.engine.batch_spec import SpeculativePagedBatchEngine
    from uzu_tpu_torch.ops.cuda.build import LAUNCHES, reset_launches
    from uzu_tpu_torch.server import serve_batched

    convs = serve_messages()
    bodies = [grammar_body()] + [dict(messages=convs[i], max_tokens=32, temperature=0,
                                      stream=i == 2) for i in (0, 2, 8)]
    httpd = serve_batched(lm, tok, host="127.0.0.1", port=0, batch_size=SERVE_SLOTS,
                          num_pages=64, speculate="ngram")
    server = httpd.batch_server
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        if type(server.engine) is not SpeculativePagedBatchEngine:
            raise AssertionError(f"serve_batched(speculate) picked "
                                 f"{type(server.engine).__name__}")
        rec = SubmitRecorder(server)
        reset_launches()
        results, wall = concurrent_chats(base, bodies)
        torch.cuda.synchronize()
        launches = dict(LAUNCHES)
        for res in results:
            if isinstance(res, Exception):
                raise res
        if server.errors:
            raise AssertionError("the scheduler kept tracebacks:\n" + "\n".join(server.errors))
        stop_ids = server.engine.stop_ids
        reqs = {tuple(ids): req for ids, req in rec.log}
        prompts = [tok.encode(server.template.render(b["messages"])) for b in bodies]
        ordered = [reqs[tuple(ids)] for ids in prompts]
    finally:
        server.shutdown()
        httpd.shutdown()
        httpd.server_close()
    del server, httpd
    torch.cuda.empty_cache()
    g = grammar_replay(tok, bodies[0], ordered[0].tokens, stop_ids)
    readings = stream_readings(torch, lm, prompts[1:], [r.tokens for r in ordered[1:]])
    info["serve_batched_spec"] = dict(
        grammar=g, content=results[0][1], http_seconds=wall,
        texts_equal=[res[1] == client_text(tok, r.tokens) for res, r in zip(results, ordered)],
        finish=[res[2] for res in results], launches=launches, **stream_summary(readings))
    log("SERVE_BATCHED_SPEC " + json.dumps(info["serve_batched_spec"]))
    if not (g["closed"] and g["valid"]) or g["mask_misses"]:
        raise AssertionError(f"serve_batched json: {g}")
    if not all(info["serve_batched_spec"]["texts_equal"]) or "error" in \
            info["serve_batched_spec"]["finish"]:
        raise AssertionError(f"serve_batched_spec: {info['serve_batched_spec']}")
    for k in ("quant_matmul_int4", "paged_attention", "flash_attention"):
        if not launches.get(k):
            raise AssertionError(f"serve_batched_spec: {k} was not launched")
    check_streams(readings)


def serve_cli(torch, serve_dir: str, info: dict) -> None:
    """`uzu_tpu_torch.cli.main(["bench", ...])` on the serving directory (the
    CLI loads the flagship itself): the BenchResult keys of
    `uzu_tpu/cli.py:84-104`, the card's name as the device, tokens out."""
    from uzu_tpu_torch.cli import main as cli_main

    task = {"identifier": "serve", "repo_id": "local", "number_of_runs": 2,
            "tokens_limit": 32, "greedy": True,
            "messages": [{"role": "user", "content": serve_text(120, 5)}]}
    task_path = os.path.join(REPO, ".port_cache", "serve_task.json")
    out_path = os.path.join(REPO, ".port_cache", "serve_bench.json")
    with open(task_path, "w") as f:
        json.dump(task, f)
    t0 = time.perf_counter()
    rc = cli_main(["bench", serve_dir, task_path, out_path, "--max-context", "4096",
                   "--device", "cuda"])
    with open(out_path) as f:
        result = json.load(f)
    keys = {"task", "device", "engine_version", "timestamp", "data_type", "memory_used",
            "peak_rss_bytes", "cpu_utilization", "tokens_count_input", "tokens_count_output",
            "time_to_first_token", "prompt_tokens_per_second", "generate_tokens_per_second",
            "text"}
    info["serve_cli"] = dict(rc=rc, seconds=time.perf_counter() - t0,
                             device=result["device"], missing=sorted(keys - set(result)),
                             **{k: result[k] for k in ("tokens_count_input",
                                                       "tokens_count_output",
                                                       "time_to_first_token",
                                                       "prompt_tokens_per_second",
                                                       "generate_tokens_per_second",
                                                       "memory_used")})
    log("SERVE_CLI " + json.dumps(info["serve_cli"]))
    if rc != 0 or info["serve_cli"]["missing"]:
        raise AssertionError(f"cli bench: {info['serve_cli']}")
    if result["device"]["cpu_name"] != torch.cuda.get_device_name(0):
        raise AssertionError(f"cli bench reported the device {result['device']}")
    if not (result["tokens_count_output"] > 0 and result["generate_tokens_per_second"] > 0):
        raise AssertionError(f"cli bench generated nothing: {info['serve_cli']}")


def serve_classifier(torch, model_dir: str, info: dict) -> None:
    """The encoder classifier (SERVE_CLASSIFIER: 12 layers, d 768, 12/12
    heads at Dh 64, vocab 128256, bf16, non-causal attention on the plain
    path) through `ClassifierModel.from_dir` on the card and on the host:
    logits of a SERVE_CLASSIFIER_TOKENS-token input within TOL relative
    L2; the same ids padded to buckets 128 and 256 on the card within TOL
    of each other; empty input refused."""
    import numpy as np

    from uzu_tpu_torch.models.classifier import ClassifierModel

    ids = prompt_tokens(SERVE_CLASSIFIER_TOKENS, SERVE_CLASSIFIER["vocab_size"])
    card = ClassifierModel.from_dir(model_dir, device="cuda")
    host = ClassifierModel.from_dir(model_dir, device="cpu")
    t0 = time.perf_counter()
    got = np.asarray(card.classify(ids)["logits"])
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    want = np.asarray(host.classify(ids)["logits"])
    padded = []
    for s in (128, 256):
        x = np.zeros(s, np.int64)
        x[:len(ids)] = ids
        padded.append(card.forward(torch.from_numpy(x).cuda(), len(ids)).cpu().numpy())
    rel = float(np.linalg.norm(got - want) / np.linalg.norm(want))
    pad_rel = float(np.linalg.norm(padded[1] - padded[0]) / np.linalg.norm(padded[0]))
    try:
        card.classify([])
        refused = False
    except ValueError:
        refused = True
    info["serve_classifier"] = dict(config=SERVE_CLASSIFIER, tokens=len(ids),
                                    card_vs_host_rel_l2=rel, padding_rel_l2=pad_rel, tol=TOL,
                                    card_seconds=card_s, logits=got.tolist(),
                                    empty_refused=refused)
    log("SERVE_CLASSIFIER " + json.dumps(info["serve_classifier"]))
    if not (np.isfinite(got).all() and rel <= TOL and pad_rel <= TOL and refused):
        raise AssertionError(f"classifier: {info['serve_classifier']}")


def serve_phases(torch, lm16, dirs: dict, info: dict) -> None:
    """Phase 18: the serving front end on the flagship, then the CLI and
    the classifier."""
    phase = functools.partial(timed_phase, info)
    serve_dir = serve_model_dir(dirs["llama1b_int4"])
    phase("serve_single", serve_single, torch, lm16, serve_dir, info)
    phase("serve_batched", serve_batched_phase, torch, lm16, serve_dir, info)
    phase("serve_cli", serve_cli, torch, serve_dir, info)
    torch.cuda.empty_cache()
    phase("serve_classifier", serve_classifier, torch, dirs["clf_12l"], info)


# -- phase 19: multi-device execution (parallel/) ----------------------------

# K1 at the flagship's linears cut over tp ranks: each rank's qkv rows
# [q_r | k_r | v_r], out's columns, [up_r | gate_r] rows, down's columns
PARALLEL_SHARD_SHAPES = {2: (("qkv", 1536, 2048), ("out", 2048, 1024),
                             ("up|gate", 8192, 2048), ("down", 2048, 4096)),
                         4: (("out", 2048, 512), ("down", 2048, 2048))}
PARALLEL_TOKENS = 64  # greedy tokens of the world-of-one and two-rank streams
PARALLEL_ENGINE_TOKENS = 16  # per request through the batch engines at tp=1


def check_parallel_rows(torch, timer, rows, flash_usage, paged_usage) -> None:
    """Phase 19's kernels at the shard shapes, each against its plain
    version: K1 at the flagship's linears over tp=2 (M = 1 and 256) and the
    column slices of tp=4 that change K/g; K3 over a 256-row chunk and K5
    over 8 slots x 1024 live tokens at half the heads (16 over 4 groups)."""
    gen = torch.Generator(device="cuda").manual_seed(19)
    for tp, shapes in PARALLEL_SHARD_SHAPES.items():
        for wname, n, k in shapes:
            w, wd = random_qweights(torch, gen, n, k, 4)["symmetric"]
            for m in ((1, 256) if tp == 2 else (1,)):
                qmm_row(torch, timer, rows, w, wd, f"{wname}/tp{tp}", m, "symmetric", gen)
    h, g, dh = 16, 4, 64
    q, kc, vc = (torch.randn(shape, device="cuda", generator=gen).to(torch.bfloat16)
                 for shape in ((256, h, dh), (1024, g, dh), (1024, g, dh)))
    flash_row(torch, timer, rows, flash_usage, q, kc, vc, 765, "tp2", {})
    b, page = 8, 512
    maxp = 4096 // page
    p_total = b * maxp + 1
    k = torch.randn((g, p_total, page, dh), device="cuda", generator=gen).to(torch.bfloat16)
    v = torch.randn((g, p_total, page, dh), device="cuda", generator=gen).to(torch.bfloat16)
    table = torch.randperm(p_total - 1, device="cuda", generator=gen)[: b * maxp]
    table = table.reshape(b, maxp).to(torch.int32)
    q = torch.randn((b, h, dh), device="cuda", generator=gen).to(torch.bfloat16)
    lengths = torch.full((b,), 1024, device="cuda", dtype=torch.int32)
    paged_row(torch, timer, rows, paged_usage, q, k, v, table, lengths, "uniform1024", "tp2",
              {})


def parallel_world_of_one(torch, lm16, model_dir: str, info: dict) -> None:
    """Part 1: `initialize()` joins a process group of one over NCCL, and
    `LanguageModel.from_dir(tp=1, dp=1)` runs over its (1, 1) mesh at full
    width: the greedy stream and both batch engines' streams equal the
    unsharded model's in this run, and K1 / K3 / K5 launch as many times a
    step as there."""
    import torch.distributed as dist

    from uzu_tpu_torch.engine.batch import BatchEngine
    from uzu_tpu_torch.engine.engine import LanguageModel, StreamMetrics
    from uzu_tpu_torch.engine.paged_batch import PagedBatchEngine
    from uzu_tpu_torch.ops.cuda.build import LAUNCHES, reset_launches
    from uzu_tpu_torch.parallel import initialize

    joined = initialize()
    if dist.get_backend() != "nccl" or dist.get_world_size() != 1:
        raise AssertionError(f"expected a world of one over nccl, got "
                             f"{dist.get_backend()} x {dist.get_world_size()}")
    probe = torch.ones(4, device="cuda")
    dist.all_reduce(probe)
    torch.cuda.synchronize()
    lm = LanguageModel.from_dir(model_dir, device="cuda", max_context=4096, tp=1, dp=1)
    if lm.mesh is None or tuple(lm.mesh.mesh.shape) != (1, 1):
        raise AssertionError("the model is not over a (1, 1) mesh")
    vocab = FLAGSHIP["vocab_size"]
    prompt = prompt_tokens(GEN_PROMPT, vocab)
    for model in (lm16, lm):
        model.generate_list(prompt[:16], 2, stop_token_ids=[])
    out = {}
    # in turns (unsharded, mesh, mesh, unsharded): the host moves tok/s
    for key, model in (("unsharded", lm16), ("mesh", lm), ("mesh", lm), ("unsharded", lm16)):
        metrics = StreamMetrics()
        reset_launches()
        toks = model.generate_list(prompt, PARALLEL_TOKENS, stop_token_ids=[],
                                   metrics=metrics)
        torch.cuda.synchronize()
        run = dict(tokens=toks, decode_tok_s=[metrics.decode_tokens_per_second],
                   prefill_tok_s=[metrics.prefill_tokens_per_second],
                   launches=dict(LAUNCHES), passes=metrics.num_forward_passes)
        if key in out:
            if toks != out[key]["tokens"] or run["launches"] != out[key]["launches"]:
                raise AssertionError(f"{key}: two greedy runs differ")
            for k in ("decode_tok_s", "prefill_tok_s"):
                out[key][k] += run[k]
        else:
            out[key] = run
    if out["mesh"]["tokens"] != out["unsharded"]["tokens"]:
        raise AssertionError("the world-of-one stream differs from the unsharded one")
    if out["mesh"]["launches"] != out["unsharded"]["launches"]:
        raise AssertionError(f"launches differ: {out['mesh']['launches']} against "
                             f"{out['unsharded']['launches']}")
    layers = len(lm.params["layers"])
    k1 = out["mesh"]["launches"]["quant_matmul_int4"]
    if k1 != (4 * layers + 1) * out["mesh"]["passes"]:
        raise AssertionError(f"K1 launched {k1} times over {out['mesh']['passes']} forward "
                             f"passes, expected {4 * layers + 1} a pass")
    prompts = batched_prompts(vocab)[:4]
    engines = {}
    for name, make in (("paged", lambda m: PagedBatchEngine(
            m, batch_size=4, decode_chunk=8, num_pages=16, stop_token_ids=[])),
                       ("dense", lambda m: BatchEngine(m, batch_size=4, decode_chunk=8,
                                                       stop_token_ids=[]))):
        streams = {}
        for key, model in (("unsharded", lm16), ("mesh", lm)):
            eng = make(model)
            reset_launches()
            reqs = [eng.submit(p, PARALLEL_ENGINE_TOKENS) for p in prompts]
            seconds, _ = drive(torch, eng)
            streams[key] = dict(tokens=[r.tokens for r in reqs], seconds=seconds,
                                launches=dict(LAUNCHES))
            del eng
        if streams["mesh"]["tokens"] != streams["unsharded"]["tokens"]:
            raise AssertionError(f"{name} engine: the world-of-one streams differ")
        engines[name] = streams
    if engines["paged"]["mesh"]["launches"]["paged_attention"] <= 0:
        raise AssertionError("paged_attention was not launched on the world-of-one run")
    info["parallel_world_of_one"] = dict(
        backend=dist.get_backend(), world=dist.get_world_size(), joined=joined,
        nccl_all_reduce=probe.tolist(), tokens_head=out["mesh"]["tokens"][:16],
        decode_tok_s=out["mesh"]["decode_tok_s"],
        unsharded_decode_tok_s=out["unsharded"]["decode_tok_s"],
        prefill_tok_s=out["mesh"]["prefill_tok_s"],
        unsharded_prefill_tok_s=out["unsharded"]["prefill_tok_s"],
        launches=out["mesh"]["launches"], forward_passes=out["mesh"]["passes"],
        engines={name: dict(requests=len(prompts), tokens=PARALLEL_ENGINE_TOKENS,
                            seconds=s["mesh"]["seconds"],
                            unsharded_seconds=s["unsharded"]["seconds"],
                            launches=s["mesh"]["launches"])
                 for name, s in engines.items()})
    log("PARALLEL_WORLD_OF_ONE " + json.dumps(info["parallel_world_of_one"]))
    del lm
    torch.cuda.empty_cache()


def _parallel_rank(rank: int, store: str, model_dir: str, prompt, paged, results) -> None:
    """One of two ranks sharing the card over gloo with CUDA tensors: the
    probe of the collectives tp needs, then the flagship over tp=2 (a
    clean greedy stream and one with the fused [up | gate] rows cut
    contiguously, each with its launches; `PagedBatchEngine` over the
    clean model on the `paged` prompts), and the mean all-reduce time of
    one decode row."""
    try:
        import torch
        import torch.distributed as dist

        sys.path.insert(0, REPO)
        from uzu_tpu_torch.engine.engine import LanguageModel, StreamMetrics
        from uzu_tpu_torch.engine.paged_batch import PagedBatchEngine
        from uzu_tpu_torch.ops.cuda.build import LAUNCHES, reset_launches
        from uzu_tpu_torch.parallel import initialize, make_mesh
        from uzu_tpu_torch.parallel.mesh import Split, axis_rank
        from uzu_tpu_torch.parallel.sharding import apply_specs, decoder_param_specs

        initialize(init_method=f"file://{store}", world_size=2, rank=rank, backend="gloo",
                   device_type="cuda")
        probe = {}
        for name, fn in (
                ("all_reduce", lambda t: dist.all_reduce(t)),
                ("all_gather", lambda t: dist.all_gather([torch.empty_like(t)
                                                          for _ in range(2)], t)),
                ("broadcast", lambda t: dist.broadcast(t, src=0))):
            t = torch.full((8,), float(rank + 1), device="cuda")
            fn(t)
            torch.cuda.synchronize()
            probe[name] = t.tolist()
        mesh = make_mesh(tp=2, dp=1, device_type="cuda")
        full = LanguageModel.from_dir(model_dir, device="cuda", max_context=4096)
        cfg = full.config.decoder_config

        def contiguous(params):
            specs = decoder_param_specs(cfg, params, mesh)
            for ls in specs["layers"]:
                ls["mlp"]["up"]["w"] = Split(dim=0)
            return apply_specs(params, specs, axis_rank(mesh, "tp"), 2,
                               mesh.get_group("tp"))

        out = dict(probe=probe)
        for key, fn in (("clean", None), ("contiguous_up_gate", contiguous)):
            lm = LanguageModel(full.config, full.params, device="cuda", max_context=4096,
                               mesh=mesh, shard_fn=fn)
            lm.generate_list(prompt[:16], 2, stop_token_ids=[])
            metrics = StreamMetrics()
            reset_launches()
            toks = lm.generate_list(prompt, PARALLEL_TOKENS, stop_token_ids=[],
                                    metrics=metrics)
            torch.cuda.synchronize()
            out[key] = dict(tokens=toks, decode_tok_s=metrics.decode_tokens_per_second,
                            prefill_tok_s=metrics.prefill_tokens_per_second,
                            launches=dict(LAUNCHES), passes=metrics.num_forward_passes,
                            heads=lm.decoder_config.transformer_config.layer_configs[0]
                            .mixer_config.num_heads,
                            up_rows=int(lm.params["layers"][0]["mlp"]["up"]["w"].shape[0]),
                            down_cols=int(lm.params["layers"][0]["mlp"]["down"]["w"].w.shape[1]))
            if fn is None:
                eng = PagedBatchEngine(lm, batch_size=4, decode_chunk=8, num_pages=16,
                                       stop_token_ids=[])
                reset_launches()
                reqs = [eng.submit(p, PARALLEL_ENGINE_TOKENS) for p in paged]
                t0 = time.perf_counter()
                eng.run()
                torch.cuda.synchronize()
                out["paged"] = dict(tokens=[r.tokens for r in reqs], launches=dict(LAUNCHES),
                                    seconds=time.perf_counter() - t0,
                                    decode_steps=eng.stats["decode_chunks"] * eng.decode_chunk)
                del eng
            del lm
        row = torch.ones((1, FLAGSHIP["model_dim"]), device="cuda")
        for _ in range(5):
            dist.all_reduce(row)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(50):
            dist.all_reduce(row)
        torch.cuda.synchronize()
        out["all_reduce_ms"] = (time.perf_counter() - t0) / 50 * 1e3
        results.put((rank, out))
        dist.destroy_process_group()
    except Exception:  # reported to the parent, which fails the phase
        import traceback

        results.put((rank, dict(error=traceback.format_exc())))


def parallel_two_ranks(torch, lm16, model_dir: str, info: dict) -> dict:
    """Part 2: two spawned ranks share the card, tp=2 over gloo with CUDA
    tensors (NCCL refuses two ranks on one device). Each holds half the
    heads (16 over 4 groups), 8192 of up|gate's rows and 4096 of down's
    columns; their greedy streams are bitwise one and pass phase 4's rule
    against the unsharded single stream; the contiguous [up | gate] cut
    must fail it. Returns rank 0's launches of the clean stream. A failed
    collective fails the phase."""
    import shutil
    import tempfile

    prompt = prompt_tokens(GEN_PROMPT, FLAGSHIP["vocab_size"])
    paged = batched_prompts(FLAGSHIP["vocab_size"])[:4]
    tmp = tempfile.mkdtemp(prefix="uzu_ranks_", dir=os.path.join(REPO, ".port_cache"))
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_parallel_rank,
                         args=(r, os.path.join(tmp, "store"), model_dir, prompt, paged,
                               results))
             for r in range(2)]
    for p in procs:
        p.start()
    try:
        got = dict(results.get(timeout=600) for _ in procs)
        for p in procs:
            p.join(timeout=60)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
        shutil.rmtree(tmp, ignore_errors=True)
    for r in (0, 1):
        if "error" in got[r]:
            raise AssertionError(f"rank {r} failed:\n{got[r]['error']}")
    rec = dict(probe={r: got[r]["probe"] for r in (0, 1)})
    if rec["probe"][0]["all_reduce"] != [3.0] * 8:
        raise AssertionError(f"gloo's all_reduce over CUDA tensors gave {rec['probe']}")
    clean = [got[r]["clean"] for r in (0, 1)]
    if clean[0]["tokens"] != clean[1]["tokens"]:
        raise AssertionError("the two ranks' greedy streams differ")
    if (clean[0]["heads"], clean[0]["up_rows"], clean[0]["down_cols"]) != (16, 8192, 4096):
        raise AssertionError(f"a rank's slice is not half the flagship's: {clean[0]}")
    readings = stream_readings(torch, lm16, [prompt], [clean[0]["tokens"]])
    log("COMPARED_TWO_RANKS " + json.dumps(readings))
    check_streams(readings)
    bad = got[0]["contiguous_up_gate"]
    bad_readings = stream_readings(torch, lm16, [prompt], [bad["tokens"]])
    try:
        check_streams(bad_readings)
    except AssertionError as e:
        caught = str(e)
    else:
        raise AssertionError("the stream check passed the contiguous [up | gate] cut")
    for name in ("quant_matmul_int4", "flash_attention"):
        if clean[0]["launches"][name] <= 0:
            raise AssertionError(f"{name} was not launched on the two-rank run")
    pg = [got[r]["paged"] for r in (0, 1)]
    if pg[0]["tokens"] != pg[1]["tokens"]:
        raise AssertionError("the two ranks' paged streams differ")
    paged_readings = stream_readings(torch, lm16, paged, pg[0]["tokens"])
    log("COMPARED_TWO_RANKS_PAGED " + json.dumps(paged_readings))
    check_streams(paged_readings)
    layers = len(lm16.params["layers"])
    if pg[0]["launches"]["paged_attention"] != pg[0]["decode_steps"] * layers:
        raise AssertionError(f"paged_attention launched {pg[0]['launches']['paged_attention']} "
                             f"times over {pg[0]['decode_steps']} steps x {layers} layers")
    launches = {n: clean[0]["launches"][n] + pg[0]["launches"][n] for n in clean[0]["launches"]}
    rec.update(
        tokens_head=clean[0]["tokens"][:16], **stream_summary(readings),
        decode_tok_s=[c["decode_tok_s"] for c in clean],
        prefill_tok_s=[c["prefill_tok_s"] for c in clean],
        launches_by_rank={r: clean[r]["launches"] for r in (0, 1)},
        forward_passes=clean[0]["passes"],
        all_reduce_ms={r: got[r]["all_reduce_ms"] for r in (0, 1)},
        all_reduces_per_step=2 * len(lm16.params["layers"]),
        fault_caught=caught, fault_max_gap=bad_readings[0]["max_gap"],
        fault_greedy_choices=bad_readings[0]["greedy_choices"],
        paged=dict(requests=len(paged), tokens=PARALLEL_ENGINE_TOKENS,
                   seconds=pg[0]["seconds"], decode_steps=pg[0]["decode_steps"],
                   launches_rank0=pg[0]["launches"], **stream_summary(paged_readings)),
        launches=launches)
    info["parallel_two_ranks"] = rec
    log("PARALLEL_TWO_RANKS " + json.dumps(rec))
    return launches


def parallel_phase(torch, lm16, model_dir: str, info: dict) -> None:
    """Phase 19: the world of one over NCCL, then two ranks over gloo."""
    import torch.distributed as dist

    phase = functools.partial(timed_phase, info)
    phase("parallel_world_of_one", parallel_world_of_one, torch, lm16, model_dir, info)
    phase("parallel_two_ranks", parallel_two_ranks, torch, lm16, model_dir, info)
    if dist.is_initialized():
        dist.destroy_process_group()


# -- phase 20: the trainer on the card, its weights served, the autotuner, the smoke ----

TRAIN_STEPS = 80
TRAIN_BATCH, TRAIN_SEQ = 16, 512  # the trainer's defaults
TRAIN_CORPUS = 1_000_000  # corpus tokens the windows come from (the trainer's default: 30M)
TRAIN_DROP = 0.75  # mean of the last 10 losses below this share of the first 10's
TRAIN_LOSS_RTOL = 1e-3  # step 0's loss, card against host
TRAIN_GRAD_TOL = 2e-2  # step 0's gradient of each leaf, card against host, rel. L2
TRAINED_TOKENS = 48  # greedy tokens of the trained INT4 model, twice
STEP_REPS = 20  # timed unprofiled steps before the profiled one, --step-profile-only
AUTOTUNE_M = (1, 8, 256)  # the flagship's decode step, the paged step, a prefill chunk
SMOKE_MODEL = "llama1b_int8_2l"  # the serving smoke's model, synthesized for phases 5-6
TRAIN_MODELS = ("llama1b_int4", SMOKE_MODEL)


def _param_paths(tree, prefix: str = "") -> dict:
    """{path: tensor} of a parameter tree (dicts and lists)."""
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items()
                for k2, v2 in _param_paths(v, f"{prefix}{k}.").items()}
    if isinstance(tree, list):
        return {k2: v2 for i, v in enumerate(tree)
                for k2, v2 in _param_paths(v, f"{prefix}{i}.").items()}
    return {prefix[:-1]: tree}


def _step0(device: str, batch, threads: int = 0) -> tuple[float, dict]:
    """The trainer's step 0 on `device`: the loss of `batch` [B, S+1] at
    the initial params (seed 0) and each leaf's gradient, on the host."""
    import tempfile

    import torch

    from uzu_tpu_torch.tools import train_tiny as tt

    if threads:
        torch.set_num_threads(threads)
    tmp = tempfile.mkdtemp(prefix="tiny_init_")
    try:
        lm = tt._build_init(tt.TINY_DIMS, 0, tmp, device)
    finally:
        import shutil

        shutil.rmtree(tmp, ignore_errors=True)
    leaves = _param_paths(lm.params)
    for t in leaves.values():
        t.requires_grad_(True)
    loss = tt._loss_fn(lm.decoder_config, lm.params, lm.new_state(),
                       torch.from_numpy(batch).to(lm.device))
    loss.backward()
    return loss.item(), {k: t.grad.float().cpu().numpy() for k, t in leaves.items()}


def host_step0(batch) -> tuple[float, dict]:
    """`_step0` on the host CPU, in a spawned process: all cores but two."""
    sys.path.insert(0, REPO)
    return _step0("cpu", batch, threads=max(1, (os.cpu_count() or 4) - 2))


def train_step_profile(torch, batch, steps: int = 0) -> dict:
    """One training step of TINY_DIMS (seed 0; AdamW; `batch` [B, S+1]) on
    the card under torch.profiler, after a warm step and `steps` timed
    unprofiled ones: K3b's device ms inside the step (its kernels,
    flash_bwd_*), K3's (flash_fwd, flash_combine), the device-busy ms over
    the traced window and their share, the host ms of the attention's
    autograd ops (FlashAttention*, with the profiler's own cost), and the
    step's wall ms (host clock to a synchronize): each unprofiled step's,
    their median, and the profiled one's.
    The trace goes to .port_cache/traces_train/."""
    import shutil
    import tempfile

    from uzu_tpu_torch.tools import train_tiny as tt

    t_start = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="tiny_init_")
    try:
        lm = tt._build_init(tt.TINY_DIMS, 0, tmp, "cuda")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    leaves = list(_param_paths(lm.params).values())
    for t in leaves:
        t.requires_grad_(True)
    opt = torch.optim.AdamW(leaves, lr=1e-4, weight_decay=0.01)
    state0 = lm.new_state()
    tokens = torch.from_numpy(batch).to(lm.device)

    def step() -> float:
        t0 = time.perf_counter()
        opt.zero_grad(set_to_none=True)
        tt._loss_fn(lm.decoder_config, lm.params, state0, tokens).backward()
        opt.step()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    step()  # the allocator's pools and AdamW's state
    steps_ms = [step() for _ in range(steps)]
    out_dir = os.path.join(REPO, ".port_cache", "traces_train")
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    path = os.path.join(out_dir, "step.json")
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    for attempt in range(2):  # once more where the profiler kept no device event
        with torch.profiler.profile(activities=acts) as prof:
            profiled_ms = step()
        prof.export_chrome_trace(path)
        try:
            kernels, busy_ms, window_ms = trace_device_time(path)
            break
        except AssertionError:
            if attempt:
                raise
    del lm, opt, leaves, state0
    torch.cuda.empty_cache()

    def of(*keys):
        mine = [v for name, v in kernels.items() if any(k in name for k in keys)]
        return sum(v[1] for v in mine), sum(v[0] for v in mine)

    k3b_ms, k3b_n = of("flash_bwd_")
    k3_ms, k3_n = of("flash_fwd", "flash_combine")
    with open(path) as f:  # the host's time in the attention's autograd ops
        host: dict = {}
        for e in json.load(f)["traceEvents"]:
            if e.get("cat") == "cpu_op" and "FlashAttention" in e.get("name", ""):
                h = host.setdefault(e["name"], [0, 0.0])
                h[0] += 1
                h[1] += e["dur"] / 1e3
    reading = dict(
        batch=list(batch.shape), steps_ms=steps_ms,
        step_ms=statistics.median(steps_ms) if steps_ms else None, profiled_step_ms=profiled_ms,
        flash_attention_host_ms=host,
        device_busy_ms=busy_ms, window_ms=window_ms, busy_share=busy_ms / window_ms,
        k3b_device_ms=k3b_ms, k3b_kernels=k3b_n, k3b_share_of_busy=k3b_ms / busy_ms,
        k3_device_ms=k3_ms, k3_kernels=k3_n,
        top_kernels=[[name, n, ms] for name, (n, ms) in
                     sorted(kernels.items(), key=lambda kv: -kv[1][1])[:8]],
        seconds=time.perf_counter() - t_start)
    log("TRAIN_STEP_PROFILE " + json.dumps(reading))
    if not (k3b_n and k3_n):
        raise AssertionError(f"train step profile: {k3b_n} K3b and {k3_n} K3 kernels traced")
    return reading


def attention_host_us(torch, pairs: int = 20, rounds: int = 10) -> dict:
    """The host's µs to enqueue one call of the trainer's attention through
    `flash_attention` (K3 with its L) and one of its gradient
    (`torch.autograd.grad`: K3b) at the trainer's shape (S=512 from
    position 0 over 1024 slots, 6 heads over 2 groups, Dh 64, f32), with
    the card held by a spin meanwhile so that only the host is timed:
    medians over `rounds` x `pairs` calls."""
    from uzu_tpu_torch.ops.cuda.flash_attention import flash_attention
    from uzu_tpu_torch.tools.train_tiny import TINY_DIMS

    gen = torch.Generator(device="cuda").manual_seed(11)
    h, g, dh = TINY_DIMS["num_heads"], TINY_DIMS["num_groups"], TINY_DIMS["head_dim"]
    q = torch.randn((TRAIN_SEQ, h, dh), device="cuda", generator=gen).requires_grad_(True)
    k, v = (torch.randn((TINY_DIMS["max_seq"], g, dh), device="cuda", generator=gen)
            .requires_grad_(True) for _ in range(2))
    qpos = torch.arange(TRAIN_SEQ, device="cuda", dtype=torch.int32)
    d_out = torch.randn((TRAIN_SEQ, h, dh), device="cuda", generator=gen)

    def pair() -> tuple[float, float]:
        t0 = time.perf_counter()
        o = flash_attention(q, k, v, qpos, scale=dh ** -0.5)
        t1 = time.perf_counter()
        torch.autograd.grad(o, (q, k, v), d_out)
        return (t1 - t0) * 1e6, (time.perf_counter() - t1) * 1e6

    pair()
    torch.cuda.synchronize()
    fwd, bwd = [], []
    for _ in range(rounds):
        torch.cuda._sleep(100_000_000)  # ~50 ms of the card, past the round's enqueues
        for f, b in (pair() for _ in range(pairs)):
            fwd.append(f)
            bwd.append(b)
        torch.cuda.synchronize()
    return dict(forward_us=statistics.median(fwd), backward_us=statistics.median(bwd),
                calls=len(fwd))


def train_tiny_phase(torch, info: dict) -> tuple:
    """Phase 20's trainer: TINY_DIMS at batch TRAIN_BATCH, seq TRAIN_SEQ
    for TRAIN_STEPS steps through `train_tiny.train` on the card. Step 0's
    loss and gradients on the card (twice: the gradients' repeatability is
    reported) against the host CPU's (a spawned process, alongside the
    training); the losses finite and dropping; K3 and K3b launched layers
    x batch times a step; steps/s and tokens/s of the step loop. First,
    before the host reference starts, one step under the profiler
    (`train_step_profile`)."""
    import numpy as np

    from uzu_tpu_torch.ops.cuda.build import LAUNCHES, reset_launches
    from uzu_tpu_torch.tools import train_tiny as tt

    dims = tt.TINY_DIMS
    batch0 = tt.train_data(dims, steps=TRAIN_STEPS, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
                           corpus_tokens=TRAIN_CORPUS)[0]
    # before the host reference's process starts: the step's host time alone
    info["train_step_profile"] = train_step_profile(torch, batch0)
    with ProcessPoolExecutor(1, mp_context=multiprocessing.get_context("spawn")) as ex:
        host = ex.submit(host_step0, batch0)
        card_loss, card_grads = _step0("cuda", batch0)
        again_loss, again_grads = _step0("cuda", batch0)
        repeat = {k: bool(np.array_equal(v, again_grads[k])) for k, v in card_grads.items()}
        del again_grads
        torch.cuda.empty_cache()
        stats: dict = {}
        reset_launches()
        lm, params, losses = tt.train(dims, steps=TRAIN_STEPS, batch=TRAIN_BATCH,
                                      seq=TRAIN_SEQ, corpus_tokens=TRAIN_CORPUS, scan_k=25,
                                      log=log, device="cuda", stats=stats)
        launches = dict(LAUNCHES)
        host_loss, host_grads = host.result()
    grad_rel = {k: float(np.linalg.norm(card_grads[k].astype(np.float64) - g)
                         / max(np.linalg.norm(g.astype(np.float64)), 1e-30))
                for k, g in host_grads.items()}
    first, last = float(np.mean(losses[:10])), float(np.mean(losses[-10:]))
    per_step = dims["num_layers"] * TRAIN_BATCH
    secs = stats["loop_seconds"]
    reading = dict(
        steps=TRAIN_STEPS, batch=TRAIN_BATCH, seq=TRAIN_SEQ, dims=dims,
        loss_first10=first, loss_last10=last, losses=losses,
        step0_card_loss=card_loss, step0_card_loss_again=again_loss,
        step0_host_loss=host_loss, step0_loss_rel=abs(card_loss - host_loss) / host_loss,
        step0_first_train_loss=losses[0],
        step0_grad_rel_l2_worst=max(grad_rel.values()),
        step0_grad_rel_l2_worst_leaf=max(grad_rel, key=grad_rel.get),
        step0_grad_rel_l2_embedding=grad_rel["embedding.tied"],
        step0_grads_bitwise_repeat={k: v for k, v in repeat.items() if not v} or "all",
        loop_seconds=secs, steps_per_s=TRAIN_STEPS / secs,
        tokens_per_s=TRAIN_STEPS * TRAIN_BATCH * TRAIN_SEQ / secs,
        launches=launches, launches_per_step={k: v / TRAIN_STEPS for k, v in launches.items()
                                              if v})
    log("TRAIN " + json.dumps({k: v for k, v in reading.items() if k != "losses"}))
    info["train_tiny"] = reading
    if not all(np.isfinite(losses)):
        raise AssertionError("train_tiny: a loss is not finite")
    if not last < TRAIN_DROP * first:
        raise AssertionError(f"train_tiny: the last 10 losses' mean {last:.4f} is not below "
                             f"{TRAIN_DROP} x the first 10's {first:.4f}")
    if not reading["step0_loss_rel"] <= TRAIN_LOSS_RTOL:
        raise AssertionError(f"train_tiny: step 0's loss {card_loss} on the card, {host_loss} "
                             f"on the host (rel. {reading['step0_loss_rel']:.2e})")
    if not reading["step0_grad_rel_l2_worst"] <= TRAIN_GRAD_TOL:
        raise AssertionError(f"train_tiny: step 0's gradient of "
                             f"{reading['step0_grad_rel_l2_worst_leaf']} is "
                             f"{reading['step0_grad_rel_l2_worst']:.2e} rel. L2 off the host's")
    for name in ("flash_attention", "flash_attention_bwd"):
        if launches[name] != TRAIN_STEPS * per_step:
            raise AssertionError(f"train_tiny: {name} launched {launches[name]} times, not "
                                 f"{TRAIN_STEPS} steps x {per_step}")
    return lm, params


def trained_serve_phase(torch, lm, params, info: dict) -> None:
    """The trained weights written by `write_trained` (bf16 and INT4 g32
    under .port_cache/), the INT4 directory served on the card (greedy
    twice, identical; K1 and K3 launched), its held-out NLL against the
    bf16 directory's under tests/test_train_tiny.py:61's bound, and the
    n-gram chain's acceptance on it (a reading)."""
    import numpy as np

    from uzu_tpu_torch.config.model import IntSpec, Layout
    from uzu_tpu_torch.engine.engine import LanguageModel
    from uzu_tpu_torch.engine.speculation import (
        NgramSpeculator,
        SpeculationMetrics,
        SpeculativeDecoder,
    )
    from uzu_tpu_torch.ops.cuda.build import LAUNCHES, reset_launches
    from uzu_tpu_torch.tools import train_tiny as tt
    from uzu_tpu_torch.tools.corpus import generate_tokens, heldout_prompts
    from uzu_tpu_torch.tools.quality import sequence_nll

    out = os.path.join(REPO, ".port_cache", "tiny_real")
    d_bf = tt.write_trained(lm, params, out + "_bf16")
    d_i4 = tt.write_trained(lm, params, out + "_int4", linear_spec=IntSpec(
        bits=4, group_size=32, is_symmetric=True, layout=Layout.OUTPUT_INPUT))
    lm_i4 = LanguageModel.from_dir(d_i4, device="cuda", max_context=1024,
                                   prefill_buckets=(32, 256))
    prompt = np.asarray(heldout_prompts(k=1, length=64)[0])
    reset_launches()
    a = lm_i4.generate_list(prompt, TRAINED_TOKENS, stop_token_ids=[])
    launches = dict(LAUNCHES)
    b = lm_i4.generate_list(prompt, TRAINED_TOKENS, stop_token_ids=[])
    lm_bf = LanguageModel.from_dir(d_bf, device="cuda", max_context=1024,
                                   prefill_buckets=(32, 256))
    ev = generate_tokens(600, seed=12345)
    nll_bf = sequence_nll(lm_bf, ev[:512])["nll"]
    nll_i4 = sequence_nll(lm_i4, ev[:512])["nll"]
    m = SpeculationMetrics()
    spec = list(SpeculativeDecoder(lm_i4, NgramSpeculator(k=15)).generate(
        prompt, TRAINED_TOKENS, stop_token_ids=[], metrics=m))
    reading = dict(greedy=a[:16], greedy_repeat_equal=a == b, launches=launches,
                   nll_bf16=nll_bf, nll_int4=nll_i4, nll_bound=0.25 * max(nll_bf, 1.0),
                   ngram_acceptance=m.acceptance_rate, ngram_proposed=m.num_tokens_proposed,
                   ngram_accepted=m.num_tokens_accepted,
                   ngram_tokens_per_pass=(len(spec) - 1) / max(m.num_verify_passes, 1),
                   ngram_equal_share=sum(x == y for x, y in zip(spec, a)) / len(a),
                   text=bytes(int(t) for t in a).decode("latin-1"))
    log("TRAINED " + json.dumps(reading))
    info["trained_int4"] = reading
    if a != b:
        raise AssertionError("trained INT4 model: two greedy runs differ")
    for k in ("quant_matmul_int4", "flash_attention"):
        if not launches.get(k):
            raise AssertionError(f"trained INT4 model: kernel {k} was not launched")
    if not abs(nll_i4 - nll_bf) < 0.25 * max(nll_bf, 1.0):
        raise AssertionError(f"trained INT4 model: NLL {nll_i4:.4f} against bf16 {nll_bf:.4f}")


def autotune_phase(torch, lm16, info: dict) -> None:
    """`autotune_shapes` over the flagship's linear shapes at AUTOTUNE_M on
    the card, the table saved under .port_cache/ (never into the package),
    `qmm_plan` reading back each entry at each M of its bucket, each tabled
    plan's output within TOL of RMS of the plain version, and a short
    `validate_e2e` on the flagship (ms/token with the table and without)."""
    from uzu_tpu_torch.ops.cuda import autotune as at
    from uzu_tpu_torch.ops.cuda import quant_matmul as qmm
    from uzu_tpu_torch.ops.cuda.flash_attention import num_sms

    shapes = at.model_linear_shapes(model_config("llama1b_int4").decoder_config)
    timings: dict = {}
    t0 = time.perf_counter()
    table = at.autotune_shapes(shapes, m_list=AUTOTUNE_M, reps=16, verbose=False,
                               timings=timings)
    tune_s = time.perf_counter() - t0
    path = os.path.join(REPO, ".port_cache", "tile_table.json")
    if os.path.exists(path):
        os.remove(path)
    at.save_table(table, path)
    prior = os.environ.get("UZU_TPU_TILE_TABLE")
    os.environ["UZU_TPU_TILE_TABLE"] = path
    at._load_table.cache_clear()
    sms = num_sms(torch.device("cuda"))
    gen = torch.Generator().manual_seed(5)
    checks = []
    try:
        for key, entry in table.items():
            bits, n, k, bucket = key.split(":")
            n, k = int(n), int(k)
            w = at._random_weight(n, k, int(bits), 32, gen, "cuda")
            for m in (mm for mm in AUTOTUNE_M if at.m_bucket(mm) == bucket):
                plan = qmm.qmm_plan(m, n, k, int(bits), sms)
                if plan != at.entry_plan(entry, k, bucket, int(bits)):
                    raise AssertionError(f"autotune: qmm_plan({m}, {n}, {k}) = {plan} does not "
                                         f"read back the entry {key} = {entry}")
                x = torch.randn((m, k), generator=gen).to(device="cuda", dtype=torch.bfloat16)
                abs_err, err = rel_err(qmm.quant_matmul(w, x), qmm.quant_matmul_plain(w, x))
                checks.append(dict(key=key, M=m, entry=entry, err_over_rms=err))
                if not err <= TOL:
                    raise AssertionError(f"autotune: {key} at M={m} with {entry}: error "
                                         f"{err:.3e} of RMS > {TOL}")
            del w
        e2e = at.validate_e2e(None, steps=32, rounds=3, verbose=False, lm=lm16)
    finally:
        if prior is None:
            os.environ.pop("UZU_TPU_TILE_TABLE", None)
        else:
            os.environ["UZU_TPU_TILE_TABLE"] = prior
        at._load_table.cache_clear()
    cells = {cell: dict(best_ms=min(c["ms"] for c in cands),
                        heuristic_ms=next(c["ms"] for c in cands if c["heuristic"]))
             for cell, cands in timings.items()}
    heuristic_won = sum(c["heuristic_ms"] == c["best_ms"] for c in cells.values())
    reading = dict(shapes=shapes, m=AUTOTUNE_M, seconds=tune_s, table=table,
                   heuristic_was_best=f"{heuristic_won} of {len(cells)}", cells=cells,
                   checks=checks, timings=timings, validate_e2e=e2e)
    log("AUTOTUNE " + json.dumps({k: v for k, v in reading.items() if k != "timings"}))
    info["autotune"] = reading


def serving_smoke_phase(torch, model_dir: str, info: dict) -> None:
    """`tools/exp_serving_smoke.py` on the card over the 2-layer INT8
    flagship: every stage line must appear, in order."""
    from uzu_tpu_torch.ops.cuda.build import LAUNCHES, reset_launches
    from uzu_tpu_torch.tools import exp_serving_smoke

    lines: list = []

    def keep(line: str) -> None:
        lines.append(line)
        log("SMOKE " + line)

    reset_launches()
    exp_serving_smoke.main(model_dir, device="cuda", log=keep)
    stages = [json.loads(line)["stage"] for line in lines]
    info["serving_smoke"] = dict(stages=stages, launches=dict(LAUNCHES),
                                 readings=[json.loads(line) for line in lines])
    if stages != list(exp_serving_smoke.STAGES):
        raise AssertionError(f"serving smoke: stages {stages}")


def train_phases(torch, lm16, dirs: dict, info: dict) -> None:
    """Phase 20: the trainer, its trained weights served, the autotuner on
    the flagship's shapes (with `lm16`, the INT4 flagship, for the A/B),
    the serving smoke."""
    phase = functools.partial(timed_phase, info)
    lm, params = phase("train_tiny", train_tiny_phase, torch, info)
    phase("trained_int4", trained_serve_phase, torch, lm, params, info)
    del lm, params
    torch.cuda.empty_cache()
    phase("autotune", autotune_phase, torch, lm16, info)
    phase("serving_smoke", serving_smoke_phase, torch, dirs[SMOKE_MODEL], info)


# -- phase 21: the bench tools -----------------------------------------------


def check_bench_rows(torch, timer, rows, flash_usage, paged_usage) -> None:
    """Phase 21's kernels at its models' shapes, each against its plain
    version: K1 at the 8B's five linears (the readout untied) at M = 1 (a
    decode step) and LLAMA8B_CHUNK (its prefill chunk); K3 at the 8B's
    heads (32 over 8 groups, Dh 128) over its first chunk, and at the MoE's
    (16 over 8, two query heads a group, Dh 64) over the last 512-row chunk
    of its 3584-token prompt with the window of 128 and sinks, sinks alone
    and the window alone; K5 at Dh 128 over 8 slots of the 8B's paged run
    (bf16 pools of 128 pages of 64 tokens, the engine's table of 16 page
    columns and the trash page's); K7 at the MoE's stacks (E 16, P = 4) and
    K9 at a 512-row chunk's 2048 routed rows."""
    from uzu_tpu_torch.ops.cuda.grouped_matmul import grouped_bm
    from uzu_tpu_torch.tools import bench8b, benchmoe

    gen = torch.Generator(device="cuda").manual_seed(21)
    for wname, n, k in LLAMA8B_LINEAR_SHAPES:
        w, wd = random_qweights(torch, gen, n, k, 4)["symmetric"]
        for m in (1, LLAMA8B_CHUNK):
            qmm_row(torch, timer, rows, w, wd, wname, m, "symmetric", gen)
        del w, wd
    torch.cuda.empty_cache()
    h, g, dh = (bench8b.DIMS[key] for key in ("num_heads", "num_groups", "head_dim"))
    ctx = 1024  # bench_8b's max_context
    q, kc, vc = (torch.randn(shape, device="cuda", generator=gen).to(torch.bfloat16)
                 for shape in ((LLAMA8B_CHUNK, h, dh), (ctx, g, dh), (ctx, g, dh)))
    flash_row(torch, timer, rows, flash_usage, q, kc, vc, 0, "llama8b", {})
    b, page, pool_pages = 8, 64, 128  # bench_8b's PagedBatchEngine
    k = torch.randn((g, pool_pages, page, dh), device="cuda", generator=gen).to(torch.bfloat16)
    v = torch.randn((g, pool_pages, page, dh), device="cuda", generator=gen).to(torch.bfloat16)
    # each slot's 2 live pages (its 32-token prompt and 48 tokens), then the
    # trash page (the pool's last) in the rest of the table's columns
    table = torch.full((b, ctx // page + 1), pool_pages - 1, device="cuda", dtype=torch.int32)
    table[:, :2] = torch.randperm(pool_pages - 1, device="cuda", generator=gen)[: 2 * b] \
        .reshape(b, 2).to(torch.int32)
    q = torch.randn((b, h, dh), device="cuda", generator=gen).to(torch.bfloat16)
    for lens_name, lens in (("uniform56", [56] * b), ("ragged", [33, 40, 47, 54, 61, 68, 75, 80])):
        lengths = torch.tensor(lens, device="cuda", dtype=torch.int32)
        paged_row(torch, timer, rows, paged_usage, q, k, v, table, lengths, lens_name,
                  "llama8b", {})
    del k, v
    d = benchmoe.DIMS
    h, g, dh = d["num_heads"], d["num_groups"], d["head_dim"]
    ctx, win = 4096, d["sliding_window"]  # bench_moe's max_context
    sinks = torch.randn((h,), device="cuda", generator=gen)
    q, kc, vc = (torch.randn(shape, device="cuda", generator=gen).to(torch.bfloat16)
                 for shape in ((MOE_SMALL_CHUNK, h, dh), (ctx, g, dh), (ctx, g, dh)))
    for variant, kw in (("moe_small_window_sinks", dict(sliding_window_size=win, sinks=sinks)),
                        ("moe_small_sinks", dict(sinks=sinks)),
                        ("moe_small_window", dict(sliding_window_size=win))):
        flash_row(torch, timer, rows, flash_usage, q, kc, vc, 3584 - MOE_SMALL_CHUNK, variant, kw)
    e, active = d["num_experts"], d["num_active"]
    check_moe_gemv(torch, timer, rows, e=e, active=active, shapes=MOE_SMALL_EXPERT_SHAPES,
                   ps=(active,), bits_list=(4,), seed=22)
    bm = grouped_bm(MOE_SMALL_CHUNK, 4, max(k for _, _, k in MOE_SMALL_EXPERT_SHAPES))
    check_grouped_matmul(torch, timer, rows,
                         cases=[("grouped_matmul_int4", MOE_SMALL_CHUNK * active, bm)], e=e,
                         active=active, shapes=MOE_SMALL_EXPERT_SHAPES, seed=23)


class StepLaunches:
    """The kernels each step function of the engines launched while a
    bench tool ran, one {kernel: launches} per call: every single-stream
    forward (`LanguageModel._forward`: a prefill chunk, or a decode step
    where it feeds one token) and every paged decode step and prefill chunk
    (`paged_decode_step`, `paged_prefill_chunk` as `engine/paged_batch.py`
    calls them). `lm` is the model of the last forward."""

    def __init__(self):
        self.calls: dict = {kind: [] for kind in ("prefill", "decode", "paged_prefill",
                                                  "paged_decode")}
        self.lm = None

    @contextlib.contextmanager
    def recording(self):
        from uzu_tpu_torch.engine import paged_batch as pb
        from uzu_tpu_torch.engine.engine import LanguageModel
        from uzu_tpu_torch.ops.cuda.build import LAUNCHES

        def counted(fn, kind_of):
            def call(*args, **kw):
                before = dict(LAUNCHES)
                out = fn(*args, **kw)
                self.calls[kind_of(args)].append(
                    {n: LAUNCHES[n] - before[n] for n in LAUNCHES if LAUNCHES[n] != before[n]})
                return out
            return call

        def forward_kind(args):
            self.lm = args[0]
            return "decode" if args[1].shape[0] == 1 else "prefill"

        real = (LanguageModel._forward, pb.paged_decode_step, pb.paged_prefill_chunk)
        LanguageModel._forward = counted(real[0], forward_kind)
        pb.paged_decode_step = counted(real[1], lambda args: "paged_decode")
        pb.paged_prefill_chunk = counted(real[2], lambda args: "paged_prefill")
        try:
            yield self
        finally:
            LanguageModel._forward, pb.paged_decode_step, pb.paged_prefill_chunk = real

    def per_call(self) -> dict:
        """{kind: {kernel: the distinct launches per call}}."""
        out = {}
        for kind, calls in self.calls.items():
            names = sorted({n for c in calls for n in c})
            out[kind] = {n: sorted({c.get(n, 0) for c in calls}) for n in names}
        return out


def expected_step_launches(lm) -> dict:
    """{kind: {kernel: launches per call}} derived from the model: K1 once
    per INT4 linear of its layers and once for a quantized readout per
    forward and paged step, K3 once per attention layer per prefill chunk,
    K5 once per attention layer per paged step, K7 twice per MoE layer (its
    up|gate and down planes) per decode step, K9 twice per MoE layer per
    prefill chunk."""
    from uzu_tpu_torch.config.model import AttentionConfig, MixtureOfExpertsConfig
    from uzu_tpu_torch.quant.format import QuantizedTensor

    def quantized(tree) -> int:
        if isinstance(tree, QuantizedTensor):
            return 1
        if isinstance(tree, dict):
            return sum(quantized(v) for v in tree.values())
        if isinstance(tree, list):
            return sum(quantized(v) for v in tree)
        return 0

    emb = lm.params["embedding"]
    k1 = quantized(lm.params["layers"]) + quantized(emb.get("output", emb.get("tied")))
    lcs = lm.decoder_config.transformer_config.layer_configs
    attn = sum(isinstance(lc.mixer_config, AttentionConfig) for lc in lcs)
    moe = sum(isinstance(lc.mlp_config, MixtureOfExpertsConfig) for lc in lcs)
    k1 = {"quant_matmul_int4": k1}
    return {"decode": dict(k1, moe_gemv_int4=2 * moe),
            "prefill": dict(k1, flash_attention=attn, grouped_matmul_int4=2 * moe),
            "paged_decode": dict(k1, paged_attention=attn)}


def bench_tool_run(torch, name: str, info: dict):
    """One bench tool on the card through its public function at its
    DIMS, gen_len and prompts (bench_8b with paged=True), the launch
    counts set to 0 just before and read just after; prints its JSON line
    and checks it: the line loads through the port's compare_bench, every
    number finite and > 0, vs_baseline and vs_practical at most
    BENCH_RATE_SLACK, practical_bw_gbs at most BENCH_RATE_SLACK x the
    card's spec rate; every step function's launches per call as
    `expected_step_launches` derives them from the tool's model, and
    each kind of call made. Returns the tool's model."""
    import importlib
    import math

    from uzu_tpu_torch.ops.cuda.build import LAUNCHES, reset_launches
    from uzu_tpu_torch.tools import compare_bench

    mod = importlib.import_module(f"uzu_tpu_torch.tools.{name}")
    fn = getattr(mod, {"bench8b": "bench_8b", "benchmoe": "bench_moe",
                       "bench_qwen08": "bench_qwen08"}[name])
    kw = dict(paged=True) if name == "bench8b" else {}
    steps = StepLaunches()
    t0 = time.perf_counter()

    def stage(s):
        log(f"BENCH_STAGE [{name}] +{time.perf_counter() - t0:.1f} s {s}")

    reset_launches()
    with steps.recording():
        res = fn(REPO, stage, device="cuda", **kw)
    torch.cuda.synchronize()
    launches = dict(LAUNCHES)
    line = json.dumps({"metric": BENCH_METRICS[name], **res})
    log(line)
    path = os.path.join(REPO, ".port_cache", "bench", f"{name}.jsonl")
    with open(path, "w") as f:
        f.write(line + "\n")
    lm = steps.lm
    per_call = steps.per_call()
    expected = expected_step_launches(lm)
    tcfg = lm.decoder_config.transformer_config
    info[name] = dict(result=res, seconds=time.perf_counter() - t0, launches=launches,
                      calls={kind: len(c) for kind, c in steps.calls.items()},
                      launches_per_call=per_call, expected_per_call=expected,
                      layers=len(tcfg.layer_configs), model_dim=tcfg.model_dim)
    log(f"BENCH_{name.upper()} " + json.dumps(info[name]))
    if compare_bench.load_record(path) != {key: float(v) for key, v in res.items()}:
        raise AssertionError(f"{name}: compare_bench does not read back the printed line")
    bad = {key: v for key, v in res.items() if not (math.isfinite(v) and v > 0)}
    if bad:
        raise AssertionError(f"{name}: readings not finite and positive: {bad}")
    for key in ("vs_baseline", "vs_practical"):
        if not res[key] <= BENCH_RATE_SLACK:
            raise AssertionError(f"{name}: {key} {res[key]} > {BENCH_RATE_SLACK}: the bytes "
                                 "a step touches are undercounted")
    if not res["practical_bw_gbs"] <= BENCH_RATE_SLACK * HBM_BYTES_PER_S / 1e9:
        raise AssertionError(f"{name}: the probe read {res['practical_bw_gbs']} GB/s, past "
                             f"the card's {HBM_BYTES_PER_S / 1e9:.0f}")
    if (len(tcfg.layer_configs), tcfg.model_dim) != (mod.DIMS["num_layers"],
                                                    mod.DIMS["model_dim"]):
        raise AssertionError(f"{name}: the tool's model is not at its DIMS")
    kinds = ("prefill", "decode", "paged_decode") if name == "bench8b" else ("prefill", "decode")
    for kind in kinds:
        if not steps.calls[kind]:
            raise AssertionError(f"{name}: no {kind} call ran")
        for kernel, want in expected[kind].items():
            got = per_call[kind].get(kernel, [0])
            if got != [want]:
                raise AssertionError(f"{name}: {kernel} launched {got} times per {kind} call, "
                                     f"expected {want}")
    return lm


def bench_tools_phase(torch, dirs, info: dict) -> None:
    """Phase 21: bench_8b(paged=True), bench_moe and bench_qwen08 on the
    card through the port's public functions (`bench_tool_run`), each
    after its model's synthesis; the 8B's first 2 layers card against host
    (`whole_path_check`, TOL)."""
    from uzu_tpu_torch.tools import bench8b

    phase = functools.partial(timed_phase, info)
    dirs["bench8b"]
    lm = phase("bench8b", bench_tool_run, torch, "bench8b", info)
    phase("whole_path_llama8b", whole_path_check, torch, lm, 2, bench8b.DIMS["vocab_size"],
          "whole_path_llama8b", info)
    del lm
    torch.cuda.empty_cache()
    for name in ("benchmoe", "bench_qwen08"):
        dirs[name]
        phase(name, bench_tool_run, torch, name, info)
        torch.cuda.empty_cache()


def kernel_record(rows, info) -> list[dict]:
    """One entry per kernel at its main-path shape (the decode GEMV of the
    up|gate projection for K1/K2, a 256-row prefill chunk over a 1024-slot
    context for K3/K4, 8 slots x 1024 live tokens in 512-token pages for
    K5/K6, one token's 4 experts of gpt-oss's up projection for K7/K8, the
    paged step's 32 routed rows of it for K9, a 1024-row chunk's 4096 for
    K10, the bisect probe's [256, 16] block for P1), with the launches of
    the path that runs it and the csrc kernel of that shape; errors are the
    worst over every shape checked."""
    spec = {
        "quant_matmul_int4": ("uzu_tpu_torch/csrc/quant_matmul.cu",
                              "uzu_tpu/ops/pallas/quant_matmul.py:183",
                              dict(weight="up|gate", M=1, variant="symmetric"), "int4_path",
                              "qmm_small"),
        "quant_matmul_int8": ("uzu_tpu_torch/csrc/quant_matmul.cu",
                              "uzu_tpu/ops/pallas/quant_matmul.py:247",
                              dict(weight="up|gate", M=1, variant="symmetric"), "int8_path",
                              "qmm_small"),
        "flash_attention": ("uzu_tpu_torch/csrc/flash_attention.cu",
                            "uzu_tpu/ops/pallas/flash_attention.py:111",
                            dict(S=256, C=1024, pos0=765, Dh=64, q="bf16", variant="plain"),
                            "int4_path", "flash_fwd"),
        "flash_attention_int8": ("uzu_tpu_torch/csrc/flash_attention.cu",
                                 "uzu_tpu/ops/pallas/flash_attention.py:132",
                                 dict(S=256, C=1024, pos0=765, Dh=64, q="bf16",
                                      variant="plain"), "paged_int8", "flash_fwd"),
        "paged_attention": ("uzu_tpu_torch/csrc/paged_attention.cu",
                            "uzu_tpu/ops/pallas/paged_attention.py:76",
                            dict(page=512, H=32, Dh=64, q="bf16", lengths="uniform1024",
                                 variant="plain"), "paged_int4", "paged_decode"),
        "paged_attention_int8": ("uzu_tpu_torch/csrc/paged_attention.cu",
                                 "uzu_tpu/ops/pallas/paged_attention.py:115",
                                 dict(page=512, Dh=64, q="bf16", lengths="uniform1024",
                                      variant="plain"), "paged_int8", "paged_decode"),
        "moe_gemv_int4": ("uzu_tpu_torch/csrc/moe_gemv.cu",
                          "uzu_tpu/ops/pallas/moe_gemv.py:68",
                          dict(weight="up", P=4), "gptoss_int4", "moe_small"),
        "moe_gemv_int8": ("uzu_tpu_torch/csrc/moe_gemv.cu",
                          "uzu_tpu/ops/pallas/moe_gemv.py:123",
                          dict(weight="up", P=4), "gptoss_int8", "moe_small"),
        "grouped_matmul_int4": ("uzu_tpu_torch/csrc/grouped_matmul.cu",
                                "uzu_tpu/ops/pallas/grouped_matmul.py:165",
                                dict(weight="up", T=32, bm=8), "paged_gptoss",
                                "grouped_small"),
        "grouped_matmul": ("uzu_tpu_torch/csrc/grouped_matmul.cu",
                           "uzu_tpu/ops/pallas/grouped_matmul.py:67",
                           dict(weight="up", T=4096), "gptoss_int8",
                           "grouped_tile_dense"),
        "scale_block_copy": ("uzu_tpu_torch/csrc/block_copy.cu", "tools/exp_qmm_bisect.py:78",
                             dict(R=256, kg=16), "bisect", "block_copy"),
        # K3b replaces no TPU kernel: it is the gradient of K3's function,
        # which the JAX package's trainer takes through XLA (jax.value_and_grad)
        "flash_attention_bwd": ("uzu_tpu_torch/csrc/flash_attention_bwd.cu",
                                "uzu_tpu/tools/train_tiny.py:110",
                                dict(S=TRAIN_SEQ, pos0=0, q="f32", variant="train"), "train_tiny",
                                "flash_bwd_prep, flash_bwd_dq, flash_bwd_dkdv, flash_bwd_sum"),
    }
    # K3-K6 again at the Gemma models' Dh 256 (at gemma3_1b's heads, 4
    # over 1 group) and at a head dim that runs rounded up (24: K3/K4 in
    # the Dh-32 instantiation, K5/K6 in the Dh-64 one); errors over the
    # rows of that Dh. A rounded Dh runs on no model path here: its
    # launches are its kernel's on the path that runs the kernel.
    # Past Dh 256 (the wide case) at gemma_e4b_8l's heads, 8 over 2: Dh
    # 512 on the synthetic Dh-512 models' paths (K3 single stream, K5
    # paged; K4/K6 run on no Dh-512 path here), Dh 264 on none.
    for dh, paths_of in ((256, ("gemma3_1b", "gemma3_1b_kv_int8", "paged_gemma3_1b",
                                "paged_int8_gemma3_1b")),
                         (24, ("int4_path", "paged_int8", "paged_int4", "paged_int8")),
                         (512, ("gemma_dh512", "paged_int8", "paged_windowed_dh512",
                                "paged_int8")),
                         (264, ("int4_path", "paged_int8", "paged_int4", "paged_int8"))):
        at = dict(H=4, G=1) if dh == 256 else dict(H=8, G=2)
        for name, path in zip(("flash_attention", "flash_attention_int8", "paged_attention",
                               "paged_attention_int8"), paths_of):
            src, replaces, _, _, kernel = spec[name]
            where = (dict(S=256, C=1024, pos0=765, q="bf16", variant="gemma_plain")
                     if name.startswith("flash") else
                     dict(page=512, q="bf16", variant="gemma_plain",
                          lengths="uniform1024" if dh == 24 else "uniform1000"))
            spec[f"{name}_dh{dh}"] = (src, replaces, dict(where, Dh=dh, **at), path, kernel)
    paths = [key for key, v in info.items()
             if isinstance(v, dict) and isinstance(v.get("launches"), dict)]
    # the chain verify's shapes (phase 16): K1 at M = 16 / 32 on the
    # up|gate linear, K3 at S = 16 / 32 from SPEC_POS0 at the flagship's
    # heads and the hybrid's; launches of the oracle chain runs (blocks of
    # 32 rows on the flagship, 16 on the hybrid)
    verify = {}
    for r in SPEC_ROWS:
        verify[f"quant_matmul_int4_verify_m{r}"] = (
            "quant_matmul_int4", dict(weight="up|gate", M=r, variant="symmetric"),
            ("spec_flagship", "chain_oracle"))
        verify[f"flash_attention_verify_s{r}"] = (
            "flash_attention", dict(S=r, C=1024, pos0=SPEC_POS0, Dh=64, H=32),
            ("spec_flagship", "chain_oracle"))
        verify[f"flash_attention_verify_s{r}_dh32"] = (
            "flash_attention", dict(S=r, C=1024, pos0=SPEC_POS0, Dh=32, H=8),
            ("spec_hybrid", "chain_oracle"))
    # the batched verify's shapes (phase 17): K1 at M = 72 / 36 on the
    # up|gate linear (the flagship's and the hybrid's n-gram runs), K5 / K6
    # at 8 slots x 9 rows over repeated tables (the flagship's and the INT8
    # flagship's n-gram runs), K9 at the verify's 288 routed rows (gpt-oss)
    bspec = {
        f"quant_matmul_int4_bspec_m{BSPEC_M[0]}": (
            "quant_matmul_int4", dict(weight="up|gate", M=BSPEC_M[0], variant="symmetric"),
            ("batch_spec_flagship", "ngram")),
        f"quant_matmul_int4_bspec_m{BSPEC_M[1]}": (
            "quant_matmul_int4", dict(weight="up|gate", M=BSPEC_M[1], variant="symmetric"),
            ("batch_spec_hybrid", "ngram")),
        "paged_attention_bspec_r72": ("paged_attention", dict(lengths="verify9"),
                                      ("batch_spec_flagship", "ngram")),
        "paged_attention_int8_bspec_r72": ("paged_attention_int8", dict(lengths="verify9"),
                                           ("batch_spec_int8", "ngram")),
        "grouped_matmul_int4_bspec_t288": (
            "grouped_matmul_int4", dict(weight="up", T=BSPEC_M[0] * GPTOSS["num_active"]),
            ("batch_spec_gptoss", "verify")),
    }
    # phase 19's shard shapes: K1 at tp=2's up|gate rows (M = 1, 256) and
    # tp=4's down columns, K3 and K5 at half the heads; launches of rank 0
    # of the two ranks sharing the card (tp=4 runs on no path here, so its
    # row has none)
    shard = {
        "quant_matmul_int4_tp2_m1": ("quant_matmul_int4",
                                     dict(weight="up|gate/tp2", M=1), "parallel_two_ranks"),
        "quant_matmul_int4_tp2_m256": ("quant_matmul_int4",
                                       dict(weight="up|gate/tp2", M=256), "parallel_two_ranks"),
        "quant_matmul_int4_tp4_m1": ("quant_matmul_int4", dict(weight="down/tp4", M=1), None),
        "flash_attention_tp2": ("flash_attention", dict(H=16, variant="tp2"),
                                "parallel_two_ranks"),
        "paged_attention_tp2": ("paged_attention", dict(H=16, variant="tp2"),
                                "parallel_two_ranks"),
    }
    # phase 21's shapes: K1 at the 8B's linears (M = 1 and its prefill
    # chunk's rows), K3 at its heads (Dh 128) and at the MoE's (two query
    # heads a group, window and sinks), K5 at Dh 128 over 64-token pages, K7
    # at the MoE's E = 16, P = 4 and K9 at its chunk's 2048 routed rows;
    # launches of the tool's run
    bench = {f"quant_matmul_int4_{w.replace('/', '_').replace('|', '')}_m{m}": (
        "quant_matmul_int4", dict(weight=w, M=m), "bench8b")
        for w, _, _ in LLAMA8B_LINEAR_SHAPES for m in (1, LLAMA8B_CHUNK)}
    bench.update({
        "flash_attention_llama8b": ("flash_attention", dict(variant="llama8b"), "bench8b"),
        "flash_attention_moe_small": ("flash_attention", dict(variant="moe_small_window_sinks"),
                                      "benchmoe"),
        "paged_attention_llama8b": ("paged_attention", dict(variant="llama8b",
                                                            lengths="uniform56"), "bench8b"),
        "moe_gemv_int4_moe_small": ("moe_gemv_int4", dict(weight="moe_small/up", P=4),
                                    "benchmoe"),
        "grouped_matmul_int4_moe_small": ("grouped_matmul_int4",
                                          dict(weight="moe_small/up",
                                               T=MOE_SMALL_CHUNK * 4), "benchmoe"),
    })
    out = []
    for name, (src, replaces, where, path, kernel) in spec.items():
        kname = name.split("_dh")[0]
        mine = [r for r in rows if r["kernel"] == kname
                and ("_dh" not in name or r["Dh"] == where["Dh"])]
        rep = next(r for r in mine if all(r[k] == v for k, v in where.items()))
        out.append(dict(
            name=name, route="cuda", source=src, kernel=kernel, replaces=replaces,
            launches=info[path]["launches"][kname],
            launches_by_path={key: info[key]["launches"][kname] for key in paths
                              if info[key]["launches"].get(kname)},
            max_abs_err=max(r["max_abs_err"] for r in mine),
            err_over_rms=max(r["err_over_rms"] for r in mine), tol=rep["tol"],
            ms=rep["ms"], device_ms=rep["device_ms"], plain_ms=rep["plain_ms"],
            bound_ms=rep["bound_ms"], bound_by=rep["bound_by"], library_ms=rep["library_ms"],
            library_device_ms=rep["library_device_ms"],
            **({"launches_per_training_step": info[path]["launches_per_step"][kname]}
               if kname == "flash_attention_bwd" else {}),
            shape={k: rep[k] for k in rep if k in ("weight", "N", "K", "M", "S", "H", "G",
                                                    "Dh", "C", "pos0", "q", "splits", "variant",
                                                    "instance", "window",
                                                    "B", "page",
                                                    "lengths", "live_tokens", "E", "P", "T",
                                                    "Tp", "bm", "route", "kw", "bn",
                                                    "items", "blocks",
                                                    "used_tiles", "distinct_experts",
                                                    "R", "kg", "width")}))
    for name, (kname, where, (path, run)) in verify.items():
        src, replaces, _, _, kernel = spec[kname]
        mine = [r for r in rows if r["kernel"] == kname
                and all(r[k] == v for k, v in where.items())]
        rep = mine[0]
        reading = info[path][run]
        out.append(dict(
            name=name, route="cuda", source=src, kernel=kernel, replaces=replaces,
            launches=reading["launches"].get(kname, 0),
            launches_per_verify_round=reading["launches_per_round"].get(kname, 0),
            launches_by_path={f"{path}/{run}": reading["launches"].get(kname, 0)},
            max_abs_err=max(r["max_abs_err"] for r in mine),
            err_over_rms=max(r["err_over_rms"] for r in mine), tol=rep["tol"],
            ms=rep["ms"], device_ms=rep["device_ms"], plain_ms=rep["plain_ms"],
            bound_ms=rep["bound_ms"], bound_by=rep["bound_by"], library_ms=rep["library_ms"],
            library_device_ms=rep["library_device_ms"],
            shape={k: rep[k] for k in rep if k in ("weight", "N", "K", "M", "S", "H", "G",
                                                    "Dh", "C", "pos0", "q", "splits",
                                                    "variant", "instance")}))
    for name, (kname, where, (path, run)) in bspec.items():
        src, replaces, _, _, kernel = spec[kname]
        mine = [r for r in rows if r["kernel"] == kname
                and all(r[k] == v for k, v in where.items())]
        rep = mine[0]
        reading = info[path][run]
        out.append(dict(
            name=name, route="cuda", source=src, kernel=kernel, replaces=replaces,
            launches=reading["launches"].get(kname, 0),
            launches_per_verify_round=reading["launches_per_round"].get(kname, 0),
            launches_by_path={f"{path}/{run}": reading["launches"].get(kname, 0)},
            max_abs_err=max(r["max_abs_err"] for r in mine),
            err_over_rms=max(r["err_over_rms"] for r in mine), tol=rep["tol"],
            ms=rep["ms"], device_ms=rep["device_ms"], plain_ms=rep["plain_ms"],
            bound_ms=rep["bound_ms"], bound_by=rep["bound_by"], library_ms=rep["library_ms"],
            library_device_ms=rep["library_device_ms"],
            shape={k: rep[k] for k in rep if k in (
                "weight", "N", "K", "M", "H", "G", "Dh", "q", "splits", "variant", "B", "page",
                "width", "lengths", "live_tokens", "distinct_live_tokens", "E", "T", "Tp", "bm",
                "route", "bn", "used_tiles", "distinct_experts")}))
    for name, (kname, where, path) in shard.items():
        mine = [r for r in rows if r["kernel"] == kname
                and all(r.get(k) == v for k, v in where.items())]
        src, replaces, _, _, kernel = spec[kname]
        rep = mine[0]
        launches = info[path]["launches"][kname] if path else 0
        out.append(dict(
            name=name, route="cuda", source=src, kernel=kernel, replaces=replaces,
            launches=launches, launches_by_path={path or "none": launches},
            max_abs_err=max(r["max_abs_err"] for r in mine),
            err_over_rms=max(r["err_over_rms"] for r in mine), tol=rep["tol"],
            ms=rep["ms"], device_ms=rep["device_ms"], plain_ms=rep["plain_ms"],
            bound_ms=rep["bound_ms"], bound_by=rep["bound_by"], library_ms=rep["library_ms"],
            library_device_ms=rep["library_device_ms"],
            shape={k: rep[k] for k in rep if k in (
                "weight", "N", "K", "M", "S", "H", "G", "Dh", "C", "pos0", "q", "splits",
                "variant", "B", "page", "width", "lengths", "live_tokens")}))
    for name, (kname, where, path) in bench.items():
        mine = [r for r in rows if r["kernel"] == kname
                and all(r.get(k) == v for k, v in where.items())]
        src, replaces, _, _, kernel = spec[kname]
        rep = mine[0]
        reading = info[path]
        out.append(dict(
            name=name, route="cuda", source=src, kernel=kernel, replaces=replaces,
            launches=reading["launches"].get(kname, 0),
            launches_per_call={kind: counts.get(kname)
                               for kind, counts in reading["launches_per_call"].items()
                               if kname in counts},
            launches_by_path={path: reading["launches"].get(kname, 0)},
            max_abs_err=max(r["max_abs_err"] for r in mine),
            err_over_rms=max(r["err_over_rms"] for r in mine), tol=rep["tol"],
            ms=rep["ms"], device_ms=rep["device_ms"], plain_ms=rep["plain_ms"],
            bound_ms=rep["bound_ms"], bound_by=rep["bound_by"], library_ms=rep["library_ms"],
            library_device_ms=rep["library_device_ms"],
            shape={k: rep[k] for k in rep if k in (
                "weight", "N", "K", "M", "S", "H", "G", "Dh", "C", "pos0", "q", "splits",
                "variant", "B", "page", "width", "lengths", "live_tokens", "E", "P", "T", "Tp",
                "bm", "route", "kw", "bn", "used_tiles", "distinct_experts")}))
    return out


def kernel_phase(torch, info: dict) -> list:
    """Phase 2: every kernel's rows against its plain version, alone on
    the card; returns the rows."""
    from uzu_tpu_torch.ops.cuda import build as kbuild

    timer = Timer(torch)
    rows: list = []
    info["qmm_ptxas"] = template_usage(kbuild.BUILD_LOGS.get("quant_matmul", ""), "qmm")
    log("QMM_PTXAS " + json.dumps(info["qmm_ptxas"]))
    check_quant_matmul(torch, timer, rows)
    check_quant_matmul_hybrid(torch, timer, rows)
    check_qmm_rows(torch, info)
    usage = kernel_usage(kbuild.BUILD_LOGS.get("flash_attention", ""), "flash_fwd")
    info["flash_ptxas"] = usage
    log("FLASH_PTXAS " + json.dumps(usage))
    check_flash_attention(torch, timer, rows, usage)
    check_flash_attention_int8(torch, timer, rows, usage)
    check_attention_gptoss(torch, timer, rows, usage)
    check_flash_hybrid(torch, timer, rows, usage)
    check_flash_gemma(torch, timer, rows, usage)
    t_k3b = time.perf_counter()
    check_flash_lse(torch, info)
    info["flash_bwd_ptxas"] = template_usage(kbuild.BUILD_LOGS.get("flash_attention_bwd", ""),
                                             "flash_bwd")
    log("FLASH_BWD_PTXAS " + json.dumps(info["flash_bwd_ptxas"]))
    check_bwd_plan(info)
    check_flash_bwd(torch, timer, rows)
    # the part of the kernels phase that K3's L and K3b's rows take
    info["k3_lse_k3b_rows_seconds"] = time.perf_counter() - t_k3b
    check_spec_rows(torch, timer, rows, usage)
    paged_usage = kernel_usage(kbuild.BUILD_LOGS.get("paged_attention", ""), "paged_decode")
    info["paged_ptxas"] = paged_usage
    log("PAGED_PTXAS " + json.dumps(paged_usage))
    check_paged_attention(torch, timer, rows, paged_usage)
    check_paged_gptoss(torch, timer, rows, paged_usage)
    check_paged_gemma(torch, timer, rows, paged_usage)
    info["moe_ptxas"] = template_usage(kbuild.BUILD_LOGS.get("moe_gemv", ""), "moe")
    log("MOE_PTXAS " + json.dumps(info["moe_ptxas"]))
    check_moe_gemv(torch, timer, rows)
    info["grouped_ptxas"] = template_usage(kbuild.BUILD_LOGS.get("grouped_matmul", ""), "grouped")
    log("GROUPED_PTXAS " + json.dumps(info["grouped_ptxas"]))
    check_grouped_matmul(torch, timer, rows)
    check_grouped_rows(torch, info)
    check_moe_rows(torch, info)
    check_block_copy(torch, timer, rows)
    check_selective_scan(torch, timer, rows)
    check_jamba_rows(torch, timer, rows)
    check_batch_spec_rows(torch, timer, rows, paged_usage)
    check_parallel_rows(torch, timer, rows, usage, paged_usage)
    t_bench = time.perf_counter()
    check_bench_rows(torch, timer, rows, usage, paged_usage)
    info["bench_rows_seconds"] = time.perf_counter() - t_bench
    del timer
    torch.cuda.empty_cache()
    return rows


def head_phases(torch, lm16, dirs, info: dict) -> None:
    """The first process's phases after phase 3: the flagships' (the INT4
    one, `lm16`, and the 2-layer INT8 one) of phases 3-6, 9-12 and 16-17,
    and phase 18."""
    phase = functools.partial(timed_phase, info)
    phase("path_int4_kv_int8", path_int4_kv_int8, torch, lm16, info)
    phase("paged_int4", path_paged_int4, torch, lm16, info)
    phase("path_int8", path_int8, torch, dirs["llama1b_int8_2l"], info)
    phase("paged_int8", path_paged_int8, torch, dirs["llama1b_int8_2l"], info)
    phase("control", control_planted_faults, torch, lm16, info)
    phase("whole_path", whole_path_check, torch, lm16, 2, FLAGSHIP["vocab_size"],
          "whole_path", info)
    phase("tools_profile", tools_profile, torch, lm16, "flagship", FLAGSHIP["vocab_size"], info)
    phase("tools_microbench", tools_microbench, torch, lm16, info)
    phase("tools_step_breakdown", tools_step_breakdown, torch, dirs["llama1b_int4"], info)
    phase("tools_quality", tools_quality, torch, lm16, info)
    phase("tools_bisect", tools_bisect, torch, info)
    phase("sampled", path_sampled, torch, lm16, info)
    phase("spec_flagship", spec_flagship, torch, lm16, dirs, info)
    phase("batch_spec_flagship", batch_spec_flagship, torch, lm16, info)
    phase("batch_spec_int8", batch_spec_int8, torch, dirs["llama1b_int8_2l"], info)
    torch.cuda.empty_cache()
    serve_phases(torch, lm16, dirs, info)


def second_phases(torch, dirs, info: dict) -> None:
    """The second process's phases, in the order of its models' synthesis:
    phase 13 (the hybrids, with their parts of phases 16-17), gpt-oss's
    (phases 7-8 and its parts of 9-10 and 16-17) and phase 14 (Gemma)."""
    phase = functools.partial(timed_phase, info)
    lm_h = phase("hybrid", path_hybrid, torch, dirs["qwen08_int4"], info)
    phase("hybrid_chunking", hybrid_chunking_check, torch, lm_h, info)
    phase("whole_path_hybrid", whole_path_check, torch, lm_h, 4, QWEN08["vocab_size"],
          "whole_path_hybrid", info, True)
    phase("recurrent_families", path_recurrent_families, torch, dirs, info)
    phase("batched", path_batched, torch, lm_h, info)
    phase("control_batched", control_batched_fault, torch, lm_h, info)
    phase("spec_hybrid", spec_hybrid, torch, lm_h, info)
    phase("batch_spec_hybrid", batch_spec_hybrid, torch, lm_h, info)
    phase("tools_profile_hybrid", tools_profile, torch, lm_h, "hybrid", QWEN08["vocab_size"],
          info)
    del lm_h
    torch.cuda.empty_cache()
    lm_oss = phase("gptoss_int4", path_gptoss_int4, torch, dirs["gptoss_int4"], info)
    phase("paged_gptoss", path_paged_gptoss, torch, lm_oss, info)
    phase("gptoss_int8", path_gptoss_int8, torch, dirs["gptoss_int8_2l"], info)
    torch.cuda.empty_cache()
    phase("control_moe", control_moe_faults, torch, lm_oss, info)
    phase("whole_path_gptoss", whole_path_check, torch, lm_oss, 2, GPTOSS["vocab_size"],
          "whole_path_gptoss", info)
    phase("spec_gptoss", spec_gptoss, torch, lm_oss, info)
    phase("batch_spec_gptoss", batch_spec_gptoss, torch, lm_oss, info)
    phase("tools_profile_gptoss", tools_profile, torch, lm_oss, "gptoss", GPTOSS["vocab_size"],
          info)
    del lm_oss
    torch.cuda.empty_cache()
    gemma_phases(torch, dirs, info)


def third_phases(torch, dirs, info: dict) -> None:
    """The third process's phases: 19 and 20 on the INT4 flagship (its own
    copy, loaded from the first process's synthesis), then phases 15 and
    21."""
    from uzu_tpu_torch.engine.engine import LanguageModel

    lm16 = LanguageModel.from_dir(dirs["llama1b_int4"], device="cuda", max_context=4096)
    timed_phase(info, "parallel", parallel_phase, torch, lm16, dirs["llama1b_int4"], info)
    train_phases(torch, lm16, dirs, info)
    del lm16
    torch.cuda.empty_cache()
    slice_phases(torch, dirs, info)
    torch.cuda.empty_cache()
    bench_tools_phase(torch, dirs, info)


def side_process(conn, name: str) -> None:
    """A side process of the full run: synthesizes its SIDE_MODELS, waits
    for the first process's word that phase 2's timed rows are done (the
    flagship's single-stream reading and SHARED_MODELS' directories; None
    stops it there), runs its phases (`second_phases` or `third_phases`)
    and sends back ("ok", its readings), ("stopped", {}) or ("error", the
    traceback)."""
    import traceback

    try:
        import torch

        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        t0 = time.perf_counter()
        info: dict = {"phase_seconds": {}}
        workers, names = SIDE_MODELS[name]
        with ProcessPoolExecutor(workers, mp_context=multiprocessing.get_context("spawn")) as ex:
            dirs = ModelDirs(ex, names)
            word = conn.recv()
            if word is None:
                ex.shutdown(cancel_futures=True)
                result = ("stopped", {})
            else:
                dirs.add(word.pop("model_dirs"))
                info.update(word)
                {"second": second_phases, "third": third_phases}[name](torch, dirs, info)
                info[f"{name}_process"] = dict(seconds=time.perf_counter() - t0,
                                               model_wait_seconds=dirs.waited)
                result = ("ok", info)
    except BaseException:
        result = ("error", traceback.format_exc())
    with contextlib.suppress(OSError):
        conn.send(result)


def side_results(sides: dict) -> list[dict]:
    """Each side process's readings once all have ended; their errors are
    raised here."""
    out, errors = [], []
    for name, (conn, proc) in sides.items():
        try:
            status, payload = conn.recv()
        except EOFError:
            status, payload = "error", "it ended without a result"
        proc.join()
        if status == "error":
            errors.append(f"the {name} process failed (exit code {proc.exitcode}):\n{payload}")
        out.append(payload)
    if errors:
        raise RuntimeError("\n".join(errors))
    return out


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card only",
              file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(REPO, "uzu_tpu_torch")):
        print("chip_smoke: run it from a checkout of the repository (uzu_tpu_torch/ "
              "is missing)", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # K1's plans are the built-in heuristics in every phase (the row-bitwise
    # checks hold them), whatever tile table the checkout holds; the autotune
    # phase alone points them at the table it measures, and restores this
    os.environ["UZU_TPU_TILE_TABLE"] = os.devnull
    from uzu_tpu_torch.ops.cuda import build as kbuild

    t_start = time.perf_counter()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    info: dict = {"nvidia_smi": smi, "torch": torch.__version__,
                  "cuda": torch.version.cuda, "phase_seconds": {}}
    log(f"CARD {smi}")

    only = {"--flash-only": ("flash_attention",), "--paged-only": ("paged_attention",),
            "--qmm-only": ("quant_matmul", "moe_gemv", "grouped_matmul"),
            "--grouped-only": ("grouped_matmul", "moe_gemv")}
    for flag, sources in only.items():
        if flag not in sys.argv[1:]:
            continue
        # one kernel's rows of phase 2 alone; run it in two checkouts in
        # turns (A, B, B, A) to compare two versions of the kernel on one card
        source = sources[0]
        log(f"BUILD {', '.join(sources)} built in {kbuild.build(sources):.1f} s")
        timer, rows = Timer(torch), []
        if source == "quant_matmul":
            log("QMM_PTXAS " + json.dumps(template_usage(kbuild.BUILD_LOGS.get(source, ""), "qmm")))
            log("MOE_PTXAS " + json.dumps(template_usage(kbuild.BUILD_LOGS.get("moe_gemv", ""),
                                                         "moe")))
            check_quant_matmul(torch, timer, rows)
            check_quant_matmul_hybrid(torch, timer, rows)
            check_quant_matmul_prefill(torch, timer, rows)
            check_qmm_rows(torch, {})
            check_moe_gemv(torch, timer, rows)
            check_grouped_matmul(torch, timer, rows)
        elif source == "grouped_matmul":
            log("GROUPED_PTXAS " + json.dumps(template_usage(kbuild.BUILD_LOGS.get(source, ""),
                                                             "grouped")))
            log("MOE_PTXAS " + json.dumps(template_usage(kbuild.BUILD_LOGS.get("moe_gemv", ""),
                                                         "moe")))
            check_moe_gemv(torch, timer, rows, sweep=True)
            check_moe_rows(torch, {})
            check_grouped_matmul(torch, timer, rows, sweep=True)
            check_grouped_rows(torch, {})
        elif source == "flash_attention":
            usage = kernel_usage(kbuild.BUILD_LOGS.get(source, ""), "flash_fwd")
            log("FLASH_PTXAS " + json.dumps(usage))
            check_flash_attention(torch, timer, rows, usage)
            check_flash_lse(torch, info)
            check_flash_attention_int8(torch, timer, rows, usage)
            check_attention_gptoss(torch, timer, rows, usage)
            check_flash_hybrid(torch, timer, rows, usage)
            check_flash_gemma(torch, timer, rows, usage)
        else:
            usage = kernel_usage(kbuild.BUILD_LOGS.get(source, ""), "paged_decode")
            log("PAGED_PTXAS " + json.dumps(usage))
            check_paged_attention(torch, timer, rows, usage)
            check_paged_gptoss(torch, timer, rows, usage)
            check_paged_gemma(torch, timer, rows, usage)
        log(f"{flag[2:].replace('-', '_').upper()} {len(rows)} rows")
        return 0

    if "--jamba-only" in sys.argv[1:]:
        sources = ("selective_scan", "quant_matmul", "flash_attention")
        log(f"BUILD {', '.join(sources)} built in {kbuild.build(sources):.1f} s")
        log("SCAN_PTXAS " + json.dumps(kbuild.ptxas_usage(kbuild.BUILD_LOGS.get("selective_scan", ""))))
        timer, rows = Timer(torch), []
        check_selective_scan(torch, timer, rows)
        check_jamba_rows(torch, timer, rows)
        log(f"JAMBA_ONLY {len(rows)} rows")
        return 0

    if "--hybrid-linear-only" in sys.argv[1:]:
        # the slice of phase 15 alone: K3-K6's rows past Dh 256, the plain
        # flagship's single stream (its decode tok/s beside the hybrid's),
        # and phase 15
        names = ("llama1b_int4", *SLICE_MODELS)
        t0 = time.perf_counter()
        with ProcessPoolExecutor(len(names), mp_context=multiprocessing.get_context("spawn")) as ex:
            dirs = dict(zip(names, ex.map(synth_model, names)))
        log(f"BUILD kernels built in {kbuild.build():.1f} s, models synthesized in "
            f"{time.perf_counter() - t0:.1f} s")
        timer, rows = Timer(torch), []
        check_flash_gemma(torch, timer, rows,
                          kernel_usage(kbuild.BUILD_LOGS.get("flash_attention", ""), "flash_fwd"),
                          parts=("wide",))
        check_paged_gemma(torch, timer, rows,
                          kernel_usage(kbuild.BUILD_LOGS.get("paged_attention", ""),
                                       "paged_decode"), parts=("wide",))
        del timer
        torch.cuda.empty_cache()
        lm16 = timed_phase(info, "path_int4", path_int4, torch, dirs["llama1b_int4"], info)
        del lm16
        torch.cuda.empty_cache()
        slice_phases(torch, dirs, info)
        log("HYBRID_LINEAR_ONLY " + json.dumps(info["phase_seconds"]))
        return 0

    if "--spec-only" in sys.argv[1:]:
        # phase 16 alone, with its K1/K3 verify-shape rows
        from uzu_tpu_torch.engine.engine import LanguageModel

        t0 = time.perf_counter()
        with ProcessPoolExecutor(len(SPEC_MODELS),
                                 mp_context=multiprocessing.get_context("spawn")) as ex:
            dirs = dict(zip(SPEC_MODELS, ex.map(synth_model, SPEC_MODELS)))
        log(f"BUILD kernels built in {kbuild.build():.1f} s, models synthesized in "
            f"{time.perf_counter() - t0:.1f} s")
        timer, rows = Timer(torch), []
        check_spec_rows(torch, timer, rows,
                        kernel_usage(kbuild.BUILD_LOGS.get("flash_attention", ""), "flash_fwd"))
        del timer
        torch.cuda.empty_cache()
        phase = functools.partial(timed_phase, info)
        for name, fn, args in (("spec_flagship", spec_flagship, (dirs, info)),
                               ("spec_gptoss", spec_gptoss, (info,)),
                               ("spec_hybrid", spec_hybrid, (info,))):
            model = {"spec_flagship": "llama1b_int4", "spec_gptoss": "gptoss_int4",
                     "spec_hybrid": "qwen08_int4"}[name]
            lm = LanguageModel.from_dir(dirs[model], device="cuda", max_context=4096)
            phase(name, fn, torch, lm, *args)
            del lm
            torch.cuda.empty_cache()
        log("SPEC_ONLY " + json.dumps(info["phase_seconds"]))
        return 0

    if "--batch-spec-only" in sys.argv[1:]:
        # phase 17 alone, with its K1 / K5 / K6 / K9 verify-shape rows
        from uzu_tpu_torch.engine.engine import LanguageModel

        t0 = time.perf_counter()
        with ProcessPoolExecutor(len(BSPEC_MODELS),
                                 mp_context=multiprocessing.get_context("spawn")) as ex:
            dirs = dict(zip(BSPEC_MODELS, ex.map(synth_model, BSPEC_MODELS)))
        log(f"BUILD kernels built in {kbuild.build():.1f} s, models synthesized in "
            f"{time.perf_counter() - t0:.1f} s")
        timer, rows = Timer(torch), []
        check_batch_spec_rows(torch, timer, rows,
                              kernel_usage(kbuild.BUILD_LOGS.get("paged_attention", ""),
                                           "paged_decode"))
        del timer
        torch.cuda.empty_cache()
        phase = functools.partial(timed_phase, info)
        for name, fn, model in (("batch_spec_gptoss", batch_spec_gptoss, "gptoss_int4"),
                                ("batch_spec_flagship", batch_spec_flagship, "llama1b_int4"),
                                ("batch_spec_hybrid", batch_spec_hybrid, "qwen08_int4")):
            lm = LanguageModel.from_dir(dirs[model], device="cuda", max_context=4096)
            phase(name, fn, torch, lm, info)
            del lm
            torch.cuda.empty_cache()
        phase("batch_spec_int8", batch_spec_int8, torch, dirs["llama1b_int8_2l"], info)
        log("BATCH_SPEC_ONLY " + json.dumps(info["phase_seconds"]))
        return 0

    if "--serve-only" in sys.argv[1:]:
        # phase 18 alone, on the flagship
        from uzu_tpu_torch.engine.engine import LanguageModel

        t0 = time.perf_counter()
        with ProcessPoolExecutor(len(SERVE_MODELS),
                                 mp_context=multiprocessing.get_context("spawn")) as ex:
            dirs = dict(zip(SERVE_MODELS, ex.map(synth_model, SERVE_MODELS)))
        log(f"BUILD kernels built in {kbuild.build():.1f} s, models synthesized in "
            f"{time.perf_counter() - t0:.1f} s")
        lm16 = LanguageModel.from_dir(dirs["llama1b_int4"], device="cuda", max_context=4096)
        serve_phases(torch, lm16, dirs, info)
        log("SERVE_ONLY " + json.dumps(info["phase_seconds"]))
        return 0

    if "--parallel-only" in sys.argv[1:]:
        # phase 19 alone, with its shard-shape kernel rows
        from uzu_tpu_torch.engine.engine import LanguageModel

        t0 = time.perf_counter()
        with ProcessPoolExecutor(1, mp_context=multiprocessing.get_context("spawn")) as ex:
            synth = ex.submit(synth_model, "llama1b_int4")
            built = kbuild.build()
            dirs = {"llama1b_int4": synth.result()}
        log(f"BUILD kernels built in {built:.1f} s, models synthesized in "
            f"{time.perf_counter() - t0:.1f} s")
        timer, rows = Timer(torch), []
        check_parallel_rows(torch, timer, rows,
                            kernel_usage(kbuild.BUILD_LOGS.get("flash_attention", ""),
                                         "flash_fwd"),
                            kernel_usage(kbuild.BUILD_LOGS.get("paged_attention", ""),
                                         "paged_decode"))
        del timer
        torch.cuda.empty_cache()
        lm16 = LanguageModel.from_dir(dirs["llama1b_int4"], device="cuda", max_context=4096)
        timed_phase(info, "parallel", parallel_phase, torch, lm16, dirs["llama1b_int4"], info)
        log("PARALLEL_ONLY " + json.dumps(info["phase_seconds"]))
        return 0

    if "--bench-drivers-only" in sys.argv[1:]:
        # phase 21 alone, with its kernel rows of phase 2
        t0 = time.perf_counter()
        with ProcessPoolExecutor(len(BENCH_TOOLS),
                                 mp_context=multiprocessing.get_context("spawn")) as ex:
            synth = ex.map(synth_model, BENCH_TOOLS)
            built = kbuild.build()
            dirs = dict(zip(BENCH_TOOLS, synth))
        log(f"BUILD kernels built in {built:.1f} s, models synthesized in "
            f"{time.perf_counter() - t0:.1f} s")
        timer, rows = Timer(torch), []
        check_bench_rows(torch, timer, rows,
                         kernel_usage(kbuild.BUILD_LOGS.get("flash_attention", ""), "flash_fwd"),
                         kernel_usage(kbuild.BUILD_LOGS.get("paged_attention", ""),
                                      "paged_decode"))
        del timer
        torch.cuda.empty_cache()
        bench_tools_phase(torch, dirs, info)
        log("BENCH_DRIVERS_ONLY " + json.dumps(info["phase_seconds"]))
        return 0

    if "--flash-bwd-only" in sys.argv[1:]:
        # K3's L and K3b's rows of phase 2 alone (with ptxas's usage of K3b)
        log(f"BUILD flash_attention, flash_attention_bwd built in "
            f"{kbuild.build(('flash_attention', 'flash_attention_bwd')):.1f} s")
        log("FLASH_BWD_PTXAS " + json.dumps(
            template_usage(kbuild.BUILD_LOGS.get("flash_attention_bwd", ""), "flash_bwd")))
        timer, rows = Timer(torch), []
        t0 = time.perf_counter()
        check_flash_lse(torch, info)
        check_bwd_plan(info)
        check_flash_bwd(torch, timer, rows, breakdown=True)
        log(f"FLASH_BWD_ONLY {len(rows)} rows in {time.perf_counter() - t0:.1f} s")
        return 0

    if "--step-profile-only" in sys.argv[1:]:
        # one profiled training step alone (phase 20's), to read K3b inside
        # a step in two checkouts in turns
        from uzu_tpu_torch.tools import train_tiny as tt

        log(f"BUILD flash_attention, flash_attention_bwd built in "
            f"{kbuild.build(('flash_attention', 'flash_attention_bwd')):.1f} s")
        batch = tt.train_data(tt.TINY_DIMS, steps=1, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
                              corpus_tokens=TRAIN_CORPUS)[0]
        reading = train_step_profile(torch, batch, STEP_REPS)
        reading = dict(attention_host_us(torch), step_ms=reading["step_ms"])
        log("ATTENTION_HOST_US " + json.dumps(reading))
        return 0

    if "--train-only" in sys.argv[1:]:
        # phase 20 alone, with K3's L and K3b's rows of phase 2
        from uzu_tpu_torch.engine.engine import LanguageModel

        t0 = time.perf_counter()
        with ProcessPoolExecutor(len(TRAIN_MODELS),
                                 mp_context=multiprocessing.get_context("spawn")) as ex:
            synth = ex.map(synth_model, TRAIN_MODELS)
            built = kbuild.build()
            dirs = dict(zip(TRAIN_MODELS, synth))
        log(f"BUILD kernels built in {built:.1f} s, models synthesized in "
            f"{time.perf_counter() - t0:.1f} s")
        log("FLASH_BWD_PTXAS " + json.dumps(
            template_usage(kbuild.BUILD_LOGS.get("flash_attention_bwd", ""), "flash_bwd")))
        timer, rows = Timer(torch), []
        check_flash_lse(torch, info)
        check_bwd_plan(info)
        check_flash_bwd(torch, timer, rows)
        del timer
        torch.cuda.empty_cache()
        lm16 = LanguageModel.from_dir(dirs["llama1b_int4"], device="cuda", max_context=4096)
        train_phases(torch, lm16, dirs, info)
        log("TRAIN_ONLY " + json.dumps(info["phase_seconds"]))
        return 0

    if "--gemma-only" in sys.argv[1:]:
        # the Gemma slice alone: its kernel rows and phase 14
        t0 = time.perf_counter()
        with ProcessPoolExecutor(2, mp_context=multiprocessing.get_context("spawn")) as ex:
            dirs = dict(zip(GEMMA_MODELS, ex.map(synth_model, GEMMA_MODELS)))
        log(f"BUILD kernels built in {kbuild.build():.1f} s, models synthesized in "
            f"{time.perf_counter() - t0:.1f} s")
        timer, rows = Timer(torch), []
        check_flash_gemma(torch, timer, rows,
                          kernel_usage(kbuild.BUILD_LOGS.get("flash_attention", ""), "flash_fwd"),
                          parts=("256", "rounded"))
        check_paged_gemma(torch, timer, rows,
                          kernel_usage(kbuild.BUILD_LOGS.get("paged_attention", ""),
                                       "paged_decode"), parts=("256", "rounded"))
        gemma_phases(torch, dirs, info)
        log("GEMMA_ONLY " + json.dumps(info["phase_seconds"]))
        return 0

    # phase 1: build the kernels while the flagship's models are
    # synthesized; the side processes synthesize their own from the start
    ctx = multiprocessing.get_context("spawn")
    sides = {}
    for name in SIDE_MODELS:
        conn, side_conn = ctx.Pipe()
        proc = ctx.Process(target=side_process, args=(side_conn, name))
        proc.start()
        side_conn.close()
        sides[name] = (conn, proc)
    told = False
    try:
        with ProcessPoolExecutor(len(HEAD_MODELS), mp_context=ctx) as ex:
            dirs = ModelDirs(ex, HEAD_MODELS)
            info["build_seconds"] = kbuild.build()
            log(f"BUILD kernels built in {info['build_seconds']:.1f} s (synthesis alongside)")
            rows = timed_phase(info, "kernels", kernel_phase, torch, info)
            lm16 = timed_phase(info, "path_int4", path_int4, torch, dirs["llama1b_int4"], info)
            # phase 2's timed rows are done: the side processes share the
            # card from here on
            word = {"int4_path": info["int4_path"],
                    "model_dirs": {n: dirs[n] for n in SHARED_MODELS}}
            for conn, _ in sides.values():
                conn.send(word)
            told = True
            head_phases(torch, lm16, dirs, info)
            del lm16
            torch.cuda.empty_cache()
        info["model_wait_seconds"] = dirs.waited
    finally:
        if not told:
            for conn, _ in sides.values():
                with contextlib.suppress(OSError):
                    conn.send(None)  # the side process stops before its phases
        side_info = side_results(sides)
    for side in side_info:
        info["phase_seconds"].update(side.pop("phase_seconds"))
        info.update(side)
    info["phase_seconds"]["total"] = time.perf_counter() - t_start
    log("PHASES " + json.dumps(info["phase_seconds"]))

    record = kernel_record(rows, info)
    os.makedirs(os.path.join(REPO, ".port_cache"), exist_ok=True)
    with open(os.path.join(REPO, ".port_cache", "chip_smoke.json"), "w") as f:
        json.dump(dict(info, kernel_rows=rows, kernels=record), f, indent=1)
    name = torch.cuda.get_device_name(0)
    print(smi)
    print(json.dumps({"kernels": record}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
