"""Command-line interface: bench / serve / chat / classify / synth / ppl / autotune.

Role parity: crates/cli (main.rs:19-38 — bench | server | storage |
interactive chat). The bench subcommand consumes the reference's
benchmark_task.json shape (BenchTask, cli/src/bench/model.rs:6-19) and
emits BenchResult-compatible JSON (model.rs:55-68) so existing tooling can
compare runs across engines.

    python -m uzu_tpu_torch.cli bench  <model_dir> <task.json> <out.json>
    python -m uzu_tpu_torch.cli serve  <model_dir> [--port 8000] [--host ...]
    python -m uzu_tpu_torch.cli chat   <model_dir> [--max-tokens N]
    python -m uzu_tpu_torch.cli classify <model_dir> <text...>
    python -m uzu_tpu_torch.cli synth  <kind> <out_dir> [--seed N]
    python -m uzu_tpu_torch.cli storage <models_dir> [--delete ID]
    python -m uzu_tpu_torch.cli ppl    <model_dir> <text file>
    python -m uzu_tpu_torch.cli autotune <model_dir> [--reps N] [--validate-e2e] [--out PATH]

The port's counterpart of `uzu_tpu/cli.py`. Every subcommand that loads a
model takes `--device` (default `cuda`: the card, raising without one;
`cpu` runs the plain PyTorch path), and bench reports the card's name from
`torch.cuda.get_device_name`. `autotune` measures K1's launch plans on
the card (`ops/cuda/autotune.py`) and raises without one. A bundled speculator is skipped only when
its directory is malformed (`engine.facade.SPECULATOR_DIR_ERRORS`).

`bench`, `serve`, `chat` and `ppl` take `--tp` / `--dp`: the model is
split over a (dp, tp) mesh of tp·dp ranks (`parallel/`). Under torchrun
(or any launcher that sets RANK / WORLD_SIZE) each rank runs this command
and joins the launcher's group; without one, the command starts tp·dp−1
follower processes itself (spawned, over a file store in a temporary
directory) and runs as rank 0. Rank 0 alone prints, writes files and
serves HTTP; the others run the same engine calls in lockstep
(`server/lockstep.py`).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def _load_chat(model_dir: str, max_context: int, device: str, speculate=None,
               tp=None, dp=None):
    from uzu_tpu_torch import LanguageModel
    from uzu_tpu_torch.engine.facade import SPECULATOR_DIR_ERRORS
    from uzu_tpu_torch.sessions import ChatSession, Tokenizer

    lm = LanguageModel.from_dir(model_dir, device=device, max_context=max_context, tp=tp,
                                dp=dp)
    tok = Tokenizer(model_dir)
    speculator = speculate  # "self" / "fused-self" strings pass through
    spec_cfg = os.path.join(model_dir, "speculator", "config.json")
    if speculator is None and os.path.exists(spec_cfg):
        try:
            from uzu_tpu_torch.engine.dflash import DFlashDraft
            from uzu_tpu_torch.engine.speculation import (
                DFlashSpeculativeDecoder,
                speculation_supported,
            )

            if speculation_supported(lm.decoder_config) and lm.mesh is None:
                draft = DFlashDraft.from_dir(os.path.dirname(spec_cfg),
                                             max_context=max_context, device=device)
                speculator = DFlashSpeculativeDecoder(lm, draft)
        except SPECULATOR_DIR_ERRORS:
            speculator = None  # malformed speculator dir: plain decoding
    return ChatSession(lm, tok, speculator=speculator)


def cmd_bench(args) -> int:
    from uzu_tpu_torch.engine.sampling import SamplingParams

    with open(args.task) as f:
        task = json.load(f)
    session = _load_chat(args.model_dir, args.max_context, args.device, tp=args.tp,
                         dp=args.dp)

    messages = [
        {"role": m["role"], "content": m["content"]} for m in task.get("messages", [])
    ]
    limit = int(task.get("tokens_limit", 128))
    runs = int(task.get("number_of_runs", 1))
    sampling = SamplingParams() if task.get("greedy", True) else None

    # warmup (runner.rs:67-68)
    session.reset()
    session.reply(list(messages), sampling=sampling, max_new_tokens=min(limit, 8))

    from uzu_tpu_torch.tools.telemetry import ResourceMeter, device_memory

    meter = ResourceMeter()
    meter.start()
    results = []
    for _ in range(runs):
        session.reset()
        reply = session.reply(list(messages), sampling=sampling, max_new_tokens=limit)
        results.append(reply)
    reading = meter.stop()
    on_card = session.model.device.type == "cuda"
    dev = device_memory() if on_card else None

    last = results[-1]
    mean = lambda xs: sum(xs) / len(xs)
    out = {
        "task": task,
        "device": {
            "os_name": sys.platform,
            "cpu_name": _device_kind(session.model.device),
            "memory_total": 0,
        },
        "engine_version": _version(),
        "timestamp": int(time.time()),
        "data_type": "bf16",
        "memory_used": dev.live_buffer_bytes if dev else reading.peak_rss_bytes,
        "peak_rss_bytes": reading.peak_rss_bytes,
        "cpu_utilization": round(reading.cpu_utilization, 3),
        "tokens_count_input": last.stats.tokens_count_input,
        "tokens_count_output": last.stats.tokens_count_output,
        "time_to_first_token": mean([r.stats.time_to_first_token for r in results]),
        "prompt_tokens_per_second": mean(
            [r.stats.prefill_tokens_per_second for r in results]
        ),
        "generate_tokens_per_second": mean(
            [r.stats.generate_tokens_per_second for r in results]
        ),
        "text": last.text,
    }
    if not _leader():
        return 0
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    from uzu_tpu_torch.ops.cuda.autotune import table_in_use

    print(json.dumps({
        "ttft": round(out["time_to_first_token"], 4),
        "prefill_tok_s": round(out["prompt_tokens_per_second"], 2),
        "decode_tok_s": round(out["generate_tokens_per_second"], 2),
        "tile_table": table_in_use(),
    }))
    return 0


def cmd_serve(args) -> int:
    name = os.path.basename(args.model_dir.rstrip("/")) or "uzu-tpu"
    if args.batched:
        from uzu_tpu_torch import LanguageModel
        from uzu_tpu_torch.server import serve_batched
        from uzu_tpu_torch.sessions import Tokenizer

        lm = LanguageModel.from_dir(args.model_dir, device=args.device,
                                    max_context=args.max_context, tp=args.tp, dp=args.dp)
        httpd = serve_batched(lm, Tokenizer(args.model_dir), host=args.host,
                              port=args.port, model_name=name,
                              batch_size=args.batch_size,
                              speculate=args.speculate)
        stop = None if httpd is None else httpd.batch_server.shutdown
    else:
        if args.speculate:
            print("warning: --speculate applies to the --batched server "
                  "only; serving plain single-stream", file=sys.stderr)
        session = _load_chat(args.model_dir, args.max_context, args.device, tp=args.tp,
                             dp=args.dp)
        from uzu_tpu_torch.server import serve

        httpd = serve(session, host=args.host, port=args.port, model_name=name)
        stop = None if httpd is None else httpd.chat_server.stop_followers
    if httpd is None:
        return 0  # a follower rank: rank 0 has shut the server down
    print(f"serving OpenAI-compatible API on http://{args.host}:{httpd.server_address[1]}/v1")
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        stop()
        httpd.shutdown()
    return 0


def cmd_chat(args) -> int:
    from uzu_tpu_torch.engine.sampling import SamplingParams

    session = _load_chat(args.model_dir, args.max_context, args.device,
                         speculate=args.speculate, tp=args.tp, dp=args.dp)
    from uzu_tpu_torch.server.lockstep import lockstep_for

    lockstep = lockstep_for(session.model)
    leader = lockstep is None or lockstep.leader
    sampling = SamplingParams(temperature=args.temperature, top_p=0.95) \
        if args.temperature else SamplingParams()

    def make_grammar():
        """Fresh per turn: a GrammarSession is single-use (its matcher
        advances with the emitted stream)."""
        if not (args.json_schema or args.regex):
            return None
        from uzu_tpu_torch.grammar import GrammarSession

        if args.regex:
            return GrammarSession(session.tokenizer, regex=args.regex)
        schema = None
        if args.json_schema != "-":  # "-" = any JSON value
            with open(args.json_schema) as f:
                schema = json.load(f)
        kw = {}
        if args.json_indent is not None:
            kw = dict(any_whitespace=False, indent=args.json_indent)
        elif args.json_compact:
            kw = dict(any_whitespace=False, separators=(",", ":"))
        return GrammarSession(session.tokenizer, schema=schema, **kw)

    def read_line() -> str:
        """Rank 0 reads the line and sends it to the other ranks."""
        line = ""
        if leader:
            try:
                line = input("> ").strip()
            except EOFError:
                pass
        if lockstep is None:
            return line
        if leader:
            lockstep.send(line)
            return line
        return lockstep.recv()

    if leader:
        print("(interactive chat; empty line or Ctrl-D to exit)")
    while line := read_line():
        for ev in session.stream(line, sampling=sampling,
                                 max_new_tokens=args.max_tokens,
                                 grammar=make_grammar()):
            if ev.kind == "text" and leader:
                print(ev.delta, end="", flush=True)
        reply = session.last_reply
        session.messages.append({"role": "assistant", "content": reply.text})
        s = reply.stats
        if leader:
            print()
            print(f"  [{s.tokens_count_output} tok, {s.generate_tokens_per_second:.1f} tok/s]")
    return 0


def cmd_classify(args) -> int:
    from uzu_tpu_torch.models.classifier import ClassifierModel
    from uzu_tpu_torch.sessions import Tokenizer

    clf = ClassifierModel.from_dir(args.model_dir, device=args.device)
    tok = Tokenizer(args.model_dir)
    ids = tok.encode(" ".join(args.text))
    print(json.dumps(clf.classify(ids), indent=1))
    return 0


def cmd_synth(args) -> int:
    from uzu_tpu_torch.tools import synth as S

    builders = {
        "llama": S.llama_config,
        "qwen3": S.qwen3_config,
        "qwen35": S.qwen35_config,
        "lfm2": S.lfm2_config,
        "mamba2": S.mamba2_hybrid_config,
        "gemma": S.gemma_config,
        "moe": S.moe_config,
    }
    if args.kind == "chat":
        S.synth_chat_model(args.out_dir, seed=args.seed)
    elif args.kind in builders:
        S.synthesize(builders[args.kind](), args.out_dir, seed=args.seed)
    else:
        print(f"unknown kind {args.kind}; one of: chat, {', '.join(builders)}")
        return 1
    print(args.out_dir)
    return 0


def cmd_storage(args) -> int:
    """Model storage manager (reference: cli storage subcommand,
    cli/src/main.rs:19-38): list local models with sizes, delete one."""
    import shutil

    from uzu_tpu_torch.engine.facade import LocalRegistry

    reg = LocalRegistry(args.models_dir)
    if args.delete:
        target = os.path.join(args.models_dir, args.delete)
        if not os.path.isdir(target):
            print(f"no such model: {args.delete}", file=sys.stderr)
            return 1
        shutil.rmtree(target)
        print(f"deleted {args.delete}")
        return 0
    rows = [
        {"id": info.id, "kind": info.kind, "size_bytes": info.size_bytes,
         "path": info.path}
        for info in reg.models()
    ]
    print(json.dumps(rows, indent=1))
    return 0


def cmd_ppl(args) -> int:
    from uzu_tpu_torch import LanguageModel
    from uzu_tpu_torch.sessions import Tokenizer
    from uzu_tpu_torch.tools.quality import sequence_nll

    lm = LanguageModel.from_dir(args.model_dir, device=args.device,
                                max_context=args.max_context, kv_quant=args.kv_quant,
                                tp=args.tp, dp=args.dp)
    tok = Tokenizer(args.model_dir)
    with open(args.textfile) as f:
        ids = tok.encode(f.read())[: args.max_context]
    nll = sequence_nll(lm, ids)
    if _leader():
        print(json.dumps(nll))
    return 0


def cmd_autotune(args) -> int:
    """Measure K1's launch plans for a model's linear shapes on the card and
    save the table (the reference's fleet-tuned GEMV tables), or A/B a
    saved table against the heuristics on the decode loop. `--out` names the
    table's file (default: this card's under `ops/cuda/tile_tables/`, which
    K1 reads unless UZU_TPU_TILE_TABLE names another)."""
    from uzu_tpu_torch.config import load_language_model_config
    from uzu_tpu_torch.ops.cuda.autotune import autotune_shapes, model_linear_shapes, save_table

    if args.out:
        os.environ["UZU_TPU_TILE_TABLE"] = os.path.abspath(args.out)
    if args.validate_e2e:
        from uzu_tpu_torch.ops.cuda.autotune import validate_e2e

        print(json.dumps(validate_e2e(args.model_dir)))
        return 0
    cfg = load_language_model_config(os.path.join(args.model_dir, "config.json"))
    shapes = model_linear_shapes(cfg.decoder_config)
    print(f"shapes: {shapes}")
    table = autotune_shapes(shapes, reps=args.reps)
    path = save_table(table, args.out)
    print(f"saved {len(table)} entries to {path}; K1's plans read it from now on "
          f"(UZU_TPU_TILE_TABLE=/dev/null holds the heuristics alone)")
    return 0


def _device_kind(device) -> str:
    """The card's name; "cpu" for a run on the host."""
    if device.type == "cuda":
        import torch

        return torch.cuda.get_device_name(device)
    return device.type


def _version() -> str:
    import uzu_tpu_torch

    return uzu_tpu_torch.__version__


def _leader() -> bool:
    from uzu_tpu_torch.server.lockstep import is_leader

    return is_leader()


def _mesh_flags(sp) -> None:
    """Multi-device flags: split the model over a (dp, tp) mesh of ranks
    (`parallel/`; no flags = one device)."""
    sp.add_argument("--tp", type=int, default=None,
                    help="tensor-parallel ways (splits heads and hidden widths over ranks)")
    sp.add_argument("--dp", type=int, default=None,
                    help="data-parallel ways (model replicas; batch sizes must divide by dp)")


def _follower(rank: int, world: int, store: str, device: str, argv: list) -> None:
    """A spawned rank other than 0: join rank 0's group, run the command."""
    from uzu_tpu_torch.parallel.distributed import initialize

    sys.stdout = open(os.devnull, "w")
    if _device_type(device) == "cpu":
        import torch

        # the ranks share the host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    initialize(init_method=f"file://{store}", world_size=world, rank=rank,
               device_type=_device_type(device))
    main(argv)


def _device_type(device: str) -> str:
    import torch

    return torch.device(device).type


def _run_ranks(args, argv: list) -> int:
    """Run the command over tp·dp ranks: inside a launcher's group as it
    stands; otherwise spawn the followers and run as rank 0."""
    import multiprocessing
    import shutil
    import tempfile

    import torch.distributed as dist

    from uzu_tpu_torch.parallel.distributed import initialize
    from uzu_tpu_torch.runtime import resolve_device

    world = (args.tp or 1) * (args.dp or 1)
    if dist.is_initialized() or "RANK" in os.environ:
        return args.fn(args)
    resolve_device(args.device)  # no card raises here, before any rank starts
    tmp = tempfile.mkdtemp(prefix="uzu_ranks_")
    store = os.path.join(tmp, "store")
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_follower, args=(r, world, store, args.device, argv))
             for r in range(1, world)]
    for p in procs:
        p.start()
    try:
        initialize(init_method=f"file://{store}", world_size=world, rank=0,
                   device_type=_device_type(args.device))
        rc = args.fn(args)
        for p in procs:
            p.join()
        if any(p.exitcode for p in procs):
            raise RuntimeError(f"a follower rank failed: exit codes "
                               f"{[p.exitcode for p in procs]}")
        return rc
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
        if dist.is_initialized():
            dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)


def _device_flag(sp) -> None:
    sp.add_argument("--device", default="cuda",
                    help="torch device of the model: 'cuda' (default; raises without a "
                         "card) or 'cpu' (the plain PyTorch path)")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="uzu_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    b = sub.add_parser("bench")
    b.add_argument("model_dir"); b.add_argument("task"); b.add_argument("out")
    b.add_argument("--max-context", type=int, default=4096, dest="max_context")
    _mesh_flags(b)
    _device_flag(b)
    b.set_defaults(fn=cmd_bench)

    s = sub.add_parser("serve")
    s.add_argument("model_dir")
    s.add_argument("--host", default="127.0.0.1"); s.add_argument("--port", type=int, default=8000)
    s.add_argument("--max-context", type=int, default=4096, dest="max_context")
    s.add_argument("--batched", action="store_true",
                   help="continuous batching (concurrent requests share the chip)")
    s.add_argument("--batch-size", type=int, default=4, dest="batch_size")
    s.add_argument("--speculate", nargs="?", const="ngram", default=False,
                   choices=("ngram", "self", "fused-self", "fused-ngram"),
                   help="batched chain speculation: 'ngram' (per-slot host "
                        "drafts), 'self' (fused device-side layer-"
                        "truncated self-draft), 'fused-self' (self-draft "
                        "+ 8 rounds per dispatch), or 'fused-ngram' "
                        "(device prompt-lookup drafts + 8 rounds, zero "
                        "draft compute); requires --batched")
    _mesh_flags(s)
    _device_flag(s)
    s.set_defaults(fn=cmd_serve)

    c = sub.add_parser("chat")
    c.add_argument("model_dir")
    c.add_argument("--max-tokens", type=int, default=512, dest="max_tokens")
    c.add_argument("--temperature", type=float, default=None)
    c.add_argument("--max-context", type=int, default=4096, dest="max_context")
    c.add_argument("--json-schema", default=None, dest="json_schema",
                   help="constrain replies to a JSON schema file ('-' = any JSON)")
    c.add_argument("--json-indent", type=int, default=None, dest="json_indent",
                   help="force exact pretty-printed JSON at this indent")
    c.add_argument("--json-compact", action="store_true", dest="json_compact",
                   help="force exact compact JSON (no whitespace)")
    c.add_argument("--regex", default=None,
                   help="constrain replies to a regex pattern")
    c.add_argument("--speculate", default=None,
                   choices=("self", "fused-self", "fused-ngram"),
                   help="single-stream speculation: 'self' (per-round "
                        "layer-truncated self-draft), 'fused-self' "
                        "(multi-round fused dispatches), or 'fused-ngram' "
                        "(fused prompt-lookup, zero draft compute)")
    _mesh_flags(c)
    _device_flag(c)
    c.set_defaults(fn=cmd_chat)

    cl = sub.add_parser("classify")
    cl.add_argument("model_dir"); cl.add_argument("text", nargs="+")
    _device_flag(cl)
    cl.set_defaults(fn=cmd_classify)

    sy = sub.add_parser("synth")
    sy.add_argument("kind"); sy.add_argument("out_dir")
    sy.add_argument("--seed", type=int, default=0)
    sy.set_defaults(fn=cmd_synth)

    st = sub.add_parser("storage")
    st.add_argument("models_dir")
    st.add_argument("--delete", default=None)
    st.set_defaults(fn=cmd_storage)

    at = sub.add_parser("autotune")
    at.add_argument("model_dir")
    at.add_argument("--reps", type=int, default=32)
    at.add_argument("--validate-e2e", action="store_true", dest="validate_e2e",
                    help="A/B the measured table against the heuristics on the decode "
                         "loop (interleaved rounds)")
    at.add_argument("--out", default=None,
                    help="the table's file (default: this card's under ops/cuda/tile_tables/)")
    at.set_defaults(fn=cmd_autotune)

    pp = sub.add_parser("ppl")
    pp.add_argument("model_dir"); pp.add_argument("textfile")
    pp.add_argument("--max-context", type=int, default=2048, dest="max_context")
    pp.add_argument("--kv-quant", action="store_true", dest="kv_quant")
    _mesh_flags(pp)
    _device_flag(pp)
    pp.set_defaults(fn=cmd_ppl)

    argv = sys.argv[1:] if argv is None else list(argv)
    args = p.parse_args(argv)
    if (getattr(args, "tp", None) or 1) * (getattr(args, "dp", None) or 1) > 1:
        return _run_ranks(args, argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
