"""Continuous-batching OpenAI server: concurrent requests share the chip.

No reference counterpart — uzu's server serializes one ChatSession behind a
mutex (cli/src/server/runner.rs); here concurrent /v1/chat/completions
requests are admitted into BatchEngine slots and decode together. A single
scheduler thread drives the engine; HTTP threads submit and wait on
per-request events (streaming responses poll the request's token list).

The port's counterpart of `uzu_tpu/server/batched.py`, with its engine
choice and its scheduler as they stand there. A scheduler exception still
cancels the in-flight requests with finish_reason "error" and scheduling
goes on; its traceback is kept in `BatchedChatServer.errors`, so a caller
can fail loudly on it.

Over a model that spans several ranks (`parallel/`), rank 0 serves and
journals every submit and cancel; before each engine step it sends the
journal to the other ranks, whose `follow` loop replays it and steps the
same engine in lockstep (`server/lockstep.py`); an idle rank 0 sends
nothing. There `serve_batched` blocks until rank 0 shuts down and returns
None. Over several ranks an engine exception is fatal
(`Lockstep.fatal_on_error`): rank 0 fails every request with
finish_reason "error", refuses later ones and tells the other ranks to
stop; another rank raises out of `follow`. Grammar requests are served by
a model on one rank only (a matcher does not travel).
"""

from __future__ import annotations

import json
import threading
import time
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from ..engine.batch import BatchEngine
from ..engine.sampling import SamplingParams
from ..sessions.parser import StreamParser
from ..sessions.template import ChatTemplate
from ..sessions.tokenizer import StreamDecoder, Tokenizer
from .lockstep import lockstep_for


class BatchedChatServer:
    def __init__(
        self,
        lm,
        tokenizer: Tokenizer,
        *,
        model_name: str = "uzu-tpu",
        batch_size: int = 4,
        decode_chunk: int = 8,
        sampling: SamplingParams | None = None,
        paged: bool | str = "auto",
        speculate: bool | str = False,
        **engine_kw,
    ):
        """paged: "auto" uses the paged engine from batch_size >= 8 when the
        model supports it (per-token KV memory beats B x max_context slot
        caches at that width, and prefix-shared admissions skip prefill);
        True forces it, False keeps the slot-cache dense engine.
        speculate: True/"ngram" = per-slot host ngram drafts + one fused
        batched verify per round; "self" = fused device-side self-draft
        (layer-truncated, half the stack) — zero host drafting, realistic
        acceptance on non-repetitive text; "fused-self" = "self" plus
        spec_rounds=8 multi-round scans per dispatch (engine/batch_spec.py
        — one fetch per 8 rounds, dense or paged; grammar/logprob
        dispatches fall back per-round); "fused-ngram" = fused rounds
        with the device n-gram matcher drafting in-scan (zero draft
        compute). Overrides paged."""
        self.lm = lm
        self.tokenizer = tokenizer
        self.template = ChatTemplate(tokenizer.chat_template)
        self.model_name = model_name
        stop_ids = list(lm.config.generation_config.stop_token_ids)
        for i in tokenizer.eos_token_ids:
            if i not in stop_ids:
                stop_ids.append(i)
        engine_cls = BatchEngine
        if paged == "auto":
            from ..models.paged_decode import paged_supported

            explicit_page = engine_kw.get("page_size")
            paged = (batch_size >= 8 and paged_supported(lm.decoder_config)
                     and not lm.ring_windows
                     and (explicit_page is None  # engine picks a divisor
                          or lm.max_context % explicit_page == 0))
        if paged:
            from ..engine.paged_batch import PagedBatchEngine

            engine_cls = PagedBatchEngine
        if speculate:
            from ..engine.batch_spec import (
                SpeculativeBatchEngine,
                SpeculativePagedBatchEngine,
            )

            engine_cls = (SpeculativePagedBatchEngine if paged
                          else SpeculativeBatchEngine)
            if speculate in ("self", "fused-self"):
                n = len(lm.decoder_config.transformer_config.layer_configs)
                if n >= 2:  # a 1-layer model has nothing to truncate;
                    # fall back to ngram drafts rather than rejecting
                    engine_kw.setdefault("draft_layers", n // 2)
                    if speculate == "fused-self":
                        engine_kw.setdefault("spec_rounds", 8)
            elif speculate == "fused-ngram":
                engine_kw.setdefault("device_ngram", True)
                engine_kw.setdefault("spec_rounds", 8)
        self.engine = engine_cls(
            lm,
            batch_size=batch_size,
            decode_chunk=decode_chunk,
            sampling=sampling or SamplingParams(),
            stop_token_ids=stop_ids,
            **engine_kw,
        )
        self._lock = threading.Lock()
        self._wake = threading.Event()
        self._events: dict[int, threading.Event] = {}
        self._requests: dict[int, object] = {}
        # requests with OpenAI `stop` sequences: [req, decoder, monitor,
        # scanned-token-count] — scanned by the scheduler to CANCEL
        # generation early; the response paths do their own independent
        # clipping, so correctness never depends on this scan's timing
        self._stop_watch: dict[int, list] = {}
        self._shutdown = False
        #: formatted tracebacks of the scheduler's engine exceptions
        self.errors: list[str] = []
        # several ranks: rank 0's submits and cancels since the last step
        self._lockstep = lockstep_for(lm)
        self._journal: list = []
        self._busy = False  # the last step's answer: the engine has work
        if self._lockstep is None or self._lockstep.leader:
            self._thread = threading.Thread(target=self._scheduler, daemon=True)
            self._thread.start()

    # -- lockstep over ranks ------------------------------------------------

    def _cancel(self, req, reason: str) -> None:
        """engine.cancel, journaled for the other ranks (lock held)."""
        if self.engine.cancel(req, reason) and self._lockstep is not None:
            self._journal.append(("cancel", req.id, reason))

    def _step(self) -> bool:
        """One engine step; first the journal to the other ranks (lock
        held). With nothing to replay and nothing to run, no step and no
        message."""
        if self._lockstep is not None:
            if not self._journal and not self._busy:
                return False
            self._lockstep.send(self._journal + [("step",)])
            self._journal = []
        self._busy = self.engine.step()
        return self._busy

    def follow(self) -> None:
        """A rank other than 0: replay rank 0's journal and step in
        lockstep until it shuts down. Any exception, here or on rank 0
        (which aborts the groups), ends it and propagates."""
        reqs = {}
        with self._lockstep.fatal_on_error():
            while True:
                for msg in self._lockstep.recv():
                    if msg[0] == "submit":
                        req = self.engine.submit(*msg[1], **msg[2])
                        reqs[req.id] = req
                    elif msg[0] == "cancel":
                        self.engine.cancel(reqs[msg[1]], msg[2])
                    elif msg[0] == "step":
                        self.engine.step()
                    else:  # shutdown
                        return
                for rid in [rid for rid, r in reqs.items() if r.finished]:
                    del reqs[rid]

    # -- scheduling ---------------------------------------------------------

    def _scan_stop_watch(self):
        for rid, entry in list(self._stop_watch.items()):
            req, decoder, mon, scanned = entry
            if req.finished:
                del self._stop_watch[rid]
                continue
            tokens = list(req.tokens)
            hit = False
            for t in tokens[scanned:]:
                delta = decoder.push(t)
                if delta and mon.push(delta)[1]:
                    hit = True
                    break
            # never rewind: preemption replays the identical stream, and
            # re-feeding already-scanned text would let a stop sequence
            # spanning the duplication seam falsely match
            entry[3] = max(scanned, len(tokens))
            if hit:
                self._cancel(req, "stop")
                del self._stop_watch[rid]

    def _scheduler(self):
        while not self._shutdown:
            busy = False
            try:
                with self._lock:
                    busy = self._step()
                    self._scan_stop_watch()
                    for rid, ev in list(self._events.items()):
                        req = self._requests.get(rid)
                        if req is not None and req.finished:
                            ev.set()
                            del self._events[rid]
                            del self._requests[rid]
            except Exception:
                # an engine exception must not wedge the server: an exited
                # scheduler thread leaves every done.wait() and stream poll
                # hanging forever. Fail the in-flight requests loudly and
                # keep scheduling (fresh requests get fresh state). Over
                # several ranks it is fatal: the ranks may no longer pair
                # their collectives, so the lockstep ends and so does
                # scheduling.
                import traceback

                self.errors.append(traceback.format_exc())
                traceback.print_exc()
                with self._lock:
                    if self._lockstep is not None:
                        self._lockstep.fail()
                    admitting = self.engine._admitting
                    for req in (list(self.engine.queue)
                                + [s.request for s in self.engine.slots
                                   if not s.free]
                                + ([admitting[0]] if admitting else [])):
                        try:
                            self.engine.cancel(req, "error")
                        except Exception:
                            req.finished = True
                            req.finish_reason = "error"
                    for rid, ev in list(self._events.items()):
                        ev.set()
                        self._events.pop(rid, None)
                        self._requests.pop(rid, None)
                if self.failed:
                    return
            if not busy:
                self._wake.wait(timeout=0.05)
                self._wake.clear()

    def submit(self, prompt_ids, max_tokens: int, seed: int = 0, grammar=None,
               sampling=None, logprobs: int = 0, presence_penalty: float = 0.0,
               frequency_penalty: float = 0.0):
        if grammar is not None and self._lockstep is not None:
            raise ValueError("grammar requests need a model on one rank (a grammar "
                             "matcher does not travel to the other ranks)")
        kw = dict(seed=seed, grammar=grammar, sampling=sampling, logprobs=logprobs,
                  presence_penalty=presence_penalty, frequency_penalty=frequency_penalty)
        with self._lock:
            if self.failed:
                raise RuntimeError("the engine of this distributed model failed (see the "
                                   "server's errors); restart the server")
            req = self.engine.submit(prompt_ids, max_tokens, **kw)
            if self._lockstep is not None:
                self._journal.append(("submit", (list(prompt_ids), max_tokens), kw))
            ev = threading.Event()
            self._events[req.id] = ev
            self._requests[req.id] = req
        self._wake.set()
        return req, ev

    def _grammar_for(self, body: dict):
        """OpenAI ``response_format`` -> GrammarSession. The engine must be
        speculative (its rounds carry the per-row masks); submit raises a
        ValueError -> HTTP 400 otherwise."""
        from .common import grammar_from_request

        return grammar_from_request(self.tokenizer, body)

    @property
    def failed(self) -> bool:
        """An engine exception has ended the lockstep over several ranks."""
        return self._lockstep is not None and self._lockstep.failed

    def shutdown(self):
        self._shutdown = True
        self._wake.set()
        if self._lockstep is not None:
            self._thread.join()
            if not self.failed:
                self._lockstep.send([("shutdown",)])

    # -- request handling ----------------------------------------------------

    def handle_chat(self, body: dict):
        messages = body.get("messages", [])
        stream = bool(body.get("stream", False))
        from .common import (
            max_tokens_from_request,
            sampling_from_request,
            seed_from_request,
            stops_from_request,
            tools_from_request,
        )

        max_tokens = max_tokens_from_request(body)

        tools = tools_from_request(body)
        stops = stops_from_request(body)
        n_lp = 0
        if body.get("logprobs"):
            n_lp = max(1, int(body.get("top_logprobs") or 0))
        n_choices = int(body.get("n") or 1)
        if not 1 <= n_choices <= 8:
            raise ValueError("n must be in [1, 8]")
        if n_choices > 1 and stream:
            raise ValueError("n > 1 with stream is not supported")
        text = self.template.render(messages, tools=tools)
        ids = self.tokenizer.encode(text)
        # per-request sampling fields route the engine onto its
        # dynamic-sampling executables; requests at the server defaults
        # stay on the static path
        sampling = sampling_from_request(body, self.engine.sampling)
        seed0 = seed_from_request(body)
        pres = float(body.get("presence_penalty") or 0.0)
        freq = float(body.get("frequency_penalty") or 0.0)
        # n > 1: one engine request per choice, decoding CONCURRENTLY in
        # separate slots with derived seeds (they admit via prefix sharing,
        # so the shared prompt prefills once); choice 0 is `req` below
        siblings = []
        for i in range(1, n_choices):
            sib, sib_done = self.submit(
                ids, max_tokens, seed=seed0 + i,
                grammar=self._grammar_for(body), sampling=sampling,
                logprobs=n_lp, presence_penalty=pres, frequency_penalty=freq)
            siblings.append((sib, sib_done))
        req, done = self.submit(ids, max_tokens, seed=seed0,
                                grammar=self._grammar_for(body),
                                sampling=sampling, logprobs=n_lp,
                                presence_penalty=pres, frequency_penalty=freq)
        if stops:
            from ..sessions.parser import StopStrings

            with self._lock:
                for r, _ in [(req, done)] + siblings:
                    self._stop_watch[r.id] = [
                        r, StreamDecoder(self.tokenizer), StopStrings(stops), 0]
        rid = f"chatcmpl-{uuid.uuid4().hex[:24]}"
        created = int(time.time())
        base = {"id": rid, "object": "chat.completion.chunk", "created": created,
                "model": self.model_name}

        def build_choice(r, index):
            """(choice dict, clipped completion-token count) for a finished
            request. The stop-sequence clip runs independently over the
            full decoded text: exact char-level truncation regardless of
            how far generation ran before the scheduler's early-cancel
            scan caught up; logprobs.content and usage align with the
            clipped message.content."""
            decoder = StreamDecoder(self.tokenizer)
            parser = StreamParser()
            mon = None
            if stops:
                from ..sessions.parser import StopStrings

                mon = StopStrings(stops)
            stopped = False
            used = 0
            for t in r.tokens:
                delta = decoder.push(t)
                used += 1
                if not delta:
                    continue
                if mon is not None:
                    delta, stopped = mon.push(delta)
                for _ in parser.push(delta):
                    pass
                if stopped:
                    break
            if mon is not None and not stopped:
                tail = mon.finish()
                if tail:
                    for _ in parser.push(tail):
                        pass
            for _ in parser.finish():
                pass
            msg = {"role": "assistant", "content": parser.text}
            if parser.reasoning:
                msg["reasoning_content"] = parser.reasoning
            finish = "stop" if stopped else (r.finish_reason or "stop")
            if parser.tool_calls:
                msg["tool_calls"] = [
                    tc.as_openai(f"call_{i}")
                    for i, tc in enumerate(parser.tool_calls)
                ]
                msg["content"] = parser.text or None
                finish = "tool_calls"
            choice = {"index": index, "message": msg, "finish_reason": finish}
            if r.logprobs:
                from .common import logprob_entries

                choice["logprobs"] = {"content": logprob_entries(
                    self.tokenizer, r.tokens[:used],
                    r.logprob_content[:used],
                    int(body.get("top_logprobs") or 0))}
            return choice, used

        if not stream:
            done.wait()
            for _, sib_done in siblings:
                sib_done.wait()
            choices, total_used = [], 0
            for index, r in enumerate([req] + [s for s, _ in siblings]):
                choice, used = build_choice(r, index)
                choices.append(choice)
                total_used += used
            return {
                "id": rid,
                "object": "chat.completion",
                "created": created,
                "model": self.model_name,
                "choices": choices,
                "usage": {
                    "prompt_tokens": len(ids),
                    "completion_tokens": total_used,
                    "total_tokens": len(ids) + total_used,
                },
            }

        def chunks():
            try:
                yield from chunk_body()
            finally:
                # a closed generator (client disconnected mid-stream) stops
                # wasting decode on the abandoned request
                if not req.finished:
                    with self._lock:
                        self._cancel(req, "cancelled")

        def chunk_body():
            yield {**base, "choices": [{"index": 0, "delta": {"role": "assistant"}}]}
            decoder = StreamDecoder(self.tokenizer)
            parser = StreamParser()
            mon = None
            if stops:
                from ..sessions.parser import StopStrings

                mon = StopStrings(stops)
            stopped = False
            n_tool = 0

            def as_delta(ev):
                nonlocal n_tool
                if ev.kind == "text":
                    return {"content": ev.delta}
                if ev.kind == "reasoning":
                    return {"reasoning_content": ev.delta}
                tc = ev.tool_call
                d = {"tool_calls": [{
                    "index": n_tool, "id": f"call_{n_tool}", "type": "function",
                    "function": {"name": tc["name"],
                                 "arguments": json.dumps(tc["arguments"])},
                }]}
                n_tool += 1
                return d

            top_n = int(body.get("top_logprobs") or 0)

            def lp_payload(idx):
                """This token's logprobs entry for the chunk carrying its
                text (raw-token order; entries are appended by the router
                in lockstep with tokens)."""
                from .common import logprob_entries

                return {"content": logprob_entries(
                    self.tokenizer, [req.tokens[idx]],
                    [req.logprob_content[idx]], top_n)}

            sent = 0
            while not stopped:
                tokens = list(req.tokens)
                avail = len(tokens)
                if n_lp:
                    # entries land right after their token; consume only
                    # tokens whose entry is visible
                    avail = min(avail, len(req.logprob_content))
                for idx in range(sent, avail):
                    t = tokens[idx]
                    delta = decoder.push(t)
                    emitted_for_tok = False
                    if delta:
                        if mon is not None:
                            delta, stopped = mon.push(delta)
                        if delta:
                            for ev in parser.push(delta):
                                chunk = {"index": 0, "delta": as_delta(ev)}
                                if n_lp and not emitted_for_tok:
                                    chunk["logprobs"] = lp_payload(idx)
                                    emitted_for_tok = True
                                yield {**base, "choices": [chunk]}
                    if n_lp and not emitted_for_tok and not stopped:
                        # no text surfaced for this token (partial UTF-8 or
                        # swallowed markup): its entry rides a bare chunk
                        yield {**base, "choices": [{"index": 0, "delta": {},
                                                    "logprobs": lp_payload(idx)}]}
                    if stopped:
                        sent = idx + 1
                        break
                    sent = idx + 1
                else:
                    # never rewind: paged recompute preemption resets
                    # req.tokens and replays the IDENTICAL stream, so tokens
                    # below `sent` were already delivered — re-pushing them
                    # would duplicate client output and desync the decoders
                    sent = max(sent, avail)
                if req.finished and sent >= len(req.tokens):
                    break
                if stopped:
                    break
                time.sleep(0.02)
            if mon is not None and not stopped:
                tail = mon.finish()
                if tail:
                    for ev in parser.push(tail):
                        yield {**base, "choices": [{"index": 0,
                                                    "delta": as_delta(ev)}]}
            for ev in parser.finish():
                yield {**base, "choices": [{"index": 0, "delta": as_delta(ev)}]}
            finish = "stop" if stopped else (req.finish_reason or "stop")
            if parser.tool_calls:
                finish = "tool_calls"
            yield {**base, "choices": [{"index": 0, "delta": {},
                                        "finish_reason": finish}]}
            if (body.get("stream_options") or {}).get("include_usage"):
                # `sent` counts the CLIPPED tokens actually delivered, like
                # the non-stream path's `used` (req.tokens may have overrun
                # a stop sequence before the scheduler's cancel caught up)
                yield {**base, "choices": [], "usage": {
                    "prompt_tokens": len(ids),
                    "completion_tokens": sent,
                    "total_tokens": len(ids) + sent,
                }}

        return chunks()

    def handle_models(self):
        return {"object": "list", "data": [{"id": self.model_name, "object": "model",
                                            "created": int(time.time()),
                                            "owned_by": "uzu-tpu"}]}

    def handle_stats(self):
        """Operational snapshot (GET /v1/stats): scheduler occupancy, queue
        depth, paged-pool pressure, speculation acceptance, and the
        engine's work counters (admissions, preemptions and the tokens they
        recompute, prefix-cache evictions, ...) — what an operator watches
        to size batch_size/num_pages."""
        with self._lock:
            eng = self.engine
            out = {
                "engine": type(eng).__name__,
                "batch_size": eng.batch_size,
                "active_slots": eng.num_active,
                "queued": len(eng.queue),
                "admitting": eng._admitting is not None,
                "counters": dict(eng.stats),
            }
            pool = getattr(eng, "pool", None)
            if pool is not None:
                out["pages"] = {"total": pool.num_pages,
                                "free": pool.free_pages,
                                "retired_prefixes": len(
                                    getattr(eng, "_retired", ()))}
            metrics = getattr(eng, "metrics", None)
            if metrics is not None and metrics.num_verify_passes:
                out["speculation"] = {
                    "verify_passes": metrics.num_verify_passes,
                    "tokens_proposed": metrics.num_tokens_proposed,
                    "tokens_accepted": metrics.num_tokens_accepted,
                    "acceptance": round(
                        metrics.num_tokens_accepted
                        / max(1, metrics.num_tokens_proposed), 4),
                }
        return out


def make_handler(server: BatchedChatServer):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def _json(self, code, payload):
            data = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def do_GET(self):
            if self.path in ("/v1/models", "/models"):
                self._json(200, server.handle_models())
            elif self.path in ("/v1/stats", "/stats"):
                self._json(200, server.handle_stats())
            elif self.path == "/health":
                self._json(200, {"status": "ok"})
            else:
                self._json(404, {"error": "not found"})

        def do_POST(self):
            if self.path not in ("/v1/chat/completions", "/chat/completions"):
                self._json(404, {"error": "not found"})
                return
            length = int(self.headers.get("Content-Length", 0))
            try:
                body = json.loads(self.rfile.read(length) or b"{}")
            except json.JSONDecodeError:
                self._json(400, {"error": "invalid JSON"})
                return
            try:
                result = server.handle_chat(body)
            except ValueError as e:
                self._json(400, {"error": {"message": str(e)}})
                return
            except Exception as e:
                self._json(500, {"error": {"message": str(e)}})
                return
            if isinstance(result, dict):
                self._json(200, result)
                return
            self.send_response(200)
            self.send_header("Content-Type", "text/event-stream")
            self.end_headers()
            try:
                for chunk in result:
                    self.wfile.write(b"data: " + json.dumps(chunk).encode() + b"\n\n")
                    self.wfile.flush()
                self.wfile.write(b"data: [DONE]\n\n")
            except (BrokenPipeError, ConnectionResetError):
                result.close()  # cancels the abandoned request

    return Handler


def serve_batched(lm, tokenizer, host="127.0.0.1", port=8000, **kw):
    """Start the server (non-blocking) and return the HTTPServer; on a rank
    other than 0 of a distributed model, follow rank 0's engine until it
    shuts down, then return None."""
    server = BatchedChatServer(lm, tokenizer, **kw)
    if server._lockstep is not None and not server._lockstep.leader:
        server.follow()
        return None
    httpd = ThreadingHTTPServer((host, port), make_handler(server))
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    httpd.batch_server = server
    return httpd
