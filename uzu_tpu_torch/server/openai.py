"""OpenAI-compatible HTTP server (stdlib http.server, SSE streaming).

Role parity: crates/cli/src/server/{runner.rs,chat_completions.rs} — the
reference serves /v1/models + /v1/chat/completions from one ChatSession
behind a mutex (serialized single-session serving). Same design here;
continuous batching replaces it in the scheduler milestone.

The port's copy of `uzu_tpu/server/openai.py`. Over a model that spans
several ranks (`parallel/`), rank 0 serves: it sends each request's body
to the other ranks as it takes the session (`server/lockstep.py`), and
their `follow` loop runs the same request on their own session; a stream
whose client leaves runs to its end, so every rank runs the same forward
passes. There `serve` blocks until rank 0 shuts down and returns None. An
exception while a rank runs a request is fatal over several ranks
(`Lockstep.fatal_on_error`): rank 0 then refuses later requests.
"""

from __future__ import annotations

import contextlib
import json
import threading
import time
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from ..engine.sampling import SamplingParams
from ..sessions.chat import ChatSession
from .lockstep import lockstep_for


def _sampling_from_request(body: dict, default: SamplingParams) -> SamplingParams:
    from .common import sampling_from_request

    return sampling_from_request(body, default)


class ChatCompletionServer:
    def __init__(self, session: ChatSession, model_name: str = "uzu-tpu"):
        self.session = session
        self.model_name = model_name
        self.lock = threading.Lock()
        self._lockstep = lockstep_for(session.model)

    def _replay(self, body: dict):
        """Rank 0: send the request to the other ranks (session lock held);
        returns the context to run it in (fatal on an exception over
        several ranks)."""
        if self._lockstep is None:
            return contextlib.nullcontext()
        if self._lockstep.leader:
            self._lockstep.send(body)
        return self._lockstep.fatal_on_error()

    def follow(self) -> None:
        """A rank other than 0: run rank 0's requests until it shuts down."""
        with self._lockstep.fatal_on_error():
            while (body := self._lockstep.recv()) is not None:
                result = self.handle_chat(body)
                if not isinstance(result, dict):
                    for _ in result:
                        pass

    def stop_followers(self) -> None:
        if self._lockstep is not None and not self._lockstep.failed:
            with self.lock:
                self._lockstep.send(None)

    # -- request handling ---------------------------------------------------

    def handle_models(self) -> dict:
        return {
            "object": "list",
            "data": [
                {
                    "id": self.model_name,
                    "object": "model",
                    "created": int(time.time()),
                    "owned_by": "uzu-tpu",
                }
            ],
        }

    def handle_chat(self, body: dict):
        """Returns (response_dict) or a generator of SSE chunk dicts."""
        messages = body.get("messages", [])
        stream = bool(body.get("stream", False))
        default = SamplingParams.from_generation_config(
            self.session.model.config.generation_config
        )
        sampling = _sampling_from_request(body, default)
        from .common import (
            grammar_from_request,
            max_tokens_from_request,
            seed_from_request,
            stops_from_request,
            tools_from_request,
        )

        max_tokens = max_tokens_from_request(body)
        seed = seed_from_request(body)

        grammar = grammar_from_request(self.session.tokenizer, body)
        tools = tools_from_request(body)
        stops = stops_from_request(body) or None
        n_lp = 0
        if body.get("logprobs"):
            n_lp = max(1, int(body.get("top_logprobs") or 0))
            if stream:
                raise ValueError("logprobs with stream is not supported")
        rid = f"chatcmpl-{uuid.uuid4().hex[:24]}"
        created = int(time.time())

        if not stream:
            with self.lock, self._replay(body):
                # stateless API: reset and replay the full message list
                self.session.reset()
                reply = self.session.reply(
                    messages, sampling=sampling, max_new_tokens=max_tokens,
                    grammar=grammar, tools=tools, stop_strings=stops,
                    logprobs=n_lp, seed=seed,
                )
                msg: dict = {"role": "assistant", "content": reply.text}
                if reply.reasoning:
                    msg["reasoning_content"] = reply.reasoning
                if reply.tool_calls and reply.finish_reason == "tool_calls":
                    msg["tool_calls"] = [
                        tc.as_openai(f"call_{i}") for i, tc in enumerate(reply.tool_calls)
                    ]
                    msg["content"] = reply.text or None
                choice = {"index": 0, "message": msg,
                          "finish_reason": reply.finish_reason}
                if n_lp:
                    from .common import logprob_entries

                    choice["logprobs"] = {"content": logprob_entries(
                        self.session.tokenizer, reply.tokens,
                        reply.logprob_content,
                        int(body.get("top_logprobs") or 0))}
                return {
                    "id": rid,
                    "object": "chat.completion",
                    "created": created,
                    "model": self.model_name,
                    "choices": [choice],
                    "usage": {
                        "prompt_tokens": reply.stats.tokens_count_input,
                        "completion_tokens": reply.stats.tokens_count_output,
                        "total_tokens": reply.stats.tokens_count_input
                        + reply.stats.tokens_count_output,
                    },
                }

        def chunks():
            base = {
                "id": rid,
                "object": "chat.completion.chunk",
                "created": created,
                "model": self.model_name,
            }
            yield {**base, "choices": [{"index": 0, "delta": {"role": "assistant"}}]}
            n_tool = 0
            # the session is exclusive for the WHOLE stream: the generator
            # body (not handle_chat) must hold the lock, or two concurrent
            # streaming requests would interleave one session's state. A
            # closed generator (client disconnect) exits here and releases
            # it; the in-flight decode stops with the inner generator.
            with self.lock, self._replay(body):
                self.session.reset()
                for ev in self.session.stream(
                    messages, sampling=sampling, max_new_tokens=max_tokens,
                    grammar=grammar, tools=tools, stop_strings=stops,
                    seed=seed,
                ):
                    if ev.kind == "text":
                        delta = {"content": ev.delta}
                    elif ev.kind == "reasoning":
                        delta = {"reasoning_content": ev.delta}
                    else:
                        tc = ev.tool_call
                        delta = {
                            "tool_calls": [
                                {
                                    "index": n_tool,
                                    "id": f"call_{n_tool}",
                                    "type": "function",
                                    "function": {
                                        "name": tc["name"],
                                        "arguments": json.dumps(tc["arguments"]),
                                    },
                                }
                            ]
                        }
                        n_tool += 1
                    yield {**base, "choices": [{"index": 0, "delta": delta}]}
                reply = self.session.last_reply
            yield {
                **base,
                "choices": [
                    {"index": 0, "delta": {}, "finish_reason": reply.finish_reason}
                ],
            }
            if (body.get("stream_options") or {}).get("include_usage"):
                s = reply.stats
                yield {**base, "choices": [], "usage": {
                    "prompt_tokens": s.tokens_count_input,
                    "completion_tokens": s.tokens_count_output,
                    "total_tokens": s.tokens_count_input + s.tokens_count_output,
                }}

        return chunks()


def make_handler(server: ChatCompletionServer):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _json(self, code: int, payload: dict):
            data = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def do_GET(self):
            if self.path in ("/v1/models", "/models"):
                self._json(200, server.handle_models())
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
                self._json(400, {"error": {"message": str(e), "type": type(e).__name__}})
                return
            except Exception as e:
                self._json(500, {"error": {"message": str(e), "type": type(e).__name__}})
                return
            if isinstance(result, dict):
                self._json(200, result)
                return
            self.send_response(200)
            self.send_header("Content-Type", "text/event-stream")
            self.send_header("Cache-Control", "no-cache")
            self.end_headers()
            try:
                for chunk in result:
                    self.wfile.write(b"data: " + json.dumps(chunk).encode() + b"\n\n")
                    self.wfile.flush()
                self.wfile.write(b"data: [DONE]\n\n")
            except (BrokenPipeError, ConnectionResetError):
                if server._lockstep is not None:
                    for _ in result:  # the other ranks run the request to its end
                        pass
                result.close()  # stops the in-flight generation + frees the session

    return Handler


def serve(session: ChatSession, host: str = "127.0.0.1", port: int = 8000,
          model_name: str = "uzu-tpu") -> ThreadingHTTPServer:
    """Start the server (non-blocking); returns the HTTPServer instance. On
    a rank other than 0 of a distributed model, follow rank 0's requests
    until it stops them (`httpd.chat_server.stop_followers()`), then
    return None."""
    server = ChatCompletionServer(session, model_name)
    if server._lockstep is not None and not server._lockstep.leader:
        server.follow()
        return None
    httpd = ThreadingHTTPServer((host, port), make_handler(server))
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    httpd.chat_server = server
    return httpd
