"""Remote OpenAI-compatible chat backend.

Role parity with crates/backend-remote (src/openai/mod.rs:22-30): the same
ChatReply-shaped interface as the local ChatSession, but served by any
OpenAI-compatible /v1/chat/completions endpoint (cloud models, or another
uzu_tpu server). Streaming chunks are assembled incrementally, including
tool-call deltas arriving split across chunks (stream_state.rs:30-55,
tool_call_state.rs). Pure stdlib HTTP (urllib) — no extra dependencies.

The port's copy of `uzu_tpu/engine/remote.py` (standard library only).
"""

from __future__ import annotations

import dataclasses
import json
import urllib.request
from typing import Iterator, Optional

from ..sessions.chat import ChatReply, ChatReplyStats
from ..sessions.parser import ToolCall


@dataclasses.dataclass
class RemoteConfig:
    api_endpoint: str  # e.g. "http://host:8000/v1"
    model: str = ""
    api_key: Optional[str] = None
    headers: Optional[dict] = None
    timeout: float = 120.0


@dataclasses.dataclass
class StreamDelta:
    """One streamed content delta (text or completed tool call)."""

    text: str = ""
    reasoning: str = ""
    tool_call: Optional[ToolCall] = None
    finish_reason: str = ""


class _ToolCallAssembler:
    """Accumulates OpenAI streaming tool_call deltas (indexed fragments of
    id/name/arguments) into complete ToolCalls — the reference's
    ToolCallState reducer."""

    def __init__(self):
        self.partial: dict[int, dict] = {}

    def push(self, deltas: list[dict]) -> None:
        for d in deltas:
            idx = d.get("index", 0)
            slot = self.partial.setdefault(idx, {"name": "", "arguments": ""})
            fn = d.get("function", {})
            if fn.get("name"):
                slot["name"] += fn["name"]
            if fn.get("arguments"):
                slot["arguments"] += fn["arguments"]

    def finish(self) -> list[ToolCall]:
        out = []
        for idx in sorted(self.partial):
            slot = self.partial[idx]
            try:
                args = json.loads(slot["arguments"]) if slot["arguments"] else {}
            except json.JSONDecodeError:
                args = {}
            out.append(ToolCall(name=slot["name"], arguments=args, raw=slot["arguments"]))
        self.partial = {}
        return out


class RemoteChatSession:
    def __init__(self, config: RemoteConfig):
        self.config = config

    # -- HTTP ---------------------------------------------------------------

    def _request(self, body: dict, stream: bool):
        url = self.config.api_endpoint.rstrip("/") + "/chat/completions"
        headers = {"Content-Type": "application/json"}
        if self.config.api_key:
            headers["Authorization"] = f"Bearer {self.config.api_key}"
        if self.config.headers:
            headers.update(self.config.headers)
        req = urllib.request.Request(
            url, data=json.dumps(body).encode(), headers=headers
        )
        return urllib.request.urlopen(req, timeout=self.config.timeout)

    def _body(self, messages, *, tools=None, stream=False, **kw) -> dict:
        body = {"model": self.config.model, "messages": list(messages), "stream": stream}
        if tools:
            body["tools"] = tools
        for k in ("max_tokens", "temperature", "top_p", "seed", "stop"):
            if k in kw and kw[k] is not None:
                body[k] = kw[k]
        return body

    # -- API ----------------------------------------------------------------

    def reply(self, messages, *, tools=None, **kw) -> ChatReply:
        with self._request(self._body(messages, tools=tools, stream=False, **kw), False) as r:
            data = json.load(r)
        choice = data["choices"][0]
        msg = choice.get("message", {})
        tool_calls = []
        for tc in msg.get("tool_calls") or []:
            fn = tc.get("function", {})
            try:
                args = json.loads(fn.get("arguments") or "{}")
            except json.JSONDecodeError:
                args = {}
            tool_calls.append(
                ToolCall(name=fn.get("name", ""), arguments=args, raw=fn.get("arguments", ""))
            )
        usage = data.get("usage", {})
        stats = ChatReplyStats(
            tokens_count_input=usage.get("prompt_tokens", 0),
            tokens_count_output=usage.get("completion_tokens", 0),
        )
        return ChatReply(
            text=msg.get("content") or "",
            reasoning=msg.get("reasoning_content") or "",
            tool_calls=tool_calls,
            finish_reason=choice.get("finish_reason") or "stop",
            stats=stats,
        )

    def stream(self, messages, *, tools=None, **kw) -> Iterator[StreamDelta]:
        assembler = _ToolCallAssembler()
        with self._request(self._body(messages, tools=tools, stream=True, **kw), True) as r:
            for raw_line in r:
                line = raw_line.decode().strip()
                if not line.startswith("data: "):
                    continue
                payload = line[len("data: "):]
                if payload == "[DONE]":
                    break
                try:
                    chunk = json.loads(payload)
                except json.JSONDecodeError:
                    continue
                for choice in chunk.get("choices", []):
                    delta = choice.get("delta", {})
                    if delta.get("tool_calls"):
                        assembler.push(delta["tool_calls"])
                    if delta.get("content"):
                        yield StreamDelta(text=delta["content"])
                    if delta.get("reasoning_content"):
                        yield StreamDelta(reasoning=delta["reasoning_content"])
                    if choice.get("finish_reason"):
                        for tc in assembler.finish():
                            yield StreamDelta(tool_call=tc)
                        yield StreamDelta(finish_reason=choice["finish_reason"])
