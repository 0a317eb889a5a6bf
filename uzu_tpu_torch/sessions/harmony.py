"""Harmony encoding (gpt-oss): renderer + incremental stream parser.

Reference: crates/hanashi/src/chat/harmony/ (wraps the openai_harmony crate;
token literals at mod.rs:26-35). This is a from-scratch implementation of
the public Harmony chat format:

    <|start|>ROLE[<|channel|>CHANNEL][ to=RECIPIENT][ <|constrain|>json]
        <|message|>CONTENT(<|end|>|<|call|>|<|return|>)

Channels: analysis (reasoning), commentary (tool calls, to=functions.NAME),
final (user-visible text). Generation prompt ends with `<|start|>assistant`.

The port's copy of `uzu_tpu/sessions/harmony.py` (standard library only).
"""

from __future__ import annotations

import dataclasses
import json
from typing import Iterator, Optional

from .parser import Event, ToolCall
from .template import validate_messages

START = "<|start|>"
END = "<|end|>"
MESSAGE = "<|message|>"
CHANNEL = "<|channel|>"
CONSTRAIN = "<|constrain|>"
CALL = "<|call|>"
RETURN = "<|return|>"

HARMONY_SPECIAL_TOKENS = [START, END, MESSAGE, CHANNEL, CONSTRAIN, CALL, RETURN]
HARMONY_STOP_TOKENS = [RETURN, CALL]


class HarmonyEncoding:
    """Renders conversations into Harmony text (hanashi's Harmony role);
    plug-compatible with sessions.ChatTemplate."""

    def render(
        self,
        messages: list[dict],
        *,
        tools: list[dict] | None = None,
        add_generation_prompt: bool = True,
        **_,
    ) -> str:
        validate_messages(messages)
        out = []
        sys_msgs = [m for m in messages if m["role"] == "system"]
        sys_text = sys_msgs[0]["content"] if sys_msgs else "You are a helpful assistant."
        out.append(f"{START}system{MESSAGE}{sys_text}{END}")
        if tools:
            lines = ["# Tools", "", "## functions", ""]
            for t in tools:
                fn = t.get("function", t)
                lines.append(
                    f"namespace functions {{ // {fn.get('description', '')}\n"
                    f"type {fn['name']} = (_: {json.dumps(fn.get('parameters', {}))}) => any;\n}}"
                )
            out.append(f"{START}developer{MESSAGE}" + "\n".join(lines) + END)
        for m in messages:
            role = m["role"]
            if role == "system":
                continue
            if role == "user":
                out.append(f"{START}user{MESSAGE}{m['content']}{END}")
            elif role == "assistant":
                if m.get("tool_calls"):
                    for tc in m["tool_calls"]:
                        fn = tc["function"]
                        out.append(
                            f"{START}assistant{CHANNEL}commentary to=functions.{fn['name']}"
                            f" {CONSTRAIN}json{MESSAGE}{fn['arguments']}{CALL}"
                        )
                else:
                    if m.get("reasoning_content"):
                        out.append(
                            f"{START}assistant{CHANNEL}analysis{MESSAGE}"
                            f"{m['reasoning_content']}{END}"
                        )
                    out.append(
                        f"{START}assistant{CHANNEL}final{MESSAGE}{m.get('content') or ''}{END}"
                    )
            elif role == "tool":
                name = m.get("name", "tool")
                out.append(
                    f"{START}functions.{name} to=assistant{CHANNEL}commentary"
                    f"{MESSAGE}{m['content']}{END}"
                )
        if add_generation_prompt:
            out.append(f"{START}assistant")
        return "".join(out)


class HarmonyParser:
    """Incremental parser for assistant Harmony output (the role of hanashi's
    StreamableParser bridge). State machine over header -> message body per
    channel; same interface as sessions.parser.StreamParser."""

    _MARKERS = [START, END, MESSAGE, CHANNEL, CONSTRAIN, CALL, RETURN]

    def __init__(self):
        self.buffer = ""
        self.in_header = True  # generation starts right after <|start|>assistant
        self.header = ""
        self.channel = "final"
        self.recipient = None
        self.body = ""
        self.text = ""
        self.reasoning = ""
        self.tool_calls: list[ToolCall] = []

    def _marker_hold(self) -> int:
        best = 0
        for m in self._MARKERS:
            for take in range(min(len(self.buffer), len(m) - 1), 0, -1):
                if m.startswith(self.buffer[-take:]):
                    best = max(best, take)
                    break
        return best

    def _begin_body(self):
        header = self.header
        self.channel = "final"
        self.recipient = None
        if CHANNEL in header:
            after = header.split(CHANNEL, 1)[1]
            self.channel = after.split()[0].split("<")[0] if after else "final"
            if "to=" in after:
                self.recipient = after.split("to=", 1)[1].split()[0].split("<")[0]
        self.in_header = False
        self.body = ""

    def _close_body(self):
        if self.recipient and self.recipient.startswith("functions."):
            # harmony tool payloads are the bare arguments JSON (the name
            # rides in the to= recipient), unlike the <tool_call> envelope
            name = self.recipient.split(".", 1)[1]
            try:
                args = json.loads(self.body.strip())
            except json.JSONDecodeError:
                args = {}
            tc = ToolCall(
                name=name,
                arguments=args if isinstance(args, dict) else {},
                raw=self.body,
            )
            self.tool_calls.append(tc)
            yield Event("tool_call", tool_call=dataclasses.asdict(tc))
        self.in_header = True
        self.header = ""
        self.body = ""

    def push(self, delta: str) -> Iterator[Event]:
        self.buffer += delta
        while True:
            if self.in_header:
                idx = self.buffer.find(MESSAGE)
                if idx == -1:
                    hold = self._marker_hold()
                    take = len(self.buffer) - hold
                    self.header += self.buffer[:take]
                    self.buffer = self.buffer[take:]
                    return
                self.header += self.buffer[:idx]
                self.buffer = self.buffer[idx + len(MESSAGE):]
                self._begin_body()
            else:
                # body until END / CALL / RETURN / a new START
                ends = [(self.buffer.find(m), m) for m in (END, CALL, RETURN, START)]
                ends = [(i, m) for i, m in ends if i != -1]
                if not ends:
                    hold = self._marker_hold()
                    take = len(self.buffer) - hold
                    chunk, self.buffer = self.buffer[:take], self.buffer[take:]
                    if chunk:
                        self.body += chunk
                        if self.recipient is None:
                            if self.channel == "analysis":
                                self.reasoning += chunk
                                yield Event("reasoning", delta=chunk)
                            elif self.channel == "final":
                                self.text += chunk
                                yield Event("text", delta=chunk)
                    return
                idx, marker = min(ends)
                chunk = self.buffer[:idx]
                self.buffer = self.buffer[idx + len(marker):]
                if chunk:
                    self.body += chunk
                    if self.recipient is None:
                        if self.channel == "analysis":
                            self.reasoning += chunk
                            yield Event("reasoning", delta=chunk)
                        elif self.channel == "final":
                            self.text += chunk
                            yield Event("text", delta=chunk)
                yield from self._close_body()
                if marker in (RETURN,):
                    return

    def finish(self) -> Iterator[Event]:
        if not self.in_header and self.buffer:
            chunk, self.buffer = self.buffer, ""
            self.body += chunk
            if self.recipient is None:
                if self.channel == "analysis":
                    self.reasoning += chunk
                    yield Event("reasoning", delta=chunk)
                elif self.channel == "final":
                    self.text += chunk
                    yield Event("text", delta=chunk)
        if not self.in_header and self.recipient and self.body:
            yield from self._close_body()
