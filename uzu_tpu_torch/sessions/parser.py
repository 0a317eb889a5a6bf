"""Incremental stream parsing: generated text -> reasoning / text / tool-call
sections.

Role parity: crates/token-stream-parser (framing -> reduction -> extraction,
config-driven; lib.rs:1-33, reduction/config.rs). This build's design: the
engine emits token ids; a StreamDecoder turns them into text deltas; this
parser segments the text with configured section markers, buffering any
suffix that could still grow into a marker (the analogue of the reference's
span framing on partial special-token matches). Tool-call payloads are
parsed as JSON on section close (the reference's extraction + json-transform
stage; we keep the {"name", "arguments"} convention used by Qwen/Llama
templates).

The port's copy of `uzu_tpu/sessions/parser.py` (standard library only).
"""

from __future__ import annotations

import dataclasses
import json
from typing import Iterator, Optional


@dataclasses.dataclass
class SectionConfig:
    """One markered section (the reference's reduction "bounded" group,
    config.rs Bounded{open_token, close_tokens, closes_on_sibling}).

    `close` is the primary close marker; `close_tokens` optionally lists
    alternates (any of them closes the section). `closes_on_sibling` lets
    ANOTHER section's open marker close this one implicitly (the sibling
    marker is not consumed — it opens its own section next)."""

    kind: str  # "reasoning" | "tool_call"
    open: str
    close: str
    close_tokens: tuple = ()
    closes_on_sibling: bool = False

    @property
    def closes(self) -> tuple:
        return tuple(self.close_tokens) or (self.close,)


QWEN_STYLE = [
    SectionConfig("reasoning", "<think>", "</think>"),
    SectionConfig("tool_call", "<tool_call>", "</tool_call>"),
]

LLAMA_STYLE = [
    SectionConfig("tool_call", "<|python_tag|>", "<|eom_id|>"),
]


def sections_from_config(cfg: list[dict]) -> list["SectionConfig"]:
    """Build sections from per-model JSON (parser_config.json "sections"):
    [{"kind", "open", "close_tokens" (or "close"), "closes_on_sibling"?}].
    The shape mirrors the reference's reduction groups
    (token-stream-parser/src/reduction/config.rs:7-20) flattened to the
    completion's content level (role/message framing is the template's
    job in this build — sessions render per turn, not whole transcripts)."""
    out = []
    for s in cfg:
        closes = tuple(s.get("close_tokens") or ([s["close"]] if "close" in s else []))
        if not closes:
            raise ValueError(f"section {s.get('kind')!r} has no close tokens")
        out.append(SectionConfig(
            kind=s["kind"], open=s["open"], close=closes[0],
            close_tokens=closes,
            closes_on_sibling=bool(s.get("closes_on_sibling", False)),
        ))
    return out


def load_parser_config(model_dir: str) -> dict | None:
    """Read the model dir's parser_config.json (per-model stream parsing,
    the role of the reference's bundled per-family parsing configs —
    hanashi/configs/parsing/*.json). Returns the raw dict or None.

    Recognized keys: "preset" ("harmony"), "sections" (see
    sections_from_config), "transformation" ({"schema": TransformSchema
    pipelines, "pipeline": entry name}) applied to tool_call payloads."""
    import os

    path = os.path.join(model_dir, "parser_config.json")
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Event:
    kind: str  # "text" | "reasoning" | "tool_call"
    delta: str = ""
    tool_call: Optional[dict] = None


@dataclasses.dataclass
class ToolCall:
    name: str
    arguments: dict
    raw: str

    def as_openai(self, call_id: str) -> dict:
        return {
            "id": call_id,
            "type": "function",
            "function": {"name": self.name, "arguments": json.dumps(self.arguments)},
        }


def parse_tool_payload(raw: str) -> ToolCall:
    raw = raw.strip()
    try:
        obj = json.loads(raw)
        name = obj.get("name", "")
        args = obj.get("arguments", obj.get("parameters", {}))
        if isinstance(args, str):
            args = json.loads(args)
        return ToolCall(name=name, arguments=args, raw=raw)
    except (json.JSONDecodeError, AttributeError):
        return ToolCall(name="", arguments={}, raw=raw)


class StreamParser:
    """Push text deltas, iterate parsed events.

    `transform` optionally replaces the default JSON payload parse with a
    schema-driven pipeline (sessions/transform.py, the json-transform
    equivalent): (TransformSchema, pipeline_name). The pipeline receives the
    raw section text and returns one tool-call object or a list of them.
    """

    def __init__(self, sections: list[SectionConfig] | None = None,
                 transform=None):
        self.sections = QWEN_STYLE if sections is None else sections
        self.transform = transform
        self.buffer = ""
        self.active: SectionConfig | None = None
        self.section_buf = ""
        # accumulated full sections
        self.text = ""
        self.reasoning = ""
        self.tool_calls: list[ToolCall] = []

    def _possible_marker_prefix(self, s: str) -> int:
        """Length of the longest suffix of s that is a prefix of any marker."""
        if self.active is None:
            markers = [c.open for c in self.sections]
        else:
            markers = list(self.active.closes)
            if self.active.closes_on_sibling:
                markers += [c.open for c in self.sections if c is not self.active]
        best = 0
        for m in markers:
            for take in range(min(len(s), len(m) - 1), 0, -1):
                if m.startswith(s[-take:]):
                    best = max(best, take)
                    break
        return best

    def push(self, delta: str) -> Iterator[Event]:
        self.buffer += delta
        while True:
            if self.active is None:
                # find earliest opening marker
                hit = None
                for c in self.sections:
                    idx = self.buffer.find(c.open)
                    if idx != -1 and (hit is None or idx < hit[0]):
                        hit = (idx, c)
                if hit is None:
                    hold = self._possible_marker_prefix(self.buffer)
                    emit = self.buffer[: len(self.buffer) - hold]
                    self.buffer = self.buffer[len(self.buffer) - hold :]
                    if emit:
                        self.text += emit
                        yield Event("text", delta=emit)
                    return
                idx, c = hit
                if idx:
                    self.text += self.buffer[:idx]
                    yield Event("text", delta=self.buffer[:idx])
                self.buffer = self.buffer[idx + len(c.open) :]
                self.active = c
                self.section_buf = ""
            else:
                c = self.active
                # earliest close marker (any alternate); a sibling's OPEN
                # marker also closes when closes_on_sibling — without
                # consuming it (the outer loop reopens on it next)
                idx, clen = -1, 0
                for m in c.closes:
                    j = self.buffer.find(m)
                    if j != -1 and (idx == -1 or j < idx):
                        idx, clen = j, len(m)
                if c.closes_on_sibling:
                    for other in self.sections:
                        if other is c:
                            continue
                        j = self.buffer.find(other.open)
                        if j != -1 and (idx == -1 or j < idx):
                            idx, clen = j, 0
                if idx == -1:
                    hold = self._possible_marker_prefix(self.buffer)
                    chunk = self.buffer[: len(self.buffer) - hold]
                    self.buffer = self.buffer[len(self.buffer) - hold :]
                    if chunk:
                        self.section_buf += chunk
                        if c.kind == "reasoning":
                            self.reasoning += chunk
                            yield Event("reasoning", delta=chunk)
                    return
                chunk = self.buffer[:idx]
                self.buffer = self.buffer[idx + clen :]
                self.section_buf += chunk
                if c.kind == "reasoning":
                    if chunk:
                        self.reasoning += chunk
                        yield Event("reasoning", delta=chunk)
                else:
                    for tc in self._extract_tool_calls(self.section_buf):
                        self.tool_calls.append(tc)
                        yield Event("tool_call", tool_call=dataclasses.asdict(tc))
                self.active = None
                self.section_buf = ""

    def _extract_tool_calls(self, raw: str) -> list[ToolCall]:
        if self.transform is None:
            return [parse_tool_payload(raw)]
        schema, pipeline = self.transform
        result = schema.execute(pipeline, raw)
        calls = result if isinstance(result, list) else [result]
        out = []
        for c in calls:
            if isinstance(c, dict):
                args = c.get("arguments", {})
                out.append(ToolCall(name=str(c.get("name", "")),
                                    arguments=args if isinstance(args, dict) else {},
                                    raw=raw))
        return out

    def finish(self) -> Iterator[Event]:
        """Flush any held-back text at end of stream."""
        if self.active is None and self.buffer:
            emit, self.buffer = self.buffer, ""
            self.text += emit
            yield Event("text", delta=emit)
        elif self.active is not None and self.active.kind == "reasoning" and self.buffer:
            chunk, self.buffer = self.buffer, ""
            self.reasoning += chunk
            yield Event("reasoning", delta=chunk)


class StopStrings:
    """Incremental stop-sequence scanner with holdback (OpenAI ``stop``).

    push(delta) returns (text safe to emit, hit): while no stop sequence
    has matched, it releases everything except the last max_len-1 chars (a
    sequence could still complete across the boundary — the holdback is
    what makes exact char-level truncation possible without retracting
    emitted text); on the first match it releases exactly the text BEFORE
    the sequence and reports the hit. finish() releases the held tail of a
    stream that ended without matching."""

    def __init__(self, stops):
        self.stops = [s for s in stops if s]
        self.hold = max((len(s) for s in self.stops), default=1) - 1
        self.buf = ""
        self.emitted = 0
        self.hit = False

    def push(self, delta: str) -> tuple[str, bool]:
        if self.hit or not self.stops:
            return ("" if self.hit else delta), self.hit
        self.buf += delta
        idx = min((i for i in (self.buf.find(s) for s in self.stops)
                   if i >= 0), default=-1)
        if idx >= 0:
            release = self.buf[self.emitted:idx]
            self.emitted = idx
            self.hit = True
            return release, True
        safe = max(self.emitted, len(self.buf) - self.hold)
        release = self.buf[self.emitted:safe]
        self.emitted = safe
        return release, False

    def finish(self) -> str:
        if self.hit:
            return ""
        release = self.buf[self.emitted:]
        self.emitted = len(self.buf)
        return release
