"""Chat-template rendering (Jinja, HF chat_template convention).

Role parity: crates/hanashi — the reference renders prompts through a
minijinja environment with a canonical message model and strict message-
ordering validation (hanashi/renderer/mod.rs:20-40, context.rs). Here the
template itself comes from tokenizer_config.json (the HF ecosystem standard
uzu's exporter also consumes), rendered with jinja2 plus the same
non-standard filters/functions HF templates rely on (tojson, strftime_now).

The port's copy of `uzu_tpu/sessions/template.py` (jinja2, as there).
"""

from __future__ import annotations

import dataclasses
import datetime
import json
from typing import Any, Callable, Optional

VALID_ROLES = ("system", "user", "assistant", "tool")


class TemplateError(ValueError):
    pass


@dataclasses.dataclass
class ToolSpec:
    """An exposed tool: JSON-schema function spec + python callable."""

    name: str
    description: str
    parameters: dict  # JSON schema
    fn: Optional[Callable[..., Any]] = None

    def spec(self) -> dict:
        return {
            "type": "function",
            "function": {
                "name": self.name,
                "description": self.description,
                "parameters": self.parameters,
            },
        }


def validate_messages(messages: list[dict]) -> None:
    """Message-ordering validation (hanashi context.rs semantics): roles
    valid; system only first; tool responses only after an assistant
    tool-call turn."""
    for i, m in enumerate(messages):
        role = m.get("role")
        if role not in VALID_ROLES:
            raise TemplateError(f"message {i}: invalid role {role!r}")
        if role == "system" and i != 0:
            raise TemplateError(f"message {i}: system message must be first")
        if role == "tool":
            prev = next(
                (p for p in reversed(messages[:i]) if p.get("role") != "tool"), None
            )
            if prev is None or prev.get("role") != "assistant" or not prev.get("tool_calls"):
                raise TemplateError(
                    f"message {i}: tool message without preceding assistant tool_calls"
                )


DEFAULT_TEMPLATE = """{% for message in messages -%}
<|{{ message.role }}|>
{% if message.tool_calls %}{% for tc in message.tool_calls %}<tool_call>{{ {"name": tc.function.name, "arguments": tc.function.arguments} | tojson }}</tool_call>{% endfor %}{% else %}{{ message.content }}{% endif %}<|end|>
{% endfor -%}
{% if add_generation_prompt %}<|assistant|>
{% endif %}"""


class ChatTemplate:
    def __init__(self, template: str | None):
        import jinja2

        self.env = jinja2.Environment(
            loader=jinja2.BaseLoader(),
            trim_blocks=True,
            lstrip_blocks=True,
            extensions=["jinja2.ext.loopcontrols"],
        )
        self.env.filters["tojson"] = lambda v, **kw: json.dumps(v, **kw)
        self.env.globals["strftime_now"] = lambda fmt: datetime.datetime.now().strftime(fmt)
        self.env.globals["raise_exception"] = _raise_exception
        self.template = self.env.from_string(template or DEFAULT_TEMPLATE)

    def render(
        self,
        messages: list[dict],
        *,
        tools: list[dict] | None = None,
        add_generation_prompt: bool = True,
        **extra,
    ) -> str:
        validate_messages(messages)
        ctx = dict(
            messages=messages,
            add_generation_prompt=add_generation_prompt,
            **extra,
        )
        if tools:
            ctx["tools"] = tools
        try:
            return self.template.render(**ctx)
        except Exception as e:  # jinja2 errors -> uniform error type
            raise TemplateError(f"chat template render failed: {e}") from e


def _raise_exception(msg):
    raise TemplateError(msg)
