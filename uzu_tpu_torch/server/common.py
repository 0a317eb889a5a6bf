"""Shared OpenAI request plumbing for both servers.

Reference counterpart: the request-side grammar selection in
crates/backend-uzu/src/engine/language_model/grammar/mod.rs:65-68
(Grammar::JsonSchema / Grammar::Regex); the OpenAI ``response_format``
object is this host's wire format for the same choice.

The port's copy of `uzu_tpu/server/common.py`.
"""

from __future__ import annotations


def logprob_entries(tokenizer, token_ids, logprob_content, top_n: int):
    """OpenAI choices[].logprobs.content entries — the ONE formatter shared
    by both servers' stream and non-stream paths."""
    out = []
    for tok_id, (lp, tops) in zip(token_ids, logprob_content):
        entry = {"token": tokenizer.decode([tok_id]), "logprob": lp}
        if top_n:
            entry["top_logprobs"] = [
                {"token": tokenizer.decode([i]), "logprob": v}
                for i, v in tops[:top_n]
            ]
        out.append(entry)
    return out


def max_tokens_from_request(body: dict) -> int:
    """Coerced/validated max_tokens: malformed values must 400 in the HTTP
    handler, not crash inside the scheduler thread (which would wedge the
    whole server)."""
    raw = body.get("max_tokens")
    if raw is None:
        raw = body.get("max_completion_tokens")
    if raw is None:
        return 512
    try:
        val = int(raw)
    except (TypeError, ValueError):
        raise ValueError(f"max_tokens must be an integer, got {raw!r}")
    if val < 1:
        raise ValueError("max_tokens must be >= 1")
    return val


def seed_from_request(body: dict) -> int:
    raw = body.get("seed")
    if raw is None:  # OpenAI declares seed nullable: null == default
        return 0
    try:
        return int(raw)
    except (TypeError, ValueError):
        raise ValueError(f"seed must be an integer, got {raw!r}")


def tools_from_request(body: dict):
    """OpenAI ``tools`` + ``tool_choice`` -> the tool-spec dicts to render
    into the chat template, or None when the request declares none.

    Reference semantics (cli/src/server/chat_tool_calls.rs choose_tools):
    "none" hides every declared tool, "auto"/"required" keep the full set
    (declarations are the only lever a local model has — "required" cannot
    compel a call), and a function object exposes only the named tool.
    Raises ValueError (-> HTTP 400) on unrecognized values."""
    tools = body.get("tools") or []
    if not isinstance(tools, list):
        raise ValueError("tools must be an array of tool declarations")
    choice = body.get("tool_choice")
    if choice is None:
        return tools or None
    if isinstance(choice, str):
        if choice == "none":
            return None
        if choice in ("auto", "required"):
            return tools or None
        raise ValueError(
            'tool_choice must be "none", "auto", "required" or a function '
            f"object, got {choice!r}")
    if isinstance(choice, dict):
        name = (choice.get("function") or {}).get("name")
        if not name:
            raise ValueError("tool_choice object needs function.name")
        selected = [
            t for t in tools
            if (t.get("function") or {}).get("name") == name
        ]
        if not selected:
            raise ValueError(f"tool_choice names an undeclared tool {name!r}")
        return selected
    raise ValueError("tool_choice is not a recognized value")


def stops_from_request(body: dict) -> list:
    """OpenAI ``stop``: a string or up to 4 strings."""
    stop = body.get("stop")
    if stop is None:
        return []
    if isinstance(stop, str):
        stop = [stop]
    if not isinstance(stop, list) or not all(isinstance(s, str) for s in stop):
        raise ValueError("stop must be a string or an array of strings")
    if len(stop) > 4:
        raise ValueError("stop supports at most 4 sequences")
    return [s for s in stop if s]


def sampling_from_request(body: dict, default):
    """Per-request OpenAI sampling fields over the server defaults.
    An explicit JSON null means "use the server default" (OpenAI
    semantics), not an override to None/greedy. Values coerce to their
    numeric types here so a malformed request 400s instead of crashing in
    the scheduler thread."""
    from ..engine.sampling import SamplingParams

    def field(name, dflt, typ):
        v = body.get(name)
        if v is None:
            return dflt
        try:
            return typ(v)
        except (TypeError, ValueError):
            raise ValueError(f"{name} must be a {typ.__name__}, got {v!r}")

    return SamplingParams(
        temperature=field("temperature", default.temperature, float),
        top_k=field("top_k", default.top_k, int),
        top_p=field("top_p", default.top_p, float),
        min_p=field("min_p", default.min_p, float),
        repetition_penalty=field("repetition_penalty",
                                 default.repetition_penalty, float),
        suffix_repetition_length=default.suffix_repetition_length,
        banned_tokens=default.banned_tokens,
    )


def grammar_from_request(tokenizer, body: dict):
    """``response_format`` -> GrammarSession (or None when unconstrained).

    Accepts the OpenAI shapes ``{"type": "json_object"}`` and
    ``{"type": "json_schema", "json_schema": {"schema": ...}}`` plus the
    common extension ``{"type": "regex", "pattern": ...}``. JSON grammars
    additionally honor the reference's formatting/strictness knobs
    (grammar/config.rs:5-12) at either nesting level:
    ``any_whitespace`` (bool), ``indent`` (int), ``separators``
    ([item, key]), ``strict_mode`` (bool). Raises ValueError (mapped to
    HTTP 400 by the handlers) on anything else.
    """
    rf = body.get("response_format")
    if not rf:
        return None
    if not isinstance(rf, dict):
        raise ValueError("response_format must be an object")
    typ = rf.get("type")
    if typ in (None, "text"):
        return None
    from ..grammar import GrammarError, GrammarSession

    def fmt_kw(*sources):
        kw = {}
        for src in sources:
            if not isinstance(src, dict):
                continue
            for key in ("any_whitespace", "indent", "separators",
                        "strict_mode"):
                if key in src and key not in kw:
                    kw[key] = src[key]
        if "separators" in kw and kw["separators"] is not None:
            seps = kw["separators"]
            if not (isinstance(seps, (list, tuple)) and len(seps) == 2):
                raise ValueError("separators must be a [item, key] pair")
            kw["separators"] = (str(seps[0]), str(seps[1]))
        return kw

    try:
        if typ == "json_object":
            return GrammarSession(tokenizer, schema=None, **fmt_kw(rf))
        if typ == "json_schema":
            js = rf.get("json_schema") or {}
            schema = js.get("schema") if isinstance(js, dict) else None
            return GrammarSession(tokenizer, schema=schema, **fmt_kw(js, rf))
        if typ == "regex":
            pattern = rf.get("pattern") or rf.get("regex")
            if not pattern:
                raise ValueError("response_format regex needs a 'pattern'")
            return GrammarSession(tokenizer, regex=pattern)
    except GrammarError as exc:
        raise ValueError(str(exc)) from exc
    raise ValueError(f"unsupported response_format type {typ!r}")
