"""Schema-driven JSON transformation of extracted tool-call payloads.

Role parity with crates/json-transform: a TransformSchema is a set of named
pipelines (operation lists, applied left to right) written in JSON config,
used by the stream parser's extraction stage to turn model-specific
tool-call text (XML-ish tags, python-call syntax, malformed JSON) into the
canonical {"name", "arguments"} shape. Operation/condition semantics mirror
the reference exactly (execution/operation.rs, condition.rs, string.rs,
collection.rs, construction.rs, control_flow.rs, access.rs):

- access:        get (key | path), first
- construction:  object(fields, required), literal, to_array, default,
                 resolve(key, map, default)
- collection:    each, flat_map, filter, join, reduce(key, if, then)
- string:        format("{}"-template), regex_replace ($N capture refs),
                 regex_find_all (group 1 else 0), split_top_level,
                 parse_json(repair)
- control flow:  switch(key, cases, default), call(name | key, arguments),
                 on(field, with, do)

Type mismatches yield None (JSON null), not errors — a pipeline degrades
gracefully on unexpected model output. Unknown pipeline names raise
TransformError (the one hard error, matching the reference).

The port's copy of `uzu_tpu/sessions/transform.py` (standard library only).
"""

from __future__ import annotations

import json
import re


class TransformError(Exception):
    pass


def _is_empty(v) -> bool:
    return v is None or v == "" or (isinstance(v, list) and not v)


def _condition(cond: dict, value) -> bool:
    t = cond["type"]
    if t == "equals":
        return value == cond["value"]
    if t == "starts_with":
        return isinstance(value, str) and value.startswith(cond["value"])
    if t == "contains":
        return isinstance(value, str) and cond["value"] in value
    if t == "is_null":
        return value is None
    if t == "field":
        field = value.get(cond["key"]) if isinstance(value, dict) else None
        return _condition(cond["condition"], field)
    if t == "not":
        return not _condition(cond["condition"], value)
    if t == "and":
        return all(_condition(c, value) for c in cond["conditions"])
    if t == "or":
        return any(_condition(c, value) for c in cond["conditions"])
    raise TransformError(f"unknown condition type {t!r}")


def repair_json(text: str) -> str:
    """Best-effort repair of LLM-emitted JSON (the role of the reference's
    llm_json::repair_json): python literals, single quotes, unquoted keys,
    trailing commas, unbalanced brackets."""
    s = text.strip()
    # strip markdown fences
    if s.startswith("```"):
        s = re.sub(r"^```[a-zA-Z]*\n?", "", s)
        s = re.sub(r"\n?```$", "", s)
    # python literals outside strings; single->double quotes; done via a
    # small scanner so quoted content is untouched
    out = []
    i, n = 0, len(s)
    in_str = False
    quote = ""
    while i < n:
        ch = s[i]
        if in_str:
            if ch == "\\" and i + 1 < n:
                out.append(s[i : i + 2])
                i += 2
                continue
            if ch == quote:
                in_str = False
                out.append('"')
            elif ch == '"':
                out.append('\\"')
            else:
                out.append(ch)
            i += 1
            continue
        if ch in "\"'":
            in_str = True
            quote = ch
            out.append('"')
            i += 1
            continue
        for lit, repl in (("True", "true"), ("False", "false"), ("None", "null")):
            if s.startswith(lit, i) and not (i and (s[i - 1].isalnum() or s[i - 1] == "_")):
                end = i + len(lit)
                if end >= n or not (s[end].isalnum() or s[end] == "_"):
                    out.append(repl)
                    i = end
                    break
        else:
            out.append(ch)
            i += 1
    s = "".join(out)
    # quote bare object keys
    s = re.sub(r"([{,]\s*)([A-Za-z_][A-Za-z0-9_]*)(\s*:)", r'\1"\2"\3', s)
    # drop trailing commas
    s = re.sub(r",(\s*[}\]])", r"\1", s)
    # balance brackets
    opens = []
    in_str = False
    for ch in s:
        if in_str:
            if ch == '"':
                in_str = False
            continue
        if ch == '"':
            in_str = True
        elif ch in "{[":
            opens.append("}" if ch == "{" else "]")
        elif ch in "}]":
            if opens and opens[-1] == ch:
                opens.pop()
    s = s + "".join(reversed(opens))
    return s


def split_top_level(text: str, separator: str) -> list[str]:
    """Split at separators outside quoted strings and nested {[( )]}."""
    parts = []
    start = 0
    depth = 0
    quote = None
    escaped = False
    for i, ch in enumerate(text):
        if quote is not None:
            if escaped:
                escaped = False
            elif ch == "\\":
                escaped = True
            elif ch == quote:
                quote = None
            continue
        if ch in "\"'":
            quote = ch
        elif ch in "{[(":
            depth += 1
        elif ch in "}])":
            depth = max(0, depth - 1)
        elif ch == separator and depth == 0:
            parts.append(text[start:i])
            start = i + 1
    parts.append(text[start:])
    return parts


def _dollar_template(template: str) -> str:
    """$1 / $2 capture refs -> Python \\1 / \\2."""
    return re.sub(r"\$(\d+)", r"\\\1", template)


class TransformSchema:
    """{name: pipeline} where pipeline = [operation, ...]."""

    def __init__(self, pipelines: dict):
        self.pipelines = dict(pipelines)

    @classmethod
    def from_json(cls, text_or_dict) -> "TransformSchema":
        data = json.loads(text_or_dict) if isinstance(text_or_dict, str) else text_or_dict
        return cls(data)

    def execute(self, name: str, value):
        if name not in self.pipelines:
            raise TransformError(f"undefined pipeline {name!r}")
        return self._pipeline(self.pipelines[name], value)

    def _pipeline(self, pipeline: list, value):
        for op in pipeline:
            value = self._op(op, value)
        return value

    def _op(self, op: dict, value):
        t = op["type"]
        if t == "get":
            if "key" in op:
                return value.get(op["key"]) if isinstance(value, dict) else None
            cur = value
            for seg in op["path"]:
                if isinstance(seg, int):
                    cur = cur[seg] if isinstance(cur, list) and seg < len(cur) else None
                else:
                    cur = cur.get(seg) if isinstance(cur, dict) else None
            return cur
        if t == "first":
            return value[0] if isinstance(value, list) and value else None
        if t == "object":
            out = {}
            required = op.get("required", [])
            for field, pipeline in op["fields"].items():
                v = self._pipeline(pipeline, value)
                if _is_empty(v) and field not in required:
                    continue
                out[field] = v
            return out
        if t == "literal":
            return op["value"]
        if t == "to_array":
            return [value]
        if t == "default":
            return op["value"] if value is None else value
        if t == "resolve":
            if not isinstance(value, dict):
                return None
            key = op["key"]
            field = value.get(key)
            field = field if isinstance(field, str) else ""
            resolved = op["map"].get(field, op.get("default"))
            return {**value, key: resolved}
        if t == "each":
            if not isinstance(value, list):
                return None
            return [self._pipeline(op["apply"], v) for v in value]
        if t == "flat_map":
            if not isinstance(value, list):
                return value
            out = []
            for v in value:
                r = self._pipeline(op["apply"], v)
                out.extend(r) if isinstance(r, list) else out.append(r)
            return out
        if t == "filter":
            if not isinstance(value, list):
                return None
            return [v for v in value if _condition(op["condition"], v)]
        if t == "join":
            if not isinstance(value, list):
                return None
            return op["separator"].join(v for v in value if isinstance(v, str))
        if t == "reduce":
            return self._reduce(op, value)
        if t == "format":
            return op["template"].replace("{}", value) if isinstance(value, str) else None
        if t == "regex_replace":
            if not isinstance(value, str):
                return None
            return re.sub(op["pattern"], _dollar_template(op["template"]), value)
        if t == "regex_find_all":
            if not isinstance(value, str):
                return None
            out = []
            for m in re.finditer(op["pattern"], value):
                out.append(m.group(1) if m.lastindex else m.group(0))
            return out
        if t == "split_top_level":
            return split_top_level(value, op["separator"]) if isinstance(value, str) else None
        if t == "parse_json":
            if not isinstance(value, str):
                return None
            if op.get("repair"):
                try:
                    return json.loads(repair_json(value))
                except json.JSONDecodeError:
                    return value
            try:
                return json.loads(value)
            except json.JSONDecodeError as e:
                raise TransformError(f"invalid JSON: {e}") from None
        if t == "switch":
            match_value = self._pipeline(op["key"], value)
            for case in op["cases"]:
                if _condition(case["when"], match_value):
                    return self._pipeline(case["then"], value)
            default = op.get("default")
            return self._pipeline(default, value) if default is not None else None
        if t == "call":
            if "name" in op:
                name = op["name"]
            else:
                name = value.get(op["key"]) if isinstance(value, dict) else None
                if not isinstance(name, str):
                    raise TransformError(f"dynamic call key {op['key']!r} not found")
            arguments = op.get("arguments", {})
            if arguments:
                base = dict(value) if isinstance(value, dict) else {}
                base.update(arguments)
                value = base
            return self.execute(name, value)
        if t == "on":
            working = (
                value.get(op["with"]) if op.get("with") and isinstance(value, dict) else value
            )
            active = isinstance(value, dict) and value.get(op["field"]) is True
            return self._pipeline(op["do"], working) if active else working
        raise TransformError(f"unknown operation type {t!r}")

    def _reduce(self, op: dict, value):
        """Group consecutive elements by key, merge each group with `then`."""
        if not isinstance(value, list):
            return None
        cond = op.get("if")
        result = []
        group: list = []
        group_key = _sentinel = object()

        def flush():
            nonlocal group, group_key
            if group:
                result.append(self._pipeline(op["then"], group))
            group, group_key = [], _sentinel

        for item in value:
            item_key = self._pipeline(op["key"], item)
            if cond is not None and not _condition(cond, item_key):
                flush()
                result.append(item)
                continue
            if group and group_key != item_key:
                flush()
            group_key = item_key
            group.append(item)
        flush()
        return result
