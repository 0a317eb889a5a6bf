"""Grammar-constrained decoding: JSON (+schema subset) byte matcher with
per-step token bitmasks.

The port's copy of `uzu_tpu/grammar/matcher.py` (numpy only, no framework),
with one change of behaviour: a failed build of the native engines raises
instead of falling back to the Python matchers; `backend="python"` picks
them explicitly, and a schema the native flattener does not take
(`SchemaUnsupported`) still goes to them. `GrammarSession.backend` says
which one runs.

Reference counterpart: crates/backend-uzu/src/engine/language_model/grammar/
(xgrammar C++ FFI: JSON-schema / regex / builtin-JSON -> compiled matcher ->
per-step token bitmasks; engagement state machine in grammar/engagement.rs).
This is a from-scratch Python implementation (a C++ port is the native-code
milestone): a deterministic character-level pushdown matcher for JSON with a
JSON-schema subset, and a vocabulary mask computed by simulating each
token's characters — cached per matcher-state signature (the role of
xgrammar's adaptive token mask cache).

Schema subset: type object (properties/required/additionalProperties),
array (items, minItems/maxItems bounded), string, number, integer, boolean,
null, enum (of scalars), const, anyOf/oneOf (branch-set fork; oneOf's
exclusivity is not enforced at generation time — the mask is the union of
the alternatives, matching xgrammar's practical behavior), local $ref
(#/$defs/... and #/definitions/..., recursion supported), and string
`pattern` (compiled to the char-class DFA of grammar/regex.py; edge ^/$
anchors honored, otherwise unanchored containment per JSON Schema), and
string `format` (date/time/date-time/duration/uuid/email/hostname/ipv4/
ipv6/uri, normalized to anchored patterns the way xgrammar compiles
formats to regexes; unknown formats are annotations per the JSON-Schema
spec and stay ignored) plus string minLength/maxLength (normalized the
same way) and integer minimum/maximum/exclusive* (enforced arithmetically
on the number frame: digits mask off once no suffix can land in range,
and the number can close only in range; number-typed bounds stay
annotations — fractional boundary semantics don't fit a char mask), and
allOf (conservative key-merge at resolve time: $ref + overlay, bound
tightening, property union; irreconcilable members raise). Enough for
real tool-call argument schemas.

Combinators make the matcher a BRANCH SET (GLR-style): every branch is a
deterministic pushdown stack; a "value" frame whose schema is an anyOf
forks the branch per alternative, characters advance all branches and drop
the ones that reject, and the token mask is the union over branches.
Branch counts stay small (bounded by combinator nesting) and signatures
dedupe identical branches.
"""

from __future__ import annotations

import json
from typing import Any, Optional

import numpy as np

WS = " \t\n\r"
DIGITS = "0123456789"


class GrammarError(ValueError):
    pass


# -- matcher frames ----------------------------------------------------------
# Branch state is a stack of frames; each frame is a tuple whose first
# element is the frame kind. Deterministic at character level (combinator
# nondeterminism lives in the branch SET, never inside a frame).
#
#   ("value", schema)                   expect any value allowed by schema
#   ("string_body", allowed|None, acc)  inside quotes; allowed = set of exact
#                                       strings (enum/const/keys) or None
#   ("string_esc", allowed, acc)        after backslash
#   ("string_pat", pat, states, matched) inside quotes, pattern-constrained:
#                                       states = DFA state bitmask of the
#                                       containment walk, matched = sticky
#                                       "a match has been seen" (unanchored
#                                       end) — see _pattern_info
#   ("string_pat_esc", pat, states, matched)   after backslash
#   ("string_pat_u", pat, states, matched, hex) inside \uXXXX
#   ("number", schema, acc)             inside a number literal
#   ("literal", rest)                   fixed text remaining (true/false/null)
#   ("obj_open", schema)                after '{' : expect key or '}'
#   ("obj_key", schema, seen)           expect '"' starting a key
#   ("obj_colon", schema, seen, key)    expect ':'
#   ("obj_next", schema, seen)          expect ',' or '}'
#   ("arr_open", schema, n)             after '[' : expect value or ']'
#   ("arr_next", schema, n)             expect ',' or ']'


def _schema_key(schema) -> str:
    return json.dumps(schema, sort_keys=True) if isinstance(schema, dict) else "any"


class _Fork(Exception):
    """Raised by a branch whose top value frame is a combinator: the
    branch set substitutes each alternative and re-feeds the character."""

    def __init__(self, alternatives):
        self.alternatives = alternatives


class _Fmt:
    """JSON formatting/strictness contract (reference: backend-uzu
    grammar/config.rs:5-12 — any_whitespace / indent / separators /
    strict_mode, the knobs real clients use to force compact or pretty
    JSON out of a constrained model).

    any_whitespace=True keeps the flexible-whitespace matcher (indent and
    separators are ignored, like xgrammar). With it False the matcher
    admits EXACTLY one serialization: `indent=N` produces json.dumps-style
    pretty printing (newline + N-space-per-level indentation, members on
    their own lines, `{}`/`[]` for empty containers), indent=None the
    compact form; `separators=(item, key)` override the defaults
    ((', ', ': ') compact, (',', ': ') with indent — json.dumps parity).
    strict_mode (default True) keeps objects closed when the schema
    doesn't set additionalProperties; False flips that default open."""

    __slots__ = ("any_ws", "item_tail", "key_tail", "indent", "strict")

    def __init__(self, any_whitespace=True, indent=None, separators=None,
                 strict_mode=True):
        if separators is None:
            separators = (",", ": ") if indent is not None else (", ", ": ")
        item, key = separators
        if not item or item[0] != "," or item[1:].strip(" \t\n"):
            raise GrammarError(
                f"separators[0] must be ',' plus optional whitespace: {item!r}")
        if not key or key[0] != ":" or key[1:].strip(" \t\n"):
            raise GrammarError(
                f"separators[1] must be ':' plus optional whitespace: {key!r}")
        if indent is not None and (isinstance(indent, bool)
                                   or not isinstance(indent, int)
                                   or indent < 0):
            # isinstance(True, int) is True — a JSON `"indent": true` must
            # 400, not silently pretty-print at True*depth spaces
            raise GrammarError(f"indent must be a non-negative int: {indent!r}")
        if not isinstance(any_whitespace, bool):
            raise GrammarError(
                f"any_whitespace must be a boolean: {any_whitespace!r}")
        if not isinstance(strict_mode, bool):
            raise GrammarError(
                f"strict_mode must be a boolean: {strict_mode!r}")
        self.any_ws = bool(any_whitespace)
        self.item_tail = item[1:]
        self.key_tail = key[1:]
        self.indent = indent
        self.strict = bool(strict_mode)

    @property
    def default(self) -> bool:
        return self.any_ws and self.strict

    def member_ws(self, depth: int) -> str:
        """Required whitespace before a member at container depth `depth`
        (the container itself counts): newline + depth*indent spaces in
        pretty mode, nothing in compact mode."""
        if self.indent is None:
            return ""
        return "\n" + " " * (self.indent * depth)

    def close_ws(self, depth: int) -> str:
        if self.indent is None:
            return ""
        return "\n" + " " * (self.indent * (depth - 1))


_CONTAINER_KINDS = frozenset((
    "obj_open", "obj_key_body", "obj_value_colon", "obj_next",
    "obj_key_start", "obj_close_ws", "arr_open", "arr_next", "arr_close_ws",
))


def _depth(branch) -> int:
    """Container nesting depth: each open container owns exactly one frame
    on the stack at any time."""
    return sum(1 for f in branch.stack if f[0] in _CONTAINER_KINDS)


# annotation keys that never constrain matching and are dropped when
# merging combinator/ref siblings
_ANNOTATIONS = ("description", "title", "default", "examples", "$schema",
                "$id", "$defs", "definitions")


def _collect_defs(schema) -> dict:
    """Local definition table for $ref resolution (root-level $defs /
    definitions — the subset real tool schemas use)."""
    defs: dict[str, Any] = {}
    if isinstance(schema, dict):
        for key in ("$defs", "definitions"):
            sub = schema.get(key)
            if isinstance(sub, dict):
                for name, s in sub.items():
                    defs[f"#/{key}/{name}"] = s
    return defs


# JSON-Schema string `format` -> anchored pattern (the ref's xgrammar
# likewise compiles formats into regexes). Subset fits grammar/regex.py;
# an explicit sibling `pattern` wins; unknown format names are ignored
# (format is an annotation by default per the JSON-Schema spec).
_TIME_BODY = (r"([01]\d|2[0-3]):[0-5]\d:[0-5]\d(\.\d+)?"
              r"(Z|[+-]([01]\d|2[0-3]):[0-5]\d)")
_DATE_BODY = r"\d{4}-(0[1-9]|1[0-2])-(0[1-9]|[12]\d|3[01])"
_FORMAT_PATTERNS = {
    "date": f"^{_DATE_BODY}$",
    "time": f"^{_TIME_BODY}$",
    "date-time": f"^{_DATE_BODY}T{_TIME_BODY}$",
    # at-least-one-designator enforced by nonempty alternatives (the DFA
    # subset has no lookahead)
    "duration": r"^P(\d+W"
                r"|(\d+Y(\d+M)?(\d+D)?|\d+M(\d+D)?|\d+D)"
                r"(T(\d+H(\d+M)?(\d+(\.\d+)?S)?|\d+M(\d+(\.\d+)?S)?"
                r"|\d+(\.\d+)?S))?"
                r"|T(\d+H(\d+M)?(\d+(\.\d+)?S)?|\d+M(\d+(\.\d+)?S)?"
                r"|\d+(\.\d+)?S))$",
    "uuid": r"^[0-9a-fA-F]{8}-[0-9a-fA-F]{4}-[0-9a-fA-F]{4}"
            r"-[0-9a-fA-F]{4}-[0-9a-fA-F]{12}$",
    "email": r"^[A-Za-z0-9.!#$%&'*+/=?_`{|}~^-]+@"
             r"[A-Za-z0-9]([A-Za-z0-9-]*[A-Za-z0-9])?"
             r"(\.[A-Za-z0-9]([A-Za-z0-9-]*[A-Za-z0-9])?)+$",
    "hostname": r"^[A-Za-z0-9]([A-Za-z0-9-]*[A-Za-z0-9])?"
                r"(\.[A-Za-z0-9]([A-Za-z0-9-]*[A-Za-z0-9])?)*$",
    "ipv4": r"^((25[0-5]|2[0-4]\d|1\d\d|[1-9]?\d)\.){3}"
            r"(25[0-5]|2[0-4]\d|1\d\d|[1-9]?\d)$",
    # pragmatic ipv6 (xgrammar-style): hex fields with one optional `::`
    # compression, no embedded-ipv4 tail
    "ipv6": r"^(([0-9A-Fa-f]{1,4}:){7}[0-9A-Fa-f]{1,4}"
            r"|([0-9A-Fa-f]{1,4}:){1,7}:"
            r"|:(:[0-9A-Fa-f]{1,4}){1,7}"
            r"|([0-9A-Fa-f]{1,4}:){1,6}(:[0-9A-Fa-f]{1,4}){1,6}|::)$",
    "uri": r"^[A-Za-z][A-Za-z0-9+.-]*:[^ \t\n\r]*$",
}


def _normalize_format(schema):
    """Rewrite a known string `format` — or minLength/maxLength bounds —
    into a `pattern` (no-op otherwise); shared by the Python matcher and
    the native flattener so the two engines stay in lockstep. An explicit
    `pattern` wins (the DFA subset cannot intersect languages); formats
    win over length bounds (every format pattern already pins lengths)."""
    if (not isinstance(schema, dict) or "pattern" in schema
            or "enum" in schema or "const" in schema):
        return schema
    pat = (_FORMAT_PATTERNS.get(schema["format"])
           if isinstance(schema.get("format"), str) else None)
    if pat is None:
        lo, hi = schema.get("minLength"), schema.get("maxLength")
        if isinstance(lo, int) or isinstance(hi, int):
            lo = lo if isinstance(lo, int) and lo > 0 else 0
            # (.|\n) = any char: `.` excludes newline in the DFA subset
            pat = (f"^(.|\\n){{{lo},{hi}}}$" if isinstance(hi, int)
                   else f"^(.|\\n){{{lo},}}$")
    if pat is not None:
        schema = {k: v for k, v in schema.items()
                  if k not in ("minLength", "maxLength")}
        schema["pattern"] = pat
    return schema


def _merge_allof(schema, defs, _depth: int = 0):
    """Conservative allOf intersection by key-merge (the cases real tool
    schemas use: $ref + overlay, bound tightening, property union). Members
    resolve first (so $ref/nested-allOf inline); conflicting property
    schemas nest as allOf and merge when reached; numeric/length/item
    bounds tighten; anything else that conflicts raises (xgrammar's
    general intersection is out of scope)."""
    members = schema.get("allOf")
    if not isinstance(members, list) or not members:
        raise GrammarError("allOf must be a non-empty list")
    out = {k: v for k, v in schema.items() if k != "allOf"}
    for member in members:
        member = _resolve(member, defs, _depth + 1)
        if member is True or member == {}:
            continue
        if not isinstance(member, dict):
            raise GrammarError("allOf member must be an object schema")
        for k, v in member.items():
            if k in _ANNOTATIONS:
                continue
            if k not in out or out[k] == v:
                out[k] = v
            elif k == "required":
                out[k] = sorted(set(out[k]) | set(v))
            elif k == "properties":
                merged = dict(out[k])
                for pk, pv in v.items():
                    if pk in merged and merged[pk] != pv:
                        merged[pk] = {"allOf": [merged[pk], pv]}
                    else:
                        merged[pk] = pv
                out[k] = merged
            elif k in ("minimum", "minLength", "minItems") or (
                    k == "exclusiveMinimum"
                    and not isinstance(v, bool)
                    and not isinstance(out[k], bool)):
                out[k] = max(out[k], v)
            elif k in ("maximum", "maxLength", "maxItems") or (
                    k == "exclusiveMaximum"
                    and not isinstance(v, bool)
                    and not isinstance(out[k], bool)):
                out[k] = min(out[k], v)
            elif k in ("anyOf", "oneOf"):
                raise GrammarError("allOf of multiple combinators")
            else:
                raise GrammarError(f"allOf members conflict on {k!r}")
    return out


def _resolve(schema, defs, _depth: int = 0):
    """Follow $ref chains; merge non-annotation sibling keys (siblings win —
    they are the more-local constraint, e.g. a $ref plus a narrowing enum);
    inline allOf by conservative key-merge."""
    while isinstance(schema, dict) and "$ref" in schema:
        if _depth > 64:
            raise GrammarError("$ref chain too deep / cyclic")
        ref = schema["$ref"]
        target = defs.get(ref)
        if target is None:
            raise GrammarError(f"unresolvable $ref {ref!r}")
        extras = {k: v for k, v in schema.items()
                  if k != "$ref" and k not in _ANNOTATIONS}
        schema = {**target, **extras} if extras else target
        _depth += 1
    if isinstance(schema, dict) and "allOf" in schema:
        if _depth > 64:
            raise GrammarError("allOf nesting too deep / cyclic")
        schema = _merge_allof(schema, defs, _depth)
    return _normalize_format(schema)


def _alternatives(schema):
    """anyOf/oneOf alternatives (sibling constraints merged into each), or
    None. oneOf == anyOf for masking purposes (exclusivity is a validation
    concern, not reachable-prefix one)."""
    if not isinstance(schema, dict):
        return None
    alts = schema.get("anyOf")
    if alts is None:
        alts = schema.get("oneOf")
    if alts is None:
        return None
    if not isinstance(alts, list) or not alts:
        raise GrammarError("anyOf/oneOf must be a non-empty list")
    extras = {k: v for k, v in schema.items()
              if k not in ("anyOf", "oneOf") and k not in _ANNOTATIONS}
    if extras:
        return [{**extras, **a} if isinstance(a, dict) else a for a in alts]
    return list(alts)


class _Branch:
    """One deterministic pushdown stack (the pre-combinator JsonMatcher)."""

    __slots__ = ("stack", "finished", "defs", "fmt")

    def __init__(self, schema, defs, fmt=None):
        self.stack: list[tuple] = [("value", schema)]
        self.finished = False
        self.defs = defs
        self.fmt = fmt

    def clone(self) -> "_Branch":
        b = _Branch.__new__(_Branch)
        b.stack = list(self.stack)
        b.finished = self.finished
        b.defs = self.defs
        b.fmt = self.fmt
        return b

    def signature(self) -> tuple:
        return (self.finished, tuple(map(_frame_sig, self.stack)))

    def advance(self, ch: str) -> bool:
        """Consume one character; False if rejected (state then undefined).
        Raises _Fork when the top value frame is a combinator — including
        from nested re-dispatch (array item start), where the stack below
        the combinator frame has already validly consumed the char."""
        if not self.stack:
            self.finished = True
            return ch in WS and (self.fmt is None or self.fmt.any_ws)
        top = self.stack[-1]
        if top[0] == "value":
            schema = _resolve(top[1], self.defs)
            alts = _alternatives(schema)
            if alts is not None:
                raise _Fork(alts)
            if schema is not top[1]:
                self.stack[-1] = ("value", schema)
        kind = self.stack[-1][0]
        handler = _HANDLERS[kind]
        return handler(self, ch)

    def is_complete(self) -> bool:
        return not self.stack


class JsonMatcher:
    """Byte/char-level matcher for one JSON value: a set of deterministic
    branches (one unless combinators fork). Public API is unchanged from
    the single-stack version: advance/feed_text/accepts_text/is_complete/
    clone/signature."""

    def __init__(self, schema: Optional[dict] = None, fmt: "_Fmt" = None):
        self.schema = schema
        self.fmt = fmt if fmt is not None and not fmt.default else None
        defs = _collect_defs(schema)
        self.branches: list[_Branch] = [_Branch(schema, defs, self.fmt)]

    # -- core transition ---------------------------------------------------

    def clone(self) -> "JsonMatcher":
        m = JsonMatcher.__new__(JsonMatcher)
        m.schema = self.schema
        m.fmt = self.fmt
        m.branches = [b.clone() for b in self.branches]
        return m

    def signature(self) -> tuple:
        if len(self.branches) == 1:
            return self.branches[0].signature()
        return tuple(sorted(b.signature() for b in self.branches))

    def advance(self, ch: str) -> bool:
        """Consume one character across all branches; returns False (state
        then undefined) if every branch rejects."""
        work = self.branches
        out: list[_Branch] = []
        sigs: set = set()
        forks = 0
        while work:
            b = work.pop()
            try:
                ok = b.advance(ch)
            except _Fork as f:
                forks += 1
                if forks > 512:  # runaway combinator/ref cycle
                    raise GrammarError("combinator expansion does not converge")
                for alt in f.alternatives:
                    nb = b.clone()
                    nb.stack[-1] = ("value", alt)
                    work.append(nb)
                continue
            if ok:
                sig = b.signature()
                if sig not in sigs:
                    sigs.add(sig)
                    out.append(b)
        self.branches = out
        return bool(out)

    def accepts_text(self, text: str) -> bool:
        m = self.clone()
        for ch in text:
            if not m.advance(ch):
                return False
        return True

    def feed_text(self, text: str) -> bool:
        for ch in text:
            if not self.advance(ch):
                return False
        return True

    def is_complete(self) -> bool:
        return any(b.is_complete() for b in self.branches)


def _frame_sig(frame: tuple) -> tuple:
    # free-form strings: the reachable-token mask is independent of the
    # accumulator once there is no allowed-set, so drop it from the
    # signature — otherwise every character inside a string is a cache
    # miss that re-simulates the whole vocabulary
    if frame[0] in ("string_body", "string_esc") and frame[1] is None:
        return frame[:2]
    if frame[0] == "string_u" and frame[1] is None:
        return ("string_u", None, frame[3])
    out = []
    for x in frame:
        if isinstance(x, dict):
            out.append(_schema_key(x))
        elif isinstance(x, set):
            out.append(tuple(sorted(x)))
        else:
            out.append(x)
    return tuple(out)


def _string_allowed(schema) -> Optional[set]:
    if isinstance(schema, dict):
        if "const" in schema and isinstance(schema["const"], str):
            return {schema["const"]}
        if "enum" in schema:
            return {e for e in schema["enum"] if isinstance(e, str)}
    return None


# -- string `pattern` ---------------------------------------------------------

class _PatternInfo:
    """Compiled JSON-Schema string pattern: the char-class DFA of the body
    (grammar/regex.py, implicitly anchored) plus edge-anchor flags. The
    string walk simulates CONTAINMENT over the DFA with a state BITMASK:
    without ^ the start state is re-seeded every character (a match may
    begin anywhere); without $ "matched" is sticky once any live state
    accepts (a match may end anywhere)."""

    __slots__ = ("dfa", "anchored_start", "anchored_end", "accept_mask",
                 "start_mask", "table")

    def __init__(self, pattern: str):
        from .regex import RegexDFA

        body, self.anchored_start, self.anchored_end = _strip_anchors(pattern)
        self.dfa = RegexDFA(body)
        self.table = self.dfa.table
        self.accept_mask = 0
        for i, a in enumerate(self.dfa.accept):
            if a:
                self.accept_mask |= 1 << i
        self.start_mask = 1  # subset construction: start state is 0

    def step(self, states: int, ch: str) -> int:
        src = states if self.anchored_start else (states | self.start_mask)
        cid = self.dfa.class_of(ch)
        col = self.table[:, cid]
        new = 0
        s = src
        while s:
            low = s & -s
            t = int(col[low.bit_length() - 1])
            if t >= 0:
                new |= 1 << t
            s ^= low
        return new

    def range_viable(self, states: int, matched: bool, lo: int, hi: int) -> bool:
        """True iff SOME codepoint in [lo, hi] keeps the containment walk
        alive (non-empty next state set). Gates \\-escape entry and each
        \\uXXXX hex digit: without it a dead-end escape (e.g. \\u after
        ^[A-Z]{3}$ has already matched 3 chars) is admitted and generation
        is trapped until max_tokens. Unanchored start re-seeds every char,
        so nothing ever dies there; a sticky match is free-running."""
        if matched or not self.anchored_start:
            return True
        import bisect

        bounds = self.dfa._bounds
        cls = self.dfa._interval_class
        i = max(bisect.bisect_right(bounds, lo) - 1, 0)
        seen: set[int] = set()
        while i < len(cls) and bounds[i] <= hi:
            cid = cls[i]
            if cid not in seen:
                seen.add(cid)
                col = self.table[:, cid]
                s = states
                while s:
                    low = s & -s
                    if int(col[low.bit_length() - 1]) >= 0:
                        return True
                    s ^= low
            i += 1
        return False


def _strip_anchors(pattern: str) -> tuple[str, bool, bool]:
    a_start = pattern.startswith("^")
    body = pattern[1:] if a_start else pattern
    a_end = False
    if body.endswith("$"):
        bs = 0
        i = len(body) - 2
        while i >= 0 and body[i] == "\\":
            bs += 1
            i -= 1
        if bs % 2 == 0:  # the $ is not escaped
            a_end = True
            body = body[:-1]
    return body, a_start, a_end


_PATTERN_CACHE: dict[str, _PatternInfo] = {}


def _pattern_info(pattern: str) -> _PatternInfo:
    info = _PATTERN_CACHE.get(pattern)
    if info is None:
        try:
            info = _PatternInfo(pattern)
        except Exception as exc:
            raise GrammarError(f"unsupported pattern {pattern!r}: {exc}") from exc
        _PATTERN_CACHE[pattern] = info
    return info


def _pat_frame_after(kind: str, pat: str, states: int, matched: bool,
                     info: _PatternInfo, ch: str):
    """Step the containment walk by one decoded character; None = dead."""
    new = info.step(states, ch)
    if info.anchored_end:
        # match must end exactly at the closing quote; "matched" is
        # recomputed there. An empty state set is dead ONLY when the start
        # is anchored too — otherwise the start re-seeds every character
        # and a later match can still begin.
        if not new and info.anchored_start:
            return None
        return (kind, pat, new, False)
    matched = matched or bool(new & info.accept_mask)
    if matched:
        return (kind, pat, 0, True)  # free-running tail: stop tracking
    if not new and info.anchored_start:
        return None  # anchored start, all states dead, never matched
    return (kind, pat, new, False)


def _pat_close_ok(pat: str, states: int, matched: bool) -> bool:
    info = _pattern_info(pat)
    if info.anchored_end:
        return bool(states & info.accept_mask)
    return matched


def _value_start(m: JsonMatcher, ch: str, schema) -> bool:
    fmt = m.fmt
    exact = fmt is not None and not fmt.any_ws
    if ch in WS:
        return not exact
    types = None
    if isinstance(schema, dict):
        if "enum" in schema or "const" in schema:
            consts = schema.get("enum", [schema.get("const")])
            kinds = set()
            for c in consts:
                if isinstance(c, str):
                    kinds.add("string")
                elif isinstance(c, bool):
                    kinds.add("boolean")
                elif isinstance(c, (int, float)):
                    kinds.add("number")
                elif c is None:
                    kinds.add("null")
            types = kinds
        elif "type" in schema:
            t = schema["type"]
            types = set(t if isinstance(t, list) else [t])
            if "integer" in types:
                types.add("number")
    m.stack.pop()

    def allow(t):
        return types is None or t in types

    if ch == '"' and allow("string"):
        allowed = _string_allowed(schema)
        pat = (schema.get("pattern")
               if isinstance(schema, dict) and allowed is None else None)
        if pat is not None:
            info = _pattern_info(pat)
            matched0 = (not info.anchored_end
                        and bool(info.start_mask & info.accept_mask))
            m.stack.append(("string_pat", pat, info.start_mask, matched0))
        else:
            m.stack.append(("string_body", allowed, ""))
        return True
    if ch == "{" and allow("object"):
        if exact:
            m.stack.append(("obj_open", schema,
                            fmt.member_ws(_depth(m) + 1), True))
        else:
            m.stack.append(("obj_open", schema))
        return True
    if ch == "[" and allow("array"):
        if exact:
            m.stack.append(("arr_open", schema, 0,
                            fmt.member_ws(_depth(m) + 1), True))
        else:
            m.stack.append(("arr_open", schema, 0))
        return True
    if (ch in DIGITS or ch == "-") and allow("number"):
        bounds = _int_bounds(schema)
        if bounds is not None and not _int_prefix_viable(ch, *bounds):
            return False
        fb = _float_bounds(schema)
        if fb is not None and not _float_prefix_viable(ch, *fb):
            return False
        m.stack.append(("number", schema, ch))
        return True
    if ch == "t" and allow("boolean"):
        m.stack.append(("literal", "rue"))
        return True
    if ch == "f" and allow("boolean"):
        m.stack.append(("literal", "alse"))
        return True
    if ch == "n" and allow("null"):
        m.stack.append(("literal", "ull"))
        return True
    return False


def _h_value(m, ch):
    schema = m.stack[-1][1]
    return _value_start(m, ch, schema)


def _h_string_body(m, ch):
    _, allowed, acc = m.stack[-1]
    if ch == '"':
        if allowed is not None and acc not in allowed:
            return False
        m.stack.pop()
        return True
    if ch == "\\":
        # allowed-set strings match escapes literally only for " \ / (the
        # others map to a placeholder that can never match): refuse the
        # escape entry when no candidate's next char is one of those —
        # otherwise the branch walks into a dead end ('\u' ate 3 more
        # chars before the guaranteed reject; observed as a truncated
        # enum under exact-format generation)
        if allowed is not None and not any(
            len(s) > len(acc) and s[len(acc)] in '"\\/' for s in allowed
        ):
            return False
        m.stack[-1] = ("string_esc", allowed, acc)
        return True
    if ch < " ":  # JSON forbids ALL raw control chars in strings
        return False
    acc2 = acc + ch
    if allowed is not None and not any(s.startswith(acc2) for s in allowed):
        return False
    m.stack[-1] = ("string_body", allowed, acc2)
    return True


def _h_string_esc(m, ch):
    _, allowed, acc = m.stack[-1]
    if ch == "u":
        if allowed is not None:
            return False  # \uXXXX can never literal-match an allowed set
        # \uXXXX: exactly 4 hex digits must follow
        m.stack[-1] = ("string_u", allowed, acc + "￿", 4)
        return True
    if ch in '"\\/bfnrt':
        # escaped char: for allowed-sets only support literal match of the
        # unescaped char for quotes/backslash
        rep = {'"': '"', "\\": "\\", "/": "/"}.get(ch)
        acc2 = acc + (rep if rep is not None else "￿")
        if allowed is not None and not any(s.startswith(acc2) for s in allowed):
            return False
        m.stack[-1] = ("string_body", allowed, acc2)
        return True
    return False


def _h_string_u(m, ch):
    _, allowed, acc, left = m.stack[-1]
    if ch not in "0123456789abcdefABCDEF":
        return False
    if left == 1:
        if allowed is not None and not any(s.startswith(acc) for s in allowed):
            return False
        m.stack[-1] = ("string_body", allowed, acc)
        return True
    m.stack[-1] = ("string_u", allowed, acc, left - 1)
    return True


def _h_string_pat(m, ch):
    _, pat, states, matched = m.stack[-1]
    if ch == '"':
        if not _pat_close_ok(pat, states, matched):
            return False
        m.stack.pop()
        return True
    if ch == "\\":
        # escapes can only produce BMP codepoints (simple escapes or \uXXXX);
        # refuse the escape entirely when none of them can survive the DFA
        if not _pattern_info(pat).range_viable(states, matched, 0, 0xFFFF):
            return False
        m.stack[-1] = ("string_pat_esc", pat, states, matched)
        return True
    if ch < " ":  # JSON forbids raw control chars in strings
        return False
    nf = _pat_frame_after("string_pat", pat, states, matched,
                          _pattern_info(pat), ch)
    if nf is None:
        return False
    m.stack[-1] = nf
    return True


_PAT_ESCAPES = {'"': '"', "\\": "\\", "/": "/", "b": "\b", "f": "\f",
                "n": "\n", "r": "\r", "t": "\t"}


def _h_string_pat_esc(m, ch):
    _, pat, states, matched = m.stack[-1]
    if ch == "u":
        m.stack[-1] = ("string_pat_u", pat, states, matched, "")
        return True
    rep = _PAT_ESCAPES.get(ch)
    if rep is None:
        return False
    nf = _pat_frame_after("string_pat", pat, states, matched,
                          _pattern_info(pat), rep)
    if nf is None:
        return False
    m.stack[-1] = nf
    return True


def _h_string_pat_u(m, ch):
    _, pat, states, matched, hexacc = m.stack[-1]
    if ch not in "0123456789abcdefABCDEF":
        return False
    hexacc += ch
    if len(hexacc) < 4:
        shift = 4 * (4 - len(hexacc))
        lo = int(hexacc, 16) << shift
        if not _pattern_info(pat).range_viable(states, matched, lo,
                                               lo | ((1 << shift) - 1)):
            return False
        m.stack[-1] = ("string_pat_u", pat, states, matched, hexacc)
        return True
    nf = _pat_frame_after("string_pat", pat, states, matched,
                          _pattern_info(pat), chr(int(hexacc, 16)))
    if nf is None:
        return False
    m.stack[-1] = nf
    return True


def _num_ok(schema, acc: str) -> bool:
    if isinstance(schema, dict) and schema.get("type") == "integer" and ("." in acc or "e" in acc or "E" in acc):
        return False
    return True


# -- integer minimum/maximum ---------------------------------------------------
# (xgrammar compiles numeric bounds into its schema grammar; here the number
# frame keeps the accumulated text, so bounds are enforced arithmetically:
# a digit is viable iff SOME suffix lands the value in range, and the number
# may close only when the parsed value is in range. Scope: type "integer" —
# fractional/exponent forms are already rejected for it by _num_ok.)

_KMAX = 40  # appended-digit horizon; bounds beyond 10^40 are treated as open


def _int_bounds(schema):
    """(lo, hi) with None = unbounded, from minimum/maximum and both the
    draft-4 boolean and the 2020-12 numeric exclusive forms; None if the
    schema is not integer-typed or carries no bounds."""
    if not isinstance(schema, dict) or schema.get("type") != "integer":
        return None

    def _num(x, name):
        if isinstance(x, bool) or not isinstance(x, (int, float)):
            raise GrammarError(f"{name} must be a number")
        return x

    lo, hi = schema.get("minimum"), schema.get("maximum")
    elo, ehi = schema.get("exclusiveMinimum"), schema.get("exclusiveMaximum")
    if isinstance(elo, bool):  # draft-4: modifies minimum
        elo = _num(lo, "minimum") if elo and lo is not None else None
        lo = None if elo is not None else lo
    if isinstance(ehi, bool):
        ehi = _num(hi, "maximum") if ehi and hi is not None else None
        hi = None if ehi is not None else hi
    import math

    lo = math.ceil(_num(lo, "minimum")) if lo is not None else None
    hi = math.floor(_num(hi, "maximum")) if hi is not None else None
    if elo is not None:
        e = math.floor(_num(elo, "exclusiveMinimum")) + 1
        lo = e if lo is None else max(lo, e)
    if ehi is not None:
        e = math.ceil(_num(ehi, "exclusiveMaximum")) - 1
        hi = e if hi is None else min(hi, e)
    if lo is None and hi is None:
        return None
    return (lo, hi)


def _int_prefix_viable(acc: str, lo, hi) -> bool:
    """Can `acc` (sign + digits so far) extend by >= 0 digits to an integer
    in [lo, hi]? Leading-zero rule: '0'/'-0' cannot take more digits."""
    if acc == "-":
        return (lo is None or lo <= -1) and (hi is None or hi >= (lo if lo is not None else -(10 ** _KMAX)))
    v = int(acc)
    neg = acc.startswith("-")
    if lo is None or lo <= v:
        if hi is None or v <= hi:
            return True  # the prefix itself is in range
    if acc.lstrip("-") == "0":
        return False  # cannot extend; k=0 failed above
    mag = abs(v)
    p = 1
    for _ in range(_KMAX):
        p *= 10
        if neg:
            a, b = -(mag * p + p - 1), -mag * p
        else:
            a, b = mag * p, mag * p + p - 1
        if (lo is None or lo <= b) and (hi is None or a <= hi):
            return True
        # monotone: positives grow, negatives sink — stop when past range
        if not neg and hi is not None and a > hi:
            return False
        if neg and lo is not None and b < lo:
            return False
    return False


def _int_close_ok(schema, acc: str) -> bool:
    bounds = _int_bounds(schema)
    if bounds is None:
        return True
    lo, hi = bounds
    v = int(acc)
    return (lo is None or lo <= v) and (hi is None or v <= hi)


# -- number (fractional) minimum/maximum --------------------------------------
# (VERDICT r4 #6: number-typed bounds were annotations. Enforced by the same
# digit-viability arithmetic the integer path uses, extended to fractions:
# appending fraction digits to a parsed value v with f fraction digits keeps
# it in [v, v + 10^-f) for positives (mirrored for negatives), and k appended
# integer digits land in [m*10^k, (m+1)*10^k). Exponent forms are masked off
# whenever fractional bounds are present — their reachable set is unbounded
# in both directions, which would make every digit viable forever.)


def _float_bounds(schema):
    """(lo, hi, lo_excl, hi_excl) for a number-typed (non-integer) schema
    with bounds; None otherwise. Floats; exclusivity per draft-4 booleans
    and 2020-12 numeric forms."""
    if not isinstance(schema, dict):
        return None
    t = schema.get("type")
    if t is None:
        return None
    types = set(t if isinstance(t, list) else [t])
    if "number" not in types or "integer" in types:
        return None

    def _num(x, name):
        if isinstance(x, bool) or not isinstance(x, (int, float)):
            raise GrammarError(f"{name} must be a number")
        return float(x)

    lo, hi = schema.get("minimum"), schema.get("maximum")
    elo, ehi = schema.get("exclusiveMinimum"), schema.get("exclusiveMaximum")
    lo_x = hi_x = False
    if isinstance(elo, bool):  # draft-4: modifies minimum
        lo_x, elo = elo and lo is not None, None
    if isinstance(ehi, bool):
        hi_x, ehi = ehi and hi is not None, None
    lo = _num(lo, "minimum") if lo is not None else None
    hi = _num(hi, "maximum") if hi is not None else None
    if elo is not None:
        e = _num(elo, "exclusiveMinimum")
        if lo is None or e >= lo:
            lo, lo_x = e, True
    if ehi is not None:
        e = _num(ehi, "exclusiveMaximum")
        if hi is None or e <= hi:
            hi, hi_x = e, True
    if lo is None and hi is None:
        return None
    return (lo, hi, lo_x, hi_x)


def _float_prefix_viable(acc: str, lo, hi, lo_x, hi_x) -> bool:
    """Can `acc` (sign, digits, optional '.', fraction digits — no exponent)
    extend by >= 0 characters to a number in range?"""

    def isect(a, b, a_open=False, b_open=True) -> bool:
        # reachable interval {a..b} vs the bounds
        if lo is not None and (b < lo or (b == lo and (b_open or lo_x))):
            return False
        if hi is not None and (a > hi or (a == hi and (a_open or hi_x))):
            return False
        return True

    if acc == "-":
        return isect(-1e308, 0.0, b_open=False)
    neg = acc.startswith("-")
    body = acc.lstrip("-")
    if "." in body:
        ip, fp = body.split(".")
        v = float(body) if fp else float(ip)
        step = 10.0 ** -len(fp) if fp else 1.0
        if neg:
            return isect(-(v + step), -v, a_open=True, b_open=False)
        return isect(v, v + step)
    v = int(body)
    if neg:
        if isect(-(v + 1.0), -float(v), a_open=True, b_open=False):
            return True
    elif isect(float(v), v + 1.0):
        return True
    if v == 0:
        return False  # leading-zero rule: only '.' may follow
    p = 1.0
    for _ in range(_KMAX):
        p *= 10.0
        a, b = v * p, (v + 1) * p
        if neg:
            ok = isect(-b, -a, a_open=True, b_open=False)
        else:
            ok = isect(a, b)
        if ok:
            return True
        if not neg and hi is not None and a > hi:
            return False
        if neg and lo is not None and -b < lo:
            return False
    return False


def _float_close_ok(acc: str, lo, hi, lo_x, hi_x) -> bool:
    v = float(acc)
    if lo is not None and (v < lo or (v == lo and lo_x)):
        return False
    if hi is not None and (v > hi or (v == hi and hi_x)):
        return False
    return True


def _num_prefix_ok(acc: str) -> bool:
    """acc extends to SOME valid JSON number: -?(0|[1-9]d*)(.d+)?([eE][+-]?d+)?
    Positional checks matter — accepting a misplaced sign/exponent ('1-',
    '1e5e') walks the matcher into a dead state the sampling mask can never
    terminate (digits stay viable forever, terminators never do)."""
    i, n = 0, len(acc)
    if i < n and acc[i] == "-":
        i += 1
    if i == n:
        return True
    if acc[i] == "0":
        i += 1
    elif acc[i].isdigit():
        while i < n and acc[i].isdigit():
            i += 1
    else:
        return False
    if i == n:
        return True
    if acc[i] == ".":
        i += 1
        start = i
        while i < n and acc[i].isdigit():
            i += 1
        if i == n:
            return True
        if i == start:
            return False  # '.e', '.+': no fraction digits yet
    if acc[i] in "eE":
        i += 1
        if i == n:
            return True
        if acc[i] in "+-":
            i += 1
        while i < n and acc[i].isdigit():
            i += 1
        return i == n
    return False


def _h_number(m, ch):
    _, schema, acc = m.stack[-1]
    if ch in DIGITS or ch in ".eE+-":
        acc2 = acc + ch
        if not _num_prefix_ok(acc2) or not _num_ok(schema, acc2):
            return False
        bounds = _int_bounds(schema)
        if bounds is not None and not _int_prefix_viable(acc2, *bounds):
            return False
        fb = _float_bounds(schema)
        if fb is not None:
            if ch in "eE":
                return False  # exponent reach is unbounded under bounds
            if not _float_prefix_viable(acc2, *fb):
                return False
        m.stack[-1] = ("number", schema, acc2)
        return True
    # number ended; re-dispatch ch to parent. Prefix validity is enforced
    # per char, so completeness == ends in a digit (plus numeric bounds).
    if not acc or not acc[-1].isdigit():
        return False
    if not _int_close_ok(schema, acc):
        return False
    fb = _float_bounds(schema)
    if fb is not None and not _float_close_ok(acc, *fb):
        return False
    m.stack.pop()
    return m.advance(ch)


def _h_literal(m, ch):
    _, rest = m.stack[-1]
    if rest and ch == rest[0]:
        if len(rest) == 1:
            m.stack.pop()
        else:
            m.stack[-1] = ("literal", rest[1:])
        return True
    return False


def _props(schema):
    if isinstance(schema, dict):
        return schema.get("properties")
    return None


def _additional(schema, fmt=None) -> bool:
    if not isinstance(schema, dict):
        return True
    # strict_mode (ref grammar/config.rs strict_mode; xgrammar semantics):
    # strict (default) keeps objects closed unless the schema opts out;
    # non-strict flips the default open
    default = not (fmt is None or fmt.strict)
    return bool(schema.get("additionalProperties", default))


def _h_obj_key_body(m, ch):
    _, schema, seen, allowed, acc = m.stack[-1]
    if ch == '"':
        if allowed is not None and acc not in allowed:
            return False
        if acc in seen:
            return False
        m.stack[-1] = ("obj_value_colon", schema, seen, acc)
        return True
    if ch == "\\":
        return False  # escaped keys unsupported in schema mode
    acc2 = acc + ch
    if allowed is not None and not any(s.startswith(acc2) for s in allowed):
        return False
    m.stack[-1] = ("obj_key_body", schema, seen, allowed, acc2)
    return True


def _obj_close_ok(schema, seen) -> bool:
    if isinstance(schema, dict):
        return not (set(schema.get("required", ())) - set(seen))
    return True


def _h_obj_value_colon(m, ch):
    _, schema, seen, key = m.stack[-1]
    fmt = m.fmt
    exact = fmt is not None and not fmt.any_ws
    if ch in WS:
        return not exact
    if ch == ":":
        props = _props(schema)
        sub = props.get(key) if props else None
        m.stack[-1] = ("obj_next", schema, seen | {key})
        m.stack.append(("value", sub))
        if exact and fmt.key_tail:
            m.stack.append(("literal", fmt.key_tail))
        return True
    return False


def _obj_comma_allowed(m, schema, seen):
    props = _props(schema)
    if props is not None and not _additional(schema, m.fmt):
        remaining = set(props) - seen
        if not remaining:
            return False, None
        return True, remaining
    return True, None


def _h_obj_next(m, ch):
    _, schema, seen = m.stack[-1]
    fmt = m.fmt
    exact = fmt is not None and not fmt.any_ws
    if exact:
        d = _depth(m)
        close = fmt.close_ws(d)
        if ch == ",":
            ok, allowed = _obj_comma_allowed(m, schema, seen)
            if not ok:
                return False
            m.stack[-1] = ("obj_key_start", schema, seen, allowed,
                           fmt.item_tail + fmt.member_ws(d))
            return True
        if close:
            # entering the close-ws walk commits to '}': gate on required
            # keys NOW or the branch walks into a dead end the mask can
            # never terminate
            if ch != close[0] or not _obj_close_ok(schema, seen):
                return False
            m.stack[-1] = ("obj_close_ws", schema, seen, close[1:])
            return True
        if ch == "}" and _obj_close_ok(schema, seen):
            m.stack.pop()
            return True
        return False
    if ch in WS:
        return True
    if ch == "}":
        if not _obj_close_ok(schema, seen):
            return False
        m.stack.pop()
        return True
    if ch == ",":
        ok, allowed = _obj_comma_allowed(m, schema, seen)
        if not ok:
            return False
        m.stack[-1] = ("obj_key_start", schema, seen, allowed)
        return True
    return False


def _h_obj_close_ws(m, ch):
    _, schema, seen, rest = m.stack[-1]
    if rest:
        if ch != rest[0]:
            return False
        m.stack[-1] = ("obj_close_ws", schema, seen, rest[1:])
        return True
    if ch == "}" and _obj_close_ok(schema, seen):
        m.stack.pop()
        return True
    return False


def _h_obj_key_start(m, ch):
    frame = m.stack[-1]
    if len(frame) == 5:  # exact-format: pending whitespace before the key
        _, schema, seen, allowed, pending = frame
        if pending:
            if ch != pending[0]:
                return False
            m.stack[-1] = ("obj_key_start", schema, seen, allowed, pending[1:])
            return True
        if ch == '"':
            m.stack[-1] = ("obj_key_body", schema, seen, allowed, "")
            return True
        return False
    _, schema, seen, allowed = frame
    if ch in WS:
        return True
    if ch == '"':
        m.stack[-1] = ("obj_key_body", schema, seen, allowed, "")
        return True
    return False


def _h_arr_open(m, ch):
    frame = m.stack[-1]
    if len(frame) == 5:  # exact-format
        _, schema, n, pending, virgin = frame
        if ch == "]":
            if not virgin:
                return False
            if isinstance(schema, dict) and n < schema.get("minItems", 0):
                return False
            m.stack.pop()
            return True
        if pending:
            if ch != pending[0]:
                return False
            m.stack[-1] = ("arr_open", schema, n, pending[1:], False)
            return True
        items = schema.get("items") if isinstance(schema, dict) else None
        m.stack[-1] = ("arr_next", schema, n + 1)
        m.stack.append(("value", items))
        return m.advance(ch)
    _, schema, n = frame
    if ch in WS:
        return True
    if ch == "]":
        if isinstance(schema, dict) and n < schema.get("minItems", 0):
            return False
        m.stack.pop()
        return True
    items = schema.get("items") if isinstance(schema, dict) else None
    m.stack[-1] = ("arr_next", schema, n + 1)
    m.stack.append(("value", items))
    return m.advance(ch)  # re-dispatch ch as the first value character


def _h_arr_next(m, ch):
    _, schema, n = m.stack[-1]
    fmt = m.fmt
    exact = fmt is not None and not fmt.any_ws
    if exact:
        d = _depth(m)
        close = fmt.close_ws(d)
        if ch == ",":
            if isinstance(schema, dict) and "maxItems" in schema and n >= schema["maxItems"]:
                return False
            items = schema.get("items") if isinstance(schema, dict) else None
            m.stack[-1] = ("arr_next", schema, n + 1)
            m.stack.append(("value", items))
            lit = fmt.item_tail + fmt.member_ws(d)
            if lit:
                m.stack.append(("literal", lit))
            return True
        if close:
            if ch != close[0]:
                return False
            if isinstance(schema, dict) and n < schema.get("minItems", 0):
                return False  # committing to ']' must be legal now
            m.stack[-1] = ("arr_close_ws", schema, n, close[1:])
            return True
        if ch == "]":
            if isinstance(schema, dict) and n < schema.get("minItems", 0):
                return False
            m.stack.pop()
            return True
        return False
    if ch in WS:
        return True
    if ch == "]":
        if isinstance(schema, dict) and n < schema.get("minItems", 0):
            return False
        m.stack.pop()
        return True
    if ch == ",":
        if isinstance(schema, dict) and "maxItems" in schema and n >= schema["maxItems"]:
            return False
        items = schema.get("items") if isinstance(schema, dict) else None
        m.stack[-1] = ("arr_next", schema, n + 1)
        m.stack.append(("value", items))
        return True
    return False


def _h_arr_close_ws(m, ch):
    _, schema, n, rest = m.stack[-1]
    if rest:
        if ch != rest[0]:
            return False
        m.stack[-1] = ("arr_close_ws", schema, n, rest[1:])
        return True
    if ch == "]":
        if isinstance(schema, dict) and n < schema.get("minItems", 0):
            return False
        m.stack.pop()
        return True
    return False


def _h_obj_open(m, ch):
    frame = m.stack[-1]
    if len(frame) == 4:  # exact-format
        _, schema, pending, virgin = frame
        if ch == "}":
            if not virgin:
                return False
            if isinstance(schema, dict) and schema.get("required"):
                return False
            m.stack.pop()
            return True
        if pending:
            if ch != pending[0]:
                return False
            m.stack[-1] = ("obj_open", schema, pending[1:], False)
            return True
        if ch == '"':
            props = _props(schema)
            allowed = (set(props) if props is not None
                       and not _additional(schema, m.fmt) else None)
            m.stack[-1] = ("obj_key_body", schema, frozenset(), allowed, "")
            return True
        return False
    _, schema = frame
    if ch in WS:
        return True
    if ch == "}":
        if isinstance(schema, dict) and schema.get("required"):
            return False
        m.stack.pop()
        return True
    if ch == '"':
        props = _props(schema)
        allowed = (set(props) if props is not None
                   and not _additional(schema, m.fmt) else None)
        m.stack[-1] = ("obj_key_body", schema, frozenset(), allowed, "")
        return True
    return False


_HANDLERS = {
    "value": _h_value,
    "string_body": _h_string_body,
    "string_esc": _h_string_esc,
    "string_u": _h_string_u,
    "string_pat": _h_string_pat,
    "string_pat_esc": _h_string_pat_esc,
    "string_pat_u": _h_string_pat_u,
    "number": _h_number,
    "literal": _h_literal,
    "obj_open": _h_obj_open,
    "obj_key_body": _h_obj_key_body,
    "obj_value_colon": _h_obj_value_colon,
    "obj_next": _h_obj_next,
    "obj_key_start": _h_obj_key_start,
    "obj_close_ws": _h_obj_close_ws,
    "arr_open": _h_arr_open,
    "arr_next": _h_arr_next,
    "arr_close_ws": _h_arr_close_ws,
}


# -- token mask --------------------------------------------------------------


class TokenMaskCache:
    """Per-matcher-state token bitmask (xgrammar adaptive cache role)."""

    def __init__(self, token_strings: list[Optional[str]]):
        self.token_strings = token_strings
        self.cache: dict[tuple, np.ndarray] = {}

    def mask(self, matcher: JsonMatcher) -> np.ndarray:
        sig = matcher.signature()
        hit = self.cache.get(sig)
        if hit is not None:
            return hit
        v = len(self.token_strings)
        out = np.zeros(v, bool)
        for i, s in enumerate(self.token_strings):
            if not s:
                continue
            if matcher.accepts_text(s):
                out[i] = True
        self.cache[sig] = out
        return out


class GrammarSession:
    """Drives a matcher over generated tokens; supplies sampling bitmasks.

    `stop_when_complete`: once the JSON value closes, only stop tokens are
    allowed (the mask keeps stop ids enabled throughout if provided).
    """

    def __init__(self, tokenizer, schema: Optional[dict] = None,
                 stop_token_ids=(), trigger: str | None = None,
                 backend: str = "auto", regex: str | None = None,
                 any_whitespace: bool = True, indent: int | None = None,
                 separators: tuple | None = None, strict_mode: bool = True):
        """Exactly one constraint kind: a JSON `schema` (None = any JSON) or
        a `regex` pattern (reference Grammar::Regex, grammar/mod.rs:65-68).
        any_whitespace/indent/separators/strict_mode mirror the reference's
        JSON grammar config (grammar/config.rs:5-12) — see _Fmt."""
        self.tokenizer = tokenizer
        self.fmt = _Fmt(any_whitespace=any_whitespace, indent=indent,
                        separators=separators, strict_mode=strict_mode)
        if self.fmt.default:
            self.fmt = None
        if self.fmt is not None and regex is not None:
            raise GrammarError("formatting knobs apply to JSON grammars only")
        # per-tokenizer cache: a server builds one session per constrained
        # request, and the vocab-wide decode loop dominates construction
        strings = getattr(tokenizer, "_grammar_token_strings", None)
        if strings is None:
            strings = []
            specials = tokenizer.special_token_strings
            for i in range(tokenizer.vocab_size):
                t = tokenizer.id_to_token(i)
                if t is None or t in specials:
                    strings.append(None)
                    continue
                strings.append(tokenizer.decode([i]))
            try:
                tokenizer._grammar_token_strings = strings
            except AttributeError:
                pass
        self.token_strings = strings
        self.schema = schema
        self.regex = regex
        self.stop_token_ids = list(stop_token_ids)
        self.trigger = trigger
        self.engaged = trigger is None
        self._text_tail = ""

        # backend select: the C++ engines (native/grammar.cpp, regex_dfa.cpp)
        # compute vocabulary masks ~100x faster; the Python matchers are the
        # semantic reference and cover schema features outside the flattened
        # subset.
        self.native = None
        self.mask_cache = None
        self.matcher = None
        if regex is not None:
            if schema is not None:
                raise GrammarError("schema and regex are mutually exclusive")
            from .regex import RegexDFA, RegexMatcher, RegexTokenMasks

            dfa = RegexDFA(regex)
            # the numpy walk only where it is asked for: a failed native
            # build raises
            self.mask_cache = RegexTokenMasks(dfa, strings, native=backend != "python")
            self.matcher = RegexMatcher(dfa)
            return
        if backend in ("auto", "native"):
            from .native_backend import NativeGrammar, SchemaUnsupported

            try:
                self.native = NativeGrammar(schema, strings, fmt=self.fmt)
            except (SchemaUnsupported, GrammarError):
                # outside the flattened subset: the Python matcher serves it
                if backend == "native":
                    raise
        if self.native is None:
            self.mask_cache = TokenMaskCache(strings)
            self.matcher = JsonMatcher(schema, fmt=self.fmt)

    @property
    def backend(self) -> str:
        if self.regex is not None:
            return self.mask_cache.backend
        return "native" if self.native is not None else "python"

    def reset(self):
        if self.native is not None:
            self.native.reset()
        elif self.regex is not None:
            from .regex import RegexMatcher

            self.matcher = RegexMatcher(self.matcher.dfa)
        else:
            self.matcher = JsonMatcher(self.schema, fmt=self.fmt)
        self.engaged = self.trigger is None
        self._text_tail = ""

    def _is_complete(self) -> bool:
        return self.native.is_complete() if self.native is not None else self.matcher.is_complete()

    def current_mask(self) -> Optional[np.ndarray]:
        if not self.engaged:
            return None
        if self.native is not None:
            m = self.native.mask()
        else:
            m = self.mask_cache.mask(self.matcher).copy()
        complete = self._is_complete()
        if complete and self.regex is None:
            # a closed JSON value admits only trailing whitespace — force
            # termination. A regex accepting state may still extend (e.g.
            # [a-z]+): keep viable continuations AND allow stopping.
            m[:] = False
        if complete:
            for sid in self.stop_token_ids:
                m[sid] = True
        if not m.any():
            # dead end: allow stop tokens so generation can terminate
            for sid in self.stop_token_ids:
                m[sid] = True
        return m

    def lookahead_masks(self, draft_tokens) -> list:
        """Masks for verifying a speculative draft chain: entry i is the
        sampling mask after the current state has additionally observed
        draft_tokens[:i] (entry 0 = current mask). Truncates at the first
        draft token the grammar forbids — verification rows beyond it can
        never be accepted (the masked sample at the truncation row differs
        from the draft by construction). State is restored afterwards.
        Reference: per-trie-node bitmask fill, stream.rs:632-675."""
        out = [self.current_mask()]
        if not draft_tokens:
            return out
        snap = None
        if self.native is not None:
            snap = self.native.save()
        else:
            saved_matcher = self.matcher.clone()
        saved_engaged = self.engaged
        saved_tail = self._text_tail
        try:
            for t in draft_tokens:
                m = out[-1]
                if m is not None and not m[int(t)]:
                    break
                self.observe(int(t))
                out.append(self.current_mask())
        finally:
            if self.native is not None:
                self.native.restore(snap)
                self.native.snapshot_free(snap)
            else:
                self.matcher = saved_matcher
            self.engaged = saved_engaged
            self._text_tail = saved_tail
        return out

    def observe(self, token_id: int) -> None:
        # ids past the tokenizer vocab (models pad vocab_size up) carry no
        # text — the unengaged all-ones mask can legally sample them
        text = (self.token_strings[token_id]
                if 0 <= token_id < len(self.token_strings) else None)
        if not self.engaged:
            if self.trigger is not None:
                tok = self.tokenizer.id_to_token(token_id)
                combined = self._text_tail + (text or "")
                if tok == self.trigger or (text and self.trigger in combined):
                    self.engaged = True
                    # text AFTER the trigger in the same token belongs to
                    # the constrained body — dropping it desynchronizes the
                    # matcher from the emitted text
                    rest = ""
                    if text and self.trigger in combined:
                        rest = combined.split(self.trigger, 1)[1]
                    self._text_tail = ""
                    if rest:
                        self.observe_text(rest)
                else:
                    self._text_tail = combined[-len(self.trigger):]
            return
        if text:
            self.observe_text(text)

    def observe_text(self, text: str) -> None:
        if self.native is not None:
            self.native.feed_text(text)
        else:
            self.matcher.feed_text(text)
