"""ctypes binding + schema flattening for the C++ grammar engine
(`uzu_tpu_torch/native/grammar.cpp`, the xgrammar-FFI role).

The port's copy of `uzu_tpu/grammar/native_backend.py`. A schema that uses
features outside the flattenable subset raises `SchemaUnsupported`, and
`GrammarSession` then serves it with the Python matcher; a failed build of
the library raises with the compiler's message (no fallback)."""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np

T_OBJECT, T_ARRAY, T_STRING, T_NUMBER = 1, 2, 4, 8
T_INTEGER_ONLY, T_BOOLEAN, T_NULL, T_ANY = 16, 32, 64, 128

_TYPE_BITS = {
    "object": T_OBJECT,
    "array": T_ARRAY,
    "string": T_STRING,
    "number": T_NUMBER,
    "integer": T_NUMBER | T_INTEGER_ONLY,
    "boolean": T_BOOLEAN,
    "null": T_NULL,
}

_UNSUPPORTED_KEYS = {
    "not", "patternProperties",
    "minLength", "maxLength",
    "prefixItems", "additionalItems", "dependencies", "if", "then", "else",
}
# `format` is handled by _normalize_format (matcher.py): known formats
# rewrite to `pattern` before flattening; unknown ones are annotations.
# minLength/maxLength likewise normalize away; the keys above reach the
# walk only when NOT consumed (e.g. an explicit pattern sibling), and the
# Python matcher serves those schemas instead. Integer minimum/maximum/
# exclusive* flatten into int64 node bounds (matcher._int_bounds does the
# draft-4/float normalization); on non-integer types they are annotations,
# exactly like the Python matcher treats them.

# |bound| above this flattens to SchemaUnsupported: the C++ viability walk
# saturates parsed magnitudes at ~4.6e18, which must exceed every bound
_BOUND_CAP = 1 << 61

_EMPTY_NODE = {"type_mask": T_ANY, "items": -1, "min": 0, "max": -1,
               "additional": 1, "props": [], "enum": [], "alts": [],
               "pattern": -1, "bflags": 0, "blo": 0, "bhi": 0}


class SchemaUnsupported(Exception):
    pass


def _flatten_pattern(pattern: str, dfas: list, dfa_ids: dict) -> int:
    """Compile a string `pattern` into a shipped DFA record (see the buffer
    layout in grammar.cpp). The C++ walk steps one DFA transition per
    CODEPOINT (UTF-8 continuation bytes are skipped; non-ASCII lead bytes
    take the catch-all class), so only ASCII patterns flatten — the rest
    fall back to the Python matcher. State sets ride a uint64 bitmask."""
    if pattern in dfa_ids:
        return dfa_ids[pattern]
    if any(ord(c) > 127 for c in pattern):
        raise SchemaUnsupported("non-ASCII pattern")
    from .matcher import GrammarError, _pattern_info

    try:
        info = _pattern_info(pattern)
    except GrammarError as exc:
        raise SchemaUnsupported(str(exc)) from exc
    if info.dfa.n_states > 64:
        raise SchemaUnsupported("pattern DFA > 64 states")
    idx = len(dfas)
    dfa_ids[pattern] = idx
    dfas.append(info)
    return idx


def flatten_schema(schema, strict: bool = True) -> tuple[np.ndarray, list[str], np.ndarray]:
    """Flatten a schema tree into the int32 tables grammar.cpp consumes:
    (node table, string pool, pattern-DFA table). anyOf/oneOf flatten to
    alternative-node lists (the C++ branch set forks on them); local $ref
    flattens to a memoized 1-alt indirection node, so recursive schemas
    terminate. Raises SchemaUnsupported for features only the Python
    matcher handles."""
    from .matcher import (
        GrammarError,
        _alternatives,
        _collect_defs,
        _int_bounds,
        _merge_allof,
        _normalize_format,
        _resolve,
    )

    defs = _collect_defs(schema)
    nodes: list[dict] = []
    strings: list[str] = []
    sids: dict[str, int] = {}
    ref_idx: dict[str, int] = {}
    dfas: list = []
    dfa_ids: dict[str, int] = {}

    def sid(s: str) -> int:
        if s not in sids:
            sids[s] = len(strings)
            strings.append(s)
        return sids[s]

    def walk(s, depth: int = 0) -> int:
        if depth > 64:
            raise SchemaUnsupported("schema nesting too deep")
        if s is None or s is True or s == {}:
            nodes.append(dict(_EMPTY_NODE))
            return len(nodes) - 1
        if not isinstance(s, dict):
            raise SchemaUnsupported(f"schema node {type(s)}")
        s = _normalize_format(s)

        if "$ref" in s:
            extras = {k: v for k, v in s.items() if k != "$ref"}
            from .matcher import _ANNOTATIONS

            if all(k in _ANNOTATIONS for k in extras):
                # pure ref: memoized indirection node (recursion-safe)
                path = s["$ref"]
                if path in ref_idx:
                    return ref_idx[path]
                if path not in defs:
                    raise SchemaUnsupported(f"unresolvable $ref {path}")
                idx = len(nodes)
                nodes.append(dict(_EMPTY_NODE))
                ref_idx[path] = idx
                target = walk(defs[path], depth + 1)
                nodes[idx] = {**_EMPTY_NODE, "alts": [target]}
                return idx
            # ref with constraining siblings: inline one level (recursion
            # through such refs is unsupported; the depth guard catches it)
            try:
                s = _resolve(s, defs)
            except GrammarError as exc:
                raise SchemaUnsupported(str(exc)) from exc

        if isinstance(s, dict) and "allOf" in s:
            # same conservative key-merge the Python matcher applies
            try:
                s = _normalize_format(_merge_allof(s, defs))
            except GrammarError as exc:
                raise SchemaUnsupported(str(exc)) from exc

        alts = _alternatives(s)
        if alts is not None:
            idx = len(nodes)
            nodes.append(dict(_EMPTY_NODE))
            nodes[idx] = {**_EMPTY_NODE,
                          "alts": [walk(a, depth + 1) for a in alts]}
            return idx

        for k in s:
            if k in _UNSUPPORTED_KEYS:
                raise SchemaUnsupported(k)
        idx = len(nodes)
        nodes.append({})  # reserve

        enum_vals = s.get("enum", [s["const"]] if "const" in s else None)
        enum_sids: list[int] = []
        type_mask = 0
        if enum_vals is not None:
            if not all(isinstance(v, str) for v in enum_vals):
                raise SchemaUnsupported("non-string enum")
            enum_sids = [sid(v) for v in enum_vals]
            type_mask = T_STRING
        elif "type" in s:
            t = s["type"]
            for name in (t if isinstance(t, list) else [t]):
                if name not in _TYPE_BITS:
                    raise SchemaUnsupported(f"type {name}")
                type_mask |= _TYPE_BITS[name]
        else:
            type_mask = T_ANY

        pattern = -1
        if "pattern" in s and not enum_sids:
            pattern = _flatten_pattern(s["pattern"], dfas, dfa_ids)

        bflags, blo, bhi = 0, 0, 0
        from .matcher import _float_bounds

        try:
            if _float_bounds(s) is not None:
                # number-typed (fractional) bounds: the C++ walk has no
                # fractional viability arithmetic — the Python matcher
                # serves these (dual-engine invariant: native never takes
                # a schema it cannot enforce)
                raise SchemaUnsupported("number-typed bounds")
            bounds = _int_bounds(s)
        except GrammarError as exc:
            raise SchemaUnsupported(str(exc)) from exc
        if bounds is not None:
            lo, hi = bounds
            for v in (lo, hi):
                if v is not None and abs(v) > _BOUND_CAP:
                    raise SchemaUnsupported("integer bound beyond 2^61")
            if lo is not None:
                bflags, blo = bflags | 1, lo
            if hi is not None:
                bflags, bhi = bflags | 2, hi

        props = []
        if "properties" in s:
            required = set(s.get("required", ()))
            if len(s["properties"]) > 64:
                raise SchemaUnsupported(">64 properties")
            for name, sub in s["properties"].items():
                props.append((sid(name), walk(sub, depth + 1),
                              1 if name in required else 0))
        elif s.get("required"):
            raise SchemaUnsupported("required without properties")

        items = walk(s["items"], depth + 1) if "items" in s else -1
        nodes[idx] = {
            "type_mask": type_mask,
            "items": items,
            "min": int(s.get("minItems", 0)),
            "max": int(s.get("maxItems", -1)),
            "additional": 0 if (props and not s.get("additionalProperties",
                                                     not strict)) else 1,
            "props": props,
            "enum": enum_sids,
            "alts": [],
            "pattern": pattern,
            "bflags": bflags, "blo": blo, "bhi": bhi,
        }
        return idx

    def _i64_halves(v: int) -> list[int]:
        u = v & 0xFFFFFFFFFFFFFFFF
        return [u & 0xFFFFFFFF, (u >> 32) & 0xFFFFFFFF]

    walk(schema)
    buf = [len(nodes)]
    for n in nodes:
        buf += [n["type_mask"], n["items"], n["min"], n["max"], n["additional"],
                len(n["props"]), len(n["enum"]), len(n["alts"]), n["pattern"],
                n["bflags"]]
        buf += _i64_halves(n["blo"]) + _i64_halves(n["bhi"])
        for p in n["props"]:
            buf += list(p)
        buf += n["enum"]
        buf += n["alts"]
    # int64-bound halves are unsigned 32-bit values: wrap to signed int32
    buf = [v - 2**32 if v >= 2**31 else v for v in buf]

    # DFA buffer: n_dfas, then per DFA:
    #   [n_states, n_classes, anchored_start, anchored_end,
    #    accept_lo, accept_hi, default_class]
    #   + 128 byte->class entries
    #   + n_intervals + n_intervals*(start_codepoint, class)  — the atomic
    #     interval partition (RegexDFA._bounds), so the C++ walk resolves
    #     non-ASCII \uXXXX codepoints and escape range-viability EXACTLY
    #     like matcher.py (interval i covers [start_i, start_{i+1}))
    #   + n_states*n_classes transitions
    dbuf = [len(dfas)]
    for info in dfas:
        acc = info.accept_mask
        dbuf += [info.dfa.n_states, info.table.shape[1],
                 int(info.anchored_start), int(info.anchored_end),
                 acc & 0xFFFFFFFF, (acc >> 32) & 0xFFFFFFFF,
                 info.dfa.class_of("\U0010fffd")]
        dbuf += [info.dfa.class_of(chr(b)) for b in range(128)]
        icls = info.dfa._interval_class
        dbuf.append(len(icls))
        for start, cid in zip(info.dfa._bounds[:-1], icls):
            dbuf += [start, cid]
        dbuf += [int(v) for v in info.table.reshape(-1)]
    # accept-mask halves are unsigned 32-bit values: wrap to signed int32
    dbuf = [v - 2**32 if v >= 2**31 else v for v in dbuf]
    return np.asarray(buf, np.int32), strings, np.asarray(dbuf, np.int32)


def _pack_strings(strs: list[str]) -> tuple[bytes, np.ndarray]:
    blob = b""
    offs = [0]
    for s in strs:
        blob += s.encode("utf-8", errors="replace")
        offs.append(len(blob))
    return blob, np.asarray(offs, np.int32)


class NativeGrammar:
    """One matcher instance over a fixed token vocabulary."""

    def __init__(self, schema, token_strings: list[Optional[str]], fmt=None):
        from ..native import load

        lib = load("grammar")
        self._lib = lib
        self._configure(lib)

        strict = fmt.strict if fmt is not None else True
        exact = fmt is not None and not fmt.any_ws
        if schema is None:
            sbuf = np.zeros(0, np.int32)
            strings: list[str] = []
            dbuf = np.zeros(1, np.int32)
        else:
            sbuf, strings, dbuf = flatten_schema(schema, strict=strict)
        str_blob, str_offs = _pack_strings(strings)
        tok_blob, tok_offs = _pack_strings([t or "" for t in token_strings])
        self.n_tokens = len(token_strings)
        # keep buffers alive
        self._keep = (sbuf, str_blob, str_offs, tok_blob, tok_offs, dbuf)
        self._h = lib.ug_create(
            sbuf.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), len(sbuf),
            str_blob, str_offs.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            len(strings),
            tok_blob, tok_offs.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            self.n_tokens,
            dbuf.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), len(dbuf),
        )
        if exact:
            # exact-format mode (any_whitespace=False): indent/separators
            # become literal whitespace requirements inside the C++ walk
            lib.ug_set_fmt(
                ctypes.c_void_p(self._h), 1,
                -1 if fmt.indent is None else fmt.indent,
                fmt.item_tail.encode(), fmt.key_tail.encode())

    @staticmethod
    def _configure(lib):
        if getattr(lib, "_g_configured", False):
            return
        lib.ug_create.restype = ctypes.c_void_p
        lib.ug_create.argtypes = [
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int32,
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_int32), ctypes.c_int32,
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_int32), ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int32,
        ]
        for name in ("ug_reset", "ug_destroy"):
            getattr(lib, name).restype = None
            getattr(lib, name).argtypes = [ctypes.c_void_p]
        lib.ug_set_fmt.restype = None
        lib.ug_set_fmt.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                   ctypes.c_int, ctypes.c_char_p,
                                   ctypes.c_char_p]
        lib.ug_observe.restype = ctypes.c_int
        lib.ug_observe.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.ug_is_complete.restype = ctypes.c_int
        lib.ug_is_complete.argtypes = [ctypes.c_void_p]
        lib.ug_advance_text.restype = ctypes.c_int
        lib.ug_advance_text.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int]
        lib.ug_mask.restype = ctypes.c_int
        lib.ug_mask.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint8)]
        lib.ug_save.restype = ctypes.c_void_p
        lib.ug_save.argtypes = [ctypes.c_void_p]
        lib.ug_restore.restype = None
        lib.ug_restore.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        lib.ug_snapshot_free.restype = None
        lib.ug_snapshot_free.argtypes = [ctypes.c_void_p]
        lib._g_configured = True

    def reset(self):
        self._lib.ug_reset(self._h)

    def observe(self, token_id: int) -> bool:
        return self._lib.ug_observe(self._h, int(token_id)) == 0

    def feed_text(self, text: str) -> bool:
        b = text.encode("utf-8", errors="replace")
        return self._lib.ug_advance_text(self._h, b, len(b)) == 0

    def is_complete(self) -> bool:
        return bool(self._lib.ug_is_complete(self._h))

    def save(self):
        """Opaque state snapshot (speculative-grammar lookahead)."""
        return self._lib.ug_save(self._h)

    def restore(self, snapshot) -> None:
        self._lib.ug_restore(self._h, snapshot)

    def snapshot_free(self, snapshot) -> None:
        self._lib.ug_snapshot_free(snapshot)

    def mask(self) -> np.ndarray:
        out = np.zeros(self.n_tokens, np.uint8)
        self._lib.ug_mask(self._h, out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
        return out.astype(bool)

    def __del__(self):
        try:
            self._lib.ug_destroy(self._h)
        except Exception:
            pass
