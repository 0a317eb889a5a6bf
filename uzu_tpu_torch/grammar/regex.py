"""Regex-constrained decoding: pattern -> char-class DFA -> token bitmasks.

The port's copy of `uzu_tpu/grammar/regex.py`; the native mask walk
(`native/regex_dfa.cpp`) is built at first use and a failed build raises.

Reference counterpart: crates/backend-uzu/src/engine/language_model/grammar/
mod.rs:65-68 (Grammar::Regex compiled through xgrammar into a matcher that
fills per-step token bitmasks). This is a from-scratch implementation built
for the mask workload:

- the pattern parses to an AST, Thompson-constructs an NFA with
  predicate-labelled edges, and subset-constructs a DFA eagerly;
- the alphabet is partitioned into CHARACTER EQUIVALENCE CLASSES (two chars
  that satisfy exactly the same set of edge predicates are
  indistinguishable), so the DFA table is [n_states, n_classes] int32 —
  unicode-safe without a 256-way byte table, and tiny;
- every token string pre-compiles to a class-id sequence ONCE, after which
  a mask computation is an integer table walk per token, and masks cache
  per DFA state (there are at most n_states distinct masks for the whole
  generation — the adaptive-cache property xgrammar gets from its
  persistent matcher states falls out of determinization here).

Matching is ANCHORED at both ends (xgrammar semantics): the constrained
output must be one complete match of the pattern.

Supported syntax: literals, '.', escapes (\\d \\D \\w \\W \\s \\S \\n \\t
\\r \\\\ and escaped metachars), classes [...] with ranges and negation,
groups (...) / (?:...), alternation '|', quantifiers * + ? {m} {m,} {m,n}
(greedy; laziness is irrelevant to the accepted language).
"""

from __future__ import annotations

import numpy as np

from .matcher import GrammarError


class RegexError(GrammarError):
    pass


# -- predicates --------------------------------------------------------------
# An edge predicate is (negated, chars frozenset, ranges tuple of (lo, hi)).
# DOT is the special "any char except newline" predicate.

_D = frozenset("0123456789")
_W = frozenset(
    "abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789_"
)
_S = frozenset(" \t\n\r\f\v")


def _pred_accepts(pred, ch: str) -> bool:
    neg, chars, ranges = pred
    hit = ch in chars or any(lo <= ch <= hi for lo, hi in ranges)
    return hit != neg


def _single(ch: str):
    return (False, frozenset((ch,)), ())


DOT = (True, frozenset("\n"), ())


# -- parser (recursive descent over the usual precedence) --------------------


class _Parser:
    def __init__(self, pattern: str):
        self.p = pattern
        self.i = 0

    def peek(self):
        return self.p[self.i] if self.i < len(self.p) else None

    def take(self):
        ch = self.p[self.i]
        self.i += 1
        return ch

    def parse(self):
        node = self.alternation()
        if self.i != len(self.p):
            raise RegexError(f"unexpected '{self.p[self.i]}' at {self.i}")
        return node

    def alternation(self):
        branches = [self.concat()]
        while self.peek() == "|":
            self.take()
            branches.append(self.concat())
        return ("alt", branches) if len(branches) > 1 else branches[0]

    def concat(self):
        parts = []
        while self.peek() is not None and self.peek() not in "|)":
            parts.append(self.quantified())
        if not parts:
            return ("empty",)
        return ("cat", parts) if len(parts) > 1 else parts[0]

    def quantified(self):
        node = self.atom()
        while True:
            ch = self.peek()
            if ch == "*":
                self.take()
                node = ("rep", node, 0, None)
            elif ch == "+":
                self.take()
                node = ("rep", node, 1, None)
            elif ch == "?":
                self.take()
                node = ("rep", node, 0, 1)
            elif ch == "{":
                save = self.i
                bound = self._try_bound()
                if bound is None:
                    self.i = save
                    break
                node = ("rep", node, bound[0], bound[1])
            else:
                break
            # lazy modifiers don't change the accepted language
            if self.peek() == "?":
                self.take()
        return node

    def _try_bound(self):
        # at '{'; returns (min, max|None) or None if not a bound
        self.take()
        lo = ""
        while self.peek() is not None and self.peek().isdigit():
            lo += self.take()
        if not lo:
            return None
        if self.peek() == "}":
            self.take()
            return (int(lo), int(lo))
        if self.peek() != ",":
            return None
        self.take()
        hi = ""
        while self.peek() is not None and self.peek().isdigit():
            hi += self.take()
        if self.peek() != "}":
            return None
        self.take()
        if hi and int(hi) < int(lo):
            raise RegexError(f"bad bound {{{lo},{hi}}}")
        return (int(lo), int(hi) if hi else None)

    def atom(self):
        ch = self.peek()
        if ch is None:
            raise RegexError("unexpected end of pattern")
        if ch == "(":
            self.take()
            if self.peek() == "?":
                self.take()
                ch2 = self.peek()
                if ch2 == ":":
                    self.take()
                else:
                    raise RegexError(f"unsupported group (?{ch2}")
            node = self.alternation()
            if self.peek() != ")":
                raise RegexError("unbalanced '('")
            self.take()
            return node
        if ch == "[":
            return ("pred", self._char_class())
        if ch == ".":
            self.take()
            return ("pred", DOT)
        if ch == "\\":
            return ("pred", self._escape())
        if ch in "*+?{":
            raise RegexError(f"dangling quantifier '{ch}' at {self.i}")
        if ch in ")|":
            raise RegexError(f"unexpected '{ch}' at {self.i}")
        if ch in "^$":
            # patterns are implicitly anchored; explicit anchors at the
            # edges are accepted as no-ops for convenience
            self.take()
            return ("empty",)
        self.take()
        return ("pred", _single(ch))

    def _escape(self):
        self.take()  # backslash
        ch = self.peek()
        if ch is None:
            raise RegexError("trailing backslash")
        self.take()
        table = {
            "d": (False, _D, ()),
            "D": (True, _D, ()),
            "w": (False, _W, ()),
            "W": (True, _W, ()),
            "s": (False, _S, ()),
            "S": (True, _S, ()),
            "n": _single("\n"),
            "t": _single("\t"),
            "r": _single("\r"),
            "f": _single("\f"),
            "v": _single("\v"),
            "0": _single("\0"),
        }
        if ch in table:
            return table[ch]
        if ch == "x":
            hexs = ""
            for _ in range(2):
                nxt = self.peek()
                if nxt is None or nxt not in "0123456789abcdefABCDEF":
                    raise RegexError("bad \\x escape")
                hexs += self.take()
            return _single(chr(int(hexs, 16)))
        return _single(ch)  # escaped literal (incl. metachars)

    def _char_class(self):
        self.take()  # '['
        neg = False
        if self.peek() == "^":
            neg = True
            self.take()
        chars: set[str] = set()
        ranges: list[tuple[str, str]] = []
        first = True
        while True:
            ch = self.peek()
            if ch is None:
                raise RegexError("unbalanced '['")
            if ch == "]" and not first:
                self.take()
                break
            first = False
            if ch == "\\":
                p = self._escape()
                pneg, pchars, pranges = p
                if pneg:
                    # \D etc. inside a class: fold via ranges is messy;
                    # support the common ones by complement sets
                    raise RegexError(
                        "negated escapes inside [...] are unsupported"
                    )
                chars |= set(pchars)
                ranges += list(pranges)
                lo = None
            else:
                self.take()
                lo = ch
                chars.add(ch)
            if lo is not None and self.peek() == "-":
                # range, unless '-' is last
                if self.i + 1 < len(self.p) and self.p[self.i + 1] != "]":
                    self.take()
                    hi = self.take()
                    if hi == "\\":
                        hp = self._escape()
                        if hp[0] or len(hp[1]) != 1:
                            raise RegexError("bad range end")
                        (hi,) = hp[1]
                    if hi < lo:
                        raise RegexError(f"bad range {lo}-{hi}")
                    chars.discard(lo)
                    ranges.append((lo, hi))
        return (neg, frozenset(chars), tuple(ranges))


# -- Thompson NFA ------------------------------------------------------------


class _NFA:
    def __init__(self):
        self.eps: list[list[int]] = []
        self.edges: list[list[tuple[tuple, int]]] = []  # (pred, dst)

    def state(self) -> int:
        self.eps.append([])
        self.edges.append([])
        return len(self.eps) - 1

    def build(self, node, src: int, dst: int) -> None:
        kind = node[0]
        if kind == "empty":
            self.eps[src].append(dst)
        elif kind == "pred":
            self.edges[src].append((node[1], dst))
        elif kind == "cat":
            cur = src
            for part in node[1][:-1]:
                mid = self.state()
                self.build(part, cur, mid)
                cur = mid
            self.build(node[1][-1], cur, dst)
        elif kind == "alt":
            for br in node[1]:
                self.build(br, src, dst)
        elif kind == "rep":
            _, inner, lo, hi = node
            cur = src
            for _ in range(lo):
                mid = self.state()
                self.build(inner, cur, mid)
                cur = mid
            if hi is None:  # unbounded tail: loop
                loop = self.state()
                self.eps[cur].append(loop)
                self.build(inner, loop, loop)
                self.eps[loop].append(dst)
            else:
                self.eps[cur].append(dst)
                for _ in range(hi - lo):
                    mid = self.state()
                    self.build(inner, cur, mid)
                    self.eps[mid].append(dst)
                    cur = mid
        else:  # pragma: no cover
            raise RegexError(f"bad node {kind}")


def _closure(nfa: _NFA, states: frozenset) -> frozenset:
    seen = set(states)
    stack = list(states)
    while stack:
        s = stack.pop()
        for t in nfa.eps[s]:
            if t not in seen:
                seen.add(t)
                stack.append(t)
    return frozenset(seen)


# -- DFA over character equivalence classes ----------------------------------


class RegexDFA:
    """table [n_states, n_classes] int32 (-1 dead), accept [n_states] bool;
    `class_of(ch)` maps any char to its equivalence class via the atomic
    interval partition of the predicates (memoized in `classes`)."""

    def __init__(self, pattern: str, extra_chars=()):
        self.pattern = pattern
        ast = _Parser(pattern).parse()
        nfa = _NFA()
        start = nfa.state()
        end = nfa.state()
        nfa.build(ast, start, end)

        preds = []
        seen_preds = set()
        for es in nfa.edges:
            for pred, _ in es:
                if pred not in seen_preds:
                    seen_preds.add(pred)
                    preds.append(pred)

        # EXACT classification via interval partitioning: predicates only
        # distinguish characters at their literal chars and range endpoints,
        # so the codepoint space splits into atomic intervals on which every
        # predicate is constant. Classifying one representative per interval
        # realizes every reachable signature — unlike the old mentioned-set
        # sampling, which misclassified the interior of ranges wider than
        # 512 code points into the catch-all class (a CJK class like
        # [\u4e00-\u9fff] masked almost every in-range token as invalid).
        pred_index = {p: i for i, p in enumerate(preds)}
        sig_to_class: dict[tuple, int] = {}
        self.classes: dict[str, int] = {}  # memo cache over class_of()
        pred_sets: list[frozenset] = []  # class id -> predicate ids it satisfies

        def class_of_sig(sig):
            cid = sig_to_class.get(sig)
            if cid is None:
                cid = len(pred_sets)
                sig_to_class[sig] = cid
                pred_sets.append(
                    frozenset(i for i, hit in enumerate(sig) if hit)
                )
            return cid

        bounds = {0, 0x110000}
        for neg, chars, ranges in preds:
            for c in chars:
                bounds |= {ord(c), ord(c) + 1}
            for lo, hi in ranges:
                bounds |= {ord(lo), ord(hi) + 1}
        self._bounds = sorted(bounds)
        self._interval_class: list[int] = []
        for b in self._bounds[:-1]:
            sig = tuple(_pred_accepts(p, chr(b)) for p in preds)
            self._interval_class.append(class_of_sig(sig))
        for ch in extra_chars or ():
            self.class_of(ch)  # warm the memo for caller-known chars
        n_classes = len(pred_sets)

        # subset construction (processed in discovery order, so `rows`
        # stays index-aligned with `order`)
        start_set = _closure(nfa, frozenset((start,)))
        index = {start_set: 0}
        order = [start_set]
        rows: list[np.ndarray] = []
        i = 0
        while i < len(order):
            cur = order[i]
            i += 1
            row = np.full(n_classes, -1, np.int32)
            for cid, sat in enumerate(pred_sets):
                nxt = {
                    dst
                    for s in cur
                    for pred, dst in nfa.edges[s]
                    if pred_index[pred] in sat
                }
                if nxt:
                    ns = _closure(nfa, frozenset(nxt))
                    j = index.get(ns)
                    if j is None:
                        j = len(order)
                        index[ns] = j
                        order.append(ns)
                    row[cid] = j
            rows.append(row)
            if len(order) > 50_000:
                raise RegexError("pattern determinizes too large")
        self.table = np.stack(rows).astype(np.int32)
        self.accept = np.array([end in s for s in order], bool)
        self.n_states = len(order)

    def class_of(self, ch: str) -> int:
        cid = self.classes.get(ch)
        if cid is None:
            import bisect

            i = bisect.bisect_right(self._bounds, ord(ch)) - 1
            cid = self._interval_class[min(i, len(self._interval_class) - 1)]
            self.classes[ch] = cid
        return cid

    def encode(self, text: str) -> np.ndarray:
        return np.fromiter(
            (self.class_of(c) for c in text), np.int32, len(text),
        )


class RegexTokenMasks:
    """Per-DFA-state token bitmasks. Token class sequences precompile once;
    a mask is one table walk per token, computed by the native C++ kernel
    (native/regex_dfa.cpp) or a vectorized numpy walk, and cached per state
    (a regex generation can touch at most n_states distinct masks)."""

    def __init__(self, dfa: RegexDFA, token_strings, native: bool = True):
        self.dfa = dfa
        seqs = [dfa.encode(s) if s else np.zeros(0, np.int32)
                for s in token_strings]
        self.valid = np.array([bool(s) for s in token_strings], bool)
        lens = np.array([len(q) for q in seqs], np.int64)
        self.offs = np.zeros(len(seqs) + 1, np.int32)
        np.cumsum(lens, out=self.offs[1:])
        self.cls = (np.concatenate(seqs).astype(np.int32)
                    if seqs else np.zeros(0, np.int32))
        self._seqs = seqs
        self.cache: dict[int, np.ndarray] = {}
        self._walk_table = None
        self._native = self._load_native() if native else None

    def _ensure_numpy(self):
        if self._walk_table is not None:
            return
        dfa = self.dfa
        n_s, n_c = dfa.n_states, dfa.table.shape[1]
        # walk table with a dead row (n_s) and an identity pad class:
        # padded short tokens stay put, dead states absorb
        wt = np.empty((n_s + 1, n_c + 1), np.int32)
        wt[:n_s, :n_c] = np.where(dfa.table < 0, n_s, dfa.table)
        wt[n_s, :] = n_s
        wt[:n_s, n_c] = np.arange(n_s)
        self._walk_table = wt
        lmax = max((len(q) for q in self._seqs), default=0)
        padded = np.full((len(self._seqs), lmax), n_c, np.int32)
        for i, q in enumerate(self._seqs):
            padded[i, : len(q)] = q
        self._padded = padded

    def _load_native(self):
        import ctypes as ct

        from ..native import load

        lib = load("regex_dfa")
        if not getattr(lib, "_rd_configured", False):
            lib.rd_create.restype = ct.c_void_p
            p32 = ct.POINTER(ct.c_int32)
            pu8 = ct.POINTER(ct.c_uint8)
            lib.rd_create.argtypes = [p32, ct.c_int32, ct.c_int32, pu8, p32, p32, ct.c_int32]
            lib.rd_destroy.restype = None
            lib.rd_destroy.argtypes = [ct.c_void_p]
            lib.rd_mask.restype = None
            lib.rd_mask.argtypes = [ct.c_void_p, ct.c_int32, pu8]
            lib._rd_configured = True
        table = np.ascontiguousarray(self.dfa.table, np.int32)
        accept = np.ascontiguousarray(self.dfa.accept, np.uint8)
        self._keep = (table, accept, self.cls, self.offs)
        h = lib.rd_create(
            table.ctypes.data_as(ct.POINTER(ct.c_int32)),
            self.dfa.n_states, table.shape[1],
            accept.ctypes.data_as(ct.POINTER(ct.c_uint8)),
            self.cls.ctypes.data_as(ct.POINTER(ct.c_int32)),
            self.offs.ctypes.data_as(ct.POINTER(ct.c_int32)),
            len(self.valid),
        )
        return (lib, h)

    @property
    def backend(self) -> str:
        return "native" if self._native is not None else "python"

    def mask_for_state(self, state: int) -> np.ndarray:
        hit = self.cache.get(state)
        if hit is not None:
            return hit
        if state < 0:
            out = np.zeros(len(self.valid), bool)
        elif self._native is not None:
            import ctypes

            lib, h = self._native
            buf = np.zeros(len(self.valid), np.uint8)
            lib.rd_mask(h, int(state),
                        buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
            out = buf.astype(bool) & self.valid
        else:
            self._ensure_numpy()
            n_s = self.dfa.n_states
            states = np.full(len(self.valid), state, np.int32)
            for j in range(self._padded.shape[1]):
                states = self._walk_table[states, self._padded[:, j]]
            out = (states != n_s) & self.valid
        self.cache[state] = out
        return out

    def mask(self, matcher: "RegexMatcher") -> np.ndarray:
        return self.mask_for_state(matcher.state)

    def __del__(self):
        if getattr(self, "_native", None) is not None:
            try:
                lib, h = self._native
                lib.rd_destroy(h)
            except Exception:
                pass


class RegexMatcher:
    """JsonMatcher-compatible interface driven by a RegexDFA (state is one
    int; clone/signature are trivial)."""

    def __init__(self, dfa: RegexDFA, state: int = 0):
        self.dfa = dfa
        self.state = state

    def clone(self) -> "RegexMatcher":
        return RegexMatcher(self.dfa, self.state)

    def signature(self) -> tuple:
        return ("re", self.state)

    def advance(self, ch: str) -> bool:
        if self.state < 0:
            return False
        nxt = self.dfa.table[self.state, self.dfa.class_of(ch)]
        if nxt < 0:
            return False
        self.state = int(nxt)
        return True

    def feed_text(self, text: str) -> bool:
        for ch in text:
            if not self.advance(ch):
                return False
        return True

    def accepts_text(self, text: str) -> bool:
        """Can `text` extend the current state (prefix-viable)?"""
        s = self.state
        table = self.dfa.table
        class_of = self.dfa.class_of
        for ch in text:
            if s < 0:
                return False
            s = table[s, class_of(ch)]
            if s < 0:
                return False
        return True

    def is_complete(self) -> bool:
        return self.state >= 0 and bool(self.dfa.accept[self.state])
