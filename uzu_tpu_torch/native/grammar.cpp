// JSON (+schema subset) pushdown matcher with vocabulary mask computation.
//
// The port's copy of uzu_tpu/native/grammar.cpp (the same C ABI). Role
// parity: the reference links xgrammar (C++) for grammar-constrained
// decoding (crates/backend-uzu/src/engine/language_model/grammar/mod.rs);
// this is the native hot path behind uzu_tpu_torch.grammar — the Python
// matcher (uzu_tpu_torch/grammar/matcher.py) is the semantic reference, this
// library computes per-step token bitmasks over large vocabularies fast.
// Semantics are kept in lockstep with matcher.py (tests compare them).
//
// The matcher state is a BRANCH SET (GLR-style): each branch is one
// deterministic frame stack; a value frame whose schema node carries
// alternatives (anyOf/oneOf, or a $ref indirection — both flattened to
// `alts` node lists by native_backend.flatten_schema) forks the branch,
// characters advance every branch and drop rejecting ones, and the token
// mask is the union over branches. String `pattern` constraints ship as
// char-class DFA tables (compiled by grammar/regex.py); the in-string walk
// is an unanchored containment simulation over a uint64 state bitmask,
// honoring edge ^/$ anchors.
//
// Schema is passed pre-flattened from Python as int32 tables + string
// pool, so no JSON parsing happens here.
//
// C ABI only — consumed via ctypes.

#include <cstdint>
#include <cstring>
#include <cstdlib>
#include <cstdio>
#include <string>
#include <unordered_map>
#include <unordered_set>
#include <vector>

namespace {

// type_mask bits
enum : uint32_t {
    T_OBJECT = 1u << 0,
    T_ARRAY = 1u << 1,
    T_STRING = 1u << 2,
    T_NUMBER = 1u << 3,
    T_INTEGER_ONLY = 1u << 4,  // with T_NUMBER: reject '.', 'e'
    T_BOOLEAN = 1u << 5,
    T_NULL = 1u << 6,
    T_ANY = 1u << 7,
};

struct Prop {
    int32_t name_sid;
    int32_t node;
    int32_t required;
};

struct Node {
    uint32_t type_mask = T_ANY;
    int32_t items = -1;     // node index for array items (-1 = any)
    int32_t min_items = 0;
    int32_t max_items = -1; // -1 = unbounded
    int32_t additional = 1; // additionalProperties allowed
    int32_t pattern = -1;   // DFA index for string `pattern` (-1 = none)
    int32_t bflags = 0;     // integer bounds: bit0 = has lo, bit1 = has hi
    int64_t blo = 0, bhi = 0;
    std::vector<Prop> props;
    std::vector<int32_t> enum_sids;  // string enum values
    std::vector<int32_t> alts;       // anyOf/oneOf / $ref indirection
};

struct Dfa {
    int32_t n_states = 0, n_classes = 0;
    bool a_start = false, a_end = false;  // edge ^ / $ anchors
    uint64_t accept = 0;                  // accepting-state bitmask
    int32_t default_class = 0;            // class for non-ASCII codepoints
    int32_t cls[128] = {0};               // byte -> class (ASCII)
    std::vector<int32_t> ibounds;         // atomic interval start codepoints
    std::vector<int32_t> icls;            // interval -> class
    std::vector<int32_t> table;           // [n_states * n_classes], -1 dead
};

enum FrameKind : uint8_t {
    F_VALUE,
    F_STRING_BODY,
    F_STRING_ESC,
    F_NUMBER,
    F_LITERAL,
    F_OBJ_OPEN,
    F_OBJ_KEY_BODY,
    F_OBJ_VALUE_COLON,
    F_OBJ_NEXT,
    F_OBJ_KEY_START,
    F_ARR_OPEN,
    F_ARR_NEXT,
    F_STRING_U,        // inside \uXXXX: `count` hex digits remain
    F_STRING_PAT,      // pattern-constrained string body
    F_STRING_PAT_ESC,  // after backslash in a pattern string
    F_STRING_PAT_U,    // \uXXXX in a pattern string; hex value in `key`
    F_OBJ_CLOSE_WS,    // exact-format: consuming ws before '}' (rest in lit)
    F_ARR_CLOSE_WS,    // exact-format: consuming ws before ']' (rest in lit)
};

struct Frame {
    FrameKind kind;
    int32_t node = -1;        // schema node (or -1)
    uint64_t seen = 0;        // object: props already emitted
    uint64_t allowed = ~0ull; // obj keys: allowed prop bitmask (when !additional)
    int32_t count = 0;        // array item count / pending hex digits
    int32_t key = -1;         // completed key prop index / hex accumulator
    bool enum_str = false;    // string restricted to node's enum
    int32_t pat = -1;         // pattern DFA index
    uint64_t pstates = 0;     // pattern containment-walk state bitmask
    uint8_t pmatched = 0;     // pattern: a match has been seen (sticky)
    uint8_t virgin = 0;       // exact-format containers: no member ws/char
                              // consumed yet (empty {} / [] still legal)
    std::string acc;          // string/number accumulator
    std::string lit;          // literal remainder / exact-format pending ws
};

using Branch = std::vector<Frame>;

static bool int_prefix_viable(const Node* n, const std::string& acc);
static bool parse_mag(const std::string& acc, bool& neg,
                      unsigned __int128& mag, bool& sat);
static bool int_in_range(const Node* n, bool neg, unsigned __int128 mag,
                         bool sat);

struct Engine {
    std::vector<Node> nodes;
    std::vector<Dfa> dfas;
    std::vector<std::string> strings;
    std::vector<std::string> tokens;
    std::vector<Branch> branches;
    std::unordered_map<std::string, std::vector<uint8_t>> mask_cache;
    int32_t root = -1;
    // exact-format mode (mirrors matcher.py _Fmt; ug_set_fmt): the matcher
    // admits exactly one serialization (json.dumps-compatible)
    bool fx_exact = false;
    int32_t fx_indent = -1;   // -1 = compact
    std::string fx_item_tail; // separators[0] past the ','
    std::string fx_key_tail;  // separators[1] past the ':'
};

// container depth: each open container owns exactly one frame at any time
static bool is_container(FrameKind k) {
    return k == F_OBJ_OPEN || k == F_OBJ_KEY_BODY || k == F_OBJ_VALUE_COLON ||
           k == F_OBJ_NEXT || k == F_OBJ_KEY_START || k == F_OBJ_CLOSE_WS ||
           k == F_ARR_OPEN || k == F_ARR_NEXT || k == F_ARR_CLOSE_WS;
}

static int depth_of(const std::vector<Frame>& b) {
    int d = 0;
    for (const Frame& f : b) d += is_container(f.kind) ? 1 : 0;
    return d;
}

static std::string member_ws(const Engine& e, int depth) {
    if (e.fx_indent < 0) return std::string();
    std::string s = "\n";
    s.append((size_t)(e.fx_indent * depth), ' ');
    return s;
}

static std::string close_ws(const Engine& e, int depth) {
    if (e.fx_indent < 0) return std::string();
    std::string s = "\n";
    s.append((size_t)(e.fx_indent * (depth - 1)), ' ');
    return s;
}

const Node* node_of(const Engine& e, int32_t idx) {
    return idx >= 0 ? &e.nodes[idx] : nullptr;
}

bool is_ws(char c) { return c == ' ' || c == '\t' || c == '\n' || c == '\r'; }
bool is_digit(char c) { return c >= '0' && c <= '9'; }

bool allow_type(const Node* n, uint32_t bit) {
    if (!n || (n->type_mask & T_ANY)) return true;
    return (n->type_mask & bit) != 0;
}

// does any candidate string (enum values or allowed keys) start with acc?
bool enum_viable(const Engine& e, const Node* n, const std::string& acc, bool closing) {
    for (int32_t sid : n->enum_sids) {
        const std::string& s = e.strings[sid];
        if (closing ? (s == acc) : (s.rfind(acc, 0) == 0 || acc.size() <= s.size()) ) {
            if (closing) return true;
            if (s.size() >= acc.size() && std::memcmp(s.data(), acc.data(), acc.size()) == 0)
                return true;
        }
    }
    return false;
}

bool key_viable(const Engine& e, const Node* n, uint64_t allowed, uint64_t seen,
                const std::string& acc, bool closing, int32_t* out_prop) {
    // additionalProperties: any key goes
    if (n == nullptr || n->additional) {
        if (closing && n != nullptr) {
            for (size_t i = 0; i < n->props.size(); ++i) {
                if (e.strings[n->props[i].name_sid] == acc) {
                    if (seen & (1ull << i)) return false;  // duplicate
                    *out_prop = (int32_t)i;
                    return true;
                }
            }
            *out_prop = -1;
            return true;
        }
        if (!closing) return true;
        *out_prop = -1;
        return true;
    }
    bool any = false;
    for (size_t i = 0; i < n->props.size(); ++i) {
        if (!(allowed & (1ull << i)) || (seen & (1ull << i))) continue;
        const std::string& name = e.strings[n->props[i].name_sid];
        if (closing) {
            if (name == acc) { *out_prop = (int32_t)i; return true; }
        } else if (name.size() >= acc.size() &&
                   std::memcmp(name.data(), acc.data(), acc.size()) == 0) {
            any = true;
        }
    }
    return closing ? false : any;
}

// -- pattern containment walk (mirrors matcher.py _pat_frame_after) ---------

// Step the walk by one decoded codepoint class; false = frame dead.
bool pat_step(const Dfa& d, Frame& f, int32_t cls) {
    if (f.pmatched) return true;  // free-running tail (unanchored end)
    uint64_t src = f.pstates;
    if (!d.a_start) src |= 1ull;  // re-seed start: a match may begin here
    uint64_t nw = 0;
    while (src) {
        int s = __builtin_ctzll(src);
        src &= src - 1;
        int32_t t = d.table[(size_t)s * d.n_classes + cls];
        if (t >= 0) nw |= 1ull << t;
    }
    if (d.a_end) {
        // match must end at the closing quote; an empty state set is dead
        // ONLY when the start is anchored too (no re-seed possible)
        if (!nw && d.a_start) return false;
        f.pstates = nw;
        return true;
    }
    if (nw & d.accept) { f.pstates = 0; f.pmatched = 1; return true; }
    if (!nw && d.a_start) return false;
    f.pstates = nw;
    return true;
}

bool pat_close_ok(const Dfa& d, const Frame& f) {
    if (d.a_end) return (f.pstates & d.accept) != 0;
    return f.pmatched != 0;
}

// codepoint class for an input byte; *skip = UTF-8 continuation byte (the
// lead byte already stepped the walk once per codepoint, like the Python
// matcher's per-char step)
int32_t pat_class(const Dfa& d, unsigned char c, bool* skip) {
    *skip = false;
    if (c < 128) return d.cls[c];
    if ((c & 0xC0) == 0x80) { *skip = true; return 0; }
    return d.default_class;
}

// exact codepoint -> class via the atomic interval partition (interval i
// covers [ibounds[i], ibounds[i+1})) — mirrors RegexDFA.class_of
int32_t cp_class(const Dfa& d, uint32_t cp) {
    if (cp < 128) return d.cls[cp];
    if (d.ibounds.empty()) return d.default_class;
    size_t lo = 0, hi = d.ibounds.size();
    while (lo + 1 < hi) {
        size_t mid = (lo + hi) / 2;
        if ((uint32_t)d.ibounds[mid] <= cp) lo = mid; else hi = mid;
    }
    return d.icls[lo];
}

// true iff SOME codepoint in [lo, hi] keeps the walk alive — mirrors
// matcher.py _PatternInfo.range_viable; gates \-escape entry and each
// \uXXXX hex digit so a dead-end escape can't trap generation
bool range_viable(const Dfa& d, const Frame& f, uint32_t lo, uint32_t hi) {
    if (f.pmatched || !d.a_start) return true;
    size_t n = d.ibounds.size();
    if (n == 0) return true;  // legacy buffer without interval data
    size_t a = 0, b = n;
    while (a + 1 < b) {
        size_t m = (a + b) / 2;
        if ((uint32_t)d.ibounds[m] <= lo) a = m; else b = m;
    }
    for (size_t i = a; i < n && (uint32_t)d.ibounds[i] <= hi; ++i) {
        int32_t cid = d.icls[i];
        uint64_t s = f.pstates;
        while (s) {
            int st = __builtin_ctzll(s);
            s &= s - 1;
            if (d.table[(size_t)st * d.n_classes + cid] >= 0) return true;
        }
    }
    return false;
}

bool badvance(Engine& e, Branch& b, char ch, std::vector<Branch>* spawned);

bool value_start(Engine& e, Branch& b, char ch, int32_t node_idx) {
    if (is_ws(ch)) return !e.fx_exact;
    const Node* n = node_of(e, node_idx);
    b.pop_back();
    Frame f;
    f.node = node_idx;
    if (ch == '"' && allow_type(n, T_STRING)) {
        if (n && !n->enum_sids.empty()) {
            f.kind = F_STRING_BODY;
            f.enum_str = true;
        } else if (n && n->pattern >= 0) {
            const Dfa& d = e.dfas[n->pattern];
            f.kind = F_STRING_PAT;
            f.pat = n->pattern;
            f.pstates = 1ull;  // subset construction: start state is 0
            f.pmatched = (!d.a_end && (1ull & d.accept)) ? 1 : 0;
        } else {
            f.kind = F_STRING_BODY;
        }
        b.push_back(std::move(f));
        return true;
    }
    if (ch == '{' && allow_type(n, T_OBJECT)) {
        f.kind = F_OBJ_OPEN;
        if (e.fx_exact) {
            f.lit = member_ws(e, depth_of(b) + 1);
            f.virgin = 1;
        }
        b.push_back(std::move(f));
        return true;
    }
    if (ch == '[' && allow_type(n, T_ARRAY)) {
        f.kind = F_ARR_OPEN;
        f.count = 0;
        if (e.fx_exact) {
            f.lit = member_ws(e, depth_of(b) + 1);
            f.virgin = 1;
        }
        b.push_back(std::move(f));
        return true;
    }
    if ((is_digit(ch) || ch == '-') && allow_type(n, T_NUMBER)) {
        f.kind = F_NUMBER;
        f.acc.push_back(ch);
        if (n && n->bflags && !int_prefix_viable(n, f.acc)) return false;
        b.push_back(std::move(f));
        return true;
    }
    if (ch == 't' && allow_type(n, T_BOOLEAN)) {
        f.kind = F_LITERAL; f.lit = "rue";
        b.push_back(std::move(f));
        return true;
    }
    if (ch == 'f' && allow_type(n, T_BOOLEAN)) {
        f.kind = F_LITERAL; f.lit = "alse";
        b.push_back(std::move(f));
        return true;
    }
    if (ch == 'n' && allow_type(n, T_NULL)) {
        f.kind = F_LITERAL; f.lit = "ull";
        b.push_back(std::move(f));
        return true;
    }
    return false;
}

// -- integer minimum/maximum (mirrors matcher.py _int_prefix_viable /
// _int_close_ok). Bounds are capped at 2^61 by the flattener; parsed
// magnitudes saturate at > 2^62, which therefore exceeds every bound.
static const unsigned __int128 SAT = ((unsigned __int128)1) << 62;

static bool parse_mag(const std::string& acc, bool& neg,
                      unsigned __int128& mag, bool& sat) {
    neg = !acc.empty() && acc[0] == '-';
    mag = 0;
    sat = false;
    for (size_t i = neg ? 1 : 0; i < acc.size(); ++i) {
        mag = mag * 10 + (unsigned)(acc[i] - '0');
        if (mag > SAT) { sat = true; return true; }
    }
    return acc.size() > (neg ? 1u : 0u);
}

static bool int_in_range(const Node* n, bool neg, unsigned __int128 mag,
                         bool sat) {
    bool has_lo = n->bflags & 1, has_hi = n->bflags & 2;
    if (sat)  // |value| > every bound
        return neg ? !has_lo : !has_hi;
    __int128 v = neg ? -(__int128)mag : (__int128)mag;
    if (has_lo && v < (__int128)n->blo) return false;
    if (has_hi && v > (__int128)n->bhi) return false;
    return true;
}

static bool int_prefix_viable(const Node* n, const std::string& acc) {
    bool has_lo = n->bflags & 1, has_hi = n->bflags & 2;
    if (acc == "-") {
        // exists x <= -1 in range (mirrors the Python expression; any
        // int64 hi clears the -10^40 floor there)
        if (has_lo && n->blo > -1) return false;
        if (has_hi && has_lo && n->bhi < n->blo) return false;
        return true;
    }
    bool neg, sat;
    unsigned __int128 mag;
    if (!parse_mag(acc, neg, mag, sat)) return true;  // bare sign handled above
    if (int_in_range(n, neg, mag, sat)) return true;  // k = 0
    if (mag == 0) return false;  // "0"/"-0" take no more digits
    if (sat)  // extensions only move further out of range
        return false;
    unsigned __int128 p10 = 1;
    for (int k = 0; k < 40 && p10 <= SAT; ++k) {
        p10 *= 10;
        __int128 a, b;  // value interval from appending k+1 digits
        if (neg) {
            a = -(__int128)(mag * p10 + p10 - 1);
            b = -(__int128)(mag * p10);
        } else {
            a = (__int128)(mag * p10);
            b = (__int128)(mag * p10 + p10 - 1);
        }
        bool lo_ok = !has_lo || (__int128)n->blo <= b;
        bool hi_ok = !has_hi || a <= (__int128)n->bhi;
        if (lo_ok && hi_ok) return true;
        // monotone: positives grow, negatives sink — stop once past range
        if (!neg && has_hi && a > (__int128)n->bhi) return false;
        if (neg && has_lo && b < (__int128)n->blo) return false;
    }
    return false;
}

bool num_prefix_ok(const std::string& a) {
    // a extends to SOME valid JSON number (mirrors matcher.py
    // _num_prefix_ok): -?(0|[1-9][0-9]*)(\.[0-9]+)?([eE][+-]?[0-9]+)?
    size_t i = 0, n = a.size();
    if (i < n && a[i] == '-') ++i;
    if (i == n) return true;
    if (a[i] == '0') {
        ++i;
    } else if (is_digit(a[i])) {
        while (i < n && is_digit(a[i])) ++i;
    } else {
        return false;
    }
    if (i == n) return true;
    if (a[i] == '.') {
        ++i;
        size_t start = i;
        while (i < n && is_digit(a[i])) ++i;
        if (i == n) return true;
        if (i == start) return false;  // '.e', '.+': no fraction digits yet
    }
    if (a[i] == 'e' || a[i] == 'E') {
        ++i;
        if (i == n) return true;
        if (a[i] == '+' || a[i] == '-') ++i;
        while (i < n && is_digit(a[i])) ++i;
        return i == n;
    }
    return false;
}

// Advance ONE branch by one character. Combinator value frames at the top
// (incl. ones reached by nested re-dispatch) fork: alternatives beyond the
// first are cloned into *spawned with the character NOT yet consumed — the
// engine loop re-feeds it to them.
bool badvance(Engine& e, Branch& b, char ch, std::vector<Branch>* spawned) {
    // pre-dispatch expansion of alternative nodes ($ref indirections are
    // 1-alt nodes; anyOf of anyOf expands through the loop)
    int guard = 0;
    while (!b.empty() && b.back().kind == F_VALUE) {
        const Node* n = node_of(e, b.back().node);
        if (!n || n->alts.empty()) break;
        if (++guard > 64) return false;  // degenerate ref/combinator cycle
        for (size_t i = 1; i < n->alts.size(); ++i) {
            Branch nb = b;
            nb.back().node = n->alts[i];
            spawned->push_back(std::move(nb));
        }
        b.back().node = n->alts[0];
    }
    if (b.empty()) return is_ws(ch) && !e.fx_exact;
    Frame& f = b.back();
    const Node* n = node_of(e, f.node);
    switch (f.kind) {
        case F_VALUE:
            return value_start(e, b, ch, f.node);
        case F_STRING_BODY: {
            if (ch == '"') {
                if (f.enum_str && !enum_viable(e, n, f.acc, true)) return false;
                b.pop_back();
                return true;
            }
            if (ch == '\\') {
                // enum strings literal-match escapes only for " \ /:
                // refuse the escape entry when no candidate's next char is
                // one of those (dead-end prevention; mirrors matcher.py)
                if (f.enum_str) {
                    bool viable = false;
                    for (int32_t sid : n->enum_sids) {
                        const std::string& c = e.strings[sid];
                        if (c.size() > f.acc.size() &&
                            std::memcmp(c.data(), f.acc.data(), f.acc.size()) == 0) {
                            char nx = c[f.acc.size()];
                            if (nx == '"' || nx == '\\' || nx == '/') {
                                viable = true;
                                break;
                            }
                        }
                    }
                    if (!viable) return false;
                }
                f.kind = F_STRING_ESC;
                return true;
            }
            if ((unsigned char)ch < 0x20) return false;  // raw controls
            f.acc.push_back(ch);
            if (f.enum_str && !enum_viable(e, n, f.acc, false)) return false;
            return true;
        }
        case F_STRING_ESC: {
            if (ch == 'u') {  // \uXXXX: exactly 4 hex digits must follow
                if (f.enum_str) return false;  // placeholder never matches
                f.acc.push_back('\x7f');
                f.kind = F_STRING_U;
                f.count = 4;
                return true;
            }
            static const char* esc = "\"\\/bfnrt";
            // NB: strchr(s, '\0') matches the terminator — guard it, or a
            // NUL byte is "accepted" as an escape (py matcher rejects it)
            if (!ch || !std::strchr(esc, ch)) return false;
            char rep = (ch == '"' || ch == '\\' || ch == '/') ? ch : '\x7f';
            f.acc.push_back(rep);
            f.kind = F_STRING_BODY;
            if (f.enum_str && !enum_viable(e, n, f.acc, false)) return false;
            return true;
        }
        case F_STRING_U: {
            bool hex = is_digit(ch) || (ch >= 'a' && ch <= 'f') ||
                       (ch >= 'A' && ch <= 'F');
            if (!hex) return false;
            if (--f.count == 0) {
                f.kind = F_STRING_BODY;
                if (f.enum_str && !enum_viable(e, n, f.acc, false)) return false;
            }
            return true;
        }
        case F_STRING_PAT: {
            const Dfa& d = e.dfas[f.pat];
            if (ch == '"') {
                if (!pat_close_ok(d, f)) return false;
                b.pop_back();
                return true;
            }
            if (ch == '\\') {
                // escapes only produce BMP codepoints; refuse the escape
                // when none can survive (matcher.py _h_string_pat)
                if (!range_viable(d, f, 0, 0xFFFF)) return false;
                f.kind = F_STRING_PAT_ESC;
                return true;
            }
            if ((unsigned char)ch < 0x20) return false;
            bool skip;
            int32_t cls = pat_class(d, (unsigned char)ch, &skip);
            if (skip) return true;
            return pat_step(d, f, cls);
        }
        case F_STRING_PAT_ESC: {
            const Dfa& d = e.dfas[f.pat];
            if (ch == 'u') {
                f.kind = F_STRING_PAT_U;
                f.count = 4;
                f.key = 0;  // hex accumulator
                return true;
            }
            char rep;
            switch (ch) {
                case '"': case '\\': case '/': rep = ch; break;
                case 'b': rep = '\b'; break;
                case 'f': rep = '\f'; break;
                case 'n': rep = '\n'; break;
                case 'r': rep = '\r'; break;
                case 't': rep = '\t'; break;
                default: return false;
            }
            f.kind = F_STRING_PAT;
            return pat_step(d, f, d.cls[(unsigned char)rep]);
        }
        case F_STRING_PAT_U: {
            int v;
            if (is_digit(ch)) v = ch - '0';
            else if (ch >= 'a' && ch <= 'f') v = ch - 'a' + 10;
            else if (ch >= 'A' && ch <= 'F') v = ch - 'A' + 10;
            else return false;
            f.key = f.key * 16 + v;
            const Dfa& d = e.dfas[f.pat];
            if (--f.count > 0) {
                // prune hex prefixes no codepoint can complete viably
                uint32_t shift = 4u * (uint32_t)f.count;
                uint32_t lo = (uint32_t)f.key << shift;
                if (!range_viable(d, f, lo, lo | ((1u << shift) - 1)))
                    return false;
                return true;
            }
            int32_t cls = cp_class(d, (uint32_t)f.key);
            f.kind = F_STRING_PAT;
            f.key = -1;
            return pat_step(d, f, cls);
        }
        case F_NUMBER: {
            if (is_digit(ch) || ch == '.' || ch == 'e' || ch == 'E' || ch == '+' || ch == '-') {
                if ((ch == '.' || ch == 'e' || ch == 'E') && n &&
                    (n->type_mask & T_INTEGER_ONLY))
                    return false;
                f.acc.push_back(ch);
                if (!num_prefix_ok(f.acc)) { f.acc.pop_back(); return false; }
                if (n && n->bflags && !int_prefix_viable(n, f.acc)) {
                    f.acc.pop_back();
                    return false;
                }
                return true;
            }
            // prefix validity is enforced per char: complete == digit-final
            // (plus integer bounds)
            if (f.acc.empty() || !is_digit(f.acc.back())) return false;
            if (n && n->bflags) {
                bool neg, sat;
                unsigned __int128 mag;
                parse_mag(f.acc, neg, mag, sat);
                if (!int_in_range(n, neg, mag, sat)) return false;
            }
            b.pop_back();
            return badvance(e, b, ch, spawned);
        }
        case F_LITERAL: {
            if (!f.lit.empty() && ch == f.lit[0]) {
                f.lit.erase(0, 1);
                if (f.lit.empty()) b.pop_back();
                return true;
            }
            return false;
        }
        case F_OBJ_OPEN: {
            if (e.fx_exact) {
                if (ch == '}') {
                    if (!f.virgin) return false;
                    if (n) {
                        for (size_t i = 0; i < n->props.size(); ++i)
                            if (n->props[i].required) return false;
                    }
                    b.pop_back();
                    return true;
                }
                if (!f.lit.empty()) {
                    if (ch != f.lit[0]) return false;
                    f.lit.erase(0, 1);
                    f.virgin = 0;
                    return true;
                }
            } else if (is_ws(ch)) {
                return true;
            }
            if (!e.fx_exact && ch == '}') {
                if (n) {
                    for (size_t i = 0; i < n->props.size(); ++i)
                        if (n->props[i].required) return false;
                }
                b.pop_back();
                return true;
            }
            if (ch == '"') {
                uint64_t allowed = ~0ull;
                if (n && !n->additional) {
                    allowed = 0;
                    for (size_t i = 0; i < n->props.size(); ++i) allowed |= 1ull << i;
                }
                f.kind = F_OBJ_KEY_BODY;
                f.seen = 0;
                f.allowed = allowed;
                f.acc.clear();
                f.lit.clear();
                f.virgin = 0;
                return true;
            }
            return false;
        }
        case F_OBJ_KEY_BODY: {
            if (ch == '"') {
                int32_t prop = -1;
                if (!key_viable(e, n, f.allowed, f.seen, f.acc, true, &prop)) return false;
                f.kind = F_OBJ_VALUE_COLON;
                f.key = prop;
                return true;
            }
            if (ch == '\\') return false;  // escaped keys unsupported (matches python)
            f.acc.push_back(ch);
            int32_t ignore;
            if (n && !n->additional &&
                !key_viable(e, n, f.allowed, f.seen, f.acc, false, &ignore))
                return false;
            return true;
        }
        case F_OBJ_VALUE_COLON: {
            if (is_ws(ch)) return !e.fx_exact;
            if (ch == ':') {
                int32_t sub = -1;
                if (f.key >= 0 && n) {
                    f.seen |= 1ull << f.key;
                    sub = n->props[f.key].node;
                }
                f.kind = F_OBJ_NEXT;
                f.acc.clear();
                Frame v;
                v.kind = F_VALUE;
                v.node = sub;
                b.push_back(std::move(v));
                if (e.fx_exact && !e.fx_key_tail.empty()) {
                    Frame l;
                    l.kind = F_LITERAL;
                    l.lit = e.fx_key_tail;
                    b.push_back(std::move(l));
                }
                return true;
            }
            return false;
        }
        case F_OBJ_NEXT: {
            if (e.fx_exact) {
                int d = depth_of(b);
                std::string close = close_ws(e, d);
                if (ch == ',') {
                    if (n && !n->additional) {
                        uint64_t all = 0;
                        for (size_t i = 0; i < n->props.size(); ++i) all |= 1ull << i;
                        uint64_t remaining = all & ~f.seen;
                        if (!remaining) return false;
                        f.allowed = remaining;
                    }
                    f.kind = F_OBJ_KEY_START;
                    f.lit = e.fx_item_tail + member_ws(e, d);
                    return true;
                }
                if (!close.empty()) {
                    // committing to '}' must be legal NOW (required keys)
                    // or the branch walks into a dead end
                    if (ch != close[0]) return false;
                    if (n) {
                        for (size_t i = 0; i < n->props.size(); ++i)
                            if (n->props[i].required && !(f.seen & (1ull << i)))
                                return false;
                    }
                    f.kind = F_OBJ_CLOSE_WS;
                    f.lit = close.substr(1);
                    return true;
                }
                // compact: fall through to the direct '}' below
            } else if (is_ws(ch)) {
                return true;
            }
            if (ch == '}') {
                if (n) {
                    for (size_t i = 0; i < n->props.size(); ++i)
                        if (n->props[i].required && !(f.seen & (1ull << i))) return false;
                }
                b.pop_back();
                return true;
            }
            if (!e.fx_exact && ch == ',') {
                if (n && !n->additional) {
                    uint64_t all = 0;
                    for (size_t i = 0; i < n->props.size(); ++i) all |= 1ull << i;
                    uint64_t remaining = all & ~f.seen;
                    if (!remaining) return false;
                    f.allowed = remaining;
                }
                f.kind = F_OBJ_KEY_START;
                return true;
            }
            return false;
        }
        case F_OBJ_CLOSE_WS: {
            if (!f.lit.empty()) {
                if (ch != f.lit[0]) return false;
                f.lit.erase(0, 1);
                return true;
            }
            if (ch == '}') {
                if (n) {
                    for (size_t i = 0; i < n->props.size(); ++i)
                        if (n->props[i].required && !(f.seen & (1ull << i))) return false;
                }
                b.pop_back();
                return true;
            }
            return false;
        }
        case F_OBJ_KEY_START: {
            if (e.fx_exact) {
                if (!f.lit.empty()) {
                    if (ch != f.lit[0]) return false;
                    f.lit.erase(0, 1);
                    return true;
                }
            } else if (is_ws(ch)) {
                return true;
            }
            if (ch == '"') {
                f.kind = F_OBJ_KEY_BODY;
                f.acc.clear();
                return true;
            }
            return false;
        }
        case F_ARR_OPEN: {
            if (e.fx_exact) {
                if (ch == ']') {
                    if (!f.virgin) return false;
                    if (n && f.count < n->min_items) return false;
                    b.pop_back();
                    return true;
                }
                if (!f.lit.empty()) {
                    if (ch != f.lit[0]) return false;
                    f.lit.erase(0, 1);
                    f.virgin = 0;
                    return true;
                }
            } else {
                if (is_ws(ch)) return true;
                if (ch == ']') {
                    if (n && f.count < n->min_items) return false;
                    b.pop_back();
                    return true;
                }
            }
            int32_t items = n ? n->items : -1;
            f.kind = F_ARR_NEXT;
            f.count += 1;
            f.lit.clear();
            f.virgin = 0;
            Frame v;
            v.kind = F_VALUE;
            v.node = items;
            b.push_back(std::move(v));
            return badvance(e, b, ch, spawned);
        }
        case F_ARR_NEXT: {
            if (e.fx_exact) {
                int d = depth_of(b);
                std::string close = close_ws(e, d);
                if (ch == ',') {
                    if (n && n->max_items >= 0 && f.count >= n->max_items) return false;
                    int32_t items = n ? n->items : -1;
                    f.count += 1;
                    Frame v;
                    v.kind = F_VALUE;
                    v.node = items;
                    b.push_back(std::move(v));
                    std::string lit = e.fx_item_tail + member_ws(e, d);
                    if (!lit.empty()) {
                        Frame l;
                        l.kind = F_LITERAL;
                        l.lit = lit;
                        b.push_back(std::move(l));
                    }
                    return true;
                }
                if (!close.empty()) {
                    if (ch != close[0]) return false;
                    if (n && f.count < n->min_items) return false;
                    f.kind = F_ARR_CLOSE_WS;
                    f.lit = close.substr(1);
                    return true;
                }
                if (ch == ']') {
                    if (n && f.count < n->min_items) return false;
                    b.pop_back();
                    return true;
                }
                return false;
            }
            if (is_ws(ch)) return true;
            if (ch == ']') {
                if (n && f.count < n->min_items) return false;
                b.pop_back();
                return true;
            }
            if (ch == ',') {
                if (n && n->max_items >= 0 && f.count >= n->max_items) return false;
                int32_t items = n ? n->items : -1;
                f.count += 1;
                Frame v;
                v.kind = F_VALUE;
                v.node = items;
                b.push_back(std::move(v));
                return true;
            }
            return false;
        }
        case F_ARR_CLOSE_WS: {
            if (!f.lit.empty()) {
                if (ch != f.lit[0]) return false;
                f.lit.erase(0, 1);
                return true;
            }
            if (ch == ']') {
                if (n && f.count < n->min_items) return false;
                b.pop_back();
                return true;
            }
            return false;
        }
    }
    return false;
}

// Advance the whole branch set; false when every branch rejects (the
// engine state is then undefined, like the Python matcher).
bool engine_advance(Engine& e, char ch) {
    std::vector<Branch> work = std::move(e.branches);
    e.branches.clear();
    std::unordered_set<std::string> sigs;
    std::string sig;
    int forks = 0;
    while (!work.empty()) {
        Branch b = std::move(work.back());
        work.pop_back();
        std::vector<Branch> spawned;
        bool ok = badvance(e, b, ch, &spawned);
        if (!spawned.empty() && (forks += (int)spawned.size()) > 512)
            return false;  // runaway combinator expansion
        for (auto& sb : spawned) work.push_back(std::move(sb));
        if (ok) {
            sig.clear();
            char buf[96];
            for (const Frame& f : b) {
                int len = std::snprintf(buf, sizeof buf,
                                        "%d:%d:%llu:%llu:%d:%d:%d:%d:%llu:%d:%d|",
                                        (int)f.kind, f.node,
                                        (unsigned long long)f.seen,
                                        (unsigned long long)f.allowed, f.count,
                                        f.key, (int)f.enum_str, f.pat,
                                        (unsigned long long)f.pstates,
                                        (int)f.pmatched, (int)f.virgin);
                sig.append(buf, len);
                sig.append(f.acc);
                sig.push_back(';');
                sig.append(f.lit);
                sig.push_back('#');
            }
            if (sigs.insert(sig).second) e.branches.push_back(std::move(b));
        }
    }
    return !e.branches.empty();
}

void signature(const Engine& e, std::string* out) {
    out->clear();
    char buf[96];
    for (const Branch& b : e.branches) {
        for (const Frame& f : b) {
            int len = std::snprintf(buf, sizeof buf,
                                    "%d:%d:%llu:%llu:%d:%d:%d:%d:%llu:%d:%d|",
                                    (int)f.kind, f.node,
                                    (unsigned long long)f.seen,
                                    (unsigned long long)f.allowed, f.count,
                                    f.key, (int)f.enum_str, f.pat,
                                    (unsigned long long)f.pstates,
                                    (int)f.pmatched, (int)f.virgin);
            out->append(buf, len);
            out->append(f.acc);
            out->push_back(';');
            out->append(f.lit);
            out->push_back('#');
        }
        out->push_back('&');
    }
}

}  // namespace

extern "C" {

// schema_buf layout (int32): n_nodes, then per node:
//   [type_mask, items, min_items, max_items, additional,
//    n_props, n_enum, n_alts, pattern,
//    bflags, blo_lo32, blo_hi32, bhi_lo32, bhi_hi32]
//   (b* = integer minimum/maximum as two's-complement int64 halves)
//   then n_props * [name_sid, node, required], n_enum * [sid],
//   n_alts * [node]
// strings: blob + (n_strs+1) offsets; tokens likewise.
// dfa_buf (int32): n_dfas, then per DFA:
//   [n_states, n_classes, anchored_start, anchored_end,
//    accept_lo, accept_hi, default_class]
//   + 128 byte->class entries
//   + n_intervals + n_intervals*(start_codepoint, class)
//   + n_states*n_classes transitions
void* ug_create(const int32_t* schema_buf, int32_t schema_len,
                const char* str_blob, const int32_t* str_offs, int32_t n_strs,
                const char* tok_blob, const int32_t* tok_offs, int32_t n_tokens,
                const int32_t* dfa_buf, int32_t dfa_len) {
    Engine* e = new Engine();
    for (int32_t i = 0; i < n_strs; ++i)
        e->strings.emplace_back(str_blob + str_offs[i], str_offs[i + 1] - str_offs[i]);
    for (int32_t i = 0; i < n_tokens; ++i)
        e->tokens.emplace_back(tok_blob + tok_offs[i], tok_offs[i + 1] - tok_offs[i]);

    if (schema_len > 0) {
        const int32_t* p = schema_buf;
        int32_t n_nodes = *p++;
        for (int32_t i = 0; i < n_nodes; ++i) {
            Node n;
            n.type_mask = (uint32_t)*p++;
            n.items = *p++;
            n.min_items = *p++;
            n.max_items = *p++;
            n.additional = *p++;
            int32_t n_props = *p++;
            int32_t n_enum = *p++;
            int32_t n_alts = *p++;
            n.pattern = *p++;
            n.bflags = *p++;
            uint64_t lo_u = (uint32_t)p[0] | ((uint64_t)(uint32_t)p[1] << 32);
            uint64_t hi_u = (uint32_t)p[2] | ((uint64_t)(uint32_t)p[3] << 32);
            p += 4;
            n.blo = (int64_t)lo_u;
            n.bhi = (int64_t)hi_u;
            for (int32_t j = 0; j < n_props; ++j) {
                Prop pr{p[0], p[1], p[2]};
                p += 3;
                n.props.push_back(pr);
            }
            for (int32_t j = 0; j < n_enum; ++j) n.enum_sids.push_back(*p++);
            for (int32_t j = 0; j < n_alts; ++j) n.alts.push_back(*p++);
            e->nodes.push_back(std::move(n));
        }
        e->root = 0;
    }
    if (dfa_buf && dfa_len > 0) {
        const int32_t* p = dfa_buf;
        int32_t n_dfas = *p++;
        for (int32_t i = 0; i < n_dfas; ++i) {
            Dfa d;
            d.n_states = *p++;
            d.n_classes = *p++;
            d.a_start = *p++ != 0;
            d.a_end = *p++ != 0;
            uint64_t lo = (uint32_t)*p++;
            uint64_t hi = (uint32_t)*p++;
            d.accept = lo | (hi << 32);
            d.default_class = *p++;
            for (int j = 0; j < 128; ++j) d.cls[j] = *p++;
            int32_t n_iv = *p++;
            d.ibounds.reserve(n_iv);
            d.icls.reserve(n_iv);
            for (int32_t j = 0; j < n_iv; ++j) {
                d.ibounds.push_back(*p++);
                d.icls.push_back(*p++);
            }
            d.table.assign(p, p + (size_t)d.n_states * d.n_classes);
            p += (size_t)d.n_states * d.n_classes;
            e->dfas.push_back(std::move(d));
        }
    }
    Frame v;
    v.kind = F_VALUE;
    v.node = e->root;
    e->branches.push_back(Branch{v});
    return e;
}

void ug_reset(void* h) {
    Engine* e = static_cast<Engine*>(h);
    e->branches.clear();
    Frame v;
    v.kind = F_VALUE;
    v.node = e->root;
    e->branches.push_back(Branch{v});
}

// exact-format mode (matcher.py _Fmt / ref grammar/config.rs knobs); call
// once right after ug_create, before any observe — the root branch carries
// no formatting state, so no rebuild is needed, and ug_reset preserves it
void ug_set_fmt(void* h, int exact, int indent, const char* item_tail,
                const char* key_tail) {
    Engine* e = static_cast<Engine*>(h);
    e->fx_exact = exact != 0;
    e->fx_indent = indent;
    e->fx_item_tail = item_tail ? item_tail : "";
    e->fx_key_tail = key_tail ? key_tail : "";
    e->mask_cache.clear();
}

int ug_advance_text(void* h, const char* s, int len) {
    Engine* e = static_cast<Engine*>(h);
    for (int i = 0; i < len; ++i)
        if (!engine_advance(*e, s[i])) return -1;
    return 0;
}

int ug_observe(void* h, int token_id) {
    Engine* e = static_cast<Engine*>(h);
    const std::string& t = e->tokens[token_id];
    return ug_advance_text(h, t.data(), (int)t.size());
}

int ug_is_complete(void* h) {
    Engine* e = static_cast<Engine*>(h);
    for (const Branch& b : e->branches)
        if (b.empty()) return 1;
    return 0;
}

// Fills out[n_tokens]; returns count of allowed tokens. Uses the per-state
// cache (the role of xgrammar's adaptive token mask cache).
int ug_mask(void* h, uint8_t* out) {
    Engine* e = static_cast<Engine*>(h);
    std::string sig;
    signature(*e, &sig);
    auto it = e->mask_cache.find(sig);
    if (it != e->mask_cache.end()) {
        std::memcpy(out, it->second.data(), it->second.size());
        int count = 0;
        for (uint8_t b : it->second) count += b;
        return count;
    }
    std::vector<uint8_t> mask(e->tokens.size(), 0);
    int count = 0;
    std::vector<Branch> saved = e->branches;  // clone branch set
    for (size_t i = 0; i < e->tokens.size(); ++i) {
        const std::string& t = e->tokens[i];
        if (t.empty()) continue;
        bool ok = true;
        for (char c : t) {
            if (!engine_advance(*e, c)) { ok = false; break; }
        }
        e->branches = saved;
        if (ok) { mask[i] = 1; ++count; }
    }
    std::memcpy(out, mask.data(), mask.size());
    e->mask_cache.emplace(std::move(sig), std::move(mask));
    return count;
}

void ug_destroy(void* h) { delete static_cast<Engine*>(h); }

// Snapshot/restore of the matcher state (the branch set) — the lookahead
// path of speculative grammar decoding clones the state, walks a draft
// chain filling per-node masks, then restores (reference: per-trie-node
// bitmask fill, stream.rs:632-675 + trie.rs:167).
void* ug_save(void* h) {
    Engine* e = static_cast<Engine*>(h);
    return new std::vector<Branch>(e->branches);
}

void ug_restore(void* h, void* snap) {
    Engine* e = static_cast<Engine*>(h);
    e->branches = *static_cast<std::vector<Branch>*>(snap);
}

void ug_snapshot_free(void* snap) {
    delete static_cast<std::vector<Branch>*>(snap);
}

}  // extern "C"
