// Regex-DFA token-mask kernel, the port's copy of uzu_tpu/native/regex_dfa.cpp
// (the xgrammar-FFI role for Grammar::Regex, reference:
// crates/backend-uzu/src/engine/language_model/grammar/mod.rs).
// The DFA is compiled in Python (uzu_tpu_torch/grammar/regex.py); this side only
// does the hot O(vocab * token_len) walk: a token is viable from a state iff
// every transition along its class sequence stays alive.
//
// Build: on demand via uzu_tpu_torch.native.load("regex_dfa"), with g++.

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct RegexDfa {
  std::vector<int32_t> table;  // [n_states, n_classes], -1 = dead
  std::vector<uint8_t> accept; // [n_states]
  int32_t n_states = 0, n_classes = 0;
  std::vector<int32_t> tok_cls;  // concatenated class ids of every token
  std::vector<int32_t> tok_offs; // [n_tokens + 1]
  int32_t n_tokens = 0;
};

} // namespace

extern "C" {

void *rd_create(const int32_t *table, int32_t n_states, int32_t n_classes,
                const uint8_t *accept, const int32_t *tok_cls,
                const int32_t *tok_offs, int32_t n_tokens) {
  auto *d = new RegexDfa();
  d->n_states = n_states;
  d->n_classes = n_classes;
  d->n_tokens = n_tokens;
  d->table.assign(table, table + (size_t)n_states * n_classes);
  d->accept.assign(accept, accept + n_states);
  d->tok_offs.assign(tok_offs, tok_offs + n_tokens + 1);
  d->tok_cls.assign(tok_cls, tok_cls + tok_offs[n_tokens]);
  return d;
}

void rd_destroy(void *h) { delete static_cast<RegexDfa *>(h); }

// out[i] = 1 iff token i (non-empty) keeps the DFA alive from `state`.
void rd_mask(void *h, int32_t state, uint8_t *out) {
  auto *d = static_cast<RegexDfa *>(h);
  const int32_t *tb = d->table.data();
  const int32_t nc = d->n_classes;
  for (int32_t t = 0; t < d->n_tokens; ++t) {
    int32_t s = state;
    int32_t b = d->tok_offs[t], e = d->tok_offs[t + 1];
    if (b == e) { out[t] = 0; continue; } // empty/special token
    for (int32_t j = b; j < e; ++j) {
      s = tb[(size_t)s * nc + d->tok_cls[j]];
      if (s < 0) break;
    }
    out[t] = (uint8_t)(s >= 0);
  }
}

// Walk one token from `state`; returns the next state or -1.
int32_t rd_step(void *h, int32_t state, int32_t token) {
  auto *d = static_cast<RegexDfa *>(h);
  int32_t s = state;
  for (int32_t j = d->tok_offs[token]; j < d->tok_offs[token + 1]; ++j) {
    s = d->table[(size_t)s * d->n_classes + d->tok_cls[j]];
    if (s < 0) return -1;
  }
  return s;
}

} // extern "C"
