"""The port's grammar layer against the JAX package's, on the CPU.

`uzu_tpu_torch.grammar` is the JAX package's numpy/C++ grammar layer with
its imports repointed (`matcher.py`, `regex.py`, `native_backend.py`,
the native engines `native/grammar.cpp` and `native/regex_dfa.cpp` built
with g++ at first use) and `decode.py` ported to torch. A test-local
tokenizer (single characters, JSON fragments and filler pieces) serves
both packages' `GrammarSession`:

- masks of the port's and JAX's sessions are equal along hypothesis-drawn
  token walks, for JSON schemas and regexes, on both backends, and the
  port's native and Python backends agree;
- `constrained_generate` and its speculative form give JAX's greedy
  streams on a tiny f32 Llama;
- a grammar slot's greedy stream in either speculative batch engine is
  the single-stream constrained loop's, next to a plain slot that keeps
  its plain stream; sampled constrained outputs satisfy their grammar;
- the plain engines refuse a grammar request, and a failed native build
  raises instead of falling back to Python.
"""

import json
import re

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from uzu_tpu import LanguageModel as JaxLM
from uzu_tpu.engine.speculation import NgramSpeculator as JaxNgram
from uzu_tpu.grammar import GrammarSession as JaxSession, constrained_generate as jax_cg
from uzu_tpu_torch import LanguageModel
from uzu_tpu_torch import native
from uzu_tpu_torch.engine.batch import BatchEngine
from uzu_tpu_torch.engine.batch_spec import SpeculativeBatchEngine, SpeculativePagedBatchEngine
from uzu_tpu_torch.engine.paged_batch import PagedBatchEngine
from uzu_tpu_torch.engine.sampling import SamplingParams
from uzu_tpu_torch.engine.speculation import NgramSpeculator
from uzu_tpu_torch.grammar import GrammarSession, constrained_generate
from uzu_tpu_torch.tools import synth

torch.set_num_threads(1)

SCHEMA = {
    "type": "object",
    "properties": {"city": {"enum": ["Paris", "Rome"]}, "days": {"type": "integer"}},
    "required": ["city"],
}
SCHEMAS = {
    "object": SCHEMA,
    "nested": {"type": "object", "properties": {
        "ok": {"type": "boolean"}, "tags": {"type": "array", "items": {"type": "string"},
                                            "maxItems": 3},
        "score": {"type": "number"}}, "required": ["ok", "tags"]},
    "any": None,
}
REGEXES = {"email": r"[a-z]{2,5}@[a-z]+\.(com|org)", "phone": r"\d{3}-\d{4}"}
FRAGMENTS = ['{"', '"}', '":', '", "', '": "', ', "', '{"city": "', 'city', 'Paris', 'Rome',
             'days', 'ok', 'tags', 'score', 'true', 'false', 'null', '12', '3.5', '[]', '["',
             '"]', ', ', ': ', '\n', '  ', '.com', '.org', '@', '-', 'ab', 'xy', '}', '{']


class TinyTokenizer:
    """Id 0 is the end-of-sequence special; then the printable ASCII
    characters, JSON fragments, and two-letter filler up to 240 ids (the
    model's vocabulary is 256: ids past the tokenizer carry no text)."""

    def __init__(self):
        pieces = ["<eos>"] + [chr(c) for c in range(32, 127)] + FRAGMENTS
        letters = "abcdefghijklmnopqrstuvwxyz"
        i = 0
        while len(pieces) < 240:
            pieces.append(letters[i % 26] + letters[(i * 7 + 3) % 26])
            i += 1
        self.pieces = pieces
        self.vocab_size = len(pieces)
        self.special_token_strings = {"<eos>"}
        self.eos_token_ids = [0]

    def id_to_token(self, i: int):
        return self.pieces[i] if 0 <= i < self.vocab_size else None

    def decode(self, ids) -> str:
        return "".join(self.pieces[i] for i in ids if 0 < i < self.vocab_size)


TOK = TinyTokenizer()
STOP = [0]


def _sessions(kind, name, backend):
    kw = dict(schema=SCHEMAS[name]) if kind == "schema" else dict(regex=REGEXES[name])
    return (GrammarSession(TOK, stop_token_ids=STOP, backend=backend, **kw),
            JaxSession(TOK, stop_token_ids=STOP, backend=backend, **kw))


CASES = [("schema", n) for n in SCHEMAS] + [("regex", n) for n in REGEXES]


@pytest.mark.parametrize("kind,name", CASES)
@pytest.mark.parametrize("backend", ["native", "python"])
@settings(max_examples=8, deadline=None)
@given(data=st.data())
def test_masks_match_jax_along_token_walks(kind, name, backend, data):
    """Along a walk of up to 24 allowed tokens (each drawn from the port's
    mask), the port's masks equal JAX's at every step, as do the lookahead
    masks of the walk's next three tokens; the port's session runs the
    backend asked for."""
    ours, theirs = _sessions(kind, name, backend)
    assert ours.backend == theirs.backend == backend
    walk = []
    for _ in range(24):
        m, jm = ours.current_mask(), theirs.current_mask()
        assert np.array_equal(m, jm)
        allowed = [int(i) for i in np.flatnonzero(m) if i not in STOP]
        if not allowed:
            break
        walk.append(data.draw(st.sampled_from(allowed)))
        ours.observe(walk[-1])
        theirs.observe(walk[-1])
    ours.reset()
    theirs.reset()
    look, jlook = ours.lookahead_masks(walk[:3]), theirs.lookahead_masks(walk[:3])
    assert len(look) == len(jlook)
    assert all(np.array_equal(a, b) for a, b in zip(look, jlook))


@pytest.mark.parametrize("kind,name", CASES)
@settings(max_examples=5, deadline=None)
@given(data=st.data())
def test_native_and_python_backends_agree(kind, name, data):
    native_s, _ = _sessions(kind, name, "native")
    python_s, _ = _sessions(kind, name, "python")
    for _ in range(24):
        m = native_s.current_mask()
        assert np.array_equal(m, python_s.current_mask())
        allowed = [int(i) for i in np.flatnonzero(m) if i not in STOP]
        if not allowed:
            break
        t = data.draw(st.sampled_from(allowed))
        native_s.observe(t)
        python_s.observe(t)


def test_schema_outside_the_native_subset_takes_the_python_matcher():
    """`SchemaUnsupported` (here a `not` keyword) goes to the Python
    matcher in auto mode, as in the JAX package; asking for native raises."""
    schema = {"type": "object", "properties": {"a": {"not": {"type": "null"}}}}
    assert GrammarSession(TOK, schema=schema, stop_token_ids=STOP).backend == "python"
    assert GrammarSession(TOK, schema=SCHEMA, stop_token_ids=STOP).backend == "native"
    with pytest.raises(Exception):
        GrammarSession(TOK, schema=schema, stop_token_ids=STOP, backend="native")


def test_failed_native_build_raises(monkeypatch, tmp_path):
    """A compiler failure raises with g++'s message, for the JSON and the
    regex engines; only `backend="python"` runs without the library."""
    monkeypatch.setattr(native, "_libs", {})
    monkeypatch.setattr(native, "GXX_FLAGS", native.GXX_FLAGS + ("-fno-such-flag",))
    monkeypatch.setattr(native, "kernel_build_dir", lambda: str(tmp_path))
    for kw in (dict(schema=SCHEMA), dict(regex=REGEXES["phone"])):
        with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
            GrammarSession(TOK, stop_token_ids=STOP, **kw)
        assert GrammarSession(TOK, stop_token_ids=STOP, backend="python", **kw).backend == \
            "python"


# -- generation -----------------------------------------------------------------------------


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    cfg = synth.llama_config(num_layers=2, model_dim=64, hidden_dim=160, num_heads=4,
                             num_groups=2, head_dim=16, vocab_size=256, tied=False)
    return synth.synthesize(cfg, str(tmp_path_factory.mktemp("grammar")), seed=11,
                            dtype=np.float32)


@pytest.fixture(scope="module")
def lm(model_dir):
    return LanguageModel.from_dir(model_dir, device="cpu", max_context=256,
                                  prefill_buckets=(16,))


PROMPT = [5, 6, 7, 8, 5, 6, 7]


def _single(lm, n, kind="schema", name="object", **kw):
    g, _ = _sessions(kind, name, "auto")
    return list(constrained_generate(lm, np.asarray(PROMPT), n, g, stop_token_ids=STOP, **kw))


@pytest.mark.parametrize("speculative", [False, True], ids=["plain", "speculative"])
@pytest.mark.parametrize("kind,name", [("schema", "object"), ("regex", "email")])
def test_constrained_generate_matches_jax(model_dir, lm, speculative, kind, name):
    """Greedy constrained streams (one token a step, or n-gram chains
    verified under lookahead masks) equal JAX's, and their text satisfies
    the grammar wherever the stream closed it."""
    jlm = JaxLM.from_dir(model_dir, max_context=256, prefill_buckets=(16,))
    ours_g, theirs_g = _sessions(kind, name, "auto")
    kw = dict(speculator=NgramSpeculator(k=4)) if speculative else {}
    jkw = dict(speculator=JaxNgram(k=4)) if speculative else {}
    ours = list(constrained_generate(lm, np.asarray(PROMPT), 40, ours_g, stop_token_ids=STOP,
                                     **kw))
    theirs = list(jax_cg(jlm, np.asarray(PROMPT, np.int32), 40, theirs_g,
                         stop_token_ids=STOP, **jkw))
    assert ours == theirs
    if ours[-1] in STOP:
        _assert_valid(kind, name, ours)


def _assert_valid(kind, name, tokens):
    text = TOK.decode(tokens)
    if kind == "regex":
        assert re.fullmatch(REGEXES[name], text), text
        return
    value = json.loads(text)
    if name == "object":
        assert value["city"] in ("Paris", "Rome")
        assert set(value) <= {"city", "days"}
        assert isinstance(value.get("days", 0), int)


ENGINES = {
    "dense": (SpeculativeBatchEngine, {}),
    "paged": (SpeculativePagedBatchEngine, dict(num_pages=64, page_size=16)),
    "dense_self_draft": (SpeculativeBatchEngine, dict(draft_layers=1)),
}


@pytest.mark.parametrize("engine", list(ENGINES))
def test_batched_grammar_slots_equal_the_single_stream(lm, engine):
    """Three grammar requests (two schemas, one regex) through two slots
    beside a plain one: each grammar slot's greedy stream is the
    single-stream constrained loop's, the plain slot keeps its plain
    stream, and per-request grammar state does not leak across slot
    reuse (the self-draft engine keeps host drafts for grammar slots)."""
    cls, kw = ENGINES[engine]
    wants = [_single(lm, 30), _single(lm, 30, "regex", "email"), _single(lm, 30)]
    plain_prompt = [9, 8, 7, 6, 5]
    want_p = lm.generate_list(np.asarray(plain_prompt), 30, stop_token_ids=STOP)
    eng = cls(lm, batch_size=2, draft_block=4, stop_token_ids=STOP, **kw)
    reqs = [eng.submit(PROMPT, 30, grammar=_sessions(k, n, "auto")[0])
            for k, n in (("schema", "object"), ("regex", "email"), ("schema", "object"))]
    rp = eng.submit(plain_prompt, 30)
    eng.run()
    assert [r.tokens for r in reqs] == wants
    assert rp.tokens == want_p


@pytest.mark.parametrize("engine", ["dense", "paged"])
def test_sampled_constrained_outputs_are_valid(lm, engine):
    """Sampled grammar requests (temperature 1.2) emit text that parses and
    satisfies its grammar whenever the stream ends on the stop token, and
    the same seed repeats the stream."""
    cls, kw = ENGINES[engine]
    sp = SamplingParams(temperature=1.2)
    outs = []
    for _ in range(2):
        eng = cls(lm, batch_size=3, draft_block=4, stop_token_ids=STOP, sampling=sp, **kw)
        reqs = [eng.submit(PROMPT, 60, seed=s, grammar=_sessions(k, n, "auto")[0])
                for s, (k, n) in enumerate((("schema", "object"), ("regex", "phone"),
                                            ("regex", "email")))]
        eng.run()
        outs.append([r.tokens for r in reqs])
    assert outs[0] == outs[1]
    closed = 0
    for toks, (k, n) in zip(outs[0], (("schema", "object"), ("regex", "phone"),
                                      ("regex", "email"))):
        if toks[-1] in STOP:
            closed += 1
            _assert_valid(k, n, toks[:-1])
    assert closed >= 1


def test_plain_engines_reject_grammar(lm):
    for eng in (BatchEngine(lm, batch_size=2, stop_token_ids=STOP),
                PagedBatchEngine(lm, batch_size=2, stop_token_ids=STOP)):
        assert not eng.supports_grammar
        with pytest.raises(ValueError, match="speculative"):
            eng.submit([1, 2, 3], 8, grammar=_sessions("schema", "object", "auto")[0])
