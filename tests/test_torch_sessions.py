"""The port's session layer (`uzu_tpu_torch/sessions/`) against the JAX
package's, on the CPU.

Templates render the same strings; the stream parsers and the harmony
parser give the same events fed one character at a time over the golden
fixtures; `TransformSchema` gives the same results; the tokenizer and the
incremental detokenizer agree; a `ChatSession` on a tiny f32 chat model
gives the JAX session's tokens and text, turn after turn with its prefix
cache; the tool loop, speculative and grammar turns, and the TTS plumbing
work over the port's engine.
"""

import json
import os

import numpy as np
import pytest
import torch

from uzu_tpu import LanguageModel as JaxLM
from uzu_tpu.grammar import GrammarSession as JaxGrammar
from uzu_tpu.sessions import ChatSession as JaxChatSession
from uzu_tpu.sessions import Tokenizer as JaxTokenizer
from uzu_tpu.sessions import harmony as jharmony
from uzu_tpu.sessions import parser as jparser
from uzu_tpu.sessions import template as jtemplate
from uzu_tpu.sessions import transform as jtransform
from uzu_tpu.sessions.tts import TokenLMSynthesizer as JaxTokenLMSynthesizer
from uzu_tpu.tools import synth as jsynth
from uzu_tpu_torch import LanguageModel
from uzu_tpu_torch.engine.sampling import SamplingParams
from uzu_tpu_torch.engine.speculation import NgramSpeculator
from uzu_tpu_torch.grammar import GrammarSession, JsonMatcher
from uzu_tpu_torch.sessions import (
    ChatSession,
    StreamDecoder,
    Tokenizer,
    ToolSpec,
    harmony,
    parser,
    template,
    transform,
)
from uzu_tpu_torch.sessions.parser import ToolCall
from uzu_tpu_torch.sessions.tts import (
    CancelToken,
    TextToSpeechSession,
    TokenLMSynthesizer,
    codebook_sine,
    sine_test_synthesizer,
)

torch.set_num_threads(1)

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures", "golden_responses.json")
with open(FIXTURES) as f:
    GOLDEN = json.load(f)

CHAT = dict(num_layers=2, model_dim=64, hidden_dim=160, num_heads=4, num_groups=2,
            head_dim=16, vocab_size=512, tied=False)
LM_KW = dict(max_context=256, prefill_buckets=(16, 64))
SCHEMA = {"type": "object", "properties": {"city": {"enum": ["Paris", "Rome"]},
                                           "days": {"type": "integer", "minimum": 1,
                                                    "maximum": 30}},
          "required": ["city", "days"]}


@pytest.fixture(scope="module")
def chat_dir(tmp_path_factory):
    """A tiny untied f32 chat model with the synthetic tokenizer and its
    stop ids at `<|end|>` (synth_chat_model's layout, f32 weights)."""
    d = str(tmp_path_factory.mktemp("torch_sessions"))
    jsynth.synthesize(jsynth.llama_config(**CHAT), d, seed=5, dtype=np.float32)
    jsynth.synth_tokenizer(d, vocab_size=CHAT["vocab_size"])
    cfg_path = os.path.join(d, "config.json")
    with open(cfg_path) as f:
        raw = json.load(f)
    raw["generation_config"]["stop_token_ids"] = JaxTokenizer(d).eos_token_ids
    with open(cfg_path, "w") as f:
        json.dump(raw, f, indent=1)
    return d


@pytest.fixture(scope="module")
def lm(chat_dir):
    return LanguageModel.from_dir(chat_dir, device="cpu", **LM_KW)


@pytest.fixture(scope="module")
def jax_lm(chat_dir):
    return JaxLM.from_dir(chat_dir, **LM_KW)


# -- templates, parsers, transforms (copies) --------------------------------------


def _golden_template(mod, entry):
    if entry.get("style") == "harmony":
        return (jharmony if mod is jtemplate else harmony).HarmonyEncoding()
    return mod.ChatTemplate(entry["template"])


@pytest.mark.parametrize("entry", GOLDEN, ids=[e["family"] for e in GOLDEN])
def test_golden_templates_render_the_same_strings(entry):
    params = entry["parameters"]
    want = _golden_template(jtemplate, entry).render(params["messages"], tools=params["tools"])
    got = _golden_template(template, entry).render(params["messages"], tools=params["tools"])
    assert got == want == entry["result"]["prompt"]


@pytest.mark.parametrize("tmpl", [None, jsynth.SYNTH_CHAT_TEMPLATE], ids=["default", "synth"])
def test_templates_render_tools_and_tool_turns_the_same(tmpl):
    msgs = [{"role": "system", "content": "terse"}, {"role": "user", "content": "weather?"},
            {"role": "assistant", "content": None, "tool_calls": [
                {"id": "c0", "type": "function",
                 "function": {"name": "get_weather", "arguments": '{"city": "Paris"}'}}]},
            {"role": "tool", "tool_call_id": "c0", "content": '{"temp_c": 21}'}]
    tools = [ToolSpec("get_weather", "weather", {"type": "object"}).spec()]
    for kw in (dict(tools=tools), dict(add_generation_prompt=False)):
        assert (template.ChatTemplate(tmpl).render(msgs, **kw)
                == jtemplate.ChatTemplate(tmpl).render(msgs, **kw))
    bad = [{"role": "user", "content": "a"}, {"role": "system", "content": "late"}]
    for mod in (template, jtemplate):
        with pytest.raises(mod.TemplateError, match="system message must be first"):
            mod.validate_messages(bad)


def _golden_parser(mods, entry):
    tmpl_mod, parser_mod, harmony_mod, transform_mod = mods
    if entry.get("style") == "harmony":
        return harmony_mod.HarmonyParser()
    if "parser_config" in entry:
        cfg = entry["parser_config"]
        tcfg = cfg.get("transformation")
        tr = (transform_mod.TransformSchema.from_json(tcfg["schema"]), tcfg["pipeline"]) \
            if tcfg else None
        return parser_mod.StreamParser(parser_mod.sections_from_config(cfg["sections"]),
                                       transform=tr)
    style = {"qwen": "QWEN_STYLE", "llama": "LLAMA_STYLE"}[entry["style"]]
    return parser_mod.StreamParser(getattr(parser_mod, style))


def _events(p, text):
    out = []
    for ch in text:
        out += [(ev.kind, ev.delta, ev.tool_call) for ev in p.push(ch)]
    out += [(ev.kind, ev.delta, ev.tool_call) for ev in p.finish()]
    calls = [(tc.name, tc.arguments, tc.raw) for tc in p.tool_calls]
    return out, p.text, p.reasoning, calls


@pytest.mark.parametrize("entry", GOLDEN, ids=[e["family"] for e in GOLDEN])
def test_golden_parser_events_match_one_character_at_a_time(entry):
    want = _events(_golden_parser((jtemplate, jparser, jharmony, jtransform), entry),
                   entry["completion"])
    got = _events(_golden_parser((template, parser, harmony, transform), entry),
                  entry["completion"])
    assert got == want
    assert [c[0] for c in got[3]] == entry["expectations"]["tool_call_names"]


def test_stop_strings_and_parser_config_match():
    for stops, text in ((["</s>", "END"], "abc</sEND tail"), (["\n\n"], "one\ntwo\n\nthree"),
                        (["zz"], "no stop here")):
        got, want = parser.StopStrings(stops), jparser.StopStrings(stops)
        steps = [(got.push(ch), want.push(ch)) for ch in text]
        assert all(a == b for a, b in steps)
        assert got.finish() == want.finish()
    assert parser.load_parser_config("") == jparser.load_parser_config("") is None


TRANSFORM_CASES = [
    ({"main": [{"type": "parse_json"}, {"type": "get", "key": "function"},
               {"type": "object", "fields": {
                   "name": [{"type": "get", "key": "name"}],
                   "arguments": [{"type": "get", "key": "args"},
                                 {"type": "default", "value": {}}]},
                "required": ["arguments"]}]},
     "main", ['{"function": {"name": "search", "args": {"q": "x"}}}', '{"function": {}}',
              '{"function": 3}']),
    ({"p": [{"type": "get", "path": ["a", 1, "b"]}], "f": [{"type": "first"}]},
     "p", [{"a": [{}, {"b": 7}]}, {"a": []}, "x"]),
    ({"calls": [{"type": "regex_find_all", "pattern": r"(\w+\([^)]*\))"},
                {"type": "each", "apply": [{"type": "regex_replace", "pattern": r"^(\w+)\(.*$",
                                            "template": "$1"}]}]},
     "calls", ['foo(a=1) bar(b="x")', "", "nothing"]),
]


@pytest.mark.parametrize("schema,pipeline,inputs", TRANSFORM_CASES,
                         ids=["object", "path_first", "regex_each"])
def test_transform_schema_results_match(schema, pipeline, inputs):
    got, want = transform.TransformSchema(schema), jtransform.TransformSchema(schema)
    for value in inputs:
        assert got.execute(pipeline, value) == want.execute(pipeline, value)
    assert transform.repair_json('{"a": [1, 2') == jtransform.repair_json('{"a": [1, 2')
    with pytest.raises(transform.TransformError):
        got.execute(pipeline, "not json") if pipeline == "main" else got.execute("nope", 1)


# -- tokenizer ----------------------------------------------------------------


def test_tokenizer_and_stream_decoder_match(chat_dir):
    tok, jtok = Tokenizer(chat_dir), JaxTokenizer(chat_dir)
    text = "<|user|>hello world, the quick brown fox 42 héllo ✓<|end|><|assistant|>"
    ids = tok.encode(text)
    assert ids == jtok.encode(text)
    assert tok.decode(ids) == jtok.decode(ids) == text
    assert tok.decode(ids, skip_special_tokens=True) == jtok.decode(ids, skip_special_tokens=True)
    assert tok.vocab_size == jtok.vocab_size
    assert tok.special_token_strings == jtok.special_token_strings
    assert tok.eos_token_ids == jtok.eos_token_ids == [tok.token_to_id("<|end|>")]
    assert tok.chat_template == jtok.chat_template == jsynth.SYNTH_CHAT_TEMPLATE
    sd, jsd = StreamDecoder(tok), StreamDecoder(jtok)
    assert [sd.push(i) for i in ids] == [jsd.push(i) for i in ids]


# -- chat session ------------------------------------------------------------------


def test_reply_tokens_and_text_match_jax_turn_after_turn(lm, jax_lm, chat_dir):
    s, js = ChatSession(lm, Tokenizer(chat_dir)), JaxChatSession(jax_lm, JaxTokenizer(chat_dir))
    for msg in ("hello world", "and the weather?"):
        r = s.reply(msg, max_new_tokens=12, sampling=SamplingParams())
        jr = js.reply(msg, max_new_tokens=12, sampling=SamplingParams())
        assert r.tokens == jr.tokens and len(r.tokens) > 0
        assert (r.text, r.reasoning, r.finish_reason) == (jr.text, jr.reasoning, jr.finish_reason)
        assert (r.stats.tokens_count_input, r.stats.tokens_count_output) == \
            (jr.stats.tokens_count_input, jr.stats.tokens_count_output)
    assert s.messages == js.messages
    assert s._state_tokens == js._state_tokens


def test_prefix_reuse_equals_a_fresh_replay(lm, chat_dir, monkeypatch):
    tok = Tokenizer(chat_dir)
    s = ChatSession(lm, tok)
    # one new token: the kept state covers the rendered prompt alone, which
    # the next turn's render extends
    s.reply("hello", max_new_tokens=1, sampling=SamplingParams())
    covered = list(s._state_tokens)
    assert int(s._state["pos"]) == len(covered) > 0
    fed = []
    real = lm.generate_resumable
    monkeypatch.setattr(lm, "generate_resumable", lambda **kw: fed.append(
        len(kw["prompt_tokens"])) or real(**kw))
    r2 = s.reply("again", max_new_tokens=8, sampling=SamplingParams())
    monkeypatch.undo()
    assert s._state_tokens[:len(covered)] == covered
    assert fed == [r2.stats.tokens_count_input - len(covered)]  # the suffix alone
    fresh = ChatSession(lm, tok)
    fresh.messages = list(s.messages[:-1])
    for _ in fresh.stream(None, max_new_tokens=8, sampling=SamplingParams(),
                          _internal_messages=fresh.messages):
        pass
    assert fresh.last_reply.tokens == r2.tokens


def test_tool_loop_runs_the_bound_tool(lm, chat_dir):
    calls = []

    def get_weather(city: str):
        calls.append(city)
        return {"temp_c": 21, "city": city}

    tool = ToolSpec("get_weather", "get weather",
                    {"type": "object", "properties": {"city": {"type": "string"}}}, get_weather)
    s = ChatSession(lm, Tokenizer(chat_dir), tools=[tool])
    real_stream, scripted = s.stream, []

    def stream(message, **kw):
        yield from real_stream(message, **kw)
        if not scripted:  # the first turn calls the tool
            scripted.append(1)
            s.last_reply.tool_calls = [ToolCall("get_weather", {"city": "Paris"}, "")]
            s.last_reply.finish_reason = "tool_calls"

    s.stream = stream
    reply = s.reply("weather in paris?", max_new_tokens=6, sampling=SamplingParams())
    assert calls == ["Paris"]
    assert reply.finish_reason in ("stop", "length")
    roles = [m["role"] for m in s.messages]
    assert roles == ["user", "assistant", "tool", "assistant"]
    assert json.loads(s.messages[2]["content"]) == {"temp_c": 21, "city": "Paris"}


@pytest.mark.parametrize("speculator", ["self", "fused-ngram", "ngram"])
def test_speculative_session_equals_plain(lm, chat_dir, speculator):
    tok = Tokenizer(chat_dir)
    spec = NgramSpeculator(k=4) if speculator == "ngram" else speculator
    plain, fast = ChatSession(lm, tok), ChatSession(lm, tok, speculator=spec)
    for msg in ("hello hello hello", "again"):
        want = plain.reply(msg, max_new_tokens=10, sampling=SamplingParams())
        got = fast.reply(msg, max_new_tokens=10, sampling=SamplingParams())
        assert got.tokens == want.tokens and got.text == want.text
    assert fast.last_reply.stats.tokens_proposed >= fast.last_reply.stats.tokens_accepted >= 0
    assert fast._state is not None  # the speculative turn kept its prefix cache


def test_grammar_turn_matches_jax_and_satisfies_the_schema(lm, jax_lm, chat_dir):
    tok, jtok = Tokenizer(chat_dir), JaxTokenizer(chat_dir)
    kw = dict(max_new_tokens=48, sampling=SamplingParams())
    r = ChatSession(lm, tok).reply(
        "plan a trip", grammar=GrammarSession(tok, schema=SCHEMA, any_whitespace=False), **kw)
    jr = JaxChatSession(jax_lm, jtok).reply(
        "plan a trip", grammar=JaxGrammar(jtok, schema=SCHEMA, any_whitespace=False), **kw)
    assert r.tokens == jr.tokens and r.text == jr.text
    value = json.loads(r.text)
    assert value["city"] in ("Paris", "Rome") and 1 <= value["days"] <= 30
    assert JsonMatcher(SCHEMA).feed_text(r.text)


def test_harmony_stop_ids_match_jax(lm, jax_lm, chat_dir):
    s = ChatSession(lm, Tokenizer(chat_dir), encoding="harmony")
    js = JaxChatSession(jax_lm, JaxTokenizer(chat_dir), encoding="harmony")
    assert s._stop_ids() == js._stop_ids()
    tok = Tokenizer(chat_dir)
    assert {tok.token_to_id("<|return|>"), tok.token_to_id("<|call|>")} <= set(s._stop_ids())


def test_logprobs_need_a_plain_turn(lm, chat_dir):
    s = ChatSession(lm, Tokenizer(chat_dir), speculator="self")
    with pytest.raises(ValueError, match="logprobs"):
        s.reply("hi", max_new_tokens=4, logprobs=2)
    r = ChatSession(lm, Tokenizer(chat_dir)).reply("hi", max_new_tokens=4, logprobs=2)
    assert len(r.logprob_content) == len(r.tokens)
    assert all(len(tops) == 2 for _, tops in r.logprob_content)


# -- text to speech ----------------------------------------------------------------


def test_tts_session_streams_cancels_and_folds():
    session = TextToSpeechSession(sine_test_synthesizer(chunk_ms=50))
    chunks = list(session.synthesize_stream("one two three"))
    assert len(chunks) == 3 and session.state == "idle"
    assert chunks[-1].stats.audio_seconds == pytest.approx(0.15)
    cancel = CancelToken()
    got = []
    for out in session.synthesize_stream("a b c d", cancel):
        got.append(out)
        cancel.cancel()
    assert len(got) == 1
    whole = session.synthesize("one two")
    assert len(whole.pcm.samples) == 2 * 800 and whole.pcm.sample_rate == 16000


def test_token_lm_synthesizer_matches_jax(lm, jax_lm, chat_dir):
    book = codebook_sine(CHAT["vocab_size"], frame_len=64)
    kw = dict(max_frames=20, tokens_per_chunk=8, seed=3)
    got = list(TokenLMSynthesizer(lm, Tokenizer(chat_dir), book, **kw)("hello world"))
    want = list(JaxTokenLMSynthesizer(jax_lm, JaxTokenizer(chat_dir), book, **kw)("hello world"))
    assert len(got) == len(want) > 1
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.samples, b.samples)
    out = TextToSpeechSession(TokenLMSynthesizer(lm, Tokenizer(chat_dir), book, **kw)).synthesize(
        "hello world")
    assert np.isfinite(out.pcm.samples).all() and out.stats.audio_seconds > 0
