"""The port's OpenAI servers (`uzu_tpu_torch/server/`) end to end over HTTP
on 127.0.0.1, on the CPU.

The single-stream server answers plain, streamed (SSE), logprob, stop
string, tool and `response_format` requests with the JAX package's server's
bodies on the same tiny f32 chat model. The batched server picks its
engine as the JAX one does, and its concurrent responses and streams equal
what the port's engine gives for the same prompts run directly. The
remote backend reads the port's own server.
"""

import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from uzu_tpu import LanguageModel as JaxLM
from uzu_tpu.server import serve as jax_serve
from uzu_tpu.sessions import ChatSession as JaxChatSession
from uzu_tpu.sessions import Tokenizer as JaxTokenizer
from uzu_tpu.tools import synth as jsynth
from uzu_tpu_torch import LanguageModel, RemoteChatSession, RemoteConfig
from uzu_tpu_torch.engine.batch import BatchEngine
from uzu_tpu_torch.engine.batch_spec import SpeculativeBatchEngine
from uzu_tpu_torch.engine.paged_batch import PagedBatchEngine
from uzu_tpu_torch.engine.sampling import SamplingParams
from uzu_tpu_torch.server import serve, serve_batched
from uzu_tpu_torch.sessions import ChatSession, StreamDecoder, StreamParser, Tokenizer

torch.set_num_threads(1)

CHAT = dict(num_layers=2, model_dim=64, hidden_dim=160, num_heads=4, num_groups=2,
            head_dim=16, vocab_size=512, tied=False)
LM_KW = dict(max_context=256, prefill_buckets=(16, 64))
SCHEMA = {"type": "object",
          "properties": {"city": {"enum": ["Paris", "Rome"]},
                         "days": {"type": "integer", "minimum": 1, "maximum": 30}},
          "required": ["city", "days"]}
TOOLS = [{"type": "function", "function": {"name": "get_weather", "description": "w",
                                           "parameters": {"type": "object"}}}]
MSGS = [{"role": "system", "content": "be brief"}, {"role": "user", "content": "hello world"}]
REQUESTS = {
    "plain": dict(messages=MSGS, max_tokens=10),
    "stream": dict(messages=MSGS, max_tokens=10, stream=True,
                   stream_options={"include_usage": True}),
    "logprobs": dict(messages=MSGS, max_tokens=6, logprobs=True, top_logprobs=3),
    "stop": dict(messages=MSGS, max_tokens=16, stop=["e", "zz"]),
    "tools": dict(messages=MSGS, max_tokens=8, tools=TOOLS, tool_choice="auto"),
    "json": dict(messages=MSGS, max_tokens=40, response_format={
        "type": "json_schema", "json_schema": {"schema": SCHEMA}, "any_whitespace": False}),
}


@pytest.fixture(scope="module")
def chat_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("torch_server"))
    jsynth.synthesize(jsynth.llama_config(**CHAT), d, seed=5, dtype=np.float32)
    jsynth.synth_tokenizer(d, vocab_size=CHAT["vocab_size"])
    with open(f"{d}/config.json") as f:
        raw = json.load(f)
    raw["generation_config"]["stop_token_ids"] = JaxTokenizer(d).eos_token_ids
    with open(f"{d}/config.json", "w") as f:
        json.dump(raw, f, indent=1)
    return d


@pytest.fixture(scope="module")
def lm(chat_dir):
    return LanguageModel.from_dir(chat_dir, device="cpu", **LM_KW)


@pytest.fixture(scope="module")
def servers(chat_dir, lm):
    """(port's server, JAX package's server) base URLs."""
    ours = serve(ChatSession(lm, Tokenizer(chat_dir)), port=0)
    theirs = jax_serve(JaxChatSession(JaxLM.from_dir(chat_dir, **LM_KW),
                                      JaxTokenizer(chat_dir)), port=0)
    yield [f"http://127.0.0.1:{h.server_address[1]}" for h in (ours, theirs)]
    for h in (ours, theirs):
        h.shutdown()
        h.server_close()


def _post(base, body):
    req = urllib.request.Request(f"{base}/v1/chat/completions", data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        if body.get("stream"):
            lines = [ln for ln in r.read().decode().splitlines() if ln.startswith("data: ")]
            assert lines[-1] == "data: [DONE]"
            return [json.loads(ln[6:]) for ln in lines[:-1]]
        return json.load(r)


def _same(a, b, path="body"):
    """Equal bodies, the request id and clock aside; log-probabilities
    (f32 in both packages) within 1e-4."""
    if isinstance(a, dict) and isinstance(b, dict):
        keys = set(a) - {"id", "created"}
        assert keys == set(b) - {"id", "created"}, path
        for k in keys:
            _same(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, list) and isinstance(b, list):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{path}[{i}]")
    elif isinstance(a, float) and isinstance(b, float):
        assert a == pytest.approx(b, abs=1e-4), path
    else:
        assert a == b, path


@pytest.mark.parametrize("name", sorted(REQUESTS))
def test_single_stream_server_answers_as_jax_does(servers, name):
    ours, theirs = (_post(base, REQUESTS[name]) for base in servers)
    _same(ours, theirs)
    if name == "stream":
        text = "".join(c["choices"][0]["delta"].get("content", "") for c in ours if c["choices"])
        assert ours[-1]["usage"]["completion_tokens"] > 0 and isinstance(text, str)
    elif name == "json":
        value = json.loads(ours["choices"][0]["message"]["content"])
        assert value["city"] in ("Paris", "Rome") and 1 <= value["days"] <= 30
    elif name == "logprobs":
        content = ours["choices"][0]["logprobs"]["content"]
        assert len(content) == ours["usage"]["completion_tokens"]
        assert all(len(e["top_logprobs"]) == 3 for e in content)
    elif name == "stop":
        assert "e" not in ours["choices"][0]["message"]["content"]


def test_single_stream_server_refuses_bad_requests(servers):
    for body in (dict(messages=MSGS, max_tokens=0), dict(messages=MSGS, stop=5),
                 dict(messages=MSGS, response_format={"type": "yaml"})):
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(servers[0], body)
        assert e.value.code == 400
    with urllib.request.urlopen(f"{servers[0]}/v1/models") as r:
        assert json.load(r)["data"][0]["id"] == "uzu-tpu"


def test_remote_session_reads_the_ports_server(servers):
    remote = RemoteChatSession(RemoteConfig(api_endpoint=servers[0] + "/v1", model="uzu-tpu"))
    reply = remote.reply(MSGS, max_tokens=10)
    direct = _post(servers[0], REQUESTS["plain"])["choices"][0]
    assert reply.text == direct["message"]["content"]
    assert reply.finish_reason == direct["finish_reason"]
    deltas = list(remote.stream(MSGS, max_tokens=10))
    assert "".join(d.text for d in deltas) == reply.text
    assert deltas[-1].finish_reason == direct["finish_reason"]


# -- the batched server ---------------------------------------------------------------


def _engine_contents(lm, tok, engine_cls, prompts, max_tokens, **kw):
    """The message contents the port's engine gives for `prompts` run
    directly: its greedy tokens through the server's decoder and parser."""
    stop = list(lm.config.generation_config.stop_token_ids)
    eng = engine_cls(lm, stop_token_ids=stop, sampling=SamplingParams(), **kw)
    reqs = [eng.submit(p, max_tokens) for p in prompts]
    eng.run()
    out = []
    for r in reqs:
        dec, parser = StreamDecoder(tok), StreamParser()
        for t in r.tokens:
            for _ in parser.push(dec.push(t)):
                pass
        for _ in parser.finish():
            pass
        out.append(parser.text)
    return out


@pytest.mark.parametrize("batch_size,cls", [(2, BatchEngine), (8, PagedBatchEngine)],
                         ids=["dense", "paged"])
def test_batched_server_streams_equal_the_engines(lm, chat_dir, batch_size, cls):
    tok = Tokenizer(chat_dir)
    httpd = serve_batched(lm, tok, port=0, batch_size=batch_size, decode_chunk=4)
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    server = httpd.batch_server
    try:
        assert type(server.engine) is cls
        users = ["hello world", "the quick brown fox", "tool call name", "42 100", "step"]
        bodies = [dict(messages=[{"role": "user", "content": u}], max_tokens=12,
                       stream=i % 2 == 1) for i, u in enumerate(users)]
        results = [None] * len(bodies)

        def send(i):
            results[i] = _post(base, bodies[i])

        threads = [threading.Thread(target=send, args=(i,)) for i in range(len(bodies))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
        prompts = [tok.encode(server.template.render(b["messages"])) for b in bodies]
        want = _engine_contents(lm, tok, cls, prompts, 12, batch_size=batch_size,
                                decode_chunk=4)
        for body, res, w in zip(bodies, results, want):
            if body["stream"]:
                got = "".join(c["choices"][0]["delta"].get("content", "") for c in res)
                finish = res[-1]["choices"][0]["finish_reason"]
            else:
                got, finish = res["choices"][0]["message"]["content"], \
                    res["choices"][0]["finish_reason"]
            assert got == w and finish in ("stop", "length")
        with urllib.request.urlopen(f"{base}/v1/stats") as r:
            stats = json.load(r)
        assert stats["engine"] == cls.__name__ and stats["active_slots"] == 0
        if cls is PagedBatchEngine:
            # the plain paged engine refuses grammar requests, as the JAX one does
            with pytest.raises(urllib.error.HTTPError) as e:
                _post(base, REQUESTS["json"])
            assert e.value.code == 400
        assert server.errors == []
    finally:
        server.shutdown()
        httpd.shutdown()
        httpd.server_close()


def test_speculative_batched_server_serves_grammar_and_logprobs(lm, chat_dir):
    tok = Tokenizer(chat_dir)
    httpd = serve_batched(lm, tok, port=0, batch_size=2, speculate=True)
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        assert type(httpd.batch_server.engine) is SpeculativeBatchEngine
        value = json.loads(_post(base, REQUESTS["json"])["choices"][0]["message"]["content"])
        assert value["city"] in ("Paris", "Rome") and 1 <= value["days"] <= 30
        lp = _post(base, REQUESTS["logprobs"])
        assert len(lp["choices"][0]["logprobs"]["content"]) == lp["usage"]["completion_tokens"]
        stopped = _post(base, REQUESTS["stop"])["choices"][0]
        assert "e" not in stopped["message"]["content"]
        assert httpd.batch_server.errors == []
    finally:
        httpd.batch_server.shutdown()
        httpd.shutdown()
        httpd.server_close()


def test_scheduler_error_cancels_requests_and_keeps_the_traceback(lm, chat_dir, capsys):
    httpd = serve_batched(lm, Tokenizer(chat_dir), port=0, batch_size=2)
    server = httpd.batch_server
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    real_step = server.engine.step

    def failing_step():
        raise RuntimeError("planted engine fault")

    try:
        server.engine.step = failing_step
        res = _post(base, REQUESTS["plain"])
        assert res["choices"][0]["finish_reason"] == "error"
        assert len(server.errors) >= 1 and "planted engine fault" in server.errors[0]
        server.engine.step = real_step  # scheduling goes on for fresh requests
        assert _post(base, REQUESTS["plain"])["choices"][0]["finish_reason"] in ("stop",
                                                                                 "length")
    finally:
        server.shutdown()
        httpd.shutdown()
        httpd.server_close()
    assert "planted engine fault" in capsys.readouterr().err
