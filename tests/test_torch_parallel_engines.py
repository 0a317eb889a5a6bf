"""The port's engines, servers and CLI over a (dp, tp) mesh of CPU ranks.

Mirrors the product-surface cases of `tests/test_parallel.py`
(`LanguageModel(tp=, dp=)`, the dense, paged and speculative batch
engines, the batched server and `cli bench --tp --dp`), with the JAX
tests' tp=4, dp=2 meshes as tp=2, dp=2 (and tp=4) worlds of 4 gloo
ranks. Greedy streams, single and through every engine, equal the JAX
package's single streams on one device; sampled streams equal the port's
unsharded ones (the port's sampling keys are its own); the ranks' streams
are bitwise one.
"""

import json
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest

from torch_parallel_pool import RankPool
from uzu_tpu import LanguageModel as JaxLM
from uzu_tpu.tools import synth as jsynth

import torch_parallel_cases as cases

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROMPTS = [[1, 2, 3], [9, 8, 7, 6], [42, 17], [5, 5, 5, 5, 5]]


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    p = RankPool(4, str(tmp_path_factory.mktemp("ranks")))
    yield p
    p.close()


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    cfg = jsynth.llama_config(num_layers=2, model_dim=64, hidden_dim=128, num_heads=8,
                              num_groups=4, head_dim=16, vocab_size=256, tied=False)
    return jsynth.synthesize(cfg, str(tmp_path_factory.mktemp("tp_llama")), seed=3,
                             dtype=np.float32)


@pytest.fixture(scope="module")
def chat_dir(tmp_path_factory):
    return jsynth.synth_chat_model(str(tmp_path_factory.mktemp("tp_chat")), num_layers=2,
                                   model_dim=64, hidden_dim=128, num_heads=8, num_groups=4,
                                   head_dim=16)


def _jax_greedy(model_dir, prompts, n):
    """The JAX package's greedy single stream of each prompt."""
    lm = JaxLM.from_dir(model_dir, max_context=64, prefill_buckets=(16,))
    return [lm.generate_list(np.asarray(p), n, stop_token_ids=[]) for p in prompts]


def _one(streams):
    """The ranks' results, asserted bitwise equal."""
    for s in streams[1:]:
        assert s == streams[0]
    return streams[0]


def test_language_model_tp_streams_identical(pool, model_dir):
    """test_language_model_tp_streams_identical: greedy equals the JAX
    stream; sampled equals the port's unsharded sampled stream."""
    toks = [1, 2, 3, 4, 5]
    want, = _jax_greedy(model_dir, [toks], 10)
    assert _one(pool.run("lm_streams", model_dir, 2, 2, toks, 10)) == want
    sp = dict(temperature=0.9, top_p=0.9)
    want_s = cases.lm_streams(model_dir, None, None, toks, 10, sampling=sp, seed=7)
    assert _one(pool.run("lm_streams", model_dir, 2, 2, toks, 10, sampling=sp, seed=7)) == want_s


def test_batch_engine_over_mesh(pool, model_dir):
    """test_batch_engine_over_mesh: 4 requests through 2 slots at tp=2, dp=2."""
    kw = dict(batch_size=2, decode_chunk=4)
    want = _jax_greedy(model_dir, PROMPTS, 8)
    assert _one(pool.run("engine_streams", model_dir, "dense", 2, 2, PROMPTS, 8, **kw)) == want


def test_batch_engine_sampled_over_mesh(pool, model_dir):
    """Sampled requests, each with its own seed, over 4 slots at tp=2, dp=2."""
    kw = dict(batch_size=4, decode_chunk=4, seeds=[3, 4, 5, 6],
              sampling=dict(temperature=0.8, top_k=20))
    want = cases.engine_streams(model_dir, "dense", None, None, PROMPTS, 8, **kw)
    assert _one(pool.run("engine_streams", model_dir, "dense", 2, 2, PROMPTS, 8, **kw)) == want


def test_batch_engine_refuses_slots_indivisible_by_dp(pool, model_dir):
    msgs = pool.run("engine_refuses", model_dir, 2, 2, 3)
    assert all("multiple of the mesh's dp=2" in m for m in msgs), msgs


@pytest.mark.parametrize("tp,dp", [(4, 1), (2, 2)])
def test_paged_engine_over_mesh(pool, model_dir, tp, dp):
    """test_paged_engine_over_mesh: page pools split on the KV-group dim."""
    kw = dict(batch_size=2, decode_chunk=4, num_pages=17, page_size=8)
    want = _jax_greedy(model_dir, PROMPTS[:3], 8)
    got = pool.run("engine_streams", model_dir, "paged", tp, dp, PROMPTS[:3], 8, **kw)
    assert _one(got) == want


@pytest.mark.parametrize("kind,kw", [
    ("spec", dict(batch_size=2, draft_block=3, draft_layers=1)),
    ("spec_paged", dict(batch_size=2, draft_block=3, num_pages=24, page_size=8)),
])
def test_spec_batch_engines_over_mesh(pool, model_dir, kind, kw):
    """test_spec_batch_engine_over_mesh, and the paged speculative engine:
    verify and commit on the tp shards."""
    prompts = [[5, 6, 5, 6, 5], [1, 2, 3], [9, 9, 9, 9], [40, 41, 42]]
    want = _jax_greedy(model_dir, prompts, 8)
    assert _one(pool.run("engine_streams", model_dir, kind, 2, 2, prompts, 8, **kw)) == want


@pytest.mark.parametrize("batched", [True, False])
def test_server_over_mesh(pool, chat_dir, batched):
    """test_batched_server_over_mesh (and the single-session server): rank 0
    answers over HTTP while the other ranks replay its requests."""
    body = {"messages": [{"role": "user", "content": "hi"}], "max_tokens": 6}
    out = pool.run("serve_chat", chat_dir, 2, 2, batched, body)
    assert out[1:] == [None] * 3
    assert out[0]["usage"]["completion_tokens"] > 0
    assert out[0]["choices"][0]["finish_reason"] in ("stop", "length")


@pytest.mark.parametrize("batched", [True, False])
@pytest.mark.parametrize("fault_ranks", [(0, 1), (1,)])
def test_server_fault_is_fatal(chat_dir, tmp_path, batched, fault_ranks):
    """An exception where a request runs, on every rank alike or on the
    follower alone, ends the lockstep at once: rank 0 answers the request
    with an error (the batched server: finish_reason "error"; the single
    session: HTTP 500) and refuses the next one, and the follower raises
    out of its loop instead of hanging in a collective."""
    pool = RankPool(2, str(tmp_path))
    try:
        t0 = time.perf_counter()
        body = {"messages": [{"role": "user", "content": "hi"}], "max_tokens": 6}
        lead, follower = pool.run("serve_fault", chat_dir, batched, fault_ranks, body)
        assert time.perf_counter() - t0 < 60
    finally:
        pool.close()
    (code, out), second, n_errors = lead
    if batched:
        assert code == 200 and out["choices"][0]["finish_reason"] == "error"
        assert n_errors == 1
    else:
        assert code == 500
    assert second == 500
    assert follower.startswith("raised"), follower


def _cli(args, **kw):
    env = dict(os.environ, PYTHONPATH=REPO)
    return subprocess.run([sys.executable, "-m", "uzu_tpu_torch.cli", *args], cwd=REPO,
                          env=env, capture_output=True, text=True, timeout=180, **kw)


def test_cli_bench_tp(chat_dir, tmp_path):
    """test_cli_bench_tp: the CLI spawns its 3 followers and runs as rank 0."""
    task = tmp_path / "task.json"
    task.write_text(json.dumps({"messages": [{"role": "user", "content": "hello"}],
                                "tokens_limit": 8, "number_of_runs": 1}))
    out = tmp_path / "out.json"
    r = _cli(["bench", chat_dir, str(task), str(out), "--max-context", "256", "--tp", "2",
              "--dp", "2", "--device", "cpu"])
    assert r.returncode == 0, r.stderr[-3000:]
    rep = json.loads(out.read_text())
    assert rep["tokens_count_output"] > 0
    assert r.stdout.count("decode_tok_s") == 1  # rank 0 alone prints


def test_cli_ppl_and_chat_tp(chat_dir, tmp_path):
    """`ppl` and `chat` with --tp: the NLL matches the unsharded one; a chat
    line read by rank 0 reaches the followers."""
    text = tmp_path / "text.txt"
    text.write_text("hello world, hello tensor parallel ranks")
    base = ["ppl", chat_dir, str(text), "--max-context", "256", "--device", "cpu"]
    one, two = _cli(base), _cli(base + ["--tp", "2"])
    assert one.returncode == 0 and two.returncode == 0, two.stderr[-3000:]
    a, b = json.loads(one.stdout.strip().splitlines()[-1]), json.loads(two.stdout.strip()
                                                                        .splitlines()[-1])
    assert a.keys() == b.keys()
    # bf16 activations: tp=2 rounds each rank's partial sum before the
    # all-reduce, so the NLL moves by bf16 rounding (~1e-4 here)
    for k in a:
        if isinstance(a[k], float):
            assert abs(a[k] - b[k]) <= 2e-3 * max(1.0, abs(a[k])), (k, a[k], b[k])
    r = _cli(["chat", chat_dir, "--max-tokens", "4", "--max-context", "256", "--tp", "2",
              "--device", "cpu"], input="hello\n")
    assert r.returncode == 0, r.stderr[-3000:]
    assert "tok/s]" in r.stdout


def test_cli_serve_tp(chat_dir):
    """`serve --batched --tp 2`: rank 0 answers over HTTP; an interrupt stops
    the followers and the command exits 0."""
    import urllib.request

    env = dict(os.environ, PYTHONPATH=REPO, PYTHONUNBUFFERED="1")
    p = subprocess.Popen([sys.executable, "-m", "uzu_tpu_torch.cli", "serve", chat_dir,
                          "--port", "0", "--batched", "--batch-size", "2", "--max-context",
                          "256", "--tp", "2", "--device", "cpu"],
                         cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                         text=True)
    try:
        line = p.stdout.readline()
        assert "serving" in line, (line, p.stderr.read()[-3000:] if p.poll() else "")
        base = line.split()[-1]
        req = urllib.request.Request(
            f"{base}/chat/completions",
            data=json.dumps({"messages": [{"role": "user", "content": "hi"}],
                             "max_tokens": 4}).encode())
        with urllib.request.urlopen(req, timeout=120) as r:
            assert json.load(r)["usage"]["completion_tokens"] > 0
        p.send_signal(signal.SIGINT)
        assert p.wait(timeout=60) == 0
    finally:
        if p.poll() is None:
            p.kill()
            time.sleep(0.5)
