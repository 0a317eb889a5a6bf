"""Rank-side cases of the port's multi-rank tests (`torch_parallel_pool`).

Each function runs on every rank of a gloo process group on the CPU and
returns what the test compares: numpy arrays and plain lists. They import
torch and the port only.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from uzu_tpu_torch import LanguageModel


def _lm(model_dir, **kw):
    kw.setdefault("max_context", 64)
    kw.setdefault("prefill_buckets", (16,))
    return LanguageModel.from_dir(model_dir, device="cpu", **kw)


def _prefill_logits(lm, toks) -> np.ndarray:
    logits, _ = lm.prefill(lm.new_state(), np.asarray(toks))
    return logits.float().numpy()


def rank_info() -> tuple[int, int]:
    return dist.get_rank(), dist.get_world_size()


def tp_logits(model_dir: str, tp: int, dp: int, toks, **kw) -> np.ndarray:
    """Prefill logits of a (dp, tp)-sharded model."""
    return _prefill_logits(_lm(model_dir, tp=tp, dp=dp, **kw), toks)


def tp_stream(model_dir: str, tp: int, dp: int, toks, n: int, sampling=None, seed: int = 0,
              **kw) -> list[int]:
    lm = _lm(model_dir, tp=tp, dp=dp, **kw)
    return lm.generate_list(np.asarray(toks), n, stop_token_ids=[], sampling=sampling,
                            seed=seed)


def _all_gather_rows(t: torch.Tensor, group) -> torch.Tensor:
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.cat(parts)


def dp_batched_prefill(model_dir: str, tp: int, dp: int, toks) -> np.ndarray:
    """One sequence per dp rank: a full batched state cut by `shard_state`
    (slots over dp, KV over tp), each rank's sequence prefilled, the
    logits all-gathered over dp -> [B, V]."""
    from uzu_tpu_torch.models.decoder import decoder_forward
    from uzu_tpu_torch.models.state import init_state
    from uzu_tpu_torch.parallel import make_mesh, shard_state
    from uzu_tpu_torch.parallel.distributed import process_local_batch_slots

    mesh = make_mesh(tp=tp, dp=dp, device_type="cpu")
    lm = _lm(model_dir, mesh=mesh)
    toks = np.asarray(toks)
    b = toks.shape[0]
    full = lm.config.decoder_config
    one = init_state(full, lm.max_context, device="cpu")
    states = {"layers": [None if ls is None else {k: v[None].repeat(b, *[1] * v.dim())
                                                  for k, v in ls.items()}
                         for ls in one["layers"]],
              "pos": one["pos"][None].repeat(b)}
    local = shard_state(full, states, mesh, batched=True)
    start, per = process_local_batch_slots(b, mesh)
    assert local["pos"].shape[0] == per
    rows = []
    for j in range(per):
        st = {"layers": [None if ls is None else {k: v[j] for k, v in ls.items()}
                         for ls in local["layers"]], "pos": local["pos"][j]}
        logits, _ = decoder_forward(lm.decoder_config, lm.params,
                                    torch.from_numpy(toks[start + j]).long(), st,
                                    true_length=toks.shape[1])
        rows.append(logits[0])
    return _all_gather_rows(torch.stack(rows), mesh.get_group("dp")).numpy()


def tp_logits_fault(model_dir: str, tp: int, fault: str, toks) -> np.ndarray:
    """Prefill logits of a tp-sharded model with a planted fault:
    "bias_before_reduce" adds the out projections' biases on every rank
    before the all-reduce; "contiguous_up_gate" cuts the fused [up | gate]
    rows contiguously instead of section by section."""
    from uzu_tpu_torch.parallel import make_mesh
    from uzu_tpu_torch.parallel.mesh import Split, axis_rank
    from uzu_tpu_torch.parallel.sharding import apply_specs, decoder_param_specs

    mesh = make_mesh(tp=tp, dp=dist.get_world_size() // tp, device_type="cpu")
    r, group = axis_rank(mesh, "tp"), mesh.get_group("tp")

    def shard(params):
        specs = decoder_param_specs(full_cfg, params, mesh)
        if fault == "contiguous_up_gate":
            for ls in specs["layers"]:
                ls["mlp"]["up"]["w"] = Split(dim=0)
        out = apply_specs(params, specs, r, tp, group)
        if fault == "bias_before_reduce":
            for layer in out["layers"]:
                lin = layer["mixer"]["out"]
                assert "b" in lin, "the model has no out biases"
                lin["b"] = lin["b"] * tp  # what tp ranks adding it before the sum give
        return out

    ref = _lm(model_dir)
    full_cfg = ref.config.decoder_config
    lm = LanguageModel(ref.config, ref.params, device="cpu", max_context=64,
                       prefill_buckets=(16,), mesh=mesh, shard_fn=shard)
    return _prefill_logits(lm, toks)


def tp_validate(model_dir: str, tp: int) -> str:
    """The ValueError message of sharding the model over tp ranks ('' if
    none)."""
    try:
        _lm(model_dir, tp=tp, dp=dist.get_world_size() // tp)
    except ValueError as e:
        return str(e)
    return ""


def _engine(kind: str, lm, **kw):
    from uzu_tpu_torch.engine.batch import BatchEngine
    from uzu_tpu_torch.engine.batch_spec import (SpeculativeBatchEngine,
                                                 SpeculativePagedBatchEngine)
    from uzu_tpu_torch.engine.paged_batch import PagedBatchEngine

    cls = {"dense": BatchEngine, "paged": PagedBatchEngine, "spec": SpeculativeBatchEngine,
           "spec_paged": SpeculativePagedBatchEngine}[kind]
    return cls(lm, stop_token_ids=[], **kw)


def engine_streams(model_dir: str, kind: str, tp, dp, prompts, n: int, seeds=None,
                   sampling=None, **kw) -> list[list[int]]:
    """Every request's tokens through a batch engine over a (dp, tp) mesh
    (tp None: the unsharded model on this rank)."""
    from uzu_tpu_torch.engine.sampling import SamplingParams

    lm = _lm(model_dir) if tp is None else _lm(model_dir, tp=tp, dp=dp)
    eng = _engine(kind, lm, **kw)
    sp = None if sampling is None else SamplingParams(**sampling)
    reqs = [eng.submit(p, n, seed=0 if seeds is None else seeds[i], sampling=sp)
            for i, p in enumerate(prompts)]
    eng.run()
    assert all(r.finished for r in reqs)
    return [r.tokens for r in reqs]


def engine_refuses(model_dir: str, tp: int, dp: int, batch_size: int) -> str:
    try:
        _engine("dense", _lm(model_dir, tp=tp, dp=dp), batch_size=batch_size)
    except ValueError as e:
        return str(e)
    return ""


def lm_streams(model_dir: str, tp, dp, prompt, n: int, sampling=None, seed: int = 0,
               **kw) -> list[int]:
    from uzu_tpu_torch.engine.sampling import SamplingParams

    lm = _lm(model_dir, tp=tp, dp=dp, **kw)
    sp = None if sampling is None else SamplingParams(**sampling)
    return lm.generate_list(np.asarray(prompt), n, stop_token_ids=[], sampling=sp, seed=seed)


def serve_chat(model_dir: str, tp: int, dp: int, batched: bool, body: dict):
    """Rank 0 serves the model over HTTP and posts `body` to itself; the
    other ranks follow until it shuts down. Rank 0 returns the response."""
    import json
    import urllib.request

    from uzu_tpu_torch.server import serve, serve_batched
    from uzu_tpu_torch.sessions import ChatSession, Tokenizer

    lm = _lm(model_dir, tp=tp, dp=dp, max_context=256, prefill_buckets=(16, 64))
    if batched:
        httpd = serve_batched(lm, Tokenizer(model_dir), port=0, batch_size=2, decode_chunk=4)
    else:
        httpd = serve(ChatSession(lm, Tokenizer(model_dir)), port=0)
    if httpd is None:
        return None  # a follower: rank 0 has shut the server down
    try:
        req = urllib.request.Request(
            f"http://127.0.0.1:{httpd.server_address[1]}/v1/chat/completions",
            data=json.dumps(body).encode(), headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as r:
            out = json.load(r)
    finally:
        if batched:
            httpd.batch_server.shutdown()
            assert not httpd.batch_server.errors, httpd.batch_server.errors
        else:
            httpd.chat_server.stop_followers()
        httpd.shutdown()
    return out


def serve_fault(model_dir: str, batched: bool, fault_ranks, body: dict):
    """A server over tp = the world (batched, or the single session) with
    an exception planted where the ranks `fault_ranks` run a request (the
    engine's step, the session's reply). Rank 0 posts `body` twice and
    returns (the first response's HTTP status and body, the second one's
    status, the number of recorded engine errors or None); another rank
    returns what the server raised, and its process ends (`RankExit`), as
    a CLI rank's does. The lockstep ends failed: the pool is not reused."""
    from uzu_tpu_torch.engine.batch import BatchEngine
    from uzu_tpu_torch.server import serve, serve_batched
    from uzu_tpu_torch.sessions import ChatSession, Tokenizer

    def fault(self, *args, **kw):
        raise RuntimeError("planted fault")

    lm = _lm(model_dir, tp=dist.get_world_size(), max_context=256, prefill_buckets=(16, 64))
    owner, name = (BatchEngine, "step") if batched else (ChatSession, "reply")
    kept = getattr(owner, name)
    if dist.get_rank() in fault_ranks:
        setattr(owner, name, fault)
    try:
        if batched:
            httpd = serve_batched(lm, Tokenizer(model_dir), port=0, batch_size=2,
                                  decode_chunk=4)
        else:
            httpd = serve(ChatSession(lm, Tokenizer(model_dir)), port=0)
        return _post_twice(httpd, body)
    except RuntimeError as e:
        from torch_parallel_pool import RankExit

        return RankExit(f"raised {e}")
    finally:
        setattr(owner, name, kept)


def _post_twice(httpd, body: dict):
    import json
    import urllib.error
    import urllib.request

    if httpd is None:
        return "returned None"
    url = f"http://127.0.0.1:{httpd.server_address[1]}/v1/chat/completions"

    def post():
        req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                     headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=120) as r:
                return r.status, json.load(r)
        except urllib.error.HTTPError as e:
            return e.code, None

    server = getattr(httpd, "batch_server", None)
    try:
        first, second = post(), post()[0]
    finally:
        if server is not None:
            server.shutdown()
        else:
            httpd.chat_server.stop_followers()
        httpd.shutdown()
    return first, second, None if server is None else len(server.errors)


def _world_rows(x: np.ndarray) -> torch.Tensor:
    """This rank's block of rows of x."""
    n, r = dist.get_world_size(), dist.get_rank()
    s = x.shape[0] // n
    return torch.from_numpy(np.ascontiguousarray(x[r * s:(r + 1) * s]))


def ep_forward(model_dir: str, x: np.ndarray, capacity: int) -> np.ndarray:
    """Layer 0's MoE block with its experts split over the world (each
    rank's E/n experts, its x rows), all-gathered -> [S, D]."""
    from uzu_tpu_torch.parallel.expert import moe_forward_ep
    from uzu_tpu_torch.parallel.sharding import cut

    lm = _lm(model_dir)
    cfg = lm.decoder_config.transformer_config.layer_configs[0].mlp_config
    p = lm.params["layers"][0]["mlp"]
    n, r = dist.get_world_size(), dist.get_rank()
    local = {"router": p["router"],
             "up": {k: cut(v, 0, None, r, n) for k, v in p["up"].items()},
             "down": {k: cut(v, 0, None, r, n) for k, v in p["down"].items()}}
    y = moe_forward_ep(cfg, local, _world_rows(x), group=dist.group.WORLD, capacity=capacity)
    return _all_gather_rows(y, dist.group.WORLD).numpy()


def ring(q, k, v, pos, **kw) -> np.ndarray:
    """Ring attention over the world, each rank holding a block of rows."""
    from uzu_tpu_torch.parallel.seqpar import ring_attention

    pl = _world_rows(pos)
    out = ring_attention(_world_rows(q), _world_rows(k), _world_rows(v), pl, pl,
                         group=dist.group.WORLD, **kw)
    return _all_gather_rows(out, dist.group.WORLD).numpy()


def sp_prefill(model_dir: str, toks, next_token=None, **kw):
    """Sequence-parallel prefill over the world: (logits, the logits of one
    decode step of `next_token` from the state it leaves)."""
    from uzu_tpu_torch.models.decoder import decoder_forward
    from uzu_tpu_torch.parallel.seqpar import make_sp_mesh, sequence_parallel_prefill

    lm = _lm(model_dir, **kw)
    mesh = make_sp_mesh(device_type="cpu")
    logits, state = sequence_parallel_prefill(lm.decoder_config, lm.params, lm.new_state(),
                                              toks, mesh)
    nxt = None
    if next_token is not None:
        nxt, _ = decoder_forward(lm.decoder_config, lm.params,
                                 torch.tensor([next_token]), state)
        nxt = nxt[0].numpy()
    return logits.numpy(), nxt


def pp_forward(model_dir: str, pp: int, tp: int, tokens: np.ndarray, feeds,
               microbatches: int = 2, **kw):
    """A pipelined prefill of tokens [B, S], then one decode step of each
    [B] array of `feeds`: (the logits [B, V] of each forward, the unstacked
    layer states' k/v of attention layers, as numpy)."""
    from uzu_tpu_torch.models.state import init_state
    from uzu_tpu_torch.parallel import (make_pp_mesh, pipeline_forward, stack_pipeline_params,
                                        stack_pipeline_states, unstack_pipeline_states)

    lm = _lm(model_dir, max_context=64, prefill_buckets=(8,), **kw)
    cfg = lm.decoder_config
    mesh = make_pp_mesh(pp, tp, device_type="cpu")
    b = tokens.shape[0]
    one = init_state(cfg, lm.max_context, device="cpu")
    states = {"layers": [{k: v[None].repeat(b, *[1] * v.dim()) for k, v in ls.items()}
                         for ls in one["layers"]], "pos": one["pos"][None].repeat(b)}
    pp_params = stack_pipeline_params(cfg, lm.params, mesh)
    pp_states = stack_pipeline_states(cfg, states, mesh, microbatches)
    toks = torch.from_numpy(tokens).long()
    out = []
    for feed in [None, *feeds]:
        if feed is not None:
            toks = torch.from_numpy(np.asarray(feed)).long()[:, None]
        logits, pp_states = pipeline_forward(cfg, pp_params, toks, pp_states, mesh,
                                             microbatches=microbatches)
        out.append(logits.numpy())
    back = unstack_pipeline_states(pp_states, mesh)
    kv = [{k: v.float().numpy() for k, v in ls.items() if k in ("k", "v")}
          for ls in back["layers"]]
    return out, kv


def multihost_dp(model_dir: str, toks: np.ndarray, true_length: int, sharded_load: bool):
    """A (dp=2, tp=2) hybrid mesh over the 4 ranks (tp inside a "host", dp
    across): the params sliced from the full tree every rank read
    (`shard_params_multihost`) or streamed group by group
    (`from_dir_sharded`), one sequence per dp replica (`put_global` of the
    batched state and tokens). Returns (this rank's dp replica, its
    sequence's logits, the load stats, the shapes of layer 0's qkv codes
    or weight: this rank's and the file's)."""
    from uzu_tpu_torch.models.decoder import decoder_forward
    from uzu_tpu_torch.models.state import init_state
    from uzu_tpu_torch.parallel import make_hybrid_mesh, state_specs
    from uzu_tpu_torch.parallel.distributed import put_global, shard_params_multihost
    from uzu_tpu_torch.parallel.mesh import DP_AXIS, Split, axis_rank
    from uzu_tpu_torch.parallel.sharding import local_config

    mesh = make_hybrid_mesh(tp=2, dp=2, device_type="cpu")
    full = _lm(model_dir)
    cfg = full.decoder_config
    stats = None
    if sharded_load:
        lm = LanguageModel.from_dir_sharded(model_dir, mesh, device="cpu", max_context=64,
                                            prefill_buckets=(16,))
        params, lcfg, stats = lm.params, lm.decoder_config, lm.shard_load_stats
    else:
        params = shard_params_multihost(cfg, full.params, mesh)
        lcfg = local_config(cfg, 2, params)
    b = toks.shape[0]
    one = init_state(cfg, 64, device="cpu")
    states = {"layers": [{k: v[None].repeat(b, *[1] * v.dim()) for k, v in ls.items()}
                         for ls in one["layers"]], "pos": one["pos"][None].repeat(b)}
    specs = state_specs(cfg, states, mesh, batched=True)

    def place(t, rules):
        for s in rules:
            t = put_global(t, mesh, s)
        return t

    layers = [{k: place(v, specs["layers"][i][k]) for k, v in ls.items()}
              for i, ls in enumerate(states["layers"])]
    pos = place(states["pos"], specs["pos"])
    mine = put_global(toks, mesh, Split(dim=0, axis=DP_AXIS))
    assert mine.shape[0] == 1
    st = {"layers": [{k: v[0] for k, v in ls.items()} for ls in layers], "pos": pos[0]}
    logits, _ = decoder_forward(lcfg, params, mine[0].long(), st, true_length=true_length)
    w = params["layers"][0]["mixer"]["qkv"]["w"]
    return (axis_rank(mesh, DP_AXIS), logits[0].numpy(), stats,
            (tuple(w.shape), tuple(full.params["layers"][0]["mixer"]["qkv"]["w"].shape)))
