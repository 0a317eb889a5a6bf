"""The closed loop of clients over an engine's `submit` / `step`, and the
benchmark's own spans around the calls into the engine.

Each client sends its next request when its previous one returns: after
every `step()` the loop reads each request in flight, stamps its first
token and its end on the host clock, and submits the finished client's
next request at once. `Spans` wraps the engine's `step`, the prefill
function that every chunk goes through, the decode chunk's dispatch and
the host read of its tokens, and records each call's host interval (and,
when asked, CUDA events around the prefill and decode calls, read after
the window, for their stream time).
"""

from __future__ import annotations

import time

import numpy as np
import torch


class Spans:
    """Host spans: (kind, t0, t1, info) with kind in "step", "prefill",
    "decode", "read"; perf_counter seconds."""

    def __init__(self, engine, adapter, lm, events: bool):
        self.rows: list = []
        self.events = events and lm.device.type == "cuda"
        self._undo = []
        self._wrap(engine, "step", "step", lambda a: None)
        self._wrap(engine, "_process_emitted", "read", lambda a: None)
        self._wrap(engine, "_dispatch_decode", "decode", lambda a: self._decode_info(engine),
                   timed=True)
        if adapter.PREFILL is None:
            self._wrap(lm, "_forward", "prefill", lambda a: adapter.prefill_call(engine, a),
                       timed=True, instance=True)
        else:
            module, attr = adapter.PREFILL
            self._wrap(module, attr, "prefill", lambda a: adapter.prefill_call(engine, a),
                       timed=True, instance=False)

    @staticmethod
    def _decode_info(engine):
        """(steps, host positions of the live slots): the host's mirror
        lags the device by at most one chunk."""
        live = [s.pos for s in engine.slots if not s.free]
        return engine.decode_chunk, live

    def _wrap(self, owner, attr, kind, info_of, timed=False, instance=True):
        inner = getattr(owner, attr)
        rows = self.rows
        use_events = timed and self.events

        def wrapped(*args, **kw):
            info = info_of(args)
            ev = None
            if use_events:
                ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
                ev[0].record()
            t0 = time.perf_counter()
            out = inner(*args, **kw)
            t1 = time.perf_counter()
            if ev is not None:
                ev[1].record()
            if kind == "decode" and out is None:
                info = (0, info[1])
            rows.append((kind, t0, t1, info, ev))
            return out

        setattr(owner, attr, wrapped)
        if instance:
            self._undo.append(lambda: delattr(owner, attr) if attr in vars(owner) else None)
        else:
            self._undo.append(lambda: setattr(owner, attr, inner))

    def restore(self) -> None:
        for undo in self._undo:
            undo()
        self._undo = []

    def between(self, t0: float, t1: float, kind: str | None = None) -> list:
        return [r for r in self.rows if r[1] >= t0 and r[2] <= t1
                and (kind is None or r[0] == kind)]


class ClosedLoop:
    def __init__(self, engine, stream):
        self.engine, self.stream = engine, stream
        self.inflight: dict[int, dict] = {}
        self.done: list[dict] = []
        self.next_j = [0] * stream.clients
        self.steps: list[tuple[float, int]] = []  # (end time, tokens delivered)

    def submit(self, client: int, now: float) -> None:
        r = self.stream.request(client, self.next_j[client])
        self.next_j[client] += 1
        req = self.engine.submit(r.prompt, r.max_new_tokens)
        self.inflight[id(req)] = {"req": req, "client": client, "index": r.index,
                                  "n_prompt": len(r.prompt), "max_new": r.max_new_tokens,
                                  "submit": now, "first": None, "end": None, "seen": 0}

    def start(self) -> None:
        now = time.perf_counter()
        for c in range(self.stream.clients):
            self.submit(c, now)

    def step(self) -> float:
        self.engine.step()
        now = time.perf_counter()
        delivered = 0
        for key, rec in list(self.inflight.items()):
            req = rec["req"]
            n = len(req.tokens)
            if n > rec["seen"]:
                delivered += n - rec["seen"]
                if rec["first"] is None:
                    rec["first"] = now
            rec["seen"] = n
            if req.finished:
                rec["end"] = now
                rec["tokens"] = list(req.tokens)
                rec["prompt"] = req.prompt
                rec["finish_reason"] = req.finish_reason
                rec["req"] = None
                del self.inflight[key]
                self.done.append(rec)
                self.submit(rec["client"], now)
        self.steps.append((now, delivered))
        return now

    def run_until(self, completions: int) -> float:
        now = time.perf_counter()
        while len(self.done) < completions:
            now = self.step()
        return now

    def run_window(self, seconds: float, t_open: float, hook=None) -> float:
        now = t_open
        while now < t_open + seconds:
            now = self.step()
            if hook is not None:
                hook(now)
        return now


def percentile(values, q: float) -> float | None:
    return float(np.percentile(np.asarray(values, float), q)) if len(values) else None


def window_metrics(loop: ClosedLoop, t_open: float, t_end: float) -> dict:
    """output_tok_s over every token delivered in the window; TTFT of every
    request whose first token came in it; TPOT of every request that ended
    in it."""
    tokens = sum(n for t, n in loop.steps if t_open < t <= t_end)
    recs = loop.done + list(loop.inflight.values())
    ttft = [r["first"] - r["submit"] for r in recs
            if r["first"] is not None and t_open < r["first"] <= t_end]
    ended = [r for r in loop.done if t_open < r["end"] <= t_end]
    tpot = [(r["end"] - r["first"]) / (len(r["tokens"]) - 1) for r in ended
            if len(r["tokens"]) > 1]
    return {"tokens": tokens, "seconds": t_end - t_open, "ttft_s": ttft, "tpot_s": tpot,
            "ended": ended}
