"""A pool of CPU ranks for the port's multi-rank tests.

`RankPool(world, store_dir)` spawns `world` processes that join one gloo
process group over a `file://` store (no TCP port, so parallel test
workers cannot collide), each with one torch thread; a case is a function
of `torch_parallel_cases` run on every rank, and `run` returns each
rank's result in rank order. torch is imported once per rank for the
whole module that owns the pool. A case that leaves its rank's process
groups broken returns `RankExit(value)`: the rank reports the value and
its process ends, as a rank of the CLI does, which closes its
connections.
"""

from __future__ import annotations

import multiprocessing
import os
import queue
import traceback

CASE_TIMEOUT = 240


class RankExit:
    def __init__(self, value):
        self.value = value


def _rank_main(rank: int, world: int, store: str, tasks, results) -> None:
    os.environ["OMP_NUM_THREADS"] = "1"
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=world)
    import torch_parallel_cases as cases

    while True:
        task = tasks.get()
        if task is None:
            break
        name, args, kwargs = task
        try:
            value = getattr(cases, name)(*args, **kwargs)
        except Exception:  # reported to the test, which fails
            results.put((rank, False, traceback.format_exc()))
            continue
        if isinstance(value, RankExit):
            results.put((rank, True, value.value))
            results.close()
            results.join_thread()
            os._exit(0)
        results.put((rank, True, value))
    dist.destroy_process_group()


class RankPool:
    def __init__(self, world: int, store_dir: str):
        ctx = multiprocessing.get_context("spawn")
        self.world = world
        self.results = ctx.Queue()
        self.tasks = [ctx.Queue() for _ in range(world)]
        store = os.path.join(store_dir, f"store_{world}")
        self.procs = [ctx.Process(target=_rank_main, daemon=True,
                                  args=(r, world, store, self.tasks[r], self.results))
                      for r in range(world)]
        for p in self.procs:
            p.start()

    def run(self, name: str, *args, **kwargs) -> list:
        """Run case `name` on every rank; its results in rank order. A
        failure on any rank raises with that rank's traceback."""
        for q in self.tasks:
            q.put((name, args, kwargs))
        out, errors = [None] * self.world, []
        for _ in range(self.world):
            try:
                rank, ok, value = self.results.get(timeout=CASE_TIMEOUT)
            except queue.Empty:
                self.close()
                raise RuntimeError(f"case {name} timed out after {CASE_TIMEOUT} s") from None
            if ok:
                out[rank] = value
            else:
                errors.append(f"rank {rank}:\n{value}")
        if errors:
            raise AssertionError(f"case {name} failed:\n" + "\n".join(errors))
        return out

    def close(self) -> None:
        for q in self.tasks:
            q.put(None)
        for p in self.procs:
            p.join(timeout=10)
            if p.is_alive():
                p.kill()
