"""Rank 0's control channel to the other ranks of a distributed model.

A model over a mesh (`LanguageModel(mesh=...)`, `parallel/`) runs one
process per rank, and every rank must run the same engine calls in the
same order: their collectives pair up. Rank 0 alone serves HTTP, prints
and writes files; before each engine step it sends the other ranks what
changed (the requests submitted and cancelled since the last step, a chat
request's body, a chat line), and they replay it. The messages travel by
`broadcast_object_list` over a gloo group of their own, whatever the
model's backend.

An exception in replayed work ends the lockstep for good
(`Lockstep.fatal_on_error`): the ranks may no longer pair their
collectives. On rank 0 the channel refuses further sends, and the others
are told to stop without waiting for them; another rank aborts its
process groups and raises, and its process ending closes its connections,
which releases every rank blocked in a collective with it. One limit
stays: a rank blocked in a collective that rank 0 left (an exception on
rank 0 alone, in the middle of a step) waits for the backend's timeout.
"""

from __future__ import annotations

import contextlib


class _Stop:
    """The message that tells the other ranks that rank 0 has failed."""


class Lockstep:
    def __init__(self):
        import torch.distributed as dist

        self.rank = dist.get_rank()
        self.group = dist.new_group(backend="gloo")
        #: set once an exception ended the lockstep
        self.failed = False

    @property
    def leader(self) -> bool:
        return self.rank == 0

    def send(self, obj) -> None:
        import torch.distributed as dist

        if self.failed:
            raise RuntimeError("an exception ended the lockstep of this distributed "
                               "model; restart it")
        dist.broadcast_object_list([obj], src=0, group=self.group)

    def recv(self):
        import torch.distributed as dist

        box = [None]
        dist.broadcast_object_list(box, src=0, group=self.group)
        if isinstance(box[0], _Stop):
            raise RuntimeError("rank 0 failed; this rank stops")
        return box[0]

    def fail(self) -> None:
        """End the lockstep: rank 0 tells the others to stop from a thread
        of its own (one blocked in a collective never takes the message);
        another rank aborts its process groups (on NCCL a peer's pending
        collective then fails at once)."""
        import threading

        import torch.distributed as dist

        if self.failed:
            return
        self.failed = True
        if self.leader:
            threading.Thread(target=dist.broadcast_object_list, args=([_Stop()],),
                             kwargs=dict(src=0, group=self.group), daemon=True).start()
        elif dist.is_initialized():
            dist.distributed_c10d._abort_process_group()

    @contextlib.contextmanager
    def fatal_on_error(self):
        """Run replayed work; an exception in it ends the lockstep (`fail`)
        and propagates."""
        try:
            yield
        except Exception:
            self.fail()
            raise


def lockstep_for(lm) -> Lockstep | None:
    """A channel when `lm` spans more than one rank, else None."""
    import torch.distributed as dist

    if getattr(lm, "mesh", None) is None or dist.get_world_size() == 1:
        return None
    return Lockstep()


def is_leader() -> bool:
    """True outside a process group and on its rank 0."""
    import torch.distributed as dist

    return not dist.is_initialized() or dist.get_rank() == 0
