"""Failure detection for a multi-process job (port of
``gym_puzzles_tpu/parallel/health.py``).

Every rank joins a tiny all-reduce on a watchdog cadence; if a rank stalls or
dies, the collective never completes on the healthy ranks -- so ``ping``
bounds it with a deadline and raises :class:`HeartbeatTimeout` when it
expires, letting the job restart from the latest checkpoint
(``train/checkpoint.py``) instead of hanging.

The all-reduce runs on a gloo group of its own, created when the
:class:`Heartbeat` is (by every rank, at the same point of the program), so
that it never queues behind or between the learner's NCCL collectives, on a
helper thread: a blocked collective cannot be interrupted from Python, so the
caller waits on an event with a timeout and raises, abandoning the stuck
daemon thread.  After a timeout the process counts as poisoned (the process
group holds a half-completed collective): exit it (``os._exit``) and restart
from the checkpoint.  ``tests/test_torch_multiprocess.py`` kills a rank to
show it.
"""

from __future__ import annotations

import threading

import torch
import torch.distributed as dist


class HeartbeatTimeout(RuntimeError):
    pass


class Heartbeat:
    """Deadline-bounded collective ping::

        hb = Heartbeat(timeout=120.0)   # every rank, at the same point
        while training:
            ts, metrics = algo.train_step(ts)
            hb.ping()          # raises HeartbeatTimeout if the round does
                               # not complete within timeout

    ``interval`` is accepted for the JAX package's signature and unused:
    the deadline bounds every ping.  With no process group (one process) a
    ping returns at once."""

    def __init__(self, timeout: float = 120.0, interval: float | None = None):
        del interval
        self.timeout = timeout
        self.group = dist.new_group(backend="gloo") if dist.is_initialized() else None
        self.world_size = dist.get_world_size() if dist.is_initialized() else 1

    def _collective(self):
        x = torch.ones(1)
        dist.all_reduce(x, group=self.group)
        if int(x.item()) != self.world_size:
            raise RuntimeError(f"heartbeat sum {x.item()} from {self.world_size} ranks")

    def ping(self):
        if self.group is None:
            return
        done = threading.Event()
        err: list[BaseException] = []

        def run():
            try:
                self._collective()
            except BaseException as e:  # surfaced to the caller below
                err.append(e)
            finally:
                done.set()

        threading.Thread(target=run, daemon=True, name="heartbeat-ping").start()
        if not done.wait(self.timeout):
            raise HeartbeatTimeout(
                f"collective heartbeat did not complete within {self.timeout}s -- a rank is "
                "stalled or dead; restart from the latest checkpoint")
        if err:
            # a dead peer can also surface as a transport error (gloo's
            # connection reset) instead of a silent stall -- same remedy
            raise HeartbeatTimeout(f"collective heartbeat failed: {err[0]!r}") from err[0]

    def close(self):
        """Release the heartbeat's group (every rank, at the same point)."""
        if self.group is not None:
            dist.destroy_process_group(self.group)
            self.group = None
