"""Tracing and profiling helpers (port of ``gym_puzzles_tpu/utils/profiling.py``).

The reference has no profiling beyond wandb's tensorboard relay
(train/train.py:53).  Here: ``torch.profiler`` traces of a block, the CPU
and (where there is one) the card's activity, written as a Chrome trace;
an env-steps/s meter; and a determinism check.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from pathlib import Path

import numpy as np
import torch


@contextlib.contextmanager
def trace(profile_dir: str | None):
    """Profile the enclosed block when ``profile_dir`` is set (the trace goes
    to ``<profile_dir>/trace.json``, for chrome://tracing or Perfetto); a
    no-op otherwise.  Yields the profiler (``key_averages()`` for sums by
    kernel), or None.

        with profiling.trace("/tmp/tb"):
            env.step(...)
    """
    if not profile_dir:
        yield None
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    out = Path(profile_dir)
    out.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(out / "trace.json"))


class Throughput:
    """Rolling env-steps/s meter."""

    def __init__(self):
        self.t0 = time.time()
        self.steps = 0

    def add(self, n: int):
        self.steps += n

    def rate(self) -> float:
        dt = time.time() - self.t0
        return self.steps / dt if dt > 0 else 0.0

    def reset(self):
        self.t0 = time.time()
        self.steps = 0


def _leaves(x):
    """The tensor and array leaves of a tree of tuples, lists, dicts and
    dataclasses, in order, as numpy arrays on the host."""
    if dataclasses.is_dataclass(x):
        return [leaf for f in dataclasses.fields(x) for leaf in _leaves(getattr(x, f.name))]
    if isinstance(x, dict):
        return [leaf for k in x for leaf in _leaves(x[k])]
    if isinstance(x, (tuple, list)):
        return [leaf for item in x for leaf in _leaves(item)]
    if isinstance(x, torch.Tensor):
        return [x.detach().cpu().numpy()]
    return [np.asarray(x)]


def assert_deterministic(fn, *args, n: int = 2):
    """Determinism check: run ``fn(*args)`` ``n`` times, each after a device
    synchronise, and assert that the outputs' leaves are bitwise equal.
    Returns the first result."""
    results = []
    for _ in range(n):
        out = fn(*args)
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        results.append(out)
    first = _leaves(results[0])
    for r in results[1:]:
        other = _leaves(r)
        if len(other) != len(first):
            raise AssertionError(f"{len(first)} outputs, then {len(other)}")
        for a, b in zip(first, other):
            np.testing.assert_array_equal(a, b)
    return results[0]
