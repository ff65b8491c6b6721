"""The general traffic generators: one module per kind of loop,
``portbench/loops/<kind>.py``, found by the ``loop`` that a mix's data file
(``portbench/traffic/<mix>.json``) names.  A new kind of traffic adds a
module here and a mix file; nothing that exists is edited.

A loop module exposes:

* ``run(config, traffic, seed, seconds, trace, device, setup_t0) -> dict``:
  set-up, warm-up and the timed window of one run; it returns ``attempted``,
  ``missing``, what its check needs, ``release`` (the program, freed before
  the check) and ``ctx``, the context that the metrics' readers
  (``portbench/metrics/<metric>.py``) take their numbers from: the set-up
  time, the window's env steps and wall time, and with ``trace`` the
  profiler's device and host ops and ``PhaseTimer`` seconds;
* ``READINGS``: the kinds of reading its check gives, ``program`` first,
  then the control and any planted faults (``portbench.control``);
* ``check(out, config, device, kinds=("program",)) -> {kind: numbers}``:
  what the timed path produced held against the plain reference, each
  number with a limit in ``portbench/limits/<cell>.json``.
"""

from __future__ import annotations

import contextlib
import importlib.util
import os
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from portbench import yardstick

HERE = Path(__file__).resolve().parent


def find(kind: str, root: Path | None = None):
    """The loop module ``<root>/loops/<kind>.py`` (``root``: the benchmark's
    folder)."""
    path = (Path(root) / "loops" if root is not None else HERE) / f"{kind}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_loop_{kind}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def sub_seeds(seed: int, n: int) -> list[int]:
    """``n`` independent 32-bit seeds from the run's ``--seed``."""
    return [int(s) for s in np.random.SeedSequence(int(seed)).generate_state(n)]


def sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def profiled(ctx: dict, device):
    """Profile the body with ``torch.profiler`` (host and device); put its
    device ops, host ops and the traced window (trace clock, us) into
    ``ctx``."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with tempfile.TemporaryDirectory() as tmp:
        with profile(activities=acts) as prof:
            sync(device)
            with torch.profiler.record_function("portbench.window"):
                t0 = time.perf_counter()
                yield
                sync(device)
                ctx["window_s"] = time.perf_counter() - t0
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        dev, host = yardstick.read_trace(path)
    (_name, lo, dur), = [r for r in host if r[0] == "portbench.window"]
    hi = lo + dur
    ctx.update(device_ops=[r for r in dev if lo <= r[1] <= hi],
               host_ops=[r for r in host if r[0] != "portbench.window"], trace_lo=lo,
               trace_hi=hi)
