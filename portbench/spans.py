"""The per-layer metrics that the program's own spans and counters give
(``gym_puzzles_tpu_torch/utils/profiling.py``), read in two more phases of a
traced run.

They run once per run, when the first reader of such a metric asks
(:func:`phases`), after the loop's own phases and the check: the loop frees
the program before the check, so the program is built again here from the
configuration, with the run's ``--seed``, on the device the run used.

* Before anything is built, the set-up's capture counters are read
  (``profiling.CAPTURES``: seconds of warm-up and capture, kernel nodes per
  graph, all captured with tracing off).
Both phases run through ``profiling.traced_calls``:

* (a) Tracing on, the profiler off: a first step or update captures the
  graphs with the spans' stamps inside; then as many env steps or updates as
  the loop's profiler phase ran (``ctx["steps"]`` / ``ctx["updates"]``), one
  after another as in the window (an update ended by a synchronize).  The
  metrics read the spans of these.
* (b) Tracing and the profiler both on, for :data:`PHASE_B_STEPS` env steps
  (no more than phase (a)'s) or one update: the aligned Chrome trace is
  written to a fresh temporary directory, and standard error gets the clock
  fit, the idle gaps summed by the innermost program span open on the host,
  each host span's device extent (its first launched op's start to its last
  one's end: ``ppo.learner``'s beside the ``learn.*`` device spans of the
  same update) and the cost of tracing (the window's wall and the profiler
  phase's device time per step against phase (a)'s and (b)'s).  No metric
  reads (b).

With a program that has no span facility every reading is None.  The
numbers are kept in ``ctx`` (``captures``, ``spans``), where a test can put
them instead.
"""

from __future__ import annotations

import argparse
import sys
import tempfile
import time

import torch

from portbench import program
from portbench.loops import sub_seeds, sync

PHASE_B_STEPS = 10  # env steps traced with the profiler in phase (b); an update is one


def _seed() -> int:
    p = argparse.ArgumentParser(add_help=False, allow_abbrev=False)
    p.add_argument("--seed", type=int, default=0)
    return p.parse_known_args(sys.argv[1:])[0].seed


def _device(ctx):
    state = ctx["tick_states"][0][0]
    return state.t.device


def phases(ctx) -> dict | None:
    """The readings of phase (a) and the set-up's counters (module
    docstring), run at the first call and kept in ``ctx``; None when the
    program has no span facility or the run was not traced."""
    if "spans" in ctx:
        return ctx["spans"]
    try:
        from gym_puzzles_tpu_torch.utils import profiling
    except ImportError:
        profiling = None
    if profiling is None or not hasattr(profiling, "traced_calls") or not ctx.get("tick_states"):
        ctx["spans"] = ctx["captures"] = None
        return None
    ctx["captures"] = [dict(name=c.name, seconds=c.seconds, kernel_nodes=c.kernel_nodes,
                            traced=c.traced) for c in profiling.CAPTURES]
    device = _device(ctx)
    ppo = ctx["traffic"]["loop"] == "ppo_updates"
    run = _ppo_phases if ppo else _env_phases
    t0 = time.perf_counter()
    ctx["spans"] = run(ctx, profiling, device, _seed())
    print(f"portbench: phases (a) and (b) {time.perf_counter() - t0:.3f} s", file=sys.stderr)
    return ctx["spans"]


def _summary(tr, wall_s: float, step_name: str) -> dict:
    """Totals by span name and clock, the count of ``step_name`` spans and
    the wall time of the phase."""
    out = {"steps": len(tr.named(step_name)), "wall_s": wall_s, "host_ns": {}, "device_ns": {},
           "count": {}}
    for name, r in tr.by_name().items():
        out[f"{r['clock']}_ns"][name] = r["total_ns"]
        out["count"][name] = r["count"]
    return out


def _phases(ctx, profiling, fn, n: int, n_b: int, step_name: str, per: str,
            window_per: float | None) -> dict:
    """Phases (a) and (b) of ``fn(k)`` (``profiling.traced_calls``), the
    report on standard error; -> phase (a)'s summary."""
    path = tempfile.mkdtemp(prefix="portbench-trace-")
    tr, wall_s, tb = profiling.traced_calls(fn, n, n_b, path)
    summary = _summary(tr, wall_s, step_name)
    steps = max(1, summary["steps"])
    print(f"portbench: phase (a) spans per {per} over {summary['steps']}: "
          + ", ".join(f"{clock} {name} {ns / steps * 1e-6:.4f} ms"
                      for clock in ("host", "device")
                      for name, ns in sorted(summary[f"{clock}_ns"].items())), file=sys.stderr)
    fit = tb.fit or {}
    print(f"portbench: phase (b) trace {path}/trace.json; clock fit over "
          f"{fit.get('device_stamps')} stamps: rate {fit.get('device_rate')}, residual "
          f"{fit.get('device_residual_us')} us (a constant offset's "
          f"{fit.get('device_offset_residual_us')} us); over {fit.get('host_spans')} host "
          f"spans: residual {fit.get('host_residual_us')} us", file=sys.stderr)
    gaps = ", ".join(f"{name} {sec * 1e3:.3f} ms" for name, sec in (tb.idle or [])[:10])
    print(f"portbench: phase (b) idle gaps by innermost program span over {n_b} {per}s: {gaps}",
          file=sys.stderr)
    device = {name: r["total_ns"] for name, r in tb.by_name().items() if r["clock"] == "device"}
    print(f"portbench: phase (b) per {per}: device extent of each host span's launches "
          + ", ".join(f"{k} {v * 1e-3 / n_b:.4f} ms" for k, v in sorted((tb.extents or {}).items()))
          + "; device spans " + ", ".join(f"{k} {v * 1e-6 / n_b:.4f} ms"
                                          for k, v in sorted(device.items())), file=sys.stderr)
    off = ctx.get("device_ops")
    dev_off = sum(d for _n, _s, d in off) * 1e-3 / (ctx.get("updates") or ctx["steps"]) \
        if off else None
    print(f"portbench: tracing cost per {per}: wall {1e3 * wall_s / steps:.4f} ms with tracing "
          f"on (phase a), {window_per} ms in the window; device {tb.device_us * 1e-3 / n_b:.4f} "
          f"ms with tracing on (phase b), {dev_off} ms with it off (profiler phase)",
          file=sys.stderr)
    return summary


def _env_phases(ctx, profiling, device, seed: int) -> dict:
    env = program.make_env(ctx["config"], device)
    s_env, s_act, _s = sub_seeds(seed, 3)
    E, A = env.num_envs, env.cfg.act_dim
    n = int(ctx["steps"])
    n_b = min(PHASE_B_STEPS, n)
    gen = torch.Generator(device=device).manual_seed(s_act)
    pool = torch.rand((n + n_b + 1, E, A), generator=gen, device=device) * 2.0 - 1.0
    state = env.reset(seed=s_env)[0]

    def step(k):
        nonlocal state
        state = env.step(state, pool[k])[0]

    window = (1e3 * ctx["window_seconds"] / (ctx["window_env_steps"] / E)
              if ctx.get("window_env_steps") else None)
    return _phases(ctx, profiling, step, n, n_b, "env.step", "env step", window)


def _ppo_phases(ctx, profiling, device, seed: int) -> dict:
    from gym_puzzles_tpu_torch.train.ppo import AdamState

    algo = program.make_ppo(ctx["config"], device)
    s_net, s_env, s_run = sub_seeds(seed, 3)
    ts = algo.init_state(seed=s_env)
    params = program.make_weights(ts.params, s_net, device)
    ts = ts.replace(params=params, opt_state=AdamState.zeros_like(params))
    ts.generator.manual_seed(s_run)

    def update(_k):  # each update ended by a synchronize, as in the window
        nonlocal ts
        ts = algo.train_step(ts)[0]
        sync(device)

    window = (1e3 * ctx["window_seconds"] / ctx["window_updates"]
              if ctx.get("window_updates") else None)
    return _phases(ctx, profiling, update, int(ctx["updates"]), 1, "ppo.update", "update",
                   window)


# -- the readers' arithmetic ---------------------------------------------------------


def per_step(ctx, clock: str, *names: str) -> float | None:
    """The summed ns of the spans ``names`` on ``clock`` (``host`` or
    ``device``) in phase (a), per step or update; None without the
    phase."""
    s = phases(ctx)
    if not s or not s["steps"]:
        return None
    return sum(s[f"{clock}_ns"].get(n, 0) for n in names) / s["steps"]


def setup_captures(ctx) -> list | None:
    """The set-up's capture records ({name, seconds, kernel_nodes, traced}),
    or None without the program's counters."""
    phases(ctx)
    return ctx.get("captures")
