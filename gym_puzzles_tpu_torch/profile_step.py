"""Where the port's main path spends the card's time: its CUDA graph beside
its eager body, and the graph's replay split by the program's spans.

    python -m gym_puzzles_tpu_torch.profile_step [steps] [--env ID] [--backend fused|pallas]
        [--pixels] [--out DIR]
    python -m gym_puzzles_tpu_torch.profile_step --learner [--pixels] [--out DIR]

Runs ``make(ID, num_envs=4096, backend=...)`` on the card (default
MultiRobotPuzzle-v0, the fused backend; reset, 10 warm-up steps of random
actions through ``env.step``, the first of which captures its CUDA graph),
then traces ``steps`` more steps with ``torch.profiler`` twice: through
``env.step`` (graph replays) and through ``env.step_eager`` (the body the
graph captures).  For each it prints the wall time per step (the tracer
slows the host), the device's busy share of that time (the sum of
device-kernel times over the wall time), the device kernels run per step,
the host's launch calls per step (kernel launches, graph launches, copies
and fills) and graph launches per step, and the top kernels by device time.
With ``--pixels`` the env is the image env of the pixel recipe
(``DeviceImageVectorEnv``, 256 envs, 60/20, frameskip 4).

Then the replay split by the spans of ``utils/profiling.py`` (tracing on,
the graph captured anew with the stamps inside): per span, ms per step in
all and in itself, on the host or on the device (kernel A's launches
``env.tick`` beside the env's logic and, with ``--pixels``, the frame
``env.render``);
the same steps with the profiler too, written as one Chrome trace (to
``--out``, default a fresh temporary directory) with the clock fit's
residual, the idle time put down to the innermost host span and each host
span's device extent (its first launched op's start to its last one's end)
beside the device spans of the same steps; the cost of
tracing (wall ms per step off and on, in turns, no profiler; device ms per
step off and on, profiled); and each capture's kernel nodes.  The last line
is the same as one JSON object.  Needs a CUDA device.

With ``--learner`` it does the same for PPO at the v0 recipe (``V0_CONFIG``
with ``V0_OVERRIDES``: 4096 envs, n_steps 64, batch 8192, 4 epochs) or, with
``--pixels``, at the pixel recipe (``PIXEL_RECIPE``), after two updates
(both CUDA graphs captured): the learner alone (bootstrap value, GAE, the
minibatch epochs and metrics on one rollout's Transition) as its graph's
replay and as its eager body, then whole updates as both graphs and as the
rollout graph with the eager learner, the same numbers per update; the
learner graph's kernel nodes beside the launches of the hand-written kernels
it holds per replay (``adam_fused``: two per minibatch; ``mlp_grad``: four
per minibatch at an MLP recipe, none at the pixel one); then whole updates
split by the spans (the learner's ``learn.grad`` against ``learn.adam``),
traced, and the cost of tracing.
"""

from __future__ import annotations

import argparse
import json
import shutil
import tempfile
import time
from pathlib import Path

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from gym_puzzles_tpu_torch import make
from gym_puzzles_tpu_torch.api.image_obs import DeviceImageVectorEnv
from gym_puzzles_tpu_torch.train.ppo import PPO, PPOConfig
from gym_puzzles_tpu_torch.utils import profiling

ENV_ID = "MultiRobotPuzzle-v0"
NUM_ENVS = 4096
# the pixel recipe's env (docs/benchmarks/ppo_v0_cnn_r5_leg1.jsonl)
PIXEL_ENVS, PIXEL_ITERS = 256, (60, 20)
# the JAX package's full-width v0 recipe (docs/BENCHMARKS.md:187) and its
# pixel recipe (docs/benchmarks/ppo_v0_cnn_r5_leg1.jsonl line 1; the rest as
# PPOConfig's defaults), seed 0
V0_CONFIG = Path(__file__).resolve().parents[1] / "train_configs" / "ppo-mrp-v0.json"
V0_OVERRIDES = dict(n_envs=NUM_ENVS, n_steps=64, batch_size=8192, n_epochs=4,
                    env_backend="fused", seed=0)
PIXEL_RECIPE = dict(env_id=ENV_ID, policy="cnn", n_envs=PIXEL_ENVS, n_steps=32, batch_size=2048,
                    n_epochs=2, learning_rate=2.5e-4, ent_coef=0.005, target_kl=0.01,
                    normalize=True, env_backend="fused", velocity_iters=PIXEL_ITERS[0],
                    position_iters=PIXEL_ITERS[1], seed=0)
SPLIT_UPDATES = 2  # whole updates split by the spans in profile_learner
# the host's runtime calls that put work on a stream
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx",
                "cudaGraphLaunch", "cudaMemcpyAsync", "cudaMemsetAsync")


def trace(fn, steps: int) -> dict:
    """``fn(k)`` for k < ``steps`` under ``torch.profiler``: wall and device
    ms per step, busy share, device kernels, host launch calls and graph
    launches per step, top kernels."""
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for k in range(steps):
            fn(k)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0

    events = prof.key_averages()
    # device-side events only: the CPU ops that launched them carry the same
    # time as their own "self device" time and would count it twice
    kernels = [e for e in events
               if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    calls = {e.key: e.count for e in events
             if e.device_type == DeviceType.CPU and e.key in LAUNCH_CALLS}
    device_us = sum(e.self_device_time_total for e in kernels)
    launches = sum(e.count for e in kernels)
    kernels.sort(key=lambda e: e.self_device_time_total, reverse=True)
    top = [dict(name=e.key[:60], count=e.count, device_ms=e.self_device_time_total / 1e3)
           for e in kernels[:8]]
    return dict(wall_ms_per_step=1e3 * wall_s / steps,
                device_ms_per_step=device_us / 1e3 / steps,
                device_busy_share=(device_us / 1e6) / wall_s,
                kernels_per_step=launches / steps,
                host_launch_calls_per_step=sum(calls.values()) / steps,
                graph_launches_per_step=calls.get("cudaGraphLaunch", 0) / steps,
                top=top)


def report(name: str, t: dict, suffix: str = "", unit: str = "step"):
    print(f"{name}: {t['wall_ms_per_step']:.3f} ms/{unit} wall, {t['device_ms_per_step']:.3f} "
          f"ms/{unit} on the device (busy share {t['device_busy_share']:.3f}), "
          f"{t['kernels_per_step']:.1f} kernels/{unit} run, "
          f"{t['host_launch_calls_per_step']:.1f} host launch calls/{unit} "
          f"({t['graph_launches_per_step']:.1f} graph launches){suffix}", flush=True)
    for k in t["top"]:
        print(f"  {k['device_ms']:10.3f} ms  x{k['count']:<6d} {k['name']}", flush=True)


def wall_ms(fn, steps: int) -> float:
    """Wall ms per step of ``fn(k)`` for k < ``steps``, to a synchronize."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for k in range(steps):
        fn(k)
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / steps


def split(fn, steps: int, suffix: str = "", unit: str = "step") -> dict:
    """The spans of ``fn(k)`` (module docstring) through
    ``profiling.traced_calls``: ``steps`` calls timed with tracing on after
    the one that captures the graphs with the stamps, then as many profiled
    too, into a fresh temporary directory.  -> ``spans`` (per name: clock, ms
    per step in all and in itself, count per step, of the timed calls),
    ``fit``, ``idle`` and ``extents`` (per host span, ms per step from its
    first launched device op's start to its last one's end) of the profiled
    calls, ``trace`` (the Chrome trace's path), ``cost`` (wall ms per step
    off / on in turns, no profiler; device ms per step off / on, profiled),
    ``captures`` (kernel nodes of each graph captured here), printed."""
    first = len(profiling.CAPTURES)
    off = [wall_ms(fn, steps)]
    out_dir = tempfile.mkdtemp(prefix="profile-step-")
    tr, wall_s, tb = profiling.traced_calls(fn, steps, steps, out_dir)
    on = [1e3 * wall_s / steps]
    with profiling.tracing():
        on.append(wall_ms(fn, steps))
    fn(0)  # captures the graphs back without the stamps
    off.append(wall_ms(fn, steps))
    device_off = trace(fn, steps)["device_ms_per_step"]
    n = max(1, tr.steps)
    spans = {name: dict(clock=r["clock"], ms_per_step=r["total_ns"] * 1e-6 / n,
                        self_ms_per_step=r["self_ns"] * 1e-6 / n, count_per_step=r["count"] / n)
             for name, r in tr.by_name().items()}
    profiled = {name: r["total_ns"] * 1e-6 / steps for name, r in tb.by_name().items()
                if r["clock"] == "device"}
    out = dict(spans=spans, fit=tb.fit, idle=tb.idle[:10], trace=f"{out_dir}/trace.json",
               extents={k: v * 1e-3 / steps for k, v in tb.extents.items()},
               cost=dict(wall_off_ms=off, wall_on_ms=on, device_off_ms=device_off,
                         device_on_ms=tb.device_us * 1e-3 / steps),
               captures=[dict(name=c.name, traced=c.traced, kernel_nodes=c.kernel_nodes,
                              nodes=c.nodes, seconds=c.seconds)
                         for c in profiling.CAPTURES[first:]])
    print(f"  spans per {unit} over {steps} {unit}s (tracing on, no profiler):{suffix}",
          flush=True)
    for name, r in sorted(spans.items(), key=lambda kv: (kv[1]["clock"], -kv[1]["ms_per_step"])):
        print(f"    {r['clock']:6s} {name:16s} {r['ms_per_step']:10.4f} ms "
              f"({r['self_ms_per_step']:.4f} self) x{r['count_per_step']:g}", flush=True)
    c = out["cost"]
    print(f"  tracing cost per {unit}: wall {c['wall_off_ms']} ms off, {c['wall_on_ms']} ms on "
          f"(in turns, no profiler); device {c['device_off_ms']:.4f} ms off, "
          f"{c['device_on_ms']:.4f} ms on (profiled){suffix}", flush=True)
    print(f"  profiled, per {unit}: device extent of each host span's launches "
          + ", ".join(f"{k} {v:.4f} ms" for k, v in sorted(out["extents"].items()))
          + "; device spans " + ", ".join(f"{k} {v:.4f} ms" for k, v in sorted(profiled.items()))
          + suffix, flush=True)
    print(f"  clock fit {tb.fit}; idle by innermost host span "
          + ", ".join(f"{k} {v * 1e3:.3f} ms" for k, v in out["idle"]) + f"; {out['trace']}"
          + suffix, flush=True)
    print("  captures " + ", ".join(f"{c['name']} traced={c['traced']} {c['kernel_nodes']} "
                                    f"kernel nodes of {c['nodes']}, {c['seconds']:.3f} s"
                                    for c in out["captures"]) + suffix, flush=True)
    return out


def profile_path(steps: int = 20, env_id: str = ENV_ID, backend: str = "fused",
                 pixels: bool = False, suffix: str = "", spans: bool = True) -> dict:
    """The traces of the module docstring, printed; returns them.  ``spans``:
    the split by the spans too (``chip_smoke.py`` leaves it out)."""
    if not torch.cuda.is_available():
        raise SystemExit("profile_step: needs a CUDA device")
    if pixels:
        env = DeviceImageVectorEnv(env_id, num_envs=PIXEL_ENVS, backend=backend,
                                   velocity_iters=PIXEL_ITERS[0], position_iters=PIXEL_ITERS[1])
    else:
        env = make(env_id, num_envs=NUM_ENVS, backend=backend)
    dev, E = env.device, env.num_envs
    state, _obs = env.reset(seed=0)
    gen = torch.Generator(device=dev).manual_seed(2)
    acts = torch.rand((steps + 10, E, env.cfg.act_dim), generator=gen, device=dev) * 2 - 1
    for k in range(10):
        state, *_ = env.step(state, acts[steps + k])
    torch.cuda.synchronize()

    def run(step):
        def fn(k):
            nonlocal state
            state, *_ = step(state, acts[k % steps])
        return fn

    out = dict(device=torch.cuda.get_device_name(0), env_id=env_id, backend=backend,
               pixels=pixels, num_envs=E, steps=steps, graph=trace(run(env.step), steps),
               eager=trace(run(env.step_eager), steps))
    name = f"{env_id} backend={backend}{' pixels' if pixels else ''}: {steps} traced steps x {E} envs"
    report(f"{name}, CUDA graph replays", out["graph"], suffix)
    report(f"{name}, eager body", out["eager"], suffix)
    if spans:
        out["split"] = split(run(env.step), steps, suffix)
    return out


def recipe(pixels: bool = False) -> PPOConfig:
    """The v0 recipe, or the pixel recipe."""
    if pixels:
        return PPOConfig(**PIXEL_RECIPE)
    return PPOConfig.from_reference_json(json.loads(V0_CONFIG.read_text()), **V0_OVERRIDES)


def profile_learner(cfg: PPOConfig, suffix: str = "", spans: bool = True) -> dict:
    """The learner traces of the module docstring for ``cfg``, one update
    each, and (``spans``) the split of :data:`SPLIT_UPDATES` whole updates,
    printed (per update); returns them."""
    if not torch.cuda.is_available():
        raise SystemExit("profile_step: needs a CUDA device")
    algo = PPO(cfg)
    ts = algo.init_state()
    for _ in range(2):
        ts, _metrics = algo.train_step(ts)
    start = ts
    ts, traj = algo._rollout(start, None, None, None, graphed=True)
    torch.cuda.synchronize()
    out = dict(device=torch.cuda.get_device_name(0), env_id=cfg.env_id, policy=cfg.policy,
               num_envs=cfg.n_envs, n_steps=cfg.n_steps, batch_size=cfg.batch_size,
               n_epochs=cfg.n_epochs)
    for graphed in (True, False):
        out["learner_graph" if graphed else "learner_eager"] = trace(
            lambda _k, g=graphed: algo._learn(start, ts, traj, None, None, g), 1)
    capture = [c for c in profiling.CAPTURES if c.name == "ppo.learner" and not c.traced][-1]
    out["learner_kernel_nodes"] = capture.kernel_nodes
    out["learner_kernel_launches"] = algo.graph_launches["learner"]
    state = {"ts": ts}

    def update(learner_graph):
        def fn(_k):
            state["ts"] = algo._train_step(state["ts"], None, None, None, None, True,
                                           learner_graph)[0]
        return fn

    out["update_graphs"] = trace(update(True), 1)
    out["update_learner_eager"] = trace(update(False), 1)
    name = (f"PPO {cfg.policy} at {cfg.n_envs} envs, n_steps {cfg.n_steps}, batch "
            f"{cfg.batch_size}, {cfg.n_epochs} epochs")
    for key, what in (("learner_graph", "the learner, CUDA graph replay"),
                      ("learner_eager", "the learner, eager body"),
                      ("update_graphs", "one update, rollout and learner graphs"),
                      ("update_learner_eager", "one update, rollout graph, eager learner")):
        report(f"{name}: {what}", out[key], suffix, unit="update")
    print(f"  learner graph: {out['learner_kernel_nodes']} kernel nodes; launches per replay of "
          f"the hand-written kernels {out['learner_kernel_launches']}{suffix}", flush=True)
    if spans:
        out["split"] = split(update(True), SPLIT_UPDATES, suffix, unit="update")
    return out


def main(steps: int = 20, env_id: str = ENV_ID, backend: str = "fused",
         pixels: bool = False, learner: bool = False, out_dir: str | None = None) -> dict:
    """``out_dir``: where the split's Chrome trace is moved to."""
    out = profile_learner(recipe(pixels)) if learner else profile_path(steps, env_id, backend,
                                                                        pixels)
    if out_dir:
        Path(out_dir).mkdir(parents=True, exist_ok=True)
        out["split"]["trace"] = str(shutil.move(out["split"]["trace"],
                                                Path(out_dir) / "trace.json"))
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("steps", nargs="?", type=int, default=20)
    parser.add_argument("--env", default=ENV_ID)
    parser.add_argument("--backend", default="fused", choices=("fused", "pallas"))
    parser.add_argument("--pixels", action="store_true",
                        help="the image env of the pixel recipe (256 envs, 60/20, frameskip 4)")
    parser.add_argument("--learner", action="store_true",
                        help="PPO updates at the v0 recipe (or, with --pixels, the pixel "
                             "recipe): the learner and whole updates, graph and eager")
    parser.add_argument("--out", default=None,
                        help="directory of the Chrome trace with the spans (default: a fresh "
                             "temporary directory)")
    args = parser.parse_args()
    main(args.steps, args.env, args.backend, args.pixels, args.learner, args.out)
