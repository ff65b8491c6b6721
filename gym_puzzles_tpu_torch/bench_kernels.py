"""Measurements of the two CUDA kernels beyond ``chip_smoke.py``'s timings.

    python -m gym_puzzles_tpu_torch.bench_kernels envs_per_warp [--repeats N]
    python -m gym_puzzles_tpu_torch.bench_kernels phases
    python -m gym_puzzles_tpu_torch.bench_kernels size_classes [--repeats N]

Each runs on 4096 random spawns (the inputs ``chip_smoke.py`` times: kernel
A on the spawns' tick, kernel B on the contact solve of the tick after it),
launches the kernels' C entries directly on packed planes into outputs it
allocates once, times with CUDA events over 10 launches per sample, prints
one line per sample and, last, the same as one JSON object.  Needs a CUDA
device.

``envs_per_warp`` (v0, v2): builds both kernels once for each of 32, 16, 8
and 4 envs per warp (``-DGPT_ENVS_PER_WARP=N``; one nvcc per build, all
started together), checks that every build's outputs equal the default
build's bitwise (the grouping changes no env's arithmetic), and times them
in turns (32 16 8 4 4 8 16 32, ``--repeats`` times over), beside the mean
and warp-max live pairs per env at that grouping.  The default build's envs
per warp (``GPT_ENVS_PER_WARP`` in ``csrc/tick.cuh``) is the fastest here.

``phases`` (v0, v2): the default builds at 0/0, 180/0, 0/60 and 180/60
velocity / position iterations (and 180/60 with exact trig), at 4096 and at
512 envs: what the narrow phase and setup, a velocity sweep and a position
sweep cost, and whether the time follows the env count or the most loaded
env.

``size_classes`` (v0, v3: the worlds that fit both instantiations): first,
before this process launches either kernel, the device memory the driver
reserves for each class's per-thread stack frames (free memory before and
after the first launch of each kernel in the small class, then in the
large one); then both kernels launched in either class, outputs bitwise
equal, timed in turns (small large large small, ``--repeats`` times over).
"""

from __future__ import annotations

import argparse
import json
import subprocess
from concurrent.futures import ThreadPoolExecutor

import torch

from gym_puzzles_tpu_torch.api.registry import _logic
from gym_puzzles_tpu_torch.engine import _cuda_build as cb
from gym_puzzles_tpu_torch.engine import solver_cuda, step_cuda, world

ENV_IDS = ("MultiRobotPuzzle-v0", "MultiRobotPuzzle-v2")
CLASS_ENV_IDS = ("MultiRobotPuzzle-v0", "MultiRobotPuzzle-v3")
NUM_ENVS = 4096
DT = 1.0 / 50.0
VI, PI = 180, 60
ENVS_PER_WARP = (32, 16, 8, 4)
PHASE_ITERS = ((0, 0, True), (180, 0, True), (0, 60, True), (180, 60, True), (180, 60, False))


def spawns(dev, env_id, E):
    """(table, the tick's inputs after (table,)) of E spawns after random
    controls; torch ops only, no kernel launch."""
    logic = _logic(env_id)
    gen = torch.Generator(device=dev).manual_seed(0)
    state, _obs = logic.reset_fast(gen, E, logic.default_params())
    act = torch.rand((logic.cfg.act_dim, E), generator=gen, device=dev) * 2 - 1
    bodies, force, torque, wake = logic._control(state, act)
    return logic.layout.table, (bodies, state.contacts, force, torque, wake)


def inputs(dev, env_id, E=NUM_ENVS):
    """(table, fused planes, fused live [P, E], solve planes, solve live
    [P, E]) of E spawns: the fused kernel's tick, and the contact solve of
    the tick after it."""
    table, tick = spawns(dev, env_id, E)
    fused_live = cb.live_pairs(table, *tick, DT)
    bodies, contacts, _ = step_cuda.step_fused(table, *tick, DT, VI, PI)
    solve_args = world.before_solve(table, bodies, contacts, *tick[2:], DT)[0]
    solve_live = solve_args[0].solve & (solve_args[0].count > 0)
    return (table, step_cuda.pack(*tick), fused_live, solver_cuda.pack(*solve_args),
            solve_live)


def fused_runner(kernel, table, planes, size_class=None):
    """``run(vel_iters, pos_iters, incremental_trig)``: one launch of
    ``kernel`` (a build of ``step_fused.cu``) on these planes, in
    ``size_class`` (default: the table's), into outputs allocated here once;
    returns them."""
    bf, pf, ids = planes
    B, P, E = table.num_bodies, table.num_pairs, bf.shape[-1]
    cls = cb.size_class(table) if size_class is None else size_class
    out = (torch.empty((len(step_cuda.B_OUT) * B, E), device=bf.device),
           torch.empty((len(step_cuda.P_OUT) * P, E), device=bf.device),
           torch.empty((2 * P, E), dtype=torch.int32, device=bf.device))

    def run(vi=VI, pi=PI, inc=True):
        kernel.launch(table, bf.device, *(x.data_ptr() for x in (bf, pf, ids, *out)), E, DT,
                      vi, pi, int(inc), cls)
        return out
    return run


def solve_runner(kernel, table, planes, size_class=None):
    """The same for a build of ``solve_contacts.cu``."""
    body = planes[3]
    B, E = table.num_bodies, body.shape[-1]
    cls = cb.size_class(table) if size_class is None else size_class
    out = (torch.empty_like(body), torch.empty_like(planes[4]),
           torch.empty((B, E), device=body.device))

    def run(vi=VI, pi=PI, inc=True):
        kernel.launch(table, body.device, *(x.data_ptr() for x in (*planes, *out)), E, DT, vi,
                      pi, int(inc), cls)
        return out
    return run


def runners(kernels, table, fplanes, splanes, size_class=None):
    """Kernel A's and B's runners, by wrapper module; ``kernels`` maps a
    wrapper module to the build to launch."""
    return {m: RUNNER[m](kernels[m], table, fplanes if m is step_cuda else splanes, size_class)
            for m in kernels}


RUNNER = {step_cuda: fused_runner, solver_cuda: solve_runner}
DEFAULT = {step_cuda: step_cuda.KERNEL, solver_cuda: solver_cuda.KERNEL}


def variant(kernel, envs_per_warp: int) -> cb.CudaKernel:
    """``kernel``'s source built for ``envs_per_warp`` envs per warp."""
    return cb.CudaKernel(f"{kernel.name}_epw{envs_per_warp}", kernel.source, kernel.entry,
                         kernel.argtypes, (f"GPT_ENVS_PER_WARP={envs_per_warp}",))


def cuda_ms(fn, n=10) -> float:
    fn()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / n


def outputs_equal(run_a, run_b) -> bool:
    want = [x.clone() for x in run_a()]
    return all(torch.equal(g, w) for g, w in zip(run_b(), want))


def build_all(kernels):
    with ThreadPoolExecutor(len(kernels)) as pool:  # one nvcc per build, all at once
        for f in [pool.submit(k.build) for k in kernels]:
            f.result()


def envs_per_warp(dev, card, repeats: int) -> list[dict]:
    builds = {(m, n): variant(m.KERNEL, n) for m in DEFAULT for n in ENVS_PER_WARP}
    build_all([*builds.values(), *DEFAULT.values()])
    for (_m, n), k in builds.items():
        assert k.envs_per_warp() == n
    order = list(ENVS_PER_WARP) + list(reversed(ENVS_PER_WARP))
    rows = []
    for env_id in ENV_IDS:
        table, fplanes, flive, splanes, slive = inputs(dev, env_id)
        default = runners(DEFAULT, table, fplanes, splanes)
        for m in DEFAULT:
            live = flive if m is step_cuda else slive
            run = {n: runners({m: builds[(m, n)]}, table, fplanes, splanes)[m]
                   for n in ENVS_PER_WARP}
            for n in ENVS_PER_WARP:
                if not outputs_equal(default[m], run[n]):
                    raise AssertionError(f"{m.KERNEL.name} {env_id}: envs per warp {n} "
                                         "changed the outputs")
            samples = {n: [] for n in ENVS_PER_WARP}
            for _ in range(repeats):
                for n in order:
                    samples[n].append(cuda_ms(run[n]))
            for n in ENVS_PER_WARP:
                stats = cb.live_pair_stats(live, n)
                rows.append(dict(kernel=m.KERNEL.name, env_id=env_id, envs_per_warp=n,
                                 ms=samples[n], best_ms=min(samples[n]),
                                 live_mean=stats["mean"], live_warp_max=stats["warp_max"],
                                 live_env_max=stats["max"]))
                print(f"{m.KERNEL.name:15s} {env_id:22s} {n:2d} envs/warp: "
                      + " ".join(f"{t:.3f}" for t in samples[n])
                      + f" ms; live pairs per env mean {stats['mean']:.3f}, warp max "
                      f"{stats['warp_max']:.3f}, env max {stats['max']:.0f}  [{card}]",
                      flush=True)
    best = {}
    for row in rows:
        key = (row["kernel"], row["env_id"])
        if key not in best or row["best_ms"] < best[key]["best_ms"]:
            best[key] = row
    for (kernel, env_id), row in best.items():
        print(f"fastest: {kernel} {env_id}: {row['envs_per_warp']} envs per warp "
              f"({row['best_ms']:.3f} ms); the default build runs "
              f"{step_cuda.KERNEL.envs_per_warp()}", flush=True)
    return rows


def phases(dev, card) -> list[dict]:
    rows = []
    for env_id in ENV_IDS:
        for E in (NUM_ENVS, 512):
            table, fplanes, flive, splanes, slive = inputs(dev, env_id, E)
            run = runners(DEFAULT, table, fplanes, splanes)
            for vi, pi, inc in PHASE_ITERS:
                ta = cuda_ms(lambda: run[step_cuda](vi, pi, inc))
                tb = cuda_ms(lambda: run[solver_cuda](vi, pi, inc))
                rows.append(dict(env_id=env_id, num_envs=E, vel_iters=vi, pos_iters=pi,
                                 incremental_trig=inc, step_fused_ms=ta, solve_contacts_ms=tb,
                                 step_fused_env_max=float(flive.sum(dim=0).max()),
                                 solve_contacts_env_max=float(slive.sum(dim=0).max())))
                print(f"{env_id:22s} E={E:4d} {vi:3d}/{pi:2d} "
                      f"{'incremental' if inc else 'exact'} trig: step_fused {ta:.4f} ms "
                      f"(env max {rows[-1]['step_fused_env_max']:.0f} live pairs), "
                      f"solve_contacts {tb:.4f} ms "
                      f"(env max {rows[-1]['solve_contacts_env_max']:.0f})  [{card}]",
                      flush=True)
    return rows


def stack_reservation(dev, card) -> dict:
    """Device memory the driver takes for local memory at each class's first
    launch: free bytes before any launch, after kernel A and B in the small
    class, after both in the large class.  Must run before anything else of
    this process launches a kernel."""
    build_all(list(DEFAULT.values()))
    ptxas = {m.KERNEL.name: cb.ptxas_report(m.KERNEL.build()[1]) for m in DEFAULT}
    table, tick = spawns(dev, CLASS_ENV_IDS[0], NUM_ENVS)
    solve_args = world.before_solve(table, *tick, DT)[0]
    fplanes, splanes = step_cuda.pack(*tick), solver_cuda.pack(*solve_args)
    run = {cls: runners(DEFAULT, table, fplanes, splanes, cls)
           for cls in range(len(cb.SIZE_CLASSES))}
    torch.cuda.synchronize()
    free = [torch.cuda.mem_get_info(dev)[0]]
    for cls in run:
        for m in DEFAULT:
            run[cls][m](0, 0)
        torch.cuda.synchronize()
        free.append(torch.cuda.mem_get_info(dev)[0])
    out = dict(free_bytes=free, ptxas=ptxas,
               taken_bytes=[free[i] - free[i + 1] for i in range(len(free) - 1)])
    for cls, taken in enumerate(out["taken_bytes"]):
        print(f"size class {cls} {cb.SIZE_CLASSES[cls]}: first launches of both kernels took "
              f"{taken} bytes of device memory (free {free[cls]} -> {free[cls + 1]}); stack "
              "frames " + ", ".join(f"{name} {r['stack']} B" for name, rs in ptxas.items()
                                    for r in rs if (r["bodies"], r["pairs"]) ==
                                    cb.SIZE_CLASSES[cls]) + f"  [{card}]", flush=True)
    return out


def size_classes(dev, card, repeats: int) -> dict:
    memory = stack_reservation(dev, card)
    order = [0, 1, 1, 0]
    rows = []
    for env_id in CLASS_ENV_IDS:
        table, fplanes, _flive, splanes, _slive = inputs(dev, env_id)
        if cb.size_class(table) != 0:
            raise AssertionError(f"{env_id} does not fit the small class")
        run = {cls: runners(DEFAULT, table, fplanes, splanes, cls) for cls in (0, 1)}
        for m in DEFAULT:
            if not outputs_equal(run[0][m], run[1][m]):
                raise AssertionError(f"{m.KERNEL.name} {env_id}: the classes' outputs differ")
            samples = {0: [], 1: []}
            for _ in range(repeats):
                for cls in order:
                    samples[cls].append(cuda_ms(run[cls][m]))
            for cls in (0, 1):
                rows.append(dict(kernel=m.KERNEL.name, env_id=env_id, size_class=cls,
                                 ms=samples[cls], best_ms=min(samples[cls])))
                print(f"{m.KERNEL.name:15s} {env_id:22s} size class {cls} "
                      f"{cb.SIZE_CLASSES[cls]}: " + " ".join(f"{t:.4f}" for t in samples[cls])
                      + f" ms (best {min(samples[cls]):.4f})  [{card}]", flush=True)
    return dict(memory=memory, rows=rows)


def main(what: str, repeats: int = 2) -> dict:
    if not torch.cuda.is_available():
        raise SystemExit("bench_kernels: needs a CUDA device")
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    if what == "envs_per_warp":
        result = envs_per_warp(dev, card, repeats)
    elif what == "phases":
        result = phases(dev, card)
    else:
        result = size_classes(dev, card, repeats)
    out = dict(measure=what, card=card, device=torch.cuda.get_device_name(0),
               default_envs_per_warp=step_cuda.KERNEL.envs_per_warp(), result=result)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("what", choices=("envs_per_warp", "phases", "size_classes"))
    parser.add_argument("--repeats", type=int, default=2)
    args = parser.parse_args()
    main(args.what, args.repeats)
