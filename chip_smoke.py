#!/usr/bin/env python3
"""Quickest proof that the PyTorch port runs on an NVIDIA H100.

    python3 chip_smoke.py

Phases (each raises on failure; the script exits non-zero on any):
1. the card (nvidia-smi name and power limit), torch and CUDA versions;
2. build the fused tick kernel from ``gym_puzzles_tpu_torch/csrc`` (nvcc,
   sm_90a) and print the build time and ptxas' register / spill report;
3. hold the kernel against its plain PyTorch version (``world.step``) on the
   card: the injected 3-body push world (10 ticks at 8/4), v0 random spawns
   at 4096 envs (1 tick at 180/60), 1000 envs (the ragged edge), and the
   exact against the incremental position-pass trig on a 12-tick v0 contact
   drive;
4. the main path: ``make("MultiRobotPuzzle-v0", num_envs=4096)`` with the
   default device and backend, a reset, then 200 steps of random actions;
   every output finite, and exactly 200 kernel launches;
5. one JSON line describing each ported kernel (times, bound, launches);
6. last line: ``{"ok": true, "device": {...}}``.

Needs one CUDA card; imports nothing of JAX or the JAX package.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

from gym_puzzles_tpu_torch import make
from gym_puzzles_tpu_torch.api.registry import _logic
from gym_puzzles_tpu_torch.engine import shapes as shp
from gym_puzzles_tpu_torch.engine import step_cuda, types, world

ENV_ID = "MultiRobotPuzzle-v0"
NUM_ENVS = 4096
DT = 1.0 / 50.0
MAIN_STEPS = 200
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
F32_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores

# Float32 operations per unit of work in csrc/tick.cuh and step_fused.cu,
# counted from the source (each multiply, add, compare, min/max, select or
# divide is one; cos/sin count as 20).  Pairs of two dynamic bodies ("dd")
# update both; a dynamic-static pair only one.  Used for the kernel's bound.
OPS_VEL_PAIR = {True: 209, False: 154}  # one velocity-sweep visit, by dd
OPS_POS_PAIR = {True: 229, False: 157}  # one position-sweep visit (incremental trig)
OPS_POS_SWEEP_BODY = 40  # cos/sin of each dynamic body once per position sweep
OPS_SETUP_PAIR = 190  # constraint setup of a pair
OPS_BODY = 150  # transforms, integration, islands and sleep per body


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def maxdiff(a, b) -> float:
    return float((a.double() - b.double()).abs().max())


def narrowphase_ops(table) -> int:
    """SAT + clip operations of one narrow-phase pass over every pair."""
    ops = 0
    for p in range(table.num_pairs):
        ca = int(table.fix_count[table.pair_fix_a[p]])
        cb = int(table.fix_count[table.pair_fix_b[p]])
        ops += 28 + ca * (20 + 4 * cb) + cb * (20 + 4 * ca) + 5 * max(ca, cb) + 120
    return ops


def kernel_bound(table, touching, vel_iters, pos_iters) -> dict:
    """Least time the card could take for one tick of these envs: bytes each
    read or written once at the HBM rate, against the float32 operations
    these inputs need at the float32 rate (sweeps counted over the pairs in
    contact only).  Returns the bound in ms, what bounds it, and its parts."""
    B, P = table.num_bodies, table.num_pairs
    E = touching.shape[-1]
    nbytes = E * 4 * ((12 + 8) * B + (15 + 17) * P + 2 * 2 * P)
    dyn = ~table.is_static
    n_dyn = int(dyn.sum())
    per_pair = touching.sum(dim=-1).tolist()  # envs in contact, per pair
    in_contact = int(sum(per_pair))
    ops = E * (narrowphase_ops(table) + OPS_SETUP_PAIR * P + OPS_BODY * B
               + pos_iters * OPS_POS_SWEEP_BODY * n_dyn)
    for p, n in enumerate(per_pair):
        dd = bool(dyn[table.pair_body_a[p]] and dyn[table.pair_body_b[p]])
        ops += n * (vel_iters * OPS_VEL_PAIR[dd] + pos_iters * OPS_POS_PAIR[dd])
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    return dict(ms=1e3 * max(t_bytes, t_ops), by="bytes" if t_bytes >= t_ops else "operations",
                bytes=nbytes, ops=ops, pairs_in_contact=in_contact,
                bytes_ms=1e3 * t_bytes, ops_ms=1e3 * t_ops)


def ticks(table, bodies, contacts, n, vi, pi, tick, control):
    """``n`` ticks with ``tick``; ``control(bodies)`` sets velocities and
    returns (bodies, force, torque, wake) before each."""
    info = None
    for _ in range(n):
        bodies, force, torque, wake = control(bodies)
        bodies, contacts, info = tick(table, bodies, contacts, force, torque, wake, DT, vi, pi)
    return bodies, contacts, info


def exact_kernel(*args):
    return step_cuda.step_fused(*args, incremental_trig=False)


def check_push_world(dev) -> dict:
    """T-block + two octagon agents pushing it (the JAX package's fused
    kernel numerics world), 10 ticks at 8/4, kernel against plain."""
    T_BOXES = [(0.5, 0.5, 0.0, -0.5), (1.5, 0.5, 0.0, 0.5)]
    AGENT = [(-0.25, -0.75), (0.25, -0.75), (0.75, -0.25), (0.75, 0.25),
             (0.25, 0.75), (-0.25, 0.75), (-0.75, 0.25), (-0.75, -0.25)]
    blk = types.BodySpec(
        fixtures=[types.FixtureSpec(vertices=shp.box_vertices(hx, hy, (cx, cy)),
                                    density=5.0, friction=0.999)
                  for hx, hy, cx, cy in T_BOXES],
        linear_damping=5.0, angular_damping=5.0)
    agent = lambda: types.BodySpec(
        fixtures=[types.FixtureSpec(vertices=np.array(AGENT), density=0.0, friction=0.2,
                                    from_hull=True)],
        linear_damping=5.0, angular_damping=5.0)
    table = types.build_shape_table([blk, agent(), agent()])
    E = 256
    origin = torch.tensor([(5.0, 5.0), (2.76, 5.5), (5.0, 3.26)], device=dev)[..., None]
    bodies = world.init_bodies(table, origin.expand(3, 2, E).contiguous(),
                               torch.zeros(3, E, device=dev))
    contacts = world.init_contacts(table, E, dev)
    v = torch.tensor([[0.0, 0.0], [4 / 3.0, 0.0], [0.0, 4 / 3.0]], device=dev)[..., None]
    zf = torch.zeros(3, 2, E, device=dev)
    zt = torch.zeros(3, E, device=dev)
    wake = torch.tensor([False, True, True], device=dev)[:, None].expand(3, E)

    def control(b):
        vel = torch.cat([b.vel[:1], v[1:].expand(2, 2, E)])
        omega = torch.cat([b.omega[:1], torch.zeros(2, E, device=dev)])
        return b.replace(vel=vel, omega=omega), zf, zt, wake

    bk, ck, _ = ticks(table, bodies, contacts, 10, 8, 4, exact_kernel, control)
    bp, cp, _ = ticks(table, bodies, contacts, 10, 8, 4, world.step, control)
    if not bool(cp.touching.any()):
        raise AssertionError("push world: no contact formed")
    d = dict(pos=maxdiff(bk.pos, bp.pos), angle=maxdiff(bk.angle, bp.angle),
             impulse=maxdiff(ck.normal_impulse, cp.normal_impulse))
    limits = dict(pos=1e-5, angle=1e-6, impulse=1e-4)
    report("push world 10 ticks 8/4", d, limits)
    if not (torch.equal(ck.man.ids, cp.man.ids) and torch.equal(bk.awake, bp.awake)):
        raise AssertionError("push world: contact ids or awake flags differ")
    return d


def v0_spawn_tick(dev, E, seed):
    """(table, bodies, contacts, force, torque, wake) of E fresh v0 spawns
    after random controls: one tick's inputs."""
    logic = _logic(ENV_ID)
    gen = torch.Generator(device=dev).manual_seed(seed)
    state, _obs = logic.reset_fast(gen, E, logic.default_params())
    act = torch.rand((logic.cfg.act_dim, E), generator=gen, device=dev) * 2 - 1
    return (logic.layout.table, state.contacts) + logic._control(state, act)


def check_spawns(dev, E, seed) -> tuple[dict, float]:
    """One 180/60 tick of E v0 random spawns, kernel against plain.  Returns
    (differences, plain ms)."""
    table, contacts, bodies, force, torque, wake = v0_spawn_tick(dev, E, seed)
    args = (table, bodies, contacts, force, torque, wake, DT, 180, 60)
    bk, ck, _ = step_cuda.step_fused(*args, incremental_trig=False)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    bp, cp, _ = world.step(*args)
    torch.cuda.synchronize()
    plain_ms = 1e3 * (time.perf_counter() - t0)
    d = (bk.pos - bp.pos).abs().amax(dim=(0, 1))
    touch = cp.touching.any(dim=0)
    out = dict(no_contact_max=float(d[~touch].max()) if bool((~touch).any()) else 0.0,
               median=float(d.median()), max=float(d.max()))
    report(f"v0 spawns E={E} 1 tick 180/60 ({int(touch.sum())} envs in contact)", out,
           dict(no_contact_max=1e-4, median=1e-3))
    if not torch.equal(bk.awake, bp.awake):
        raise AssertionError(f"spawns E={E}: awake flags differ")
    if not all(bool(torch.isfinite(x).all()) for x in (bk.pos, bk.vel, ck.normal_impulse)):
        raise AssertionError(f"spawns E={E}: kernel output not finite")
    return out, plain_ms


def check_trig(dev) -> dict:
    """Exact against incremental position-pass trig: a 12-tick v0 contact
    drive (agents pushing the block face-on) at 180/60, kernel only."""
    logic = _logic(ENV_ID)
    E = 512
    origin = torch.tensor([[0.0, 8.0], [21.33, 8.0], [10.67, 0.0], [10.67, 16.0],
                           [10.0, 8.0], [7.745, 8.5], [10.0, 6.245]], device=dev)
    state = logic.inject(origin[..., None].expand(7, 2, E).contiguous(),
                         torch.zeros(7, E, device=dev),
                         torch.tensor([320.0, 262.5, 0.0], device=dev)[:, None].expand(3, E))
    act = torch.tensor([1.0, 0.0, 0.0, 0.0, 1.0, 0.0], device=dev)[:, None].expand(6, E)
    out = {}
    for incremental in (False, True):
        s = state
        for _ in range(12):
            bodies, force, torque, wake = logic._control(s, act)
            bodies, contacts, _ = step_cuda.step_fused(
                logic.layout.table, bodies, s.contacts, force, torque, wake, DT, 180, 60,
                incremental_trig=incremental)
            s = s.replace(bodies=bodies, contacts=contacts)
        out[incremental] = s
    if not bool(out[False].contacts.touching.any()):
        raise AssertionError("trig drive: no contact formed")
    e, i = out[False], out[True]
    d = dict(pos=maxdiff(e.bodies.pos, i.bodies.pos), angle=maxdiff(e.bodies.angle, i.bodies.angle),
             impulse=maxdiff(e.contacts.normal_impulse, i.contacts.normal_impulse))
    report("trig exact vs incremental, 12-tick v0 contact drive", d,
           dict(pos=1e-6, angle=1e-6, impulse=1e-6))
    return d


def report(name, diffs, limits):
    line = ", ".join(f"{k} {v:.3e}" + (f" (limit {limits[k]:g})" if k in limits else "")
                     for k, v in diffs.items())
    print(f"  {name}: {line}", flush=True)
    bad = [k for k, lim in limits.items() if not diffs[k] <= lim]
    if bad:
        raise AssertionError(f"{name}: {bad} beyond limits")


def cuda_ms(fn, n) -> float:
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / n


def run_main_path(dev, card_line) -> dict:
    env = make(ENV_ID, num_envs=NUM_ENVS)
    if env.device.type != "cuda":
        raise AssertionError(f"make() defaulted to {env.device}")
    state, obs = env.reset(seed=0)
    gen = torch.Generator(device=dev).manual_seed(1)
    acts = torch.rand((MAIN_STEPS + 10, NUM_ENVS, env.cfg.act_dim), generator=gen,
                      device=dev) * 2 - 1
    for k in range(10):  # warm-up
        state, obs, reward, done, info = env.step(state, acts[MAIN_STEPS + k])
    torch.cuda.synchronize()

    step_cuda.reset_launch_count()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    finite = torch.ones((), dtype=torch.bool, device=dev)
    for k in range(MAIN_STEPS):
        state, obs, reward, done, info = env.step(state, acts[k])
        finite &= torch.isfinite(obs).all() & torch.isfinite(reward).all()
    stop.record()
    stop.synchronize()
    launches = step_cuda.launch_count()
    elapsed_s = start.elapsed_time(stop) / 1e3

    if launches != MAIN_STEPS:
        raise AssertionError(f"main path launched the kernel {launches} times in "
                             f"{MAIN_STEPS} steps")
    if not bool(finite):
        raise AssertionError("main path produced non-finite obs or rewards")
    if obs.shape != (NUM_ENVS, env.cfg.obs_dim) or reward.shape != (NUM_ENVS,):
        raise AssertionError(f"main path shapes: obs {tuple(obs.shape)} reward {tuple(reward.shape)}")
    for name in ("pos", "vel", "angle", "omega"):
        if not bool(torch.isfinite(getattr(state.bodies, name)).all()):
            raise AssertionError(f"main path state.bodies.{name} not finite")
    rate = MAIN_STEPS * NUM_ENVS / elapsed_s
    print(f"  {MAIN_STEPS} steps x {NUM_ENVS} envs in {elapsed_s:.3f} s: "
          f"{rate:,.0f} env-steps/s  [{card_line}]", flush=True)
    print(f"  kernel launches in the main path: {launches}", flush=True)
    return dict(env=env, state=state, launches=launches, env_steps_per_s=rate)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    card_line = card()

    print("== 1. card", flush=True)
    print(card_line, flush=True)
    print(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}", flush=True)

    print("== 2. build", flush=True)
    t0 = time.perf_counter()
    path, log = step_cuda.build()
    print(f"  built {path.name} in {time.perf_counter() - t0:.1f} s", flush=True)
    for line in log.splitlines():
        if "registers" in line or "stack frame" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}", flush=True)

    print("== 3. kernel against plain on the card", flush=True)
    check_push_world(dev)
    spawn_diff, plain_ms = check_spawns(dev, NUM_ENVS, seed=0)
    check_spawns(dev, 1000, seed=1)
    check_trig(dev)

    print("== 4. main path", flush=True)
    main_run = run_main_path(dev, card_line)

    # kernel time at the main path's shapes: a tick of 4096 fresh v0 spawns
    table, contacts, bodies, force, torque, wake = v0_spawn_tick(dev, NUM_ENVS, 0)
    bf, pf, pi = step_cuda.pack(bodies, contacts, force, torque, wake)
    launch = lambda: step_cuda.launch(table, bf, pf, pi, DT, 180, 60)
    launch()
    kernel_ms = cuda_ms(launch, 10)
    _bfo, pfo, _pio = step_cuda.launch(table, bf, pf, pi, DT, 180, 60)
    touching = pfo.view(len(step_cuda.P_OUT), table.num_pairs, NUM_ENVS)[
        step_cuda.P_OUT.index("touch")] > 0.5
    bound = kernel_bound(table, touching, 180, 60)
    print(f"  kernel {kernel_ms:.3f} ms/tick, plain {plain_ms:.1f} ms/tick, bound "
          f"{bound['ms']:.4f} ms ({bound['by']}) at {NUM_ENVS} envs 180/60  [{card_line}]",
          flush=True)
    print(f"  bound parts: {bound['bytes']} bytes = {bound['bytes_ms']:.4f} ms, {bound['ops']} "
          f"f32 ops = {bound['ops_ms']:.4f} ms ({bound['pairs_in_contact']} pairs in contact)",
          flush=True)

    print("== 5. kernels", flush=True)
    print(json.dumps({"kernels": [{
        "name": "step_fused",
        "route": "cuda",
        "source": "gym_puzzles_tpu_torch/csrc/step_fused.cu",
        "replaces": "gym_puzzles_tpu/engine/step_pallas.py:539",
        "launches": main_run["launches"],
        "max_abs_err": spawn_diff["max"],
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound["ms"],
        "bound_by": bound["by"],
        "library_ms": None,
        "checked": True,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
