#!/usr/bin/env python3
"""Quickest proof that the PyTorch port runs on an NVIDIA H100.

    python3 chip_smoke.py

Phases (each raises on failure; the script exits non-zero on any):
1. the card (nvidia-smi name and power limit), torch and CUDA versions;
2. build both kernels from ``gym_puzzles_tpu_torch/csrc`` (one nvcc each,
   started together, sm_90a) and print the build time and, for every
   instantiation (size class) of each, ptxas' registers, stack frame and
   spills;
3. hold the fused tick kernel against its plain PyTorch version
   (``world.step``) on the card: the injected 3-body push world (10 ticks at
   8/4), v0 random spawns at 4096 envs (1 tick at 180/60), 1000 envs (the
   ragged edge), 4096 spawns each of Heavy-v0, v2 and v3 (the shapes the
   main paths give it), and the exact against the incremental position-pass
   trig on a 12-tick v0 contact drive; and, once phase 5 has run it, on the
   state the 200-step v0 fused drive ends with (resting contacts, sleeping
   bodies), with the kernel's time on that state;
4. hold the contact-solve kernel against its plain version
   (``solver_cuda.solve_contacts_plain``): the push world through the staged
   tick, the constraints of 4096 v0 spawns, 1000 v0 spawns (ragged) and 4096
   v2 spawns after the PyTorch prologue, exact against incremental trig on
   each, and on 12-tick v0 and v2 contact drives;
5. the main paths at 4096 envs and 180/60, 200 steps of random actions each
   through ``make(...)`` with the default device: v0 fused, v0 and v2 staged
   (``backend='pallas'``), v2 and v3 fused; every output finite; exactly
   200 x frameskip launches of the path's kernel and none of the other;
7. train: PPO on v0 at 4096 envs through ``train.ppo.PPO`` (fused backend,
   180/60, ActorCritic 256x256, the JAX package's full-width recipe: n_steps
   64, batch 8192, 4 epochs, the rest from ``train_configs/ppo-mrp-v0.json``)
   for 3 updates: finite metrics, params moved, ``timesteps`` 786,432 as
   int64, exactly 192 launches of the fused tick kernel and none of the
   solve kernel; saved after update 2, restored into a fresh learner, whose
   update 3 must equal the uninterrupted one bit for bit (params, Adam state,
   normalizer, env state, generators, metrics); each update's wall time,
   env-steps/s including the learner, and the split of timed updates into
   env step, policy forward, GAE and update;
8. eval of the committed v0 policy (``gym_puzzles_tpu_torch/policies/``):
   its deterministic actions on the obs of 4096 resets on the card against
   the CPU (1e-5), then 4096 deterministic episodes of at most 2000 steps through
   ``evaluate_policy_batched`` (fused): completion share (``done_status`` 3) in
   [0.82, 0.93] and mean return in [5190, 6800], the bands around the JAX
   package's record for this policy (337/384, mean 5992);
9. pixels (the image pipeline, whose physics is the fused tick kernel at
   frameskip 4): the on-device renderer on the card against the same
   renderer on the CPU (4096 v0 spawns, human vision; 1024 v2 spawns, agent
   vision; 1024 v3 spawns; downsample 4), share of equal pixels >= 0.999;
   CNN PPO at the JAX package's pixel recipe (256 image envs, fused, 60/20,
   n_steps 32, batch 2048, 2 epochs, seed 0) through ``train_and_resume`` as
   in phase 7 with cuDNN held deterministic: 384 launches of the fused tick
   kernel in 3 updates and none of the solve kernel, the resumed update
   bitwise, one more update split into physics, render, policy, GAE and
   update; the policy those updates produce: deterministic actions on the
   obs of 256 reference resets on the card against the CPU, then 256
   deterministic episodes of at most 100 steps at 180/60 through
   ``evaluate_policy_batched`` (4 launches per env step); kernel A at the
   pixel path's shape (256 v0 spawns, 60/20 and 180/60) against
   ``world.step`` on the same inputs (``SPAWN_LIMITS``) and incremental
   against exact trig, then its time per launch beside its bound;
10. host surface: the old-Gym ``GymPuzzleEnv`` (one env, the fused tick
   kernel at E = 1) for 200 random-action steps on each of v0, v2 and v3:
   exactly one kernel-A launch per step plus one per reset, wall ms per
   step; kernel A at E = 1 and E = 13 (the grid's one block, a partial last
   warp) against ``world.step`` on v0 and Heavy-v0 spawns (``SPAWN_LIMITS``;
   incremental against exact trig), and its time per launch at E = 1 beside
   its bound; the host rasterizer (C++ core, built with g++) on card states
   against the card's renderer at downsample 4 (>= 0.999 of the pixels
   equal); ``GymnasiumVectorAdapter`` for 20 steps at 4096 envs;
   ``ImageObsEnv`` for 20 steps (4 launches per step); ``record_video`` of
   the committed v0 policy for up to 300 steps (frames, ms per frame);
11. scripted and BC at full width: ``pusher_action`` (offset 70) and
   ``planner_action`` on Heavy-v0, 4096 envs, reference reset, 180/60, up
   to the 3,000-step limit: completions, mean return and median completed
   length beside the JAX package's records (a report, not a gate); then
   ``bc_train`` at the imitate CLI's width (Heavy-v0, 4096 envs, n_steps 64,
   batch 8192, 4 epochs) for 3 of its 60 rounds: 192 kernel-A launches, s
   per round, loss terms; then ``train.cli --resume`` one PPO update from
   its checkpoint (64 launches);
12. sweep: ``run_fast_sweep`` at the v0 recipe width (4096 envs,
   ``train_configs/ppo-mrp-v0.json``), 2 trials x 1 update, each ranked by
   256 deterministic eval episodes cut to 200 steps: s per trial, ranking,
   launches;
13. distribution (``gym_puzzles_tpu_torch.parallel``) at the v0 recipe of
   phase 7: (a) ``DistributedPPO`` on a one-rank NCCL group for 3 updates
   against a plain ``PPO`` given the same action noise and minibatch orders:
   every state field and metric equal bit for bit after each update, 192
   kernel-A launches and none of B, env-steps/s of both, all-reduces per
   update and one gradient all-reduce's wall time; (b) two processes share
   the card over gloo (NCCL refuses two ranks on one device), 2048 envs
   each, 2 updates: replicated state and metrics bitwise equal across the
   ranks after every update, env shards different, 64 launches per rank per
   update, a heartbeat, and a sharded save after update 1 restored into a
   fresh two-process job whose update 2 equals the first job's bit for bit;
   (c) the scaling bench's n = 1 row at its defaults and one update of
   ``torchrun --nproc_per_node 1 -m gym_puzzles_tpu_torch.train.cli
   --distributed``;
6. (run after 7-13) both kernels' times per variant, beside the mean
   and warp-max live pairs per env of the inputs timed (the sweeps visit
   only those), and one JSON line describing each ported kernel (times,
   bound, launches);
last line: ``{"ok": true, "device": {...}}``.

Needs one CUDA card; imports nothing of JAX or the JAX package.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from gym_puzzles_tpu_torch import make
from gym_puzzles_tpu_torch.api.gym_compat import GymnasiumVectorAdapter, GymPuzzleEnv
from gym_puzzles_tpu_torch.api.image_obs import ImageObsEnv
from gym_puzzles_tpu_torch.api.registry import _logic
from gym_puzzles_tpu_torch.engine import _cuda_build as cb
from gym_puzzles_tpu_torch.engine import shapes as shp
from gym_puzzles_tpu_torch.engine import solver_cuda, step_cuda, types, world
from gym_puzzles_tpu_torch.render import _raster_cpp
from gym_puzzles_tpu_torch.render.device import make_device_renderer
from gym_puzzles_tpu_torch.render.raster import render_batch
from gym_puzzles_tpu_torch.parallel import DistributedPPO, Heartbeat, scaling_bench
from gym_puzzles_tpu_torch.parallel import train_state_specs
from gym_puzzles_tpu_torch.train import checkpoint as ckpt
from gym_puzzles_tpu_torch.train import cli, evaluate, imitate, scripted, sweep
from gym_puzzles_tpu_torch.train import normalize as nrm
from gym_puzzles_tpu_torch.train.ppo import PPO, PhaseTimer, PPOConfig

ENV_ID = "MultiRobotPuzzle-v0"
NUM_ENVS = 4096
DT = 1.0 / 50.0
MAIN_STEPS = 200
VI, PI = 180, 60  # the reference's solver iterations
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
OPS_SOLVE_BODY = 40  # the solve kernel alone: island labels and integration per body

VARIANTS = ("MultiRobotPuzzle-v0", "MultiRobotPuzzleHeavy-v0", "MultiRobotPuzzle-v2",
            "MultiRobotPuzzle-v3")
# incremental against exact position-pass trig: 10x what the JAX package
# records for its kernels after 12 contact steps (4.8e-7 m, 3.3e-6 rad)
TRIG_LIMITS = dict(pos=4.8e-6, angle=3.3e-5, impulse=1e-6)
# the same on one solve of random spawns, whose deep overlaps the 60 position
# sweeps resolve chaotically and whose coordinates reach 21 m (one float32
# step there is 1.9e-6): ten such steps
# (the trig mode touches the position pass only, so what the velocity pass
# leaves -- velocities and impulses -- is equal)
SPAWN_TRIG_LIMITS = dict(pos=2e-5, angle=3.3e-5, vel=0.0, impulse=0.0)
# A kernel against its plain version on one solve of random spawns, largest
# difference over all envs, those in contact included.  Measured on an H100
# at 4096 envs: positions up to 1.8e-5 m; angles up to 2.5e-4 rad (v2, whose
# wheel bodies have little inertia) and 7.2e-6 elsewhere; normal impulses, which
# the deep overlaps of a spawn drive high, up to 8.5e-3 N s.  The limits are
# five to twelve times these.  ``impulse_scale``, the largest impulse, is
# printed beside them.
SPAWN_LIMITS = dict(no_contact_max=1e-4, median=1e-3, max=1e-4, angle=2e-3, impulse=0.1)
# position_solved compares a min separation with -3 * linear_slop, so a
# last-bit difference can flip it: at most this share of the envs in contact
# (measured: no env differs)
SOLVED_FLAGS_SHARE = 0.001

ROOT = Path(__file__).resolve().parent
# phase 7: the JAX package's full-width v0 recipe (docs/BENCHMARKS.md:187)
TRAIN_CONFIG = ROOT / "train_configs" / "ppo-mrp-v0.json"
TRAIN_OVERRIDES = dict(n_envs=NUM_ENVS, n_steps=64, batch_size=8192, n_epochs=4,
                       env_backend="fused", seed=0)
TRAIN_UPDATES = 3
TIMED_UPDATES = 2  # after the resumed update 3, each split by part
# phase 8: the committed round-4 v0 policy and the bands around the JAX
# package's record of it (README: 337/384 completions, mean 5992 over 3 x 128
# deterministic episodes, per-episode std ~5,000): three standard errors of
# the difference between two samples of 384 and 4096 episodes
POLICY_NPZ = ROOT / "gym_puzzles_tpu_torch" / "policies" / "MultiRobotPuzzle-v0_r4.npz"
EVAL_EPISODES = 4096
EVAL_MAX_STEPS = 2000
COMPLETION_BAND = (0.82, 0.93)
RETURN_BAND = (5190.0, 6800.0)
ACTION_TOL = 1e-5
# phase 9: the JAX package's pixel recipe (docs/benchmarks/ppo_v0_cnn_r5_leg1.jsonl
# line 1; the rest as PPOConfig's defaults), seed 0
CNN_CONFIG = dict(env_id=ENV_ID, policy="cnn", n_envs=256, n_steps=32, batch_size=2048,
                  n_epochs=2, learning_rate=2.5e-4, ent_coef=0.005, target_kl=0.01,
                  normalize=True, env_backend="fused", velocity_iters=60, position_iters=20,
                  seed=0)
CNN_TIMED_UPDATES = 1  # after the resumed update 3
# renderer on the card against the CPU: spawns and mode per variant, downsample 4
RENDER_CASES = {"MultiRobotPuzzle-v0": (4096, "human_vision"),
                "MultiRobotPuzzle-v2": (1024, "agent_vision"),
                "MultiRobotPuzzle-v3": (1024, "human_vision")}
RENDER_EQUAL_SHARE = 0.999
CNN_EVAL_EPISODES = 256
CNN_EVAL_MAX_STEPS = 100
# the pixel policy's deterministic actions, card (cuDNN) against CPU (oneDNN),
# both with bfloat16 convolutions: about ten times the difference measured on
# an H100 (2.4e-6, the policy of the 3 recipe updates at seed 0)
CNN_ACTION_TOL = 3e-5
PIXEL_ITERS = ((60, 20), (VI, PI))  # training and eval solver iterations
# phase 10: the host surface
GYM_IDS = ("MultiRobotPuzzle-v0", "MultiRobotPuzzle-v2", "MultiRobotPuzzle-v3")
GYM_STEPS = 200
SMALL_BATCHES = (13, 1)  # kernel A's partial warp and its one-env launch
HOST_RENDER_ENVS = 64  # card states rasterized on the host per variant
ADAPTER_STEPS = IMAGE_STEPS = 20
VIDEO_STEPS = 300
# phase 11: the scripted demonstrators and BC at the JAX package's widths
# (docs/benchmarks/oracle_push.py; train/imitate.py's CLI defaults), rounds
# cut from 60 to 3
SCRIPTED_ENV = "MultiRobotPuzzleHeavy-v0"
SCRIPTED_OFFSET = 70.0
SCRIPTED_CHECK_EVERY = 200  # steps between host checks for "every lane finished"
BC_CONFIG = dict(env_id=SCRIPTED_ENV, n_envs=NUM_ENVS, n_steps=64, batch_size=8192,
                 n_epochs=4, gamma=0.999, seed=0, env_backend="fused")
BC_ROUNDS = 3
# the JAX package's records: docs/benchmarks/oracle_push_hv0_r4.jsonl line 2
# (the pusher at offset 70, 128 episodes; the pusher has changed since) and
# docs/BENCHMARKS.md:410-414 (the planner)
SCRIPTED_RECORDS = {"pusher": "8/128 completed, mean return -34,987, median completed "
                              "length 249 (r4 record; the pusher has changed since)",
                    "planner": "30-47/128 completed (docs/BENCHMARKS.md)"}
# phase 12: 2 trials x 1 update at the v0 recipe's width
SWEEP_TRIALS = 2
SWEEP_EVAL_EPISODES = 256
SWEEP_EVAL_MAX_STEPS = 200
# phase 13: distribution at the v0 recipe (TRAIN_CONFIG, TRAIN_OVERRIDES):
# (a) DistributedPPO on a one-rank NCCL group against PPO, same noise and
# orders; (b) two ranks sharing the card over gloo, 2048 envs each; (c) the
# scaling bench's n = 1 row at its defaults, and the CLI under torchrun
DIST_UPDATES = 3
DIST_GLOO_RANKS = 2
DIST_GLOO_UPDATES = 2
ALLREDUCE_REPS = 200


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def maxdiff(a, b) -> float:
    return float((a.double() - b.double()).abs().max())


def narrowphase_ops(table) -> list[int]:
    """SAT + clip operations of one narrow-phase visit, per pair."""
    ops = []
    for p in range(table.num_pairs):
        ca = int(table.fix_count[table.pair_fix_a[p]])
        cb = int(table.fix_count[table.pair_fix_b[p]])
        ops.append(28 + ca * (20 + 4 * cb) + cb * (20 + 4 * ca) + 5 * max(ca, cb) + 120)
    return ops


def sweep_ops(table, vel_rows, pos_rows, vel_iters, pos_iters) -> int:
    """Float32 operations of the velocity and position sweeps over the live
    rows: ``vel_rows[p]`` / ``pos_rows[p]`` envs visit pair ``p`` in a
    velocity / position sweep."""
    dyn = ~table.is_static
    ops = 0
    for p, (nv, np_) in enumerate(zip(vel_rows, pos_rows)):
        dd = bool(dyn[table.pair_body_a[p]] and dyn[table.pair_body_b[p]])
        ops += nv * vel_iters * OPS_VEL_PAIR[dd] + np_ * pos_iters * OPS_POS_PAIR[dd]
    return ops


def bound(nbytes, ops, live_rows) -> dict:
    """The larger of bytes at the HBM rate and operations at the float32
    rate, in ms, with what bounds it and its parts."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    return dict(ms=1e3 * max(t_bytes, t_ops), by="bytes" if t_bytes >= t_ops else "operations",
                bytes=nbytes, ops=ops, live_rows=live_rows,
                bytes_ms=1e3 * t_bytes, ops_ms=1e3 * t_ops)


def kernel_bound(table, bf, live, vel_iters, pos_iters) -> dict:
    """Least time the card could take for one fused tick of these envs: the
    bytes it must move at the HBM rate, against the float32 operations it
    must do at the float32 rate, counted from this run's inputs (``bf`` the
    body input planes, ``live`` [P, E] the pairs with manifold points and an
    active body).  A pair whose two bodies are dynamic and asleep keeps its
    stored manifold: only there are its 10 manifold planes read and the
    narrow phase not needed.  Constraint setup and the sweeps run over the
    live pairs, the position sweeps' per-body cos/sin only in envs with
    one."""
    B, P = table.num_bodies, table.num_pairs
    E = live.shape[-1]
    planes = bf.view(len(step_cuda.B_IN), B, E)
    static = torch.as_tensor(table.is_static, device=bf.device)[:, None]
    aw = ((planes[step_cuda.B_IN.index("awake")] > 0.5)
          | (planes[step_cuda.B_IN.index("wake")] > 0.5) | static)
    pair_body = lambda x: torch.as_tensor(x, dtype=torch.long, device=bf.device)
    # [P, E]: pairs whose new manifold the narrow phase decides
    upd = aw[pair_body(table.pair_body_a)] | aw[pair_body(table.pair_body_b)]
    # body planes 12 in, 8 out; per pair touch, 2 ids, 4 impulses in, 17 + 2 out
    words = E * ((12 + 8) * B + (7 + 19) * P) + 10 * int((~upd).sum())
    n_dyn = int((~table.is_static).sum())
    per_pair = live.sum(dim=-1).tolist()
    ops = (E * OPS_BODY * B
           + sum(n * c for n, c in zip(narrowphase_ops(table), upd.sum(dim=-1).tolist()))
           + OPS_SETUP_PAIR * sum(per_pair)
           + pos_iters * OPS_POS_SWEEP_BODY * n_dyn * int(live.any(dim=0).sum()))
    ops += sweep_ops(table, per_pair, per_pair, vel_iters, pos_iters)
    return bound(4 * words, ops, int(sum(per_pair)))


def solve_bound(table, vc, man, vel_iters, pos_iters) -> dict:
    """The same for one launch of the contact-solve kernel, counted from its
    inputs: per env the 14 B body words, per pair the ``solve`` and ``link``
    flags and 4 impulses in and out, per solved pair its two counts, and the
    row planes of the live rows only (22 words for a velocity row, 9 for a
    position row); the sweeps over those rows, the position sweeps' per-body
    cos/sin only in envs with a position row."""
    B, P = table.num_bodies, table.num_pairs
    E = vc.k11.shape[-1]
    vel = vc.solve & (vc.count > 0)
    pos = vc.solve & (man.count > 0)
    words = (E * (10 * P + 14 * B) + 2 * int(vc.solve.sum())
             + 22 * int(vel.sum()) + 9 * int(pos.sum()))
    n_dyn = int((~table.is_static).sum())
    ops = (E * OPS_SOLVE_BODY * B
           + pos_iters * OPS_POS_SWEEP_BODY * n_dyn * int(pos.any(dim=0).sum()))
    ops += sweep_ops(table, vel.sum(dim=-1).tolist(), pos.sum(dim=-1).tolist(), vel_iters,
                     pos_iters)
    return bound(4 * words, ops, int(vel.sum()))


def ticks(table, bodies, contacts, n, vi, pi, tick, control):
    """``n`` ticks with ``tick``; ``control(bodies)`` sets velocities and
    returns (bodies, force, torque, wake) before each."""
    info = None
    for _ in range(n):
        bodies, force, torque, wake = control(bodies)
        bodies, contacts, info = tick(table, bodies, contacts, force, torque, wake, DT, vi, pi)
    return bodies, contacts, info


def fused_tick(incremental):
    """The fused kernel's tick in one trig mode."""
    return lambda *args: step_cuda.step_fused(*args, incremental_trig=incremental)


def staged_tick(incremental):
    """The staged tick (``world.step_batched``) with the solve kernel in one
    trig mode."""
    def tick(table, bodies, contacts, force, torque, wake, dt, vi, pi):
        solve_args, carry = world.before_solve(table, bodies, contacts, force, torque, wake, dt)
        solved = solver_cuda.solve_contacts(table, *solve_args, dt, vi, pi,
                                            incremental_trig=incremental)
        return world.after_solve(table, solve_args, carry, solved, dt)
    return tick


def check_push_world(dev, tick=None, name="push world") -> dict:
    """T-block + two octagon agents pushing it (the JAX package's fused
    kernel numerics world), 10 ticks at 8/4, ``tick`` (default: the fused
    kernel, exact trig) against plain."""
    tick = fused_tick(False) if tick is None else tick
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

    bk, ck, _ = ticks(table, bodies, contacts, 10, 8, 4, tick, control)
    bp, cp, _ = ticks(table, bodies, contacts, 10, 8, 4, world.step, control)
    if not bool(cp.touching.any()):
        raise AssertionError(f"{name}: no contact formed")
    d = dict(pos=maxdiff(bk.pos, bp.pos), angle=maxdiff(bk.angle, bp.angle),
             impulse=maxdiff(ck.normal_impulse, cp.normal_impulse))
    limits = dict(pos=1e-5, angle=1e-6, impulse=1e-4)
    report(f"{name} 10 ticks 8/4", d, limits)
    if not (torch.equal(ck.man.ids, cp.man.ids) and torch.equal(bk.awake, bp.awake)):
        raise AssertionError(f"{name}: contact ids or awake flags differ")
    return d


def spawn_tick(dev, E, seed, env_id=ENV_ID):
    """(table, contacts, bodies, force, torque, wake) of E fresh spawns
    after random controls: one tick's inputs."""
    logic = _logic(env_id)
    gen = torch.Generator(device=dev).manual_seed(seed)
    state, _obs = logic.reset_fast(gen, E, logic.default_params())
    act = torch.rand((logic.cfg.act_dim, E), generator=gen, device=dev) * 2 - 1
    return (logic.layout.table, state.contacts) + logic._control(state, act)


def spawn_diffs(name, got, want, in_contact) -> dict:
    """Differences over a batch of spawns, held to ``SPAWN_LIMITS``; ``got``
    and ``want`` are (pos, angle, normal impulse).  ``max`` is the largest
    position difference over all envs, so it reads the envs in contact."""
    d = (got[0] - want[0]).abs().amax(dim=(0, 1))
    free = ~in_contact
    out = dict(no_contact_max=float(d[free].max()) if bool(free.any()) else 0.0,
               median=float(d.median()), max=float(d.max()),
               angle=maxdiff(got[1], want[1]), impulse=maxdiff(got[2], want[2]),
               impulse_scale=float(want[2].abs().max()))
    report(f"{name} ({int(in_contact.sum())} envs in contact)", out, SPAWN_LIMITS)
    return out


def check_spawns(dev, E, seed, env_id=ENV_ID, vel_iters=VI,
                 pos_iters=PI) -> tuple[dict, float]:
    """One tick of E random spawns (180/60 unless given), fused kernel
    against plain.  Returns (differences, plain ms)."""
    table, contacts, bodies, force, torque, wake = spawn_tick(dev, E, seed, env_id)
    args = (table, bodies, contacts, force, torque, wake, DT, vel_iters, pos_iters)
    bk, ck, _ = step_cuda.step_fused(*args, incremental_trig=False)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    bp, cp, _ = world.step(*args)
    torch.cuda.synchronize()
    plain_ms = 1e3 * (time.perf_counter() - t0)
    name = f"fused, {env_id} spawns E={E} 1 tick {vel_iters}/{pos_iters}"
    out = spawn_diffs(name, (bk.pos, bk.angle, ck.normal_impulse),
                      (bp.pos, bp.angle, cp.normal_impulse), cp.touching.any(dim=0))
    if not torch.equal(bk.awake, bp.awake):
        raise AssertionError(f"{name}: awake flags differ")
    if not all(bool(torch.isfinite(x).all()) for x in (bk.pos, bk.vel, ck.normal_impulse)):
        raise AssertionError(f"{name}: kernel output not finite")
    return out, plain_ms


def spawn_solve_args(dev, E, seed, env_id, vi=VI, pi=PI):
    """(table, solve args) of E spawns one tick in: the first tick goes
    through the fused kernel, so the second tick's constraints carry
    impulses to warm start from."""
    table, contacts, bodies, force, torque, wake = spawn_tick(dev, E, seed, env_id)
    bodies, contacts, _ = step_cuda.step_fused(table, bodies, contacts, force, torque, wake,
                                               DT, vi, pi)
    solve_args, _carry = world.before_solve(table, bodies, contacts, force, torque, wake, DT)
    return table, solve_args


def check_solve_kernel(dev, env_id, E, seed, vi=VI, pi=PI) -> tuple[dict, float]:
    """The contact-solve kernel against its plain version on the constraints
    of E spawns after the PyTorch prologue: exact trig within the spawn
    limits, incremental against exact.  Returns (differences, plain ms)."""
    table, solve_args = spawn_solve_args(dev, E, seed, env_id, vi, pi)
    vc = solve_args[0]
    exact = solver_cuda.solve_contacts(table, *solve_args, DT, vi, pi, incremental_trig=False)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plain = solver_cuda.solve_contacts_plain(table, *solve_args, DT, vi, pi)
    torch.cuda.synchronize()
    plain_ms = 1e3 * (time.perf_counter() - t0)
    in_contact = (vc.solve & (vc.count > 0)).any(dim=0)
    if not bool(in_contact.any()) or not bool((vc.normal_impulse != 0).any()):
        raise AssertionError(f"solve, {env_id}: no contact or nothing to warm start")
    name = f"solve, {env_id} spawns E={E} {vi}/{pi}"
    out = spawn_diffs(name, exact[2:5], plain[2:5], in_contact)
    flags = (exact[6] != plain[6]).any(dim=0)
    allowed = int(SOLVED_FLAGS_SHARE * int(in_contact.sum()))
    print(f"  {name}: position_solved differs in {int(flags.sum())} envs (limit {allowed})",
          flush=True)
    if bool(flags[~in_contact].any()) or int(flags.sum()) > allowed:
        raise AssertionError(f"{name}: position_solved differs in an env without contact, "
                             f"or in more than {allowed} envs")
    if not all(bool(torch.isfinite(x).all()) for x in exact[:6]):
        raise AssertionError(f"{name}: kernel output not finite")
    incr = solver_cuda.solve_contacts(table, *solve_args, DT, vi, pi, incremental_trig=True)
    d = dict(pos=maxdiff(incr[2], exact[2]), angle=maxdiff(incr[3], exact[3]),
             vel=maxdiff(incr[0], exact[0]), impulse=maxdiff(incr[4], exact[4]))
    report(f"{name}, incremental vs exact trig", d, SPAWN_TRIG_LIMITS)
    return out, plain_ms


def contact_scene(env_id, E, dev):
    """An injected contact drive: (origin [B, 2, E], angles [B, E], goal
    [3, E], action [act_dim, E]) with agents pressed face-on against the
    block and pushing it."""
    if env_id == "MultiRobotPuzzle-v0":
        origin = [[0.0, 8.0], [21.33, 8.0], [10.67, 0.0], [10.67, 16.0],
                  [10.0, 8.0], [7.745, 8.5], [10.0, 6.245]]
        angles = [0.0] * 7
        goal, act = [320.0, 262.5, 0.0], [1.0, 0.0, 0.0, 0.0, 1.0, 0.0]
    elif env_id == "MultiRobotPuzzle-v2":
        # block centred; agent 0 heads +x into the wide box's left face,
        # agent 1 heads +y into the stem's bottom; 2 mm overlap each, both at
        # full throttle with a turn (the torque that spins the wheel bodies)
        w, h = 1440 / 560.0, 810 / 560.0
        origin = [[0.0, h / 2], [w, h / 2], [w / 2, 0.0], [w / 2, h],
                  [w / 2, h / 2], [w / 2 - 0.3 - 0.093, h / 2 + 0.1],
                  [w / 2, h / 2 - 0.2 - 0.093]]
        angles = [0.0] * 5 + [1.5 * np.pi, 0.0]
        goal, act = [0.8, 0.25, 0.0], [0.5, 1.0, -0.5, 1.0]
    else:
        raise ValueError(env_id)
    t = lambda x: torch.tensor(x, dtype=torch.float32, device=dev)
    origin = t(origin)
    B = origin.shape[0]
    return (origin[..., None].expand(B, 2, E).contiguous(), t(angles)[:, None].expand(B, E),
            t(goal)[:, None].expand(3, E), t(act)[:, None].expand(len(act), E))


def check_trig(dev, env_id=ENV_ID, make_tick=fused_tick, name="fused") -> dict:
    """Exact against incremental position-pass trig: a 12-tick contact
    drive at 180/60 through ``make_tick(incremental)``, kernel only."""
    logic = _logic(env_id)
    origin, angles, goal, act = contact_scene(env_id, 512, dev)
    state = logic.inject(origin, angles, goal)
    out = {}
    for incremental in (False, True):
        tick = make_tick(incremental)
        s = state
        for _ in range(12):
            bodies, force, torque, wake = logic._control(s, act)
            bodies, contacts, _ = tick(logic.layout.table, bodies, s.contacts, force, torque,
                                       wake, DT, VI, PI)
            s = s.replace(bodies=bodies, contacts=contacts)
        out[incremental] = s
    if not bool(out[False].contacts.touching.any()):
        raise AssertionError(f"trig drive {env_id}: no contact formed")
    e, i = out[False], out[True]
    d = dict(pos=maxdiff(e.bodies.pos, i.bodies.pos), angle=maxdiff(e.bodies.angle, i.bodies.angle),
             impulse=maxdiff(e.contacts.normal_impulse, i.contacts.normal_impulse))
    limits = dict(pos=1e-6, angle=1e-6, impulse=1e-6) if env_id == ENV_ID else TRIG_LIMITS
    report(f"{name}: trig exact vs incremental, 12-tick {env_id} contact drive", d, limits)
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


def run_main_path(dev, card_line, env_id=ENV_ID, backend="fused", steps=MAIN_STEPS) -> dict:
    """``steps`` env steps of random actions through ``make`` at 4096 envs
    and 180/60, with the launch counts set to 0 just before and read just
    after: the path's kernel must have run steps x frameskip times and the
    other kernel not at all.  Returns the launches, the rate, and the env and
    its state at the end."""
    env = make(env_id, num_envs=NUM_ENVS, backend=backend)
    if env.device.type != "cuda":
        raise AssertionError(f"make() defaulted to {env.device}")
    state, obs = env.reset(seed=0)
    gen = torch.Generator(device=dev).manual_seed(1)
    acts = torch.rand((steps + 10, NUM_ENVS, env.cfg.act_dim), generator=gen,
                      device=dev) * 2 - 1
    for k in range(10):  # warm-up
        state, obs, reward, done, info = env.step(state, acts[steps + k])
    torch.cuda.synchronize()

    step_cuda.reset_launch_count()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    finite = torch.ones((), dtype=torch.bool, device=dev)
    for k in range(steps):
        state, obs, reward, done, info = env.step(state, acts[k])
        finite &= torch.isfinite(obs).all() & torch.isfinite(reward).all()
    stop.record()
    stop.synchronize()
    launches = launch_counts()
    elapsed_s = start.elapsed_time(stop) / 1e3

    name = f"{env_id} backend={backend}"
    mine, other = (("step_fused", "solve_contacts") if backend == "fused"
                   else ("solve_contacts", "step_fused"))
    if launches[mine] != steps * env.cfg.frameskip or launches[other] != 0:
        raise AssertionError(f"{name}: launches {launches} in {steps} steps "
                             f"(frameskip {env.cfg.frameskip})")
    if not bool(finite):
        raise AssertionError(f"{name}: non-finite obs or rewards")
    if obs.shape != (NUM_ENVS, env.cfg.obs_dim) or reward.shape != (NUM_ENVS,):
        raise AssertionError(f"{name}: obs {tuple(obs.shape)} reward {tuple(reward.shape)}")
    for field in ("pos", "vel", "angle", "omega"):
        if not bool(torch.isfinite(getattr(state.bodies, field)).all()):
            raise AssertionError(f"{name}: state.bodies.{field} not finite")
    rate = steps * NUM_ENVS / elapsed_s
    print(f"  {name}: {steps} steps x {NUM_ENVS} envs in {elapsed_s:.3f} s: "
          f"{rate:,.0f} env-steps/s; launches {launches}  [{card_line}]", flush=True)
    return dict(launches=launches[mine], env_steps_per_s=rate, env=env, state=state)


def live_line(live, kernel) -> str:
    """The mean and warp-max live pairs per env of ``live`` [P, E], at the
    envs per warp of ``kernel``'s build."""
    st = cb.live_pair_stats(live, kernel.envs_per_warp())
    return (f"live pairs per env mean {st['mean']:.3f}, warp max {st['warp_max']:.3f} "
            f"({st['envs_per_warp']} envs per warp), env max {st['max']:.0f}")


def check_end_of_drive(dev, env, state, card_line) -> dict:
    """Kernel A against ``world.step`` on the state a 200-step v0 fused drive
    ends with: one tick at 180/60 as the ticks after a step's first run it
    (no force, no control wake), so resting contacts and sleeping bodies
    stay as the drive left them; every env held to ``SPAWN_LIMITS``, awake
    flags equal.  Prints kernel A's time on that tick."""
    table = env.logic.layout.table
    bodies, contacts = state.bodies, state.contacts
    zf = torch.zeros_like(bodies.vel)
    zt = torch.zeros_like(bodies.omega)
    no_wake = torch.zeros_like(bodies.awake)
    args = (table, bodies, contacts, zf, zt, no_wake, DT, VI, PI)
    bk, ck, _ = step_cuda.step_fused(*args, incremental_trig=False)
    bp, cp, _ = world.step(*args)
    vc, man = world.before_solve(*args[:7])[0][:2]
    dyn = torch.as_tensor(~table.is_static, device=dev)[:, None]
    n_asleep = int((dyn & ~bodies.awake).sum())
    n_carried = int(((man.count > 0) & ~vc.solve).any(dim=0).sum())
    name = (f"fused, {env.cfg.env_id} state ending the {MAIN_STEPS}-step fused drive, "
            f"1 tick {VI}/{PI} ({n_asleep} dynamic bodies asleep; {n_carried} envs hold "
            f"unsolved manifolds)")
    out = spawn_diffs(name, (bk.pos, bk.angle, ck.normal_impulse),
                      (bp.pos, bp.angle, cp.normal_impulse), cp.touching.any(dim=0))
    if not torch.equal(bk.awake, bp.awake):
        raise AssertionError(f"{name}: awake flags differ")
    if not all(bool(torch.isfinite(x).all()) for x in (bk.pos, bk.vel, ck.normal_impulse)):
        raise AssertionError(f"{name}: kernel output not finite")
    planes = step_cuda.pack(bodies, contacts, zf, zt, no_wake)
    ms = cuda_ms(lambda: step_cuda.launch(table, *planes, DT, VI, PI), 10)
    live = vc.solve & (vc.count > 0)
    print(f"  step_fused on that state: {ms:.3f} ms per launch; "
          f"{live_line(live, step_cuda.KERNEL)}; {NUM_ENVS} envs {VI}/{PI}  [{card_line}]",
          flush=True)
    return dict(out, ms=ms)


def time_kernels(dev, env_id, card_line) -> dict:
    """Both kernels' time per launch on 4096 spawns of one variant at 180/60
    (the solve kernel on the second tick's constraints), with their bounds."""
    table, contacts, bodies, force, torque, wake = spawn_tick(dev, NUM_ENVS, 0, env_id)
    bf, pf, pi = step_cuda.pack(bodies, contacts, force, torque, wake)
    fused = lambda: step_cuda.launch(table, bf, pf, pi, DT, VI, PI)
    fused()
    fused_ms = cuda_ms(fused, 10)
    vc = world.before_solve(table, bodies, contacts, force, torque, wake, DT)[0][0]
    live = vc.solve & (vc.count > 0)  # the rows the kernel's sweeps visit
    fused_bound = kernel_bound(table, bf, live, VI, PI)
    fused_live = live_line(live, step_cuda.KERNEL)

    table, solve_args = spawn_solve_args(dev, NUM_ENVS, 0, env_id)
    planes = solver_cuda.pack(*solve_args)
    solve = lambda: solver_cuda.launch(table, *planes, DT, VI, PI)
    solve()
    solve_ms = cuda_ms(solve, 10)
    vc, man = solve_args[:2]
    sbound = solve_bound(table, vc, man, VI, PI)
    solve_live = (f"velocity {live_line(vc.solve & (vc.count > 0), solver_cuda.KERNEL)}; "
                  f"position {live_line(vc.solve & (man.count > 0), solver_cuda.KERNEL)}")
    for name, ms, b, live in (("step_fused", fused_ms, fused_bound, fused_live),
                              ("solve_contacts", solve_ms, sbound, solve_live)):
        print(f"  {env_id} (B={table.num_bodies} P={table.num_pairs}, size class "
              f"{cb.size_class(table)}) {name}: {ms:.3f} ms per launch; {live}; "
              f"bound {b['ms']:.4f} ms ({b['by']}): {b['bytes']} bytes = "
              f"{b['bytes_ms']:.4f} ms, {b['ops']} f32 ops = {b['ops_ms']:.4f} ms, "
              f"{b['live_rows']} live rows; {NUM_ENVS} envs {VI}/{PI}  "
              f"[{card_line}]", flush=True)
    return dict(fused_ms=fused_ms, fused_bound=fused_bound, solve_ms=solve_ms,
                solve_bound=sbound)


def on_card(obj, what):
    """Raise unless ``obj`` (a learner) defaulted to the card."""
    if obj.device.type != "cuda":
        raise AssertionError(f"{what} defaulted to {obj.device}")


def tree_diff(a, b, path="") -> list[str]:
    """The paths of the leaves where two checkpoint trees differ (NaN equal
    to NaN)."""
    if isinstance(a, dict):
        if a.keys() != b.keys():
            return [f"{path}<keys>"]
        return [p for k in a for p in tree_diff(a[k], b[k], f"{path}.{k}")]
    if isinstance(a, torch.Tensor):
        same = a.dtype == b.dtype and a.shape == b.shape and (
            torch.equal(a, b) or (a.is_floating_point() and torch.equal(a.isnan(), b.isnan())
                                  and torch.equal(a.nan_to_num(), b.nan_to_num())))
        return [] if same else [path]
    return [] if a == b else [path]


def train_and_resume(algo_fn, card_line, timed_updates, what) -> tuple:
    """``TRAIN_UPDATES`` updates of the learner ``algo_fn()`` builds, with the
    launch counts set to 0 just before and read just after; a save after
    update 2 restored into a fresh learner must reproduce update 3 bit for
    bit; then ``timed_updates`` more updates, each split by part (the
    resumed one is timed too).  Returns (the fresh learner, its state, the
    launches of each kernel in the counted updates)."""
    algo = algo_fn()
    on_card(algo, what)
    cfg = algo.cfg
    per_update = cfg.n_steps * cfg.n_envs
    ts = algo.init_state()
    params0 = {k: v.clone() for k, v in ts.params.items()}
    torch.cuda.synchronize()
    cb.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=cb.BUILD_DIR) as tmp:
        step_cuda.reset_launch_count()
        walls = []
        for u in range(TRAIN_UPDATES):
            t0 = time.perf_counter()
            ts, metrics = algo.train_step(ts)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            if u == TRAIN_UPDATES - 2:
                saved_at = ckpt.step_count(ts.timesteps)
                ckpt.save(tmp, ts, saved_at)  # between updates: not timed
            m = {k: (v.item() if isinstance(v, torch.Tensor) else v) for k, v in metrics.items()}
            print(f"  update {u + 1}: {walls[-1]:.3f} s wall, {per_update / walls[-1]:,.0f} "
                  f"env-steps/s; " + ", ".join(f"{k} {v:.6g}" if isinstance(v, float)
                                              else f"{k} {v}" for k, v in m.items())
                  + f"  [{card_line}]", flush=True)
            bad = [k for k, v in m.items() if k != "ep_rew_mean" and isinstance(v, float)
                   and not np.isfinite(v)]
            if bad:
                raise AssertionError(f"{what}: non-finite metrics {bad}")
        launches = launch_counts()
        want = TRAIN_UPDATES * cfg.n_steps * algo.env.cfg.frameskip
        if launches != {"step_fused": want, "solve_contacts": 0}:
            raise AssertionError(f"{what}: launches {launches}, expected {want} of step_fused "
                                 "and none of solve_contacts")
        if ts.timesteps.dtype != torch.int64 or int(ts.timesteps) != TRAIN_UPDATES * per_update:
            raise AssertionError(f"{what}: timesteps {ts.timesteps!r}")
        moved = sum(int((ts.params[k] != params0[k]).sum()) for k in params0)
        if not moved:
            raise AssertionError(f"{what}: params did not move")
        rate = TRAIN_UPDATES * per_update / sum(walls)
        print(f"  {TRAIN_UPDATES} updates, {TRAIN_UPDATES * per_update} env steps in "
              f"{sum(walls):.3f} s: {rate:,.0f} env-steps/s including the learner "
              f"({(TRAIN_UPDATES - 1) * per_update / sum(walls[1:]):,.0f} without update 1); "
              f"launches {launches}; {moved} of "
              f"{sum(v.numel() for v in params0.values())} params moved  [{card_line}]",
              flush=True)

        fresh = algo_fn()
        rs = ckpt.restore(tmp, fresh.init_state(), saved_at)
    timer = PhaseTimer(fresh.device)
    rs, rmetrics = fresh.train_step(rs, timer=timer)
    diff = (tree_diff(ckpt.to_tree(rs), ckpt.to_tree(ts), "state")
            + tree_diff(ckpt.to_tree(rmetrics), ckpt.to_tree(metrics), "metrics"))
    if diff:
        raise AssertionError(f"{what}: the resumed update {TRAIN_UPDATES} differs in {diff}")
    print(f"  resume: saved after update {TRAIN_UPDATES - 1} (step {saved_at}), restored into a "
          f"fresh learner: update {TRAIN_UPDATES} equal bit for bit (params, Adam state, "
          f"normalizer, env state, generators, metrics)  [{card_line}]", flush=True)
    splits = [timer.seconds]
    for _ in range(timed_updates):
        timer = PhaseTimer(fresh.device)
        rs, _ = fresh.train_step(rs, timer=timer)
        splits.append(timer.seconds)
    for k, sp in enumerate(splits):
        total = sum(sp.values())
        print(f"  timed update {TRAIN_UPDATES + k}: {total:.3f} s = "
              + ", ".join(f"{name} {sec:.3f} s ({sec / total:.1%})" for name, sec in sp.items())
              + f"  [{card_line}]", flush=True)
    return fresh, rs, launches


def run_training(card_line) -> int:
    """Phase 7: PPO on v0 at 4096 envs, fused, the MLP recipe, through
    :func:`train_and_resume`.  Returns the fused kernel's launches in the
    counted updates."""
    cfg = PPOConfig.from_reference_json(json.loads(TRAIN_CONFIG.read_text()), **TRAIN_OVERRIDES)
    if torch.get_float32_matmul_precision() != "highest" or torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("float32 matmuls must keep full precision (TF32 off)")
    print(f"  {cfg.env_id} n_envs {cfg.n_envs} n_steps {cfg.n_steps} batch {cfg.batch_size} "
          f"epochs {cfg.n_epochs} lr {cfg.learning_rate} target_kl {cfg.target_kl} "
          f"net {cfg.net_arch} backend {cfg.env_backend} "
          f"{cfg.velocity_iters or VI}/{cfg.position_iters or PI}  [{card_line}]", flush=True)
    _algo, _ts, launches = train_and_resume(lambda: PPO(cfg), card_line, TIMED_UPDATES, "train")
    return launches["step_fused"]


def run_eval(card_line):
    """Phase 8: the committed v0 policy's deterministic actions on the card
    against the CPU, then ``EVAL_EPISODES`` deterministic episodes held to the
    bands around the JAX package's record."""
    cfg = PPOConfig(env_id=ENV_ID, n_envs=1, n_steps=2, batch_size=2, n_epochs=1)
    algo, algo_cpu = PPO(cfg), PPO(cfg, device="cpu")
    on_card(algo, "the eval learner")
    st = ckpt.restore_policy(POLICY_NPZ, algo.init_state())
    st_cpu = ckpt.restore_policy(POLICY_NPZ, algo_cpu.init_state())
    # the obs of 4096 reference resets (one random step from a spawn)
    _state, obs = make(ENV_ID, num_envs=EVAL_EPISODES, reset_mode="reference",
                       device=algo.device).reset(seed=0)
    with torch.no_grad():
        got = evaluate.policy_action(algo, st.params, st.normalizer, obs, True)
        want = evaluate.policy_action(algo_cpu, st_cpu.params, st_cpu.normalizer, obs.cpu(), True)
        raw = [a.apply(s.params, nrm.normalize_obs(s.normalizer, o, update=False)[1])[0]
               for a, s, o in ((algo, st, obs), (algo_cpu, st_cpu, obs.cpu()))]
    err = maxdiff(got.cpu(), want)
    raw_err = float(((raw[0].cpu() - raw[1]).abs() / raw[1].abs().clamp_min(1.0)).max())
    print(f"  deterministic actions of {POLICY_NPZ.name} on the obs of {EVAL_EPISODES} resets, "
          f"card against CPU: max abs diff {err:.3e} (limit {ACTION_TOL:g}); unclipped means "
          f"{raw_err:.3e} relative to max(1, |mean|) (limit {ACTION_TOL:g}); "
          f"{float((want.abs() >= 1).float().mean()):.3f} of the actions at the clip  "
          f"[{card_line}]", flush=True)
    if not (err <= ACTION_TOL and raw_err <= ACTION_TOL):
        raise AssertionError("eval: the card's actions differ from the CPU's")

    torch.cuda.synchronize()
    step_cuda.reset_launch_count()
    t0 = time.perf_counter()
    ret_mean, ret_std, returns, lengths, statuses = evaluate.evaluate_policy_batched(
        algo, st, n_episodes=EVAL_EPISODES, deterministic=True, seed=0,
        max_steps=EVAL_MAX_STEPS)
    wall = time.perf_counter() - t0
    lengths = np.asarray(lengths)
    completions = int((np.asarray(statuses) == 3).sum())  # done_status 3: success
    share = completions / EVAL_EPISODES
    print(f"  {EVAL_EPISODES} deterministic episodes (max {EVAL_MAX_STEPS} steps, fused, "
          f"{VI}/{PI}): mean return {ret_mean:.2f}, std {ret_std:.2f}, completions "
          f"(done_status 3) {completions}/{EVAL_EPISODES} = {share:.4f} (band "
          f"{COMPLETION_BAND}; shorter than {EVAL_MAX_STEPS} steps: "
          f"{int((lengths < EVAL_MAX_STEPS).sum())}), mean return "
          f"band {RETURN_BAND}; median length {float(np.median(lengths)):.0f}; "
          f"{wall:.1f} s wall, {step_cuda.launch_count('step_fused')} launches of step_fused  "
          f"[{card_line}]", flush=True)
    if not (np.isfinite(returns).all() and lengths.min() >= 1):
        raise AssertionError("eval: non-finite returns or empty episodes")
    if not (COMPLETION_BAND[0] <= share <= COMPLETION_BAND[1]
            and RETURN_BAND[0] <= ret_mean <= RETURN_BAND[1]):
        raise AssertionError("eval: the committed policy left its bands")


def tree_map(fn, x):
    """``fn`` on every tensor of a dataclass tree (other leaves kept)."""
    if dataclasses.is_dataclass(x):
        return type(x)(**{f.name: tree_map(fn, getattr(x, f.name))
                          for f in dataclasses.fields(x)})
    if isinstance(x, dict):
        return {k: tree_map(fn, v) for k, v in x.items()}
    return fn(x) if isinstance(x, torch.Tensor) else x


def check_renderer(dev, card_line) -> float:
    """The renderer on the card against the same renderer on the CPU, on
    the same spawns (``RENDER_CASES``, downsample 4): the share of equal
    pixels over all frames must reach ``RENDER_EQUAL_SHARE``.  Prints each
    frame batch's render time on the card, and the v0 time at the pixel
    path's 256 envs.  Returns the v0 256-env time in ms."""
    ms_256 = None
    for env_id, (E, mode) in RENDER_CASES.items():
        logic = _logic(env_id)
        gen = torch.Generator(device=dev).manual_seed(3)
        state, _ = logic.reset_fast(gen, E, logic.default_params())
        render = make_device_renderer(logic, downsample=4, mode=mode)
        got = render(state)
        t0 = time.perf_counter()
        want = render(tree_map(lambda x: x.cpu(), state))
        cpu_s = time.perf_counter() - t0
        equal = (got.cpu() == want).all(dim=-1).flatten(1).to(torch.float64)
        share, worst = float(equal.mean()), float(equal.mean(dim=1).min())
        ms = cuda_ms(lambda: render(state), 5)
        line = (f"  renderer {env_id} {mode}, {E} spawns, frames {tuple(got.shape[1:])}: card "
                f"against CPU {share:.6f} of pixels equal (limit {RENDER_EQUAL_SHARE}), worst "
                f"frame {worst:.6f}; {ms:.3f} ms per batch on the card, CPU {cpu_s:.1f} s")
        if env_id == ENV_ID:
            part = tree_map(lambda x: x[..., :CNN_CONFIG["n_envs"]].contiguous(), state)
            ms_256 = cuda_ms(lambda: render(part), 20)
            line += f"; {ms_256:.3f} ms per batch of {CNN_CONFIG['n_envs']}"
        print(line + f"  [{card_line}]", flush=True)
        if not (share >= RENDER_EQUAL_SHARE and got.dtype == torch.uint8
                and got.device.type == "cuda"):
            raise AssertionError(f"renderer {env_id}: the card's frames differ from the CPU's")
    return ms_256


def run_pixel_training(card_line) -> tuple:
    """Phase 9's CNN PPO at the pixel recipe through :func:`train_and_resume`,
    with cuDNN held to deterministic algorithms (its convolution backward
    may otherwise pick non-deterministic ones, and the resumed update must
    be bitwise).  Returns (learner, state, launches)."""
    cfg = PPOConfig(**CNN_CONFIG)
    flags = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        print(f"  {cfg.env_id} policy {cfg.policy} n_envs {cfg.n_envs} n_steps {cfg.n_steps} "
              f"batch {cfg.batch_size} epochs {cfg.n_epochs} lr {cfg.learning_rate} ent "
              f"{cfg.ent_coef} target_kl {cfg.target_kl} backend {cfg.env_backend} "
              f"{cfg.velocity_iters}/{cfg.position_iters}; cudnn.deterministic True, "
              f"cudnn.benchmark False  [{card_line}]", flush=True)
        algo, ts, launches = train_and_resume(lambda: PPO(cfg), card_line, CNN_TIMED_UPDATES,
                                              "CNN PPO")
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = flags
    print(f"  obs {tuple(ts.last_obs.shape)} {ts.last_obs.dtype}; "
          f"{sum(v.numel() for v in ts.params.values())} params; timed parts: env = physics "
          f"(fused tick kernel, {algo.env.cfg.frameskip} launches per step) and reward "
          f"bookkeeping, render = frames and stacks", flush=True)
    return algo, ts, launches


def run_pixel_eval(algo, ts, card_line) -> dict:
    """Phase 9's eval of the policy the CNN updates produced: deterministic
    actions on the obs of ``CNN_EVAL_EPISODES`` reference resets on the card
    against the CPU, then as many deterministic episodes of at most
    ``CNN_EVAL_MAX_STEPS`` steps at 180/60 through ``evaluate_policy_batched``
    with the training run's image pipeline, launches counted."""
    image_cfg = evaluate._image_pipeline(algo)
    env = evaluate.make_eval_env(ENV_ID, CNN_EVAL_EPISODES, algo.device, image_cfg=image_cfg)
    _ist, obs = env.reset(seed=0)
    cpu = lambda x: x.cpu()  # noqa: E731
    with torch.no_grad():
        got = evaluate.policy_action(algo, ts.params, ts.normalizer, obs, True)
        want = evaluate.policy_action(algo, tree_map(cpu, ts.params),
                                      tree_map(cpu, ts.normalizer), obs.cpu(), True)
        raw = [algo.apply(p, o)[0] for p, o in ((ts.params, obs),
                                                  (tree_map(cpu, ts.params), obs.cpu()))]
    err = maxdiff(got.cpu(), want)
    raw_err = maxdiff(raw[0].cpu(), raw[1])
    print(f"  CNN deterministic actions on the obs of {CNN_EVAL_EPISODES} reference resets "
          f"{tuple(obs.shape)}, card against CPU: max abs diff {err:.3e}, unclipped means "
          f"{raw_err:.3e} (limit {CNN_ACTION_TOL:g}, about ten times the measured difference; "
          f"bf16 convolutions, cuDNN against the CPU's); mean |action| "
          f"{float(want.abs().mean()):.3f}  [{card_line}]", flush=True)
    if not (err <= CNN_ACTION_TOL and raw_err <= CNN_ACTION_TOL):
        raise AssertionError("pixel eval: the card's actions differ from the CPU's")

    torch.cuda.synchronize()
    step_cuda.reset_launch_count()
    t0 = time.perf_counter()
    ret_mean, ret_std, returns, lengths, _statuses = evaluate.evaluate_policy_batched(
        algo, ts, n_episodes=CNN_EVAL_EPISODES, deterministic=True, seed=0,
        max_steps=CNN_EVAL_MAX_STEPS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts()
    # every chunk runs to its end: max_steps steps, plus the reference
    # reset's random step
    steps = CNN_EVAL_MAX_STEPS + 1
    lengths = np.asarray(lengths)
    print(f"  {CNN_EVAL_EPISODES} deterministic episodes (max {CNN_EVAL_MAX_STEPS} steps, "
          f"{image_cfg}, fused, {VI}/{PI}): mean return {ret_mean:.2f}, std {ret_std:.2f}, "
          f"{int((lengths < CNN_EVAL_MAX_STEPS).sum())} ended early; {wall:.2f} s wall, "
          f"{1e3 * wall / steps:.2f} ms per env step ({steps} steps with the reset's); "
          f"launches {launches}  [{card_line}]", flush=True)
    want_launches = {"step_fused": algo.env.cfg.frameskip * steps, "solve_contacts": 0}
    if launches != want_launches:
        raise AssertionError(f"pixel eval: launches {launches}, expected {want_launches}")
    if not (np.isfinite(returns).all() and lengths.min() >= 1):
        raise AssertionError("pixel eval: non-finite returns or empty episodes")
    return dict(err=err, ms_per_step=1e3 * wall / steps)


def time_pixel_kernel(dev, card_line) -> dict:
    """Kernel A at the pixel path's shape (256 v0 spawns) at the training
    and eval solver iterations: held against ``world.step`` on the same
    inputs (``SPAWN_LIMITS``, exact trig) and its incremental trig, which
    the path runs, against exact (``SPAWN_TRIG_LIMITS``' pos and angle); then
    its time per launch beside its bound.  At 8 envs per warp the launch
    fills one one-warp block per 8 envs."""
    E = CNN_CONFIG["n_envs"]
    table, contacts, bodies, force, torque, wake = spawn_tick(dev, E, 0)
    for vi, pi_iters in PIXEL_ITERS:
        check_spawns(dev, E, 0, vel_iters=vi, pos_iters=pi_iters)
        args = (table, bodies, contacts, force, torque, wake, DT, vi, pi_iters)
        bi = step_cuda.step_fused(*args)[0]
        be = step_cuda.step_fused(*args, incremental_trig=False)[0]
        report(f"fused, {ENV_ID} spawns E={E} 1 tick {vi}/{pi_iters}, incremental vs exact "
               f"trig", dict(pos=maxdiff(bi.pos, be.pos), angle=maxdiff(bi.angle, be.angle)),
               {k: SPAWN_TRIG_LIMITS[k] for k in ("pos", "angle")})
    bf, pf, pi = step_cuda.pack(bodies, contacts, force, torque, wake)
    live = world.before_solve(table, bodies, contacts, force, torque, wake, DT)[0][0]
    live = live.solve & (live.count > 0)
    per_warp = step_cuda.KERNEL.envs_per_warp()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    out = {}
    for vi, pi_iters in PIXEL_ITERS:
        fn = lambda: step_cuda.launch(table, bf, pf, pi, DT, vi, pi_iters)  # noqa: E731
        fn()
        ms = cuda_ms(fn, 20)
        b = kernel_bound(table, bf, live, vi, pi_iters)
        print(f"  step_fused at the pixel path's shape, {E} v0 spawns {vi}/{pi_iters}: "
              f"{ms:.3f} ms per launch; {live_line(live, step_cuda.KERNEL)}; bound "
              f"{b['ms']:.6f} ms ({b['by']}): {b['bytes']} bytes = {b['bytes_ms']:.6f} ms, "
              f"{b['ops']} f32 ops = {b['ops_ms']:.6f} ms; {-(-E // per_warp)} one-warp blocks "
              f"on {sms} SMs  [{card_line}]", flush=True)
        out[(vi, pi_iters)] = dict(ms=ms, bound=b)
    return out


def launch_counts() -> dict:
    """Each kernel's launches since the counts were last set to 0."""
    return {name: step_cuda.launch_count(name) for name in ("step_fused", "solve_contacts")}


def expect_launches(what, want_fused):
    """Raise unless kernel A ran ``want_fused`` times since the counts were
    set to 0, and the solve kernel not at all."""
    got = launch_counts()
    if got != {"step_fused": want_fused, "solve_contacts": 0}:
        raise AssertionError(f"{what}: launches {got}, expected {want_fused} of step_fused "
                             "and none of solve_contacts")
    return got


def run_gym_envs(card_line) -> int:
    """Phase 10: ``GYM_STEPS`` random-action steps of the old-Gym single env
    on each of ``GYM_IDS`` (a reset after each episode end), the counts set
    to 0 just before and read just after each: one kernel-A launch per step
    and per reset.  Returns the launches in all."""
    rng = np.random.RandomState(0)
    total = 0
    for env_id in GYM_IDS:
        env = GymPuzzleEnv(env_id, seed=0)
        on_card(env, f"GymPuzzleEnv({env_id})")
        cfg = env.spec_cfg
        actions = rng.uniform(-1, 1, (GYM_STEPS, cfg.act_dim)).astype(np.float32)
        env.reset()
        for a in actions[:5]:  # warm-up
            env.step(a)
        step_cuda.reset_launch_count()
        t0 = time.perf_counter()
        obs, resets, ends, step_s = env.reset(), 1, [], 0.0
        finite = bool(np.isfinite(obs).all())
        for a in actions:
            t = time.perf_counter()
            obs, reward, done, info = env.step(a)
            step_s += time.perf_counter() - t
            finite &= bool(np.isfinite(obs).all()) and bool(np.isfinite(reward))
            if done:
                ends.append(info["done_status"])
                obs, resets = env.reset(), resets + 1
        wall = time.perf_counter() - t0
        launches = expect_launches(f"GymPuzzleEnv {env_id}", GYM_STEPS + resets)
        print(f"  GymPuzzleEnv {env_id} (one env, {cfg.velocity_iters}/{cfg.position_iters}): "
              f"{GYM_STEPS} random-action steps and {resets} resets (done_status of the "
              f"episode ends: {ends}) in {wall:.3f} s; {1e3 * step_s / GYM_STEPS:.3f} ms per "
              f"step (wall, obs / reward / done on the host); launches {launches}  "
              f"[{card_line}]", flush=True)
        if not (finite and obs.shape == (cfg.obs_dim,) and obs.dtype == np.float32):
            raise AssertionError(f"GymPuzzleEnv {env_id}: obs {obs.shape} {obs.dtype}, "
                                 f"finite {finite}")
        total += launches["step_fused"]
    return total


def check_small_batches(dev, env_id, card_line) -> dict:
    """Kernel A at ``SMALL_BATCHES`` envs (13: one block whose last warp is
    partial; 1: one live lane) against ``world.step`` on the same spawns:
    one plain tick of 13 spawns at 180/60 is the plain version of both (each
    env's arithmetic is its own), held to ``SPAWN_LIMITS`` with the awake
    flags equal, and the path's incremental trig against exact.  Then kernel
    A's time per launch at E = 1 beside its bound from those inputs."""
    E0 = max(SMALL_BATCHES)
    table, contacts, bodies, force, torque, wake = spawn_tick(dev, E0, 4, env_id)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    bp, cp, _ = world.step(table, bodies, contacts, force, torque, wake, DT, VI, PI)
    torch.cuda.synchronize()
    plain_ms = 1e3 * (time.perf_counter() - t0)
    out = {}
    for E in SMALL_BATCHES:
        cut = lambda x: tree_map(lambda t: t[..., :E].contiguous(), x)  # noqa: E731
        inputs = tuple(cut(x) for x in (bodies, contacts, force, torque, wake))
        args = (table,) + inputs + (DT, VI, PI)
        bk, ck, _ = step_cuda.step_fused(*args, incremental_trig=False)
        name = f"fused, {env_id} spawns E={E} 1 tick {VI}/{PI}"
        out[E] = spawn_diffs(name, (bk.pos, bk.angle, ck.normal_impulse),
                             (bp.pos[..., :E], bp.angle[..., :E], cp.normal_impulse[..., :E]),
                             cp.touching[..., :E].any(dim=0))
        if not torch.equal(bk.awake, bp.awake[..., :E]):
            raise AssertionError(f"{name}: awake flags differ")
        if not all(bool(torch.isfinite(x).all()) for x in (bk.pos, bk.vel, ck.normal_impulse)):
            raise AssertionError(f"{name}: kernel output not finite")
        bi = step_cuda.step_fused(*args)[0]
        report(f"{name}, incremental vs exact trig",
               dict(pos=maxdiff(bi.pos, bk.pos), angle=maxdiff(bi.angle, bk.angle)),
               {k: SPAWN_TRIG_LIMITS[k] for k in ("pos", "angle")})
    one = tuple(tree_map(lambda t: t[..., :1].contiguous(), x)
                for x in (bodies, contacts, force, torque, wake))
    bf, pf, pi = step_cuda.pack(*one)
    fn = lambda: step_cuda.launch(table, bf, pf, pi, DT, VI, PI)  # noqa: E731
    fn()
    ms = cuda_ms(fn, 20)
    live = world.before_solve(table, *one, DT)[0][0]
    live = live.solve & (live.count > 0)
    b = kernel_bound(table, bf, live, VI, PI)
    print(f"  step_fused at E=1, {env_id} spawn {VI}/{PI}: {ms:.3f} ms per launch; "
          f"{int(live.sum())} live pairs; bound {b['ms']:.7f} ms ({b['by']}): {b['bytes']} bytes "
          f"= {b['bytes_ms']:.7f} ms, {b['ops']} f32 ops = {b['ops_ms']:.7f} ms; one one-warp "
          f"block; world.step on the {E0} envs {plain_ms:.1f} ms  [{card_line}]", flush=True)
    return dict(diffs=out, ms=ms, bound=b, plain_ms=plain_ms)


def check_host_raster(dev, card_line):
    """The host rasterizer on ``HOST_RENDER_ENVS`` card spawns of each of
    ``RENDER_CASES``' variants against the card's renderer at downsample 4:
    the share of equal pixels must reach ``RENDER_EQUAL_SHARE``.  Prints the
    host raster's ms per full-size frame."""
    for env_id, (_E, mode) in RENDER_CASES.items():
        logic = _logic(env_id)
        gen = torch.Generator(device=dev).manual_seed(6)
        state, _ = logic.reset_fast(gen, HOST_RENDER_ENVS, logic.default_params())
        want = make_device_renderer(logic, downsample=4, mode=mode)(state).cpu().numpy()
        t0 = time.perf_counter()
        host = render_batch(logic, state, mode=mode)
        ms = 1e3 * (time.perf_counter() - t0) / HOST_RENDER_ENVS
        share = float((host[:, ::4, ::4] == want).all(axis=-1).mean())
        print(f"  host raster {env_id} {mode}, {HOST_RENDER_ENVS} card spawns, frames "
              f"{tuple(host.shape[1:])}: against the card's renderer at downsample 4 "
              f"{share:.6f} of pixels equal (limit {RENDER_EQUAL_SHARE}); {ms:.3f} ms per frame "
              f"on the host  [{card_line}]", flush=True)
        if share < RENDER_EQUAL_SHARE:
            raise AssertionError(f"host raster {env_id}: frames differ from the card's")


def run_adapter(card_line) -> int:
    """``GymnasiumVectorAdapter`` for ``ADAPTER_STEPS`` random-action steps at
    ``NUM_ENVS`` envs (fast autoreset: one launch per step)."""
    env = GymnasiumVectorAdapter(ENV_ID, NUM_ENVS)
    on_card(env.env, "GymnasiumVectorAdapter")
    obs, _info = env.reset(seed=0)
    acts = np.random.RandomState(1).uniform(-1, 1, (ADAPTER_STEPS, NUM_ENVS, 6)).astype(
        np.float32)
    step_cuda.reset_launch_count()
    t0 = time.perf_counter()
    for a in acts:
        obs, rew, term, trunc, info = env.step(a)
    wall = time.perf_counter() - t0
    launches = expect_launches("GymnasiumVectorAdapter", ADAPTER_STEPS)
    if not (obs.shape == (NUM_ENVS, 28) and rew.shape == (NUM_ENVS,) and term.dtype == bool
            and trunc.dtype == bool and np.isfinite(obs).all()):
        raise AssertionError("GymnasiumVectorAdapter: outputs")
    print(f"  GymnasiumVectorAdapter {ENV_ID}: {ADAPTER_STEPS} steps x {NUM_ENVS} envs in "
          f"{wall:.3f} s ({1e3 * wall / ADAPTER_STEPS:.3f} ms per step, numpy in and out); "
          f"launches {launches}  [{card_line}]", flush=True)
    return launches["step_fused"]


def run_image_obs(card_line) -> int:
    """``ImageObsEnv`` (one v0 env, host frames, frameskip 4) for
    ``IMAGE_STEPS`` steps: frameskip launches per step and per reset."""
    env = ImageObsEnv(seed=0)
    on_card(env, "ImageObsEnv")
    fs = env._logic.cfg.frameskip
    acts = np.random.RandomState(2).uniform(-1, 1, (IMAGE_STEPS, 6)).astype(np.float32)
    step_cuda.reset_launch_count()
    t0 = time.perf_counter()
    obs, resets = env.reset(), 1
    for a in acts:
        obs, reward, done, info = env.step(a)
        if done:
            obs, resets = env.reset(), resets + 1
    wall = time.perf_counter() - t0
    launches = expect_launches("ImageObsEnv", fs * (IMAGE_STEPS + resets))
    if obs.shape != env.observation_shape or obs.dtype != np.uint8:
        raise AssertionError(f"ImageObsEnv: obs {obs.shape} {obs.dtype}")
    print(f"  ImageObsEnv: {IMAGE_STEPS} steps, {resets} resets, obs {obs.shape} uint8, "
          f"{1e3 * wall / (IMAGE_STEPS + resets):.3f} ms per step or reset ({fs} ticks and a "
          f"host frame each); launches {launches}  [{card_line}]", flush=True)
    return launches["step_fused"]


def run_video(card_line) -> int:
    """``record_video`` of the committed v0 policy for up to ``VIDEO_STEPS``
    steps: the frames written equal the frames returned; one launch per step
    and one for the reset."""
    cfg = PPOConfig(env_id=ENV_ID, n_envs=1, n_steps=2, batch_size=2, n_epochs=1)
    algo = PPO(cfg)
    on_card(algo, "the video learner")
    st = ckpt.restore_policy(POLICY_NPZ, algo.init_state())
    cb.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=cb.BUILD_DIR) as tmp:
        step_cuda.reset_launch_count()
        t0 = time.perf_counter()
        frames = evaluate.record_video(algo, st, f"{tmp}/v0_r4", n_steps=VIDEO_STEPS, seed=0)
        wall = time.perf_counter() - t0
        with np.load(f"{tmp}/v0_r4.npz") as f:
            saved = f["frames"]
    launches = expect_launches("record_video", len(frames) + 1)
    if not (np.array_equal(saved, frames) and frames.shape[1:] == (480, 640, 3)):
        raise AssertionError("record_video: the .npz frames differ from the returned ones")
    print(f"  record_video of {POLICY_NPZ.name}: {len(frames)} frames (max {VIDEO_STEPS}; an "
          f"episode ends at success) in {wall:.3f} s, {1e3 * wall / len(frames):.3f} ms per "
          f"frame (step on the card, host raster 640x480, the compressed .npz); launches {launches}  "
          f"[{card_line}]", flush=True)
    return launches["step_fused"]


def roll_demonstrator(dev, name, controller, card_line) -> dict:
    """Phase 11: ``controller`` on ``SCRIPTED_ENV`` at ``NUM_ENVS`` envs from
    the reference reset at 180/60, up to the registered step limit, every
    lane's return, length and ``done_status`` kept from its first ``done``
    (a host check every ``SCRIPTED_CHECK_EVERY`` steps ends the roll when
    every lane is done).  A report, not a gate."""
    env = make(SCRIPTED_ENV, num_envs=NUM_ENVS, auto_reset=False, reset_mode="reference")
    on_card(env, f"the {name} env")
    A, max_steps = env.cfg.num_agents, env.cfg.max_episode_steps
    torch.cuda.synchronize()
    step_cuda.reset_launch_count()
    t0 = time.perf_counter()
    state, obs = env.reset(seed=0)
    finished = torch.zeros((NUM_ENVS,), dtype=torch.bool, device=dev)
    total = torch.zeros((NUM_ENVS,), device=dev)
    length = torch.zeros((NUM_ENVS,), dtype=torch.int32, device=dev)
    status = torch.zeros((NUM_ENVS,), dtype=torch.int32, device=dev)
    steps = 0
    while steps < max_steps:
        for _ in range(min(SCRIPTED_CHECK_EVERY, max_steps - steps)):
            state, obs, reward, done, info = env.step(state, controller(obs, A))
            total = total + torch.where(finished, 0.0, reward)
            length = length + (~finished).int()
            status = torch.where(finished, status, info["done_status"])
            finished = finished | done
            steps += 1
        if bool(finished.all()):
            break
    wall = time.perf_counter() - t0
    launches = expect_launches(name, steps + 1)
    done_ok = status == 3
    n_done = int(done_ok.sum())
    med = float(length[done_ok].float().median()) if n_done else float("nan")
    out = dict(completions=n_done, mean_return=float(total.mean()), median_completed_len=med,
               steps=steps, launches=launches["step_fused"])
    if not bool(torch.isfinite(total).all()):
        raise AssertionError(f"{name}: non-finite returns")
    print(f"  {name} on {SCRIPTED_ENV}, {NUM_ENVS} envs, reference reset, "
          f"{env.cfg.velocity_iters}/{env.cfg.position_iters}: "
          f"{n_done}/{NUM_ENVS} completed ({n_done / NUM_ENVS:.4f}), mean return "
          f"{out['mean_return']:.2f}, median completed length {med:.0f}; ended out of bounds "
          f"{int(((status == 1) | (status == 2)).sum())}; {steps} steps in {wall:.1f} s "
          f"({1e3 * wall / steps:.3f} ms per step); launches {launches}; JAX package record: "
          f"{SCRIPTED_RECORDS[name]}  [{card_line}]", flush=True)
    return out


def run_bc(card_line) -> dict:
    """Phase 11's ``bc_train`` at ``BC_CONFIG`` for ``BC_ROUNDS`` rounds
    (``n_steps`` launches each), then ``train.cli --resume`` one PPO update
    from its checkpoint (``n_steps`` launches)."""
    cfg = PPOConfig(**BC_CONFIG)
    print(f"  bc_train {cfg.env_id}, {cfg.n_envs} envs, n_steps {cfg.n_steps}, batch "
          f"{cfg.batch_size}, {cfg.n_epochs} epochs, the pusher at offset {SCRIPTED_OFFSET}: "
          f"rounds cut from 60 to {BC_ROUNDS}  [{card_line}]", flush=True)
    stamps, rows = [], []

    def log_fn(line):
        stamps.append(time.perf_counter())
        rows.append(json.loads(line))

    torch.cuda.synchronize()
    step_cuda.reset_launch_count()
    t0 = time.perf_counter()
    algo, ts = imitate.bc_train(cfg, rounds=BC_ROUNDS, offset_px=SCRIPTED_OFFSET, log_every=1,
                                log_fn=log_fn)
    launches = expect_launches("bc_train", BC_ROUNDS * cfg.n_steps)
    on_card(algo, "bc_train")
    secs = np.diff([t0] + stamps)
    for row, sec in zip(rows, secs):
        print(f"  BC round {row['bc_round'] + 1}: {sec:.3f} s"
              + (" (with the learner's set-up)" if row["bc_round"] == 0 else "")
              + f"; loss {row['loss']:.6g}, pi_mse {row['pi_mse']:.6g}, v_mse "
              f"{row['v_mse']:.6g}  [{card_line}]", flush=True)
    per_round = cfg.n_steps * cfg.n_envs
    if int(ts.timesteps) != BC_ROUNDS * per_round or not all(
            np.isfinite([r["loss"], r["pi_mse"], r["v_mse"]]).all() for r in rows):
        raise AssertionError(f"bc_train: timesteps {int(ts.timesteps)}, rows {rows}")
    print(f"  bc_train: {BC_ROUNDS} rounds in {sum(secs):.3f} s; launches {launches}  "
          f"[{card_line}]", flush=True)

    cb.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=cb.BUILD_DIR) as tmp:
        path = f"{tmp}/{cfg.env_id}"
        ckpt.save(path, ts, ckpt.step_count(ts.timesteps))
        torch.cuda.synchronize()
        step_cuda.reset_launch_count()
        t0 = time.perf_counter()
        final = cli.main(["--env", cfg.env_id, "--n_envs", str(cfg.n_envs), "--n_steps",
                          str(cfg.n_steps), "--batch_size", str(cfg.batch_size), "--n_epochs",
                          str(cfg.n_epochs), "--gamma", str(cfg.gamma), "--seed", "0",
                          "--total_timesteps", str(per_round), "--disable_wandb", "--resume",
                          path])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    resume_launches = expect_launches("train.cli --resume", cfg.n_steps)
    moved = sum(int((final.params[k] != ts.params[k]).sum()) for k in ts.params)
    if int(final.timesteps) != int(ts.timesteps) + per_round or not moved:
        raise AssertionError(f"resume: timesteps {int(final.timesteps)}, {moved} params moved")
    print(f"  train.cli --resume from the BC checkpoint (step {int(ts.timesteps)}): one PPO "
          f"update in {wall:.3f} s (the CLI's set-up included), {moved} params moved, "
          f"timesteps {int(final.timesteps)}; launches {resume_launches}  [{card_line}]",
          flush=True)
    return dict(launches=launches["step_fused"], resume_launches=resume_launches["step_fused"],
                round_s=[float(x) for x in secs])


def run_sweep(card_line) -> dict:
    """Phase 12: ``run_fast_sweep`` at the v0 recipe's width, ``SWEEP_TRIALS``
    trials of one update each, each ranked by ``SWEEP_EVAL_EPISODES``
    deterministic episodes cut to ``SWEEP_EVAL_MAX_STEPS`` steps: a trial
    launches kernel A ``n_steps`` times, and its eval ``SWEEP_EVAL_MAX_STEPS``
    + 1 times (the reference reset's step)."""
    cfg = PPOConfig.from_reference_json(json.loads(TRAIN_CONFIG.read_text()), **TRAIN_OVERRIDES)
    per_update = cfg.n_steps * cfg.n_envs
    stamps = []

    def log(line):
        stamps.append(time.perf_counter())
        print(f"  trial {line}  [{card_line}]", flush=True)

    torch.cuda.synchronize()
    step_cuda.reset_launch_count()
    t0 = time.perf_counter()
    results = sweep.run_fast_sweep(cfg, trials=SWEEP_TRIALS, budget_timesteps=per_update, seed=0,
                                   eval_episodes=SWEEP_EVAL_EPISODES,
                                   eval_max_steps=SWEEP_EVAL_MAX_STEPS, log=log)
    launches = expect_launches("run_fast_sweep",
                               SWEEP_TRIALS * (cfg.n_steps + SWEEP_EVAL_MAX_STEPS + 1))
    secs = np.diff([t0] + stamps)
    scores = [r["score"] for r in results]
    best = results[0]["final_state"]
    if not (scores == sorted(scores, reverse=True) and np.isfinite(scores).all()
            and best is not None and best.params["log_std"].device.type == "cuda"
            and all(r["final_state"] is None for r in results[1:])):
        raise AssertionError(f"run_fast_sweep: ranking {scores}")
    print(f"  run_fast_sweep {cfg.env_id}, {cfg.n_envs} envs, {SWEEP_TRIALS} trials x 1 update, "
          f"eval {SWEEP_EVAL_EPISODES} episodes x {SWEEP_EVAL_MAX_STEPS} steps: "
          + ", ".join(f"{s:.3f}" for s in secs) + " s per trial (the first with the "
          f"learner's set-up); ranking (trial, eval mean) "
          f"{[(r['trial'], round(r['score'], 2)) for r in results]}; launches {launches}  "
          f"[{card_line}]", flush=True)
    return dict(launches=launches["step_fused"], trial_s=[float(x) for x in secs])


def replicated_leaves(tree, specs) -> dict:
    """The leaves of a checkpoint tree outside the fields that ``specs``
    (``train_state_specs``) marks as sharded, by dotted path."""
    def leaves(x, path):
        if isinstance(x, dict):
            return {p: v for k in x for p, v in leaves(x[k], f"{path}.{k}" if path else k).items()}
        return {path: x}
    sharded = [k for k, v in specs.items() if v]
    return {p: v for p, v in leaves(tree, "").items()
            if not any(p == k or p.startswith(k + ".") for k in sharded)}


def dist_config() -> PPOConfig:
    return PPOConfig.from_reference_json(json.loads(TRAIN_CONFIG.read_text()), **TRAIN_OVERRIDES)


def run_dist_world1(card_line) -> dict:
    """Phase 13a: ``DistributedPPO`` on a one-rank NCCL group at the v0
    recipe, for ``DIST_UPDATES`` updates, against a plain ``PPO`` given the
    same action noise and minibatch orders: every state field (generators
    included) and every metric equal bit for bit after each update; exactly
    ``n_steps`` kernel-A launches per update and none of kernel B; env-steps/s
    of both; the all-reduces per update and one gradient all-reduce's wall
    time at the params' size."""
    cfg = dist_config()
    cb.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=cb.BUILD_DIR) as tmp:
        dist.init_process_group("nccl", init_method=f"file://{tmp}/rdv", world_size=1, rank=0)
        try:
            algo, plain = DistributedPPO(cfg), PPO(cfg)
            on_card(algo, "DistributedPPO")
            if algo.mesh.backend != "nccl" or algo.mesh.world_size != 1:
                raise AssertionError(f"mesh {algo.mesh}")
            gen = torch.Generator(device=algo.device).manual_seed(0)
            total = cfg.n_steps * cfg.n_envs
            inputs = [(torch.randn((cfg.n_steps, cfg.n_envs, plain.act_dim), generator=gen,
                                   device=algo.device),
                       torch.stack([torch.randperm(total, generator=gen, device=algo.device)
                                    for _ in range(cfg.n_epochs)]))
                      for _ in range(DIST_UPDATES)]
            a, b = plain.init_state(), algo.init_state()
            diff = tree_diff(ckpt.to_tree(b), ckpt.to_tree(a), "init")
            want, plain_walls = [], []
            for noise, perms in inputs:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                a, ma = plain.train_step(a, noise, perms)
                torch.cuda.synchronize()
                plain_walls.append(time.perf_counter() - t0)
                want.append((ckpt.to_tree(a), ckpt.to_tree(ma)))
            torch.cuda.synchronize()
            step_cuda.reset_launch_count()
            calls0, walls = algo.mesh.calls, []
            for u, (noise, perms) in enumerate(inputs):
                t0 = time.perf_counter()
                b, mb = algo.train_step(b, noise, perms)
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
                diff += (tree_diff(ckpt.to_tree(b), want[u][0], f"update {u + 1} state")
                         + tree_diff(ckpt.to_tree(mb), want[u][1], f"update {u + 1} metrics"))
            launches = expect_launches("DistributedPPO world size 1", DIST_UPDATES * cfg.n_steps)
            calls = algo.mesh.calls - calls0
            if diff:
                raise AssertionError(f"DistributedPPO at world size 1 differs from PPO in {diff}")
            grads = [torch.randn_like(v) for v in b.params.values()] + [
                torch.zeros((), device=algo.device)]
            for _ in range(10):
                algo.mesh.mean(grads)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(ALLREDUCE_REPS):
                algo.mesh.mean(grads)
            torch.cuda.synchronize()
            allreduce_ms = (time.perf_counter() - t0) / ALLREDUCE_REPS * 1e3
        finally:
            dist.destroy_process_group()
    n_floats = sum(g.numel() for g in grads)
    rate, plain_rate = DIST_UPDATES * total / sum(walls), DIST_UPDATES * total / sum(plain_walls)
    print(f"  (a) DistributedPPO, 1 rank on NCCL, {cfg.n_envs} envs, {DIST_UPDATES} updates with "
          f"the noise and orders of a plain PPO: equal bit for bit after every update (params, "
          f"Adam state, normalizer, env state, generators, metrics); launches {launches}; "
          f"{calls / DIST_UPDATES:.1f} all-reduces per update; updates "
          + " / ".join(f"{w:.3f}" for w in walls) + f" s: {rate:,.0f} env-steps/s including the "
          f"learner (plain PPO " + " / ".join(f"{w:.3f}" for w in plain_walls)
          + f" s: {plain_rate:,.0f}); one gradient + KL all-reduce ({n_floats} float32, "
          f"flatten and split included) {allreduce_ms:.4f} ms wall  [{card_line}]", flush=True)
    return dict(launches=launches["step_fused"], rate=rate, plain_rate=plain_rate,
                allreduce_ms=allreduce_ms, calls_per_update=calls / DIST_UPDATES,
                walls=walls, plain_walls=plain_walls)


def _gloo_rank(rank, job, tmp):
    """One of the ``DIST_GLOO_RANKS`` processes of phase 13b, on the one
    card over gloo.  ``train``: ``DIST_GLOO_UPDATES`` updates (launches
    counted per update, a sharded save after the first), one heartbeat;
    ``resume``: restore the save and run the second update again.  Writes
    what it got to ``<tmp>/<job>_<rank>.pt``."""
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/rdv_{job}",
                            world_size=DIST_GLOO_RANKS, rank=rank)
    try:
        algo = DistributedPPO(dist_config(), device="cuda:0")
        out = {}
        if job == "train":
            hb = Heartbeat(timeout=60.0)
            ts = algo.init_state()
            out.update(envs=ckpt.to_tree(ts.vstate), specs=train_state_specs(ts),
                       launches=[], states=[], metrics=[], walls=[])
            for u in range(DIST_GLOO_UPDATES):
                torch.cuda.synchronize()
                step_cuda.reset_launch_count()
                t0 = time.perf_counter()
                ts, metrics = algo.train_step(ts)
                torch.cuda.synchronize()
                out["walls"].append(time.perf_counter() - t0)
                out["launches"].append(launch_counts())
                out["states"].append(ckpt.to_tree(ts))
                out["metrics"].append(ckpt.to_tree(metrics))
                if u == 0:
                    ckpt.save(f"{tmp}/ckpt", ts, ckpt.step_count(ts.timesteps), mesh=algo.mesh)
            t0 = time.perf_counter()
            hb.ping()
            out["ping_s"] = time.perf_counter() - t0
        else:
            rs = ckpt.restore(f"{tmp}/ckpt", algo.init_state(), mesh=algo.mesh)
            rs, metrics = algo.train_step(rs)
            out.update(state=ckpt.to_tree(rs), metrics=ckpt.to_tree(metrics))
        torch.save(out, f"{tmp}/{job}_{rank}.pt")
    finally:
        dist.destroy_process_group()


def run_dist_gloo(card_line) -> dict:
    """Phase 13b: ``DIST_GLOO_RANKS`` processes share the card over gloo
    (NCCL refuses two ranks on one device), 2048 envs each: the replicated
    state and the metrics bitwise equal across the ranks after every update,
    the env shards different, ``n_steps`` kernel-A launches per rank per
    update, a heartbeat; a sharded save after update 1, restored into a fresh
    job, whose update 2 equals the first job's bit for bit on every rank."""
    cfg = dist_config()
    out = {}
    cb.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=cb.BUILD_DIR) as tmp:
        for job in ("train", "resume"):
            t0 = time.perf_counter()
            mp.start_processes(_gloo_rank, args=(job, tmp), nprocs=DIST_GLOO_RANKS,
                               start_method="spawn")
            out[f"{job}_s"] = time.perf_counter() - t0
            out[job] = [torch.load(f"{tmp}/{job}_{r}.pt", map_location="cpu", weights_only=False)
                        for r in range(DIST_GLOO_RANKS)]
    train, resume = out["train"], out["resume"]
    specs = train[0]["specs"]
    want = {"step_fused": cfg.n_steps, "solve_contacts": 0}
    for r, got in enumerate(train):
        if got["launches"] != [want] * DIST_GLOO_UPDATES:
            raise AssertionError(f"rank {r}: launches per update {got['launches']}, expected "
                                 f"{want} in each")
    for u in range(DIST_GLOO_UPDATES):
        rep = [replicated_leaves(t["states"][u], specs) for t in train]
        diff = tree_diff(rep[0], rep[1], f"update {u + 1}") + tree_diff(
            train[0]["metrics"][u], train[1]["metrics"][u], f"update {u + 1} metrics")
        if diff:
            raise AssertionError(f"the ranks' replicated state differs in {diff}")
    if not tree_diff(train[0]["envs"], train[1]["envs"]):
        raise AssertionError("the two ranks' env shards are equal")
    for r in range(DIST_GLOO_RANKS):
        diff = (tree_diff(resume[r]["state"], train[r]["states"][-1], f"rank {r} state")
                + tree_diff(resume[r]["metrics"], train[r]["metrics"][-1], f"rank {r} metrics"))
        if diff:
            raise AssertionError(f"the resumed update differs in {diff}")
    walls = [t["walls"] for t in train]
    per_update = cfg.n_steps * cfg.n_envs
    rates = [per_update / max(w[u] for w in walls) for u in range(DIST_GLOO_UPDATES)]
    print(f"  (b) {DIST_GLOO_RANKS} ranks on the one card over gloo, "
          f"{cfg.n_envs // DIST_GLOO_RANKS} envs each: replicated state and metrics bitwise equal across the ranks after each of "
          f"{DIST_GLOO_UPDATES} updates; env shards differ; launches per rank per update "
          f"{[t['launches'][0]['step_fused'] for t in train]}; heartbeat "
          + " / ".join(f"{t['ping_s'] * 1e3:.2f}" for t in train) + " ms; updates (slowest "
          "rank) " + " / ".join(f"{max(w[u] for w in walls):.3f}" for u in range(DIST_GLOO_UPDATES))
          + " s = " + " / ".join(f"{x:,.0f}" for x in rates) + " env-steps/s; resumed update "
          f"{DIST_GLOO_UPDATES} equal bit for bit on every rank; jobs {out['train_s']:.1f} / "
          f"{out['resume_s']:.1f} s (process start-up included)  [{card_line}]", flush=True)
    return dict(launches=[[lc["step_fused"] for lc in t["launches"]] for t in train],
                rates=rates, walls=walls)


def run_dist_entry_points(card_line) -> dict:
    """Phase 13c: the scaling bench's n = 1 row at its defaults, and one
    update of the v0 recipe through ``torchrun --nproc_per_node 1 -m
    gym_puzzles_tpu_torch.train.cli --distributed``."""
    (row,) = scaling_bench.run(nproc=1)
    if not (row["devices"] == 1 and row["env_steps_per_s"] > 0
            and row["efficiency_vs_1dev"] == 1.0):
        raise AssertionError(f"scaling bench row {row}")
    print(f"  (c) scaling bench (2048 envs, 64 steps, 2 epochs, best of 3 after a warm update): "
          f"{json.dumps(row)}  [{card_line}]", flush=True)
    cfg = dist_config()
    t0 = time.perf_counter()
    run = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", "1",
         "-m", "gym_puzzles_tpu_torch.train.cli", "--distributed", "--config", str(TRAIN_CONFIG),
         "--n_envs", str(cfg.n_envs), "--n_steps", str(cfg.n_steps),
         "--batch_size", str(cfg.batch_size), "--n_epochs", str(cfg.n_epochs),
         "--total_timesteps", str(cfg.n_steps * cfg.n_envs), "--disable_wandb"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    wall = time.perf_counter() - t0
    lines = [json.loads(line) for line in run.stdout.splitlines() if line.startswith("{")]
    if run.returncode or [line["timesteps"] for line in lines] != [cfg.n_steps * cfg.n_envs]:
        raise AssertionError(f"torchrun train.cli --distributed: rc {run.returncode}\n"
                             f"{run.stdout[-2000:]}\n{run.stderr[-2000:]}")
    print(f"  (c) torchrun --nproc_per_node 1 -m gym_puzzles_tpu_torch.train.cli --distributed: "
          f"one update, {wall:.1f} s with start-up; {json.dumps(lines[0])}  [{card_line}]",
          flush=True)
    return dict(row=row, cli_s=wall)


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
    with ThreadPoolExecutor(2) as pool:  # one nvcc per source, started together
        builds = [pool.submit(m.KERNEL.build) for m in (step_cuda, solver_cuda)]
        builds = [f.result() for f in builds]
    print(f"  built {', '.join(path.name for path, _ in builds)} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for m, (_path, log) in zip((step_cuda, solver_cuda), builds):
        report = cb.ptxas_report(log)
        if len(report) != len(cb.SIZE_CLASSES):
            raise AssertionError(f"{m.KERNEL.name}: ptxas reported {len(report)} "
                                 f"instantiations, expected {len(cb.SIZE_CLASSES)}")
        for r in report:
            print(f"  ptxas: {m.KERNEL.name} B<={r['bodies']} P<={r['pairs']}: "
                  f"{r['registers']} registers, {r['stack']} bytes stack frame, "
                  f"{r['spill_stores']} / {r['spill_loads']} bytes spill stores / loads; "
                  f"{m.KERNEL.envs_per_warp()} envs per warp", flush=True)

    print("== 3. fused tick kernel against plain on the card", flush=True)
    check_push_world(dev)
    spawn_diff, plain_ms = check_spawns(dev, NUM_ENVS, seed=0)
    check_spawns(dev, 1000, seed=1)
    plain_variants = {env_id: check_spawns(dev, NUM_ENVS, seed=2, env_id=env_id)[1]
                      for env_id in VARIANTS[1:]}
    check_trig(dev)

    print("== 4. contact-solve kernel against plain on the card", flush=True)
    check_push_world(dev, staged_tick(False), "staged push world")
    solve_diff, solve_plain_ms = check_solve_kernel(dev, ENV_ID, NUM_ENVS, seed=0)
    check_solve_kernel(dev, ENV_ID, 1000, seed=1)
    _diff, solve_plain_v2_ms = check_solve_kernel(dev, "MultiRobotPuzzle-v2", NUM_ENVS,
                                                  seed=2)
    check_trig(dev, ENV_ID, staged_tick, "staged")
    check_trig(dev, "MultiRobotPuzzle-v2", staged_tick, "staged")
    check_trig(dev, "MultiRobotPuzzle-v2", fused_tick, "fused")

    print("== 5. main paths", flush=True)
    fused_run = run_main_path(dev, card_line)
    print("== 3 (end). fused tick kernel against plain on the state the v0 fused drive "
          "ends with", flush=True)
    check_end_of_drive(dev, fused_run["env"], fused_run["state"], card_line)
    staged_run = run_main_path(dev, card_line, ENV_ID, "pallas")
    run_main_path(dev, card_line, "MultiRobotPuzzle-v2", "pallas")
    run_main_path(dev, card_line, "MultiRobotPuzzle-v2", "fused")
    run_main_path(dev, card_line, "MultiRobotPuzzle-v3", "fused")

    print("== 7. train: PPO on v0", flush=True)
    train_launches = run_training(card_line)
    print("== 8. eval of the committed v0 policy", flush=True)
    run_eval(card_line)

    print("== 9. pixels: renderer, CNN PPO at the pixel recipe, its eval, kernel A at 256 "
          "envs", flush=True)
    render_ms = check_renderer(dev, card_line)
    pixel_algo, pixel_ts, pixel_launches = run_pixel_training(card_line)
    pixel_eval = run_pixel_eval(pixel_algo, pixel_ts, card_line)
    pixel_kernel = time_pixel_kernel(dev, card_line)
    print(f"  pixel path: render {render_ms:.3f} ms per step of {CNN_CONFIG['n_envs']} envs; "
          f"eval {pixel_eval['ms_per_step']:.2f} ms per step  [{card_line}]", flush=True)

    print("== 10. host surface: GymPuzzleEnv, kernel A at E = 1 and 13, host raster, "
          "gymnasium adapter, ImageObsEnv, record_video", flush=True)
    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    raster_lib, _log = _raster_cpp.build()
    print(f"  host rasterizer {raster_lib.name} (g++ -O3 -march=native) ready in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    gym_launches = run_gym_envs(card_line)
    small = {env_id: check_small_batches(dev, env_id, card_line)
             for env_id in (ENV_ID, "MultiRobotPuzzleHeavy-v0")}
    check_host_raster(dev, card_line)
    run_adapter(card_line)
    run_image_obs(card_line)
    run_video(card_line)
    print(f"  phase 10: {time.perf_counter() - t_phase:.1f} s", flush=True)

    print("== 11. scripted demonstrators and BC at full width", flush=True)
    t_phase = time.perf_counter()
    demos = {"pusher": roll_demonstrator(
                 dev, "pusher", lambda obs, A: scripted.pusher_action(obs, A, SCRIPTED_OFFSET),
                 card_line),
             "planner": roll_demonstrator(dev, "planner", scripted.planner_action, card_line)}
    bc = run_bc(card_line)
    print(f"  phase 11: {time.perf_counter() - t_phase:.1f} s", flush=True)

    print("== 12. sweep", flush=True)
    t_phase = time.perf_counter()
    sweep_run = run_sweep(card_line)
    print(f"  phase 12: {time.perf_counter() - t_phase:.1f} s", flush=True)

    print("== 13. distribution: DistributedPPO on NCCL at world size 1, two ranks over gloo, "
          "the scaling bench, torchrun", flush=True)
    t_phase = time.perf_counter()
    dist_w1 = run_dist_world1(card_line)
    dist_gloo = run_dist_gloo(card_line)
    run_dist_entry_points(card_line)
    print(f"  phase 13: {time.perf_counter() - t_phase:.1f} s", flush=True)

    print("== 6. kernels", flush=True)
    times = {env_id: time_kernels(dev, env_id, card_line) for env_id in VARIANTS}
    v0 = times[ENV_ID]
    print(f"  plain versions on {NUM_ENVS} v0 spawns {VI}/{PI}: world.step {plain_ms:.1f} ms per "
          f"tick, solve_contacts_plain {solve_plain_ms:.1f} ms per solve  [{card_line}]",
          flush=True)
    print(f"  plain versions on {NUM_ENVS} spawns {VI}/{PI}: world.step "
          + ", ".join(f"{env_id} {ms:.1f} ms" for env_id, ms in plain_variants.items())
          + f"; solve_contacts_plain MultiRobotPuzzle-v2 {solve_plain_v2_ms:.1f} ms  "
          f"[{card_line}]", flush=True)
    common = dict(route="cuda", library_ms=None, checked=True)
    print(json.dumps({"kernels": [
        dict(common, name="step_fused",
             source="gym_puzzles_tpu_torch/csrc/step_fused.cu",
             replaces="gym_puzzles_tpu/engine/step_pallas.py:539",
             launches=fused_run["launches"], train_launches=train_launches,
             pixel_train_launches=pixel_launches["step_fused"],
             pixel_ms=pixel_kernel[PIXEL_ITERS[0]]["ms"],
             pixel_bound_ms=pixel_kernel[PIXEL_ITERS[0]]["bound"]["ms"],
             gym_env_launches=gym_launches,
             e1_ms=small[ENV_ID]["ms"], e1_bound_ms=small[ENV_ID]["bound"]["ms"],
             e1_bound_by=small[ENV_ID]["bound"]["by"],
             e1_max_abs_err=small[ENV_ID]["diffs"][1]["max"],
             e13_plain_ms=small[ENV_ID]["plain_ms"],
             e13_max_abs_err=max(v["diffs"][13]["max"] for v in small.values()),
             scripted_launches=sum(d["launches"] for d in demos.values()),
             bc_launches=bc["launches"], bc_resume_launches=bc["resume_launches"],
             sweep_launches=sweep_run["launches"],
             dist_launches=dist_w1["launches"], dist_gloo_launches=dist_gloo["launches"],
             max_abs_err=spawn_diff["max"],
             ms=v0["fused_ms"], plain_ms=plain_ms,
             bound_ms=v0["fused_bound"]["ms"], bound_by=v0["fused_bound"]["by"]),
        dict(common, name="solve_contacts",
             source="gym_puzzles_tpu_torch/csrc/solve_contacts.cu",
             replaces="gym_puzzles_tpu/engine/solver_pallas.py:557",
             launches=staged_run["launches"],
             max_abs_err=solve_diff["max"],
             ms=v0["solve_ms"], plain_ms=solve_plain_ms,
             bound_ms=v0["solve_bound"]["ms"], bound_by=v0["solve_bound"]["by"]),
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
