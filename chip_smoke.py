#!/usr/bin/env python3
"""Quickest proof that the PyTorch port runs on an NVIDIA H100.

    python3 chip_smoke.py

Phases (each raises on failure; the script exits non-zero on any):
1. the card (nvidia-smi name and power limit), torch and CUDA versions;
2. build both tick kernels, the learner's fused optimizer step and gradient
   chain and the v0 env's two kernels from ``gym_puzzles_tpu_torch/csrc``
   (one nvcc each, started together, sm_90a) and print the build time and,
   for every instantiation (size class) of each tick kernel and each of the
   other kernels, ptxas' registers, stack frame and spills;
3. hold the fused tick kernel against its plain PyTorch version
   (``world.step``) on the card: the injected 3-body push world (10 ticks at
   8/4), v0 random spawns at 4096 envs (1 tick at 180/60), 1000 envs (the
   ragged edge), 4096 spawns each of Heavy-v0, v2, v3 (the shapes the
   main paths give it) and v3 built with five heavy agents (48 pairs, the
   large size class; its spawns beyond the position limit held to what
   float32 itself reaches from inputs moved by its rounding,
   ``check_spawns_reach``), and the exact against the incremental position-pass
   trig on a 12-tick v0 contact drive; and, once phase 5 has run it, on the
   state the 200-step v0 fused drive ends with (resting contacts, sleeping
   bodies), with the kernel's time on that state;
4. hold the contact-solve kernel against its plain version
   (``solver_cuda.solve_contacts_plain``): the push world through the staged
   tick, the constraints of 4096 v0 spawns, 1000 v0 spawns (ragged), 4096
   v2 spawns and 4096 spawns of v3 with five heavy agents after the PyTorch
   prologue, exact against incremental trig on each, and on 12-tick v0 and
   v2 contact drives;
5. the main paths at 4096 envs and 180/60, 200 steps of random actions each
   through ``make(...)`` with the default device: v0 fused, v0 and v2 staged
   (``backend='pallas'``), v2 and v3 fused; each step a CUDA graph replay
   (captured at the first warm-up step); every output finite; exactly 200 x
   frameskip launches of the path's kernel and none of the other;
7. train: PPO on v0 at 4096 envs through ``train.ppo.PPO`` (fused backend,
   180/60, ActorCritic 256x256, the JAX package's full-width recipe: n_steps
   64, batch 8192, 4 epochs, the rest from ``train_configs/ppo-mrp-v0.json``)
   for 3 updates: finite metrics, params moved, ``timesteps`` 786,432 as
   int64, exactly 192 launches of the fused tick kernel and none of the
   solve kernel; saved after update 2, restored into a fresh learner, whose
   update 3 must equal the uninterrupted one bit for bit (params, Adam state,
   normalizer, env state, generators, metrics); each update's wall time,
   env-steps/s including the learner, and the split of timed updates into
   the rollout and the learner (each one CUDA graph replay);
8. eval of the committed v0 policy (``gym_puzzles_tpu_torch/policies/``)
   through ``check_policy``: its deterministic actions on the obs of 4096
   resets on the card against the CPU (1e-5), then 4096 deterministic
   episodes of at most 2000 steps through ``evaluate_policy_batched``
   (fused), one kernel-A launch per env step: completion share
   (``done_status`` 3) in [0.82, 0.93] and mean return in [5190, 6800], the
   bands around the JAX package's record for this policy (337/384, mean
   5992);
9. pixels (the image pipeline, whose physics is the fused tick kernel at
   frameskip 4): the on-device renderer on the card against the same
   renderer on the CPU (4096 v0 spawns, human vision; 1024 v2 spawns, agent
   vision; 1024 v3 spawns; downsample 4), share of equal pixels >= 0.999;
   CNN PPO at the JAX package's pixel recipe (256 image envs, fused, 60/20,
   n_steps 32, batch 2048, 2 epochs, seed 0) through ``train_and_resume`` as
   in phase 7 with cuDNN held deterministic: 384 launches of the fused tick
   kernel in 3 updates and none of the solve kernel, the resumed update
   bitwise, one more update split into rollout and learner (one CUDA graph
   each); the policy those updates produce: deterministic actions on the
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
   (its learner's CUDA graph holding the all-reduces) against a plain
   ``PPO`` given the same action noise and minibatch orders: every state
   field and metric equal bit for bit after each update, 192 kernel-A
   launches and none of B, env-steps/s of both, exactly 131 all-reduces per
   update (one per minibatch and three more) and one gradient all-reduce's
   wall time; (b) two processes share
   the card over gloo (NCCL refuses two ranks on one device), 2048 envs
   each, 2 updates: replicated state and metrics bitwise equal across the
   ranks after every update, env shards different, 64 launches per rank per
   update, a heartbeat, and a sharded save after update 1 restored into a
   fresh two-process job whose update 2 equals the first job's bit for bit;
   (c) the scaling bench's n = 1 row at its defaults and one update of
   ``torchrun --nproc_per_node 1 -m gym_puzzles_tpu_torch.train.cli
   --distributed``;
14. the JAX package's variant policies (v2 r4, v2 83 r5, v3 r4, Heavy-v2
   r4, Heavy-v0 H2 r5 and X4 r4; files in ``gym_puzzles_tpu_torch/policies/``) and
   the policies the port trained by the JAX recipes (``PORT_POLICIES``) through
   ``check_policy`` at their registered episode limits (2000, 1500 for v3,
   3000 for Heavy-v0), 4096 episodes each: card against CPU actions, one
   kernel-A launch per env step, the mean return inside three standard
   errors of the record it is held to (the JAX package's, or for the port's
   Heavy-v0 X4 its own run's; computed from the record files under
   ``docs/benchmarks/``) and, but for Heavy-v0, above the registered
   ``reward_threshold``;
15. PPO on each variant's recipe at full width through ``train_and_resume``
   (3 updates, launches counted by the learner's ``env_backend``, the resumed
   update 3 bitwise with ``env_params``, split by part): v2 and Heavy-v2
   with ``update_goal``, Heavy-v0 at 16384 envs (kernel A's large size
   class) with the reward overrides and a 1100-step horizon warm-started
   from the recipe's own start, the JAX X4 policy, v3 on the staged tick
   (192 launches of the solve kernel, none of kernel A); then kernel A against
   ``world.step`` in float32 and float64 on 16384 Heavy-v0 spawns
   (``check_spawns_f64``), equal bit for bit to its launches on 4096-env
   slices, and both kernels timed there;
16. (run after 15) the CUDA graphs against the eager bodies they capture,
   every output bit for bit (``mismatches``: the elements whose bits
   differ), launches exact (each graph holds ``frameskip`` launches, and at
   v0 and Heavy-v0 one of each of the env logic's two kernels; two per tick,
   replay and eager): 200 steps at 4096 envs and 180/60 of v0,
   Heavy-v0, v2 and v3 on both ticks (v0 fused reseeded by ``reset(seed=1)``
   after the capture, v2 with ``update_goal`` changed half way) and of v3
   with five heavy agents fused, Heavy-v0 at
   16384 envs, a v0 and a v2 graph stepped in turn (each replay on its own
   world table), the image env at 256 envs and 60/20 (frames), and two
   chained ``PPO.rollout`` replays at the v0 and pixel recipes against
   ``PPO.rollout_eager``; peak device memory;
17. (run after 16) the MLP learner's minibatch gradient chain (``mlp_grad``)
   against ``PPO.loss`` + autograd at the v0 and Heavy-v0 X4 recipes' shapes,
   each leaf within ``MLP_GRAD_TOL`` of its largest magnitude, then us per
   minibatch in a CUDA graph beside its float32 bound, the three trunk GEMMs
   alone and the plain version; the learner's fused optimizer step (``adam_fused``: clip,
   Adam and the target-KL freeze in two launches) against its plain version
   (``ppo.adam_freeze_plain``) on the card at the v0 MLP's and the pixel
   CNN's leaves: bit for bit with the clip inactive, within 1e-6 of each
   leaf's largest magnitude with it active, a frozen step returning its
   inputs; each one CUDA graph of ``ADAM_CALLS`` chained steps, ms per step
   beside the bound (7 float32 words per parameter at 3.35 TB/s); then the
   learner as a CUDA graph (``PPO.learn_steps``: the
   bootstrap value, GAE, the minibatch orders drawn on the card, the epochs
   with the target-KL stop as a device mask, the metrics): two chained
   ``PPO.train_step`` updates (rollout graph, then learner graph) against
   ``PPO.train_step_eager`` from the same state and generator states, every
   element of state and metrics bit for bit, ``kl_stopped`` equal, launches
   exact, the learner's graph holding two of ``adam_fused`` and, at the MLP
   recipes, four of ``mlp_grad`` per minibatch, and no tick kernel: at the v0 recipe (default, then
   with ``target_kl`` set so that the stop fires inside the first update, on
   the same graphs), the pixel recipe (cuDNN deterministic) and the v2
   recipe;
18. (run after 17) the v2 recipe's two legs as the train CLI runs them,
   ``PPO.train_step`` against ``PPO.train_step_eager`` side by side from one
   ``init_state``: 12 updates with the goal schedule over leg 1's 114, a
   save of each way, a restore of each into a fresh learner at leg 2's
   config with ``cli.leg_overrides`` (``ent_coef`` 0.002, the schedule
   restarting over leg 2's 247 updates; graphs captured anew), 12 more
   updates: 0 differing elements in every update's state and metrics and
   in the restored states, 24 x 64 kernel-A launches each way, each graph
   captured once per learner, the schedule the CLI's;
6. (run after 7-18) the v0 env's ``control`` and ``score_respawn`` kernels
   (``envs/v0_cuda.py``) at 4096 v0 and 16384 Heavy-v0 envs, from fresh
   spawns, after 50 random steps and at a step where every env truncates:
   against their plain versions on the same inputs (0 differing elements in
   the exact outputs, the float ones' largest differences), ``RESPAWNS`` of
   a traced launch, us per launch in a CUDA graph beside the bound (bytes
   at 3.35 TB/s) and the plain version's time (``check_env_logic``); both
   tick kernels' times per variant, beside the mean and warp-max live pairs
   per env of the inputs timed (the sweeps visit only those), and one JSON
   line describing each hand-written kernel (times, bound, launches);
then the whole script's time; last line: ``{"ok": true, "device": {...}}``.
Rates, traces and the main path's roofline shares are the benchmark's
(``python3 -m portbench.run``); the kernels' bounds here count with its
arithmetic (``portbench/yardstick.py``).

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
from types import SimpleNamespace

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from torch.func import functional_call

from gym_puzzles_tpu_torch import make
from gym_puzzles_tpu_torch.api.gym_compat import GymnasiumVectorAdapter, GymPuzzleEnv
from gym_puzzles_tpu_torch.api.image_obs import DeviceImageVectorEnv, ImageObsEnv
from gym_puzzles_tpu_torch.api.registry import _logic
from gym_puzzles_tpu_torch.engine import _cuda_build as cb
from gym_puzzles_tpu_torch.engine import shapes as shp
from gym_puzzles_tpu_torch.engine import solver_cuda, step_cuda, types, world
from gym_puzzles_tpu_torch.envs import common as env_common
from gym_puzzles_tpu_torch.envs import v0_cuda
from gym_puzzles_tpu_torch.envs.base import PuzzleEnvLogic
from gym_puzzles_tpu_torch.envs.config import V2_EPSILON
from gym_puzzles_tpu_torch.envs.config import VARIANTS as VARIANT_CFGS
from gym_puzzles_tpu_torch.render import _raster_cpp
from gym_puzzles_tpu_torch.render.device import make_device_renderer
from gym_puzzles_tpu_torch.render.raster import render_batch
from gym_puzzles_tpu_torch.parallel import DistributedPPO, Heartbeat, scaling_bench
from gym_puzzles_tpu_torch.parallel import train_state_specs
from gym_puzzles_tpu_torch.train import adam_fused, mlp_grad
from gym_puzzles_tpu_torch.train import checkpoint as ckpt
from gym_puzzles_tpu_torch.train import cli, evaluate, imitate, scripted, sweep
from gym_puzzles_tpu_torch.train import normalize as nrm
from gym_puzzles_tpu_torch.train.networks import ActorCritic, gaussian_log_prob
from gym_puzzles_tpu_torch.train.ppo import (PPO, AdamState, HParams, PhaseTimer, PPOConfig,
                                             adam_freeze_plain, adam_freeze_step)
from gym_puzzles_tpu_torch.utils import cuda_graph, profiling
from portbench import yardstick

ENV_ID = "MultiRobotPuzzle-v0"
NUM_ENVS = 4096
DT = 1.0 / 50.0
MAIN_STEPS = 200
VI, PI = 180, 60  # the reference's solver iterations
# Float32 operations of the solve kernel alone (island labels and integration)
# per body, counted from csrc/solve_contacts.cu as portbench/yardstick.py
# counts the tick's
OPS_SOLVE_BODY = 40

VARIANTS = ("MultiRobotPuzzle-v0", "MultiRobotPuzzleHeavy-v0", "MultiRobotPuzzle-v2",
            "MultiRobotPuzzle-v3")
# v3 built with five heavy agents (``api/registry.py::_logic``'s num_agents and
# heavy): 10 bodies, 48 pairs, kernel A's large size class; held in phases 3,
# 4 and 16
V3_ID, HEAVY5 = "MultiRobotPuzzle-v3", dict(num_agents=5, heavy=True)
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
# check_spawns_reach: copies of each env beyond SPAWN_LIMITS['max'] re-solved
# from inputs moved by float32 rounding
REACH_COPIES = 16

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
POLICY_DIR = ROOT / "gym_puzzles_tpu_torch" / "policies"
POLICY_NPZ = POLICY_DIR / "MultiRobotPuzzle-v0_r4.npz"
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
# phase 14: the JAX package's variant policies (gym_puzzles_tpu_torch/policies/,
# each written from checkpoints/<run>/) at their registered episode limits,
# each held to the band around the JAX package's record of it (the eval files
# under docs/benchmarks/, 128 deterministic episodes per seed) and, where the
# JAX package met it, above the registered reward_threshold (Heavy-v0's is
# unmet there too: docs/BENCHMARKS.md)
RECORDS = ROOT / "docs" / "benchmarks"
VARIANT_EVAL_EPISODES = 4096
VARIANT_POLICIES = (  # (file, env id, the JAX records, hold the threshold)
    ("MultiRobotPuzzle-v2_r4.npz", "MultiRobotPuzzle-v2",
     [f"eval_v2_r4_seed{k}_fused.json" for k in range(3)], True),
    ("MultiRobotPuzzle-v2_83_r5.npz", "MultiRobotPuzzle-v2",
     [f"eval_v2_83_r5_seed{k}.json" for k in range(2)], True),
    ("MultiRobotPuzzle-v3_r4.npz", "MultiRobotPuzzle-v3",
     [f"eval_v3_r4_seed{k}_fused.json" for k in range(3)], True),
    ("MultiRobotPuzzleHeavy-v2_r4.npz", "MultiRobotPuzzleHeavy-v2",
     [f"eval_hv2_r4_seed{k}_fused.json" for k in range(3)], True),
    ("MultiRobotPuzzleHeavy-v0_H2_r5.npz", "MultiRobotPuzzleHeavy-v0",
     [f"eval_hv0_H2_r5_seed{k}.json" for k in range(3)], False),
    # X4 of the Heavy-v0 curriculum (the H2 recipe's warm start), beside the
    # port's own X4 below on the same spawns
    ("MultiRobotPuzzleHeavy-v0_best_r4.npz", "MultiRobotPuzzleHeavy-v0",
     [f"eval_hv0_X4_seed{k}.json" for k in range(3)], False),
)
# and the policies the port trained itself on the H100 by the JAX recipes
# (docs/benchmarks/torch_h100_ppo_recipes.sh and torch_h100_ppo_v0.sh; their
# records docs/benchmarks/torch_h100_{v0g,v2,hv2,v3,hv0h2_s0}_*), each exported
# from its run's final checkpoint by train/export.py and held to the band
# around the JAX record of its recipe (Heavy-v0's H2: its threshold unmet, as
# for the JAX policy).  The Heavy-v2 run's file
# (MultiRobotPuzzleHeavy-v2_torch_h100.npz) missed its band at 384 episodes
# (ROADMAP.md, Queue 3) and is not held here.  The X4 of the Heavy-v0
# curriculum trained from a fresh init (recipe hv0c, its first chain) missed
# the JAX X4 band at 384 episodes too: it is held to the band around its own
# run's eval rows, so that a change to the file or to the eval path shows.
PORT_POLICIES = (
    ("MultiRobotPuzzle-v0_torch_h100.npz", "MultiRobotPuzzle-v0",
     [f"eval_v0_r4_seed{k}_fused.json" for k in range(3)], True),
    ("MultiRobotPuzzle-v2_torch_h100.npz", "MultiRobotPuzzle-v2",
     [f"eval_v2_r4_seed{k}_fused.json" for k in range(3)], True),
    ("MultiRobotPuzzle-v3_torch_h100.npz", "MultiRobotPuzzle-v3",
     [f"eval_v3_r4_seed{k}_fused.json" for k in range(3)], True),
    ("MultiRobotPuzzleHeavy-v0_torch_h100.npz", "MultiRobotPuzzleHeavy-v0",
     [f"eval_hv0_H2_r5_seed{k}.json" for k in range(3)], False),
    ("MultiRobotPuzzleHeavy-v0_x4_torch_h100.npz", "MultiRobotPuzzleHeavy-v0",
     [f"torch_h100_hv0c_x4_eval_seed{k}.json" for k in range(3)], False),
)
# phase 15: PPO on each variant's recipe at full width, from the config
# headers of the JAX package's runs (docs/benchmarks/ppo_*.jsonl line 1);
# each run: (name, PPOConfig, curriculum run length in updates, warm-start
# policy file or None)
H2_REWARDS = (("agentDelta", 5.0), ("agentDistance", 0.0), ("blockDelta", 2000.0),
              ("blockDistance", 0.0))
VARIANT_TIMED_UPDATES = 0  # the resumed update 3 is the one timed
HV0_ID, HV0_ENVS = "MultiRobotPuzzleHeavy-v0", 16384  # kernel A's large class at its width
# phase 16: the env step, the image env step and the rollout as CUDA graphs,
# each replay held against the eager body (same seeds, same inputs) bit for
# bit: every variant on both ticks at the main path's width and length (v0
# fused with a reset(seed=1) after the capture, v2 with an update_goal change
# half way), Heavy-v0 at 16384 envs, a v0 and a v2 graph stepped in turn,
# the pixel path's image env, and two chained rollouts at the v0 and pixel
# recipes
GRAPH_CHANGE_AT = MAIN_STEPS // 2
GRAPH_SHORT_STEPS = 50  # Heavy-v0 at 16384 envs, the alternating pair, the image env
# phase 17: the learner as a CUDA graph: two chained updates, graph replays
# against the eager body, at the v0 recipe (default, then with target_kl set
# so that the stop fires inside the first update, on the same graphs), the
# pixel recipe and the v2 recipe
LEARNER_UPDATES = 2
LEARNER_STOP_KL = 5e-4
ADAM_CALLS = 20  # chained optimizer steps in each timed CUDA graph
# phase 6: the v0 env's control and score_respawn kernels (envs/v0_cuda.py),
# each timed per launch in a CUDA graph of ENV_LOGIC_CALLS, at v0's and
# Heavy-v0's widths, from fresh spawns, after ENV_LOGIC_STEPS random steps,
# and at a step where every env truncates (every env respawned)
ENV_LOGIC_CALLS = 20
ENV_LOGIC_STEPS = 50
ENV_LOGIC_WORLDS = ((ENV_ID, NUM_ENVS), ("MultiRobotPuzzleHeavy-v0", 16384))
# the MLP learner's minibatch gradient (mlp_grad) at the recipes' shapes:
# (obs_dim, act_dim, minibatch rows, flat batch rows, clip_range)
MLP_GRAD_SHAPES = {"v0 recipe": (28, 6, 8192, 4096 * 64, 0.2),
                   "Heavy-v0 X4 recipe": (40, 15, 16384, 16384 * 64, 0.1)}
MLP_GRAD_TOL = 5e-5  # of each leaf's largest magnitude, against PPO.loss + autograd
# phase 18: the v2 recipe's two legs as the CLI runs them, graph against eager
# side by side: CHAIN_UPDATES updates of leg 1 (the goal schedule over its
# updates), a save, a restore into fresh learners with leg 2's overrides
# (cli.leg_overrides), CHAIN_UPDATES updates of leg 2 (the schedule
# restarting over its updates); (--total_timesteps, overrides) of each leg,
# from ppo_v2_leg{1,2}_r4.jsonl
CHAIN_UPDATES = 12
CHAIN_LEGS = ((30_000_000, {}), (65_000_000, dict(ent_coef=0.002)))


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def maxdiff(a, b) -> float:
    return float((a.double() - b.double()).abs().max())


def bound(nbytes, ops, live_rows) -> dict:
    """The larger of bytes at the HBM rate and operations at the float32
    rate, in ms, with what bounds it and its parts."""
    t_bytes = nbytes / yardstick.HBM_BYTES_PER_S
    t_ops = ops / yardstick.F32_FLOPS_PER_S
    return dict(ms=1e3 * max(t_bytes, t_ops), by="bytes" if t_bytes >= t_ops else "operations",
                bytes=nbytes, ops=ops, live_rows=live_rows,
                bytes_ms=1e3 * t_bytes, ops_ms=1e3 * t_ops)


def kernel_bound(table, bf, live, vel_iters, pos_iters) -> dict:
    """Least time the card could take for one fused tick of these envs,
    counted by ``yardstick.tick_work`` from this run's inputs: ``bf`` the
    body input planes (awake or woken this tick), ``live`` [P, E] the pairs
    with manifold points and an active body."""
    planes = bf.view(len(step_cuda.B_IN), table.num_bodies, live.shape[-1])
    awake = ((planes[step_cuda.B_IN.index("awake")] > 0.5)
             | (planes[step_cuda.B_IN.index("wake")] > 0.5))
    nbytes, ops = yardstick.tick_work(table, awake, live, vel_iters, pos_iters)
    return bound(nbytes, ops, int(live.sum()))


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
           + pos_iters * yardstick.OPS_POS_SWEEP_BODY * n_dyn * int(pos.any(dim=0).sum())
           + yardstick.sweep_ops(table, vel.sum(dim=-1).tolist(), vel_iters, 0)
           + yardstick.sweep_ops(table, pos.sum(dim=-1).tolist(), 0, pos_iters))
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


def world_name(env_id, make_kw=None) -> str:
    """``env_id`` and the constructor kwargs of its world, if any."""
    return env_id + (f" ({', '.join(f'{k}={v}' for k, v in make_kw.items())})" if make_kw else "")


def spawn_tick(dev, E, seed, env_id=ENV_ID, make_kw=None):
    """(table, contacts, bodies, force, torque, wake) of E fresh spawns
    after random controls: one tick's inputs.  ``make_kw``: the world's
    constructor kwargs (v3's ``num_agents`` and ``heavy``)."""
    logic = _logic(env_id, **(make_kw or {}))
    gen = torch.Generator(device=dev).manual_seed(seed)
    state, _obs = logic.reset_fast(gen, E, logic.default_params())
    act = torch.rand((logic.cfg.act_dim, E), generator=gen, device=dev) * 2 - 1
    return (logic.layout.table, state.contacts) + logic._control(state, act)


def spawn_diffs(name, got, want, in_contact, limits=SPAWN_LIMITS) -> dict:
    """Differences over a batch of spawns, held to ``limits``; ``got`` and
    ``want`` are (pos, angle, normal impulse).  ``max`` is the largest
    position difference over all envs, so it reads the envs in contact."""
    d = (got[0] - want[0]).abs().amax(dim=(0, 1))
    free = ~in_contact
    out = dict(no_contact_max=float(d[free].max()) if bool(free.any()) else 0.0,
               median=float(d.median()), max=float(d.max()),
               angle=maxdiff(got[1], want[1]), impulse=maxdiff(got[2], want[2]),
               impulse_scale=float(want[2].abs().max()))
    report(f"{name} ({int(in_contact.sum())} envs in contact)", out, limits)
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


def f64(x):
    """A tree of tensors with its floating leaves in float64."""
    return tree_map(lambda t: t.double() if t.is_floating_point() else t, x)


def check_spawns_reach(dev, E, seed, env_id, make_kw=None) -> tuple[dict, float]:
    """Kernel A on one tick of E random spawns at 180/60 (exact trig) against
    ``world.step`` in float32, held to ``SPAWN_LIMITS`` but for the largest
    position difference; then each env beyond ``SPAWN_LIMITS['max']`` is
    solved again by both from ``REACH_COPIES`` copies of its inputs, every
    body position and angle moved by float32's epsilon times its magnitude
    (one or two units in the last place, signs at random; the first copy
    unmoved).  The kernel's outcome must be within ``SPAWN_LIMITS['max']``
    of an outcome ``world.step`` reaches from some copy, and ``world.step``'s
    within it of one the kernel reaches (``reach``): a spawn whose deep
    overlaps float32 resolves one way or another by its rounding is held to
    the outcomes float32 itself gives it (float64 ``world.step`` may keep to
    one of them: ``docs/benchmarks/torch_h100_heavy5_spawns.py``).  Prints,
    per such env, how many copies of each solve land on the kernel's outcome
    and on ``world.step``'s.  Returns (differences, plain ms)."""
    table, contacts, bodies, force, torque, wake = spawn_tick(dev, E, seed, env_id, make_kw)
    args = (table, bodies, contacts, force, torque, wake, DT, VI, PI)
    bk, ck, _ = step_cuda.step_fused(*args, incremental_trig=False)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    bp, cp, _ = world.step(*args)
    torch.cuda.synchronize()
    plain_ms = 1e3 * (time.perf_counter() - t0)
    name = (f"fused, {world_name(env_id, make_kw)} spawns E={E} 1 tick {VI}/{PI} against "
            f"world.step in float32")
    limit = SPAWN_LIMITS["max"]
    out = spawn_diffs(name, (bk.pos, bk.angle, ck.normal_impulse),
                      (bp.pos, bp.angle, cp.normal_impulse), cp.touching.any(dim=0),
                      {k: v for k, v in SPAWN_LIMITS.items() if k != "max"})
    d = (bk.pos - bp.pos).abs().amax(dim=(0, 1))
    flagged = (d > limit).nonzero().flatten()
    F, K = flagged.numel(), REACH_COPIES
    out["reach"] = 0.0
    if F:
        gen = torch.Generator(device=dev).manual_seed(seed)
        pick = lambda x: tree_map(  # noqa: E731
            lambda t: t[..., flagged].repeat_interleave(K, dim=-1).contiguous(), x)
        b, c, f, tq, w = map(pick, (bodies, contacts, force, torque, wake))
        later = ((torch.arange(F * K, device=dev) % K) > 0).float()

        def moved(t):
            sign = torch.randint(-1, 2, t.shape, generator=gen, device=dev).float()
            return t + torch.finfo(torch.float32).eps * t.abs() * sign * later

        b = b.replace(pos=moved(b.pos), angle=moved(b.angle))
        copies = lambda pos: pos.reshape(pos.shape[:2] + (F, K))  # noqa: E731
        kern = copies(step_cuda.step_fused(table, b, c, f, tq, w, DT, VI, PI,
                                           incremental_trig=False)[0].pos)
        plain = copies(world.step(table, b, c, f, tq, w, DT, VI, PI)[0].pos)
        dist = lambda own, pos: (own[..., flagged, None].double()  # noqa: E731
                                 - pos.double()).abs().amax(dim=(0, 1))
        k_own, p_own = bk.pos, bp.pos
        k_to_p = dist(k_own, plain).min(dim=-1).values
        p_to_k = dist(p_own, kern).min(dim=-1).values
        for i, e in enumerate(flagged.tolist()):
            lands = {who: (int((dist(k_own, pos)[i] <= limit).sum()),
                           int((dist(p_own, pos)[i] <= limit).sum()))
                     for who, pos in (("kernel", kern), ("world.step", plain))}
            print(f"    env {e}: kernel - world.step {float(d[e]):.3e} m; of {K} copies moved "
                  f"by float32 rounding (the first unmoved), on the kernel's outcome / on "
                  f"world.step's: " + ", ".join(f"{who} {a} / {b_}" for who, (a, b_)
                                                 in lands.items())
                  + f"; nearest world.step copy to the kernel {float(k_to_p[i]):.3e} m, "
                  f"nearest kernel copy to world.step {float(p_to_k[i]):.3e} m", flush=True)
        out["reach"] = float(torch.maximum(k_to_p, p_to_k).max())
    report(f"{name}: {F} envs beyond {limit:g} re-solved from {K} copies moved by float32 "
           f"rounding", {"reach": out["reach"]}, {"reach": limit})
    if not torch.equal(bk.awake, bp.awake):
        raise AssertionError(f"{name}: awake flags differ")
    if not all(bool(torch.isfinite(x).all()) for x in (bk.pos, bk.vel, ck.normal_impulse)):
        raise AssertionError(f"{name}: kernel output not finite")
    return out, plain_ms


def check_spawns_f64(dev, E, seed, env_id) -> tuple[dict, float]:
    """Kernel A on one tick of E random spawns at 180/60 (exact trig) against
    ``world.step`` in float32 on the same inputs, held to ``SPAWN_LIMITS``
    but for the largest position difference, and both against ``world.step``
    in float64: in every env the kernel's largest position difference from
    the float64 result may exceed the float32 plain version's by at most
    ``SPAWN_LIMITS['max']`` (``excess``).  On a large batch a spawn whose deep
    overlaps float32 cannot resolve stably (the float32 plain version itself
    1e-4 to 2e-3 m from float64, measured on Heavy-v0) sets the largest
    difference between any two float32 solves; the float64 solve says which
    of them is off.  Then the kernel on the whole batch must equal, bit for
    bit, the kernel on its consecutive ``NUM_ENVS``-env slices.  Returns
    (differences, plain float32 ms)."""
    table, contacts, bodies, force, torque, wake = spawn_tick(dev, E, seed, env_id)
    args = (table, bodies, contacts, force, torque, wake, DT, VI, PI)
    bk, ck, _ = step_cuda.step_fused(*args, incremental_trig=False)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    bp, cp, _ = world.step(*args)
    torch.cuda.synchronize()
    plain_ms = 1e3 * (time.perf_counter() - t0)
    b64 = world.step(table, f64(bodies), f64(contacts), f64(force), f64(torque), wake, DT,
                     VI, PI)[0]
    env_max = lambda a, b: (a.double() - b.double()).abs().amax(dim=(0, 1))  # noqa: E731
    d, dk, dp = env_max(bk.pos, bp.pos), env_max(bk.pos, b64.pos), env_max(bp.pos, b64.pos)
    free = ~cp.touching.any(dim=0)
    out = dict(no_contact_max=float(d[free].max()) if bool(free.any()) else 0.0,
               median=float(d.median()), max=float(d.max()), excess=float((dk - dp).max()),
               angle=maxdiff(bk.angle, bp.angle),
               impulse=maxdiff(ck.normal_impulse, cp.normal_impulse),
               impulse_scale=float(cp.normal_impulse.abs().max()))
    limits = {k: v for k, v in SPAWN_LIMITS.items() if k != "max"}
    name = (f"fused, {env_id} spawns E={E} 1 tick {VI}/{PI} against world.step in float32 and "
            f"float64 ({int((~free).sum())} envs in contact)")
    report(name, out, dict(limits, excess=SPAWN_LIMITS["max"]))
    for e in (d > SPAWN_LIMITS["max"]).nonzero().flatten().tolist():
        print(f"    env {e}: kernel - plain32 {float(d[e]):.3e}, kernel - plain64 "
              f"{float(dk[e]):.3e}, plain32 - plain64 {float(dp[e]):.3e} m", flush=True)
    print(f"    largest position difference from float64 over the {E} envs: kernel "
          f"{float(dk.max()):.3e}, plain32 {float(dp.max()):.3e} m; envs beyond "
          f"{SPAWN_LIMITS['max']:g}: kernel {int((dk > SPAWN_LIMITS['max']).sum())}, plain32 "
          f"{int((dp > SPAWN_LIMITS['max']).sum())}", flush=True)
    if not torch.equal(bk.awake, bp.awake):
        raise AssertionError(f"{name}: awake flags differ")
    if not all(bool(torch.isfinite(x).all()) for x in (bk.pos, bk.vel, ck.normal_impulse)):
        raise AssertionError(f"{name}: kernel output not finite")
    for s0 in range(0, E, NUM_ENVS):
        part = [tree_map(lambda x: x[..., s0:s0 + NUM_ENVS].contiguous(), x)
                for x in (bodies, contacts, force, torque, wake)]
        bs, cs_, _ = step_cuda.step_fused(table, *part, DT, VI, PI, incremental_trig=False)
        if not (torch.equal(bs.pos, bk.pos[..., s0:s0 + NUM_ENVS])
                and torch.equal(bs.vel, bk.vel[..., s0:s0 + NUM_ENVS])
                and torch.equal(cs_.normal_impulse, ck.normal_impulse[..., s0:s0 + NUM_ENVS])):
            raise AssertionError(f"{name}: envs {s0}-{s0 + NUM_ENVS - 1} differ from a launch "
                                 f"of those {NUM_ENVS} envs alone")
    print(f"    the kernel on {E} envs equal bit for bit to {E // NUM_ENVS} launches of "
          f"{NUM_ENVS}", flush=True)
    return out, plain_ms


def spawn_solve_args(dev, E, seed, env_id, vi=VI, pi=PI, make_kw=None):
    """(table, solve args) of E spawns one tick in: the first tick goes
    through the fused kernel, so the second tick's constraints carry
    impulses to warm start from."""
    table, contacts, bodies, force, torque, wake = spawn_tick(dev, E, seed, env_id, make_kw)
    bodies, contacts, _ = step_cuda.step_fused(table, bodies, contacts, force, torque, wake,
                                               DT, vi, pi)
    solve_args, _carry = world.before_solve(table, bodies, contacts, force, torque, wake, DT)
    return table, solve_args


def check_solve_kernel(dev, env_id, E, seed, vi=VI, pi=PI, make_kw=None) -> tuple[dict, float]:
    """The contact-solve kernel against its plain version on the constraints
    of E spawns after the PyTorch prologue: exact trig within the spawn
    limits, incremental against exact.  Returns (differences, plain ms)."""
    table, solve_args = spawn_solve_args(dev, E, seed, env_id, vi, pi, make_kw)
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
    name = f"solve, {world_name(env_id, make_kw)} spawns E={E} {vi}/{pi}"
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
    and 180/60 (``env.step``, CUDA graph replays), with the launch counts set to 0
    just before and read just after: the path's kernel must have run steps x
    frameskip times and the other kernel not at all.  Returns the launches,
    the rate, and the env and its state at the end."""
    env = make(env_id, num_envs=NUM_ENVS, backend=backend)
    if env.device.type != "cuda":
        raise AssertionError(f"make() defaulted to {env.device}")
    state, obs = env.reset(seed=0)
    gen = torch.Generator(device=dev).manual_seed(1)
    acts = torch.rand((steps + 10, NUM_ENVS, env.cfg.act_dim), generator=gen,
                      device=dev) * 2 - 1
    for k in range(10):  # warm-up (the first step captures the graph)
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


def time_kernels(dev, env_id, card_line, E=NUM_ENVS) -> dict:
    """Both kernels' time per launch on E spawns of one variant at 180/60
    (the solve kernel on the second tick's constraints), with their bounds."""
    table, contacts, bodies, force, torque, wake = spawn_tick(dev, E, 0, env_id)
    bf, pf, pi = step_cuda.pack(bodies, contacts, force, torque, wake)
    fused = lambda: step_cuda.launch(table, bf, pf, pi, DT, VI, PI)
    fused()
    fused_ms = cuda_ms(fused, 10)
    live = cb.live_pairs(table, bodies, contacts, force, torque, wake, DT)
    fused_bound = kernel_bound(table, bf, live, VI, PI)
    fused_live = live_line(live, step_cuda.KERNEL)

    table, solve_args = spawn_solve_args(dev, E, 0, env_id)
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
              f"{b['live_rows']} live rows; {E} envs {VI}/{PI}  "
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


def train_and_resume(algo_fn, card_line, timed_updates, what, init_fn=None,
                     n_updates=None) -> tuple:
    """``TRAIN_UPDATES`` updates of the learner ``algo_fn()`` builds, from the
    state ``init_fn(learner)`` makes (default ``learner.init_state()``), with
    the launch counts set to 0 just before and read just after: exactly
    ``n_steps x frameskip`` launches per update of the kernel of the
    learner's ``env_backend`` (the fused tick kernel for ``'fused'``, the
    solve kernel for ``'pallas'``) and none of the other.  With
    ``n_updates`` each update is preceded by ``apply_curriculum(ts, update,
    n_updates)``, as ``PPO.learn`` runs it over a run of that many updates.
    A save after update 2 restored into a fresh learner must reproduce update
    3 bit for bit (``env_params``, the curriculum's state, included); then
    ``timed_updates`` more updates, each split by part (the resumed one is
    timed too).  Returns (the fresh learner, its state, the launches of each
    kernel in the counted updates, each update's wall seconds and the
    splits)."""
    algo = algo_fn()
    on_card(algo, what)
    cfg = algo.cfg
    per_update = cfg.n_steps * cfg.n_envs
    init_fn = init_fn or (lambda learner: learner.init_state())
    curriculum = ((lambda learner, ts, u: learner.apply_curriculum(ts, u, n_updates))
                  if n_updates else (lambda learner, ts, u: ts))
    ts = init_fn(algo)
    steps0 = ckpt.step_count(ts.timesteps)
    params0 = {k: v.clone() for k, v in ts.params.items()}
    torch.cuda.synchronize()
    cb.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=cb.BUILD_DIR) as tmp:
        step_cuda.reset_launch_count()
        walls = []
        for u in range(TRAIN_UPDATES):
            t0 = time.perf_counter()
            ts = curriculum(algo, ts, u)
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
        n = TRAIN_UPDATES * cfg.n_steps * algo.env.cfg.frameskip
        want = ({"step_fused": n, "solve_contacts": 0} if cfg.env_backend == "fused"
                else {"step_fused": 0, "solve_contacts": n})
        if launches != want:
            raise AssertionError(f"{what}: launches {launches}, expected {want} "
                                 f"(env_backend {cfg.env_backend!r})")
        if (ts.timesteps.dtype != torch.int64
                or int(ts.timesteps) != steps0 + TRAIN_UPDATES * per_update):
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
    rs = curriculum(fresh, rs, TRAIN_UPDATES - 1)
    rs, rmetrics = fresh.train_step(rs, timer=timer)
    diff = (tree_diff(ckpt.to_tree(rs), ckpt.to_tree(ts), "state")
            + tree_diff(ckpt.to_tree(rmetrics), ckpt.to_tree(metrics), "metrics"))
    if diff:
        raise AssertionError(f"{what}: the resumed update {TRAIN_UPDATES} differs in {diff}")
    print(f"  resume: saved after update {TRAIN_UPDATES - 1} (step {saved_at}), restored into a "
          f"fresh learner: update {TRAIN_UPDATES} equal bit for bit (params, Adam state, "
          f"normalizer, env state, generators, env_params, metrics)  [{card_line}]", flush=True)
    splits = [timer.seconds]
    for k in range(timed_updates):
        timer = PhaseTimer(fresh.device)
        rs = curriculum(fresh, rs, TRAIN_UPDATES + k)
        rs, _ = fresh.train_step(rs, timer=timer)
        splits.append(timer.seconds)
    for k, sp in enumerate(splits):
        total = sum(sp.values())
        print(f"  timed update {TRAIN_UPDATES + k}: {total:.3f} s = "
              + ", ".join(f"{name} {sec:.3f} s ({sec / total:.1%})" for name, sec in sp.items())
              + f"  [{card_line}]", flush=True)
    return fresh, rs, launches, walls, splits


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
    launches = train_and_resume(lambda: PPO(cfg), card_line, TIMED_UPDATES, "train")[2]
    return launches["step_fused"]


def check_policy(npz, env_id, n_episodes, max_steps, card_line) -> dict:
    """A committed policy file on ``env_id``: its deterministic actions on the
    obs of ``n_episodes`` reference resets on the card against the CPU (the
    clipped actions, and the unclipped means relative to max(1, |mean|),
    within ``ACTION_TOL``), then ``n_episodes`` deterministic episodes of at
    most ``max_steps`` steps through ``evaluate_policy_batched`` (fused,
    180/60), launches counted: exactly one of the fused tick kernel per env
    step the eval takes (``max_steps`` plus the reference reset's random step,
    unless every lane ended earlier, at a chunk's end) and none of the solve
    kernel.  Returns the eval's numbers."""
    cfg = PPOConfig(env_id=env_id, n_envs=1, n_steps=2, batch_size=2, n_epochs=1)
    algo, algo_cpu = PPO(cfg), PPO(cfg, device="cpu")
    on_card(algo, "the eval learner")
    st = ckpt.restore_policy(npz, algo.init_state())
    st_cpu = ckpt.restore_policy(npz, algo_cpu.init_state())
    # the obs of the resets (one random step from a spawn)
    _state, obs = make(env_id, num_envs=n_episodes, reset_mode="reference",
                       device=algo.device).reset(seed=0)
    with torch.no_grad():
        got = evaluate.policy_action(algo, st.params, st.normalizer, obs, True)
        want = evaluate.policy_action(algo_cpu, st_cpu.params, st_cpu.normalizer, obs.cpu(), True)
        raw = [a.apply(s.params, nrm.normalize_obs(s.normalizer, o, update=False)[1])[0]
               for a, s, o in ((algo, st, obs), (algo_cpu, st_cpu, obs.cpu()))]
    err = maxdiff(got.cpu(), want)
    raw_err = float(((raw[0].cpu() - raw[1]).abs() / raw[1].abs().clamp_min(1.0)).max())
    print(f"  {env_id}: deterministic actions of {Path(npz).name} on the obs of {n_episodes} "
          f"resets, card against CPU: max abs diff {err:.3e} (limit {ACTION_TOL:g}); unclipped "
          f"means {raw_err:.3e} relative to max(1, |mean|) (limit {ACTION_TOL:g}); "
          f"{float((want.abs() >= 1).float().mean()):.3f} of the actions at the clip  "
          f"[{card_line}]", flush=True)
    if not (err <= ACTION_TOL and raw_err <= ACTION_TOL):
        raise AssertionError(f"eval {env_id}: the card's actions differ from the CPU's")

    torch.cuda.synchronize()
    step_cuda.reset_launch_count()
    t0 = time.perf_counter()
    ret_mean, ret_std, returns, lengths, statuses = evaluate.evaluate_policy_batched(
        algo, st, n_episodes=n_episodes, deterministic=True, seed=0, max_steps=max_steps)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts()
    lengths, statuses = np.asarray(lengths), np.asarray(statuses)
    shares = {int(k): float((statuses == k).mean()) for k in np.unique(statuses)}
    share = shares.get(3, 0.0)  # done_status 3: success
    # the eval stops at the first chunk's end where every lane has ended
    chunk = min(200, max_steps)
    steps = min(max_steps, -(-int(lengths.max()) // chunk) * chunk) + 1
    print(f"  {env_id}: {n_episodes} deterministic episodes (max {max_steps} steps, fused, "
          f"{VI}/{PI}): mean return {ret_mean:.2f}, std {ret_std:.2f}, completions "
          f"(done_status 3) {int((statuses == 3).sum())}/{n_episodes} = {share:.4f}; "
          f"done_status shares {shares}; shorter than {max_steps} steps: "
          f"{int((lengths < max_steps).sum())}; median length {float(np.median(lengths)):.0f}; "
          f"{wall:.1f} s wall ({steps} env steps, {1e3 * wall / steps:.2f} ms each); launches "
          f"{launches}  [{card_line}]", flush=True)
    if launches != {"step_fused": steps, "solve_contacts": 0}:
        raise AssertionError(f"eval {env_id}: launches {launches}, expected {steps} of "
                             "step_fused (one per env step) and none of solve_contacts")
    if not (np.isfinite(returns).all() and lengths.min() >= 1):
        raise AssertionError(f"eval {env_id}: non-finite returns or empty episodes")
    return dict(mean=ret_mean, std=ret_std, share=share, shares=shares, wall=wall,
                steps=steps, launches=launches["step_fused"], err=max(err, raw_err))


def run_eval(card_line):
    """Phase 8: the committed v0 policy through :func:`check_policy`, held to
    the bands around the JAX package's record."""
    out = check_policy(POLICY_NPZ, ENV_ID, EVAL_EPISODES, EVAL_MAX_STEPS, card_line)
    print(f"  completion share band {COMPLETION_BAND}, mean return band {RETURN_BAND}  "
          f"[{card_line}]", flush=True)
    if not (COMPLETION_BAND[0] <= out["share"] <= COMPLETION_BAND[1]
            and RETURN_BAND[0] <= out["mean"] <= RETURN_BAND[1]):
        raise AssertionError("eval: the committed policy left its bands")


def record_band(records, n) -> tuple:
    """The JAX package's records of a policy (``docs/benchmarks`` eval files,
    one per seed): (pooled mean, population sd, episodes, and the band
    pooled mean +- 3 sqrt(sd^2 / n_jax + sd^2 / n)), three standard errors
    of the difference between the records' mean and that of ``n`` new
    episodes."""
    returns = np.concatenate([json.loads((RECORDS / f).read_text())["returns"]
                              for f in records]).astype(np.float64)
    mean, sd, n_jax = float(returns.mean()), float(returns.std()), len(returns)
    half = 3.0 * float(np.sqrt(sd ** 2 / n_jax + sd ** 2 / n))
    return mean, sd, n_jax, (mean - half, mean + half)


def run_variant_evals(card_line) -> int:
    """Phase 14: each of the JAX package's variant policies
    (``VARIANT_POLICIES``) and of the port's own (``PORT_POLICIES``) through
    :func:`check_policy` at its registered episode limit: the mean return
    inside the band around its record (:func:`record_band`), and above the
    registered ``reward_threshold`` where the JAX package met it.
    Returns the fused kernel's launches."""
    total = 0
    for npz, env_id, records, gate_threshold in VARIANT_POLICIES + PORT_POLICIES:
        max_steps = VARIANT_CFGS[env_id].max_episode_steps
        out = check_policy(POLICY_DIR / npz, env_id, VARIANT_EVAL_EPISODES, max_steps,
                           card_line)
        total += out["launches"]
        mean, sd, n_jax, band = record_band(records, VARIANT_EVAL_EPISODES)
        threshold = VARIANT_CFGS[env_id].reward_threshold
        print(f"  {npz}: mean return {out['mean']:.2f} against the record's pooled mean "
              f"{mean:.1f} (sd {sd:.1f}, {n_jax} episodes): band [{band[0]:.1f}, {band[1]:.1f}]; "
              f"reward_threshold {threshold:g} "
              f"({'held' if gate_threshold else 'not held: unmet by the JAX package too'})  "
              f"[{card_line}]", flush=True)
        if not band[0] <= out["mean"] <= band[1]:
            raise AssertionError(f"eval {npz}: mean return {out['mean']:.2f} outside the band "
                                 f"{band}")
        if gate_threshold and not out["mean"] > threshold:
            raise AssertionError(f"eval {npz}: mean return {out['mean']:.2f} not above the "
                                 f"reward_threshold {threshold}")
    return total


def variant_recipes() -> list:
    """Phase 15's runs: the v2 recipe (``ppo_v2_leg1_r4.jsonl``: the v2 config
    at 4096 envs, n_steps 64, batch 8192, 4 epochs, seed 3, ``update_goal``
    over the leg's 114 updates), the same on Heavy-v2 (``ppo_hv2_leg1_r4``),
    the Heavy-v0 H2 recipe (``ppo_hv0_H2_r5.jsonl``: 16384 envs, n_steps 32,
    batch 32768, the reward overrides, a 1100-step horizon, 572 updates),
    warm-started as that recipe is, from the JAX X4 policy, and v3 on the
    staged tick (the v3 config at 4096 / 64 / 8192 / 4, seed 17, ``env_backend='pallas'``:
    the JAX package's first v3 run, docs/BENCHMARKS.md)."""
    def load(name):
        return json.loads((ROOT / "train_configs" / name).read_text())
    width = dict(n_envs=NUM_ENVS, n_steps=64, batch_size=8192, n_epochs=4)
    v2 = dict(width, seed=3, update_goal=True, env_backend="fused")
    return [
        ("v2", PPOConfig.from_reference_json(load("ppo-mrp-v2.json"), **v2), 114, None),
        ("Heavy-v2", PPOConfig.from_reference_json(load("ppo-mrp-v2.json"),
                                                   env_id="MultiRobotPuzzleHeavy-v2", **v2),
         114, None),
        ("Heavy-v0", PPOConfig(env_id="MultiRobotPuzzleHeavy-v0", n_envs=16384, n_steps=32,
                               batch_size=32768, n_epochs=4, learning_rate=2.5e-4, gamma=0.997,
                               clip_range=0.1, ent_coef=0.001, reward_params=H2_REWARDS,
                               max_episode_steps=1100, seed=0, env_backend="fused"),
         572, "MultiRobotPuzzleHeavy-v0_best_r4.npz"),
        ("v3 staged", PPOConfig.from_reference_json(load("ppo-mrp-v3.json"), **width, seed=17,
                                                    env_backend="pallas"), None, None),
    ]


def run_variant_training(card_line) -> dict:
    """Phase 15: each of :func:`variant_recipes` through
    :func:`train_and_resume` (3 updates with each kernel's launches counted,
    the resumed update 3 bitwise, ``env_params`` included, and split by
    part).  Returns each kernel's launches over the counted updates of all
    runs."""
    total = {"step_fused": 0, "solve_contacts": 0}
    for name, cfg, n_updates, warm in variant_recipes():
        print(f"  {name}: {cfg.env_id} n_envs {cfg.n_envs} n_steps {cfg.n_steps} batch "
              f"{cfg.batch_size} epochs {cfg.n_epochs} lr {cfg.learning_rate:.6g} gamma "
              f"{cfg.gamma} clip {cfg.clip_range} ent {cfg.ent_coef:.6g} seed {cfg.seed} "
              f"backend {cfg.env_backend} update_goal {cfg.update_goal} reward_params "
              f"{dict(cfg.reward_params)} max_episode_steps {cfg.max_episode_steps} "
              f"curriculum over {n_updates} updates; warm start {warm}  [{card_line}]",
              flush=True)
        init_fn = None
        if warm is not None:
            def init_fn(learner, path=POLICY_DIR / warm):
                return ckpt.restore_policy(path, learner.init_state())
        t0 = time.perf_counter()
        _algo, ts, launches, walls, splits = train_and_resume(
            lambda cfg=cfg: PPO(cfg), card_line, VARIANT_TIMED_UPDATES, f"PPO {name}",
            init_fn=init_fn, n_updates=n_updates)
        per_update = cfg.n_steps * cfg.n_envs
        print(f"  {name}: {len(walls)} updates at {', '.join(f'{w:.3f}' for w in walls)} s; "
              f"{len(walls) * per_update / sum(walls):,.0f} env-steps/s including the learner; "
              f"timed update {sum(splits[0].values()):.3f} s; launches {launches}; "
              f"env_params after update {TRAIN_UPDATES}: scaled_epsilon "
              f"{ts.env_params.scaled_epsilon:.6g}, weight_delta_block "
              f"{ts.env_params.weight_delta_block:g}; {time.perf_counter() - t0:.1f} s in all  "
              f"[{card_line}]", flush=True)
        for k in total:
            total[k] += launches[k]
    return total


def tree_map(fn, x):
    """``fn`` on every tensor of a dataclass tree (other leaves kept)."""
    if dataclasses.is_dataclass(x):
        return type(x)(**{f.name: tree_map(fn, getattr(x, f.name))
                          for f in dataclasses.fields(x)})
    if isinstance(x, dict):
        return {k: tree_map(fn, v) for k, v in x.items()}
    if isinstance(x, tuple):
        return tuple(tree_map(fn, v) for v in x)
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
                                              "CNN PPO")[:3]
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = flags
    print(f"  obs {tuple(ts.last_obs.shape)} {ts.last_obs.dtype}; "
          f"{sum(v.numel() for v in ts.params.values())} params; timed parts: rollout = one "
          f"CUDA graph of {cfg.n_steps} steps (physics: fused tick kernel, "
          f"{algo.env.cfg.frameskip} launches per step; render and stacks; policy; reward "
          f"bookkeeping), update = the learner's CUDA graph (bootstrap value, GAE, "
          f"{cfg.n_epochs} epochs of {cfg.n_steps * cfg.n_envs // cfg.batch_size} minibatches, "
          f"metrics)", flush=True)
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
    live = cb.live_pairs(table, bodies, contacts, force, torque, wake, DT)
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
    live = cb.live_pairs(table, *one, DT)
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
            # the statistics, one per minibatch, the losses and the completions
            want_calls = DIST_UPDATES * (3 + cfg.n_epochs * total // cfg.batch_size)
            if calls != want_calls:
                raise AssertionError(f"{calls} all-reduces in {DIST_UPDATES} updates, expected "
                                     f"{want_calls}")
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

# --------------------------------------------------------------------------
# phase 16: CUDA graphs against their eager bodies
# --------------------------------------------------------------------------

_BITS = {torch.float32: torch.int32, torch.float64: torch.int64, torch.bfloat16: torch.int16,
         torch.float16: torch.int16, torch.bool: torch.uint8}


def mismatches(a, b) -> torch.Tensor:
    """The elements in which two trees of tensors differ in their bits (a
    device count, no host read); raises if the trees differ in structure."""
    la, sa = cuda_graph.flatten(a)
    lb, sb = cuda_graph.flatten(b)
    if sa != sb:
        raise AssertionError("the graph's outputs and the eager body's differ in structure")
    bits = lambda x: x.view(_BITS.get(x.dtype, x.dtype))  # noqa: E731
    return sum(((bits(x) != bits(y)).sum() for x, y in zip(la, lb)),
               torch.zeros((), dtype=torch.int64, device=la[0].device))


def replay_against_eager(dev, card_line, pairs, steps, what, backend, change=None,
                         reseed_at=None):
    """Step each (graphed env, eager twin) of ``pairs`` ``steps`` times in
    turn, from the same reset and random actions: the graphed env through
    ``step`` (CUDA graph replays), the twin through ``step_eager``; every
    output (state, obs, reward, done, info; frames) held equal bit for bit.
    ``change = (k, fn)`` replaces the reward params by ``fn(params)`` before
    step k; ``reseed_at`` reseeds both envs with ``reset(seed=1)`` before that
    step.  Launch counts set to 0 just before and read just after: two
    launches of ``backend``'s kernel per tick (replay and eager) and none of
    the other; each graph holds ``frameskip`` launches, and at v0 and
    Heavy-v0 one of each of the env logic's kernels (``envs/v0_cuda.py``)."""
    states, acts, params = [], [], []
    gen = torch.Generator(device=dev).manual_seed(1)
    for graphed, eager in pairs:
        g = graphed.reset(seed=0)
        e = eager.reset(seed=0)
        if int(mismatches(g, e)):
            raise AssertionError(f"{what}: the two resets differ")
        states.append([g[0], e[0]])
        E, A = graphed.num_envs, graphed.cfg.act_dim
        acts.append(torch.rand((steps, E, A), generator=gen, device=dev) * 2 - 1)
        params.append(graphed.default_params())
    torch.cuda.synchronize()
    step_cuda.reset_launch_count()
    bad = torch.zeros((), dtype=torch.int64, device=dev)
    t0 = time.perf_counter()
    for k in range(steps):
        for i, (graphed, eager) in enumerate(pairs):
            if k == reseed_at:
                states[i] = [graphed.reset(seed=1, params=params[i])[0],
                             eager.reset(seed=1, params=params[i])[0]]
            if change is not None and k == change[0]:
                params[i] = change[1](params[i])
            g = graphed.step(states[i][0], acts[i][k], params[i])
            e = eager.step_eager(states[i][1], acts[i][k], params[i])
            bad += mismatches(g, e)
            states[i] = [g[0], e[0]]
    n_bad = int(bad)
    wall = time.perf_counter() - t0
    launches = launch_counts()
    mine, other = (("step_fused", "solve_contacts") if backend == "fused"
                   else ("solve_contacts", "step_fused"))
    want = 2 * steps * sum(graphed.cfg.frameskip for graphed, _ in pairs)
    held = [graphed._graph.launches for graphed, _ in pairs]
    print(f"  {what}: {steps} steps of replay against the eager body, {n_bad} elements "
          f"differ; launches {launches} (graphs hold {held}); {wall:.2f} s  [{card_line}]",
          flush=True)
    if n_bad:
        raise AssertionError(f"{what}: replays differ from the eager body in {n_bad} elements")
    env_kernels = lambda env: ({v0_cuda.CONTROL.name: 1, v0_cuda.SCORE.name: 1}  # noqa: E731
                               if env.logic.fused_logic(dev) else {})
    if launches[mine] != want or launches[other] != 0 or any(
            h != {mine: graphed.cfg.frameskip, **env_kernels(graphed)}
            for h, (graphed, _) in zip(held, pairs)):
        raise AssertionError(f"{what}: launches {launches}, graphs {held}; expected {want} "
                             f"of {mine}")
    return n_bad


def graphed_pair(env_id, backend, E=NUM_ENVS, make_kw=None):
    kw = dict(num_envs=E, backend=backend, **(make_kw or {}))
    return make(env_id, **kw), make(env_id, **kw)


ROLLOUT_FIELDS = ("normalizer", "vstate", "last_obs", "ep_return", "ep_len", "stat_return",
                  "stat_count")


def rollout_against_eager(cfg, card_line, what) -> dict:
    """Two chained rollouts of a fresh learner at ``cfg``: ``PPO.rollout`` (one
    CUDA graph replay each, the second from the first's outputs) against
    ``PPO.rollout_eager`` from the same states, noise and env generator
    state; the learner state, Transition and bootstrap value equal bit for
    bit; launches counted just around the replays (n_steps x frameskip of the
    learner's kernel per replay)."""
    algo = PPO(cfg)
    ts = algo.init_state()
    gen_state = algo.env.generator.get_state()
    noises = [torch.randn((cfg.n_steps, cfg.n_envs, algo.act_dim), generator=ts.generator,
                          device=algo.device) for _ in range(2)]
    torch.cuda.synchronize()
    step_cuda.reset_launch_count()
    t0 = time.perf_counter()
    got, gts = [], ts
    for noise in noises:
        gts, traj, value = algo.rollout(gts, noise)
        # the Transition is the graph's buffer, which the next replay refills
        got.append(([getattr(gts, f) for f in ROLLOUT_FIELDS], tree_map(torch.clone, traj),
                    value))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts()
    algo.env.generator.set_state(gen_state)
    bad, ets = torch.zeros((), dtype=torch.int64, device=algo.device), ts
    for noise, g in zip(noises, got):
        ets, traj, value = algo.rollout_eager(ets, noise)
        bad += mismatches(g, ([getattr(ets, f) for f in ROLLOUT_FIELDS], traj, value))
    n_bad = int(bad)
    n = 2 * cfg.n_steps * algo.env.cfg.frameskip
    want = ({"step_fused": n, "solve_contacts": 0} if cfg.env_backend == "fused"
            else {"step_fused": 0, "solve_contacts": n})
    print(f"  {what}: 2 chained rollouts of {cfg.n_steps} steps x {cfg.n_envs} envs, CUDA "
          f"graph replays against the eager body: {n_bad} elements differ; launches "
          f"{launches}; {wall:.2f} s for the replays (the first captures)  [{card_line}]",
          flush=True)
    if n_bad:
        raise AssertionError(f"{what}: rollout replays differ from the eager body")
    if launches != want:
        raise AssertionError(f"{what}: launches {launches}, expected {want}")
    return dict(launches=launches)


def check_adam_fused(algo, card_line, what) -> dict:
    """Phase 17: the fused optimizer step (``ppo.adam_freeze_step`` on the
    card: ``train/adam_fused.py``) against its plain version
    (``ppo.adam_freeze_plain``) at the leaves of ``algo``'s network, params,
    gradients and moments drawn on the card (the 4-d gradients
    channels-last, as autograd gives the convolutions'), Adam's count 41:
    every element bit for bit with the clip inactive (the gradients' norm a
    tenth of ``max_grad_norm``), within 1e-6 of each leaf's largest
    magnitude with it active (a hundred times), a frozen step returning
    every input bit; then ``ADAM_CALLS`` chained steps of each captured in
    one CUDA graph and replayed: ms per step beside the bound."""
    dev = algo.device
    on_card(algo, what)
    shapes = {k: v.shape for k, v in algo.net.state_dict().items()}
    n = sum(int(np.prod(s)) for s in shapes.values())
    hp = cuda_graph.as_device_scalars(HParams.from_config(algo.cfg), dev)
    gen = torch.Generator(device=dev).manual_seed(41)
    randn = lambda s, a: torch.randn(s, generator=gen, device=dev) * a  # noqa: E731
    params = {k: randn(s, 1.0) for k, s in shapes.items()}

    def inputs(norm):
        scale = norm / n ** 0.5
        grads = [randn(s, scale) for s in shapes.values()]
        grads = [g.to(memory_format=torch.channels_last) if g.dim() == 4 else g
                 for g in grads]
        opt = AdamState(mu={k: randn(s, 0.1 * scale) for k, s in shapes.items()},
                        nu={k: randn(s, 0.1 * scale) ** 2 for k, s in shapes.items()},
                        count=torch.tensor(41, dtype=torch.int32, device=dev))
        return grads, opt

    def flags(stop):  # stop, kl, kl_last
        return tuple(torch.tensor(x, device=dev) for x in (stop, 0.004, 0.002))

    tree = lambda out: (out[0], out[1].mu, out[1].nu, out[1].count, out[2], out[3])  # noqa: E731
    mgn = float(algo.cfg.max_grad_norm)
    out = dict(params=n)
    for case, norm in (("inactive", 0.1 * mgn), ("active", 100.0 * mgn)):
        grads, opt = inputs(norm)
        got = tree(adam_freeze_step(params, grads, opt, *flags(False), hp))
        want = tree(adam_freeze_plain(params, grads, opt, *flags(False), hp))
        bad = int(mismatches(got, want))
        rel = max(float((x - y).abs().max()) / max(float(y.abs().max()), 1e-30)
                  for x, y in zip(cuda_graph.flatten(got)[0], cuda_graph.flatten(want)[0])
                  if x.dtype == torch.float32)
        out[case] = dict(differ=bad, rel=rel)
    frozen = tree(adam_freeze_step(params, grads, opt, *flags(True), hp))
    out["frozen_differ"] = int(mismatches(frozen, tree((params, opt, *flags(True)[::2]))))

    def graphed(step):
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            step(params, grads, opt, *flags(False), hp)
        torch.cuda.current_stream(dev).wait_stream(side)
        stop, kl, kl_last = flags(False)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            p, o, s, k = params, opt, stop, kl_last
            for _ in range(ADAM_CALLS):
                p, o, s, k = step(p, grads, o, s, kl, k, hp)
        del p, o, s, k
        graph.replay()
        torch.cuda.synchronize(dev)
        return cuda_ms(graph.replay, 5) / ADAM_CALLS

    before = cb.launch_count("adam_fused")
    out["ms"] = graphed(adam_freeze_step)
    out["capture_launches"] = cb.launch_count("adam_fused") - before
    out["plain_ms"] = graphed(adam_freeze_plain)
    out["bound_ms"] = 1e3 * 7 * 4 * n / yardstick.HBM_BYTES_PER_S
    print(f"  adam_fused at the {what}'s {len(shapes)} leaves, {n:,} parameters: clip inactive "
          f"{out['inactive']['differ']} elements differ from the plain version, clip active "
          f"largest difference {out['active']['rel']:.2e} of its leaf's largest magnitude "
          f"({out['active']['differ']} elements differ), frozen {out['frozen_differ']} differ "
          f"from the inputs; {out['ms'] * 1e3:.1f} us per step in a graph of {ADAM_CALLS} "
          f"(bound {out['bound_ms'] * 1e3:.2f} us: 7 float32 words per parameter at 3.35 TB/s), "
          f"plain version {out['plain_ms'] * 1e3:.1f} us  [{card_line}]", flush=True)
    if out["inactive"]["differ"] or out["frozen_differ"] or not out["active"]["rel"] <= 1e-6:
        raise AssertionError(f"adam_fused at the {what}: {out}")
    if out["capture_launches"] != 2 * (ADAM_CALLS + 1):
        raise AssertionError(f"adam_fused at the {what}: {out['capture_launches']} launches "
                             f"counted, expected {2 * (ADAM_CALLS + 1)}")
    return out


def mlp_grad_case(dev, D, A, M, N, clip) -> tuple:
    """(net, params, batch, idx, hp) of a 256 x 256 ActorCritic at obs_dim
    ``D`` and act_dim ``A`` on the card: a log-std and a mean head large
    enough for real gradients, a flat batch of ``N`` rows and a minibatch of
    ``M`` of them, the old log-probs set so that the ratios fall across the
    clip range ``clip``, none within 1e-3 of a bound (where the kernels'
    round-off and ATen's could put a row on either side)."""
    gen = torch.Generator(device=dev).manual_seed(21)
    randn = lambda *s: torch.randn(s, generator=gen, device=dev)  # noqa: E731
    net = ActorCritic(D, A, (256, 256), torch.Generator().manual_seed(21)).to(dev)
    params = {k: v.detach().clone() for k, v in net.state_dict().items()}
    params["log_std"] += 0.3 * randn(A)
    params["mean.weight"] *= 30.0
    obs, act, adv = randn(N, D), randn(N, A), 2.0 * randn(N) + 0.3
    idx = torch.randperm(N, generator=gen, device=dev)[:M]
    with torch.no_grad():
        mean, log_std, value = functional_call(net, params, (obs,))
        ratio = 0.5 + 1.1 * torch.rand(N, generator=gen, device=dev)
        for bound in (1.0 - clip, 1.0 + clip):
            ratio = torch.where((ratio - bound).abs() < 1e-3, ratio + 2e-3, ratio)
        olp = gaussian_log_prob(mean, log_std, act) - torch.log(ratio)
    batch = (obs, act, olp.contiguous(), adv, (value + randn(N)).contiguous())
    hp = cuda_graph.as_device_scalars(HParams.from_config(PPOConfig(clip_range=clip)), dev)
    return net, params, batch, idx, hp


def check_mlp_grad(card_line) -> dict:
    """Phase 17: the MLP learner's minibatch gradient chain
    (``train/mlp_grad.py``) against its plain version, ``PPO.loss`` +
    ``torch.autograd.grad``, on the card at each of ``MLP_GRAD_SHAPES``
    (256 x 256 trunk; weights, batch and minibatch rows drawn on the card, the
    old log-probs set so that the ratios fall across the clip range): every
    leaf within ``MLP_GRAD_TOL`` of its largest magnitude, the losses and KL
    within 1e-5; then ``ADAM_CALLS`` calls of each in one CUDA graph: us per
    minibatch beside the bound (the float32 FMA-operations of the products
    at 67 TFLOP/s) and the three trunk GEMMs alone."""
    dev = torch.device("cuda")
    out = {}
    for what, shape in MLP_GRAD_SHAPES.items():
        D, A, M, N, _clip = shape
        net, params, batch, idx, hp = mlp_grad_case(dev, *shape)
        algo = SimpleNamespace(apply=lambda p, o: functional_call(net, p, (o,)))

        def plain():
            p = {k: v.detach().requires_grad_() for k, v in params.items()}
            loss, (pg, vl, ent, kl) = PPO.loss(algo, p, *(x[idx] for x in batch), hp)
            grads = torch.autograd.grad(loss, list(p.values()))
            return list(grads), torch.stack([loss.detach(), pg, vl, ent]), kl

        def chain():
            return mlp_grad.launch(params, batch, idx, hp)

        got, want = chain(), plain()
        rel = max(float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
                  for a, b in zip(got[0], want[0]))
        loss_err = max(abs(a - b) / max(abs(b), 1.0) for a, b in zip(
            torch.cat([got[1], got[2][None]]).tolist(), torch.cat([want[1], want[2][None]]).tolist()))
        W2 = params["trunk.1.weight"]
        h1, dz2 = torch.randn(M, 256, device=dev), torch.randn(M, 256, device=dev)

        def gemms():
            torch.mm(h1, W2.t()), torch.mm(dz2.t(), h1), torch.mm(dz2, W2)

        def graphed(fn):
            side = torch.cuda.Stream(dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):
                fn()
            torch.cuda.current_stream(dev).wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                for _ in range(ADAM_CALLS):
                    fn()
            graph.replay()
            torch.cuda.synchronize(dev)
            return cuda_ms(graph.replay, 5) / ADAM_CALLS

        flops = 2 * M * 256 * (3 * 256 + 2 * D + 3 * (A + 1))
        r = dict(rel=rel, loss_err=loss_err, us=1e3 * graphed(chain),
                 plain_us=1e3 * graphed(plain), gemm_us=1e3 * graphed(gemms),
                 bound_us=1e6 * flops / yardstick.F32_FLOPS_PER_S, flops=flops)
        out[what] = r
        print(f"  mlp_grad at the {what} (obs {D}, act {A}, {M} of {N} rows): largest leaf "
              f"difference {rel:.2e} of its leaf's largest magnitude, losses and KL {loss_err:.2e}"
              f" from PPO.loss + autograd; {r['us']:.1f} us per minibatch in a graph of "
              f"{ADAM_CALLS} (bound {r['bound_us']:.1f} us: {flops / 1e9:.2f} GFLOP at 67 "
              f"TFLOP/s; the three trunk GEMMs alone {r['gemm_us']:.1f} us), plain version "
              f"{r['plain_us']:.1f} us  [{card_line}]", flush=True)
        if not (rel <= MLP_GRAD_TOL and loss_err <= 1e-5):
            raise AssertionError(f"mlp_grad at the {what}: {r}")
    return out


def env_logic_bytes(logic, E: int, respawned: int) -> tuple[int, int]:
    """(control's, score_respawn's) bytes: each plane the kernel reads or
    writes counted once, a respawned env's columns for ``respawned`` envs."""
    A, B = logic.cfg.num_agents, logic.layout.table.num_bodies
    P, D = logic.layout.table.num_pairs, logic.cfg.obs_dim
    a0 = B - A
    # control: the action, the block's and agents' centres, the walls' and
    # the block's vel and omega, agent_dist; vel', omega', force, torque, wake
    control = E * (4 * (3 * A + 2 * (1 + A) + 3 * a0 + A + 6 * B) + B)
    # score: the block's and agents' centres, the block's angle, the goal, the
    # previous distances, blks and t, the contact flags; obs, reward, info t
    # and done_status, the distances, block angle, blks, t, done_status, goal;
    # done and truncated
    score = E * (4 * (3 * A + 9) + A + 4 * (D + A + 11) + 2)
    # a respawn: its uniforms; the bodies' six planes, the contact flags, the
    # 17 words of each pair's contact state
    score += respawned * (4 * (3 + 2 * A) + 29 * B + A + 1 + 62 * P)
    return control, score


def check_env_logic(dev, card_line) -> dict:
    """Phase 6: the v0 env's ``control`` and ``score_respawn`` kernels
    (``envs/v0_cuda.py``) at each of ``ENV_LOGIC_WORLDS``, from fresh spawns,
    after ``ENV_LOGIC_STEPS`` random steps and at a step where every env
    truncates: each against its plain version on the same inputs (control
    against ``V0Env._control_plain``; score_respawn, with the spawn's draws,
    against ``_finish``, ``reset_fast`` and the select from the same generator
    state), the differing elements of the exact outputs and the largest
    differences of the float ones, ``RESPAWNS`` of a traced launch; then each
    per launch in a CUDA graph of ``ENV_LOGIC_CALLS`` beside its bound (its
    bytes at 3.35 TB/s) and the plain version's time in the same kind of
    graph (the plain score with its autoreset's draws, spawn and select)."""
    out = {}
    for env_id, E in ENV_LOGIC_WORLDS:
        env = make(env_id, num_envs=E)
        logic, gen = env.logic, env.generator
        state, _obs = env.reset(seed=7)
        act_gen = torch.Generator(device=dev).manual_seed(7)
        act = lambda: torch.rand((E, env.cfg.act_dim), generator=act_gen, device=dev) * 2 - 1  # noqa: E731
        params = cuda_graph.as_device_scalars(env.default_params(), dev)
        for when in ("fresh", "stepped", "truncate"):
            if when == "stepped":
                for _ in range(ENV_LOGIC_STEPS):
                    state = env.step(state, act())[0]
            pre = state if when != "truncate" else state.replace(
                t=torch.full_like(state.t, env.cfg.max_episode_steps - 1))
            action = act().T
            got_c = v0_cuda.control(logic, pre, action)
            want_c = logic._control_plain(pre, action)
            ticked = env_common.physics_fused(logic.layout, logic.cfg, want_c[0], pre.contacts,
                                              *want_c[1:], pre.goal_contact, pre.wall_contact)
            g0 = gen.get_state()

            def plain_score():
                ps, pobs, prew, pdone, pinfo = PuzzleEnvLogic._finish(logic, pre, *ticked, params)
                rs, robs = logic.reset_fast(gen, E, params)
                return (env_common.select(pdone, rs, ps), torch.where(pdone, robs, pobs), prew,
                        pdone, pinfo)

            want = plain_score()
            gen.set_state(g0)
            draws = logic._spawn_draws(gen, E)
            with profiling.tracing():
                got = v0_cuda.score_respawn(logic, pre, *tree_map(torch.clone, ticked), params,
                                            draws)
            record = profiling.RESPAWNS[-1]
            n_done = int(want[3].sum())
            exact = (got[0], got[3], got[4], got_c[0].vel, got_c[0].omega, got_c[2], got_c[3])
            like = (want[0], want[3], want[4], want_c[0].vel, want_c[0].omega, want_c[2],
                    want_c[3])
            floats = [(got[0].agent_dist, want[0].agent_dist),
                      (got[0].block_distance, want[0].block_distance)]
            r = dict(
                respawned=n_done, record=(record.respawned, record.scored),
                # the state's floats that the kernel computes are held apart
                differ=int(mismatches(
                    (exact[0].replace(agent_dist=want[0].agent_dist,
                                      block_distance=want[0].block_distance),) + exact[1:],
                    like)),
                obs_err=maxdiff(got[1], want[1]), reward_err=maxdiff(got[2], want[2]),
                dist_err=max(maxdiff(a, b) for a, b in floats),
                force_rel=maxdiff(got_c[1], want_c[1]) / max(float(want_c[1].abs().max()), 1e-30))

            def graphed(fn, generators=()):
                side = torch.cuda.Stream(dev)
                side.wait_stream(torch.cuda.current_stream(dev))
                state0 = [g.get_state() for g in generators]
                with torch.cuda.stream(side):
                    fn()
                torch.cuda.current_stream(dev).wait_stream(side)
                graph = torch.cuda.CUDAGraph()
                for g in generators:
                    graph.register_generator_state(g)
                with torch.cuda.graph(graph):
                    for _ in range(ENV_LOGIC_CALLS):
                        fn()
                for g, st in zip(generators, state0):
                    g.set_state(st)
                graph.replay()
                torch.cuda.synchronize(dev)
                return 1e3 * cuda_ms(graph.replay, 5) / ENV_LOGIC_CALLS

            copies = tree_map(torch.clone, ticked)
            r.update(
                control_us=graphed(lambda: v0_cuda.control(logic, pre, action)),
                control_plain_us=graphed(lambda: logic._control_plain(pre, action)),
                score_us=graphed(lambda: v0_cuda.score_respawn(logic, pre, *copies, params,
                                                               draws)),
                score_plain_us=graphed(plain_score, (gen,)))
            cb_, sb_ = env_logic_bytes(logic, E, n_done)
            r.update(control_bytes=cb_, score_bytes=sb_,
                     control_bound_us=1e6 * cb_ / yardstick.HBM_BYTES_PER_S,
                     score_bound_us=1e6 * sb_ / yardstick.HBM_BYTES_PER_S)
            out[(env_id, when)] = r
            print(f"  env logic, {env_id} at {E} envs, {when} ({n_done} done): control "
                  f"{r['control_us']:.2f} us per launch (bound {r['control_bound_us']:.3f} us: "
                  f"{cb_:,} bytes; plain {r['control_plain_us']:.1f} us), score_respawn "
                  f"{r['score_us']:.2f} us (bound {r['score_bound_us']:.3f} us: {sb_:,} bytes; "
                  f"plain score and autoreset {r['score_plain_us']:.1f} us); against plain: "
                  f"{r['differ']} elements differ in the exact outputs, obs {r['obs_err']:.2e} px, "
                  f"reward {r['reward_err']:.2e}, distances {r['dist_err']:.2e} px, force "
                  f"{r['force_rel']:.2e} of its largest; RESPAWNS (respawned, scored) "
                  f"{r['record']}  [{card_line}]", flush=True)
            if r["differ"] or r["record"] != (n_done, E) or not (
                    r["obs_err"] <= 2e-4 and r["reward_err"] <= 2e-3 and r["dist_err"] <= 2e-4
                    and r["force_rel"] <= 1e-6):
                raise AssertionError(f"env logic kernels, {env_id} {when}: {r}")
        env.close()
    return out


def learner_against_eager(algo, card_line, what, hparams=None, stop_in_first=False) -> dict:
    """Phase 17: ``LEARNER_UPDATES`` chained updates of the learner ``algo``
    from its ``init_state()`` (``hparams`` set through ``set_hparams``
    first; a learner whose graphs were captured replays them): ``train_step``
    (the rollout's graph, then the learner's) against ``train_step_eager``
    from the same state and generator states, so with the same noise, spawns
    and minibatch orders; every element of the state (params, Adam state,
    normalizer, env state, generators) and of the metrics equal bit for bit,
    ``kl_stopped`` equal; launches counted just around the replays (n_steps x
    frameskip of the learner's kernel per update), the learner's graph
    holding no tick kernel, two launches of ``adam_fused`` per minibatch and,
    for an MLP the chain takes (``PPO.fused_grad``), four of ``mlp_grad``.  With ``stop_in_first`` the stop must fire inside update 1
    (Adam's count then says at which minibatch)."""
    cfg = algo.cfg
    on_card(algo, what)
    ts = algo.init_state()
    if hparams:
        ts = algo.set_hparams(ts, **hparams)
    states = ts.generator.get_state(), algo.env.generator.get_state()
    torch.cuda.synchronize()
    step_cuda.reset_launch_count()
    t0 = time.perf_counter()
    got, gts = [], ts
    for _ in range(LEARNER_UPDATES):
        gts, metrics = algo.train_step(gts)
        got.append((ckpt.to_tree(gts), metrics))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts()
    held = algo.graph_launches
    ts.generator.set_state(states[0])
    algo.env.generator.set_state(states[1])
    bad, ets, stops = torch.zeros((), dtype=torch.int64, device=algo.device), ts, []
    for g_state, g_metrics in got:
        ets, metrics = algo.train_step_eager(ets)
        bad += mismatches((g_state, g_metrics), (ckpt.to_tree(ets), metrics))
        stops.append((bool(g_metrics["kl_stopped"]), bool(metrics["kl_stopped"]),
                      int(g_state["opt_state"]["count"])))
    n_bad = int(bad)
    n = LEARNER_UPDATES * cfg.n_steps * algo.env.cfg.frameskip
    want = ({"step_fused": n, "solve_contacts": 0} if cfg.env_backend == "fused"
            else {"step_fused": 0, "solve_contacts": n})
    per_update = cfg.n_epochs * (cfg.n_steps * cfg.n_envs // cfg.batch_size)
    hand = {"adam_fused": 2 * per_update}
    if algo.fused_grad:
        hand["mlp_grad"] = 4 * per_update
    print(f"  {what}: {LEARNER_UPDATES} chained updates, both CUDA graphs against the eager "
          f"bodies: {n_bad} elements differ (state, generators, metrics); kl_stopped (graph, "
          f"eager) and Adam count after each update "
          + ", ".join(f"{a}/{b} {c}" for a, b, c in stops)
          + f" ({per_update} minibatches per update); launches {launches}, graphs hold {held}; "
          f"{wall:.2f} s for the replays (the first captures)  [{card_line}]", flush=True)
    if n_bad:
        raise AssertionError(f"{what}: the replays differ from the eager bodies")
    if any(a != b for a, b, _ in stops):
        raise AssertionError(f"{what}: kl_stopped differs: {stops}")
    if stop_in_first and not (stops[0][0] and stops[0][2] < per_update):
        raise AssertionError(f"{what}: the stop did not fire inside update 1: {stops}")
    if launches != want or held.get("learner") != hand:
        raise AssertionError(f"{what}: launches {launches} (graphs hold {held}), expected "
                             f"{want} and {hand} in the learner's graph")
    return dict(launches=launches, stops=stops, wall=wall, held=held["learner"])


def v2_config() -> PPOConfig:
    """Phase 15's v2 recipe (:func:`variant_recipes`)."""
    return next(cfg for name, cfg, _n, _w in variant_recipes() if name == "v2")


def run_learner_graphs(card_line) -> dict:
    """Phase 17: :func:`learner_against_eager` at the v0 recipe (default,
    then ``target_kl = LEARNER_STOP_KL`` on the same learner, whose graphs it
    replays), the pixel recipe (cuDNN held deterministic) and the v2 recipe,
    after the gradient and optimizer kernels against their plain versions."""
    flat_cfg = PPOConfig.from_reference_json(json.loads(TRAIN_CONFIG.read_text()),
                                             **TRAIN_OVERRIDES)
    pixel_cfg, v2_cfg = PPOConfig(**CNN_CONFIG), v2_config()
    mlp = check_mlp_grad(card_line)
    flat = PPO(flat_cfg)
    adam = {"v0": check_adam_fused(flat, card_line, "v0 recipe")}
    checks = {"v0": learner_against_eager(flat, card_line, "PPO at the v0 recipe"),
              "v0 stop": learner_against_eager(
                  flat, card_line, f"PPO at the v0 recipe, target_kl {LEARNER_STOP_KL} (the "
                  "same graphs)", dict(target_kl=LEARNER_STOP_KL), stop_in_first=True)}
    del flat
    flags = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        pixel = PPO(pixel_cfg)
        adam["pixel"] = check_adam_fused(pixel, card_line, "pixel recipe")
        checks["pixel"] = learner_against_eager(pixel, card_line,
                                                "PPO at the pixel recipe (cudnn deterministic)")
        del pixel
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = flags
    checks["v2"] = learner_against_eager(PPO(v2_cfg), card_line, "PPO at the v2 recipe")

    held = {}
    for c in checks.values():
        for name, n in c["held"].items():
            held[name] = held.get(name, 0) + n
    return dict(checks=checks, held=held, adam=adam, mlp=mlp,
                launches=sum(c["launches"]["step_fused"] for c in checks.values()))


def run_chain(card_line) -> dict:
    """Phase 18: the v2 recipe (:func:`v2_config`) run two ways side by side
    from one ``init_state``, ``PPO.train_step`` (both CUDA graphs) and
    ``PPO.train_step_eager``, each update preceded by ``apply_curriculum``
    over the leg's updates as ``PPO.learn`` runs it (``CHAIN_LEGS``):
    ``CHAIN_UPDATES`` updates, ``checkpoint.save`` of each way, a restore of
    each into a fresh ``PPO`` at leg 2's config with the CLI's resume
    overrides (``cli.leg_overrides``; new graphs, captured anew), then
    ``CHAIN_UPDATES`` more.  Every update's state (params, Adam state,
    normalizer, env state, generators, env params, hparams) and metrics, and
    both restored states, equal between the ways in every element; exactly
    n_steps launches of kernel A per update on each way (counted around
    each way's updates) and none of kernel B; each graph captured once per
    learner.  Returns kernel A's launches over both ways."""
    base = v2_config()
    per_update = base.n_steps * base.n_envs
    ways = {"graph": "train_step", "eager": "train_step_eager"}
    launches = {way: {"step_fused": 0, "solve_contacts": 0} for way in ways}
    walls = {way: 0.0 for way in ways}
    bad, log, captures = 0, [], []
    cb.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=cb.BUILD_DIR) as tmp:
        learners, states = {}, {}
        for leg, (total, overrides) in enumerate(CHAIN_LEGS):
            cfg = dataclasses.replace(base, total_timesteps=total, **overrides)
            n_updates = max(1, total // per_update)
            for way in ways:
                learners[way] = None  # the old learner's graphs go before new ones are made
                learner = PPO(cfg)
                on_card(learner, f"chain, leg {leg + 1}")
                ts = learner.init_state()
                if leg:
                    ts = cli.leg_overrides(learner, ckpt.restore(f"{tmp}/{way}", ts))
                learners[way], states[way] = learner, ts
            bad = bad + mismatches(ckpt.to_tree(states["graph"]), ckpt.to_tree(states["eager"]))
            for u in range(n_updates)[:CHAIN_UPDATES]:
                out = {}
                for way, method in ways.items():
                    learner = learners[way]
                    ts = learner.apply_curriculum(states[way], u, n_updates)
                    before = launch_counts()
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    ts, metrics = getattr(learner, method)(ts)
                    torch.cuda.synchronize()
                    walls[way] += time.perf_counter() - t0
                    for name, n in launch_counts().items():
                        launches[way][name] += n - before[name]
                    states[way], out[way] = ts, (ckpt.to_tree(ts), metrics)
                bad = bad + mismatches(out["graph"], out["eager"])
                m, ts, p = out["graph"][1], states["graph"], learners["graph"].env_params
                # the CLI's schedule: the goal epsilon over this leg's updates, at this
                # leg's ent_coef
                want = (p.update_goal(u, n_updates, p.scaled_epsilon).scaled_epsilon,
                        HParams.from_config(cfg).ent_coef)
                log.append((leg + 1, u, ts.env_params.scaled_epsilon, ts.hparams.ent_coef,
                            float(m["ep_rew_mean"]), float(m["approx_kl"]),
                            bool(m["kl_stopped"]), int(ts.opt_state.count),
                            (ts.env_params.scaled_epsilon, ts.hparams.ent_coef) == want))
            captures.append(learners["graph"].graph_captures)
            if leg == 0:
                for way in ways:
                    ckpt.save(f"{tmp}/{way}", states[way], ckpt.step_count(states[way].timesteps))
    n_bad = int(bad)
    n = len(CHAIN_LEGS) * CHAIN_UPDATES
    want = {"step_fused": n * base.n_steps, "solve_contacts": 0}
    for leg, u, eps, ent, ret, kl, stop, count, _ok in log:
        print(f"  leg {leg} update {u}: scaled_epsilon {eps:.6g}, ent_coef {ent:.6g}, ep_rew_mean "
              f"{ret:.6g}, approx_kl {kl:.6g}, kl_stopped {stop}, Adam count {count}", flush=True)
    print(f"  {n} updates of the v2 recipe each way, {CHAIN_UPDATES} per leg across a save and a "
          f"restore into fresh learners with leg 2's overrides: {n_bad} elements differ between "
          f"graph and eager (state, generators, metrics, the restored states); launches "
          f"{launches}; graph captures per leg {captures}; {walls['graph']:.2f} s graph (captures "
          f"included) against {walls['eager']:.2f} s eager: "
          f"{n * per_update / walls['graph']:,.0f} against {n * per_update / walls['eager']:,.0f}"
          f" env-steps/s  [{card_line}]", flush=True)
    if n_bad:
        raise AssertionError(f"chain: graph and eager differ in {n_bad} elements")
    if any(v != want for v in launches.values()):
        raise AssertionError(f"chain: launches {launches}, expected {want} each way")
    if any(c != {"rollout": 1, "learner": 1} for c in captures):
        raise AssertionError(f"chain: graphs captured {captures}, expected once per learner")
    if not all(entry[-1] for entry in log):
        raise AssertionError("chain: scaled_epsilon or ent_coef off the CLI's schedule")
    return launches["graph"]["step_fused"] + launches["eager"]["step_fused"]


def run_graphs(dev, card_line):
    """Phase 16 (constants ``GRAPH_*``): each CUDA graph of the main path
    against its eager body, bit for bit, launches exact; peak device
    memory."""
    print(f"  peak device memory of phases 1-15: "
          f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB allocated  [{card_line}]",
          flush=True)
    torch.cuda.reset_peak_memory_stats(dev)
    v2 = "MultiRobotPuzzle-v2"
    goal = (GRAPH_CHANGE_AT, lambda p: p.update_goal(5, 10, V2_EPSILON))
    for env_id in VARIANTS:
        for backend in ("fused", "pallas"):
            kw = dict(reseed_at=GRAPH_CHANGE_AT) if (env_id, backend) == (ENV_ID, "fused") else {}
            if env_id == v2:
                kw = dict(change=goal)
            what = f"{env_id} {backend}, {NUM_ENVS} envs {VI}/{PI}" + (
                f", reset(seed=1) before step {GRAPH_CHANGE_AT}" if "reseed_at" in kw else "") + (
                f", update_goal before step {GRAPH_CHANGE_AT}" if "change" in kw else "")
            replay_against_eager(dev, card_line, [graphed_pair(env_id, backend)], MAIN_STEPS,
                                 what, backend, **kw)
    replay_against_eager(dev, card_line, [graphed_pair(V3_ID, "fused", make_kw=HEAVY5)],
                         MAIN_STEPS, f"{world_name(V3_ID, HEAVY5)} fused, {NUM_ENVS} envs "
                         f"{VI}/{PI}", "fused")
    replay_against_eager(dev, card_line, [graphed_pair(HV0_ID, "fused", HV0_ENVS)],
                         GRAPH_SHORT_STEPS, f"{HV0_ID} fused, {HV0_ENVS} envs", "fused")
    replay_against_eager(dev, card_line, [graphed_pair(ENV_ID, "fused"), graphed_pair(v2, "fused")],
                         GRAPH_SHORT_STEPS, "a v0 and a v2 graph stepped in turn (their world "
                         "tables re-uploaded before each replay)", "fused")
    iters = dict(velocity_iters=CNN_CONFIG["velocity_iters"],
                 position_iters=CNN_CONFIG["position_iters"])
    image = [DeviceImageVectorEnv(ENV_ID, num_envs=CNN_CONFIG["n_envs"], **iters)
             for _ in range(2)]
    replay_against_eager(dev, card_line, [tuple(image)], GRAPH_SHORT_STEPS,
                         f"image env, {CNN_CONFIG['n_envs']} envs "
                         f"{iters['velocity_iters']}/{iters['position_iters']} (frames)", "fused")
    del image

    flat_cfg = PPOConfig.from_reference_json(json.loads(TRAIN_CONFIG.read_text()),
                                             **TRAIN_OVERRIDES)
    pixel_cfg = PPOConfig(**CNN_CONFIG)
    rollout_against_eager(flat_cfg, card_line, "PPO.rollout at the v0 recipe")
    flags = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        rollout_against_eager(pixel_cfg, card_line, "PPO.rollout at the pixel recipe")
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = flags

    print(f"  peak device memory of phase 16: "
          f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB allocated  [{card_line}]",
          flush=True)


def main() -> int:
    t_start = time.perf_counter()
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
    with ThreadPoolExecutor(5) as pool:  # one nvcc per source, started together
        builds = [pool.submit(kernel.build)
                  for kernel in (step_cuda.KERNEL, solver_cuda.KERNEL, adam_fused.KERNEL,
                                 mlp_grad.KERNEL, v0_cuda.CONTROL)]
        builds = [f.result() for f in builds]
    print(f"  built {', '.join(path.name for path, _ in builds)} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for name, (_path, log) in zip(("adam_fused", "mlp_grad", "env_v0"), builds[2:]):
        for line in log.splitlines():
            if "Function properties" in line or "registers" in line or "stack frame" in line:
                print(f"  ptxas: {name}: {line.strip()}", flush=True)
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
    # five heavy agents spawn in deep overlaps, one of which float32 resolves one
    # way or another by its rounding while float64 keeps to one (measured on an
    # H100: the kernel 5.98e-4 m from world.step there): held to float32's reach
    heavy5_diff, heavy5_plain_ms = check_spawns_reach(dev, NUM_ENVS, seed=2, env_id=V3_ID,
                                                      make_kw=HEAVY5)
    check_trig(dev)

    print("== 4. contact-solve kernel against plain on the card", flush=True)
    check_push_world(dev, staged_tick(False), "staged push world")
    solve_diff, solve_plain_ms = check_solve_kernel(dev, ENV_ID, NUM_ENVS, seed=0)
    check_solve_kernel(dev, ENV_ID, 1000, seed=1)
    _diff, solve_plain_v2_ms = check_solve_kernel(dev, "MultiRobotPuzzle-v2", NUM_ENVS,
                                                  seed=2)
    heavy5_solve_diff, heavy5_solve_plain_ms = check_solve_kernel(dev, V3_ID, NUM_ENVS, seed=2,
                                                                  make_kw=HEAVY5)
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

    print("== 14. the JAX package's variant policies held to their records", flush=True)
    t_phase = time.perf_counter()
    variant_eval_launches = run_variant_evals(card_line)
    print(f"  phase 14: {time.perf_counter() - t_phase:.1f} s", flush=True)

    print("== 15. PPO on each variant's recipe at full width; kernel A's large class at "
          f"{HV0_ENVS} envs", flush=True)
    t_phase = time.perf_counter()
    variant_train = run_variant_training(card_line)
    hv0_diff, hv0_plain_ms = check_spawns_f64(dev, HV0_ENVS, seed=2, env_id=HV0_ID)
    hv0 = time_kernels(dev, HV0_ID, card_line, E=HV0_ENVS)
    print(f"  world.step on {HV0_ENVS} {HV0_ID} spawns {VI}/{PI}: {hv0_plain_ms:.1f} ms per "
          f"tick  [{card_line}]", flush=True)
    print(f"  phase 15: {time.perf_counter() - t_phase:.1f} s", flush=True)

    print("== 16. the env step, the image env step and the rollout as CUDA graphs against "
          "their eager bodies", flush=True)
    t_phase = time.perf_counter()
    run_graphs(dev, card_line)
    print(f"  phase 16: {time.perf_counter() - t_phase:.1f} s", flush=True)

    print("== 17. the learner as a CUDA graph against its eager body", flush=True)
    t_phase = time.perf_counter()
    learner = run_learner_graphs(card_line)
    print(f"  phase 17: {time.perf_counter() - t_phase:.1f} s", flush=True)

    print("== 18. the v2 recipe's two legs, graph against eager, across a save and a restore "
          "into fresh learners", flush=True)
    t_phase = time.perf_counter()
    chain_launches = run_chain(card_line)
    print(f"  phase 18: {time.perf_counter() - t_phase:.1f} s", flush=True)

    print("== 6. kernels", flush=True)
    env_logic = check_env_logic(dev, card_line)
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
    print(f"  chip_smoke.py: {time.perf_counter() - t_start:.1f} s in all", flush=True)
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
             variant_eval_launches=variant_eval_launches,
             variant_train_launches=variant_train["step_fused"],
             learner_check_launches=learner["launches"],
             learner_graph_launches=learner["held"].get("step_fused", 0),
             chain_launches=chain_launches,
             v3_heavy5_max_abs_err=heavy5_diff["max"], v3_heavy5_reach=heavy5_diff["reach"],
             v3_heavy5_plain_ms=heavy5_plain_ms,
             hv0_16k_ms=hv0["fused_ms"], hv0_16k_bound_ms=hv0["fused_bound"]["ms"],
             hv0_16k_bound_by=hv0["fused_bound"]["by"], hv0_16k_plain_ms=hv0_plain_ms,
             hv0_16k_max_abs_err=hv0_diff["max"],
             max_abs_err=spawn_diff["max"],
             ms=v0["fused_ms"], plain_ms=plain_ms,
             bound_ms=v0["fused_bound"]["ms"], bound_by=v0["fused_bound"]["by"]),
        dict(common, name="solve_contacts",
             source="gym_puzzles_tpu_torch/csrc/solve_contacts.cu",
             replaces="gym_puzzles_tpu/engine/solver_pallas.py:557",
             launches=staged_run["launches"], train_launches=variant_train["solve_contacts"],
             learner_graph_launches=learner["held"].get("solve_contacts", 0),
             max_abs_err=solve_diff["max"],
             v3_heavy5_max_abs_err=heavy5_solve_diff["max"],
             v3_heavy5_plain_ms=heavy5_solve_plain_ms,
             ms=v0["solve_ms"], plain_ms=solve_plain_ms,
             bound_ms=v0["solve_bound"]["ms"], bound_by=v0["solve_bound"]["by"]),
        dict(common, name="adam_fused",
             source="gym_puzzles_tpu_torch/csrc/adam_fused.cu", replaces=None,
             learner_graph_launches=learner["held"].get("adam_fused", 0),
             **{f"{net}_{key}": a[key] for net, a in learner["adam"].items()
                for key in ("params", "ms", "plain_ms", "bound_ms")},
             **{f"{net}_active_rel_err": a["active"]["rel"]
                for net, a in learner["adam"].items()},
             bound_by="bytes"),
        dict(common, name="mlp_grad",
             source="gym_puzzles_tpu_torch/csrc/mlp_grad.cu", replaces=None,
             learner_graph_launches=learner["held"].get("mlp_grad", 0),
             **{f"{what.split()[0]}_{key}": r[key] for what, r in learner["mlp"].items()
                for key in ("us", "plain_us", "gemm_us", "bound_us", "rel")},
             bound_by="operations"),
        dict(common, name="env_v0",
             source="gym_puzzles_tpu_torch/csrc/env_v0.cu", replaces=None,
             **{f"{'v0' if env_id == ENV_ID else 'hv0'}_{when}_{key}": r[key]
                for (env_id, when), r in env_logic.items()
                for key in ("control_us", "control_bound_us", "control_plain_us", "score_us",
                            "score_bound_us", "score_plain_us", "obs_err", "reward_err",
                            "force_rel", "respawned")},
             bound_by="bytes"),
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
