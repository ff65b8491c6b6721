"""The port stands alone: importing ``gym_puzzles_tpu_torch`` (every module
that holds a kernel's wrapper, the learner in ``train``, the pixel pipeline,
the host surface -- old-Gym adapters, host rasterizer and its C++ loader,
viewer, teleop -- the extras: scripted controllers, imitation, sweeps,
profiling -- the CUDA graphs of the step and the rollout, and the
distribution: ``parallel``, its mesh, heartbeat and scaling bench), stepping each env family on the CPU through both backends,
running one PPO update with each policy (MLP; CNN on the image env),
restoring every committed policy file and taking one eval step of it, a
single env step with a host-rendered frame, a BC round, a one-trial sweep,
an env step and an update traced with spans on, and one ``DistributedPPO``
update on a one-rank gloo group load neither JAX,
flax, optax, orbax nor the JAX package; and without a CUDA device no entry
point picks a device on its own."""

import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import gym_puzzles_tpu_torch as gpt
from gym_puzzles_tpu_torch.api.gym_compat import GymnasiumVectorAdapter, GymPuzzleEnv
from gym_puzzles_tpu_torch.api.image_obs import ImageObsEnv
from gym_puzzles_tpu_torch.parallel import DistributedPPO, scaling_bench
from gym_puzzles_tpu_torch.train import imitate, sweep
from gym_puzzles_tpu_torch.train.ppo import PPOConfig

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent

PROBE = """
import json, sys, torch
torch.set_num_threads(1)
import gym_puzzles_tpu_torch as gpt
from gym_puzzles_tpu_torch.api.gym_compat import GymnasiumVectorAdapter, GymPuzzleEnv
from gym_puzzles_tpu_torch.api.image_obs import ImageObsEnv
from gym_puzzles_tpu_torch.train import imitate, sweep
from gym_puzzles_tpu_torch.train.ppo import PPOConfig
import gym_puzzles_tpu_torch.convert
import gym_puzzles_tpu_torch.bench_kernels
import gym_puzzles_tpu_torch.engine.solver_cuda, gym_puzzles_tpu_torch.engine.step_cuda
import gym_puzzles_tpu_torch.engine._cuda_build
import gym_puzzles_tpu_torch.train.checkpoint, gym_puzzles_tpu_torch.train.cli
import gym_puzzles_tpu_torch.train.evaluate, gym_puzzles_tpu_torch.train.export
import gym_puzzles_tpu_torch.train.networks, gym_puzzles_tpu_torch.train.normalize
import gym_puzzles_tpu_torch.api.image_obs, gym_puzzles_tpu_torch.render.device
import gym_puzzles_tpu_torch.render.palette, gym_puzzles_tpu_torch.render.raster
import gym_puzzles_tpu_torch.render._raster_cpp, gym_puzzles_tpu_torch.render.window
import gym_puzzles_tpu_torch.api.gym_compat, gym_puzzles_tpu_torch.teleop
import gym_puzzles_tpu_torch.train.scripted, gym_puzzles_tpu_torch.train.imitate
import gym_puzzles_tpu_torch.train.sweep, gym_puzzles_tpu_torch.utils.profiling
import gym_puzzles_tpu_torch.utils.cuda_graph
import gym_puzzles_tpu_torch.train.adam_fused, gym_puzzles_tpu_torch.train.mlp_grad
from gym_puzzles_tpu_torch.train.ppo import PPO, PPOConfig
for env_id, backend in (("MultiRobotPuzzle-v0", "fused"), ("MultiRobotPuzzle-v0", "pallas"),
                        ("MultiRobotPuzzle-v2", "pallas"), ("MultiRobotPuzzleHeavy-v2", "fused"),
                        ("MultiRobotPuzzle-v3", "fused")):
    env = gpt.make(env_id, num_envs=4, device="cpu", backend=backend,
                   velocity_iters=4, position_iters=2)
    state, obs = env.reset(seed=0)
    state, obs, reward, done, info = env.step(state, torch.zeros(4, env.cfg.act_dim))
    assert obs.shape == (4, env.cfg.obs_dim) and bool(torch.isfinite(obs).all())
algo = PPO(PPOConfig(n_envs=2, n_steps=2, batch_size=2, n_epochs=1, velocity_iters=2,
                     position_iters=1), device="cpu")
ts, metrics = algo.train_step(algo.init_state())
assert int(ts.timesteps) == 4 and bool(torch.isfinite(metrics["loss"]))
from gym_puzzles_tpu_torch.utils import profiling
with profiling.tracing() as tr:
    state, *_ = env.step(state, torch.zeros(4, env.cfg.act_dim))
    ts, metrics = algo.train_step(ts)
assert tr.steps == 2 and tr.named("learn.adam")
from gym_puzzles_tpu_torch.api.image_obs import DeviceImageVectorEnv
cnn = PPO(PPOConfig(policy="cnn", n_envs=2, n_steps=2, batch_size=4, n_epochs=1),
          device="cpu", env=DeviceImageVectorEnv(num_envs=2, downsample=16, device="cpu",
                                                 velocity_iters=2, position_iters=1))
ts, metrics = cnn.train_step(cnn.init_state())
assert ts.last_obs.dtype == torch.uint8 and bool(torch.isfinite(metrics["loss"]))
from gym_puzzles_tpu_torch.api.gym_compat import GymPuzzleEnv
from gym_puzzles_tpu_torch.api.image_obs import ImageObsEnv
env = GymPuzzleEnv("MultiRobotPuzzle-v0", device="cpu", velocity_iters=2, position_iters=1)
env.reset()
env.step([0.0] * 6)
assert env.render("rgb_array").shape == (480, 640, 3)
img = ImageObsEnv(downsample=8, device="cpu", velocity_iters=2, position_iters=1)
assert img.reset().shape == (180, 80, 3)
from gym_puzzles_tpu_torch.train import imitate, sweep
small = PPOConfig(n_envs=2, n_steps=2, batch_size=4, n_epochs=1, velocity_iters=2,
                  position_iters=1)
algo, ts = imitate.bc_train(small, rounds=1, log_fn=lambda line: None, device="cpu")
assert int(ts.timesteps) == 4
rows = sweep.run_fast_sweep(small, trials=1, budget_timesteps=4, log=lambda line: None,
                            device="cpu")
assert rows[0]["final_state"] is not None
from pathlib import Path
from gym_puzzles_tpu_torch.train import checkpoint as ckpt, evaluate
npzs = sorted(Path("gym_puzzles_tpu_torch/policies").glob("*.npz"))
assert len(npzs) == 13, npzs
for npz in npzs:
    env_id = npz.name.split("_")[0]
    pol = PPO(PPOConfig(env_id=env_id, n_envs=1, n_steps=2, batch_size=2, n_epochs=1),
              device="cpu")
    st = ckpt.restore_policy(npz, pol.init_state())
    mean, _std, returns, lengths, _st = evaluate.evaluate_policy_batched(
        pol, st, n_episodes=1, max_steps=1, velocity_iters=2, position_iters=1)
    assert int(st.timesteps) > 0 and lengths == [1] and returns[0] == returns[0], npz
import tempfile
import gym_puzzles_tpu_torch.parallel.mesh, gym_puzzles_tpu_torch.parallel.health
import gym_puzzles_tpu_torch.parallel.scaling_bench
from gym_puzzles_tpu_torch.parallel import DistributedPPO, Heartbeat, init_distributed
with tempfile.TemporaryDirectory() as tmp:
    init_distributed(world_size=1)  # one process: does nothing
    assert not torch.distributed.is_initialized()
    torch.distributed.init_process_group("gloo", init_method=f"file://{tmp}/rdv", world_size=1,
                                         rank=0)
    dppo = DistributedPPO(small, device="cpu")
    assert dppo.mesh.backend == "gloo"
    ts, metrics = dppo.train_step(dppo.init_state())
    Heartbeat(timeout=30.0).ping()
    assert int(ts.timesteps) == 4 and bool(torch.isfinite(metrics["loss"]))
    torch.distributed.destroy_process_group()
print(json.dumps(sorted(sys.modules)))
"""


def test_port_imports_no_jax():
    # a fresh interpreter: this test process has already imported jax
    out = subprocess.run([sys.executable, "-c", PROBE], cwd=ROOT, capture_output=True,
                         text=True, timeout=120, check=True)
    mods = json.loads(out.stdout.strip().splitlines()[-1])
    leaked = [m for m in mods
              if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "orbax",
                                     "gym_puzzles_tpu")]
    assert not leaked, leaked


def test_make_without_cuda_raises(monkeypatch):
    """``make`` and every entry point of the host surface and the extras
    refuse to run without CUDA when no device is named."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    small = PPOConfig(n_envs=2, n_steps=2, batch_size=4, n_epochs=1)
    for build in (lambda: gpt.make("MultiRobotPuzzle-v0", num_envs=4),
                  lambda: GymPuzzleEnv("MultiRobotPuzzle-v0"),
                  lambda: GymnasiumVectorAdapter("MultiRobotPuzzle-v0", 4),
                  lambda: ImageObsEnv(),
                  lambda: imitate.bc_train(small, rounds=1),
                  lambda: sweep.run_fast_sweep(small, trials=1),
                  lambda: sweep.run_local_sweep(trials=1),
                  lambda: DistributedPPO(small),
                  lambda: scaling_bench.run()):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build()


def test_all_ids_and_backends_build():
    for env_id in gpt.ENV_IDS:
        for backend in ("fused", "pallas"):
            env = gpt.make(env_id, num_envs=4, device="cpu", backend=backend)
            assert env.backend == backend and env.cfg.env_id == env_id


def test_unported_ids_and_backends_raise():
    """An id or a backend name that the port does not have raises."""
    with pytest.raises(KeyError, match="unknown env id"):
        gpt.make("MultiRobotPuzzle-v1", num_envs=4, device="cpu")
    with pytest.raises(ValueError, match="backend must be one of"):
        gpt.make("MultiRobotPuzzle-v0", num_envs=4, device="cpu", backend="xla")


def test_chip_smoke_imports_no_jax():
    source = (ROOT / "chip_smoke.py").read_text()
    for name in ("jax", "flax", "gym_puzzles_tpu"):
        assert f"import {name}\n" not in source and f"import {name} " not in source
        assert f"from {name} " not in source and f"from {name}." not in source
