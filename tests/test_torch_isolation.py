"""The port stands alone: importing ``gym_puzzles_tpu_torch`` and stepping an
env on the CPU loads neither JAX, flax nor the JAX package, and without a
CUDA device ``make`` refuses to pick a device on its own."""

import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import gym_puzzles_tpu_torch as gpt

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent

PROBE = """
import json, sys, torch
torch.set_num_threads(1)
import gym_puzzles_tpu_torch as gpt
env = gpt.make("MultiRobotPuzzle-v0", num_envs=4, device="cpu",
               velocity_iters=4, position_iters=2)
state, obs = env.reset(seed=0)
state, obs, reward, done, info = env.step(state, torch.zeros(4, env.cfg.act_dim))
assert obs.shape == (4, env.cfg.obs_dim) and bool(torch.isfinite(obs).all())
print(json.dumps(sorted(sys.modules)))
"""


def test_port_imports_no_jax():
    # a fresh interpreter: this test process has already imported jax
    out = subprocess.run([sys.executable, "-c", PROBE], cwd=ROOT, capture_output=True,
                         text=True, timeout=120, check=True)
    mods = json.loads(out.stdout.strip().splitlines()[-1])
    leaked = [m for m in mods
              if m.split(".")[0] in ("jax", "jaxlib", "flax", "gym_puzzles_tpu")]
    assert not leaked, leaked


def test_make_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        gpt.make("MultiRobotPuzzle-v0", num_envs=4)


def test_unported_ids_and_backends_raise():
    for env_id in ("MultiRobotPuzzle-v2", "MultiRobotPuzzleHeavy-v2", "MultiRobotPuzzle-v3"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            gpt.make(env_id, num_envs=4, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        gpt.make("MultiRobotPuzzle-v0", num_envs=4, device="cpu", backend="pallas")
