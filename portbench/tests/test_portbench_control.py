"""The comparison that decides ``correct`` fails what it should, at a size
the CPU holds: the control (the reference one precision lower in the
program's place) and, through the whole harness with the look for a chip
skipped, the program broken underneath: a step that returns its state
unchanged, half of the batch left out, an answer altered where it is
produced."""

import contextlib

import pytest
import torch

from portbench import check, control
from portbench import run as R

CELLS = ["v0-env", "v0-ppo", "pixel-ppo", "pixel-env"]


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(tiny_root, bench, cell):
    nums = control.readings(cell, 2**31 + 21, 0.2, "cpu", ["control"], bench, tiny_root)
    correct, rows = check.judge(nums["control"], R.load_cell(cell, bench, tiny_root)["limits"])
    assert not correct, rows


def _env_unchanged(mp):
    from gym_puzzles_tpu_torch.envs import common

    mp.setattr(common, "physics_fused",
               lambda layout, cfg, bodies, contacts, f, t, w, g, wc: (bodies, contacts, g, wc))


def _env_half(mp):
    from gym_puzzles_tpu_torch.envs import common

    real = common.physics_fused

    def half(layout, cfg, bodies, contacts, f, t, w, g, wc):
        out = real(layout, cfg, bodies, contacts, f, t, w, g, wc)
        E = bodies.angle.shape[-1]
        skip = torch.arange(E) >= E // 2
        return tuple(common.select(skip, a, b) for a, b in
                     zip((bodies, contacts, g, wc), out))

    mp.setattr(common, "physics_fused", half)


def _env_altered(mp):
    from gym_puzzles_tpu_torch.envs.v0 import V0Env

    real = V0Env._score

    def score(self, *a):
        obs, reward, done, status, blks = real(self, *a)
        return obs, reward + torch.nn.functional.one_hot(
            torch.tensor(0), reward.shape[-1]).to(reward.dtype), done, status, blks

    mp.setattr(V0Env, "_score", score)


def _ppo_unchanged(mp):
    from gym_puzzles_tpu_torch.train.ppo import PPO

    real = PPO.train_step
    mp.setattr(PPO, "train_step", lambda self, ts, **kw: (ts, real(self, ts, **kw)[1]))


def _ppo_half(mp):
    from gym_puzzles_tpu_torch.train.ppo import PPO

    real = PPO.loss

    def loss(self, params, obs, action, old_lp, adv, ret, hp):
        h = obs.shape[0] // 2
        return real(self, params, obs[:h], action[:h], old_lp[:h], adv[:h], ret[:h], hp)

    mp.setattr(PPO, "loss", loss)


def _ppo_altered(mp):
    from gym_puzzles_tpu_torch.train.ppo import PPO

    real = PPO.apply

    def apply(self, params, obs):
        mean, log_std, value = real(self, params, obs)
        return mean, log_std, value + 0.01

    mp.setattr(PPO, "apply", apply)


FAULTS = {"unchanged": (_env_unchanged, _ppo_unchanged), "half_batch": (_env_half, _ppo_half),
          "altered": (_env_altered, _ppo_altered)}


@pytest.mark.parametrize("fault", list(FAULTS))
@pytest.mark.parametrize("cell", CELLS)
def test_a_broken_program_is_not_correct(tiny_root, bench, cell, fault):
    plant = FAULTS[fault][0 if cell.endswith("-env") else 1]
    with pytest.MonkeyPatch.context() as mp, contextlib.ExitStack():
        plant(mp)
        line = R.run(cell, 2**31 + 31, 0.2, False, device="cpu", bench=bench, root=tiny_root)
    assert line["correct"] is False, line["checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_the_sound_program_is_correct(tiny_root, bench, cell):
    line = R.run(cell, 2**31 + 31, 0.2, False, device="cpu", bench=bench, root=tiny_root)
    assert line["correct"] is True, line["checks"]


def _ppo_sampler(mp):
    from gym_puzzles_tpu_torch.train.ppo import PPO

    real = PPO.rollout_steps

    def steps(self, carry, params, noise, env_params, traj):
        return real(self, carry, params, noise * 1.01, env_params, traj)

    mp.setattr(PPO, "rollout_steps", steps)


def _ppo_stale(mp):
    from gym_puzzles_tpu_torch.train.ppo import PPO

    real = PPO.rollout_steps

    def steps(self, carry, params, noise, env_params, traj):
        env, first = self.env, carry[1]
        step = env.step_eager
        env.step_eager = lambda vstate, action, p: step(first, action, p)
        try:
            return real(self, carry, params, noise, env_params, traj)
        finally:
            del env.step_eager

    mp.setattr(PPO, "rollout_steps", steps)


@pytest.mark.parametrize("fault", ["sampler", "stale_state"])
@pytest.mark.parametrize("cell", ["v0-ppo", "pixel-ppo"])
def test_a_broken_rollout_is_not_correct(tiny_root, bench, cell, fault):
    """Noise scaled by 1.01 in the sampler; every env step of the rollout
    from the state it began in."""
    plant = {"sampler": _ppo_sampler, "stale_state": _ppo_stale}[fault]
    with pytest.MonkeyPatch.context() as mp:
        plant(mp)
        line = R.run(cell, 2**31 + 41, 0.2, False, device="cpu", bench=bench, root=tiny_root)
    failed = {k for k, v, lim in line["checks"] if v is None or lim is None or v > lim}
    assert line["correct"] is False and failed, line["checks"]
    print(cell, fault, sorted(failed))
