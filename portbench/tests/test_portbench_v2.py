"""The v2 env cell (``v2-env``) through the same comparison as the other
cells, at the size the CPU holds (8 envs, 4/2 iterations, episodes of 24
steps): the sound program is correct; the control and the program broken
underneath (a step that returns its state unchanged, half the batch left
out, a reward altered, the spin pump left out of the control) are not; a
traced run reads the cell's per-layer metrics, the env step's live-pair
counter among them."""

import contextlib
import dataclasses

import pytest
import torch

from gym_puzzles_tpu_torch.api import vector
from gym_puzzles_tpu_torch.utils import profiling
from portbench import check, control
from portbench import run as R
from portbench.tests.conftest import EPISODE
from portbench.tests.test_portbench_control import _env_half, _env_unchanged

CELL = "v2-env"
ENV_ID = "MultiRobotPuzzle-v2"


@contextlib.contextmanager
def short_v2_episodes(steps: int = EPISODE):
    """The v2 episode limit at ``steps`` in the port's registry and in the
    reference's, the registry's caches of env logic cleared on the way in
    and out."""
    from gym_puzzles_tpu_torch.api import registry
    from gym_puzzles_tpu_torch.envs import config as pconfig
    from portbench.reference import config as rconfig

    def clear():
        registry._logic.cache_clear()
        registry._image_logic.cache_clear()

    try:
        with pytest.MonkeyPatch.context() as mp:
            for table in (pconfig.VARIANTS, rconfig.VARIANTS):
                mp.setitem(table, ENV_ID,
                           dataclasses.replace(table[ENV_ID], max_episode_steps=steps))
            clear()
            yield
    finally:
        clear()


@pytest.fixture
def v2_root(tiny_files):
    with short_v2_episodes():
        yield tiny_files


def _v2_altered(mp):
    from gym_puzzles_tpu_torch.envs.v2 import V2Env

    real = V2Env._score

    def score(self, *a):
        obs, reward, done, status, blks = real(self, *a)
        return obs, reward + torch.nn.functional.one_hot(
            torch.tensor(0), reward.shape[-1]).to(reward.dtype), done, status, blks

    mp.setattr(V2Env, "_score", score)


def _v2_no_spin_pump(mp):
    """The control with the agents' spin as it came in: no
    ApplyAngularImpulse(0.1 * I * w)."""
    from gym_puzzles_tpu_torch.envs import common
    from gym_puzzles_tpu_torch.envs.v2 import V2Env

    real = V2Env._control

    def ctrl(self, state, action):
        bodies, force, torque, wake = real(self, state, action)
        a0 = int(self.layout.agent_slots[0])
        w_in = state.bodies.omega[a0:a0 + self.cfg.num_agents]
        omega = common.set_agent_rows(self.layout, bodies.omega, w_in)
        return bodies.replace(omega=omega), force, torque, wake

    mp.setattr(V2Env, "_control", ctrl)


FAULTS = {"unchanged": _env_unchanged, "half_batch": _env_half, "altered": _v2_altered,
          "no_spin_pump": _v2_no_spin_pump}


def test_the_sound_program_is_correct(v2_root, bench):
    line = R.run(CELL, 2**31 + 31, 0.2, False, device="cpu", bench=bench, root=v2_root)
    assert line["correct"] is True, line["checks"]
    assert {k for k, _v, _lim in line["checks"]} == {
        "tick_gap", "reward_gap", "done_diff", "reset_bad", "obs_gap", "reset_gap"}


def test_the_control_is_not_correct(v2_root, bench):
    nums = control.readings(CELL, 2**31 + 21, 0.2, "cpu", ["control"], bench, v2_root)
    correct, rows = check.judge(nums["control"], R.load_cell(CELL, bench, v2_root)["limits"])
    assert not correct, rows


@pytest.mark.parametrize("fault", list(FAULTS))
def test_a_broken_program_is_not_correct(v2_root, bench, fault):
    with pytest.MonkeyPatch.context() as mp:
        FAULTS[fault](mp)
        line = R.run(CELL, 2**31 + 31, 0.2, False, device="cpu", bench=bench, root=v2_root)
    assert line["correct"] is False, line["checks"]


def test_a_traced_cpu_run_reads_the_env_live_pair_counter(v2_root, bench, monkeypatch):
    """Phase (a) runs on the CPU; with a record at every traced step (the
    tiny run traces 3) the env step's records are kernel A's large class at
    8 envs and the reader gives their mean warp max; the rollout's reader
    finds no rollout and the capture counters, which only a CUDA graph
    feeds, read None.  Without the phases the reader reads None."""
    monkeypatch.setattr(profiling, "LIVE_PAIRS", [])
    monkeypatch.setattr(vector, "LIVE_PAIRS_EVERY", 1)
    assert R.metric_reader("tick_live_pairs.env")({"traffic": {"loop": "env_steps"}}) is None
    line = R.run(CELL, 2**31 + 5, 0.2, True, device="cpu", bench=bench, root=v2_root)
    got = line["metrics"]
    recs = profiling.LIVE_PAIRS
    assert recs and {(r.num_envs, r.size_class, r.site) for r in recs} == {(8, 1, "env.step")}
    assert got["tick_live_pairs.env"]["value"] == sum(r.warp_max for r in recs) / len(recs)
    for name in ("step_host_us.env", "env_logic_ms.env"):
        assert got[name]["value"] > 0, name
    assert "capture_s" not in got and "tick_live_pairs.heavy" not in got
    assert line["correct"] is True


def test_the_reference_finds_v2_by_name():
    """The reference env of the v2 configuration is ``reference/v2.py``'s;
    a variant with no reference module (v3) still fails by its name."""
    import json

    cfg = json.loads((R.ROOT / "configs" / "v2-flat.json").read_text())
    assert type(check.RefEnv(cfg).logic).__module__ == "portbench.reference.v2"
    cfg["env"]["env_id"] = "MultiRobotPuzzle-v3"
    with pytest.raises(ModuleNotFoundError, match="portbench.reference.v3"):
        check.RefEnv(cfg)
