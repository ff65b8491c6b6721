"""The Heavy-v0 PPO cell (``heavy-v0-x4-ppo``) through the same comparison as
the other cells, at the size the CPU holds (8 envs, 4/2 iterations, 4-step
rollouts): the sound program is correct; the control, each planted fault of
``test_portbench_control.FAULTS`` and a broken rollout are not; a traced run
reads the cell's per-layer metrics, the live-pair counter's among them."""

import pytest

from gym_puzzles_tpu_torch.utils import profiling
from portbench import check, control
from portbench import run as R
from portbench.tests.test_portbench_control import FAULTS, _ppo_sampler, _ppo_stale

CELL = "heavy-v0-x4-ppo"


def test_the_sound_program_is_correct(tiny_root, bench):
    line = R.run(CELL, 2**31 + 31, 0.2, False, device="cpu", bench=bench, root=tiny_root)
    assert line["correct"] is True, line["checks"]


def test_the_control_is_not_correct(tiny_root, bench):
    nums = control.readings(CELL, 2**31 + 21, 0.2, "cpu", ["control"], bench, tiny_root)
    correct, rows = check.judge(nums["control"], R.load_cell(CELL, bench, tiny_root)["limits"])
    assert not correct, rows


@pytest.mark.parametrize("fault", list(FAULTS))
def test_a_broken_program_is_not_correct(tiny_root, bench, fault):
    with pytest.MonkeyPatch.context() as mp:
        FAULTS[fault][1](mp)
        line = R.run(CELL, 2**31 + 31, 0.2, False, device="cpu", bench=bench, root=tiny_root)
    assert line["correct"] is False, line["checks"]


@pytest.mark.parametrize("fault", ["sampler", "stale_state"])
def test_a_broken_rollout_is_not_correct(tiny_root, bench, fault):
    """Noise scaled by 1.01 in the sampler; every env step of the rollout
    from the state it began in."""
    plant = {"sampler": _ppo_sampler, "stale_state": _ppo_stale}[fault]
    with pytest.MonkeyPatch.context() as mp:
        plant(mp)
        line = R.run(CELL, 2**31 + 41, 0.2, False, device="cpu", bench=bench, root=tiny_root)
    failed = {k for k, v, lim in line["checks"] if v is None or lim is None or v > lim}
    assert line["correct"] is False and failed, line["checks"]


def test_a_traced_cpu_run_reads_the_live_pair_counter(tiny_root, bench, monkeypatch):
    """Phase (a) runs on the CPU: the counter has a record per traced
    rollout and its reader a value; the capture counters, which only a CUDA
    graph feeds, read None.  Without the phases the reader reads None."""
    monkeypatch.setattr(profiling, "LIVE_PAIRS", [])
    assert R.metric_reader("tick_live_pairs.heavy")({"traffic": {"loop": "ppo_updates"}}) is None
    line = R.run(CELL, 2**31 + 5, 0.2, True, device="cpu", bench=bench, root=tiny_root)
    got = line["metrics"]
    recs = profiling.LIVE_PAIRS
    assert recs and {(r.num_envs, r.size_class) for r in recs} == {(8, 1)}
    assert got["tick_live_pairs.heavy"]["value"] == sum(r.warp_max for r in recs) / len(recs)
    for name in ("update_host_ms.ppo", "grad_ms.ppo", "adam_ms.ppo"):
        assert got[name]["value"] > 0, name
    assert "learner_kernels.ppo" not in got and "capture_s" not in got
    assert line["correct"] is True
