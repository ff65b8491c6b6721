"""A copy of the benchmark's files at a size the CPU can run in seconds:
8 envs, 4/2 solver iterations, 4-step rollouts, a few traced steps, and
episodes of 24 steps on both sides so that the checked steps come early."""

import contextlib
import dataclasses
import json
import re
import shutil
from pathlib import Path

import pytest
import torch

BENCH = Path(__file__).resolve().parents[1]
REPO = BENCH.parent
ENV_ID = "MultiRobotPuzzle-v0"
EPISODE = 24
# the loops' constants at the tiny size
TINY = {"ACTION_POOL_STEPS": 8, "TRACE_STEPS": 3, "TIMED_UPDATES": 1, "TRACE_UPDATES": 1}


def make_tiny_root(dest: Path) -> Path:
    root = dest / "portbench"
    shutil.copytree(BENCH, root, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    for p in (root / "configs").glob("*.json"):
        d = json.loads(p.read_text())
        d["env"].update(num_envs=8, velocity_iters=4, position_iters=2)
        d["ppo"].update(n_steps=4, batch_size=16, n_epochs=2)
        p.write_text(json.dumps(d))
    for p in (root / "loops").glob("*.py"):
        text = p.read_text()
        for name, value in TINY.items():
            text = re.sub(rf"^{name} = \d+", f"{name} = {value}", text, flags=re.M)
        p.write_text(text)
    return root


@contextlib.contextmanager
def short_episodes(steps: int = EPISODE):
    """The v0 episode limit at ``steps`` in the port's registry and in the
    reference's, their caches of env logic cleared on the way in and out."""
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


@pytest.fixture(scope="session")
def tiny_files(tmp_path_factory):
    torch.set_num_threads(2)
    return make_tiny_root(tmp_path_factory.mktemp("tiny"))


@pytest.fixture
def tiny_root(tiny_files):
    with short_episodes():
        yield tiny_files


@pytest.fixture(scope="session")
def bench():
    return json.loads((REPO / "BENCHMARK.json").read_text())
