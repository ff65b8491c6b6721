"""Port's static tables against the JAX package's: every ShapeTable array and
the layout's static masks, equal array for array (np.array_equal), for all
five env ids, the v0 L and I blocks, and a 3-agent heavy v3 world."""

import dataclasses

import numpy as np
import pytest
import torch

from gym_puzzles_tpu.envs import config as jcfg
from gym_puzzles_tpu.envs import layout as jlay
from gym_puzzles_tpu_torch import convert
from gym_puzzles_tpu_torch.envs import config as tcfg
from gym_puzzles_tpu_torch.envs import layout as tlay

torch.set_num_threads(1)

CASES = [
    ("MultiRobotPuzzle-v0", {}),
    ("MultiRobotPuzzleHeavy-v0", {}),
    ("MultiRobotPuzzle-v2", {}),
    ("MultiRobotPuzzleHeavy-v2", {}),
    ("MultiRobotPuzzle-v3", {}),
    ("MultiRobotPuzzle-v0", {"block_shape": "l"}),
    ("MultiRobotPuzzle-v0", {"block_shape": "i"}),
    ("MultiRobotPuzzle-v3", {"num_agents": 3, "heavy": True}),
]


@pytest.mark.parametrize("env_id, changes", CASES,
                         ids=[f"{e}-{'-'.join(f'{k}={v}' for k, v in c.items())}"
                              for e, c in CASES])
def test_tables_equal(env_id, changes):
    jl, jwalls = jlay.build(dataclasses.replace(jcfg.VARIANTS[env_id], **changes))
    tl, twalls = tlay.build(dataclasses.replace(tcfg.VARIANTS[env_id], **changes))

    jt = {f.name: np.asarray(getattr(jl.table, f.name))
          for f in dataclasses.fields(jl.table)}
    tt = convert.shape_table_to_numpy(tl.table)
    assert jt.keys() == tt.keys()
    for name in jt:
        assert jt[name].dtype == tt[name].dtype, name
        assert np.array_equal(jt[name], tt[name]), name

    for name in ("agent_slots", "agent_block_pairs", "agent_wall_pairs", "block_verts"):
        assert np.array_equal(getattr(jl, name), getattr(tl, name)), name
    assert (jl.num_agents, jl.block_slot, jl.world_w, jl.world_h) == (
        tl.num_agents, tl.block_slot, tl.world_w, tl.world_h)
    assert np.array_equal(jwalls, twalls)


def test_reward_params_equal():
    """Default reward weights, float32-rounded identically, for every variant."""
    for variant in ("v0", "v2", "v3"):
        jp = jcfg.RewardParams.default(variant)
        tp = tcfg.RewardParams.default(variant)
        for f in dataclasses.fields(tp):
            assert np.float32(getattr(tp, f.name)) == getattr(jp, f.name), (variant, f.name)
