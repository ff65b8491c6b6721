"""The port's on-device renderer (``gym_puzzles_tpu_torch.render.device``)
against the JAX package's (``gym_puzzles_tpu.render.device``, jitted and
vmapped) on the CPU, on the same ``reset_fast`` states carried across with
``convert``: v0 / human vision, v2 / agent vision and v3 / human vision, at
downsample 4 and 1 (the JAX package's own parametrization,
tests/test_render.py).

The frames must be equal but for float contraction: XLA on the CPU may fuse
``a*b - c*d`` into an FMA and eager PyTorch does not, so a pixel on a
shape's edge may differ.  A differing pixel must lie on an edge of the JAX
frame (a neighbour there has another colour), and at most 0.1% of a frame's
pixels may differ (measured: none at any parametrization)."""

import numpy as np
import pytest
import torch

import jax

from gym_puzzles_tpu.render.device import make_device_renderer as jax_renderer
from gym_puzzles_tpu_torch import convert
from gym_puzzles_tpu_torch.api.registry import _logic as torch_logic
from gym_puzzles_tpu_torch.render import palette
from gym_puzzles_tpu_torch.render.device import make_device_renderer
from torch_port_helpers import assert_frames_match, jax_env, jax_spawns, np_tree

torch.set_num_threads(1)

E = 4
CASES = [("MultiRobotPuzzle-v0", "human_vision"), ("MultiRobotPuzzle-v2", "agent_vision"),
         ("MultiRobotPuzzle-v3", "human_vision")]


@pytest.mark.parametrize("downsample", [4, 1])
@pytest.mark.parametrize("env_id,mode", CASES)
def test_renderer_matches_jax(env_id, mode, downsample):
    jenv = jax_env(env_id, E)
    jstate, _ = jax_spawns(jenv, seed=5)
    jrender = jax_renderer(jenv.logic, downsample=downsample, mode=mode)
    want = np.asarray(jax.jit(jax.vmap(jrender, in_axes=-1))(jstate))

    render = make_device_renderer(torch_logic(env_id), downsample=downsample, mode=mode)
    got = render(convert.state_from_numpy(np_tree(jstate))).numpy()
    assert (render.height, render.width) == (jrender.height, jrender.width)
    n_diff = assert_frames_match(got, want)
    print(f"{env_id} {mode} downsample {downsample}: {n_diff} of {got[..., 0].size} "
          "pixels differ")
    # the frame shows the world: background, goal and bodies all painted
    colors = {tuple(c) for c in got.reshape(-1, 3)}
    assert {(0, 0, 0), palette.WHITE} <= colors
    assert (palette.BLUE in colors) == (env_id != "MultiRobotPuzzle-v2")
    assert (palette.GREY in colors) == (mode == "human_vision")


def test_renderer_follows_the_state():
    """A pose moved in the state moves in the frame: the block's centre dot
    follows the block."""
    logic = torch_logic("MultiRobotPuzzle-v0")
    state, _ = logic.reset_fast(torch.Generator().manual_seed(0), 2, logic.default_params())
    render = make_device_renderer(logic, downsample=1)
    b = logic.layout.block_slot
    pos = state.bodies.pos.clone()
    pos[b, :, 0] = torch.tensor([5.0, 5.0])
    pos[b, :, 1] = torch.tensor([15.0, 10.0])
    frames = render(state.replace(bodies=state.bodies.replace(pos=pos))).numpy()
    assert not (frames[0] == frames[1]).all()
    for e in range(2):
        x, y = (pos[b, :, e] * 30.0).tolist()
        assert tuple(frames[e, int(480 - y), int(x)]) == palette.WHITE
