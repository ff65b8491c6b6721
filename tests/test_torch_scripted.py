"""The port's scripted controllers (``train/scripted.py``) against the JAX
package's on the CPU: ``pusher_action`` and ``planner_action`` on 256 seeded
v0-family obs for 2 (v0), 3 and 5 (Heavy-v0) agents, within 1e-5; and the
port's copy of the JAX package's ``test_planner_action_contract``."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gym_puzzles_tpu.train import scripted as jscripted
from gym_puzzles_tpu_torch.api.registry import _logic as torch_logic
from gym_puzzles_tpu_torch.train import scripted

torch.set_num_threads(1)

# the heavy T's outline (local, m) at angle 0, in px (30 px per m)
T_OUTLINE = np.array([[-1, -2], [1, -2], [1, 0], [-1, 0],
                      [-3, 0], [3, 0], [3, 2], [-3, 2]], float) * 30.0
GOAL = np.array([320.0, 262.5])


def seeded_obs(num_agents, E=256, seed=0):
    """[E, 4A + 20] v0-family obs from a numpy seed: agents around the
    block (agent - block, px, and the distance), block - goal and its
    distance, the block's 8 outline vertices in world px at a random angle."""
    rng = np.random.RandomState(seed)
    A = num_agents
    obs = np.zeros((E, 4 * A + 20), np.float32)
    rel = rng.uniform(-300, 300, (E, A, 2))
    agents = obs[:, : 4 * A].reshape(E, A, 4)
    agents[..., 0:2] = rel
    agents[..., 2] = np.linalg.norm(rel, axis=-1)
    obs[:, : 4 * A] = agents.reshape(E, 4 * A)
    b2g = rng.uniform(-250, 250, (E, 2))
    obs[:, 4 * A: 4 * A + 2] = b2g
    obs[:, 4 * A + 3] = np.linalg.norm(b2g, axis=-1)
    bc = GOAL + b2g
    ang = rng.uniform(-np.pi, np.pi, E)
    c, s = np.cos(ang)[:, None], np.sin(ang)[:, None]
    vx = bc[:, :1] + c * T_OUTLINE[None, :, 0] - s * T_OUTLINE[None, :, 1]
    vy = bc[:, 1:] + s * T_OUTLINE[None, :, 0] + c * T_OUTLINE[None, :, 1]
    obs[:, 4 * A + 4:] = np.stack([vx, vy], axis=-1).reshape(E, 16)
    return obs


@pytest.mark.parametrize("num_agents", [2, 3, 5])
@pytest.mark.parametrize("name,kw", [("pusher_action", {}),
                                     ("pusher_action", {"offset_px": 90.0, "push_px": 0.5}),
                                     ("planner_action", {}),
                                     ("planner_action", {"gate": 1, "tol_px": 60.0})])
def test_controller_matches_jax(name, kw, num_agents):
    obs = seeded_obs(num_agents, seed=num_agents)
    want = np.asarray(getattr(jscripted, name)(jnp.asarray(obs), num_agents, **kw))
    got = getattr(scripted, name)(torch.from_numpy(obs), num_agents, **kw)
    assert got.shape == (256, 3 * num_agents) and got.dtype == torch.float32
    d = float(np.abs(got.numpy() - want).max())
    print(f"{name} {kw} A={num_agents}: max |diff| {d:.3e}")
    assert d <= 1e-5
    assert (got.abs() <= 1.0).all() and (got.view(256, num_agents, 3)[..., 2] == 0).all()


@pytest.mark.parametrize("env_id", ["MultiRobotPuzzle-v0", "MultiRobotPuzzleHeavy-v0"])
def test_controllers_match_jax_on_spawns(env_id):
    """Both controllers on the obs of 256 spawns of the env they drive."""
    logic = torch_logic(env_id)
    _state, obs = logic.reset_fast(torch.Generator().manual_seed(0), 256, logic.default_params())
    obs = obs.T.contiguous()  # [E, obs_dim]
    A = logic.cfg.num_agents
    for name in ("pusher_action", "planner_action"):
        want = np.asarray(getattr(jscripted, name)(jnp.asarray(obs.numpy()), A))
        got = getattr(scripted, name)(obs, A).numpy()
        d = float(np.abs(got - want).max())
        print(f"{name} on {env_id} spawns: max |diff| {d:.3e}")
        assert d <= 1e-5


def test_planner_action_contract():
    """Action bounds, finiteness, and the behavioural contract on a
    constructed Heavy-v0 obs: agents slotted behind the block with the gate
    open push toward the goal; a scattered formation does not push."""
    A = 5
    bc = GOAL + np.array([150.0, 0.0])  # block 150 px right of the goal
    verts = bc[None] + T_OUTLINE - np.array([0.0, 15.0])[None]
    # push direction u = (-1, 0): slots sit on the +x side of the block,
    # all five agents already there
    rel = np.stack([np.array([114.0, off]) for off in (-92.0, -46.0, 0.0, 46.0, 92.0)])
    obs = np.zeros((1, 40), np.float32)
    for i in range(A):
        obs[0, 4 * i: 4 * i + 2] = rel[i]
        obs[0, 4 * i + 2] = np.linalg.norm(rel[i])
    obs[0, 20:22] = bc - GOAL
    obs[0, 23] = np.linalg.norm(bc - GOAL)
    obs[0, 24:40] = verts.reshape(-1)
    act = scripted.planner_action(torch.from_numpy(obs), A).numpy().reshape(A, 3)
    assert np.isfinite(act).all() and (np.abs(act) <= 1.0).all()
    # gate open (all arrived): every agent drives toward the goal (-x)
    assert (act[:, 0] < -0.9).all(), act

    rel2 = np.stack([np.array([-400.0, 300.0]), np.array([300.0, 300.0]),
                     np.array([-350.0, -250.0]), np.array([400.0, -100.0]),
                     np.array([350.0, 200.0])])
    obs2 = obs.copy()
    for i in range(A):
        obs2[0, 4 * i: 4 * i + 2] = rel2[i]
        obs2[0, 4 * i + 2] = np.linalg.norm(rel2[i])
    act2 = scripted.planner_action(torch.from_numpy(obs2), A).numpy().reshape(A, 3)
    assert np.isfinite(act2).all() and (np.abs(act2) <= 1.0).all()
    # agents left of the block (goal side, far) move right (+x), toward the
    # block and their slots rather than away
    assert act2[0, 0] > 0.0 and act2[2, 0] > 0.0, act2
