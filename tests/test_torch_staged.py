"""The staged tick (``world.step_batched``) and ``backend='pallas'`` on the
CPU, where the contact solve runs its plain version.

* ``world.step_batched`` against the port's own ``world.step``: equal, bit
  for bit (both run the plain solve: this holds the split of the tick into
  ``before_solve`` / solve / ``after_solve``), on v0 and v2 spawns over
  several ticks.
* ``world.step_batched`` against ``jax.vmap(world.step)`` on the 3-body push
  world, 10 ticks at 8/4: positions within 1e-5, contact ids equal.
* ``make(..., backend='pallas', device='cpu')`` against the JAX
  ``VectorEnv(backend='xla')`` on v0: a 20-step drive, the checks of
  ``tests/test_torch_v0.py``.
* The registry's backend names, and one launch counter per kernel (the
  learner's ``adam_fused`` and the v0 env's two among them).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import gym_puzzles_tpu_torch as gpt
from gym_puzzles_tpu_torch.api.registry import _logic
from gym_puzzles_tpu_torch.engine import _cuda_build as cb
from gym_puzzles_tpu_torch.engine import solver_cuda, step_cuda
from gym_puzzles_tpu_torch.engine import world as tw
from gym_puzzles_tpu_torch.envs import v0_cuda
from gym_puzzles_tpu_torch.train import adam_fused, mlp_grad
from tests.torch_port_helpers import (both_init, compare_drive, jax_step, maxdiff,
                                      small_tables)

torch.set_num_threads(1)

DT = 1.0 / 50.0


@pytest.mark.parametrize("env_id", ["MultiRobotPuzzle-v0", "MultiRobotPuzzle-v2"])
def test_step_batched_equals_step(env_id):
    logic = _logic(env_id)
    gen = torch.Generator().manual_seed(11)
    state, _ = logic.reset_fast(gen, 12, logic.default_params())
    table = logic.layout.table
    sa = sb = state
    for _ in range(4):
        act = torch.rand((logic.cfg.act_dim, 12), generator=gen) * 2 - 1
        outs = []
        for s, tick in ((sa, tw.step), (sb, tw.step_batched)):
            bodies, force, torque, wake = logic._control(s, act)
            outs.append(tick(table, bodies, s.contacts, force, torque, wake, DT, 6, 3))
        (ba, ca, ia), (bb, cb_, ib) = outs
        for x, y in ((ba, bb), (ca.man, cb_.man), (ia, ib)):
            for name in x.__dataclass_fields__:
                assert torch.equal(getattr(x, name), getattr(y, name)), name
        assert torch.equal(ca.normal_impulse, cb_.normal_impulse)
        assert torch.equal(ca.tangent_impulse, cb_.tangent_impulse)
        sa, sb = sa.replace(bodies=ba, contacts=ca), sb.replace(bodies=bb, contacts=cb_)
    assert sa.contacts.touching.any()


def test_step_batched_matches_vmapped_jax_step():
    """The push drive of tests/test_torch_engine_contact.py through the
    staged tick."""
    jt, tt = small_tables()
    E = 4
    origin = np.broadcast_to(
        np.array([(5.0, 5.0), (2.76, 5.5), (5.0, 3.26)], np.float32)[..., None], (3, 2, E))
    jb, jc, tb, tc = both_init(jt, tt, origin, np.zeros((3, E), np.float32))
    vel = np.zeros((3, 2, E), np.float32)
    vel[1, 0], vel[2, 1] = 4 / 3.0, 4 / 3.0
    force, torque = np.zeros((3, 2, E), np.float32), np.zeros((3, E), np.float32)
    wake = np.broadcast_to(np.array([False, True, True])[:, None], (3, E))
    for _ in range(10):
        jb = jb.replace(vel=jnp.concatenate([jb.vel[:1], jnp.asarray(vel[1:])]),
                        omega=jnp.concatenate([jb.omega[:1], jnp.zeros((2, E))]))
        tb = tb.replace(vel=torch.cat([tb.vel[:1], torch.tensor(vel[1:])]),
                        omega=torch.cat([tb.omega[:1], torch.zeros(2, E)]))
        jb, jc, _ = jax_step(jt, 8, 4)(jb, jc, jnp.asarray(force), jnp.asarray(torque),
                                       jnp.asarray(wake))
        tb, tc, _ = tw.step_batched(tt, tb, tc, torch.tensor(force), torch.tensor(torque),
                                    torch.tensor(np.array(wake)), DT, 8, 4)
    assert tc.touching.any()
    assert maxdiff(jb.pos, tb.pos) <= 1e-5 and maxdiff(jb.angle, tb.angle) <= 1e-5
    np.testing.assert_array_equal(tc.man.ids.numpy(), np.asarray(jc.man.ids))
    np.testing.assert_array_equal(tb.awake.numpy(), np.asarray(jb.awake))


def test_pallas_backend_drive_matches_jax():
    env, _state = compare_drive("MultiRobotPuzzle-v0", 16, 20, 2, backend="pallas",
                                obs_tol=(1e-4, 1e-3))
    assert env.backend == "pallas"


def test_backend_names_and_defaults():
    env = gpt.make("MultiRobotPuzzle-v0", num_envs=2, device="cpu")
    assert env.backend == "fused"
    assert env._step == env.logic.step_fused
    env = gpt.make("MultiRobotPuzzle-v0", num_envs=2, device="cpu", backend="pallas")
    assert env._step == env.logic.step_batched
    for name in ("xla", "cuda", ""):
        with pytest.raises(ValueError, match="backend must be one of"):
            gpt.make("MultiRobotPuzzle-v0", num_envs=2, device="cpu", backend=name)


def test_one_launch_counter_per_kernel():
    assert set(cb.KERNELS) == {"step_fused", "solve_contacts", "adam_fused", "mlp_grad",
                               "v0_control", "v0_score_respawn"}
    assert cb.KERNELS["step_fused"] is step_cuda.KERNEL
    assert cb.KERNELS["solve_contacts"] is solver_cuda.KERNEL
    assert cb.KERNELS["adam_fused"] is adam_fused.KERNEL  # the learner's, no world table
    assert cb.KERNELS["mlp_grad"] is mlp_grad.KERNEL  # the learner's, no world table
    assert cb.KERNELS["v0_control"] is v0_cuda.CONTROL  # the v0 env's, one library
    assert cb.KERNELS["v0_score_respawn"] is v0_cuda.SCORE
    try:
        step_cuda.KERNEL.launches, solver_cuda.KERNEL.launches = 3, 5
        adam_fused.KERNEL.launches, mlp_grad.KERNEL.launches = 7, 11
        v0_cuda.CONTROL.launches, v0_cuda.SCORE.launches = 13, 17
        assert step_cuda.launch_count() == 3  # the old call still reads kernel A
        assert step_cuda.launch_count("step_fused") == 3
        assert step_cuda.launch_count("solve_contacts") == 5
        assert cb.launch_count("adam_fused") == 7
        assert cb.launch_count("mlp_grad") == 11
        assert cb.launch_count("v0_control") == 13
        assert cb.launch_count("v0_score_respawn") == 17
        with pytest.raises(KeyError):
            step_cuda.launch_count("no_such_kernel")
    finally:
        step_cuda.reset_launch_count()
    assert step_cuda.launch_count() == 0 and cb.launch_count("solve_contacts") == 0
    assert cb.launch_count("adam_fused") == 0 and cb.launch_count("mlp_grad") == 0
    assert cb.launch_count("v0_control") == 0 and cb.launch_count("v0_score_respawn") == 0
    # a CPU step launches nothing
    env = gpt.make("MultiRobotPuzzle-v0", num_envs=2, device="cpu", backend="pallas",
                   velocity_iters=2, position_iters=1)
    state, _ = env.reset(seed=0)
    env.step(state, torch.zeros(2, env.cfg.act_dim))
    assert cb.launch_count("solve_contacts") == 0 and cb.launch_count("step_fused") == 0
