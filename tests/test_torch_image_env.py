"""The port's image env (``gym_puzzles_tpu_torch.api.image_obs``) against the
JAX package's ``DeviceImageVectorEnv(backend='xla')`` on the CPU, and
frameskip on the port's fused path.

* From one JAX reset carried across with ``convert``, both envs step 4 v0
  envs (downsample 8, frameskip 4, 8/4 solver iterations) with the same
  actions.  While an env has had no contact its frames match (equal but for
  edge pixels, as in tests/test_torch_render.py; measured: all equal) and
  its reward is within the v0 env tests' tolerance (1e-3 absolute;
  measured 2.3e-4); ``done`` is equal throughout.  Spawns often start in
  contact at frameskip 4: the reset key is one that leaves two of the four
  envs free of contact for the whole drive.  The stacks match the JAX layout on
  every shift and on a forced ``done`` (the episode clock set to its last
  step in both), where both start a fresh zero-padded stack.
* The port's own reset stack: ``obs_depth - 1`` zero frames, then the
  rendered frame; autoreset renders the fresh spawn into a fresh stack.
* A frameskip-4 step is four engine ticks, the first with the step's
  controls, bitwise; on the card it is four launches of the fused tick
  kernel (marked ``cuda``).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gym_puzzles_tpu.api.image_obs import DeviceImageVectorEnv as JaxImageEnv
from gym_puzzles_tpu.api.registry import _image_logic as jax_image_logic
from gym_puzzles_tpu_torch import convert
from gym_puzzles_tpu_torch.api.image_obs import DeviceImageVectorEnv
from gym_puzzles_tpu_torch.api.registry import _image_logic
from gym_puzzles_tpu_torch.engine import step_cuda
from gym_puzzles_tpu_torch.engine import world as tw
from torch_port_helpers import assert_frames_match, np_tree

torch.set_num_threads(1)

ENV_ID = "MultiRobotPuzzle-v0"
E, DOWNSAMPLE, STEPS, DEPTH = 4, 8, 6, 3
ITERS = dict(velocity_iters=8, position_iters=4)
H, W = 480 // DOWNSAMPLE, 640 // DOWNSAMPLE


def frames_of(obs):
    """[N, depth * h, w, 3] stacked obs -> [N * depth, h, w, 3] frames."""
    obs = np.asarray(obs)
    return obs.reshape(obs.shape[0] * DEPTH, H, W, 3)


def with_clock(jist, tist, t):
    """Both image states with the episode clock of env 0 set to ``t``."""
    jt = jist.vec.env.t.at[0].set(t)
    jist = jist.replace(vec=jist.vec.replace(env=jist.vec.env.replace(t=jt)))
    tt = tist.vec.t.clone()
    tt[0] = t
    return jist, tist.replace(vec=tist.vec.replace(t=tt))


def test_image_env_matches_jax():
    jenv = JaxImageEnv(ENV_ID, num_envs=E, downsample=DOWNSAMPLE, auto_reset=False, **ITERS)
    tenv = DeviceImageVectorEnv(ENV_ID, num_envs=E, downsample=DOWNSAMPLE, auto_reset=False,
                                device="cpu", **ITERS)
    assert tenv.obs_shape == jenv.obs_shape == (DEPTH * H, W, 3)
    assert tenv.cfg.frameskip == jenv.cfg.frameskip == 4
    jstep = jax.jit(jenv.step)
    jist, jobs = jenv.reset(jax.random.key(2))
    tist = convert.image_state_from_numpy({"vec": np_tree(jist.vec.env),
                                           "frames": np.asarray(jist.frames)})
    # the reset stack: zero frames, then the frame of the spawned state,
    # which the port renders as the JAX env did
    jobs_np = np.asarray(jobs)
    assert not jobs_np[:, :2 * H].any()
    assert_frames_match(tenv.render(tist.vec).numpy(), jobs_np[:, 2 * H:])
    rng = np.random.RandomState(0)
    contacted = np.zeros(E, bool)
    reward_diff, n_diff = 0.0, 0
    last = STEPS - 1
    tobs = None
    for k in range(STEPS):
        if k == last:  # force done in env 0: its episode clock reaches the limit
            jist, tist = with_clock(jist, tist, tenv.cfg.max_episode_steps - 1)
        a = rng.uniform(-1, 1, (E, 6)).astype(np.float32)
        prev = (np.asarray(jobs), tobs.numpy()) if k else (np.asarray(jobs),) * 2
        jist, jobs, jrew, jdone, _ = jstep(jist, jnp.asarray(a), jenv.default_params())
        tist, tobs, trew, tdone, _ = tenv.step(tist, torch.from_numpy(a))
        contacted |= np.asarray(jist.vec.env.contacts.touching).any(axis=0)
        contacted |= tist.vec.contacts.touching.any(dim=0).numpy()
        free = ~contacted
        jobs_np, tobs_np = np.asarray(jobs), tobs.numpy()
        assert tobs.dtype == torch.uint8 and tobs.shape == jobs_np.shape
        n_diff += assert_frames_match(frames_of(tobs_np[free]), frames_of(jobs_np[free]))
        reward_diff = max(reward_diff, float(np.abs(trew.numpy() - np.asarray(jrew))[free]
                                             .max(initial=0.0)))
        np.testing.assert_array_equal(tdone.numpy(), np.asarray(jdone))
        # the stack layout: shifted by one frame, or fresh where done
        done = np.asarray(jdone)
        assert done[0] == (k == last) and not done.all()
        for obs, before in zip((jobs_np, tobs_np), prev):
            np.testing.assert_array_equal(obs[~done, :2 * H], before[~done, H:])
            assert not obs[done, :2 * H].any() and all(o.any() for o in obs[done, 2 * H:])
    assert free.any() and not free.all(), "the drive should bring some envs, not all, into contact"
    print(f"max reward diff before contact {reward_diff:.3e}; {n_diff} frame pixels differ")
    assert reward_diff <= 1e-3


def test_reset_and_autoreset_stacks():
    env = DeviceImageVectorEnv(ENV_ID, num_envs=2, downsample=DOWNSAMPLE, device="cpu",
                               velocity_iters=2, position_iters=1)
    assert env.image_pipeline == (DEPTH, 4, DOWNSAMPLE, "human_vision", "t")
    ist, obs = env.reset(seed=0)
    assert obs.shape == (2, DEPTH * H, W, 3) and obs.dtype == torch.uint8
    assert not obs[:, :2 * H].any()
    assert torch.equal(obs[:, 2 * H:], env.render(ist.vec))
    assert torch.equal(ist.frames[:, -1], env.render(ist.vec))
    # env 1 reaches its episode limit: autoreset spawns it afresh, and its
    # stack starts over from the fresh spawn's frame
    t = ist.vec.t.clone()
    t[1] = env.cfg.max_episode_steps - 1
    ist = ist.replace(vec=ist.vec.replace(t=t))
    ist2, obs2, _r, done, _ = env.step(ist, torch.zeros(2, 6))
    assert done.tolist() == [False, True]
    assert int(ist2.vec.t[1]) == 0
    assert torch.equal(obs2[0, :2 * H], obs[0, H:])
    assert not obs2[1, :2 * H].any()
    assert torch.equal(obs2[:, 2 * H:], env.render(ist2.vec))


# --------------------------------------------------------------------------
# frameskip > 1 on the fused path
# --------------------------------------------------------------------------


def test_frameskip_step_is_four_ticks(monkeypatch):
    """A frameskip-4 v0 step through the fused path equals four plain ticks
    (controls, force and wake on the first only), bitwise, and makes four
    calls of the fused tick entry point."""
    logic = _image_logic(ENV_ID, 4, "t", 8, 4)
    assert logic.cfg.frameskip == 4 and jax_image_logic(ENV_ID, 4).cfg.frameskip == 4
    params = logic.default_params()
    state, _ = logic.reset_fast(torch.Generator().manual_seed(0), 3, params)
    act = torch.rand((6, 3), generator=torch.Generator().manual_seed(1)) * 2 - 1

    calls = []
    fused = step_cuda.step_fused
    monkeypatch.setattr(step_cuda, "step_fused", lambda *a, **kw: (calls.append(1),
                                                                  fused(*a, **kw))[1])
    new, *_ = logic.step_fused(state, act, params)
    assert len(calls) == 4

    table, cfg = logic.layout.table, logic.cfg
    bodies, force, torque, wake = logic._control(state, act)
    contacts = state.contacts
    for k in range(4):
        if k:
            force, torque, wake = (torch.zeros_like(x) for x in (force, torque, wake))
        bodies, contacts, _ = tw.step(table, bodies, contacts, force, torque, wake, cfg.dt,
                                      cfg.velocity_iters, cfg.position_iters)
    for name in ("pos", "angle", "vel", "omega", "awake", "sleep_time"):
        assert torch.equal(getattr(new.bodies, name), getattr(bodies, name)), name
    assert torch.equal(new.contacts.normal_impulse, contacts.normal_impulse)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; on the card chip_smoke.py runs these checks")
    return torch.device("cuda")


@pytest.mark.cuda
def test_frameskip_launches_on_card(cuda_device):
    env = DeviceImageVectorEnv(ENV_ID, num_envs=256, device=cuda_device)
    ist, _ = env.reset(seed=0)
    step_cuda.reset_launch_count()
    for k in range(3):
        ist, *_ = env.step(ist, torch.zeros(256, 6, device=cuda_device))
        assert step_cuda.launch_count("step_fused") == 4 * (k + 1)
    assert step_cuda.launch_count("solve_contacts") == 0
