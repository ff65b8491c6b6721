"""The step bodies that the port's CUDA graphs capture (``utils/cuda_graph.py``),
on the CPU, at 8/4 solver iterations.

* Reward parameters as 0-d float32 tensors (the graph's params buffer) give
  the same state, obs, reward, done and info bit for bit as Python floats,
  on all five ids, through both backends, across autoresets; and the v2
  score on injected states that reach every termination branch.
* With the curriculum moved (``update_goal`` on v2, ``update_params`` on v0)
  the tensor-param step still agrees with the JAX package's step given the
  same params, under the contract of ``tests/test_torch_v0.py``: while an env
  has had no contact, obs within 1e-4 and reward within 1e-3; done and
  done_status equal at every step; returns after that.
* A state or obs a step returned is unchanged by the next step (flat and
  image envs).
* ``PPO.rollout`` (its steps in ``PPO.rollout_steps``, the function the
  graph captures) equals a rollout written out through the public
  ``env.step`` bit for bit, given the same noise, MLP and CNN.
* The graph module's host side: tree flattening, the static buffers' layout
  (strides kept, 512-byte alignment), copy-in skipped for an unchanged
  input, the params buffer written only when a value changes.
* ``cuda``-marked (skipped without a card; ``chip_smoke.py`` phase 16 runs
  them at full width): a replay equals the eager body bit for bit.
"""

import dataclasses
import gc
import io
import weakref

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import gym_puzzles_tpu_torch as gpt
from gym_puzzles_tpu.api.vector import VectorState
from gym_puzzles_tpu_torch import convert
from gym_puzzles_tpu_torch.api.image_obs import DeviceImageVectorEnv
from gym_puzzles_tpu_torch.envs import config as C
from gym_puzzles_tpu_torch.envs import common as cm
from gym_puzzles_tpu_torch.train import normalize as nrm
from gym_puzzles_tpu_torch.train.networks import gaussian_log_prob
from gym_puzzles_tpu_torch.train.ppo import PPO, PPOConfig, Transition
from gym_puzzles_tpu_torch.utils import cuda_graph as cg
from tests.torch_port_helpers import ITERS, jax_env, jax_spawns, np_tree

torch.set_num_threads(1)

E = 4


def tensor_params(params):
    """``params`` as the CUDA graph reads them: 0-d views of one float32
    buffer (here on the CPU)."""
    buf = cg.ParamsBuffer("cpu")
    buf.load(params)
    return buf.view


def moved_params(env):
    """Reward params away from the defaults: the curriculum's updates."""
    p = env.default_params().update_params(20_000, 0.9999)
    if env.cfg.variant == "v2":
        p = p.update_goal(3, 10, C.V2_EPSILON)
    return p.set_reward_params(agentDistance=0.3)


def assert_bitwise(a, b):
    la, sa = cg.flatten(a)
    lb, sb = cg.flatten(b)
    assert sa == sb
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and torch.equal(x, y)


def drive(env, params, steps, seed=1):
    state, obs = env.reset(seed=seed, params=params)
    rng = np.random.RandomState(seed)
    outs = [(state, obs)]
    for _ in range(steps):
        a = torch.as_tensor(rng.uniform(-1, 1, (env.num_envs, env.cfg.act_dim))
                            .astype(np.float32))
        out = env.step_eager(state, a, params)
        state = out[0]
        outs.append(out)
    return outs


@pytest.mark.parametrize("backend", ["fused", "pallas"])
@pytest.mark.parametrize("env_id", gpt.ENV_IDS)
def test_tensor_params_step_bitwise(env_id, backend):
    # max_episode_steps=1: the second step starts from autoreset spawns
    env = gpt.make(env_id, num_envs=E, device="cpu", backend=backend, max_episode_steps=1,
                   **ITERS)
    params = moved_params(env)
    floats = drive(env, params, 2)
    tensors = drive(env, tensor_params(params), 2)
    assert bool(floats[1][3].all())  # the autoreset happened
    assert_bitwise(floats, tensors)


def test_v2_score_tensor_params_bitwise():
    """Every v2 termination branch (running, agent OOB, block OOB, complete,
    and the OOB priorities), float against tensor params."""
    logic = gpt.make("MultiRobotPuzzle-v2", num_envs=6, device="cpu", **ITERS).logic
    w, h = logic.layout.world_w, logic.layout.world_h
    origin = np.zeros((7, 2, 6), np.float32)
    origin[:4] = np.asarray(logic.wall_positions, np.float32)[..., None]
    origin[4] = np.array([[w / 2], [h / 2]])
    origin[5], origin[6] = np.array([[0.5], [0.4]]), np.array([[0.6], [1.0]])
    origin[5, 0, [1, 4, 5]] = 0.05  # agent 0 beyond the left bound
    origin[4, 1, [2, 5]] = h - 0.05  # block beyond the top bound
    goal = np.tile(np.array([[0.8], [0.3], [0.0]], np.float32), (1, 6))
    ratio = float(np.float32(C.V2_RATIO))
    origin[4, :, 3:5] = goal[:2, 3:5] / ratio  # block near its goal
    state = logic.inject(torch.as_tensor(origin), torch.zeros((7, 6)), goal)
    state = state.replace(goal_contact=torch.tensor([[0, 0, 0, 1, 1, 1], [0] * 6], dtype=bool),
                          blks_in_place=torch.tensor([0, 1, 1, 0, 0, 1], dtype=torch.int32))
    params = logic.default_params().update_goal(0, 10, 0.05).update_params(5000, 0.9999)
    score = lambda p: logic._score(state, state.bodies, state.goal_contact,  # noqa: E731
                                   *logic._distances(state.bodies, state.goal_pos), p)
    floats, tensors = score(params), score(tensor_params(params))
    assert floats[3].tolist() == [0, 1, 2, 3, 1, 1]
    assert_bitwise(floats, tensors)


def jax_step(jenv, state, action, params):
    vs = VectorState(env=state, key=jax.random.split(jax.random.key(0), jenv.num_envs))
    vs, obs, reward, done, info = jenv.step(vs, jnp.asarray(action), params)
    return vs.env, np.asarray(obs), np.asarray(reward), np.asarray(done), info


@pytest.mark.parametrize("env_id, kw", [("MultiRobotPuzzle-v0", {}),
                                        ("MultiRobotPuzzle-v2",
                                         dict(simple=False, anywhere=True))])
def test_curriculum_params_match_jax(env_id, kw):
    n, steps = 16, 6
    jenv = jax_env(env_id, n, **kw)
    tenv = gpt.make(env_id, num_envs=n, auto_reset=False, device="cpu", **ITERS, **kw)
    if env_id.endswith("v0"):
        jp = jenv.default_params().update_params(40_000, 0.9999)
        tp = tenv.default_params().update_params(40_000, 0.9999)
    else:
        jp = jenv.default_params().update_goal(7, 10, C.V2_EPSILON)
        tp = tenv.default_params().update_goal(7, 10, C.V2_EPSILON)
    for f in dataclasses.fields(tp):  # the port's curriculum gives JAX's floats
        assert np.float32(getattr(tp, f.name)) == np.float32(getattr(jp, f.name)), f.name
    tview = tensor_params(tp)
    jstate, _ = jax_spawns(jenv, 3)
    tstate = convert.state_from_numpy(np_tree(jstate))
    rng = np.random.RandomState(3)
    contacted = np.zeros(n, bool)
    ret_j, ret_t = np.zeros(n), np.zeros(n)
    for _ in range(steps):
        a = rng.uniform(-1, 1, (n, tenv.cfg.act_dim)).astype(np.float32)
        jstate, jobs, jrew, jdone, jinfo = jax_step(jenv, jstate, a, jp)
        tstate, tobs, trew, tdone, tinfo = tenv.step_eager(tstate, torch.as_tensor(a), tview)
        contacted |= np.asarray(jstate.contacts.touching).any(axis=0)
        contacted |= tstate.contacts.touching.any(dim=0).numpy()
        free = ~contacted
        np.testing.assert_allclose(tobs.numpy()[free], jobs[free], rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(trew.numpy()[free], jrew[free], atol=1e-3)
        np.testing.assert_array_equal(tdone.numpy(), jdone)
        np.testing.assert_array_equal(tinfo["done_status"].numpy(),
                                      np.asarray(jinfo["done_status"]))
        ret_j += jrew
        ret_t += trew.numpy()
    assert not contacted.all()
    np.testing.assert_allclose(ret_t, ret_j, rtol=1e-4, atol=1e-2)


def test_returned_state_unchanged_by_next_step():
    env = gpt.make("MultiRobotPuzzle-v0", num_envs=E, device="cpu", max_episode_steps=1,
                   **ITERS)
    state, _ = env.reset(seed=0)
    a = torch.full((E, env.cfg.act_dim), 0.5)
    out = env.step(state, a)
    kept = cg.unflatten(cg.flatten(out)[1], [x.clone() for x in cg.flatten(out)[0]])
    env.step(out[0], a)
    assert_bitwise(out, kept)

    img = DeviceImageVectorEnv(num_envs=2, downsample=16, device="cpu", **ITERS)
    ist, _ = img.reset(seed=0)
    out = img.step(ist, torch.zeros((2, 6)))
    kept = cg.unflatten(cg.flatten(out)[1], [x.clone() for x in cg.flatten(out)[0]])
    img.step(out[0], torch.ones((2, 6)))
    assert_bitwise(out, kept)


def written_out_rollout(algo, ts, noise):
    """A rollout written out step by step through the public ``env.step``:
    normalize, policy, sample, step, reward normalization, episode counters."""
    T, E_ = algo.cfg.n_steps, algo.cfg.n_envs
    traj = {k: [] for k in ("obs", "action", "log_prob", "value", "reward", "done", "status")}
    norm, vstate, obs = ts.normalizer, ts.vstate, ts.last_obs
    ep_ret, ep_len, stat_r, stat_c = ts.ep_return, ts.ep_len, ts.stat_return, ts.stat_count
    for t in range(T):
        if algo.use_obs_norm:
            norm, n_obs = nrm.normalize_obs(norm, obs, update=True)
        else:
            n_obs = obs
        mean, log_std, value = algo.apply(ts.params, n_obs)
        action = mean + torch.exp(log_std) * noise[t]
        traj["obs"].append(n_obs)
        traj["action"].append(action)
        traj["value"].append(value)
        traj["log_prob"].append(gaussian_log_prob(mean, log_std, action))
        vstate, obs, reward, done, info = algo.env.step(vstate, torch.clamp(action, -1.0, 1.0),
                                                        ts.env_params)
        norm, n_reward = nrm.normalize_reward(norm, reward, done, update=True)
        ep_ret = ep_ret + reward
        ep_len = ep_len + 1
        stat_r = stat_r + torch.where(done, ep_ret, 0.0).sum()
        stat_c = stat_c + done.sum()
        ep_ret = torch.where(done, 0.0, ep_ret)
        ep_len = torch.where(done, 0, ep_len)
        traj["reward"].append(n_reward)
        traj["done"].append(done)
        traj["status"].append(info["done_status"])
    n_last = nrm.normalize_obs(norm, obs, update=False)[1] if algo.use_obs_norm else obs
    last_value = algo.apply(ts.params, n_last)[2]
    ts = ts.replace(normalizer=norm, vstate=vstate, last_obs=obs, ep_return=ep_ret,
                    ep_len=ep_len, stat_return=stat_r, stat_count=stat_c)
    traj = Transition(**{k: torch.stack(v) for k, v in traj.items()})
    assert traj.obs.shape[:2] == (T, E_)
    return ts, traj, last_value


@pytest.mark.parametrize("policy", ["mlp", "cnn"])
def test_rollout_matches_written_out_rollout(policy):
    small = dict(n_envs=2, n_steps=2, batch_size=4, n_epochs=1, max_episode_steps=1,
                 **ITERS)
    if policy == "mlp":
        algo = PPO(PPOConfig(**small), device="cpu")
    else:
        del small["max_episode_steps"]
        algo = PPO(PPOConfig(policy="cnn", **small), device="cpu",
                   env=DeviceImageVectorEnv(num_envs=2, downsample=16, device="cpu", **ITERS))
    ts = algo.init_state()
    ts = ts.replace(env_params=moved_params(algo.env))
    noise = torch.randn((2, 2, algo.act_dim), generator=torch.Generator().manual_seed(5))
    gen_state = algo.env.generator.get_state()
    got = algo.rollout(ts, noise)
    algo.env.generator.set_state(gen_state)
    want = written_out_rollout(algo, ts, noise)
    assert_bitwise(got[1:], want[1:])
    for name in ("normalizer", "vstate", "last_obs", "ep_return", "ep_len", "stat_return",
                 "stat_count"):
        assert_bitwise(getattr(got[0], name), getattr(want[0], name))
    # the step body with the graph's tensor params: the same bits
    algo.env.generator.set_state(gen_state)
    carry = (ts.normalizer, ts.vstate, ts.last_obs, ts.ep_return, ts.ep_len,
             ts.stat_return, ts.stat_count)
    traj = algo.new_transition()
    out = algo.rollout_steps(carry, ts.params, noise, tensor_params(ts.env_params), traj)
    assert_bitwise(traj, got[1])
    assert_bitwise(out[1], got[0].vstate)


# --------------------------------------------------------------------------
# the graph module's host side
# --------------------------------------------------------------------------


def test_flatten_round_trip():
    env = gpt.make("MultiRobotPuzzle-v3", num_envs=E, device="cpu")
    state, obs = env.reset(seed=0)
    tree = (state, obs, {"a": obs[0], "gamma": 0.99}, env.default_params())
    leaves, spec = cg.flatten(tree)
    assert sum(isinstance(x, C.RewardParams) for x in leaves) == 1
    back = cg.unflatten(spec, leaves)
    assert back[2]["gamma"] == 0.99 and back[3] is tree[3]
    assert isinstance(back[0], cm.EnvState) and back[0].bodies.pos is state.bodies.pos
    assert cg.flatten(back)[1] == spec
    # a static leaf or a shape that differs makes another signature
    assert cg.flatten((state, obs, {"a": obs[0], "gamma": 0.9}, tree[3]))[1] != spec
    assert cg.flatten((state, obs[:2], tree[2], tree[3]))[1] != spec


def test_flat_buffer_keeps_layout():
    obs_t = torch.arange(12.0).view(3, 4).T  # a transposed (dense) view
    gapped = torch.arange(20.0).view(4, 5)[:, :3]  # not dense: stored contiguous
    like = [obs_t, torch.ones((), dtype=torch.int64), torch.zeros(3, dtype=torch.bool), gapped]
    fb = cg.FlatBuffer(like, "cpu")
    for v, x in zip(fb.views, like):
        v.copy_(x)
        assert v.shape == x.shape and v.dtype == x.dtype and torch.equal(v, x)
        assert v.data_ptr() % cg.ALIGN == fb.buffers[v.dtype].data_ptr() % cg.ALIGN
    assert fb.views[0].stride() == obs_t.stride() and fb.views[3].is_contiguous()
    assert fb.holds(fb.views[2]) and not fb.holds(obs_t)
    snap = fb.snapshot()
    assert all(torch.equal(a, b) for a, b in zip(snap, like))
    assert snap[0].data_ptr() != fb.views[0].data_ptr()
    # one buffer per dtype: torch.save takes views of the snapshot
    buf = io.BytesIO()
    torch.save(snap, buf)
    buf.seek(0)
    assert all(torch.equal(a, b) for a, b in zip(torch.load(buf), like))


def test_slots_copy_only_what_changed():
    fb = cg.FlatBuffer([torch.zeros(3)], "cpu")
    slot = cg._Slot(fb.views[0])
    x = torch.tensor([1.0, 2.0, 3.0])
    slot.load(x)
    fb.views[0].fill_(7.0)  # stands in for the graph writing its output there
    slot.load(x)  # the same tensor, unchanged: not copied again
    assert fb.views[0].tolist() == [7.0] * 3
    x.add_(1.0)  # changed in place: copied
    slot.load(x)
    assert fb.views[0].tolist() == [2.0, 3.0, 4.0]
    slot.load(x.clone())  # another tensor: copied
    assert fb.views[0].tolist() == [2.0, 3.0, 4.0]

    pb = cg.ParamsBuffer("cpu")
    params = C.RewardParams.default("v2")
    pb.load(params)
    assert float(pb.view.scaled_epsilon) == params.scaled_epsilon
    pb.buffer.zero_()
    pb.load(params.replace())  # equal values: not written again
    assert float(pb.view.scaled_epsilon) == 0.0
    pb.load(params.update_goal(5, 10, C.V2_EPSILON))
    assert float(pb.view.scaled_epsilon) == np.float32(C.V2_EPSILON * 1.5)


def test_weak_call_keeps_no_cycle():
    env = gpt.make("MultiRobotPuzzle-v0", num_envs=E, device="cpu")
    call = cg.weak_call(env.default_params)
    assert call() == env.default_params()
    ref = weakref.ref(env)
    gc.disable()
    try:
        del env
        assert ref() is None  # freed by its reference count alone
    finally:
        gc.enable()


def test_flatten_keeps_no_cycle():
    """A tensor passed through ``flatten`` and one placed by ``unflatten`` are
    freed by their reference counts alone: a replay's inputs and outputs do
    not wait for the cyclic collector."""
    gc.disable()
    try:
        x, y = torch.zeros(3), torch.ones(3)
        leaves, spec = cg.flatten({"a": (x, [1.0]), "b": [x + 1]})
        tree = cg.unflatten(spec, [y, y + 1])
        refs = [weakref.ref(t) for t in (x, y, leaves[1], tree["b"][0])]
        del x, y, leaves, tree
        assert [r() is None for r in refs] == [True] * len(refs)  # x, y, one of each
    finally:
        gc.enable()


def test_graphed_step_needs_cuda():
    with pytest.raises(ValueError, match="CUDA device"):
        cg.GraphedStep(lambda c: (c,), "cpu")


# --------------------------------------------------------------------------
# on the card
# --------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; on the card chip_smoke.py phase 16 runs these checks")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("backend", ["fused", "pallas"])
def test_replay_equals_eager_on_card(cuda_device, backend):
    graphed = gpt.make("MultiRobotPuzzle-v2", num_envs=256, backend=backend, device=cuda_device)
    eager = gpt.make("MultiRobotPuzzle-v2", num_envs=256, backend=backend, device=cuda_device)
    params = moved_params(graphed)
    gs, _ = graphed.reset(seed=0)
    es, _ = eager.reset(seed=0)
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    for k in range(20):
        a = torch.rand((256, 4), generator=gen, device=cuda_device) * 2 - 1
        if k == 10:
            params = params.update_goal(8, 10, C.V2_EPSILON)
        g = graphed.step(gs, a, params)
        e = eager.step_eager(es, a, params)
        assert_bitwise(g, e)
        gs, es = g[0], e[0]


@pytest.mark.cuda
def test_rollout_replay_equals_eager_on_card(cuda_device):
    algo = PPO(PPOConfig(n_envs=256, n_steps=8, batch_size=512, n_epochs=1), device=cuda_device)
    ts = algo.init_state()
    noise = torch.randn((8, 256, algo.act_dim), generator=ts.generator, device=cuda_device)
    state = algo.env.generator.get_state()
    got = algo.rollout(ts, noise)
    algo.env.generator.set_state(state)
    want = algo.rollout_eager(ts, noise)
    assert_bitwise(got[1:], want[1:])
    assert_bitwise(got[0].vstate, want[0].vstate)
