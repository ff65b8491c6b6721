"""The port's learner (``gym_puzzles_tpu_torch.train``) against the JAX
package's on the CPU: the network, the Gaussian helpers, the normalizer, the
reward curriculum, the config loader, and one whole ``train_step`` from the
same params and env state with the same action noise and minibatch order."""

import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gym_puzzles_tpu.envs.config import RewardParams as JaxRewardParams
from gym_puzzles_tpu.train import networks as jnet
from gym_puzzles_tpu.train import normalize as jnrm
from gym_puzzles_tpu.train import ppo as jppo
from gym_puzzles_tpu_torch import convert
from gym_puzzles_tpu_torch.envs.config import RewardParams
from gym_puzzles_tpu_torch.train import networks as tnet
from gym_puzzles_tpu_torch.train import normalize as tnrm
from gym_puzzles_tpu_torch.train import ppo as tppo
from torch_port_helpers import np_tree

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
jtree = lambda x: jax.tree_util.tree_map(np.asarray, x)  # noqa: E731


def test_actor_critic_matches_flax():
    net = jnet.ActorCritic(act_dim=6, hidden=(256, 256))
    params = net.init(jax.random.key(0), jnp.zeros((1, 28)))
    # a trained log_std is not zero
    params = jax.tree_util.tree_map(lambda x: x, params)
    params["params"]["log_std"] = jnp.linspace(-1.0, 0.5, 6)
    obs = np.random.RandomState(0).randn(64, 28).astype(np.float32) * 2
    jm, jls, jv = net.apply(params, jnp.asarray(obs))
    tn = convert.actor_critic_from_numpy(jtree(params))
    tm, tls, tv = (x.detach() for x in tn(torch.from_numpy(obs)))
    for j, t in ((jm, tm), (jls, tls), (jv, tv)):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-6, atol=1e-6)
    act = np.random.RandomState(1).randn(64, 6).astype(np.float32)
    np.testing.assert_allclose(
        tnet.gaussian_log_prob(tm, tls, torch.from_numpy(act)).numpy(),
        np.asarray(jnet.gaussian_log_prob(jm, jls, jnp.asarray(act))), rtol=1e-6)
    np.testing.assert_allclose(float(tnet.gaussian_entropy(tls)),
                               float(jnet.gaussian_entropy(jls)), rtol=1e-6)
    # and back: the flax layout round-trips bitwise
    back = convert.params_to_numpy(tn.state_dict())
    for (_, a), (_, b) in zip(sorted(jax.tree_util.tree_leaves_with_path(back), key=str),
                              sorted(jax.tree_util.tree_leaves_with_path(
                                  jtree(params["params"])), key=str)):
        np.testing.assert_array_equal(a, b)


def test_actor_critic_own_init():
    net = tnet.ActorCritic(28, 6, (256, 64), generator=torch.Generator().manual_seed(0))
    for layer, gain in ((net.trunk[0], 2 ** 0.5), (net.trunk[1], 2 ** 0.5),
                        (net.mean, 0.01), (net.value, 1.0)):
        w = layer.weight.detach().double()
        gram = w @ w.T if w.shape[0] <= w.shape[1] else w.T @ w
        np.testing.assert_allclose(gram.numpy(), gain ** 2 * np.eye(gram.shape[0]),
                                   atol=1e-5 * gain ** 2)
        assert not bool(layer.bias.any())
    assert not bool(net.log_std.any())
    again = tnet.ActorCritic(28, 6, (256, 64), generator=torch.Generator().manual_seed(0))
    for a, b in zip(net.state_dict().values(), again.state_dict().values()):
        assert torch.equal(a, b)


def test_normalizer_matches_jax():
    rng = np.random.RandomState(0)
    E, D = 16, 28
    js = jnrm.NormalizerState.create(D, E, 0.99)
    ts = tnrm.NormalizerState.create(D, E, float(np.float32(0.99)))
    for _ in range(10):
        obs = (rng.randn(E, D) * 50 + 20).astype(np.float32)
        reward = (rng.randn(E) * 30).astype(np.float32)
        done = rng.rand(E) < 0.2
        js, jo = jnrm.normalize_obs(js, jnp.asarray(obs))
        ts, to = tnrm.normalize_obs(ts, torch.from_numpy(obs))
        js, jr = jnrm.normalize_reward(js, jnp.asarray(reward), jnp.asarray(done))
        ts, tr = tnrm.normalize_reward(ts, torch.from_numpy(reward), torch.from_numpy(done))
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=1e-6, atol=1e-6)
    for name in ("obs_rms", "ret_rms"):
        for k in ("mean", "var", "count"):
            np.testing.assert_allclose(getattr(getattr(ts, name), k).numpy(),
                                       np.asarray(getattr(getattr(js, name), k)), rtol=1e-6)
    np.testing.assert_allclose(ts.returns.numpy(), np.asarray(js.returns), rtol=1e-6, atol=1e-6)
    # evaluation leaves the statistics alone
    ts2, _ = tnrm.normalize_obs(ts, torch.from_numpy(obs), update=False)
    assert ts2.obs_rms is ts.obs_rms


def _assert_bitwise(port: RewardParams, jax_params):
    for f in dataclasses.fields(port):
        a = np.float32(getattr(port, f.name))
        b = np.float32(np.asarray(getattr(jax_params, f.name)))
        assert a.view(np.uint32) == b.view(np.uint32), (f.name, a, b)


@pytest.mark.parametrize("variant", ["v0", "v2", "v3"])
def test_reward_params_curriculum_bitwise(variant):
    port, ref = RewardParams.default(variant), JaxRewardParams.default(variant)
    _assert_bitwise(port, ref)
    values = {"agentDelta": 30.0, "agentDistance": 0.3, "blockDelta": 400.0,
              "blockDistance": 0.005, "puzzleComp": 123.4, "outOfBounds": 1100.0,
              "blkOutOfBounds": 77.7}
    assert set(values) == set(RewardParams.REFERENCE_WEIGHT_NAMES)
    for name, value in values.items():
        _assert_bitwise(port.set_reward_params(**{name: value}),
                        ref.set_reward_params(**{name: value}))
    port, ref = port.set_reward_params(**values), ref.set_reward_params(**values)
    _assert_bitwise(port, ref)
    with pytest.raises(TypeError, match="unknown reward param"):
        port.set_reward_params(agentSpeed=1.0)
    for decay in (0.9999999, 0.99999, 1.0000001):
        for t in (0, 1_000_000, 180_000_000):
            _assert_bitwise(port.update_params(t, decay), ref.update_params(t, decay))
    for epoch, n in ((0, 10), (3, 7), (9, 10), (11, 12)):
        _assert_bitwise(port.update_goal(epoch, n, port.scaled_epsilon),
                        ref.update_goal(epoch, n, ref.scaled_epsilon))


# --------------------------------------------------------------------------
# apply_curriculum against the JAX learner's, update by update
# --------------------------------------------------------------------------

H2_REWARDS = (("agentDelta", 5.0), ("agentDistance", 0.0), ("blockDelta", 2000.0),
              ("blockDistance", 0.0))
# each recipe's config fields and its updates' step counts (the counter
# apply_curriculum reads as it stands before each update)
CURRICULA = {
    # the v2 recipe (docs/benchmarks/ppo_v2_leg1_r4.jsonl): 114 updates
    "v2_update_goal": (dict(env_id="MultiRobotPuzzle-v2", update_goal=True),
                       [u * 262_144 for u in range(115)]),
    # the Heavy-v2 recipe's two legs (ppo_hv2_leg{1,2}_r4.jsonl): the schedule
    # over leg 1's 114 updates, then again over leg 2's 247 from leg 1's end
    "hv2_update_goal_leg1": (dict(env_id="MultiRobotPuzzleHeavy-v2", update_goal=True),
                             [u * 262_144 for u in range(115)]),
    "hv2_update_goal_leg2": (dict(env_id="MultiRobotPuzzleHeavy-v2", update_goal=True,
                                  ent_coef=0.002),
                             [(114 + u) * 262_144 for u in range(248)]),
    # the Heavy-v0 H2 recipe (ppo_hv0_H2_r5.jsonl), the weights held and
    # annealed back over 5 updates
    "hv0_H2_rewards": (dict(env_id="MultiRobotPuzzleHeavy-v0", reward_params=H2_REWARDS),
                       [1_499_463_680 + u * 524_288 for u in range(8)]),
    "hv0_H2_rewards_anneal5": (dict(env_id="MultiRobotPuzzleHeavy-v0", reward_params=H2_REWARDS,
                                    reward_anneal_updates=5),
                               [1_499_463_680 + u * 524_288 for u in range(8)]),
    # shaped rewards decayed and grown, across 180M steps and up to int32's end
    **{f"decay_{decay}": (dict(env_id="MultiRobotPuzzle-v0", update_params_decay=decay),
                          [0, 1, 262_144, 1_000_000, 79_953_920, 179_830_784, 180_000_000,
                           2**31 - 1])
       for decay in (0.99999, 1.0000001)},
    # linear lr decay over the v0 leg-1 recipe's 305 updates
    "anneal_lr": (dict(env_id="MultiRobotPuzzle-v0", anneal_lr=True),
                  [u * 262_144 for u in range(306)]),
}


@pytest.mark.parametrize("recipe", list(CURRICULA))
def test_apply_curriculum_matches_jax_bitwise(recipe):
    """Both learners built from the same config fields; ``apply_curriculum(ts,
    update, n_updates)`` chained over updates 0..N, each call on the step
    count that update starts from: every ``RewardParams`` field and the
    learning rate equal to the JAX package's by their float32 bits."""
    fields, steps = CURRICULA[recipe]
    fields = dict(fields, n_envs=2, n_steps=2, batch_size=2, n_epochs=1, velocity_iters=2,
                  position_iters=1)
    talgo = tppo.PPO(tppo.PPOConfig(**fields), device="cpu")
    jalgo = jppo.PPO(jppo.PPOConfig(**fields, env_backend="xla"))
    ts = talgo.init_state()
    jts = jppo.TrainState(
        params=None, opt_state=None, normalizer=None, vstate=None, last_obs=None, key=None,
        timesteps=None, ep_return=None, ep_len=None, stat_return=None, stat_count=None,
        env_params=jax.tree_util.tree_map(jnp.asarray, jalgo.env_params),
        hparams=jppo.HParams.from_config(jalgo.cfg))
    _assert_bitwise(ts.env_params, jts.env_params)
    n_updates = len(steps) - 1
    seen = set()
    for update, t in enumerate(steps):
        ts = talgo.apply_curriculum(ts.replace(timesteps=torch.tensor(t, dtype=torch.int64)),
                                    update, n_updates)
        jts = jalgo.apply_curriculum(jts.replace(timesteps=jnp.asarray(t, jnp.int32)),
                                     update, n_updates)
        _assert_bitwise(ts.env_params, jts.env_params)
        for k in ("learning_rate", "lr_base"):
            a = np.float32(getattr(ts.hparams, k))
            b = np.float32(np.asarray(getattr(jts.hparams, k)))
            assert a.view(np.uint32) == b.view(np.uint32), (update, k, a, b)
        seen.add((ts.env_params, ts.hparams.learning_rate))
    # the schedule moved what it schedules; held weights stayed the overrides
    if recipe == "hv0_H2_rewards":
        assert seen == {(talgo.env_params, ts.hparams.lr_base)}
        assert talgo.env_params != talgo.default_env_params
    else:
        assert len(seen) > 1


@pytest.mark.parametrize("name", ["ppo-mrp-v0.json", "ppo-mrp-v2.json", "ppo-mrp-v3.json"])
def test_config_from_reference_json(name):
    config = json.loads((ROOT / "train_configs" / name).read_text())
    port = dataclasses.asdict(tppo.PPOConfig.from_reference_json(config, seed=5))
    ref = dataclasses.asdict(jppo.PPOConfig.from_reference_json(config, seed=5))
    assert port.pop("env_backend") == "fused"
    ref.pop("env_backend")
    assert port == ref


# --------------------------------------------------------------------------
# one train_step against the JAX learner
# --------------------------------------------------------------------------

E, T = 4, 8
CFG = dict(env_id="MultiRobotPuzzle-v0", n_envs=E, n_steps=T, batch_size=16, n_epochs=2,
           velocity_iters=8, position_iters=4, seed=3)
_rng = np.random.RandomState(0)
NOISE = (0.3 * _rng.randn(E, 6)).astype(np.float32)  # the same at every rollout step
PERM = _rng.permutation(T * E)  # the same in every epoch


@pytest.fixture(scope="module")
def jax_learner():
    """The JAX PPO, traced with ``NOISE`` as its action noise and ``PERM`` as
    its minibatch order (both baked into the one compiled train step, which
    ``set_hparams`` reuses)."""
    algo = jppo.PPO(jppo.PPOConfig(**CFG))
    normal, permutation = jax.random.normal, jax.random.permutation

    def fixed_normal(key, shape=(), *args, **kw):
        return jnp.asarray(NOISE) if tuple(shape) == NOISE.shape else normal(key, shape, *args,
                                                                              **kw)

    def fixed_permutation(key, x, *args, **kw):
        return jnp.asarray(PERM) if x == T * E else permutation(key, x, *args, **kw)

    runs = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.random, "normal", fixed_normal)
        mp.setattr(jax.random, "permutation", fixed_permutation)
        for name, hp in (("default", {}), ("kl_stop", {"target_kl": 1e-6})):
            ts0 = algo.init_state()
            start = dict(params=jtree(ts0.params), vstate=np_tree(ts0.vstate.env),
                         last_obs=np.asarray(ts0.last_obs), normalizer=np_tree(ts0.normalizer))
            ts1, m = algo.train_step(algo.set_hparams(ts0, **hp))
            runs[name] = (start, ts1, jax.device_get(m))
    return runs


def _port_step(start, hp):
    algo = tppo.PPO(tppo.PPOConfig(**CFG), device="cpu")
    ts = algo.init_state()
    ts = ts.replace(
        params=convert.actor_critic_from_numpy(start["params"]).state_dict(),
        vstate=convert.state_from_numpy(start["vstate"]),
        last_obs=torch.tensor(start["last_obs"]),
        normalizer=convert.normalizer_from_numpy(start["normalizer"]))
    ts = algo.set_hparams(ts, **hp)
    noise = torch.from_numpy(NOISE).expand(T, E, 6)
    perms = torch.from_numpy(PERM).expand(CFG["n_epochs"], T * E)
    return algo.train_step(ts, noise=noise, perms=perms)


def _max_abs(port_tree, jax_tree):
    pa = dict(jax.tree_util.tree_leaves_with_path(port_tree))
    ja = dict(jax.tree_util.tree_leaves_with_path(jax_tree))
    assert pa.keys() == ja.keys()
    return max(float(np.abs(np.asarray(pa[k], np.float64) - np.asarray(ja[k])).max()) for k in pa)


@pytest.mark.parametrize("run", ["default", "kl_stop"])
def test_train_step_matches_jax(jax_learner, run):
    """Params and Adam moments within 1e-4 (a sixth of one Adam step at lr
    6.3e-4; measured at most 8.4e-7), the normalizer, last obs and episode
    returns within 1e-5, the metrics within 1e-4 relative, timesteps
    equal.  With ``target_kl=1e-6`` the stop fires in both, and both run the
    frozen minibatches after it: their losses enter the averages too."""
    start, jts, jm = jax_learner[run]
    hp = {"target_kl": 1e-6} if run == "kl_stop" else {}
    ts, m = _port_step(start, hp)

    d_params = _max_abs(convert.params_to_numpy(ts.params), jtree(jts.params["params"]))
    d_mu = _max_abs(convert.params_to_numpy(ts.opt_state.mu), jtree(jts.opt_state.mu["params"]))
    d_nu = _max_abs(convert.params_to_numpy(ts.opt_state.nu), jtree(jts.opt_state.nu["params"]))
    print(f"{run}: max |params| diff {d_params:.3e}, mu {d_mu:.3e}, nu {d_nu:.3e}")
    assert max(d_params, d_mu, d_nu) <= 1e-4
    assert ts.opt_state.count == int(jts.opt_state.count)

    jn = np_tree(jts.normalizer)
    for name in ("obs_rms", "ret_rms"):
        for k in ("mean", "var", "count"):
            np.testing.assert_allclose(getattr(getattr(ts.normalizer, name), k).numpy(),
                                       jn[name][k], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(ts.normalizer.returns.numpy(), jn["returns"], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(ts.last_obs.numpy(), np.asarray(jts.last_obs), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(ts.ep_return.numpy(), np.asarray(jts.ep_return), rtol=1e-5,
                               atol=1e-5)
    assert int(ts.timesteps) == int(jm["timesteps"]) == T * E
    assert ts.timesteps.dtype == torch.int64

    assert bool(m["kl_stopped"]) == bool(jm["kl_stopped"]) == (run == "kl_stop")
    assert m["kl_stopped"].dtype == torch.bool
    for k in ("approx_kl", "ep_rew_mean", "episodes", "loss", "policy_loss", "value_loss",
              "entropy"):
        # the policy loss is a mean of terms of size ~1 (normalized
        # advantages) that cancel to ~6e-4: its rounding is held to those
        # terms' scale (measured 1.3e-7), the rest to 1e-4 relative
        atol = 1e-6 if k == "policy_loss" else 0.0
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-4, atol=atol,
                                   equal_nan=True, err_msg=k)
    assert int(m["completions"]) == int(jm["completions"])
