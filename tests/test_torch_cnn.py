"""The port's pixel policy against the JAX package's on the CPU:
``CnnActorCritic`` with converted flax params against the flax module at
downsample 8, its own init, and one CNN ``train_step`` against the JAX
learner at downsample 16 from the same params and image-env state, with the
same action noise and minibatch order (the harness of tests/test_torch_ppo.py).

Tolerances: the convolutions run in bfloat16 on both sides but accumulate
in another order (XLA's CPU convolution against oneDNN's), so a bf16
rounding of a feature can differ.  Forward: mean within 1e-5 and value
within 1e-3 absolute (measured 1.4e-6 and 1.1e-4 in a scratch run of this
layout, on rendered frames).  After one update (one Adam step): every param
within 0.3 x the learning rate; Adam's first and second moments, which hold
the clipped gradient, leaf by leaf within 0.1 (mu) and 0.2 (nu) of the
leaf's largest moment for the convolutions and 1e-3 / 2e-3 for the dense
layers and log_std; the loss terms within 1e-3 relative but for the policy
loss, which cancels to ~1e-8 and is held to 1e-6 absolute.  Measured: mean
5.3e-6 (scale 0.015) and value 2.9e-4 (scale 1.4) on random frames; params
within 0.09 x lr; mu within 0.039 (Conv_0 bias) and 1.9e-4 (dense), nu
within 0.061 and 3.8e-4; loss and value loss 1.5e-5 relative, entropy equal,
policy loss 3.0e-8 absolute."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gym_puzzles_tpu.api.image_obs import DeviceImageVectorEnv as JaxImageEnv
from gym_puzzles_tpu.train import networks as jnet
from gym_puzzles_tpu.train import ppo as jppo
from gym_puzzles_tpu_torch import convert
from gym_puzzles_tpu_torch.api.image_obs import DeviceImageVectorEnv
from gym_puzzles_tpu_torch.train import networks as tnet
from gym_puzzles_tpu_torch.train import ppo as tppo
from torch_port_helpers import np_tree

torch.set_num_threads(1)

ENV_ID = "MultiRobotPuzzle-v0"
ITERS = dict(velocity_iters=8, position_iters=4)
jtree = lambda x: jax.tree_util.tree_map(np.asarray, x)  # noqa: E731


def max_abs(a, b) -> float:
    return float(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)).max())


def test_cnn_matches_flax():
    """Downsample 8: obs [N, 3 x 60, 80, 3] uint8."""
    obs_shape = (180, 80, 3)
    net = jnet.CnnActorCritic(act_dim=6)
    params = net.init(jax.random.key(0), jnp.zeros((1,) + obs_shape, jnp.uint8))
    params["params"]["log_std"] = jnp.linspace(-1.0, 0.5, 6)  # a trained log_std is not 0
    obs = np.random.RandomState(0).randint(0, 256, (16,) + obs_shape).astype(np.uint8)
    jm, jls, jv = net.apply(params, jnp.asarray(obs))

    tn = convert.cnn_actor_critic_from_numpy(jtree(params), obs_shape)
    with torch.no_grad():
        tm, tls, tv = tn(torch.from_numpy(obs))
    d_mean, d_value = max_abs(tm, jm), max_abs(tv, jv)
    print(f"mean {d_mean:.3e} (scale {float(jnp.abs(jm).max()):.3g}), value {d_value:.3e} "
          f"(scale {float(jnp.abs(jv).max()):.3g})")
    assert d_mean <= 1e-5 and d_value <= 1e-3
    np.testing.assert_array_equal(tls.detach().numpy(), np.asarray(jls))
    assert tm.dtype == tv.dtype == torch.float32 and tv.shape == (16,)

    # and back: the flax layout round-trips bitwise
    back = convert.params_to_numpy(tn.state_dict())
    want = jtree(params["params"])
    assert back.keys() == want.keys()
    for name in want:
        for leaf in ("kernel", "bias") if name != "log_std" else ():
            np.testing.assert_array_equal(back[name][leaf], want[name][leaf])
    np.testing.assert_array_equal(back["log_std"], want["log_std"])


def test_cnn_own_init():
    net = tnet.CnnActorCritic((180, 80, 3), 6, generator=torch.Generator().manual_seed(0))
    # NatureCNN at downsample 8: 180 x 80 -> 44 x 19 -> 21 x 8 -> 19 x 6 features
    assert tnet.cnn_output_hw(180, 80) == (19, 6)
    assert net.dense.weight.shape == (512, 19 * 6 * 64)
    layers = [(c, 2 ** 0.5) for c in net.convs] + [(net.dense, 2 ** 0.5), (net.mean, 0.01),
                                                    (net.value, 1.0)]
    for layer, gain in layers:
        w = layer.weight.detach().double().flatten(1)
        gram = w @ w.T if w.shape[0] <= w.shape[1] else w.T @ w
        np.testing.assert_allclose(gram.numpy(), gain ** 2 * np.eye(gram.shape[0]),
                                   atol=1e-5 * gain ** 2)
        assert not bool(layer.bias.any())
    assert not bool(net.log_std.any())
    again = tnet.CnnActorCritic((180, 80, 3), 6, generator=torch.Generator().manual_seed(0))
    for a, b in zip(net.state_dict().values(), again.state_dict().values()):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="too small"):
        tnet.CnnActorCritic((30, 40, 3), 6)


# --------------------------------------------------------------------------
# one CNN train_step against the JAX learner
# --------------------------------------------------------------------------

E, T, DOWNSAMPLE = 2, 4, 16
CFG = dict(env_id=ENV_ID, policy="cnn", n_envs=E, n_steps=T, batch_size=8, n_epochs=1,
           seed=3, **ITERS)
_rng = np.random.RandomState(1)
NOISE = (0.3 * _rng.randn(E, 6)).astype(np.float32)  # the same at every rollout step
PERM = _rng.permutation(T * E)


@pytest.fixture(scope="module")
def jax_cnn_learner():
    """The JAX CNN PPO on its image env (``backend='xla'``), traced with
    ``NOISE`` as its action noise and ``PERM`` as its minibatch order."""
    env = JaxImageEnv(ENV_ID, num_envs=E, downsample=DOWNSAMPLE, **ITERS)
    algo = jppo.PPO(jppo.PPOConfig(**CFG), env=env)
    normal, permutation = jax.random.normal, jax.random.permutation

    def fixed_normal(key, shape=(), *args, **kw):
        return jnp.asarray(NOISE) if tuple(shape) == NOISE.shape else normal(key, shape, *args,
                                                                              **kw)

    def fixed_permutation(key, x, *args, **kw):
        return jnp.asarray(PERM) if x == T * E else permutation(key, x, *args, **kw)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.random, "normal", fixed_normal)
        mp.setattr(jax.random, "permutation", fixed_permutation)
        ts0 = algo.init_state()
        start = dict(params=jtree(ts0.params),
                     vstate={"vec": np_tree(ts0.vstate.vec.env),
                             "frames": np.asarray(ts0.vstate.frames)},
                     last_obs=np.asarray(ts0.last_obs), normalizer=np_tree(ts0.normalizer))
        ts1, m = algo.train_step(ts0)
    return start, ts1, jax.device_get(m)


def test_cnn_train_step_matches_jax(jax_cnn_learner):
    start, jts, jm = jax_cnn_learner
    env = DeviceImageVectorEnv(ENV_ID, num_envs=E, downsample=DOWNSAMPLE, device="cpu", **ITERS)
    algo = tppo.PPO(tppo.PPOConfig(**CFG), env=env)
    assert algo.obs_shape == env.obs_shape == start["last_obs"].shape[1:] == (90, 40, 3)
    ts = algo.init_state()
    ts = ts.replace(
        params=convert.cnn_actor_critic_from_numpy(start["params"], algo.obs_shape).state_dict(),
        vstate=convert.image_state_from_numpy(start["vstate"]),
        last_obs=torch.tensor(start["last_obs"]),
        normalizer=convert.normalizer_from_numpy(start["normalizer"]))
    noise = torch.from_numpy(NOISE).expand(T, E, 6)
    perms = torch.from_numpy(PERM).expand(CFG["n_epochs"], T * E)
    ts, m = algo.train_step(ts, noise=noise, perms=perms)

    lr = tppo.HParams.from_config(algo.cfg).learning_rate
    got = convert.params_to_numpy(ts.params)
    want = jtree(jts.params["params"])
    diffs = {f"{k}/{leaf}": max_abs(got[k][leaf], want[k][leaf])
             for k in want if k != "log_std" for leaf in ("kernel", "bias")}
    diffs["log_std"] = max_abs(got["log_std"], want["log_std"])
    print("max |param diff| / lr: " + ", ".join(f"{k} {v / lr:.3g}" for k, v in diffs.items()))
    assert max(diffs.values()) <= 0.3 * lr
    # Adam's moments after its first step are (1 - b) x the clipped gradient
    # (squared): they hold the backward itself, leaf by leaf, relative to the
    # leaf's largest moment.  The convolutions' gradients run in bf16 with
    # another accumulation order on each side; the dense layers' differ only
    # through the global-norm clip factor, which the conv gradients enter.
    for moment, conv_limit, dense_limit in (("mu", 0.1, 1e-3), ("nu", 0.2, 2e-3)):
        mg = convert.params_to_numpy(getattr(ts.opt_state, moment))
        mw = jtree(getattr(jts.opt_state, moment)["params"])
        rel = {f"{k}/{leaf}": max_abs(mg[k][leaf], mw[k][leaf]) / np.abs(mw[k][leaf]).max()
               for k in mw if k != "log_std" for leaf in ("kernel", "bias")}
        rel["log_std"] = max_abs(mg["log_std"], mw["log_std"]) / np.abs(mw["log_std"]).max()
        print(f"{moment}, relative: " + ", ".join(f"{k} {v:.3g}" for k, v in rel.items()))
        for k, v in rel.items():
            assert v <= (conv_limit if k.startswith("Conv") else dense_limit), (moment, k, v)
    moved = max_abs(got["Dense_0"]["kernel"], start["params"]["params"]["Dense_0"]["kernel"])
    assert moved > 0.5 * lr  # the update did move the params
    assert ts.opt_state.count == int(jts.opt_state.count) == 1

    # the rollout: frames, returns, the reward normalizer
    assert ts.last_obs.dtype == torch.uint8
    np.testing.assert_array_equal(ts.last_obs.numpy(), np.asarray(jts.last_obs))
    np.testing.assert_allclose(ts.ep_return.numpy(), np.asarray(jts.ep_return), rtol=1e-5,
                               atol=1e-5)
    jn = np_tree(jts.normalizer)
    for k in ("mean", "var", "count"):
        np.testing.assert_allclose(getattr(ts.normalizer.ret_rms, k).numpy(),
                                   jn["ret_rms"][k], rtol=1e-5, atol=1e-5)
        # no obs normalization for images: its moments stay as created
        np.testing.assert_array_equal(getattr(ts.normalizer.obs_rms, k).numpy(),
                                      jn["obs_rms"][k])
    assert int(ts.timesteps) == int(jm["timesteps"]) == T * E

    rel = {k: abs(float(m[k]) - float(jm[k])) / max(abs(float(jm[k])), 1e-12)
           for k in ("loss", "value_loss", "entropy")}
    print("loss terms, relative: " + ", ".join(f"{k} {v:.3e}" for k, v in rel.items()))
    assert max(rel.values()) <= 1e-3
    # the policy loss of the first minibatch is a mean of terms of size ~1
    # (normalized advantages at ratio 1) that cancel to ~1e-8: held to 1e-6
    # absolute, as in tests/test_torch_ppo.py
    pg = abs(float(m["policy_loss"]) - float(jm["policy_loss"]))
    print(f"policy loss {float(jm['policy_loss']):.3e}, difference {pg:.3e}")
    assert pg <= 1e-6
    assert float(m["episodes"]) == float(jm["episodes"])
