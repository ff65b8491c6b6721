"""The port's imitation bootstrap (``train/imitate.py``) against the JAX
package's on the CPU: one BC round from the same TrainState (params,
normalizer, env batch) with the same minibatch order -- the demonstrator
rollout, the normalizer, the discounted-return proxy, the loss terms and the
plain Adam steps -- and a BC checkpoint that the trainer CLI resumes."""

import json
import types

import numpy as np
import pytest
import torch

import jax

from gym_puzzles_tpu.train import imitate as jimitate
from gym_puzzles_tpu.train import ppo as jppo
from gym_puzzles_tpu_torch import convert
from gym_puzzles_tpu_torch.train import checkpoint as ckpt
from gym_puzzles_tpu_torch.train import cli, imitate
from gym_puzzles_tpu_torch.train import ppo as tppo
from torch_port_helpers import np_tree

torch.set_num_threads(1)

E, T = 4, 8
CFG = dict(env_id="MultiRobotPuzzle-v0", n_envs=E, n_steps=T, batch_size=8, n_epochs=2,
           gamma=0.999, velocity_iters=8, position_iters=4, seed=1)
PERM = np.random.RandomState(0).permutation(T * E)  # the same in every epoch
jtree = lambda x: jax.tree_util.tree_map(np.asarray, x)  # noqa: E731


@pytest.fixture(scope="module")
def jax_round():
    """JAX ``bc_train`` for one round with ``PERM`` as its minibatch order:
    (the starting TrainState as numpy, the TrainState, BC Adam state and
    metrics its jitted ``bc_round`` returned)."""
    rounds = []

    def jit(fn, **kw):
        compiled = jax.jit(fn, **kw)

        def call(*args):
            out = compiled(*args)
            rounds.append(out)
            return out
        return call

    permutation = jax.random.permutation

    def fixed_permutation(key, x, *args, **kw):
        return jax.numpy.asarray(PERM) if x == T * E else permutation(key, x, *args, **kw)

    spy = types.SimpleNamespace(jit=jit, lax=jax.lax, random=jax.random,
                                value_and_grad=jax.value_and_grad, device_get=jax.device_get,
                                tree_util=jax.tree_util)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jimitate, "jax", spy)
        mp.setattr(jax.random, "permutation", fixed_permutation)
        algo, _ts = jimitate.bc_train(jppo.PPOConfig(**CFG), rounds=1, log_fn=lambda s: None)
    ts0 = algo.init_state()  # what bc_train started from (same key)
    start = dict(params=jtree(ts0.params), vstate=np_tree(ts0.vstate.env),
                 last_obs=np.asarray(ts0.last_obs), normalizer=np_tree(ts0.normalizer))
    assert len(rounds) == 1
    return start, rounds[0]


def _max_abs(port_tree, jax_tree):
    pa = dict(jax.tree_util.tree_leaves_with_path(port_tree))
    ja = dict(jax.tree_util.tree_leaves_with_path(jax_tree))
    assert pa.keys() == ja.keys()
    return max(float(np.abs(np.asarray(pa[k], np.float64) - np.asarray(ja[k])).max()) for k in pa)


def test_bc_round_matches_jax(jax_round):
    """Params and the BC Adam moments within 1e-4 leaf by leaf (the PPO
    update's contract), the normalizer and last obs within 1e-5, each
    minibatch's loss, pi_mse and v_mse within 1e-4 relative, the step
    counts equal."""
    start, (jts, jopt, jmetrics) = jax_round
    algo = tppo.PPO(tppo.PPOConfig(**CFG), device="cpu")
    ts = algo.init_state().replace(
        params=convert.actor_critic_from_numpy(start["params"]).state_dict(),
        vstate=convert.state_from_numpy(start["vstate"]),
        last_obs=torch.tensor(start["last_obs"]),
        normalizer=convert.normalizer_from_numpy(start["normalizer"]))
    perms = torch.from_numpy(PERM).expand(CFG["n_epochs"], T * E)
    ts1, opt, metrics = imitate.bc_round(algo, ts, imitate.bc_opt_init(ts.params), perms=perms)

    adam = jopt[0]  # optax.adam = chain(scale_by_adam, scale_by_learning_rate)
    d_params = _max_abs(convert.params_to_numpy(ts1.params), jtree(jts.params["params"]))
    d_mu = _max_abs(convert.params_to_numpy(opt.mu), jtree(adam.mu["params"]))
    d_nu = _max_abs(convert.params_to_numpy(opt.nu), jtree(adam.nu["params"]))
    print(f"BC round: max |params| diff {d_params:.3e}, mu {d_mu:.3e}, nu {d_nu:.3e}")
    assert max(d_params, d_mu, d_nu) <= 1e-4
    n_minibatch = T * E // CFG["batch_size"]
    assert opt.count == int(adam.count) == CFG["n_epochs"] * n_minibatch

    jn = np_tree(jts.normalizer)
    d_norm = 0.0  # relative to max(1, |JAX value|)
    for name in ("obs_rms", "ret_rms"):
        for k in ("mean", "var", "count"):
            got, want = getattr(getattr(ts1.normalizer, name), k).numpy(), jn[name][k]
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
            d_norm = max(d_norm, float((np.abs(got - want) / np.maximum(np.abs(want), 1)).max()))
    np.testing.assert_allclose(ts1.normalizer.returns.numpy(), jn["returns"], rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(ts1.last_obs.numpy(), np.asarray(jts.last_obs), rtol=1e-5,
                               atol=1e-5)
    assert int(ts1.timesteps) == int(jts.timesteps) == T * E

    want = np.stack([np.asarray(m).reshape(-1) for m in jmetrics], axis=-1)  # [mb, 3]
    got = metrics.numpy()
    assert got.shape == want.shape == (CFG["n_epochs"] * n_minibatch, 3)
    rel = float((np.abs(got - want) / np.abs(want)).max())
    print(f"BC round: normalizer {d_norm:.3e}, loss terms {rel:.3e} relative")
    np.testing.assert_allclose(got, want, rtol=1e-4)
    # the PPO optimizer state is left fresh, as in the JAX package
    assert ts1.opt_state.count == 0


def test_bc_checkpoint_resumes_in_trainer(tmp_path, capsys):
    """The imitate CLI's checkpoint: the trainer CLI takes one PPO update
    from it, starting from the BC params and normalizer."""
    out = tmp_path / "bc"
    small = ["--device", "cpu", "--env", "MultiRobotPuzzle-v0", "--n_envs", "2", "--n_steps", "4",
             "--batch_size", "4", "--n_epochs", "1", "--velocity_iters", "8",
             "--position_iters", "4"]
    _algo, bc_ts = imitate.main(small + ["--rounds", "2", "--out", str(out)])
    lines = [json.loads(line) for line in capsys.readouterr().out.splitlines()
             if line.startswith("{")]
    assert [row["bc_round"] for row in lines] == [0, 1]
    assert all(np.isfinite([row["loss"], row["pi_mse"], row["v_mse"]]).all() for row in lines)
    path = out / "MultiRobotPuzzle-v0"
    assert ckpt.latest_step(path) == 16

    restored = ckpt.restore(path, tppo.PPO(tppo.PPOConfig(
        env_id="MultiRobotPuzzle-v0", n_envs=2, n_steps=4, batch_size=4, n_epochs=1,
        velocity_iters=8, position_iters=4), device="cpu").init_state())
    for k, v in bc_ts.params.items():
        assert torch.equal(restored.params[k], v)
    assert torch.equal(restored.normalizer.obs_rms.mean, bc_ts.normalizer.obs_rms.mean)

    final = cli.main(small[2:] + ["--device", "cpu", "--disable_wandb", "--gamma", "0.999",
                                  "--total_timesteps", "8", "--resume", str(path)])
    assert int(final.timesteps) == 24
    assert any(not torch.equal(final.params[k], bc_ts.params[k]) for k in bc_ts.params)
