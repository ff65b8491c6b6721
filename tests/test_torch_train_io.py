"""The port's checkpoints, evaluation, policy file and CLIs on the CPU: exact
resume, ``restore_policy`` across batch sizes, the int64 step counter,
chunk-invariant evaluation, the committed v0 policy against the JAX
package's, and the train / eval CLIs."""

import copy
import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gym_puzzles_tpu.envs.config import RewardParams as JaxRewardParams
from gym_puzzles_tpu.train import networks as jnet
from gym_puzzles_tpu.train import normalize as jnrm
from gym_puzzles_tpu_torch.train import checkpoint as ckpt
from gym_puzzles_tpu_torch.train import cli, evaluate, export
from gym_puzzles_tpu_torch.train.ppo import PPO, HParams, PPOConfig
from torch_port_helpers import V0_POLICY_NPZ, assert_trees_equal, export_jax_policy

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent

ITERS = dict(velocity_iters=8, position_iters=4)


def tiny_cfg(**kw):
    return PPOConfig(**{**dict(env_id="MultiRobotPuzzle-v0", n_envs=2, n_steps=4, batch_size=4,
                               n_epochs=2, seed=3, **ITERS), **kw})


@pytest.fixture(scope="module")
def one_update(tmp_path_factory):
    """A checkpoint of a fresh learner after one update, and its metrics."""
    path = tmp_path_factory.mktemp("one_update")
    algo = PPO(tiny_cfg(), device="cpu")
    ts, metrics = algo.train_step(algo.init_state())
    ckpt.save(path, ts, ckpt.step_count(ts.timesteps))
    return path, metrics


def test_exact_resume(one_update):
    """Two updates in a row equal one update, save, restore into a fresh
    learner, one update: params, Adam state, normalizer, env state, both
    generators and the metrics, bitwise."""
    path, _ = one_update
    algo = PPO(tiny_cfg(), device="cpu")
    ts = algo.init_state()
    for _ in range(2):
        ts, m = algo.train_step(ts)
    resumed = PPO(tiny_cfg(), device="cpu")
    rs = ckpt.restore(path, resumed.init_state())
    assert rs.env_generator is resumed.env.generator
    rs, rm = resumed.train_step(rs)
    assert_trees_equal(rs, ts)
    assert_trees_equal(rm, m)
    assert int(ts.timesteps) == 16


def test_exact_resume_with_curriculum(tmp_path):
    """v2 with ``update_goal``, each update preceded by ``apply_curriculum``
    as ``learn`` does: saved after update 1 and restored into a fresh
    learner, update 2 equals the uninterrupted run's bitwise, the shrinking
    goal epsilon (``env_params``) included."""
    cfg = tiny_cfg(env_id="MultiRobotPuzzle-v2", update_goal=True)
    n_updates = 4
    algo = PPO(cfg, device="cpu")
    ts = algo.init_state()
    for u in range(2):
        ts = algo.apply_curriculum(ts, u, n_updates)
        ts, m = algo.train_step(ts)
        if u == 0:
            ckpt.save(tmp_path, ts, ckpt.step_count(ts.timesteps))
            saved_params = ts.env_params
    resumed = PPO(cfg, device="cpu")
    rs = ckpt.restore(tmp_path, resumed.init_state())
    assert rs.env_params == saved_params != resumed.env_params
    rs = resumed.apply_curriculum(rs, 1, n_updates)
    rs, rm = resumed.train_step(rs)
    assert_trees_equal(rs, ts)
    assert_trees_equal(rm, m)
    assert rs.env_params.scaled_epsilon < saved_params.scaled_epsilon


def test_restore_policy_across_batch_sizes(one_update, tmp_path):
    """Params, normalizer moments and timesteps graft into a template of
    another batch size, from the checkpoint and from its exported policy
    file alike; the template's env-batch leaves keep their shapes."""
    path, _ = one_update
    full = ckpt.restore(path, PPO(tiny_cfg(), device="cpu").init_state())
    export.export(path, tmp_path / "policy.npz")
    eval_algo = PPO(tiny_cfg(n_envs=3), device="cpu")
    for source in (path, tmp_path / "policy.npz"):
        got = ckpt.restore_policy(source, eval_algo.init_state())
        assert_trees_equal(got.params, full.params)
        assert_trees_equal(got.normalizer.obs_rms, full.normalizer.obs_rms)
        assert_trees_equal(got.normalizer.ret_rms, full.normalizer.ret_rms)
        assert got.normalizer.returns.shape == (3,) and got.last_obs.shape[0] == 3
        assert int(got.timesteps) == int(full.timesteps) == 8


def test_step_counter_past_int32(one_update, tmp_path):
    """The int64 counter stays exact and positive past 2^31 env steps, in
    the state, the metrics and the checkpoint label."""
    path, _ = one_update
    algo = PPO(tiny_cfg(), device="cpu")
    ts = ckpt.restore(path, algo.init_state())
    ts = ts.replace(timesteps=torch.tensor(2**31 - 3, dtype=torch.int64))
    ts, m = algo.train_step(ts)
    assert ckpt.step_count(m["timesteps"]) == ckpt.step_count(ts.timesteps) == 2**31 + 5
    ckpt.save(tmp_path, ts, ckpt.step_count(ts.timesteps))
    assert ckpt.latest_step(tmp_path) == 2**31 + 5
    back = ckpt.restore(tmp_path, algo.init_state())
    assert back.timesteps.dtype == torch.int64 and int(back.timesteps) == 2**31 + 5


def test_evaluate_batched_chunk_invariant(one_update):
    """The chunk size cannot change an evaluation (stochastic here, so the
    action noise's order counts too); the sequential evaluation runs."""
    path, _ = one_update
    algo = PPO(tiny_cfg(), device="cpu")
    ts = ckpt.restore_policy(path, algo.init_state())
    runs = [evaluate.evaluate_policy_batched(algo, ts, n_episodes=3, deterministic=False,
                                             seed=9, max_steps=12, chunk=chunk, **ITERS)
            for chunk in (5, 200)]
    assert runs[0] == runs[1]
    mean, std, returns, lengths, statuses = runs[0]
    assert len(returns) == 3 and lengths == [12, 12, 12] and np.isfinite(mean)
    assert statuses == [0, 0, 0]
    mean1, _, returns1 = evaluate.evaluate_policy(algo, ts, n_episodes=1, max_steps=3,
                                                  seed=5, **ITERS)
    assert len(returns1) == 1 and np.isfinite(mean1)


# --------------------------------------------------------------------------
# the committed v0 policy
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def fresh_export(tmp_path_factory):
    """(JAX policy tree, a fresh export of the JAX checkpoint)."""
    out = tmp_path_factory.mktemp("policy") / "v0.npz"
    return export_jax_policy(out=out), out


def test_committed_policy_is_a_fresh_export(fresh_export):
    _tree, out = fresh_export
    with np.load(V0_POLICY_NPZ) as committed, np.load(out) as fresh:
        assert sorted(committed.files) == sorted(fresh.files)
        for k in committed.files:
            a, b = committed[k], fresh[k]
            assert a.dtype == b.dtype and a.shape == b.shape, k
            assert a.tobytes() == b.tobytes(), k
        assert int(committed["timesteps"]) == 179830784


def test_committed_policy_actions_match_jax(fresh_export):
    """Deterministic actions of the committed file through the port's eval
    path (``restore_policy`` + frozen normalizer + network) against the JAX
    package's ``normalize_obs(update=False)`` + ``ActorCritic.apply`` on 256
    seeded obs at the scale the normalizer saw, within 1e-5."""
    tree, _ = fresh_export
    norm = tree["normalizer"]
    rng = np.random.RandomState(0)
    obs = (norm["obs_rms"]["mean"] + np.sqrt(norm["obs_rms"]["var"])
           * rng.randn(256, 28)).astype(np.float32)
    rms = lambda r: jnrm.RunningMeanStd(**{k: jnp.asarray(v) for k, v in r.items()})  # noqa
    jstate = jnrm.NormalizerState(obs_rms=rms(norm["obs_rms"]), ret_rms=rms(norm["ret_rms"]),
                                  returns=jnp.zeros((1,)), gamma=jnp.float32(0.99))
    _, n_obs = jnrm.normalize_obs(jstate, jnp.asarray(obs), update=False)
    jmean, _, _ = jnet.ActorCritic(act_dim=6).apply(tree["params"], n_obs)

    algo = PPO(PPOConfig(n_envs=1, n_steps=2, batch_size=2, n_epochs=1), device="cpu")
    st = ckpt.restore_policy(V0_POLICY_NPZ, algo.init_state())
    with torch.no_grad():
        act = evaluate.policy_action(algo, st.params, st.normalizer, torch.from_numpy(obs),
                                     True, None)
    np.testing.assert_allclose(act.numpy(), np.clip(np.asarray(jmean), -1, 1), rtol=0,
                               atol=1e-5)
    assert 0.0 < float((act.abs() < 1).float().mean()) < 1.0  # some actions saturate, not all


# --------------------------------------------------------------------------
# CLIs
# --------------------------------------------------------------------------


def test_cli_train_resume_eval(tmp_path, monkeypatch, capsys):
    """Train with ``--save_model`` (the last periodic save holds the final
    step: one save, not two), resume from it, and evaluate the result and
    the committed policy with the eval CLI."""
    saves = []
    save = ckpt.save
    monkeypatch.setattr(ckpt, "save",
                        lambda path, ts, step: (saves.append(step), save(path, ts, step)))
    base = ["--device", "cpu", "--disable_wandb", "--n_envs", "2", "--n_steps", "4",
            "--batch_size", "4", "--n_epochs", "1", "--velocity_iters", "8",
            "--position_iters", "4"]
    cli.main(base + ["--total_timesteps", "16", "--save_model", "--checkpoint_every", "1",
                     "--checkpoint_dir", str(tmp_path / "leg1")])
    assert saves == [16]
    leg1 = tmp_path / "leg1" / "MultiRobotPuzzle-v0"
    assert ckpt.latest_step(leg1) == 16
    final = cli.main(base + ["--total_timesteps", "8", "--resume", str(leg1), "--save_model",
                             "--checkpoint_dir", str(tmp_path / "leg2")])
    assert int(final.timesteps) == 24 and saves == [16, 24]
    capsys.readouterr()

    eval_args = ["--device", "cpu", "--n_episodes", "2", "--max_steps", "6", "--batched",
                 "--velocity_iters", "8", "--position_iters", "4"]
    for source, steps in ((tmp_path / "leg2" / "MultiRobotPuzzle-v0", 24),
                          (V0_POLICY_NPZ, 179830784)):
        evaluate.main(["--checkpoint", str(source)] + eval_args)
        row = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert row["trained_timesteps"] == steps and row["device"] == "cpu"
        assert len(row["returns"]) == 2 and row["lengths"] == [6, 6]
        assert row["completions"] == 0 and row["eval_solver_iters"] == [8, 4]


def test_cli_leg2_resume(tmp_path, monkeypatch):
    """The v2 recipe's two legs through the CLI at 64 envs (8/4): leg 1 of 2
    updates saved, then ``--resume`` with ``--ent_coef 0.002 --update_goal``.
    The TrainState leg 2 starts from carries the checkpoint's params, Adam
    state, normalizer, env batch, generators and step count; its hparams are
    leg 2's and its reward params the variant's defaults (leg 1's curriculum
    state dropped), and ``scaled_epsilon`` follows the JAX package's
    ``update_goal`` over leg 2's updates, bit for bit."""
    base = ["--device", "cpu", "--disable_wandb", "--config", "train_configs/ppo-mrp-v2.json",
            "--n_envs", "64", "--n_steps", "4", "--batch_size", "128", "--n_epochs", "1",
            "--seed", "3", "--update_goal", *sum((["--" + k, str(v)] for k, v in ITERS.items()),
                                                 [])]
    monkeypatch.chdir(ROOT)
    cli.main(base + ["--total_timesteps", "512", "--save_model",
                     "--checkpoint_dir", str(tmp_path / "leg1")])
    leg1 = tmp_path / "leg1" / "MultiRobotPuzzle-v2"
    saved = ckpt.load(leg1)
    assert saved["timesteps"] == 512 and saved["hparams"]["ent_coef"] != np.float32(0.002)

    seen, schedule = {}, []
    learn, curriculum = PPO.learn, PPO.apply_curriculum

    def spy_learn(self, total_timesteps=None, log_fn=None, state=None, **kw):
        seen["tree"] = copy.deepcopy(ckpt.to_tree(state))  # learn advances it in place
        seen["n_updates"] = total_timesteps // (self.cfg.n_steps * self.cfg.n_envs)
        return learn(self, total_timesteps, log_fn, state, **kw)

    def spy_curriculum(self, ts, update, n_updates):
        ts = curriculum(self, ts, update, n_updates)
        schedule.append((update, n_updates, ts.env_params.scaled_epsilon))
        return ts

    monkeypatch.setattr(PPO, "learn", spy_learn)
    monkeypatch.setattr(PPO, "apply_curriculum", spy_curriculum)
    final = cli.main(base + ["--ent_coef", "0.002", "--total_timesteps", "768",
                             "--resume", str(leg1)])
    resumed = seen["tree"]
    carried = ("params", "opt_state", "vstate", "last_obs", "generator", "env_generator",
               "timesteps", "ep_return", "ep_len", "stat_return", "stat_count")
    assert_trees_equal({k: resumed[k] for k in carried}, {k: saved[k] for k in carried})
    assert_trees_equal({k: v for k, v in resumed["normalizer"].items() if k != "gamma"},
                       {k: v for k, v in saved["normalizer"].items() if k != "gamma"})
    cfg = PPOConfig.from_reference_json(json.loads((ROOT / "train_configs/ppo-mrp-v2.json")
                                                   .read_text()), ent_coef=0.002)
    assert resumed["hparams"] == dataclasses.asdict(HParams.from_config(cfg))
    assert resumed["hparams"]["ent_coef"] == float(np.float32(0.002))
    assert resumed["normalizer"]["gamma"] == float(np.float32(0.997))
    jp = JaxRewardParams.default("v2")
    assert resumed["env_params"] == {f: float(np.float32(np.asarray(getattr(jp, f))))
                                     for f in resumed["env_params"]}
    # the goal schedule restarts over leg 2's 3 updates, as the JAX package's
    assert seen["n_updates"] == 3 and [u for u, _n, _e in schedule] == [0, 1, 2]
    for u, n, eps in schedule:
        want = np.float32(np.asarray(jp.update_goal(u, n, jp.scaled_epsilon).scaled_epsilon))
        assert n == 3 and np.float32(eps).view(np.uint32) == want.view(np.uint32), (u, eps, want)
    assert int(final.timesteps) == 512 + 768 and final.hparams.ent_coef == resumed["hparams"][
        "ent_coef"]


def test_no_cuda_raises(monkeypatch, tmp_path):
    """Without CUDA and without a device named, the learner and both CLIs
    refuse to run rather than move onto the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PPO(tiny_cfg())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["--disable_wandb", "--n_envs", "2", "--total_timesteps", "8"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        evaluate.main(["--checkpoint", str(V0_POLICY_NPZ)])


@pytest.mark.parametrize("env_id", ["MultiRobotPuzzleHeavy-v0", "MultiRobotPuzzle-v2",
                                    "MultiRobotPuzzle-v3"])
def test_train_step_runs_on_other_variants(env_id):
    """The learner takes its dims from the env: one update on each other
    flat-obs family runs finite."""
    algo = PPO(tiny_cfg(env_id=env_id, n_steps=2, velocity_iters=2, position_iters=1),
               device="cpu")
    ts, m = algo.train_step(algo.init_state())
    assert ts.last_obs.shape == (2, algo.env.cfg.obs_dim)
    assert all(bool(torch.isfinite(m[k])) for k in ("loss", "value_loss", "entropy"))
