"""The JAX package's trained v2 / v3 / Heavy-v2 / Heavy-v0 policies as the
port's committed policy files (``gym_puzzles_tpu_torch/policies/``): each
file is a fresh export of its JAX checkpoint, and its deterministic actions
through the port's eval path match the JAX package's on the CPU.  The same
for the policies the port trained itself on the card by the JAX recipes
(``torch_h100_*.npz``): each loads, records its run's env steps, and its
arrays in the JAX package's network and normalizer act as the port does."""

import json

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gym_puzzles_tpu.train import networks as jnet
from gym_puzzles_tpu.train import normalize as jnrm
from gym_puzzles_tpu_torch.train import checkpoint as ckpt
from gym_puzzles_tpu_torch.train import evaluate
from gym_puzzles_tpu_torch.train.ppo import PPO, PPOConfig
from torch_port_helpers import (POLICIES, ROOT, TRAINED_POLICIES, export_jax_policy,
                                npz_policy_tree)

torch.set_num_threads(1)

ACTION_TOL = 1e-5
# the v0 policy has its own tests in test_torch_train_io.py
VARIANT_POLICIES = [name for name in POLICIES if name != "v0_r4"]


@pytest.fixture(scope="module", params=VARIANT_POLICIES)
def exported(request, tmp_path_factory):
    """(policy, JAX policy tree, a fresh export of the JAX checkpoint)."""
    policy = POLICIES[request.param]
    out = tmp_path_factory.mktemp(request.param) / "policy.npz"
    return policy, export_jax_policy(policy.checkpoint, out), out


@pytest.fixture(scope="module", params=VARIANT_POLICIES + list(TRAINED_POLICIES))
def policy_tree(request, tmp_path_factory):
    """(policy, its JAX policy tree): a JAX policy's read from its checkpoint
    by the JAX package's reader, a port-trained policy's from its file."""
    if request.param in TRAINED_POLICIES:
        policy = TRAINED_POLICIES[request.param]
        return policy, npz_policy_tree(policy.npz)
    policy = POLICIES[request.param]
    out = tmp_path_factory.mktemp(request.param) / "policy.npz"
    return policy, export_jax_policy(policy.checkpoint, out)


def test_committed_policy_is_a_fresh_export(exported):
    policy, _tree, out = exported
    with np.load(policy.npz) as committed, np.load(out) as fresh:
        assert sorted(committed.files) == sorted(fresh.files)
        for k in committed.files:
            a, b = committed[k], fresh[k]
            assert a.dtype == b.dtype and a.shape == b.shape, k
            assert a.tobytes() == b.tobytes(), k
        assert int(committed["timesteps"]) == policy.timesteps


def test_committed_policy_actions_match_jax(policy_tree):
    """Deterministic actions of the committed file through the port's eval
    path (``restore_policy`` + frozen normalizer + network) against the JAX
    package's ``normalize_obs(update=False)`` + ``ActorCritic.apply`` on 256
    seeded obs at the scale the normalizer saw: the clipped actions and the
    unclipped means within 1e-5 (relative to max(1, |mean|))."""
    policy, tree = policy_tree
    algo = PPO(PPOConfig(env_id=policy.env_id, n_envs=1, n_steps=2, batch_size=2, n_epochs=1),
               device="cpu")
    norm = tree["normalizer"]
    rng = np.random.RandomState(0)
    obs = (norm["obs_rms"]["mean"] + np.sqrt(norm["obs_rms"]["var"])
           * rng.randn(256, algo.obs_dim)).astype(np.float32)
    rms = lambda r: jnrm.RunningMeanStd(**{k: jnp.asarray(v) for k, v in r.items()})  # noqa
    jstate = jnrm.NormalizerState(obs_rms=rms(norm["obs_rms"]), ret_rms=rms(norm["ret_rms"]),
                                  returns=jnp.zeros((1,)), gamma=jnp.float32(0.99))
    _, n_obs = jnrm.normalize_obs(jstate, jnp.asarray(obs), update=False)
    jmean = np.asarray(jnet.ActorCritic(act_dim=algo.act_dim).apply(tree["params"], n_obs)[0])

    st = ckpt.restore_policy(policy.npz, algo.init_state())
    assert int(st.timesteps) == policy.timesteps
    with torch.no_grad():
        act = evaluate.policy_action(algo, st.params, st.normalizer, torch.from_numpy(obs),
                                     True, None)
        t_obs = evaluate.nrm.normalize_obs(st.normalizer, torch.from_numpy(obs), update=False)[1]
        mean = algo.apply(st.params, t_obs)[0].numpy()
    np.testing.assert_allclose(act.numpy(), np.clip(jmean, -1, 1), rtol=0, atol=ACTION_TOL)
    assert float((np.abs(mean - jmean) / np.maximum(1.0, np.abs(jmean))).max()) <= ACTION_TOL


@pytest.mark.parametrize("name", list(TRAINED_POLICIES))
def test_trained_policy_records_its_run(name):
    """A policy the port trained: it restores through ``restore_policy``
    into a learner of its env; its step count is the run's (every leg, a
    warm start's too), as its run's eval records say; it has no image
    pipeline; and the records name its env (the eval rows, each leg's config
    line)."""
    policy = TRAINED_POLICIES[name]
    algo = PPO(PPOConfig(env_id=policy.env_id, n_envs=1, n_steps=2, batch_size=2, n_epochs=1),
               device="cpu")
    st = ckpt.restore_policy(policy.npz, algo.init_state())
    assert int(st.timesteps) == policy.timesteps
    assert st.image_pipeline is None and "image/obs_shape" not in np.load(policy.npz).files
    records = ROOT / "docs" / "benchmarks"
    for seed in range(3):
        row = json.loads((records / f"torch_h100_{policy.records}_eval_seed{seed}.json")
                         .read_text())
        assert (row["env_id"], row["trained_timesteps"]) == (policy.env_id, policy.timesteps)
        assert row["image_pipeline"] is None and len(row["returns"]) == 128
    for leg in range(policy.first_leg, policy.legs + 1):
        lines = (records / f"torch_h100_{policy.records}_leg{leg}.jsonl").read_text().splitlines()
        assert lines[0].startswith(f"config: PPOConfig(env_id='{policy.env_id}'")
