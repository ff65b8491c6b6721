"""The port's data-parallel learner (``gym_puzzles_tpu_torch.parallel``)
against the JAX package's distributed train step on the CPU.

The oracle is ``PPO._build_train_step(axis_name="data", n_devices=2)`` under
``jax.vmap(..., axis_name="data")`` (the collectives of ``shard_map`` over a
2-device mesh, as ``tests/test_distributed_equiv.py`` uses it) on the stacked
per-device shards of the JAX ``init_state()``, traced with fixed action noise
and minibatch orders, one per device (``jax.random.normal`` /
``permutation`` swapped for lookups by ``axis_index``).  The port runs as two
real gloo processes (``tests/_torch_mp_distributed.py``), each from its shard
of that state, with the same noise and order.  v0, 4 envs per rank, 8 steps,
8/4 solver iterations."""

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from gym_puzzles_tpu.parallel import mesh as jmesh
from gym_puzzles_tpu.train import ppo as jppo
from gym_puzzles_tpu_torch import convert
from gym_puzzles_tpu_torch.parallel import DistributedPPO, train_state_specs
from gym_puzzles_tpu_torch.train import checkpoint as ckpt
from gym_puzzles_tpu_torch.train.ppo import PPO, PPOConfig
from torch_port_helpers import np_tree

import _torch_mp_distributed as worker

torch.set_num_threads(1)

W, E, T = 2, 4, 8  # ranks, envs per rank, rollout steps
CFG = dict(env_id="MultiRobotPuzzle-v0", n_envs=W * E, n_steps=T, batch_size=32, n_epochs=2,
           velocity_iters=8, position_iters=4, seed=3)
_rng = np.random.RandomState(0)
NOISE = (0.3 * _rng.randn(W, E, 6)).astype(np.float32)  # per rank, the same at every step
PERM = np.stack([_rng.permutation(T * E) for _ in range(W)])  # per rank, every epoch
CASES = {"default": {}, "kl_stop": {"target_kl": 1e-6}}
jtree = lambda x: jax.tree_util.tree_map(np.asarray, x)  # noqa: E731


def _stack_shards(specs, ts):
    """Global TrainState -> leaves stacked on a leading device axis: each
    device's window of a sharded leaf, copies of a replicated one."""

    def stack(spec, leaf):
        dim = next((i for i, name in enumerate(spec) if name is not None), None)
        if dim is None:
            return jnp.stack([leaf] * W)
        n = leaf.shape[dim] // W
        return jnp.stack([jax.lax.slice_in_dim(leaf, i * n, (i + 1) * n, axis=dim)
                          for i in range(W)])

    return jax.tree_util.tree_map(stack, specs, ts, is_leaf=lambda x: isinstance(x, P))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{case: (start, oracle state, oracle metrics)} and each rank's results."""
    algo = jppo.PPO(jppo.PPOConfig(**CFG))
    inner = algo._build_train_step(axis_name="data", n_devices=W)
    normal, permutation = jax.random.normal, jax.random.permutation

    def fixed_normal(key, shape=(), *args, **kw):
        if tuple(shape) == (E, 6):
            return jnp.asarray(NOISE)[jax.lax.axis_index("data")]
        return normal(key, shape, *args, **kw)

    def fixed_permutation(key, x, *args, **kw):
        if x == T * E:
            return jnp.asarray(PERM)[jax.lax.axis_index("data")]
        return permutation(key, x, *args, **kw)

    oracle, cases = {}, {}
    with pytest.MonkeyPatch.context() as mp_:
        mp_.setattr(jax.random, "normal", fixed_normal)
        mp_.setattr(jax.random, "permutation", fixed_permutation)
        step = jax.jit(jax.vmap(inner, axis_name="data"))
        for name, hp in CASES.items():
            ts0 = algo.set_hparams(algo.init_state(), **hp)
            specs = jmesh.train_state_specs("data", batch_axis=algo.env.batch_axis)(ts0)
            env, obs, norm = np_tree(ts0.vstate.env), np.asarray(ts0.last_obs), np_tree(
                ts0.normalizer)
            split = lambda a, axis: np.split(a, W, axis=axis)  # noqa: E731
            shards = [jax.tree_util.tree_map(lambda a: split(a, -1)[r], env) for r in range(W)]
            start = dict(params=jtree(ts0.params), vstate=shards, last_obs=split(obs, 0),
                         normalizer={k: norm[k] for k in ("obs_rms", "ret_rms", "gamma")},
                         returns=split(norm["returns"], 0))
            o_ts, o_m = step(_stack_shards(specs, ts0))
            oracle[name] = (o_ts, jax.device_get(o_m))
            cases[name] = (hp, start, NOISE, PERM)
    out = tmp_path_factory.mktemp("ranks")
    mp.start_processes(worker.run_rank, args=(W, CFG, cases, str(out / "rdv"), str(out)),
                       nprocs=W, start_method="spawn")
    ranks = [torch.load(out / f"rank{r}.pt", weights_only=False) for r in range(W)]
    return oracle, ranks


def _max_abs(port_tree, jax_tree):
    pa = dict(jax.tree_util.tree_leaves_with_path(port_tree))
    ja = dict(jax.tree_util.tree_leaves_with_path(jax_tree))
    assert pa.keys() == ja.keys()
    return max(float(np.abs(np.asarray(pa[k], np.float64) - np.asarray(ja[k])).max()) for k in pa)


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        return {p: v for k in tree for p, v in _leaves(tree[k], f"{path}.{k}").items()}
    return {path: tree}


def _sharded_paths():
    ts = DistributedPPO(PPOConfig(**CFG), device="cpu").ppo.init_state()
    return [k for k, sharded in train_state_specs(ts).items() if sharded]


@pytest.mark.parametrize("case", list(CASES))
def test_two_ranks_match_jax(runs, case):
    """Params and Adam moments within 1e-4, the normalizer, last obs and
    episode returns within 1e-5, metrics within 1e-4 relative (the policy
    loss within 1e-6 absolute), ``kl_stopped`` equal; the replicated fields
    bitwise equal across the ranks, the sharded ones concatenated against the
    oracle's.  With ``target_kl=1e-6`` the stop fires and the four losses are
    not compared (the port averages only the minibatches that ran)."""
    oracle, ranks = runs
    o_ts, o_m = oracle[case]
    got = [r[case] for r in ranks]
    sharded = _sharded_paths()

    a, b = (_leaves(g["state"]) for g in got)
    for path in a:
        if not any(path.startswith(f".{s}") for s in sharded):
            va, vb = a[path], b[path]
            same = (torch.equal(va.nan_to_num(), vb.nan_to_num())
                    if isinstance(va, torch.Tensor) else va == vb)
            assert same, f"replicated {path} differs between the ranks"
    assert _leaves(got[0]["metrics"]).keys() == _leaves(got[1]["metrics"]).keys()
    for k, v in got[0]["metrics"].items():
        other = got[1]["metrics"][k]
        assert (torch.equal(v.nan_to_num(), other.nan_to_num())
                if isinstance(v, torch.Tensor) else v == other), k

    state = got[0]["state"]
    first = lambda x: jax.tree_util.tree_map(lambda a: np.asarray(a)[0], x)  # noqa: E731
    d_params = _max_abs(convert.params_to_numpy(state["params"]),
                        first(jtree(o_ts.params["params"])))
    d_mu = _max_abs(convert.params_to_numpy(state["opt_state"]["mu"]),
                    first(jtree(o_ts.opt_state.mu["params"])))
    d_nu = _max_abs(convert.params_to_numpy(state["opt_state"]["nu"]),
                    first(jtree(o_ts.opt_state.nu["params"])))
    print(f"{case}: max |params| diff {d_params:.3e}, mu {d_mu:.3e}, nu {d_nu:.3e}")
    assert max(d_params, d_mu, d_nu) <= 1e-4
    assert state["opt_state"]["count"] == int(np.asarray(o_ts.opt_state.count)[0])

    jn = np_tree(o_ts.normalizer)
    for name in ("obs_rms", "ret_rms"):
        for k in ("mean", "var", "count"):
            np.testing.assert_allclose(state["normalizer"][name][k].numpy(), jn[name][k][0],
                                       rtol=1e-5, atol=1e-5, err_msg=f"{name}.{k}")
    cat = lambda key: np.concatenate([g["state"][key].numpy() for g in got])  # noqa: E731
    np.testing.assert_allclose(np.concatenate([g["state"]["normalizer"]["returns"].numpy()
                                               for g in got]),
                               np.concatenate(list(jn["returns"])), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(cat("last_obs"), np.concatenate(list(np.asarray(o_ts.last_obs))),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(cat("ep_return"),
                               np.concatenate(list(np.asarray(o_ts.ep_return))),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(state["stat_count"].numpy(), np.asarray(o_ts.stat_count)[0])
    assert int(state["timesteps"]) == int(o_m["timesteps"][0]) == W * T * E

    m = got[0]["metrics"]
    assert bool(m["kl_stopped"]) == bool(o_m["kl_stopped"][0]) == (case == "kl_stop")
    keys = ["approx_kl", "ep_rew_mean", "episodes"]
    if case == "default":
        keys += ["loss", "policy_loss", "value_loss", "entropy"]
    for k in keys:
        atol = 1e-6 if k == "policy_loss" else 0.0
        np.testing.assert_allclose(float(m[k]), float(o_m[k][0]), rtol=1e-4, atol=atol,
                                   equal_nan=True, err_msg=k)
    assert int(m["completions"]) == int(o_m["completions"][0])
    # the statistics, one all-reduce per minibatch that ran, the losses and
    # the completions
    n_minibatch = CFG["n_epochs"] * (T * E) // (CFG["batch_size"] // W)
    assert got[0]["collectives"] == got[1]["collectives"] <= 3 + n_minibatch
    if case == "default":
        assert got[0]["collectives"] == 3 + n_minibatch


def test_initial_shards_are_the_single_process_batch(runs):
    """The two ranks' initial shards, concatenated, are the single-process
    ``init_state``; the replicated fields are equal; the ranks' env
    generators, learner generators and noise differ."""
    _, ranks = runs
    single = ckpt.to_tree(PPO(PPOConfig(**CFG), device="cpu").init_state())
    a, b = (r["init"] for r in ranks)
    sharded = _sharded_paths()
    for path, want in _leaves(single).items():
        key = path[1:]
        if key in ("generator", "env_generator"):
            continue
        got = [_leaves(x)[path] for x in (a, b)]
        if any(key.startswith(s) for s in sharded):
            # env state: env axis last; obs, returns and episode counters: first
            axis = -1 if key.startswith("vstate") else 0
            assert torch.equal(torch.cat(got, dim=axis), want), path
        else:
            same = torch.equal if isinstance(want, torch.Tensor) else (lambda x, y: x == y)
            assert same(got[0], want) and same(got[1], want), path
    # rank 0 keeps the single-process streams; rank 1 has its own
    assert torch.equal(a["generator"], single["generator"])
    assert torch.equal(a["env_generator"], single["env_generator"])
    assert not torch.equal(a["env_generator"], b["env_generator"])
    assert not torch.equal(a["generator"], b["generator"])
    assert not torch.allclose(ranks[0]["noise"], ranks[1]["noise"])


def test_world_size_one_equals_ppo(tmp_path):
    """On a one-rank gloo group ``DistributedPPO`` equals ``PPO.train_step``
    bit for bit: init, two updates (every state field, the generators among
    them, and every metric), and a sharded checkpoint restores."""
    cfg = PPOConfig(**dict(CFG, n_envs=E, velocity_iters=4, position_iters=2))
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rdv", world_size=1, rank=0)
    try:
        plain, algo = PPO(cfg, device="cpu"), DistributedPPO(cfg, device="cpu")
        assert algo.mesh.backend == "gloo" and algo.mesh.world_size == 1
        a, b = plain.init_state(), algo.init_state()
        for _ in range(2):
            a, ma = plain.train_step(a)
            b, mb = algo.train_step(b)
            for x, y in ((ckpt.to_tree(a), ckpt.to_tree(b)), (ckpt.to_tree(ma), ckpt.to_tree(mb))):
                lx, ly = _leaves(x), _leaves(y)
                assert lx.keys() == ly.keys()
                for k in lx:
                    same = (lx[k].dtype == ly[k].dtype
                            and torch.equal(lx[k].nan_to_num(), ly[k].nan_to_num())
                            if isinstance(lx[k], torch.Tensor) else lx[k] == ly[k])
                    assert same, k
        ckpt.save(tmp_path / "ckpt", b, 1, mesh=algo.mesh)
        assert sorted(p.name for p in (tmp_path / "ckpt" / "1").iterdir()) == [
            "shard_0.pt", "state.pt"]
        fresh = DistributedPPO(cfg, device="cpu")
        r = ckpt.restore(tmp_path / "ckpt", fresh.init_state(), mesh=fresh.mesh)
        assert torch.equal(r.last_obs, b.last_obs) and torch.equal(r.ep_len, b.ep_len)
        with pytest.raises(ValueError, match="world size 1 restored at world size None"):
            ckpt.restore(tmp_path / "ckpt", plain.init_state())
    finally:
        dist.destroy_process_group()


def test_refuses_indivisible_n_envs_and_cnn(runs):
    _, ranks = runs
    assert ranks[0]["refused"] == ranks[1]["refused"] == "n_envs=3 must divide over 2 ranks"
    with pytest.raises(ValueError, match="policy='mlp'"):
        DistributedPPO(PPOConfig(**dict(CFG, policy="cnn")), device="cpu")
