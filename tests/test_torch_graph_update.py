"""The learner body that the port's learner CUDA graph captures
(``PPO.learn_steps``, ``utils/cuda_graph.py``), on the CPU at small width.

* (a) The body with its hyperparameters as the graph reads them (0-d float32
  views of one buffer) gives the same params, Adam state and metrics bit for
  bit as with Python floats, on the MLP and the CNN learner, with knobs moved
  away from their defaults.
* (b) Adam's bias corrections computed on the device (``bias_corrections``)
  against numpy float32's ``1 - b ** count`` for counts 1..10,000: each power
  within one unit in the last place, each correction within that unit.
* (c) An update whose target-KL stop fires at minibatch k leaves params,
  Adam's moments and count bit for bit as a run of only the first k
  minibatches; the frozen minibatches' losses still enter the averages.
* (d) The learner graph's signature (the ``cuda_graph.flatten`` spec of its
  inputs) stays the same across updates, ``anneal_lr`` and ``set_hparams``
  of every knob but ``gamma``, which changes it (it also lives in the
  normalizer, as a Python float).
* (e) The copy-in trap that makes the rollout's Transition reach the learner
  graph through its closure: a tensor written in place without a version bump
  (as a replay writes its buffers) is not copied again into an argument slot;
  and the learner's inputs hold no view of the Transition.
* Adam's count as a tensor round-trips through checkpoints (one file, and
  the replicated file of a sharded save); a checkpoint written with an
  ``int`` count still restores.
* ``cuda``-marked (skipped without a card; ``chip_smoke.py`` phase 17 runs it
  at full width): a ``train_step`` replay equals ``train_step_eager`` bit for
  bit.
"""

import numpy as np
import pytest
import torch

from gym_puzzles_tpu_torch.api.image_obs import DeviceImageVectorEnv
from gym_puzzles_tpu_torch.parallel.mesh import Mesh
from gym_puzzles_tpu_torch.train import checkpoint as ckpt
from gym_puzzles_tpu_torch.train import ppo as tppo
from gym_puzzles_tpu_torch.train.ppo import PPO, HParams, PPOConfig
from gym_puzzles_tpu_torch.utils import cuda_graph as cg
from tests.torch_port_helpers import ITERS

torch.set_num_threads(1)

SMALL = dict(n_envs=4, n_steps=8, batch_size=8, n_epochs=2, net_arch=(32, 32), seed=5, **ITERS)
# knobs away from the defaults, every one of them read by the learner
MOVED = dict(learning_rate=1.3e-3, clip_range=0.15, ent_coef=0.02, vf_coef=0.7,
             max_grad_norm=0.3, target_kl=0.02, gamma=0.97, gae_lambda=0.9)


def learner(policy="mlp", **kw):
    cfg = PPOConfig(**dict(SMALL, **kw))
    if policy == "mlp":
        return PPO(cfg, device="cpu")
    return PPO(PPOConfig(**dict(SMALL, policy="cnn", **kw)), device="cpu",
               env=DeviceImageVectorEnv(num_envs=SMALL["n_envs"], downsample=16, device="cpu",
                                        **ITERS))


def after_rollout(algo, **hp):
    """(start, ts after one eager rollout, its Transition)."""
    start = algo.set_hparams(algo.init_state(), **hp)
    ts, traj, _value = algo.rollout_eager(start)
    return start, ts, traj


def orders(algo, seed=0):
    total = algo.cfg.n_steps * algo.cfg.n_envs
    gen = torch.Generator().manual_seed(seed)
    return torch.stack([torch.randperm(total, generator=gen) for _ in range(algo.cfg.n_epochs)])


def assert_bitwise(a, b):
    la, sa = cg.flatten(a)
    lb, sb = cg.flatten(b)
    assert sa == sb
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and torch.equal(x.nan_to_num(), y.nan_to_num()), (x, y)
        assert torch.equal(x.isnan(), y.isnan())


def tensor_hparams(hp):
    buf = cg.ParamsBuffer("cpu", HParams)
    buf.load(hp)
    return buf.view


# --------------------------------------------------------------------------
# (a) device hyperparameters
# --------------------------------------------------------------------------


@pytest.mark.parametrize("policy", ["mlp", "cnn"])
def test_device_hparams_bitwise(policy):
    algo = learner(policy)
    start, ts, traj = after_rollout(algo, **MOVED)
    (carry, (norm, obs, hp, _perms, stats)) = algo.learner_inputs(start, ts)
    perms = orders(algo)
    assert all(isinstance(getattr(hp, k), float) for k in MOVED)
    floats = algo.learn_steps(carry, norm, obs, hp, perms, stats, traj)
    views = tensor_hparams(hp)
    assert all(isinstance(getattr(views, k), torch.Tensor) and getattr(views, k).dim() == 0
               for k in MOVED)
    tensors = algo.learn_steps(carry, norm, obs, views, perms, stats, traj)
    assert_bitwise(floats, tensors)
    (params, opt), metrics = floats
    assert int(opt.count) > 0 and metrics["kl_stopped"].dtype == torch.bool
    assert any(not torch.equal(params[k], ts.params[k]) for k in params)
    # the body reads the knobs: another value, another result
    other = algo.learn_steps(carry, norm, obs, tensor_hparams(hp.replace(vf_coef=0.25)),
                             perms, stats, traj)
    assert not torch.equal(other[1]["loss"], metrics["loss"])


# --------------------------------------------------------------------------
# (b) Adam's bias corrections
# --------------------------------------------------------------------------


def test_bias_corrections_match_numpy_float32():
    counts = np.arange(1, 10_001)
    got = tppo.bias_corrections(torch.tensor(counts, dtype=torch.int32))
    n_equal = []
    for b, bc in zip((tppo.ADAM_B1, tppo.ADAM_B2), got):
        bf = np.float32(b)
        powers = np.array([bf ** np.float32(c) for c in counts], np.float32)
        want = (np.float32(1.0) - powers).astype(np.float32)
        mine = bc.numpy()
        assert bc.dtype == torch.float32
        # the power within one unit in its last place, and the correction
        # within that unit plus the rounding of the subtraction (exact while
        # the power is at least 1/2)
        assert np.all(np.abs(mine - want) <= np.spacing(powers) + np.spacing(want)), b
        n_equal.append(int((mine == want).sum()))
    print(f"bias corrections equal to numpy float32's at {n_equal} of {len(counts)} counts")
    assert min(n_equal) >= 0.999 * len(counts)


# --------------------------------------------------------------------------
# (c) the stop
# --------------------------------------------------------------------------


def test_stop_at_k_equals_first_k_minibatches():
    algo = learner("mlp", n_epochs=3)
    start, ts, traj = after_rollout(algo)
    hp0 = cg.as_device_scalars(ts.hparams.replace(target_kl=0.0), "cpu")
    total = traj.done.numel()
    flat = lambda x: x.reshape((total,) + x.shape[2:])  # noqa: E731
    with torch.no_grad():
        value = algo.bootstrap_value(ts.params, ts.normalizer, ts.last_obs)
        adv, ret = tppo.compute_gae(traj, value, hp0.gamma, hp0.gae_lambda)
    batch = (flat(traj.obs), flat(traj.action), flat(traj.log_prob), flat(adv), flat(ret))
    idxs = orders(algo)[:, :total].reshape(-1, algo.cfg.batch_size)
    n = len(idxs)

    def run(rows, hp):
        return algo.minibatch_steps(ts.params, ts.opt_state, batch, rows, hp)

    # the KL after each minibatch with no stop; stop at the first k >= 2 whose
    # KL exceeds every earlier one
    kls = [float(run(idxs[:j], hp0)[3]) for j in range(1, n + 1)]
    k = next(j for j in range(2, n) if kls[j - 1] > max(kls[: j - 1]))
    limit = (kls[k - 1] + max(kls[: k - 1])) / 2
    hp = hp0.replace(target_kl=torch.tensor(limit / 1.5, dtype=torch.float32))
    assert max(kls[: k - 1]) < float(1.5 * hp.target_kl) < kls[k - 1]

    params, opt, stop, kl_last, losses = run(idxs, hp)
    want_params, want_opt, want_stop, want_kl, want_losses = run(idxs[:k], hp0)
    assert bool(stop) and not bool(want_stop)
    assert int(opt.count) == int(want_opt.count) == k < n
    assert_bitwise((params, opt.mu, opt.nu, opt.count, kl_last),
                   (want_params, want_opt.mu, want_opt.nu, want_opt.count, want_kl))
    # every minibatch ran: the first k as the short run's, each later one on
    # the stopped params
    assert losses.shape == (n, 4)
    assert torch.equal(losses[:k], want_losses)
    for j in range(k, n):
        loss_j, _aux = algo.loss(params, *(x[idxs[j]] for x in batch), hp)
        assert torch.equal(losses[j, 0], loss_j.detach())


# --------------------------------------------------------------------------
# (d) the learner graph's signature
# --------------------------------------------------------------------------


def test_learner_signature_stable_but_for_gamma():
    algo = learner("mlp", anneal_lr=True)
    start = algo.init_state()
    spec = lambda s, t: cg.flatten(algo.learner_inputs(s, t))[1]  # noqa: E731
    ts, _traj, _value = algo.rollout_eager(start)
    first = spec(start, ts)
    # after an update: params, Adam state (count included) and timesteps moved
    ts2, metrics = algo.train_step(start)
    assert int(ts2.opt_state.count) > 0
    assert spec(ts2, ts2) == first
    # anneal_lr moves the learning rate every update
    ts3 = algo.apply_curriculum(ts2, 3, 10)
    assert ts3.hparams.learning_rate != ts2.hparams.learning_rate
    assert spec(ts3, ts3) == first
    ts4 = algo.set_hparams(ts3, **{k: v for k, v in MOVED.items() if k != "gamma"})
    assert spec(ts4, ts4) == first
    ts5 = algo.set_hparams(ts4, gamma=MOVED["gamma"])
    assert spec(ts5, ts5) != first
    # given orders are an input of their own
    assert cg.flatten(algo.learner_inputs(ts2, ts2, orders(algo)))[1] != first


# --------------------------------------------------------------------------
# (e) why the Transition goes by reference
# --------------------------------------------------------------------------


def test_unbumped_write_is_not_copied_again():
    fb = cg.FlatBuffer([torch.zeros(4)], "cpu")
    slot = cg._Slot(fb.views[0])
    traj = torch.zeros(4)
    slot.load(traj)
    version = traj._version
    traj.data.fill_(5.0)  # a write that leaves the version as it was, as a replay's does
    assert traj._version == version and traj.tolist() == [5.0] * 4
    slot.load(traj)
    assert fb.views[0].tolist() == [0.0] * 4  # the slot kept the first content
    cg._load_slots([slot], [traj])
    assert fb.views[0].tolist() == [0.0] * 4
    traj.add_(1.0)  # a write that bumps the version: copied
    cg._load_slots([slot], [traj])
    assert fb.views[0].tolist() == [6.0] * 4

    # the learner's graph inputs hold no view of the Transition: it reaches
    # the body through the graph's closure
    algo = learner("mlp")
    start, ts, traj = after_rollout(algo)
    leaves, _spec = cg.flatten(algo.learner_inputs(start, ts))
    storages = {t.untyped_storage().data_ptr() for t in cg.flatten(traj)[0]}
    assert not any(isinstance(x, torch.Tensor) and x.untyped_storage().data_ptr() in storages
                   for x in leaves)


# --------------------------------------------------------------------------
# checkpoints
# --------------------------------------------------------------------------


def test_adam_count_checkpoints(tmp_path):
    algo = learner("mlp", target_kl=None)
    ts, _metrics = algo.train_step(algo.init_state())
    count = ts.opt_state.count
    assert count.dtype == torch.int32 and count.dim() == 0 and int(count) == 8
    ckpt.save(tmp_path / "one", ts, 32)
    back = ckpt.restore(tmp_path / "one", algo.init_state())
    assert back.opt_state.count.dtype == torch.int32 and int(back.opt_state.count) == 8

    # a checkpoint written when the count was a Python int
    tree = ckpt.load(tmp_path / "one", 32)
    tree["opt_state"]["count"] = 8
    (tmp_path / "old" / "32").mkdir(parents=True)
    torch.save(tree, tmp_path / "old" / "32" / ckpt.STATE_FILE)
    old = ckpt.restore(tmp_path / "old", algo.init_state())
    assert_bitwise(ckpt.to_tree(old), ckpt.to_tree(back))

    # a sharded save: the count is replicated, in state.pt
    mesh = Mesh(group=None, rank=0, world_size=1, backend=None)
    ckpt.save(tmp_path / "sharded", ts, 32, mesh=mesh)
    assert ckpt.load(tmp_path / "sharded", 32)["opt_state"]["count"].dtype == torch.int32
    sharded = ckpt.restore(tmp_path / "sharded", algo.init_state(), mesh=mesh)
    assert_bitwise(ckpt.to_tree(sharded), ckpt.to_tree(back))
    # and the resumed update is the uninterrupted one
    ts_next, m_next = algo.train_step(ts)
    r_next, rm_next = algo.train_step(sharded)
    assert_bitwise((ckpt.to_tree(r_next), rm_next), (ckpt.to_tree(ts_next), m_next))


# --------------------------------------------------------------------------
# on the card
# --------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; on the card chip_smoke.py phase 17 runs this check")
    return torch.device("cuda")


@pytest.mark.cuda
def test_learner_replay_equals_eager_on_card(cuda_device):
    algo = PPO(PPOConfig(n_envs=256, n_steps=8, batch_size=512, n_epochs=2, target_kl=5e-4),
               device=cuda_device)
    ts = algo.init_state()
    states = ts.generator.get_state(), algo.env.generator.get_state()
    got, gts = [], ts
    for _ in range(2):
        gts, metrics = algo.train_step(gts)
        got.append((ckpt.to_tree(gts), metrics))
    ts.generator.set_state(states[0])
    algo.env.generator.set_state(states[1])
    ets = ts
    for want in got:
        ets, metrics = algo.train_step_eager(ets)
        assert_bitwise(want, (ckpt.to_tree(ets), metrics))
    # per minibatch (2 epochs x 4): the fused optimizer step's two launches
    # and the minibatch gradient chain's four
    assert algo.graph_launches["learner"] == {"adam_fused": 2 * 2 * 4, "mlp_grad": 4 * 2 * 4}
