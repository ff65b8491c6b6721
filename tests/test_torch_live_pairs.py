"""Kernel A's load counter (``profiling.LIVE_PAIRS``, ``_cuda_build.live_pairs``
and ``live_pair_stats``) on the CPU at 8 envs.

* ``live_pair_stats`` on a known mask: the mean per env, the mean over warps
  of the most loaded env (a partial last warp padded with empty envs), the
  most of any env.
* ``live_pairs`` are the pairs solved with a point: a sleeping island's
  manifold points are not live.
* With tracing off ``PPO.train_step`` takes no record; with it on, one per
  update, after the update's spans, of the state the rollout ended in, in
  the size class of the env's table, and the outputs are those of tracing
  off.
* ``VectorEnv.step`` with tracing off takes no record; with it on, one of
  every 25th state it returns in a tracing block, marked ``env.step``, and
  the outputs are those of tracing off.
* ``cuda``-marked (skipped without a card): the learner's graphs and the
  env step's graph captured with tracing on hold exactly their spans'
  stamps more than those captured with it off, so the counter puts no node
  into a graph.
"""

import contextlib

import pytest
import torch

import gym_puzzles_tpu_torch as gpt
from gym_puzzles_tpu_torch.api import vector
from gym_puzzles_tpu_torch.engine import _cuda_build as cb
from gym_puzzles_tpu_torch.engine import step_cuda, world
from gym_puzzles_tpu_torch.train.ppo import PPO, PPOConfig
from gym_puzzles_tpu_torch.utils import profiling

torch.set_num_threads(1)

DT = 1.0 / 50.0


def test_live_pair_stats_on_a_known_mask():
    # 3 pairs x 10 envs; live pairs per env 0 1 2 3 0 0 1 1 3 2
    per_env = [0, 1, 2, 3, 0, 0, 1, 1, 3, 2]
    live = torch.tensor([[k > p for k in per_env] for p in range(3)])
    st = cb.live_pair_stats(live, 4)
    # warps of 4 envs: (0 1 2 3) (0 0 1 1) (3 2 pad pad) -> most 3, 1, 3
    # float32 sums: exact to float32's rounding of 1.3 and 7 / 3
    assert st == dict(mean=pytest.approx(1.3, rel=1e-7), warp_max=pytest.approx(7 / 3, rel=1e-7),
                      max=3.0, envs_per_warp=4)
    assert cb.live_pair_stats(live, 1)["warp_max"] == pytest.approx(1.3)


def test_a_sleeping_island_has_no_live_pair():
    env = gpt.make("MultiRobotPuzzleHeavy-v0", num_envs=8, device="cpu", velocity_iters=4,
                   position_iters=2)
    table = env.logic.layout.table
    state, _ = env.reset(seed=4)
    bodies, contacts = state.bodies, state.contacts
    dyn = torch.as_tensor(~table.is_static)[:, None]
    asleep = dyn & (torch.arange(8) < 4)[None]  # the first half: every dynamic body asleep
    bodies = bodies.replace(awake=bodies.awake & ~asleep)
    zf, zt = torch.zeros_like(bodies.vel), torch.zeros_like(bodies.omega)
    live = cb.live_pairs(table, bodies, contacts, zf, zt, torch.zeros_like(asleep), DT)
    vc, man = world.before_solve(table, bodies, contacts, zf, zt, torch.zeros_like(asleep),
                                 DT)[0][:2]
    assert torch.equal(live, vc.solve & (vc.count > 0))
    assert not live[:, :4].any() and live[:, 4:].any()
    assert (man.count[:, :4] > 0).any()  # points kept, not solved
    woken = cb.live_pairs(table, bodies, contacts, zf, zt, dyn.expand_as(asleep), DT)
    assert woken[:, :4].any() and torch.equal(woken[:, 4:], live[:, 4:])


def _ppo(env_id):
    cfg = PPOConfig(env_id=env_id, n_envs=8, n_steps=3, batch_size=8, n_epochs=1, seed=5,
                    velocity_iters=4, position_iters=2)
    return PPO(cfg, device="cpu")


@pytest.mark.parametrize("env_id,size_class", [("MultiRobotPuzzle-v0", 0),
                                               ("MultiRobotPuzzleHeavy-v0", 1)])
def test_a_record_per_traced_update_and_none_untraced(env_id, size_class, monkeypatch):
    monkeypatch.setattr(profiling, "LIVE_PAIRS", [])

    def run(trace_on):
        algo = _ppo(env_id)
        ts = algo.init_state()
        with profiling.tracing() if trace_on else contextlib.nullcontext() as tr:
            for _ in range(2):
                ts, metrics = algo.train_step_eager(ts)
        return algo, ts, metrics, tr

    algo, off, off_metrics, _ = run(False)
    assert profiling.LIVE_PAIRS == []
    algo, on, on_metrics, tr = run(True)
    assert len(profiling.LIVE_PAIRS) == 2
    rec = profiling.LIVE_PAIRS[-1]
    table = algo.env.logic.layout.table
    assert (rec.num_envs, rec.envs_per_warp, rec.size_class) == (8, 1, size_class)
    dyn = torch.as_tensor(~table.is_static)[:, None].expand_as(on.vstate.bodies.awake)
    b = on.vstate.bodies
    live = cb.live_pairs(table, b, on.vstate.contacts, torch.zeros_like(b.vel),
                         torch.zeros_like(b.omega), dyn, DT)
    assert rec.mean == pytest.approx(float(live.sum(dim=0).float().mean()))
    assert rec.max == float(live.sum(dim=0).max()) and rec.warp_max == pytest.approx(rec.mean)
    # no span of its own, and the update's spans as they were
    assert {s.name for s in tr.spans if s.clock == "host"} == {
        "ppo.update", "ppo.noise", "ppo.rollout", "ppo.learner"}
    assert tr.steps == 2
    for a, b in zip(profiling._leaves((off.params, off.vstate, off_metrics)),
                    profiling._leaves((on.params, on.vstate, on_metrics))):
        assert a.tobytes() == b.tobytes()


def test_count_live_pairs_is_a_no_op_with_tracing_off(monkeypatch):
    monkeypatch.setattr(profiling, "LIVE_PAIRS", [])
    env = gpt.make("MultiRobotPuzzleHeavy-v0", num_envs=8, device="cpu")
    state, _ = env.reset(seed=0)
    assert profiling.count_live_pairs(env.logic.layout.table, state, DT) is None
    with profiling.tracing():
        rec = profiling.count_live_pairs(env.logic.layout.table, state, DT)
    assert profiling.LIVE_PAIRS == [rec] and rec.size_class == 1 and rec.mean > 0


def _env_steps(env, n, trace_on):
    """``n`` steps of ``env`` from its seed-2 spawn with seeded random
    actions, tracing on or off -> (every output, the tracing block's trace)."""
    state, _ = env.reset(seed=2)
    g = torch.Generator().manual_seed(3)
    acts = torch.rand((n, env.num_envs, env.cfg.act_dim), generator=g).to(env.device) * 2 - 1
    outs = []
    with profiling.tracing() if trace_on else contextlib.nullcontext() as tr:
        for k in range(n):
            out = env.step(state, acts[k])
            state = out[0]
            outs.append(out)
    return outs, tr


def test_env_steps_take_a_record_every_25th_traced_step(monkeypatch):
    monkeypatch.setattr(profiling, "LIVE_PAIRS", [])
    env = gpt.make("MultiRobotPuzzle-v0", num_envs=8, device="cpu", velocity_iters=4,
                   position_iters=2)
    off, _ = _env_steps(env, 100, False)
    assert profiling.LIVE_PAIRS == []
    on, tr = _env_steps(env, 100, True)
    recs = profiling.LIVE_PAIRS
    assert vector.LIVE_PAIRS_EVERY == 25 and len(recs) == 4
    assert {(r.site, r.num_envs, r.size_class) for r in recs} == {("env.step", 8, 0)}
    table = env.logic.layout.table
    for rec, k in zip(recs, (24, 49, 74, 99)):
        s = on[k][0]
        b = s.bodies
        dyn = torch.as_tensor(~table.is_static)[:, None].expand_as(b.awake)
        live = cb.live_pairs(table, b, s.contacts, torch.zeros_like(b.vel),
                             torch.zeros_like(b.omega), dyn, DT)
        assert rec.mean == pytest.approx(float(live.sum(dim=0).float().mean()))
    # no span of its own, and the steps' outputs those of tracing off
    assert {s.name for s in tr.spans if s.clock == "host"} == {"env.step"}
    assert tr.steps == 100
    for a, b in zip(profiling._leaves(off), profiling._leaves(on)):
        assert a.tobytes() == b.tobytes()
    # a new tracing block counts its steps from 0
    _env_steps(env, 24, True)
    assert len(profiling.LIVE_PAIRS) == 4


# --------------------------------------------------------------------------
# on the card
# --------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; on the card: "
                    "python -m pytest --noconftest tests/test_torch_live_pairs.py")
    return torch.device("cuda")


@pytest.mark.cuda
def test_the_counter_adds_no_graph_node_on_card(cuda_device, monkeypatch):
    monkeypatch.setattr(profiling, "LIVE_PAIRS", [])
    # the stamp ring this test makes is its own: a later tracing block of the
    # process on the CPU then finds no CUDA ring to zero under its profiler
    monkeypatch.setattr(profiling, "_RINGS", {})
    cfg = PPOConfig(env_id="MultiRobotPuzzleHeavy-v0", n_envs=256, n_steps=4, batch_size=512,
                    n_epochs=2, seed=5)
    algo = PPO(cfg, device=cuda_device)
    ts = algo.init_state()
    ts, _ = algo.train_step(ts)  # captures both graphs, tracing off
    assert profiling.LIVE_PAIRS == []
    off = {c.name: c for c in profiling.CAPTURES[-2:]}
    traced = PPO(cfg, device=cuda_device)
    tts = traced.init_state()
    with profiling.tracing():
        tts, _ = traced.train_step(tts)  # captures both graphs, tracing on
    with profiling.tracing() as tr:
        tts, _ = traced.train_step(tts)  # one replay of each
    on = {c.name: c for c in profiling.CAPTURES[-2:]}
    assert set(on) == set(off) == {"ppo.rollout", "ppo.learner"}
    assert all(on[k].traced and not off[k].traced for k in on)
    stamps = 2 * len([s for s in tr.spans if s.clock == "device"])
    assert sum(on[k].kernel_nodes - off[k].kernel_nodes for k in on) == stamps
    assert len(profiling.LIVE_PAIRS) == 2
    rec = profiling.LIVE_PAIRS[-1]
    assert (rec.num_envs, rec.size_class) == (256, 1)
    assert rec.envs_per_warp == step_cuda.KERNEL.envs_per_warp()


@pytest.mark.cuda
def test_the_env_step_counter_adds_no_graph_node_on_card(cuda_device, monkeypatch):
    monkeypatch.setattr(profiling, "LIVE_PAIRS", [])
    monkeypatch.setattr(profiling, "_RINGS", {})
    env = gpt.make("MultiRobotPuzzle-v0", num_envs=256, device=cuda_device)
    _env_steps(env, 30, False)  # captures the step's graph, tracing off
    assert profiling.LIVE_PAIRS == []
    off = profiling.CAPTURES[-1]
    traced = gpt.make("MultiRobotPuzzle-v0", num_envs=256, device=cuda_device)
    _outs, _tr = _env_steps(traced, 1, True)  # captures the step's graph, tracing on
    on = profiling.CAPTURES[-1]
    _outs, tr = _env_steps(traced, 25, True)  # replays
    assert off.name == on.name == "env.step" and on.traced and not off.traced
    stamps = 2 * len([s for s in tr.spans if s.clock == "device"]) // 25
    assert on.kernel_nodes - off.kernel_nodes == stamps
    assert len(profiling.LIVE_PAIRS) == 1
    rec = profiling.LIVE_PAIRS[-1]
    assert (rec.site, rec.num_envs, rec.size_class) == ("env.step", 256, 0)
    assert rec.envs_per_warp == step_cuda.KERNEL.envs_per_warp()
