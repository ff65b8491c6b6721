"""Shared helpers of the port's engine tests (tests/test_torch_engine*.py):
the same worlds built by both packages, and one tick of each on the same
states."""


import dataclasses
import functools
from pathlib import Path

import numpy as np
import torch

import jax
import jax.numpy as jnp

from gym_puzzles_tpu.api.registry import _logic as jax_logic
from gym_puzzles_tpu.engine import shapes as jshp
from gym_puzzles_tpu.engine import types as jtypes
from gym_puzzles_tpu.engine import world as jw
from gym_puzzles_tpu_torch import convert
from gym_puzzles_tpu_torch.api.registry import _logic as torch_logic
from gym_puzzles_tpu_torch.engine import shapes as tshp
from gym_puzzles_tpu_torch.engine import types as ttypes
from gym_puzzles_tpu_torch.engine import world as tw

DT = 1.0 / 50.0
T_BOXES = [(0.5, 0.5, 0.0, -0.5), (1.5, 0.5, 0.0, 0.5)]
AGENT_POLY = [(-0.25, -0.75), (0.25, -0.75), (0.75, -0.25), (0.75, 0.25),
              (0.25, 0.75), (-0.25, 0.75), (-0.75, 0.25), (-0.75, -0.25)]


def np_tree(x):
    """JAX dataclass tree -> nested dicts of numpy arrays."""
    if dataclasses.is_dataclass(x):
        return {f.name: np_tree(getattr(x, f.name)) for f in dataclasses.fields(x)}
    return np.asarray(x)


def small_tables():
    """T-block + two octagon agents, built by both packages."""
    def build(shp, types):
        blk = types.BodySpec(
            fixtures=[types.FixtureSpec(vertices=shp.box_vertices(hx, hy, (cx, cy)),
                                        density=5.0, friction=0.999)
                      for hx, hy, cx, cy in T_BOXES],
            linear_damping=5.0, angular_damping=5.0)
        ag = lambda: types.BodySpec(
            fixtures=[types.FixtureSpec(vertices=np.array(AGENT_POLY), density=0.0,
                                        friction=0.2, from_hull=True)],
            linear_damping=5.0, angular_damping=5.0)
        return types.build_shape_table([blk, ag(), ag()])

    return build(jshp, jtypes), build(tshp, ttypes)


@functools.lru_cache(maxsize=None)
def jax_step(table, vi, pi):
    return jax.jit(jax.vmap(
        lambda b, c, f, t, w: jw.step(table, b, c, f, t, w, DT, vi, pi),
        in_axes=-1, out_axes=-1))


@functools.lru_cache(maxsize=None)
def v0_tables():
    return jax_logic("MultiRobotPuzzle-v0").layout.table, \
        torch_logic("MultiRobotPuzzle-v0").layout.table


def both_init(jt, tt, origin, angle):
    """Bodies (and empty contacts) from origin poses [B, 2, E] in both packages."""
    E = origin.shape[-1]
    jb = jax.vmap(lambda o, a: jw.init_bodies(jt, o, a), in_axes=-1, out_axes=-1)(
        jnp.asarray(origin), jnp.asarray(angle))
    jc = jax.tree_util.tree_map(lambda x: jnp.broadcast_to(x[..., None], x.shape + (E,)),
                                jw.init_contacts(jt))
    tb = convert.from_numpy(ttypes.Bodies, np_tree(jb))
    tc = tw.init_contacts(tt, E)
    return jb, jc, tb, tc


def step_both(jt, tt, jb, jc, tb, tc, force, torque, wake, vi, pi):
    jr = jax_step(jt, vi, pi)(jb, jc, jnp.asarray(force), jnp.asarray(torque), jnp.asarray(wake))
    tr = tw.step(tt, tb, tc, torch.tensor(np.array(force)), torch.tensor(np.array(torque)),
                 torch.tensor(np.array(wake)), DT, vi, pi)
    return jr, tr


def maxdiff(j, t):
    return float(np.abs(np.asarray(j, np.float64) - t.numpy()).max())


# --------------------------------------------------------------------------
# env-level drives: the JAX ``VectorEnv(backend='xla')`` beside the port's
# ``VectorEnv`` on the CPU, at 8/4 solver iterations
# --------------------------------------------------------------------------

ITERS = dict(velocity_iters=8, position_iters=4)


@functools.lru_cache(maxsize=None)
def jax_env(env_id, E, **kw):
    from gym_puzzles_tpu.api import registry as jreg

    return jreg.make(env_id, num_envs=E, auto_reset=False, **ITERS, **kw)


def jax_spawns(env, seed):
    """(EnvState with trailing env axis, obs [obs_dim, E]) from JAX reset_fast."""
    keys = jax.random.split(jax.random.key(seed), env.num_envs)
    return jax.jit(jax.vmap(env.logic.reset_fast, in_axes=(0, None), out_axes=-1))(
        keys, env.logic.default_params())


def jax_env_step(env, state, action):
    from gym_puzzles_tpu.api.vector import VectorState

    vs = VectorState(env=state, key=jax.random.split(jax.random.key(0), env.num_envs))
    vs, obs, reward, done, info = env.step(vs, jnp.asarray(action))
    return vs.env, np.asarray(obs), np.asarray(reward), np.asarray(done), info


def compare_drive(env_id, E, steps, seed, backend="fused", obs_tol=(1e-4, 1e-4),
                  reward_atol=1e-3, return_tol=(1e-4, 1e-2), need_contact=True, need_free=True,
                  **kw):
    """Spawn in the JAX env, carry the states across, and step both envs with
    the same numpy actions.  While an env has had no contact: obs within
    ``obs_tol`` (rtol, atol) and reward within ``reward_atol``; done and
    done_status equal at every step.  Past the first contact f32 chaos can
    make states diverge (docs/PARITY.md:94-99), so the returns over the
    drive (``return_tol``) and the terminations are what is compared.
    ``need_free=False`` for a world whose spawns all start in contact (v3
    with five heavy agents), where no obs is compared one by one."""
    from gym_puzzles_tpu_torch.api import registry as treg

    jenv = jax_env(env_id, E, **kw)
    tenv = treg.make(env_id, num_envs=E, auto_reset=False, device="cpu", backend=backend,
                     **ITERS, **kw)
    jstate, _ = jax_spawns(jenv, seed)
    tstate = convert.state_from_numpy(np_tree(jstate))
    rng = np.random.RandomState(seed)
    contacted = np.zeros(E, bool)
    ret_j, ret_t = np.zeros(E), np.zeros(E)
    for _ in range(steps):
        a = rng.uniform(-1, 1, (E, tenv.cfg.act_dim)).astype(np.float32)
        jstate, jobs, jrew, jdone, jinfo = jax_env_step(jenv, jstate, a)
        tstate, tobs, trew, tdone, tinfo = tenv.step(tstate, torch.as_tensor(a))
        contacted |= np.asarray(jstate.contacts.touching).any(axis=0)
        contacted |= tstate.contacts.touching.any(dim=0).numpy()
        free = ~contacted
        np.testing.assert_allclose(tobs.numpy()[free], jobs[free],
                                   rtol=obs_tol[0], atol=obs_tol[1])
        np.testing.assert_allclose(trew.numpy()[free], jrew[free], atol=reward_atol)
        np.testing.assert_array_equal(tdone.numpy(), jdone)
        np.testing.assert_array_equal(tinfo["done_status"].numpy(),
                                      np.asarray(jinfo["done_status"]))
        ret_j += jrew
        ret_t += trew.numpy()
    if need_free:
        assert not contacted.all(), "the drive should keep some envs free of contact"
    if need_contact:
        assert contacted.any(), "the drive should bring some envs into contact"
    np.testing.assert_allclose(ret_t, ret_j, rtol=return_tol[0], atol=return_tol[1])
    return tenv, tstate


def leaves(x):
    """The array leaves of a (tuple of) JAX or port dataclass tree(s), as
    numpy arrays, in field order."""
    if dataclasses.is_dataclass(x):
        return [leaf for f in dataclasses.fields(x) for leaf in leaves(getattr(x, f.name))]
    if isinstance(x, (tuple, list)):
        return [leaf for item in x for leaf in leaves(item)]
    return [x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)]


def assert_trees_close(jax_out, torch_out, rtol=1e-5, atol=1e-6):
    """A JAX result against the port's, leaf by leaf: exact for bool and int
    leaves, within (rtol, atol) for floats."""
    js, ts = leaves(jax_out), leaves(torch_out)
    assert len(js) == len(ts)
    for j, t in zip(js, ts):
        if j.dtype.kind in "bi":
            np.testing.assert_array_equal(t, j)
        else:
            np.testing.assert_allclose(t, j, rtol=rtol, atol=atol)


# --------------------------------------------------------------------------
# inputs whose live-pair lists differ from env to env (the CUDA kernels'
# sweeps visit only the live pairs)
# --------------------------------------------------------------------------


def live_pair_batch(env_id, E, seed, vi=8, pi=4):
    """The second tick's inputs (table, bodies, contacts, force, torque,
    wake) for E spawns of ``env_id`` under random controls, the first tick
    plain; the first quarter of the envs is then put to sleep (dynamic bodies
    asleep and still, no wake, no force), so its pairs keep their manifold
    points without being solved."""
    logic = torch_logic(env_id)
    table = logic.layout.table
    gen = torch.Generator().manual_seed(seed)
    state, _ = logic.reset_fast(gen, E, logic.default_params())
    act = torch.rand((logic.cfg.act_dim, E), generator=gen) * 2 - 1
    b, force, torque, wake = logic._control(state, act)
    bodies, contacts, _ = tw.step(table, b, state.contacts, force, torque, wake, DT, vi, pi)
    b, force, torque, wake = logic._control(state.replace(bodies=bodies), act)
    sleep = torch.as_tensor(~table.is_static)[:, None] & (torch.arange(E) < E // 4)[None]
    b = b.replace(awake=b.awake & ~sleep, vel=torch.where(sleep[:, None], 0.0, b.vel),
                  omega=torch.where(sleep, 0.0, b.omega))
    return (table, b, contacts, torch.where(sleep[:, None], 0.0, force),
            torch.where(sleep, 0.0, torque), wake & ~sleep)


def live_pair_cases(table, bodies, contacts, force, torque, wake):
    """What the plain prologue makes of a tick's inputs, as the cases the
    kernels' live-pair lists must get right: per env the live pairs (solved,
    effective count > 0) and whether two of them are apart in the table;
    pairs with manifold points that are not solved (their island sleeps);
    solved 2-point manifolds whose block solve is degraded to 1 point."""
    vc, man = tw.before_solve(table, bodies, contacts, force, torque, wake, DT)[0][:2]
    live = vc.solve & (vc.count > 0)
    apart = torch.zeros(live.shape[1], dtype=torch.bool)
    for e in range(live.shape[1]):
        idx = live[:, e].nonzero().flatten()
        apart[e] = bool((idx[1:] - idx[:-1] > 1).any()) if len(idx) > 1 else False
    return dict(per_env=live.sum(dim=0), apart=apart,
                unsolved_with_points=(man.count > 0) & ~vc.solve,
                degraded=(man.count == 2) & (vc.count == 1) & vc.solve)


def two_island_tick():
    """Heavy-v0 (block + 5 agents), 5 identical envs: agent 0 sits 0.3 m
    inside the block (an island that cannot converge in a few position
    sweeps); agents 1 and 2 touch within the polygon skin, 1 cm apart (an
    island that converges at once); agents 3 and 4 touch nothing.  Returns
    (layout, one tick's inputs (table, bodies, contacts, force, torque,
    wake)) under zero actions."""
    logic = torch_logic("MultiRobotPuzzleHeavy-v0")
    E = 5
    origin = torch.tensor([[0.0, 8.0], [21.33, 8.0], [10.67, 0.0], [10.67, 16.0],
                           [10.0, 8.0], [6.55, 9.0], [3.0, 3.0], [4.51, 3.0],
                           [15.0, 3.0], [18.0, 13.0]])
    state = logic.inject(origin[..., None].expand(10, 2, E).contiguous(), torch.zeros(10, E),
                         torch.tensor([320.0, 262.5, 0.0])[:, None].expand(3, E))
    act = torch.zeros(logic.cfg.act_dim, E)
    bodies, force, torque, wake = logic._control(state, act)
    return logic.layout, (logic.layout.table, bodies, state.contacts, force, torque, wake)


# --------------------------------------------------------------------------
# learner states
# --------------------------------------------------------------------------


def assert_trees_equal(a, b):
    """Two TrainStates (or metrics dicts) bitwise equal, generator states
    included; NaN equals NaN."""
    from gym_puzzles_tpu_torch.train import checkpoint as ckpt

    a, b = ckpt.to_tree(a), ckpt.to_tree(b)
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], dict):
            assert_trees_equal(a[k], b[k])
        elif isinstance(a[k], torch.Tensor):
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k].numpy(), b[k].numpy(), err_msg=k)
        else:
            assert a[k] == b[k], k


# --------------------------------------------------------------------------
# frames of the on-device renderer
# --------------------------------------------------------------------------


def on_edge(frame, where):
    """Per pixel of ``where`` [h, w]: whether a neighbour (8-connected) of
    ``frame`` [h, w, 3] has another colour."""
    h, w, _ = frame.shape
    pad = np.pad(frame, ((1, 1), (1, 1), (0, 0)), mode="edge")
    edge = np.zeros((h, w), bool)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            edge |= (pad[1 + dy:1 + dy + h, 1 + dx:1 + dx + w] != frame).any(axis=-1)
    return edge[where]


def assert_frames_match(got, want, edge_share=1e-3):
    """Frames [N, h, w, 3] equal but for at most ``edge_share`` of each
    frame's pixels, each on an edge of the ``want`` frame (float contraction
    moves an edge by a pixel); returns the differing pixel count."""
    assert got.shape == want.shape and got.dtype == want.dtype == np.uint8
    n_diff = 0
    for g, j in zip(got, want):
        diff = (g != j).any(axis=-1)
        n_diff += int(diff.sum())
        assert diff.mean() <= edge_share, f"{diff.mean():.5f} of a frame differs"
        assert on_edge(j, diff).all(), "a pixel off every edge differs"
    return n_diff


# --------------------------------------------------------------------------
# the committed policies: the JAX package's slim checkpoints as the port's
# policy files
# --------------------------------------------------------------------------

ROOT = Path(__file__).resolve().parent.parent
POLICY_DIR = ROOT / "gym_puzzles_tpu_torch" / "policies"


@dataclasses.dataclass(frozen=True)
class CommittedPolicy:
    """A JAX package checkpoint and the port's policy file written from it."""

    checkpoint: Path
    npz: Path
    env_id: str
    timesteps: int  # the env steps the JAX run trained it for


def _policy(run, env_id, name, timesteps):
    return CommittedPolicy(ROOT / "checkpoints" / run / env_id, POLICY_DIR / f"{name}.npz",
                           env_id, timesteps)


# name -> policy; the JAX package's records of each are docs/benchmarks/eval_<run>_*.json
POLICIES = {
    "v0_r4": _policy("v0_r4", "MultiRobotPuzzle-v0", "MultiRobotPuzzle-v0_r4", 179_830_784),
    "v2_r4": _policy("v2_r4", "MultiRobotPuzzle-v2", "MultiRobotPuzzle-v2_r4", 94_633_984),
    "v2_83_r5": _policy("v2_83_r5", "MultiRobotPuzzle-v2", "MultiRobotPuzzle-v2_83_r5",
                        94_633_984),
    "v3_r4": _policy("v3_r4", "MultiRobotPuzzle-v3", "MultiRobotPuzzle-v3_r4", 119_799_808),
    "hv2_r4": _policy("hv2_r4", "MultiRobotPuzzleHeavy-v2", "MultiRobotPuzzleHeavy-v2_r4",
                      94_633_984),
    "hv0_H2_r5": _policy("hv0_H2_r5", "MultiRobotPuzzleHeavy-v0",
                         "MultiRobotPuzzleHeavy-v0_H2_r5", 1_799_356_416),
    # the X4 checkpoint: the warm start of the H2 recipe (--resume_policy)
    "hv0_best_r4": _policy("hv0_best_r4", "MultiRobotPuzzleHeavy-v0",
                           "MultiRobotPuzzleHeavy-v0_best_r4", 1_499_463_680),
}
V0_POLICY_CHECKPOINT = POLICIES["v0_r4"].checkpoint
V0_POLICY_NPZ = POLICIES["v0_r4"].npz


@dataclasses.dataclass(frozen=True)
class TrainedPolicy:
    """A policy file the port's trainer wrote on the card by a JAX recipe
    (``train/export.py`` on its run's final checkpoint), and its run's
    records ``docs/benchmarks/torch_h100_<records>_*``."""

    npz: Path
    env_id: str
    timesteps: int  # the env steps of the run, every leg (and a warm start's)
    records: str
    legs: int
    first_leg: int = 1  # the first of its legs in its records (a later leg of a chain)


def _trained(env_id, records, timesteps, legs, first_leg=1, tag=""):
    name = f"{env_id}_{tag}_torch_h100.npz" if tag else f"{env_id}_torch_h100.npz"
    return TrainedPolicy(POLICY_DIR / name, env_id, timesteps, records, legs, first_leg)


# name -> the port's own policy (docs/benchmarks/torch_h100_ppo_recipes.sh, torch_h100_ppo_v0.sh)
TRAINED_POLICIES = {
    "torch_v0": _trained("MultiRobotPuzzle-v0", "v0g", 179_830_784, 2),
    "torch_v2": _trained("MultiRobotPuzzle-v2", "v2", 94_633_984, 2),
    "torch_hv2": _trained("MultiRobotPuzzleHeavy-v2", "hv2", 94_633_984, 2),
    "torch_v3": _trained("MultiRobotPuzzle-v3", "v3", 119_799_808, 1),
    # the H2 leg at seed 0, warm-started from the X4 policy: its steps include
    # the warm start's 1,499,463,680 (docs/benchmarks/torch_h100_ppo_recipes.sh hv0h3)
    "torch_hv0": _trained("MultiRobotPuzzleHeavy-v0", "hv0h2_s0", 1_799_356_416, 1),
    # X4, the fourth leg of Heavy-v0's curriculum trained from a fresh init,
    # no JAX weights on its path (docs/benchmarks/torch_h100_ppo_recipes.sh hv0c)
    "torch_hv0_x4": _trained("MultiRobotPuzzleHeavy-v0", "hv0c_x4", 1_499_463_680, 4,
                             first_leg=4, tag="x4"),
}


def npz_policy_tree(path) -> dict:
    """A policy file as the JAX package's policy tree: ``params`` (flax
    variables), ``normalizer`` moments and ``timesteps``."""
    tree: dict = {}
    with np.load(path) as f:
        for key in f.files:
            *parents, leaf = key.split("/")
            node = tree
            for part in parents:
                node = node.setdefault(part, {})
            node[leaf] = f[key]
    return dict(tree, params={"params": tree["params"]}, timesteps=int(tree["timesteps"]))


def export_jax_policy(checkpoint=V0_POLICY_CHECKPOINT, out=V0_POLICY_NPZ):
    """Write the policy of a JAX package checkpoint (full or slim) as the
    port's policy file, through the JAX package's own reader.  From the
    repo root, every committed file:

        JAX_PLATFORMS=cpu python -c "import sys; sys.path.insert(0, 'tests'); \\
            import torch_port_helpers as h; \\
            [h.export_jax_policy(p.checkpoint, p.npz) for p in h.POLICIES.values()]"
    """
    from gym_puzzles_tpu.train import checkpoint as jckpt
    from gym_puzzles_tpu.train.export import load_policy_subtree

    tree, _step = load_policy_subtree(checkpoint)
    convert.policy_to_npz(out, tree["params"], tree["normalizer"],
                          jckpt.step_count(tree["timesteps"]))
    return tree
