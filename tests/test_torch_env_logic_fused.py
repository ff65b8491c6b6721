"""The v0 env's per-step logic as two hand-written CUDA kernels
(``csrc/env_v0.cu``, wrapper ``envs/v0_cuda.py``) against its plain version:
``V0Env._control_plain``, ``PuzzleEnvLogic._finish`` and ``VectorEnv``'s fast
autoreset (``reset_fast`` for every env from the same generator state, then
``common.select`` by done).

On the CPU:

* (a) The kernel source built as host C++ (g++, no FMA contraction), run
  through the wrapper with its host entries, against the plain ops at 64 envs
  of v0 and Heavy-v0 (8/4 iterations) in four cases: fresh spawns, after a few
  random steps, a step where every env truncates, a step where only injected
  envs complete (a block placed in the goal through ``inject``).  Then the
  whole ``VectorEnv`` step with the host build in the kernels' place, fast
  autoreset against the plain path, and ``reset_mode='reference'`` keeping its
  own spawn and select.
* (b) Who takes the kernels, what the wrapper refuses, the constants the
  source and the wrapper share, the respawn counter.

Equality, in every case: exact for done, truncated, done_status, t, blks,
goal_contact, wall_contact, the wake mask, the velocity, omega and torque
rows, every field of a not-done env that the kernel leaves as ticked, and
every field of a respawned env but its positions and angles on the CPU; those
and the float outputs within ``TOL`` (the reasons beside each).  On the card
a respawned env's whole state is exact.

On the card (``cuda``-marked, skipped without one; there ``python -m pytest
--noconftest -q tests/test_torch_env_logic_fused.py``, the conftest importing
JAX): the four cases at v0's 4096 envs and Heavy-v0's 16384 at 180/60, 50
random steps for the second; ``RESPAWNS`` equal to the envs done; the
launches each graph replay holds: one of each kernel per v0 step (two with
the reference reset's step), 64 of each per v0 rollout graph.
"""

import ctypes
import dataclasses
import re
import shutil
import subprocess

import pytest
import torch

import gym_puzzles_tpu_torch as gpt
from gym_puzzles_tpu_torch.api import registry
from gym_puzzles_tpu_torch.api.image_obs import DeviceImageVectorEnv
from gym_puzzles_tpu_torch.engine import _cuda_build as cb
from gym_puzzles_tpu_torch.engine import world as eng
from gym_puzzles_tpu_torch.envs import common as cm
from gym_puzzles_tpu_torch.envs import config as C
from gym_puzzles_tpu_torch.envs import v0_cuda
from gym_puzzles_tpu_torch.envs.base import PuzzleEnvLogic
from gym_puzzles_tpu_torch.envs.layout import BLOCK_SLOT, FIRST_AGENT_SLOT
from gym_puzzles_tpu_torch.envs.v0 import V0Env
from gym_puzzles_tpu_torch.train.ppo import PPO, PPOConfig
from gym_puzzles_tpu_torch.utils import cuda_graph as cg
from gym_puzzles_tpu_torch.utils import profiling

torch.set_num_threads(1)

ITERS = dict(velocity_iters=8, position_iters=4)
ENV_IDS = {"v0": "MultiRobotPuzzle-v0", "heavy": "MultiRobotPuzzleHeavy-v0"}
CASES = ("fresh", "stepped", "truncate", "complete")
# Tolerances (absolute, but for force, relative to its largest magnitude):
TOL = dict(
    # the 1.1^-d magnitudes: the CPU's vectorized pow is an ulp off powf on
    # some elements, and ATen's CPU sum over the agents runs in another order
    force=1e-6,
    # px, values up to ~800 px where an ulp is 6.1e-5: the CPU's vectorized
    # sqrt, cos and sin are an ulp off on some elements
    obs=2e-4, agent_dist=2e-4, block_distance=2e-4,
    # up to ~1e4 (the completion's 10000), where an ulp is 1e-3; the sums over
    # the agents in another order on the CPU
    reward=2e-3,
    # a respawned env's positions (m) and angles (rad) on the CPU: the block's
    # centre of mass through cos and sin of its angle (on the card: exact)
    spawn=2e-6,
)


# --------------------------------------------------------------------------
# the cases
# --------------------------------------------------------------------------


def inject_complete(logic, state, every: int = 7):
    """``state`` with the block of every ``every``-th env placed in the goal
    (angle 0, its agents moved to the bottom edge), every other block 5 m to
    the goal's left, through ``inject``; the episode clock kept.  -> (state,
    the envs placed)."""
    E, A = state.t.shape[0], logic.cfg.num_agents
    dev = state.t.device
    origin, _q = eng.body_origins(logic.layout.table, state.bodies)
    origin, angle = origin.clone(), state.bodies.angle.clone()
    placed = torch.arange(E, device=dev) % every == 0
    gx, gy = (float(x) / C.V0_SCALE for x in logic.goal_px[:2])
    origin[BLOCK_SLOT, 0] = torch.where(placed, gx, gx - 5.0)
    origin[BLOCK_SLOT, 1] = gy
    angle[BLOCK_SLOT] = torch.where(placed, 0.0, angle[BLOCK_SLOT])
    for a in range(A):
        s = FIRST_AGENT_SLOT + a
        origin[s, 0] = torch.where(placed, 2.0 + 3.5 * a, origin[s, 0])
        origin[s, 1] = torch.where(placed, 2.0, origin[s, 1])
    return logic.inject(origin, angle, state.goal_pos).replace(t=state.t), placed


def make_case(which: str, case: str, E: int, device, steps: int, **make_kw):
    """(env, pre-step state, action [act_dim, E] as ``step_eager`` passes
    it, the envs a ``complete`` case placed or None)."""
    env = gpt.make(ENV_IDS[which], num_envs=E, device=device, **make_kw)
    state, _obs = env.reset(seed=5)
    gen = torch.Generator(device=device).manual_seed(11)
    act = lambda: torch.rand((E, env.cfg.act_dim), generator=gen, device=device) * 2 - 1  # noqa: E731
    placed = None
    if case == "stepped":
        for _ in range(steps):
            state = env.step(state, act())[0]
    elif case == "truncate":
        state = state.replace(t=torch.full_like(state.t, env.cfg.max_episode_steps - 1))
    elif case == "complete":
        state, placed = inject_complete(env.logic, state)
    return env, state, act().T, placed


def clone(tree):
    if isinstance(tree, tuple):
        return tuple(clone(x) for x in tree)
    if dataclasses.is_dataclass(tree):
        return type(tree)(**{f.name: clone(getattr(tree, f.name)) for f in dataclasses.fields(tree)})
    return tree.clone()


def leaves(tree) -> dict:
    """{dotted field name: tensor} of a tree of dataclasses."""
    out = {}
    for f in dataclasses.fields(tree):
        x = getattr(tree, f.name)
        if dataclasses.is_dataclass(x):
            out.update({f"{f.name}.{k}": v for k, v in leaves(x).items()})
        else:
            out[f.name] = x
    return out


def assert_close(name, got, want, atol):
    assert got.shape == want.shape and got.dtype == want.dtype, name
    diff = float((got.double() - want.double()).abs().max()) if got.numel() else 0.0
    assert diff <= atol, (name, diff, atol)
    return diff


def check_case(env, state, action, placed) -> dict:
    """The kernels against the plain ops from ``state`` with ``action``:
    control, then one physics step from the plain control's outputs, then
    ``score_respawn`` with the spawn's draws against ``_finish``,
    ``reset_fast`` and the select from the same generator state, with tracing
    on around the kernel.  -> the largest differences, the envs done."""
    logic, gen = env.logic, env.generator
    E = state.t.shape[0]
    # the stepped case reads the weights from 0-d device views, as a graph does
    params = env.default_params()
    if placed is None and bool((state.t > 0).any()):
        params = cg.as_device_scalars(params, state.t.device)
    exact_spawn = state.t.is_cuda
    errs = {}
    got_c = v0_cuda.control(logic, state, action)
    want_c = logic._control_plain(state, action)
    for name, g, w in (("vel", got_c[0].vel, want_c[0].vel), ("omega", got_c[0].omega,
                                                             want_c[0].omega),
                       ("torque", got_c[2], want_c[2]), ("wake", got_c[3], want_c[3])):
        assert g.dtype == w.dtype and torch.equal(g, w), name
    scale = max(float(want_c[1].abs().max()), 1e-30)
    errs["force"] = assert_close("force", got_c[1], want_c[1], TOL["force"] * scale) / scale
    for f in ("pos", "angle", "awake", "sleep_time"):
        assert getattr(got_c[0], f) is getattr(state.bodies, f)

    ticked = cm.physics_fused(logic.layout, logic.cfg, want_c[0], state.contacts, *want_c[1:],
                              state.goal_contact, state.wall_contact)
    g0 = gen.get_state()
    ps, pobs, prew, pdone, pinfo = PuzzleEnvLogic._finish(logic, state, *ticked, params)
    rs, robs = logic.reset_fast(gen, E, params)
    g1 = gen.get_state()
    want = cm.select(pdone, rs, ps)
    want_obs = torch.where(pdone, robs, pobs)
    gen.set_state(g0)
    draws = logic._spawn_draws(gen, E)
    assert torch.equal(gen.get_state(), g1)  # the same draws: the stream goes on alike
    n = len(profiling.RESPAWNS)
    with profiling.tracing():
        got, obs, rew, done, info = v0_cuda.score_respawn(logic, state, *clone(ticked), params,
                                                          draws)
    assert len(profiling.RESPAWNS) == n + 1
    record = profiling.RESPAWNS[-1]
    assert (record.respawned, record.scored) == (int(pdone.sum()), E)

    assert torch.equal(done, pdone)
    for k in ("done_status", "truncated", "t"):
        assert torch.equal(info[k], pinfo[k]), k
    errs["obs"] = assert_close("obs", obs, want_obs, TOL["obs"])
    errs["reward"] = assert_close("reward", rew, prew, TOL["reward"])
    gl, wl = leaves(got), leaves(want)
    assert list(gl) == list(wl)
    floats = {"agent_dist", "block_distance"}
    spawned = {"bodies.pos", "bodies.angle"}
    for name, g in gl.items():
        w = wl[name]
        keep, new = g[..., ~pdone], w[..., ~pdone]
        if name in floats:
            errs[name] = assert_close(name, g, w, TOL[name])
            continue
        assert g.dtype == w.dtype and torch.equal(keep, new), name
        if name in spawned and not exact_spawn:
            errs[f"spawn {name}"] = assert_close(name, g[..., pdone], w[..., pdone], TOL["spawn"])
        else:
            assert torch.equal(g[..., pdone], w[..., pdone]), name
    if placed is not None:  # the case is what it says: only the placed blocks complete
        assert bool(placed.any()) and torch.equal(info["done_status"] == 3, placed)
    errs["done"] = int(pdone.sum())
    return errs


# --------------------------------------------------------------------------
# (a) the kernel source as host C++ against the plain ops
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def host(tmp_path_factory):
    """``csrc/env_v0.cu`` built as host C++: (library, run) where ``run``,
    put in ``v0_cuda._launch``'s place, calls the host entries."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to build the kernel source as host C++")
    out = tmp_path_factory.mktemp("env_v0_host") / "env_v0_host.so"
    subprocess.run([gxx, "-x", "c++", "-O2", "-shared", "-fPIC", "-ffp-contract=off",
                    "-o", str(out), str(cb.CSRC / "env_v0.cu")],
                   check=True, capture_output=True, timeout=120)
    lib = ctypes.CDLL(str(out))
    for entry in ("gpt_v0_control", "gpt_v0_score_respawn"):
        fn = getattr(lib, f"{entry}_host")
        fn.argtypes, fn.restype = v0_cuda.FUNCTIONS[entry][0][:-1], ctypes.c_int
    lib.gpt_v0_constants.argtypes = [ctypes.POINTER(ctypes.c_int)]
    lib.gpt_v0_constants.restype = ctypes.c_int
    calls = []

    def run(kernel, entry, dev, *args):
        assert dev.type == "cpu"
        calls.append(kernel.name)
        assert getattr(lib, f"{entry}_host")(*args) == 0

    run.calls = calls
    return lib, run


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("which", ["v0", "heavy"])
def test_host_kernels_against_plain(host, monkeypatch, which, case):
    env, state, action, placed = make_case(which, case, 64, "cpu", steps=3, **ITERS)
    monkeypatch.setattr(v0_cuda, "_launch", host[1])
    errs = check_case(env, state, action, placed)
    if case == "truncate":
        assert errs["done"] == 64
    if case in ("fresh", "stepped"):
        assert errs["done"] < 64


def host_vector_env(monkeypatch, run):
    """Put the host build in the kernels' place for CPU states: V0Env takes
    them on the CPU, the wrapper launches the host entries."""
    monkeypatch.setattr(V0Env, "fused_logic", lambda self, device: True)
    monkeypatch.setattr(v0_cuda, "_launch", run)


# the whole step through the host build against the plain step: the host
# build's force is an ulp off the CPU's vectorized pow on some envs, and the
# tick carries that on, so the steps are held loosely but for what only the
# generator's stream decides
LOOSE = dict(obs=1e-2, reward=1e-2, pos=1e-4)


@pytest.mark.parametrize("which", ["v0", "heavy"])
def test_vector_env_fast_autoreset_through_the_host_build(host, monkeypatch, which):
    """Three steps to the 3-step limit: the fused respawn of every env at the
    last against the plain spawn-and-select, from the same generator stream."""
    E = 16
    kw = dict(num_envs=E, device="cpu", max_episode_steps=3, **ITERS)
    plain = gpt.make(ENV_IDS[which], **kw)
    gen = torch.Generator().manual_seed(3)
    acts = [torch.rand((E, plain.cfg.act_dim), generator=gen) * 2 - 1 for _ in range(3)]
    state, _ = plain.reset(seed=2)
    want = []
    for a in acts:
        want.append(plain.step(state, a))
        state = want[-1][0]
    lib, run = host
    host_vector_env(monkeypatch, run)
    fused = gpt.make(ENV_IDS[which], **kw)
    assert fused.fused_respawn
    state, _ = fused.reset(seed=2)
    del run.calls[:]
    for k, (a, w) in enumerate(zip(acts, want)):
        got = fused.step(state, a)
        state = got[0]
        (gs, gobs, grew, gdone, ginfo), (ws, wobs, wrew, wdone, winfo) = got, w
        assert torch.equal(gdone, wdone) and bool(gdone.all()) == (k == 2)
        assert_close("obs", gobs, wobs, LOOSE["obs"])
        assert_close("reward", grew, wrew, LOOSE["reward"])
        for key in winfo:
            assert torch.equal(ginfo[key], winfo[key]), key
        for name in ("t", "done_status", "blks_in_place", "goal_pos"):
            assert torch.equal(getattr(gs, name), getattr(ws, name)), (k, name)
        assert_close("pos", gs.bodies.pos, ws.bodies.pos, LOOSE["pos"])
    # the respawn: every field the spawn's, which only the stream decides
    for name, g in leaves(gs).items():
        w = leaves(ws)[name]
        if name in ("agent_dist", "block_distance"):
            assert_close(name, g, w, TOL[name])
        elif name in ("bodies.pos", "bodies.angle"):
            assert_close(name, g, w, TOL["spawn"])
        else:
            assert g.dtype == w.dtype and torch.equal(g, w), name
    assert_close("obs", gobs, wobs, TOL["obs"])
    assert run.calls == ["v0_control", "v0_score_respawn"] * 3


def test_reference_mode_keeps_its_spawn_and_select(host, monkeypatch):
    """With ``reset_mode='reference'`` the step takes both kernels with no
    respawn, and the reference reset's random step takes them too; the spawn
    and the select stay ``VectorEnv``'s own."""
    E = 8
    kw = dict(num_envs=E, device="cpu", max_episode_steps=2, reset_mode="reference", **ITERS)
    plain = gpt.make("MultiRobotPuzzle-v0", **kw)
    a = torch.full((E, 6), 0.3)
    state, _ = plain.reset(seed=4)
    want = [plain.step(state, a)]
    want.append(plain.step(want[0][0], a))
    lib, run = host
    host_vector_env(monkeypatch, run)
    env = gpt.make("MultiRobotPuzzle-v0", **kw)
    assert not env.fused_respawn
    batches = []
    real = env._reset_batch
    env._reset_batch = lambda params: batches.append(1) or real(params)
    state, _ = env.reset(seed=4)
    del run.calls[:], batches[:]
    got = [env.step(state, a)]
    got.append(env.step(got[0][0], a))
    assert len(batches) == 2  # the spawn and select path ran at each step
    # each step: its own control and score, then the reference reset's step
    assert run.calls == ["v0_control", "v0_score_respawn"] * 4
    assert bool(got[1][3].all()) and torch.equal(got[1][3], want[1][3])
    for g, w in zip(got, want):
        assert_close("obs", g[1], w[1], LOOSE["obs"])
        assert_close("reward", g[2], w[2], LOOSE["reward"])
        assert torch.equal(g[0].t, w[0].t) and torch.equal(g[0].done_status, w[0].done_status)


# --------------------------------------------------------------------------
# (b) who takes the kernels, refusals, shared constants, the counter
# --------------------------------------------------------------------------


def _refuse(*_args, **_kw):
    raise AssertionError("the v0 env kernels' wrapper was called")


def test_cpu_takes_the_plain_ops(monkeypatch):
    monkeypatch.setattr(v0_cuda, "control", _refuse)
    monkeypatch.setattr(v0_cuda, "score_respawn", _refuse)
    for env_id in ENV_IDS.values():
        env = gpt.make(env_id, num_envs=3, device="cpu", max_episode_steps=1, **ITERS)
        assert env.logic.fused_logic(torch.device("cuda"))
        assert not env.logic.fused_logic(torch.device("cpu")) and not env.fused_respawn
        state, _ = env.reset(seed=0)
        out = env.step(state, torch.zeros((3, env.cfg.act_dim)))
        assert bool(out[3].all())  # the plain autoreset ran


def test_v2_v3_never_call_the_wrapper(monkeypatch):
    monkeypatch.setattr(v0_cuda, "control", _refuse)
    monkeypatch.setattr(v0_cuda, "score_respawn", _refuse)
    for env_id in ("MultiRobotPuzzle-v2", "MultiRobotPuzzleHeavy-v2", "MultiRobotPuzzle-v3"):
        env = gpt.make(env_id, num_envs=2, device="cpu", max_episode_steps=1, **ITERS)
        assert not env.logic.fused_logic(torch.device("cuda"))
        assert v0_cuda.refusal(env.logic) is not None
        state, _ = env.reset(seed=0)
        env.step(state, torch.zeros((2, env.cfg.act_dim)))
        with pytest.raises(ValueError, match="no fused respawn"):
            env.logic.step_fused(state, torch.zeros((env.cfg.act_dim, 2)),
                                 env.default_params(), respawn=env.generator)


def test_wrapper_refuses_what_the_kernels_do_not_take(host, monkeypatch):
    _lib, run = host
    del run.calls[:]
    env = gpt.make("MultiRobotPuzzle-v0", num_envs=4, device="cpu", **ITERS)
    state, _ = env.reset(seed=0)
    act = torch.zeros((6, 4))
    with pytest.raises(ValueError, match="CUDA"):
        v0_cuda.control(env.logic, state, act)
    monkeypatch.setattr(v0_cuda, "_launch", run)
    three = V0Env(dataclasses.replace(env.cfg, num_agents=3, obs_dim=32, act_dim=9))
    with pytest.raises(ValueError, match="3 agents and 8 bodies"):
        v0_cuda.layout(three)
    with pytest.raises(ValueError, match="v0's env logic"):
        v0_cuda.layout(registry._logic("MultiRobotPuzzle-v2"))
    strided = state.replace(agent_dist=state.agent_dist.T.contiguous().T)
    with pytest.raises(ValueError, match="agent_dist.*not contiguous"):
        v0_cuda.control(env.logic, strided, act)
    with pytest.raises(ValueError, match="action"):
        v0_cuda.control(env.logic, state, torch.zeros((6, 4), dtype=torch.float64))
    wide = state.replace(t=state.t.to(torch.int64))
    ticked = (state.bodies, state.contacts, state.goal_contact, state.wall_contact)
    with pytest.raises(ValueError, match="prev_t"):
        v0_cuda.score_respawn(env.logic, wide, *ticked, env.default_params())
    assert run.calls == []  # nothing was launched


def test_source_and_wrapper_share_their_constants(host):
    lib, _run = host
    src = (cb.CSRC / "env_v0.cu").read_text()
    define = lambda name: int(re.search(rf"#define {name} (\d+)", src).group(1))  # noqa: E731
    assert define("GPT_V0_THREADS") == v0_cuda.THREADS
    assert define("GPT_V0_MAX_BODIES") == v0_cuda.MAX_BODIES
    assert define("GPT_V0_MAX_VERTS") == v0_cuda.MAX_VERTS
    worlds = re.search(r"#define GPT_V0_WORLDS\(X\) (.*)", src).group(1)
    assert tuple((int(a), int(b)) for a, b in re.findall(r"X\((\d+), (\d+)\)", worlds)) == \
        v0_cuda.WORLDS
    for enum, prefix, names in (("ControlPtr", "C_", v0_cuda.CONTROL_PTRS),
                                ("ScorePtr", "S_", v0_cuda.SCORE_PTRS)):
        body = re.sub(r"//[^\n]*", "", re.search(rf"enum {enum} \{{(.*?)\}};", src, re.S).group(1))
        got = [n.strip() for n in body.split(",") if n.strip()]
        assert got[-1] == f"{prefix}NPTRS"
        assert [n[len(prefix):].lower() for n in got[:-1]] == list(names)
    struct = re.sub(r"//[^\n]*", "", re.search(r"struct Layout \{(.*?)\};", src, re.S).group(1))
    fields = []
    for decl in struct.split(";"):
        words = decl.split(None, 1)
        if len(words) == 2:
            fields += [re.match(r"\s*(\w+)", d).group(1) for d in words[1].split(",")]
    assert fields == [f for f, _t in v0_cuda.Layout._fields_]
    out = (ctypes.c_int * 16)()
    n = lib.gpt_v0_constants(out)
    threads, bodies, verts, layout_bytes, weight_bytes, c_ptrs, s_ptrs, n_worlds = out[:8]
    assert (threads, bodies, verts) == (v0_cuda.THREADS, v0_cuda.MAX_BODIES, v0_cuda.MAX_VERTS)
    assert layout_bytes == ctypes.sizeof(v0_cuda.Layout)
    assert weight_bytes == 4 * len(v0_cuda.WEIGHTS)
    assert (c_ptrs, s_ptrs) == (len(v0_cuda.CONTROL_PTRS), len(v0_cuda.SCORE_PTRS))
    assert tuple(zip(out[8:n:2], out[9:n:2])) == v0_cuda.WORLDS and n_worlds == len(v0_cuda.WORLDS)
    assert set(v0_cuda.WEIGHTS) <= {f.name for f in dataclasses.fields(C.RewardParams)}
    for env_id in ENV_IDS.values():  # the registry's v0 worlds are the instantiated ones
        logic = registry._logic(env_id)
        assert v0_cuda.refusal(logic) is None
        assert (logic.cfg.num_agents, logic.layout.table.num_bodies) in v0_cuda.WORLDS
    assert cb.KERNELS["v0_control"] is v0_cuda.CONTROL
    assert cb.KERNELS["v0_score_respawn"] is v0_cuda.SCORE
    assert v0_cuda.CONTROL.library == v0_cuda.SCORE.library == "env_v0"


def test_spawn_affine_maps_are_the_plain_spawns(host):
    """The kernel's lo + range * u reproduces ``_spawn_from``'s block x, y,
    angle and agent origins bit for bit (the CPU's trig does not enter)."""
    logic = registry._logic("MultiRobotPuzzleHeavy-v0")
    gen = torch.Generator().manual_seed(9)
    draws = logic._spawn_draws(gen, 257)
    bodies, _goal = logic._spawn_from(draws)
    lo, rng = v0_cuda.spawn_affine(logic)
    f = lambda i, u: torch.tensor(lo[i]) + torch.tensor(rng[i]) * u  # noqa: E731
    assert torch.equal(bodies.angle[BLOCK_SLOT], f(2, draws[2]))
    origin, _q = eng.body_origins(logic.layout.table, bodies)
    a0 = FIRST_AGENT_SLOT
    # the agents spawn at angle 0: their centres are their origins moved by
    # the local centre, exactly
    lc = torch.tensor(logic.layout.table.local_center[a0:])
    lcx, lcy = lc[:, :1], lc[:, 1:]
    assert torch.equal(bodies.pos[a0:, 0], f(3, draws[3][:, 0]) + (1.0 * lcx - 0.0 * lcy))
    assert torch.equal(bodies.pos[a0:, 1], f(4, draws[3][:, 1]) + (0.0 * lcx + 1.0 * lcy))
    assert torch.allclose(origin[BLOCK_SLOT, 0], f(0, draws[0]), atol=1e-5)
    assert torch.allclose(origin[BLOCK_SLOT, 1], f(1, draws[1]), atol=1e-5)


def test_respawn_counter_only_with_tracing():
    assert profiling.respawn_counts("cpu") is None
    n = len(profiling.RESPAWNS)
    with profiling.tracing():
        profiling.respawn_counts("cpu").add_(torch.tensor([2, 7]))
    assert profiling.RESPAWNS[n:] == [profiling.RespawnRecord("cpu", 2, 7)]
    with profiling.tracing():  # zeroed when a block opens; nothing scored, no record
        assert int(profiling.respawn_counts("cpu").abs().sum()) == 0
    assert len(profiling.RESPAWNS) == n + 1


# --------------------------------------------------------------------------
# on the card
# --------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; on the card chip_smoke.py phase 6 checks the kernels")
    return torch.device("cuda")


CARD_ENVS = {"v0": 4096, "heavy": 16384}


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("which", ["v0", "heavy"])
def test_kernels_equal_plain_on_card(cuda_device, which, case):
    env, state, action, placed = make_case(which, case, CARD_ENVS[which], cuda_device, steps=50)
    before = (cb.launch_count("v0_control"), cb.launch_count("v0_score_respawn"))
    errs = check_case(env, state, action, placed)
    torch.cuda.synchronize()
    assert (cb.launch_count("v0_control"), cb.launch_count("v0_score_respawn")) == \
        (before[0] + 1, before[1] + 1)
    print(f"{which} {case}: {errs}")


@pytest.mark.cuda
def test_launches_per_replay_on_card(cuda_device):
    want = {"step_fused": 1, "v0_control": 1, "v0_score_respawn": 1}
    for kw, held in ((dict(), want), (dict(reset_mode="reference"),
                                      {k: 2 * v for k, v in want.items()})):
        env = gpt.make("MultiRobotPuzzle-v0", num_envs=4096, device=cuda_device, **kw)
        state, _ = env.reset(seed=0)
        a = torch.zeros((4096, 6), device=cuda_device)
        env.step(env.step(state, a)[0], a)
        assert env._graph.launches == held, kw
    img = DeviceImageVectorEnv(num_envs=256, downsample=16, device=cuda_device, **ITERS)
    ist, _ = img.reset(seed=0)
    img.step(ist, torch.zeros((256, 6), device=cuda_device))
    assert img._graph.launches == {"step_fused": 4, "v0_control": 1, "v0_score_respawn": 1}
    algo = PPO(PPOConfig(n_envs=4096, n_steps=64, batch_size=8192, n_epochs=1),
               device=cuda_device)
    ts = algo.init_state()
    algo.rollout(ts)
    assert algo.graph_launches["rollout"] == {"step_fused": 64, "v0_control": 64,
                                              "v0_score_respawn": 64}
    nodes = [c for c in profiling.CAPTURES if not c.traced]
    print("kernel nodes (name, kernel nodes, nodes):",
          [(c.name, c.kernel_nodes, c.nodes) for c in nodes])


@pytest.mark.cuda
def test_replay_equals_eager_with_respawns_on_card(cuda_device, monkeypatch):
    """A v0 graph replay against its eager body across the episode limit (3
    steps) and with tracing on: every output bit for bit, the counter's
    respawns those of the step at the limit."""
    # the stamp ring and the counter this test makes are its own: a later
    # tracing block of the process on the CPU then finds no CUDA ring to zero
    # under its profiler
    monkeypatch.setattr(profiling, "_RINGS", {})
    monkeypatch.setattr(profiling, "_RESPAWN_COUNTS", {})
    kw = dict(num_envs=4096, device=cuda_device, max_episode_steps=3)
    graphed, eager = gpt.make("MultiRobotPuzzle-v0", **kw), gpt.make("MultiRobotPuzzle-v0", **kw)
    gs, _ = graphed.reset(seed=1)
    es, _ = eager.reset(seed=1)
    gen = torch.Generator(device=cuda_device).manual_seed(2)
    n = len(profiling.RESPAWNS)
    with profiling.tracing():
        for k in range(5):
            a = torch.rand((4096, 6), generator=gen, device=cuda_device) * 2 - 1
            g, e = graphed.step(gs, a), eager.step_eager(es, a)
            for x, y in zip(cg.flatten(g)[0], cg.flatten(e)[0]):
                assert torch.equal(x, y), k
            gs, es = g[0], e[0]
    record = profiling.RESPAWNS[n]
    # the capture's eager warm-up, five replays and five eager steps: 11 steps
    # scored, of which the limit's (the third) respawned every env on each side
    assert record.scored == 11 * 4096 and record.respawned >= 2 * 4096
