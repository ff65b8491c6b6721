"""The staged contact-solve kernel: its wrapper and arithmetic on the CPU, and
the kernel itself on the card (marked ``cuda``; skipped without one).

* The port's ``solver_cuda.solve_contacts`` on CPU tensors (its plain
  version) against the JAX package's ``solver_pallas.solve_contacts`` run in
  the Pallas interpreter, on the very constraints the JAX ``step_batched``
  hands its kernel in an injected-contact drive of the 3-body push world
  (carried across with ``convert``): positions and angles within 1e-5
  (measured 4.8e-7), each pair's impulse and the velocities within 1e-4
  (measured 1.0e-5: XLA contracts ``a*b+c`` into FMA on the CPU, eager
  PyTorch does not), ``position_solved`` equal.  How a pair's impulse splits
  between the two points of a nearly singular block is ill-conditioned:
  per point the limit is 1e-3 (measured 1.2e-4 after 180 sweeps).  At 8/4
  and at 180/60.
* The kernel source compiled as host C++ (g++, no FMA contraction) against
  the plain version on constraints from v0, Heavy-v0 and v2 spawns, in both
  trig modes, with a ragged env count; two islands of which one converges
  early; a 2-point manifold whose block solve is degraded to 1 point;
  ``pos_iters=0``.
* the live-pair lists its sweeps walk: envs with 0, 1 and several live
  pairs, some apart in the table, a sleeping island whose pairs keep
  manifold points, in both instantiations (v0, v2), and a solved pair whose
  velocity count is 0 (the velocity and position lists differ);
* pack then unpack of the kernel's planes is the identity.
"""

import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gym_puzzles_tpu.engine import solver_pallas
from gym_puzzles_tpu.engine import world as jw
from gym_puzzles_tpu_torch import convert
from gym_puzzles_tpu_torch.api.registry import _logic
from gym_puzzles_tpu_torch.engine import _cuda_build as cb
from gym_puzzles_tpu_torch.engine import solver as slv
from gym_puzzles_tpu_torch.engine import solver_cuda
from gym_puzzles_tpu_torch.engine import world
from tests.torch_port_helpers import (live_pair_batch, live_pair_cases, np_tree, small_tables,
                                      two_island_tick)

solver_pallas.INTERPRET = True  # CPU: the Pallas kernel runs interpreted
torch.set_num_threads(1)

DT = 1.0 / 50.0
OUT = ("vel", "omega", "pos", "angle", "normal_impulse", "tangent_impulse", "position_solved")


# --------------------------------------------------------------------------
# against the JAX kernel
# --------------------------------------------------------------------------


def jax_last_solve_call(speed, vi, pi, ticks, E=128):
    """Drive the JAX staged tick on the 3-body push world (a T-block and two
    octagon agents pushing it: 5 pairs, so the interpreted kernel compiles in
    seconds) and return what its kernel got and gave in the last tick:
    (args, outputs) as numpy.  Agent 1 is turned by a different angle and
    both push at a different speed in every env, so the batch holds 1-point
    and 2-point manifolds and no env is a copy of another."""
    jt, _tt = small_tables()
    origin = np.broadcast_to(
        np.array([(5.0, 5.0), (2.76, 5.5), (5.0, 3.26)], np.float32)[..., None], (3, 2, E))
    angle = np.zeros((3, E), np.float32)
    angle[1] = np.linspace(0.0, 0.7, E)
    bodies = jax.vmap(lambda o, a: jw.init_bodies(jt, o, a), in_axes=-1, out_axes=-1)(
        jnp.asarray(origin), jnp.asarray(angle))
    contacts = jax.tree_util.tree_map(
        lambda x: jnp.broadcast_to(x[..., None], x.shape + (E,)), jw.init_contacts(jt))
    s = speed * np.linspace(0.5, 1.0, E, dtype=np.float32)
    z = np.zeros(E, np.float32)
    agent_vel = jnp.asarray(np.stack([np.stack([s, z]), np.stack([z, s])]))  # [2, 2, E]
    wake = jnp.broadcast_to(jnp.asarray([False, True, True])[:, None], (3, E))
    calls = []
    real = solver_pallas.solve_contacts

    def recording(table, vc, man, pos, angle, vel, omega, active, link, dt, v, p):
        out = real(table, vc, man, pos, angle, vel, omega, active, link, dt, v, p)
        calls.append(((vc, man, pos, angle, vel, omega, active, link), out))
        return out

    @jax.jit
    def tick(bodies, contacts):
        bodies = bodies.replace(
            vel=jnp.concatenate([bodies.vel[:1], agent_vel]),
            omega=jnp.concatenate([bodies.omega[:1], jnp.zeros((2, E))]))
        bodies, contacts, _info = jw.step_batched(
            jt, bodies, contacts, jnp.zeros((3, 2, E)), jnp.zeros((3, E)), wake, DT, vi, pi)
        # under jit the recorded values are tracers of this trace: hand
        # them out as results
        return bodies, contacts, calls[-1]

    solver_pallas.solve_contacts = recording
    try:
        for _ in range(ticks):
            bodies, contacts, (args, out) = tick(bodies, contacts)
    finally:
        solver_pallas.solve_contacts = real
    vc, man = np_tree(args[0]), np_tree(args[1])
    return (vc, man) + tuple(np.array(x) for x in args[2:]), tuple(np.array(x) for x in out)


@pytest.mark.parametrize("speed, vi, pi, ticks", [
    (4 / 3.0, 8, 4, 8),
    (4 / 3.0, 180, 60, 3),  # the reference's iteration counts
])
def test_solve_contacts_matches_jax_kernel(speed, vi, pi, ticks):
    (vc, man, pos, angle, vel, omega, active, link), want = jax_last_solve_call(
        speed, vi, pi, ticks)
    table = small_tables()[1]
    solved = np.where(vc["solve"], vc["count"], 0)
    assert link.shape[-1] == 128 and (solved == 1).any() and (solved == 2).any()
    assert (vc["normal_impulse"] != 0).any(), "the last call should warm start"
    t = torch.as_tensor
    got = solver_cuda.solve_contacts(
        table, convert.constraints_from_numpy(vc), convert.manifold_from_numpy(man),
        t(pos), t(angle), t(vel), t(omega), t(active), t(link), DT, vi, pi)
    for name, g, w in zip(OUT, got, want):
        if name == "position_solved":
            np.testing.assert_array_equal(g.numpy(), w)
        else:
            atol = 1e-5 if name in ("pos", "angle") else 1e-4
            if "impulse" in name:  # per pair; the split between its two points to 1e-3
                np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-3, err_msg=name)
                g, w = g.sum(dim=1), w.sum(axis=1)
            np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=atol, err_msg=name)


# --------------------------------------------------------------------------
# the kernel body as host C++ against the plain version
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def host_kernel(tmp_path_factory):
    """csrc/solve_contacts.cu built as host C++ with g++."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to build the kernel source as host C++")
    out = tmp_path_factory.mktemp("host_solve") / "solve_contacts_host.so"
    subprocess.run([gxx, "-x", "c++", "-O2", "-shared", "-fPIC", "-ffp-contract=off",
                    "-o", str(out), str(cb.CSRC / "solve_contacts.cu")],
                   check=True, capture_output=True, timeout=120)
    lib = ctypes.CDLL(str(out))
    vp = ctypes.c_void_p
    lib.gpt_solve_contacts_host.argtypes = [vp] * 9 + [ctypes.c_int, ctypes.c_float,
                                                       ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                                       ctypes.c_int]
    lib.gpt_solve_contacts_host.restype = ctypes.c_int
    cb.check_library(lib)
    return lib


def host_solve(lib, incremental, table, vc, man, pos, angle, vel, omega, active, link,
               dt, vi, pi, size_class=None):
    """One solve of the host build, in the instantiation the wrapper would
    pick unless ``size_class`` names one."""
    planes = solver_cuda.pack(vc, man, pos, angle, vel, omega, active, link)
    body, imp = planes[3], planes[4]
    body_o, imp_o = torch.full_like(body, float("nan")), torch.full_like(imp, float("nan"))
    done_o = torch.full((table.num_bodies, body.shape[-1]), float("nan"))
    w = cb.world_struct(table)
    cls = cb.size_class(table) if size_class is None else size_class
    err = lib.gpt_solve_contacts_host(ctypes.byref(w), *(x.data_ptr() for x in planes),
                                      body_o.data_ptr(), imp_o.data_ptr(), done_o.data_ptr(),
                                      body.shape[-1], dt, vi, pi, int(incremental), cls)
    assert err == 0, "the world does not fit the size class"
    assert not torch.isnan(done_o).any()
    return solver_cuda.unpack(table, body_o, imp_o, done_o)


def solve_inputs(table, bodies, contacts, force, torque, wake, vi, pi):
    """What ``world.step_batched`` hands its solve on this state: the
    arguments of ``solve_contacts`` after the PyTorch prologue."""
    solve_args, _carry = world.before_solve(table, bodies, contacts, force, torque, wake, DT)
    return (table,) + solve_args + (DT, vi, pi)


def spawn_inputs(env_id, E, seed, vi, pi, warm_ticks=1, **kw):
    """Solve inputs of E fresh spawns under random controls, after
    ``warm_ticks`` plain ticks (so there are impulses to warm start)."""
    logic = _logic(env_id, **kw)
    gen = torch.Generator().manual_seed(seed)
    state, _ = logic.reset_fast(gen, E, logic.default_params())
    act = torch.rand((logic.cfg.act_dim, E), generator=gen) * 2 - 1
    table = logic.layout.table
    bodies, contacts = state.bodies, state.contacts
    for _ in range(warm_ticks):
        b, force, torque, wake = logic._control(state.replace(bodies=bodies), act)
        bodies, contacts, _ = world.step(table, b, contacts, force, torque, wake, DT, vi, pi)
    b, force, torque, wake = logic._control(state.replace(bodies=bodies), act)
    return solve_inputs(table, b, contacts, force, torque, wake, vi, pi)


def assert_same(got, want, atol):
    for name, g, w in zip(OUT, got, want):
        if name == "position_solved":
            assert torch.equal(g, w), name
        else:
            torch.testing.assert_close(g, w, rtol=0, atol=atol, msg=lambda m, n=name: f"{n}: {m}")


@pytest.mark.parametrize("env_id, E", [
    ("MultiRobotPuzzle-v0", 37),       # 37: a ragged count, not a multiple of 32
    ("MultiRobotPuzzleHeavy-v0", 24),
    ("MultiRobotPuzzle-v2", 24),
])
def test_host_kernel_spawns(host_kernel, env_id, E):
    args = spawn_inputs(env_id, E, 3, 12, 6)
    vc = args[1]
    assert (vc.count > 0).any() and (vc.normal_impulse != 0).any()
    want = solver_cuda.solve_contacts_plain(*args)
    exact = host_solve(host_kernel, False, *args)
    assert_same(exact, want, 1e-5)
    # incremental against exact trig: within 10x of what the JAX package
    # records for its kernel (4.8e-7 m, 3.3e-6 rad; positions here reach
    # 21 m, where one float32 step is 1.9e-6)
    incr = host_solve(host_kernel, True, *args)
    torch.testing.assert_close(incr[2], exact[2], rtol=0, atol=4.8e-6)
    torch.testing.assert_close(incr[3], exact[3], rtol=0, atol=3.3e-6)
    assert torch.equal(incr[6], exact[6])
    # the velocity phase does not see the trig mode
    assert torch.equal(incr[4], exact[4]) and torch.equal(incr[0], exact[0])


def two_island_inputs(vi, pi):
    """The solve inputs of ``two_island_tick``'s Heavy-v0 scene (two islands,
    one deep, one that converges at once, and two free agents)."""
    layout, tick = two_island_tick()
    return layout, solve_inputs(*tick, vi, pi)


def test_host_kernel_two_islands_one_converges(host_kernel):
    layout, args = two_island_inputs(8, 2)
    link = args[8]
    blk, a0 = layout.block_slot, int(layout.agent_slots[0])
    assert link.any(dim=0).all(), "agents 1 and 2 should be linked"
    want = solver_cuda.solve_contacts_plain(*args)
    solved = want[6]
    # the deep island (block, agent 0) is not done; the shallow one and the
    # free bodies are; static bodies never are
    assert not solved[blk].any() and not solved[a0].any()
    assert solved[a0 + 1].all() and solved[a0 + 2].all() and solved[a0 + 3:].all()
    assert not solved[:blk].any()
    for incremental in (False, True):
        got = host_solve(host_kernel, incremental, *args)
        assert_same(got, want, 1e-5)
    # the labels the kernel derives from ``link`` are compute_islands' labels
    assert torch.equal(slv.compute_islands(args[0], link),
                       slv.compute_islands(args[0], args[1].count > 0))


def test_host_kernel_degraded_block_solve(host_kernel):
    """A 2-point manifold solved as 1 point (the conditioning degrade): the
    velocity phase uses the degraded count, the position phase the
    manifold's."""
    args = list(spawn_inputs("MultiRobotPuzzle-v0", 24, 5, 12, 6))
    vc, man = args[1], args[2]
    two = (man.count == 2) & vc.solve
    assert two.any(), "needs a solved 2-point manifold"
    args[1] = vc.replace(count=torch.where(two, 1, vc.count).to(torch.int32))
    want = solver_cuda.solve_contacts_plain(*args)
    got = host_solve(host_kernel, False, *args)
    assert_same(got, want, 1e-5)
    # the case is live: degrading changes the solve, and the second point's
    # impulse stays what came in
    full = host_solve(host_kernel, False, args[0], vc, *args[2:])
    assert not torch.equal(full[4], got[4])
    assert torch.equal(got[4][:, 1][two], vc.normal_impulse[:, 1][two])


@pytest.mark.parametrize("env_id, seed, size_class", [
    ("MultiRobotPuzzle-v0", 2, 0), ("MultiRobotPuzzle-v2", 0, 1)])
def test_host_kernel_live_pair_lists(host_kernel, env_id, seed, size_class):
    """The sweeps walk each env's live rows only: envs with 0, 1 and several
    live pairs (some apart in the table) and a sleeping island whose pairs
    keep manifold points, against the plain version; then a solved pair
    with a velocity count of 0 in every env that has two live pairs, so the
    velocity list skips what the position list visits.  v0 also runs in the
    larger instantiation, bitwise equal."""
    tick = live_pair_batch(env_id, 16, seed)
    cases = live_pair_cases(*tick)
    n = cases["per_env"]
    assert (n == 0).any() and (n == 1).any() and (n >= 2).any() and cases["apart"].any()
    assert cases["unsolved_with_points"].any()
    args = list(solve_inputs(*tick, 12, 6))
    assert cb.size_class(args[0]) == size_class
    want = solver_cuda.solve_contacts_plain(*args)
    got = host_solve(host_kernel, False, *args)
    assert_same(got, want, 1e-5)
    if size_class == 0:
        for g, w in zip(host_solve(host_kernel, False, *args, size_class=1), got):
            assert torch.equal(g, w)

    vc = args[1]
    live = vc.solve & (vc.count > 0)
    first = live & (live.cumsum(dim=0) == 1) & (live.sum(dim=0) >= 2)
    assert first.any()
    args[1] = vc.replace(count=torch.where(first, 0, vc.count).to(torch.int32))
    want = solver_cuda.solve_contacts_plain(*args)
    got = host_solve(host_kernel, True, *args)
    assert_same(got, want, 1e-5)
    # the zeroed pairs kept their impulses, and their positions were solved
    assert torch.equal(got[4][first[:, None].expand_as(got[4])],
                       vc.normal_impulse[first[:, None].expand_as(got[4])])


def test_host_kernel_no_position_iterations(host_kernel):
    args = spawn_inputs("MultiRobotPuzzle-v0", 8, 6, 6, 0)
    want = solver_cuda.solve_contacts_plain(*args)
    got = host_solve(host_kernel, True, *args)
    assert_same(got, want, 1e-6)
    assert not got[6].any() and not want[6].any()


def test_pack_unpack_identity():
    args = spawn_inputs("MultiRobotPuzzle-v2", 6, 7, 4, 2)
    table, vc, man, pos, angle, vel, omega, active, link = args[:9]
    pair_a, pair_b, act, body, imp = solver_cuda.pack(vc, man, pos, angle, vel, omega,
                                                      active, link)
    B, P = table.num_bodies, table.num_pairs
    assert pair_a.shape == (17 * P, 6) and pair_b.shape == (18 * P, 6)
    assert act.shape == (B, 6) and body.shape == (6 * B, 6) and imp.shape == (4 * P, 6)
    out = solver_cuda.unpack(table, body, imp, act)
    for g, w in zip(out, (vel, omega, pos, angle, vc.normal_impulse, vc.tangent_impulse,
                          active)):
        assert torch.equal(g, w)
    # plane order: the JAX kernel's (solver_pallas.py:79-83)
    assert torch.equal(pair_a[15 * P:16 * P] > 0.5, link)
    assert torch.equal(pair_b[(3 * P + 1) * 2 + 1], vc.r_a[1, 1, 0])


def test_cpu_entry_point_is_plain_and_cuda_planes_are_checked():
    args = spawn_inputs("MultiRobotPuzzle-v0", 4, 8, 4, 2)
    for g, w in zip(solver_cuda.solve_contacts(*args), solver_cuda.solve_contacts_plain(*args)):
        assert torch.equal(g, w)
    planes = solver_cuda.pack(*args[1:9])
    with pytest.raises(ValueError, match="CUDA tensors"):
        solver_cuda.launch(args[0], *planes, DT, 4, 2)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; on the card chip_smoke.py runs these checks")
    return torch.device("cuda")


@pytest.mark.cuda
def test_solve_kernel_against_plain_on_card(cuda_device):
    import chip_smoke

    chip_smoke.check_solve_kernel(cuda_device, "MultiRobotPuzzle-v0", 1000, seed=1)
