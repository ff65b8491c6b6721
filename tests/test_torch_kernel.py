"""The fused tick kernel's wrapper and arithmetic, checked on the CPU, and the
kernel itself on the card (marked ``cuda``; skipped without one).

On the CPU:
* pack then unpack of the kernel's planes is the identity;
* ``step_cuda.step_fused`` on CPU tensors is the plain ``world.step``,
  bitwise;
* the kernel source compiled as host C++ (g++, no FMA contraction) against
  the plain version: the 3-body push world within 1e-6 after 10 ticks,
  v0, Heavy-v0 and L-block spawns within 1e-5 (only cos/sin implementations
  differ), and the incremental position-pass trig within 1e-6 of the exact
  one;
* the live-pair lists the sweeps walk: envs with 0, 1 and several live
  pairs, some apart in the table, a sleeping island whose pairs keep
  manifold points and degraded block solves, in both instantiations (v0,
  v2; the v0 world in both, bitwise equal); two islands of which one
  converges early, seen through the sleep flags;
* a table beyond the kernel's compile-time maxima is refused, and each
  world gets the smallest instantiation it fits;
* ``chip_smoke.py``'s bounds of both kernels count the bytes, operations and
  live rows they counted before they moved onto ``portbench/yardstick.py``.
"""

import ctypes
import shutil
import subprocess

import pytest
import torch

from gym_puzzles_tpu_torch.api.registry import _logic
from gym_puzzles_tpu_torch.engine import _cuda_build
from gym_puzzles_tpu_torch.engine import shapes as shp
from gym_puzzles_tpu_torch.engine import step_cuda
from gym_puzzles_tpu_torch.engine import types
from gym_puzzles_tpu_torch.engine import world
from tests.torch_port_helpers import (live_pair_batch, live_pair_cases, small_tables,
                                      two_island_tick)

torch.set_num_threads(1)

DT = 1.0 / 50.0


def v0_inputs(E, seed, env_id="MultiRobotPuzzle-v0", block_shape="t"):
    logic = _logic(env_id, block_shape)
    gen = torch.Generator().manual_seed(seed)
    state, _ = logic.reset_fast(gen, E, logic.default_params())
    act = torch.rand((logic.cfg.act_dim, E), generator=gen) * 2 - 1
    bodies, force, torque, wake = logic._control(state, act)
    return logic.layout.table, bodies, state.contacts, force, torque, wake


def test_pack_unpack_identity():
    table, bodies, contacts, force, torque, wake = v0_inputs(8, 0)
    # a state with contacts in it
    bodies, contacts, _ = world.step(table, bodies, contacts, force, torque, wake, DT, 4, 2)
    bf, pf, pi = step_cuda.pack(bodies, contacts, force, torque, wake)
    B, P = table.num_bodies, table.num_pairs
    assert bf.shape == (12 * B, 8) and pf.shape == (15 * P, 8) and pi.shape == (2 * P, 8)
    # the output planes start with the input planes in the same order
    pfo = torch.cat([pf, torch.zeros(2 * P, 8)])
    b2, c2, info = step_cuda.unpack(table, bf[:8 * B].clone(), pfo, pi.clone())
    for name in ("pos", "angle", "vel", "omega", "awake", "sleep_time"):
        assert torch.equal(getattr(b2, name), getattr(bodies, name)), name
    for name in ("flip", "local_normal", "local_point", "points", "ids", "count"):
        assert torch.equal(getattr(c2.man, name), getattr(contacts.man, name)), name
    for name in ("normal_impulse", "tangent_impulse", "touching"):
        assert torch.equal(getattr(c2, name), getattr(contacts, name)), name
    assert contacts.touching.any() and not info.begin.any()


def test_cpu_entry_point_is_plain_step():
    table, bodies, contacts, force, torque, wake = v0_inputs(6, 1)
    args = (table, bodies, contacts, force, torque, wake, DT, 6, 3)
    a = step_cuda.step_fused(*args)
    b = world.step(*args)
    for x, y in zip(a, b):
        for name in x.__dataclass_fields__:
            u, v = getattr(x, name), getattr(y, name)
            if hasattr(u, "__dataclass_fields__"):
                for n2 in u.__dataclass_fields__:
                    assert torch.equal(getattr(u, n2), getattr(v, n2))
            else:
                assert torch.equal(u, v), name


def test_oversize_table_refused():
    box = shp.box_vertices(0.5, 0.5)
    specs = [types.BodySpec(fixtures=[types.FixtureSpec(vertices=box, density=1.0)])
             for _ in range(_cuda_build.MAX_B + 1)]
    with pytest.raises(ValueError, match="at most"):
        _cuda_build.world_struct(types.build_shape_table(specs))
    with pytest.raises(ValueError, match="at most"):
        _cuda_build.size_class(types.build_shape_table(specs))


@pytest.mark.parametrize("env_id, kw, size_class", [
    ("MultiRobotPuzzle-v0", {}, 0), ("MultiRobotPuzzle-v3", {}, 0),
    ("MultiRobotPuzzle-v3", dict(num_agents=3), 1), ("MultiRobotPuzzleHeavy-v0", {}, 1),
    ("MultiRobotPuzzle-v2", {}, 1)])
def test_size_class(env_id, kw, size_class):
    table = _logic(env_id, **kw).layout.table
    assert _cuda_build.size_class(table) == size_class
    max_b, max_p = _cuda_build.SIZE_CLASSES[size_class]
    assert table.num_bodies <= max_b and table.num_pairs <= max_p


@pytest.fixture(scope="module")
def host_kernel(tmp_path_factory):
    """The kernel source built as host C++ with g++."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to build the kernel source as host C++")
    out = tmp_path_factory.mktemp("host_kernel") / "step_fused_host.so"
    subprocess.run([gxx, "-x", "c++", "-O2", "-shared", "-fPIC", "-ffp-contract=off",
                    "-o", str(out), str(_cuda_build.CSRC / "step_fused.cu")],
                   check=True, capture_output=True, timeout=120)
    lib = ctypes.CDLL(str(out))
    vp = ctypes.c_void_p
    lib.gpt_step_fused_host.argtypes = [vp] * 7 + [ctypes.c_int, ctypes.c_float, ctypes.c_int,
                                                   ctypes.c_int, ctypes.c_int, ctypes.c_int]
    lib.gpt_step_fused_host.restype = ctypes.c_int
    _cuda_build.check_library(lib)
    return lib


def host_tick(lib, incremental, table, bodies, contacts, force, torque, wake, dt, vi, pi,
              size_class=None):
    """One tick of the host build, in the instantiation the wrapper would
    pick unless ``size_class`` names one."""
    bf, pf, pid = step_cuda.pack(bodies, contacts, force, torque, wake)
    B, P, E = table.num_bodies, table.num_pairs, bf.shape[-1]
    bfo = torch.full((8 * B, E), float("nan"))
    pfo = torch.full((17 * P, E), float("nan"))
    pio = torch.full((2 * P, E), -7, dtype=torch.int32)
    w = _cuda_build.world_struct(table)
    cls = _cuda_build.size_class(table) if size_class is None else size_class
    err = lib.gpt_step_fused_host(ctypes.byref(w), bf.data_ptr(), pf.data_ptr(),
                                  pid.data_ptr(), bfo.data_ptr(), pfo.data_ptr(),
                                  pio.data_ptr(), E, dt, vi, pi, int(incremental), cls)
    assert err == 0, "the world does not fit the size class"
    return step_cuda.unpack(table, bfo, pfo, pio)


def drive_push(tick, n=10):
    table = small_tables()[1]
    E = 3
    origin = torch.tensor([(5.0, 5.0), (2.76, 5.5), (5.0, 3.26)])[..., None].expand(3, 2, E)
    bodies = world.init_bodies(table, origin.contiguous(), torch.zeros(3, E))
    contacts = world.init_contacts(table, E)
    zf, zt = torch.zeros(3, 2, E), torch.zeros(3, E)
    wake = torch.tensor([False, True, True])[:, None].expand(3, E)
    v = torch.tensor([[4 / 3.0, 0.0], [0.0, 4 / 3.0]])[..., None].expand(2, 2, E)
    for _ in range(n):
        bodies = bodies.replace(vel=torch.cat([bodies.vel[:1], v]),
                                omega=torch.cat([bodies.omega[:1], torch.zeros(2, E)]))
        bodies, contacts, _ = tick(table, bodies, contacts, zf, zt, wake, DT, 8, 4)
    return bodies, contacts


def test_host_kernel_push_world(host_kernel):
    bp, cp = drive_push(world.step)
    assert cp.touching.any()
    for incremental in (False, True):
        bk, ck = drive_push(lambda *a: host_tick(host_kernel, incremental, *a))
        torch.testing.assert_close(bk.pos, bp.pos, rtol=0, atol=1e-6)
        torch.testing.assert_close(bk.angle, bp.angle, rtol=0, atol=1e-6)
        torch.testing.assert_close(ck.normal_impulse, cp.normal_impulse, rtol=0, atol=1e-6)
        assert torch.equal(ck.man.ids, cp.man.ids) and torch.equal(bk.awake, bp.awake)


@pytest.mark.parametrize("env_id, block_shape", [
    ("MultiRobotPuzzle-v0", "t"), ("MultiRobotPuzzleHeavy-v0", "t"), ("MultiRobotPuzzle-v0", "l")])
def test_host_kernel_v0_spawns(host_kernel, env_id, block_shape):
    args = v0_inputs(24, 2, env_id, block_shape) + (DT, 12, 6)
    bp, cp, ip = world.step(*args)
    bk, ck, ik = host_tick(host_kernel, False, *args)
    assert cp.touching.any() and not cp.touching.all()
    torch.testing.assert_close(bk.pos, bp.pos, rtol=0, atol=1e-5)
    torch.testing.assert_close(bk.vel, bp.vel, rtol=0, atol=1e-5)
    for name in ("ids", "count", "flip"):
        assert torch.equal(getattr(ck.man, name), getattr(cp.man, name)), name
    assert torch.equal(bk.awake, bp.awake) and torch.equal(ik.begin, ip.begin)
    bi, ci, _ = host_tick(host_kernel, True, *args)
    torch.testing.assert_close(bi.pos, bk.pos, rtol=0, atol=1e-6)
    torch.testing.assert_close(bi.angle, bk.angle, rtol=0, atol=1e-6)


@pytest.mark.parametrize("env_id, seed, size_class", [
    ("MultiRobotPuzzle-v0", 2, 0), ("MultiRobotPuzzle-v2", 0, 1)])
def test_host_kernel_live_pair_lists(host_kernel, env_id, seed, size_class):
    """The sweeps walk each env's live rows only: envs with 0, 1 and several
    live pairs (some apart in the table), a sleeping island whose pairs keep
    manifold points (carried, not solved) and, on v0, degraded block
    solves, against the plain tick; v0 also in the larger instantiation,
    bitwise equal."""
    args = live_pair_batch(env_id, 16, seed)
    cases = live_pair_cases(*args)
    n = cases["per_env"]
    assert (n == 0).any() and (n == 1).any() and (n >= 2).any() and cases["apart"].any()
    assert cases["unsolved_with_points"].any()
    assert cases["degraded"].any() or env_id != "MultiRobotPuzzle-v0"
    assert _cuda_build.size_class(args[0]) == size_class
    args = args + (DT, 12, 6)
    bp, cp, ip = world.step(*args)
    bk, ck, ik = host_tick(host_kernel, False, *args)
    for name in ("pos", "angle", "vel", "omega"):
        torch.testing.assert_close(getattr(bk, name), getattr(bp, name), rtol=0, atol=1e-5)
    for name in ("normal_impulse", "tangent_impulse"):
        torch.testing.assert_close(getattr(ck, name), getattr(cp, name), rtol=0, atol=1e-5)
    for name in ("ids", "count", "flip"):
        assert torch.equal(getattr(ck.man, name), getattr(cp.man, name)), name
    assert torch.equal(bk.awake, bp.awake) and torch.equal(ck.touching, cp.touching)
    assert torch.equal(ik.begin, ip.begin) and torch.equal(ik.end, ip.end)
    # the sleeping envs' manifolds come through as they went in
    asleep = cases["unsolved_with_points"]
    assert torch.equal(ck.man.count[asleep], args[2].man.count[asleep])
    bi, ci, _ = host_tick(host_kernel, True, *args)
    torch.testing.assert_close(bi.pos, bk.pos, rtol=0, atol=1e-6)
    torch.testing.assert_close(bi.angle, bk.angle, rtol=0, atol=1e-6)
    if size_class == 0:
        big = host_tick(host_kernel, False, *args, size_class=1)
        for x, y in zip(big, (bk, ck, ik)):
            for name in x.__dataclass_fields__:
                u, v = getattr(x, name), getattr(y, name)
                if hasattr(u, "__dataclass_fields__"):
                    assert all(torch.equal(getattr(u, f), getattr(v, f))
                               for f in u.__dataclass_fields__)
                else:
                    assert torch.equal(u, v), name


def test_host_kernel_island_done_early(host_kernel):
    """Two islands, one converging at the first position sweep and one that
    cannot in 2: with every sleep timer one tick short of the limit, a body
    falls asleep exactly when its island's position solve is done, so the
    awake flags read the per-island early exit."""
    layout, tick = two_island_tick()
    table, bodies, contacts, force, torque, wake = tick
    bodies = bodies.replace(sleep_time=torch.full_like(bodies.sleep_time, 0.5 - DT / 2))
    args = (table, bodies, contacts, force, torque, wake, DT, 8, 2)
    bp, cp, _ = world.step(*args)
    blk, a0 = layout.block_slot, int(layout.agent_slots[0])
    assert bp.awake[blk].all() and bp.awake[a0].all()
    assert not bp.awake[a0 + 1:].any(), "the converged island and the free agents sleep"
    for incremental in (False, True):
        bk, ck, _ = host_tick(host_kernel, incremental, *args)
        assert torch.equal(bk.awake, bp.awake)
        torch.testing.assert_close(bk.pos, bp.pos, rtol=0, atol=1e-5)
        torch.testing.assert_close(ck.normal_impulse, cp.normal_impulse, rtol=0, atol=1e-5)


# chip_smoke.py's bounds on 256 spawns (seed 0, one tick at 180/60), counted
# before they moved onto portbench/yardstick.py's arithmetic: (bytes, float32
# operations, live rows) of kernel A (``kernel_bound``) and kernel B
# (``solve_bound``, the second tick's constraints)
BOUND_COUNTS = {("A", "MultiRobotPuzzle-v0"): (702_464, 14_515_966, 253),
                ("A", "MultiRobotPuzzle-v2"): (1_554_432, 23_750_180, 302),
                ("B", "MultiRobotPuzzle-v0"): (345_356, 9_959_020, 227),
                ("B", "MultiRobotPuzzle-v2"): (657_064, 6_070_960, 106)}


@pytest.mark.parametrize("kernel, env_id", list(BOUND_COUNTS))
def test_chip_smoke_bound_counts(kernel, env_id):
    import chip_smoke

    dev = torch.device("cpu")
    if kernel == "A":
        table, contacts, bodies, force, torque, wake = chip_smoke.spawn_tick(dev, 256, 0, env_id)
        bf, _pf, _pi = step_cuda.pack(bodies, contacts, force, torque, wake)
        live = _cuda_build.live_pairs(table, bodies, contacts, force, torque, wake, DT)
        b = chip_smoke.kernel_bound(table, bf, live, 180, 60)
    else:
        table, solve_args = chip_smoke.spawn_solve_args(dev, 256, 0, env_id)
        b = chip_smoke.solve_bound(table, *solve_args[:2], 180, 60)
    assert (b["bytes"], b["ops"], b["live_rows"]) == BOUND_COUNTS[kernel, env_id]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; on the card chip_smoke.py runs these checks")
    return torch.device("cuda")


@pytest.mark.cuda
def test_kernel_against_plain_on_card(cuda_device):
    import chip_smoke

    chip_smoke.check_push_world(cuda_device)
    chip_smoke.check_spawns(cuda_device, 1000, seed=1)
    chip_smoke.check_trig(cuda_device)
