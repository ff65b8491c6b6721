"""Port's plain engine tick against ``jax.vmap(world.step)`` through
sustained contact and sleep, at 8/4 iterations:

1. the injected 3-body push world (tests/test_fused_numerics.py), 10 ticks:
   pos <= 1e-5, angle <= 1e-6, impulses <= 1e-4, ids and awake exact;
2. a sleep sawtooth: awake flags exact every tick, and the island's
   velocity zeroed where it falls asleep.

XLA on the CPU contracts a*b+c into FMA where PyTorch rounds each product;
the solver amplifies the last-bit differences in contact, hence the
impulse tolerance.
"""

import numpy as np
import torch

import jax.numpy as jnp

from tests.torch_port_helpers import both_init, maxdiff, small_tables, step_both

torch.set_num_threads(1)


def test_injected_push_world_10_ticks_8_4():
    jt, tt = small_tables()
    E = 4
    origin = np.repeat(np.array([(5.0, 5.0), (2.76, 5.5), (5.0, 3.26)], np.float32)[..., None],
                       E, -1)
    jb, jc, tb, tc = both_init(jt, tt, origin, np.zeros((3, E), np.float32))
    zf, zt = np.zeros((3, 2, E), np.float32), np.zeros((3, E), np.float32)
    wake = np.repeat(np.array([False, True, True])[:, None], E, -1)
    v = np.zeros((3, 2, E), np.float32)
    v[1, 0] = 4 / 3.0
    v[2, 1] = 4 / 3.0
    for _ in range(10):
        # holonomic control: the agents' velocities are set every tick
        jv = np.asarray(jb.vel).copy()
        jv[1:] = v[1:]
        tv = tb.vel.clone()
        tv[1:] = torch.as_tensor(v[1:])
        jo = np.asarray(jb.omega).copy()
        jo[1:] = 0.0
        to = tb.omega.clone()
        to[1:] = 0.0
        jb = jb.replace(vel=jnp.asarray(jv), omega=jnp.asarray(jo))
        tb = tb.replace(vel=tv, omega=to)
        (jb, jc, _), (tb, tc, _) = step_both(jt, tt, jb, jc, tb, tc, zf, zt, wake, 8, 4)

    assert np.asarray(jc.touching).any(), "no contact formed"
    assert maxdiff(jb.pos, tb.pos) <= 1e-5
    assert maxdiff(jb.angle, tb.angle) <= 1e-6
    assert maxdiff(jc.normal_impulse, tc.normal_impulse) <= 1e-4
    assert maxdiff(jc.tangent_impulse, tc.tangent_impulse) <= 1e-4
    np.testing.assert_array_equal(tc.man.ids.numpy(), np.asarray(jc.man.ids))
    np.testing.assert_array_equal(tb.awake.numpy(), np.asarray(jb.awake))


def test_sleep_sawtooth_8_4():
    """A T-block under a small per-tick force (the soft-assist pattern,
    00.py:421-424) slows below the sleep tolerances; after TIME_TO_SLEEP its
    island sleeps, its velocity is zeroed, and the force's wake restarts it."""
    jt, tt = small_tables()
    E = 2
    origin = np.repeat(np.array([(5.0, 5.0), (1.5, 9.0), (9.0, 1.5)], np.float32)[..., None],
                       E, -1)
    jb, jc, tb, tc = both_init(jt, tt, origin, np.zeros((3, E), np.float32))
    force = np.zeros((3, 2, E), np.float32)
    force[0, 0] = [0.8, 0.5]
    zt = np.zeros((3, E), np.float32)
    wake = np.repeat(np.array([True, False, False])[:, None], E, -1)
    slept = False
    for _ in range(40):
        (jb, jc, _), (tb, tc, _) = step_both(jt, tt, jb, jc, tb, tc, force, zt, wake, 8, 4)
        np.testing.assert_array_equal(tb.awake.numpy(), np.asarray(jb.awake))
        assert maxdiff(jb.vel, tb.vel) <= 1e-5
        asleep = ~tb.awake[0]
        if asleep.any():
            slept = True
            assert (tb.vel[0][:, asleep] == 0).all() and (tb.sleep_time[0][asleep] == 0).all()
    assert slept, "the block never fell asleep"
