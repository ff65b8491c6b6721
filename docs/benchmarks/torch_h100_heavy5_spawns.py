"""Kernel A (``csrc/step_fused.cu``) and ``world.step`` in float32 and
float64 on one tick of 4096 spawns of v3 built with five heavy agents (seed
2, 180/60), and how sensitive the spawns where they differ most are.

Prints, per pair of solves (kernel / float32 / float64, and the kernel's
incremental against its exact position-pass trig), the largest position
difference over the envs and how many envs exceed 1e-4, 1e-5 and 1e-6.
Then, for the four envs where each pair differs most, the distance from the
unmoved float64 result of 16 copies of the env (copy 0 unmoved, the others
with every body position and angle moved by float32's epsilon times its
magnitude, one or two units in the last place, signs at random) solved by float64 ``world.step``, float32
``world.step`` and the kernel: a spawn whose copies land on two outcomes
under float32 while float64 keeps to one is resolved by float32 rounding.
Needs the card; from the repo root:

    python docs/benchmarks/torch_h100_heavy5_spawns.py
"""

import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from gym_puzzles_tpu_torch.engine import step_cuda, world  # noqa: E402

K = 16  # perturbed copies per env

if __name__ == "__main__":
    dev = torch.device("cuda")
    print(cs.card(), flush=True)
    step_cuda.KERNEL.build()
    E = cs.NUM_ENVS
    table, contacts, bodies, force, torque, wake = cs.spawn_tick(dev, E, 2, cs.V3_ID, cs.HEAVY5)
    args = (table, bodies, contacts, force, torque, wake, cs.DT, cs.VI, cs.PI)
    bk, ck, _ = step_cuda.step_fused(*args, incremental_trig=False)
    bi, _, _ = step_cuda.step_fused(*args, incremental_trig=True)
    bp, cp, _ = world.step(*args)
    b64 = world.step(table, cs.f64(bodies), cs.f64(contacts), cs.f64(force), cs.f64(torque), wake,
                     cs.DT, cs.VI, cs.PI)[0]
    env_max = lambda a, b: (a.double() - b.double()).abs().amax(dim=(0, 1))  # noqa: E731
    d, dk, dp = env_max(bk.pos, bp.pos), env_max(bk.pos, b64.pos), env_max(bp.pos, b64.pos)
    di = env_max(bi.pos, bk.pos)
    for name, x in (("kernel-plain32", d), ("kernel-plain64", dk), ("plain32-plain64", dp),
                    ("kernel incremental-exact", di)):
        print(f"{name}: max {float(x.max()):.3e}, envs > 1e-4: {int((x > 1e-4).sum())}, "
              f"> 1e-5: {int((x > 1e-5).sum())}, > 1e-6: {int((x > 1e-6).sum())}", flush=True)
    worst = torch.unique(torch.cat([d.topk(4).indices, dk.topk(4).indices, dp.topk(4).indices]))
    gen = torch.Generator(device=dev).manual_seed(0)
    pick = lambda x, e: cs.tree_map(lambda t: t[..., e:e + 1].repeat_interleave(K, dim=-1)  # noqa
                                    .contiguous(), x)
    for e in worst.tolist():
        t0 = time.perf_counter()
        b, c, f, tq, w = (pick(x, e) for x in (bodies, contacts, force, torque, wake))
        # float32 rounding of the inputs: each position and angle moved by float32's
        # epsilon times its magnitude (copy 0 unmoved)
        ulp = lambda t: torch.where(t == 0, 0.0, torch.finfo(torch.float32).eps  # noqa: E731
                                    * t.abs())
        moved = lambda t: t + ulp(t) * torch.randint(-1, 2, t.shape, generator=gen,  # noqa
                                                     device=dev).to(t.dtype) * (
            torch.arange(K, device=dev) > 0).to(t.dtype)
        bm = b.replace(pos=moved(b.pos), angle=moved(b.angle))
        p64 = world.step(table, cs.f64(bm), cs.f64(c), cs.f64(f), cs.f64(tq), w, cs.DT, cs.VI,
                         cs.PI)[0].pos
        p32 = world.step(table, bm, c, f, tq, w, cs.DT, cs.VI, cs.PI)[0].pos
        k32 = step_cuda.step_fused(table, bm, c, f, tq, w, cs.DT, cs.VI, cs.PI,
                                   incremental_trig=False)[0].pos
        ref = b64.pos[..., e:e + 1].double()
        spread = lambda p: (p.double() - ref).abs().amax(dim=(0, 1))  # noqa: E731
        print(f"env {e}: kernel-plain32 {float(d[e]):.3e}, kernel-plain64 {float(dk[e]):.3e}, "
              f"plain32-plain64 {float(dp[e]):.3e}; from plain64 over {K} copies moved by one "
              f"float32 ulp (copy 0 unmoved): plain64 {spread(p64).tolist()}", flush=True)
        print(f"    plain32 {[round(v, 7) for v in spread(p32).tolist()]}", flush=True)
        print(f"    kernel  {[round(v, 7) for v in spread(k32).tolist()]}  "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)
