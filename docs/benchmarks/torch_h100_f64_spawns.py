"""Kernel A (``csrc/step_fused.cu``) and ``world.step`` in float32, each
against ``world.step`` in float64, on one tick of Heavy-v0 spawns at 180/60.

Deep-overlap spawns are resolved chaotically by the 60 position sweeps, so
on a large batch the largest difference between the kernel and the float32
plain version is set by a few envs whose float32 result is not stable; the
float64 solve says which of the two float32 solves is off.  Prints, per
batch, the largest difference per env of each pair (max, count beyond 1e-4
and 1e-5, quantiles) and the five envs where kernel and float32 plain differ
most.  Needs the card; from the repo root:

    python docs/benchmarks/torch_h100_f64_spawns.py
"""

import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

BATCHES = ((16384, 2), (4096, 2), (4096, 0), (4096, 1), (4096, 3))  # (envs, seed)


def env_max(a, b):
    return (a.double() - b.double()).abs().amax(dim=(0, 1))


def main():
    dev = torch.device("cuda")
    print(cs.card(), flush=True)
    cs.step_cuda.KERNEL.build()
    f64 = lambda x: cs.tree_map(lambda t: t.double() if t.is_floating_point() else t, x)  # noqa
    for E, seed in BATCHES:
        table, c, b, f, t, w = cs.spawn_tick(dev, E, seed, cs.HV0_ID)
        args = (table, b, c, f, t, w, cs.DT, cs.VI, cs.PI)
        bk = cs.step_cuda.step_fused(*args, incremental_trig=False)[0]
        bi = cs.step_cuda.step_fused(*args)[0]
        t0 = time.perf_counter()
        bp, cp, _ = cs.world.step(*args)
        torch.cuda.synchronize()
        t32 = time.perf_counter() - t0
        t0 = time.perf_counter()
        b64 = cs.world.step(table, f64(b), f64(c), f64(f), f64(t), w, cs.DT, cs.VI, cs.PI)[0]
        torch.cuda.synchronize()
        t64 = time.perf_counter() - t0
        kp, k64, p64 = env_max(bk.pos, bp.pos), env_max(bk.pos, b64.pos), env_max(bp.pos, b64.pos)
        print(f"{cs.HV0_ID} E={E} seed={seed}: world.step float32 {t32:.1f} s, float64 "
              f"{t64:.1f} s; {int(cp.touching.any(dim=0).sum())} envs in contact", flush=True)
        for name, d in (("kernel - plain32", kp), ("kernel - plain64", k64),
                        ("plain32 - plain64", p64),
                        ("kernel incremental trig - plain64", env_max(bi.pos, b64.pos))):
            q = torch.quantile(d.float(), torch.tensor([0.5, 0.99, 0.999], device=dev))
            print(f"  {name}: max {float(d.max()):.3e} m at env {int(d.argmax())}; beyond 1e-4: "
                  f"{int((d > 1e-4).sum())}, beyond 1e-5: {int((d > 1e-5).sum())}; quantiles "
                  f"0.5 / 0.99 / 0.999 {', '.join(f'{float(x):.2e}' for x in q)}", flush=True)
        for e in torch.topk(kp, 5).indices.tolist():
            print(f"   env {e}: kernel - plain32 {float(kp[e]):.3e}, kernel - plain64 "
                  f"{float(k64[e]):.3e}, plain32 - plain64 {float(p64[e]):.3e} m; pairs "
                  f"touching {int(cp.touching[:, e].sum())}", flush=True)


if __name__ == "__main__":
    main()
