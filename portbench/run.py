"""Run one cell of ``BENCHMARK.json`` once and print its result line.

    python -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell names a configuration (``portbench/configs/<config>.json``) and a
traffic mix (``portbench/traffic/<mix>.json``, whose ``loop`` names the
general generator ``portbench/loops/<loop>.py`` that runs and checks it); its
limits are in
``portbench/limits/<cell>.json`` and each metric's reader, end-to-end or
per-layer, in ``portbench/metrics/<metric>.py``.  Nothing here names a cell, a
configuration or a metric: adding one adds files and entries only.

Set-up (imports, kernel build from the port's cache, env or learner, graph
captures, warm-up) is ``setup_s``; then the loop measures for ``--seconds``;
then the reference judges what the timed path produced, once the device's
memory peak has been read.  With ``--trace 1`` the line carries the cell's
per-layer metrics, ``busy_s`` / ``window_s`` and a ``breakdown`` instead of
its end-to-end metrics.  Needs as many CUDA devices as the cell asks for;
exits with 1 and no result without them, or when JAX or the JAX package
was loaded.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "gym_puzzles_tpu")


def manifest(path: Path | None = None) -> dict:
    return json.loads(Path(path or ROOT.parent / "BENCHMARK.json").read_text())


def load_cell(name: str, bench: dict | None = None, root: Path = ROOT) -> dict:
    """The cell, its configuration, traffic mix, limits and per-layer and
    end-to-end metrics, found by name."""
    bench = bench or manifest()
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; known: {sorted(cells)}")
    cell = cells[name]
    read = lambda p: json.loads((root / p).read_text())  # noqa: E731
    # a metric without ``workloads``: every cell, or for a per-layer metric
    # every cell that reports the end-to-end metric it moves
    e2e = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if (name in m["workloads"] if "workloads" in m else m["moves"] in reported)]
    return dict(cell=cell, config=read(f"configs/{cell['config']}.json"),
                traffic=read(f"traffic/{cell['traffic']}.json"),
                limits=read(f"limits/{name}.json"), end_to_end=e2e, per_layer=per_layer,
                chips=int(cell["chips"]))


def metric_reader(name: str, root: Path = ROOT):
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name}",
                                                  root / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def loaded_forbidden() -> list[str]:
    """Top-level names of loaded modules that are JAX or the JAX package
    (compared whole: ``gym_puzzles_tpu_torch`` is the port)."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def run(cell_name: str, seed: int, seconds: float, trace: bool, device="cuda",
        bench: dict | None = None, root: Path = ROOT, t0: float = T0) -> dict:
    """One run of a cell on ``device``: the result line as a dict, its
    compared numbers under ``checks``."""
    import torch

    from portbench import check, loops

    spec = load_cell(cell_name, bench, root)
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    loop = loops.find(spec["traffic"]["loop"], root)
    out = loop.run(spec["config"], spec["traffic"], seed, seconds, trace, dev, t0)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    ctx = out["ctx"]
    # free the program before the reference runs
    del out["release"]
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    numbers = loop.check(out, spec["config"], dev)["program"]
    print(f"portbench: set-up {ctx['setup_seconds']:.3f} s, "
          f"check {time.perf_counter() - t_check:.3f} s", file=sys.stderr)
    for k in [k for k in numbers if k.startswith("_")]:
        print(f"portbench: {k[1:]} {json.dumps(numbers.pop(k))}", file=sys.stderr)
    correct, rows = check.judge(numbers, spec["limits"])
    correct = correct and not out["missing"]
    device_info = {"platform": "gpu" if dev.type == "cuda" else "cpu",
                   "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
                   "count": spec["chips"], "memory_peak_bytes": int(peak)}
    line = {"correct": bool(correct), "attempted": int(out["attempted"]),
            "failed": int(not correct) * max(1, len(out["missing"])), "metrics": {},
            "device": device_info}
    for m in spec["per_layer"] if trace else spec["end_to_end"]:
        v = metric_reader(m["name"], root)(ctx)
        if v is not None:
            line["metrics"][m["name"]] = {"value": float(v), "unit": m["unit"]}
        elif not trace:
            raise RuntimeError(f"no reading of the end-to-end metric {m['name']}")
    if trace:
        if ctx.get("device_ops"):
            from portbench import yardstick

            window = (ctx["trace_hi"] - ctx["trace_lo"]) * 1e-6
            busy = yardstick.union_us(ctx["device_ops"], ctx["trace_lo"], ctx["trace_hi"]) * 1e-6
            device_info.update(busy_s=busy, window_s=window)
            line["breakdown"] = {
                "device_ops": yardstick.top_ops(ctx["device_ops"]),
                "idle_gaps": yardstick.idle_gaps(ctx["device_ops"], ctx["host_ops"],
                                                 ctx["trace_lo"], ctx["trace_hi"])}
    line["checks"] = [[k, v, lim] for k, v, lim in rows] + (
        [["missing_steps", len(out["missing"]), 0]] if out["missing"] else [])
    return line


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)
    os.environ.setdefault("USE_FLAX", "0")
    import torch

    spec = load_cell(a.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < spec["chips"]:
        print(f"portbench: the cell needs {spec['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 1
    line = run(a.workload, a.seed, a.seconds, bool(a.trace))
    bad = loaded_forbidden()
    if bad:
        print(f"portbench: loaded {bad}: the benchmark runs without JAX", file=sys.stderr)
        return 1
    for name, value, limit in line["checks"]:
        print(f"check {name} {value} limit {limit}", file=sys.stderr)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
