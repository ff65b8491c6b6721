"""``BENCHMARK.json`` against the contract's rules, the harness's data-driven
layout, the result line's keys, and the metric arithmetic on fixed inputs."""

import json
import re
import shutil
from pathlib import Path

import pytest
import torch

from portbench import check, loops
from portbench import run as R
from portbench import yardstick as Y
from portbench.tests.conftest import make_tiny_root, short_episodes

BENCH = Path(__file__).resolve().parents[1]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def _names(bench):
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in bench[group]:
            yield e["name"]
    for w in bench["workloads"]:
        yield w["config"]
        yield w["traffic"]
    for c in bench["configs"]:
        yield from c["reduced"]


def test_names_and_units_use_the_allowed_characters(bench):
    for n in _names(bench):
        assert NAME.match(n), n
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in bench[group]]
        assert len(names) == len(set(names)), group


def test_every_cell_finds_its_files_by_name(bench):
    for w in bench["workloads"]:
        spec = R.load_cell(w["name"], bench)
        assert spec["config"]["name"] == w["config"]
        loop = loops.find(spec["traffic"]["loop"])
        assert callable(loop.run) and callable(loop.check) and loop.READINGS[0] == "program"
        assert spec["limits"], w["name"]
        assert any(m["name"] == "setup_s" for m in spec["end_to_end"])
        assert len(spec["end_to_end"]) >= 2 and spec["per_layer"]
    for c in bench["configs"]:
        assert (BENCH.parent / c["file"]).is_file()
    for m in bench["per_layer"]:
        assert callable(R.metric_reader(m["name"]))


def test_each_per_layer_metric_moves_what_its_cells_report(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    cells = {w["name"] for w in bench["workloads"]}
    for m in bench["per_layer"]:
        assert m["moves"] in e2e
        for w in m.get("workloads", cells):
            assert w in cells
            assert w in e2e[m["moves"]].get("workloads", cells), (m["name"], w)


def test_run_names_no_cell_configuration_or_metric(bench):
    text = "".join(p.read_text() for p in [BENCH / "run.py", *(BENCH / "loops").glob("*.py")])
    for n in _names(bench):
        assert f'"{n}"' not in text and f"'{n}'" not in text, n


@pytest.mark.parametrize("trace", [0, 1])
def test_the_last_line_has_the_contract_keys(tiny_root, bench, trace):
    line = R.run("v0-env", 2**31 + 11, 0.2, bool(trace), device="cpu", bench=bench,
                 root=tiny_root)
    keys = ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[:5] == keys and list(line)[-1] == "checks"
    assert set(line) <= set(keys) | {"breakdown", "checks"}
    assert set(line["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    if not trace:
        assert set(line["metrics"]) == {"env_steps_per_s", "setup_s"}
    assert line["correct"] is True
    json.dumps(line)


def test_a_new_cell_config_mix_and_metric_take_only_files_and_entries(tmp_path, bench):
    root = make_tiny_root(tmp_path)
    shutil.copy(root / "configs" / "v0-flat.json", root / "configs" / "v0-dummy.json")
    d = json.loads((root / "traffic" / "random-steps.json").read_text())
    d["warmup_steps"] = 3
    (root / "traffic" / "dummy-steps.json").write_text(json.dumps(d))
    shutil.copy(root / "limits" / "v0-env.json", root / "limits" / "dummy-env.json")
    (root / "metrics" / "dummy_count.env.py").write_text(
        "def read(ctx):\n    return float(ctx['steps']) if ctx.get('steps') else None\n")
    b = json.loads(json.dumps(bench))
    b["configs"].append(dict(b["configs"][0], name="v0-dummy",
                             file="portbench/configs/v0-dummy.json"))
    b["workloads"].append({"name": "dummy-env", "config": "v0-dummy", "traffic": "dummy-steps",
                           "chips": 1, "why": "a dummy"})
    for m in b["end_to_end"]:
        if m["name"] == "env_steps_per_s":
            m["workloads"].append("dummy-env")
    b["per_layer"].append({"name": "dummy_count.env", "unit": "steps", "better": "higher",
                           "source": "program_counter", "layer": "env step",
                           "moves": "env_steps_per_s", "workloads": ["dummy-env"]})
    with short_episodes():
        line = R.run("dummy-env", 5, 0.2, True, device="cpu", bench=b, root=root)
    assert line["metrics"]["dummy_count.env"]["value"] == 3.0
    assert line["correct"] is True


def test_a_new_kind_of_loop_takes_only_a_file(tmp_path, bench):
    root = make_tiny_root(tmp_path)
    text = (root / "loops" / "env_steps.py").read_text()
    (root / "loops" / "dummy_loop.py").write_text(
        text.replace("TRACE_STEPS = 3", "TRACE_STEPS = 2"))
    (root / "traffic" / "dummy-mix.json").write_text(
        json.dumps({"loop": "dummy_loop", "why": "a dummy", "warmup_steps": 2}))
    shutil.copy(root / "limits" / "v0-env.json", root / "limits" / "dummy-env.json")
    b = json.loads(json.dumps(bench))
    b["workloads"].append({"name": "dummy-env", "config": "v0-flat", "traffic": "dummy-mix",
                           "chips": 1, "why": "a dummy"})
    for m in b["end_to_end"] + b["per_layer"]:
        if "v0-env" in m.get("workloads", []):
            m["workloads"].append("dummy-env")
    with short_episodes():
        line = R.run("dummy-env", 6, 0.2, True, device="cpu", bench=b, root=root)
    assert line["correct"] is True and line["device"]["count"] == 1


def test_the_reference_finds_a_variant_by_name():
    cfg = json.loads((BENCH / "configs" / "v0-flat.json").read_text())
    assert type(check.RefEnv(cfg).logic).__module__ == "portbench.reference.v0"
    cfg["env"]["env_id"] = "MultiRobotPuzzle-v2"
    with pytest.raises(ModuleNotFoundError, match="portbench.reference.v2"):
        check.RefEnv(cfg)


def test_union_of_intervals_and_idle_gaps():
    ops = [("a", 0.0, 10.0), ("b", 5.0, 10.0), ("c", 30.0, 5.0), ("d", 100.0, 50.0)]
    assert Y.union_us(ops, 0.0, 120.0) == 15.0 + 5.0 + 20.0
    host = [("launch", 14.0, 20.0), ("sync", 36.0, 60.0)]
    gaps = Y.idle_gaps(ops, host, 0.0, 120.0)
    assert gaps[0][0] == "sync" and abs(gaps[0][1] - 65e-6) < 1e-12
    assert gaps[1][0] == "launch" and abs(gaps[1][1] - 15e-6) < 1e-12
    ctx = {"device_ops": ops, "trace_lo": 0.0, "trace_hi": 120.0}
    assert abs(Y.idle_share(ctx) - 100.0 * (1 - 40.0 / 120.0)) < 1e-9
    assert Y.top_ops(ops)[0][0] == "d"


def test_policy_flops_from_the_shapes():
    mlp = {"trunk.0.weight": torch.zeros(256, 28), "trunk.0.bias": torch.zeros(256),
           "trunk.1.weight": torch.zeros(256, 256), "trunk.1.bias": torch.zeros(256),
           "mean.weight": torch.zeros(6, 256), "mean.bias": torch.zeros(6),
           "value.weight": torch.zeros(1, 256), "value.bias": torch.zeros(1),
           "log_std": torch.zeros(6)}
    fwd, train = Y.policy_flops(mlp, None)
    f = 2 * (256 * 28 + 256 * 256 + 6 * 256 + 256)
    assert fwd == {"float32": f, "bfloat16": 0}
    assert train["float32"] == 3 * f - 2 * 256 * 28
    per = Y.update_flops(mlp, None, n_steps=64, n_envs=4096, n_epochs=4, batch_size=8192)
    assert per["float32"] == f * (64 * 4096 + 4096) + train["float32"] * 4 * 64 * 4096
    cnn = {"convs.0.weight": torch.zeros(32, 3, 8, 8), "convs.1.weight": torch.zeros(64, 32, 4, 4),
           "convs.2.weight": torch.zeros(64, 64, 3, 3), "dense.weight": torch.zeros(512, 41984),
           "mean.weight": torch.zeros(6, 512), "value.weight": torch.zeros(1, 512)}
    fwd, _ = Y.policy_flops(cnn, (360, 160, 3))
    convs = 2 * (89 * 39 * 32 * 3 * 64 + 43 * 18 * 64 * 32 * 16 + 41 * 16 * 64 * 64 * 9)
    assert fwd["bfloat16"] == convs
    assert fwd["float32"] == 2 * (41984 * 512 + 6 * 512 + 512)


def test_tick_work_counts_from_the_world_state():
    from portbench.reference import config as rconfig
    from portbench.reference import v0 as rv0

    table = rv0.V0Env(rconfig.VARIANTS["MultiRobotPuzzle-v0"]).layout.table
    B, P, E = table.num_bodies, table.num_pairs, 4
    awake = torch.ones((B, E), dtype=torch.bool)
    none = torch.zeros((P, E), dtype=torch.bool)
    nbytes, ops = Y.tick_work(table, awake, none, 180, 60)
    assert nbytes == 4 * E * (20 * B + 26 * P)
    assert ops == E * Y.OPS_BODY * B + E * sum(Y.narrowphase_ops(table))
    one = none.clone()
    one[P - 1, 0] = True  # the two agents touch in env 0
    _b, ops1 = Y.tick_work(table, awake, one, 180, 60)
    dd = not (table.is_static[table.pair_body_a[P - 1]] or table.is_static[table.pair_body_b[P - 1]])
    assert ops1 - ops == (Y.OPS_SETUP_PAIR + 60 * Y.OPS_POS_SWEEP_BODY * int((~table.is_static).sum())
                          + 180 * Y.OPS_VEL_PAIR[dd] + 60 * Y.OPS_POS_PAIR[dd])
    t, by = Y.least_time(nbytes, {"float32": ops})
    assert t > 0 and by in ("bytes", "operations")
