"""The readers of the program's spans and counters (``portbench/spans.py``):
their arithmetic on fixed inputs, and a traced CPU run that reads them."""

import json

import pytest

from portbench import run as R

SPAN_CTX = {
    "spans": {"steps": 4, "wall_s": 0.01,
              "host_ns": {"env.step": 4_000_000, "ppo.update": 8_000_000},
              "device_ns": {"env.control": 400_000, "env.score": 800_000,
                            "env.autoreset": 1_200_000, "env.tick": 9_000_000,
                            "env.render": 2_000_000, "learn.grad": 6_000_000,
                            "learn.adam": 10_000_000},
              "count": {}},
    "captures": [{"name": "env.step", "seconds": 1.5, "kernel_nodes": 7, "traced": False},
                 {"name": "ppo.learner", "seconds": 2.0, "kernel_nodes": 900, "traced": False},
                 {"name": "ppo.learner", "seconds": 3.0, "kernel_nodes": 950, "traced": True}],
}


@pytest.mark.parametrize("name,want", [
    ("step_host_us.env", 1000.0), ("env_logic_ms.env", 0.6), ("render_ms.env", 0.5),
    ("update_host_ms.ppo", 2.0), ("update_host_ms.ppo_pixel", 2.0), ("grad_ms.ppo", 1.5),
    ("grad_ms.ppo_pixel", 1.5), ("adam_ms.ppo", 2.5), ("adam_ms.ppo_pixel", 2.5),
    ("learner_kernels.ppo", 900.0), ("learner_kernels.ppo_pixel", 900.0),
    ("render_ms.ppo_pixel", 0.5), ("capture_s", 6.5)])
def test_span_readers_read_the_phase_and_the_counters(name, want):
    """Each reader of the program's spans and counters on a run's numbers
    put in ``ctx``; without them (a program that has no span facility, or no
    traced states) every one reads None."""
    assert abs(R.metric_reader(name)(json.loads(json.dumps(SPAN_CTX))) - want) < 1e-9
    assert R.metric_reader(name)({"traffic": {"loop": "env_steps"}}) is None


def test_a_traced_cpu_run_reads_the_span_metrics(tiny_root, bench):
    """On the CPU phase (a) runs and the span metrics of the cell have a
    value; the capture counters, which only a CUDA graph feeds, read None."""
    line = R.run("v0-ppo", 2**31 + 5, 0.2, True, device="cpu", bench=bench, root=tiny_root)
    got = line["metrics"]
    for name in ("update_host_ms.ppo", "grad_ms.ppo", "adam_ms.ppo"):
        assert got[name]["value"] > 0, name
    assert "learner_kernels.ppo" not in got and "capture_s" not in got
    assert line["correct"] is True
