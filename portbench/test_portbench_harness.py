"""The harness on the CPU, at the tiny size (``tiny.py``):

- it finds a cell and a per-layer metric that exist only as new files and
  new entries in a copy of the benchmark, and reports that metric;
- it drives the rest of a run (everything but the look for a card) and
  ``correct`` comes out false with each planted fault under the timed
  path: a state left unchanged, half of each trial's rows left out, one
  parameter's update applied twice; and true without one;
- its trace reduction: busy time as the union of device intervals, idle
  gaps named by the innermost host event.
"""
import json
import time

import pytest
import torch

from portbench import faults, harness, tiny
from portbench.trace import Trace

F32_LIMITS = tiny.F32_LIMITS


@pytest.fixture(autouse=True, scope="module")
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def checkout(tmp_path):
    """A tiny float32 copy of the benchmark with one cell and one metric
    more, added as new files and new entries only."""
    root = tiny.checkout(tmp_path, dtype="float32")
    base = root / "portbench"
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["workloads"].append(
        {"name": "granite-moe.pop2", "config": "granite-moe-3b-a800m-d4",
         "traffic": "pop2", "chips": 1, "why": "a cell added by files"})
    spec["per_layer"].append(
        {"name": "steps.counted", "unit": "steps", "better": "higher",
         "source": "program_counter", "layer": "trial step",
         "moves": "train_tokens_per_s", "workloads": ["granite-moe.pop2"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    traffic = json.loads((base / "traffic" / "population-4x2-s4096.json")
                         .read_text())
    (base / "traffic" / "pop2.json").write_text(
        json.dumps(dict(traffic, trials=2)))
    (base / "cells" / "granite-moe.pop2.json").write_text(
        json.dumps({"counts": ["tokens"], "limits": F32_LIMITS}))
    (base / "metrics" / "steps.counted.py").write_text(
        "def read(run):\n    return float(run.window_steps)\n")
    for w in ("granite-moe.pop", "whisper.pop", "granite-moe.solo"):
        path = base / "cells" / f"{w}.json"
        path.write_text(json.dumps(dict(json.loads(path.read_text()),
                                        limits=F32_LIMITS)))
    return root


def _run(root, workload, traced=False):
    return harness.run(harness.Suite(root), workload, 2 ** 31 + 5, 0.2,
                       traced, "cpu", time.perf_counter())


def test_new_cell_and_metric_found_by_name(checkout):
    out = _run(checkout, "granite-moe.pop2", traced=True)
    assert out["correct"] is True, out["checks"]
    assert out["metrics"]["steps.counted"]["value"] >= 1
    assert out["attempted"] == 2 * out["metrics"]["steps.counted"]["value"]
    # the cells already there report the new metric nowhere
    suite = harness.Suite(checkout)
    assert [m["name"] for m in suite.metrics("granite-moe.pop", True)] \
        == [m["name"] for m in harness.Suite().metrics("granite-moe.pop",
                                                        True)]


def test_untraced_run_reports_end_to_end_metrics(checkout):
    out = _run(checkout, "granite-moe.solo")
    assert set(out["metrics"]) == {"setup_s", "train_tokens_per_s",
                                   "peak_mem_gb"}
    assert out["metrics"]["train_tokens_per_s"]["value"] > 0
    assert list(out)[-1] == "checks"
    assert set(out["checks"]) == set(F32_LIMITS)


@pytest.mark.parametrize("workload", ("granite-moe.pop", "whisper.pop",
                                      "granite-moe.solo"))
@pytest.mark.parametrize("fault", (None,) + faults.FAULTS)
def test_planted_faults_come_out_not_correct(checkout, workload, fault):
    if fault is None:
        assert _run(checkout, workload)["correct"] is True
        return
    with faults.planted(fault):
        out = _run(checkout, workload)
    assert out["correct"] is False, (fault, out["checks"])


def test_trace_reduction():
    tr = Trace(device=[("k1", 10.0, 20.0), ("k2", 15.0, 30.0),
                       ("gemm_a", 50.0, 60.0), ("k1", 95.0, 120.0)],
               host=[("aten::item", 30.0, 50.0), ("aten::mm", 1.0, 2.0),
                     ("cudaStreamSynchronize", 62.0, 94.0)],
               start=0.0, end=100.0, steps=1)
    assert tr.intervals() == [(10.0, 30.0), (50.0, 60.0), (95.0, 100.0)]
    assert tr.busy_s == pytest.approx(35e-6)
    assert tr.seconds(["gemm"]) == pytest.approx(10e-6)
    gaps = tr.idle_gaps(10)
    assert [g[0] for g in gaps] == ["cudaStreamSynchronize", "aten::item",
                                    "after aten::mm"]
    assert gaps[0][1] == pytest.approx(35e-6)
    assert tr.top_ops(1) == [["k1", pytest.approx(35e-6)]]
