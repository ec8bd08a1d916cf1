"""The five readers of the program's spans (``metrics/*_share_pct.py``):

- on a synthetic ``summary()``: each share is its spans' device
  milliseconds over the ``step`` spans'; nothing without device times,
  without a ``step`` span, in an untraced run, or from a program that
  has no span module;
- a traced run of the granite cells on the CPU at the tiny size
  completes, correct, and leaves the five out (no device times there).
"""
import json
import sys
import time

import pytest
import torch

from portbench import harness, tiny

NAMES = ("adamw.step_share_pct", "recompute.step_share_pct",
         "cast.step_share_pct", "moe.route_share_pct", "head.step_share_pct")


def _row(calls, device_ms):
    return {"calls": calls, "host_ms": 1.0, "device_ms": device_ms}


#: two steps of 500 device ms each, every span present
SUMMARY = {
    ("step", "forward"): _row(2, 1000.0),
    ("step.grads", "forward"): _row(2, 800.0),
    ("optim.adamw", "forward"): _row(2, 150.0),
    ("model.layer", "forward"): _row(8, 200.0),
    ("model.layer", "backward"): _row(8, 180.0),
    ("cast", "forward"): _row(66, 12.0),
    ("cast", "backward"): _row(64, 10.0),
    ("moe.router", "forward"): _row(8, 5.0),
    ("moe.router", "backward"): _row(8, 4.0),
    ("moe.dispatch", "forward"): _row(8, 20.0),
    ("moe.dispatch", "backward"): _row(8, 19.0),
    ("moe.experts", "forward"): _row(8, 60.0),
    ("moe.combine", "forward"): _row(8, 30.0),
    ("moe.combine", "backward"): _row(8, 28.0),
    ("model.head", "forward"): _row(2, 40.0),
    ("model.head.backward", "backward"): _row(2, 70.0),
}
WANT = {"adamw.step_share_pct": 15.0, "recompute.step_share_pct": 18.0,
        "cast.step_share_pct": 2.2, "moe.route_share_pct": 10.6,
        "head.step_share_pct": 11.0}


class _Traced:
    trace = object()


def _readers(monkeypatch, summary):
    from repro_torch import spans
    monkeypatch.setattr(spans, "summary", lambda: summary)
    suite = harness.Suite()
    return {n: suite.reader(n) for n in NAMES}


def test_entries_name_the_readers():
    spec = harness.Suite().spec
    entries = {m["name"]: m for m in spec["per_layer"]}
    for n in NAMES:
        assert entries[n]["unit"] == "%" and entries[n]["better"] == "lower"
        assert entries[n]["moves"] == "train_tokens_per_s"
        assert entries[n]["workloads"] == ["granite-moe.pop",
                                           "granite-moe.solo"]
    assert [m["name"] for m in spec["per_layer"]][-len(NAMES):] == list(NAMES)


@pytest.mark.parametrize("name", NAMES)
def test_share_of_the_step(monkeypatch, name):
    read = _readers(monkeypatch, SUMMARY)[name]
    assert read(_Traced()) == pytest.approx(WANT[name])


@pytest.mark.parametrize("name", NAMES)
def test_nothing_to_read(monkeypatch, name):
    off_card = {k: dict(v, device_ms=None) for k, v in SUMMARY.items()}
    assert _readers(monkeypatch, off_card)[name](_Traced()) is None
    no_step = {k: v for k, v in SUMMARY.items() if k[0] != "step"}
    read = _readers(monkeypatch, no_step)[name]
    assert read(_Traced()) is None
    assert _readers(monkeypatch, SUMMARY)[name](harness.Record(
        None, {}, [], 1.0, 1, None)) is None
    # a program without the span module (an import of it fails)
    monkeypatch.setitem(sys.modules, "repro_torch.spans", None)
    assert harness.Suite().reader(name)(_Traced()) is None


@pytest.fixture
def checkout(tmp_path):
    root = tiny.checkout(tmp_path, dtype="float32")
    for w in ("granite-moe.pop", "granite-moe.solo"):
        path = root / "portbench" / "cells" / f"{w}.json"
        path.write_text(json.dumps(dict(json.loads(path.read_text()),
                                        limits=tiny.F32_LIMITS)))
    return root


@pytest.mark.parametrize("workload", ("granite-moe.pop", "granite-moe.solo"))
def test_traced_cpu_run_leaves_the_shares_out(checkout, workload):
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        suite = harness.Suite(checkout)
        wanted = {m["name"] for m in suite.metrics(workload, True)}
        assert set(NAMES) <= wanted
        out = harness.run(suite, workload, 2 ** 31 + 7, 0.2, True, "cpu",
                          time.perf_counter())
    finally:
        torch.set_num_threads(n)
    assert out["correct"] is True, out["checks"]
    assert not set(NAMES) & set(out["metrics"])
    assert "device_idle_pct" in out["metrics"]
