"""One run of one cell: set-up, the measured window, the optional traced
steps, the check against the plain reference, and the result line.

Everything a cell is made of is found by name from ``BENCHMARK.json``:
its configuration file (``configs/``, whose ``reference`` names the plain
reference family under ``reference/``), its traffic (``traffic/``), its
own file (``cells/<workload>.json``: the inputs whose positions count,
the limits of the check), the configuration's work formula
(``work/<config>.py``) and each per-layer metric's reader
(``metrics/<metric>.py``).  A new cell, configuration or metric is new
files and new entries; nothing here names one.

Set-up makes the trials' parameters and the batches from the seed on
the device, hands them to the program (``program.py``) and runs the
checked steps, which warm every shape the window uses; it reads the
gradient norms after the first and the change of every parameter after
the last.  The window then runs whole steps until ``seconds`` have
passed, each step's loss read as it ends.  A traced run profiles
``profiled_steps`` more.  Once the peak memory has been read and the
program's state freed, the reference follows the checked steps of every
trial in float32, and ``compare.py`` decides ``correct``.
"""
from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

import torch

from portbench import compare as C
from portbench import trace as TR
from portbench import traffic as T
from portbench import weights as W
from portbench.program import Trainer
from portbench.reference.common import follow
from portbench.work.common import step_bounds

ROOT = Path(__file__).resolve().parents[1]
#: top-level module names a run may not hold: the JAX stack and the JAX
#: package the port was made from
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def log(*parts) -> None:
    print("portbench:", *parts, file=sys.stderr, flush=True)


def load_module(path: Path):
    """The Python file at ``path`` as a module of its own."""
    tag = re.sub(r"\W", "_", str(path.relative_to(path.parents[1])))
    spec = importlib.util.spec_from_file_location(f"portbench_file_{tag}",
                                                  path)
    if spec is None or not path.is_file():
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _json(path: Path) -> Dict:
    return json.loads(path.read_text())


@dataclasses.dataclass
class Cell:
    name: str
    entry: Dict          # the cell's entry in BENCHMARK.json
    config: Dict         # its configuration file
    traffic: Dict        # its traffic file
    spec: Dict           # its own file: counts, limits
    reference: object    # the plain reference family
    work: object         # the configuration's work formula

    @property
    def run_config(self) -> Dict:
        return self.config["run"]


class Suite:
    """A checkout's benchmark: ``BENCHMARK.json`` at ``root`` and the
    files under its first path."""

    def __init__(self, root: Path = ROOT):
        self.root = Path(root)
        self.spec = _json(self.root / "BENCHMARK.json")
        self.base = self.root / self.spec["paths"][0]

    def entry(self, key: str, name: str) -> Dict:
        """The one entry of ``key`` named ``name``."""
        found = [e for e in self.spec[key] if e["name"] == name]
        if len(found) != 1:
            raise KeyError(f"{key}: no one entry named {name!r}")
        return found[0]

    def cell(self, workload: str) -> Cell:
        entry = self.entry("workloads", workload)
        cfg_entry = self.entry("configs", entry["config"])
        config = _json(self.root / cfg_entry["file"])
        traffic = _json(self.base / "traffic" / f"{entry['traffic']}.json")
        T.check(traffic)
        return Cell(
            name=workload, entry=entry, config=config, traffic=traffic,
            spec=_json(self.base / "cells" / f"{workload}.json"),
            reference=load_module(self.base / "reference"
                                  / f"{config['reference']}.py"),
            work=load_module(self.base / "work" / f"{entry['config']}.py"))

    def metrics(self, workload: str, traced: bool) -> List[Dict]:
        """The metrics a run of the cell reports: its end-to-end metrics
        untraced, its per-layer metrics traced."""
        key = "per_layer" if traced else "end_to_end"
        return [m for m in self.spec[key]
                if workload in m.get("workloads", [workload])]

    def reader(self, metric: str) -> Callable:
        return load_module(self.base / "metrics" / f"{metric}.py").read


@dataclasses.dataclass
class Record:
    """What a per-layer metric's reader reads."""
    cell: Cell
    work: Dict                 # the work formula's step, with "bounds"
    host_step_s: List[float]   # the span around each window step's call
    window_s: float
    window_steps: int
    trace: Optional[TR.Trace]


def forbidden() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def card_line() -> str:
    """The card's name and power limit as nvidia-smi reads them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi: {e}"
    return (out.stdout.strip().splitlines() or [out.stderr.strip()])[0]


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def checked_steps(cell: Cell, seed: int, device, hp: Dict
                  ) -> Tuple[Trainer, List[Dict[str, list]], float]:
    """The program's state built from the seed's parameters and driven
    through the cell's checked steps -> (the trainer, one {"loss",
    "grad", "change"} a trial, as ``compare.gaps`` takes them, and the
    seconds spent reading the norms, which are the check's and not the
    program's set-up)."""
    run_cfg, traffic = cell.run_config, cell.traffic
    P, opt = traffic["trials"], traffic["optimizer"]
    leaves = cell.reference.leaves(run_cfg)
    paths = [leaf[0] for leaf in leaves]
    trainer = Trainer(run_cfg, traffic, hp, device)
    trainer.load(paths, W.stacked(leaves, seed, P, device))
    prog = [{"loss": [], "grad": [], "change": []} for _ in range(P)]
    for t in range(1, traffic["checked_steps"] + 1):
        m = trainer.step(T.batch(traffic, run_cfg, seed, t, device))
        for i, x in enumerate(m["loss"].float().cpu().tolist()):
            prog[i]["loss"].append(x)
        if t == 1:
            _sync(device)
            t0 = time.perf_counter()
            # the gradient as AdamW took it: its first moment is
            # (1 - b1) times the gradient times the clipping scale
            gnorm = m["grad_norm"].float()
            scale = (torch.clamp(opt["clip_norm"]
                                 / torch.clamp(gnorm, min=1e-9), max=1.0)
                     if opt["clip_norm"] else torch.ones_like(gnorm))
            rows = torch.stack([trainer.first_moment(p).flatten(1).norm(dim=1)
                                for p in paths])           # (leaves, P)
            rows = (rows / ((1 - opt["b1"]) * scale)).cpu()
            for i in range(P):
                prog[i]["grad"] = rows[:, i].tolist()
            reading = time.perf_counter() - t0
    _sync(device)
    t0 = time.perf_counter()
    for i in range(P):
        change = [None] * len(leaves)
        for j, v0 in W.draw(leaves, seed, i, device):
            change[j] = (trainer.params(paths[j])[i] - v0).norm()
        prog[i]["change"] = torch.stack(change).cpu().tolist()
    return trainer, prog, reading + time.perf_counter() - t0


def follow_reference(cell: Cell, seed: int, device, hp: Dict,
                     prec: str = "f32") -> List[Dict[str, list]]:
    """The plain reference through every trial's checked steps, from the
    seed's parameters and batches, one trial at a time."""
    run_cfg, traffic = cell.run_config, cell.traffic
    leaves = cell.reference.leaves(run_cfg)
    out = []
    for i in range(traffic["trials"]):
        batches = [{k: v.clone() for k, v in T.trial_rows(
            T.batch(traffic, run_cfg, seed, t, device), traffic, i).items()}
            for t in range(1, traffic["checked_steps"] + 1)]
        out.append(follow(
            lambda tree, batch, p: cell.reference.loss(tree, batch, run_cfg,
                                                       p),
            leaves, W.trial(leaves, seed, i, device), batches,
            hp["lr"][i], hp["weight_decay"][i], traffic["optimizer"], prec))
        del batches
    return out


def leaf_names(cell: Cell) -> List[str]:
    return [".".join(map(str, leaf[0]))
            for leaf in cell.reference.leaves(cell.run_config)]


def free(device) -> None:
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def run(suite: Suite, workload: str, seed: int, seconds: float,
        traced: bool, device, started: float) -> Dict:
    """One run -> the result line's object.  ``started``: the process's
    start on ``time.perf_counter``'s clock, where set-up begins."""
    device = torch.device(device)
    cell = suite.cell(workload)
    run_cfg, traffic = cell.run_config, cell.traffic
    P = traffic["trials"]
    hp = T.hyperparameters(traffic, seed)
    if device.type == "cuda":
        torch.empty(1, device=device)     # the allocator, before its reset
        torch.cuda.reset_peak_memory_stats(device)
    ready = time.perf_counter() - started
    trainer, prog, check_s = checked_steps(cell, seed, device, hp)
    _sync(device)
    setup_s = time.perf_counter() - started - check_s
    log(f"set-up {setup_s:.2f} s: {ready:.2f} to import and reach the "
        f"card, {setup_s - ready:.2f} for the state and the checked steps "
        f"(the check's readings, {check_s:.2f} s, left out)")

    # ---- the window: whole steps until ``seconds`` have passed
    step_no = traffic["checked_steps"] + 1
    host_s: List[float] = []
    step_s: List[float] = []
    failed = 0
    w0 = time.perf_counter()
    while True:
        s0 = time.perf_counter()
        b = T.batch(traffic, run_cfg, seed, step_no, device)
        h0 = time.perf_counter()
        m = trainer.step(b)
        host_s.append(time.perf_counter() - h0)
        loss = m["loss"].float().cpu()
        failed += int((~torch.isfinite(loss)).sum())
        step_no += 1
        step_s.append(time.perf_counter() - s0)
        if time.perf_counter() - w0 >= seconds:
            break
    window_s = time.perf_counter() - w0
    steps = len(host_s)
    positions = T.positions(b, traffic, cell.spec["counts"])

    tr = None
    if traced:
        def one():
            nonlocal step_no
            trainer.step(T.batch(traffic, run_cfg, seed, step_no,
                                 device))["loss"].cpu()
            step_no += 1
        tr = TR.profile(one, traffic["profiled_steps"], device)
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    trainer.close()
    del trainer, m, b
    free(device)

    t_ref = time.perf_counter()
    ref = follow_reference(cell, seed, device, hp)
    log(f"reference: {time.perf_counter() - t_ref:.1f} s")
    numbers = C.gaps(prog, ref, leaf_names(cell))
    limits = cell.spec.get("limits") or {}
    correct = C.verdict(numbers, limits)

    # ---- metrics
    values = {"setup_s": setup_s,
              "train_tokens_per_s": positions * steps / window_s,
              "peak_mem_gb": peak / 1e9}
    wanted = suite.metrics(workload, traced)
    metrics = {}
    if traced:
        seqs = math.prod(T.lead(traffic))
        work = dict(cell.work.step_work(run_cfg, seqs, traffic["seq"]))
        work["bounds"] = step_bounds(work["launches"])
        record = Record(cell, work, host_s, window_s, steps, tr)
        for m_ in wanted:
            v = suite.reader(m_["name"])(record)
            if v is not None:
                metrics[m_["name"]] = {"value": v, "unit": m_["unit"]}
    else:
        for m_ in wanted:
            metrics[m_["name"]] = {"value": values[m_["name"]],
                                   "unit": m_["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": 1, "memory_peak_bytes": peak}
    out = {"correct": correct, "attempted": steps * P, "failed": failed,
           "metrics": metrics, "device": dev}
    if tr is not None:
        dev["busy_s"] = tr.busy_s
        dev["window_s"] = tr.window_s
        out["breakdown"] = {"device_ops": tr.top_ops(10),
                            "idle_gaps": tr.idle_gaps(10)}
    ms = sorted(1e3 * s for s in step_s)
    log(f"{workload} seed {seed}: {steps} steps in {window_s:.3f} s, "
        f"{positions} positions a step, set-up {setup_s:.2f} s; a step "
        f"{ms[0]:.1f} / {ms[len(ms) // 2]:.1f} / {ms[-1]:.1f} ms (least, "
        f"median, most), the first {1e3 * step_s[0]:.1f}")
    for n in C.NAMES:
        if n not in limits:
            log(f"not compared: {n} {numbers[n]['value']!r}")
    out["checks"] = {n: {"value": numbers[n]["value"], "limit": lim}
                     for n, lim in limits.items()}
    for n, lim in limits.items():
        log(f"check {n} {numbers[n]['value']!r} limit {lim} "
            f"(trial {numbers[n]['trial']}, {numbers[n]['where']})")
    return out
