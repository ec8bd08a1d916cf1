"""Spans: named stretches of the training step, timed on the host and
on the device, taken only while ``torch.profiler`` runs.

``with span(name):`` marks a stretch of code.  With no profiler running
it costs one check (``torch._C._autograd._profiler_enabled()``) and
allocates nothing: there is no other switch.  Under a running profiler
a span

- opens a profiler range of its name (what ``record_function`` opens,
  without its operator dispatch), so that it sits in the profiler's
  timeline on the clock of the device's operations (and the profiler's
  idle gaps take its name where the host sat inside it);
- records a CUDA timing event on the current stream at its start and at
  its end (from a pool reused across stretches; nothing waits on them
  inside the step), when the process uses the card;
- keeps its host start and end (``time.perf_counter_ns``);
- keeps its parent, the innermost span open when it began on any thread
  (the backward runs on autograd's own thread while the caller waits),
  the ``step`` span it belongs to, and its phase: "backward" inside an
  autograd graph task (a backward, and a layer's recomputation in it),
  else "forward".

A layer's backward has no code of its own to put a ``with`` around:
``backward_span(name, x)`` brackets it by two identity autograd
Functions, one on the layer's input and one on its output.  The
output's backward opens the span as the gradient reaches the layer, the
input's closes it when the layer's last gradient has been made; under
rematerialization the recomputation runs between them.  They are
inserted only while spans are on and the input takes a gradient, and
their vmap rule is generated, so they hold under the population's
``vmap(grad(...))``.

A span opened inside an open span of its own name (a parameter's cast
inside ``cast_params``' cast of the whole tree) records nothing: the
outer one times it.

Records stay in memory; the first span of a profiled stretch drops the
previous stretch's records (a stretch begins at a span under the
profiler after one that ran without it).  ``records()`` and
``summary()`` read them; both wait for the device once.  The records
are process-wide, as the profiler that turns them on is.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
from typing import Dict, List, Optional, Tuple

import torch

_enabled = torch._C._autograd._profiler_enabled
#: the profiler's range of a name (``record_function``'s, without its
#: operator dispatch)
_Range = torch._C._profiler._RecordFunctionFast
_OFF = contextlib.nullcontext()


@dataclasses.dataclass(frozen=True)
class Record:
    """One span; ``parent`` and ``step`` index ``records()``."""
    name: str
    phase: str                    # "forward" | "backward"
    parent: Optional[int]
    step: Optional[int]
    host_ms: Optional[float]      # None while it is open
    device_ms: Optional[float]    # None off the card, or while open


@dataclasses.dataclass
class _Open:
    name: str
    phase: str
    parent: Optional[int]
    step: Optional[int]
    start_ns: int
    end_ns: int = 0
    events: Optional[Tuple[torch.cuda.Event, torch.cuda.Event]] = None
    handle: object = None         # the record_function range


class _Recorder:
    def __init__(self):
        self.spans: List[_Open] = []
        self.open: List[int] = []     # open spans, innermost last
        self.fresh = True             # the next span on starts a stretch
        self.pool: List[torch.cuda.Event] = []
        self.used = 0
        self.lock = threading.Lock()

    def _event(self) -> torch.cuda.Event:
        if self.used == len(self.pool):
            self.pool.append(torch.cuda.Event(enable_timing=True))
        self.used += 1
        return self.pool[self.used - 1]

    def begin(self, name: str) -> Optional[int]:
        """Opens a span -> its index; None, recording nothing, inside an
        open span of the same name, which times it already."""
        with self.lock:
            if self.fresh:
                self.spans.clear()
                self.open.clear()
                self.used = 0
                self.fresh = False
            if any(self.spans[j].name == name for j in self.open):
                return None
            parent = self.open[-1] if self.open else None
            i = len(self.spans)
            step = i if name == "step" else (
                self.spans[parent].step if parent is not None else None)
            phase = ("backward" if torch._C._current_graph_task_id() >= 0
                     else "forward")
            rec = _Open(name, phase, parent, step, 0)
            if torch.cuda.is_initialized():
                rec.events = (self._event(), self._event())
            self.spans.append(rec)
            self.open.append(i)
        rec.handle = _Range(name)
        rec.handle.__enter__()
        if rec.events:
            rec.events[0].record()
        rec.start_ns = time.perf_counter_ns()
        return i

    def end(self, i: Optional[int]) -> None:
        """Closes span ``i``, and first any span opened inside it that is
        still open (a backward span whose closing mark never ran)."""
        with self.lock:
            if i not in self.open:
                return
            at = self.open.index(i)
            closing = self.open[at:]
            del self.open[at:]
        for j in reversed(closing):
            rec = self.spans[j]
            rec.end_ns = time.perf_counter_ns()
            if rec.events:
                rec.events[1].record()
            rec.handle.__exit__(None, None, None)
            rec.handle = None

    def records(self) -> List[Record]:
        with self.lock:
            spans = list(self.spans)
        if any(r.events for r in spans):
            torch.cuda.synchronize()
        return [Record(r.name, r.phase, r.parent, r.step,
                       (r.end_ns - r.start_ns) / 1e6 if r.end_ns else None,
                       r.events[0].elapsed_time(r.events[1])
                       if r.events and r.end_ns else None)
                for r in spans]


_REC = _Recorder()


class _On:
    __slots__ = ("name", "i")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.i = _REC.begin(self.name)

    def __exit__(self, *exc):
        _REC.end(self.i)
        return False


def span(name: str):
    """A context manager that times its body as the span ``name`` while
    a profiler runs; a shared no-op otherwise."""
    if not _enabled():
        if not _REC.open:
            _REC.fresh = True
        return _OFF
    return _On(name)


class _Mark(torch.autograd.Function):
    """The identity, whose backward opens (``opens``) or closes the span
    of ``bw``."""
    generate_vmap_rule = True

    @staticmethod
    def forward(x, bw, opens):
        return x.view_as(x)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.bw, ctx.opens = inputs[1], inputs[2]

    @staticmethod
    def backward(ctx, g):
        if ctx.opens:
            if _enabled():
                ctx.bw.i = _REC.begin(ctx.bw.name)
        elif ctx.bw.i is not None:
            _REC.end(ctx.bw.i)
            ctx.bw.i = None
        return g, None, None


class _Backward:
    """The marks of one stretch's backward span (see the module)."""
    __slots__ = ("name", "i")

    def __init__(self, name: str):
        self.name, self.i = name, None

    def input(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` marked as the stretch's input: its backward closes the
        span."""
        return _Mark.apply(x, self, False)

    def output(self, y: torch.Tensor) -> torch.Tensor:
        """``y`` marked as the stretch's output: its backward opens the
        span."""
        return _Mark.apply(y, self, True)


class _NoBackward:
    __slots__ = ()

    def input(self, x):
        return x

    def output(self, y):
        return y


_NO_BACKWARD = _NoBackward()


def backward_span(name: str, x: torch.Tensor):
    """The marks that make the backward of a stretch from ``x`` (its
    input) to what ``.output`` is given the span ``name``; they mark
    nothing while spans are off or when ``x`` takes no gradient."""
    if not _enabled():
        if not _REC.open:
            _REC.fresh = True
        return _NO_BACKWARD
    if not (torch.is_grad_enabled() and x.requires_grad):
        return _NO_BACKWARD
    return _Backward(name)


def records() -> List[Record]:
    """The spans of the latest profiled stretch, in the order they began
    (waits for the device once)."""
    return _REC.records()


def summary() -> Dict[Tuple[str, str], Dict[str, Optional[float]]]:
    """For each (name, phase) of the latest profiled stretch: its
    ``calls``, ``host_ms`` and ``device_ms`` (None off the card), summed
    over its closed spans."""
    out: Dict[Tuple[str, str], Dict[str, Optional[float]]] = {}
    for r in records():
        if r.host_ms is None:
            continue
        s = out.setdefault((r.name, r.phase),
                           {"calls": 0, "host_ms": 0.0, "device_ms": 0.0})
        s["calls"] += 1
        s["host_ms"] += r.host_ms
        s["device_ms"] = (None if r.device_ms is None or s["device_ms"] is None
                          else s["device_ms"] + r.device_ms)
    return out
