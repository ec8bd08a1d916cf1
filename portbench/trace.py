"""A traced stretch of steps and the readings taken from it.

``profile(fn, n)`` runs ``fn`` n times under ``torch.profiler`` (host and
device activity) inside one named host range, then keeps, from the
profiler's raw records, every device operation (kernels, copies, sets)
and every host event with its start and end in microseconds.  The
device's busy time is the union of its operations' intervals inside the
range; the idle gaps are the holes in that union, each named by the
innermost host event that spans its middle.  Reading the raw records
(``kineto_results.events()``) rather than ``prof.events()`` keeps the
reading to seconds at a population step's tens of thousands of kernels.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Callable, List, Sequence, Tuple

#: the host range around the traced steps
RANGE = "portbench.traced_steps"
#: characters of an operation's name kept in the breakdown
NAME = 160

Span = Tuple[str, float, float]


@dataclasses.dataclass
class Trace:
    device: List[Span]        # (name, start us, end us) of each operation
    host: List[Span]          # host events
    start: float              # the traced range, us
    end: float
    steps: int

    @property
    def window_s(self) -> float:
        return (self.end - self.start) / 1e6

    def intervals(self) -> List[Tuple[float, float]]:
        """The union of the operations' intervals inside the range, in
        order."""
        out: List[List[float]] = []
        for _, a, b in sorted(self.device, key=lambda s: s[1]):
            a, b = max(a, self.start), min(b, self.end)
            if b <= a:
                continue
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return [(a, b) for a, b in out]

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.intervals()) / 1e6

    def seconds(self, patterns: Sequence[str]) -> float:
        """Device seconds of the operations whose name matches any of the
        regular expressions."""
        rx = re.compile("|".join(patterns))
        return sum(b - a for name, a, b in self.device
                   if rx.search(name)) / 1e6

    def top_ops(self, n: int = 10) -> List[List]:
        by: dict = {}
        for name, a, b in self.device:
            by[name] = by.get(name, 0.0) + (b - a) / 1e6
        top = sorted(by.items(), key=lambda kv: -kv[1])[:n]
        return [[k[:NAME], v] for k, v in top]

    def idle_gaps(self, n: int = 10) -> List[List]:
        """The n longest stretches of the range with no device operation,
        named by what the host was doing in their middle."""
        edges = [self.start]
        for a, b in self.intervals():
            edges += [a, b]
        edges.append(self.end)
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        gaps.sort(key=lambda g: g[0] - g[1])
        out = []
        for a, b in gaps[:n]:
            mid = (a + b) / 2
            around = [(e - s, name) for name, s, e in self.host
                      if s <= mid <= e]
            if around:
                name = min(around)[1]
            else:       # the host between events: name the last it ended
                before = [(e, name) for name, s, e in self.host if e < mid]
                name = f"after {max(before)[1]}" if before else "(none)"
            out.append([name[:NAME], (b - a) / 1e6])
        return out


def profile(fn: Callable[[], None], n: int, device) -> Trace:
    """``fn`` run n times under torch.profiler, the device synchronised
    at the end of the range (on the CPU, host activity alone)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as _profile
    from torch.profiler import record_function
    card = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if card else (lambda: None)
    sync()
    with _profile(activities=[ProfilerActivity.CPU]
                  + ([ProfilerActivity.CUDA] if card else [])) as prof:
        with record_function(RANGE):
            for _ in range(n):
                fn()
            sync()
    device, host = [], []
    start = end = None
    for e in prof.profiler.kineto_results.events():
        s = e.start_ns() / 1e3
        span = (e.name(), s, s + e.duration_ns() / 1e3)
        if e.name() == RANGE:
            if e.device_type() != DeviceType.CUDA:
                start, end = span[1], span[2]
            continue
        (device if e.device_type() == DeviceType.CUDA else host).append(span)
    if start is None:
        raise RuntimeError("the profiler kept no record of the traced range")
    # a host range is mirrored on the device's timeline under its own
    # name: that is no operation
    ranges = {name for name, _, _ in host}
    device = [d for d in device if d[0] not in ranges]
    return Trace(device, host, start, end, n)
