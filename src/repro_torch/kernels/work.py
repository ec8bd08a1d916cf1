"""The work each hand-written kernel must do: (operations, bytes).

One place for the formulas that every bound of ``chip_smoke.py`` and the
cost analyser (``distributed/cost.py``) count a launch by: the FLOPs its
function needs on these inputs and the bytes it must move (each input
read once, each output written once).  Where the work depends on the
mask (a causal or windowed band), the formula counts the pairs this mask
lets through, not the most it could.

A kernel launch is no aten op, so an analyser that watches aten ops does
not see it: each wrapper calls ``charge(name, formula, *shape)`` where
it launches, beside its launch counter, and every ``charging()`` block open
in the process adds the launch to its tally (the process, not the thread:
a backward's kernels launch on autograd's device thread).  With no block
open ``charge`` does nothing.
"""
from __future__ import annotations

import contextlib
import functools
import threading
from typing import Dict, Iterator, List, Tuple

Work = Tuple[float, float]


def matern_flops(d: int) -> int:
    """Operations of one Matérn-5/2 ARD entry: per dimension a
    difference, a scaling and a multiply-add (3d); then the square root,
    exponential and the polynomial around them (10)."""
    return 3 * d + 10


def nll_work(k: int, b: int, d: int) -> Work:
    """(FLOPs, bytes) ``gp_nll_chol`` needs: per lane the lower triangle
    of the covariance, a Cholesky (b³/3), the forward solve (b²) and the
    NLL; each input read once, (nll, L, z) written once."""
    flops = k * (b * (b + 1) / 2 * matern_flops(d) + b ** 3 / 3 + b * b)
    nbytes = 4 * (k * d + 2 * k + k * b * d + 2 * k * b      # in
                  + k + k * b * b + k * b)                   # out
    return flops, nbytes


def ei_work(k: int, b: int, d: int, m: int) -> Work:
    """(FLOPs, bytes) ``gp_ei`` needs: per candidate its b covariance
    entries, μ and Σv² (4b), the forward substitution (b²) and the closed
    form; each input read once, ei written once."""
    flops = k * m * (b * b + b * (matern_flops(d) + 4))
    nbytes = 4 * (k * d + 4 * k + k * b * d + 2 * k * b
                  + k * b * b + k * m * d + k * m)
    return flops, nbytes


def q8_work(n: int) -> Work:
    """(operations, bytes) of quantizing n float32 elements: about 6
    operations an element (|x|, max, divide, round, two clamps); x read
    once, the (nb, 256) codes and nb scales written once."""
    nb = -(-n // 256)
    return 6 * n, 4 * n + 256 * nb + 4 * nb


def sumsq_work(n: int, elem: int) -> Work:
    """(operations, bytes) of the sum of squares of n gradient elements
    of ``elem`` bytes that AdamW's norm takes: a multiply and an add an
    element, each read once (the partial sums are a few kilobytes)."""
    return 2 * n, n * elem


def adamw_work(n: int, p_elem: int, g_elem: int) -> Work:
    """(operations, bytes) of AdamW's update of n elements, parameters of
    ``p_elem`` bytes and gradients of ``g_elem``: 17 operations an
    element (the clip scale's product, 3 for the first moment and 4 for
    the second, 5 for the step, 2 for the weight decay, 2 to apply the
    step); p, g and the float32 m and v read once, p, m and v written
    once."""
    return 17 * n, n * (2 * p_elem + g_elem + 16)


@functools.lru_cache(maxsize=256)
def visible_pairs(Sq: int, Skv: int, causal: bool, window: int,
                  q_offset: int = 0) -> int:
    """(query, key) pairs the mask lets through, counted per query; query
    row i at position ``q_offset`` + i, key j at j."""
    total = 0
    for q in range(q_offset, q_offset + Sq):
        hi = min(q + 1, Skv) if causal else Skv
        lo = max(0, q - window + 1) if window else 0
        total += max(0, hi - lo)
    return total


def flash_work(B, Sq, Skv, H, K, D, causal, window, elem, Dv=None,
               q_offset=0) -> Work:
    """(FLOPs, bytes) the attention forward needs: a visible pair a head
    takes S = q·k at the q/k width D and P·v at the value width Dv (D
    when None), 2·(D + Dv) operations, the pairs those of queries at
    ``q_offset`` onwards; q, k, v read once, o written once, each of
    ``elem`` bytes an element."""
    Dv = D if Dv is None else Dv
    flops = (2 * B * H * visible_pairs(Sq, Skv, causal, window, q_offset)
             * (D + Dv))
    nbytes = elem * (B * Sq * H * D + B * Skv * K * D + B * Skv * K * Dv
                     + B * Sq * H * Dv)
    return flops, nbytes


def flash_bwd_work(B, Sq, Skv, H, K, D, causal, window, elem,
                   Dv=None, q_offset=0) -> Work:
    """(FLOPs, bytes) the attention backward needs: a visible pair a head
    takes S = q·k, dK and dQ at the q/k width D and dP = dO·v and dV at
    the value width Dv (D when None): 2·(3·D + 2·Dv) operations, 10·D
    when they are equal, 2.5x the forward's (pairs as ``flash_work``
    counts them at ``q_offset``); q, k, v, o, dO and lse read
    once, dq, dk, dv written once.  The bf16 kernels issue twice this
    product work (P and dS split in two bf16 parts double dV, dK and dQ;
    S and dP are computed in both the dK/dV and the dQ kernel) on whole
    64 x 64 tiles of the band, at the padded width: the bound stays the
    minimum work."""
    Dv = D if Dv is None else Dv
    flops = (2 * (3 * D + 2 * Dv) * B * H
             * visible_pairs(Sq, Skv, causal, window, q_offset))
    nbytes = (elem * 2 * (D + Dv) * (B * Sq * H + B * Skv * K)
              + 4 * B * H * Sq)
    return flops, nbytes


def scan_work(B: int, S: int, R: int) -> Work:
    """(FLOPs, bytes) of the RG-LRU scan: exp, multiply and add a step
    and feature; log_a and b read, h written, float32."""
    return 3 * B * S * R, 12 * B * S * R


def scan_bwd_work(B: int, S: int, R: int) -> Work:
    """(FLOPs, bytes) of its backward: the reverse recurrence and the two
    gradients (6 a step and feature); log_a, h and dh read, d_log_a and
    d_b written, float32."""
    return 6 * B * S * R, 20 * B * S * R


class Tally:
    """Launches charged inside a ``charging()`` block: per kernel name
    its launches, FLOPs and bytes."""

    def __init__(self):
        self.kernels: Dict[str, Dict[str, float]] = {}

    def add(self, name: str, flops: float, nbytes: float) -> None:
        k = self.kernels.setdefault(name, {"launches": 0, "flops": 0.0,
                                           "bytes": 0.0})
        k["launches"] += 1
        k["flops"] += flops
        k["bytes"] += nbytes

    @property
    def flops(self) -> float:
        return sum(k["flops"] for k in self.kernels.values())

    @property
    def bytes(self) -> float:
        return sum(k["bytes"] for k in self.kernels.values())


_OPEN: List[Tally] = []
_LOCK = threading.Lock()


@contextlib.contextmanager
def charging() -> Iterator[Tally]:
    """A ``Tally`` of the launches charged inside the block."""
    tally = Tally()
    with _LOCK:
        _OPEN.append(tally)
    try:
        yield tally
    finally:
        with _LOCK:
            _OPEN.remove(tally)


def charge(name: str, formula, *args, **kwargs) -> None:
    """One launch of kernel ``name``, its work ``formula(*args,
    **kwargs)`` (worked out only when a ``charging()`` block is open),
    added to every open block."""
    if not _OPEN:
        return
    flops, nbytes = formula(*args, **kwargs)
    with _LOCK:
        for tally in _OPEN:
            tally.add(name, flops, nbytes)
