"""Error-feedback int8 gradient compression for data-parallel reductions.

The port of the reference's ``distributed/compress.py``.  Each gradient is
quantized to int8 in blocks of 256 against a per-block max-abs scale, and
the quantization residual is carried in an error-feedback buffer, so SGD
and Adam converge as if uncompressed (Karimireddy et al., 2019).
``quantize`` goes through ``ops.int8_quantize``: the hand-written CUDA
kernel on the card, its plain version on the CPU.  The reference calls
that kernel its hot path, though its own ``quantize`` is plain jnp; the
function is the same.

A ``torch.distributed`` process group stands in for the reference's
``shard_map`` axis: ``n`` is the group's size and the mean is an
all-reduce of the sum divided by ``n``.  Without an initialised process
group ``compressed_psum`` raises, as the reference needs a named axis.
As in the reference, the all-reduce carries the *dequantized* float32
tensor, so it moves as many bytes as an uncompressed one; sending the
int8 codes and scales instead is later work (ROADMAP.md §1).

This path has no weights: its state is the tree of float32 error buffers,
which callers pass in and get back, so no converter is needed; the tests
hand both packages the same numpy arrays.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.kernels import ops
from repro_torch.kernels.int8_quant import BLOCK  # elements a block


def quantize(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """float -> (int8 values (nb, 256), per-block float32 scales (nb,)).
    Blockwise max-abs."""
    return ops.int8_quantize(x)


def dequantize(q: torch.Tensor, scale: torch.Tensor, shape) -> torch.Tensor:
    deq = q * scale[:, None]       # one pass: int8 -> float32 is exact
    n = 1
    for d in shape:
        n *= d
    return deq.reshape(-1)[:n].reshape(shape)


def _group_size(group: Optional[dist.ProcessGroup]) -> int:
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError(
            "compressed_psum needs an initialised torch.distributed process "
            "group (the reference needs a shard_map axis): call "
            "torch.distributed.init_process_group first")
    return dist.get_world_size(group)


def compressed_psum(grad: torch.Tensor, err: torch.Tensor,
                    group: Optional[dist.ProcessGroup] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Error-feedback compressed mean over ``group`` (the default group
    when None).  Returns (reduced float32, new_error float32), both of
    ``grad``'s shape."""
    n = _group_size(group)
    corrected = grad.to(torch.float32) + err
    q, scale = quantize(corrected)
    sent = dequantize(q, scale, grad.shape)
    new_err = corrected - sent                      # residual feedback
    del corrected, q, scale
    # all-reduce ``sent`` in place: it is this call's own tensor.  The
    # divisor is a tensor, since CUDA division by a Python number
    # multiplies by its reciprocal and the reference divides.
    dist.all_reduce(sent, op=dist.ReduceOp.SUM, group=group)
    reduced = sent.div_(sent.new_full((), float(n)))
    return reduced, new_err


def compressed_psum_tree(grads, errs,
                         group: Optional[dist.ProcessGroup] = None):
    """``compressed_psum`` over every leaf of a nest of dicts and lists
    (``errs`` has ``grads``' structure, leaves paired by key and position)
    -> (reduced tree in each grad's dtype, new error tree in float32).
    Blocks are taken per leaf."""
    if isinstance(grads, dict):
        pairs = {k: compressed_psum_tree(g, errs[k], group)
                 for k, g in grads.items()}
        return ({k: p[0] for k, p in pairs.items()},
                {k: p[1] for k, p in pairs.items()})
    if isinstance(grads, (list, tuple)):
        pairs = [compressed_psum_tree(g, e, group)
                 for g, e in zip(grads, errs, strict=True)]
        return (type(grads)(p[0] for p in pairs),
                type(grads)(p[1] for p in pairs))
    reduced, new_err = compressed_psum(grads, errs, group)
    return reduced.to(grads.dtype), new_err
