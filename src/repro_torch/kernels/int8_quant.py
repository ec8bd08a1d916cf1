"""Wrapper of the hand-written CUDA int8 quantization
(``csrc/int8_quant.cu``), with its plain version.

``int8_quantize(x)`` flattens ``x`` (any shape and dtype, cast to
float32), cuts it into blocks of 256 (the tail read as 0) and returns
(q int8 (nb, 256), scales float32 (nb,)) with scale = max(max|x|/127,
1e-12) and q = clip(round(x/scale), −127, 127), round half to even.  For
tensors on the CPU it takes its plain version (``ref.int8_quant_ref``);
for CUDA tensors it launches the kernel or raises.  Every launch adds one
to ``int8_quantize_launches``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ref, work
from repro_torch.kernels._launch import I64, P, LaunchCounter, _fn, \
    _raise_on

BLOCK = 256

int8_quantize_launches = LaunchCounter()


def int8_quantize(x: torch.Tensor):
    """x: any shape -> (q int8 (nb, 256), scales float32 (nb,))."""
    if x.device.type == "cpu":
        return ref.int8_quant_ref(x, BLOCK)
    if x.device.type != "cuda":
        raise ValueError(f"int8_quantize: no kernel for device {x.device}")
    flat = x.to(torch.float32).reshape(-1).contiguous()
    if flat.data_ptr() % 16:  # the kernel loads float4s
        flat = flat.clone()
    n = flat.numel()
    nb = -(-n // BLOCK)
    q = torch.empty((nb, BLOCK), dtype=torch.int8, device=x.device)
    scales = torch.empty((nb,), dtype=torch.float32, device=x.device)
    if n == 0:
        return q, scales
    fn = _fn("int8_quant", "int8_quant_launch", [P, P, P, I64, P])
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(flat.data_ptr(), q.data_ptr(), scales.data_ptr(), n, stream)
    _raise_on(err, "int8_quantize")
    int8_quantize_launches.add()
    work.charge("int8_quantize", work.q8_work, n)
    return q, scales
