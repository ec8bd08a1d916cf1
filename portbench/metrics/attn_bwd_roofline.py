"""The attention backward's share of its roofline in the traced steps:
the least time its work needs (each layer once; ``work/common.py``) over
the device time of the backward-attention kernels named in
``PATTERNS``: the port's four bf16 (three float32) backward kernels and
PyTorch's SDPA flash, cuDNN and memory-efficient backward kernels."""

PATTERNS = (r"bwd::dot_kernel", r"dkdv_tc_kernel", r"sum_splits_kernel",
            r"dq_tc_kernel", r"bwd::dkdv_kernel", r"bwd::dq_kernel",
            r"flash_bwd", r"fmha_cutlassB", r"cudnn.*(dgrad|bprop|bwd)",
            r"attn_bwd")


def read(run):
    if run.trace is None:
        return None
    t = run.trace.seconds(PATTERNS)
    if t <= 0:
        return None
    return 100.0 * run.work["bounds"]["attn_bwd"] * run.trace.steps / t
