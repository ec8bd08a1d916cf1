"""The attention forward's share of its roofline in the traced steps: the
least time its work needs (each layer's launch counted once, not its
recomputation; ``work/common.py``) over the device time of the
forward-attention kernels named in ``PATTERNS``: the port's hand-written
kernels and PyTorch's SDPA flash, cuDNN and memory-efficient kernels, so
that it reads the same work whatever implements it."""

PATTERNS = (r"flash_tc_kernel", r"::flash_kernel", r"flash_fwd",
            r"fmha_cutlassF", r"cudnn.*(fprop|fwd)", r"attn_fwd")


def read(run):
    if run.trace is None:
        return None
    t = run.trace.seconds(PATTERNS)
    if t <= 0:
        return None
    return 100.0 * run.work["bounds"]["attn_fwd"] * run.trace.steps / t
