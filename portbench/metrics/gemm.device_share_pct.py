"""Share of the device's busy time in the traced steps spent in matrix
products: the kernels whose names match one of ``PATTERNS`` (cuBLAS,
cuBLASLt's nvjet kernels, CUTLASS and the sm90 xmma kernels)."""

PATTERNS = (r"gemm", r"nvjet", r"^(?!.*fmha).*cutlass", r"xmma", r"cublas",
            r"[Mm]atmul")


def read(run):
    if run.trace is None or run.trace.busy_s <= 0:
        return None
    return 100.0 * run.trace.seconds(PATTERNS) / run.trace.busy_s
