"""The MoE routing's share of the traced steps: the device milliseconds of
the program's ``moe.router``, ``moe.dispatch`` and ``moe.combine``
spans, in the forward and in the recomputation, not the experts'
products (``repro_torch/spans.py``: CUDA events at the spans'
boundaries, recorded while the profiler runs) over those of its ``step``
spans.  Nothing without the program's spans or off the card."""

#: (span, phase) pairs summed; phase None: either
SPANS = (("moe.router", None), ("moe.dispatch", None),
         ("moe.combine", None))


def read(run):
    if run.trace is None:
        return None
    try:
        from repro_torch.spans import summary
    except ImportError:          # a program without spans
        return None
    got = summary()
    step = [v["device_ms"] for (name, _), v in got.items() if name == "step"]
    part = [v["device_ms"] for (name, phase), v in got.items()
            if (name, phase) in SPANS or (name, None) in SPANS]
    if not step or None in step + part or sum(step) <= 0:
        return None
    return 100.0 * sum(part) / sum(step)
