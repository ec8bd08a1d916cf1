"""Share of the traced steps' range in which no operation runs on the
device (the union of the operations' intervals, from the profiler)."""


def read(run):
    if run.trace is None or run.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
