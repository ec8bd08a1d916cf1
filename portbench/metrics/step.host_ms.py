"""Host milliseconds a step: the benchmark's span around the call into
the trainer's step, up to its return and before the loss is read, over
the window's steps (none of them traced).  Near the step's whole time,
the host sets the pace."""


def read(run):
    if not run.host_step_s:
        return None
    return 1e3 * sum(run.host_step_s) / len(run.host_step_s)
