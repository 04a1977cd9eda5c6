"""idle_share (%): the share of the traced window in which no kernel, copy
or set ran on the card (``torch.profiler``'s device intervals, merged)."""

SOURCE = "device_trace"


def read(run):
    if run.trace is None or run.trace.window_s <= 0 or \
            not run.trace.kernels:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
