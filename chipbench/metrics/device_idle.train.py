"""device_idle: the share of the traced window in which no device operation
(kernel, copy or fill) ran, in %."""


def read(run):
    if run.trace.busy_s <= 0:
        return None
    return 100 * (1 - run.trace.busy_s / run.trace.window_s)
