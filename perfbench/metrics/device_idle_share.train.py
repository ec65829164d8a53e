"""The device's idle share of the traced window, in %: 1 minus the union
of the kernel, copy and memset intervals in the torch.profiler trace over
the window's length."""


def read(run):
    if run.busy_s is None:
        return None
    return 100.0 * (1.0 - run.busy_s / run.window_s)
