"""device_idle_pct: the share of the traced window in which no kernel ran
on any stream (the union of the profiler's kernel intervals)."""


def read(t):
    if t.window_s <= 0 or not t.kernels:
        return None
    return 100.0 * (1.0 - t.busy_us() / 1e6 / t.window_s)
