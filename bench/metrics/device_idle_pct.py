"""device_idle_pct (%; layer: device): the share of the traced segment in
which no device operation (kernel, copy, set) ran, from the profiler's
trace: 100 x (1 - busy_s / window_s)."""


def read(run):
    if not run.traced:
        return None
    return 100.0 * (1.0 - run.summary["busy_s"] / run.summary["window_s"])
