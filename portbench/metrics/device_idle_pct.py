"""``device_idle_pct``: the share of the traced window in which nothing
ran on the card: 1 - (the union of kernel, copy and fill intervals) /
the window, from the profiler's timeline."""


def read(run):
    t = run.timeline
    if t is None or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s() / t.window_s)
