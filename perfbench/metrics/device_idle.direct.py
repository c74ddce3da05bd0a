"""device_idle.direct: the share of rank 0's traced window, in %, in which no
device operation runs (the complement of the union of their intervals).
Moves factor_solve_ms."""


def read(run):
    t = run.trace
    if t is None or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
