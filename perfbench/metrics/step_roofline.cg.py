"""step_roofline.cg: one CG iteration's byte bound over the device's busy
time an iteration, in %, from rank 0's trace of the traced sets (the union
of every device operation's interval, the per-set host read included). The
bound: rank 0's stored values once, and x, r and p each read once and
written once, at the device's published memory bandwidth (``peaks.json``).
It counts the same work whatever implements the step. Moves cg_iter_ms."""


def bound_bytes(run) -> int:
    return run.itemsize * (run.nnz_local + 6 * run.rows_local)


def read(run):
    if run.trace is None or run.peak is None or not run.traced_iterations:
        return None
    busy_us = 1e6 * run.trace.busy_s / run.traced_iterations
    bound_us = 1e6 * bound_bytes(run) / run.peak["hbm_bytes_per_s"]
    return 100.0 * bound_us / busy_us
