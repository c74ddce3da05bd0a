"""set_p95_ms.dist: the 95th percentile, in ms, of the measured window's
CG sets on rank 0's clock, where the ranks exchange (world > 1): the value
``request_p95_ms`` gives on one card. Across cards a set waits for the
slowest rank's host at every collective, and from run to run that tail
moves by more than an end-to-end bound can hold, so it is read here
beside ``cg_iter_ms``, the rate it should move with."""

from pbcore.record import p95


def read(run):
    if run.world < 2 or not run.latencies_s:
        return None
    return 1e3 * p95(run.latencies_s)
