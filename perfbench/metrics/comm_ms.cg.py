"""comm_ms.cg: device ms an iteration of the NCCL kernels (the halo's
all_to_all_single and the all_reduces, waiting included), from rank 0's
trace of the traced sets. Moves cg_iter_ms; read where ranks exchange."""

KERNELS = ("nccl",)


def read(run):
    if run.trace is None or run.world < 2 or not run.traced_iterations:
        return None
    us, calls = run.trace.time_of(KERNELS)
    if not calls:
        return None
    return 1e-3 * us / run.traced_iterations
