"""spmv_roofline.cg: the SpMV's byte bound over the device time of the SpMV
kernels a call, in %, from rank 0's trace of the traced sets. The bound:
rank 0's stored values read once, the distinct entries of x its rows read
once, y written once, at the device's published memory bandwidth
(``peaks.json``). Moves cg_iter_ms."""

# the program's SpMV kernels (hpclinalg_torch/csrc): K1 (DIA), K3 (resident
# ELL), K2 (ELL rows and its COO tail); the exchange's gather is not the
# SpMV's
KERNELS = ("dia_vec", "dia_scalar", "ell_resident_rows", "ell_rows",
           "ell_tail")


def bound_bytes(run) -> int:
    return run.itemsize * (run.nnz_local + run.xcols_local + run.rows_local)


def read(run):
    if run.trace is None or run.peak is None or not run.traced_iterations:
        return None
    us, calls = run.trace.time_of(KERNELS)
    if not calls:
        return None
    bound_us = 1e6 * bound_bytes(run) / run.peak["hbm_bytes_per_s"]
    return 100.0 * bound_us / (us / run.traced_iterations)
