"""plan_build_s: host seconds, on rank 0, of the program's plan builds, by
the harness's clock: ``DistSparseMatrix.from_scipy`` and ``cg_step_fn``
(exchange, SpMV engine choice and value tables, one product) in the CG
loop; ``from_scipy``, ``with_values`` and ``ldlt(method="device")``
(ordering, symbolic analysis, schedule, first factorization and the factor
graph's capture) in the direct loop. Moves setup_s."""


def read(run):
    return run.plan_build_s
