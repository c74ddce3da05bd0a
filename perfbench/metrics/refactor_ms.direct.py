"""refactor_ms.direct: the mean over the window's requests of the time,
by CUDA events on the current stream, of ``F.refactorize(A.with_values(v))``
(value gather, eps, the factor graph's replay, the one host read). Moves
factor_solve_ms."""


def read(run):
    v = run.refactor_ms
    return sum(v) / len(v) if v else None
