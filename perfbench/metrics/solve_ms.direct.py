"""solve_ms.direct: the mean over the window's requests of the time, by
CUDA events on the current stream, of ``F.solve(b)`` (the solve graph's
replays and the refinement's A @ x and norms). Moves factor_solve_ms."""


def read(run):
    v = run.solve_ms
    return sum(v) / len(v) if v else None
