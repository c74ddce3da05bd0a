"""solve_ms.solves: the mean over the window's requests of the time, by
CUDA events on the current stream, of ``F.solve(b)`` on a factorization
made once at set-up (the solve graph's replays, K2's gather in and out,
the refinement's A @ x and norms). Moves factor_solve_ms."""

from pbcore import spec

# the same reading as solve_ms.direct's, in this cell
read = spec.load_reader("solve_ms.direct")
