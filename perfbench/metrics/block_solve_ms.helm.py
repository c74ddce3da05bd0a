"""block_solve_ms.helm: the mean over the window's requests of the time,
by CUDA events on the current stream, of ``F.solve_matrix(B)`` on the
block of shots (the solve graph's replays at the block's width and the
refinement's SpMM residual and norms). Moves factor_solve_ms."""

from pbcore import spec

# the same reading as solve_ms.direct's, in this cell
read = spec.load_reader("solve_ms.direct")
