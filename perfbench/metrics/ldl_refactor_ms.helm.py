"""ldl_refactor_ms.helm: the mean over the window's requests of the time,
by CUDA events on the current stream, of ``F.refactorize(A.with_values(v))``
on the complex-symmetric LDLᵀ (value gather, eps, the factor graph's
replay with the recursive unpivoted leaf, the one host read). Moves
factor_solve_ms."""

from pbcore import spec

# the same reading as refactor_ms.direct's, in this cell
read = spec.load_reader("refactor_ms.direct")
