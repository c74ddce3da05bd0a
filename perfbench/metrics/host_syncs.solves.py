"""host_syncs.solves: the program's ``solver.host_reads`` counter (each
norm the refinement reads; no factorization runs in a request) over the
traced requests, a request. Moves factor_solve_ms."""

from pbcore import spec

# the same reading as host_syncs.helm's, in this cell
read = spec.load_reader("host_syncs.helm")
