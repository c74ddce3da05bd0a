"""device_idle.helm: the share of rank 0's traced window, in %, in which no
device operation runs (the complement of the union of their intervals).
Moves factor_solve_ms."""

from pbcore import spec

# the same reading as device_idle.direct's, in this cell
read = spec.load_reader("device_idle.direct")
