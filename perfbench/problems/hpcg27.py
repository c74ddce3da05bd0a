"""The configuration kind ``hpcg27``: HPCG 3.1's 27-point operator on the
global grid ``local_grid`` x ``process_grid``, made on the host
(``pbcore/grids.hpcg27``) and applied by the reference
(``reference/hpcg.stencil27``)."""

from pbcore import grids
from reference import hpcg


def dims(cfg):
    return [int(a) * int(b) for a, b in zip(cfg["local_grid"],
                                            cfg["process_grid"])]


def matrix(cfg):
    """The host CSR matrix the program is given."""
    return grids.hpcg27(dims(cfg))


def operator(cfg):
    """A @ x by the reference, for x (..., n) on any device."""
    d = dims(cfg)
    return lambda x: hpcg.stencil27(x, d)
