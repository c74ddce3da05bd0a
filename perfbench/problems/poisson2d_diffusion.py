"""The configuration kind ``poisson2d_diffusion``: the 5-point pattern of a
``grid`` x ``grid`` Poisson problem whose values come from seeded edge
conductivities in ``coefficient_range`` (``reference/poisson.py``)."""

from pbcore import grids
from reference import poisson


def matrix(cfg):
    """The host CSR pattern (laplace2d's values) the program is given."""
    csr = grids.laplace2d(int(cfg["grid"]))
    csr.sort_indices()
    return csr


def fields(cfg, P, gen, device):
    """``P`` seeded conductivity fields on the device: (ch, cv)."""
    lo, hi = (float(c) for c in cfg["coefficient_range"])
    return grids.conductivities(P, int(cfg["grid"]), lo, hi, gen, device)


def values(f):
    """The fields' stored values in ``matrix``'s CSR order: (P, nnz)."""
    return grids.poisson_values(*f)


def residual(f, i, x, b) -> float:
    """||b - A_i x|| / ||b|| under field i's operator, by the reference."""
    ch, cv = f
    return poisson.relative_residual(ch[i], cv[i], x, b)
