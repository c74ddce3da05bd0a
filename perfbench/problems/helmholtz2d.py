"""The configuration kind ``helmholtz2d``: PETSc ex11.c's damped Helmholtz
operator (``reference/helmholtz.py``) on the 5-point pattern of a ``grid``
x ``grid`` problem, one frequency and medium a pool entry, and a block of
point sources as the right-hand sides.

Pool entry p of P has ``ppw_p = lo + (hi - lo) p / (P - 1)`` points a
wavelength over ``ppw_range`` (lo, hi), so ``s_p = (2π / ppw_p)²``, and a
seeded relative squared slowness ``μ_p`` uniform in ``slowness_range`` at
every node; ``eta`` damps them all. The sources: column c is a unit
point source at grid row ``sources["row"]``, column ``first_column + c
spacing``."""

import math

import torch

from pbcore import grids
from reference import helmholtz


def matrix(cfg):
    """The host CSR pattern (laplace2d's values) the program is given."""
    csr = grids.laplace2d(int(cfg["grid"]))
    csr.sort_indices()
    return csr


def fields(cfg, P, gen, device):
    """``P`` seeded operators on the device: (s (P,) f64, μ (P, k, k) f64,
    η)."""
    f64 = torch.float64
    k = int(cfg["grid"])
    lo, hi = (float(v) for v in cfg["ppw_range"])
    p = torch.arange(P, dtype=f64, device=device)
    ppw = lo + (hi - lo) * p / max(P - 1, 1)
    s = (2 * math.pi / ppw) ** 2
    mlo, mhi = (float(v) for v in cfg["slowness_range"])
    mu = mlo + (mhi - mlo) * torch.rand((P, k, k), generator=gen, dtype=f64,
                                        device=device)
    return s, mu, float(cfg["eta"])


def values(f):
    """The operators' stored values in ``matrix``'s CSR order (sorted
    columns: i - k, i - 1, i, i + 1, i + k): (P, nnz) complex128."""
    s, mu, eta = f
    P, k = mu.shape[0], mu.shape[1]
    dev = mu.device
    d = (4 - s[:, None, None] * mu * (1 - 1j * eta)).to(torch.complex128)
    off = torch.full_like(d, -1)
    cand = torch.stack([off, off, d, off, off], dim=-1)      # (P, k, k, 5)
    iy = torch.arange(k, device=dev)[:, None]
    ix = torch.arange(k, device=dev)[None, :]
    ok = torch.stack(torch.broadcast_tensors(
        iy > 0, ix > 0, torch.ones_like(iy * ix, dtype=torch.bool),
        ix < k - 1, iy < k - 1), dim=-1)                     # (k, k, 5)
    return cand[:, ok]


def rhs(cfg, m, device):
    """The ``m`` point sources as the columns of an (n, m) complex128
    block; raises when a source falls off the grid."""
    k = int(cfg["grid"])
    src = cfg["sources"]
    iy = int(src["row"])
    ix = int(src["first_column"]) + int(src["spacing"]) * torch.arange(m)
    if not (0 <= iy < k and 0 <= int(ix.min()) and int(ix.max()) < k):
        raise ValueError(f"{m} sources at row {iy}, columns {ix.tolist()} "
                         f"do not fit a {k} x {k} grid")
    B = torch.zeros((k * k, m), dtype=torch.complex128, device=device)
    B[(iy * k + ix).to(device), torch.arange(m, device=device)] = 1
    return B


def residual(f, i, x, b) -> float:
    """The largest ||b - A_i x|| / ||b|| over the columns of x and b under
    pool entry i's operator, by the reference."""
    s, mu, eta = f
    return float(helmholtz.relative_residuals(s[i], mu[i], eta, x, b).max())
