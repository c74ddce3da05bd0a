"""The test matrices of the card tests and the CPU tests, made on the host
from a seed with numpy and scipy, and the ridge path's constants. Imports
nothing of the package.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp


def laplace2d(k):
    T = sp.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(k, k))
    I = sp.eye(k)
    return (sp.kron(I, T) + sp.kron(T, I)).tocsr()


def hpcg27(k):
    """HPCG's 27-point operator on a k x k x k grid: 26 on the diagonal, -1
    for each neighbour inside the grid (k^3 rows, x fastest)."""
    T = sp.diags([1.0, 1.0, 1.0], [-1, 0, 1], shape=(k, k))
    return (27.0 * sp.eye(k ** 3) - sp.kron(T, sp.kron(T, T))).tocsr()


def helmholtz(k, shift=0.5, damp=0.05):
    """laplace2d(k) - shift I + damp i I: a complex-symmetric, indefinite
    Helmholtz operator (the JAX package's tests/test_cplx.py _helmholtz)."""
    n = k * k
    return (laplace2d(k) - shift * sp.eye(n) + damp * 1j * sp.eye(n)).tocsr()


def between_eigenvalues(k, target):
    """The midpoint of the two eigenvalues of laplace2d(k) around target:
    laplace2d(k) - sigma I is then indefinite and as far from singular as
    a shift near target can make it."""
    t = 2 - 2 * np.cos(np.arange(1, k + 1) * np.pi / (k + 1))
    ev = np.sort((t[:, None] + t[None, :]).ravel())
    i = int(np.searchsorted(ev, target))
    return 0.5 * (ev[i - 1] + ev[i])


def complex_values(A, seed):
    """A copy of A (sorted indices) whose values gain seeded standard-normal
    imaginary parts: the same pattern, complex128 values."""
    A = sp.csr_matrix(A, copy=True)
    A.sort_indices()
    rng = np.random.default_rng(seed)
    return sp.csr_matrix((A.data + 1j * rng.standard_normal(A.nnz),
                          A.indices, A.indptr), shape=A.shape)


def wide_span(n):
    """Three diagonals at offsets -w, 0, w with w = 3n/10 (0.5, 2, -0.5):
    an offset span far wider than any tile of K1."""
    w = 3 * n // 10
    return sp.diags([np.full(n - w, 0.5), np.full(n, 2.0),
                     np.full(n - w, -0.5)], (-w, 0, w), format="csr")


def random_8(n, seed):
    """The random n x n, 8 entries per row matrix of bench.py."""
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(n, dtype=np.int64), 8)
    cols = rng.integers(0, n, size=n * 8)
    A = sp.csr_matrix((rng.standard_normal(n * 8), (rows, cols)), shape=(n, n))
    A.sum_duplicates()
    return A


def power_law(n, seed):
    """Zipf(2) row lengths capped at 10^4 (mean near 6): the long rows
    overflow the ELL width into the COO tail."""
    rng = np.random.default_rng(seed)
    lens = np.minimum(rng.zipf(2.0, n), 10_000)
    indptr = np.concatenate([[0], np.cumsum(lens)])
    A = sp.csr_matrix((rng.standard_normal(indptr[-1]),
                       rng.integers(0, n, indptr[-1]), indptr), shape=(n, n))
    A.sum_duplicates()
    return A


def banded_design(m, n, seed, per_row=4, half=48):
    """The ridge design matrix and right-hand side: row i holds per_row
    distinct columns drawn from [c_i - half, c_i + half] ∩ [0, n), with
    c_i = floor(i n / m), and standard-normal values; b is m standard
    normals. A local design, as in B-spline smoothing or 1-D deconvolution."""
    rng = np.random.default_rng(seed)
    c = (np.arange(m, dtype=np.int64) * n) // m
    lo = np.maximum(c - half, 0)
    width = np.minimum(c + half, n - 1) - lo + 1
    chosen = np.zeros((m, 0), np.int64)
    for j in range(per_row):
        # the r-th of the width - j columns not chosen yet
        r = rng.integers(0, width - j)
        for k in range(j):
            r += r >= chosen[:, k]
        chosen = np.sort(np.concatenate([chosen, r[:, None]], 1), axis=1)
    indptr = np.arange(0, per_row * m + 1, per_row, dtype=np.int64)
    A = sp.csr_matrix((rng.standard_normal(per_row * m),
                       (lo[:, None] + chosen).reshape(-1), indptr),
                      shape=(m, n))
    return A, rng.standard_normal(m)


# the ridge path's regularisation: N = AᵀA + RIDGE_LAMBDA I
RIDGE_LAMBDA = 1e-2
# N = A^T A + lambda I has condition number near 3 at this design (1.0e-15
# relative CG error after 50 steps at 2*10^5 x 4096 in scipy), so the CG
# iterate must equal the direct solution to this relative tolerance
RIDGE_CG_RTOL = 1e-11


def random_cols(m, n, per_row, seed):
    """m x n with per_row uniformly random columns a row (duplicates summed)."""
    rng = np.random.default_rng(seed)
    A = sp.csr_matrix((rng.standard_normal(m * per_row),
                       (np.repeat(np.arange(m), per_row),
                        rng.integers(0, n, m * per_row))), shape=(m, n))
    A.sum_duplicates()
    return A
