"""Input generators: the configurations' matrices on the host, made with
numpy index arithmetic, and their seeded values and right-hand sides on the
device. Nothing here imports the program.

``laplace2d`` is a copy of the program's ``tools/matrices.py`` function of
the same name (which imports nothing of the package either).
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import torch


def laplace2d(k):
    T = sp.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(k, k))
    I = sp.eye(k)
    return (sp.kron(I, T) + sp.kron(T, I)).tocsr()


def hpcg27(dims) -> sp.csr_matrix:
    """HPCG 3.1's 27-point operator on the grid ``dims`` = (nx, ny, nz) as a
    CSR matrix with sorted columns: 26 on the diagonal, -1 for each
    neighbour inside the grid, rows ordered with x fastest. Built from the
    27 offsets at once (no ``kron``), in int32 while n allows."""
    nx, ny, nz = (int(d) for d in dims)
    n = nx * ny * nz
    it = np.int32 if 27 * n < 2 ** 31 else np.int64
    row = np.arange(n, dtype=it)
    ix = row % nx
    iy = (row // nx) % ny
    iz = row // (nx * ny)
    # the offsets in increasing column order: dz, then dy, then dx
    cols = np.empty((n, 27), dtype=it)
    ok = np.empty((n, 27), dtype=bool)
    j = 0
    for dz in (-1, 0, 1):
        okz = (iz + dz >= 0) & (iz + dz < nz)
        for dy in (-1, 0, 1):
            okzy = okz & (iy + dy >= 0) & (iy + dy < ny)
            for dx in (-1, 0, 1):
                ok[:, j] = okzy & (ix + dx >= 0) & (ix + dx < nx)
                cols[:, j] = row + (dz * ny + dy) * nx + dx
                j += 1
    del ix, iy, iz
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(ok.sum(axis=1), out=indptr[1:])
    indices = cols[ok]
    del cols
    data = np.full(indices.shape[0], -1.0)
    data[indptr[:-1] + ok[:, :13].sum(axis=1)] = 26.0
    A = sp.csr_matrix((data, indices, indptr), shape=(n, n))
    A.has_sorted_indices = True
    return A


def conductivities(P: int, k: int, lo: float, hi: float, gen: torch.Generator,
                   device) -> tuple[torch.Tensor, torch.Tensor]:
    """``P`` seeded sets of edge conductivities, uniform in [lo, hi], in
    f64 on the device: ch (P, k, k + 1) and cv (P, k + 1, k), in that order
    from ``gen`` (``reference/poisson.py`` says which edge is which)."""
    f64 = torch.float64
    ch = torch.rand((P, k, k + 1), generator=gen, dtype=f64, device=device)
    cv = torch.rand((P, k + 1, k), generator=gen, dtype=f64, device=device)
    return lo + (hi - lo) * ch, lo + (hi - lo) * cv


def poisson_values(ch: torch.Tensor, cv: torch.Tensor) -> torch.Tensor:
    """The stored values of the variable-coefficient operator in the CSR
    order of ``laplace2d(k)`` (sorted columns: i - k, i - 1, i, i + 1,
    i + k): (P, nnz), from ``conductivities``' (P, k, k + 1) and
    (P, k + 1, k)."""
    P, k = ch.shape[0], ch.shape[1]
    d = ch[:, :, :-1] + ch[:, :, 1:] + cv[:, :-1, :] + cv[:, 1:, :]
    cand = torch.stack([-cv[:, :-1, :], -ch[:, :, :-1], d, -ch[:, :, 1:],
                        -cv[:, 1:, :]], dim=-1)             # (P, k, k, 5)
    iy = torch.arange(k, device=ch.device)[:, None]
    ix = torch.arange(k, device=ch.device)[None, :]
    ok = torch.stack(torch.broadcast_tensors(
        iy > 0, ix > 0, torch.ones_like(iy * ix, dtype=torch.bool),
        ix < k - 1, iy < k - 1), dim=-1)                    # (k, k, 5)
    return cand[:, ok]


def local_rows(v: torch.Tensor, row_partition, lrow: int, shards) -> torch.Tensor:
    """The program's shard layout of global vectors v (..., n): the rows of
    each shard in ``shards`` (a range), zero-padded to ``lrow``:
    (..., len(shards), lrow)."""
    out = v.new_zeros(v.shape[:-1] + (len(shards), lrow))
    for i, s in enumerate(shards):
        r0, r1 = int(row_partition[s]), int(row_partition[s + 1])
        out[..., i, : r1 - r0] = v[..., r0:r1]
    return out


def local_values(v: torch.Tensor, indptr, row_partition, nnzpad: int,
                 shards) -> torch.Tensor:
    """The program's stored-value layout of global CSR values v (..., nnz):
    the entries of each shard's rows, zero-padded to ``nnzpad``."""
    out = v.new_zeros(v.shape[:-1] + (len(shards), nnzpad))
    for i, s in enumerate(shards):
        a = int(indptr[int(row_partition[s])])
        b = int(indptr[int(row_partition[s + 1])])
        out[..., i, : b - a] = v[..., a:b]
    return out
