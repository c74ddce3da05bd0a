"""Sparse constructors: speye, spdiagm, spzeros, distributed random matrices.

Port of the JAX package's ``hpclinalg/ops/sparse_build.py`` (ref: spdiagm
family, sparse.jl:3304-3605, with the cached-structure path for the main
diagonal, sparse.jl:3544 and HPCLinearAlgebra.jl:150-156). Every
structure is built from global host data and the seed, so on a process
group no builder communicates: each rank builds the same structure and
keeps its own shard's values (a diagonal's values move from its vector
by an ExchangePlan).
"""

from __future__ import annotations

import numpy as np
import torch

from ..cache import cached_plan
from ..hashing import partition_hash
from ..partition import global_to_local, uniform_partition, validate_partition
from ..parallel.exchange import ExchangePlan


def speye(n: int, backend, row_partition=None, col_partition=None, dtype=None):
    """Identity matrix with the given row partition."""
    from ..sparse import DistSparseMatrix

    rp = (validate_partition(row_partition, n) if row_partition is not None
          else uniform_partition(n, backend.nshards))
    parts = []
    for s in range(backend.nshards):
        nl = int(rp[s + 1] - rp[s])
        parts.append((np.arange(nl + 1, dtype=np.int64),
                      np.arange(rp[s], rp[s + 1], dtype=np.int64), np.ones(nl)))
    return DistSparseMatrix.from_local_csr(parts, n, backend,
                                           col_partition=col_partition,
                                           dtype=dtype)


def spdiagm(*diags, m: int | None = None, n: int | None = None, backend=None):
    """spdiagm(k1 => v1, k2 => v2, ...) analogue: pass (k, DistVector) pairs
    (ref sparse.jl:3304/3439); a bare DistVector is the main diagonal.
    Without an explicit size the result is square and just large enough to
    hold every diagonal, as Julia's."""
    from ..vector import DistVector

    pairs = []
    for d in diags:
        if isinstance(d, DistVector):
            pairs.append((0, d))
        else:
            k, v = d
            pairs.append((int(k), v))
    if backend is None:
        backend = pairs[0][1].backend
    need = max(len(v) + abs(k) for k, v in pairs)
    m = m if m is not None else need
    n = n if n is not None else need
    if len(pairs) == 1 and pairs[0][0] == 0 and m == n == len(pairs[0][1]):
        return build_diag(pairs[0][1], m)
    return _spdiagm_device(pairs, m, n, backend)


def _spdiagm_device(pairs, m: int, n: int, backend):
    """Multi-offset spdiagm: the index-only structure is cached per (shape,
    offsets, lengths, partitions); the values never touch the host — each
    diagonal's vector data is scattered into the output values by a cached
    ExchangePlan. Repeated offsets sum, as in Julia."""
    from ..sparse import DistSparseMatrix, SparseStructure, compress_cols, \
        csr_from_rows

    S = backend.nshards
    rp = uniform_partition(m, S)
    sig = tuple((k, len(v), partition_hash(v.partition)) for k, v in pairs)

    def build():
        # per-diagonal global (row, col, diagonal id, source index)
        rows_all, cols_all, diag_id, src_i = [], [], [], []
        for di, (k, v) in enumerate(pairs):
            i = np.arange(len(v), dtype=np.int64)
            r, c = i + max(0, -k), i + max(0, k)
            keep = (r < m) & (c < n)
            rows_all.append(r[keep])
            cols_all.append(c[keep])
            diag_id.append(np.full(int(keep.sum()), di, np.int64))
            src_i.append(i[keep])
        rows, cols = np.concatenate(rows_all), np.concatenate(cols_all)
        dids, srci = np.concatenate(diag_id), np.concatenate(src_i)
        order = np.lexsort((cols, rows))
        rows, cols, dids, srci = rows[order], cols[order], dids[order], srci[order]
        # duplicates (repeated offsets) share one slot
        new = np.ones(len(rows), bool)
        new[1:] = (np.diff(rows) != 0) | (np.diff(cols) != 0)
        upos = np.cumsum(new) - 1          # entry -> unique slot (global order)
        urows, ucols = rows[new], cols[new]

        indptr, col_indices, colval, base = [], [], [], []
        for s in range(S):
            lo, hi = np.searchsorted(urows, [rp[s], rp[s + 1]])
            base.append(lo)
            indptr.append(csr_from_rows(urows[lo:hi] - rp[s],
                                        int(rp[s + 1] - rp[s])))
            ci, cv = compress_cols(ucols[lo:hi])
            col_indices.append(ci)
            colval.append(cv)
        st = SparseStructure(rp, uniform_partition(n, S), indptr,
                             col_indices, colval, backend)

        # one ExchangePlan per diagonal: v's local slots -> the value slots
        # of the owning output shard
        plans = []
        owners_u, _ = global_to_local(rp, urows)
        base = np.asarray(base)
        for di, (k, v) in enumerate(pairs):
            mask = dids == di
            gpos = upos[mask]
            d_sh = owners_u[gpos]
            d_slot = gpos - base[d_sh]
            s_sh, s_slot = global_to_local(v.partition, srci[mask])
            send = [[np.zeros(0, np.int64) for _ in range(S)] for _ in range(S)]
            recv = [[np.zeros(0, np.int64) for _ in range(S)] for _ in range(S)]
            for ss in range(S):
                for dd in range(S):
                    mm = (s_sh == ss) & (d_sh == dd)
                    if mm.any():
                        send[ss][dd] = s_slot[mm]
                        recv[dd][ss] = d_slot[mm]
            plans.append(ExchangePlan(backend, send, recv, st.NNZpad))
        return st, plans

    st, plans = cached_plan("spdiagm_structure", (m, n, sig, backend.key), build)
    dt = pairs[0][1].dtype
    for _k, v in pairs[1:]:
        dt = torch.promote_types(dt, v.dtype)
    nz = torch.zeros((backend.nlocal, st.NNZpad), dtype=dt,
                     device=backend.device)
    for (_k, v), plan in zip(pairs, plans):
        nz = plan.apply(v.data.to(dt), base=nz, add=True)
    return DistSparseMatrix(st, nz, backend)


def build_diag(v, n: int):
    """Diagonal matrix from a distributed vector without a host round trip:
    the structure depends only on the partition, so it is cached (ref:
    _diag_structure_cache, HPCLinearAlgebra.jl:150-156), and the values are
    v's own slots, cut or zero-padded to the value width."""
    from ..sparse import DistSparseMatrix, SparseStructure
    from .cuda_dia import pad_trunc

    backend, p = v.backend, v.partition

    def build():
        indptr, col_indices, colval = [], [], []
        for s in range(backend.nshards):
            nl = int(p[s + 1] - p[s])
            indptr.append(np.arange(nl + 1, dtype=np.int64))
            col_indices.append(np.arange(p[s], p[s + 1], dtype=np.int64))
            colval.append(np.arange(nl, dtype=np.int32))
        return SparseStructure(p, p, indptr, col_indices, colval, backend)

    st = cached_plan("diag_structure", (partition_hash(p), backend.key), build)
    return DistSparseMatrix(st, pad_trunc(v.data, st.NNZpad).contiguous(),
                            backend)


def spzeros(m: int, n: int, backend, row_partition=None, dtype=None):
    """All-zero sparse matrix (ref: HPCLinearAlgebra.jl:1430-1467)."""
    from ..sparse import DistSparseMatrix

    rp = (validate_partition(row_partition, m) if row_partition is not None
          else uniform_partition(m, backend.nshards))
    parts = [(np.zeros(int(rp[s + 1] - rp[s]) + 1, dtype=np.int64),
              np.zeros(0, np.int64), np.zeros(0))
             for s in range(backend.nshards)]
    return DistSparseMatrix.from_local_csr(parts, n, backend, dtype=dtype)


def sprand_dist(m: int, n: int, density: float, backend, dtype=None,
                seed: int = 0):
    """Distributed random sparse matrix; the pattern and values are numpy's
    for ``seed``, the same as the JAX package's (and on every rank of a
    group)."""
    import scipy.sparse as sp

    from ..sparse import DistSparseMatrix

    A = sp.random(m, n, density, format="csr",
                  random_state=np.random.default_rng(seed))
    return DistSparseMatrix.from_scipy(A, backend, dtype=dtype)
