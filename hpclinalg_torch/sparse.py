"""DistSparseMatrix: the distributed row-partitioned CSR sparse matrix.

PyTorch counterpart of the JAX package's ``DistSparseMatrix`` (and of the
reference's ``HPCSparseMatrix``): each shard owns a contiguous block of rows
stored as local CSR with a **compressed column space** — ``col_indices[s]``
is the sorted set of global columns present on shard s and ``colval[s]``
holds indices into it.

  * ALL structure metadata (partitions, indptr, col_indices, colval) is host
    numpy, wrapped in an immutable ``SparseStructure`` that carries the
    blake2b structural hash keying the plan caches. The arrays and the hash
    equal the JAX package's for the same input.
  * Only ``nzval`` lives on the device: one stacked (S, NNZpad) tensor,
    padding zero — (1, NNZpad), this process's rows, on a process group,
    where the structure stays global and identical on every rank. Matrices
    sharing a pattern share the structure object, so plans and symbolic
    factorizations are reused.
"""

from __future__ import annotations

import weakref
from functools import cached_property

import numpy as np
import scipy.sparse as sp
import torch

from .backend import Backend, numpy_dtype, resolve_dtype
from .config import round_up
from .hashing import partition_hash
from .parallel import comm
from .partition import (padded_size, partition_sizes, uniform_partition,
                        validate_partition)


class SparseStructure:
    """Immutable host description of a distributed CSR pattern."""

    def __init__(self, row_partition, col_partition, indptr, col_indices, colval,
                 backend: Backend):
        self.backend = backend
        self.row_partition = validate_partition(row_partition)
        self.col_partition = validate_partition(col_partition)
        self.indptr = [np.asarray(a, dtype=np.int64) for a in indptr]
        self.col_indices = [np.asarray(a, dtype=np.int64) for a in col_indices]
        self.colval = [np.asarray(a, dtype=np.int32) for a in colval]
        S = backend.nshards
        if not (len(self.indptr) == len(self.col_indices) == len(self.colval) == S):
            raise ValueError(f"structure needs one CSR block per shard ({S})")

        self.nnz_local = np.array([len(c) for c in self.colval], dtype=np.int64)
        self.nnz = int(self.nnz_local.sum())
        self.Lrow = padded_size(self.row_partition)
        self.NNZpad = round_up(int(self.nnz_local.max()) if S else 0)
        # gathered-x buffer length: >= max compressed width + 1 guaranteed-zero
        # slot that padding colval entries point to (keeps 0*inf out of SpMV)
        self.Gmax = int(max((len(c) for c in self.col_indices), default=0))
        self.Gpad = round_up(self.Gmax + 1)

    @cached_property
    def hash(self) -> str:
        from .hashing import sparse_structural_hash

        return sparse_structural_hash(self.row_partition, self.col_partition,
                                      self.indptr, self.col_indices,
                                      self.colval)

    @cached_property
    def row_ids(self) -> np.ndarray:
        """(S, NNZpad) int32 local row of each stored value; padding points
        at row Lrow, which the segment sum drops."""
        S = self.backend.nshards
        out = np.full((S, self.NNZpad), self.Lrow, dtype=np.int32)
        for s in range(S):
            nl = len(self.indptr[s]) - 1
            out[s, : self.nnz_local[s]] = np.repeat(
                np.arange(nl, dtype=np.int32), np.diff(self.indptr[s]))
        return out

    @cached_property
    def row_ids_dev(self) -> torch.Tensor:
        return self.backend.shard_tensor(self.row_ids)

    @cached_property
    def colval_dev(self) -> torch.Tensor:
        """(nlocal, NNZpad) int32 compressed column of each stored value of
        this process's shards; padding points at the guaranteed-zero slot
        of the gathered-x buffer."""
        S = self.backend.nshards
        out = np.empty((S, self.NNZpad), dtype=np.int32)
        for s in self.backend.shards:
            out[s, :] = len(self.col_indices[s])  # a zero slot < Gpad
            out[s, : self.nnz_local[s]] = self.colval[s]
        return self.backend.shard_tensor(out)

    @cached_property
    def global_coo(self) -> list[tuple[np.ndarray, np.ndarray]]:
        """Per shard: (global rows, global cols) of the stored values in
        storage order — the common currency of symbolic planning."""
        out = []
        for s in range(len(self.indptr)):
            rows = np.repeat(np.arange(len(self.indptr[s]) - 1, dtype=np.int64),
                             np.diff(self.indptr[s])) + self.row_partition[s]
            out.append((rows, self.col_indices[s][self.colval[s]]))
        return out

    @cached_property
    def nnz_mask_dev(self) -> torch.Tensor:
        """(nlocal, NNZpad) bool: True on stored values, False on padding."""
        m = np.arange(self.NNZpad)[None, :] < self.nnz_local[:, None]
        return self.backend.shard_tensor(m)

    def local_sizes(self) -> np.ndarray:
        """Rows of each shard."""
        return partition_sizes(self.row_partition)

    @property
    def shape(self):
        return (int(self.row_partition[-1]), int(self.col_partition[-1]))


def csr_from_rows(local_rows: np.ndarray, nrows: int) -> np.ndarray:
    """indptr of a CSR block whose stored values, in order, lie in the
    (sorted) local rows ``local_rows``."""
    return np.concatenate([[0], np.cumsum(np.bincount(
        local_rows, minlength=nrows))]).astype(np.int64)


def compress_cols(gcols: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(col_indices, colval): the sorted distinct global columns and each
    stored value's index into them. Up to 2^24 columns a presence bitmap
    and a rank table find them in two linear passes instead of a sort."""
    gcols = np.asarray(gcols, dtype=np.int64)
    hi = int(gcols.max()) + 1 if len(gcols) else 0
    if 0 < hi <= (1 << 24):
        present = np.zeros(hi, bool)
        present[gcols] = True
        ci = np.flatnonzero(present).astype(np.int64)
        rank = np.empty(hi, np.int32)
        rank[ci] = np.arange(len(ci), dtype=np.int32)
        return ci, rank[gcols]
    ci = np.unique(gcols)
    return ci, np.searchsorted(ci, gcols).astype(np.int32)


def _structure_from_local_csr(parts, ncols, backend, col_partition=None):
    """parts: list of (indptr, global col indices) per shard."""
    indptr, col_indices, colval = [], [], []
    sizes = []
    # flag-array compression: a presence bitmap + rank table is two linear
    # passes instead of unique+searchsorted sorts; huge column spaces take
    # the sort path
    use_flags = 0 < ncols <= (1 << 24)
    if use_flags:
        present = np.zeros(ncols, bool)
        rank = np.empty(ncols, np.int32)
    for ip, gj in parts:
        ip = np.asarray(ip, dtype=np.int64)
        gj = np.asarray(gj, dtype=np.int64)
        sizes.append(len(ip) - 1)
        if use_flags and len(gj):
            present[:] = False
            present[gj] = True
            ci = np.flatnonzero(present).astype(np.int64)
            rank[ci] = np.arange(len(ci), dtype=np.int32)
            cv = rank[gj]
        else:
            ci = np.unique(gj)
            cv = np.searchsorted(ci, gj).astype(np.int32)
        indptr.append(ip)
        col_indices.append(ci)
        colval.append(cv)
    row_partition = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)
    cp = (validate_partition(col_partition, ncols) if col_partition is not None
          else uniform_partition(ncols, backend.nshards))
    return SparseStructure(row_partition, cp, indptr, col_indices, colval, backend)


def _pad_stack_nzval(vals: list[np.ndarray], NNZpad: int, dtype) -> np.ndarray:
    out = np.zeros((len(vals), NNZpad), dtype=dtype)
    for s, v in enumerate(vals):
        out[s, : len(v)] = v
    return out


class DistSparseMatrix:
    """Distributed CSR sparse matrix (ref: HPCSparseMatrix, sparse.jl:319)."""

    __array_priority__ = 120

    def __init__(self, structure: SparseStructure, nzval: torch.Tensor,
                 backend: Backend):
        if tuple(nzval.shape) != (backend.nlocal, structure.NNZpad):
            raise ValueError(f"nzval must be {(backend.nlocal, structure.NNZpad)}"
                             f", got {tuple(nzval.shape)}")
        self.structure = structure
        self.nzval = nzval  # (nlocal, NNZpad), padding zero
        self.backend = backend
        # the materialised transpose, cached both ways (ref sparse.jl:333):
        # a matrix holds its transpose, the transpose a weakref back, so no
        # reference cycle keeps their device memory alive until the cyclic
        # garbage collector runs
        self._transpose = None
        self._issym: bool | None = None

    # -- identity / metadata -------------------------------------------------
    @property
    def cached_transpose(self) -> "DistSparseMatrix | None":
        t = self._transpose
        return t() if isinstance(t, weakref.ref) else t

    @property
    def hash(self) -> str:
        return self.structure.hash

    @property
    def row_partition(self) -> np.ndarray:
        return self.structure.row_partition

    @property
    def col_partition(self) -> np.ndarray:
        return self.structure.col_partition

    @property
    def row_partition_hash(self) -> str:
        return partition_hash(self.structure.row_partition)

    @property
    def shape(self):
        return self.structure.shape

    @property
    def m(self):
        return self.shape[0]

    @property
    def ncols(self):
        return self.shape[1]

    @property
    def dtype(self) -> torch.dtype:
        return self.nzval.dtype

    def nnz(self) -> int:
        return self.structure.nnz

    # -- constructors ----------------------------------------------------------
    @staticmethod
    def from_scipy(A, backend: Backend, row_partition=None, col_partition=None,
                   dtype=None) -> "DistSparseMatrix":
        """Build from a host scipy sparse matrix — each shard slices its rows
        (ref global ctor, sparse.jl:398-409). On a group every rank passes
        the same matrix and keeps its own rows' values."""
        A = sp.csr_matrix(A)
        A.sort_indices()
        m, n = A.shape
        rp = (validate_partition(row_partition, m) if row_partition is not None
              else uniform_partition(m, backend.nshards))
        parts, vals = [], []
        for s in range(backend.nshards):
            loc = A[int(rp[s]): int(rp[s + 1])]
            parts.append((loc.indptr.astype(np.int64), loc.indices.astype(np.int64)))
            vals.append(loc.data)
        st = _structure_from_local_csr(parts, n, backend, col_partition)
        nz = _pad_stack_nzval(vals, st.NNZpad,
                              resolve_dtype(backend, A.dtype, dtype))
        return DistSparseMatrix(st, backend.shard_tensor(nz), backend)

    @staticmethod
    def from_local_csr(parts, ncols: int, backend: Backend, col_partition=None,
                       dtype=None) -> "DistSparseMatrix":
        """Build from per-shard (indptr, global col indices, values) triples
        (ref: HPCSparseMatrix_local, sparse.jl:454-525). On a group every
        rank passes every shard's triple, since the structure is global
        host data, and keeps its own shard's values."""
        st = _structure_from_local_csr([(ip, gj) for ip, gj, _v in parts],
                                       ncols, backend, col_partition)
        return DistSparseMatrix.from_structure(
            st, [v for _ip, _gj, v in parts], dtype)

    @staticmethod
    def from_structure(st: SparseStructure, nzval_parts, dtype=None
                       ) -> "DistSparseMatrix":
        """A matrix of pattern ``st`` holding each shard's stored values
        ``nzval_parts[s]`` in storage order; on a group every rank passes
        every shard's part and keeps its own."""
        vals = [np.asarray(v) for v in nzval_parts]
        be = st.backend
        nz = _pad_stack_nzval(vals, st.NNZpad, resolve_dtype(
            be, np.result_type(*vals) if vals else be.dtype, dtype))
        return DistSparseMatrix(st, be.shard_tensor(nz), be)

    def with_values(self, nzval: torch.Tensor) -> "DistSparseMatrix":
        """Same pattern, new values — shares structure, hash, and every plan."""
        return DistSparseMatrix(self.structure, nzval, self.backend)

    def _gathered_pattern(self):
        """(indptr, indices) of the global CSR, from host metadata only."""
        st = self.structure
        indices_all = []
        indptr = np.zeros(self.m + 1, dtype=np.int64)
        rows_done = 0
        for s in range(self.backend.nshards):
            ip = st.indptr[s]
            nl = len(ip) - 1
            indptr[rows_done + 1: rows_done + nl + 1] = indptr[rows_done] + ip[1:]
            indices_all.append(st.col_indices[s][st.colval[s]]
                               if len(st.colval[s]) else np.zeros(0, np.int64))
            rows_done += nl
        indices = np.concatenate(indices_all) if indices_all else np.zeros(0, np.int64)
        return indptr, indices

    def pattern_csr(self) -> sp.csr_matrix:
        """Host CSR of the PATTERN only (data = ones; explicit zeros kept) —
        for symbolic consumers, which never read values."""
        indptr, indices = self._gathered_pattern()
        return sp.csr_matrix(
            (np.ones(len(indices), np.float32), indices, indptr),
            shape=self.shape)

    def host_values(self) -> np.ndarray:
        """Stored values in global CSR order (matches to_scipy().data). On
        a group every rank must call it: it all-gathers the values."""
        st = self.structure
        nz = comm.all_gather_rows(self.backend, self.nzval).detach().cpu() \
            .numpy()
        if not self.backend.nshards:
            return np.zeros(0, numpy_dtype(self.dtype))
        return np.concatenate([nz[s, : st.nnz_local[s]]
                               for s in range(self.backend.nshards)])

    def to_scipy(self) -> sp.csr_matrix:
        """Gather to a host scipy CSR (ref converter SparseMatrixCSC(),
        HPCLinearAlgebra.jl:871-930); a collective on a group."""
        return self.csr_with(self.host_values())

    def csr_with(self, values: np.ndarray) -> sp.csr_matrix:
        """Host CSR of this pattern holding ``values``, given in global CSR
        order as ``host_values`` returns them."""
        indptr, indices = self._gathered_pattern()
        return sp.csr_matrix((values, indices, indptr), shape=self.shape)

    def issymmetric(self) -> bool:
        """Exact symmetry of pattern and values, checked on the host."""
        if self._issym is None:
            if self.m != self.ncols:
                self._issym = False
            else:
                A = self.to_scipy()
                self._issym = (A != A.T).nnz == 0
        return self._issym

    # -- elementwise / scalar (zero-preserving; ref sparse.jl:2261-2569) -------
    def map_nonzeros(self, fn, zero_preserving: bool = True) -> "DistSparseMatrix":
        """``fn`` over the stored values (ref: map/abs/real/...,
        sparse.jl:2488-2569); a map that may not keep zeros is masked back
        to zero on the padding slots."""
        out = fn(self.nzval)
        if not zero_preserving:
            out = torch.where(self.structure.nnz_mask_dev, out,
                              torch.zeros((), dtype=out.dtype, device=out.device))
        return self.with_values(out)

    def __mul__(self, o):
        from .vector import _finite_scalar

        if isinstance(o, (int, float, complex, np.number)):
            return self.map_nonzeros(lambda v: v * o,
                                     zero_preserving=_finite_scalar(o))
        return NotImplemented

    __rmul__ = __mul__

    def __truediv__(self, o):
        from .vector import _finite_scalar

        if isinstance(o, (int, float, complex, np.number)):
            return self.map_nonzeros(lambda v: v / o,
                                     zero_preserving=_finite_scalar(o) and o != 0)
        return NotImplemented

    def __neg__(self):
        return self.map_nonzeros(torch.neg)

    def conj(self):
        return self.map_nonzeros(torch.conj_physical)

    def real(self):
        from .vector import real_part

        return self.map_nonzeros(real_part)

    def imag(self):
        from .vector import imag_part

        return self.map_nonzeros(imag_part)

    def __abs__(self):
        return self.map_nonzeros(torch.abs)

    def abs(self):
        return self.__abs__()

    def abs2(self):
        """|a|^2 on the stored values, real result (ref sparse.jl:2488-2569)."""
        from .vector import abs2

        return self.map_nonzeros(abs2)

    def floor(self):
        return self.map_nonzeros(torch.floor)

    def ceil(self):
        return self.map_nonzeros(torch.ceil)

    def round(self):
        return self.map_nonzeros(torch.round)

    # -- operators --------------------------------------------------------------
    def __matmul__(self, o):
        from .dense import DistDenseMatrix
        from .lazy import LazyTranspose
        from .ops import mixed, spgemm, spmv
        from .vector import DistVector

        if isinstance(o, DistVector):
            return spmv.matvec(self, o)
        if isinstance(o, DistDenseMatrix):
            return mixed.sparse_times_dense(self, o)
        if isinstance(o, DistSparseMatrix):
            return spgemm.spgemm(self, o)
        if isinstance(o, LazyTranspose) and isinstance(o.parent, DistSparseMatrix):
            return spgemm.spgemm(self, o.materialize())
        return NotImplemented

    def __add__(self, o):
        return self._add(o, 1)

    def __sub__(self, o):
        return self._add(o, -1)

    def _add(self, o, beta):
        """self + beta * o (ref: Base.:+/-, sparse.jl:1405/1454); a lazy
        transpose operand is materialised first."""
        from .lazy import LazyTranspose
        from .ops import addition

        if isinstance(o, LazyTranspose) and isinstance(o.parent, DistSparseMatrix):
            o = o.materialize()
        if isinstance(o, DistSparseMatrix):
            return addition.add(self, o, 1, beta)
        return NotImplemented

    def add_identity(self, lam=1.0) -> "DistSparseMatrix":
        """A + lam*I (ref: IdentityAdditionPlan, sparse.jl:3704-4060)."""
        from .ops import addition

        return addition.add_identity(self, lam)

    @property
    def T(self):
        from .lazy import LazyTranspose

        return LazyTranspose(self)

    @property
    def H(self):
        """Adjoint (conjugate transpose), lazy (ref: adjoint, sparse.jl:2261)."""
        from .lazy import LazyTranspose

        return LazyTranspose(self.conj())

    def transpose_materialized(self) -> "DistSparseMatrix":
        from .ops import transpose

        return transpose.materialize_transpose(self)

    # -- structural API (ref sparse.jl:2755-2971, 4098-4573) --------------------
    def diag(self, k: int = 0):
        from .ops import diagonal

        return diagonal.diag(self, k)

    def triu(self, k: int = 0) -> "DistSparseMatrix":
        from .ops import diagonal

        return diagonal.triu(self, k)

    def tril(self, k: int = 0) -> "DistSparseMatrix":
        from .ops import diagonal

        return diagonal.tril(self, k)

    def dropzeros(self, tol: float = 0.0) -> "DistSparseMatrix":
        from .ops import diagonal

        return diagonal.dropzeros(self, tol)

    def repartition(self, new_row_partition) -> "DistSparseMatrix":
        from .ops import sparse_repartition

        return sparse_repartition.repartition_sparse(self, new_row_partition)

    # -- reductions (ref sparse.jl:2172-2244, 2586-2723) -------------------------
    # On a group each all-reduces this process's partial result
    # (ops/reductions.py): a 0-d tensor or a DistVector, as stacked.
    def norm(self, p=2):
        """Elementwise norm of the stored values (Frobenius for p = 2)."""
        from .ops import reductions

        return reductions.norm(self, p)

    def opnorm(self, p=np.inf):
        """Induced 1- and inf-norms: the largest absolute column or row sum."""
        from .ops import reductions

        if p == np.inf:
            return reductions.row_abs_sum(self).max()
        if p == 1:
            return reductions.col_abs_sum(self).max()
        raise ValueError("opnorm supports p=1 and p=inf")

    def sum(self, axis=None):
        """The sum of all entries, or a DistVector of row sums (axis=1, on
        the row partition) or column sums (axis=0, on the column partition)."""
        from .ops import reductions

        if axis is None:
            return reductions.total(self)
        if axis == 1:
            return reductions.row_sum(self)
        if axis == 0:
            return reductions.col_sum(self)
        raise ValueError("axis must be None, 0 or 1")

    def tr(self):
        from .ops import reductions

        return reductions.trace(self)

    def maximum(self):
        """The largest entry, the implicit zeros counted (ref sparse.jl:2650)."""
        from .ops import reductions

        return reductions.maximum(self)

    def minimum(self):
        from .ops import reductions

        return reductions.minimum(self)

    def mean(self):
        """The mean over all m*n entries (ref sparse.jl:2678)."""
        from .ops import reductions

        return reductions.mean(self)

    # -- indexing (ref indexing.jl) ----------------------------------------------
    def __getitem__(self, key):
        from .ops import sparse_index

        return sparse_index.sparse_getindex(self, key)

    def __setitem__(self, key, value):
        from .ops import setindex

        setindex.sparse_setindex(self, key, value)

    def __repr__(self):
        return (f"DistSparseMatrix(shape={self.shape}, nnz={self.nnz()}, "
                f"shards={self.backend.nshards}, dtype={self.dtype})")
