"""DistDenseMatrix: the distributed row-partitioned dense matrix.

PyTorch counterpart of the JAX package's ``DistDenseMatrix`` (and of the
reference's ``HPCMatrix``): each shard owns a contiguous block of rows with
all ``ncols`` columns, stored stacked as one (S, Lrow, ncols) tensor whose
padding rows stay zero; on a process group this process holds its own
shard, (1, Lrow, ncols). The products are plain ``torch.einsum``, as the
JAX package leaves them to XLA: the matvec gathers x whole
(``parallel/mesh.allgather_full``), the transpose product sums the local
partials without materialising Aᵀ (over the stack, then, on a group, one
``all_reduce``: the JAX package's psum), and the materialised transpose is
one gather of the stack, or one exchange of the column windows on a group
(``parallel/dense_transpose.py``). The reductions over rows reduce this
process's shards and all-reduce the partial result.
"""

from __future__ import annotations

import numpy as np
import torch

from .backend import Backend, resolve_dtype, torch_dtype
from .hashing import dense_structural_hash, partition_hash
from .parallel import comm
from .parallel.mesh import allgather_full, gather_to_host, scatter_from_full
from .partition import (
    nshards_of,
    padded_size,
    uniform_partition,
    validate_partition,
)


def _is_scalar(o) -> bool:
    return isinstance(o, (int, float, complex, np.number)) or (
        isinstance(o, torch.Tensor) and o.dim() == 0)


def _promoted(a: torch.Tensor, b: torch.Tensor):
    dt = torch.promote_types(a.dtype, b.dtype)
    return a.to(dt), b.to(dt)


class DistDenseMatrix:
    """Distributed dense matrix (ref: HPCMatrix, dense.jl:59)."""

    __array_priority__ = 110

    def __init__(self, data: torch.Tensor, row_partition: np.ndarray,
                 ncols: int, backend: Backend,
                 col_partition: np.ndarray | None = None):
        self.backend = backend
        self.row_partition = validate_partition(row_partition)
        self.ncols = int(ncols)
        self.data = data  # (nlocal, Lrow, ncols), padding rows zero
        self.col_partition = (validate_partition(col_partition, ncols)
                              if col_partition is not None
                              else uniform_partition(ncols, backend.nshards))
        if data.dim() != 3 or data.shape[0] != backend.nlocal \
                or data.shape[2] != self.ncols:
            raise ValueError(f"data must be (nlocal={backend.nlocal}, Lrow, "
                             f"{self.ncols}), got {tuple(data.shape)}")

    # -- metadata ---------------------------------------------------------
    @property
    def m(self) -> int:
        return int(self.row_partition[-1])

    @property
    def shape(self):
        return (self.m, self.ncols)

    @property
    def dtype(self) -> torch.dtype:
        return self.data.dtype

    @property
    def row_partition_hash(self) -> str:
        return partition_hash(self.row_partition)

    @property
    def hash(self) -> str:
        return dense_structural_hash(self.row_partition, self.ncols)

    # -- constructors -------------------------------------------------------
    @staticmethod
    def _stacked(blocks, rp, n, dtype, backend: Backend) -> np.ndarray:
        """Host (nlocal, Lrow, n) staging of this process's shards' row
        blocks (``blocks`` holds every shard's)."""
        sh = backend.shards
        out = np.zeros((len(sh), padded_size(rp), n), dtype=dtype)
        for i, s in enumerate(sh):
            out[i, : blocks[s].shape[0]] = blocks[s]
        return out

    @staticmethod
    def from_global(arr, backend: Backend, row_partition=None, dtype=None):
        """Build from a full host array (ref global ctor, dense.jl:185); on
        a group every rank passes the same array and keeps its rows."""
        arr = np.asarray(arr)
        m, n = arr.shape
        rp = (validate_partition(row_partition, m) if row_partition is not None
              else uniform_partition(m, backend.nshards))
        out = DistDenseMatrix._stacked(
            [arr[rp[s]: rp[s + 1]] for s in range(nshards_of(rp))], rp, n,
            resolve_dtype(backend, arr.dtype, dtype), backend)
        return DistDenseMatrix(backend.tensor(out), rp, n, backend)

    @staticmethod
    def from_local(shards: list[np.ndarray], backend: Backend, dtype=None):
        """Build from per-shard row blocks (ref: HPCMatrix_local,
        dense.jl:125); on a group every rank passes every shard's block
        and keeps its own."""
        shards = [np.asarray(s) for s in shards]
        sizes = [s.shape[0] for s in shards]
        rp = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)
        n = shards[0].shape[1]
        out = DistDenseMatrix._stacked(
            shards, rp, n,
            resolve_dtype(backend, np.result_type(*shards), dtype), backend)
        return DistDenseMatrix(backend.tensor(out), rp, n, backend)

    @staticmethod
    def zeros(m: int, n: int, backend: Backend, row_partition=None,
              dtype=None):
        rp = (validate_partition(row_partition, m) if row_partition is not None
              else uniform_partition(m, backend.nshards))
        data = torch.zeros((backend.nlocal, padded_size(rp), n),
                           dtype=torch_dtype(dtype or backend.dtype),
                           device=backend.device)
        return DistDenseMatrix(data, rp, n, backend)

    def to_numpy(self) -> np.ndarray:
        """Gather to the host (ref converter Matrix(),
        HPCLinearAlgebra.jl:871-930). Returns a writable copy."""
        return gather_to_host(self.data, self.row_partition, self.backend)

    # no host cache here, so the read-only and writable paths coincide
    to_numpy_ro = to_numpy

    def _like(self, data) -> "DistDenseMatrix":
        return DistDenseMatrix(data, self.row_partition, self.ncols,
                               self.backend, self.col_partition)

    def _mask3(self) -> torch.Tensor:
        from .vector import _mask_dev

        return _mask_dev(self.row_partition, self.data.shape[1],
                         self.backend)[..., None]

    # -- elementwise / scalar (ref dense.jl:1317-1346, 1818-1851) ------------
    def _check_same_shape(self, o):
        if o.shape != self.shape:
            raise ValueError(f"dimension mismatch: {self.shape} vs {o.shape}")

    def _aligned(self, o: "DistDenseMatrix") -> "DistDenseMatrix":
        self._check_same_shape(o)
        return o.repartition(self.row_partition)

    def __add__(self, o):
        if isinstance(o, DistDenseMatrix):
            return self._like(self.data + self._aligned(o).data)
        if _is_scalar(o):
            return self.map(lambda d: d + o)
        return NotImplemented

    __radd__ = __add__

    def __sub__(self, o):
        if isinstance(o, DistDenseMatrix):
            return self._like(self.data - self._aligned(o).data)
        if _is_scalar(o):
            return self.map(lambda d: d - o)
        return NotImplemented

    def __rsub__(self, o):
        if _is_scalar(o):
            return self.map(lambda d: o - d)
        return NotImplemented

    def __mul__(self, o):
        from .vector import _finite_scalar

        if _is_scalar(o):
            return self.map(lambda d: d * o,
                            zero_preserving=_finite_scalar(o))
        return NotImplemented

    __rmul__ = __mul__

    def __truediv__(self, o):
        from .vector import _finite_scalar

        if _is_scalar(o):
            return self.map(lambda d: d / o,
                            zero_preserving=_finite_scalar(o) and o != 0)
        return NotImplemented

    def __neg__(self):
        return self._like(-self.data)

    def map(self, fn, zero_preserving: bool = False) -> "DistDenseMatrix":
        """Elementwise ``fn`` over the stack; a map that may not keep zeros
        is masked back to zero on the padding rows."""
        out = fn(self.data)
        if not zero_preserving:
            out = torch.where(self._mask3(), out,
                              torch.zeros((), dtype=out.dtype,
                                          device=out.device))
        return self._like(out)

    def conj(self):
        return self._like(torch.conj_physical(self.data))

    def real(self):
        from .vector import real_part

        return self._like(real_part(self.data))

    def imag(self):
        from .vector import imag_part

        return self._like(imag_part(self.data))

    def __abs__(self):
        return self._like(torch.abs(self.data))

    # -- products (ref: DenseMatrixVectorPlan dense.jl:397-658) ----------------
    def __matmul__(self, o):
        from .lazy import LazyTranspose
        from .sparse import DistSparseMatrix
        from .vector import DistVector

        if isinstance(o, DistVector):
            return self.matvec(o)
        if isinstance(o, DistDenseMatrix):
            return self.matmat(o)
        if isinstance(o, DistSparseMatrix):
            from .ops.mixed import dense_times_sparse

            return dense_times_sparse(self, o)
        if isinstance(o, LazyTranspose) and isinstance(o.parent,
                                                       DistDenseMatrix):
            return self.matmat(o.materialize())
        return NotImplemented

    def matvec(self, x):
        from .vector import DistVector

        if len(x) != self.ncols:
            raise ValueError(f"dimension mismatch: A is {self.shape}, x has "
                             f"{len(x)}")
        xf = allgather_full(x.data, x.partition, self.backend)  # (n,)
        a, xf = _promoted(self.data, xf)
        return DistVector(torch.einsum("slc,c->sl", a, xf),
                          self.row_partition, self.backend)

    def rmatvec(self, x):
        """Aᵀ @ x without materialising Aᵀ: the partial products of the
        shards summed over the stack and, on a group, over the ranks (one
        ``all_reduce``), laid out on ``col_partition`` (ref:
        DenseTransposeVectorPlan, dense.jl:1000-1261). Not conjugating."""
        from .vector import DistVector

        if len(x) != self.m:
            raise ValueError(f"dimension mismatch: Aᵀ is "
                             f"{(self.ncols, self.m)}, x has {len(x)}")
        if not np.array_equal(x.partition, self.row_partition):
            x = x.repartition(self.row_partition)
        a, xd = _promoted(self.data, x.data)
        # padding rows are zero on both sides and add nothing
        full = comm.all_reduce(self.backend, torch.einsum("slc,sl->c", a, xd))
        return DistVector(scatter_from_full(full, self.col_partition,
                                            self.backend),
                          self.col_partition, self.backend)

    def matmat(self, B: "DistDenseMatrix") -> "DistDenseMatrix":
        if self.ncols != B.m:
            raise ValueError(f"dimension mismatch: {self.shape} @ {B.shape}")
        Bf = allgather_full(B.data, B.row_partition, self.backend)  # (n, k)
        a, Bf = _promoted(self.data, Bf)
        return DistDenseMatrix(torch.einsum("slc,ck->slk", a, Bf),
                               self.row_partition, B.ncols, self.backend)

    @property
    def T(self):
        from .lazy import LazyTranspose

        return LazyTranspose(self)

    @property
    def H(self):
        """Adjoint (ref: adjoint handling, dense.jl:952-982)."""
        from .lazy import LazyTranspose

        return LazyTranspose(self.conj())

    def transpose_materialized(self) -> "DistDenseMatrix":
        """Aᵀ laid out on ``col_partition`` (ref: DenseTransposePlan,
        dense.jl:690-978)."""
        from .parallel.dense_transpose import dense_transpose

        return dense_transpose(self)

    # -- reductions (ref dense.jl:1367-1454) ------------------------------------
    def sum(self, axis=None):
        if axis is None:
            return comm.all_reduce(self.backend, torch.sum(self.data))
        if axis == 0:
            return comm.all_reduce(self.backend,   # (ncols,)
                                   torch.sum(self.data, dim=(0, 1)))
        if axis == 1:
            from .vector import DistVector

            return DistVector(torch.sum(self.data, dim=2), self.row_partition,
                              self.backend)
        raise ValueError("axis must be None, 0 or 1")

    def norm(self, p=2):
        """Elementwise norm (Frobenius for p = 2); on a group the sum of
        |x|^p over the ranks, then the root (the max for p = inf)."""
        from .vector import dist_norm

        return dist_norm(self.backend, self.data, p)

    def opnorm(self, p=np.inf):
        a = torch.abs(self.data)
        if p == np.inf:
            return comm.all_reduce(self.backend,
                                   torch.max(torch.sum(a, dim=2)), "max")
        if p == 1:
            return torch.max(comm.all_reduce(self.backend,
                                             torch.sum(a, dim=(0, 1))))
        raise ValueError("opnorm supports p=1 and p=inf")

    def repartition(self, new_partition) -> "DistDenseMatrix":
        from .ops.repartition import repartition_dense

        return repartition_dense(self, new_partition)

    def mapslices(self, fn, axis=1):
        """``fn`` over each row (axis=1, through ``map_rows``) or each
        column (axis=0: the columns span the shards, so the matrix is
        gathered whole on its device, ``fn`` mapped over the columns, each
        returning a (kout,) slice, and the (kout, ncols) result laid out by
        rows; ref: mapslices, dense.jl:1476)."""
        from .ops.map_rows import map_rows

        if axis == 1:
            return map_rows(fn, self)
        if axis != 0:
            raise ValueError("axis must be 0 (columns) or 1 (rows)")
        full = allgather_full(self.data, self.row_partition, self.backend)
        out = torch.func.vmap(fn, in_dims=1, out_dims=1)(full)
        rp = uniform_partition(out.shape[0], self.backend.nshards)
        return DistDenseMatrix(scatter_from_full(out, rp, self.backend), rp,
                               out.shape[1], self.backend)

    def __getitem__(self, key):
        from .ops.dense_index import dense_getindex

        return dense_getindex(self, key)

    def __setitem__(self, key, value):
        from .ops.setindex import dense_setindex

        dense_setindex(self, key, value)

    def __repr__(self):
        return (f"DistDenseMatrix(shape={self.shape}, shards="
                f"{self.backend.nshards}, dtype={self.dtype})")
