"""DistVector: the distributed dense vector.

PyTorch counterpart of the JAX package's ``DistVector`` (and of the
reference's ``HPCVector``): row-partitioned, stored as one stacked-shard
tensor of shape (S, L) on the backend's device, with the padding region
kept identically zero (the padding invariant). Elementwise arithmetic and
reductions are plain tensor operations over the whole stack; a reduction
over (S, L) is the reference's Allreduce.
"""

from __future__ import annotations

import numpy as np
import torch

from .backend import Backend, backends_compatible, resolve_dtype, torch_dtype
from .cache import cached_plan
from .hashing import partition_hash
from .partition import (
    nshards_of,
    padded_size,
    partition_sizes,
    shard_mask,
    uniform_partition,
    validate_partition,
)


def _mask_dev(partition: np.ndarray, L: int, backend: Backend) -> torch.Tensor:
    """Device (S, L) bool validity mask, cached per (partition, L, backend)."""
    key = ("mask", partition_hash(partition), L, backend.key)
    return cached_plan("masks", key,
                       lambda: backend.tensor(shard_mask(partition, L)))


def _finite_scalar(o) -> bool:
    """True when scalar-multiplying by the host number ``o`` preserves zeros:
    a non-finite scalar writes 0*inf = NaN into the padding region."""
    try:
        return bool(np.isfinite(o))
    except TypeError:
        return False


def _stack(arr: np.ndarray, p: np.ndarray, dtype) -> np.ndarray:
    """Host (S, L) staging of a global array under partition ``p``."""
    L = padded_size(p)
    out = np.zeros((nshards_of(p), L), dtype=dtype)
    sizes = partition_sizes(p)
    for s in range(len(sizes)):
        out[s, : sizes[s]] = arr[p[s]: p[s + 1]]
    return out


class DistVector:
    """Distributed dense vector (ref: HPCVector, vectors.jl:21)."""

    __array_priority__ = 100  # beat numpy in mixed operators

    def __init__(self, data: torch.Tensor, partition: np.ndarray,
                 backend: Backend):
        self.backend = backend
        self.partition = validate_partition(partition)
        self._lazy_stacked = None
        self._lazy_full = None
        self.data = data  # (S, L), padding zero
        if data.dim() != 2 or data.shape[0] != backend.nshards:
            raise ValueError(f"data must be (S={backend.nshards}, L), got "
                             f"{tuple(data.shape)}")
        self._phash: str | None = None

    # -- deferred device residency ----------------------------------------
    # Solver returns stage the solution on the host and copy it to the
    # device only on first .data use; a host-only consumer (to_numpy,
    # residual checks, another solve) never pays the transfer.
    @property
    def data(self) -> torch.Tensor:
        if self._data is None:
            self._data = self.backend.tensor(self._lazy_stacked)
            self._lazy_stacked = None  # _lazy_full stays valid (private copy)
        return self._data

    @data.setter
    def data(self, value):
        self._data = value
        if value is not None:
            self._lazy_stacked = None
            self._lazy_full = None

    # -- identity ----------------------------------------------------------
    @property
    def partition_hash(self) -> str:
        if self._phash is None:
            self._phash = partition_hash(self.partition)
        return self._phash

    @property
    def n(self) -> int:
        return int(self.partition[-1])

    def __len__(self) -> int:
        return self.n

    @property
    def shape(self):
        return (self.n,)

    @property
    def dtype(self) -> torch.dtype:
        if self._data is not None:
            return self._data.dtype
        return torch_dtype(self._lazy_stacked.dtype)

    @property
    def L(self) -> int:
        src = self._data if self._data is not None else self._lazy_stacked
        return int(src.shape[1])

    # -- constructors --------------------------------------------------------
    @staticmethod
    def from_global(arr, backend: Backend, partition: np.ndarray | None = None,
                    dtype=None) -> "DistVector":
        """Build from a full host array (ref global ctor, vectors.jl:119)."""
        arr = np.asarray(arr)
        p = validate_partition(partition, arr.shape[0]) if partition is not None \
            else uniform_partition(arr.shape[0], backend.nshards)
        out = _stack(arr, p, resolve_dtype(backend, arr.dtype, dtype))
        return DistVector(backend.tensor(out), p, backend)

    @staticmethod
    def from_global_deferred(arr, backend: Backend,
                             partition: np.ndarray | None = None,
                             dtype=None) -> "DistVector":
        """from_global with DEFERRED device residency: the (S, L) staging
        stays on the host and is copied by the first ``.data`` access. The
        vector keeps a private copy of ``arr``; the caller's array is left
        as it was (writable)."""
        arr = np.asarray(arr)
        p = validate_partition(partition, arr.shape[0]) if partition is not None \
            else uniform_partition(arr.shape[0], backend.nshards)
        dt = resolve_dtype(backend, arr.dtype, dtype)
        v = object.__new__(DistVector)
        v.backend = backend
        v.partition = p
        v._phash = None
        v._data = None
        v._lazy_stacked = _stack(arr, p, dt)
        v._lazy_full = arr.astype(dt, copy=True)
        return v

    @staticmethod
    def zeros(n: int, backend: Backend, partition=None, dtype=None) -> "DistVector":
        p = validate_partition(partition, n) if partition is not None \
            else uniform_partition(n, backend.nshards)
        data = torch.zeros((nshards_of(p), padded_size(p)),
                           dtype=torch_dtype(dtype or backend.dtype),
                           device=backend.device)
        return DistVector(data, p, backend)

    def to_numpy(self) -> np.ndarray:
        """Gather the full vector to the host (ref converter Vector(),
        HPCLinearAlgebra.jl:817-870). Returns a writable copy."""
        if self._lazy_full is not None:
            return self._lazy_full.copy()
        host = self.data.detach().cpu().numpy()
        sizes = partition_sizes(self.partition)
        return np.concatenate([host[s, : sizes[s]] for s in range(len(sizes))])

    @staticmethod
    def _wrap(data: torch.Tensor, partition: np.ndarray, backend: Backend,
              phash: str | None = None) -> "DistVector":
        """Internal constructor for results on an already validated
        partition: skips the checks, which dominate the host time of small
        vector operations in an iterative solver."""
        v = object.__new__(DistVector)
        v.backend, v.partition, v._phash = backend, partition, phash
        v._data, v._lazy_stacked, v._lazy_full = data, None, None
        return v

    # -- helpers -------------------------------------------------------------
    def _like(self, data) -> "DistVector":
        return DistVector._wrap(data, self.partition, self.backend, self._phash)

    def _has_padding(self) -> bool:
        return self.n != self.data.numel()

    def mask(self) -> torch.Tensor:
        return _mask_dev(self.partition, self.L, self.backend)

    def _rezero(self, out: torch.Tensor) -> torch.Tensor:
        """Restore the padding invariant after a map that may not preserve
        zeros; free when the partition leaves no padding slots."""
        if not self._has_padding():
            return out
        return torch.where(self.mask(), out, torch.zeros((), dtype=out.dtype,
                                                         device=out.device))

    def _aligned(self, other: "DistVector") -> "DistVector":
        """``other`` on this vector's partition: binary operations align a
        mismatched right operand by repartitioning it."""
        if not backends_compatible(self.backend, other.backend):
            raise ValueError("incompatible backends")
        if other.partition_hash == self.partition_hash:
            return other
        return other.repartition(self.partition)

    def repartition(self, new_partition: np.ndarray) -> "DistVector":
        """Ref: repartition(v, partition) (vectors.jl:712)."""
        from .ops.repartition import repartition_vector

        return repartition_vector(self, new_partition)

    @property
    def T(self):
        """Lazy row vector: ``v.T @ w`` and ``v.T @ A`` (ref vectors.jl:738)."""
        from .lazy import LazyTranspose

        return LazyTranspose(self)

    def _scalar_map(self, fn, o) -> "DistVector":
        """Elementwise map with a scalar: a host number that keeps zeros
        skips the re-zeroing; a tensor scalar (e.g. a CG step length still
        on the device) is never read back to decide it."""
        out = fn(self.data)
        if isinstance(o, torch.Tensor) or not _finite_scalar(o):
            out = self._rezero(out)
        return self._like(out)

    # -- arithmetic ------------------------------------------------------------
    def __add__(self, o):
        if isinstance(o, DistVector):
            return self._like(self.data + self._aligned(o).data)
        return self._like(self._rezero(self.data + o))

    __radd__ = __add__

    def __sub__(self, o):
        if isinstance(o, DistVector):
            return self._like(self.data - self._aligned(o).data)
        return self._like(self._rezero(self.data - o))

    def __rsub__(self, o):
        return self._like(self._rezero(o - self.data))

    def __mul__(self, o):
        if isinstance(o, DistVector):
            return self._like(self.data * self._aligned(o).data)
        return self._scalar_map(lambda d: d * o, o)

    __rmul__ = __mul__

    def __neg__(self):
        return self._like(-self.data)

    # -- reductions (ref: vectors.jl:758-857) ---------------------------------
    def dot(self, other: "DistVector") -> torch.Tensor:
        """conj(self)' * other, Julia ``dot`` convention (vectors.jl:798);
        a 0-d tensor on the device (no host synchronisation)."""
        o = self._aligned(other)
        dt = torch.promote_types(self.data.dtype, o.data.dtype)
        return torch.vdot(self.data.reshape(-1).to(dt),
                          o.data.reshape(-1).to(dt))

    def norm(self, p=2) -> torch.Tensor:
        return torch.linalg.vector_norm(self.data.reshape(-1), ord=p)

    def __repr__(self):
        return (f"DistVector(n={self.n}, shards={self.backend.nshards}, "
                f"dtype={self.dtype}, partition={self.partition.tolist()})")
