"""DistVector: the distributed dense vector.

PyTorch counterpart of the JAX package's ``DistVector`` (and of the
reference's ``HPCVector``): row-partitioned, stored as one stacked-shard
tensor of shape (S, L) on the backend's device — (1, L), this process's
shard, on a process group — with the padding region kept identically zero
(the padding invariant). Elementwise arithmetic and reductions are plain
tensor operations over the local shards; a reduction over them, followed
on a group by an ``all_reduce`` (``parallel/comm.py``), is the reference's
Allreduce.
"""

from __future__ import annotations

import numpy as np
import torch

from .backend import Backend, backends_compatible, resolve_dtype, torch_dtype
from .cache import cached_plan
from .hashing import partition_hash
from .parallel import comm
from .parallel.mesh import gather_to_host
from .partition import (
    nshards_of,
    padded_size,
    partition_sizes,
    shard_mask,
    uniform_partition,
    validate_partition,
)


def _mask_dev(partition: np.ndarray, L: int, backend: Backend) -> torch.Tensor:
    """Device (nlocal, L) bool validity mask of this process's shards,
    cached per (partition, L, backend)."""
    key = ("mask", partition_hash(partition), L, backend.key)
    return cached_plan("masks", key,
                       lambda: backend.shard_tensor(shard_mask(partition, L)))


def dist_norm(backend: Backend, data: torch.Tensor, p=2) -> torch.Tensor:
    """The ``p``-norm of every entry of this process's shards ``data``
    (padding zero): on a group this rank's partial (the sum of |x|^p, the
    max or min for p = ±inf, the count for p = 0) all-reduced, then the
    root."""
    a = data.reshape(-1)
    if not backend.is_dist:
        return torch.linalg.vector_norm(a, ord=p)
    if p in (np.inf, -np.inf):
        return comm.all_reduce(backend, torch.linalg.vector_norm(a, ord=p),
                               "max" if p > 0 else "min")
    if p == 0:
        return comm.all_reduce(backend, torch.linalg.vector_norm(a, ord=0))
    part = comm.all_reduce(backend, torch.linalg.vector_norm(a, ord=p) ** p)
    return part ** (1.0 / p)


def _finite_scalar(o) -> bool:
    """True when scalar-multiplying by the host number ``o`` preserves zeros:
    a non-finite scalar writes 0*inf = NaN into the padding region."""
    try:
        return bool(np.isfinite(o))
    except TypeError:
        return False


def real_part(t: torch.Tensor) -> torch.Tensor:
    """The real part as a tensor of its own (a copy, not a view)."""
    return torch.real(t).clone()


def imag_part(t: torch.Tensor) -> torch.Tensor:
    """The imaginary part; zeros for a real tensor, as numpy and JAX give."""
    return torch.imag(t).clone() if t.is_complex() else torch.zeros_like(t)


def abs2(t: torch.Tensor) -> torch.Tensor:
    """|t|^2 elementwise as real(t * conj(t)), the JAX package's arithmetic."""
    return torch.real(t * torch.conj_physical(t)).clone() if t.is_complex() \
        else t * t


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
        self.data = data  # (nlocal, L), padding zero
        if nshards_of(self.partition) != backend.nshards:
            raise ValueError(f"the partition has {nshards_of(self.partition)}"
                             f" shards, the backend {backend.nshards}")
        if data.dim() != 2 or data.shape[0] != backend.nlocal:
            raise ValueError(f"data must be (S={backend.nlocal}, L), got "
                             f"{tuple(data.shape)}")
        self._phash: str | None = None

    # -- deferred device residency ----------------------------------------
    # Solver returns stage the solution on the host and copy it to the
    # device only on first .data use; a host-only consumer (to_numpy,
    # residual checks, another solve) never pays the transfer.
    @property
    def data(self) -> torch.Tensor:
        if self._data is None:
            self._data = self.backend.shard_tensor(self._lazy_stacked)
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
        return DistVector(backend.shard_tensor(out), p, backend)

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
        data = torch.zeros((backend.nlocal, padded_size(p)),
                           dtype=torch_dtype(dtype or backend.dtype),
                           device=backend.device)
        return DistVector(data, p, backend)

    @staticmethod
    def from_local(shards, backend: Backend, dtype=None) -> "DistVector":
        """Build from per-shard local arrays, one a shard (all of them, on
        every rank of a group); the partition follows their lengths (ref:
        HPCVector_local, vectors.jl:76)."""
        shards = [np.asarray(v) for v in shards]
        p = np.concatenate([[0], np.cumsum([len(v) for v in shards])]) \
            .astype(np.int64)
        out = np.zeros((len(shards), padded_size(p)), dtype=resolve_dtype(
            backend, np.result_type(*shards), dtype))
        for s, v in enumerate(shards):
            out[s, : len(v)] = v
        return DistVector(backend.shard_tensor(out), p, backend)

    @staticmethod
    def ones(n: int, backend: Backend, partition=None, dtype=None) -> "DistVector":
        return DistVector.from_global(np.ones(n), backend, partition=partition,
                                      dtype=dtype)

    @staticmethod
    def full(n: int, value, backend: Backend, partition=None,
             dtype=None) -> "DistVector":
        return DistVector.from_global(np.full(n, value), backend,
                                      partition=partition, dtype=dtype)

    @staticmethod
    def rand(n: int, backend: Backend, partition=None, dtype=None,
             seed=0) -> "DistVector":
        """Standard normal entries from numpy's ``default_rng(seed)``: the
        JAX package's vector for the same seed."""
        return DistVector.from_global(
            np.random.default_rng(seed).standard_normal(n), backend,
            partition=partition, dtype=dtype)

    def to_numpy(self) -> np.ndarray:
        """Gather the full vector to the host (ref converter Vector(),
        HPCLinearAlgebra.jl:817-870). Returns a writable copy."""
        if self._lazy_full is not None:
            return self._lazy_full.copy()
        return self._gather()

    def to_numpy_ro(self) -> np.ndarray:
        """The full vector on the host, read-only, for callers that only
        read: cached while the device tensor is unchanged (the same tensor
        at the same version)."""
        if self._lazy_full is not None:
            self._lazy_full.setflags(write=False)   # a private copy
            return self._lazy_full
        key = (self.data, self.data._version)
        cached = getattr(self, "_host_cache", None)
        if cached is not None and cached[0] is key[0] and cached[1] == key[1]:
            return cached[2]
        arr = self._gather()
        arr.setflags(write=False)
        self._host_cache = key + (arr,)
        return arr

    def _gather(self) -> np.ndarray:
        return gather_to_host(self.data, self.partition, self.backend)

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
        return self.n != self.backend.nshards * self.L

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

    def map(self, fn, zero_preserving: bool = False) -> "DistVector":
        """Elementwise ``fn`` on the (S, L) tensor (ref: broadcasting,
        vectors.jl:1019-1226); a map that may not keep zeros re-zeroes the
        padding."""
        out = fn(self.data)
        return self._like(out if zero_preserving else self._rezero(out))

    @staticmethod
    def bmap(fn, *vs: "DistVector", zero_preserving: bool = False) -> "DistVector":
        """``fn`` over several vectors, each aligned to the first one's
        partition; the padding is re-zeroed unless ``zero_preserving``."""
        v0 = vs[0]
        out = fn(v0.data, *[v0._aligned(v).data for v in vs[1:]])
        return v0._like(out if zero_preserving else v0._rezero(out))

    def _scalar_map(self, fn, o, keeps_zero: bool = True) -> "DistVector":
        """Elementwise map with a scalar ``o``: a finite host number for
        which ``fn`` keeps zeros (``keeps_zero``) skips the re-zeroing; a
        tensor scalar (e.g. a CG step length still on the device) is never
        read back to decide it."""
        return self.map(fn, zero_preserving=keeps_zero and not isinstance(
            o, torch.Tensor) and _finite_scalar(o))

    # -- arithmetic ------------------------------------------------------------
    def __add__(self, o):
        if isinstance(o, DistVector):
            return self._like(self.data + self._aligned(o).data)
        return self.map(lambda d: d + o)

    __radd__ = __add__

    def __sub__(self, o):
        if isinstance(o, DistVector):
            return self._like(self.data - self._aligned(o).data)
        return self.map(lambda d: d - o)

    def __rsub__(self, o):
        return self.map(lambda d: o - d)

    def __mul__(self, o):
        if isinstance(o, DistVector):
            return self._like(self.data * self._aligned(o).data)
        return self._scalar_map(lambda d: d * o, o)

    __rmul__ = __mul__

    def __truediv__(self, o):
        if isinstance(o, DistVector):
            return DistVector.bmap(torch.div, self, o)   # 0 / 0 in the padding
        return self._scalar_map(lambda d: d / o, o, keeps_zero=not isinstance(
            o, torch.Tensor) and o != 0)

    def __rtruediv__(self, o):
        return self.map(lambda d: o / d)

    def __pow__(self, e):
        is_real = isinstance(e, (int, float, np.integer, np.floating))
        return self._scalar_map(lambda d: d ** e, e,
                                keeps_zero=is_real and e > 0)

    def __neg__(self):
        return self._like(-self.data)

    def __abs__(self):
        return self._like(torch.abs(self.data))

    def abs(self):
        return self.__abs__()

    def abs2(self):
        """|x|^2 elementwise, real result (ref: abs2, test_sparse_api)."""
        return self._like(abs2(self.data))

    def floor(self):
        return self._like(torch.floor(self.data))

    def ceil(self):
        return self._like(torch.ceil(self.data))

    def round(self):
        return self._like(torch.round(self.data))

    def real(self):
        return self._like(real_part(self.data))

    def imag(self):
        return self._like(imag_part(self.data))

    def conj(self):
        return self._like(torch.conj_physical(self.data))

    # -- reductions (ref: vectors.jl:758-857) ---------------------------------
    # Each reduces this process's shards, then, on a group, all-reduces the
    # partial result: a 0-d tensor on the device, the same on every rank.
    def dot(self, other: "DistVector") -> torch.Tensor:
        """conj(self)' * other, Julia ``dot`` convention (vectors.jl:798);
        a 0-d tensor on the device (no host synchronisation)."""
        o = self._aligned(other)
        dt = torch.promote_types(self.data.dtype, o.data.dtype)
        return comm.all_reduce(self.backend, torch.vdot(
            self.data.reshape(-1).to(dt), o.data.reshape(-1).to(dt)))

    def norm(self, p=2) -> torch.Tensor:
        return dist_norm(self.backend, self.data, p)

    def sum(self) -> torch.Tensor:
        return comm.all_reduce(self.backend, self.data.sum())

    def mean(self) -> torch.Tensor:
        return self.sum() / self.n

    def _filled(self, fill) -> torch.Tensor:
        """The data with the padding set to ``fill``."""
        if not self._has_padding():
            return self.data
        return torch.where(self.mask(), self.data,
                           torch.tensor(fill, dtype=self.data.dtype,
                                        device=self.data.device))

    def max(self) -> torch.Tensor:
        """The largest entry; the padding reads as -inf (the least integer)."""
        dt = self.data.dtype
        fill = -np.inf if dt.is_floating_point else torch.iinfo(dt).min
        return comm.all_reduce(self.backend, self._filled(fill).max(), "max")

    def min(self) -> torch.Tensor:
        dt = self.data.dtype
        fill = np.inf if dt.is_floating_point else torch.iinfo(dt).max
        return comm.all_reduce(self.backend, self._filled(fill).min(), "min")

    @property
    def H(self):
        """Conjugated row vector, v' (ref: adjoint handling alongside
        vectors.jl:738): ``v.H @ A`` and ``v.H @ w``."""
        from .lazy import LazyTranspose

        return LazyTranspose(self.conj())

    # -- indexing (ref indexing.jl:79, 1339, 1871) -----------------------------
    def __getitem__(self, key):
        from .ops.indexing import vector_getindex

        return vector_getindex(self, key)

    def __setitem__(self, key, value):
        from .ops.indexing import vector_setindex

        vector_setindex(self, key, value)

    def __repr__(self):
        return (f"DistVector(n={self.n}, shards={self.backend.nshards}, "
                f"dtype={self.dtype}, partition={self.partition.tolist()})")
