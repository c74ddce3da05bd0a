"""Carry container state over from the JAX package.

For this system the "weights" are the matrix and the vectors. These
constructors take the JAX containers' state as numpy arrays (the caller
does ``np.asarray(...)`` on the JAX side) and build the port's containers
from it without recomputing anything: the stacked data, partitions and
compressed-column structure are taken as they are. No JAX import is needed.
The solver selection of the JAX container's backend (``solver=``) carries
over too, so both sides route ``lu``/``ldlt``/``solve`` to the same engine.
The JAX package's split-plane complex containers (``ComplexDistVector``,
``ComplexDistSparseMatrix``: a (re, im) pair of real containers sharing
one partition or structure) become one native complex container,
re + i·im, complex64 from f32 planes and complex128 from f64 ones.
"""

from __future__ import annotations

from dataclasses import replace

import numpy as np

from ..backend import Backend
from ..dense import DistDenseMatrix
from ..sparse import DistSparseMatrix, SparseStructure
from ..vector import DistVector


def _planes(re, im) -> np.ndarray:
    """re + i·im of two real planes, complex64 from f32 and complex128
    from f64."""
    re, im = np.asarray(re), np.asarray(im)
    out = np.empty(re.shape, np.complex64 if re.dtype.itemsize <= 4
                   else np.complex128)
    out.real, out.imag = re, im
    return out


def _reference_state(ref) -> dict:
    """The keyword arguments of ``from_reference`` for a container of the
    JAX package — any DistVector, DistDenseMatrix or DistSparseMatrix,
    including one produced by its transpose, addition, SpGEMM or SpMM
    plans, and the split-plane ``ComplexDistVector`` and
    ``ComplexDistSparseMatrix`` (their ``re`` and ``im`` planes) — read by
    duck typing: its device arrays go through ``np.asarray`` and its host
    structure arrays are taken as they are, so the structure and its hash
    carry over."""
    planes = hasattr(ref, "re") and hasattr(ref, "im")
    st = getattr(ref, "structure", None)
    if planes and st is None:
        return dict(data=_planes(ref.re.data, ref.im.data),
                    partition=np.asarray(ref.partition))
    if planes:
        nzval = _planes(ref.re.nzval, ref.im.nzval)
    elif st is None and hasattr(ref, "row_partition"):
        return dict(data=np.asarray(ref.data),
                    row_partition=np.asarray(ref.row_partition),
                    col_partition=np.asarray(ref.col_partition))
    elif st is None:
        return dict(data=np.asarray(ref.data), partition=np.asarray(ref.partition))
    else:
        nzval = np.asarray(ref.nzval)
    return dict(nzval=nzval, indptr=st.indptr,
                colval=st.colval, col_indices=st.col_indices,
                row_partition=st.row_partition,
                col_partition=st.col_partition, ncols=ref.shape[1])


def from_reference(backend: Backend, ref=None, *, data=None, partition=None,
                   nzval=None, indptr=None, colval=None, col_indices=None,
                   row_partition=None, col_partition=None, ncols=None):
    """The port's container for a JAX package container ``ref`` (see
    ``_reference_state``), or a DistVector from ``data`` (S, L) and
    ``partition``, or a DistDenseMatrix from ``data`` (S, Lrow, ncols),
    ``row_partition`` and optionally ``col_partition``, or a
    DistSparseMatrix from ``nzval`` (S, NNZpad) and the SparseStructure
    arrays (per-shard ``indptr``, ``colval``, ``col_indices``, the two
    partitions and ``ncols``). A container carried over from ``ref`` lives
    on ``backend`` with the solver of ``ref``'s backend ("multifrontal" or
    "device"); on a process group each rank keeps its own shard of the
    stacked data."""
    if ref is not None:
        solver = getattr(getattr(ref, "backend", None), "solver",
                         backend.solver)
        return from_reference(replace(backend, solver=solver),
                              **_reference_state(ref))
    if data is not None and np.ndim(data) == 3:
        if row_partition is None:
            raise ValueError("a dense matrix needs its row partition")
        data = np.asarray(data)
        return DistDenseMatrix(backend.shard_tensor(data),
                               np.asarray(row_partition),
                               data.shape[2], backend,
                               col_partition=col_partition)
    if data is not None:
        if partition is None:
            raise ValueError("a vector needs its partition")
        return DistVector(backend.shard_tensor(data),
                          np.asarray(partition), backend)
    if any(a is None for a in (nzval, indptr, colval, col_indices,
                               row_partition, col_partition)):
        raise ValueError("a matrix needs nzval and every structure array")
    st = SparseStructure(row_partition, col_partition, indptr, col_indices,
                         colval, backend)
    if ncols is not None and st.shape[1] != int(ncols):
        raise ValueError(f"ncols {ncols} != column partition end {st.shape[1]}")
    return DistSparseMatrix(st, backend.shard_tensor(nzval), backend)


def to_backend(x, backend: Backend):
    """A copy of a distributed container on another Backend: another
    device, shard count, dtype (the target backend's dtype) or process
    group, on the uniform partition of the target's shard count, as the
    JAX package's ``to_backend`` gives. Vectors and dense matrices move
    gathered whole from device to device (an all-gather from a group; a
    group rank keeps its own shard); a sparse matrix's structure is rebuilt
    on the host, where it lives, and its values go with it."""
    from ..backend import torch_dtype
    from ..parallel.mesh import allgather_full, scatter_from_full
    from ..partition import uniform_partition

    dt = torch_dtype(backend.dtype)
    if isinstance(x, DistVector):
        full = allgather_full(x.data, x.partition, x.backend)
        p = uniform_partition(x.n, backend.nshards)
        return DistVector(scatter_from_full(full.to(backend.device, dt), p,
                                            backend), p, backend)
    if isinstance(x, DistDenseMatrix):
        full = allgather_full(x.data, x.row_partition, x.backend)
        p = uniform_partition(x.m, backend.nshards)
        return DistDenseMatrix(scatter_from_full(full.to(backend.device, dt),
                                                 p, backend),
                               p, x.ncols, backend)
    if isinstance(x, DistSparseMatrix):
        return DistSparseMatrix.from_scipy(x.to_scipy(), backend,
                                           dtype=backend.dtype)
    raise TypeError(f"cannot convert {type(x)} between backends")


def comm_size(backend: Backend) -> int:
    """The shard count: the world size on a process group, the analogue
    of it stacked (ref: comm_size)."""
    return backend.nshards


def comm_rank() -> int:
    """This process's rank: the ``torch.distributed`` rank when a process
    group is up, else 0 (ref: comm_rank)."""
    from .io import process_rank

    return process_rank()


SOLVER_CACHES = ("symbolic", "solver_perm", "backslash", "device_mf")


def clear_solver_caches() -> None:
    """Drop the cached symbolic analyses, backslash factorizations and
    device solver plans (ref: clear_mumps_analysis_cache!,
    mumps_factorization.jl:68-88)."""
    from ..cache import clear_plan_cache

    for name in SOLVER_CACHES:
        clear_plan_cache(name)
