"""Sparse addition/subtraction across (possibly mismatched) sparsity patterns.

Port of the JAX package's ``hpclinalg/ops/addition.py`` (ref: AdditionPlan,
sparse.jl:1072-1454; IdentityAdditionPlan, sparse.jl:3704-4060). The union
of the two patterns is one ``np.unique`` over (row, col) keys per shard;
its index maps are memoized by both structural hashes. Execution is two
scatter-adds into C's values. Mismatched row partitions repartition the
right operand first, so no shard reads another's rows. On a process
group the plans stay global host data and each rank uploads its own rows
of the index tables.
"""

from __future__ import annotations

import numpy as np
import torch

from ..cache import cached_plan
from ..config import round_up
from .cuda_ell import check_index


def scalar_dtype(dt: torch.dtype, *scalars) -> torch.dtype:
    """The dtype of ``dt`` values combined with host scalars (a complex
    scalar promotes a real matrix)."""
    probe = torch.empty(1, dtype=dt)
    for s in scalars:
        dt = torch.promote_types(dt, torch.result_type(probe, s))
    return dt


class AdditionPlan:
    def __init__(self, A, B):
        from ..sparse import SparseStructure, compress_cols, csr_from_rows

        stA, stB = A.structure, B.structure
        if not np.array_equal(stA.row_partition, stB.row_partition):
            raise ValueError("addition plan needs equal row partitions")
        S = A.backend.nshards
        n = A.ncols
        indptr, col_indices, colval = [], [], []
        mapsA, mapsB = [], []
        for s in range(S):
            rA, cA = stA.global_coo[s]
            rB, cB = stB.global_coo[s]
            r0 = stA.row_partition[s]
            keys = np.concatenate([(rA - r0) * n + cA, (rB - r0) * n + cB])
            uniq, inv = np.unique(keys, return_inverse=True)
            nl = len(stA.indptr[s]) - 1
            indptr.append(csr_from_rows(uniq // n, nl))
            ci, cv = compress_cols(uniq % n)
            col_indices.append(ci)
            colval.append(cv)
            inv = inv.reshape(-1)
            mapsA.append(inv[: len(rA)])
            mapsB.append(inv[len(rA):])
        self.structure = SparseStructure(stA.row_partition, stA.col_partition,
                                         indptr, col_indices, colval, A.backend)
        out_pad = self.structure.NNZpad

        # (S, NNZpad_in) maps into C's values; padding -> the drop slot
        def pack(name, maps, NNZpad_in):
            out = np.full((S, NNZpad_in), out_pad, dtype=np.int64)
            for s, m in enumerate(maps):
                out[s, : len(m)] = m
            check_index(name, out, out_pad, sentinel=out_pad)
            return A.backend.shard_tensor(out)

        self.mapA = pack("addition mapA", mapsA, stA.NNZpad)
        self.mapB = pack("addition mapB", mapsB, stB.NNZpad)


def get_addition_plan(A, B) -> AdditionPlan:
    key = (A.hash, B.hash, A.backend.key)
    return cached_plan("addition_plan", key, lambda: AdditionPlan(A, B))


def add(A, B, alpha=1, beta=1):
    """alpha*A + beta*B (ref: Base.:+/-, sparse.jl:1405/1454)."""
    from ..sparse import DistSparseMatrix

    if A.shape != B.shape:
        raise ValueError(f"shape mismatch {A.shape} vs {B.shape}")
    if not np.array_equal(A.row_partition, B.row_partition):
        B = B.repartition(A.row_partition)
    plan = get_addition_plan(A, B)
    dt = scalar_dtype(torch.promote_types(A.dtype, B.dtype), alpha, beta)
    S, NZ = A.backend.nlocal, plan.structure.NNZpad
    out = torch.zeros((S, NZ + 1), dtype=dt, device=A.nzval.device)  # +drop
    out.scatter_add_(1, plan.mapA, alpha * A.nzval.to(dt))
    out.scatter_add_(1, plan.mapB, beta * B.nzval.to(dt))
    return DistSparseMatrix(plan.structure, out[:, :NZ].contiguous(), A.backend)


def add_identity(A, lam=1.0):
    """A + lam*I (ref: IdentityAdditionPlan, sparse.jl:3704-4060). Fast path
    when every diagonal entry exists structurally: a pure value update that
    shares A's structure (and therefore every cached plan). The path is
    chosen from the global structure, the same on every rank."""
    from ..sparse import DistSparseMatrix
    from .sparse_build import speye

    if A.m != A.ncols:
        raise ValueError("A must be square")
    st = A.structure

    def build():
        pos = [np.flatnonzero(r == c) for r, c in st.global_coo]
        sizes = np.diff(st.row_partition)
        if not all(len(p) == sz for p, sz in zip(pos, sizes)):
            return None
        P = round_up(int(max((len(p) for p in pos), default=1)))
        arr = np.full((A.backend.nshards, P), st.NNZpad, dtype=np.int64)
        for s, p in enumerate(pos):
            arr[s, : len(p)] = p
        check_index("identity positions", arr, st.NNZpad, sentinel=st.NNZpad)
        return A.backend.shard_tensor(arr)

    pos = cached_plan("identity_addition_plan", (A.hash, A.backend.key), build)
    dt = scalar_dtype(A.dtype, lam)
    if pos is None:
        I = speye(A.m, A.backend, row_partition=st.row_partition,
                  col_partition=st.col_partition, dtype=dt)
        return add(A, I, 1, lam)
    S, NZ = A.backend.nlocal, st.NNZpad
    out = torch.cat([A.nzval.to(dt), A.nzval.new_zeros((S, 1), dtype=dt)], 1)
    out.scatter_add_(1, pos, torch.full(pos.shape, lam, dtype=dt,
                                        device=out.device))
    return DistSparseMatrix(st, out[:, :NZ].contiguous(), A.backend)
