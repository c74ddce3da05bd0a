"""Mixed sparse × dense products.

Port of the JAX package's ``hpclinalg/ops/mixed.py`` (ref:
sparse.jl:2391-2424, 3617-3689; dense.jl:1286-1308, column by column
there). ``A @ B`` with a sparse A and a dense B is SpMV with (k,) row
payloads: the SpMV plan of A for an x on B's row partition, whose exchange
moves B's rows whole, and the plan's engine widened to k columns — the DIA
stencil, the densified block (``torch.bmm``), the ELL table with its COO
tail, or the segment sum. The engines are plain PyTorch, as the JAX
package leaves them to XLA. ``D @ A`` with a dense D scatters A's values
into a dense block and multiplies once, or goes through transposes when
that block would be too large.
"""

from __future__ import annotations

import numpy as np
import torch

from ..cache import cached_plan
from .cuda_ell import check_index
from .spmv import (_dense_block, _dia_values, _ell_spmm_apply, _pad_rows,
                   gathered, get_spmm_plan)


def _dia_spmm(dval, g, offsets, bias_lo: int, bias_hi: int,
              pad_to: int = 0) -> torch.Tensor:
    """C[s, r, :] = Σ_t dval[s, t, r] · gp[s, bias_lo + off_t + r, :], with
    ``g`` cut or zero-padded to ``pad_to`` slots and zero-padded by
    ``bias_lo``/``bias_hi``: the multi-column stencil, free of gathers."""
    if pad_to:
        g = _pad_rows(g, pad_to)[:, :pad_to]
    dt = torch.promote_types(dval.dtype, g.dtype)
    dval, g = dval.to(dt), g.to(dt)
    S, G, k = g.shape
    Lrow = dval.shape[2]
    gp = g
    if bias_lo or bias_hi:
        gp = g.new_zeros((S, bias_lo + G + bias_hi, k))
        gp[:, bias_lo: bias_lo + G] = g
    C = torch.zeros((S, Lrow, k), dtype=dt, device=g.device)
    for i, o in enumerate(offsets):
        C += dval[:, i, :, None] * gp[:, bias_lo + o: bias_lo + o + Lrow]
    return C


def _segment_spmm(A, g: torch.Tensor) -> torch.Tensor:
    """Gather + segment sum over the stored values, for patterns no other
    engine takes (no stored entries)."""
    st = A.structure
    S, G, k = g.shape
    dt = torch.promote_types(A.nzval.dtype, g.dtype)
    off = torch.arange(S, device=g.device)[:, None]
    rows = g.to(dt).reshape(S * G, k).index_select(
        0, (st.colval_dev.long() + off * G).reshape(-1))
    contrib = A.nzval.to(dt).reshape(-1, 1) * rows
    C = contrib.new_zeros((S * (st.Lrow + 1), k))  # row Lrow: drop
    C.index_add_(0, (st.row_ids_dev.long() + off * (st.Lrow + 1)).reshape(-1),
                 contrib)
    return C.reshape(S, st.Lrow + 1, k)[:, : st.Lrow].contiguous()


def sparse_times_dense(A, B):
    """C = A_sp @ B_dn (ref sparse.jl:2391-2424, redesigned: one row-payload
    gather and a stencil, dense, ELL or segment engine instead of
    column-by-column SpMVs). C lies on A's row partition."""
    from ..dense import DistDenseMatrix

    if A.ncols != B.m:
        raise ValueError(f"dimension mismatch: {A.shape} @ {B.shape}")
    st = A.structure
    plan = get_spmm_plan(A, B)
    ex = plan.exchange
    if plan.offsets is not None:
        g, pad_to = gathered(plan, B.data)
        C = _dia_spmm(_dia_values(A, plan), g, plan.offsets, plan.bias_lo,
                      plan.bias_hi, pad_to)
    elif plan.densify:
        blk = _dense_block(A, plan)
        g = B.data if ex.is_identity else ex.apply(B.data)
        G = blk.shape[-1]
        g = _pad_rows(g, G)[:, :G]
        dt = torch.promote_types(blk.dtype, g.dtype)
        C = torch.bmm(blk.to(dt), g.to(dt))
    elif plan.ell:
        C = _ell_spmm_apply(A, plan, B.data)
    else:
        C = _segment_spmm(A, ex.apply(B.data))
    return DistDenseMatrix(C, st.row_partition, B.ncols, A.backend)


# dense × sparse densify gate: B is scattered into a dense (m, k) block when
# it has at most this many elements
DXS_DENSIFY_MAX_ELEMS = 1 << 25


def _dxs_table(B):
    """Flat positions ``row * ncols + col`` of B's stored values in global
    CSR order, and the partition of B's stacked nonzeros."""
    st = B.structure
    idx = [(np.repeat(np.arange(len(st.indptr[s]) - 1, dtype=np.int64),
                      np.diff(st.indptr[s])) + int(st.row_partition[s]))
           * B.ncols + st.col_indices[s][st.colval[s]]
           for s in range(B.backend.nshards)]
    flat = np.concatenate(idx) if idx else np.zeros(0, np.int64)
    check_index("dxs_densify", flat, B.m * B.ncols)
    nnzb = np.concatenate([[0], np.cumsum(st.nnz_local)]).astype(np.int64)
    return B.backend.tensor(flat), nnzb


def dense_times_sparse(A, B):
    """C = A_dn @ B_sp (ref dense.jl:1286-1308, column by column there).

    B's stored values are gathered whole and scattered into a dense
    (m, k) block, and one einsum multiplies A's rows with it: C lies on
    A's row partition. When that block would exceed
    ``DXS_DENSIFY_MAX_ELEMS`` elements, C = (Bᵀ Aᵀ)ᵀ through the sparse
    and dense transposes instead."""
    from ..dense import DistDenseMatrix
    from ..parallel.mesh import allgather_full

    if A.ncols != B.m:
        raise ValueError(f"dimension mismatch: {A.shape} @ {B.shape}")
    if B.m * B.ncols <= DXS_DENSIFY_MAX_ELEMS:
        be = B.backend
        flat, nnzb = cached_plan("dxs_densify", (B.hash, be.key),
                                 lambda: _dxs_table(B))
        vals = allgather_full(B.nzval, nnzb, be)
        dt = torch.promote_types(A.dtype, vals.dtype)
        Bd = vals.new_zeros(B.m * B.ncols, dtype=dt)
        Bd.index_add_(0, flat, vals.to(dt))
        C = torch.einsum("slg,gk->slk", A.data.to(dt),
                         Bd.reshape(B.m, B.ncols))
        return DistDenseMatrix(C, A.row_partition, B.ncols, be)
    Bt = B.transpose_materialized()
    At = A.transpose_materialized()
    return sparse_times_dense(Bt, At).transpose_materialized()
