"""Index assignment of distributed matrices.

Port of the JAX package's ``hpclinalg/ops/setindex.py`` (ref: the
setindex! methods, indexing.jl:1871-4362).

*Sparse*: a per-shard CSR splice on the host, touching only the affected
rows: the (rows x cols) block's old entries are dropped, the value's
pattern inserted, and the surviving values move to their new slots through
one cached local ``ExchangePlan`` onto a base that holds the inserted
values (a host value's written in place; a DistSparseMatrix value's moved
there by a second cached plan, across ranks on a process group). The
matrix swaps in the new structure and values and drops every cache the old
ones fed: its transpose (and the transpose's link back), the symmetry flag
and the per-instance SpMV value tables. The SpMV, transpose and backslash
caches are keyed by the structural hash, so a new pattern gets new plans;
a value-only assignment keeps the hash and the backslash cache
refactorizes (it keys values by the identity of ``nzval``).

*Dense*: one flat list of exactly the assigned slots of this process's
(nlocal*L*n) stack, checked on the host, and one ``index_copy`` into a
copy of the stack. The JAX package pads its table with an out-of-range
slot and scatters with mode="drop"; on the card an index out of range is a
device-side assert, so nothing here ever points outside the stack.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import torch

from ..backend import numpy_dtype
from ..cache import cached_plan
from ..hashing import _h
from ..parallel.exchange import ExchangePlan
from ..partition import global_to_local
from .indexing import dedup_last, key_ids


def _check_value_dtype(vdtype, adtype) -> None:
    if (np.issubdtype(numpy_dtype(vdtype), np.complexfloating)
            and not np.issubdtype(numpy_dtype(adtype), np.complexfloating)):
        raise TypeError(
            "cannot assign complex values into a real container "
            "(casting would silently drop the imaginary part)")


def _keys(M, key):
    if not isinstance(key, tuple) or len(key) != 2:
        raise TypeError("matrix setindex requires M[rows, cols] = value")
    return (key_ids(key[0], M.m, "row")[0],
            key_ids(key[1], M.ncols, "column")[0])


def _ranges(starts: np.ndarray, counts: np.ndarray) -> np.ndarray:
    """concatenate(arange(a, a + c) for a, c in zip(starts, counts))."""
    total = int(counts.sum())
    if not total:
        return np.zeros(0, np.int64)
    offs = np.concatenate([[0], np.cumsum(counts)[:-1]])
    return (np.repeat(starts - offs, counts)
            + np.arange(total, dtype=np.int64)).astype(np.int64)


def _sparse_insert_plan(A, rids, cids, V_indptr, V_indices):
    """The new structure, the ExchangePlan moving the surviving old values
    to their new slots, per shard (new slots, V.data positions) of the
    inserted values (global host data, the same in every rank), and the
    inserted values this process's shards hold as (flat slots of its
    (nlocal, out_pad) values, V.data positions):
    ``base.flat[ins_dst] = V.data[ins_src]`` before the moves."""
    from ..sparse import SparseStructure, compress_cols

    st = A.structure
    S = A.backend.nshards
    p = st.row_partition
    cid_sorted = np.sort(cids)

    indptr2, colind2, colval2, out = [], [], [], []
    for s in range(S):
        ip = st.indptr[s]
        nl = len(ip) - 1
        gcols = st.col_indices[s][st.colval[s]]
        rows_l = np.repeat(np.arange(nl, dtype=np.int64), np.diff(ip))

        owned = (rids >= p[s]) & (rids < p[s + 1])
        al = rids[owned] - p[s]
        row_affected = np.zeros(nl, dtype=bool)
        row_affected[al] = True
        if len(gcols) and len(cid_sorted):
            pos = np.minimum(np.searchsorted(cid_sorted, gcols),
                             len(cid_sorted) - 1)
            in_cids = cid_sorted[pos] == gcols
        else:
            in_cids = np.zeros(len(gcols), dtype=bool)
        keep = ~(row_affected[rows_l] & in_cids)
        kept_pos = np.flatnonzero(keep)

        # inserted entries: the rows of V this shard owns
        ks = np.flatnonzero(owned)
        counts = V_indptr[ks + 1] - V_indptr[ks]
        vsrc = _ranges(V_indptr[ks], counts)
        i_rows = np.repeat(al, counts)
        i_cols = cids[V_indices[vsrc]]

        # the new slot of every entry in row-major order: the kept entries
        # are already in that order (CSR), so the inserted ones are merged
        # in; a block with unsorted rows is sorted whole
        W = max(A.ncols, 1)
        rows2 = np.concatenate([rows_l[keep], i_rows])
        cols2 = np.concatenate([gcols[keep], i_cols])
        key = rows2 * W + cols2
        nk = len(kept_pos)
        kk = key[:nk]
        if nk > 1 and not bool(np.all(kk[1:] > kk[:-1])):
            order = np.argsort(key, kind="stable")
            newpos = np.empty(len(order), dtype=np.int64)
            newpos[order] = np.arange(len(order))
        else:
            io = np.argsort(key[nk:], kind="stable")
            ins = key[nk:][io]
            newpos = np.empty(len(key), dtype=np.int64)
            newpos[:nk] = np.arange(nk) + np.searchsorted(ins, kk)
            newpos[nk + io] = np.searchsorted(kk, ins) + np.arange(len(ins))
        rows2[newpos], cols2[newpos] = rows2.copy(), cols2.copy()

        indptr2.append(np.concatenate([[0], np.cumsum(np.bincount(
            rows2, minlength=nl))]).astype(np.int64))
        ci, cv = compress_cols(cols2)
        colind2.append(ci)
        colval2.append(cv)

        out.append((kept_pos, newpos[:nk], newpos[nk:], vsrc))

    st2 = SparseStructure(p, st.col_partition, indptr2, colind2, colval2,
                          A.backend)
    send = [[np.zeros(0, np.int64) for _ in range(S)] for _ in range(S)]
    recv = [[np.zeros(0, np.int64) for _ in range(S)] for _ in range(S)]
    for s in range(S):
        send[s][s], recv[s][s] = out[s][0], out[s][1]
    plan = ExchangePlan(A.backend, send, recv, st2.NNZpad)
    sh = A.backend.shards
    ins_dst = np.concatenate([j * plan.out_pad + out[s][2]
                              for j, s in enumerate(sh)])
    ins_src = np.concatenate([out[s][3] for s in sh])
    return (st2, plan, [(o[2], o[3]) for o in out],
            A.backend.tensor(ins_dst), ins_src)


def _value_plan(A, value, ins, slots, out_pad):
    """The ExchangePlan moving each inserted entry of the DistSparseMatrix
    ``value`` from its slot on its shard of ``value`` (``slots``: V.data,
    each entry's flat slot in the value's (S, NNZpad) stack plus one) to
    its new slot on A's shard; on a group each crosses from the rank that
    owns it in the value's partition."""
    S = A.backend.nshards
    P = value.structure.NNZpad
    send = [[np.zeros(0, np.int64) for _ in range(S)] for _ in range(S)]
    recv = [[np.zeros(0, np.int64) for _ in range(S)] for _ in range(S)]
    for d in range(S):
        owner, slot = np.divmod(slots[ins[d][1]] - 1, P)
        for s in range(S):
            m = owner == s
            if m.any():
                send[s][d], recv[d][s] = slot[m], ins[d][0][m]
    return ExchangePlan(A.backend, send, recv, out_pad)


def sparse_setindex(A, key, value) -> None:
    """A[rows, cols] = value; ``value`` is a scalar, an array of shape
    (len(rows), len(cols)), a scipy sparse matrix or a DistSparseMatrix
    (whose values move device to device, through one cached ExchangePlan
    from the ranks that hold them on a group). Repeated ids keep their last
    write. The full matrix is never gathered."""
    from ..sparse import DistSparseMatrix

    rids, cids = _keys(A, key)
    on_device = isinstance(value, DistSparseMatrix)
    if on_device:
        # the value's pattern on the host, each stored entry carrying its
        # flat nzval slot plus one (never an explicit zero); the values
        # themselves stay on the device
        sv = value.structure
        slots = np.concatenate([s * sv.NNZpad + np.arange(sv.nnz_local[s])
                                for s in range(value.backend.nshards)])
        P = value.pattern_csr()
        V = sp.csr_matrix((slots + 1, P.indices, P.indptr), shape=P.shape)
    elif sp.issparse(value):
        V = sp.csr_matrix(value)
    elif np.isscalar(value) or isinstance(value, (int, float, complex)):
        V = sp.csr_matrix(np.full((len(rids), len(cids)), value))
    else:
        V = sp.csr_matrix(np.asarray(value))
    if V.shape != (len(rids), len(cids)):
        raise ValueError(f"value shape {V.shape} does not match index block "
                         f"({len(rids)}, {len(cids)})")
    V.sort_indices()
    kr = dedup_last(rids)
    if kr is not None:
        rids, V = rids[kr], V[kr]
    kc = dedup_last(cids)
    if kc is not None:
        cids, V = cids[kc], sp.csr_matrix(V[:, kc])
        V.sort_indices()
    _check_value_dtype(value.dtype if on_device else V.dtype, A.dtype)

    Vip = V.indptr.astype(np.int64)
    Vix = V.indices.astype(np.int64)
    key = (A.hash, _h(rids), _h(cids), _h(Vip, Vix), A.backend.key)
    st2, plan, ins, ins_dst, ins_src = cached_plan(
        "sparse_setindex", key,
        lambda: _sparse_insert_plan(A, rids, cids, Vip, Vix))

    if on_device:
        # the plan holds the value's slots, so its key holds them too
        vplan = cached_plan(
            "sparse_setindex_value", key + (value.hash, _h(V.data)),
            lambda: _value_plan(A, value, ins, V.data, plan.out_pad))
        base = vplan.apply(value.nzval.to(A.dtype))
    else:
        S = A.backend.nlocal
        base = A.nzval.new_zeros(S * plan.out_pad)
        if len(ins_src):
            base.index_copy_(0, ins_dst, A.backend.tensor(
                V.data[ins_src].astype(numpy_dtype(A.dtype))))
        base = base.reshape(S, plan.out_pad)
    nz2 = plan.apply(A.nzval, base=base)
    _replace_sparse(A, st2, nz2)


def _replace_sparse(A, structure, nzval) -> None:
    """Swap A's structure and values and drop every cache they fed."""
    old_t = A.cached_transpose
    if old_t is not None:
        old_t._transpose = None
    A.structure = structure
    A.nzval = nzval
    A._transpose = None
    A._issym = None
    A._engine_cache = {}


def dense_setindex(M, key, value) -> None:
    """M[rows, cols] = value; ``value`` is a scalar, an array or a
    DistDenseMatrix of shape (len(rows), len(cols)). Repeated ids keep
    their last write. The matrix stays on its device; its tensor is swapped
    for an updated copy. On a group each rank writes the assigned rows it
    owns."""
    from ..dense import DistDenseMatrix
    from ..parallel.mesh import allgather_full

    rids, cids = _keys(M, key)
    backend = M.backend
    if np.isscalar(value) or isinstance(value, (int, float, complex)):
        vals = backend.tensor(np.full((len(rids), len(cids)), value))
    elif isinstance(value, DistDenseMatrix):
        vals = allgather_full(value.data, value.row_partition, value.backend)
    elif isinstance(value, torch.Tensor):
        vals = value.to(backend.device)
    else:
        vals = backend.tensor(np.asarray(value))
    if tuple(vals.shape) != (len(rids), len(cids)):
        raise ValueError("value shape mismatch")
    _check_value_dtype(vals.dtype, M.dtype)
    kr = dedup_last(rids)
    if kr is not None:
        rids = rids[kr]
        vals = vals.index_select(0, backend.tensor(kr))
    kc = dedup_last(cids)
    if kc is not None:
        cids = cids[kc]
        vals = vals.index_select(1, backend.tensor(kc))

    S, L, n = M.data.shape

    def build():
        """The flat slots of the assigned rows this process holds and, when
        it holds only some of them, their positions in ``vals``."""
        owners, loc = global_to_local(M.row_partition, rids)
        sh = backend.shards
        mine = np.flatnonzero((owners >= sh.start) & (owners < sh.stop))
        dst = (((owners[mine] - sh.start) * L + loc[mine])[:, None] * n
               + cids[None, :]).reshape(-1)
        if len(dst) and (dst.min() < 0 or dst.max() >= S * L * n):
            raise IndexError("dense setindex slot outside the stack")
        rows = None if len(mine) == len(rids) else backend.tensor(mine)
        return backend.tensor(dst.astype(np.int64)), rows

    dst, rows = cached_plan(
        "dense_setindex",
        (M.row_partition_hash, n, L, _h(rids), _h(cids), backend.key), build)
    if rows is not None:
        vals = vals.index_select(0, rows)
    M.data = M.data.reshape(-1).index_copy(
        0, dst, vals.reshape(-1).to(M.dtype)).reshape(S, L, n)
