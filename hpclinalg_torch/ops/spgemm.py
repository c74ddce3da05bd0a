"""SpGEMM: distributed sparse × sparse matrix multiply.

Port of the JAX package's ``hpclinalg/ops/spgemm.py`` (ref: MatrixPlan,
sparse.jl:554-1059). The symbolic phase — which B rows each shard needs,
the flop-pair expansion and C's exact CSR structure — is host numpy over
the structure metadata, vectorised (no Python loop over rows), and gives
the JAX package's structure and hash. Execution takes one of three
engines, with the JAX package's thresholds:

  * densify (``DENSE_SPGEMM_ELEMS``): small general operands as dense
    blocks, one batched ``torch.matmul``;
  * DIA: stencil-class operands as diagonal convolutions;
  * pairs: ``gathered = ExchangePlan(B values)``, then
    ``contrib = A[pairA] * gathered[pairB]`` (two gathers in K2's gather
    mode) and ``index_add_`` of ``contrib`` into C's values at ``pairO``.
    A product with more than ``PAIR_CAP`` pairs per shard keeps its pair
    tables on the host and streams them to the device in chunks of that
    size, so no O(flops) table is held on the device.

The plan is memoized by both structural hashes: repeated products with the
same patterns only move values.

On a process group the symbolic phase stays global host data, so every
rank picks the same engine and the same chunk count and calls the same
collectives (B's values arrive by the ExchangePlan's ``all_to_all_single``);
each rank keeps and uploads only its own rows of the pair, diagonal and
densify tables.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from ..cache import cached_plan
from ..config import round_up
from ..partition import global_to_local, owner_of
from ..parallel.exchange import ExchangePlan
from .cuda_ell import check_index, gather

# densify tier: per-shard dense operand cap (elements)
DENSE_SPGEMM_ELEMS = 1 << 22
# pair engine: most pair-table slots per shard held on the device at once
PAIR_CAP = 1 << 23


def _ranges(starts: np.ndarray, lens: np.ndarray) -> np.ndarray:
    """The concatenation of arange(starts[i], starts[i] + lens[i])."""
    lens = np.asarray(lens, np.int64)
    total = int(lens.sum())
    if not total:
        return np.zeros(0, np.int64)
    first = np.cumsum(lens) - lens
    return np.repeat(np.asarray(starts, np.int64) - first, lens) \
        + np.arange(total, dtype=np.int64)


class SpGEMMPlan:
    def __init__(self, A, B):
        from ..sparse import SparseStructure, compress_cols, csr_from_rows

        stA, stB = A.structure, B.structure
        be = A.backend
        S = be.nshards
        ncB = B.ncols

        # --- which B rows each shard needs, and the gathered-value layout ----
        # shard s gathers the values of the B rows col_indices_A[s], row
        # after row; row j of that list starts at goff[s][j]
        b_indptr, b_indices = B._gathered_pattern()
        brow_len = np.diff(b_indptr)
        b_first = b_indptr[stB.row_partition[:-1]]  # first storage pos per shard
        send = [[np.zeros(0, np.int64) for _ in range(S)] for _ in range(S)]
        recv = [[np.zeros(0, np.int64) for _ in range(S)] for _ in range(S)]
        goffs, gath_cols, gath_rows = [], [], []
        max_g = 0
        for s in range(S):
            wanted = stA.col_indices[s]
            lens = brow_len[wanted]
            goff = np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)
            goffs.append(goff)
            max_g = max(max_g, int(goff[-1]))
            gpos = _ranges(b_indptr[wanted], lens)   # global B storage slots
            gath_cols.append(b_indices[gpos])
            gath_rows.append(lens)
            slot_owner = np.repeat(owner_of(stB.row_partition, wanted), lens)
            for sb in range(S):
                m = slot_owner == sb
                if m.any():
                    send[sb][s] = gpos[m] - b_first[sb]
                    recv[s][sb] = np.flatnonzero(m)
        self.gpad = round_up(max_g + 1)
        self.value_plan = ExchangePlan(be, send, recv, self.gpad)

        # --- flop-pair expansion and C's structure, per shard ----------------
        # C's structure is global; the pair lists are kept for this
        # process's shards only
        indptr, col_indices, colval = [], [], []
        pairsA, pairsB, pairsO = [], [], []
        max_pairs = 0
        for s in range(S):
            goff = goffs[s]
            j_comp = stA.colval[s].astype(np.int64)
            plens = goff[j_comp + 1] - goff[j_comp]
            nl = len(stA.indptr[s]) - 1
            rows_l = np.repeat(np.arange(nl, dtype=np.int64),
                               np.diff(stA.indptr[s]))
            pA = np.repeat(np.arange(len(j_comp), dtype=np.int64), plens)
            pB = _ranges(goff[j_comp], plens)
            keys = np.repeat(rows_l, plens) * ncB + gath_cols[s][pB]
            uniq, inv = np.unique(keys, return_inverse=True)
            indptr.append(csr_from_rows(uniq // ncB, nl))
            ci, cv = compress_cols(uniq % ncB)
            col_indices.append(ci)
            colval.append(cv)
            max_pairs = max(max_pairs, len(pA))
            if s in be.shards:
                pairsA.append(pA)
                pairsB.append(pB)
                pairsO.append(inv.reshape(-1))
        self.structure = SparseStructure(stA.row_partition, stB.col_partition,
                                         indptr, col_indices, colval, be)
        NZc = self.structure.NNZpad
        Ppad = round_up(max(max_pairs, 1))

        def pack(lists, fill):
            out = np.full((be.nlocal, Ppad), fill, dtype=np.int32)
            for s, lst in enumerate(lists):
                out[s, : len(lst)] = lst
            return out

        # padding: pairA -> a valid slot (0), pairB -> the guaranteed-zero
        # gathered slot, pairO -> the drop slot NZc
        self._pair_np = (pack(pairsA, 0), pack(pairsB, self.gpad - 1),
                         pack(pairsO, NZc))
        check_index("spgemm pairA", self._pair_np[0], stA.NNZpad)
        check_index("spgemm pairB", self._pair_np[1], self.gpad)
        check_index("spgemm pairO", self._pair_np[2], NZc, sentinel=NZc)
        self.nchunks = -(-Ppad // PAIR_CAP)
        # device tables, uploaded at the first pair-engine product (the DIA
        # and densify engines never read them); a chunked plan keeps its
        # chunks in (pinned) host memory and copies one at a time
        self._pair_dev = None
        if self.nchunks > 1:
            warnings.warn(
                f"SpGEMM pair table ({max_pairs} flop-pairs/shard) exceeds "
                f"PAIR_CAP={PAIR_CAP}; executing in {self.nchunks} bounded "
                "chunks", RuntimeWarning, stacklevel=3)
            pin = be.device.type == "cuda"
            self._pair_host = [
                tuple(t.pin_memory() if pin else t for t in self._chunk_tables(
                    slice(i * PAIR_CAP, (i + 1) * PAIR_CAP)))
                for i in range(self.nchunks)]
            del self._pair_np

        # stencil-class engine (diagonal convolution)
        self.dia = DiaSpGEMMPlan(A, B, self.structure)

        # densify engine for small general operands: B's gathered values
        # scatter into a dense (GA, ncols B) operand, GA = A's compressed
        # column width; C's values are one take from the dense product
        GA = stA.Gpad
        self.densify = (not self.dia.ok
                        and stA.Lrow * GA <= DENSE_SPGEMM_ELEMS
                        and GA * ncB <= DENSE_SPGEMM_ELEMS
                        and stA.Lrow * ncB <= DENSE_SPGEMM_ELEMS)
        if self.densify:
            self.ncolsB, self.GA = ncB, GA
            stC = self.structure
            gm = np.full((be.nlocal, self.gpad), GA * ncB,
                         dtype=np.int64)  # drop
            take = np.full((be.nlocal, NZc), stA.Lrow * ncB, dtype=np.int64)
            for i, s in enumerate(be.shards):
                j = np.repeat(np.arange(len(gath_rows[s]), dtype=np.int64),
                              gath_rows[s])
                gm[i, : len(j)] = j * ncB + gath_cols[s]
                r, c = stC.global_coo[s]
                take[i, : stC.nnz_local[s]] = \
                    (r - stC.row_partition[s]) * ncB + c
            check_index("spgemm gathered_to_dense", gm, GA * ncB,
                        sentinel=GA * ncB)
            check_index("spgemm c_dense_take", take, stA.Lrow * ncB + 1)
            self.gathered_to_dense = be.tensor(gm)
            self.c_dense_take = be.tensor(take)

    def _chunk_tables(self, sl):
        """Host tables of the pair slots ``sl``: pairA, pairB (nlocal, P)
        int32 and pairO as flat int64 indices into C's (nlocal, NNZpad+1)
        values."""
        pa, pb, po = (np.ascontiguousarray(t[:, sl]) for t in self._pair_np)
        S = pa.shape[0]
        flat = po.astype(np.int64) + (np.arange(S, dtype=np.int64)
                                      * (self.structure.NNZpad + 1))[:, None]
        return (torch.from_numpy(pa), torch.from_numpy(pb),
                torch.from_numpy(flat.reshape(-1)))

    def pair_chunks(self, backend):
        """Yield the device pair tables, one chunk of at most PAIR_CAP slots
        per shard at a time."""
        if self.nchunks > 1:
            for chunk in self._pair_host:
                yield tuple(t.to(backend.device, non_blocking=True)
                            for t in chunk)
            return
        if self._pair_dev is None:
            self._pair_dev = tuple(t.to(backend.device) for t in
                                   self._chunk_tables(slice(None)))
        yield self._pair_dev


class DiaSpGEMMPlan:
    """Diagonal-convolution SpGEMM for stencil-class operands.

    When both patterns decompose into few GLOBAL diagonal offsets (OA, OB),
    the product's diagonals are
        dC[oA+oB](i) = Σ dA[oA](i) * dB[oB](i + oA)
    — shifted vector multiplies, no gathers or scatters in the hot path. C's
    CSR values are then one static take from the dC table. ``ok`` is False
    unless both operands qualify.
    """

    MAX_OFFSETS = 32

    def __init__(self, A, B, c_structure):
        self.ok = False
        stA, stB = A.structure, B.structure
        be = A.backend
        S = be.nshards
        OA = _global_offsets(stA)
        OB = _global_offsets(stB) if OA else None
        OC = _global_offsets(c_structure) if OB else None
        if not OA or not OB or OC is None:
            return  # (an operand with no stored entries takes the pair engine)
        rowsA = int(np.diff(stA.row_partition).sum())
        rowsB = int(np.diff(stB.row_partition).sum())
        if (len(OA) * rowsA > 3 * max(stA.nnz, 1) + 1024 or
                len(OB) * rowsB > 3 * max(stB.nnz, 1) + 1024):
            return
        self.OA, self.OB, self.OC = OA, OB, OC
        self.Lrow = stA.Lrow
        # dA: (S, OA, LrowA), offset-major; dB: (S, LrowB, OB), row-major so
        # the window exchange moves whole rows
        self.dA_scatter = _global_dia_scatter(stA, OA, be, row_major=False)
        self.dB_scatter = _global_dia_scatter(stB, OB, be, row_major=True)

        # window of B rows each A shard needs: [r0 + min OA, r1 + max OA)
        self.w_lo = min(OA)
        self.W = stA.Lrow + (max(OA) - self.w_lo)
        nB = stB.shape[0]
        wanted, lo = [], []
        for s in range(S):
            r0, r1 = int(stA.row_partition[s]), int(stA.row_partition[s + 1])
            lo.append(r0 + self.w_lo)
            wanted.append(np.arange(max(r0 + self.w_lo, 0),
                                    min(r1 + max(OA), nB), dtype=np.int64))
        self.window_plan = _window_gather_plan(be, stB.row_partition, wanted,
                                               lo, round_up(self.W))

        # C value (storage order) -> flat dC slot (offset index * LC + row)
        LC = c_structure.Lrow
        OCa = np.asarray(OC, np.int64)
        take = np.full((be.nlocal, c_structure.NNZpad), len(OC) * LC,
                       dtype=np.int64)
        for i, s in enumerate(be.shards):
            r, c = c_structure.global_coo[s]
            oi = np.searchsorted(OCa, c - r)
            take[i, : c_structure.nnz_local[s]] = \
                oi * LC + (r - c_structure.row_partition[s])
        check_index("dia spgemm c_take", take, len(OC) * LC + 1)
        self.c_take = be.tensor(take)
        self.LC = LC
        self.ok = True


def _global_offsets(st):
    """Distinct global (col - row) offsets, or None if more than
    MAX_OFFSETS (a sample of each shard is probed first: more distinct
    offsets in the sample means more in the whole)."""
    cap = DiaSpGEMMPlan.MAX_OFFSETS
    offs = set()
    for r, c in st.global_coo:
        if len(r) > (1 << 16) and len(np.unique(c[: 1 << 16] - r[: 1 << 16])) > cap:
            return None
        offs.update(np.unique(c - r).tolist())
        if len(offs) > cap:
            return None
    return tuple(sorted(offs))


def _global_dia_scatter(st, offsets, backend, row_major: bool):
    """(nlocal, NNZpad) map from storage order into a flat diagonal table
    of this process's shards: offset-major (o_index*Lrow + row) or
    row-major (row*O + o_index); the padding goes to the drop slot
    O*Lrow."""
    O = len(offsets)
    offa = np.asarray(offsets, np.int64)
    out = np.full((backend.nlocal, st.NNZpad), O * st.Lrow, dtype=np.int64)
    for i, s in enumerate(backend.shards):
        r, c = st.global_coo[s]
        oi = np.searchsorted(offa, c - r)
        rl = r - st.row_partition[s]
        out[i, : st.nnz_local[s]] = (rl * O + oi) if row_major \
            else (oi * st.Lrow + rl)
    check_index("dia spgemm scatter", out, O * st.Lrow, sentinel=O * st.Lrow)
    return backend.tensor(out)


def _window_gather_plan(backend, src_partition, wanted, window_lo, out_len):
    """Gather global rows ``wanted[d]`` into window slots id - window_lo[d]."""
    S = backend.nshards
    send = [[np.zeros(0, np.int64) for _ in range(S)] for _ in range(S)]
    recv = [[np.zeros(0, np.int64) for _ in range(S)] for _ in range(S)]
    for d in range(S):
        owners, loc = global_to_local(src_partition, wanted[d])
        pos = wanted[d] - window_lo[d]
        for s in range(S):
            m = owners == s
            if m.any():
                send[s][d] = loc[m]
                recv[d][s] = pos[m]
    return ExchangePlan(backend, send, recv, out_len)


def _instance_dia_table(M, offsets, row_major, scatter):
    """Per-value-instance diagonal table, cached on the matrix object."""
    from .spmv import _engine_cache, _scatter_table

    cache = _engine_cache(M)
    key = ("gdia", offsets, row_major)
    hit = cache.get(key)
    if hit is None:
        st = M.structure
        O, L = len(offsets), st.Lrow
        S = M.backend.nlocal
        hit = _scatter_table(scatter, M.nzval, O * L)
        hit = hit.reshape(S, L, O) if row_major else hit.reshape(S, O, L)
        cache[key] = hit
    return hit


def _dia_spgemm_exec(d, dA, dBw) -> torch.Tensor:
    """C's values from the diagonal tables: dA (S, OA, Lrow) and the row
    window of B's diagonals dBw (S, Wpad, OB)."""
    S = dA.shape[0]
    dt = torch.promote_types(dA.dtype, dBw.dtype)
    oc_map = {o: i for i, o in enumerate(d.OC)}
    dC = [None] * len(d.OC)
    for ia, oa in enumerate(d.OA):
        # B row (r0 + i + oa) sits at window slot i + (oa - w_lo)
        base = oa - d.w_lo
        for ib, ob in enumerate(d.OB):
            oc = oc_map.get(oa + ob)
            if oc is None:
                continue
            term = dA[:, ia, :].to(dt) * dBw[:, base: base + d.Lrow, ib].to(dt)
            dC[oc] = term if dC[oc] is None else dC[oc] + term
    zero = dA.new_zeros((S, d.LC), dtype=dt)
    # the last slot is the zero that C's padding (and an empty C) takes
    flat = torch.cat([zero if t is None else t for t in dC]
                     + [dA.new_zeros((S, 1), dtype=dt)], 1)
    return torch.gather(flat, 1, d.c_take)


def get_spgemm_plan(A, B) -> SpGEMMPlan:
    key = (A.hash, B.hash, A.backend.key)
    return cached_plan("matrix_plan", key, lambda: SpGEMMPlan(A, B))


def _densify_spmv_plan(A, B, plan):
    """A's SpMV plan on B's row partition when the densify engine takes
    ``A @ B`` (its dense block of A is the SpMV densify engine's), else
    None."""
    from .spmv import _get_plan

    if not plan.densify:
        return None
    sp_plan = _get_plan(A, B.row_partition, B.row_partition_hash)
    return sp_plan if sp_plan.offsets is None and sp_plan.densify else None


def engine(A, B) -> str:
    """The engine ``A @ B`` runs on: "densify", "dia" or "pairs". It is
    chosen from global host data, so every rank of a group takes the same
    one (and, for "pairs", the same ``nchunks``)."""
    plan = get_spgemm_plan(A, B)
    if _densify_spmv_plan(A, B, plan) is not None:
        return "densify"
    return "dia" if plan.dia.ok else "pairs"


def spgemm(A, B):
    """C = A @ B (ref: Base.:*, sparse.jl:991-1059). C inherits A's row
    partition and B's column partition."""
    from ..sparse import DistSparseMatrix
    from .spmv import _dense_block

    if A.ncols != B.m:
        raise ValueError(f"dimension mismatch: {A.shape} @ {B.shape}")
    plan = get_spgemm_plan(A, B)
    dt = torch.promote_types(A.dtype, B.dtype)
    S = A.backend.nlocal
    sp_plan = _densify_spmv_plan(A, B, plan)
    if sp_plan is not None:
        # A's dense local block over its compressed columns, shared with
        # (and cached like) the SpMV densify engine
        Ad = _dense_block(A, sp_plan).to(dt)
        GA, ncB = plan.GA, plan.ncolsB
        bd = Ad.new_zeros((S, GA * ncB + 1))
        bd.scatter_(1, plan.gathered_to_dense,
                    plan.value_plan.apply(B.nzval.to(dt)))
        cd = torch.bmm(Ad, bd[:, : GA * ncB].reshape(S, GA, ncB))
        flat = torch.cat([cd.reshape(S, -1), Ad.new_zeros((S, 1))], 1)
        return DistSparseMatrix(plan.structure,
                                torch.gather(flat, 1, plan.c_dense_take),
                                A.backend)
    if plan.dia.ok:
        d = plan.dia
        dA = _instance_dia_table(A, d.OA, False, d.dA_scatter)
        dB = _instance_dia_table(B, d.OB, True, d.dB_scatter)
        nz = _dia_spgemm_exec(d, dA, d.window_plan.apply(dB))
        return DistSparseMatrix(plan.structure, nz, A.backend)
    gathered = plan.value_plan.apply(B.nzval.to(dt))
    Anz = A.nzval.to(dt)
    NZ = plan.structure.NNZpad
    out = Anz.new_zeros(S * (NZ + 1))   # slot NZ of each shard: drop
    for pa, pb, po in plan.pair_chunks(A.backend):
        out.index_add_(0, po, (gather(Anz, pa) * gather(gathered, pb))
                       .reshape(-1))
    return DistSparseMatrix(plan.structure,
                            out.reshape(S, NZ + 1)[:, :NZ].contiguous(),
                            A.backend)
