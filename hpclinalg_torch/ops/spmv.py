"""SpMV: distributed sparse matrix × vector — the hottest path.

Port of the JAX package's ``hpclinalg/ops/spmv.py``. The gather is a cached
static ExchangePlan delivering ``x[col_indices[s]]`` into each shard's
gathered buffer; the local engine is chosen per sparsity pattern when the
plan is built, with the JAX package's rules and thresholds:

  * DIA (stencil) engine: the pattern decomposes into at most
    ``DIA_MAX_OFFSETS`` diagonals in the gathered index space with at most
    ``DIA_FILL_FACTOR`` storage blowup; y is O shifted multiply-adds.
    Kernel K1 (ops/cuda_dia.py, csrc/dia_spmv.cu).
  * densify: a small general local block (at most ``DENSE_MAX_ELEMS``
    elements per shard) is stored dense and multiplied with ``torch.bmm``.
  * ELL(+COO tail) engine for general sparsity: rows padded to width
    ``W = min(maxlen, max(ELL_MIN_WIDTH, ceil(ELL_WIDTH_MULT * mean)))``;
    entries past W spill into a COO tail. Kernel K2 (ops/cuda_ell.py,
    csrc/ell_spmv.cu), which also reads the plan's row-length table so it
    never fetches the padding.
  * resident: the ELL engine's tables with x staged in shared memory, a
    column window per row tile (recorded with the plan), taken when the
    ELL plan has at least ``MIN_NNZ``
    entries, at most ``MAX_ELL_BLOWUP`` padding, and a gathered x whose
    bytes fit the device's shared-memory cap per block — the JAX package's
    ``ell_policy_would_accept`` (hpclinalg/ops/pallas_csr.py) with shared
    memory in place of VMEM. Kernel K3 (ops/cuda_ell_resident.py,
    csrc/ell_resident_spmv.cu).
  * fallback: gather + segment sum (``scatter_add_``), for degenerate
    patterns with no stored entries.

SpMM (``A @ B`` with a dense B, ``ops/mixed.py``) takes the same plan for
an x on B's row partition (``get_spmm_plan``); its exchange moves B's rows
whole, and its engines are the plain PyTorch ones widened to k columns.
The ELL one (``_ell_spmm_exec``) reads B itself at one shard, through
column tables composed with the compressed-column map and checked
against B's rows (``_ell_cols_raw``).

On a process group (``Backend.group``) the plan is built from the global
host structure, the same on every rank with no communication, so every
rank picks the same engine and the same exchange; each rank uploads only
its own rows of every table (``Backend.shard_tensor``) and runs the engine
on its (1, ...) shard, for SpMM as for SpMV.

Every index table is checked on the host when the plan is built
(``check_index``): an out-of-range index on the device would be a
device-side fault, and the kernels do not clip. The per-matrix value tables
(DIA diagonals, dense block, ELL values) are built once per matrix instance
by one device scatter and cached on it, so repeated products with the same
matrix (iterative solvers) run scatter-free.
"""

from __future__ import annotations

import numpy as np
import torch

from ..cache import cached_plan
from ..hashing import partition_hash
from ..parallel.exchange import ExchangePlan
from ..solver.native import load_ell
from ..utils.profiling import span
from .cuda_dia import dia_spmv, pad_trunc
from .cuda_ell import check_index, ell_spmv, lanes_for
from .cuda_ell_resident import ell_resident_spmv, make_windows, smem_cap
from .gather import gather_exchange_plan

# DIA engine limits: max distinct offsets, and max storage blowup vs nnz
DIA_MAX_OFFSETS = 64
DIA_FILL_FACTOR = 3.0
# densify engine: per-shard dense block cap (elements)
DENSE_MAX_ELEMS = 1 << 22
# ELL engine: rows padded to W = min(max row len, ELL_WIDTH_MULT × mean);
# overflow entries go to a COO tail
ELL_WIDTH_MULT = 3.0
ELL_MIN_WIDTH = 4
# resident engine (pallas_csr.py's MIN_NNZ and MAX_ELL_BLOWUP): enough work
# to be worth the staging, and bounded ELL padding
MIN_NNZ = 1 << 20
MAX_ELL_BLOWUP = 2.5


def _distinct_offsets(offs, Lrow, cap):
    """Sorted distinct values of ``offs`` (all >= -Lrow) via a presence
    bitmap — two linear passes instead of a sort. Returns None as soon as
    the count provably exceeds ``cap`` (a 256k-element sample is probed
    first: sample-distinct > cap implies total-distinct > cap)."""
    if not offs.size:
        return np.zeros(0, np.int64)

    def census(a):
        bm = np.zeros(Lrow + int(a.max()) + 2, bool)
        bm[a + Lrow] = True
        return bm

    if offs.size > (1 << 18):
        if np.count_nonzero(census(offs[: 1 << 18])) > cap:
            return None
    bm = census(offs)
    if np.count_nonzero(bm) > cap:
        return None
    return np.flatnonzero(bm).astype(np.int64) - Lrow


class SpMVPlan:
    """Gather plan + local-engine selection for one (structure, x-partition)."""

    def __init__(self, A, x_partition_hash, exchange: ExchangePlan):
        st = A.structure
        be = A.backend
        self.exchange = exchange
        self.key = (A.hash, x_partition_hash, be.key)
        self.st_hash = A.hash
        self.row_phash = partition_hash(st.row_partition)
        self.ell = False
        self.resident_cap = 0   # bytes of gathered x K3 may stage; 0: never
        self.backend = be

        # ---- try the DIA decomposition (host metadata) --------------------
        # distinct-offset census via a presence bitmap, with a sampled early
        # exit so random patterns reject before the full offset arrays exist
        S = be.nshards
        offsets = set()
        per_shard = []
        rejected = False
        for s in range(S):
            nl = len(st.indptr[s]) - 1
            ip = st.indptr[s]
            if int(st.nnz_local[s]) > (1 << 18):
                pos = np.arange(1 << 18, dtype=np.int64)
                rows_smp = np.searchsorted(ip, pos, side="right") - 1
                offs_smp = st.colval[s][: 1 << 18].astype(np.int64) - rows_smp
                if _distinct_offsets(offs_smp, st.Lrow,
                                     DIA_MAX_OFFSETS) is None:
                    rejected = True
                    break
            rows_local = np.repeat(np.arange(nl, dtype=np.int64), np.diff(ip))
            offs = st.colval[s].astype(np.int64) - rows_local
            per_shard.append(offs)
            u = _distinct_offsets(offs, st.Lrow, DIA_MAX_OFFSETS)
            if u is None:
                rejected = True
                break
            offsets.update(u.tolist())
            if len(offsets) > DIA_MAX_OFFSETS:
                rejected = True
                break
        if rejected:
            offsets = set(range(DIA_MAX_OFFSETS + 1))  # force the else arm
        total_rows = int(np.diff(st.row_partition).sum())
        if (len(offsets) <= DIA_MAX_OFFSETS and
                len(offsets) * total_rows <= DIA_FILL_FACTOR * max(st.nnz, 1) + 1024):
            self.offsets = tuple(sorted(offsets))
            omap = np.zeros(0, np.int64)
            O = len(self.offsets)
            Lrow = st.Lrow
            scat = np.full((S, st.NNZpad), O * Lrow, dtype=np.int64)  # drop
            if O:
                lo = self.offsets[0]
                omap = np.zeros(self.offsets[-1] - lo + 1, np.int64)
                omap[np.asarray(self.offsets) - lo] = np.arange(O)
            for s in range(S):
                nl = len(st.indptr[s]) - 1
                rows_local = np.repeat(np.arange(nl, dtype=np.int64),
                                       np.diff(st.indptr[s]))
                if len(per_shard[s]):
                    oidx = omap[per_shard[s] - self.offsets[0]]
                    scat[s, : st.nnz_local[s]] = oidx * Lrow + rows_local
            check_index("dia_scatter", scat, O * Lrow, sentinel=O * Lrow)
            self.dia_scatter = be.shard_tensor(scat)
            # pad widths so every shifted slice of the gathered buffer is
            # valid (an all-zero matrix has no offsets and needs no padding)
            self.bias_lo = max(0, -min(self.offsets)) if self.offsets else 0
            need_hi = (max(self.offsets) + Lrow - exchange.out_pad) \
                if self.offsets else 0
            self.bias_hi = max(0, need_hi)
            self.densify = False
        else:
            self.offsets = None
            self.densify = st.Lrow * exchange.out_pad <= DENSE_MAX_ELEMS
            if self.densify:
                G = exchange.out_pad
                scat = np.full((S, st.NNZpad), st.Lrow * G, dtype=np.int64)
                for s in range(S):
                    nl = len(st.indptr[s]) - 1
                    rows_local = np.repeat(np.arange(nl, dtype=np.int64),
                                           np.diff(st.indptr[s]))
                    scat[s, : st.nnz_local[s]] = (
                        rows_local * G + st.colval[s].astype(np.int64))
                check_index("dense_scatter", scat, st.Lrow * G,
                            sentinel=st.Lrow * G)
                self.dense_scatter = be.shard_tensor(scat)
            else:
                self._build_ell(A)

    def _build_ell(self, A):
        """ELL(+COO tail) layout for general sparsity: per-shard (Lrow, W)
        column table indexing the gathered buffer; entries past W in their
        row spill into a COO tail handled by a scatter-add."""
        st = A.structure
        be = A.backend
        S = be.nshards
        self.ell = False
        if st.nnz == 0:
            return
        lens_all = []
        for s in range(S):
            ip = st.indptr[s]
            lens_all.append(np.diff(ip) if len(ip) > 1
                            else np.zeros(0, np.int64))
        maxlen = max((int(ln.max()) if ln.size else 0) for ln in lens_all)
        nrows_tot = max(1, sum(ln.size for ln in lens_all))
        mean_len = st.nnz / nrows_tot
        W = int(min(maxlen, max(ELL_MIN_WIDTH,
                                int(np.ceil(ELL_WIDTH_MULT * mean_len)))))
        if W == 0:
            return
        cols = np.zeros((S, st.Lrow, W), dtype=np.int32)
        ell_scat = np.full((S, st.NNZpad), st.Lrow * W, dtype=np.int32)
        tails = []          # per shard (rows, gidx, nzpos)
        ell_lib = load_ell()
        for s in range(S):
            lens = lens_all[s]
            nl = lens.size
            if not nl:
                tails.append((np.zeros(0, np.int64),) * 3)
                continue
            ip = st.indptr[s]
            if ell_lib is not None:
                # single-pass C++ layout build (native/route.cpp ell_build)
                nov = int(np.maximum(lens - W, 0).sum())
                trow = np.empty(max(nov, 1), np.int32)
                tgidx = np.empty(max(nov, 1), np.int32)
                tpos = np.empty(max(nov, 1), np.int64)
                nt = ell_lib.ell_build(
                    nl, st.Lrow, W, int(st.NNZpad),
                    np.ascontiguousarray(ip, np.int64),
                    np.ascontiguousarray(st.colval[s], np.int32),
                    cols[s].reshape(-1), ell_scat[s], trow, tgidx, tpos)
                tails.append((trow[:nt].astype(np.int64),
                              tgidx[:nt].astype(np.int64), tpos[:nt]))
                continue
            rows_l = np.repeat(np.arange(nl), lens)
            within = np.arange(len(rows_l)) - np.repeat(ip[:-1], lens)
            main = within < W
            cols[s, rows_l[main], within[main]] = st.colval[s][main]
            ell_scat[s, np.flatnonzero(main)] = rows_l[main] * W + within[main]
            ov = ~main
            tails.append((rows_l[ov], st.colval[s][ov].astype(np.int64),
                          np.flatnonzero(ov)))
        Tpad = max(t[0].size for t in tails)
        Tpad = int(-(-Tpad // 8) * 8) if Tpad else 0
        G = self.exchange.out_pad
        self.ell = True
        self.ell_W = W
        self.ell_Tpad = Tpad
        self.ell_cols_np = cols.reshape(S, st.Lrow * W)
        check_index("ell_cols", self.ell_cols_np, G)
        check_index("ell_scat", ell_scat, st.Lrow * W, sentinel=st.Lrow * W)
        self.ell_cols = be.shard_tensor(self.ell_cols_np)
        self.ell_scat = be.shard_tensor(ell_scat, torch.int64)
        if Tpad:
            trows = np.full((S, Tpad), st.Lrow, dtype=np.int32)   # drop slot
            tgidx = np.zeros((S, Tpad), dtype=np.int32)
            tscat = np.full((S, st.NNZpad), Tpad, dtype=np.int64)  # drop
            for s, (r, g, p) in enumerate(tails):
                trows[s, : r.size] = r
                tgidx[s, : r.size] = g
                tscat[s, p] = np.arange(r.size)
            check_index("ell_tail_rows", trows, st.Lrow, sentinel=st.Lrow)
            check_index("ell_tail_gidx", tgidx, G)
            check_index("ell_tail_scat", tscat, Tpad, sentinel=Tpad)
            self.ell_tail_rows = be.shard_tensor(trows)
            self.ell_tail_gidx_np = tgidx
            self.ell_tail_gidx = be.shard_tensor(tgidx)
            self.ell_tail_scat = be.shard_tensor(tscat)
        # the kernels' own table: each row's stored length (they stop there
        # instead of reading the padding)
        rowlen = np.zeros((S, st.Lrow), np.int32)
        for s, ln in enumerate(lens_all):
            rowlen[s, : ln.size] = np.minimum(ln, W)
        self.ell_rowlen_np = rowlen
        self.ell_rowlen = be.shard_tensor(rowlen)
        self.ell_mean_len = float(rowlen.sum()) / nrows_tot
        self._layouts = {}
        if st.nnz >= MIN_NNZ and W * nrows_tot <= MAX_ELL_BLOWUP * st.nnz:
            self.resident_cap = smem_cap(be.device)

    def ell_layout(self, dtype: torch.dtype):
        """(lanes, windows) of the ELL kernels in ``dtype``, built once per
        dtype: the threads that share a row, and K3's column windows for
        that many lanes (``make_windows``; None unless the resident engine
        takes the plan in ``dtype``)."""
        hit = self._layouts.get(dtype)
        if hit is None:
            lanes = lanes_for(self.ell_W, self.ell_mean_len, dtype.itemsize)
            win = make_windows(self.ell_cols_np, self.ell_rowlen_np, lanes,
                               dtype, self.backend.device,
                               shards=self.backend.shards) \
                if self.engine(dtype) == "resident" else None
            hit = self._layouts[dtype] = (lanes, win)
        return hit

    def engine(self, dtype: torch.dtype) -> str:
        """The local engine of a product in ``dtype``: "dia", "densify",
        "resident", "ell" or "segment". Resident needs the gathered x, in
        that dtype's item size (16 bytes a c128 slot), to fit the
        shared-memory cap."""
        if self.offsets is not None:
            return "dia"
        if self.densify:
            return "densify"
        if not self.ell:
            return "segment"
        if self.exchange.out_pad * dtype.itemsize <= self.resident_cap:
            return "resident"
        return "ell"


def _get_plan(A, partition: np.ndarray, phash: str) -> SpMVPlan:
    key = (A.hash, phash, A.backend.key)

    def build():
        with span("plan.exchange"):
            exchange = gather_exchange_plan(
                A.backend, partition, A.structure.col_indices,
                out_len=A.structure.Gpad,
            )
        with span("plan.spmv"):
            return SpMVPlan(A, phash, exchange)

    return cached_plan("vector_plan", key, build)


def get_spmv_plan(A, x) -> SpMVPlan:
    """Memoized plan (ref: get_vector_plan, sparse.jl:1992)."""
    return _get_plan(A, x.partition, x.partition_hash)


def get_vector_plan(A, x) -> ExchangePlan:
    """The exchange of ``A @ x`` alone: x's entries to each shard's
    gathered-x buffer (ref: get_vector_plan, sparse.jl:1992)."""
    return get_spmv_plan(A, x).exchange


def get_spmm_plan(A, B) -> SpMVPlan:
    """The plan of ``A @ B`` with a dense B: the SpMV plan of an x on B's
    row partition, whose exchange moves B's rows whole."""
    return _get_plan(A, B.row_partition, B.row_partition_hash)


def _scatter_table(scat: torch.Tensor, nzval: torch.Tensor,
                   width: int) -> torch.Tensor:
    """(S, width) table with nzval[s, k] at column scat[s, k]; index
    ``width`` is the drop slot for padding entries."""
    z = nzval.new_zeros((nzval.shape[0], width + 1))
    z.scatter_(1, scat, nzval)
    return z[:, :width].contiguous()


def _engine_cache(A) -> dict:
    cache = getattr(A, "_engine_cache", None)
    if cache is None:
        cache = A._engine_cache = {}
    return cache


def _dia_values(A, plan: SpMVPlan) -> torch.Tensor:
    """(nlocal, O, Lrow) diagonal-value table, built once per matrix
    instance."""
    cache = _engine_cache(A)
    hit = cache.get(("dia", plan.key))
    if hit is None:
        st = A.structure
        O = len(plan.offsets)
        hit = _scatter_table(plan.dia_scatter, A.nzval, O * st.Lrow) \
            .reshape(A.backend.nlocal, O, st.Lrow)
        cache[("dia", plan.key)] = hit
    return hit


def _dense_block(A, plan: SpMVPlan) -> torch.Tensor:
    """(nlocal, Lrow, Gpad) densified local block, cached per matrix
    instance."""
    cache = _engine_cache(A)
    hit = cache.get(("dense", plan.key))
    if hit is None:
        st = A.structure
        G = plan.exchange.out_pad
        hit = _scatter_table(plan.dense_scatter, A.nzval, st.Lrow * G) \
            .reshape(A.backend.nlocal, st.Lrow, G)
        cache[("dense", plan.key)] = hit
    return hit


def _ell_values(A, plan: SpMVPlan):
    """Per-instance ELL value tables: (nlocal, Lrow, W) bulk plus (nlocal,
    Tpad) tail (None without a tail), cached per matrix instance."""
    cache = _engine_cache(A)
    hit = cache.get(("ell", plan.key))
    if hit is None:
        st = A.structure
        W, Tpad = plan.ell_W, plan.ell_Tpad
        vals = _scatter_table(plan.ell_scat, A.nzval, st.Lrow * W) \
            .reshape(A.backend.nlocal, st.Lrow, W)
        tvals = _scatter_table(plan.ell_tail_scat, A.nzval, Tpad) \
            if Tpad else None
        hit = (vals, tvals)
        cache[("ell", plan.key)] = hit
    return hit


def ell_kernel_args(A, plan: SpMVPlan, g: torch.Tensor, pad_to: int):
    """The arguments of K2 (``ell_spmv(*args, **kw)``) and K3
    (``ell_resident_spmv(*args, **kw, windows=windows)``) for ``A @ x`` on
    the plan's ELL tables and the gathered x ``g``: (args, kw, windows).
    The plan checked its tables when it built them, so the wrappers are
    told so (``checked``) and check only the values and x."""
    vals, tvals = _ell_values(A, plan)
    tail = (tvals, plan.ell_tail_rows, plan.ell_tail_gidx) \
        if plan.ell_Tpad else None
    lanes, windows = plan.ell_layout(torch.promote_types(vals.dtype, g.dtype))
    return ((vals, plan.ell_cols, g, tail, pad_to),
            {"rowlen": plan.ell_rowlen, "lanes": lanes, "checked": True},
            windows)


def _segment_spmv(A, g: torch.Tensor) -> torch.Tensor:
    """Fallback per-shard CSR SpMV as gather + segment sum (ref kernel:
    _spmv_kernel!, sparse.jl:2055)."""
    st = A.structure
    dt = torch.promote_types(A.nzval.dtype, g.dtype)
    contrib = A.nzval.to(dt) * torch.gather(g.to(dt), 1, st.colval_dev.long())
    y = contrib.new_zeros((A.backend.nlocal, st.Lrow + 1))  # col Lrow: drop
    y.scatter_add_(1, st.row_ids_dev.long(), contrib)
    return y[:, : st.Lrow].contiguous()


def gathered(plan: SpMVPlan, xd: torch.Tensor):
    """(g, pad_to): the engines' input for x's shards ``xd``. A fully local
    gather hands the engines x itself, cut or zero-padded to the gathered
    width (``pad_to``), and skips the exchange."""
    ex = plan.exchange
    if ex.is_identity:
        return xd, ex.out_pad
    return ex.apply(xd), 0


def local_spmv(A, plan: SpMVPlan, engine: str, g: torch.Tensor,
               pad_to: int) -> torch.Tensor:
    """This process's rows of ``A @ x`` on the gathered x ``g``
    (``gathered``) by ``engine`` (``plan.engine``): (nlocal, Lrow)."""
    if engine == "dia":
        y = dia_spmv(_dia_values(A, plan), g, plan.offsets, plan.bias_lo,
                     plan.bias_hi, pad_to)
    elif engine == "densify":
        blk = _dense_block(A, plan)
        g = pad_trunc(g, pad_to)
        dt = torch.promote_types(blk.dtype, g.dtype)
        y = torch.bmm(blk.to(dt), g.to(dt).unsqueeze(-1)).squeeze(-1)
    elif engine in ("ell", "resident"):
        args, kw, windows = ell_kernel_args(A, plan, g, pad_to)
        if engine == "resident":
            y = ell_resident_spmv(*args, **kw, windows=windows)
        else:
            y = ell_spmv(*args, **kw)
    else:
        y = _segment_spmv(A, pad_trunc(g, pad_to))
    return y


def matvec(A, x):
    """y = A @ x (ref: Base.:*(A::HPCSparseMatrix, x::HPCVector),
    sparse.jl:2096-2128)."""
    from ..vector import DistVector

    if len(x) != A.ncols:
        raise ValueError(f"dimension mismatch: A is {A.shape}, x has {len(x)}")
    plan = get_spmv_plan(A, x)
    g, pad_to = gathered(plan, x.data)
    y = local_spmv(A, plan, plan.engine(torch.promote_types(A.dtype, x.dtype)),
                   g, pad_to)
    return DistVector._wrap(y, A.structure.row_partition, A.backend,
                            plan.row_phash)


# -- SpMM: the same engines with (k,) row payloads ------------------------------

def _pad_rows(g: torch.Tensor, n: int) -> torch.Tensor:
    """Zero-pad the slot axis (axis 1) of a (S, L, k) payload to ``n``."""
    if g.shape[1] >= n:
        return g
    out = g.new_zeros((g.shape[0], n) + tuple(g.shape[2:]))
    out[:, : g.shape[1]] = g
    return out


def _ell_cols_raw(A, plan: SpMVPlan) -> torch.Tensor:
    """(1, Lrow*W) ELL column table composed with the compressed-column
    map of a single shard, so the product reads B's own rows and skips the
    compression gather. Dead slots point at column ``col_indices[0]``;
    their values are zero. Checked against A's column count (= B.m) and
    cached on the plan."""
    hit = getattr(plan, "_ell_cols_raw", None)
    if hit is None:
        ci = A.structure.col_indices[0]
        raw = ci[plan.ell_cols_np[0].astype(np.int64)]
        check_index("ell_cols_raw", raw, A.ncols)
        hit = plan._ell_cols_raw = A.backend.tensor(
            raw.astype(np.int32)[None])
    return hit


def _ell_tail_gidx_raw(A, plan: SpMVPlan) -> torch.Tensor:
    """The COO tail's gather indices composed like ``_ell_cols_raw``."""
    hit = getattr(plan, "_ell_tail_gidx_raw", None)
    if hit is None:
        ci = A.structure.col_indices[0]
        raw = ci[plan.ell_tail_gidx_np[0].astype(np.int64)]
        check_index("ell_tail_gidx_raw", raw, A.ncols)
        hit = plan._ell_tail_gidx_raw = A.backend.tensor(
            raw.astype(np.int32)[None])
    return hit


def _ell_spmm_exec(vals, cols, g, tail=None) -> torch.Tensor:
    """Row-payload ELL product, shard by shard:
    C[s, r, :] = Σ_w vals[s, r, w] · g[s, cols[s, r*W + w], :] plus the COO
    tail, whose row ``Lrow`` is the drop slot. Its temporary is the
    (Lrow, W, k) block of gathered rows of one shard."""
    S, Lrow, W = vals.shape
    k = g.shape[2]
    dt = torch.promote_types(vals.dtype, g.dtype)
    C = torch.empty((S, Lrow, k), dtype=dt, device=g.device)
    for s in range(S):
        gs = g[s].to(dt)
        gr = gs.index_select(0, cols[s]).reshape(Lrow, W, k)
        gr.mul_(vals[s].to(dt)[:, :, None])
        torch.sum(gr, dim=1, out=C[s])
        del gr  # freed before the next shard allocates its own
        if tail is not None:
            tv, tr, tg = tail
            ys = torch.cat([C[s], C.new_zeros((1, k))])
            ys.index_add_(0, tr[s], tv[s].to(dt)[:, None]
                          * gs.index_select(0, tg[s]))
            C[s] = ys[:Lrow]
    return C


def _ell_spmm_apply(A, plan: SpMVPlan, data: torch.Tensor) -> torch.Tensor:
    """The ELL engine of ``A @ B`` on B's stacked rows ``data``. One shard
    reads B directly through the composed tables; more shards gather B's
    rows through the plan's exchange first."""
    vals, tvals = _ell_values(A, plan)
    ex = plan.exchange
    if A.backend.nshards == 1:
        g = data
        cols = _ell_cols_raw(A, plan)
        tgidx = _ell_tail_gidx_raw(A, plan) if plan.ell_Tpad else None
    else:
        g = _pad_rows(data, ex.out_pad) if ex.is_identity else ex.apply(data)
        cols = plan.ell_cols
        tgidx = plan.ell_tail_gidx if plan.ell_Tpad else None
    tail = (tvals, plan.ell_tail_rows, tgidx) if plan.ell_Tpad else None
    return _ell_spmm_exec(vals, cols, g, tail)
