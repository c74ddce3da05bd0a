"""Host-side symbolic analysis for the multifrontal factorization.

The reference gets all of this from MUMPS's analysis phase (job=1,
reference src/mumps_factorization.jl:196-203). Implemented from
scratch here: elimination tree (Liu's algorithm with path compression),
postorder, Gilbert-Ng-Peyton column counts, fundamental-supernode detection
with relaxed amalgamation, and per-supernode row structures — everything
the numeric phase needs, computed once per sparsity pattern and cached
under the structural hash.

The production path runs in native C++ (native/sym.cpp via ctypes); a pure
numpy/Python implementation remains as fallback and as a cross-validation
oracle for the native kernels (tests/test_factorization.py).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import scipy.sparse as sp


@dataclass
class SymbolicFactor:
    n: int
    perm: np.ndarray            # new-to-old (fill-reducing ∘ postorder)
    iperm: np.ndarray           # old-to-new
    parent: np.ndarray          # etree on permuted matrix
    snode_ptr: np.ndarray       # supernode column ranges [ptr[k], ptr[k+1])
    snode_of: np.ndarray        # column -> supernode
    snode_parent: np.ndarray    # supernode tree
    snode_rows: list            # per supernode: row structure BELOW the
                                # supernode columns (global permuted ids, sorted)
    lnz: int                    # total below-diagonal nnz of L
    flops: float

    @property
    def nsuper(self) -> int:
        return len(self.snode_ptr) - 1


def _permuted_pattern(A_csr: sp.csr_matrix, perm: np.ndarray):
    """Full symmetric pattern of P A Pᵀ, CSR sorted."""
    P = sp.csr_matrix(A_csr)[perm][:, perm]
    P = (P + P.T).tocsr()
    P.sort_indices()
    return P.indptr.astype(np.int64), P.indices.astype(np.int64)


def etree(indptr, indices, n):
    """Elimination tree — Liu (1986) with path compression (Python fallback;
    native: sym_etree in native/sym.cpp)."""
    parent = np.full(n, -1, dtype=np.int64)
    ancestor = np.full(n, -1, dtype=np.int64)
    for j in range(n):
        for t in range(indptr[j], indptr[j + 1]):
            i = indices[t]
            if i >= j:
                continue
            while True:
                a = ancestor[i]
                if a == -1:
                    ancestor[i] = j
                    parent[i] = j
                    break
                if a == j:
                    break
                ancestor[i] = j
                i = a
    return parent


def postorder(parent, n):
    """Postorder of the elimination forest (Python fallback)."""
    head = np.full(n, -1, dtype=np.int64)
    nxt = np.full(n, -1, dtype=np.int64)
    for v in range(n - 1, -1, -1):
        p = parent[v]
        if p != -1:
            nxt[v] = head[p]
            head[p] = v
    order = np.empty(n, dtype=np.int64)
    k = 0
    stack = []
    for root in range(n):
        if parent[root] != -1:
            continue
        stack.append(root)
        while stack:
            v = stack[-1]
            c = head[v]
            if c != -1:
                head[v] = nxt[c]
                stack.append(c)
            else:
                order[k] = v
                k += 1
                stack.pop()
    return order


def _fundamental_starts(parent: np.ndarray, below: np.ndarray, n: int) -> list:
    """Fundamental supernode boundaries, vectorized: col j-1 chains into j
    iff parent[j-1] == j and count(j-1) == count(j)+1."""
    if n == 0:
        return [0]
    j = np.arange(1, n)
    chain = (parent[:-1] == j) & (below[:-1] == below[1:] + 1)
    return [0] + (np.flatnonzero(~chain) + 1).tolist()


def _amalgamate(starts: list, parent: np.ndarray, counts: np.ndarray, n: int,
                relax: int, zeros_frac: float = 0.3, small: int = 16) -> np.ndarray:
    """Greedy chain amalgamation over column-adjacent supernode blocks.

    A block [a,b) may merge into the next block [b,b2) iff parent(b-1) — the
    first below-diagonal row of its last column — lands inside [b,b2); then,
    by the etree containment property, the merged block's rows equal the
    parent block's rows and only explicit zeros are added. Merge when the
    CUMULATIVE explicit zeros stay under ``zeros_frac`` of the block's
    physical storage (prevents the root front swallowing the whole matrix).
    ``counts[j]`` (below-diag) is updated to the RELAXED count so chained
    decisions stay exact. Mirrors MUMPS's amalgamation behind ICNTL
    (mumps_factorization.jl:176)."""
    k = len(starts) - 1
    final_bounds = [n]
    b2 = n
    while k >= 0:
        a2 = starts[k]
        phys = int(counts[a2:b2].sum())
        zeros = 0
        while k - 1 >= 0:
            a = starts[k - 1]
            b = a2
            pb = parent[b - 1]
            if pb == -1 or not (a2 <= pb < b2):
                break
            nc_c, nc_p = b - a, b2 - a2
            rows_p = int(counts[b2 - 1])
            s_c = int(counts[a:b].sum())
            merged_child_store = nc_c * (nc_c - 1) // 2 + nc_c * (nc_p + rows_p)
            extra = merged_child_store - s_c
            new_phys = phys + merged_child_store
            new_zeros = zeros + extra
            if ((nc_c <= 2 and nc_p <= small and new_zeros <= max(
                    4 * relax, zeros_frac * new_phys)) or
                    new_zeros <= zeros_frac * new_phys or
                    new_zeros <= relax):
                for j in range(a, b):
                    counts[j] = (b - j - 1) + nc_p + rows_p
                a2 = a
                phys, zeros = new_phys, new_zeros
                k -= 1
            else:
                break
        final_bounds.append(a2)
        b2 = a2
        k -= 1
    return np.array(sorted(final_bounds), dtype=np.int64)


def _finish(n, perm2, parent, snode_ptr, snode_rows) -> SymbolicFactor:
    iperm2 = np.empty(n, dtype=np.int64)
    iperm2[perm2] = np.arange(n)
    nsuper = len(snode_ptr) - 1
    snode_of = np.zeros(n, dtype=np.int64)
    lnz = 0
    flops = 0.0
    snode_parent = np.full(nsuper, -1, dtype=np.int64)
    for k in range(nsuper):
        j0, j1 = int(snode_ptr[k]), int(snode_ptr[k + 1])
        snode_of[j0:j1] = k
        nc, nr = j1 - j0, len(snode_rows[k])
        lnz += nc * (nc - 1) // 2 + nc * nr
        flops += nc * (nc + nr) ** 2
    for k in range(nsuper):
        rows = snode_rows[k]
        if len(rows):
            snode_parent[k] = snode_of[rows[0]]
    return SymbolicFactor(
        n=n, perm=perm2, iperm=iperm2, parent=parent,
        snode_ptr=snode_ptr, snode_of=snode_of, snode_parent=snode_parent,
        snode_rows=snode_rows, lnz=int(lnz), flops=flops,
    )


def analyze(A_csr: sp.csr_matrix, perm: np.ndarray, relax: int = 16,
            zeros_frac: float = 0.3, small: int = 16) -> SymbolicFactor:
    """Full symbolic analysis of P A Pᵀ — native path with Python fallback.

    ``relax``/``zeros_frac``/``small`` tune the supernode amalgamation:
    the defaults suit the 1-core BLAS host engine; the device engine uses
    heavier merging (fewer, larger fronts: explicit-zero flops are cheap
    on the MXU, scatter elements and wave levels are not)."""
    from .native import load_sym

    lib = load_sym()
    if lib is None:
        return analyze_python(A_csr, perm, relax, zeros_frac, small)
    n = A_csr.shape[0]
    if n == 0:
        return _finish(0, perm, np.zeros(0, np.int64), np.array([0]), [])

    ip, ix = _permuted_pattern(A_csr, perm)
    parent = np.zeros(n, dtype=np.int64)
    post = np.zeros(n, dtype=np.int64)
    lib.sym_etree(n, ip, ix, parent)
    if lib.sym_postorder(n, parent, post) != 0:
        return analyze_python(A_csr, perm, relax, zeros_frac, small)
    perm2 = perm[post]
    ip, ix = _permuted_pattern(A_csr, perm2)
    lib.sym_etree(n, ip, ix, parent)
    counts = np.zeros(n, dtype=np.int64)
    ident = np.arange(n, dtype=np.int64)  # natural order is a postorder now
    lib.sym_counts(n, ip, ix, parent, ident, counts)
    below = counts - 1
    below_orig = below.copy()

    starts = _fundamental_starts(parent, below, n)
    snode_ptr = _amalgamate(starts, parent, below, n, relax,
                            zeros_frac=zeros_frac, small=small)
    nsuper = len(snode_ptr) - 1
    snode_of = np.zeros(n, dtype=np.int64)
    for k in range(nsuper):
        snode_of[snode_ptr[k]: snode_ptr[k + 1]] = k

    cap = int(below_orig[snode_ptr[1:] - 1].sum()) + 1
    rows_ptr = np.zeros(nsuper + 1, dtype=np.int64)
    rows = np.zeros(cap, dtype=np.int64)
    tot = lib.sym_snode_rows(n, nsuper, ip, ix, snode_ptr, snode_of, cap,
                             rows_ptr, rows)
    if tot < 0:
        return analyze_python(A_csr, perm, relax, zeros_frac, small)
    snode_rows = [rows[rows_ptr[k]: rows_ptr[k + 1]].copy() for k in range(nsuper)]
    return _finish(n, perm2, parent, snode_ptr, snode_rows)


def analyze_best(A_csr: sp.csr_matrix, relax: int = 16,
                 zeros_frac: float = 0.3, small: int = 16) -> SymbolicFactor:
    """Symbolic analysis under the better of AMD and nested dissection.

    The reference delegates this choice to METIS (mumps ICNTL(7)=5). AMD
    is the general-purpose default; for stencil-class patterns (low
    flops/lnz — the scatter-bound regime) George-Liu dissection produces
    a balanced separator tree with ~half the flops on 2D grids (measured
    512^2: 11.2 vs 21.6 Gflop, lnz 17.5M vs 20.3M). Picks by
    flops + 1000·lnz (lnz ~ memory traffic, the scatter-regime cost)."""
    from .ordering import amd_order, nd_order

    ip = A_csr.indptr.astype(np.int64)
    ix = A_csr.indices.astype(np.int64)
    n = A_csr.shape[0]
    sym = analyze(A_csr, amd_order(ip, ix, n), relax, zeros_frac, small)
    if n >= 4096 and sym.lnz and sym.flops / max(sym.lnz, 1) < 3000:
        try:
            sym_nd = analyze(A_csr, nd_order(ip, ix, n), relax,
                             zeros_frac, small)
        except Exception:
            return sym
        if (sym_nd.flops + 1000.0 * sym_nd.lnz
                < sym.flops + 1000.0 * sym.lnz):
            return sym_nd
    return sym


def _trial_factor_ms(A_csr: sp.csr_matrix, sym: SymbolicFactor,
                     reps: int) -> float:
    """Measured wall time of one numeric factorization under ``sym`` with
    placeholder values (factor time is value-independent for the unpivoted
    kernels). Used by analyze_fastest to pick an ordering by reality
    instead of a cost model."""
    import time

    from .native import NativeFactor, load_mf

    lib = load_mf()
    if lib is None:
        return float("inf")
    n = A_csr.shape[0]
    coo = A_csr.tocoo()
    r2 = sym.iperm[coo.row]
    c2 = sym.iperm[coo.col]
    order = np.lexsort((r2, c2))
    indices = r2[order].astype(np.int64)
    indptr = np.zeros(n + 1, np.int64)
    np.add.at(indptr, c2[order] + 1, 1)
    indptr = np.cumsum(indptr).astype(np.int64)

    class _V:
        pass

    v = _V()
    v.indptr, v.indices = indptr, indices
    # diagonally dominant placeholder values: no perturbation paths fire
    v.data = np.where(indices == np.repeat(np.arange(n), np.diff(indptr)),
                      8.0, -1.0)
    nf = NativeFactor(sym, np.float64)
    nf.factorize(lib, v, "ldlt", 1e-12)  # warm (page-in the factor arrays)
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        nf.factorize(lib, v, "ldlt", 1e-12)
        best = min(best, time.perf_counter() - t0)
    return best * 1e3


def analyze_fastest(A_csr: sp.csr_matrix, relax: int = 16,
                    zeros_frac: float = 0.3, small: int = 16,
                    trial_max_n: int = 300_000) -> SymbolicFactor:
    """analyze_best, but for patterns small enough to afford it the
    AMD-vs-ND choice is made by TIMING one trial numeric factorization per
    candidate — the flops+lnz cost model misranks orderings whose time is
    dominated by per-front overhead and extend-add traffic (on the 100^2
    Laplacian the model picks ND while AMD factors faster). One
    trial costs about one refactorization and is paid once per sparsity
    pattern, the same amortization contract as the symbolic phase itself
    (ref: MUMPS job=1 analysis, mumps_factorization.jl:196-203)."""
    from .ordering import amd_order, nd_order

    ip = A_csr.indptr.astype(np.int64)
    ix = A_csr.indices.astype(np.int64)
    n = A_csr.shape[0]
    sym = analyze(A_csr, amd_order(ip, ix, n), relax, zeros_frac, small)
    if not (4096 <= n and sym.lnz and sym.flops / max(sym.lnz, 1) < 3000):
        return sym
    try:
        sym_nd = analyze(A_csr, nd_order(ip, ix, n), relax, zeros_frac,
                         small)
    except Exception:
        return sym
    if n <= trial_max_n:
        # candidate grid: both orderings x {default, light} amalgamation.
        # Light merging trades BLAS-front size for fewer explicit-zero
        # flops; which side wins flips with size and ordering, while the
        # cost model ranks them invertedly.
        reps = 2 if n <= 65_536 else 1
        cands = [sym, sym_nd]
        try:
            cands.append(analyze(A_csr, sym.perm, 4, 0.1, 8))
            cands.append(analyze(A_csr, sym_nd.perm, 4, 0.1, 8))
        except Exception:
            pass
        times = [_trial_factor_ms(A_csr, s, reps) for s in cands]
        if np.isfinite(min(times)):
            return cands[int(np.argmin(times))]
    if (sym_nd.flops + 1000.0 * sym_nd.lnz
            < sym.flops + 1000.0 * sym.lnz):
        return sym_nd
    return sym


def analyze_python(A_csr: sp.csr_matrix, perm: np.ndarray, relax: int = 16,
                   zeros_frac: float = 0.3, small: int = 16) -> SymbolicFactor:
    if A_csr.shape[0] == 0:  # native path guards this; mirror it here
        return _finish(0, perm, np.zeros(0, np.int64), np.array([0]), [])
    """Pure-Python symbolic analysis (fallback + validation oracle)."""
    n = A_csr.shape[0]
    ip, ix = _permuted_pattern(A_csr, perm)
    par = etree(ip, ix, n)
    post = postorder(par, n)
    perm2 = perm[post]
    ip, ix = _permuted_pattern(A_csr, perm2)
    par = etree(ip, ix, n)

    # per-column below-diagonal structures by simulation (children precede
    # parents in the now-postordered matrix)
    children = [[] for _ in range(n)]
    for v in range(n):
        if par[v] != -1:
            children[par[v]].append(v)
    col_struct: list = [None] * n
    for j in range(n):
        rows = ix[ip[j]: ip[j + 1]]
        rows = rows[rows > j]
        pieces = [rows] + [col_struct[c][col_struct[c] > j] for c in children[j]]
        col_struct[j] = np.unique(np.concatenate(pieces)) if len(pieces) > 1 else np.unique(rows)
    below = np.array([len(s) for s in col_struct], dtype=np.int64)

    starts = _fundamental_starts(par, below, n)
    snode_ptr = _amalgamate(starts, par, below, n, relax,
                            zeros_frac=zeros_frac, small=small)
    nsuper = len(snode_ptr) - 1
    snode_rows = []
    for k in range(nsuper):
        j0, j1 = int(snode_ptr[k]), int(snode_ptr[k + 1])
        s = np.unique(np.concatenate([col_struct[j] for j in range(j0, j1)]))
        snode_rows.append(s[s >= j1].astype(np.int64))
    return _finish(n, perm2, par, snode_ptr, snode_rows)
