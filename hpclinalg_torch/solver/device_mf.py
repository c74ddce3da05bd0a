"""Distributed multifrontal factorization on the device.

Port of the JAX package's ``hpclinalg/solver/device_mf.py``, the
counterpart of the reference's distributed direct solvers (MUMPS
distributed-input factorization, cuDSS multi-GPU with the right-hand side
staying distributed):

  * **Proportional subtree mapping**: the supernode forest is split into
    per-shard subtrees balanced by subtree flops; supernodes above the cut
    form the replicated "top" set.
  * **Local phase**: each level of every shard's subtrees is one
    identity-padded (S, B, NF, NF) batch of fronts on the device. Value
    assembly and the extend-add of the children's updates are static
    scatters over the shard axis; the front kernels are batched
    ``torch.linalg`` calls (Cholesky) or the recursive blocked unpivoted
    LDLᵀ / LU below; on the card the LDLᵀ's blocks of up to 32 columns are
    one hand-written kernel a batch (``ops/cuda_ldl.py``), elsewhere its
    plain version.
  * **Cross reduction**: local subtree roots scatter their updates into an
    (S, CROSS) buffer, summed over the shard axis once.
  * **Top phase**: the top tree is factored replicated.
  * **Solves** run the same wave schedule on inverted diagonal blocks, with
    the right-hand side moved in and the solution moved out by two
    ``ExchangePlan``s. One buffer carries the right-hand side, z and x: a
    level's step overwrites its fronts' rows and adds into its ancestors'.
    On the card a level's step of a sweep is one hand-written kernel
    (``ops/cuda_front_solve.py``) wherever its products are bound by bytes
    or latency; elsewhere its plain version.

Kinds: "chol" (SPD), "ldl" (symmetric or complex-symmetric indefinite,
unpivoted LDLᵀ with static-pivot perturbation) and "lu" (unsymmetric on the
symmetrized pattern, unpivoted LU with perturbation). Iterative refinement
in ``DeviceFactorization`` compensates the perturbations.

On a process group (``Backend.group``, one shard a process) every rank
builds the same plan from the global pattern with no communication, keeps
only its own rows of the per-shard tables and runs its own subtrees; the
cross buffer is summed by ONE ``all_reduce`` a factorization (the JAX
package's ``jnp.sum`` over the mesh axis), the top tree is factored
replicated in every rank, and a solve sums the top right-hand side by one
``all_reduce``. The perturbation and failure counts of the local fronts
and their growth are gathered in one collective, so every rank reports
the same global ``n_perturbed`` and ``growth``.

Every index table is built once per pattern on the host, checked there,
and kept as a device tensor in the engine (``cached_plan("device_mf")``).
Where the reference drops out-of-range scatter slots (``mode="drop"``),
the port's front and solve buffers carry one sentinel slot past their end:
the padding of a static table points at it, and it is sliced off or zeroed
after the scatter. The extend-add's padding, which is most of its slots,
adds masked zeros at spread in-range slots instead (``_ea_scatter``). So no
device-side index is ever out of range.

The engine's bodies run level by level in eager PyTorch. On the card a
``DeviceFactorization`` captures them as CUDA graphs, the counterpart of
the JAX engine's ``_factor_jit``, ``_prep_jit`` and ``_solve_jit``
(``utils/graphs.py``): one graph holds the factorization, the inversion of
its diagonal blocks and the reduction of its counts and growth
(``_factor_program``), replayed by every ``refactorize``; one graph a
right-hand-side width and transpose holds ``solve_prepped``. There is no
compile cache and no RHS width bucketing, and the f32 engine's extended
refinement carries its solution in f64 with an f64 copy of A for the
residual (``DeviceFactorization._extended_refine``).
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import torch

from ..backend import numpy_dtype, torch_dtype
from ..config import round_up
from ..ops import cuda_front_solve, cuda_ldl
from ..ops.cuda_ell import check_index
from ..parallel import comm
from ..utils import graphs
from ..utils.profiling import count, span
from . import symbolic
from .ordering import amd_order

_PERT_REL = 1e-10  # relative static-pivot perturbation (matches host engine)

# |L| growth ceiling before a device factorization is flagged unstable and
# its solves escalate to the full-budget extended refinement
_GROWTH_MAX_DEV = 1e4


# ---------------------------------------------------------------------------
# supernode -> shard mapping
# ---------------------------------------------------------------------------

def proportional_map(sym: symbolic.SymbolicFactor, S: int) -> np.ndarray:
    """Owner shard per supernode; -1 marks the replicated top set.

    Proportional mapping: walk the forest from the roots with a shard
    interval, splitting children proportionally to subtree flops; once an
    interval narrows to one shard the whole subtree is local to it."""
    ns = sym.nsuper
    parent = sym.snode_parent
    children = [[] for _ in range(ns)]
    for k in range(ns):
        p = int(parent[k])
        if p >= 0:
            children[p].append(k)
    w = np.empty(ns)
    for k in range(ns):
        nc = int(sym.snode_ptr[k + 1] - sym.snode_ptr[k])
        nr = len(sym.snode_rows[k])
        w[k] = nc * float(nc + nr) ** 2 + 1.0
    subtree = w.copy()
    for k in range(ns):  # postorder: children precede parents
        p = int(parent[k])
        if p >= 0:
            subtree[p] += subtree[k]

    owner = np.full(ns, -1, dtype=np.int64)

    def assign_whole(root, s):
        stack = [root]
        while stack:
            v = stack.pop()
            owner[v] = s
            stack.extend(children[v])

    roots = [k for k in range(ns) if parent[k] < 0]
    stack = [(roots, 0, S)]
    while stack:
        kids, lo, hi = stack.pop()
        total = sum(subtree[c] for c in kids)
        acc = 0.0
        for c in kids:
            start = lo + (hi - lo) * acc / total
            acc += subtree[c]
            end = lo + (hi - lo) * acc / total
            s0 = max(lo, int(np.floor(start + 1e-9)))
            s1 = min(hi, int(np.ceil(end - 1e-9)))
            if s1 - s0 <= 1:
                assign_whole(c, min(max(s0, lo), hi - 1))
            else:
                # owner[c] stays -1 (top, replicated)
                stack.append((children[c], s0, s1))
    return owner


# ---------------------------------------------------------------------------
# batched unpivoted front kernels (recursive blocked). Every function takes
# any number of leading batch axes: (S, B, n, n) for a local level,
# (B, n, n) for a top level.
# ---------------------------------------------------------------------------

def _clamp(d, eps):
    """Static-pivot perturbation: |d| < eps -> sign-preserving +-eps.
    ``eps``: a 0-d tensor in d's real dtype (the JAX engine's
    ``jnp.asarray(eps, dtype)``, which a graph reads at every replay) or a
    float. Returns the clamped pivots and how many were clamped."""
    bad = torch.abs(d) < eps
    sign = (d.real >= 0).to(d.real.dtype) * 2 - 1
    safe = torch.where(bad, (sign * eps).to(d.dtype), d)
    return safe, bad.sum()


def _right_lower_t(L, B, unit=False):
    """X with X Lᵀ = B for lower-triangular L (plain transpose, also for
    complex-symmetric factors: never the conjugate)."""
    return torch.linalg.solve_triangular(L.mT, B, upper=True, left=False,
                                         unitriangular=unit)


def _cat2x2(A11, A12, A21, A22):
    return torch.cat([torch.cat([A11, A12], dim=-1),
                      torch.cat([A21, A22], dim=-1)], dim=-2)


def _ldl_schur(L11, d1, F21, F22, out=None):
    """The LDLᵀ's split step below factored columns (L11, d1): W = F21
    L11⁻ᵀ, L21 = W D1⁻¹ (into ``out`` when given) and the Schur complement
    F22 − L21 Wᵀ. Returns (L21, the complement)."""
    W = _right_lower_t(L11, F21, unit=True)
    L21 = torch.div(W, d1[..., None, :], out=out)
    return L21, F22 - L21 @ W.mT


def batched_ldl(F, eps):
    """Unpivoted LDLᵀ of a (..., n, n) symmetric batch (plain transpose —
    also valid complex-symmetric), reading only the lower triangle.
    Returns (unit-lower L, d, n_perturbed). Blocks of more than
    ``cuda_ldl.LEAF`` columns split in two, written into one L and d
    (``_ldl_blocked``); the blocks they leave are factored a batch by
    ``_ldl_leaf``."""
    if cuda_ldl.leaf_route(F.device, F.dtype):
        eps = cuda_ldl.eps_tensor(eps, F.dtype, F.device)
    # the splits leave L's blocks above their diagonal blocks unwritten
    L = F.new_zeros(F.shape) if F.shape[-1] > cuda_ldl.LEAF \
        else F.new_empty(F.shape)
    d = F.new_empty(F.shape[:-1])
    npert = torch.zeros((), dtype=torch.int64, device=F.device)
    _ldl_blocked(F, eps, L, d, npert)
    return L, d, npert


def _ldl_blocked(F, eps, L, d, npert):
    """The recursion of ``batched_ldl``, writing into views of one L (zero
    above the diagonal blocks) and d, and adding the clamped pivots into
    ``npert``: blocks of at most ``cuda_ldl.LEAF`` columns go to
    ``_ldl_leaf``, larger ones split in two."""
    n = F.shape[-1]
    if n <= cuda_ldl.LEAF:
        _ldl_leaf(F, eps, L, d, npert)
        return
    k = n // 2
    _ldl_blocked(F[..., :k, :k], eps, L[..., :k, :k], d[..., :k], npert)
    _, S22 = _ldl_schur(L[..., :k, :k], d[..., :k], F[..., k:, :k],
                        F[..., k:, k:], out=L[..., k:, :k])
    _ldl_blocked(S22, eps, L[..., k:, k:], d[..., k:], npert)


def _ldl_leaf(F, eps, L, d, npert):
    """A base case of ``batched_ldl``: a batch of blocks of at most
    ``cuda_ldl.LEAF`` columns into the views L and d, the clamped pivots
    added into ``npert``. On CUDA in a type of ``cuda_ldl.DTYPES`` one
    launch of the hand-written kernel (``solver.ldl_leaf_kernels``);
    elsewhere its plain version, ``_ldl_plain`` (``solver.ldl_leaf_plain``).
    """
    if cuda_ldl.leaf_route(F.device, F.dtype):
        count("solver.ldl_leaf_kernels")
        cuda_ldl.ldl_leaf(F, eps, L, d, npert)
        return
    count("solver.ldl_leaf_plain")
    Lp, dp, p = _ldl_plain(F, eps)
    L.copy_(Lp)
    d.copy_(dp)
    npert.add_(p)


def _ldl_plain(F, eps):
    """The LDLᵀ of ``batched_ldl`` recursing to 1 × 1 blocks, in plain
    PyTorch: the hand-written leaf kernel's plain version."""
    n = F.shape[-1]
    if n == 1:
        d, npert = _clamp(F[..., 0, 0], eps)
        return torch.ones_like(F), d[..., None], npert
    k = n // 2
    L11, d1, p1 = _ldl_plain(F[..., :k, :k], eps)
    L21, S22 = _ldl_schur(L11, d1, F[..., k:, :k], F[..., k:, k:])
    L22, d2, p2 = _ldl_plain(S22, eps)
    zt = F.new_zeros(F.shape[:-2] + (k, n - k))
    return _cat2x2(L11, zt, L21, L22), torch.cat([d1, d2], dim=-1), p1 + p2


def batched_lu(F, eps):
    """Unpivoted LU of a (..., n, n) batch with diagonal perturbation.
    Returns (unit-lower L, upper U, n_perturbed)."""
    n = F.shape[-1]
    if n == 1:
        u, npert = _clamp(F[..., 0, 0], eps)
        return torch.ones_like(F), u[..., None, None], npert
    k = n // 2
    F11, F12 = F[..., :k, :k], F[..., :k, k:]
    F21, F22 = F[..., k:, :k], F[..., k:, k:]
    L11, U11, p1 = batched_lu(F11, eps)
    U12 = torch.linalg.solve_triangular(L11, F12, upper=False,
                                        unitriangular=True)
    L21 = torch.linalg.solve_triangular(U11, F21, upper=True, left=False)
    S22 = F22 - L21 @ U12
    L22, U22, p2 = batched_lu(S22, eps)
    zt = F.new_zeros(F.shape[:-2] + (k, n - k))
    zb = F.new_zeros(F.shape[:-2] + (n - k, k))
    return _cat2x2(L11, zt, L21, L22), _cat2x2(U11, U12, zb, U22), p1 + p2


def _front_kernel(kind, F, NC, eps):
    """Factor one padded batch (..., NF, NF). Returns (factor tuple,
    update (..., NR, NR), n_perturbed, failed): ``failed`` counts the
    fronts whose Cholesky stopped at a nonpositive pivot."""
    F11 = F[..., :NC, :NC]
    F21 = F[..., NC:, :NC]
    F22 = F[..., NC:, NC:]
    zero = torch.zeros((), dtype=torch.int64, device=F.device)
    if kind == "chol":
        # symmetric fronts are assembled in the lower triangle only; the
        # mask makes sure the factor never reads the upper one
        L11, info = torch.linalg.cholesky_ex(torch.tril(F11))
        L21 = _right_lower_t(L11, F21)
        U = F22 - L21 @ L21.mT
        return (L11, L21), U, zero, (info != 0).sum()
    if kind == "ldl":
        L11, d, npert = batched_ldl(F11, eps)
        L21, U = _ldl_schur(L11, d, F21, F22)
        return (L11, d, L21), U, npert, zero
    F12 = F[..., :NC, NC:]
    L11, U11, npert = batched_lu(F11, eps)
    U12 = torch.linalg.solve_triangular(L11, F12, upper=False,
                                        unitriangular=True)
    L21 = torch.linalg.solve_triangular(U11, F21, upper=True, left=False)
    U = F22 - L21 @ U12
    return (L11, U11, L21, U12), U, npert, zero


# ---------------------------------------------------------------------------
# one level's solve step, plain: ``ops/cuda_front_solve.py``'s plain version.
# y (S, rows, k) holds the right-hand side, z and x in place; its last row
# is the sentinel slot, which the padding of ccol and crow points at and
# which is zero again after each step.
# ---------------------------------------------------------------------------

def _fwd_plain(y, ccol, crow_add, crow_live, A, M, d=None):
    """The forward step: w = A y[ccol], y[ccol] = w / d (or w), y[crow]
    −= M w (``crow_add``: crow flattened over the shards, masked by
    ``crow_live``)."""
    ar = torch.arange(y.shape[0], device=y.device)[:, None, None]
    w = A @ y[ar, ccol]
    y[ar, ccol] = w if d is None else w / d[..., :, None]
    y.view(-1, y.shape[-1]).index_add_(0, crow_add, torch.where(
        crow_live, -(M @ w), 0).view(-1, y.shape[-1]))
    y[:, -1] = 0


def _bwd_plain(y, ccol, crow, A, M):
    """The backward step: y[ccol] = A (y[ccol] − M y[crow])."""
    ar = torch.arange(y.shape[0], device=y.device)[:, None, None]
    y[ar, ccol] = A @ (y[ar, ccol] - M @ y[ar, crow])
    y[:, -1] = 0


# ---------------------------------------------------------------------------
# plan construction (host, cached per structural hash)
# ---------------------------------------------------------------------------

class _Level:
    """Static tables of one wave level (local: stacked (S, ...) tensors;
    top: plain tensors). The scatter destinations ``a_dst`` and ``diag``
    point their padding at the sentinel slot B·NF·NF. ``crow_add`` is
    ``crow`` flattened over the shards for the solve's scatter-add, its
    padding spread over the real slots, where ``crow_live`` masks the
    values to zero. ``ncol`` and ``nrow`` (int32) count each front's live
    columns and update rows: the prefixes of ``ccol`` and ``crow`` that
    are not the sentinel."""
    __slots__ = ("B", "NC", "NF", "a_src", "a_dst", "diag", "ea", "ea_cross",
                 "ccol", "crow", "crow_add", "crow_live", "ncol", "nrow")

    def __init__(self):
        self.ea = []        # (child_level, srcb, dstb, psl)
        self.ea_cross = []  # (co, nrv, dstb, psl, NRX) — top levels only


def _pad2_sorted(dst_list, src_list, sentinel, src_fill):
    """Per row: sort (dst, src) jointly by dst; pad dst with the sentinel
    slot and src with the zero slot of the values."""
    W = max((len(r) for r in dst_list), default=0)
    W = max(W, 1)
    D = np.full((len(dst_list), W), sentinel, np.int64)
    Sr = np.full((len(dst_list), W), src_fill, np.int64)
    for i, (d, s) in enumerate(zip(dst_list, src_list)):
        o = np.argsort(d, kind="stable")
        D[i, : len(d)] = d[o]
        Sr[i, : len(d)] = np.asarray(s)[o]
    return D, Sr


def _pad_sentinel(rows_list, sentinel):
    """list of sorted 1-D index rows -> (len, W) padded with the sentinel."""
    W = max((len(r) for r in rows_list), default=0)
    W = max(W, 1)
    out = np.full((len(rows_list), W), sentinel, np.int64)
    for i, r in enumerate(rows_list):
        out[i, : len(r)] = r
    return out


def _ea_scatter(dstb, psl, NF, u):
    """Flat front indices (…, C, NR, NR) of the children's updates u
    (…, C, NR, NR) in their parents' fronts, and the values to add there:
    dst[c, i, j] = (dstb[c]*NF + psl[c, i])*NF + psl[c, j], computed on the
    device (never materialized on the host: O(sum nr^2) would sink 3D
    problems). A padding slot (psl = -1) adds a zero at the child's own
    (i, j) position, taken mod NF, of its parent's front instead: in range,
    and spread over many addresses — one drop slot for all of them
    serializes the atomic adds on it."""
    ar = torch.arange(psl.shape[-1], device=psl.device) % NF
    pi = psl[..., :, None]
    pj = psl[..., None, :]
    qi = torch.where(pi >= 0, pi, ar[:, None])
    qj = torch.where(pj >= 0, pj, ar[None, :])
    dst = (dstb[..., None, None] * NF + qi) * NF + qj
    return dst, torch.where((pi >= 0) & (pj >= 0), u, 0)


def _cross_slots(co, nrv, NRX, CROSS):
    """Flat cross-buffer slots (…, C, NRX, NRX) of each child's nr x nr
    update at offset co, and the mask of the real ones. The slots past nr
    (and those of padding children) spread over the buffer, mod CROSS, for
    the reason of ``_ea_scatter``: their values are masked to zero."""
    ii = torch.arange(NRX, device=co.device)[:, None]
    jj = torch.arange(NRX, device=co.device)[None, :]
    nre = nrv[..., None, None]
    valid = (ii < nre) & (jj < nre)
    idx = torch.where(valid, co[..., None, None] + ii * nre + jj,
                      (ii * NRX + jj) % CROSS)
    return idx, valid


class DeviceScheduleError(ValueError):
    """Pattern unsuited to the device wave schedule (e.g. chain trees from
    banded matrices). Solver dispatch catches this and falls back to the
    host engine with a warning."""


class DeviceMF:
    """Multifrontal engine for one sparsity pattern on the backend's
    device, its S shards stacked on the leading axis (this process's one
    shard on a process group)."""

    def __init__(self, A_csr: sp.csr_matrix, backend, kind: str = "ldl",
                 dtype=np.float64, row_partition=None):
        if kind not in ("chol", "ldl", "lu"):
            raise ValueError(f"unknown kind {kind!r}")
        self.kind = kind
        self.dtype = torch_dtype(dtype)
        self.backend = backend
        self.device = backend.device
        self.S = backend.nshards
        self.n = A_csr.shape[0]

        with span("solver.order"):
            perm = amd_order(A_csr.indptr.astype(np.int64),
                             A_csr.indices.astype(np.int64), self.n)
        with span("solver.symbolic"):
            sym = symbolic.analyze(A_csr, perm)
            # device-tuned amalgamation for scatter-bound (low arithmetic
            # intensity, 2D-stencil-class) trees: merge harder, since
            # explicit zeros cost batched dense flops while scatter
            # elements and wave levels cost launches. Flop-dominated 3D
            # trees (high flops/lnz) keep the lean host setting.
            if sym.lnz and sym.flops / sym.lnz < 3000:
                sym = symbolic.analyze(A_csr, perm, relax=64,
                                       zeros_frac=0.5, small=64)
        self.sym = sym
        with span("solver.schedule"):
            self._schedule(A_csr, perm, row_partition)

    def _schedule(self, A_csr, perm, row_partition):
        """The plan after the ordering and the symbolic analysis: the
        subtree mapping, the wave levels, every level's assembly,
        extend-add and solve tables (checked on the host, then uploaded)
        and the exchanges of the right-hand side and the solution."""
        kind, backend, S, n, sym = (self.kind, self.backend, self.S, self.n,
                                    self.sym)
        ns = sym.nsuper
        ptr, rows_of = sym.snode_ptr, sym.snode_rows
        parent = sym.snode_parent

        owner = proportional_map(sym, S)
        self.owner = owner

        # -- wave levels ----------------------------------------------------
        lvl = np.zeros(ns, dtype=np.int64)     # local levels (per shard tree)
        tlvl = np.zeros(ns, dtype=np.int64)    # top levels
        for k in range(ns):
            p = int(parent[k])
            if p < 0:
                continue
            if owner[k] >= 0 and owner[p] == owner[k]:
                lvl[p] = max(lvl[p], lvl[k] + 1)
            elif owner[k] < 0 and owner[p] < 0:
                tlvl[p] = max(tlvl[p], tlvl[k] + 1)
        nloc_lvl = int(lvl[owner >= 0].max()) + 1 if (owner >= 0).any() else 0
        ntop_lvl = int(tlvl[owner < 0].max()) + 1 if (owner < 0).any() else 0

        # per (level): fronts per shard (local) / flat list (top)
        loc_fronts = [[[] for _ in range(S)] for _ in range(nloc_lvl)]
        top_fronts = [[] for _ in range(ntop_lvl)]
        slot = {}  # supernode -> ("loc", l, s, b) | ("top", l, b)
        for k in range(ns):
            if owner[k] >= 0:
                l, s = int(lvl[k]), int(owner[k])
                slot[k] = ("loc", l, s, len(loc_fronts[l][s]))
                loc_fronts[l][s].append(k)
            else:
                l = int(tlvl[k])
                slot[k] = ("top", l, len(top_fronts[l]))
                top_fronts[l].append(k)

        nc_of = np.diff(ptr).astype(np.int64)
        nr_of = np.array([len(r) for r in rows_of], dtype=np.int64)

        def front_slot(k, ids):
            """Front-local slot of each global permuted id for supernode k."""
            j0, j1 = int(ptr[k]), int(ptr[k + 1])
            NCl = self._lvl_geom[k][0]
            within = (ids >= j0) & (ids < j1)
            ri = np.searchsorted(rows_of[k], ids)
            return np.where(within, ids - j0, NCl + ri)

        # level geometry (shared NC/NF per level; identity padding)
        self.local_levels: list[_Level] = []
        self.top_levels: list[_Level] = []
        self._lvl_geom = {}
        for l in range(nloc_lvl):
            ks_all = [k for s in range(S) for k in loc_fronts[l][s]]
            NC = int(nc_of[ks_all].max())
            NF = NC + int(nr_of[ks_all].max())
            B = max(max(len(loc_fronts[l][s]) for s in range(S)), 1)
            m = _Level()
            m.B, m.NC, m.NF = B, NC, NF
            self.local_levels.append(m)
            for k in ks_all:
                self._lvl_geom[k] = (NC, NF)
        for l in range(ntop_lvl):
            ks_all = top_fronts[l]
            NC = int(nc_of[ks_all].max())
            NF = NC + int(nr_of[ks_all].max())
            m = _Level()
            m.B, m.NC, m.NF = max(len(ks_all), 1), NC, NF
            self.top_levels.append(m)
            for k in ks_all:
                self._lvl_geom[k] = (NC, NF)
        for m in (*self.local_levels, *self.top_levels):
            if m.B * m.NF * m.NF >= 2**31 - 1:
                raise ValueError(
                    "front batch exceeds int32 index space "
                    f"(B={m.B}, NF={m.NF})")
        # deep chain trees (banded matrices) make the wave schedule
        # sequential: hundreds of levels of one front each run serially —
        # the host engine is the right tool there
        if len(self.local_levels) + len(self.top_levels) > 128:
            raise DeviceScheduleError(
                f"elimination tree too deep for the device wave schedule "
                f"({len(self.local_levels)} local + {len(self.top_levels)} "
                "top levels; banded/chain-structured patterns serialize) — "
                "use the host engine (method='host')")

        # -- assembly maps: A entries (global CSR order) -> front slots ------
        # the gathered distributed nzval (concat of contiguous row shards,
        # indices sorted) IS the global CSR data order, so entry t maps to
        # permuted (r2, c2) straight from the replicated pattern
        A_csr = sp.csr_matrix(A_csr)
        A_csr.sort_indices()
        rg = np.repeat(np.arange(n, dtype=np.int64), np.diff(A_csr.indptr))
        cg = A_csr.indices.astype(np.int64)
        r2 = sym.iperm[rg]
        c2 = sym.iperm[cg]
        tpos = np.arange(len(r2), dtype=np.int64)
        if kind != "lu":
            keep = r2 >= c2  # lower triangle only (symmetric kinds)
            r2, c2, tpos = r2[keep], c2[keep], tpos[keep]
        dest = sym.snode_of[np.minimum(r2, c2)]

        asm = {}  # (kind of level, l, s|None) -> ([srcs], [dsts])
        order = np.argsort(dest, kind="stable")
        r2o, c2o, tpo, do = r2[order], c2[order], tpos[order], dest[order]
        bounds = np.flatnonzero(np.diff(do)) + 1
        groups = np.split(np.arange(len(do)), bounds)
        for g in groups:
            if not len(g):
                continue
            k = int(do[g[0]])
            kindL, *loc = slot[k]
            NC, NF = self._lvl_geom[k]
            I = front_slot(k, r2o[g])
            J = front_slot(k, c2o[g])
            if kindL == "loc":
                l, s, b = loc
                key = ("loc", l, s)
            else:
                l, b = loc
                key = ("top", l, None)
            flat = (b * NF + I) * NF + J
            sr, ds = asm.setdefault(key, ([], []))
            sr.append(tpo[g])
            ds.append(flat)

        nnzA = len(rg)
        self.nnzA = nnzA
        cat = (lambda a: np.concatenate(a) if a else np.zeros(0, np.int64))

        def pack_asm(m, l, is_top):
            BNN = m.B * m.NF * m.NF
            if is_top:
                sr, ds = asm.get(("top", l, None), ([], []))
                D, Sr = _pad2_sorted([cat(ds)], [cat(sr)], BNN, nnzA)
                D, Sr = D[0], Sr[0]
            else:
                srcs, dsts = [], []
                for s in range(S):
                    sr, ds = asm.get(("loc", l, s), ([], []))
                    srcs.append(cat(sr))
                    dsts.append(cat(ds))
                D, Sr = _pad2_sorted(dsts, srcs, BNN, nnzA)
                D, Sr = self._mine(D), self._mine(Sr)
            m.a_src = self._dev("a_src", Sr, nnzA + 1)
            m.a_dst = self._dev("a_dst", D, BNN + 1)

        # -- identity padding (diag slots not covered by a real front) -------
        def pack_diag(m, fronts_by_slot, is_top):
            def one(frs):
                ds = []
                for b in range(m.B):
                    if b < len(frs):
                        k = frs[b]
                        nc_k = int(ptr[k + 1] - ptr[k])
                        i = np.concatenate([
                            np.arange(nc_k, m.NC, dtype=np.int64),
                            np.arange(m.NC + len(rows_of[k]), m.NF,
                                      dtype=np.int64)])
                    else:
                        i = np.arange(m.NF, dtype=np.int64)
                    ds.append(b * m.NF * m.NF + i * (m.NF + 1))
                return cat(ds)
            BNN = m.B * m.NF * m.NF
            if is_top:
                D = _pad_sentinel([one(fronts_by_slot)], BNN)[0]
            else:
                D = self._mine(_pad_sentinel(
                    [one(fronts_by_slot[s]) for s in range(S)], BNN))
            m.diag = self._dev("diag", D, BNN + 1)

        # -- extend-add maps --------------------------------------------------
        # COMPACT representation: the per-child nr x nr scatter indices are
        # never materialized (O(sum nr^2) memory would sink 3D problems);
        # only each child's parent-slot vector psl (O(sum nr)) plus batch
        # slots are kept, and the factor computes
        # dst[b, i, j] = (b_parent*NF + psl[i])*NF + psl[j] on the device.
        # cross buffer: local subtree roots with a top parent
        croff = {}
        off = 0
        for k in range(ns):
            if owner[k] >= 0 and int(parent[k]) >= 0 \
                    and owner[int(parent[k])] < 0:
                croff[k] = off
                off += int(nr_of[k]) ** 2
        self.CROSS = max(off, 1)

        ea_loc = {}    # (lp, lc) -> per shard [(bc, bp, psl)]
        ea_top = {}    # (lp, lc) -> [(bc, bp, psl)]
        cross_out = {}  # lc -> per shard [(bc, croff, nr)]
        cross_in = {}   # lp -> [(croff, nr, bp, psl)]
        for k in range(ns):
            p = int(parent[k])
            if p < 0 or int(nr_of[k]) == 0:
                continue
            pslot = front_slot(p, rows_of[k]).astype(np.int64)
            pk, *ploc = slot[p]
            kk, *kloc = slot[k]
            nr = int(nr_of[k])
            if kk == "loc" and pk == "loc":
                lp, sp_, bp = ploc
                lc, sc, bc = kloc
                ea_loc.setdefault((lp, lc), [[] for _ in range(S)])[sp_]\
                    .append((bc, bp, pslot))
            elif kk == "loc" and pk == "top":
                lc, sc, bc = kloc
                lp, bp = ploc
                cross_out.setdefault(lc, [[] for _ in range(S)])[sc]\
                    .append((bc, croff[k], nr))
                cross_in.setdefault(lp, []).append((croff[k], nr, bp, pslot))
            else:  # top -> top
                lp, bp = ploc
                lc, bc = kloc
                ea_top.setdefault((lp, lc), []).append((bc, bp, pslot))

        def _pack_group(entries, NR):
            """[(bc, bp, psl)] -> (srcb (C,), dstb (C,), psl (C, NR))."""
            C = max(len(entries), 1)
            srcb = np.zeros(C, dtype=np.int64)
            dstb = np.zeros(C, dtype=np.int64)
            psl = np.full((C, NR), -1, dtype=np.int64)
            for i, (bc, bp, ps) in enumerate(entries):
                srcb[i] = bc
                dstb[i] = bp
                psl[i, : len(ps)] = ps
            return srcb, dstb, psl

        def _pack_group_sharded(per_shard, NR):
            packed = [_pack_group(per_shard[s], NR) for s in range(S)]
            C = max(p0[0].shape[0] for p0 in packed)
            srcb = np.zeros((S, C), dtype=np.int64)
            dstb = np.zeros((S, C), dtype=np.int64)
            psl = np.full((S, C, NR), -1, dtype=np.int64)
            for s, (sb, db, ps) in enumerate(packed):
                srcb[s, : sb.shape[0]] = sb
                dstb[s, : db.shape[0]] = db
                psl[s, : ps.shape[0]] = ps
            return srcb, dstb, psl

        def ea_tables(m, mc, srcb, dstb, psl):
            return (self._dev("ea srcb", srcb, mc.B),
                    self._dev("ea dstb", dstb, m.B),
                    self._dev("ea psl", psl, m.NF, dead_below_zero=True))

        # -- row-distributed solve-phase spaces -------------------------------
        # Per-shard COMPACT column space instead of O(n) full-length solve
        # buffers: shard s's space is the union of its supernodes' column
        # ranges ([0, M_s)) plus a copy of the replicated top set at
        # [Mmax, Mmax+TOPM). Local fronts only ever touch own columns and
        # top rows (proportional mapping invariant), so every ccol/crow id
        # translates into this space: per-shard solve memory is
        # O(n/S + |top|), the cuDSS row-1d distributed-RHS contract.
        topset: set = set()
        for ks in top_fronts:
            for k2 in ks:
                topset.update(range(int(ptr[k2]), int(ptr[k2 + 1])))
                topset.update(int(r) for r in rows_of[k2])
        topids = np.array(sorted(topset), dtype=np.int64)
        self.TOPM = TOPM = len(topids)
        topmap = np.full(n + 1, TOPM, dtype=np.int64)
        if TOPM:
            topmap[topids] = np.arange(TOPM)
        loc_lists = [[] for _ in range(S)]
        for k2 in range(ns):
            if owner[k2] >= 0:
                loc_lists[int(owner[k2])].append(
                    np.arange(int(ptr[k2]), int(ptr[k2 + 1])))
        cid = [np.sort(np.concatenate(ll)) if ll else np.zeros(0, np.int64)
               for ll in loc_lists]
        self.Ms = np.array([len(c) for c in cid], dtype=np.int64)
        Mmax = int(self.Ms.max()) if S else 0
        self.Mmax = Mmax

        self.SVPAD = round_up(max(Mmax + TOPM, 1))   # in-plan out_pad
        SENT = self.SVPAD                             # sentinel slot (zeroed)
        # per-shard translation: global permuted id -> compact slot
        cmap = np.full((S, n + 1), SENT, dtype=np.int64)
        for s in range(S):
            cmap[s, cid[s]] = np.arange(len(cid[s]))
        if TOPM:
            cmap[:, topids] = Mmax + topmap[topids][None, :]
        self._cid, self._topids = cid, topids

        # -- solve gather maps (translated into the compact spaces) -----------
        def pack_cols(m, fronts_by_slot, is_top):
            def one(frs, s):
                cc = np.full((m.B, m.NC), n, dtype=np.int64)
                cr = np.full((m.B, m.NF - m.NC), n, dtype=np.int64)
                for b, k in enumerate(frs):
                    j0, j1 = int(ptr[k]), int(ptr[k + 1])
                    cc[b, : j1 - j0] = np.arange(j0, j1)
                    cr[b, : len(rows_of[k])] = rows_of[k]
                if is_top:
                    return topmap[cc], topmap[cr]   # sentinel -> TOPM
                return cmap[s, cc], cmap[s, cr]     # sentinel -> SENT
            if is_top:
                cc, cr = one(fronts_by_slot, None)
                hi = TOPM + 1
            else:
                ccs, crs = zip(*[one(fronts_by_slot[s], s) for s in range(S)])
                cc, cr = np.stack(ccs), np.stack(crs)
                hi = SENT + 1
            # the scatter-add of the updates: one sentinel slot for all the
            # padding would serialize the adds on it (sorted or atomic), so
            # the padding adds masked zeros at spread real slots
            live = cr != hi - 1
            spread = np.arange(cr.size, dtype=np.int64).reshape(cr.shape) \
                % (hi - 1)
            add = np.where(live, cr, spread)
            if is_top:
                base = np.zeros(1, np.int64)
            else:
                cc, cr, live, add = (self._mine(a)
                                     for a in (cc, cr, live, add))
                base = np.arange(len(cc), dtype=np.int64)[:, None, None] * hi
            m.ccol = self._dev("ccol", cc, hi)
            m.crow = self._dev("crow", cr, hi)
            m.crow_add = self._dev("crow_add", (base + add).reshape(-1),
                                   base.size * hi)
            m.crow_live = self.backend.tensor(live[..., None])
            # the kernel's live counts: a front's live columns and update
            # rows come first, its padding after them
            livec = cc != hi - 1
            ncol, nrow = livec.sum(-1), live.sum(-1)
            if not (np.array_equal(livec, np.arange(m.NC) < ncol[..., None])
                    and np.array_equal(live, np.arange(m.NF - m.NC)
                                       < nrow[..., None])):
                raise AssertionError("device_mf: a front's live columns or "
                                     "update rows are not a prefix of its "
                                     "padded ones")
            m.ncol = self.backend.tensor(ncol.astype(np.int32))
            m.nrow = self.backend.tensor(nrow.astype(np.int32))

        # -- finalize static tables -------------------------------------------
        for l, m in enumerate(self.local_levels):
            pack_asm(m, l, False)
            pack_diag(m, loc_fronts[l], False)
            pack_cols(m, loc_fronts[l], False)
            for (lp, lc), per_shard in sorted(x for x in ea_loc.items()
                                              if x[0][0] == l):
                mc = self.local_levels[lc]
                m.ea.append((lc,) + ea_tables(m, mc, *(
                    self._mine(a) for a in
                    _pack_group_sharded(per_shard, mc.NF - mc.NC))))
        for l, m in enumerate(self.top_levels):
            pack_asm(m, l, True)
            pack_diag(m, top_fronts[l], True)
            pack_cols(m, top_fronts[l], True)
            for (lp, lc), entries in sorted(x for x in ea_top.items()
                                            if x[0][0] == l):
                mc = self.top_levels[lc]
                m.ea.append((lc,) + ea_tables(
                    m, mc, *_pack_group(entries, mc.NF - mc.NC)))
            if l in cross_in:
                entries = cross_in[l]
                NRX = max(len(e[3]) for e in entries)
                C = len(entries)
                co = np.zeros(C, dtype=np.int64)
                nrv = np.zeros(C, dtype=np.int64)
                dstb = np.zeros(C, dtype=np.int64)
                psl = np.full((C, NRX), -1, dtype=np.int64)
                for i, (o, nr, bp, ps) in enumerate(entries):
                    co[i], nrv[i], dstb[i] = o, nr, bp
                    psl[i, : len(ps)] = ps
                self._check_cross(co, nrv)
                m.ea_cross.append((self._dev("cross co", co, self.CROSS),
                                   self._dev("cross nr", nrv, NRX + 1),
                                   self._dev("cross dstb", dstb, m.B),
                                   self._dev("cross psl", psl, m.NF,
                                             dead_below_zero=True), NRX))

        # cross scatter (per child level): update buffer -> (S, CROSS)
        self.cross_maps = []
        for lc, per_shard in sorted(cross_out.items()):
            C = max(max(len(per_shard[s]) for s in range(S)), 1)
            srcb = np.zeros((S, C), dtype=np.int64)
            co = np.full((S, C), self.CROSS, dtype=np.int64)  # padding: nr 0
            nrv = np.zeros((S, C), dtype=np.int64)
            for s in range(S):
                for i, (bc, o, nr) in enumerate(per_shard[s]):
                    srcb[s, i], co[s, i], nrv[s, i] = bc, o, nr
            self._check_cross(co, nrv)
            srcb, co, nrv = (self._mine(a) for a in (srcb, co, nrv))
            mc = self.local_levels[lc]
            self.cross_maps.append((lc, self._dev("cross srcb", srcb, mc.B),
                                    self._dev("cross co", co, self.CROSS + 1),
                                    self._dev("cross nr", nrv,
                                              mc.NF - mc.NC + 1)))

        # top column ids in the top-compact space (device)
        topcols = np.concatenate(
            [np.arange(int(ptr[k]), int(ptr[k + 1])) for k in range(ns)
             if owner[k] < 0]) if (owner < 0).any() else np.zeros(0, np.int64)
        self.n_topcols = len(topcols)
        self.topcols = self._dev("topcols", topmap[topcols], TOPM + 1)

        # -- RHS in-gather / solution out-scatter plans (natural order <->
        # compact solve spaces; the fill-reducing permutation is folded in)
        from ..parallel.exchange import ExchangePlan
        from ..partition import global_to_local, padded_size, uniform_partition
        from ..ops.gather import gather_exchange_plan

        rp = row_partition
        # the row partition comes from the wrapping DistSparseMatrix;
        # DeviceMF itself is partition-agnostic: default to the uniform split
        if rp is None:
            rp = uniform_partition(n, S)
        self.row_partition = rp
        perm = sym.perm
        wanted = []
        for s in range(S):
            w = perm[cid[s]]
            if s == 0 and TOPM:
                filler = np.zeros(Mmax - len(w), dtype=np.int64)
                w = np.concatenate([w, filler, perm[topids]])
            wanted.append(w)
        self.in_plan = gather_exchange_plan(backend, rp, wanted,
                                            out_len=Mmax + TOPM)
        if self.in_plan.out_pad != self.SVPAD:
            raise AssertionError("in_plan pad differs from the solve space")
        send = [[np.zeros(0, np.int64) for _ in range(S)] for _ in range(S)]
        recv = [[np.zeros(0, np.int64) for _ in range(S)] for _ in range(S)]
        for s in range(S):
            nats = perm[cid[s]]
            owners_o, locs = global_to_local(rp, nats)
            slots = np.arange(len(nats), dtype=np.int64)
            for d in range(S):
                mm = owners_o == d
                if mm.any():
                    send[s][d] = slots[mm]
                    recv[d][s] = locs[mm]
        if TOPM:
            # top columns: every shard holds the replicated copy — the
            # natural-row owner reads its OWN copy (pure self-traffic)
            tnat = perm[topids]
            towners, tlocs = global_to_local(rp, tnat)
            for d in range(S):
                mm = towners == d
                if mm.any():
                    send[d][d] = np.concatenate(
                        [send[d][d], Mmax + np.flatnonzero(mm)])
                    recv[d][d] = np.concatenate([recv[d][d], tlocs[mm]])
        self.out_plan = ExchangePlan(backend, send, recv, padded_size(rp))

    # ------------------------------------------------------------------
    def _mine(self, arr: np.ndarray) -> np.ndarray:
        """This process's rows of a per-shard (S, ...) host table: all of
        them stacked, its own on a group (the others are dropped here, so
        ranks sharing a card do not each hold every shard's tables)."""
        sh = self.backend.shards
        return arr[sh.start: sh.stop]

    def _dev(self, name, arr, hi, dead_below_zero=False) -> torch.Tensor:
        """A static index table on the device, after checking on the host
        that every entry lies in [0, hi) (or is a dead -1 slot where the
        table allows one): a device-side out-of-range index would kill the
        CUDA context."""
        check_index(f"device_mf {name}", arr, hi,
                    dead_below_zero=dead_below_zero)
        return self.backend.tensor(np.asarray(arr, np.int64))

    def _check_cross(self, co, nrv):
        """Every child's nr x nr block ends inside the cross buffer (the
        padding children, nr = 0, sit at offset CROSS)."""
        if (co + nrv * nrv > self.CROSS).any():
            raise IndexError("device_mf cross map: a block runs past the "
                             f"cross buffer ({self.CROSS})")

    # ------------------------------------------------------------------
    # numeric factorization, level by level
    # ------------------------------------------------------------------
    def _local_level_body(self, m, Av, upds, eps):
        """Assemble + extend-add + factor ONE local level batch of this
        process's shards (S stacked, or 1). Returns (fac tuple (S, B, ...),
        U (S, B, NR, NR), n_perturbed, failed)."""
        S = self.backend.nlocal
        B, NC, NF = m.B, m.NC, m.NF
        BNN = B * NF * NF
        ar = torch.arange(S, device=self.device)[:, None]
        # shard s's fronts and its sentinel slot: [s*(BNN+1), (s+1)*(BNN+1))
        off = ar * (BNN + 1)
        F = torch.zeros((S, BNN + 1), dtype=self.dtype, device=self.device)
        Ff = F.view(-1)
        Ff.index_add_(0, (m.a_dst + off).view(-1), Av[m.a_src].view(-1))
        Ff.index_fill_(0, (m.diag + off).view(-1), 1.0)
        for lc, srcb, dstb, psl in m.ea:
            dst, u = _ea_scatter(dstb, psl, NF, upds[lc][ar, srcb])
            Ff.index_add_(0, (dst.view(S, -1) + off).view(-1), u.view(-1))
        # drop the sentinel column: a view, no copy
        F4 = F[:, :BNN].view(S, B, NF, NF)
        return _front_kernel(self.kind, F4, NC, eps)

    def _cross_body(self, upds):
        """Local subtree roots' updates -> replicated cross contributions:
        one sum over the shard axis, and on a group over the ranks (the
        factorization's one collective)."""
        S = self.backend.nlocal
        cross = torch.zeros((S, self.CROSS), dtype=self.dtype,
                            device=self.device)
        ar = torch.arange(S, device=self.device)[:, None]
        off = ar * self.CROSS
        for lc, srcb, co, nrv in self.cross_maps:
            U = upds[lc]
            idx, valid = _cross_slots(co, nrv, U.shape[-1], self.CROSS)
            u = torch.where(valid, U[ar, srcb], 0)      # (S, C, NR, NR)
            cross.view(-1).index_add_(0, (idx.view(S, -1) + off).view(-1),
                                      u.view(-1))
        return comm.all_reduce(self.backend, cross.sum(dim=0))

    def _top_body(self, Av, crossp, eps):
        """Replicated top-tree factorization (small dense levels)."""
        npert = torch.zeros((), dtype=torch.int64, device=self.device)
        failed = torch.zeros_like(npert)
        tupds = []
        top_factors = []
        for m in self.top_levels:
            B, NC, NF = m.B, m.NC, m.NF
            BNN = B * NF * NF
            F = torch.zeros(BNN + 1, dtype=self.dtype, device=self.device)
            F.index_add_(0, m.a_dst, Av[m.a_src])
            F.index_fill_(0, m.diag, 1.0)
            for lc, srcb, dstb, psl in m.ea:
                dst, u = _ea_scatter(dstb, psl, NF, tupds[lc][srcb])
                F.index_add_(0, dst.view(-1), u.view(-1))
            for co, nrv, dstb, psl, NRX in m.ea_cross:
                idx, valid = _cross_slots(co, nrv, NRX, self.CROSS)
                vals_c = torch.where(valid, crossp[idx], 0)  # (C, NRX, NRX)
                dst, u = _ea_scatter(dstb, psl, NF, vals_c)
                F.index_add_(0, dst.view(-1), u.view(-1))
            fac, U, p, f = _front_kernel(self.kind, F[:BNN].view(B, NF, NF),
                                         NC, eps)
            npert = npert + p
            failed = failed + f
            tupds.append(U)
            top_factors.append(fac)
        return top_factors, npert, failed

    def factor(self, Avals, eps):
        """Avals: (nnzA,) values in global CSR order on the device; eps: the
        static-pivot threshold, a float or a 0-d tensor (taken as it is
        when it is already one in the engine's real dtype on its device).
        Returns (local factors, top factors, (n_perturbed, failed) of this
        process's local fronts, (n_perturbed, failed) of the replicated top
        tree), the counts 0-d device tensors. Reads nothing on the host."""
        dt = self.dtype
        Av = torch.cat([Avals.to(dt), Avals.new_zeros(1, dtype=dt)])
        eps = torch.as_tensor(eps, dtype=dt.to_real(), device=self.device)
        upds = []          # per local level: (S, B, NR, NR)
        loc_factors = []
        npert = torch.zeros((), dtype=torch.int64, device=self.device)
        failed = torch.zeros_like(npert)
        for m in self.local_levels:
            fac, U, p, f = self._local_level_body(m, Av, upds, eps)
            npert = npert + p
            failed = failed + f
            upds.append(U)
            loc_factors.append(fac)
        crossp = self._cross_body(upds)
        del upds
        top_factors, ptop, ftop = self._top_body(Av, crossp, eps)
        return loc_factors, top_factors, (npert, failed), (ptop, ftop)

    # ------------------------------------------------------------------
    # solve: wave sweeps on INVERTED diagonal blocks (invert), so that
    # every per-level triangular solve is one batched matmul with the
    # precomputed L11^-1 / U11^-1. Inversion happens ONCE per
    # factorization (DeviceFactorization keeps the inverted factors); the
    # flop count of (inv @ rhs) equals substitution.
    # ------------------------------------------------------------------
    def invert(self, loc_factors, top_factors):
        """(loc, top) factors -> (loc, top) with every level's diagonal
        blocks inverted (``_inv_fac``): what ``solve_prepped`` takes."""
        return ([self._inv_fac(f) for f in loc_factors],
                [self._inv_fac(f) for f in top_factors])

    def _inv_fac(self, fac):
        """Replace the triangular diagonal blocks of one level's factor
        tuple with their inverses (unit-ness folded in)."""
        L11 = fac[0]
        nc = L11.shape[-1]
        eye = torch.eye(nc, dtype=L11.dtype, device=L11.device) \
            .expand(L11.shape)
        unit = self.kind != "chol"
        Li = torch.linalg.solve_triangular(L11, eye, upper=False,
                                           unitriangular=unit)
        if self.kind != "lu":
            return (Li,) + tuple(fac[1:])
        Ui = torch.linalg.solve_triangular(fac[1], eye, upper=True)
        return (Li, Ui) + tuple(fac[2:])

    def _fwd_ops(self, fac, tr=False):
        """The forward step's operands of one level's factor tuple (inverted
        diagonal blocks): (A, M, d) with w = A b, z = w / d (w where d is
        None) and the update M w. ``tr`` solves the transposed system (LU
        only: Aᵀ = Uᵀ Lᵀ, forward with Uᵀ)."""
        if self.kind == "ldl":
            return fac[0], fac[2], fac[1]
        if self.kind == "lu" and tr:   # Uᵀ z = b -> z = (U^-1)ᵀ b
            return fac[1].mT, fac[3].mT, None
        return fac[0], (fac[2] if self.kind == "lu" else fac[1]), None

    def _bwd_ops(self, fac, tr=False):
        """The backward step's operands: (A, M) with x = A (z − M xr), xr the
        ancestor solution rows. ``tr`` (LU only): backward with Lᵀ (unit)."""
        if self.kind == "lu" and not tr:
            return fac[1], fac[3]
        # Lᵀ x = z - L21ᵀ xr with L^-1 stored: chol, ldl and LU transposed
        return fac[0].mT, (fac[2] if self.kind == "lu" else fac[-1]).mT

    @staticmethod
    def _tables(m, top):
        """A level's solve tables with the shard axis (one for a top
        level): ccol, crow, crow_add, crow_live, ncol, nrow."""
        t = (m.ccol, m.crow, m.crow_add, m.crow_live, m.ncol, m.nrow)
        return tuple(x[None] if top and x is not m.crow_add else x
                     for x in t)

    def _fwd_step(self, m, fac, y, tr, top=False):
        """One level's forward step on y (S, rows, k) in place (a top
        level's on ytop[None]): one ``front_fwd`` launch where
        ``cuda_front_solve.front_route`` takes the level
        (``solver.front_steps_kernel``), else ``_fwd_plain``
        (``solver.front_steps_plain``)."""
        A, M, d = self._fwd_ops(fac, tr)
        if top:
            A, M, d = A[None], M[None], None if d is None else d[None]
        ccol, crow, crow_add, crow_live, ncol, nrow = self._tables(m, top)
        if cuda_front_solve.front_route(y.device, y.dtype, m.NC, m.NF,
                                        y.shape[-1]):
            count("solver.front_steps_kernel")
            cuda_front_solve.front_fwd(y, ccol, crow, ncol, nrow, A, M, d)
            return
        count("solver.front_steps_plain")
        _fwd_plain(y, ccol, crow_add, crow_live, A, M, d)

    def _bwd_step(self, m, fac, y, tr, top=False):
        """One level's backward step on y in place: one ``front_bwd``
        launch or ``_bwd_plain``, as ``_fwd_step`` decides."""
        A, M = self._bwd_ops(fac, tr)
        if top:
            A, M = A[None], M[None]
        ccol, crow, _add, _live, ncol, nrow = self._tables(m, top)
        if cuda_front_solve.front_route(y.device, y.dtype, m.NC, m.NF,
                                        y.shape[-1]):
            count("solver.front_steps_kernel")
            cuda_front_solve.front_bwd(y, ccol, crow, ncol, nrow, A, M)
            return
        count("solver.front_steps_plain")
        _bwd_plain(y, ccol, crow, A, M)

    def _solve_impl(self, loc_factors, top_factors, bloc, tr=False):
        # bloc: (S, SVPAD, k) — the in_plan gather of the row-distributed
        # RHS into the per-shard compact spaces (local columns at [0, M_s),
        # the replicated top copy at [Mmax, Mmax+TOPM) on shard 0 only);
        # (1, SVPAD, k), this process's shard, on a group. One buffer y
        # (and ytop for the top tree) carries b, z and x in place.
        dt = self.dtype
        S = self.backend.nlocal
        TOPM, Mmax = self.TOPM, self.Mmax
        k = bloc.shape[2]
        # the last row is the sentinel slot, kept zero
        y = torch.cat([bloc.to(dt), bloc.new_zeros((S, 1, k), dtype=dt)], 1)

        # forward, local phase (compact per-shard spaces)
        for m, fac in zip(self.local_levels, loc_factors):
            self._fwd_step(m, fac, y, tr)

        # forward, top phase: ONE cross-shard reduction of the compact top
        # region (b_top rides shard 0's slice; others carry only updates),
        # over the stack and on a group over the ranks
        ytop = torch.zeros((TOPM + 1, k), dtype=dt, device=self.device)
        if TOPM:
            ytop[:TOPM] = comm.all_reduce(
                self.backend, y[:, Mmax: Mmax + TOPM].sum(dim=0))
        for m, fac in zip(self.top_levels, top_factors):
            self._fwd_step(m, fac, ytop[None], tr, top=True)

        # backward, top phase (replicated compute on the compact top space)
        for m, fac in zip(reversed(self.top_levels), reversed(top_factors)):
            self._bwd_step(m, fac, ytop[None], tr, top=True)
        xtop = torch.zeros_like(ytop)
        if self.n_topcols:
            tc = self.topcols
            xtop[tc] = ytop[tc]

        # backward, local phase: every shard carries the top solution copy
        # in its [Mmax, Mmax+TOPM) region
        if TOPM:
            y[:, Mmax: Mmax + TOPM] = xtop[:TOPM]
        for m, fac in zip(reversed(self.local_levels), reversed(loc_factors)):
            self._bwd_step(m, fac, y, tr)

        return y  # (S, SENT+1, k); out_plan scatters to natural order

    def solve_prepped(self, prepped, b, tr: bool = False):
        """b (S, Lrow, k) on ``self.row_partition`` -> the solution stacked
        the same way, with ``prepped`` = ``invert``'s (loc, top) factors.
        in_plan gathers the RHS into the per-shard compact spaces, the wave
        solve runs on O(n/S + |top|) buffers, out_plan scatters the
        solution back to natural row order. ``tr``: the transposed system
        (LU). Reads nothing on the host."""
        bloc = self.in_plan.apply(b.to(self.dtype))
        return self.out_plan.apply(self._solve_impl(*prepped, bloc, tr))

    def solve_dist(self, factors, bstacked, transpose: bool = False):
        """Row-distributed solve: bstacked (S, Lrow[, k]) on
        ``self.row_partition`` -> solution stacked the same way, with
        ``factors`` = ``factor``'s (loc, top, ...): ``solve_prepped`` on
        the factors inverted here, for one call (``DeviceFactorization``
        inverts once a factorization and keeps the result)."""
        prepped = self.invert(factors[0], factors[1])
        b = bstacked
        squeeze = b.dim() == 2
        if squeeze:
            b = b[:, :, None]
        # chol/ldl are symmetric: transpose == plain solve
        tr = bool(transpose) and self.kind == "lu"
        x = self.solve_prepped(prepped, b, tr)
        return x[:, :, 0] if squeeze else x

    def solve(self, factors, b, transpose: bool = False):
        """Replicated-RHS convenience wrapper: (n[, k]) in, (n[, k]) out
        (scatter -> distributed solve -> gather)."""
        from ..parallel.mesh import allgather_full, scatter_from_full

        squeeze = b.dim() == 1
        if squeeze:
            b = b[:, None]
        bs = scatter_from_full(b, self.row_partition, self.backend)
        xs = self.solve_dist(factors, bs, transpose=transpose)
        x = allgather_full(xs, self.row_partition, self.backend)
        return x[:, 0] if squeeze else x


def device_engine(A, kind: str, dtype) -> DeviceMF:
    """The DeviceMF plan of A's pattern for ``kind`` in ``dtype``, built
    once per (pattern, kind, dtype, backend) and cached."""
    from ..cache import cached_plan

    def build():
        # pattern-only host CSR: the symbolic/plan phase never reads values
        return DeviceMF(A.pattern_csr(), A.backend, kind=kind, dtype=dtype,
                        row_partition=A.row_partition)

    return cached_plan("device_mf", (A.hash, kind, str(np.dtype(dtype)),
                                     A.backend.key), build)


def _leaves_amax(factors, like) -> torch.Tensor:
    """The largest |entry| of a list of factor tuples as a 0-d f64 tensor
    on ``like``'s device (0 for none)."""
    leaves = [x for fac in factors for x in fac if x.numel()]
    if not leaves:
        return like.new_zeros((), dtype=torch.float64)
    return torch.stack([torch.abs(x).amax().to(torch.float64)
                        for x in leaves]).amax()


def _pert_eps(Avals, real_dtype) -> torch.Tensor:
    """The static-pivot threshold relative to the largest |value| (1 for a
    zero matrix; no floor) as a 0-d tensor in ``real_dtype`` on the
    values' device: the host engine's arithmetic in f64, rounded once to
    ``real_dtype``, with no host read."""
    f64 = torch.float64
    anorm = torch.abs(Avals).amax().to(f64) if Avals.numel() \
        else Avals.new_zeros((), dtype=f64)
    return (_PERT_REL * torch.where(anorm > 0, anorm, 1.0)).to(real_dtype)


def _factor_program(engine, Avals, eps):
    """The work of one factorization, on the device with no host read (the
    factor graph's body; the JAX engine's ``_factor_jit``, ``_prep_jit``,
    ``_max_abs`` and ``_all_finite``): ``engine.factor``, the inversion of
    every diagonal block (``engine.invert``) and the global counts and
    growth. The local fronts' counts and growth are this process's: one
    gather makes them the group's, and the replicated top tree's are added
    once. Returns (local factors, top factors, the inverted (loc, top),
    a (3,) f64 tensor [n_perturbed, failed Cholesky fronts, growth])."""
    loc, top, (p_loc, f_loc), (p_top, f_top) = engine.factor(Avals, eps)
    prepped = engine.invert(loc, top)
    f64 = torch.float64
    rows = comm.all_gather_rows(engine.backend, torch.stack(
        [p_loc.to(f64), f_loc.to(f64), _leaves_amax(loc, p_loc)])[None])
    stats = torch.stack(
        [rows[:, 0].sum() + p_top, rows[:, 1].sum() + f_top,
         torch.maximum(rows[:, 2].max(), _leaves_amax(top, p_loc))])
    return loc, top, prepped, stats


class DeviceFactorization:
    """Factorization interface over the DeviceMF engine (ref:
    MUMPSFactorization / CuDSSFactorizationMPI). The RHS and solution stay
    on the device end to end: gather in, wave solves, scatter out.

    On the card the factorization is compiled as the JAX engine compiles
    it: ``_factor_program`` is captured once as a CUDA graph over static
    copies of the gathered values and eps (``utils/graphs.CapturedStep``)
    and each ``refactorize`` copies the new values in and replays it; each
    solve replays a graph of ``engine.solve_prepped`` captured at the first
    solve of its RHS width and transpose (a new width captures a new
    graph, as ``jax.jit`` retraces). The graphs and their memory pools
    belong to the factorization, not to the engine that every
    factorization of the pattern shares; ``finalize`` drops them. A solve
    returns a tensor the caller owns. On a NCCL group the factor's cross
    ``all_reduce`` and count gather and the solve's ``all_reduce`` are in
    the graphs. On CPU tensors and on a gloo group (which stages CUDA
    tensors through the host) the same bodies run eagerly: ``refusal``
    says why (None when graphed). A capture that fails raises.
    """

    def __init__(self, A, kind: str = "ldl", dtype=None):
        self.A = A
        self.backend = A.backend
        self.structural_hash = A.hash
        if A.dtype.is_complex and kind == "chol":
            raise ValueError("device Cholesky is real-SPD only; use "
                             "kind='ldl' for complex-symmetric systems")
        # the engine runs in the matrix's own dtype: the card has native
        # f64 and complex arithmetic
        self.dtype = numpy_dtype(A.dtype if dtype is None else dtype)
        self.kind = kind
        self.engine = device_engine(A, kind, self.dtype)
        self.refusal = graphs.refusal(self.backend, (A.nzval,))
        self._factor_graph = None
        self._solve_graphs = {}   # (RHS width, transposed) -> CapturedStep
        self._numeric(A)

    def _numeric(self, A):
        from ..parallel.mesh import allgather_full

        st = A.structure
        nnzb = np.concatenate([[0], np.cumsum(st.nnz_local)]).astype(np.int64)
        Avals = allgather_full(A.nzval, nnzb, self.backend)  # (nnzA,) device
        # the norm of the gathered values: the same eps, and so the same
        # top pivots' clamp, in every rank of a group
        eps = _pert_eps(Avals, self.engine.dtype.to_real())
        Avals = Avals.to(self.engine.dtype)
        # drop the previous factors BEFORE factoring: old + new + temps
        # together may not fit the device (a replay rewrites them in place)
        self.factors = self._prepped = self._A64 = None
        if self.refusal is not None:
            loc, top, self._prepped, stats = _factor_program(
                self.engine, Avals, eps)
        else:
            if self._factor_graph is None:
                eng = self.engine
                self._factor_graph = graphs.CapturedStep(
                    lambda a, e: _factor_program(eng, a, e), (Avals, eps),
                    name="solver_factor")
            loc, top, self._prepped, stats = self._factor_graph(Avals, eps)
        # growth monitor: the device engine has no numerical pivoting, so a
        # legal-but-tiny pivot shows up as large |L| growth; flag it and
        # escalate the solve to the full-budget extended refinement (the
        # eps clamp alone only catches |pivot| < eps). The one host read
        # of a factorization: the perturbation count, the failure count
        # and the growth.
        np_, nfail, g = stats.tolist()
        count("solver.host_reads")
        self.factors = (loc, top, int(np_))
        self.n_perturbed = int(np_)
        # the reference reads the growth in f32
        self.growth = float(np.float32(g))
        self._unstable = (self.n_perturbed > 0
                          or self.growth > _GROWTH_MAX_DEV)
        if self.kind == "chol" and (nfail > 0 or not np.isfinite(g)):
            raise ValueError("device Cholesky requires an SPD matrix "
                             "(use kind='ldl' for indefinite systems)")

    def refactorize(self, A) -> "DeviceFactorization":
        if A.hash != self.structural_hash:
            raise ValueError("refactorize requires the same sparsity pattern")
        self.A = A
        with span("solver.refactorize"):
            self._numeric(A)
        return self

    def _default_refine(self) -> int:
        """Sweep CAP, not a fixed count: the loop exits as soon as the
        residual reaches dtype noise."""
        return 1 if self.n_perturbed == 0 else 2

    @staticmethod
    def _part_of(o):
        """Row partition of a DistVector (.partition) or matrix."""
        p = getattr(o, "partition", None)
        return p if p is not None else o.row_partition

    def _solve_dist(self, b, transpose: bool):
        """``engine.solve_dist`` on this factorization's inverted factors:
        b (S, Lrow[, k]) in, the solution stacked the same way out, a
        tensor the caller owns. On the card it replays the solve graph of
        b's width and ``transpose``, captured at its first use."""
        tr = bool(transpose) and self.kind == "lu"
        squeeze = b.dim() == 2
        b3 = (b[:, :, None] if squeeze else b).to(self.engine.dtype)
        if self.refusal is not None:
            x = self.engine.solve_prepped(self._prepped, b3, tr)
        else:
            key = (b3.shape[2], tr)
            step = self._solve_graphs.get(key)
            if step is None:
                eng, prepped = self.engine, self._prepped
                step = self._solve_graphs[key] = graphs.CapturedStep(
                    lambda bb: eng.solve_prepped(prepped, bb, tr), (b3,),
                    name="solver_solve")
            # the graph rewrites its output at the next replay
            x = step(b3).clone()
        return x[:, :, 0] if squeeze else x

    def _refined_solve(self, Bd, transpose, refine, to_dist, extended=None):
        """Solve + capped early-stopping iterative refinement with device
        residuals through the distributed SpMV/SpMM: compensates
        static-pivot perturbations. Stops when the relative residual
        reaches dtype noise or stagnates. ``extended`` (default: on for an
        f32 engine) carries the solution in f64 with f64 residuals
        (_extended_refine)."""
        if self._unstable and extended is not False:
            # growth-flagged factorization: spend the full extended budget
            # — refinement is what recovers the lost accuracy
            extended = True
        explicit_ext = extended is True
        if extended is None:
            extended = self.engine.dtype == torch.float32
        # the RHS stays row-distributed end to end: align it to the
        # engine's partition once
        part = self.engine.row_partition
        if not np.array_equal(self._part_of(Bd), part):
            Bd = Bd.repartition(part)
        Xs = self._solve_dist(Bd.data, transpose)
        Xd = to_dist(Xs)
        if not refine:
            return Xd
        if extended:
            ext = self._extended_refine(Bd, Xs, transpose, refine,
                                        full_budget=explicit_ext)
            if ext is not None:
                return ext
        Aop = self.A.T if transpose else self.A
        rtol = 50 * torch.finfo(self.engine.dtype).eps
        bn = float(Bd.norm())
        count("solver.host_reads")
        prev = np.inf
        for _ in range(refine):
            R = Bd - Aop @ Xd
            rn = float(R.norm())
            count("solver.host_reads")
            if bn > 0 and (rn <= rtol * bn or rn >= 0.8 * prev):
                break
            prev = rn
            if not np.array_equal(self._part_of(R), part):
                R = R.repartition(part)
            count("solver.refine_sweeps")
            Xs = Xs + self._solve_dist(R.data, transpose)
            Xd = to_dist(Xs)
        return Xd

    # extended refinement: stop once the f64 relative residual reaches
    # 5e-10, or after a sweep that shrinks it by less than 10 %. The
    # full-budget cap binds only on a growth-flagged factorization.
    _EXT_RTOL = 5e-10
    _EXT_MAX_SWEEPS = 24

    def _extended_refine(self, Bd, Xs, transpose, refine,
                         full_budget: bool = False):
        """Iterative refinement of an f32 factorization to an f64-class
        relative residual (about 1e-9): the solution is carried in f64 and
        the residual runs through the same SpMV plan on an f64 copy of A.
        Returns the f64 DistVector, or None for a matrix RHS or another
        engine dtype (the caller then runs the plain loop)."""
        from ..vector import DistVector

        if self.engine.dtype != torch.float32 or not isinstance(Bd, DistVector):
            return None
        if self._A64 is None:
            self._A64 = self.A.with_values(self.A.nzval.to(torch.float64))
        Aop = self._A64.T if transpose else self._A64
        part = self.engine.row_partition
        b64 = DistVector(Bd.data.to(torch.float64), part, self.backend)
        x64 = Xs.to(torch.float64)
        bn = float(b64.norm())
        count("solver.host_reads")
        prev = np.inf
        cap = max(refine, self._EXT_MAX_SWEEPS) if full_budget \
            else refine + 3
        for _ in range(cap):
            r = b64 - Aop @ DistVector(x64, part, self.backend)
            rn = float(r.norm())
            count("solver.host_reads")
            if bn > 0 and (rn <= self._EXT_RTOL * bn or rn >= 0.9 * prev):
                break
            prev = rn
            if not np.array_equal(r.partition, part):
                r = r.repartition(part)
            count("solver.refine_sweeps")
            x64 = x64 + self._solve_dist(
                r.data.to(torch.float32), transpose).to(torch.float64)
        return DistVector(x64, part, self.backend)

    def solve(self, b, transpose: bool = False, refine: int | None = None,
              extended: bool | None = None):
        """Solve A x = b (or Aᵀ x = b). ``b``: DistVector (the solution is
        a DistVector in b's dtype on A's row partition) or host array (the
        solution is a host array; f64 after an extended refinement)."""
        from ..parallel.mesh import scatter_from_full
        from ..vector import DistVector

        with span("solver.solve"):
            if self.factors is None:
                raise RuntimeError("factorization was finalized")
            if refine is None:
                refine = self._default_refine()
            is_dist = isinstance(b, DistVector)
            part = self.A.row_partition
            if not is_dist:
                # host-array RHS refines through the same distributed path
                b = DistVector(scatter_from_full(
                    self.backend.tensor(np.asarray(b)), part, self.backend),
                    part, self.backend)
            count("solver.rhs_columns")

            def to_dist(xs):
                # xs arrives stacked/row-distributed from solve_dist
                return DistVector(xs.to(b.dtype), part, self.backend)

            xd = self._refined_solve(b, transpose, refine, to_dist,
                                     extended=extended)
            if not is_dist:
                return xd.to_numpy()
            return xd if xd.dtype == b.dtype else to_dist(xd.data)

    def solve_transpose(self, b, refine: int | None = None):
        """Solve Aᵀ x = b: ``solve(b, transpose=True)``, as the host
        engine's ``Factorization.solve_transpose``."""
        return self.solve(b, transpose=True, refine=refine)

    def solve_matrix(self, B, transpose: bool = False,
                     refine: int | None = None,
                     extended: bool | None = None):
        """Multi-RHS device solve: one batched wave sweep for all columns
        (ref: MUMPS multi-RHS, mumps_factorization.jl:291-353), with the
        same capped early-stopping refinement as the vector path (the
        residual is one distributed SpMM per sweep)."""
        from ..dense import DistDenseMatrix
        from ..parallel.mesh import scatter_from_full

        with span("solver.solve_matrix"):
            if self.factors is None:
                raise RuntimeError("factorization was finalized")
            if refine is None:
                refine = self._default_refine()
            is_dist = isinstance(B, DistDenseMatrix)
            part = self.A.row_partition
            if not is_dist:
                Bg = self.backend.tensor(np.asarray(B))
                B = DistDenseMatrix(scatter_from_full(Bg, part, self.backend),
                                    part, Bg.shape[1], self.backend)
            k = B.ncols
            count("solver.rhs_columns", k)

            def to_dist(Xs):
                return DistDenseMatrix(Xs.to(B.dtype), part, k, self.backend)

            Xd = self._refined_solve(B, transpose, refine, to_dist,
                                     extended=extended)
            return Xd if is_dist else Xd.to_numpy()

    def finalize(self):
        """Drops the factors and this factorization's graphs, with their
        memory pools."""
        self.factors = self._prepped = self._A64 = None
        self._factor_graph = None
        self._solve_graphs = {}
