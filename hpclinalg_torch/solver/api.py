"""Solver API: lu / ldlt / solve with the reference's backslash cache.

Port of the JAX package's ``hpclinalg/solver/api.py``.
Reference semantics (src/mumps_factorization.jl, HPCLinearAlgebra.jl:
626-744):
  * ``lu(A)`` / ``ldlt(A)`` return a Factorization; ``F.solve(b)`` solves.
  * ``solve(A, b)`` (the ``A \\ b`` analogue) consults a cache keyed by
    (structural hash, kind, dtype, solver): a hit re-uses the symbolic
    analysis and only refreshes values + refactorizes, through a cached
    CSR -> permuted CSC value permutation (the reference's ``nzval_perm``).
  * transpose solves and ``finalize`` are supported.

Numeric phases of the host engine run in the native C++ engine
(native/mf.cpp, BLAS fronts) for float64/complex128, with the numpy
multifrontal as fallback. ``method="device"`` (or a backend built with
``solver="device"``) selects the device multifrontal engine
(``solver/device_mf.py``).

On a process group the host engine runs on rank 0 alone: every rank
all-gathers A's values and the right-hand side (collectives, so every
rank takes them, cached or not), rank 0 factors and solves, and the
solution is broadcast; each rank keeps its rows. The other ranks hold a
handle that only takes part in the collectives. Rank 0 alone factors
because the symbolic analysis picks its ordering by timing a trial
factorization (``symbolic.analyze_fastest``): ranks could pick different
orderings and return rows of slightly different solutions.
"""

from __future__ import annotations

import numpy as np

from ..backend import numpy_dtype
from ..cache import cached_plan, plan_cache
from ..parallel import comm
from .multifrontal import NumericFactor, factorize, solve_factored, _PERT_REL
from .native import NativeFactor, load_mf
from .symbolic import SymbolicFactor, analyze_best, analyze_fastest


def _is_complex(dtype) -> bool:
    return np.issubdtype(numpy_dtype(dtype), np.complexfloating)


def _get_symbolic(A) -> SymbolicFactor:
    """Symbolic analysis cached per sparsity pattern — shared by lu/ldlt and
    every refactorization."""
    return cached_plan("symbolic", (A.hash,),
                       lambda: analyze_fastest(A.pattern_csr()))


def _perm_csc(A_csr, iperm_rows, iperm_cols):
    n = A_csr.shape[0]
    coo = A_csr.tocoo()
    r2 = iperm_rows[coo.row]
    c2 = iperm_cols[coo.col]
    order = np.lexsort((r2, c2))  # CSC: by column, then row
    indices = r2[order].astype(np.int64)
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.add.at(indptr, c2[order] + 1, 1)
    indptr = np.cumsum(indptr).astype(np.int64)
    return indptr, indices, order.astype(np.int64)


def _get_perm_csc(A, sym):
    """Cached permuted-CSC pattern + the CSR-data -> permuted-CSC-data map
    (the reference's nzval_perm, mumps_factorization.jl:105-140)."""
    return cached_plan("solver_perm", (A.hash,),
                       lambda: _perm_csc(A.pattern_csr(), sym.iperm, sym.iperm))


def _colperm_matching(A_host) -> np.ndarray | None:
    """MC64-role maximum-product transversal: a column permutation cperm
    with A[i, cperm[i]] large, via min-weight full bipartite matching on
    -log(|a| / rowmax). None when structurally singular or the identity
    already matches."""
    import scipy.sparse as sp
    from scipy.sparse.csgraph import min_weight_full_bipartite_matching

    M = sp.csr_matrix(abs(A_host))
    n = M.shape[0]
    if M.nnz == 0:
        return None
    rowmax = np.maximum(np.asarray(abs(M).max(axis=1).todense()).ravel(),
                        1e-300)
    W = M.tocoo()
    w = 1e-3 - np.log(np.maximum(W.data, 1e-300) / rowmax[W.row])
    Wm = sp.csr_matrix((w, (W.row, W.col)), shape=M.shape)
    try:
        rows_i, cols_i = min_weight_full_bipartite_matching(Wm)
    except ValueError:  # structurally singular
        return None
    if len(rows_i) < n:
        return None
    cperm = np.empty(n, np.int64)
    cperm[rows_i] = cols_i
    if np.array_equal(cperm, np.arange(n)):
        return None
    return cperm


def _cperm_key(cperm) -> str:
    import hashlib

    return hashlib.blake2b(cperm.tobytes(), digest_size=12).hexdigest()


def _get_symbolic_cp(A, cperm) -> SymbolicFactor:
    """Symbolic analysis of the column-permuted pattern A[:, cperm]."""

    def build():
        import scipy.sparse as sp

        pat = A.pattern_csr()
        icperm = np.argsort(cperm)
        B = sp.csr_matrix((pat.data, icperm[pat.indices], pat.indptr),
                          shape=pat.shape)
        B.sort_indices()
        return analyze_best(B)

    return cached_plan("symbolic", (A.hash, "cp", _cperm_key(cperm)), build)


def _get_perm_csc_cp(A, sym, cperm):
    """_get_perm_csc for the column-permuted system B = A[:, cperm]."""
    return cached_plan(
        "solver_perm", (A.hash, "cp", _cperm_key(cperm)),
        lambda: _perm_csc(A.pattern_csr(), sym.iperm,
                          sym.iperm[np.argsort(cperm)]))


class Symmetric:
    """Marker asserting symmetry for solves — the analogue of wrapping in
    LinearAlgebra.Symmetric before backslash."""

    def __init__(self, A):
        self.A = A

    def __matmul__(self, o):
        return self.A @ o

    @property
    def shape(self):
        return self.A.shape


class _CSCView:
    __slots__ = ("indptr", "indices", "data")

    def __init__(self, indptr, indices, data):
        self.indptr, self.indices, self.data = indptr, indices, data


class Factorization:
    """LDLᵀ/LU factorization handle on the host engine (ref:
    MUMPSFactorization, mumps_factorization.jl:42). On a process group
    only rank 0 (``root``) holds the factors; every rank reports rank 0's
    ``n_perturbed``."""

    _GROWTH_MAX = 1e8

    def __init__(self, A, kind: str):
        self.A = A
        self.kind = kind
        self.backend = A.backend
        self.root = A.backend.rank == 0
        self.structural_hash = A.hash
        self.dtype = np.dtype(np.complex128 if _is_complex(A.dtype)
                              else np.float64)
        self._A_host = None
        self._csc_buf = None
        self._growth: float | None = None
        self._finalized = False
        self._n_perturbed = 0   # rank 0's count, on every rank of a group
        self.cperm: np.ndarray | None = None  # MC64-role column permutation
        self.sym = _get_symbolic(A) if self.root else None
        self._lib = load_mf() if self.root else None
        self.native: NativeFactor | None = (
            NativeFactor(self.sym, self.dtype) if self._lib is not None else None)
        self.num: NumericFactor | None = None
        self._numeric(A)

    def _numeric(self, A):
        raw = A.host_values()   # every rank: a collective on a group
        if self.root:
            self._factor(A, raw)
        if self.backend.is_dist:
            # one broadcast, so that no rank branches on a count it lacks
            t = self.backend.tensor([self._local_perturbed()], np.int64)
            self._n_perturbed = int(comm.broadcast(self.backend, t).item())

    def _factor(self, A, raw):
        vals = raw.astype(self.dtype, copy=False)
        # host CSR copy for refinement residuals; its value refresh is lazy
        # (only refinement and escalation read it). Rows are deliberately
        # left unsorted so the storage-order value refresh stays aligned.
        self._A_vals = vals
        if self._A_host is None:
            M = A.pattern_csr().astype(self.dtype)
            M.data[:] = vals
            self._A_host = M
            self._A_host_stale = False
        else:
            self._A_host_stale = True
        if self.native is None:
            self.num = factorize(self.sym, A.csr_with(raw), self.kind)
            return
        anorm = float(np.abs(vals).max()) if vals.size else 0.0
        # relative threshold (no 1.0 floor: it would perturb every pivot of
        # a small-magnitude matrix)
        eps = _PERT_REL * (anorm if anorm > 0 else 1.0)
        csc = self._csc_for(A, vals)
        self._growth = None
        self.native.factorize(self._lib, csc, self.kind, eps,
                              pivot=self.cperm is not None)
        if self._unstable():
            # a static perturbation fired, or the factor shows large element
            # growth: escalate to the within-front pivoted kernels (BK LDLt /
            # partial-pivot LU — the MUMPS CNTL(1) role)
            self._growth = None
            self.native.factorize(self._lib, csc, self.kind, eps, pivot=True)
        if self._unstable() and self.kind == "lu" and self.cperm is None:
            # in-front pivoting exhausted its candidates: refactor on the
            # MC64-role column permutation (the MUMPS ICNTL(6) role)
            cperm = _colperm_matching(self._host_matrix())
            if cperm is not None:
                self.cperm = cperm
                self.sym = _get_symbolic_cp(A, cperm)
                self.native = NativeFactor(self.sym, self.dtype)
                self._growth = None
                self.native.factorize(self._lib, self._csc_for(A, vals),
                                      self.kind, eps, pivot=True)

    def _host_matrix(self):
        """The host CSR copy with CURRENT values (lazy refresh)."""
        if self._A_host_stale:
            self._A_host.data[:] = self._A_vals
            self._A_host_stale = False
        return self._A_host

    def _factor_growth(self) -> float:
        """Max |L| entry, from the native factorize pass; memoized per
        numeric factorization."""
        if self._growth is None:
            self._growth = float(getattr(self.native, "growth", 0.0))
        return self._growth

    def _unstable(self) -> bool:
        return (self.native.n_perturbed > 0
                or self._factor_growth() > self._GROWTH_MAX)

    def _csc_for(self, A, vals):
        if self.cperm is None:
            indptr, indices, nzmap = _get_perm_csc(A, self.sym)
        else:
            indptr, indices, nzmap = _get_perm_csc_cp(A, self.sym, self.cperm)
        # reusable permuted-value buffer: the native factorize reads it
        # synchronously, so reuse across refactorizations is safe
        buf = self._csc_buf
        if buf is None or buf.size != nzmap.size or buf.dtype != vals.dtype:
            buf = self._csc_buf = np.empty(nzmap.size, vals.dtype)
        np.take(vals, nzmap, out=buf)
        return _CSCView(indptr, indices, buf)

    # -- refactorization: same pattern, new values --------------------------
    def refactorize(self, A) -> "Factorization":
        if A.hash != self.structural_hash:
            raise ValueError("refactorize requires the same sparsity pattern")
        new_dtype = np.dtype(np.complex128 if _is_complex(A.dtype)
                             else np.float64)
        if new_dtype != self.dtype:
            # value dtype changed on the same pattern: rebuild the numeric
            # engine instead of silently casting to the stale dtype
            self.dtype = new_dtype
            self._A_host = None
            self._csc_buf = None
            self.native = (NativeFactor(self.sym, self.dtype)
                           if self._lib is not None else None)
            self.num = None
        self.A = A
        self._numeric(A)
        return self

    def _solve_host(self, bh: np.ndarray, transpose: bool) -> np.ndarray:
        if self.native is None:
            return solve_factored(self.num, bh, transpose=transpose)
        if self.cperm is None:
            return self.native.solve(self._lib, bh, transpose=transpose)
        # factor is of B = A[:, cperm]:  A x = b  <=>  B y = b with
        # x[cperm] = y;  A^T x = b  <=>  B^T x = b[cperm]
        if transpose:
            return self.native.solve(self._lib, bh[self.cperm], transpose=True)
        y = self.native.solve(self._lib, bh, transpose=False)
        x = np.empty_like(y)
        x[self.cperm] = y
        return x

    def _solve_multi_host(self, Bh: np.ndarray, transpose: bool) -> np.ndarray:
        if self.native is None:
            return np.stack([solve_factored(self.num, Bh[:, j],
                                            transpose=transpose)
                             for j in range(Bh.shape[1])], axis=1)
        if self.cperm is None:
            return self.native.solve_multi(self._lib, Bh, transpose=transpose)
        if transpose:
            return self.native.solve_multi(
                self._lib, np.ascontiguousarray(Bh[self.cperm]), transpose=True)
        Y = self.native.solve_multi(self._lib, Bh, transpose=False)
        X = np.empty_like(Y)
        X[self.cperm] = Y
        return X

    def _refined(self, solve_host, bh: np.ndarray, transpose: bool,
                 refine: int) -> np.ndarray:
        """Solve + iterative refinement with host residuals in full
        precision. ``bh`` must already be self.dtype."""
        x = solve_host(bh, transpose)
        if refine <= 0:
            return x
        Ah = self._host_matrix().T if transpose else self._host_matrix()
        for _ in range(refine):
            r = bh - Ah @ x
            if not np.isfinite(r).all():
                break
            x = x + solve_host(r, transpose)
        return x

    def _solve_any(self, solve_host, bh: np.ndarray, transpose: bool,
                   refine: int | None) -> np.ndarray:
        """The solution of ``bh`` on every rank: computed here, or, on a
        group, on rank 0 and broadcast."""
        if self._finalized:
            raise RuntimeError("factorization was finalized")
        if not self.backend.is_dist:
            return self._solve_here(solve_host, bh, transpose, refine)
        x = self._solve_here(solve_host, bh, transpose, refine) if self.root \
            else np.empty(bh.shape, np.result_type(bh.dtype, self.dtype))
        t = comm.broadcast(self.backend, self.backend.tensor(x))
        return t.cpu().numpy()

    def _solve_here(self, solve_host, bh: np.ndarray, transpose: bool,
                    refine: int | None) -> np.ndarray:
        if refine is None:
            # unperturbed, growth-bounded f64 direct solves are already at
            # ~1e-13 relative residual (the reference's MUMPS path runs
            # without refinement by default)
            refine = 0 if self._clean() else 3
        dtype = np.result_type(bh.dtype, self.dtype)
        if np.issubdtype(bh.dtype, np.complexfloating) \
                and not np.issubdtype(self.dtype, np.complexfloating):
            # real factorization, complex RHS: solve Re(b) and Im(b) apart
            xr = self._refined(solve_host, np.ascontiguousarray(bh.real),
                               transpose, refine)
            xi = self._refined(solve_host, np.ascontiguousarray(bh.imag),
                               transpose, refine)
            return (xr + 1j * xi).astype(dtype)
        return self._refined(solve_host, bh.astype(self.dtype), transpose,
                             refine).astype(dtype)

    def solve(self, b, transpose: bool = False, refine: int | None = None):
        """Solve A x = b (or Aᵀ x = b). b: DistVector or host array; returns
        the same flavor, partitioned like A's rows. The RHS is gathered to
        the host, as the reference gathers it for MUMPS
        (mumps_factorization.jl:316-329). On a group every rank calls it
        with the same b."""
        from ..vector import DistVector

        is_dist = isinstance(b, DistVector)
        bh = b.to_numpy() if is_dist else np.asarray(b)
        x = self._solve_any(self._solve_host, bh, transpose, refine)
        if is_dist:
            return DistVector.from_global_deferred(
                x, self.backend, partition=self.A.row_partition, dtype=x.dtype)
        return x

    def solve_transpose(self, b, refine: int | None = None):
        """Solve Aᵀ x = b: ``solve(b, transpose=True)``."""
        return self.solve(b, transpose=True, refine=refine)

    def solve_matrix(self, B, transpose: bool = False,
                     refine: int | None = None):
        """Blocked multi-RHS solve: ``B`` is a DistDenseMatrix or a host
        (n, k) array whose columns are right-hand sides, gathered to the
        host once; all columns go through one gemm-based sweep, with
        matrix-level refinement (ref: MUMPS multi-RHS solve path,
        mumps_factorization.jl:291-353). Returns the same flavour, a
        DistDenseMatrix on A's row partition."""
        from ..dense import DistDenseMatrix

        is_dist = isinstance(B, DistDenseMatrix)
        Bh = B.to_numpy() if is_dist else np.asarray(B)
        X = self._solve_any(self._solve_multi_host, Bh, transpose, refine)
        if is_dist:
            return DistDenseMatrix.from_global(
                X, self.backend, row_partition=self.A.row_partition,
                dtype=X.dtype)
        return X

    def finalize(self):
        """Release numeric data (ref: finalize!, mumps_factorization.jl:421)."""
        self.num = None
        self.native = None
        self._n_perturbed = 0
        self._finalized = True

    def _clean(self) -> bool:
        """No perturbations and bounded growth: safe to skip refinement."""
        if self.n_perturbed != 0:
            return False
        if self.native is not None:
            return self._factor_growth() <= self._GROWTH_MAX
        return True

    @property
    def n_perturbed(self) -> int:
        """Pivots perturbed by the last factorization; on a group, rank
        0's count on every rank."""
        if self.backend.is_dist:
            return self._n_perturbed
        return self._local_perturbed()

    def _local_perturbed(self) -> int:
        if self.native is not None:
            return self.native.n_perturbed
        return self.num.n_perturbed if self.num else 0

    def __repr__(self):
        if self.sym is None:
            return (f"Factorization(kind={self.kind}, n={self.A.m}, factors "
                    f"on rank 0)")
        return (f"Factorization(kind={self.kind}, n={self.A.m}, "
                f"nsuper={self.sym.nsuper}, lnz={self.sym.lnz}, "
                f"native={self.native is not None})")


def _resolve_method(A, method):
    """None -> the backend's solver selection (ref: the Solver type
    parameter of HPCBackend routes ``A \\ b`` to MUMPS or cuDSS)."""
    if method is None:
        return "device" if A.backend.solver == "device" else "host"
    if method not in ("host", "device"):
        raise ValueError(f"unknown solver method {method!r}")
    return method


def _device_or_host(A, kind, host_kind):
    """The device engine's factorization of A, or, for a pattern the wave
    schedule cannot take (a chain tree), the host engine's with a
    warning."""
    from .device_mf import DeviceFactorization, DeviceScheduleError

    try:
        return DeviceFactorization(A, kind=kind)
    except DeviceScheduleError as e:
        _warn_host_fallback(e)
    return Factorization(A, host_kind)


def ldlt(A, method: str | None = None, spd: bool = False):
    """Ref: ldlt (mumps_factorization.jl:259). Symmetric (possibly complex-
    symmetric) LDLᵀ with static pivoting. ``method="device"`` (or a backend
    built with ``solver="device"``) selects the device multifrontal engine
    (solver/device_mf.py; the cuDSS analogue): indefinite systems use the
    blocked unpivoted LDL kernel; ``spd=True`` opts into Cholesky."""
    if A.m != A.ncols:
        raise ValueError("ldlt requires a square matrix")
    if _resolve_method(A, method) == "device":
        return _device_or_host(A, "chol" if spd else "ldl", "ldlt")
    return Factorization(A, "ldlt")


def lu(A, method: str | None = None):
    """Ref: lu (mumps_factorization.jl:242). Unsymmetric LU on the
    symmetrized pattern with static pivoting + refinement. ``method=
    "device"`` (or ``solver="device"`` backends) runs the device
    multifrontal LU."""
    if A.m != A.ncols:
        raise ValueError("lu requires a square matrix")
    if _resolve_method(A, method) == "device":
        return _device_or_host(A, "lu", "lu")
    return Factorization(A, "lu")


def _warn_host_fallback(e):
    import warnings

    warnings.warn(f"device multifrontal unavailable for this pattern "
                  f"({e}); falling back to the host engine", stacklevel=4)


class BackslashCache:
    """The A \\ b cache (ref: _mumps_backslash_cache keyed on
    (hash, symmetric, T), HPCLinearAlgebra.jl:643-744): repeated solves with
    the same sparsity pattern skip symbolic analysis; same values skip the
    numeric factorization entirely."""

    @staticmethod
    def _cache():
        return plan_cache("backslash")

    @staticmethod
    def solve(A, b, symmetric: bool | None = None, transpose: bool = False):
        if symmetric is None:
            symmetric = A.issymmetric()
        kind = "ldlt" if symmetric else "lu"
        # the value dtype is part of the key: a complex-valued matrix on a
        # real-valued pattern twin must not hit the real factorization; so
        # is the solver, which picks the engine
        solver = A.backend.solver
        key = (A.hash, kind, str(A.dtype), solver, A.backend.key)
        c = BackslashCache._cache()
        F = c.get(key)
        if F is None:
            if solver == "device":
                # backend-selected device engine (ref: SolverCuDSS backends
                # route the backslash to cuDSS)
                F = _device_or_host(A, "ldl" if symmetric else "lu", kind)
            else:
                F = Factorization(A, kind)
            c[key] = F
        elif F._vals_ref is not A.nzval:
            # identity of the value tensor detects value swaps; the strong
            # reference makes this immune to id recycling
            F.refactorize(A)
        F._vals_ref = A.nzval
        from ..dense import DistDenseMatrix
        from ..vector import DistVector

        if isinstance(b, DistDenseMatrix) or (
                not isinstance(b, DistVector) and np.ndim(b) == 2):
            # matrix right-hand side: the blocked multi-RHS sweep
            return F.solve_matrix(b, transpose=transpose)
        return F.solve(b, transpose=transpose)


def solve(A, b, symmetric: bool | None = None, transpose: bool = False):
    """``A \\ b`` (ref: Base.:\\, HPCLinearAlgebra.jl:674). Wrapping A in
    Symmetric asserts symmetry; ``transpose=True`` solves Aᵀ x = b, and so
    does a LazyTranspose ``A.T`` (ref: transpose solve,
    test_factorization.jl). ``b`` may be a DistVector, a DistDenseMatrix or
    a host array of one or two dimensions."""
    from ..lazy import LazyTranspose

    if isinstance(A, Symmetric):
        return BackslashCache.solve(A.A, b, symmetric=True,
                                    transpose=transpose)
    if isinstance(A, LazyTranspose):
        return BackslashCache.solve(A.parent, b, symmetric=symmetric,
                                    transpose=not transpose)
    return BackslashCache.solve(A, b, symmetric=symmetric, transpose=transpose)
