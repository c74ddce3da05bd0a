"""Supernodal multifrontal LDLᵀ / LU numeric factorization.

From-scratch replacement for MUMPS's numeric phase (job=2,
reference src/mumps_factorization.jl:196-203) and cuDSS
(ext/HPCLinearAlgebraCUDAExt.jl:602-710). Frontal matrices are dense; the
frontal kernels (partial LDL/LU + trailing GEMM update) run on the host
BLAS — the same dependency class as MUMPS's OpenBLAS fronts. This is the
numpy fallback of the native engine (native/mf.cpp, solver/native.py).

Pivoting strategy: static (no dynamic row exchanges), with MUMPS-CNTL-style
tiny-pivot perturbation; ``api.solve`` compensates with iterative refinement
with host residuals. This is the standard static-pivoting design for
distributed sparse direct solvers.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import scipy.linalg as sla
import scipy.sparse as sp

from .symbolic import SymbolicFactor


@dataclass
class NumericFactor:
    sym: SymbolicFactor
    kind: str                  # "ldlt" | "lu"
    L11: list                  # unit-lower (nc, nc) per supernode
    L21: list                  # (nr, nc)
    D: list                    # (nc,) LDLT only
    U11: list                  # (nc, nc) LU only (upper, incl diag)
    U12: list                  # (nc, nr) LU only
    n_perturbed: int


_PERT_REL = 1e-12  # tiny-pivot threshold relative to max front magnitude


def factorize(sym: SymbolicFactor, A_csr: sp.csr_matrix, kind: str) -> NumericFactor:
    """Numeric multifrontal factorization of P A Pᵀ over the symbolic tree."""
    n = sym.n
    Ap = sp.csc_matrix(A_csr[sym.perm][:, sym.perm])
    Ap.sort_indices()
    # RELATIVE perturbation: flooring anorm at 1.0 made the threshold
    # absolute and perturbed every pivot of a small-magnitude matrix
    # (e.g. a well-conditioned SPD scaled by 1e-16 -> 99.9%-wrong solve)
    anorm = float(np.abs(Ap.data).max()) if Ap.nnz else 0.0
    eps = _PERT_REL * (anorm if anorm > 0 else 1.0)

    nsuper = sym.nsuper
    L11 = [None] * nsuper
    L21 = [None] * nsuper
    D = [None] * nsuper
    U11 = [None] * nsuper
    U12 = [None] * nsuper
    updates = [None] * nsuper  # child update matrices awaiting extend-add
    upd_rows = [None] * nsuper
    children = [[] for _ in range(nsuper)]
    for k in range(nsuper):
        p = sym.snode_parent[k]
        if p >= 0:
            children[p].append(k)
    n_pert = 0

    Ap_csr = sp.csr_matrix(Ap)
    Ap_csr.sort_indices()

    pos_of = np.full(n, -1, dtype=np.int64)  # reused scatter map (O(n) once)
    for k in range(nsuper):  # postordered: children before parents
        j0, j1 = int(sym.snode_ptr[k]), int(sym.snode_ptr[k + 1])
        nc = j1 - j0
        rows = sym.snode_rows[k]
        nr = len(rows)
        fr = np.concatenate([np.arange(j0, j1), rows])  # front index list
        nf = nc + nr

        F = np.zeros((nf, nf), dtype=Ap.dtype)
        # assemble A columns of the supernode: F[:, 0:nc] = A[fr, j0:j1]
        pos_of[fr] = np.arange(nf)
        for j in range(j0, j1):
            a, b = Ap.indptr[j], Ap.indptr[j + 1]
            ridx = Ap.indices[a:b]
            p = pos_of[ridx]
            m = p >= 0
            F[p[m], j - j0] = Ap.data[a:b][m]
        if kind == "lu":
            # also need A rows of the supernode beyond the diagonal block:
            # F[0:nc, nc:] = A[j0:j1, rows]
            for j in range(j0, j1):
                a, b = Ap_csr.indptr[j], Ap_csr.indptr[j + 1]
                cidx = Ap_csr.indices[a:b]
                p = pos_of[cidx]
                m = (p >= nc)
                F[j - j0, p[m]] = Ap_csr.data[a:b][m]

        # extend-add child updates
        for c in children[k]:
            cr = upd_rows[c]
            U = updates[c]
            p = pos_of[cr]
            F[np.ix_(p, p)] += U
            updates[c] = None
            upd_rows[c] = None

        # ---- partial factorization of the leading nc columns --------------
        if kind == "ldlt":
            F11 = F[:nc, :nc]
            F21 = F[nc:, :nc]
            l11 = np.eye(nc, dtype=F.dtype)
            d = np.zeros(nc, dtype=F.dtype)
            for j in range(nc):
                dj = F11[j, j]
                if abs(dj) < eps:
                    dj = eps if (dj == 0 or dj.real >= 0) else -eps
                    n_pert += 1
                d[j] = dj
                if j + 1 < nc:
                    col = F11[j + 1:, j] / dj
                    l11[j + 1:, j] = col
                    F11[j + 1:, j + 1:] -= np.outer(col, F11[j + 1:, j])
            # L21 = F21 · L11⁻ᵀ · D⁻¹
            l21 = sla.solve_triangular(l11, F21.T, lower=True, unit_diagonal=True).T
            l21 = l21 / d[None, :]
            upd = F[nc:, nc:] - (l21 * d[None, :]) @ l21.T
            L11[k], L21[k], D[k] = l11, l21, d
        else:  # LU, no pivoting + static perturbation
            F11 = F[:nc, :nc]
            for j in range(nc):
                dj = F11[j, j]
                if abs(dj) < eps:
                    F11[j, j] = eps if (dj == 0 or dj.real >= 0) else -eps
                    n_pert += 1
                if j + 1 < nc:
                    F11[j + 1:, j] /= F11[j, j]
                    F11[j + 1:, j + 1:] -= np.outer(F11[j + 1:, j], F11[j, j + 1:])
            l11 = np.tril(F11, -1) + np.eye(nc, dtype=F.dtype)
            u11 = np.triu(F11)
            # L21 = F21 · U11⁻¹ ;  U12 = L11⁻¹ · F12
            l21 = sla.solve_triangular(u11, F[nc:, :nc].T, lower=False, trans="T").T
            u12 = sla.solve_triangular(l11, F[:nc, nc:], lower=True, unit_diagonal=True)
            upd = F[nc:, nc:] - l21 @ u12
            L11[k], L21[k], U11[k], U12[k] = l11, l21, u11, u12

        updates[k] = upd
        upd_rows[k] = rows
        pos_of[fr] = -1  # reset only the touched slots (keeps O(front) cost)

    return NumericFactor(sym=sym, kind=kind, L11=L11, L21=L21, D=D,
                         U11=U11, U12=U12, n_perturbed=n_pert)


def solve_factored(F: NumericFactor, b: np.ndarray, transpose: bool = False) -> np.ndarray:
    """Dense triangular sweeps over the supernode tree (ref: MUMPS job=3,
    mumps_factorization.jl:333-335).

    LDLᵀ: x = L⁻ᵀ D⁻¹ L⁻¹ (Pb); transpose solve is identical (symmetric —
    note: transpose, not conjugate transpose, matching MUMPS SYM=2 complex-
    symmetric semantics). LU: x = U⁻¹ L⁻¹ (Pb); transpose solves Uᵀ then Lᵀ.
    """
    sym = F.sym
    ns = sym.nsuper
    y = b[sym.perm].copy()
    sptr, srows = sym.snode_ptr, sym.snode_rows

    if F.kind == "ldlt":
        for k in range(ns):  # forward: L z = y
            j0, j1 = int(sptr[k]), int(sptr[k + 1])
            rows = srows[k]
            yk = sla.solve_triangular(F.L11[k], y[j0:j1], lower=True,
                                      unit_diagonal=True)
            y[j0:j1] = yk
            if len(rows):
                y[rows] -= F.L21[k] @ yk
            y[j0:j1] = yk / F.D[k]  # fold in the diagonal
        for k in range(ns - 1, -1, -1):  # backward: Lᵀ x = z
            j0, j1 = int(sptr[k]), int(sptr[k + 1])
            rows = srows[k]
            rhs = y[j0:j1] - (F.L21[k].T @ y[rows] if len(rows) else 0)
            y[j0:j1] = sla.solve_triangular(F.L11[k].T, rhs, lower=False,
                                            unit_diagonal=True)
    elif not transpose:  # LU: L then U
        for k in range(ns):
            j0, j1 = int(sptr[k]), int(sptr[k + 1])
            rows = srows[k]
            yk = sla.solve_triangular(F.L11[k], y[j0:j1], lower=True,
                                      unit_diagonal=True)
            y[j0:j1] = yk
            if len(rows):
                y[rows] -= F.L21[k] @ yk
        for k in range(ns - 1, -1, -1):
            j0, j1 = int(sptr[k]), int(sptr[k + 1])
            rows = srows[k]
            rhs = y[j0:j1] - (F.U12[k] @ y[rows] if len(rows) else 0)
            y[j0:j1] = sla.solve_triangular(F.U11[k], rhs, lower=False)
    else:  # Aᵀ = Uᵀ Lᵀ: forward with Uᵀ, backward with Lᵀ
        for k in range(ns):
            j0, j1 = int(sptr[k]), int(sptr[k + 1])
            rows = srows[k]
            yk = sla.solve_triangular(F.U11[k].T, y[j0:j1], lower=True)
            y[j0:j1] = yk
            if len(rows):
                y[rows] -= F.U12[k].T @ yk
        for k in range(ns - 1, -1, -1):
            j0, j1 = int(sptr[k]), int(sptr[k + 1])
            rows = srows[k]
            rhs = y[j0:j1] - (F.L21[k].T @ y[rows] if len(rows) else 0)
            y[j0:j1] = sla.solve_triangular(F.L11[k].T, rhs, lower=False,
                                            unit_diagonal=True)

    x = np.empty_like(y)
    x[sym.perm] = y
    return x
