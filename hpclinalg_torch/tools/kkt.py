"""The saddle-point (KKT) assembly through the public API, each step held
against scipy or numpy.

PDE and optimisation codes assemble K = [[A, Bᵀ], [B, −δI]] for
equality-constrained least squares or Lagrange-multiplier constraints,
impose Dirichlet rows and take submatrices for block preconditioners.
``drive`` runs that path on one backend: A = laplace2d(k) (n = k² grid
nodes), B m × n with ``per_row`` N(0, 1) entries a row at random columns,
δ = 1e-6. On a process group (``backend_dist``) every rank runs it on its
own shard and holds each step against scipy itself
(``tools/dist_checks.assembly``). ``tests/test_torch_slice.py`` and
``tests/test_torch_dist_assembly.py`` drive it at a small size on the CPU,
``tests/test_torch_card_algebra.py`` and ``tests/test_torch_card_groups.py``
at k = 1000, m = 10⁴ on the card.
"""

from __future__ import annotations

import json
import math
import time

import numpy as np
import scipy.sparse as sp
import torch

from .matrices import laplace2d


class Inputs:
    """The host matrices and vectors of one run, from ``seed``, with the
    scipy references the steps are held against."""

    def __init__(self, k, m, seed, per_row=16, delta=1e-6):
        rng = np.random.default_rng(seed)
        self.k, self.m, self.delta = k, m, delta
        self.A = laplace2d(k)
        n = self.n = k * k
        rows = np.repeat(np.arange(m, dtype=np.int64), per_row)
        self.B = sp.csr_matrix((rng.standard_normal(m * per_row),
                                (rows, rng.integers(0, n, m * per_row))),
                               shape=(m, n))
        self.B.sum_duplicates()
        self.Bt = self.B.T.tocsr()
        self.C = (-delta * sp.eye(m)).tocsr()
        self.K = sp.bmat([[self.A, self.Bt], [self.B, self.C]]).tocsr()
        self.K.sort_indices()
        N = self.N = n + m
        self.z = rng.standard_normal(N)
        self.w = rng.standard_normal(N)
        self.x = rng.standard_normal(n)
        self.p = rng.integers(0, N, min(N, 10_000))
        self.p[: len(self.p) // 10] = self.p[len(self.p) // 10: 2 * (
            len(self.p) // 10)]                       # repeated ids
        self.j = int(rng.integers(0, n))
        self.ids = rng.integers(0, N, 1000)
        self.ids[-100:] = self.ids[:100]              # repeats: the last wins
        self.vals = rng.standard_normal(len(self.ids))
        g = np.arange(n).reshape(k, k)
        self.bnd = np.unique(np.concatenate([g[0], g[-1], g[:, 0], g[:, -1]]))
        # K after K[bnd, bnd] = I: the block's entries dropped, I inserted
        c = self.K.tocoo()
        inb = np.isin(c.row, self.bnd) & np.isin(c.col, self.bnd)
        nb = len(self.bnd)
        self.K_edit = sp.csr_matrix(
            (np.concatenate([c.data[~inb], np.ones(nb)]),
             (np.concatenate([c.row[~inb], self.bnd]),
              np.concatenate([c.col[~inb], self.bnd]))), shape=(N, N))
        self.K_edit.sort_indices()
        self.D = rng.standard_normal((n, 8))
        self.Dvals = rng.standard_normal((1000, 3))
        self.Drows = rng.integers(0, n, 1000)
        self.Drows[-50:] = self.Drows[:50]
        self._references()

    def _references(self):
        """scipy's and numpy's answers to every step, computed once for all
        shard counts (they need no backend)."""
        K, R, n = self.K, self.K_edit, self.n
        self.Kz, self.Ktw = K @ self.z, K.T @ self.w
        self.Kp = K[self.p][:, self.p].tocsr()
        self.Kp.sort_indices()
        self.Kj = K[:, self.j].toarray().ravel()
        self.Ax = self.A @ self.x
        self.zh = _last_write(self.z, self.ids, self.vals)
        self.Rz, self.Rtw = R @ self.z, R.T @ self.w
        self.R_symmetric = (R != R.T).nnz == 0
        absR = abs(R)
        self.reductions = {
            "norm": sp.linalg.norm(R), "opnorm(1)": absR.sum(axis=0).max(),
            "opnorm(inf)": absR.sum(axis=1).max(),
            "sum(axis=0)": np.asarray(R.sum(axis=0)).ravel(),
            "sum(axis=1)": np.asarray(R.sum(axis=1)).ravel(),
            "tr": R.diagonal().sum(), "maximum": R.max(), "minimum": R.min(),
            "mean": R.mean()}
        # a sum is held relative to the sum of its terms' magnitudes: K's
        # entries nearly cancel (the Laplacian's rows sum to 0 or 1)
        self.reduction_scale = {"mean": absR.mean()}
        Dh = self.D.copy()
        keep = len(self.Drows) - 1 - np.unique(self.Drows[::-1],
                                               return_index=True)[1]
        Dh[self.Drows[keep], 2:5] = self.Dvals[keep]
        self.Dh = Dh
        h = 1.0 / (self.k + 1)
        g = np.arange(n)
        self.xy = np.stack([(g % self.k + 1) * h, (g // self.k + 1) * h],
                           axis=1)


def _last_write(v, ids, vals):
    """v with v[ids] = vals, a repeated id keeping its last write."""
    keep = len(ids) - 1 - np.unique(ids[::-1], return_index=True)[1]
    out = v.copy()
    out[ids[keep]] = vals[keep]
    return out


def check(cond, what):
    if not cond:
        raise RuntimeError(f"kkt check failed: {what}")


def _timed(fn):
    """(fn(), wall seconds), the card's queue drained on both sides."""
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def same_csr(M, ref) -> bool:
    """The port's matrix equals the scipy CSR ``ref`` bit for bit."""
    got = M.to_scipy()
    return (got.shape == ref.shape
            and np.array_equal(got.indptr, ref.indptr)
            and np.array_equal(got.indices, ref.indices)
            and np.array_equal(got.data, ref.data))


def _rel(got, want, scale=None) -> float:
    """max |got - want| over ``scale``, by default max |want|."""
    got, want = np.asarray(got), np.asarray(want)
    if not want.size:
        return 0.0
    if scale is None:
        scale = float(np.abs(want).max())
    return float(np.abs(got - want).max()) / max(scale, 1e-300)


def _near(got, want, rtol, what, check, scale=None):
    err = _rel(got, want, scale)
    check(err <= rtol, f"{what}: max rel err {err:.2e} (rtol {rtol:g})")


def _first_and_cached(fn):
    """(result, first-call seconds, cached-call seconds)."""
    out, t1 = _timed(fn)
    out2, t2 = _timed(fn)
    return out2, t1, t2


def blocks(be, I: Inputs):
    """A, Bᵀ, B and −δI on backend ``be``."""
    import hpclinalg_torch as ht

    return [ht.DistSparseMatrix.from_scipy(M, be)
            for M in (I.A, I.Bt, I.B, I.C)]


# a piece of the name of each SpMV engine's kernel, for the trace check
ENGINE_KERNELS = {"ell": "ell_rows", "resident": "ell_resident",
                  "dia": "dia_"}


def drive(be, I: Inputs, check=check, trace_dir=None):
    """Run the assembly on backend ``be`` (f64); each step is held against
    scipy/numpy through ``check(cond, what)``. With ``trace_dir``, one K @ z
    is traced there inside annotate("kkt_matvec"); the trace must name that
    region and, on the card, the kernel of the engine K @ z took
    (``ENGINE_KERNELS``): the range its wrapper opens on the host timeline
    at the launch, or its device event.
    Returns the seconds of the first (plan build) and cached calls, and
    the SpMV engine of K @ z, by name."""
    import hpclinalg_torch as ht
    from hpclinalg_torch.ops.spmv import get_spmv_plan
    from hpclinalg_torch.utils.profiling import trace_path

    out = {}
    n, S = I.n, be.nshards
    # on a group S is the world, and each rank names itself
    where = f"rank {be.rank} of {S}" if be.is_dist else f"S={S}"
    # wall seconds of each step, its checks against scipy included
    steps = out["steps_s"] = {}
    mark = [time.perf_counter()]

    def done(step):
        now = time.perf_counter()
        steps[step] = round(now - mark[0], 3)
        mark[0] = now

    parts = blocks(be, I)
    Ad = parts[0]
    z = ht.DistVector.from_global(I.z, be)
    w = ht.DistVector.from_global(I.w, be)
    x = ht.DistVector.from_global(I.x, be)
    done("setup")

    # 1. K = [[A, Bᵀ], [B, −δI]]
    K, out["cat_first_s"], out["cat_cached_s"] = _first_and_cached(
        lambda: ht.cat(*parts, dims=(2, 2)))
    check(same_csr(K, I.K), f"{where}: cat equals sp.bmat bit for bit "
          f"({K.shape[0]} rows, {K.nnz()} nnz)")
    done("cat")

    # 2. K @ z, K.T @ w
    Kz, out["matvec_first_s"], out["matvec_cached_s"] = _first_and_cached(
        lambda: K @ z)
    out["engine"] = get_spmv_plan(K, z).engine(torch.float64)
    _near(Kz.to_numpy(), I.Kz, 1e-12, f"{where}: K @ z ({out['engine']})",
          check)
    Ktw, out["rmatvec_first_s"], out["rmatvec_cached_s"] = \
        _first_and_cached(lambda: K.T @ w)
    _near(Ktw.to_numpy(), I.Ktw, 1e-12, f"{where}: K.T @ w", check)
    done("matvec")

    # 3. indexing
    K11, out["getindex_first_s"], out["getindex_cached_s"] = \
        _first_and_cached(lambda: K[0:n, 0:n])
    check(same_csr(K11, I.A), f"{where}: K[0:n, 0:n] equals A bit for bit")
    check(same_csr(K[n:, 0:n], I.B), f"{where}: K[n:, 0:n] equals B")
    check(same_csr(K[I.p, I.p], I.Kp), f"{where}: K[p, p], {len(I.p)} ids "
          "with repeats, equals scipy's")
    col = K[:, I.j]
    check(isinstance(col, ht.DistVector)
          and np.array_equal(col.to_numpy(), I.Kj),
          f"{where}: K[:, j] as a DistVector")
    check(np.array_equal(z[n:].to_numpy(), I.z[n:]), f"{where}: z[n:]")
    zz = ht.DistVector.from_global(I.z, be)
    zz[I.ids] = I.vals
    check(np.array_equal(zz.to_numpy(), I.zh) and np.array_equal(
        z.to_numpy(), I.z), f"{where}: z[ids] = vals, repeated ids keep the "
        "last write, z untouched")
    check(np.array_equal(ht.vcat_vectors(zz[0:n], zz[n:]).to_numpy(), I.zh),
          f"{where}: vcat_vectors(z[0:n], z[n:]) is z")
    H = ht.hcat_vectors(zz[0:n], x)
    check(np.array_equal(H.to_numpy(), np.stack([I.zh[:n], I.x], axis=1)),
          f"{where}: hcat_vectors(z[0:n], x)")
    out["k11_engine"] = get_spmv_plan(K11, x).engine(torch.float64)
    _near((K11 @ x).to_numpy(), I.Ax, 1e-12,
          f"{where}: K[0:n, 0:n] @ x ({out['k11_engine']}) against A @ x",
          check)
    done("indexing")

    # 4. Dirichlet rows: K[bnd, bnd] = I, then new plans
    h0, plan0 = K.hash, get_spmv_plan(K, z)
    _, out["setindex_first_s"] = _timed(
        lambda: K.__setitem__((I.bnd, I.bnd), sp.eye(len(I.bnd))))
    check(same_csr(K, I.K_edit) and K.hash != h0
          and K.cached_transpose is None,
          f"{where}: K[bnd, bnd] = I on {len(I.bnd)} boundary nodes")
    check(get_spmv_plan(K, z) is not plan0, f"{where}: a new SpMV plan")
    _near((K @ z).to_numpy(), I.Rz, 1e-12, f"{where}: K @ z after the edit",
          check)
    _near((K.T @ w).to_numpy(), I.Rtw, 1e-12,
          f"{where}: K.T @ w after the edit", check)
    check(K.issymmetric() == I.R_symmetric,
          f"{where}: issymmetric() is {I.R_symmetric}")
    done("setindex")

    # 5. reductions, rtol 1e-12
    red = {"norm": lambda: K.norm(), "opnorm(1)": lambda: K.opnorm(1),
           "opnorm(inf)": lambda: K.opnorm(np.inf),
           "sum(axis=0)": lambda: K.sum(axis=0).to_numpy(),
           "sum(axis=1)": lambda: K.sum(axis=1).to_numpy(),
           "tr": lambda: K.tr(), "maximum": lambda: K.maximum(),
           "minimum": lambda: K.minimum(), "mean": lambda: K.mean()}
    t0 = time.perf_counter()
    for name, fn in red.items():
        got = fn()
        got = got.cpu().numpy() if isinstance(got, torch.Tensor) else got
        _near(got, I.reductions[name], 1e-12, f"{where}: K.{name}", check,
              I.reduction_scale.get(name))
    out["reductions_first_s"] = time.perf_counter() - t0
    done("reductions")

    # 6. dense: D[p, 2:5], D[rows, 2:5] = vals, vcat_dense, hcat_dense
    D = ht.DistDenseMatrix.from_global(I.D, be)
    pd = I.p[I.p < n]
    check(np.array_equal(D[pd, 2:5].to_numpy(), I.D[pd, 2:5]),
          f"{where}: D[p, 2:5]")
    D[I.Drows, 2:5] = I.Dvals
    Dh = I.Dh
    check(np.array_equal(D.to_numpy(), Dh), f"{where}: D[rows, 2:5] = vals, "
          "the last write wins")
    E = D[0:100, :]
    check(np.array_equal(ht.vcat_dense(D, E).to_numpy(),
                         np.vstack([Dh, Dh[:100]])), f"{where}: vcat_dense")
    check(np.array_equal(ht.hcat_dense(D, D[:, 0:3]).to_numpy(),
                         np.hstack([Dh, Dh[:, :3]])), f"{where}: hcat_dense")
    done("dense")

    # 7. map_rows: grid coordinates, then sin(pi x) sin(pi y)
    k, h = I.k, 1.0 / (I.k + 1)
    vi = ht.vertex_indices(ht.uniform_partition(n, S), be)
    XY = ht.map_rows(lambda i: torch.stack([(i % k + 1).double() * h,
                                            (i // k + 1).double() * h]), vi)
    f = ht.map_rows(lambda c: torch.sin(math.pi * c[0])
                    * torch.sin(math.pi * c[1]), XY)
    xs, ys = I.xy[:, 0], I.xy[:, 1]
    check(XY.shape == (n, 2) and np.array_equal(XY.to_numpy(), I.xy),
          f"{where}: map_rows grid coordinates from vertex_indices")
    _near(f.to_numpy(), np.sin(np.pi * xs) * np.sin(np.pi * ys), 1e-13,
          f"{where}: map_rows sin(pi x) sin(pi y)", check)
    _near(XY.mapslices(lambda r: r[0] * r[1]).to_numpy(), xs * ys, 1e-13,
          f"{where}: mapslices over rows", check)
    _near(D.mapslices(lambda c: torch.stack([c.sum(), c.abs().max()]),
                      axis=0).to_numpy(),
          np.stack([Dh.sum(0), np.abs(Dh).max(0)]), 1e-12,
          f"{where}: mapslices over columns", check)
    done("map_rows")

    # 8. blockdiag(A, A) @ [x; x]
    BD, out["blockdiag_first_s"] = _timed(lambda: ht.blockdiag(Ad, Ad))
    out["blockdiag_engine"] = get_spmv_plan(
        BD, ht.vcat_vectors(x, x)).engine(torch.float64)
    _near((BD @ ht.vcat_vectors(x, x)).to_numpy(),
          np.concatenate([I.Ax] * 2), 1e-12,
          f"{where}: blockdiag(A, A) @ [x; x] ({out['blockdiag_engine']})",
          check)
    done("blockdiag")

    # 9. to_backend from a CPU backend
    cpu = ht.backend_auto(1, device="cpu")
    Bc = ht.DistSparseMatrix.from_scipy(I.B, cpu)
    Bb = ht.to_backend(Bc, be)
    xb = ht.to_backend(ht.DistVector.from_global(I.x, cpu), be)
    check(Bb.nzval.device == be.device and same_csr(Bb, I.B)
          and xb.data.device == be.device
          and np.array_equal(xb.to_numpy(), I.x),
          f"{where}: to_backend from the CPU to {be.device}")
    done("to_backend")

    # 10. profile_trace around one K @ z inside annotate("kkt_matvec")
    if trace_dir is not None:
        with ht.profile_trace(trace_dir, backend=be):
            with ht.annotate("kkt_matvec"):
                K @ z
        with open(trace_path(trace_dir, be)) as fh:
            events = json.load(fh)["traceEvents"]
        names = {e.get("name", "") for e in events}
        kernels = sorted({e.get("name", "")[:40] for e in events
                          if e.get("cat") == "kernel"}) or "not recorded"
        kn = ENGINE_KERNELS.get(out["engine"], "") \
            if be.device.type == "cuda" else ""
        check("kkt_matvec" in names and any(kn in nm for nm in names),
              f"{where}: the trace holds kkt_matvec and the {out['engine']} "
              f"kernel {kn!r} (annotation "
              f"{'found' if 'kkt_matvec' in names else 'missing'}; "
              f"{len(events)} events, device kernels {kernels})")
    done("trace")

    # 11. warmup
    _, out["warmup_s"] = _timed(lambda: ht.warmup(be))
    done("warmup")
    return out
