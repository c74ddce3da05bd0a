"""Per-rank bodies of the distributed checks, run on every rank of a process
group by ``tests/test_torch_dist*.py`` and ``tests/test_torch_entry.py``
(gloo, CPU) and ``tests/test_torch_card_groups.py`` (NCCL or gloo on the
card):

    from hpclinalg_torch.parallel.launch import run_ranks
    ranks = run_ranks("hpclinalg_torch.tools.dist_checks:on_rank", 4,
                      backend="gloo", device="cpu", args=("checks", {}))

Each body takes a Backend, builds its inputs from a seed with numpy, runs
the port's public API and returns a dict of numpy arrays: a device result
as this process's rows (``"<name>.local"``, shape (nlocal, ...)) and,
where the API gathers it, the whole (``"<name>.full"``). On a stacked
backend (``backend_auto(S)``) the same body gives the reference: rank r's
``.local`` is row r of the stacked one. Bodies call the same collectives
in the same order on every rank, so every rank must run the same bodies.
"""

from __future__ import annotations

import sys
from contextlib import contextmanager
from dataclasses import replace

import numpy as np
import scipy.sparse as sp
import torch

from .matrices import (banded_design, between_eigenvalues, complex_values,
                       helmholtz, laplace2d, power_law, random_8)


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def empty_shard_partition(n: int, S: int) -> np.ndarray:
    """n rows over S shards, shard 1 empty (uniform at S = 1)."""
    from ..partition import uniform_partition

    if S == 1:
        return uniform_partition(n, 1)
    sizes = np.insert(np.diff(uniform_partition(n, S - 1)), 1, 0)
    return np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)


@contextmanager
def patched(module, **values):
    """Module attributes set to ``values`` inside the block (engine limits
    for the plans built there; a plan keeps its engine once built)."""
    old = {k: getattr(module, k) for k in values}
    for k, v in values.items():
        setattr(module, k, v)
    try:
        yield
    finally:
        for k, v in old.items():
            setattr(module, k, v)


# -- containers and reductions -------------------------------------------------

def vectors(be, n: int = 37, seed: int = 1) -> dict:
    """from_global / to_numpy on a partition with an empty shard, the
    reductions, an axpy, repartition both ways and the constructors."""
    import hpclinalg_torch as ht
    from ..partition import uniform_partition

    S = be.nshards
    rng = np.random.default_rng(seed)
    xh, yh = rng.standard_normal(n), rng.standard_normal(n)
    p, pu = empty_shard_partition(n, S), uniform_partition(n, S)
    x = ht.DistVector.from_global(xh, be, partition=p)
    y = ht.DistVector.from_global(yh, be, partition=p)
    z = x + 2.5 * y
    w = x.repartition(pu)
    out = {"x.local": x.data, "x.full": x.to_numpy(), "x.ro": x.to_numpy_ro(),
           "dot": x.dot(y), "norm2": x.norm(), "norm1": x.norm(1),
           "norminf": x.norm(np.inf), "sum": x.sum(), "mean": x.mean(),
           "max": x.max(), "min": x.min(), "axpy.local": z.data,
           "axpy.full": z.to_numpy(), "repart.local": w.data,
           "repart.full": w.to_numpy(),
           "repart_back.local": ht.repartition(w, p).data,
           "zeros.local": ht.DistVector.zeros(n, be, partition=p).data,
           "rand.local": ht.DistVector.rand(n, be, seed=seed).data,
           "from_local.local": ht.DistVector.from_local(
               [xh[p[s]: p[s + 1]] for s in range(S)], be).data,
           "mixed_dot": x.dot(y.repartition(pu))}
    d = ht.DistVector.from_global_deferred(xh, be, partition=p)
    out["deferred.full"] = d.to_numpy()
    out["deferred.local"] = d.data
    return {f"vec.{k}": _np(v) for k, v in out.items()}


def exchange_inputs(n: int, S: int, seed: int):
    """(partition with an empty shard, x, wanted ids per destination, global
    destination ids per source shard, destination partition): the gather
    and scatter plans of ``exchange``, for the JAX package too."""
    from ..partition import uniform_partition

    rng = np.random.default_rng(seed)
    p = empty_shard_partition(n, S)
    xh = rng.standard_normal(n)
    wanted = [rng.integers(0, n, int(rng.integers(1, 2 * n)))
              for _ in range(S)]
    pd = uniform_partition(n, S)
    dst = [rng.integers(0, n, int(p[s + 1] - p[s])) for s in range(S)]
    return p, xh, wanted, dst, pd


def exchange(be, n: int = 37, seed: int = 2) -> dict:
    """A gather plan on a partition with an empty shard applied to a vector,
    a (k = 3) row payload and a complex payload, and a scatter plan with
    repeated destinations, summed (add=True) onto a base."""
    import hpclinalg_torch as ht
    from ..ops.gather import gather_exchange_plan, scatter_exchange_plan
    from ..vector import _stack

    S = be.nshards
    p, xh, wanted, dst, pd = exchange_inputs(n, S, seed)
    x = ht.DistVector.from_global(xh, be, partition=p)
    g = gather_exchange_plan(be, p, wanted)
    X3 = be.shard_tensor(np.stack([_stack(xh * (j + 1), p, np.float64)
                                   for j in range(3)], axis=2))
    sc = scatter_exchange_plan(be, p, dst, pd)
    base = torch.ones((be.nlocal, sc.out_pad), dtype=torch.float64,
                      device=be.device)
    out = {"gather.local": g.apply(x.data),
           "gather3.local": g.apply(X3),
           "gather_c.local": g.apply(x.data * (1.0 - 0.5j)),
           "scatter_add.local": sc.apply(x.data, base=base, add=True),
           "crosses": g.crosses, "nmoved": g.nmoved}
    return {f"ex.{k}": _np(v) for k, v in out.items()}


# -- SpMV on every engine ------------------------------------------------------

def spmv_matrices(k: int = 12, n: int = 300, seed: int = 3) -> dict:
    """name -> (matrix, spmv module limits its plan is built under):
    laplace2d(k) on the DIA engine; a power law (ELL + COO tail); the ridge
    normal matrix N's pattern at a small size (resident, MIN_NNZ lowered);
    a small random matrix (densify); a random matrix with no ELL layout
    (segment)."""
    Ab, _ = banded_design(8 * n, n, seed, half=24)
    N = (Ab.T @ Ab + 1e-2 * sp.eye(n)).tocsr()
    R = sp.random(n, n, 0.05, format="csr", random_state=seed) \
        + sp.eye(n, format="csr")
    no_dense = {"DENSE_MAX_ELEMS": 0}
    return {"dia": (laplace2d(k), {}),
            "ell": (power_law(n, seed), no_dense),
            "resident": (N, {"DENSE_MAX_ELEMS": 0, "MIN_NNZ": 0}),
            "densify": (sp.random(60, 60, 0.1, format="csr",
                                  random_state=seed) + sp.eye(60), {}),
            "segment": (R.tocsr(), no_dense)}


def spmv(be, k: int = 12, n: int = 300, seed: int = 3) -> dict:
    """``A @ x`` on each engine: the engine, y's rows and y whole."""
    import hpclinalg_torch as ht
    from ..ops import spmv as spmv_mod

    out = {}
    for name, (M, limits) in spmv_matrices(k, n, seed).items():
        xh = np.random.default_rng(seed + 1).standard_normal(M.shape[1])
        x = ht.DistVector.from_global(xh, be)
        # the segment engine is the fallback of a plan with no ELL layout
        no_ell = {"_build_ell": lambda self, A: None} if name == "segment" \
            else {}
        with patched(spmv_mod, **limits), \
                patched(spmv_mod.SpMVPlan, **no_ell):
            A = ht.DistSparseMatrix.from_scipy(M, be)
            plan = spmv_mod.get_spmv_plan(A, x)
        y = A @ x
        out[f"{name}.engine"] = plan.engine(torch.float64)
        out[f"{name}.local"] = y.data
        out[f"{name}.full"] = y.to_numpy()
        out[f"{name}.hash"] = A.hash
    # the plans built under lowered limits are not left for other callers
    ht.clear_plan_cache("vector_plan")
    return {f"spmv.{k}": _np(v) for k, v in out.items()}


# -- the sparse algebra ---------------------------------------------------------------

# SpGEMM engine limits of ``algebra``'s products: the module attributes
# each product's plan is built under (``patched``)
SPGEMM_CASES = {"dia": ("L", "L", {}), "densify": ("A", "B", {}),
                "pairs": ("A", "B", {"DENSE_SPGEMM_ELEMS": 0}),
                "chunks": ("A", "B", {"DENSE_SPGEMM_ELEMS": 0,
                                      "PAIR_CAP": 256})}


def algebra_inputs(S: int, n: int = 40, seed: int = 7) -> dict:
    """The host inputs of ``algebra``, for the JAX package too: ``R`` a
    rectangular random matrix, ``A`` a square one with a full diagonal and
    ``B`` one of another pattern (more than 32 distinct offsets each, so
    no product of them takes the DIA engine), ``L`` laplace2d(6), ``Z``
    A with every third stored value an explicit zero, complex ``Ac`` and
    ``Bc`` on A's and B's patterns; ``p`` a partition with an empty shard
    (A, R, L, Z and the vectors), ``pu`` the uniform one (B); x, y on
    ``p``, ``d1`` and ``d2`` the diagonals of spdiagm's offsets form."""
    from ..partition import uniform_partition

    rng = np.random.default_rng(seed)

    def rand(m, k, density):
        return sp.random(m, k, density, format="csr", random_state=rng)

    R = rand(n, n - 7, 0.2)
    A = (rand(n, n, 0.15) + sp.eye(n)).tocsr()
    B = rand(n, n, 0.15)
    Z = A.copy()
    Z.data[::3] = 0.0
    L = laplace2d(6)
    Ac = A.copy()
    Ac.data = Ac.data + 1j * rng.standard_normal(A.nnz)
    Bc = B.copy()
    Bc.data = Bc.data - 0.5j * rng.standard_normal(B.nnz)
    return {"R": R, "A": A, "B": B, "Z": Z, "L": L, "Ac": Ac, "Bc": Bc,
            "p": empty_shard_partition(n, S), "pu": uniform_partition(n, S),
            "pL": empty_shard_partition(L.shape[0], S),
            "x": rng.standard_normal(n), "y": rng.standard_normal(n),
            "d1": rng.standard_normal(n - 1), "d2": rng.standard_normal(n - 3)}


def algebra(be, n: int = 40, seed: int = 7) -> dict:
    """The sparse algebra on ``algebra_inputs``: the transpose and its
    cache both ways, ``A.T @ x``, ``x.T @ A``, ``x.T @ y``, ``x.T / A``,
    ``A.H``; ``A + B`` on different patterns and partitions, ``A - B``,
    both paths of ``add_identity``; SpGEMM on each engine
    (``SPGEMM_CASES``); ``diag(k)`` for k in {0, 1, -1}, ``triu``,
    ``tril``, ``dropzeros``; the builders, ``from_local_csr``,
    ``from_structure`` and a sparse repartition; c128 transpose, addition
    and SpGEMM. A matrix gives its rows (``.local``) and hash, a vector
    its rows and whole, the SpGEMM cases their engine and chunk count."""
    import warnings

    import hpclinalg_torch as ht
    from ..ops import spgemm as spgemm_mod

    inp = algebra_inputs(be.nshards, n, seed)
    p, pu = inp["p"], inp["pu"]
    M = {k: ht.DistSparseMatrix.from_scipy(inp[k], be, row_partition=p)
         for k in ("R", "A", "Z", "Ac")}
    M["L"] = ht.DistSparseMatrix.from_scipy(inp["L"], be,
                                            row_partition=inp["pL"])
    M["B"] = ht.DistSparseMatrix.from_scipy(inp["B"], be, row_partition=pu)
    M["Bp"] = M["B"].repartition(p)
    M["Bc"] = ht.DistSparseMatrix.from_scipy(inp["Bc"], be,
                                             row_partition=pu)
    x = ht.DistVector.from_global(inp["x"], be, partition=p)
    y = ht.DistVector.from_global(inp["y"], be, partition=p)
    d1 = ht.DistVector.from_global(inp["d1"], be)
    d2 = ht.DistVector.from_global(inp["d2"], be)
    mats, vecs, out = {}, {}, {}

    Rt = M["R"].T.materialize()
    mats["transpose"] = Rt
    sizes = ht.cache_sizes()
    R3t = (3.0 * M["R"]).transpose_materialized()
    out.update({"transpose.cached_both_ways":
                M["R"].T.materialize() is Rt
                and Rt.transpose_materialized() is M["R"],
                "transpose.plan_reused": ht.cache_sizes() == sizes
                and R3t.structure is Rt.structure})
    mats["transpose_values"] = R3t
    xr = ht.DistVector.from_global(inp["x"][: M["R"].ncols], be)
    vecs["At_x"] = M["R"].T @ x
    vecs["xt_A"] = (x.T @ M["R"]).parent
    out["xt_y"] = x.T @ y
    vecs["xt_div_A"] = (x.T / M["A"]).parent
    vecs["A_x"] = M["R"] @ xr
    mats["adjoint"] = M["Ac"].H.materialize()

    mats["add"] = M["A"] + M["B"]              # B on another partition
    mats["sub"] = M["A"] - M["Bp"]             # same partition
    mats["add_lazy"] = M["A"] + M["Bp"].T
    fast = M["A"].add_identity(2.5)
    mats["add_identity_fast"] = fast
    out["add_identity_fast.shares_structure"] = \
        fast.structure is M["A"].structure
    mats["add_identity_slow"] = M["Bp"].add_identity(-1.5)

    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)   # the chunk warning
        for name, (a, b, limits) in SPGEMM_CASES.items():
            ht.clear_plan_cache("matrix_plan")
            with patched(spgemm_mod, **limits):
                plan = spgemm_mod.get_spgemm_plan(M[a], M[b])
            mats[f"spgemm_{name}"] = M[a] @ M[b]
            out[f"spgemm_{name}.engine"] = spgemm_mod.engine(M[a], M[b])
            out[f"spgemm_{name}.nchunks"] = plan.nchunks
        ht.clear_plan_cache("matrix_plan")
    mats["spgemm_lazy"] = M["R"].T @ M["A"]

    for k in (0, 1, -1):
        vecs[f"diag{k}"] = M["L"].diag(k)
    mats["triu"] = M["A"].triu()
    mats["tril"] = M["A"].tril(-1)
    mats["dropzeros"] = M["Z"].dropzeros()
    mats["dropzeros_tol"] = M["A"].dropzeros(0.5)

    mats["speye"] = ht.speye(n, be, row_partition=p)
    mats["spdiagm"] = ht.spdiagm(x)
    mats["spdiagm_offsets"] = ht.spdiagm((0, x), (1, d1), (-3, d2))
    mats["spzeros"] = ht.spzeros(n, n + 3, be, row_partition=p)
    mats["sprand_dist"] = ht.sprand_dist(n, n, 0.2, be, seed=seed)
    A_sc = inp["A"]
    parts = [(A_sc[p[s]: p[s + 1]].indptr, A_sc[p[s]: p[s + 1]].indices,
              A_sc[p[s]: p[s + 1]].data) for s in range(be.nshards)]
    mats["from_local_csr"] = ht.DistSparseMatrix.from_local_csr(parts, n, be)
    mats["from_structure"] = ht.DistSparseMatrix.from_structure(
        M["A"].structure, [2.0 * d for _ip, _j, d in parts])
    mats["repartition"] = M["A"].repartition(pu)

    mats["c128_transpose"] = M["Ac"].T.materialize()
    mats["c128_add"] = M["Ac"] + M["Bc"]
    mats["c128_spgemm"] = M["Ac"] @ M["Bc"].repartition(p)
    for name, m in mats.items():
        out[f"{name}.local"] = m.nzval
        out[f"{name}.hash"] = m.hash
    for name, v in vecs.items():
        out[f"{name}.local"] = v.data
        out[f"{name}.full"] = v.to_numpy()
    return {f"alg.{k}": _np(v) for k, v in out.items()}


# -- CG and the host solve ---------------------------------------------------------

def api_cg_step(A, x, r, p):
    """One CG iteration with the port's public API: (x, r, p) -> the next
    three DistVectors."""
    Ap = A @ p
    rr = r.dot(r)
    alpha = rr / p.dot(Ap)
    x = x + alpha * p
    r2 = r - alpha * Ap
    return x, r2, r2 + (r2.dot(r2) / rr) * p


def api_cg(A, b, steps):
    """``steps`` CG iterations from x = 0 with the port's public API;
    returns (x, r)."""
    x, r, p = type(b).zeros(b.n, b.backend), b, b
    for _ in range(steps):
        x, r, p = api_cg_step(A, x, r, p)
    return x, r


def cg(be, k: int = 16, steps: int = 20, seed: int = 5) -> dict:
    """``steps`` CG iterations on laplace2d(k) from x = 0 (``api_cg``), in
    f64 and f32: the iterate and the residual."""
    import hpclinalg_torch as ht

    out = {}
    bh = np.random.default_rng(seed).standard_normal(k * k)
    for dt in (np.float64, np.float32):
        bd = replace(be, dtype=dt)
        A = ht.DistSparseMatrix.from_scipy(laplace2d(k), bd)
        x, r = api_cg(A, ht.DistVector.from_global(bh, bd), steps)
        tag = np.dtype(dt).name
        out.update({f"{tag}.x.local": x.data, f"{tag}.r.local": r.data,
                    f"{tag}.x.full": x.to_numpy(), f"{tag}.rnorm": r.norm()})
    return {f"cg.{k}": _np(v) for k, v in out.items()}


def solves(be, k: int = 10, seed: int = 4) -> dict:
    """Host ``ldlt`` and ``lu`` solves (rank 0 factors on a group), a
    transposed LU solve, a host-array right-hand side, ``ht.solve`` twice
    on one pattern with new values (the backslash cache), and the
    perturbed-pivot counts of both factorizations of a singular matrix."""
    import hpclinalg_torch as ht

    L = laplace2d(k)
    n = L.shape[0]
    rng = np.random.default_rng(seed)
    bh = rng.standard_normal(n)
    Lu = L.copy()
    Lu.data = Lu.data * (1.0 + 0.2 * rng.random(Lu.nnz))
    A = ht.DistSparseMatrix.from_scipy(L, be)
    Au = ht.DistSparseMatrix.from_scipy(Lu, be)
    b = ht.DistVector.from_global(bh, be)
    F = ht.ldlt(A)
    x = F.solve(b)
    Fu = ht.lu(Au)
    out = {"ldlt.local": x.data, "ldlt.full": x.to_numpy(),
           "ldlt_host.full": F.solve(bh), "root": F.sym is not None,
           "native": F.native is not None,
           "lu.full": Fu.solve(b).to_numpy(),
           "lu_t.full": Fu.solve(b, transpose=True).to_numpy(),
           "lu_st.full": Fu.solve_transpose(b).to_numpy()}
    ht.clear_plan_cache("backslash")
    x1 = ht.solve(A, b)
    F1 = next(iter(ht.BackslashCache._cache().values()))
    A2 = A.with_values(ht.DistSparseMatrix.from_scipy(
        (2.0 * L + sp.eye(n)).tocsr(), be).nzval)
    x2 = ht.solve(A2, b)
    cache = ht.BackslashCache._cache()
    out.update({"bs1.full": x1.to_numpy(), "bs2.full": x2.to_numpy(),
                "bs2.local": x2.data, "bs.entries": len(cache),
                "bs.hit": next(iter(cache.values())) is F1 and F1.A is A2})
    ht.clear_plan_cache("backslash")
    # the graph Laplacian (rows summing to 0) is singular: a pivot perturbs
    G = (L - sp.diags(np.asarray(L.sum(axis=1)).ravel())).tocsr()
    Ag = ht.DistSparseMatrix.from_scipy(G, be)
    out.update({"perturbed.ldlt": ht.ldlt(Ag).n_perturbed,
                "perturbed.lu": ht.lu(Ag).n_perturbed})
    return {f"solve.{k}": _np(v) for k, v in out.items()}


# -- the device solver and the dense containers ------------------------------

def solver_inputs(S: int, k: int = 10, seed: int = 12) -> dict:
    """The host inputs of ``device_solvers``, for the JAX package too:
    ``L`` laplace2d(k) on ``p``, a partition with an empty shard, and
    ``L2`` = 2 L + I on its pattern; ``N`` = L - sigma I, indefinite
    (sigma between two of L's eigenvalues); ``Lu`` L plus a seeded random
    pattern (unsymmetric); ``H`` the c128 Helmholtz operator on
    laplace2d(k); ``b``, ``bc`` (complex) and ``B`` (n x 3) right-hand
    sides."""
    rng = np.random.default_rng(seed)
    L = laplace2d(k)
    n = L.shape[0]
    Lu = (L + sp.random(n, n, 0.03, random_state=rng)).tocsr()
    return {"L": L, "L2": (2.0 * L + sp.eye(n)).tocsr(),
            "N": (L - between_eigenvalues(k, 2.0) * sp.eye(n)).tocsr(),
            "Lu": Lu, "H": helmholtz(k),
            "p": empty_shard_partition(n, S),
            "b": rng.standard_normal(n),
            "bc": rng.standard_normal(n) + 1j * rng.standard_normal(n),
            "B": rng.standard_normal((n, 3))}


def plan_digest(eng) -> str:
    """A digest of a device multifrontal plan's global scalars (order,
    shard count, cross buffer, top set, solve space, the owner map and
    every level's padded geometry) and of its top tables: the same in
    every rank of a group and in the stacked plan at that S."""
    import hashlib

    h = hashlib.blake2b(digest_size=16)
    levels = eng.local_levels + eng.top_levels
    h.update(np.asarray([eng.n, eng.S, eng.CROSS, eng.TOPM, eng.Mmax,
                         eng.SVPAD, eng.n_topcols], np.int64).tobytes())
    h.update(np.asarray(eng.owner, np.int64).tobytes())
    h.update(np.asarray([(m.B, m.NC, m.NF) for m in levels],
                        np.int64).tobytes())
    tables = [eng.topcols]
    for m in eng.top_levels:
        tables += [m.a_src, m.a_dst, m.diag, m.ccol, m.crow, m.crow_add]
        tables += [t for ea in m.ea for t in ea[1:]]
        tables += [t for ea in m.ea_cross for t in ea[:4]]
    for t in tables:
        h.update(_np(t).tobytes())
    return h.hexdigest()


def _factor_stats(F, tag: str) -> dict:
    """A device factorization's global counts, its engine's owner set,
    cross buffer and plan digest under ``tag``, and why its factor and
    solves run eagerly ("" when they are CUDA graphs)."""
    eng = F.engine
    return {f"{tag}.n_perturbed": F.n_perturbed, f"{tag}.growth": F.growth,
            f"{tag}.owners": np.unique(eng.owner[eng.owner >= 0]),
            f"{tag}.cross": eng.CROSS, f"{tag}.digest": plan_digest(eng),
            f"{tag}.refusal": F.refusal or ""}


def device_solvers(be, k: int = 10, seed: int = 12) -> dict:
    """The device multifrontal solver on ``solver_inputs``: ``ldlt(spd=
    True)`` on a partition with an empty shard (DistVector and host-array
    right-hand sides, ``solve_matrix`` of a DistDenseMatrix), its
    ``refactorize`` with new values (a cache hit: no plan is built), the
    indefinite ``ldlt``, ``lu`` with its transposed solve, the c128
    ``ldlt``, a Cholesky of the indefinite matrix (which must raise
    ValueError in every rank) and ``ht.solve`` on a ``solver="device"``
    backend; with the fallback's warning an error. A solution gives its
    rows and whole, a factorization its counts, owners and digest."""
    import warnings

    import hpclinalg_torch as ht
    from ..solver.device_mf import DeviceFactorization

    inp = solver_inputs(be.nshards, k, seed)
    p = inp["p"]
    out, vecs = {}, {}
    with warnings.catch_warnings():
        warnings.filterwarnings("error",
                                message="device multifrontal unavailable")
        A = ht.DistSparseMatrix.from_scipy(inp["L"], be, row_partition=p)
        b = ht.DistVector.from_global(inp["b"], be, partition=p)
        F = ht.ldlt(A, method="device", spd=True)
        out["chol.device"] = isinstance(F, DeviceFactorization)
        vecs["chol"] = F.solve(b)
        out["chol_host.full"] = F.solve(inp["b"])
        X = F.solve_matrix(ht.DistDenseMatrix.from_global(inp["B"], be,
                                                          row_partition=p))
        out.update({"chol_matrix.local": X.data,
                    "chol_matrix.full": X.to_numpy(),
                    **_factor_stats(F, "chol")})
        eng, sizes = F.engine, ht.cache_sizes()
        A2 = A.with_values(ht.DistSparseMatrix.from_scipy(
            inp["L2"], be, row_partition=p).nzval)
        vecs["refactor"] = F.refactorize(A2).solve(b)
        out["refactor.hit"] = F.engine is eng and ht.cache_sizes() == sizes

        Nd = ht.DistSparseMatrix.from_scipy(inp["N"], be)
        bu = ht.DistVector.from_global(inp["b"], be)
        Fl = ht.ldlt(Nd, method="device")
        vecs["ldl"] = Fl.solve(bu)
        out.update({**_factor_stats(Fl, "ldl"), **chol_failure(be, k)})

        Fu = ht.lu(ht.DistSparseMatrix.from_scipy(inp["Lu"], be),
                   method="device")
        vecs["lu"] = Fu.solve(bu)
        vecs["lu_t"] = Fu.solve_transpose(bu)
        out.update(_factor_stats(Fu, "lu"))

        Hd = ht.DistSparseMatrix.from_scipy(inp["H"], be)
        Fc = ht.ldlt(Hd, method="device")
        vecs["c128"] = Fc.solve(ht.DistVector.from_global(inp["bc"], be))
        out.update(_factor_stats(Fc, "c128"))

        dev = replace(be, solver="device")
        ht.clear_plan_cache("backslash")
        Ad = ht.DistSparseMatrix.from_scipy(inp["L"], dev)
        vecs["backslash"] = ht.solve(Ad, ht.DistVector.from_global(
            inp["b"], dev))
        out["backslash.device"] = isinstance(
            next(iter(ht.BackslashCache._cache().values())),
            DeviceFactorization)
        ht.clear_plan_cache("backslash")
    for name, v in vecs.items():
        out[f"{name}.local"] = v.data
        out[f"{name}.full"] = v.to_numpy()
    return {f"dsol.{k}": _np(v) for k, v in out.items()}


# the SpMM engines of ``dense_ops``: name -> (matrix of dense_inputs, spmv
# module limits its plan is built under); the segment engine is the
# fallback of a plan with no ELL layout
SPMM_CASES = {"dia": ("L", {}), "densify": ("R", {}),
              "ell": ("W", {"DENSE_MAX_ELEMS": 0}),
              "segment": ("W", {"DENSE_MAX_ELEMS": 0})}


def dense_inputs(S: int, m: int = 37, c: int = 5, seed: int = 13) -> dict:
    """The host inputs of ``dense_ops``, for the JAX package too: ``D``,
    ``D2`` (m x c) on ``p``, a partition with an empty shard; ``E`` (c x
    4), ``v`` (c), ``w`` (m); the SpMM matrices ``L`` laplace2d(6), ``R``
    a small random one and ``W`` a random one with a long row (past the
    ELL width, into the COO tail), each with a dense right-hand side
    ``B_<name>`` (3 columns, on ``pb``: another uneven partition);
    ``Sp`` a sparse (c x 9) right factor of ``D``, and ``Ls``/``Y`` a
    laplace2d(5) system with 2 right-hand sides. ``R`` has more distinct
    diagonals a shard than the DIA engine takes at 4 shards."""
    from ..partition import uniform_partition

    rng = np.random.default_rng(seed)
    W = sp.random(60, 50, 0.06, format="lil", random_state=rng)
    W[3, :] = rng.standard_normal(50)
    mats = {"L": laplace2d(6), "R": sp.random(120, 100, 0.1, format="csr",
                                              random_state=rng),
            "W": W.tocsr()}
    out = {"D": rng.standard_normal((m, c)),
           "D2": rng.standard_normal((m, c)), "E": rng.standard_normal((c, 4)),
           "v": rng.standard_normal(c), "w": rng.standard_normal(m),
           "p": empty_shard_partition(m, S), "pu": uniform_partition(m, S),
           "Sp": sp.random(c, 9, 0.5, format="csr", random_state=rng),
           "Ls": laplace2d(5), "Y": rng.standard_normal((25, 2)), **mats}
    for name, M in mats.items():
        out[f"B_{name}"] = rng.standard_normal((M.shape[1], 3))
        out[f"pb_{name}"] = empty_shard_partition(M.shape[1], S)
    return out


def dense_ops(be, m: int = 37, c: int = 5, seed: int = 13) -> dict:
    """The dense containers on ``dense_inputs``: ``from_global``/
    ``to_numpy`` on a partition with an empty shard, arithmetic, ``D @ v``,
    ``rmatvec`` and ``D.T @ w``, ``D @ E``, the materialised transpose,
    ``sum`` over all three axes, ``norm`` (1, 2, inf), ``opnorm`` (1,
    inf), a repartition, sparse @ dense on the DIA, densify, ELL (with its
    COO tail) and segment engines, dense @ sparse through the densified
    block and through the transposes, and the host ``solve_matrix`` and
    ``ht.solve(A, DistDenseMatrix)``. A matrix gives its rows and whole, a
    vector its rows and whole, a reduction its value."""
    import hpclinalg_torch as ht
    from ..ops import mixed as mixed_mod
    from ..ops import spmv as spmv_mod

    inp = dense_inputs(be.nshards, m, c, seed)
    p = inp["p"]
    D = ht.DistDenseMatrix.from_global(inp["D"], be, row_partition=p)
    D2 = ht.DistDenseMatrix.from_global(inp["D2"], be, row_partition=p)
    v = ht.DistVector.from_global(inp["v"], be)
    w = ht.DistVector.from_global(inp["w"], be, partition=p)
    E = ht.DistDenseMatrix.from_global(inp["E"], be)
    mats = {"D": D, "arith": 2.0 * D + D2 - 1.5, "neg_abs": abs(-D),
            "matmat": D @ E, "transpose": D.transpose_materialized(),
            "lazy_matmat": D.T @ D, "repartition": D.repartition(inp["pu"])}
    vecs = {"matvec": D @ v, "rmatvec": D.rmatvec(w), "lazy_rmatvec": D.T @ w,
            "sum1": D.sum(axis=1)}
    out = {"sum": D.sum(), "sum0": D.sum(axis=0), "norm2": D.norm(),
           "norm1": D.norm(1), "norminf": D.norm(np.inf),
           "opnorm1": D.opnorm(1), "opnorminf": D.opnorm(np.inf),
           "transpose.col_partition": mats["transpose"].col_partition}
    for name, (mat, limits) in SPMM_CASES.items():
        no_ell = {"_build_ell": lambda self, A: None} if name == "segment" \
            else {}
        M = ht.DistSparseMatrix.from_scipy(inp[mat], be)
        B = ht.DistDenseMatrix.from_global(inp[f"B_{mat}"], be,
                                           row_partition=inp[f"pb_{mat}"])
        ht.clear_plan_cache("vector_plan")
        with patched(spmv_mod, **limits), \
                patched(spmv_mod.SpMVPlan, **no_ell):
            plan = spmv_mod.get_spmm_plan(M, B)
        mats[f"spmm_{name}"] = M @ B
        out[f"spmm_{name}.engine"] = "dia" if plan.offsets is not None else (
            "densify" if plan.densify else "ell" if plan.ell else "segment")
    ht.clear_plan_cache("vector_plan")
    Sp = ht.DistSparseMatrix.from_scipy(inp["Sp"], be)
    mats["dxs_densify"] = D @ Sp
    with patched(mixed_mod, DXS_DENSIFY_MAX_ELEMS=0):
        mats["dxs_transposes"] = D @ Sp
    Ls = ht.DistSparseMatrix.from_scipy(inp["Ls"], be)
    Y = ht.DistDenseMatrix.from_global(inp["Y"], be)
    mats["host_solve_matrix"] = ht.ldlt(Ls).solve_matrix(Y)
    ht.clear_plan_cache("backslash")
    mats["backslash_dense"] = ht.solve(Ls, Y)
    ht.clear_plan_cache("backslash")
    for name, M in mats.items():
        out[f"{name}.local"] = M.data
        out[f"{name}.full"] = M.to_numpy()
        out[f"{name}.row_partition"] = M.row_partition
    for name, x in vecs.items():
        out[f"{name}.local"] = x.data
        out[f"{name}.full"] = x.to_numpy()
    return {f"dense.{k}": _np(v) for k, v in out.items()}


def solver_checks(be) -> dict:
    """The bodies of ``tests/test_torch_dist_solvers.py``."""
    return {**device_solvers(be), **dense_ops(be)}


def chol_failure(be, k: int = 10) -> dict:
    """A device Cholesky of ``solver_inputs``' indefinite N: 1 if it
    raised ValueError in this rank."""
    import hpclinalg_torch as ht

    L = laplace2d(k)
    N = (L - between_eigenvalues(k, 2.0) * sp.eye(L.shape[0])).tocsr()
    try:
        ht.ldlt(ht.DistSparseMatrix.from_scipy(N, be), method="device",
                spd=True)
    except ValueError:
        return {"chol_failure.raised": np.asarray(1)}
    return {"chol_failure.raised": np.asarray(0)}


# -- utilities -----------------------------------------------------------------

def utilities(be, n: int = 37, k: int = 5, seed: int = 6) -> dict:
    """comm_size, comm_rank, io0, to_backend both ways between the group
    and a stacked one-shard backend on this process's device,
    from_reference of stacked host state, and ``with_dtype``."""
    import hpclinalg_torch as ht
    from ..vector import _stack

    S = be.nshards
    xh = np.random.default_rng(seed).standard_normal(n)
    p = empty_shard_partition(n, S)
    x = ht.DistVector.from_global(xh, be, partition=p)
    one = ht.backend_auto(1, device=be.device)
    xs = ht.to_backend(x, one)
    A = ht.DistSparseMatrix.from_scipy(laplace2d(k), be)
    As = ht.to_backend(A, one)
    st = A.structure
    v = ht.from_reference(be, data=_stack(xh, p, np.float64), partition=p)
    M = ht.from_reference(
        be, nzval=np.stack([np.pad(A.to_scipy()[st.row_partition[s]:
                                                st.row_partition[s + 1]].data,
                                   (0, st.NNZpad - st.nnz_local[s]))
                            for s in range(S)]),
        indptr=st.indptr, colval=st.colval, col_indices=st.col_indices,
        row_partition=st.row_partition, col_partition=st.col_partition,
        ncols=A.ncols)
    out = {"comm_size": ht.comm_size(be), "comm_rank": ht.comm_rank(),
           "io0": ht.io0() is sys.stdout,
           "to_one.full": xs.to_numpy(),
           "to_one.shards": xs.data.shape[0],
           "back.local": ht.to_backend(xs, be).data,
           "sparse_to_one.nnz": As.nzval.shape[1],
           "sparse_to_one.values": As.host_values(),
           "sparse_back.local": ht.to_backend(As, be).nzval,
           "ref_vec.local": v.data, "ref_mat.local": M.nzval,
           "ref_mat.same_hash": M.hash == A.hash,
           "with_dtype.keeps_group": be.with_dtype(np.float32).group
           is be.group and be.with_dtype(np.float32).rank == be.rank,
           "with_dtype.f32": ht.DistVector.from_global(
               xh, be.with_dtype(np.float32), partition=p).data}
    return {f"util.{k}": _np(v) for k, v in out.items()}


# -- indexing, assignment, blocks, reductions, map_rows, the KKT assembly ------

def assembly_inputs(S: int, n: int = 37, seed: int = 9) -> dict:
    """The host inputs of ``assembly_cases``, for the JAX package too: ``R``
    n x (n - 3) random on ``p`` (a partition with an empty shard) and its
    grid neighbours for ``cat``, ``L`` = laplace2d(6), vectors ``x`` (on
    ``p``) and ``y`` (on ``pu``, uniform), ``D`` n x 4, index lists with
    repeats and the values assigned, each on a partition of its own."""
    from ..partition import uniform_partition

    rng = np.random.default_rng(seed)

    def rand(m, k, density):
        M = sp.random(m, k, density=density, format="csr", random_state=rng)
        M.data = rng.standard_normal(M.nnz)
        return M

    ids = rng.integers(0, n, 12)
    ids[-3:] = ids[:3]                          # repeated ids
    srows = np.array([4, 30, 11, 33, 0])
    pu = uniform_partition(n, S)
    return {"p": empty_shard_partition(n, S), "pu": pu,
            "R": rand(n, n - 3, 0.15), "B12": rand(n, 5, 0.3),
            "B21": rand(6, n - 3, 0.3), "B22": rand(6, 5, 0.5),
            "p6": uniform_partition(6, S), "L": laplace2d(6),
            "x": rng.standard_normal(n), "y": rng.standard_normal(n),
            "ids": ids, "pi": uniform_partition(len(ids), S),
            "vals": rng.standard_normal(len(ids)),
            "cids": np.array([3, 20, 3, 0, 33]),
            "srows": srows, "scols": np.array([2, 9, 17, 25, 30, 31]),
            "Vs": rand(len(srows), 6, 0.5), "pv": uniform_partition(5, S),
            "Vr": sp.csr_matrix(np.array([[1.0, 0.0, 2.0], [0.0, 3.0, 0.0],
                                          [4.0, 5.0, 0.0]])),
            "pr": uniform_partition(3, S),
            # the last row of the last shard: on the last rank, not rank 0
            "krow": int(pu[-2]), "D": rng.standard_normal((n, 4)),
            "drows": np.array([36, 2, 19, 2, 28]),
            "Dv": rng.standard_normal((5, 2)), "Dh": rng.standard_normal(
                (len(ids), 2))}


def _arrays(name: str, obj) -> dict:
    """A result of ``assembly_cases`` as numpy arrays: a sparse matrix's
    values (``.local``, this process's rows) and hash, a vector's or a
    dense matrix's rows and the whole (``.full``), a scalar's value, and 0
    for None (a call that returns nothing)."""
    if obj is None:
        return {name: np.asarray(0)}
    if hasattr(obj, "nzval"):
        return {f"{name}.local": _np(obj.nzval),
                f"{name}.hash": np.asarray(obj.hash)}
    if hasattr(obj, "row_partition") or hasattr(obj, "partition"):
        return {f"{name}.local": _np(obj.data),
                f"{name}.full": _np(obj.to_numpy())}
    return {name: _np(obj)}


KKT_SMALL = (12, 30, 5)   # k, m, seed of the KKT assembly in the CPU tests


def assembly_cases(api, be, inp: dict, stack) -> dict:
    """Indexing, assignment, blocks, every sparse reduction and ``map_rows``
    through ``api`` (``hpclinalg_torch``, or a package with the same API:
    the CPU tests pass the JAX package with its backend) on backend ``be``
    and ``assembly_inputs``, then ``warmup`` and the KKT assembly's
    ``cat``, submatrices and Dirichlet rows at ``KKT_SMALL``; ``stack``
    stacks ``api``'s 0-d arrays into a row. Returns each result as
    ``_arrays`` gives it, taken as soon as it is made (the assignments
    change their matrix in place)."""
    from .kkt import Inputs

    p, pu = inp["p"], inp["pu"]
    ids, vals, srows, scols = (inp["ids"], inp["vals"], inp["srows"],
                               inp["scols"])
    n = len(inp["x"])
    out = {}

    def put(name, obj):
        out.update(_arrays(name, obj))

    def vec(a, part=p):
        return api.DistVector.from_global(a, be, partition=part)

    def sparse(M, part=p):
        return api.DistSparseMatrix.from_scipy(M, be, row_partition=part)

    def dense(M, part=p):
        return api.DistDenseMatrix.from_global(M, be, row_partition=part)

    x, y, R = vec(inp["x"]), vec(inp["y"], pu), sparse(inp["R"])
    # vector getindex and setindex
    put("vget_slice", x[3:30])
    put("vget_step", x[1:35:3])
    put("vget_ids", x[ids])
    put("vget_vec", x[vec(ids.astype(np.float64), inp["pi"])])

    def vset(name, key, value):
        v = vec(inp["x"])
        v[key] = value
        put(name, v)

    uniq = np.unique(ids)
    vset("vset_scalar", slice(2, 20), 1.5)
    vset("vset_host", uniq, vals[: len(uniq)])
    vset("vset_vec", slice(5, 15), y[20:30])
    vset("vset_repeats", ids, vals)
    # sparse getindex: slices, ids, DistVector ids, a column, a row
    put("sget_slice", R[3:30, 2:25])
    put("sget_step", R[1:35:2, ::3])
    put("sget_ids", R[ids, inp["cids"]])
    put("sget_vec", R[vec(ids.astype(np.float64), inp["pi"]), 0:20])
    put("sget_col", R[:, 7])
    put("sget_col_ids", R[ids, 4])
    put("sget_row", R[inp["krow"], :])

    def sset(name, key, value):
        A = sparse(inp["R"])
        A[key] = value
        put(name, A)

    sset("sset_scalar", (slice(2, 6), slice(3, 9)), 2.0)
    sset("sset_scipy", (srows, scols), inp["Vs"])
    # the value's entries live on other ranks than the rows they land in
    sset("sset_dist", (srows, scols), sparse(inp["Vs"], inp["pv"]))
    sset("sset_dist_repeats", ([7, 1, 7], [4, 9, 4]),
         sparse(inp["Vr"], inp["pr"]))
    sset("sset_repeats", ([1, 30, 1], [2, 5, 2]),
         np.arange(1.0, 10.0).reshape(3, 3))
    k = inp["krow"]
    sset("sset_grow", (slice(k, k + 1), slice(0, n - 3)),
         np.ones((1, n - 3)))          # a row grown to the full width
    # dense getindex and setindex
    D, Du = dense(inp["D"]), dense(inp["D"], pu)
    put("dget_row", Du[k, 1:4])
    put("dget_rows", D[ids, 1:3])
    put("dget_col", D[ids, 2])

    def dset(name, key, value):
        E = dense(inp["D"])
        E[key] = value
        put(name, E)

    dset("dset_dist", (inp["drows"], slice(0, 2)),
         dense(inp["Dv"], inp["pv"]))
    dset("dset_host", (ids, [0, 3]), inp["Dh"])
    # blocks
    put("cat22", api.cat(R, sparse(inp["B12"]), sparse(inp["B21"], inp["p6"]),
                         sparse(inp["B22"], inp["p6"]), dims=(2, 2)))
    Lm = sparse(inp["L"], None)
    put("blockdiag", api.blockdiag(R[0:36, :], Lm))
    put("dcat_v", api.vcat_dense(D, Du[0:5, :]))
    put("dcat_h", api.hcat_dense(D, Du))
    put("vcat_vectors", api.vcat_vectors(x, y))
    put("hcat_vectors", api.hcat_vectors(x, y))
    # every sparse reduction
    for name, fn in (("norm2", lambda: R.norm()), ("norm1", lambda: R.norm(1)),
                     ("norminf", lambda: R.norm(np.inf)),
                     ("norm3", lambda: R.norm(3)),
                     ("opnorm1", lambda: R.opnorm(1)),
                     ("opnorminf", lambda: R.opnorm(np.inf)),
                     ("sum", lambda: R.sum()), ("sum0", lambda: R.sum(axis=0)),
                     ("sum1", lambda: R.sum(axis=1)), ("tr", lambda: Lm.tr()),
                     ("maximum", lambda: R.maximum()),
                     ("minimum", lambda: R.minimum()),
                     ("mean", lambda: R.mean())):
        put(name, fn())
    # map_rows over arguments on different partitions, mapslices over rows
    put("map_vec_dense", api.map_rows(lambda a, r: a * r.sum(), x, Du))
    put("map_row", api.map_rows(lambda r: stack([r[0] - r[1], 2 * r[2]]), D))
    put("mapslices_rows", D.mapslices(lambda r: stack([r.sum(), r[3]]),
                                      axis=1))
    put("map_vertex", api.map_rows(lambda i: 2 * i + 1,
                                   api.vertex_indices(pu, be)))
    put("warmup", api.warmup(be))
    # the KKT assembly at KKT_SMALL: cat, submatrices, the Dirichlet rows
    I = Inputs(*KKT_SMALL)
    nk = I.n
    K = api.cat(*[api.DistSparseMatrix.from_scipy(M, be)
                  for M in (I.A, I.Bt, I.B, I.C)], dims=(2, 2))
    put("kkt_K", K)
    put("kkt_K11", K[0:nk, 0:nk])
    put("kkt_Kp", K[I.p, I.p])
    put("kkt_Kn", K[nk:, :])
    put("kkt_Kj", K[:, I.j])
    K[I.bnd, I.bnd] = sp.eye(len(I.bnd))
    put("kkt_edit", K)
    put("kkt_edit_opnorm1", K.opnorm(1))
    return out


def assembly_checks(be, trace_dir: str | None = None) -> dict:
    """The body of ``tests/test_torch_dist_assembly.py``: ``assembly_cases``
    through this package, then ``tools/kkt.drive`` at ``KKT_SMALL``, every
    step held against scipy by the drive in this process (a failing check
    raises), its one traced ``K @ z`` written to ``trace_dir``."""
    import hpclinalg_torch as ht
    from . import kkt

    out = assembly_cases(ht, be, assembly_inputs(be.nshards), torch.stack)
    res = kkt.drive(be, kkt.Inputs(*KKT_SMALL), trace_dir=trace_dir)
    for key in ("engine", "k11_engine", "blockdiag_engine"):
        out[f"drive.{key}"] = np.asarray(res[key])
    return {f"asm.{k}": v for k, v in out.items()}


# the operations of indexing, assignment, blocks, the sparse reductions,
# map_rows and warmup, each with the case of ``assembly_cases`` that runs it
GROUP_OPS = {"dense_getindex": "dget_rows", "dense_setindex": "dset_host",
             "dense_mapslices_rows": "mapslices_rows", "dense_cat": "dcat_v",
             "vector_getindex": "vget_step", "vector_setindex": "vset_repeats",
             "sparse_getindex": "sget_slice", "sparse_setindex": "sset_scalar",
             "cat": "cat22", "blockdiag": "blockdiag",
             "vcat_vectors": "vcat_vectors", "hcat_vectors": "hcat_vectors",
             "norm": "norm2", "opnorm": "opnorminf", "sum": "sum",
             "row_sum": "sum1", "tr": "tr", "maximum": "maximum",
             "minimum": "minimum", "mean": "mean",
             "map_rows": "map_vec_dense", "warmup": "warmup"}


def group_ops(be) -> dict:
    """Each operation of ``GROUP_OPS`` as its case of ``assembly_cases``
    runs it: this process's rows of a container result (``grp.<op>.local``)
    or the value of a scalar (``grp.<op>``; 0 for ``warmup``, which returns
    nothing)."""
    import hpclinalg_torch as ht

    res = assembly_cases(ht, be, assembly_inputs(be.nshards), torch.stack)
    out = {}
    for op, case in GROUP_OPS.items():
        key = f"{case}.local" if f"{case}.local" in res else case
        out[f"grp.{op}" + key[len(case):]] = res[key]
    return out


# -- the process ---------------------------------------------------------------

def meta(be) -> dict:
    return {"meta.rank": np.asarray(be.rank), "meta.world": np.asarray(be.world),
            "meta.nlocal": np.asarray(be.nlocal),
            "meta.jax": np.asarray("jax" in sys.modules),
            "meta.hpclinalg": np.asarray("hpclinalg" in sys.modules)}


# -- the main path at full size, per rank (tests/test_torch_card_groups.py) --

LAUNCH_COUNTERS = ("dia", "ell", "gather", "resident")
# the CG step's vector kernels (ops/cuda_cg.py), which only
# entry.cg_step_fn's step launches
CG_LAUNCH_COUNTERS = ("cg_dots", "cg_update_xr", "cg_update_p")
# the device LDLᵀ's leaf kernel (ops/cuda_ldl.py), which only a device
# factorization with spd=False launches
LDL_LAUNCH_COUNTERS = ("ldl_leaf",)


def _launchers() -> dict:
    from ..ops import cuda_cg, cuda_dia, cuda_ell, cuda_ell_resident, cuda_ldl

    return {"dia": cuda_dia.dia_spmv, "ell": cuda_ell.ell_spmv,
            "gather": cuda_ell.gather,
            "resident": cuda_ell_resident.ell_resident_spmv,
            **{k: getattr(cuda_cg, k) for k in CG_LAUNCH_COUNTERS},
            **{k: getattr(cuda_ldl, k) for k in LDL_LAUNCH_COUNTERS}}


def launch_counts() -> dict:
    """The kernels' launch counters: K1, K2, K2's gather mode, K3
    (``LAUNCH_COUNTERS``), the CG step's three (``CG_LAUNCH_COUNTERS``) and
    the device LDLᵀ's leaf (``LDL_LAUNCH_COUNTERS``)."""
    return {k: f.launches for k, f in _launchers().items()}


def reset_launch_counts() -> None:
    for f in _launchers().values():
        f.launches = 0


def card_matrices(k: int, n: int, ridge: tuple, seed: int) -> dict:
    """The card tests' matrices (tools/matrices.py, their seeds):
    laplace2d(k) (K1), the random n x 8 (K2 and its gather mode), the power
    law (K2's tail), the ridge design A with its right-hand side and scipy's
    normal matrix N = AᵀA + λI (K3), and the complex ones: the Helmholtz
    operator on laplace2d(k) (K1 in c128) and the random matrix and N
    with seeded imaginary parts (K2 and K3 in c128)."""
    rm = ridge_matrices(ridge, seed)
    R8 = random_8(n, seed + 1)
    return {"lap": laplace2d(k), "random8": R8,
            "power_law": power_law(n, seed + 2), **rm, "helm": helmholtz(k),
            "random8_c128": complex_values(R8, seed + 9),
            "N_c128": complex_values(rm["N"], seed + 10)}


def ridge_matrices(ridge: tuple, seed: int) -> dict:
    """The ridge design A (``ridge`` = (m, n, λ): m x n,
    ``banded_design``), its right-hand side and scipy's normal matrix
    N = AᵀA + λI: ``card_matrices``' ``design``, ``design_b`` and ``N``."""
    m, nr, lam = ridge
    Ab, bh = banded_design(m, nr, seed + 8)
    N = (Ab.T @ Ab + lam * sp.eye(nr)).tocsr()
    N.sort_indices()
    return {"design": Ab, "design_b": bh, "N": N}


# the products of ``card``: name -> (matrix of card_matrices, the
# backend's dtype when it is not the caller's); the complex matrices are
# promoted to c128 on the caller's (f64) backend and share its plans
CARD_PRODUCTS = {"lap": ("lap", None), "lap_f32": ("lap", np.float32),
                 "random8": ("random8", None),
                 "power_law": ("power_law", None), "N": ("N", None),
                 "helm": ("helm", None),
                 "random8_c128": ("random8_c128", None),
                 "N_c128": ("N_c128", None)}


def ridge(be, mats: dict, As: dict, lam: float, steps: int) -> dict:
    """The ridge path on this rank's shard: At = A.T.materialize() (the
    transpose exchange), C = At @ A (the pair SpGEMM), N =
    C.add_identity(λ), rhs = At @ b (K2), ``steps`` CG steps on N (K3) for
    x, A @ x (K3); the refit A.with_values(1.5 A.nzval), whose products
    must reuse every plan; laplace2d(k) + the random matrix (an addition
    across patterns), diag and triu of laplace2d(k); and the c128
    transpose of A's values times (0.6 - 0.8i) and the c128 Helmholtz
    operator plus the random c128 matrix (``As``: ``card``'s matrices,
    which hold the last four). Returns the results, each under
    ``ridge.``; ``check.ridge_*`` are this rank's checks against scipy
    (relative errors, the pattern)."""
    import hpclinalg_torch as ht
    from ..ops import spgemm as spgemm_mod

    Ad = ht.DistSparseMatrix.from_scipy(mats["design"], be)
    b = ht.DistVector.from_global(mats["design_b"], be)
    At = Ad.T.materialize()
    C = At @ Ad
    N = C.add_identity(lam)
    rhs = At @ b
    # N's condition number is near 3: the CG steps reach the direct
    # solution (the stacked ridge test holds them to ldlt(N)'s to 1e-11);
    # the host ldlt on a group is card()'s solves
    x, _ = api_cg(N, rhs, steps)
    y = Ad @ x
    out = {"ridge.At.local": At.nzval, "ridge.C.local": C.nzval,
           "ridge.N.local": N.nzval, "ridge.rhs.local": rhs.data,
           "ridge.x.local": x.data, "ridge.Ax.local": y.data,
           "ridge.spgemm.engine": spgemm_mod.engine(At, Ad),
           "ridge.spgemm.nchunks": spgemm_mod.get_spgemm_plan(At, Ad).nchunks}
    Nh, Nsc = N.to_scipy(), mats["N"]
    xh, rh = x.to_numpy(), rhs.to_numpy()
    out.update({
        "check.ridge_N_pattern": np.array_equal(Nh.indptr, Nsc.indptr)
        and np.array_equal(Nh.indices, Nsc.indices),
        "check.ridge_N_rel_err": np.abs(Nh.data - Nsc.data).max()
        / np.abs(Nsc.data).max(),
        "check.ridge_solve_res": np.linalg.norm(Nsc @ xh - rh)
        / np.linalg.norm(rh),
        "check.ridge_Ax_rel_err": np.abs(y.to_numpy() - mats["design"] @ xh)
        .max() / np.abs(mats["design"] @ xh).max()})
    sizes = ht.cache_sizes()
    A2 = Ad.with_values(Ad.nzval * 1.5)
    C2 = A2.T.materialize() @ A2
    out.update({"check.ridge_refit_reused": ht.cache_sizes() == sizes
                and C2.structure is C.structure,
                "ridge.C2.local": C2.nzval})

    lap, r8 = As["lap"], As["random8"]
    S = lap + r8
    out.update({"ridge.add.local": S.nzval, "ridge.add.hash": S.hash,
                "ridge.diag.local": lap.diag().data,
                "ridge.triu.local": lap.triu().nzval})
    Ac = Ad.map_nonzeros(lambda v: v * (0.6 - 0.8j))
    out.update({"ridge.At_c128.local": Ac.T.materialize().nzval,
                "ridge.add_c128.local": (As["helm"] + As["random8_c128"])
                .nzval})
    return out


def card(be, k: int = 1000, n: int = 1_000_000,
         ridge_shape: tuple = (1_000_000, 16_384, 1e-2), k_solve: int = 256,
         steps: int = 20, ridge_steps: int = 50, seed: int = 0,
         mats: dict | None = None) -> dict:
    """The main path on this rank's shard at the card tests' sizes: ``A @
    x`` on laplace2d(k) in f64 and f32 (K1, the halo exchange), ``steps``
    CG steps and a dot in each, ``A @ x`` on the random and power-law
    matrices (K2, its gather mode and tail), on N (K3) and, in c128, on
    the Helmholtz operator (K1), the random matrix (K2) and N (K3, or K2
    where the gathered x is over K3's cap), then the ridge assembly
    (``ridge``, with ``ridge_steps`` CG steps on N), then
    ``ldlt(laplace2d(k_solve)).solve(b)`` on the host engine and
    ``ht.solve`` twice on that pattern. Every plan cache is cleared
    first, so the first calls build their plans in every drive. The
    kernels' launch counters are set to 0 just before and read just after
    (``launches.*``). ``mats``: ``card_matrices``' result, if the caller
    has it."""
    import hpclinalg_torch as ht
    from ..ops import spmv as spmv_mod

    ht.clear_plan_cache()
    mats = mats or card_matrices(k, n, ridge_shape, seed)
    rng = np.random.default_rng(seed)
    xh, bh = rng.standard_normal(n), rng.standard_normal(n)
    xc = xh + 1j * rng.standard_normal(n)
    As, xs = {}, {}
    for name, (mat, dt) in CARD_PRODUCTS.items():
        bd = be if dt is None else be.with_dtype(dt)
        As[name] = ht.DistSparseMatrix.from_scipy(mats[mat], bd)
        xs[name] = ht.DistVector.from_global(
            (xc if As[name].dtype.is_complex else xh)[: As[name].ncols], bd)
    plans = {name: spmv_mod.get_spmv_plan(A, xs[name])
             for name, A in As.items()}
    L = laplace2d(k_solve)
    Ls = ht.DistSparseMatrix.from_scipy(L, be)
    L2 = Ls.with_values(ht.DistSparseMatrix.from_scipy(
        (2.0 * L + sp.eye(L.shape[0])).tocsr(), be).nzval)
    bs = ht.DistVector.from_global(bh[: L.shape[0]], be)
    for name, A in As.items():      # value tables and first uses: set-up
        A @ xs[name]
    if be.device.type == "cuda":
        torch.cuda.synchronize()

    out = {}
    reset_launch_counts()
    for name, A in As.items():
        ex = plans[name].exchange
        out[f"{name}.engine"] = plans[name].engine(A.dtype)
        out[f"{name}.y.local"] = (A @ xs[name]).data
        if not ex.is_identity:
            out[f"{name}.exchange.local"] = ex.apply(xs[name].data)
    for name in ("lap", "lap_f32"):
        A, x = As[name], xs[name]
        b = ht.DistVector.from_global(bh, x.backend)
        xcg, rc = api_cg(A, b, steps)
        out.update({f"{name}.y.full": (A @ x).to_numpy(),
                    f"{name}.dot": x.dot(b), f"{name}.cg.local": xcg.data,
                    f"{name}.cg.rnorm": rc.norm()})
    out.update(ridge(be, mats, As, ridge_shape[2], ridge_steps))
    xsol = ht.ldlt(Ls).solve(bs)
    out.update({"solve.local": xsol.data, "solve.full": xsol.to_numpy()})
    ht.clear_plan_cache("backslash")
    x1, x2 = ht.solve(Ls, bs), ht.solve(L2, bs)
    out.update({"solve.bs1.full": x1.to_numpy(), "solve.bs2.full": x2.to_numpy(),
                "solve.bs.entries": len(ht.BackslashCache._cache())})
    ht.clear_plan_cache("backslash")
    out.update({f"launches.{k}": v for k, v in launch_counts().items()})
    return {f"card.{k}": _np(v) for k, v in out.items()}


def _rel_res(M, x, b) -> float:
    return float(np.linalg.norm(M @ x - b) / np.linalg.norm(b))


def solvers(be, k: int = 512, k_small: int = 256,
            ridge_shape: tuple = (1_000_000, 16_384, 1e-2), ycols: int = 64,
            seed: int = 0, mats: dict | None = None) -> dict:
    """The device solver and the dense containers on this rank's shard,
    f64 unless said, with the host fallback's warning made an error:
    ``ldlt(method="device", spd=True)`` of laplace2d(k) and its solve; the
    indefinite ``ldlt`` of laplace2d(k_small) - sigma I, ``lu`` of
    laplace2d(k_small) with unsymmetric values and its transposed solve,
    and the c128 ``ldlt`` of Helmholtz(k_small); then the multi-response
    ridge on ``mats``' design and N (``ridge_matrices``): Y (m x
    ``ycols``) a DistDenseMatrix, R = At @ Y (SpMM), X = ldlt(N,
    method="device", spd=True).solve_matrix(R), G = X.T @ X (the dense
    transpose), and the single response x = solve(At @ b). Every plan
    cache is cleared first; the kernels' launch counters are set to 0 just
    before the drive and read just after (``launches.*``). ``check.*`` are
    this rank's residuals against scipy (the ridge's through N's SpMM)."""
    import warnings

    import hpclinalg_torch as ht
    from ..solver.device_mf import DeviceFactorization

    ht.clear_plan_cache()
    mats = mats or ridge_matrices(ridge_shape, seed)
    rng = np.random.default_rng(seed + 30)
    L = laplace2d(k)
    bh = rng.standard_normal(L.shape[0])
    Ls = laplace2d(k_small)
    ns = Ls.shape[0]
    Nind = (Ls - between_eigenvalues(k_small, 0.5) * sp.eye(ns)).tocsr()
    Lu = Ls.copy()
    Lu.data = Lu.data * (1.0 + 0.2 * rng.random(Lu.nnz))
    H = helmholtz(k_small)
    b2h = rng.standard_normal(ns)
    bch = rng.standard_normal(ns) + 1j * rng.standard_normal(ns)
    Y = rng.standard_normal((ridge_shape[0], ycols))
    A = ht.DistSparseMatrix.from_scipy(L, be)
    b = ht.DistVector.from_global(bh, be)
    systems = {name: ht.DistSparseMatrix.from_scipy(M, be)
               for name, M in (("ldl", Nind), ("lu", Lu), ("c128", H))}
    b2 = ht.DistVector.from_global(b2h, be)
    bc = ht.DistVector.from_global(bch, be)
    Ad = ht.DistSparseMatrix.from_scipy(mats["design"], be)
    Nr = ht.DistSparseMatrix.from_scipy(mats["N"], be)
    Yd = ht.DistDenseMatrix.from_global(Y, be)
    bd = ht.DistVector.from_global(mats["design_b"], be)
    del Y
    if be.device.type == "cuda":
        torch.cuda.synchronize()

    out = {}
    reset_launch_counts()
    with warnings.catch_warnings():
        warnings.filterwarnings("error",
                                message="device multifrontal unavailable")
        F = ht.ldlt(A, method="device", spd=True)
        x = F.solve(b)
        out.update({"chol.device": isinstance(F, DeviceFactorization),
                    "chol.x.local": x.data,
                    "chol.cross_bytes": F.engine.CROSS
                    * F.engine.dtype.itemsize,
                    "check.chol_res": _rel_res(L, x.to_numpy(), bh),
                    **_factor_stats(F, "chol")})
        for name, M, rhs in (("ldl", Nind, b2), ("lu", Lu, b2),
                             ("c128", H, bc)):
            Fs = ht.lu(systems[name], method="device") if name == "lu" \
                else ht.ldlt(systems[name], method="device")
            xs = Fs.solve(rhs)
            out.update({f"{name}.x.local": xs.data,
                        f"check.{name}_res": _rel_res(M, xs.to_numpy(),
                                                      rhs.to_numpy()),
                        **_factor_stats(Fs, name)})
            if name == "lu":
                xt = Fs.solve_transpose(rhs)
                out.update({"lu_t.x.local": xt.data,
                            "check.lu_t_res": _rel_res(
                                Lu.T, xt.to_numpy(), b2h)})
            del Fs
        At = Ad.T.materialize()
        R = At @ Yd
        FN = ht.ldlt(Nr, method="device", spd=True)
        X = FN.solve_matrix(R)
        G = X.T @ X
        rhs = At @ bd
        xr = FN.solve(rhs)
        out.update({"ridge.R.local": R.data, "ridge.X.local": X.data,
                    "ridge.G.local": G.data, "ridge.G.full": G.to_numpy(),
                    "ridge.x.local": xr.data,
                    "ridge.device": isinstance(FN, DeviceFactorization),
                    "check.ridge_multi_res": float((Nr @ X - R).norm()
                                                   / R.norm()),
                    "check.ridge_res": float((Nr @ xr - rhs).norm()
                                             / rhs.norm()),
                    **_factor_stats(FN, "ridge_chol")})
    out.update({f"launches.{k}": v for k, v in launch_counts().items()})
    return {f"sol.{k}": _np(v) for k, v in out.items()}


# -- the KKT assembly at full width, per rank (tests/test_torch_card_groups.py)

def assembly(be, k: int = 1000, m: int = 10_000, seed: int = 30,
             trace_dir: str | None = None) -> dict:
    """``tools/kkt.drive`` on this rank's shard (K = [[A, Bᵀ], [B, −10⁻⁶
    I]], A = laplace2d(k), B m x k² with 16 entries a row,
    ``kkt.Inputs(k, m, seed)`` built in every rank), every step held
    against scipy in this rank (a failing check raises), its one traced
    ``K @ z`` written to ``trace_dir``. The kernels' launch counters are
    set to 0 just before the drive and read just after (``launches.*``).
    Returns the drive's engines."""
    from . import kkt

    I = kkt.Inputs(k, m, seed)
    reset_launch_counts()
    res = kkt.drive(be, I, trace_dir=trace_dir)
    out = {f"launches.{c}": v for c, v in launch_counts().items()}
    out.update({key: v for key, v in res.items() if isinstance(v, str)})
    return {f"asm.{key}": _np(v) for key, v in out.items()}


# -- the raw CG step (hpclinalg_torch.entry): the CPU tests and the card's --

def raw_steps(step, args, steps: int, graphed: bool) -> dict:
    """``steps`` eager steps of ``step`` (``entry.cg_step_fn``) chained from
    ``args``, the launch counters set to 0 just before them and read just
    after everything below: {"out": the last (x, r, p), "launches": {kernel:
    count}, and "graph" or "refused"}. ``graphed``: the step is also
    captured (``entry.capture``) and replayed ``steps`` times from
    ``args``, which must equal the eager steps bit for bit (they launch
    the same kernels in the same order; a check that raises); else
    ``capture`` must refuse the step (CPU tensors, a gloo group) with
    ValueError, whose message is ``refused``."""
    from ..entry import capture

    reset_launch_counts()
    out = args
    for _ in range(steps):
        out = step(*out)
    res = {"out": out}
    if graphed:
        graph = capture(step, args)
        rep = args
        for _ in range(steps):
            rep = graph(*rep)
        if not all(torch.equal(a, b) for a, b in zip(out, rep)):
            raise AssertionError(f"{steps} replays of the captured step "
                                 "differ from the eager steps")
        res["graph"] = graph
    else:
        try:
            capture(step, args)
        except ValueError as e:
            res["refused"] = str(e)
        else:
            raise AssertionError(f"capture took a step on {args[0].device}")
    res["launches"] = launch_counts()
    return res


def entry_steps(be, k: int = 16, steps: int = 20, seed: int = 5,
                dtypes: tuple = ("float64", "float32"),
                graphed: bool = False) -> dict:
    """``entry.cg_step_fn`` on laplace2d(k) in each of ``dtypes``: ``steps``
    raw steps from x = 0, r = p = b (seeded standard normals) through
    ``raw_steps`` (``graphed``: also captured and replayed, bit for bit;
    else ``capture`` must refuse, ``<dtype>.refused``), their x, r and p
    (``<dtype>.{x,r,p}.local``), the engine and the launches
    (``launches.<dtype>.*``)."""
    import hpclinalg_torch as ht
    from ..entry import cg_step_fn

    out = {}
    bh = np.random.default_rng(seed).standard_normal(k * k)
    for dt in dtypes:
        bd = be.with_dtype(dt)
        A = ht.DistSparseMatrix.from_scipy(laplace2d(k), bd)
        step, x0 = cg_step_fn(A, bd)
        b = ht.DistVector.from_global(bh, bd)
        args = (x0.data, b.data, b.data)
        res = raw_steps(step, args, steps, graphed)
        out.update({f"{dt}.{v}.local": t for v, t in zip("xrp", res["out"])})
        out[f"{dt}.engine"] = step.engine
        if graphed:
            out[f"{dt}.graphed_equal"] = True
        else:
            out[f"{dt}.refused"] = res["refused"]
        out.update({f"launches.{dt}.{c}": v
                    for c, v in res["launches"].items()})
    return {f"entry.{k}": _np(v) for k, v in out.items()}


def checks(be) -> dict:
    """Every body of the CPU tests, in one fixed order."""
    out = {}
    for body in (vectors, exchange, spmv, cg, solves, utilities, group_ops):
        out.update(body(be))
    return out


def bodies(be, runs: list) -> dict:
    """The bodies ``runs`` names, [(body, kwargs)], in order in one process,
    every plan cache cleared before each: the card tests' bodies at full
    size with one spawn of the ranks."""
    import hpclinalg_torch as ht

    out = {}
    for body, kwargs in runs:
        ht.clear_plan_cache()
        out.update(BODIES[body](be, **kwargs))
    return out


def comm_counts(be, n: int = 64, steps: int = 5,
                graphed: bool = False) -> dict:
    """The span recorder over ``steps`` CG steps (``entry.cg_step_fn``) on
    the 1-D Laplacian of n rows, f64: eager steps, or (``graphed``) the
    step captured with the recorder on and replayed, the recorder cleared
    between the capture and the replays. Returns the counters
    ``comm.calls`` and ``comm.bytes`` and each span's calls over the steps
    (``spans.<name>``), the bytes the SpMV's exchange sends from this rank
    a product (``sent_bytes``, from ``ExchangePlan._in_splits``) and
    whether it crosses ranks; graphed, also the capture's
    ``graph.cg_step.nodes`` counter (``counted_nodes``) and
    ``graph_nodes`` of the captured graph (``nodes``)."""
    import hpclinalg_torch as ht
    from ..entry import capture, cg_step_fn
    from ..utils import profiling
    from ..utils.graphs import graph_nodes

    lap = sp.diags([-np.ones(n - 1), 2 * np.ones(n), -np.ones(n - 1)],
                   [-1, 0, 1], format="csr")
    A = ht.DistSparseMatrix.from_scipy(lap, be)
    step, x0 = cg_step_fn(A, be)
    ex = step.plan.exchange
    b = ht.DistVector.from_global(np.ones(n), be)
    args = (x0.data, b.data, b.data)
    out = {"sent_bytes": 8 * sum(ex._in_splits) if ex.crosses else 0,
           "crosses": ex.crosses}
    profiling.reset_trace()
    profiling.tracing(True)
    try:
        if graphed:
            step = capture(step, args)
            out["counted_nodes"] = profiling.trace_report()["counters"][
                "graph.cg_step.nodes"]
            out["nodes"] = sum(graph_nodes(step.graph).values())
            profiling.reset_trace()
        for _ in range(steps):
            args = step(*args)
        if graphed:
            torch.cuda.synchronize()
        rep = profiling.trace_report()
    finally:
        profiling.tracing(False)
        profiling.reset_trace()
    out.update({k: rep["counters"].get(k, 0)
                for k in ("comm.calls", "comm.bytes")})
    out.update({f"spans.{k}": v["calls"] for k, v in rep["spans"].items()})
    return {f"counts.{k}": _np(v) for k, v in out.items()}


BODIES = {"checks": checks, "vectors": vectors, "exchange": exchange,
          "spmv": spmv, "algebra": algebra, "cg": cg, "solves": solves,
          "utilities": utilities, "group_ops": group_ops, "card": card,
          "solver_checks": solver_checks, "chol_failure": chol_failure,
          "solvers": solvers, "assembly_checks": assembly_checks,
          "assembly": assembly, "entry_steps": entry_steps,
          "comm_counts": comm_counts, "bodies": bodies}


def on_rank(device: str, body: str, kwargs: dict) -> dict:
    """``parallel.launch.run_ranks`` entry: the body named ``body`` on
    this rank's ``backend_dist`` (f64) with ``kwargs``."""
    import hpclinalg_torch as ht

    be = ht.backend_dist(device="cpu" if device == "cpu" else None)
    return {**BODIES[body](be, **kwargs), **meta(be)}
