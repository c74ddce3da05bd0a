"""Per-rank bodies of the distributed checks, run on every rank of a process
group by ``tests/test_torch_dist.py`` (gloo, CPU) and ``chip_smoke.py``
phase 12 (NCCL or gloo on the card):

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
import time
from contextlib import contextmanager
from dataclasses import replace

import numpy as np
import scipy.sparse as sp
import torch

from .matrices import banded_design, laplace2d, power_law, random_8


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


# -- CG and the host solve ---------------------------------------------------------

def cg(be, k: int = 16, steps: int = 20, seed: int = 5) -> dict:
    """``steps`` CG iterations on laplace2d(k) from x = 0 (tools/ell_ab.cg),
    in f64 and f32: the iterate and the residual."""
    import hpclinalg_torch as ht
    from .ell_ab import cg as cg_steps

    out = {}
    bh = np.random.default_rng(seed).standard_normal(k * k)
    for dt in (np.float64, np.float32):
        bd = replace(be, dtype=dt)
        A = ht.DistSparseMatrix.from_scipy(laplace2d(k), bd)
        x, r = cg_steps(A, ht.DistVector.from_global(bh, bd), steps)
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
           "lu_t.full": Fu.solve(b, transpose=True).to_numpy()}
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


# -- utilities, guards, the process --------------------------------------------------

def utilities(be, n: int = 37, k: int = 5, seed: int = 6) -> dict:
    """comm_size, comm_rank, io0, to_backend both ways between the group
    and a stacked one-shard backend on this process's device, and
    from_reference of stacked host state."""
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
           "ref_mat.same_hash": M.hash == A.hash}
    return {f"util.{k}": _np(v) for k, v in out.items()}


def guarded_ops(be) -> dict:
    """name -> a call of an operation this slice does not run on a process
    group; each must raise NotImplementedError there."""
    import hpclinalg_torch as ht

    n = 16
    A = ht.DistSparseMatrix.from_scipy(laplace2d(4), be)
    x = ht.DistVector.from_global(np.arange(n, dtype=np.float64), be)
    dev = ht.DistSparseMatrix.from_scipy(laplace2d(4),
                                         replace(be, solver="device"))

    def setv():
        x[1:3] = 1.0

    def setA():
        A[0:2, 0:2] = 1.0

    return {
        "transpose": lambda: A.transpose_materialized(),
        "lazy_matrix": lambda: A.T, "lazy_vector": lambda: x.T,
        "adjoint": lambda: A.H,
        "add": lambda: A + A, "add_identity": lambda: A.add_identity(1.0),
        "spgemm": lambda: A @ A, "diag": lambda: A.diag(),
        "triu": lambda: A.triu(), "tril": lambda: A.tril(),
        "dropzeros": lambda: A.dropzeros(),
        "speye": lambda: ht.speye(n, be), "spdiagm": lambda: ht.spdiagm(x),
        "spdiagm_offsets": lambda: ht.spdiagm((1, x)),
        "spzeros": lambda: ht.spzeros(n, n, be),
        "sprand_dist": lambda: ht.sprand_dist(n, n, 0.2, be),
        "from_local_csr": lambda: ht.DistSparseMatrix.from_local_csr(
            [(np.zeros(1, np.int64), np.zeros(0, np.int64), np.zeros(0))]
            * be.nshards, n, be),
        "sparse_repartition": lambda: A.repartition(
            empty_shard_partition(n, be.nshards)),
        "dense": lambda: ht.DistDenseMatrix.from_global(np.ones((n, 2)), be),
        "vector_getindex": lambda: x[1:3], "vector_setindex": setv,
        "sparse_getindex": lambda: A[0:2, 0:2], "sparse_setindex": setA,
        "cat": lambda: ht.cat(A, A), "blockdiag": lambda: ht.blockdiag(A, A),
        "vcat_vectors": lambda: ht.vcat_vectors(x, x),
        "hcat_vectors": lambda: ht.hcat_vectors(x, x),
        "norm": lambda: A.norm(), "opnorm": lambda: A.opnorm(),
        "sum": lambda: A.sum(), "row_sum": lambda: A.sum(axis=1),
        "tr": lambda: A.tr(), "maximum": lambda: A.maximum(),
        "minimum": lambda: A.minimum(), "mean": lambda: A.mean(),
        "map_rows": lambda: ht.map_rows(lambda r: 2 * r, x),
        "device_ldlt": lambda: ht.ldlt(A, method="device", spd=True),
        "device_lu": lambda: ht.lu(A, method="device"),
        "device_backslash": lambda: ht.solve(dev, x),
        "warmup": lambda: ht.warmup(be),
    }


def guards(be) -> dict:
    """On a group: 1 for each guarded operation that raised
    NotImplementedError naming the process group, 0 for one that ran."""
    if not be.is_dist:
        return {}
    out = {}
    for name, call in guarded_ops(be).items():
        try:
            call()
            out[name] = 0
        except NotImplementedError as e:
            if "process-group backend" not in str(e):
                raise
            out[name] = 1
    return {f"guard.{k}": np.asarray(v) for k, v in out.items()}


def meta(be) -> dict:
    return {"meta.rank": np.asarray(be.rank), "meta.world": np.asarray(be.world),
            "meta.nlocal": np.asarray(be.nlocal),
            "meta.jax": np.asarray("jax" in sys.modules),
            "meta.hpclinalg": np.asarray("hpclinalg" in sys.modules)}


# -- chip_smoke.py phase 12: the main path at full size, per rank -----------------

LAUNCH_COUNTERS = ("dia", "ell", "gather", "resident")


def launch_counts() -> dict:
    """The kernels' launch counters: K1, K2, K2's gather mode, K3."""
    from ..ops import cuda_dia, cuda_ell, cuda_ell_resident

    return {"dia": cuda_dia.dia_spmv.launches,
            "ell": cuda_ell.ell_spmv.launches,
            "gather": cuda_ell.gather.launches,
            "resident": cuda_ell_resident.ell_resident_spmv.launches}


def reset_launch_counts() -> None:
    from ..ops import cuda_dia, cuda_ell, cuda_ell_resident

    for f in (cuda_dia.dia_spmv, cuda_ell.ell_spmv, cuda_ell.gather,
              cuda_ell_resident.ell_resident_spmv):
        f.launches = 0


def events_ms(fn, reps: int = 20, warm: int = 3) -> float:
    """The median over ``reps`` calls of ``fn`` of its CUDA-event time in
    ms, each call timed alone (a collective waits for every rank)."""
    for _ in range(warm):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def host_ms(fn, reps: int = 200) -> float:
    """The host's time in ms a call of ``fn`` over ``reps`` calls queued
    without a wait (what the host spends enqueueing one call)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    ms = (time.perf_counter() - t0) * 1e3 / reps
    torch.cuda.synchronize()
    return ms


def card_matrices(k: int, n: int, ridge: tuple, seed: int) -> dict:
    """chip_smoke.py's matrices (tools/matrices.py, its seeds): laplace2d(k)
    (K1), the random n x 8 (K2 and its gather mode), the power law (K2's
    tail) and the ridge normal matrix N (K3)."""
    m, nr, lam = ridge
    Ab, _ = banded_design(m, nr, seed + 8)
    N = (Ab.T @ Ab + lam * sp.eye(nr)).tocsr()
    N.sort_indices()
    return {"lap": laplace2d(k), "random8": random_8(n, seed + 1),
            "power_law": power_law(n, seed + 2), "N": N}


def card(be, k: int = 1000, n: int = 1_000_000,
         ridge: tuple = (1_000_000, 16_384, 1e-2), k_solve: int = 512,
         steps: int = 20, seed: int = 0, mats: dict | None = None) -> dict:
    """The main path on this rank's shard at chip_smoke.py's sizes: ``A @
    x`` on laplace2d(k) in f64 and f32 (K1, the halo exchange), ``steps``
    CG steps and a dot in each, ``A @ x`` on the random and power-law
    matrices (K2, its gather mode and tail) and on N (K3), then
    ``ldlt(laplace2d(k_solve)).solve(b)`` on the host engine and
    ``ht.solve`` twice on that pattern. The kernels' launch counters are
    set to 0 just before and read just after (``launches.*``). On a CUDA
    device it then times the CG step (``tools/ell_ab.cg_step_ms``), the
    random matrix's exchange alone, and on a group an ``all_reduce`` of a
    scalar and an ``all_to_all_single`` of 2^16 doubles to each rank.
    ``mats``: ``card_matrices``' result, if the caller has it."""
    import hpclinalg_torch as ht
    from ..ops import spmv as spmv_mod
    from ..parallel import comm
    from .ell_ab import cg as cg_steps
    from .ell_ab import cg_step_ms

    t0 = time.perf_counter()
    mats = mats or card_matrices(k, n, ridge, seed)
    rng = np.random.default_rng(seed)
    xh, bh = rng.standard_normal(n), rng.standard_normal(n)
    f32 = replace(be, dtype=np.float32)
    As = {"lap": ht.DistSparseMatrix.from_scipy(mats["lap"], be),
          "lap_f32": ht.DistSparseMatrix.from_scipy(mats["lap"], f32),
          **{name: ht.DistSparseMatrix.from_scipy(mats[name], be)
             for name in ("random8", "power_law", "N")}}
    xs = {name: ht.DistVector.from_global(
              xh[: A.ncols], f32 if name == "lap_f32" else be)
          for name, A in As.items()}
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

    out = {"secs.setup": time.perf_counter() - t0}
    t0 = time.perf_counter()
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
        xc, rc = cg_steps(A, b, steps)
        out.update({f"{name}.y.full": (A @ x).to_numpy(),
                    f"{name}.dot": x.dot(b), f"{name}.cg.local": xc.data,
                    f"{name}.cg.rnorm": rc.norm()})
    out["secs.products_cg"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    xsol = ht.ldlt(Ls).solve(bs)
    out.update({"solve.local": xsol.data, "solve.full": xsol.to_numpy()})
    ht.clear_plan_cache("backslash")
    x1, x2 = ht.solve(Ls, bs), ht.solve(L2, bs)
    out.update({"solve.bs1.full": x1.to_numpy(), "solve.bs2.full": x2.to_numpy(),
                "solve.bs.entries": len(ht.BackslashCache._cache())})
    ht.clear_plan_cache("backslash")
    out.update({f"launches.{k}": v for k, v in launch_counts().items()})
    out["secs.solves"] = time.perf_counter() - t0

    if be.device.type == "cuda":
        b = ht.DistVector.from_global(bh, be)
        step = cg_step_ms(As["lap"], b)
        ex = plans["random8"].exchange
        x8 = xs["random8"].data
        out.update({"time.cg_step_ms": step["step_ms"],
                    "time.cg_host_enqueue_ms": step["host_enqueue_ms"],
                    "time.exchange_random8_ms": events_ms(
                        lambda: ex.apply(x8)),
                    "time.dot_host_ms": host_ms(lambda: b.dot(b))})
        if be.is_dist:
            one = torch.ones((), dtype=torch.float64, device=be.device)
            buf = torch.ones(be.world << 16, dtype=torch.float64,
                             device=be.device)
            splits = [1 << 16] * be.world
            out.update({
                "time.all_reduce_ms": events_ms(
                    lambda: comm.all_reduce(be, one.clone()), reps=100),
                "time.all_reduce_host_ms": host_ms(
                    lambda: comm.all_reduce(be, one.clone())),
                "time.all_to_all_64k_ms": events_ms(
                    lambda: comm.all_to_all_v(be, buf, splits, splits))})
    return {f"card.{k}": _np(v) for k, v in out.items()}


def checks(be) -> dict:
    """Every body of the CPU tests, in one fixed order."""
    out = {}
    for body in (vectors, exchange, spmv, cg, solves, utilities, guards):
        out.update(body(be))
    return out


BODIES = {"checks": checks, "vectors": vectors, "exchange": exchange,
          "spmv": spmv, "cg": cg, "solves": solves, "utilities": utilities,
          "guards": guards, "card": card}


def on_rank(device: str, body: str, kwargs: dict) -> dict:
    """``parallel.launch.run_ranks`` entry: the body named ``body`` on
    this rank's ``backend_dist`` (f64) with ``kwargs``."""
    import hpclinalg_torch as ht

    be = ht.backend_dist(device="cpu" if device == "cpu" else None)
    return {**BODIES[body](be, **kwargs), **meta(be)}
