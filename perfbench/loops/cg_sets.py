"""The ``cg_sets`` traffic: a closed loop of conjugate-gradient sets through
the program's compiled step.

Set-up builds the configuration's matrix on the host (its kind's file under
``problems/``: ``matrix(cfg)``, and ``operator(cfg)``, the reference's
A @ x), hands it to the program (``DistSparseMatrix.from_scipy``,
``entry.cg_step_fn``: the plan build), makes a seeded pool of right-hand
sides b = A x* on the device with the reference's operator, and captures
the step (``entry.capture``; on the CPU the step runs eagerly, as the
program documents). A request starts from x = 0 with the next b of the
pool, replays the step ``iterations_per_set`` times and ends in the host
read of ||r||^2 (summed over the ranks, with rank 0's stop flag beside it).
The window runs requests until ``--seconds`` have passed at the start of
one, which is the last. Each run checks a seeded sample of the window's
sets and its last set against the reference's CG from the same b
(``reference/hpcg.py``), once the window has closed and the program's state
is freed.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from pbcore import grids, spec
from pbcore.record import (RunRecord, cache_sizes, delta, free_program_state,
                           worse)
from pbcore.trace import Session
from reference import hpcg as ref


def run(env, cell, seed: int, seconds: float, trace: bool, t0: float):
    import hpclinalg_torch as ht
    from hpclinalg_torch import entry

    cfg, trf = cell.config, cell.traffic
    rec = RunRecord(world=env.world)
    split = rec.setup_split
    split["imports_s"] = time.perf_counter() - t0
    prob = spec.load_module("problems", cfg["kind"])
    op = prob.operator(cfg)
    dtype = np.dtype(cfg["dtype"])
    tdt = torch.float64 if dtype == np.float64 else torch.float32
    rec.itemsize = dtype.itemsize
    iters, P = int(trf["iterations_per_set"]), int(trf["rhs_pool"])

    t = time.perf_counter()
    csr = prob.matrix(cfg)
    n = csr.shape[0]
    split["host_build_s"] = time.perf_counter() - t

    t = time.perf_counter()
    be = env.backend(dtype)
    A = ht.DistSparseMatrix.from_scipy(csr, be, dtype=dtype)
    step, x0 = entry.cg_step_fn(A, be)
    rec.plan_build_s = split["plan_s"] = time.perf_counter() - t
    rec.notes["engine"] = step.engine

    t = time.perf_counter()
    gen = torch.Generator(device=env.device).manual_seed(seed)
    xstar = torch.randn((P, n), generator=gen, dtype=torch.float64,
                        device=env.device)
    b = op(xstar)
    del xstar
    part, lrow = A.row_partition, int(x0.data.shape[1])
    bl = grids.local_rows(b, part, lrow, be.shards).to(tdt)
    zero = torch.zeros_like(x0.data)
    env.sync()
    split["inputs_s"] = time.perf_counter() - t

    t = time.perf_counter()
    g = entry.capture(step, (zero, bl[0], bl[0])) if env.cuda else step
    env.sync()
    split["capture_s"] = time.perf_counter() - t

    def one_set(k, flag):
        bk = bl[k % P]
        x, r, p = g(zero, bk, bk)
        for _ in range(iters - 1):
            x, r, p = g(x, r, p)
        rr = torch.vdot(r.reshape(-1), r.reshape(-1)).to(torch.float64)
        if env.is_dist:
            import torch.distributed as dist

            buf = torch.stack([rr, rr.new_tensor(float(flag))])
            dist.all_reduce(buf)
            rrv, f = buf.tolist()
        else:
            rrv, f = rr.item(), flag
        return x, r, rrv, f > 0

    t = time.perf_counter()
    for k in range(int(trf["warm_sets"])):
        one_set(k, 0)
    env.barrier()
    split["warm_s"] = time.perf_counter() - t

    # the sample: decided from the seed alone, so every rank keeps the same
    keep_rng = np.random.default_rng(seed)
    p_keep = 1.0 / float(trf["sample_every"])
    max_keep = int(trf["max_samples"])
    kept = []
    before = cache_sizes()
    if env.cuda:
        torch.cuda.reset_peak_memory_stats(env.device)
    lat = []
    start = time.perf_counter()
    rec.setup_s = start - t0
    k = 0
    while True:
        ts = time.perf_counter()
        x, r, rrv, last = one_set(k, env.rank == 0 and ts - start >= seconds)
        te = time.perf_counter()
        lat.append(te - ts)
        if keep_rng.random() < p_keep and len(kept) < max_keep and not last:
            kept.append((k, x.clone(), r.clone(), rrv))
        k += 1
        if last:
            break
    rec.window_s = te - start
    kept.append((k - 1, x.clone(), r.clone(), rrv))
    rec.latencies_s = lat
    rec.attempted = k
    rec.iterations = k * iters
    rec.rates["cg_iter_ms"] = 1e3 * rec.window_s / rec.iterations
    rec.notes["plans_built_in_window"] = delta(before, cache_sizes())

    if trace:
        ntr = int(trf["trace_sets"])
        with Session(env) as s:
            for j in range(ntr):
                one_set(k + j, 0)
        rec.trace = s.summary
        rec.traced_iterations = ntr * iters
        busy = env.floats([s.summary.busy_s])
        rec.busy_s_mean = float(np.mean([v[0] for v in busy]))
        st = A.structure
        r0, r1 = int(part[be.shards[0]]), int(part[be.shards[0] + 1])
        rec.rows_local = r1 - r0
        rec.nnz_local = int(st.nnz_local[be.shards[0]])
        seen = np.zeros(n, dtype=bool)
        seen[csr.indices[csr.indptr[r0]:csr.indptr[r1]]] = True
        rec.xcols_local = int(seen.sum())

    if env.cuda:
        peak = torch.cuda.max_memory_allocated(env.device)
        rec.memory_peak_bytes = int(max(v[0] for v in env.floats([peak])))
    # the program's state goes before the reference runs
    del g, step, A, x0, x, r, bl, zero
    free_program_state(env)
    _check(env, rec, cfg, op, b, iters, P, part, kept)
    return rec if env.rank == 0 else None


def _to_global(env, t, part, n):
    """Rank 0's view of a vector held as each rank's (nlocal, Lrow) rows:
    the global (n,) f64 vector (None on other ranks)."""
    rows = torch.cat(env.all_gather(t.to(torch.float64)))
    if env.rank:
        return None
    return torch.cat([rows[s, : int(part[s + 1] - part[s])]
                      for s in range(rows.shape[0])])[:n]


def _check(env, rec, cfg, op, b, iters, P, part, kept):
    """Every kept set against the reference's CG from its b, in f64: the
    iterate's and the residual's relative errors and the host read's."""
    lim = cfg["limits"]
    n = b.shape[1]
    worst = {"x_rel_err": 0.0, "r_rel_err": 0.0, "rr_rel_err": 0.0}
    refs = {}
    failed = 0
    for k, x, r, rrv in kept:
        xg = _to_global(env, x, part, n)
        rg = _to_global(env, r, part, n)
        if env.rank:
            continue
        i = k % P
        if i not in refs:
            refs[i] = ref.cg(op, b[i], iters)
        xr, rr_ = refs[i]
        nrm = torch.linalg.vector_norm
        got = {"x_rel_err": float(nrm(xg - xr) / nrm(xr)),
               "r_rel_err": float(nrm(rg - rr_) / nrm(rr_)),
               "rr_rel_err": abs(rrv - float(torch.dot(rr_, rr_)))
               / float(torch.dot(rr_, rr_))}
        if any(not (got[m] <= lim[m]) for m in got):
            failed += 1
        worst = {m: worse(worst[m], got[m]) for m in got}
    if env.rank == 0:
        rec.failed = failed
        rec.checks = {m: [worst[m], lim[m]] for m in worst}
        rec.notes["checked_sets"] = len(kept)
