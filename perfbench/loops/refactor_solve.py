"""The ``refactor_solve`` traffic: a closed loop of refactorize-and-solve
requests through the program's device Cholesky.

Set-up makes a seeded pool of value fields (edge conductivities) and
right-hand sides on the device, builds the configuration's pattern on the
host (its kind's file under ``problems/``: ``matrix``, ``fields``,
``values``, ``residual``), hands it to
the program with the first field's values (``DistSparseMatrix.from_scipy``,
``with_values``, ``ldlt(method="device", spd=True)``: the plan build, which
captures the factor graph), and warms up (the first solve captures the solve
graph). A request takes the next field and right-hand side of the pools:
``F.refactorize(A.with_values(v))``, then ``F.solve(b)``, ending when the
solution is on the device. CUDA events time the two calls of each request.
Once the window has closed and the program's state is freed, every
request's solution is checked against the reference's operator, rebuilt
from that request's conductivities (``reference/poisson.py``).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from pbcore import grids, spec
from pbcore.record import (RunRecord, cache_sizes, delta, free_program_state,
                           worse)
from pbcore.trace import Session


def run(env, cell, seed: int, seconds: float, trace: bool, t0: float):
    import hpclinalg_torch as ht

    cfg, trf = cell.config, cell.traffic
    rec = RunRecord(world=env.world)
    split = rec.setup_split
    split["imports_s"] = time.perf_counter() - t0
    dtype = np.dtype(cfg["dtype"])
    tdt = torch.float64 if dtype == np.float64 else torch.float32
    rec.itemsize = dtype.itemsize
    prob = spec.load_module("problems", cfg["kind"])
    Pv, Pb = int(trf["value_pool"]), int(trf["rhs_pool"])

    t = time.perf_counter()
    csr = prob.matrix(cfg)
    n = csr.shape[0]
    split["host_build_s"] = time.perf_counter() - t

    t = time.perf_counter()
    gen = torch.Generator(device=env.device).manual_seed(seed)
    fields = prob.fields(cfg, Pv, gen, env.device)
    V = prob.values(fields)
    B = torch.randn((Pb, n), generator=gen, dtype=torch.float64,
                    device=env.device)
    env.sync()
    split["inputs_s"] = time.perf_counter() - t

    t = time.perf_counter()
    be = env.backend(dtype)
    A = ht.DistSparseMatrix.from_scipy(csr, be, dtype=dtype)
    part = A.row_partition
    Vl = grids.local_values(V, csr.indptr, part, A.structure.NNZpad,
                            be.shards).to(tdt)
    Bl = grids.local_rows(B, part, A.structure.Lrow, be.shards).to(tdt)
    F = ht.ldlt(A.with_values(Vl[0]), method="device", spd=True)
    env.sync()
    rec.plan_build_s = split["plan_s"] = time.perf_counter() - t

    events = []

    def request(j):
        Aj = A.with_values(Vl[j % Pv])
        bj = ht.DistVector(Bl[j % Pb], part, be)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)] \
            if env.cuda else None
        if ev:
            ev[0].record()
        F.refactorize(Aj)
        if ev:
            ev[1].record()
        x = F.solve(bj)
        if ev:
            ev[2].record()
        env.sync()
        return x.data, ev

    t = time.perf_counter()
    for j in range(int(trf["warm_requests"])):
        request(j)
    env.barrier()
    split["warm_s"] = time.perf_counter() - t

    before = cache_sizes()
    if env.cuda:
        torch.cuda.reset_peak_memory_stats(env.device)
    lat, sols = [], []
    start = time.perf_counter()
    rec.setup_s = start - t0
    j = 0
    while True:
        ts = time.perf_counter()
        last = ts - start >= seconds
        x, ev = request(j)
        te = time.perf_counter()
        lat.append(te - ts)
        sols.append((j, x))
        events.append(ev)
        j += 1
        if last:
            break
    rec.window_s = te - start
    rec.latencies_s = lat
    rec.attempted = j
    rec.rates["factor_solve_ms"] = 1e3 * rec.window_s / j
    rec.notes["plans_built_in_window"] = delta(before, cache_sizes())
    if env.cuda:
        rec.refactor_ms = [a.elapsed_time(b) for a, b, _c in events]
        rec.solve_ms = [b.elapsed_time(c) for _a, b, c in events]

    if trace:
        ntr = int(trf["trace_requests"])
        with Session(env) as s:
            for i in range(ntr):
                sols.append((j + i, request(j + i)[0]))
        rec.trace = s.summary
        busy = env.floats([s.summary.busy_s])
        rec.busy_s_mean = float(np.mean([v[0] for v in busy]))

    if env.cuda:
        peak = torch.cuda.max_memory_allocated(env.device)
        rec.memory_peak_bytes = int(max(v[0] for v in env.floats([peak])))
    rec.notes["n_perturbed"] = F.n_perturbed
    F.finalize()
    del F, A, V, Vl, Bl, x
    free_program_state(env)
    _check(env, rec, cfg, prob, fields, B, Pv, Pb, part, sols)
    return rec if env.rank == 0 else None


def _check(env, rec, cfg, prob, fields, B, Pv, Pb, part, sols):
    """Every request's solution: its relative residual against the
    reference's operator of that request's values, in f64."""
    lim = cfg["limits"]["rel_residual"]
    n = B.shape[1]
    worst, failed = 0.0, 0
    for j, x in sols:
        rows = torch.cat(env.all_gather(x.to(torch.float64)))
        if env.rank:
            continue
        xg = torch.cat([rows[s, : int(part[s + 1] - part[s])]
                        for s in range(rows.shape[0])])[:n]
        got = prob.residual(fields, j % Pv, xg, B[j % Pb])
        failed += not (got <= lim)
        worst = worse(worst, got)
    if env.rank == 0:
        rec.failed = failed
        rec.checks = {"rel_residual": [worst, lim]}
        rec.notes["checked_requests"] = len(sols)
