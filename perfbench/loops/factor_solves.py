"""The ``factor_solves`` traffic: a closed loop of solve requests through
the program's device multifrontal solver, each optionally preceded by a
refactorization, with one right-hand side or a block of them.

Set-up builds the configuration's pattern on the host (its kind's file
under ``problems/``: ``matrix``, ``fields``, ``values``, ``residual``, and
``rhs`` where the kind has its own right-hand sides), makes the seeded pool
of value fields and the right-hand sides on the device (the kind's ``rhs``
block, else a pool of seeded standard normals), hands the pattern to the
program with the first field's values (``DistSparseMatrix.from_scipy``,
``with_values``, ``ldlt(method="device", spd=<the configuration's solver
is "Cholesky">)``: the plan build, which factors and captures the factor
graph), and warms up (the first solve of a width captures its solve
graph). A request takes the next entries of the pools: if the traffic's
``refactor_each_request``, ``F.refactorize(A.with_values(v))``; then
``F.solve(b)`` for one right-hand side, or ``F.solve_matrix(B)`` for
``rhs_columns`` of them; it ends when the solution is on the device. CUDA
events time the two calls of each request (the host clock on the CPU).
The loop keeps the solutions of a seeded sample of the window's requests
and of its last one; once the window has closed and the program's state
is freed, each is checked against the reference's operator of its
request, rebuilt from that request's seeded fields, and its worst column
is held to the limit.

In a ``--trace 1`` run the program's span recorder is on from the start:
``notes["program_setup"]`` is its report at the end of set-up,
``notes["program_traced"]`` its report over the traced requests alone.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from pbcore import grids, spec
from pbcore.record import (RunRecord, cache_sizes, delta, free_program_state,
                           worse)
from pbcore.trace import Session


def _local_block(B, part, lrow, shards):
    """The program's layout of global blocks B (P, n, m): (P, S, lrow, m)."""
    return grids.local_rows(B.transpose(1, 2), part, lrow, shards) \
        .permute(0, 2, 3, 1).contiguous()


def _ms(a, b) -> float:
    """Milliseconds between two marks: CUDA events, or host clock readings
    on the CPU (where the program's work is synchronous)."""
    if isinstance(a, float):
        return 1e3 * (b - a)
    return a.elapsed_time(b)


def run(env, cell, seed: int, seconds: float, trace: bool, t0: float):
    import hpclinalg_torch as ht
    from hpclinalg_torch.utils import profiling

    cfg, trf = cell.config, cell.traffic
    rec = RunRecord(world=env.world)
    split = rec.setup_split
    split["imports_s"] = time.perf_counter() - t0
    if trace:
        profiling.reset_trace()
        profiling.tracing(True)
    try:
        return _run(env, ht, profiling, cfg, trf, rec, seed, seconds, trace,
                    t0)
    finally:
        profiling.tracing(False)


def _run(env, ht, profiling, cfg, trf, rec, seed, seconds, trace, t0):
    split = rec.setup_split
    dtype = np.dtype(cfg["dtype"])
    tdt = getattr(torch, dtype.name)
    rec.itemsize = dtype.itemsize
    prob = spec.load_module("problems", cfg["kind"])
    Pv, Pb = int(trf["value_pool"]), int(trf["rhs_pool"])
    m = int(trf["rhs_columns"])
    refactor = bool(trf["refactor_each_request"])

    t = time.perf_counter()
    csr = prob.matrix(cfg)
    n = csr.shape[0]
    split["host_build_s"] = time.perf_counter() - t

    t = time.perf_counter()
    gen = torch.Generator(device=env.device).manual_seed(seed)
    fields = prob.fields(cfg, Pv, gen, env.device)
    V = prob.values(fields)
    if hasattr(prob, "rhs"):
        B = prob.rhs(cfg, m, env.device)[None].expand(Pb, n, m)
    else:
        B = torch.randn((Pb, n, m), generator=gen, dtype=torch.float64,
                        device=env.device)
    env.sync()
    split["inputs_s"] = time.perf_counter() - t

    t = time.perf_counter()
    be = env.backend(dtype)
    A = ht.DistSparseMatrix.from_scipy(csr, be, dtype=dtype)
    part = A.row_partition
    lrow = A.structure.Lrow
    Vl = grids.local_values(V, csr.indptr, part, A.structure.NNZpad,
                            be.shards).to(tdt)
    Bl = _local_block(B, part, lrow, be.shards).to(tdt)
    F = ht.ldlt(A.with_values(Vl[0]), method="device",
                spd=cfg["solver"] == "Cholesky")
    if not hasattr(F, "refusal"):
        raise RuntimeError(f"ldlt(method='device') gave {type(F).__name__}, "
                           f"not the device solver")
    env.sync()
    rec.plan_build_s = split["plan_s"] = time.perf_counter() - t
    rec.notes["graphed"] = F.refusal is None

    events = []

    def mark(ev):
        if env.cuda:
            ev.append(torch.cuda.Event(enable_timing=True))
            ev[-1].record()
        else:
            ev.append(time.perf_counter())

    def request(j):
        ev = []
        mark(ev)
        if refactor:
            F.refactorize(A.with_values(Vl[j % Pv]))
        mark(ev)
        bj = Bl[j % Pb]
        if m == 1:
            x = F.solve(ht.DistVector(bj[..., 0], part, be)).data
        else:
            x = F.solve_matrix(ht.DistDenseMatrix(bj, part, m, be)).data
        mark(ev)
        env.sync()
        return x, ev

    t = time.perf_counter()
    for j in range(int(trf["warm_requests"])):
        request(j)
    env.barrier()
    split["warm_s"] = time.perf_counter() - t
    if trace:
        rec.notes["program_setup"] = profiling.trace_report()

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
    j = 0
    while True:
        ts = time.perf_counter()
        last = ts - start >= seconds
        x, ev = request(j)
        te = time.perf_counter()
        lat.append(te - ts)
        events.append(ev)
        if keep_rng.random() < p_keep and len(kept) < max_keep and not last:
            kept.append((j, x))
        j += 1
        if last:
            break
    kept.append((j - 1, x))
    rec.window_s = te - start
    rec.latencies_s = lat
    rec.attempted = j
    rec.rates["factor_solve_ms"] = 1e3 * rec.window_s / j
    rec.notes["plans_built_in_window"] = delta(before, cache_sizes())
    if refactor:
        rec.refactor_ms = [_ms(a, b) for a, b, _c in events]
    rec.solve_ms = [_ms(b, c) for _a, b, c in events]

    if trace:
        ntr = int(trf["trace_requests"])
        profiling.reset_trace()
        t = time.perf_counter()
        with Session(env) as s:
            for i in range(ntr):
                request(j + i)
        rec.notes["traced_segment_s"] = time.perf_counter() - t
        rec.notes["program_traced"] = profiling.trace_report()
        rec.notes["traced_requests"] = ntr
        rec.notes["traced_device_ops"] = len(s.summary.ops)
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
    _check(env, rec, cfg, prob, fields, B, Pv, Pb, part, kept)
    return rec if env.rank == 0 else None


def _check(env, rec, cfg, prob, fields, B, Pv, Pb, part, kept):
    """Each kept solution: its worst column's relative residual against the
    reference's operator of that request's values."""
    lim = cfg["limits"]["rel_residual"]
    n = B.shape[1]
    worst, failed = 0.0, 0
    for j, x in kept:
        rows = torch.cat(env.all_gather(x))
        if env.rank:
            continue
        xg = torch.cat([rows[s, : int(part[s + 1] - part[s])]
                        for s in range(rows.shape[0])])[:n]
        b = B[j % Pb]
        got = prob.residual(fields, j % Pv, xg, b[:, 0] if xg.dim() == 1
                            else b)
        failed += not (got <= lim)
        worst = worse(worst, got)
    if env.rank == 0:
        rec.failed = failed
        rec.checks = {"rel_residual": [worst, lim]}
        rec.notes["checked_requests"] = len(kept)
