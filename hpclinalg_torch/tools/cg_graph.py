"""The CG step of ``hpclinalg_torch.entry`` on the card: captured as a CUDA
graph and replayed (the counterpart of the JAX entry point's ``jax.jit``),
held against the eager raw step, the public-API step and a host replay,
and timed beside both.

    python -m hpclinalg_torch.tools.cg_graph

Cases, f64 unless said, b seeded standard normals (``entry``: ones):

    lap      laplace2d(1000), n = 10^6, S = 1: K1 on the identity exchange
    lap_s4   the same on S = 4 stacked shards: K2's gather mode, then K1
    N        chip_smoke.py's ridge normal matrix N = AᵀA + 10⁻²I (16,384
             rows, 2,754,950 nnz), S = 1: K3
    random8  the random 10^6 x 8 matrix, S = 1: K2 (W = 8, no COO tail)
    entry    ``entry()`` itself: laplace2d(64), f32, S = 1: K1

For each case, through ``dist_checks.raw_steps``: the kernels' launch
counters are set to 0 just before 20 eager raw steps and read just after
the capture and 20 replays (the eager steps, the capture's warm-up and its
one captured call launch through the wrappers; a replay runs no Python and
counts nothing); 20 replays from (0, b, b) must equal the 20 eager raw
steps bit for bit (the same kernels in the same order) and 20 steps of the
public-API ``tools/ell_ab.cg`` to rtol 1e-10 (f32: 1e-5), relative to the
largest entry, where the matrix is symmetric positive definite; the
three vector kernels must launch once each a step. On ``random8``, which
is not, CG diverges and p·Ap cancels to rounding noise within a few steps
(its cancellation κ = Σ|p_i (Ap)_i| / |p·Ap| reaches 1/ε), so two
summation orders of the dots part there. From each of its 20 states
instead: the kernels run once on the state must equal the step bit for
bit, their updates the plain arithmetic given their own reduced dots, and
their dots a double reference within DOT_RTOL of the terms' magnitudes
(``against_plain``); and while DOT_ULPS ε κ stays at most API_CAP, the
step must be within that rtol plus DOT_ULPS ε κ of one public-API step
from the same state, for API_STEPS steps at least. ``lap`` must be within
1e-10 of the same steps in float64 on the host (numpy/scipy), ``entry``
within 1e-4 of them in float64 and in float32. Then the wall time a step
(the median of 5 runs of 50 chained steps, CUDA events) and the host
time a step of the replay, the eager raw step and the public-API step,
taken in turns (``timing.chain_ms``); then, in one torch.profiler
session for every case (the profiler is reliable only in a process's
first sessions), one call of each: its device time (the union of its
kernels' and copies' intervals), its kernels and copies and their device
time by name. Last, a step that reads a value on the host must fail to
capture. Prints one JSON line a case and, last, the record of all beside
the card's name and power limit; raises on a failed check. Runs on a
CUDA device only.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from .dist_checks import raw_steps, ridge_matrices
from .ell_ab import busy_us, cg, cg_step, device_events
from .matrices import laplace2d, random_8
from .timing import card, chain_ms, require_cuda

SEED = 0                        # chip_smoke.py's seed for its matrices
B_SEED = SEED + 15              # b's seed (chip_smoke.py's case (i) ranks too)
LAP_K = 1000                    # laplace2d(LAP_K)
RIDGE = (1_000_000, 16_384, 1e-2)   # the ridge design's m, n and lambda
RANDOM_N = 1_000_000
STEPS = 20
RTOL = {torch.float64: 1e-10, torch.float32: 1e-5}
HOST_RTOL = {torch.float64: 1e-10, torch.float32: 1e-4}
# name -> (S, dtype, its engine, the kernels the graph must launch, whether
# the matrix is symmetric positive definite)
CASES = {"lap": (1, np.float64, "dia", ("dia",), True),
         "lap_s4": (4, np.float64, "dia", ("dia", "gather"), True),
         "N": (1, np.float64, "resident", ("resident",), True),
         "random8": (1, np.float64, "ell", ("ell",), False),
         "entry": (1, np.float32, "dia", ("dia",), True)}
# the step's vector kernels (ops/cuda_cg.py), each launched once a step
CG_KERNELS = ("cg_dots", "cg_update_xr", "cg_update_p")
# a kernel's dot against a double reference on the same inputs, over the sum
# of the terms' magnitudes (a tree over 10^6 terms errs by about 25 ε of it)
DOT_RTOL = 1e-12
# two summation orders of one dot differ by at most DOT_ULPS ε times the sum
# of its terms' magnitudes: a tree of depth d errs by at most d ε of it, the
# kernels' tree over 10^6 terms is 25 deep (ops/cuda_cg.py grid_blocks), and
# cuBLAS's, whose order is not documented, is allowed as much again and more
DOT_ULPS = 64
# random8's step is held against the public-API step only while DOT_ULPS ε κ,
# what the two orders' rounding can move α by, is at most API_CAP, and on at
# least API_STEPS steps
API_CAP = 1e-6
API_STEPS = 2
GAP_S = 0.05        # host pause between the profiled calls: splits the trace


def host_cg(M, b, steps, dtype):
    """``steps`` CG steps from x = 0 in numpy/scipy in ``dtype``: (x, r, p)."""
    M = M.astype(dtype)
    b = b.astype(dtype)
    x, r, p = np.zeros_like(b), b, b
    for _ in range(steps):
        Ap = M @ p
        rr = r @ r
        alpha = rr / (p @ Ap)
        x = x + alpha * p
        r2 = r - alpha * Ap
        p = r2 + (r2 @ r2) / rr * p
        r = r2
    return x, r, p


def rel_err(got, want) -> float:
    """max |got - want| / max |want|."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-300))


def check(cond, what):
    check_quiet(cond, what)
    print(f"  ok: {what}", flush=True)


def check_quiet(cond, what):
    if not cond:
        raise RuntimeError(f"cg_graph check failed: {what}")


def build(name, dev, mats):
    """(A, b, step, x0, host matrix) of case ``name``."""
    import hpclinalg_torch as ht
    from ..entry import cg_step_fn, entry

    S, dt = CASES[name][:2]
    be = ht.backend_auto(S, dtype=dt, device=dev)
    if name == "entry":
        step, args = entry(device=dev)
        M = laplace2d(64)
        A = ht.DistSparseMatrix.from_scipy(M, be, dtype=dt)
        b = ht.DistVector.from_global(np.ones(M.shape[0]), be, dtype=dt)
        check(all(torch.equal(a, c) for a, c in zip(args, (
            torch.zeros_like(b.data), b.data, b.data))),
              "entry()'s arguments are (0, b, b) with b all ones, "
              f"{tuple(args[0].shape)} {args[0].dtype}")
        return A, b, step, ht.DistVector(args[0], b.partition, be), M
    M = mats[name]
    A = ht.DistSparseMatrix.from_scipy(M, be)
    b = ht.DistVector.from_global(np.random.default_rng(B_SEED)
                                  .standard_normal(M.shape[0]), be)
    step, x0 = cg_step_fn(A, be)
    return A, b, step, x0, M


def against_plain(x, r, p, Ap) -> tuple[tuple, dict]:
    """The three kernels once on (x, r, p, Ap) with a workspace of their
    own, held against the plain arithmetic on the same inputs: x + αp,
    r − αAp and r' + βp bit for bit with α and β divided from the kernels'
    own reduced dots as the plain step divides them, and each dot within
    DOT_RTOL Σ|terms| (plus its rounding to the vectors' type) of a double
    ``torch.dot``. Returns ((x', r', p'), {"dot_err": the largest dot's
    error over Σ|terms|, "dot_abs_errs" and "dots": each of p·Ap, r·r and
    r'·r'}); raises on a failed check."""
    from ..ops import cuda_cg

    ws = cuda_cg.Workspace(x.numel(), x.dtype, x.device)
    d = cuda_cg.cg_dots(p, Ap, r, ws).clone()
    xo, ro = cuda_cg.cg_update_xr(x, r, p, Ap, ws)
    rr = ws.rr.clone()
    po = cuda_cg.cg_update_p(ro, p, ws)
    alpha, beta = d[1] / d[0], rr[0] / d[1]
    check_quiet(torch.equal(xo, x + alpha * p)
                and torch.equal(ro, r - alpha * Ap)
                and torch.equal(po, ro + beta * p),
                "the kernels' updates equal x + αp, r − αAp and r' + βp "
                "bit for bit, α and β from their own dots")
    eps = torch.finfo(x.dtype).eps
    err, abs_errs = 0.0, []
    for got, a, b in ((d[0], p, Ap), (d[1], r, r), (rr[0], ro, ro)):
        a, b = a.reshape(-1).double(), b.reshape(-1).double()
        want = float(torch.dot(a, b))
        mag = max(float(torch.dot(a.abs(), b.abs())), 1e-300)
        e = abs(float(got) - want)
        check_quiet(e <= DOT_RTOL * mag + eps * abs(want),
                    f"a kernel's dot {float(got):.17g} is within {DOT_RTOL:g}"
                    f" of Σ|terms| {mag:.6g} of the double reference "
                    f"{want:.17g}")
        err = max(err, e / mag)
        abs_errs.append(e)
    return (xo, ro, po), {"dot_err": err, "dot_abs_errs": abs_errs,
                          "dots": [float(d[0]), float(d[1]), float(rr[0])]}


def stepwise(A, b, step, args, steps, rtol) -> dict:
    """``steps`` raw steps chained from ``args``, each checked from its
    state: the kernels once on it (``against_plain``, with the step's own
    product ``step.spmv``) must equal the step bit for bit; while DOT_ULPS
    ε κ, with κ = Σ|p_i (Ap)_i| / |p·Ap| of the state, is at most API_CAP,
    the step must be within rtol + DOT_ULPS ε κ of one public-API step from
    the state, on API_STEPS steps at least. Returns {"api_steps",
    "api_rel_err" (the largest of those), "dot_err", "cancellation" (κ a
    step)}; raises on a failed check."""
    import hpclinalg_torch as ht

    eps = torch.finfo(args[0].dtype).eps
    rec = {"api_steps": 0, "api_rel_err": 0.0, "dot_err": 0.0,
           "cancellation": []}
    comparing = True
    for k in range(steps):
        nxt = step(*args)
        Ap = step.spmv(args[2])
        mine, res = against_plain(*args, Ap)
        check_quiet(all(torch.equal(a, c) for a, c in zip(mine, nxt)),
                    f"step {k + 1}: the kernels once on its state equal "
                    "the step bit for bit")
        rec["dot_err"] = max(rec["dot_err"], res["dot_err"])
        terms = args[2].reshape(-1) * Ap.reshape(-1)
        kappa = float(terms.abs().sum() / terms.sum().abs())
        rec["cancellation"].append(kappa)
        comparing = comparing and DOT_ULPS * eps * kappa <= API_CAP
        if comparing:
            x, r, p = (ht.DistVector(t.clone(), b.partition, b.backend)
                       for t in args)
            err = max(rel_err(g.cpu(), w.data.cpu())
                      for g, w in zip(nxt, cg_step(A, x, r, p)))
            tol = rtol + DOT_ULPS * eps * kappa
            check_quiet(err <= tol, f"step {k + 1}: within {tol:.3e} "
                        f"(rtol {rtol:g} + {DOT_ULPS} ε × κ {kappa:.3e}) of "
                        f"the public-API step ({err:.3e})")
            rec["api_steps"] += 1
            rec["api_rel_err"] = max(rec["api_rel_err"], err)
        args = nxt
    check_quiet(rec["api_steps"] >= API_STEPS,
                f"{rec['api_steps']} steps held against the public-API step "
                f"before {DOT_ULPS} ε κ passed {API_CAP:g}, {API_STEPS} at "
                f"least (κ a step: {rec['cancellation']})")
    return rec


def run_case(name, dev, mats) -> tuple[dict, dict]:
    """The checks of case ``name``; returns its record and its steps to
    time: {variant: (step, args)}."""
    import hpclinalg_torch as ht

    S, dt, engine, kernels, spd = CASES[name]
    tdt = torch.float64 if dt == np.float64 else torch.float32
    A, b, step, x0, M = build(name, dev, mats)
    check(step.engine == engine, f"{name}: the step takes the {engine} "
          f"engine ({step.engine})")
    args = (x0.data, b.data, b.data)
    rec = {"case": name, "S": S, "dtype": np.dtype(dt).name, "n": A.m,
           "nnz": int(A.nnz()), "engine": step.engine}
    res = raw_steps(step, args, STEPS, graphed=True)
    out = res["out"]
    rec["capture_s"], rec["launches"] = res["capture_s"], res["launches"]
    check(all(rec["launches"][k] >= 1 for k in kernels),
          f"{name}: the steps and the capture launched {kernels}: "
          f"{rec['launches']}")
    check(step.fused and len({rec["launches"][k] for k in CG_KERNELS}) == 1
          and rec["launches"]["cg_dots"] >= STEPS,
          f"{name}: each step launched each of {CG_KERNELS} once: "
          f"{rec['launches']}")
    print(f"  ok: {name}: {STEPS} replays equal {STEPS} eager raw steps bit "
          "for bit", flush=True)
    if spd:
        xa, ra = cg(A, b, STEPS)
        rec["api_rel_err"] = max(rel_err(out[0].cpu(), xa.data.cpu()),
                                 rel_err(out[1].cpu(), ra.data.cpu()))
        check(rec["api_rel_err"] <= RTOL[tdt],
              f"{name}: within {RTOL[tdt]:g} of the public-API CG "
              f"({rec['api_rel_err']:.3e})")
    else:
        rec["stepwise"] = sw = stepwise(A, b, step, args, STEPS, RTOL[tdt])
        print(f"  ok: {name}: from each of {STEPS} states the kernels equal "
              "the step and the plain arithmetic bit for bit (dots within "
              f"{sw['dot_err']:.3e} of Σ|terms|); the first "
              f"{sw['api_steps']} steps within {RTOL[tdt]:g} + {DOT_ULPS} ε "
              f"κ of the public-API step (largest {sw['api_rel_err']:.3e}; "
              f"κ {', '.join(f'{c:.3g}' for c in sw['cancellation'])})",
              flush=True)
    if name in ("lap", "entry"):
        got = [ht.DistVector(t, x0.partition, x0.backend).to_numpy()
               for t in out]
        for hdt in ((np.float64, np.float32) if name == "entry"
                    else (np.float64,)):
            want = host_cg(M, b.to_numpy().astype(np.float64), STEPS, hdt)
            err = max(rel_err(g, w) for g, w in zip(got, want))
            rec[f"host_{np.dtype(hdt).name}_rel_err"] = err
            check(err <= HOST_RTOL[tdt], f"{name}: within "
                  f"{HOST_RTOL[tdt]:g} of the host replay in "
                  f"{np.dtype(hdt).name} ({err:.3e})")
    check(all(bool(torch.isfinite(t).all()) for t in out),
          f"{name}: the iterates are finite")
    vecs = (x0, b, b)
    return rec, {"graphed": (res["graph"], tuple(a.clone() for a in args)),
                 "eager": (step, args),
                 "api": (lambda x, r, p: cg_step(A, x, r, p), vecs)}


def profile(calls: dict) -> dict:
    """One call of each ``label: (step, args)`` in one torch.profiler
    session, GAP_S apart on the host: {label: {"device_us", "events",
    "by_name": {name: [count, µs]}}}, or {} when the trace holds no device
    activity or cannot be split into the calls."""
    def body():
        for step, args in calls.values():
            torch.cuda.synchronize()
            time.sleep(GAP_S)
            step(*args)
            torch.cuda.synchronize()
    evs = sorted(device_events(body), key=lambda e: e.time_range.start)
    groups, last = [], None
    for e in evs:
        if last is None or e.time_range.start - last > GAP_S * 1e6 / 2:
            groups.append([])
        groups[-1].append(e)
        last = e.time_range.end if last is None \
            else max(last, e.time_range.end)
    if len(groups) != len(calls):
        print(f"  the trace holds {len(evs)} device events in "
              f"{len(groups)} groups for {len(calls)} calls: device times "
              "not measured", flush=True)
        return {}
    out = {}
    for label, grp in zip(calls, groups):
        by = {}
        for e in grp:
            c = by.setdefault(e.name.split("(")[0][:80], [0, 0.0])
            c[0] += 1
            c[1] += e.time_range.end - e.time_range.start
        out[label] = {"device_us": busy_us(grp), "events": len(grp),
                      "by_name": by}
    return out


def failed_capture_raises(dev) -> str:
    """A step that reads a value on the host cannot be captured:
    ``capture`` must raise RuntimeError. Returns its message."""
    from ..entry import capture

    def reads_host(v, out):
        return (torch.mul(v, float(v.sum()), out=out[0]),)

    try:
        capture(reads_host, (torch.ones(8, device=dev),))
    except RuntimeError as e:
        return str(e)
    raise RuntimeError("cg_graph check failed: capture took a step that "
                       "reads a value on the host")


def main(argv=None) -> dict:
    argparse.ArgumentParser(description=__doc__.split("\n\n")[0]) \
        .parse_args(argv)
    names = list(CASES)
    dev = require_cuda()
    name = card()
    print(f"cg_graph on {name}: cases {names}", flush=True)
    t0 = time.perf_counter()
    mats = {"N": ridge_matrices(RIDGE, SEED)["N"],
            "random8": random_8(RANDOM_N, SEED + 1)}
    mats["lap"] = mats["lap_s4"] = laplace2d(LAP_K)
    record = {"card": name, "inputs_s": time.perf_counter() - t0,
              "cases": {}}
    calls = {}
    for c in names:
        t0 = time.perf_counter()
        rec, steps = run_case(c, dev, mats)
        for v, t in chain_ms(steps).items():
            rec[v] = t
        rec["seconds"] = time.perf_counter() - t0
        record["cases"][c] = rec
        # the replay profiled alone, on its own static tensors: no copy in
        steps["graphed"] = (steps["graphed"][0], steps["graphed"][0].static)
        calls.update({(c, v): s for v, s in steps.items()})
    prof = profile(calls)
    for (c, v), p in prof.items():
        record["cases"][c][v].update(p)
    for c in names:
        rec = record["cases"][c]
        line = "  ".join(
            f"{v} {rec[v]['step_ms']:.4f} ms a step, host "
            f"{rec[v]['host_ms']:.4f} ms, device "
            + (f"{rec[v]['device_us']:.2f} us in {rec[v]['events']} "
               "kernels/copies" if "device_us" in rec[v] else "not measured")
            for v in ("graphed", "eager", "api"))
        print(f"  {c} ({rec['engine']}, S={rec['S']}, {rec['dtype']}): "
              f"{line}  [{name}]", flush=True)
        print(json.dumps({"cg_graph": c, **rec}), flush=True)
    record["failed_capture"] = failed_capture_raises(dev)
    print(f"  ok: a step that reads a value on the host fails to capture: "
          f"{record['failed_capture'][:160]}", flush=True)
    record["launches"] = {c: record["cases"][c]["launches"] for c in names}
    print(json.dumps(record), flush=True)
    return record


if __name__ == "__main__":
    main()
