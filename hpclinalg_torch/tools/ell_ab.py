"""Device time of the ELL kernels by name, on chip_smoke.py's cases, for one
checkout of this repository: run it on two checkouts in turns, in one call,
to compare them on one card.

    PYTHONPATH=<checkout> python <repo>/hpclinalg_torch/tools/ell_ab.py \
        [label] [--cases random8,power_law,N,A,at_cap,gather,gather_f32,cg_N]

Run as a file, it measures the package on PYTHONPATH (which may be another
commit unpacked elsewhere) through that package's public API alone, and
takes only the matrix builders and the timer from the files beside it.
Cases, f64, S = 1: ``A @ x`` on the random 10^6 x 8 and power-law
matrices (K2: its row and tail kernels), K2's gather mode at 8*10^6 random
slots (3 % dead; also in f32), and ``A @ x`` on the ridge normal matrix N,
the ridge design A and the matrix at the shared-memory cap (K3, whichever
engine the checkout's plan takes). Each case runs 20 times with L2 flushed
before each run, under torch.profiler; prints each kernel's median device
time in µs with the card's name and power limit. ``cg_N`` times the CG
step on N through the public API instead (``cg``): the median over 5 runs
of 50 steps of the wall time a step by CUDA events, and of its host
enqueue time; and the host time of one ``N @ p`` call (the median over 5
runs of the mean of 200 calls queued without a wait). All cases by
default; then one JSON line. Runs on a CUDA device only."""

from __future__ import annotations

import json
import sys
import time

import numpy as np
import scipy.sparse as sp
import torch

if __package__:
    from .matrices import banded_design, power_law, random_8, random_cols
    from .timing import Timer, card, require_cuda
else:       # run as a file: the package measured is PYTHONPATH's
    from matrices import banded_design, power_law, random_8, random_cols
    from timing import Timer, card, require_cuda

REPS = 20
SEED = 0            # the seeds of chip_smoke.py's matrices
N_ROWS = 1_000_000
SLOTS = 8_000_000
RIDGE = (1_000_000, 16_384, 1e-2)
CAP_SLOTS = 29_056  # f64 slots in the H100's 232,448 bytes a block
CASES = ("random8", "power_law", "N", "A", "at_cap", "gather", "gather_f32",
         "cg_N")
CG_STEPS, CG_RUNS, MATVECS = 50, 5, 200


def cg(A, b, steps):
    """``steps`` CG iterations from x = 0 with the port's public API;
    returns (x, r)."""
    x = type(b).zeros(b.n, b.backend)
    r, p = b, b
    for _ in range(steps):
        Ap = A @ p
        rr = r.dot(r)
        alpha = rr / p.dot(Ap)
        x = x + alpha * p
        r2 = r - alpha * Ap
        p = r2 + (r2.dot(r2) / rr) * p
        r = r2
    return x, r


def cg_step_ms(A, b) -> dict:
    """Median over CG_RUNS runs of CG_STEPS steps: the wall time a step by
    CUDA events and the host's enqueue time a step, in ms."""
    cg(A, b, 3)
    wall, host = [], []
    for _ in range(CG_RUNS):
        ev0 = torch.cuda.Event(enable_timing=True)
        ev1 = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ev0.record()
        cg(A, b, CG_STEPS)
        host.append((time.perf_counter() - t0) * 1e3 / CG_STEPS)
        ev1.record()
        torch.cuda.synchronize()
        wall.append(ev0.elapsed_time(ev1) / CG_STEPS)
    mv = []
    for _ in range(CG_RUNS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(MATVECS):
            A @ b
        mv.append((time.perf_counter() - t0) * 1e6 / MATVECS)
        torch.cuda.synchronize()
    return {"step_ms": float(np.median(wall)),
            "host_enqueue_ms": float(np.median(host)),
            "matvec_host_us": float(np.median(mv))}


def device_events(body):
    """The kernels and copies ``body`` runs on the card, from a
    torch.profiler trace."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        body()
        torch.cuda.synchronize()
    return [e for e in prof.events() if e.device_type == DeviceType.CUDA]


def kernel_times(fn, flush, skip) -> dict:
    """{kernel name: median device µs over REPS runs of fn}, each run after
    an L2 flush; the kernels named in ``skip`` (the flush's) are left out."""
    for _ in range(3):
        fn()

    def runs():
        for _ in range(REPS):
            flush()
            fn()
    got = {}
    for e in device_events(runs):
        if e.name not in skip:
            got.setdefault(e.name, []).append(e.time_range.end
                                              - e.time_range.start)
    return {name.split("(")[0]: float(np.median(v))
            for name, v in got.items() if len(v) >= REPS}


def main(argv=None) -> dict:
    argv = list(sys.argv[1:] if argv is None else argv)
    cases = CASES
    if "--cases" in argv:
        i = argv.index("--cases")
        cases = tuple(argv[i + 1].split(","))
        del argv[i:i + 2]
        if set(cases) - set(CASES):
            raise SystemExit(f"ell_ab: cases are {','.join(CASES)}")
    label = argv[0] if argv else "checkout"
    import hpclinalg_torch as ht
    from hpclinalg_torch.ops import cuda_ell

    dev = require_cuda()
    name = card()
    flush = Timer(dev).flush.sum
    be = ht.backend_auto(1, dtype=np.float64, device=dev)
    rng = np.random.default_rng(SEED + 20)
    m, n, lam = RIDGE
    Ab, _ = banded_design(m, n, SEED + 8)
    Nm = (Ab.T @ Ab + lam * sp.eye(n)).tocsr() \
        if {"N", "cg_N"} & set(cases) else None
    mats = {"random8": lambda: random_8(N_ROWS, SEED + 1),
            "power_law": lambda: power_law(N_ROWS, SEED + 2),
            "N": lambda: Nm, "A": lambda: Ab,
            "at_cap": lambda: random_cols(300_000, CAP_SLOTS - 8, 4,
                                          SEED + 6)}
    skip = {e.name for e in device_events(lambda: [flush()
                                                   for _ in range(REPS)])}
    out = {}
    for case in cases:
        if case in mats:
            M = mats[case]()
            Md = ht.DistSparseMatrix.from_scipy(M, be)
            x = ht.DistVector.from_global(rng.standard_normal(M.shape[1]), be)
            out[case] = kernel_times(lambda: Md @ x, flush, skip)
        elif case in ("gather", "gather_f32"):
            dt = torch.float32 if case == "gather_f32" else torch.float64
            xg = torch.from_numpy(rng.standard_normal(N_ROWS)).to(dev, dt)[None]
            src = rng.integers(0, N_ROWS, SLOTS).astype(np.int32)
            src[rng.random(SLOTS) < 0.03] = -1
            src = torch.from_numpy(src).to(dev)[None]
            out[case] = kernel_times(lambda: cuda_ell.gather(xg, src), flush,
                                     skip)
        else:
            Md = ht.DistSparseMatrix.from_scipy(Nm, be)
            b = ht.DistVector.from_global(rng.standard_normal(n), be)
            got = cg_step_ms(Md, b)
            print(f"{label} cg_N f64: step {got['step_ms']:.4f} ms, host "
                  f"enqueue {got['host_enqueue_ms']:.4f} ms, N @ p on the "
                  f"host {got['matvec_host_us']:.1f} us  [{name}]", flush=True)
            out[case] = got
    for case, ks in out.items():
        if case == "cg_N":
            continue
        for k, us in sorted(ks.items(), key=lambda kv: -kv[1]):
            print(f"{label} {case}: {us:8.1f} us  {k[:60]}  [{name}]",
                  flush=True)
    print(json.dumps({"label": label, "card": name, "us": out}), flush=True)
    return out


if __name__ == "__main__":
    main()
