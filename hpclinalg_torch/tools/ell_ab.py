"""Device time of the ELL kernels by name, on chip_smoke.py's cases, for one
checkout of this repository: run it on two checkouts in turns, in one call,
to compare them on one card.

    PYTHONPATH=<checkout> python <repo>/hpclinalg_torch/tools/ell_ab.py \
        [label] [--cases random8,power_law,N,A,at_cap,gather,gather_f32,cg_N,
                         stream,kpayload,dia,dia_f32,dia_wide,dia_wide_f32]

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
runs of the mean of 200 calls queued without a wait). ``stream`` times
the probe kernel K4 ``table_stream`` at dia_variants.py's shapes (f32,
laplace2d(k)'s O = 5 rows of 131072-row tiles, k = 1000 and 2000): skern
(R = 1), v3 (R = O) and v5_d2/_d3, an odd row stride (the scalar
kernel), and the library calls of the same functions (``torch.add``,
``torch.baddbmm``); ``kpayload`` times K5 at probe_kpayload.py's shape
(k = 64, F = 8, 4096 tiles), its granule control (every lane on the even
sector of its pair), floor (i) ``torch.sum(src, dim=1)`` and its library
call (one indexing call). ``dia`` and ``dia_wide`` time ``A @ x`` on
laplace2d(1000) and on chip_smoke.py's wide-span matrix (offsets
+-3*10^5), K1 by its kernels' names, in f64 (``_f32``: in f32). All cases
by default; then one JSON line. Runs on a CUDA device only."""

from __future__ import annotations

import json
import sys
import time

import numpy as np
import scipy.sparse as sp
import torch

if __package__:
    from .matrices import (banded_design, laplace2d, power_law, random_8,
                           random_cols, wide_span)
    from .timing import Timer, card, chain_ms, require_cuda
else:       # run as a file: the package measured is PYTHONPATH's
    from matrices import (banded_design, laplace2d, power_law, random_8,
                          random_cols, wide_span)
    from timing import Timer, card, chain_ms, require_cuda

REPS = 20
SEED = 0            # the seeds of chip_smoke.py's matrices
N_ROWS = 1_000_000
SLOTS = 8_000_000
RIDGE = (1_000_000, 16_384, 1e-2)
CAP_SLOTS = 29_056  # f64 slots in the H100's 232,448 bytes a block
CASES = ("random8", "power_law", "N", "A", "at_cap", "gather", "gather_f32",
         "cg_N", "stream", "kpayload", "dia", "dia_f32", "dia_wide",
         "dia_wide_f32")
TR, O = 131072, 5               # the stream probe's tile and rows
KP = (64, 8, 4096)              # the k-payload probe's k, F and tiles
CG_STEPS, CG_RUNS, MATVECS = 50, 5, 200


def cg_step(A, x, r, p):
    """One CG iteration with the port's public API: (x, r, p) -> the next
    three DistVectors."""
    Ap = A @ p
    rr = r.dot(r)
    alpha = rr / p.dot(Ap)
    x = x + alpha * p
    r2 = r - alpha * Ap
    return x, r2, r2 + (r2.dot(r2) / rr) * p


def cg(A, b, steps):
    """``steps`` CG iterations from x = 0 with the port's public API;
    returns (x, r)."""
    x, r, p = type(b).zeros(b.n, b.backend), b, b
    for _ in range(steps):
        x, r, p = cg_step(A, x, r, p)
    return x, r


def cg_step_ms(A, b) -> dict:
    """Median over CG_RUNS runs of CG_STEPS steps from x = 0: the wall time
    a step by CUDA events and the host's enqueue time a step, in ms
    (``timing.chain_ms``)."""
    x0 = type(b).zeros(b.n, b.backend)
    t = chain_ms({"cg": (lambda x, r, p: cg_step(A, x, r, p), (x0, b, b))},
                 CG_STEPS, CG_RUNS)["cg"]
    mv = []
    for _ in range(CG_RUNS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(MATVECS):
            A @ b
        mv.append((time.perf_counter() - t0) * 1e6 / MATVECS)
        torch.cuda.synchronize()
    return {"step_ms": t["step_ms"], "host_enqueue_ms": t["host_ms"],
            "matvec_host_us": float(np.median(mv))}


def device_events(body):
    """The kernels and copies ``body`` runs on the card, from a
    torch.profiler trace. The device timeline's copies of host ranges
    (``annotate``, the kernel wrappers' ``launch_range``) are left out:
    they are no device work."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        body()
        torch.cuda.synchronize()
    return [e for e in prof.events() if e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]


def busy_us(events) -> float:
    """The union of the events' device intervals (``device_events``), in
    µs."""
    busy, end = 0.0, float("-inf")
    for a, b in sorted((e.time_range.start, e.time_range.end)
                       for e in events):
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy


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


def stream_calls(dev, rng) -> dict:
    """{label: call} for the ``stream`` case: K4 table_stream and the
    library calls of its functions."""
    from hpclinalg_torch.ops.cuda_dia_probe import table_stream
    calls = {}
    for k in (1000, 2000):
        ntiles = -(-k * k // TR)
        npad = ntiles * TR
        tbl = torch.from_numpy(rng.standard_normal((O, npad), dtype=np.float32)
                               ).to(dev)
        tflat = tbl.reshape(O, ntiles, TR).permute(1, 0, 2).contiguous()
        c = torch.full((1,), 0.5, dtype=torch.float32, device=dev)
        ones = torch.ones((ntiles, 1, O), dtype=torch.float32, device=dev)
        cexp = c.view(1, 1, 1).expand(ntiles, 1, TR)
        calls[f"skern k={k}"] = (lambda a=(tbl, c, ntiles, TR, 1, TR, npad,
                                            0.125): table_stream(*a))
        calls[f"skern k={k} torch.add"] = (
            lambda t=tbl, c=c: torch.add(c, t[0], alpha=0.125))
        for depth in (1, 2, 3):
            name = "v3" if depth == 1 else f"v5_d{depth}"
            calls[f"{name} k={k}"] = (
                lambda a=(tflat, c, ntiles, TR, O, O * TR, TR, 1.0, depth):
                table_stream(*a))
        calls[f"v3 odd row stride k={k}"] = (
            lambda a=(tflat, c, ntiles, TR, O, O * TR, TR - 1, 1.0):
            table_stream(*a))
        calls[f"v3 k={k} baddbmm"] = (
            lambda a=(cexp, ones, tflat): torch.baddbmm(*a))
    return calls


def kpayload_calls(dev, rng) -> dict:
    """{label: call} for the ``kpayload`` case: K5, its granule control,
    floor (i) and its library call."""
    from hpclinalg_torch.ops.cuda_kpayload import kpayload
    k, F, ntiles = KP
    src = torch.from_numpy(rng.standard_normal((ntiles, F, k, 128),
                                               dtype=np.float32)).to(dev)
    idx = torch.from_numpy(rng.integers(0, 128, (ntiles, 1, 128))
                           .astype(np.int8)).to(dev)
    sel = torch.from_numpy(rng.integers(0, F, (ntiles, 1, 128))
                           .astype(np.uint8)).to(dev)
    t = torch.arange(ntiles, device=dev)[:, None, None]
    j = torch.arange(k, device=dev)[None, :, None]
    sl, il, even = sel.long(), idx.long(), idx & ~8
    return {"K5": lambda: kpayload(src, idx, sel, checked=True),
            "K5 granule control": lambda: kpayload(src, even, sel,
                                                   checked=True),
            "floor (i) torch.sum": lambda: torch.sum(src, dim=1),
            "K5 library call": lambda: src[t, sl, j, il]}


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
    Ab = banded_design(m, n, SEED + 8)[0] \
        if {"N", "A", "cg_N"} & set(cases) else None
    Nm = (Ab.T @ Ab + lam * sp.eye(n)).tocsr() \
        if {"N", "cg_N"} & set(cases) else None
    mats = {"random8": lambda: random_8(N_ROWS, SEED + 1),
            "power_law": lambda: power_law(N_ROWS, SEED + 2),
            "N": lambda: Nm, "A": lambda: Ab,
            "at_cap": lambda: random_cols(300_000, CAP_SLOTS - 8, 4,
                                          SEED + 6),
            "dia": lambda: laplace2d(1000),
            "dia_wide": lambda: wide_span(N_ROWS)}
    skip = {e.name for e in device_events(lambda: [flush()
                                                   for _ in range(REPS)])}
    out = {}
    for case in cases:
        if case.removesuffix("_f32") in mats:
            M = mats[case.removesuffix("_f32")]()
            bk = ht.backend_auto(1, dtype=np.float32, device=dev) \
                if case.endswith("_f32") else be
            Md = ht.DistSparseMatrix.from_scipy(M, bk)
            x = ht.DistVector.from_global(rng.standard_normal(M.shape[1]), bk)
            out[case] = kernel_times(lambda: Md @ x, flush, skip)
        elif case in ("stream", "kpayload"):
            make = stream_calls if case == "stream" else kpayload_calls
            for lab, fn in make(dev, rng).items():
                out[f"{case} {lab}"] = kernel_times(fn, flush, skip)
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
        if len(ks) > 1:
            print(f"{label} {case}: {sum(ks.values()):8.1f} us  all its "
                  f"kernels  [{name}]", flush=True)
    print(json.dumps({"label": label, "card": name, "us": out}), flush=True)
    return out


if __name__ == "__main__":
    main()
