#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (hpclinalg_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout. It builds the hand-written kernels from
hpclinalg_torch/csrc, then:
  1. holds K1 (DIA SpMV) against its plain twin bit for bit on the 1000^2
     Laplacian (n = 10^6) in f32 and f64 at S = 1 and S = 4 stacked shards
     and on a wide-span pattern (offsets +-3*10^5, three staged pieces), all
     on its 16-byte kernel dia_vec, and on its scalar kernel dia_scalar at
     an odd Lrow (laplace2d(999)'s table cut to its 998001 rows) and with a
     g 4 bytes off 16; the kernel that ran is the one the wrapper
     records at its launch;
  2. holds K2 (ELL SpMV + COO tail) against its twin on the random
     10^6 x 8 nnz/row matrix in f32 and f64 and on a power-law matrix with a
     nonempty tail (also a tenth of it on S = 4 shards), and its gather-only
     mode bit for bit at 8*10^6 slots, at an odd length, from an
     unaligned source table and on two shards of an odd width;
  3. drives the main path through the public API in f64 — A @ x, 200 CG
     steps, A @ x on the random matrix, ldlt/solve/lu on the host engine —
     with the kernels' launch counters reset just before and read just after;
  4. times each kernel against its twin and its library call (median of 20,
     CUDA events, L2 flushed before each launch, in turns) beside its bound
     (bytes over 3.35 TB/s or operations over the peak rate); the library
     call is cuSPARSE's CSR SpMV (torch.sparse_csr_tensor @ x) for K1-K3
     and index_select for the gather mode, built from the same inputs and
     called by this script only; K2's kernels on the power law by the
     profiler, K2's group width swept 1..32, the gather mode against the
     same bytes in order; each K1 case's device time (torch.profiler,
     median of 20 cold-L2 runs, the better of two rounds); the CG step (wall and host enqueue time,
     its device time by kernel and the card's busy share from a
     torch.profiler trace) and the build;
  5. holds K3 (resident-x ELL SpMV) against its plain version and against K2
     on the same tables: the ridge normal matrix N = A^T A + lambda I (f32
     and f64, S = 1 and 4), the tall design A (f64), and a gathered x at
     the shared-memory cap (with 16-byte and with one-entry loads); a
     gathered x over the cap must take K2;
  6. drives the sparse ridge-regression path through the public API in f64
     at S = 1 and 4 — A is 10^6 x 16384 with 4 entries a row in a band:
     At = A.T.materialize(), N = (At @ A).add_identity(lambda), rhs = At @ b
     (K2), 50 CG steps on N (K3), ldlt(N).solve(rhs) on the host, A @ x
     (K3) — with the launch counters reset just before and read just after,
     then the laplace2d(100)^2 SpGEMM (DIA engine) in f64 and f32; and
     times K3, K2, the plain version and the library call on each phase-5
     case (K2's group width and K3's tile height swept on N and A, K3 on N
     once more with L2 warm), the SpGEMM with and without its plan build,
     the transpose, add_identity, the CG step on N and the host factor +
     solve;
  7. runs the probe tools (python -m hpclinalg_torch.tools.*) at their own
     sizes in f32, with the launch counters reset just before and read just
     after: proto_dia (K1 on laplace2d(2000) against scipy), dia_variants
     at k = 1000 and 2000 (K1 through the plan and raw, K4 dia_flat_spmv v4
     against its plain version and scipy, v1 against its plain version, K4
     table_stream skern, v3 and v5 on its 16-byte kernel, bit for bit
     against their plain versions) and probe_kpayload at k = 64, F = 8,
     4096 tiles (K5 bit-exact, its floors and granule control); then holds
     table_stream's scalar kernel (an odd row stride, an unaligned table)
     and K5 at k = 1, F = 1, at k = 13 with every lane in one sector and at
     F = 255 bit for bit against their plain versions; and prints each
     probe beside its bound and its library call (cuSPARSE's CSR SpMV on
     the same Laplacian; torch.add for skern and torch.baddbmm for v3 and
     v5, each within PROBE_RTOL of the plain version; K5's one indexing
     call) and K5 beside its sector floor;
  8. drives the dense path through the public API in f64 at S = 1 and 4:
     the random 10^6 x 8 matrix times a 10^6 x 64 DistDenseMatrix against
     scipy (and in f32), laplace2d(1000) times a 10^6 x 8 block, the
     multi-response ridge (R = At @ Y, Xh = solve(N, R) from the host
     multi-RHS sweep with its residual checked through N @ Xh, Xh.T @ Xh,
     A @ Xh - Y) and the dense operations D @ v, D.T @ w, D @ E, D @ B on
     a 10^4 x 512 D; and times the SpMMs, At @ Y and the multi-RHS solve,
     with the peak device memory of the SpMMs;
  9. drives the device multifrontal solver through the public API in f64,
     with the host engine's fallback warning made an error:
     ldlt(A, method="device", spd=True) on laplace2d(512) (n = 262,144) at
     S = 1 and 4 against the host engine (residual <= 1e-10, within 1e-9
     of the host solution), printing bench.py's host_ldlt_factor_262k_ms,
     device_chol_factor_262k_ms (the eager engine factor) and
     device_solve_262k_ms, the plan build, the factor's launches, busy
     share (torch.profiler), largest kernels and peak memory; then the
     factorization's CUDA graphs (the counterpart of the JAX engine's
     compiled factor, inversion and solve): the factor graph's call
     against its eager bodies and against eng.factor alone, the solve
     graph's call against its eager body (CUDA events, in turns), the
     launches (kernel nodes) and device time of a replay, the capture and
     instantiation seconds, memory_reserved after the capture, a
     refactorize that replays with no new capture, and the graphed
     solution within 1e-12 of the eager bodies' beside the spread of two
     eager ones; an indefinite LDL on laplace2d(256) - sigma I and a
     k = 8 multi-RHS solve on it (residual through N @ X; its own solve
     graph), an LU on unsymmetric values over laplace2d(256) with its
     transposed solve, a complex-symmetric c128 LDL on laplace2d(64) at
     S = 4, each factored and solved through its graphs (node counts,
     capture and instantiation seconds printed); a solver="device"
     backend through ht.solve twice (a refactorize-only hit that replays
     its factor graph), and a tridiagonal chain tree that warns and takes
     the host engine. K1 (refinement) and K2's gather mode (the solve's
     in and out plans, counted at the solve graph's warm-up and capture:
     a replay runs no Python) are counted on the solves;
 10. drives the saddle-point assembly through the public API in f64 at
     S = 1 and 4, in a process of its own (python -m
     hpclinalg_torch.tools.kkt: the profiler is reliable only in a
     process's first sessions, PERF.md): K = cat(A, B^T, B, -1e-6 I,
     dims=(2, 2)) with A = laplace2d(1000) and B 10^4 x 10^6 with 16
     random entries a row (1,010,000 rows), equal to sp.bmat bit for bit;
     K @ z and K.T @ w; K[0:n, 0:n], K[n:, 0:n], K[p, p] with repeated ids,
     K[:, j], z[n:], z[ids] = vals (the last write wins), vcat/hcat of
     vectors, K[0:n, 0:n] @ x; K[bnd, bnd] = I on the 3996 boundary nodes,
     then K @ z, K.T @ w and issymmetric() on new plans; the nine
     reductions of K; dense indexing, assignment and concatenation on a
     10^6 x 8 D; map_rows and mapslices over the grid coordinates;
     blockdiag(A, A) @ [x; x]; to_backend from the CPU; profile_trace of one
     K @ z inside annotate("kkt_matvec"), the trace read back for that name
     and K2's kernel; warmup. Each step is held against scipy or numpy; the
     launch counters are set to 0 just before the drives and read just
     after (K2 and its gather mode must have run, and K1 where a plan took
     the DIA engine), and the first (plan build) and cached times and the
     cached pass's busy share and largest kernels are printed beside the
     card;
 11. drives complex values through the public API in c64 and c128, each
     kernel in one launch on torch's interleaved values: K1 on the
     Helmholtz operator laplace2d(1000) - 0.5 I + 0.05i I (n = 10^6) at
     S = 1 and 4 (H @ z, the conjugating z.dot(w), norm, an axpy, H.H @ z);
     K2 on the random and power-law matrices with seeded complex values
     (a tenth of the power law at S = 4) and mixed real/complex products;
     K3 on the ridge N's pattern (c64 at S = 1 and c128 at S = 4 take K3,
     c128 at S = 1 is over the cap and takes K2) and at the cap (c128 at
     cap // 16 slots, c64 at cap // 8 with 16-byte and one-entry loads);
     each kernel against its plain version (rtol 1e-12 in c128, 1e-5 in
     c64) and each product against scipy; the complex device solver:
     ldlt(method="device", spd=False) on the Helmholtz operator at 256^2
     (c128 at S = 1 and 4 against the host engine, c64 at S = 1; cut from
     512^2 to make room for phase 14), lu on a
     permuted laplace2d(256) with unsymmetric complex values (K2 in its
     refinement) with its transposed solve, and a solver="device" backend
     through ht.solve twice; then times each complex kernel beside its
     plain version, bound and cuSPARSE's complex CSR SpMV (where PyTorch
     has one), K1 in c128 also beside the former route (four real K1
     products), and the complex device factor and solve beside phase 9's
     f64 ones. The launch counters are set to 0 just before each drive
     and read just after.

 12. drives the main path with one shard a process (ht.backend_dist over a
     torch.distributed group, hpclinalg_torch.parallel.launch.run_ranks,
     tools/dist_checks.card): A @ x on laplace2d(1000) in f64 and f32 (K1
     and the halo exchange), 20 CG steps and a dot in each, A @ x on the
     random and power-law matrices (K2, its gather mode, its tail) and on
     the ridge N (K3), in c128 on the Helmholtz operator (K1), the random
     matrix (K2) and N (K3; K2 at world 1, over K3's cap), then the ridge
     assembly at phase 6's sizes (At = A.T.materialize(), N = (At @
     A).add_identity(lambda) on the pair engine, rhs = At @ b, 50 CG steps
     on N for x (no host ldlt of N here, for the script's time: phase 6
     runs it, and the drive's last step is a host ldlt on the group),
     A @ x; N against scipy's in
     every rank; the refit A.with_values(1.5 A.nzval) reusing every plan;
     laplace2d(1000) + the random matrix; diag and triu of laplace2d(1000);
     a c128 transpose and addition), then ldlt(laplace2d(256)).solve(b)
     on the host engine (rank 0 factors) and ht.solve twice; (a) NCCL at
     world 1, (b) gloo at world 4 with the four ranks sharing the card,
     (c) NCCL at world = device count with two cards or more. Every drive
     clears the plan caches first. Each rank is held against the same
     drive run stacked at that S (data movement and K1/K3 bit for bit, the
     rest to K2_RTOL), must have launched K1, K2, the gather mode and K3,
     and the CG step, the exchange, the ridge's first and cached
     transpose, SpGEMM and additions, an all_reduce and an
     all_to_all_single are timed per rank beside the stacked drive's; at
     NCCL world 1 the all_reduce's host time is profiled (cProfile and
     torch.profiler's CPU activity);
 13. drives the device multifrontal solver and the dense containers with
     one shard a process (tools/dist_checks.solvers, arrangements as in
     phase 12), with the host fallback's warning an error: ldlt(A,
     method="device", spd=True) of laplace2d(512) (n = 262,144; its cross
     buffer summed by one all_reduce, the top tree replicated in every
     rank) and its solve, the indefinite LDL and the LU with its
     transposed solve on laplace2d(256), a c128 LDL of Helmholtz(256);
     then the multi-response ridge on phase 12's design and N: Y a
     10^6 x 64 DistDenseMatrix, R = At @ Y (SpMM on the group), X =
     ldlt(N, method="device", spd=True).solve_matrix(R) with |N X - R| /
     |R| <= 1e-10, G = X.T @ X (the dense transpose's exchange) and the
     single response solve(At @ b). Each rank is held against the same
     drive run stacked at that S (solutions rtol 1e-10, R and G 1e-12;
     n_perturbed, growth and the plan's digest equal), must have launched
     K1, K2, its gather mode and K3, must have factored and solved
     through CUDA graphs at NCCL (the factor's cross all_reduce and the
     solve's all_reduce in the graphs) and eagerly at gloo, and at gloo
     world 4 its Cholesky subtrees cover all four ranks; one JSON line an
     arrangement prints each rank's first call, engine factor (events
     and host enqueue time), factor graph and solve graph (events and
     host time, where graphed), solve, cross all_reduce (bytes, events,
     host time), At @ Y and multi-RHS solve beside the stacked drive's;
 14. drives phase 10's saddle-point assembly with one shard a process
     (tools/dist_checks.assembly: tools/kkt.drive at k = 1000, m = 10^4,
     K 1,010,000 rows, in every rank; arrangements as in phase 12): cat,
     K @ z, K.T @ w, K[0:n, 0:n] (K1), K[:, j], K[p, p], z[ids] = vals,
     the vector cat, the Dirichlet rows K[bnd, bnd] = I, every sparse
     reduction, the dense indexing and assignment, map_rows, mapslices,
     blockdiag, to_backend, profile_trace of one K @ z into a file of the
     rank's own, warmup; each step held against scipy in every rank. Each
     rank's engines must equal phase 10's stacked ones at that S, it must
     have launched K1, K2 and K2's gather mode, and its trace must name
     kkt_matvec and K2's launch range; one JSON line an arrangement prints
     each rank's first (plan build) and cached times and step seconds
     beside phase 10's stacked S = 1 and S = 4 times.
 15. runs the JAX entry point's compiled CG step (hpclinalg_torch.entry:
     cg_step_fn over the plan's raw tensors, entry(), and capture, the
     step captured once as a CUDA graph, the counterpart of jax.jit) in a
     process of its own (python -m hpclinalg_torch.tools.cg_graph), f64
     unless said: (i) laplace2d(1000) at S = 1 (K1), (ii) at S = 4 (K2's
     gather mode, then K1), (iii) the ridge N (K3), (iv) the random
     10^6 x 8 matrix (K2), (v) entry() itself (laplace2d(64), f32, K1).
     Each case's launch counters are set to 0 just before its 20 eager raw
     steps and read just after its capture and 20 replays, which must
     equal the eager steps bit for bit, launch each of the step's three
     vector kernels once a step, and equal the public-API CG to 1e-10
     (f32 1e-5) on the symmetric positive definite cases ((iv) instead:
     from each state, the kernels against the step and the plain
     arithmetic, and one public-API step while rounding allows; see
     tools/cg_graph.py) and, for (i) and (v), a host replay in numpy
     (1e-10; 1e-4 in f64 and f32); it prints
     the wall time a step (CUDA events, median of 5 runs of 50), the host
     time a step and, from one torch.profiler session, the device time
     and kernels of one call, for the replay, the eager raw step and
     phase 4's public-API step taken in turns, and checks that a step
     that reads a value on the host fails to capture. Then case (i) with
     one shard a process (tools/dist_checks.entry_steps): NCCL at world 1
     graphed (its two all_reduces in the graph) and eager, gloo at world
     4 on the card eager, where capture must refuse the group; each rank
     held against the same steps stacked (rtol 1e-10) and each launching
     the three vector kernels once a step.
 16. holds the CG step's vector kernels (hpclinalg_torch/csrc/cg_vec.cu:
     cg_dots, cg_update_xr, cg_update_p) on HPCG's 27-point operator at
     104^3 (1,124,864 rows), f64, S = 1: the step takes them; their launch
     counters are set to 0 just before 20 replays of the captured step
     and read just after (20 each); from the state the replays leave, the
     kernels once on the same inputs equal the step bit for bit, their
     updates equal the plain arithmetic given their own alpha and beta,
     and their dots a double torch.dot to 1e-12 of the terms' magnitudes;
     then each kernel, its plain version (that pass of the plain step)
     and its library calls (torch.dot; torch.add with the scalar on the
     host) are timed in turns beside its bound (27, 54 and 27 MB).
 17. holds the device LDLT's leaf kernel (hpclinalg_torch/csrc/ldl_leaf.cu)
     on the main path: ldlt(method="device", spd=False) of Helmholtz(256)
     in c128 at S = 1 and its solve, the kernel's launch counter and the
     recorder's counters set to 0 just before and read just after: its
     launches equal solver.ldl_leaf_kernels, no leaf takes the plain
     version, residual <= 1e-10; then the kernel at each leaf shape of
     that factorization in f32, f64, c64 and c128 against its plain
     version (the recursion to 1 x 1 on the card; rtol 1e-5 / 1e-12, the
     same clamped pivots); then, at 27647 blocks of 16 columns and 64 of
     32 in c128, the kernel and its plain version each captured as a CUDA
     graph and replayed in turns beside the byte bound. Phase 13 also
     requires every rank to have launched it.

Any failed check raises, so the exit code is nonzero and the last line is
not printed. With no CUDA device it raises at once. The line before the
last is the kernels' JSON record; the last is the device record.
"""

import json
import subprocess
import sys
import time

import numpy as np
import scipy.sparse as sp
import torch

from hpclinalg_torch.tools.ell_ab import (busy_us, cg, device_events,
                                          kernel_times)
from hpclinalg_torch.tools.matrices import (banded_design,
                                            between_eigenvalues,
                                            complex_values, helmholtz,
                                            laplace2d, power_law, random_8,
                                            random_cols, wide_span)
from hpclinalg_torch.tools.timing import Timer, bound_ms

SEED = 0
N = 1_000_000          # rows of the SpMV matrices (laplace2d(K): N = K^2)
K = 1000
D = 8_000_000          # destinations of the gather-only check
K1_RTOL = {torch.float32: 1e-5, torch.float64: 1e-12}
K2_RTOL = {torch.float32: 1e-5, torch.float64: 1e-12}
K3_RTOL = K2_RTOL       # K3 sums a row in K2's order; the tail uses atomics
RIDGE_M = 1_000_000     # observations (rows of the design A)
RIDGE_N = 16_384        # unknowns (columns of A, order of N)
RIDGE_LAMBDA = 1e-2
RIDGE_CG_STEPS = 50
# N = A^T A + lambda I has condition number near 3 at this design (1.0e-15
# relative CG error after 50 steps at 2*10^5 x 4096 in scipy), so the CG
# iterate must equal the direct solution to this relative tolerance
RIDGE_CG_RTOL = 1e-11
KKT_M = 10_000          # constraints (rows of B) of the saddle-point phase


def check(cond, what):
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {what}")
    print(f"  ok: {what}", flush=True)


def close(a, b, rtol):
    """max |a - b| <= rtol * max |b|; returns (ok, max_abs_err)."""
    err = float((a - b).abs().max()) if a.numel() else 0.0
    scale = float(b.abs().max()) if b.numel() else 0.0
    return err <= rtol * max(scale, 1e-300), err


def device_us(fn):
    """Device time of the kernels and copies that ``fn`` launches, from a
    torch.profiler trace: the union of their intervals in microseconds, and
    how many there were."""
    events = device_events(fn)
    return busy_us(events), len(events)


def device_kernels(fn, top=4):
    """The kernels and copies ``fn`` launches, their device time summed by
    name over a torch.profiler trace: [(name, us)], largest first."""
    tot = {}
    for e in device_events(fn):
        tot[e.name] = tot.get(e.name, 0.0) + (e.time_range.end
                                               - e.time_range.start)
    return sorted(tot.items(), key=lambda kv: -kv[1])[:top]


def engine_inputs(A, x):
    """The SpMV plan of A @ x and the gathered x its engine reads."""
    from hpclinalg_torch.ops import spmv as spmv_mod

    plan = spmv_mod.get_spmv_plan(A, x)
    return (plan,) + spmv_mod.gathered(plan, x.data)


def ell_call(plan, Md, g, pad_to):
    """K2's and K3's arguments as A @ x passes them: (args, K2 keywords,
    K3 keywords)."""
    from hpclinalg_torch.ops import spmv as spmv_mod

    args, kw, windows = spmv_mod.ell_kernel_args(Md, plan, g, pad_to)
    return args, kw, dict(kw, windows=windows)


def misaligned(t):
    """A copy of ``t`` whose data starts one item past the allocator's
    16-byte boundary, so the ELL kernels take their one-entry loads."""
    flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = flat[1:].view(t.shape)
    out.copy_(t)
    return out


def k1_check(label, args, vector):
    """K1 on ``args`` against its plain version, bit for bit, and the
    kernel that ran, as the wrapper records it at the launch: dia_vec where
    dia_vector_width says 16 bytes (``vector``), else dia_scalar. (Not
    from a profiler trace: torch.profiler on the card may record no device
    activity from some session of a process on, PERF.md.)
    Returns the max abs error (0.0)."""
    from hpclinalg_torch.ops import cuda_dia

    dval, g = args[0], args[1]
    cuda_dia.dia_spmv.kernel = None
    yk = cuda_dia.dia_spmv(*args)
    ran = cuda_dia.dia_spmv.kernel
    yp = cuda_dia.dia_spmv_plain(*args)
    torch.cuda.synchronize()
    width = cuda_dia.dia_vector_width(dval, g, yk)
    lay = cuda_dia.dia_layout(tuple(args[2]), dval.element_size(),
                              cuda_dia.smem_cap(0))
    want = "dia_vec" if vector else "dia_scalar"
    err = float((yk - yp).abs().max())
    check(torch.equal(yk, yp) and (width > 1) == vector and ran == want,
          f"K1 {label} {dval.dtype}: {ran} (vector width {width}; "
          f"{lay.threads} threads, {lay.tile}-row tiles, "
          f"{len(lay.pieces)} staged pieces, {lay.smem_bytes} bytes) equals "
          f"its plain version bit for bit (max_abs_err {err:.3e})")
    return err


def ell_bytes(plan, Md, dt):
    """Bytes an ELL SpMV must move: the stored entries (value and column
    index), the row-length table, the tail's entries (value, row, column),
    the gathered x once and y once. Padding is not counted: the kernels
    never read it."""
    isz = dt.itemsize
    S, Lrow = plan.ell_rowlen_np.shape
    n_ell = int(plan.ell_rowlen_np.sum())
    n_tail = Md.nnz() - n_ell
    return (n_ell * (isz + 4) + S * Lrow * 4 + n_tail * (isz + 8)
            + S * plan.exchange.out_pad * isz + S * Lrow * isz)


def dia_bytes(plan, dval, dt):
    """Bytes a DIA SpMV must move: the (S, O, Lrow) diagonal table, the
    gathered x once and y once."""
    S, O, Lrow = dval.shape
    return (S * O * Lrow + S * plan.exchange.out_pad + S * Lrow) * dt.itemsize


def csr_call(M, dt, dev, xh):
    """The library yardstick of an SpMV: cuSPARSE's CSR SpMV, one PyTorch
    call (``torch.sparse_csr_tensor(...) @ x``) on the same matrix and x,
    built outside the timed call. Only this script calls it."""
    M = M.tocsr()
    A = torch.sparse_csr_tensor(torch.from_numpy(M.indptr.astype(np.int32)),
                                torch.from_numpy(M.indices.astype(np.int32)),
                                torch.from_numpy(M.data), size=M.shape,
                                dtype=dt, device=dev)
    x = torch.from_numpy(np.asarray(xh)).to(dev, dt)
    return lambda: A @ x


def case_line(label, ms, plain, lib, nbytes, flops, dt, card):
    """Print a timed case with its bound; returns (bound ms, bound_by)."""
    bms, by = bound_ms(nbytes, flops, dt)
    print(f"  {label}: kernel {ms:.4f} ms, plain {plain:.4f} ms, library "
          f"{'none' if lib is None else f'{lib:.4f} ms'}; bound {bms:.4f} ms "
          f"({by}: {nbytes / 1e6:.1f} MB), {100 * bms / ms:.0f} % of it  "
          f"[{card}]", flush=True)
    return bms, by


def lanes_sweep(timer, label, args, kw, card):
    """K2's time at each group width 1..32 on one case, in turns, the
    plan's own marked with *: the evidence for ops/cuda_ell.py:lanes_for."""
    from hpclinalg_torch.ops import cuda_ell

    widths = (1, 2, 4, 8, 16, 32)
    got = timer.turns(*[lambda k=dict(kw, lanes=w):
                        cuda_ell.ell_spmv(*args, **k) for w in widths])
    print(f"  {label} by group width: " + ", ".join(
        f"{w}{'*' if w == kw['lanes'] else ''} {ms:.4f}"
        for w, ms in zip(widths, got)) + f" ms  [{card}]", flush=True)


def tile_sweep(timer, label, plan, args, kw3, card):
    """K3's time at tiles of 1..16 row passes on one case, in turns, the
    plan's own marked with *: the evidence for
    ops/cuda_ell_resident.py:tile_rows."""
    from hpclinalg_torch.ops import cuda_ell, cuda_ell_resident as k3

    per = cuda_ell.rows_per_pass(kw3["lanes"])
    dt = args[0].dtype
    fns, labels = [], []
    for passes in (1, 2, 4, 8, 16):
        win = k3.make_windows(plan.ell_cols_np, plan.ell_rowlen_np,
                              kw3["lanes"], dt, args[2].device, per * passes)
        fns.append(lambda k=dict(kw3, windows=win):
                   k3.ell_resident_spmv(*args, **k))
        mark = "*" if per * passes == kw3["windows"].tile_rows else ""
        labels.append(f"{passes}{mark}")
    got = timer.turns(*fns)
    print(f"  {label} by row passes a tile ({per} rows a pass): " + ", ".join(
        f"{lab} {ms:.4f}" for lab, ms in zip(labels, got))
        + f" ms  [{card}]", flush=True)


def timed_s(fn):
    """Wall seconds of one call of ``fn``, the card's queue drained."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def phase5_k3(ht, dev, A, N_sc, rng, errs, bench, sweep):
    """K3 against its plain version and against K2 on the same tables, at
    the shapes of the ridge path and at the shared-memory cap."""
    from hpclinalg_torch.ops import cuda_ell, cuda_ell_resident as k3
    from hpclinalg_torch.ops import spmv as spmv_mod

    cap = k3.smem_cap(dev)
    # a gathered x of Gpad slots, Gpad the largest multiple of 8 whose f64
    # bytes fit the cap: n = Gpad - 8 columns (plus the zero slot)
    g_cap = (cap // 8) // 8 * 8
    print(f"  shared-memory cap {cap} bytes: up to {cap // 8} f64 slots",
          flush=True)
    cases = [("N", N_sc, 1, torch.float64), ("N", N_sc, 1, torch.float32),
             ("N", N_sc, 4, torch.float64), ("N", N_sc, 4, torch.float32),
             ("A", A, 1, torch.float64),
             ("at_cap", random_cols(300_000, g_cap - 8, 4, SEED + 6), 1,
              torch.float64)]
    for name, M, S, dt in cases:
        npdt = np.float32 if dt == torch.float32 else np.float64
        be = ht.backend_auto(S, dtype=npdt, device=dev)
        Md = ht.DistSparseMatrix.from_scipy(M, be)
        x = ht.DistVector.from_global(rng.standard_normal(M.shape[1]), be)
        plan, g, pad_to = engine_inputs(Md, x)
        G = plan.exchange.out_pad
        lanes, win = plan.ell_layout(dt)
        staged = "windows" if win is not None and \
            2 * win.width * dt.itemsize <= cap else "whole x"
        check(plan.engine(dt) == "resident",
              f"{name} S={S} {dt} takes the resident engine (nnz "
              f"{Md.nnz()}, W={plan.ell_W}, Tpad={plan.ell_Tpad}, lanes "
              f"{lanes}, gathered x {G} slots = {G * dt.itemsize} "
              f"bytes; K3 stages {staged}"
              + (f", {win.tile_rows}-row tiles, widest window {win.width} "
                 "slots)" if win is not None else ")"))
        args, kw2, kw3 = ell_call(plan, Md, g, pad_to)
        y3 = k3.ell_resident_spmv(*args, **kw3)
        yp = k3.ell_resident_spmv_plain(*args)
        y2 = cuda_ell.ell_spmv(*args, **kw2)
        torch.cuda.synchronize()
        ok, err = close(y3, yp, K3_RTOL[dt])
        ok2, err2 = close(y3, y2, K3_RTOL[dt])
        check(ok and ok2, f"K3 {name} S={S} {dt}: max_abs_err {err:.3e} "
              f"against the plain version, {err2:.3e} against K2 (rtol "
              f"{K3_RTOL[dt]:g} of max|y|)")
        errs["resident"] = max(errs["resident"], err)
        if name == "at_cap":
            # both variants of the kernel (16-byte and one-entry loads) at
            # the same shared memory, above the 48 KB that needs an opt-in
            a1 = (misaligned(args[0]),) + args[1:]
            y1 = k3.ell_resident_spmv(*a1, **kw3)
            torch.cuda.synchronize()
            ok, err1 = close(y1, yp, K3_RTOL[dt])
            check(ok, f"K3 {name} with one-entry loads (vals {dt.itemsize} "
                  f"bytes off 16) after 16-byte loads, both staging "
                  f"{-(-G * dt.itemsize // 16) * 16} bytes: max_abs_err "
                  f"{err1:.3e} against the plain version")
            errs["resident"] = max(errs["resident"], err1)
        bench[(name, S, dt)] = (
            lambda a=args, k=kw3: k3.ell_resident_spmv(*a, **k),
            lambda a=args, k=kw2: cuda_ell.ell_spmv(*a, **k),
            lambda a=args: k3.ell_resident_spmv_plain(*a),
            csr_call(M, dt, dev, x.to_numpy()),
            ell_bytes(plan, Md, dt), 2 * Md.nnz())
        if S == 1 and dt == torch.float64 and name != "at_cap":
            sweep[name] = (plan, args, kw2, kw3)
    # one slot group past the cap: the plan must take K2, and A @ x does
    M = random_cols(300_000, g_cap, 4, SEED + 7)
    be = ht.backend_auto(1, dtype=np.float64, device=dev)
    Md = ht.DistSparseMatrix.from_scipy(M, be)
    xh = rng.standard_normal(M.shape[1])
    x = ht.DistVector.from_global(xh, be)
    plan = spmv_mod.get_spmv_plan(Md, x)
    Md @ x
    torch.cuda.synchronize()
    c2, c3 = cuda_ell.ell_spmv.launches, k3.ell_resident_spmv.launches
    y = (Md @ x).to_numpy()
    ok, err = close(torch.from_numpy(y), torch.from_numpy(M @ xh), 1e-12)
    check(plan.engine(torch.float64) == "ell" and plan.engine(torch.float32)
          == "resident" and cuda_ell.ell_spmv.launches == c2 + 1
          and k3.ell_resident_spmv.launches == c3 and ok,
          f"over the cap ({plan.exchange.out_pad * 8} bytes in f64) A @ x "
          f"takes K2, not K3 (f32 would fit: resident); max_abs_err "
          f"{err:.3e} against scipy")


def phase6_ridge(ht, dev, A, bh, N_sc, S, timer, card, times):
    """The sparse ridge-regression path through the public API on S
    shards, f64; returns the launches of K2 and K3 it made."""
    from hpclinalg_torch.ops import cuda_ell, cuda_ell_resident as k3
    from hpclinalg_torch.ops import spgemm as spgemm_mod
    from hpclinalg_torch.ops import spmv as spmv_mod

    f64 = torch.float64
    be = ht.backend_auto(S, dtype=np.float64, device=dev)
    Ad = ht.DistSparseMatrix.from_scipy(A, be)
    b = ht.DistVector.from_global(bh, be)
    torch.cuda.synchronize()
    for f in (cuda_ell.ell_spmv, cuda_ell.gather, k3.ell_resident_spmv):
        f.launches = 0
    t = {}
    At, t["transpose_first_s"] = timed_s(lambda: Ad.T.materialize())
    C, t["spgemm_first_s"] = timed_s(lambda: At @ Ad)
    N = C.add_identity(RIDGE_LAMBDA)
    rhs = At @ b
    xk, _ = cg(N, rhs, RIDGE_CG_STEPS)

    def factor_solve():
        F = ht.ldlt(N)
        return F, F.solve(rhs)

    (F, x), t["ldlt_factor_solve_first_s"] = timed_s(factor_solve)
    y = Ad @ x
    torch.cuda.synchronize()
    launches = {"ell": cuda_ell.ell_spmv.launches,
                "gather": cuda_ell.gather.launches,
                "resident": k3.ell_resident_spmv.launches}
    print(f"  ridge S={S} launches: {launches}", flush=True)

    engines = (spmv_mod.get_spmv_plan(N, rhs).engine(f64),
               spmv_mod.get_spmv_plan(At, b).engine(f64),
               spmv_mod.get_spmv_plan(Ad, x).engine(f64))
    check(engines == ("resident", "ell", "resident"),
          f"S={S}: N @ p, At @ b, A @ x take {engines}")
    check(launches["resident"] >= RIDGE_CG_STEPS + 1 and launches["ell"] >= 1,
          f"S={S}: the path launched K3 {launches['resident']} times and K2 "
          f"{launches['ell']} times")
    Nh = N.to_scipy()
    nplan = spmv_mod.get_spmv_plan(N, rhs)
    rows, cols = Nh.nonzero()
    lens = np.diff(Nh.indptr)
    print(f"  N: {Nh.shape[0]} rows, nnz {Nh.nnz} ({lens.min()}-{lens.max()} "
          f"a row, mean {lens.mean():.1f}), {len(np.unique(cols - rows))} "
          f"distinct offsets, ELL W={nplan.ell_W}, SpGEMM pair chunks "
          f"{spgemm_mod.get_spgemm_plan(At, Ad).nchunks}", flush=True)
    check(nplan.offsets is None and np.array_equal(Nh.indptr, N_sc.indptr)
          and np.array_equal(Nh.indices, N_sc.indices),
          f"S={S}: N has scipy's pattern and the DIA engine refused it")
    ok, err = close(torch.from_numpy(Nh.data), torch.from_numpy(N_sc.data),
                    1e-12)
    check(ok, f"S={S}: N equals scipy's A^T A + lambda I, max_abs_err "
          f"{err:.3e} (rtol 1e-12 of max|N|)")
    xh, rh = x.to_numpy(), rhs.to_numpy()
    ok, err = close(torch.from_numpy(rh), torch.from_numpy(A.T @ bh), 1e-12)
    check(ok, f"S={S}: At @ b equals scipy's, max_abs_err {err:.3e}")
    res = np.linalg.norm(N_sc @ xh - rh) / np.linalg.norm(rh)
    check(res <= 1e-10, f"S={S}: ldlt(N).solve residual {res:.3e} <= 1e-10 "
          f"(native engine: {F.native is not None})")
    cg_err = float(np.linalg.norm(xk.to_numpy() - xh) / np.linalg.norm(xh))
    check(cg_err <= RIDGE_CG_RTOL, f"S={S}: {RIDGE_CG_STEPS} CG steps on N "
          f"equal the direct solution to {cg_err:.3e} (<= {RIDGE_CG_RTOL:g})")
    ok, err = close(torch.from_numpy(y.to_numpy()), torch.from_numpy(A @ xh),
                    1e-12)
    check(ok, f"S={S}: A @ x equals scipy's, max_abs_err {err:.3e}")
    sizes = ht.cache_sizes()
    A2 = Ad.with_values(Ad.nzval * 1.5)
    C2 = A2.T.materialize() @ A2
    ok, err = close(C2.nzval, 2.25 * C.nzval, 1e-12)
    check(ht.cache_sizes() == sizes and C2.structure is C.structure and ok,
          f"S={S}: At @ A with new values reused every plan (cache sizes "
          f"{sizes}), max_abs_err {err:.3e}")

    # times: device ones by the Timer (median of 20, L2 flushed), host once
    t["transpose_values_ms"] = timer.ms(
        lambda: Ad.with_values(Ad.nzval).transpose_materialized())
    t["add_identity_ms"] = timer.ms(lambda: C.add_identity(RIDGE_LAMBDA))
    t["spgemm_values_ms"] = timer.ms(lambda: At @ Ad)
    cg(N, rhs, 3)
    ev0, ev1 = torch.cuda.Event(enable_timing=True), \
        torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ev0.record()
    cg(N, rhs, RIDGE_CG_STEPS)
    t["cg_step_host_enqueue_ms"] = \
        (time.perf_counter() - t0) * 1e3 / RIDGE_CG_STEPS
    ev1.record()
    torch.cuda.synchronize()
    t["cg_step_ms"] = ev0.elapsed_time(ev1) / RIDGE_CG_STEPS
    for k, v in t.items():
        times[f"ridge_S{S}_{k}"] = v
        print(f"  ridge S={S} {k}: {v:.4f}  [{card}]", flush=True)
    return launches


def spgemm_laplace(ht, dev):
    """laplace2d(100)^2, the JAX bench's spgemm_laplace10k shape, through
    the DIA SpGEMM engine in f64 and f32, against scipy."""
    from hpclinalg_torch.ops import spgemm as spgemm_mod

    L = laplace2d(100)
    ref = (L @ L).tocsr()
    ref.sort_indices()
    for npdt, rtol in ((np.float64, 1e-12), (np.float32, 1e-6)):
        be = ht.backend_auto(1, dtype=npdt, device=dev)
        Ld = ht.DistSparseMatrix.from_scipy(L, be)
        Ch = (Ld @ Ld).to_scipy()
        ok, err = close(torch.from_numpy(Ch.data.astype(np.float64)),
                        torch.from_numpy(ref.data), rtol)
        check(spgemm_mod.get_spgemm_plan(Ld, Ld).dia.ok and ok
              and np.array_equal(Ch.indptr, ref.indptr)
              and np.array_equal(Ch.indices, ref.indices),
              f"laplace2d(100)^2 {npdt.__name__}: DIA SpGEMM engine, scipy's "
              f"pattern, max_abs_err {err:.3e} (rtol {rtol:g} of max|C|)")


PROBE_RTOL = 1e-5      # the probes run in f32, as the TPU scripts do
SPMM_K = 64            # columns of bench.py's SpMM (spmm_random_1m_k64_ms)
SPMM_RTOL = {torch.float32: 1e-5, torch.float64: 1e-12}
DENSE_M, DENSE_N = 10_000, 512
RIDGE_RES_TOL = 1e-10


def phase7_probes():
    """The probe tools at their own sizes; returns the launches of K1, K4
    and K5 they made, and the results of dia_variants and probe_kpayload."""
    from hpclinalg_torch.ops import cuda_dia, cuda_dia_probe as k4
    from hpclinalg_torch.ops import cuda_kpayload as k5
    from hpclinalg_torch.tools import dia_variants, probe_kpayload, proto_dia

    counted = {"dia": cuda_dia.dia_spmv, "dia_flat": k4.dia_flat_spmv,
               "stream": k4.table_stream, "kpayload": k5.kpayload}
    torch.cuda.synchronize()
    for f in counted.values():
        f.launches = 0
    proto = proto_dia.main([])
    dv = dia_variants.main(["--k", "1000", "2000"])
    kp = probe_kpayload.main([str(SPMM_K), "8", "4096"])
    torch.cuda.synchronize()
    launches = {key: f.launches for key, f in counted.items()}
    print(f"  probe launches: {launches}", flush=True)
    check(proto["scipy_rel_err"] <= PROBE_RTOL,
          f"proto_dia: K1 on laplace2d(2000) against scipy, rel err "
          f"{proto['scipy_rel_err']:.2e} (<= {PROBE_RTOL:g})")
    for k, rows in dv.items():
        for name, rec in rows.items():
            if "rel_err" in rec:
                check(rec["rel_err"] <= PROBE_RTOL,
                      f"dia_variants k={k} {name}: kernel against its plain "
                      f"version, max_abs_err {rec['err']:.3e}")
            if "scipy_rel_err" in rec:
                check(rec["scipy_rel_err"] <= PROBE_RTOL,
                      f"dia_variants k={k} {name}: against scipy, rel err "
                      f"{rec['scipy_rel_err']:.2e}")
    check(kp["exact"], f"probe_kpayload k={SPMM_K} F=8: K5 is bit-exact")
    check(all(v > 0 for v in launches.values()),
          "the probes launched K1, K4 (both kernels) and K5")
    for k, rows in dv.items():
        for name, rec in rows.items():
            if "lib_ms" in rec:
                check(rec["exact"] and rec["vec"] > 1
                      and rec["lib_rel_err"] <= PROBE_RTOL,
                      f"dia_variants k={k} {name}: table_stream's 16-byte "
                      f"kernel ({rec['vec']} elements an access) equals its "
                      f"plain version bit for bit; the library call within "
                      f"rel {rec['lib_rel_err']:.2e}")
    probe_edges()
    return launches, proto, dv, kp


def probe_edges():
    """table_stream's scalar kernel and K5's edge cases, bit for bit against
    their plain versions (comparison launches, after the counted run)."""
    from hpclinalg_torch.ops import cuda_dia_probe as k4
    from hpclinalg_torch.ops import cuda_kpayload as k5
    from hpclinalg_torch.tools.dia_variants import TR

    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(SEED + 12)
    O, ntiles = 5, 31
    flat = torch.from_numpy(rng.standard_normal(ntiles * O * TR + 8,
                                                dtype=np.float32)).to(dev)
    c = torch.full((1,), 0.5, dtype=torch.float32, device=dev)
    for what, args in (
            ("odd row stride", (flat, c, ntiles, TR, O, O * TR, TR + 1, 1.0,
                                1)),
            ("table 4 bytes off 16, depth 2", (flat[1:], c, ntiles, TR, O,
                                               O * TR, TR, 1.0, 2))):
        y = k4.table_stream(*args)
        vec = k4.stream_vector_width(args[0], TR, args[5], args[6], y)
        check(vec == 1 and torch.equal(y, k4.table_stream_plain(*args)),
              f"table_stream's scalar kernel at {what} ({ntiles} tiles of "
              f"{TR}, R = {O}) equals its plain version bit for bit")
    for k, F, ntiles, one in ((1, 1, 5, False), (13, 8, 300, True),
                              (9, 255, 40, False)):
        src = torch.from_numpy(rng.standard_normal(
            (ntiles, F, k, 128), dtype=np.float32)).to(dev)
        idx = rng.integers(0, 128, (ntiles, 1, 128)).astype(np.int8)
        sel = rng.integers(0, F, (ntiles, 1, 128)).astype(np.uint8)
        if one:     # every lane in sector 5 of plane 0
            idx, sel = (idx % 8 + 40).astype(np.int8), sel * 0
        k5.check_tables(idx, sel, F)
        idx, sel = torch.from_numpy(idx).to(dev), torch.from_numpy(sel).to(dev)
        check(torch.equal(k5.kpayload(src, idx, sel),
                          k5.kpayload_plain(src, idx, sel)),
              f"K5 at k={k} F={F} {ntiles} tiles"
              + (" with every lane in one sector" if one else "")
              + " equals its plain version bit for bit")


def probe_bounds(dv, proto, kp, timer, card, csr_ms):
    """Each probe beside its bound and its library call: cuSPARSE's CSR
    SpMV on the same Laplacian (``csr_ms`` by k) for the variants that
    compute a DIA SpMV; for table_stream the call dia_variants timed
    (``torch.add`` for skern, ``torch.baddbmm`` for v3 and v5); for K5 the
    one advanced-indexing call ``src[t, sel, j, idx]`` on widened tables,
    timed here, and K5's floors from probe_kpayload. Returns K5's library
    time."""
    from hpclinalg_torch.tools.dia_variants import TR

    def need(name, rec):
        n, O = rec["n"], rec["O"]
        if name == "skern":          # one table row read, y written
            return 2 * -(-n // TR) * TR * 4
        if name[:2] in ("v3", "v5"):  # O table rows read, y written
            return (O + 1) * n * 4
        return (O + 2) * n * 4       # an SpMV: the table, x and y once
    recs = [(2000, "proto_dia (K1 through A @ x)", "k1", proto)] + [
        (k, name, name, rec) for k, rows in dv.items()
        for name, rec in rows.items() if "plain_ms" in rec]
    for k, label, name, rec in recs:
        lib = rec.get("lib_ms", csr_ms[k])
        case_line(f"probe k={k} {label} float32", rec["ms"], rec["plain_ms"],
                  lib, need(name, rec), 0.0, torch.float32, card)
    src, idx, sel = kp.pop("inputs")
    dev = src.device
    t = torch.arange(src.shape[0], device=dev)[:, None, None]
    j = torch.arange(src.shape[2], device=dev)[None, :, None]
    sl, il = sel.long(), idx.long()
    lib = min(timer.ms(lambda: src[t, sl, j, il]) for _ in range(2))
    case_line(f"K5 kpayload k={kp['k']} F={kp['F']} float32", kp["ms"],
              kp["plain_ms"], lib, kp["bound_bytes"], 0.0, torch.float32, card)
    print(f"  K5 against its floors: sector floor {kp['sector_floor_ms']:.4f}"
          f" ms ({100 * kp['sector_floor_ms'] / kp['ms']:.0f} % of it), "
          f"64-byte floor {kp['granule_floor_ms']:.4f} ms, granule control "
          f"{kp['even_ms']:.4f} ms, floor (i) every plane whole "
          f"{kp['floor1_ms']:.4f} ms, floor (ii) the touched sectors by "
          f"index_select {kp['floor2_ms']:.4f} ms  [{card}]", flush=True)
    return lib


def peak_mb(fn):
    """(result of fn, device memory it allocated at its peak above what
    was allocated before, in MB)."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    return out, (torch.cuda.max_memory_allocated() - base) / 2 ** 20


DEV_K = 512            # laplace2d(512), n = 262,144: bench.py's device factor
DEV_K_SMALL = 256      # the LDL, LU and multi-RHS cases
DEV_K_COMPLEX = 64     # the complex-symmetric case
DEV_MULTI_K = 8        # right-hand sides of the multi-RHS case
CHAIN_N = 4000         # the tridiagonal chain tree that falls back to host


def timed_ms(fn, n):
    """Median over n calls of fn's wall time in ms, the queue drained
    before and after each."""
    return float(np.median([timed_s(fn)[1] for _ in range(n)])) * 1e3


def rel_res(M, x, b):
    return float(np.linalg.norm(M @ x - b) / np.linalg.norm(b))


def graph_info(F):
    """{graph: {"capture_s", "instantiate_s", "nodes": {type: count}}} of a
    device factorization's factor graph and each of its solve graphs
    (``solve_k<width>``, ``_t`` transposed); the kernel nodes are the
    launches of one replay."""
    from hpclinalg_torch.tools.timing import graph_nodes

    def one(step):
        return {**step.times, "nodes": graph_nodes(step.graph)}

    return {"factor": one(F._factor_graph),
            **{f"solve_k{k}{'_t' if t else ''}": one(g)
               for (k, t), g in sorted(F._solve_graphs.items())}}


def storage_mib(tree):
    """MiB of the storages that the tensors of ``tree`` (nested lists
    and tuples, None allowed) hold, each storage once."""
    seen = {}

    def walk(t):
        if isinstance(t, torch.Tensor):
            st = t.untyped_storage()
            seen[st.data_ptr()] = st.nbytes()
        elif isinstance(t, (list, tuple)):
            for u in t:
                walk(u)

    walk(tree)
    return sum(seen.values()) / 2 ** 20


def rel_gap(a, b):
    """max |a - b| over max |b|."""
    return float((a - b).abs().max() / b.abs().max())


def phase9_device_solver(ht, dev, card, times, timer):
    """The device multifrontal solver through the public API, f64 unless
    said: ldlt(method="device", spd=True) on laplace2d(512) at S = 1 and 4
    against the host engine, its factor and solve graphs against the eager
    bodies, an indefinite LDL, an LU with its transposed solve, a
    multi-RHS solve and a complex-symmetric LDL at the smaller sizes, all
    through their graphs, and the solver="device" routing. Returns the
    launches of K1 and of K2's gather mode over the phase."""
    import warnings

    from hpclinalg_torch.ops import cuda_dia, cuda_ell
    from hpclinalg_torch.parallel.mesh import allgather_full
    from hpclinalg_torch.solver import device_mf
    from hpclinalg_torch.tools.timing import graph_nodes

    launches = {"dia": 0, "gather": 0}

    def counted(fn):
        """fn() with the K1 and gather counts set to 0 just before and read
        just after; returns (result, the counts)."""
        cuda_dia.dia_spmv.launches = 0
        cuda_ell.gather.launches = 0
        out = fn()
        c = {"dia": cuda_dia.dia_spmv.launches,
             "gather": cuda_ell.gather.launches}
        for key in launches:
            launches[key] += c[key]
        return out, c

    def named(kernels):
        """[(kernel name cut before its template arguments, µs)]."""
        return [(nm.replace("void ", "").replace("(anonymous namespace)::", "")
                 .split("<")[0].split("(")[0], round(us, 1))
                for nm, us in kernels]

    def extend_add_elements(eng):
        """(elements the extend-add scatters a factor, those of them that
        are padding: masked zeros at spread slots), from the plan."""
        total = pad = 0
        for m in eng.local_levels + eng.top_levels:
            for _lc, _srcb, _dstb, psl in m.ea:
                live = (psl >= 0).sum(-1)
                total += psl.shape[-1] ** 2 * live.numel()
                pad += psl.shape[-1] ** 2 * live.numel() - int((live ** 2).sum())
        return total, pad

    def on_card(F):
        return all(x.device == dev for fac in F.factors[0] + F.factors[1]
                   for x in fac)

    def graphed(F, A, what):
        """F (of A) factored through its graph, each solve through one of
        its solve graphs; returns graph_info(F) with the host-clock ms of
        F.refactorize(A) (one replay) and of the eager bodies it replays
        (device_mf._factor_program, one call)."""
        info = graph_info(F)
        check(F.refusal is None and F._factor_graph is not None
              and F._solve_graphs,
              f"{what}: factored by a graph replay ({info['factor']['nodes']}"
              f" nodes, captured in {info['factor']['capture_s']:.2f} s, "
              f"instantiated in {info['factor']['instantiate_s']:.2f} s), "
              f"solved by replays of {sorted(F._solve_graphs)}")
        Av = allgather_full(A.nzval, np.concatenate(
            [[0], np.cumsum(A.structure.nnz_local)]), A.backend)
        eps_t = device_mf._pert_eps(Av, F.engine.dtype.to_real())
        Av = Av.to(F.engine.dtype)
        info["refactorize_ms"] = timed_ms(lambda: F.refactorize(A), 3)
        info["eager_factor_program_ms"] = timed_ms(
            lambda: device_mf._factor_program(F.engine, Av, eps_t), 1)
        print(f"  {what}: refactorize (a graph replay) "
              f"{info['refactorize_ms']:.2f} ms, the eager bodies "
              f"{info['eager_factor_program_ms']:.2f} ms  [{card}]",
              flush=True)
        return info

    record = {}
    # a silent host solve must fail the device cases: the fallback's
    # warning is an error here
    with warnings.catch_warnings():
        warnings.filterwarnings("error",
                                message="device multifrontal unavailable")
        L = laplace2d(DEV_K)
        n = L.shape[0]
        bh = np.random.default_rng(SEED + 20).standard_normal(n)
        for S in (1, 4):
            be = ht.backend_auto(S, dtype=np.float64, device=dev)
            A = ht.DistSparseMatrix.from_scipy(L, be)
            b = ht.DistVector.from_global(bh, be)
            eng, plan_s = timed_s(lambda: device_mf.device_engine(
                A, "chol", np.float64))
            nnzb = np.concatenate([[0], np.cumsum(A.structure.nnz_local)])

            def eager_numeric():
                # DeviceFactorization._numeric's eager path on this engine:
                # the values gathered, eps, the factor program, its read
                Av = allgather_full(A.nzval, nnzb, be)
                eps_ = device_mf._pert_eps(Av, torch.float64)
                return device_mf._factor_program(eng, Av, eps_)[3].tolist()

            # a one-shot factorization: the eager path first, so that it,
            # not the graphed ldlt after it, pays the engine's first use
            _, eager_first_s = timed_s(eager_numeric)
            # the cache emptied before and (by the capture) during the
            # ldlt: what it adds is the factor graph's pool, with the
            # factors, and what the warm-up left allocated
            torch.cuda.empty_cache()
            reserved0 = torch.cuda.memory_reserved() / 2 ** 20
            F, first_s = timed_s(lambda: ht.ldlt(A, method="device",
                                                 spd=True))
            reserved = torch.cuda.memory_reserved() / 2 ** 20
            _, eager_warm_s = timed_s(eager_numeric)
            check(isinstance(F, device_mf.DeviceFactorization)
                  and F.engine is eng and on_card(F),
                  f"laplace2d({DEV_K}) S={S}: ldlt(method='device', "
                  f"spd=True) is a DeviceFactorization with its factors on "
                  f"the card ({len(eng.local_levels)} local + "
                  f"{len(eng.top_levels)} top levels, TOPM {eng.TOPM})")
            Avals = allgather_full(A.nzval, nnzb, be)
            eps = 1e-10 * float(A.nzval.abs().max())
            fac_ms = timed_ms(lambda: eng.factor(Avals, eps), 3)
            _, peak = peak_mb(lambda: eng.factor(Avals, eps))
            fbusy_us, nlaunch = device_us(lambda: eng.factor(Avals, eps))
            top = named(device_kernels(lambda: eng.factor(Avals, eps), top=6))
            Fh = ht.ldlt(A)
            host_ms = timed_ms(lambda: Fh.refactorize(A), 3)
            xhost = Fh.solve(bh)
            sweeps = []
            solve_dist = F._solve_dist
            F._solve_dist = lambda *a, **k: (sweeps.append(1),
                                             solve_dist(*a, **k))[1]
            try:
                (x, c), first_solve_s = timed_s(
                    lambda: counted(lambda: F.solve(b).to_numpy()))
            finally:
                del F._solve_dist
            res = rel_res(L, x, bh)
            gap = float(np.linalg.norm(x - xhost) / np.linalg.norm(xhost))
            check(res <= 1e-10 and gap <= 1e-9,
                  f"laplace2d({DEV_K}) S={S} device solve: residual "
                  f"{res:.2e} <= 1e-10, {gap:.2e} <= 1e-9 from the host "
                  f"engine's solution ({len(sweeps) - 1} refinement "
                  f"sweeps)")
            check(c["dia"] > 0 and c["gather"] > 0,
                  f"the solve launched K1 {c['dia']} times (refinement) and "
                  f"K2's gather mode {c['gather']} times (in/out plans)")
            solve_ms = timed_ms(lambda: F.solve(b, refine=0), 5)
            default_ms = timed_ms(lambda: F.solve(b), 3)
            sbusy_us, slaunch = device_us(lambda: F.solve(b, refine=0))
            stop = named(device_kernels(lambda: F.solve(b, refine=0), top=6))
            ea_total, ea_pad = extend_add_elements(eng)
            # the graphs against the eager bodies, in turns, CUDA events:
            # the factor graph holds eng.factor, the inversion and the
            # counts (device_mf._factor_program), the solve graph the
            # solve's in-plan, sweeps and out-plan
            fg, sg = F._factor_graph, F._solve_graphs[(1, False)]
            eps_t = device_mf._pert_eps(Avals, torch.float64)
            b3 = b.data[:, :, None]
            g_ms, prog_ms, eng_ms = timer.turns(
                lambda: fg(Avals, eps_t),
                lambda: device_mf._factor_program(eng, Avals, eps_t),
                lambda: eng.factor(Avals, eps))
            refac_ms = timed_ms(lambda: F.refactorize(A), 3)
            check(F._factor_graph is fg and F.refusal is None,
                  f"laplace2d({DEV_K}) S={S}: refactorize replays the "
                  f"factor graph, no new capture ({refac_ms:.2f} ms)")
            prepped = [eng.invert(*eng.factor(Avals, eps)[:2])
                       for _ in range(2)]
            xe = [eng.solve_prepped(p, b3)[:, :, 0] for p in prepped]
            xg = F._solve_dist(b.data, False)
            spread, ggap = rel_gap(xe[1], xe[0]), rel_gap(xg, xe[0])
            check(ggap <= 1e-12,
                  f"laplace2d({DEV_K}) S={S}: the graphed factor and solve "
                  f"(refine=0) within {ggap:.2e} <= 1e-12 of the eager "
                  f"bodies' solution (eager against eager: {spread:.2e})")
            gs_ms, es_ms = timer.turns(
                lambda: F._solve_dist(b.data, False),
                lambda: eng.solve_prepped(prepped[0], b3))
            # K2's gather in the solve: the eager body's launches, which
            # the solve graph must hold and add at each replay
            cuda_ell.gather.launches = 0
            eng.solve_prepped(prepped[0], b3)
            eager_gathers = cuda_ell.gather.launches
            check(sg.held.get(cuda_ell.gather, 0) == eager_gathers > 0,
                  f"laplace2d({DEV_K}) S={S}: the solve graph holds K2's "
                  f"gather {sg.held.get(cuda_ell.gather)} times, the "
                  f"eager solve launches it {eager_gathers} times; each "
                  "replay adds them to the count")
            del prepped, xe
            gbusy_us, _ = device_us(lambda: fg.graph.replay())
            sev = device_events(lambda: sg.graph.replay())
            gsbusy_us = busy_us(sev)
            # K2's gather mode in a solve replay's trace (the profiler's
            # count, which can fall short of the graph's kernels)
            sgathers = sum("gather_rows" in e.name for e in sev)
            fnodes, snodes = graph_nodes(fg.graph), graph_nodes(sg.graph)
            rec = {"host_ldlt_factor_262k_ms": host_ms,
                   "device_chol_factor_262k_ms": fac_ms,
                   "device_solve_262k_ms": solve_ms,
                   "device_solve_default_262k_ms": default_ms,
                   "refine_sweeps": len(sweeps) - 1,
                   "plan_build_s": plan_s, "first_ldlt_s": first_s,
                   # the eager path's one-shot factorization on this
                   # engine, before the ldlt (the engine's first use) and
                   # after it; the first solve (its graph captured, then
                   # the refinement's replays)
                   "eager_first_factor_s": eager_first_s,
                   "eager_warm_factor_s": eager_warm_s,
                   "first_solve_s": first_solve_s,
                   "factors_mib": storage_mib(F.factors[:2] + (F._prepped,)),
                   "factor_launches": nlaunch,
                   # None: not measured (the trace held no device activity)
                   "factor_device_ms": fbusy_us / 1e3 if nlaunch else None,
                   "factor_busy_share":
                       fbusy_us / 1e3 / fac_ms if nlaunch else None,
                   "factor_peak_mib": peak,
                   "max_memory_allocated_mib":
                       torch.cuda.max_memory_allocated() / 2 ** 20,
                   "factor_top_kernels_us": top,
                   "extend_add_elements": ea_total,
                   "extend_add_padding": ea_pad,
                   "solve_launches": slaunch,
                   "solve_device_ms": sbusy_us / 1e3 if slaunch else None,
                   "solve_busy_share":
                       sbusy_us / 1e3 / solve_ms if slaunch else None,
                   "solve_top_kernels_us": stop,
                   # events, in turns: the factor graph's call (values
                   # copied in, one replay), the eager bodies it holds, and
                   # eng.factor alone; the solve graph's call (RHS copied
                   # in, a replay, the result cloned) and its eager body
                   "graph_factor_ms": g_ms, "eager_factor_program_ms": prog_ms,
                   "eager_factor_ms": eng_ms, "refactorize_ms": refac_ms,
                   "graph_solve_ms": gs_ms, "eager_solve_ms": es_ms,
                   "graph_factor_launches": fnodes.get("kernel", 0),
                   "graph_factor_nodes": fnodes,
                   "graph_factor_device_ms":
                       gbusy_us / 1e3 if gbusy_us else None,
                   "graph_solve_launches": snodes.get("kernel", 0),
                   "graph_solve_gather_launches":
                       sg.held.get(cuda_ell.gather, 0),
                   "graph_solve_gather_in_trace": sgathers,
                   "graph_solve_events_in_trace": len(sev),
                   "graph_solve_nodes": snodes,
                   "graph_solve_device_ms":
                       gsbusy_us / 1e3 if gsbusy_us else None,
                   "factor_capture_s": fg.times["capture_s"],
                   "factor_instantiate_s": fg.times["instantiate_s"],
                   "solve_capture_s": sg.times["capture_s"],
                   "solve_instantiate_s": sg.times["instantiate_s"],
                   "memory_reserved_before_ldlt_mib": reserved0,
                   "memory_reserved_after_capture_mib": reserved,
                   "graph_vs_eager_rel": ggap, "eager_vs_eager_rel": spread}
            record[f"chol_262k_S{S}"] = rec
            print(f"  262k Cholesky S={S} [{card}]: " + json.dumps(rec),
                  flush=True)
            del F, Fh, eng, Avals, fg, sg
            ht.clear_plan_cache("device_mf")
            torch.cuda.empty_cache()

        # indefinite LDL and the multi-RHS solve on N = laplace2d(256) - sI
        k2 = DEV_K_SMALL
        n2 = k2 * k2
        sig = between_eigenvalues(k2, 0.5)
        N = (laplace2d(k2) - sig * sp.eye(n2)).tocsr()
        be = ht.backend_auto(1, dtype=np.float64, device=dev)
        Nd = ht.DistSparseMatrix.from_scipy(N, be)
        b2h = np.random.default_rng(SEED + 21).standard_normal(n2)
        F, t_f = timed_s(lambda: ht.ldlt(Nd, method="device"))
        (x, c) = counted(lambda: F.solve(ht.DistVector.from_global(
            b2h, be)).to_numpy())
        res = rel_res(N, x, b2h)
        check(res <= 1e-8 and c["dia"] > 0,
              f"indefinite LDL laplace2d({k2}) - {sig:.6f} I: residual "
              f"{res:.2e} <= 1e-8, n_perturbed {F.n_perturbed}, growth "
              f"{F.growth:.4e}, factor + plan {t_f:.2f} s")
        Bh = np.random.default_rng(SEED + 22).standard_normal(
            (n2, DEV_MULTI_K))
        Bd = ht.DistDenseMatrix.from_global(Bh, be)
        X, c = counted(lambda: F.solve_matrix(Bd))
        R = Nd @ X - Bd
        res_k = float(R.norm()) / float(Bd.norm())
        check(isinstance(X, ht.DistDenseMatrix) and res_k <= 1e-8
              and (DEV_MULTI_K, False) in F._solve_graphs,
              f"multi-RHS solve_matrix k={DEV_MULTI_K} on N through its own "
              f"solve graph: residual through N @ X {res_k:.2e} <= 1e-8")
        record["ldl_indefinite"] = {
            "n_perturbed": F.n_perturbed, "growth": F.growth,
            "residual": res, "residual_k8": res_k, "first_ldlt_s": t_f,
            "graphs": graphed(F, Nd, f"indefinite LDL laplace2d({k2})")}
        del F

        # LU on unsymmetric values over laplace2d(256)'s own pattern (a
        # random perturbation of the pattern at this n would fill the
        # factor densely), with its transposed solve, S = 4
        Lu = laplace2d(k2)
        Lu.data = Lu.data * (1.0 + 0.2 * np.random.default_rng(SEED + 23)
                             .random(Lu.nnz))
        be4 = ht.backend_auto(4, dtype=np.float64, device=dev)
        Ud = ht.DistSparseMatrix.from_scipy(Lu, be4)
        F, t_f = timed_s(lambda: ht.lu(Ud, method="device"))
        bu = ht.DistVector.from_global(b2h, be4)
        (x, c) = counted(lambda: F.solve(bu).to_numpy())
        xt = F.solve(bu, transpose=True).to_numpy()
        res, rest = rel_res(Lu, x, b2h), rel_res(Lu.T, xt, b2h)
        check(isinstance(F, device_mf.DeviceFactorization) and on_card(F)
              and res <= 1e-9 and rest <= 1e-9
              and (1, True) in F._solve_graphs,
              f"LU laplace2d({k2}) unsymmetric values S=4: residual "
              f"{res:.2e}, transposed {rest:.2e} <= 1e-9 (n_perturbed "
              f"{F.n_perturbed}, factor + plan {t_f:.2f} s)")
        record["lu_S4"] = {"residual": res, "residual_t": rest,
                           "first_lu_s": t_f,
                           "graphs": graphed(F, Ud,
                                             f"LU laplace2d({k2}) S=4")}
        del F

        # complex-symmetric LDL, c128, S = 4: the complex payloads cross
        # the exchange as real pairs, and K1 takes them in its c128
        # instantiation (phase 11 drives the complex path at full size)
        kc = DEV_K_COMPLEX
        Ac = (laplace2d(kc).astype(np.complex128)
              + 0.4j * sp.eye(kc * kc)).tocsr()
        bec = ht.backend_auto(4, dtype=np.complex128, device=dev)
        Acd = ht.DistSparseMatrix.from_scipy(Ac, bec)
        rng = np.random.default_rng(SEED + 24)
        bch = rng.standard_normal(kc * kc) + 1j * rng.standard_normal(kc * kc)
        F = ht.ldlt(Acd, method="device")
        (x, c) = counted(lambda: F.solve(ht.DistVector.from_global(
            bch, bec)).to_numpy())
        res = rel_res(Ac, x, bch)
        check(F.factors[0][0][0].dtype == torch.complex128 and on_card(F)
              and res <= 1e-10 and c["gather"] > 0 and c["dia"] > 0,
              f"complex-symmetric LDL laplace2d({kc}) + 0.4i I c128 S=4: "
              f"residual {res:.2e} <= 1e-10 (gather {c['gather']}, K1 "
              f"{c['dia']} launches)")
        record["ldl_c128_S4"] = {"residual": res, "graphs": graphed(
            F, Acd, f"c128 LDL laplace2d({kc}) S=4")}
        del F

        # routing: a solver="device" backend through ht.solve, then new
        # values on the same pattern: a refactorize-only cache hit
        bed = ht.backend_auto(1, dtype=np.float64, device=dev,
                              solver="device")
        Ld = ht.DistSparseMatrix.from_scipy(laplace2d(k2), bed)
        bd = ht.DistVector.from_global(b2h, bed)
        ht.clear_plan_cache("backslash")
        x1 = ht.solve(Ld, bd).to_numpy()
        cache = ht.BackslashCache._cache()
        F1 = next(iter(cache.values()))
        fg1 = F1._factor_graph
        Ld2 = Ld * 2.0
        x2 = ht.solve(Ld2, bd).to_numpy()
        res1 = rel_res(laplace2d(k2), x1, b2h)
        res2 = rel_res(2.0 * laplace2d(k2), x2, b2h)
        check(isinstance(F1, device_mf.DeviceFactorization)
              and len(cache) == 1 and next(iter(cache.values())) is F1
              and F1.A is Ld2 and max(res1, res2) <= 1e-10
              and fg1 is not None and F1._factor_graph is fg1,
              f"solver='device' backend: ht.solve took the device engine, "
              f"new values a refactorize-only hit that replayed its factor "
              f"graph (residuals {res1:.2e}, {res2:.2e})")
    # the chain tree takes the host engine, with the warning
    T = sp.diags([-1.0, 2.0, -1.0], [-1, 0, 1],
                 shape=(CHAIN_N, CHAIN_N)).tocsr()
    Td = ht.DistSparseMatrix.from_scipy(T, bed)
    bth = np.random.default_rng(SEED + 25).standard_normal(CHAIN_N)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        xc = ht.solve(Td, ht.DistVector.from_global(bth, bed)).to_numpy()
    Fc = [F for key, F in cache.items() if key[0] == Td.hash]
    res = rel_res(T, xc, bth)
    check(any("host" in str(w.message) for w in caught) and len(Fc) == 1
          and isinstance(Fc[0], ht.Factorization) and res <= 1e-10,
          f"tridiagonal chain tree n={CHAIN_N}: warned and took the host "
          f"engine (residual {res:.2e})")
    ht.clear_plan_cache("backslash")
    ht.clear_plan_cache("device_mf")
    times["phase9"] = record
    return launches


def phase10_kkt(card, times):
    """The saddle-point assembly (python -m hpclinalg_torch.tools.kkt) on the
    card at S = 1 and 4, f64, in a process of its own: the profiler is
    reliable only in a process's first sessions (PERF.md), and this one
    traces one K @ z and the cached pass. Returns the launches of K1, K2,
    K2's gather mode and K3 it counted over its drives (each count set to
    0 just before and read just after)."""
    import os

    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=root + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run(
        [sys.executable, "-m", "hpclinalg_torch.tools.kkt", str(K),
         str(KKT_M), "--trace", os.path.join(root, "build", "traces")],
        cwd=root, env=env, capture_output=True, text=True, timeout=900)
    print(proc.stdout, end="", flush=True)
    if proc.returncode != 0:
        print(proc.stderr, file=sys.stderr, flush=True)
        raise RuntimeError(f"chip_smoke check failed: phase 10 exited "
                           f"{proc.returncode}")
    record = json.loads(proc.stdout.strip().splitlines()[-1])
    times["phase10"] = record
    check(record["card"] == card, f"phase 10 ran on {card}")
    return record["launches"]


def phase8_dense(ht, dev, R8, L1000, Ab, timer, card, times):
    """The dense path through the public API, f64 (and the random SpMM in
    f32), at S = 1 and 4."""
    from hpclinalg_torch.ops import spmv as spmv_mod

    rng = np.random.default_rng(SEED + 9)
    X = rng.standard_normal((N, SPMM_K))
    ref_r8 = R8 @ X
    X8 = rng.standard_normal((N, 8))
    ref_l = L1000 @ X8
    Y = rng.standard_normal((RIDGE_M, SPMM_K))
    AtY = Ab.T @ Y
    D = rng.standard_normal((DENSE_M, DENSE_N))
    E = rng.standard_normal((DENSE_N, SPMM_K))
    v = rng.standard_normal(DENSE_N)
    w = rng.standard_normal(DENSE_M)
    Bsp = random_cols(DENSE_N, 2048, 16, SEED + 10)
    for S in (1, 4):
        for dt in (torch.float64, torch.float32):
            npdt = np.float64 if dt == torch.float64 else np.float32
            be = ht.backend_auto(S, dtype=npdt, device=dev)
            Ar = ht.DistSparseMatrix.from_scipy(R8, be)
            Xd = ht.DistDenseMatrix.from_global(X, be)
            C, mb = peak_mb(lambda: Ar @ Xd)
            plan = spmv_mod.get_spmm_plan(Ar, Xd)
            ok, err = close(torch.from_numpy(C.to_numpy()).double(),
                            torch.from_numpy(ref_r8), SPMM_RTOL[dt])
            check(ok and plan.ell and isinstance(C, ht.DistDenseMatrix),
                  f"S={S} {dt}: random {N} x 8 @ {N} x {SPMM_K} on the ELL "
                  f"engine (W={plan.ell_W}) against scipy, max_abs_err "
                  f"{err:.3e} (rtol {SPMM_RTOL[dt]:g} of max|C|)")
            tag = f"S{S}_{str(dt).replace('torch.', '')}"
            times[f"spmm_random_k64_{tag}_ms"] = timer.ms(lambda: Ar @ Xd)
            times[f"spmm_random_k64_{tag}_peak_mb"] = mb
            if dt == torch.float64:
                for name, us in device_kernels(lambda: Ar @ Xd):
                    print(f"  SpMM S={S} f64 device time: {us:9.1f} us  "
                          f"{name[:70]}", flush=True)
            del C, Xd
        be = ht.backend_auto(S, dtype=np.float64, device=dev)
        Ld = ht.DistSparseMatrix.from_scipy(L1000, be)
        Cl = Ld @ ht.DistDenseMatrix.from_global(X8, be)
        ok, err = close(torch.from_numpy(Cl.to_numpy()),
                        torch.from_numpy(ref_l), 1e-12)
        check(ok and spmv_mod.get_spmm_plan(Ld, Cl).offsets is not None,
              f"S={S}: laplace2d({K}) @ {N} x 8 on the DIA engine against "
              f"scipy, max_abs_err {err:.3e}")

        # the multi-response ridge on phase 6's A and N
        Ad = ht.DistSparseMatrix.from_scipy(Ab, be)
        At = Ad.T.materialize()
        Nm = (At @ Ad).add_identity(RIDGE_LAMBDA)
        Yd = ht.DistDenseMatrix.from_global(Y, be)
        R, mb = peak_mb(lambda: At @ Yd)
        ok, err = close(torch.from_numpy(R.to_numpy()), torch.from_numpy(AtY),
                        1e-12)
        check(ok and spmv_mod.get_spmm_plan(At, Yd).ell,
              f"S={S}: R = At @ Y on the ELL engine against scipy, "
              f"max_abs_err {err:.3e}")
        times[f"ridge_S{S}_AtY_ms"] = timer.ms(lambda: At @ Yd)
        for name, us in device_kernels(lambda: At @ Yd):
            print(f"  At @ Y S={S} device time: {us:9.1f} us  {name[:70]}",
                  flush=True)
        times[f"ridge_S{S}_AtY_peak_mb"] = mb
        ht.clear_plan_cache("backslash")
        Xh, times[f"ridge_S{S}_multi_rhs_first_s"] = timed_s(
            lambda: ht.solve(Nm, R))
        _, times[f"ridge_S{S}_multi_rhs_cached_s"] = timed_s(
            lambda: ht.solve(Nm, R))
        res = float((Nm @ Xh - R).norm() / R.norm())
        check(isinstance(Xh, ht.DistDenseMatrix)
              and np.array_equal(Xh.row_partition, Nm.row_partition)
              and res <= RIDGE_RES_TOL,
              f"S={S}: Xh = solve(N, R) is a DistDenseMatrix on N's rows; "
              f"|N Xh - R| / |R| = {res:.3e} (<= {RIDGE_RES_TOL:g})")
        Xn = Xh.to_numpy()
        G = Xh.T @ Xh
        ok, err = close(torch.from_numpy(G.to_numpy()),
                        torch.from_numpy(Xn.T @ Xn), 1e-12)
        check(ok and G.shape == (SPMM_K, SPMM_K),
              f"S={S}: Xh.T @ Xh against numpy, max_abs_err {err:.3e}")
        Res = Ad @ Xh - Yd
        ok, err = close(torch.from_numpy(Res.to_numpy()),
                        torch.from_numpy(Ab @ Xn - Y), 1e-12)
        check(ok, f"S={S}: A @ Xh - Y against scipy, max_abs_err {err:.3e}")
        del Yd, R, Res

        # dense operations on a 10^4 x 512 D
        Dd = ht.DistDenseMatrix.from_global(D, be)
        got = {
            "D @ v": ((Dd @ ht.DistVector.from_global(v, be)).to_numpy(),
                      D @ v),
            "D.T @ w": ((Dd.T @ ht.DistVector.from_global(w, be)).to_numpy(),
                        D.T @ w),
            "D @ E": ((Dd @ ht.DistDenseMatrix.from_global(E, be)).to_numpy(),
                      D @ E),
            "D @ B_sp": ((Dd @ ht.DistSparseMatrix.from_scipy(Bsp, be))
                         .to_numpy(), D @ Bsp.toarray()),
        }
        for what, (a, b) in got.items():
            ok, err = close(torch.from_numpy(a), torch.from_numpy(b), 1e-12)
            check(ok, f"S={S}: {what} against numpy, max_abs_err {err:.3e}")
    for k_, v_ in times.items():
        if k_.startswith(("spmm_", "ridge_S1_AtY", "ridge_S4_AtY",
                          "ridge_S1_multi", "ridge_S4_multi")):
            print(f"  {k_}: {v_:.4f}  [{card}]", flush=True)


# ---- phase 11: complex values on the card ----------------------------------

CPLX = ((torch.complex128, np.complex128), (torch.complex64, np.complex64))
# products held to the rtol of their parts' type (K1_RTOL, K2_RTOL)
CPLX_RTOL = {torch.complex128: K2_RTOL[torch.float64],
             torch.complex64: K2_RTOL[torch.float32]}
HELM_K = 1000          # Helmholtz(1000), n = 10^6: K1's complex instantiation
HELM_DEV_K = 256       # Helmholtz(256), n = 65,536: the complex device LDL
                       # (512 until phase 14 needed its time: PERF.md 4)
LU_K = 256             # the permuted laplace2d(256) of the complex device LU
CAP_ROWS = 300_000     # rows of the at-the-cap matrices (random_cols)
# residual bounds of the device solves: c128 as phase 9's, c64 as the JAX
# package's tests/test_cplx.py
CPLX_RES = {torch.complex128: 1e-10, torch.complex64: 1e-4}


def tag(dt):
    return {torch.complex128: "c128", torch.complex64: "c64"}[dt]


def cplx_vec(rng, n):
    return rng.standard_normal(n) + 1j * rng.standard_normal(n)


def rounded(a, npdt):
    """a rounded to npdt and widened back to complex128: the inputs a run in
    npdt sees, for a reference computed in complex128."""
    if sp.issparse(a):
        return a.astype(npdt).astype(np.complex128)
    return np.asarray(a).astype(npdt).astype(np.complex128)


def held_to(ref, got, dt, what, scale=None):
    """``got`` (numpy) against the complex128 reference ``ref`` within
    CPLX_RTOL[dt] of max|ref|, or of ``scale`` where given (a sum's
    condition, the sum of its terms' magnitudes); returns max_abs_err."""
    got = np.asarray(got, np.complex128)
    ref = np.asarray(ref, np.complex128)
    err = float(np.abs(got - ref).max())
    s = float(np.abs(ref).max()) if scale is None else scale
    check(err <= CPLX_RTOL[dt] * s, f"{what} against scipy/numpy, "
          f"max_abs_err {err:.3e} (rtol {CPLX_RTOL[dt]:g} of "
          f"{'max|ref|' if scale is None else 'the sum of |terms|'})")
    return err


def csr_checked(M, dt, dev, xh, ref):
    """``csr_call`` in a complex dtype (cuSPARSE's complex CSR SpMV), its
    result checked against ``ref``."""
    f = csr_call(M, dt, dev, xh)
    held_to(ref, f().cpu().numpy(), dt,
            f"the library call (CSR SpMV) {dt}")
    return f


def phase11_complex(ht, dev, R8, PL, N_sc, timer, card, times):
    """Complex values on the card through the public API: K1, K2 (rows and
    tail) and K3 each in c64 and c128 in one launch, held against their
    plain versions and scipy; the complex device LDL and LU; their times.
    Returns (launches by kernel and type, max_abs_err by kernel and type,
    the timed c128 cases by kernel)."""
    import warnings

    from hpclinalg_torch.ops import cuda_dia, cuda_ell
    from hpclinalg_torch.ops import cuda_ell_resident as k3
    from hpclinalg_torch.ops import spmv as spmv_mod
    from hpclinalg_torch.parallel.mesh import allgather_full
    from hpclinalg_torch.solver import device_mf

    kernels = {"dia": cuda_dia.dia_spmv, "ell": cuda_ell.ell_spmv,
               "resident": k3.ell_resident_spmv}
    launches = {key: {"c64": 0, "c128": 0} for key in kernels}
    errs = {key: {"c64": 0.0, "c128": 0.0} for key in kernels}
    bench = {}
    rng = np.random.default_rng(SEED + 40)

    def drive(dt, fn):
        """fn() with the launch counts set to 0 just before and read just
        after, added to dt's; returns (result, the counts)."""
        torch.cuda.synchronize()
        for f in kernels.values():
            f.launches = 0
        out = fn()
        torch.cuda.synchronize()
        c = {key: f.launches for key, f in kernels.items()}
        for key, v in c.items():
            launches[key][tag(dt)] += v
        return out, c

    def held(key, label, dt, yk, yp):
        torch.cuda.synchronize()
        ok, err = close(yk, yp, CPLX_RTOL[dt])
        errs[key][tag(dt)] = max(errs[key][tag(dt)], err)
        check(ok and yk.dtype == dt, f"{label} {tag(dt)}: the kernel's "
              f"{yk.dtype} against its plain version, max_abs_err "
              f"{err:.3e} (rtol {CPLX_RTOL[dt]:g} of max|y|)")

    # (a) Helmholtz(1000), K1 ------------------------------------------------
    cap = k3.smem_cap(dev)
    H = helmholtz(HELM_K)
    n = max(H.shape[0], R8.shape[1], PL.shape[1], cap // 8)
    zh, wh = cplx_vec(rng, n)[: H.shape[0]], cplx_vec(rng, H.shape[0])
    zh = np.concatenate([zh, cplx_vec(rng, n - H.shape[0])])
    alpha = 0.75 - 0.5j
    for S in (1, 4):
        for dt, npdt in CPLX:
            be = ht.backend_auto(S, dtype=npdt, device=dev)
            Hd = ht.DistSparseMatrix.from_scipy(H, be)
            z = ht.DistVector.from_global(zh[: H.shape[0]], be)
            w = ht.DistVector.from_global(wh, be)
            plan, g, pad_to = engine_inputs(Hd, z)
            dval = spmv_mod._dia_values(Hd, plan)
            args = (dval, g, plan.offsets, plan.bias_lo, plan.bias_hi, pad_to)
            cuda_dia.dia_spmv.kernel = None
            c0 = cuda_dia.dia_spmv.launches
            yk = cuda_dia.dia_spmv(*args)
            ran = cuda_dia.dia_spmv.kernel
            check(plan.offsets is not None and ran == "dia_vec"
                  and cuda_dia.dia_kernel(dval, g, yk) == ran
                  and cuda_dia.dia_spmv.launches == c0 + 1,
                  f"Helmholtz({HELM_K}) S={S} {tag(dt)}: the DIA engine "
                  f"({len(plan.offsets or ())} offsets), K1 {ran} in one "
                  f"launch on {dval.dtype} values ("
                  f"{cuda_dia.dia_vector_width(dval, g, yk)} rows an access)")
            held("dia", f"K1 Helmholtz({HELM_K}) S={S}", dt, yk,
                 cuda_dia.dia_spmv_plain(*args))
            Hr, wr = rounded(H, npdt), rounded(wh, npdt)
            zr = rounded(zh[: H.shape[0]], npdt)

            def ops(Hd=Hd, z=z, w=w, c128=dt == torch.complex128):
                out = {"y": (Hd @ z).to_numpy(), "dot": complex(z.dot(w)),
                       "norm": float(z.norm()),
                       "axpy": (z * alpha + w).to_numpy()}
                if c128:
                    out["yH"] = (Hd.H @ z).to_numpy()
                return out
            got, c = drive(dt, ops)
            label = f"Helmholtz({HELM_K}) S={S} {tag(dt)}"
            held_to(Hr @ zr, got["y"], dt, f"{label} H @ z")
            held_to(np.array([np.vdot(zr, wr)]), np.array([got["dot"]]), dt,
                    f"{label} z.dot(w) (conjugating z)",
                    scale=float(np.abs(zr) @ np.abs(wr)))
            held_to(np.array([np.linalg.norm(zr)]),
                    np.array([got["norm"]]), dt, f"{label} norm(z)")
            held_to(alpha * zr + wr, got["axpy"], dt, f"{label} z*a + w")
            if "yH" in got:
                held_to(Hr.conj().T @ zr, got["yH"], dt, f"{label} H.H @ z")
            want = 2 if "yH" in got else 1
            check(c["dia"] == want and c["ell"] == 0,
                  f"{label}: the drive launched K1 {c['dia']} times")
            if S == 1 or dt == torch.complex128:
                bench[("dia", "helmholtz", S, dt)] = (
                    lambda a=args: cuda_dia.dia_spmv(*a),
                    lambda a=args: cuda_dia.dia_spmv_plain(*a),
                    csr_checked(H, dt, dev, zh[: H.shape[0]], Hr @ zr),
                    dia_bytes(plan, dval, dt), 8 * Hd.nnz(),
                    # the former route: four real products of the parts
                    (lambda a=args: cuda_dia.complex_products(
                        lambda v, x: cuda_dia.dia_spmv(v, x, *a[2:]),
                        a[0], a[1])) if dt == torch.complex128 and S == 1
                    else None)

    # (b) general patterns, K2 ---------------------------------------------
    R8c = complex_values(R8, SEED + 41)
    PLc = complex_values(PL, SEED + 42)
    PL4c = complex_values(power_law(N // 10, SEED + 3), SEED + 43)
    for name, M, S in (("random8", R8c, 1), ("power_law", PLc, 1),
                       ("power_law_tenth", PL4c, 4)):
        for dt, npdt in CPLX:
            be = ht.backend_auto(S, dtype=npdt, device=dev)
            Md = ht.DistSparseMatrix.from_scipy(M, be)
            zs = zh[: M.shape[1]]
            z = ht.DistVector.from_global(zs, be)
            plan, g, pad_to = engine_inputs(Md, z)
            args, kw, _ = ell_call(plan, Md, g, pad_to)
            label = f"K2 {name} S={S}"
            check(plan.engine(dt) == "ell"
                  and (plan.ell_Tpad > 0) == (name != "random8"),
                  f"{label} {tag(dt)}: the ELL engine (W={plan.ell_W}, "
                  f"Tpad={plan.ell_Tpad}, lanes {kw['lanes']}, "
                  f"{cuda_ell.unit_entries(plan.ell_W, dt.itemsize)} entries "
                  "a load)")
            held("ell", label, dt, cuda_ell.ell_spmv(*args, **kw),
                 cuda_ell.ell_spmv_plain(*args))
            y, c = drive(dt, lambda: (Md @ z).to_numpy())
            ref = rounded(M, npdt) @ rounded(zs, npdt)
            held_to(ref, y, dt, f"{label} {tag(dt)} A @ z")
            check(c["ell"] == 1, f"{label} {tag(dt)}: A @ z launched K2 once")
            if S == 1:
                bench[("ell", name, S, dt)] = (
                    lambda a=args, k=kw: cuda_ell.ell_spmv(*a, **k),
                    lambda a=args: cuda_ell.ell_spmv_plain(*a),
                    csr_checked(M, dt, dev, zs, ref),
                    ell_bytes(plan, Md, dt), 8 * Md.nnz(), None)
    # mixed real and complex: a complex A times a real x, a real R times a
    # complex z (the real operand is widened; one complex launch each)
    be = ht.backend_auto(1, dtype=np.complex128, device=dev)
    Cd = ht.DistSparseMatrix.from_scipy(R8c, be)
    Rd = ht.DistSparseMatrix.from_scipy(R8, be, dtype=np.float64)
    xr = rng.standard_normal(R8.shape[1])
    xd = ht.DistVector.from_global(xr, be, dtype=np.float64)
    zd = ht.DistVector.from_global(zh[: R8.shape[1]], be)
    (y1, y2), c = drive(torch.complex128, lambda: (
        (Cd @ xd).to_numpy(), (Rd @ zd).to_numpy()))
    check(Rd.dtype == torch.float64 and xd.dtype == torch.float64
          and c["ell"] == 2, "mixed: complex A @ real x and real R @ complex "
          "z launched K2's c128 instantiation once each")
    held_to(R8c @ xr, y1, torch.complex128, "mixed complex A @ real x")
    held_to(R8 @ zh[: R8.shape[1]], y2, torch.complex128,
            "mixed real R @ complex z")

    # (c) K3 on the ridge N's pattern and at the cap ------------------------
    Nc = complex_values(N_sc, SEED + 44)
    nN = Nc.shape[0]
    for S, (dt, npdt), want in ((1, CPLX[1], "resident"),
                                (1, CPLX[0], "ell"),
                                (4, CPLX[0], "resident")):
        be = ht.backend_auto(S, dtype=npdt, device=dev)
        Nd = ht.DistSparseMatrix.from_scipy(Nc, be)
        z = ht.DistVector.from_global(zh[:nN], be)
        plan, g, pad_to = engine_inputs(Nd, z)
        G = plan.exchange.out_pad
        eng = plan.engine(dt)
        label = f"N S={S}"
        check(eng == want, f"{label} {tag(dt)}: gathered x {G} slots = "
              f"{G * dt.itemsize} bytes against the {cap}-byte cap: the "
              f"{eng} engine")
        args, kw2, kw3 = ell_call(plan, Nd, g, pad_to)
        yp = cuda_ell.ell_spmv_plain(*args)
        y2 = cuda_ell.ell_spmv(*args, **kw2)
        held("ell", f"K2 {label}", dt, y2, yp)
        if eng == "resident":
            win = kw3["windows"]
            y3 = k3.ell_resident_spmv(*args, **kw3)
            held("resident", f"K3 {label} (staging "
                 f"{'windows' if win.staged else 'the whole x'})", dt, y3, yp)
            if plan.ell_Tpad == 0:
                check(torch.equal(y3, y2), f"K3 {label} {tag(dt)} equals K2 "
                      "bit for bit (the same row pass, no tail)")
        y, c = drive(dt, lambda: (Nd @ z).to_numpy())
        ref = rounded(Nc, npdt) @ rounded(zh[:nN], npdt)
        held_to(ref, y, dt, f"{label} {tag(dt)} N @ z")
        check(c[eng] == 1 and sum(c.values()) == 1,
              f"{label} {tag(dt)}: N @ z launched {eng} once ({c})")
        if eng == "resident":
            bench[("resident", "N", S, dt)] = (
                lambda a=args, k=kw3: k3.ell_resident_spmv(*a, **k),
                lambda a=args: cuda_ell.ell_spmv_plain(*a),
                csr_checked(Nc, dt, dev, zh[:nN], ref),
                ell_bytes(plan, Nd, dt), 8 * Nd.nnz(),
                lambda a=args, k=kw2: cuda_ell.ell_spmv(*a, **k))
    # at the cap: a gathered x of exactly cap // itemsize slots (a multiple
    # of 8: the columns plus the zero slot), staged whole by K3
    for (dt, npdt), seed in ((CPLX[0], SEED + 45), (CPLX[1], SEED + 46)):
        slots = (cap // dt.itemsize) // 8 * 8
        M = complex_values(random_cols(CAP_ROWS, slots - 8, 4, seed), seed)
        be = ht.backend_auto(1, dtype=npdt, device=dev)
        Md = ht.DistSparseMatrix.from_scipy(M, be)
        zs = zh[: M.shape[1]]
        z = ht.DistVector.from_global(zs, be)
        plan, g, pad_to = engine_inputs(Md, z)
        G = plan.exchange.out_pad
        args, kw2, kw3 = ell_call(plan, Md, g, pad_to)
        unit = cuda_ell.unit_entries(plan.ell_W, dt.itemsize)
        check(plan.engine(dt) == "resident" and G * dt.itemsize <= cap
              and kw3["windows"].staged == 0,
              f"at the cap {tag(dt)}: {G} slots = {G * dt.itemsize} bytes of "
              f"the {cap}-byte cap, K3 stages the whole x ({unit} entries "
              "a 16-byte load)")
        yp = cuda_ell.ell_spmv_plain(*args)
        held("resident", f"K3 at the cap, {unit}-entry 16-byte loads", dt,
             k3.ell_resident_spmv(*args, **kw3), yp)
        if unit > 1:     # one-entry loads: values 8 bytes off 16
            held("resident", "K3 at the cap, one-entry loads (values "
                 f"{dt.itemsize} bytes off 16)", dt,
                 k3.ell_resident_spmv(misaligned(args[0]), *args[1:], **kw3),
                 yp)
        y, c = drive(dt, lambda: (Md @ z).to_numpy())
        ref = rounded(M, npdt) @ rounded(zs, npdt)
        held_to(ref, y, dt, f"at the cap {tag(dt)} A @ z")
        check(c["resident"] == 1, f"at the cap {tag(dt)}: A @ z launched K3")
        if dt == torch.complex128:
            bench[("resident", "at_cap", 1, dt)] = (
                lambda a=args, k=kw3: k3.ell_resident_spmv(*a, **k),
                lambda a=args: cuda_ell.ell_spmv_plain(*a),
                csr_checked(M, dt, dev, zs, ref),
                ell_bytes(plan, Md, dt), 8 * Md.nnz(),
                lambda a=args, k=kw2: cuda_ell.ell_spmv(*a, **k))

    # (d) the complex device solver -----------------------------------------
    solver = {}
    with warnings.catch_warnings():
        warnings.filterwarnings("error",
                                message="device multifrontal unavailable")
        H5 = helmholtz(HELM_DEV_K)
        n5 = H5.shape[0]
        b5 = cplx_vec(rng, n5)
        be = ht.backend_auto(1, dtype=np.complex128, device=dev)
        Fh, t_host = timed_s(lambda: ht.ldlt(
            ht.DistSparseMatrix.from_scipy(H5, be)))
        xhost = Fh.solve(b5)
        del Fh
        for S, (dt, npdt) in ((1, CPLX[0]), (4, CPLX[0]), (1, CPLX[1])):
            be = ht.backend_auto(S, dtype=npdt, device=dev)
            A = ht.DistSparseMatrix.from_scipy(H5, be)
            b = ht.DistVector.from_global(b5, be)
            F, t_first = timed_s(lambda: ht.ldlt(A, method="device",
                                                 spd=False))
            x, c = drive(dt, lambda: F.solve(b).to_numpy())
            Hr, br = rounded(H5, npdt), rounded(b5, npdt)
            res = rel_res(Hr, x, br)
            gap = float(np.linalg.norm(x - xhost) / np.linalg.norm(xhost))
            label = f"Helmholtz({HELM_DEV_K}) S={S} {tag(dt)}"
            check(isinstance(F, device_mf.DeviceFactorization)
                  and F.factors[0][0][0].dtype == dt
                  and res <= CPLX_RES[dt]
                  and (gap <= 1e-9 or dt == torch.complex64)
                  and c["dia"] > 0,
                  f"{label}: ldlt(method='device', spd=False) residual "
                  f"{res:.2e} <= {CPLX_RES[dt]:g}, {gap:.2e} from the host "
                  f"engine's c128 solution, n_perturbed {F.n_perturbed}, K1 "
                  f"{c['dia']} launches (refinement)")
            eng = F.engine
            nnzb = np.concatenate([[0], np.cumsum(A.structure.nnz_local)])
            Avals = allgather_full(A.nzval, nnzb, be)
            eps = 1e-10 * float(A.nzval.abs().max())
            # one factor: it takes seconds (the recursive LDL, PERF.md)
            solver[f"ldl_S{S}_{tag(dt)}"] = {
                "n": n5, "first_ldlt_s": t_first,
                "device_ldl_factor_ms":
                    timed_ms(lambda: eng.factor(Avals, eps), 1),
                # the factor graph's replay with its copy-in, gather and
                # host read, beside the eager engine factor above
                "graph_refactorize_ms":
                    timed_ms(lambda: F.refactorize(A), 3),
                "device_solve_ms":
                    timed_ms(lambda: F.solve(b, refine=0), 5),
                "residual": res, "graphs": graph_info(F)}
            del F, eng, Avals
            ht.clear_plan_cache("device_mf")
        solver["host_ldlt_first_s_c128"] = t_host
        # the same LDL in f64 on the real part, laplace2d(512) - 0.5 I: what
        # the unpivoted recursive LDL costs without complex arithmetic
        be = ht.backend_auto(1, dtype=np.float64, device=dev)
        A = ht.DistSparseMatrix.from_scipy(H5.real.tocsr(), be)
        F, t_first = timed_s(lambda: ht.ldlt(A, method="device", spd=False))
        eng = F.engine
        Avals = allgather_full(A.nzval, np.concatenate(
            [[0], np.cumsum(A.structure.nnz_local)]), be)
        eps = 1e-10 * float(A.nzval.abs().max())
        solver["ldl_S1_f64"] = {
            "n": n5, "first_ldlt_s": t_first,
            "device_ldl_factor_ms":
                timed_ms(lambda: eng.factor(Avals, eps), 1),
            "device_solve_ms": timed_ms(
                lambda: F.solve(ht.DistVector.from_global(b5.real, be),
                                refine=0), 5)}
        del F, eng, Avals
        ht.clear_plan_cache("device_mf")
        # LU: laplace2d(256) with unsymmetric complex values on its own
        # pattern, permuted symmetrically so its SpMV plan is K2's
        r = np.random.default_rng(SEED + 47)
        Lu = laplace2d(LU_K)
        n2 = Lu.shape[0]
        Lu = sp.csr_matrix((Lu.data * (1.0 + 0.2 * r.random(Lu.nnz))
                            + 0.1j * r.standard_normal(Lu.nnz), Lu.indices,
                            Lu.indptr), shape=Lu.shape)
        perm = r.permutation(n2)
        P = Lu[perm][:, perm].tocsr()
        P.sort_indices()
        b2 = cplx_vec(rng, n2)
        c128 = torch.complex128
        for S in (1, 4):
            be = ht.backend_auto(S, dtype=np.complex128, device=dev)
            Pd = ht.DistSparseMatrix.from_scipy(P, be)
            bd = ht.DistVector.from_global(b2, be)
            eng_p = spmv_mod.get_spmv_plan(Pd, bd).engine(c128)
            F, t_first = timed_s(lambda: ht.lu(Pd, method="device"))
            (x, xt), c = drive(c128, lambda: (
                F.solve(bd).to_numpy(),
                F.solve(bd, transpose=True).to_numpy()))
            res, rest = rel_res(P, x, b2), rel_res(P.T, xt, b2)
            check(isinstance(F, device_mf.DeviceFactorization)
                  and eng_p == "ell" and res <= 1e-10 and rest <= 1e-10
                  and c["ell"] > 0,
                  f"LU permuted laplace2d({LU_K}) + complex perturbation "
                  f"S={S} c128: residual {res:.2e}, transposed {rest:.2e} "
                  f"<= 1e-10 with refinement, K2 ({eng_p} engine) "
                  f"{c['ell']} launches")
            solver[f"lu_65k_S{S}_c128"] = {
                "first_lu_s": t_first,
                "device_solve_ms": timed_ms(lambda: F.solve(bd, refine=0), 5),
                "graphs": graph_info(F)}
            del F
        # routing: a solver="device" backend through ht.solve twice, the
        # second time with new values on the same pattern
        bed = ht.backend_auto(1, dtype=np.complex128, device=dev,
                              solver="device")
        Pd = ht.DistSparseMatrix.from_scipy(P, bed)
        bd = ht.DistVector.from_global(b2, bed)
        ht.clear_plan_cache("backslash")
        x1 = ht.solve(Pd, bd).to_numpy()
        cache = ht.BackslashCache._cache()
        F1 = next(iter(cache.values()))
        s2 = 1.5 - 0.5j
        Pd2 = Pd * s2
        x2, c = drive(c128, lambda: ht.solve(Pd2, bd).to_numpy())
        res1, res2 = rel_res(P, x1, b2), rel_res(s2 * P, x2, b2)
        check(isinstance(F1, device_mf.DeviceFactorization)
              and len(cache) == 1 and next(iter(cache.values())) is F1
              and F1.A is Pd2 and max(res1, res2) <= 1e-10 and c["ell"] > 0,
              f"solver='device' c128: ht.solve took the device engine, new "
              f"values a refactorize-only hit (residuals {res1:.2e}, "
              f"{res2:.2e}; K2 {c['ell']} launches)")
        ht.clear_plan_cache("backslash")
        ht.clear_plan_cache("device_mf")

    # (e) times -------------------------------------------------------------
    timed = {}
    for key, (fk, fp, fl, nbytes, flops, extra) in bench.items():
        kname, name, S, dt = key
        t = timer.turns(fk, fp, fl, extra)
        label = f"{kname} {name} S={S} {tag(dt)}"
        if kname == "dia" and extra is not None:
            label += f" (former route, four real K1 products: {t[3]:.4f} ms)"
        elif extra is not None:
            label += f" (K2 {t[3]:.4f} ms)"
        bms, by = case_line(label, t[0], t[1], t[2], nbytes, flops, dt, card)
        if dt == torch.complex128 and kname not in timed:
            timed[kname] = {"ms": t[0], "plain_ms": t[1], "library_ms": t[2],
                            "bound_ms": bms, "bound_by": by,
                            "case": f"{name} S={S} c128"}
            if kname == "dia":
                timed[kname]["former_route_ms"] = t[3]
    p9 = times.get("phase9", {}).get("chol_262k_S1", {})
    for k, v in solver.items():
        print(f"  {k}: {json.dumps(v)}  [{card}]", flush=True)
    print(f"  f64 beside them (phase 9, laplace2d({DEV_K}) S=1 Cholesky): "
          f"factor {p9.get('device_chol_factor_262k_ms')} ms, solve "
          f"{p9.get('device_solve_262k_ms')} ms  [{card}]", flush=True)
    times["phase11"] = solver
    return launches, errs, timed


# ---- phase 12: shards on separate processes -----------------------------------

DIST_WORLD = 4          # gloo ranks sharing the card in arrangement (b)
DIST_DEADLINE_S = 400   # each arrangement's spawn, set-up and drive
# phase 12's depth, cut to keep the script in half its time limit: the
# host ldlt's laplace2d(DIST_K_SOLVE), and the ridge's CG steps on N,
# whose condition number near 3 takes the residual below RIDGE_RES_TOL
# in about 20
DIST_K_SOLVE = 128
DIST_RIDGE_STEPS = 30
# rank results held to the stacked run bit for bit besides the exchanges
# and the products of K1 and K3 (the same kernel on the same shard's
# tables): the moved values of the ridge assembly
DIST_MOVED = ("ridge.At.local", "ridge.At_c128.local", "ridge.triu.local",
              "ridge.diag.local")
DIST_ENGINES = {"lap": "dia", "lap_f32": "dia", "random8": "ell",
                "power_law": "ell", "N": "resident", "helm": "dia",
                "random8_c128": "ell", "N_c128": "resident"}
# the ridge's checks against scipy in every rank: the largest relative
# error each may have
DIST_RIDGE_TOL = {"N_rel_err": 1e-12, "solve_res": RIDGE_RES_TOL,
                  "Ax_rel_err": 1e-12}


def dist_engine(name, world):
    """The SpMV engine of ``card``'s product ``name`` on ``world`` shards:
    c128 N on one shard gathers all 16384 x 16 bytes of x, over K3's
    shared-memory cap, and takes K2 (as in phase 11)."""
    if name == "N_c128" and world == 1:
        return "ell"
    return DIST_ENGINES[name]


def dist_exact(name, ref):
    """Whether ``card``'s result ``name`` must equal the stacked run's bit
    for bit: data movement, and the products whose engine is K1 or K3."""
    prod, _, rest = name.partition(".")
    return name in DIST_MOVED or ".exchange." in name or (
        rest.startswith("y.") and str(ref[f"card.{prod}.engine"])
        in ("dia", "resident"))


def dist_held(ranks, ref, what):
    """Each rank's results against the stacked run at the same S (rank r's
    rows against row r): data movement and the K1/K3 products bit for bit
    (``dist_exact``), K2's products, the sums (SpGEMM, the additions),
    the dots, the CG iterates and residuals and the solves to K2_RTOL of
    their type (the tail's atomics and the reductions sum in another
    order); and each rank's ridge checks against scipy. Returns the
    largest error of each kind."""
    from hpclinalg_torch.tools.dist_checks import (LAUNCH_COUNTERS,
                                                   LDL_LAUNCH_COUNTERS)

    world = len(ranks)
    errs = {}
    for r, out in enumerate(ranks):
        check(int(out["meta.nlocal"]) == 1 and not bool(out["meta.jax"])
              and int(out["card.solve.bs.entries"]) == 1,
              f"{what} rank {r}: one shard, no JAX, one backslash entry")
        for name in DIST_ENGINES:
            engine = dist_engine(name, world)
            check(str(out[f"card.{name}.engine"]) == engine
                  == str(ref[f"card.{name}.engine"]),
                  f"{what} rank {r}: {name} takes the {engine} engine")
        check(str(out["card.ridge.spgemm.engine"]) == "pairs"
              == str(ref["card.ridge.spgemm.engine"])
              and int(out["card.ridge.spgemm.nchunks"])
              == int(ref["card.ridge.spgemm.nchunks"]),
              f"{what} rank {r}: At @ A takes the pair engine in "
              f"{int(out['card.ridge.spgemm.nchunks'])} chunk(s), as the "
              "stacked run")
        check(bool(out["card.check.ridge_N_pattern"])
              and bool(out["card.check.ridge_refit_reused"]),
              f"{what} rank {r}: N = At @ A + lambda I has scipy's pattern; "
              "the refit reused every plan")
        for key, tol in DIST_RIDGE_TOL.items():
            got = float(out[f"card.check.ridge_{key}"])
            check(got <= tol, f"{what} rank {r}: ridge {key} {got:.3e} "
                  f"(<= {tol:g})")
        ok, err = close(torch.from_numpy(out["card.ridge.C2.local"]),
                        torch.from_numpy(2.25 * out["card.ridge.C.local"]),
                        1e-12)
        check(ok, f"{what} rank {r}: the refit's At @ A is 2.25 C, "
              f"max_abs_err {err:.3e}")
        for key, want in ref.items():
            if not key.startswith("card.") or key.startswith(
                    ("card.time.", "card.launches.", "card.secs.",
                     "card.check.", "card.profile.")) \
                    or want.dtype.kind not in "fc":
                continue
            got = out[key]
            if key.endswith(".local"):
                want = want[r: r + 1]
            name = key[len("card."):]
            if dist_exact(name, ref):
                ok = np.array_equal(got, want)
                err = float(np.max(np.abs(got - want))) if got.size else 0.0
                rule = "bit for bit"
            else:
                dt = torch.float32 if got.dtype in (np.float32,
                                                    np.complex64) \
                    else torch.float64
                ok, err = close(torch.from_numpy(np.atleast_1d(got)),
                                torch.from_numpy(np.atleast_1d(want)),
                                K2_RTOL[dt])
                rule = f"rtol {K2_RTOL[dt]:g}"
            check(ok, f"{what} rank {r}: {name} equals the stacked run "
                  f"({rule}, max_abs_err={err:.3e})")
            kind = name.split(".")[0]
            errs[kind] = max(errs.get(kind, 0.0), err)
        launches = {k: int(out[f"card.launches.{k}"])
                    for k in LAUNCH_COUNTERS}
        check(all(v >= 1 for v in launches.values()),
              f"{what} rank {r} launched K1, K2, K2's gather mode and K3: "
              f"{launches}")
    return errs


def phase12_dist(ht, dev, card, times, mats):
    """The main path with one shard a process (``ht.backend_dist``), each
    rank on the card, through ``tools/dist_checks.card`` at this script's
    sizes: (a) NCCL at world 1; (b) gloo at world DIST_WORLD, the ranks
    sharing cuda:0 (every collective staged through the host: a test
    arrangement, not a deployment); (c) NCCL at world = device count when
    there are two cards or more. Each rank is held against the same body
    run stacked at that S in this process, and prints one JSON line a
    arrangement with the stacked run's times beside its ranks' (the CG
    step, the exchange, the ridge's first and cached transpose, SpGEMM
    and additions) and, at NCCL world 1, prints where the host time of an
    ``all_reduce`` goes (cProfile). ``mats``: ``dist_checks.card_matrices``
    at this script's sizes. Returns each kernel's per-rank launches by
    arrangement."""
    from hpclinalg_torch.parallel.launch import run_ranks
    from hpclinalg_torch.tools import dist_checks as dc

    kw = {"k": K, "n": N,
          "ridge_shape": (RIDGE_M, RIDGE_N, RIDGE_LAMBDA),
          "k_solve": DIST_K_SOLVE, "ridge_steps": DIST_RIDGE_STEPS,
          "seed": SEED}
    count = torch.cuda.device_count()
    arrangements = [("nccl", 1), ("gloo", DIST_WORLD)]
    if count >= 2:
        arrangements.append(("nccl", count))
    else:
        print("  (c) NCCL at world = device count: skipped: one card",
              flush=True)
    refs = {}
    for S in sorted({w for _, w in arrangements}):
        refs[S], t = timed_s(lambda: dc.card(ht.backend_auto(S, device=dev),
                                             mats=mats, **kw))
        print(f"  stacked S={S} reference drive: {t:.1f} s", flush=True)
    torch.cuda.empty_cache()
    dist_launches = {k: {} for k in dc.LAUNCH_COUNTERS}
    for transport, world in arrangements:
        what = f"{transport} world {world}"
        t0 = time.perf_counter()
        ranks = run_ranks("hpclinalg_torch.tools.dist_checks:on_rank", world,
                          backend=transport, device="cuda",
                          deadline_s=DIST_DEADLINE_S, args=("card", kw))
        secs = time.perf_counter() - t0
        errs = dist_held(ranks, refs[world], what)
        ref = refs[world]
        per_rank = {k[len("card.time."):]: [float(r[k]) for r in ranks]
                    for k in ranks[0] if k.startswith("card.time.")}
        stacked = {f"stacked_S{world}_{k[len('card.time.'):]}": float(v)
                   for k, v in ref.items() if k.startswith("card.time.")}
        key = f"{transport}_world{world}"
        for k in dc.LAUNCH_COUNTERS:
            dist_launches[k][key] = [int(r[f"card.launches.{k}"])
                                     for r in ranks]
        if transport == "nccl" and world == 1:
            prof = json.loads(str(ranks[0]["card.profile.all_reduce"]))
            print(f"  all_reduce of a 0-d tensor at NCCL world 1, host time "
                  f"under cProfile: {prof['profiled_us_per_call']:.1f} us a "
                  f"call (unprofiled {per_rank['all_reduce_host_ms'][0]:.4f}"
                  f" ms)  [{card}]", flush=True)
            for where, us, calls in prof["self_us_per_call"]:
                print(f"    {us:8.2f} us  {calls:g} calls  {where}",
                      flush=True)
            print(f"  the same under torch.profiler (CPU activity): "
                  f"{prof['torch_profiled_us_per_call']:.1f} us a call; "
                  "operators by their own CPU time:", flush=True)
            for name, us, calls in prof["op_self_us_per_call"]:
                print(f"    {us:8.2f} us  {calls:g} calls  {name}",
                      flush=True)
            times["phase12_all_reduce_profile"] = prof
        record = {"phase12": key, "card": card, "seconds": secs,
                  **per_rank, **stacked,
                  "launches": {k: dist_launches[k][key]
                               for k in dc.LAUNCH_COUNTERS},
                  "rank_secs": {k[len("card.secs."):]: [
                      float(r[k]) for r in ranks]
                      for k in ranks[0] if k.startswith("card.secs.")},
                  "max_abs_err": errs}
        times[f"phase12_{key}"] = record
        print(json.dumps(record), flush=True)
    return dist_launches


# ---- phase 13: the device solver and the dense containers, per process -----

DIST13_DEADLINE_S = 300  # each arrangement's spawn, set-up and drive
RIDGE_K = SPMM_K         # responses of the multi-response ridge (Y 10^6 x 64)
# the residual each of ``dist_checks.solvers``' solves may have in every
# rank (phase 9's and phase 11's bounds)
DIST13_RES = {"chol_res": 1e-10, "ldl_res": 1e-8, "lu_res": 1e-9,
              "lu_t_res": 1e-9, "c128_res": CPLX_RES[torch.complex128],
              "ridge_multi_res": RIDGE_RES_TOL, "ridge_res": RIDGE_RES_TOL}
# results of ``solvers`` that are sums (SpMM, the dense transpose's
# product), held to the stacked run to 1e-12; the rest are solutions,
# held to 1e-10 (the cross and top sums run in another order)
DIST13_SUMMED = ("ridge.R", "ridge.G")
DIST13_KINDS = ("chol", "ldl", "lu", "c128", "ridge_chol")


def dist13_held(ranks, ref, what):
    """Each rank of ``dist_checks.solvers`` against the stacked run at the
    same S: every rank's rows against that row of the stack (solutions
    rtol 1e-10, R and G 1e-12 of their largest entry), the same
    n_perturbed, growth and plan digest in every rank and the stacked
    run, the residuals within DIST13_RES, both factorizations on the
    device engine, and every one of K1, K2, its gather mode, K3 and the
    LDLᵀ's leaf launched. Returns the largest error of each result."""
    from hpclinalg_torch.tools.dist_checks import (LAUNCH_COUNTERS,
                                                   LDL_LAUNCH_COUNTERS)

    world = len(ranks)
    errs = {}
    for r, out in enumerate(ranks):
        check(int(out["meta.nlocal"]) == 1 and not bool(out["meta.jax"])
              and bool(out["sol.chol.device"])
              and bool(out["sol.ridge.device"]),
              f"{what} rank {r}: one shard, no JAX, the device engine")
        for key, tol in DIST13_RES.items():
            got = float(out[f"sol.check.{key}"])
            check(got <= tol, f"{what} rank {r}: {key} {got:.3e} "
                  f"(<= {tol:g})")
        for kind in DIST13_KINDS:
            for stat in ("n_perturbed", "growth", "digest"):
                key = f"sol.{kind}.{stat}"
                check(str(out[key]) == str(ref[key]),
                      f"{what} rank {r}: {kind} {stat} {out[key]} equals "
                      f"the stacked run's")
        for key, want in ref.items():
            if not key.endswith((".local", ".full")):
                continue
            got = out[key]
            if key.endswith(".local"):
                want = want[r: r + 1]
            name = key[len("sol."):].rsplit(".", 1)[0]
            rtol = 1e-12 if name in DIST13_SUMMED else 1e-10
            ok, err = close(torch.from_numpy(got), torch.from_numpy(want),
                            rtol)
            check(ok, f"{what} rank {r}: {key[len('sol.'):]} equals the "
                  f"stacked run (rtol {rtol:g}, max_abs_err={err:.3e})")
            errs[name] = max(errs.get(name, 0.0), err)
        launches = {k: int(out[f"sol.launches.{k}"])
                    for k in LAUNCH_COUNTERS + LDL_LAUNCH_COUNTERS}
        check(all(v >= 1 for v in launches.values()),
              f"{what} rank {r} launched K1, K2, K2's gather mode, K3 and "
              f"the LDLT's leaf: {launches}")
    if world == DIST_WORLD:
        owners = ranks[0]["sol.chol.owners"].tolist()
        cross = int(ranks[0]["sol.chol.cross"])
        check(owners == list(range(world)) and cross > 1,
              f"{what}: laplace2d({DEV_K})'s subtrees cover ranks {owners} "
              f"and the cross buffer holds {cross} values")
    return errs


def phase13_solvers(ht, dev, card, times, mats):
    """The device multifrontal solver and the dense containers with one
    shard a process, through ``tools/dist_checks.solvers`` at full width:
    the device Cholesky of laplace2d(DEV_K) (n = 262,144), the indefinite
    LDL, the LU with its transposed solve and a c128 LDL of
    Helmholtz(DEV_K_SMALL), and the multi-response ridge on phase 12's
    design and N (``mats``): Y 10^6 x RIDGE_K, R = At @ Y, X =
    ldlt(N, method="device", spd=True).solve_matrix(R), G = X.T @ X.
    Arrangements as phase 12's; each rank is held against the same body
    run stacked at that S in this process (``dist13_held``), and one JSON
    line an arrangement prints each rank's first call (plan), factor,
    solve, cross all_reduce (events and host time), At @ Y and multi-RHS
    solve beside the stacked run's, with the launches and the cross
    buffer's bytes. Returns each kernel's per-rank launches by
    arrangement."""
    from hpclinalg_torch.parallel.launch import run_ranks
    from hpclinalg_torch.tools import dist_checks as dc

    DIST13_LAUNCHES = dc.LAUNCH_COUNTERS + dc.LDL_LAUNCH_COUNTERS
    kw = {"k": DEV_K, "k_small": DEV_K_SMALL,
          "ridge_shape": (RIDGE_M, RIDGE_N, RIDGE_LAMBDA), "ycols": RIDGE_K,
          "seed": SEED}
    ridge = {k: mats[k] for k in ("design", "design_b", "N")}
    count = torch.cuda.device_count()
    arrangements = [("nccl", 1), ("gloo", DIST_WORLD)]
    if count >= 2:
        arrangements.append(("nccl", count))
    refs = {}
    for S in sorted({w for _, w in arrangements}):
        refs[S], t = timed_s(lambda: dc.solvers(
            ht.backend_auto(S, device=dev), mats=ridge, **kw))
        print(f"  stacked S={S} reference drive: {t:.1f} s", flush=True)
        torch.cuda.empty_cache()
    launches = {k: {} for k in DIST13_LAUNCHES}
    for transport, world in arrangements:
        what = f"{transport} world {world}"
        ranks, secs = timed_s(lambda: run_ranks(
            "hpclinalg_torch.tools.dist_checks:on_rank", world,
            backend=transport, device="cuda", deadline_s=DIST13_DEADLINE_S,
            args=("solvers", kw)))
        ref = refs[world]
        errs = dist13_held(ranks, ref, what)
        refusals = {str(r[f"sol.{kind}.refusal"]) for r in ranks
                    for kind in DIST13_KINDS}
        check(refusals == {""} if transport == "nccl" else
              all("gloo" in why for why in refusals),
              f"{what}: every rank's device factorizations are "
              + ("CUDA graphs (the factor's cross all_reduce and count "
                 "gather and the solve's all_reduce captured over NCCL)"
                 if transport == "nccl" else
                 "eager, the gloo group refused by the capture")
              + f" ({sorted(refusals)[0][:60] or 'graphed'})")
        key = f"{transport}_world{world}"
        for k in DIST13_LAUNCHES:
            launches[k][key] = [int(r[f"sol.launches.{k}"]) for r in ranks]
        per_rank = {k[len("sol.time."):]: [float(r[k]) for r in ranks]
                    for k in ranks[0] if k.startswith("sol.time.")}
        stacked = {f"stacked_S{world}_{k[len('sol.time.'):]}": float(v)
                   for k, v in ref.items() if k.startswith("sol.time.")}
        record = {"phase13": key, "card": card, "seconds": secs,
                  **per_rank, **stacked,
                  "cross_bytes": int(ranks[0]["sol.chol.cross_bytes"]),
                  "stacked_cross_bytes": int(ref["sol.chol.cross_bytes"]),
                  "chol_owners": ranks[0]["sol.chol.owners"].tolist(),
                  "n_perturbed": {
                      kind: int(ranks[0][f"sol.{kind}.n_perturbed"])
                      for kind in DIST13_KINDS},
                  "growth": {kind: float(ranks[0][f"sol.{kind}.growth"])
                             for kind in DIST13_KINDS},
                  "residuals": {k: [float(r[f"sol.check.{k}"]) for r in ranks]
                                for k in DIST13_RES},
                  "launches": {k: launches[k][key]
                               for k in DIST13_LAUNCHES},
                  "stacked_launches": {k: int(ref[f"sol.launches.{k}"])
                                       for k in DIST13_LAUNCHES},
                  "rank_secs": {k[len("sol.secs."):]: [
                      float(r[k]) for r in ranks]
                      for k in ranks[0] if k.startswith("sol.secs.")},
                  "stacked_secs": {k[len("sol.secs."):]: float(v)
                                   for k, v in ref.items()
                                   if k.startswith("sol.secs.")},
                  "max_abs_err": errs}
        times[f"phase13_{key}"] = record
        print(json.dumps(record), flush=True)
    return launches


# ---- phase 14: the saddle-point assembly, one shard a process ----------------

DIST14_DEADLINE_S = 240  # each arrangement's spawn, inputs and drive
KKT_SEED = 30            # phase 10's inputs (tools/kkt.main)
# the drive's first (plan build) and cached times, printed per rank
DIST14_TIMES = ("cat_first_s", "cat_cached_s", "matvec_first_s",
                "matvec_cached_s", "rmatvec_first_s", "rmatvec_cached_s",
                "getindex_first_s", "getindex_cached_s", "setindex_first_s",
                "reductions_first_s", "blockdiag_first_s", "warmup_s")


def phase14_assembly(card, times):
    """Phase 10's saddle-point assembly with one shard a process, through
    ``tools/dist_checks.assembly`` (``tools/kkt.drive`` at k = K, m =
    KKT_M in every rank, each step held against scipy there: a failing
    check fails its rank, and ``run_ranks`` raises): (a) NCCL at world 1;
    (b) gloo at world DIST_WORLD, the ranks sharing cuda:0; (c) NCCL at
    world = device count with two cards or more. No stacked drive runs
    here: phase 10 drove the same inputs stacked at S = 1 and 4, and each
    rank's engines are held to its record at that S. Each rank must have
    launched K1, K2 and K2's gather mode (counted around its drive), and
    its trace file must name ``kkt_matvec`` and K2's launch range. Prints
    one JSON line an arrangement: each rank's first and cached times and
    the drive's step seconds beside phase 10's stacked ones. Returns each
    kernel's per-rank launches by arrangement."""
    import os

    from hpclinalg_torch.parallel.launch import run_ranks
    from hpclinalg_torch.tools import dist_checks as dc
    from hpclinalg_torch.tools.kkt import ENGINE_KERNELS

    root = os.path.dirname(os.path.abspath(__file__))
    p10 = times["phase10"]
    count = torch.cuda.device_count()
    arrangements = [("nccl", 1), ("gloo", DIST_WORLD)]
    if count >= 2:
        arrangements.append(("nccl", count))
    else:
        print("  (c) NCCL at world = device count: skipped: one card",
              flush=True)
    launches = {k: {} for k in dc.LAUNCH_COUNTERS}
    for transport, world in arrangements:
        what = f"{transport} world {world}"
        key = f"{transport}_world{world}"
        trace_dir = os.path.join(root, "build", "traces", f"kkt_{key}")
        ranks, secs = timed_s(lambda: run_ranks(
            "hpclinalg_torch.tools.dist_checks:on_rank", world,
            backend=transport, device="cuda", deadline_s=DIST14_DEADLINE_S,
            args=("assembly", {"k": K, "m": KKT_M, "seed": KKT_SEED,
                               "trace_dir": trace_dir})))
        ref = p10.get(f"S{world}")
        for r, out in enumerate(ranks):
            check(int(out["meta.nlocal"]) == 1 and not bool(out["meta.jax"]),
                  f"{what} rank {r}: one shard, no JAX; every step of the "
                  "drive held against scipy in the rank")
            engines = {e: str(out[f"asm.{e}"])
                       for e in ("engine", "k11_engine", "blockdiag_engine")}
            if ref is not None:
                check(all(engines[e] == ref[e] for e in engines),
                      f"{what} rank {r}: engines {engines} equal phase 10's "
                      f"stacked S={world}")
            else:
                print(f"  {what} rank {r}: engines {engines} (phase 10 has "
                      f"no stacked S={world} record)", flush=True)
            n = {k: int(out[f"asm.launches.{k}"]) for k in dc.LAUNCH_COUNTERS}
            check(n["dia"] >= 1 and n["ell"] >= 1 and n["gather"] >= 1,
                  f"{what} rank {r} launched K1, K2 and K2's gather mode: "
                  f"{n}")
            with open(os.path.join(trace_dir, f"trace.rank{r}.json")) as fh:
                names = {e.get("name", "")
                         for e in json.load(fh)["traceEvents"]}
            # densify and segment launch no kernel of this repo: no name
            kn = ENGINE_KERNELS.get(engines["engine"], "<no kernel>")
            check("kkt_matvec" in names and any(kn in nm for nm in names),
                  f"{what} rank {r}: its trace names kkt_matvec and "
                  f"{kn!r} (K @ z on the {engines['engine']} engine)")
        for k in dc.LAUNCH_COUNTERS:
            launches[k][key] = [int(r[f"asm.launches.{k}"]) for r in ranks]
        record = {"phase14": key, "card": card, "seconds": secs,
                  **{t: [float(r[f"asm.time.{t}"]) for r in ranks]
                     for t in DIST14_TIMES},
                  **{f"stacked_S{S}_{t}": p10[f"S{S}"][t]
                     for S in (1, 4) for t in DIST14_TIMES},
                  "steps_s": {k[len("asm.step."):]: [
                      float(r[k]) for r in ranks]
                      for k in ranks[0] if k.startswith("asm.step.")},
                  "stacked_steps_s": {f"S{S}": p10[f"S{S}"]["steps_s"]
                                      for S in (1, 4)},
                  "rank_secs": {k[len("asm.secs."):]: [
                      float(r[k]) for r in ranks]
                      for k in ranks[0] if k.startswith("asm.secs.")},
                  "launches": {k: launches[k][key]
                               for k in dc.LAUNCH_COUNTERS}}
        times[f"phase14_{key}"] = record
        print(json.dumps(record), flush=True)
    return launches


# ---- phase 15: the compiled CG step (hpclinalg_torch.entry) -----------------

DIST15_DEADLINE_S = 60   # each arrangement's spawn, set-up and steps
ENTRY_RTOL = 1e-10       # a rank's 20 f64 steps against the stacked ones


def phase15_entry(ht, dev, card, times):
    """The JAX entry point's compiled CG step: ``python -m
    hpclinalg_torch.tools.cg_graph`` in a process of its own (its one
    profiler session is that process's first), which captures cases
    (i)-(v) as CUDA graphs and holds 20 replays against the eager raw
    step (bit for bit), the public-API CG and a host replay, and times
    the three steps; then case (i) with one shard a process
    (``tools/dist_checks.entry_steps`` on laplace2d(K), f64): (a) NCCL at
    world 1, graphed and eager, (b) gloo at world DIST_WORLD on the card,
    eager, where ``capture`` must refuse the group, (c) NCCL at world =
    device count with two cards or more, graphed (the exchange's
    ``all_to_all_single`` and the two all_reduces in the graph) and
    eager. Each rank's 20 steps
    are held against the same steps stacked here at that S (rtol
    ENTRY_RTOL; the dots are summed in another order on a group). Returns
    each kernel's launches over the cases (set to 0 just before each
    case's eager steps and read just after its replays) and per rank by
    arrangement. The stacked references take cg_graph's right-hand side
    (``B_SEED``), so at S = 1 they are its case (i) again."""
    import os

    from hpclinalg_torch.parallel.launch import run_ranks
    from hpclinalg_torch.tools import dist_checks as dc
    from hpclinalg_torch.tools.cg_graph import B_SEED

    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=root + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run([sys.executable, "-m",
                           "hpclinalg_torch.tools.cg_graph"], cwd=root,
                          env=env, capture_output=True, text=True,
                          timeout=600)
    print(proc.stdout, end="", flush=True)
    if proc.returncode != 0:
        print(proc.stderr, file=sys.stderr, flush=True)
        raise RuntimeError(f"chip_smoke check failed: phase 15's cases "
                           f"exited {proc.returncode}")
    record = json.loads(proc.stdout.strip().splitlines()[-1])
    check(record["card"] == card and set(record["cases"]) == {
        "lap", "lap_s4", "N", "random8", "entry"},
        "phase 15 ran cases (i)-(v) on this card; each equalled its eager "
        "raw step bit for bit")
    launches = {k: sum(record["launches"][c][k] for c in record["launches"])
                for k in dc.LAUNCH_COUNTERS + dc.CG_LAUNCH_COUNTERS}
    kw = {"k": K, "seed": B_SEED, "dtypes": ("float64",)}
    count = torch.cuda.device_count()
    arrangements = [("nccl", 1), ("gloo", DIST_WORLD)]
    if count >= 2:
        arrangements.append(("nccl", count))
    else:
        print("  (c) NCCL at world = device count: skipped: one card",
              flush=True)
    refs = {S: dc.entry_steps(ht.backend_auto(S, device=dev), graphed=True,
                              **kw) for S in {S for _, S in arrangements}}
    torch.cuda.empty_cache()
    dist = {k: {} for k in dc.LAUNCH_COUNTERS + dc.CG_LAUNCH_COUNTERS}
    for transport, world in arrangements:
        what = f"{transport} world {world}"
        key = f"{transport}_world{world}"
        graphed = transport == "nccl"
        ranks, secs = timed_s(lambda: run_ranks(
            "hpclinalg_torch.tools.dist_checks:on_rank", world,
            backend=transport, device="cuda", deadline_s=DIST15_DEADLINE_S,
            args=("entry_steps", dict(kw, graphed=graphed, timed=True))))
        err = 0.0
        for r, out in enumerate(ranks):
            check(int(out["meta.nlocal"]) == 1 and not bool(out["meta.jax"])
                  and str(out["entry.float64.engine"]) == "dia",
                  f"{what} rank {r}: one shard, no JAX, the dia engine")
            if graphed:
                check(bool(out["entry.float64.graphed_equal"]),
                      f"{what} rank {r}: 20 replays of the captured step "
                      "(its collectives in the graph) equal 20 eager "
                      "steps bit for bit")
            else:
                check("gloo" in str(out["entry.float64.refused"]),
                      f"{what} rank {r}: capture refuses the gloo group")
            for v in "xrp":
                ok, e = close(torch.from_numpy(out[f"entry.float64.{v}.local"]),
                              torch.from_numpy(refs[world][
                                  f"entry.float64.{v}.local"][r: r + 1]),
                              ENTRY_RTOL)
                check(ok, f"{what} rank {r}: {v} after 20 steps equals the "
                      f"stacked S={world} steps (rtol {ENTRY_RTOL:g}, "
                      f"max_abs_err={e:.3e})")
                err = max(err, e)
            n = {k: int(out[f"entry.launches.float64.{k}"])
                 for k in dc.LAUNCH_COUNTERS + dc.CG_LAUNCH_COUNTERS}
            check(n["dia"] >= 1 and (world == 1 or n["gather"] >= 1),
                  f"{what} rank {r} launched K1 and, across ranks, K2's "
                  f"gather mode: {n}")
            check(len({n[k] for k in dc.CG_LAUNCH_COUNTERS}) == 1
                  and n["cg_dots"] >= 20,
                  f"{what} rank {r} launched each of the step's vector "
                  f"kernels once a step: {n}")
        for k in dc.LAUNCH_COUNTERS + dc.CG_LAUNCH_COUNTERS:
            dist[k][key] = [int(r[f"entry.launches.float64.{k}"])
                            for r in ranks]
        rec = {"phase15": key, "card": card, "seconds": secs,
               **{t[len("entry.time.float64."):]: [
                   float(r[t]) for r in ranks]
                  for t in ranks[0] if t.startswith("entry.time.")},
               "stacked_S1": {v: record["cases"]["lap"][v]
                              for v in ("graphed", "eager", "api")},
               "launches": {k: dist[k][key] for k in dist},
               "max_abs_err": err}
        times[f"phase15_{key}"] = rec
        print(json.dumps(rec), flush=True)
    times["phase15"] = record
    return launches, dist


HPCG_K = 104             # phase 16: HPCG's 27-point operator on a 104^3 grid


def phase16_cg_vec(ht, dev, card, timer, times):
    """The CG step's vector kernels (``ops/cuda_cg.py``) on HPCG's operator
    at HPCG_K^3, f64, S = 1, where the step takes them: their launch
    counters set to 0 just before 20 replays of the captured step and read
    just after; from the state the replays leave, the kernels once on the
    same inputs against the step and the plain arithmetic
    (``cg_graph.against_plain``); then each kernel, its plain version (the
    plain step's operations for that pass, scalars on the device) and its
    library calls (``torch.dot``, ``torch.add`` with the scalar on the
    host) timed in turns beside its bound. Returns {kernel: record}."""
    from hpclinalg_torch.entry import capture, cg_step_fn
    from hpclinalg_torch.ops import cuda_cg
    from hpclinalg_torch.tools import dist_checks as dc
    from hpclinalg_torch.tools.cg_graph import against_plain
    from hpclinalg_torch.tools.matrices import hpcg27

    be = ht.backend_auto(1, dtype=np.float64, device=dev)
    A = ht.DistSparseMatrix.from_scipy(hpcg27(HPCG_K), be)
    step, x0 = cg_step_fn(A, be)
    check(step.fused and step.engine == "dia",
          f"HPCG {HPCG_K}^3 f64: the step takes the vector kernels and K1")
    b = ht.DistVector.from_global(np.random.default_rng(SEED + 16)
                                  .standard_normal(A.m), be).data
    graph = capture(step, (x0.data, b, b))
    dc.reset_launch_counts()
    args = (x0.data, b, b)
    for _ in range(20):
        args = graph(*args)
    torch.cuda.synchronize()
    n = dc.launch_counts()
    check(all(n[k] == 20 for k in dc.CG_LAUNCH_COUNTERS + ("dia",)),
          f"20 replays launched each vector kernel and K1 20 times: {n}")
    x, r, p = (t.clone() for t in args)
    Ap = step.spmv(p)
    mine, res = against_plain(x, r, p, Ap)
    nxt = step(x, r, p)
    check(all(torch.equal(a, c) for a, c in zip(mine, nxt)),
          "the kernels once on the state equal the step bit for bit; their "
          "updates equal the plain arithmetic with their own alpha and "
          f"beta; their dots within {res['dot_err']:.3e} of the terms' "
          "magnitudes of a double torch.dot")
    N = x.numel()
    xf, rf, pf, Apf = (t.reshape(-1) for t in (x, r, p, Ap))
    ws = cuda_cg.Workspace(N, torch.float64, dev)
    cuda_cg.cg_dots(p, Ap, r, ws)
    xo, ro, po = (torch.empty_like(t) for t in (x, r, p))
    cuda_cg.cg_update_xr(x, r, p, Ap, ws, xo, ro)
    d, rr = ws.dots.clone(), ws.rr.clone()
    alpha, beta = d[1] / d[0], rr[0] / d[1]
    ah, bh = float(alpha), float(beta)
    xl, rl, pl = (torch.empty_like(t) for t in (xf, rf, pf))
    fns = {
        "cg_dots": (
            lambda: cuda_cg.cg_dots(p, Ap, r, ws),
            lambda: torch.stack([torch.vdot(pf, Apf), torch.vdot(rf, rf)]),
            lambda: (torch.dot(pf, Apf), torch.dot(rf, rf)), 3),
        "cg_update_xr": (
            lambda: cuda_cg.cg_update_xr(x, r, p, Ap, ws, xo, ro),
            lambda: (torch.add(x, alpha * p, out=xo),
                     torch.vdot(torch.sub(r, alpha * Ap, out=ro).reshape(-1),
                                ro.reshape(-1))),
            lambda: (torch.add(xf, pf, alpha=ah, out=xl),
                     torch.dot(torch.add(rf, Apf, alpha=-ah, out=rl), rl)),
            6),
        "cg_update_p": (
            lambda: cuda_cg.cg_update_p(ro, p, ws, po),
            lambda: torch.add(ro, beta * p, out=po),
            lambda: torch.add(ro.reshape(-1), pf, alpha=bh, out=pl), 3)}
    out = {}
    for name, (fk, fp, fl, vectors) in fns.items():
        ms, plain, lib = timer.turns(fk, fp, fl)
        nbytes = vectors * N * 8
        bms, by = case_line(f"{name} HPCG {HPCG_K}^3 f64", ms, plain, lib,
                            nbytes, 0.0, torch.float64, card)
        out[name] = {"launches": n[name], "ms": ms, "plain_ms": plain,
                     "library_ms": lib, "bound_ms": bms, "bound_by": by,
                     "max_abs_err": 0.0}
    e = res["dot_abs_errs"]
    out["cg_dots"]["max_abs_err"] = max(e[:2])
    out["cg_update_xr"]["max_abs_err"] = e[2]
    out["cg_dots"]["max_dot_err"] = res["dot_err"]
    times["phase16"] = {"n": N, "dots": res["dots"], **out}
    return out


# ---- phase 17: the device LDLᵀ's leaf kernel ---------------------------------

# the leaf's timed cases, (blocks, columns) in c128: helmholtz2d-512's
# widest level (27,647 fronts of 16 columns) and a 32-column leaf of its
# upper levels
LEAF_TIMED = ((27647, 16), (64, 32))
LEAF_RTOL = {torch.float32: 1e-5, torch.complex64: 1e-5,
             torch.float64: 1e-12, torch.complex128: 1e-12}
LEAF_EPS = 1e-10


def leaf_blocks(B, n, dtype, dev, seed):
    """B seeded n × n blocks, symmetric with the plain transpose, diagonally
    dominant with alternating signs; in the first, entry (0, 0) is 1e-14
    and its row and column zero, a pivot the clamp takes."""
    rng = np.random.default_rng(seed)
    M = rng.standard_normal((B, n, n))
    if dtype.is_complex:
        M = M + 1j * rng.standard_normal((B, n, n))
    M = M + np.swapaxes(M, 1, 2) + 3 * n * np.diag(
        np.where(np.arange(n) % 2, -1.0, 1.0))
    M[0, 0, :] = 0
    M[0, :, 0] = 0
    M[0, 0, 0] = 1e-14
    return torch.from_numpy(M).to(dtype=dtype, device=dev)


def leaf_held(F, eps, what):
    """The kernel once on ``F`` against its plain version
    (``device_mf._ldl_plain``, on the card): L and d within LEAF_RTOL of
    the plain ones' largest entry, the same clamped pivots, exact zeros
    above L's diagonal and ones on it. Returns (max |L - Lp|, max |d - dp|,
    that over the plain one's largest entry, the clamped pivots)."""
    from hpclinalg_torch.ops import cuda_ldl
    from hpclinalg_torch.solver import device_mf

    L, d, p = cuda_ldl.ldl_leaf(F, eps)
    Lp, dp, pp = device_mf._ldl_plain(F, eps)
    okL, eL = close(L, Lp, LEAF_RTOL[F.dtype])
    okd, ed = close(d, dp, LEAF_RTOL[F.dtype])
    rel = max(eL / float(Lp.abs().max()), ed / float(dp.abs().max()))
    ones = torch.equal(torch.diagonal(L, dim1=-2, dim2=-1),
                       torch.ones_like(d))
    zeros = not bool(torch.triu(L, 1).any())
    if not (okL and okd and int(p) == int(pp) and ones and zeros):
        check(False, f"{what}: the kernel equals its plain version (L "
              f"{eL:.3e}, d {ed:.3e}, clamped {int(p)} / {int(pp)}, unit "
              f"diagonal {ones}, zeros above it {zeros})")
    return eL, ed, rel, int(p)


def phase17_ldl_leaf(ht, dev, card, timer, times):
    """The device LDLᵀ's leaf kernel (``ops/cuda_ldl.py``): on the main
    path, ldlt(method="device", spd=False) of Helmholtz(HELM_DEV_K) in c128
    at S = 1 with the kernel's launch counter and the recorder's counters
    set to 0 just before its factorization and solve and read just after
    (its launches equal ``solver.ldl_leaf_kernels``; no plain base case)
    and the leaves' shapes noted as they pass; then the kernel at each of
    those shapes in the four types against its plain version
    (``device_mf._ldl_plain`` on the card, LEAF_RTOL, equal clamped pivots);
    then at LEAF_TIMED in c128 the kernel and the plain version, each
    captured as a CUDA graph (as the factor graph holds them), replayed in
    turns beside the byte bound (lower triangle read, L and d written,
    once). Returns the kernel's record."""
    import warnings

    from hpclinalg_torch.ops import cuda_ldl
    from hpclinalg_torch.solver import device_mf
    from hpclinalg_torch.tools import dist_checks as dc
    from hpclinalg_torch.utils import graphs, profiling

    H = helmholtz(HELM_DEV_K)
    rng = np.random.default_rng(SEED + 17)
    bh = cplx_vec(rng, H.shape[0])
    be = ht.backend_auto(1, dtype=np.complex128, device=dev)
    A = ht.DistSparseMatrix.from_scipy(H, be)
    b = ht.DistVector.from_global(bh, be)
    leaf = device_mf._ldl_leaf
    shapes = set()

    def noted(F, *args):
        shapes.add((int(np.prod(F.shape[:-2])), F.shape[-1]))
        return leaf(F, *args)

    with warnings.catch_warnings():
        warnings.filterwarnings("error",
                                message="device multifrontal unavailable")
        cuda_ldl.ldl_leaf.launches = 0
        profiling.reset_trace()
        profiling.tracing(True)
        with dc.patched(device_mf, _ldl_leaf=noted):
            F = ht.ldlt(A, method="device", spd=False)
            x = F.solve(b).to_numpy()
        torch.cuda.synchronize()
        profiling.tracing(False)
    counters = profiling.trace_report()["counters"]
    profiling.reset_trace()
    launches = cuda_ldl.ldl_leaf.launches
    res = rel_res(H, x, bh)
    label = f"Helmholtz({HELM_DEV_K}) S=1 c128"
    check(isinstance(F, device_mf.DeviceFactorization) and launches > 0
          and launches == counters.get("solver.ldl_leaf_kernels")
          and "solver.ldl_leaf_plain" not in counters and res <= 1e-10,
          f"{label}: ldlt(method='device', spd=False) and its solve "
          f"launched the leaf kernel {launches} times, "
          f"solver.ldl_leaf_kernels {counters.get('solver.ldl_leaf_kernels')}"
          f", no plain base case; {len(shapes)} leaf shapes, residual "
          f"{res:.2e} <= 1e-10, n_perturbed {F.n_perturbed}")
    del F
    ht.clear_plan_cache("device_mf")

    errs = {}
    for dt in (torch.float32, torch.float64, torch.complex64,
               torch.complex128):
        worst = (0.0, 0.0, 0.0)
        for i, (B, n) in enumerate(sorted(shapes)):
            eps = torch.full((), LEAF_EPS, dtype=dt.to_real(), device=dev)
            eL, ed, rel, clamped = leaf_held(
                leaf_blocks(B, n, dt, dev, SEED + 17 + i), eps,
                f"ldl_leaf {B} x {n} {dt}")
            worst = tuple(map(max, worst, (eL, ed, rel)))
        errs[str(dt)] = dict(zip(("L_abs", "d_abs", "rel"), worst))
        check(True, f"ldl_leaf {dt}: every leaf shape of {label} equals "
              f"its plain version (largest relative error "
              f"{worst[2]:.3e} <= {LEAF_RTOL[dt]:g})")

    cases = {}
    for B, n in LEAF_TIMED:
        dt = torch.complex128
        F = leaf_blocks(B, n, dt, dev, SEED + 170 + n)
        eps = torch.full((), LEAF_EPS, dtype=torch.float64, device=dev)
        got = {}
        for name, fn in (("kernel", lambda: cuda_ldl.ldl_leaf(F, eps)),
                         ("plain", lambda: device_mf._ldl_plain(F, eps))):
            fn()
            torch.cuda.synchronize()
            g, out, _ = graphs.record(fn, dev)
            got[name] = (g, out)
        ms, plain = timer.turns(got["kernel"][0].replay,
                                got["plain"][0].replay)
        torch.cuda.synchronize()
        (Lk, dk, pk), (Lp, dp, pp) = got["kernel"][1], got["plain"][1]
        okL, eL = close(Lk, Lp, LEAF_RTOL[dt])
        okd, ed = close(dk, dp, LEAF_RTOL[dt])
        check(okL and okd and int(pk) == int(pp),
              f"ldl_leaf {B} x {n} c128: the replayed kernel equals the "
              f"replayed plain version (L {eL:.3e}, d {ed:.3e}, clamped "
              f"{int(pk)})")
        nbytes = B * (n * (n + 1) // 2 + n * n + n) * F.element_size()
        bms, by = case_line(f"ldl_leaf {B} x {n} c128 (graph replays)", ms,
                            plain, None, nbytes, 0.0, dt, card)
        cases[f"{B}x{n}_c128"] = {
            "ms": ms, "plain_ms": plain, "bound_ms": bms, "bound_by": by,
            "kernel_nodes": graphs.graph_nodes(got["kernel"][0]),
            "plain_nodes": graphs.graph_nodes(got["plain"][0]),
            "L_abs_err": eL, "d_abs_err": ed}
        del got, F
    first = cases[f"{LEAF_TIMED[0][0]}x{LEAF_TIMED[0][1]}_c128"]
    out = {"launches": launches, "leaf_shapes": sorted(shapes),
           "residual": res, "max_abs_err": max(
               max(e["L_abs"], e["d_abs"]) for e in errs.values()),
           "max_err_by_dtype": errs, "cases": cases,
           "ms": first["ms"], "plain_ms": first["plain_ms"],
           "library_ms": None, "bound_ms": first["bound_ms"],
           "bound_by": first["bound_by"]}
    times["phase17"] = out
    return out


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this run needs one GPU")
    t_start = time.perf_counter()
    import hpclinalg_torch as ht
    from hpclinalg_torch.ops import cuda_build, cuda_dia, cuda_ell
    from hpclinalg_torch.ops import cuda_dia_probe as k4
    from hpclinalg_torch.ops import cuda_ell_resident as k3
    from hpclinalg_torch.ops import cuda_kpayload as k5
    from hpclinalg_torch.ops import spmv as spmv_mod
    from hpclinalg_torch.solver import native
    from hpclinalg_torch.utils.warmup import build_kernels

    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    card = smi.splitlines()[0]
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    timer = Timer(dev)
    times = {}

    # ---- build: one nvcc per kernel source, all started together ---------
    t0 = time.perf_counter()
    build_kernels()
    times["build_kernels_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    check(native.load_mf() is not None and native.load_sym() is not None
          and native.load_ell() is not None, "host C++ engines built")
    times["build_native_s"] = time.perf_counter() - t0
    print(f"build: nvcc {cuda_build.build_seconds} s; kernels "
          f"{times['build_kernels_s']:.2f} s; host engines "
          f"{times['build_native_s']:.2f} s")

    rng = np.random.default_rng(SEED)
    n = N
    L1000 = laplace2d(K)
    xh = rng.standard_normal(n)
    errs = {"dia": 0.0, "ell": 0.0, "gather": 0.0, "resident": 0.0}
    bench = {}

    # ---- phase 1: K1 against its twin -------------------------------------
    print("phase 1: K1 dia_spmv against dia_spmv_plain, bit for bit",
          flush=True)
    for S in (1, 4):
        for dt, npdt in ((torch.float32, np.float32), (torch.float64, np.float64)):
            be = ht.backend_auto(S, dtype=npdt, device=dev)
            A = ht.DistSparseMatrix.from_scipy(L1000, be)
            x = ht.DistVector.from_global(xh, be)
            plan, g, pad_to = engine_inputs(A, x)
            check(plan.offsets is not None,
                  f"laplace2d({K}) S={S} takes the DIA engine "
                  f"({len(plan.offsets or ())} offsets in the gathered space)")
            dval = spmv_mod._dia_values(A, plan)
            args = (dval, g, plan.offsets, plan.bias_lo, plan.bias_hi, pad_to)
            errs["dia"] = max(errs["dia"], k1_check(
                f"laplace2d({K}) S={S}", args, True))
            yh = (A @ x).to_numpy()
            ok, err = close(torch.from_numpy(yh),
                            torch.from_numpy(L1000 @ xh.astype(npdt)),
                            K1_RTOL[dt])
            check(ok, f"A @ x S={S} {dt} against scipy, max_abs_err={err:.3e}")
            bench[("dia", S, dt)] = (
                lambda a=args: cuda_dia.dia_spmv(*a),
                lambda a=args: cuda_dia.dia_spmv_plain(*a),
                csr_call(L1000, dt, dev, xh), dia_bytes(plan, dval, dt),
                2 * A.nnz())
            if S == 1 and dt == torch.float32:
                lap_f32 = args
    W3 = wide_span(n)
    offs = (-(3 * n // 10), 0, 3 * n // 10)
    for dt, npdt in ((torch.float32, np.float32), (torch.float64, np.float64)):
        be = ht.backend_auto(1, dtype=npdt, device=dev)
        A = ht.DistSparseMatrix.from_scipy(W3, be)
        x = ht.DistVector.from_global(xh, be)
        plan, g, pad_to = engine_inputs(A, x)
        check(plan.offsets == offs, "wide-span pattern takes the DIA engine")
        args = (spmv_mod._dia_values(A, plan), g, plan.offsets, plan.bias_lo,
                plan.bias_hi, pad_to)
        errs["dia"] = max(errs["dia"], k1_check("wide span", args, True))
        bench[("dia_wide", 1, dt)] = (
            lambda a=args: cuda_dia.dia_spmv(*a),
            lambda a=args: cuda_dia.dia_spmv_plain(*a),
            csr_call(W3, dt, dev, xh), dia_bytes(plan, args[0], dt),
            2 * A.nnz())
    # the scalar kernel: an odd Lrow (laplace2d(999)'s table cut to its
    # 998001 rows) and a g that starts 4 bytes off 16
    L999 = laplace2d(K - 1)
    be = ht.backend_auto(1, dtype=np.float64, device=dev)
    A = ht.DistSparseMatrix.from_scipy(L999, be)
    x = ht.DistVector.from_global(xh[: L999.shape[0]], be)
    plan, g, pad_to = engine_inputs(A, x)
    dval = spmv_mod._dia_values(A, plan)[:, :, : L999.shape[0]].contiguous()
    args = (dval, g, plan.offsets, plan.bias_lo, plan.bias_hi, pad_to)
    errs["dia"] = max(errs["dia"], k1_check(
        f"laplace2d({K - 1}), odd Lrow {L999.shape[0]}", args, False))
    bench[("dia_odd", 1, torch.float64)] = (
        lambda a=args: cuda_dia.dia_spmv(*a),
        lambda a=args: cuda_dia.dia_spmv_plain(*a),
        csr_call(L999, torch.float64, dev, xh[: L999.shape[0]]),
        (dval.shape[1] + 2) * dval.shape[2] * 8, 2 * A.nnz())
    errs["dia"] = max(errs["dia"], k1_check(
        f"laplace2d({K}), g 4 bytes off 16",
        (lap_f32[0], misaligned(lap_f32[1])) + lap_f32[2:], False))

    # ---- phase 2: K2 against its twin -------------------------------------
    print("phase 2: K2 ell_spmv and gather against their twins", flush=True)
    R8 = random_8(n, SEED + 1)
    PL = power_law(n, SEED + 2)
    sweep = {}          # f64 K2 cases whose group width is swept in phase 4
    for name, M, dts in (("random8", R8, (torch.float32, torch.float64)),
                         ("power_law", PL, (torch.float32, torch.float64))):
        for dt in dts:
            npdt = np.float32 if dt == torch.float32 else np.float64
            be = ht.backend_auto(1, dtype=npdt, device=dev)
            A = ht.DistSparseMatrix.from_scipy(M, be)
            x = ht.DistVector.from_global(xh, be)
            plan, g, pad_to = engine_inputs(A, x)
            check(plan.ell, f"{name} takes the ELL engine (W={plan.ell_W}, "
                  f"Tpad={plan.ell_Tpad})")
            if name == "power_law":
                check(plan.ell_Tpad > 0, "power-law matrix has a COO tail")
            args, kw, _ = ell_call(plan, A, g, pad_to)
            yk = cuda_ell.ell_spmv(*args, **kw)
            yp = cuda_ell.ell_spmv_plain(*args)
            lib = csr_call(M, dt, dev, xh)
            yl = lib()
            torch.cuda.synchronize()
            ok, err = close(yk, yp, K2_RTOL[dt])
            okl, errl = close(yl, yp[0, : M.shape[0]], K2_RTOL[dt])
            check(ok and okl, f"K2 {name} {dt} (lanes {kw['lanes']}) "
                  f"max_abs_err={err:.3e}, the library call's {errl:.3e} "
                  f"(rtol {K2_RTOL[dt]:g} of max|y|; the tail's atomics "
                  "sum in no fixed order)")
            errs["ell"] = max(errs["ell"], err)
            bench[(name, 1, dt)] = (
                lambda a=args, k=kw: cuda_ell.ell_spmv(*a, **k),
                lambda a=args: cuda_ell.ell_spmv_plain(*a), lib,
                ell_bytes(plan, A, dt), 2 * A.nnz())
            if dt == torch.float64:
                sweep[name] = (args, kw)
    # four stacked shards, each with its own rows and tail, in one launch
    PL4 = power_law(n // 10, SEED + 3)
    for dt in (torch.float32, torch.float64):
        be = ht.backend_auto(4, dtype=np.float32 if dt == torch.float32
                             else np.float64, device=dev)
        A = ht.DistSparseMatrix.from_scipy(PL4, be)
        x = ht.DistVector.from_global(xh[: PL4.shape[1]], be)
        plan, g, pad_to = engine_inputs(A, x)
        args, kw, _ = ell_call(plan, A, g, pad_to)
        yk = cuda_ell.ell_spmv(*args, **kw)
        yp = cuda_ell.ell_spmv_plain(*args)
        torch.cuda.synchronize()
        ok, err = close(yk, yp, K2_RTOL[dt])
        check(ok and plan.ell_Tpad > 0, f"K2 power_law {PL4.shape[0]} rows "
              f"S=4 {dt} (W={plan.ell_W}, Tpad={plan.ell_Tpad}, lanes "
              f"{kw['lanes']}) max_abs_err={err:.3e} (rtol {K2_RTOL[dt]:g})")
        errs["ell"] = max(errs["ell"], err)
    src_h = rng.integers(0, n, D).astype(np.int32)
    src_h[rng.random(D) < 0.03] = -1
    cuda_ell.check_index("gather src", src_h, n, dead_below_zero=True)
    src = torch.from_numpy(src_h).to(dev)[None]
    for dt in (torch.float32, torch.float64):
        xg = torch.from_numpy(xh).to(dev, dt)[None]
        xe = cuda_ell.gather(xg, src)
        xp = cuda_ell.gather_plain(xg, src)
        torch.cuda.synchronize()
        err = float((xe - xp).abs().max())
        errs["gather"] = max(errs["gather"], err)
        # the library yardstick: index_select on x with a zero slot appended,
        # dead slots pointed at it
        xz = torch.cat([xg[0], xg.new_zeros(1)])
        idx = torch.where(src[0] < 0, n, src[0])
        xl = torch.index_select(xz, 0, idx)
        torch.cuda.synchronize()
        check(torch.equal(xe, xp) and torch.equal(xl, xp[0]),
              f"K2 gather mode {dt} at {D} slots is bit-exact "
              f"(max_abs_err={err:.3e}), and so is index_select")
        bench[("gather", 1, dt)] = (
            lambda a=(xg, src): cuda_ell.gather(*a),
            lambda a=(xg, src): cuda_ell.gather_plain(*a),
            lambda a=(xz, idx): torch.index_select(a[0], 0, a[1]),
            D * 4 + n * dt.itemsize + D * dt.itemsize, 0)
    # the gather at an odd length, from a source table 4 bytes off 16, and
    # on two shards of an odd width
    x2 = torch.from_numpy(xh).to(dev, torch.float64).expand(2, n).contiguous()
    half = D // 2 - 1
    for what, (xa, sa) in {
            f"{D - 3} slots": (x2[:1], src[:, : D - 3]),
            f"{D - 1} slots 4 bytes off 16": (x2[:1], src[:, 1:]),
            f"2 shards x {half} slots": (x2, src[0, : 2 * half].view(2, half))
    }.items():
        check(torch.equal(cuda_ell.gather(xa, sa),
                          cuda_ell.gather_plain(xa, sa)),
              f"K2 gather mode float64 at {what} is bit-exact")
    # the same bytes with the x reads in order: what the random pattern costs
    src_seq = (torch.arange(D, dtype=torch.int32, device=dev) % n)[None]
    src_sorted = torch.sort(src[0]).values[None]

    # ---- phase 3: the main path through the public API, f64 ----------------
    print("phase 3: main path (public API, f64)", flush=True)
    be = ht.backend_auto(1, dtype=np.float64, device=dev)
    A = ht.DistSparseMatrix.from_scipy(L1000, be)
    Ar = ht.DistSparseMatrix.from_scipy(R8, be)
    bh = np.random.default_rng(SEED + 3).standard_normal(n)
    b = ht.DistVector.from_global(bh, be)
    xv = ht.DistVector.from_global(xh, be)

    A @ xv, Ar @ xv   # plan builds are set-up, outside the counted run
    cg(A, b, 3)       # so is the first use of cuBLAS (the dots) and others
    torch.cuda.synchronize()

    for f in (cuda_dia.dia_spmv, cuda_ell.ell_spmv, cuda_ell.gather):
        f.launches = 0
    y = (A @ xv).to_numpy()
    ok, err = close(torch.from_numpy(y), torch.from_numpy(L1000 @ xh), 1e-12)
    check(ok, f"A @ x laplace2d({K}) against scipy, max_abs_err={err:.3e}")
    c0 = cuda_dia.dia_spmv.launches
    ev0, ev1 = torch.cuda.Event(enable_timing=True), \
        torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    ev0.record()
    xk, rk = cg(A, b, 200)
    times["cg_step_host_enqueue_ms"] = (time.perf_counter() - t0) * 1e3 / 200
    ev1.record()
    torch.cuda.synchronize()
    times["cg_step_ms"] = ev0.elapsed_time(ev1) / 200
    check(cuda_dia.dia_spmv.launches - c0 >= 200,
          f"200 CG steps launched K1 {cuda_dia.dia_spmv.launches - c0} times")
    rn, bn = float(rk.norm()), float(np.linalg.norm(bh))
    check(np.isfinite(rn) and rn < bn, f"CG residual fell: {rn:.4e} < {bn:.4e}")
    yr = (Ar @ xv).to_numpy()
    ok, err = close(torch.from_numpy(yr), torch.from_numpy(R8 @ xh), 1e-12)
    check(ok, f"A @ x random {n} x 8 against scipy, max_abs_err={err:.3e}")
    check(cuda_ell.ell_spmv.launches > 0 and cuda_ell.gather.launches > 0,
          f"random A @ x launched K2 {cuda_ell.ell_spmv.launches} times and "
          f"its gather mode {cuda_ell.gather.launches} times")
    L100 = laplace2d(100)
    A100 = ht.DistSparseMatrix.from_scipy(L100, be)
    b100h = np.random.default_rng(SEED + 4).standard_normal(L100.shape[0])
    b100 = ht.DistVector.from_global(b100h, be)
    t0 = time.perf_counter()
    F = ht.ldlt(A100)
    x100 = F.solve(b100).to_numpy()
    times["ldlt_factor_solve_first_s"] = time.perf_counter() - t0
    res = np.linalg.norm(L100 @ x100 - b100h) / np.linalg.norm(b100h)
    check(F.native is not None and res <= 1e-12,
          f"ldlt(laplace2d(100)).solve: native engine, residual {res:.2e}")
    ht.clear_plan_cache("backslash")
    ht.solve(A100, b100)
    cache = ht.BackslashCache._cache()
    F1 = next(iter(cache.values()))
    L100b = (2.0 * L100 + sp.eye(L100.shape[0])).tocsr()
    A100b = A100.with_values(ht.DistSparseMatrix.from_scipy(L100b, be).nzval)
    xb = ht.solve(A100b, b100).to_numpy()
    res = np.linalg.norm(L100b @ xb - b100h) / np.linalg.norm(b100h)
    check(len(cache) == 1 and next(iter(cache.values())) is F1
          and F1.A is A100b and res <= 1e-12,
          f"second solve with new values hit the backslash cache "
          f"(residual {res:.2e})")
    # unsymmetric values on the Laplacian's own pattern keep the factor sparse
    Lu = L100.copy()
    Lu.data = Lu.data * (1.0 + 0.2 * np.random.default_rng(SEED + 5)
                         .random(Lu.nnz))
    xu = ht.lu(ht.DistSparseMatrix.from_scipy(Lu, be)).solve(b100).to_numpy()
    res = np.linalg.norm(Lu @ xu - b100h) / np.linalg.norm(b100h)
    check(res <= 1e-10, f"lu on an unsymmetric perturbation: residual {res:.2e}")
    launches = {"dia": cuda_dia.dia_spmv.launches,
                "ell": cuda_ell.ell_spmv.launches,
                "gather": cuda_ell.gather.launches}
    print(f"main-path launches: {launches}")

    # the same 200 CG steps with the twin in place of K1 (a comparison run)
    orig = spmv_mod.dia_spmv
    spmv_mod.dia_spmv = cuda_dia.dia_spmv_plain
    try:
        xp, rp = cg(A, b, 200)
    finally:
        spmv_mod.dia_spmv = orig
    torch.cuda.synchronize()
    ok, err = close(xk.data, xp.data, 1e-9)
    check(ok, f"200 CG iterates with K1 equal those with the twin to rtol "
          f"1e-9 (max_abs_err={err:.3e})")

    # ---- phase 4: times ----------------------------------------------------
    print(f"phase 4: times on {card} (median of 20, L2 flushed)", flush=True)
    kt = {}
    for key, (fk, fp, fl, nbytes, flops) in bench.items():
        ms, plain, lib = timer.turns(fk, fp, fl)
        name, S, dt = key
        kt[key] = (ms, plain, lib) + case_line(
            f"{name} S={S} {str(dt).replace('torch.', '')}", ms, plain, lib,
            nbytes, flops, dt, card)
    for key in [k for k in bench if k[0].startswith("dia")]:
        # K1's own kernels by name, the better of two rounds
        us = min(sum(t for nm, t in kernel_times(
            bench[key][0], timer.flush.sum, set()).items()
            if nm.startswith("void dia_")) for _ in range(2))
        print(f"  {key[0]} S={key[1]} {str(key[2]).replace('torch.', '')} "
              f"device time: {us:.1f} us  [{card}]", flush=True)
    args, kw = sweep["power_law"]
    for name, us in device_kernels(lambda: cuda_ell.ell_spmv(*args, **kw)):
        print(f"  K2 power_law f64 device time: {us:9.1f} us  {name[:60]}  "
              f"[{card}]", flush=True)
    for name, (args, kw) in sweep.items():
        lanes_sweep(timer, f"K2 {name} f64", args, kw, card)
    xg = torch.from_numpy(xh).to(dev, torch.float64)[None]
    print(f"  gather f64, {D} slots, same bytes: random src "
          f"{timer.ms(lambda: cuda_ell.gather(xg, src)):.4f} ms, sorted src "
          f"{timer.ms(lambda: cuda_ell.gather(xg, src_sorted)):.4f} ms, "
          f"sequential src {timer.ms(lambda: cuda_ell.gather(xg, src_seq)):.4f}"
          f" ms  [{card}]", flush=True)
    for name, us in device_kernels(lambda: cg(A, b, 20), top=8):
        print(f"  CG step device time by kernel: {us / 20:8.2f} us a step  "
              f"{name[:60]}  [{card}]", flush=True)
    cg_us, nspans = device_us(lambda: cg(A, b, 20))
    if nspans:
        times["cg_step_device_us"] = cg_us / 20
        times["cg_step_device_busy_share"] = \
            times["cg_step_device_us"] / (1e3 * times["cg_step_ms"])
        print(f"  CG step device activity: {nspans / 20:g} kernels/copies "
              "per step (torch.profiler, 20 steps)")
    else:
        print("  CG step device time: not measured (the profiler traced no "
              "device activity)")
    for k, v in times.items():
        print(f"  {k}: {v:.4f}  [{card}]")

    # ---- phase 5: K3 against its plain version and K2 ----------------------
    print("phase 5: K3 ell_resident_spmv against its plain version and K2",
          flush=True)
    Ab, bh_r = banded_design(RIDGE_M, RIDGE_N, SEED + 8)
    N_sc = (Ab.T @ Ab + RIDGE_LAMBDA * sp.eye(RIDGE_N)).tocsr()
    N_sc.sort_indices()
    bench3, sweep3 = {}, {}
    phase5_k3(ht, dev, Ab, N_sc, rng, errs, bench3, sweep3)

    # ---- phase 6: the ridge path through the public API, f64 ---------------
    print(f"phase 6: ridge path, A {RIDGE_M} x {RIDGE_N} (public API, f64)",
          flush=True)
    launches6 = {}
    for S in (1, 4):
        for key, v in phase6_ridge(ht, dev, Ab, bh_r, N_sc, S, timer, card,
                                   times).items():
            launches6[key] = launches6.get(key, 0) + v
    spgemm_laplace(ht, dev)
    for key, v in launches6.items():
        launches[key] = launches.get(key, 0) + v
    print(f"main-path launches (phases 3 and 6): {launches}")
    for key, (f3, f2, fp, fl, nbytes, flops) in bench3.items():
        t3, t2, tp, tl = timer.turns(f3, f2, fp, fl)
        name, S, dt = key
        kt[("k3",) + key] = (t3, tp, tl) + case_line(
            f"K3 {name} S={S} {str(dt).replace('torch.', '')} (K2 "
            f"{t2:.4f} ms)", t3, tp, tl, nbytes, flops, dt, card)
    for name, (plan, args, kw2, kw3) in sweep3.items():
        lanes_sweep(timer, f"K2 {name} f64", args, kw2, card)
        tile_sweep(timer, f"K3 {name} f64", plan, args, kw3, card)
    f3, f2 = bench3[("N", 1, torch.float64)][:2]
    w3, w2 = timer.turns(f3, f2, cold=False)
    print(f"  K3 N S=1 float64 with L2 warm (no flush; N's tables stay in L2 "
          f"across CG steps): K3 {w3:.4f} ms, K2 {w2:.4f} ms  [{card}]",
          flush=True)

    # ---- phase 7: the probe tools ------------------------------------------
    print(f"phase 7: the probes (python -m hpclinalg_torch.tools.*, f32) on "
          f"{card}", flush=True)
    launches7, proto, dv, kp = phase7_probes()
    launches["dia"] += launches7["dia"]
    # the library yardstick of K1 and K4 at the probes' k = 2000 (f32)
    x2000 = np.random.default_rng(SEED + 11).standard_normal(2000 ** 2)
    csr2000 = csr_call(laplace2d(2000), torch.float32, dev, x2000)
    csr2000_ms = min(timer.ms(csr2000), timer.ms(csr2000))
    print(f"  cuSPARSE CSR SpMV, laplace2d(2000) f32 (the library call of "
          f"K1 and K4 dia_flat_spmv at k = 2000): {csr2000_ms:.4f} ms  "
          f"[{card}]", flush=True)
    k5_lib_ms = probe_bounds(dv, proto, kp, timer, card, {
        1000: kt[("dia", 1, torch.float32)][2], 2000: csr2000_ms})

    # ---- phase 8: the dense path through the public API, f64 ---------------
    print("phase 8: dense path (SpMM, multi-response ridge, dense ops; public "
          "API, f64)", flush=True)
    phase8_dense(ht, dev, R8, L1000, Ab, timer, card, times)

    # ---- phase 9: the device solver through the public API, f64 -------------
    print(f"phase 9: device solver (public API, f64) on {card}", flush=True)
    launches9, t9 = timed_s(lambda: phase9_device_solver(ht, dev, card,
                                                         times, timer))
    print(f"phase 9 launches (device solves): {launches9}; phase 9 took "
          f"{t9:.1f} s")
    for key, v in launches9.items():
        launches[key] += v

    # ---- phase 10: the saddle-point assembly through the public API, f64 ----
    print(f"phase 10: saddle-point assembly, K = [[A, B^T], [B, -dI]] with A = "
          f"laplace2d({K}), B {KKT_M} x {N} (public API, f64) on {card}",
          flush=True)
    launches10, t10 = timed_s(lambda: phase10_kkt(card, times))
    print(f"phase 10 launches: {launches10}; phase 10 took {t10:.1f} s  "
          f"[{card}]", flush=True)

    # ---- phase 11: complex values (public API, c64 and c128) ----------------
    print(f"phase 11: complex values, K1 on Helmholtz({HELM_K}), K2 on the "
          f"random and power-law matrices, K3 on N, the complex device LDL "
          f"and LU (public API, c64 and c128) on {card}", flush=True)
    (launches11, errs11, timed11), t11 = timed_s(lambda: phase11_complex(
        ht, dev, R8, PL, N_sc, timer, card, times))
    print(f"phase 11 launches (drives): {launches11}; phase 11 took "
          f"{t11:.1f} s  [{card}]", flush=True)
    check(all(v > 0 for per in launches11.values() for v in per.values()),
          "phase 11 launched K1, K2 and K3 each in c64 and in c128")

    # ---- phase 12: shards on separate processes (public API, f64/f32) ------
    print(f"phase 12: one shard a process (ht.backend_dist): NCCL world 1, "
          f"gloo world {DIST_WORLD} on one card, NCCL over every card; K1, "
          f"K2, its gather mode and K3 in every rank on {card}", flush=True)
    from hpclinalg_torch.tools.dist_checks import card_matrices

    mats = card_matrices(K, N, (RIDGE_M, RIDGE_N, RIDGE_LAMBDA), SEED)
    dist_launches, t12 = timed_s(lambda: phase12_dist(ht, dev, card, times,
                                                      mats))
    print(f"phase 12 launches per rank: {dist_launches}; phase 12 took "
          f"{t12:.1f} s  [{card}]", flush=True)

    # ---- phase 13: the device solver and the dense containers, per process --
    print(f"phase 13: one shard a process, the device Cholesky of laplace2d("
          f"{DEV_K}), LDL/LU/c128 LDL at {DEV_K_SMALL}^2, the multi-response "
          f"ridge (Y {RIDGE_M} x {RIDGE_K}); NCCL world 1, gloo world "
          f"{DIST_WORLD} on one card on {card}", flush=True)
    sol_launches, t13 = timed_s(lambda: phase13_solvers(ht, dev, card, times,
                                                        mats))
    del mats
    print(f"phase 13 launches per rank: {sol_launches}; phase 13 took "
          f"{t13:.1f} s  [{card}]", flush=True)

    # ---- phase 14: the saddle-point assembly, one shard a process ----------
    print(f"phase 14: one shard a process, the saddle-point assembly of phase "
          f"10 (K {K * K + KKT_M} rows) in every rank; NCCL world 1, gloo "
          f"world {DIST_WORLD} on one card on {card}", flush=True)
    kkt_dist, t14 = timed_s(lambda: phase14_assembly(card, times))
    print(f"phase 14 launches per rank: {kkt_dist}; phase 14 took "
          f"{t14:.1f} s  [{card}]", flush=True)

    # ---- phase 15: the compiled CG step, captured as a CUDA graph ----------
    print(f"phase 15: the JAX entry point's CG step (hpclinalg_torch.entry: "
          f"cg_step_fn, entry, capture) as a CUDA graph, cases (i)-(v), then "
          f"NCCL world 1 and gloo world {DIST_WORLD} on {card}", flush=True)
    (graph_launches, graph_dist), t15 = timed_s(
        lambda: phase15_entry(ht, dev, card, times))
    print(f"phase 15 launches (cases): {graph_launches}; per rank: "
          f"{graph_dist}; phase 15 took {t15:.1f} s  [{card}]", flush=True)

    # ---- phase 16: the CG step's vector kernels at HPCG's size -----------
    print(f"phase 16: the CG step's vector kernels (cg_dots, cg_update_xr, "
          f"cg_update_p) on HPCG's 27-point operator at {HPCG_K}^3, f64, "
          f"S = 1 on {card}", flush=True)
    cgk, t16 = timed_s(lambda: phase16_cg_vec(ht, dev, card, timer, times))
    print(f"phase 16 took {t16:.1f} s  [{card}]", flush=True)

    # ---- phase 17: the device LDLᵀ's leaf kernel ---------------------------
    print(f"phase 17: the device LDLT's leaf kernel (ldl_leaf) on the "
          f"c128 factorization of Helmholtz({HELM_DEV_K}), at its leaf "
          f"shapes in f32, f64, c64 and c128, and timed at {LEAF_TIMED} "
          f"in c128 on {card}", flush=True)
    ldk, t17 = timed_s(lambda: phase17_ldl_leaf(ht, dev, card, timer, times))
    print(f"phase 17 took {t17:.1f} s  [{card}]", flush=True)

    f64 = torch.float64
    v4 = dv[2000]["v4"]
    streams = [dv[k][v] for k in dv for v in ("skern", "v3", "v5_d2", "v5_d3")]

    def timed(key):
        ms, plain, lib, bms, by = kt[key]
        return {"ms": ms, "plain_ms": plain, "library_ms": lib,
                "bound_ms": bms, "bound_by": by}

    def probe(rec, nbytes, lib):
        bms, by = bound_ms(nbytes)
        return {"ms": rec["ms"], "plain_ms": rec["plain_ms"],
                "library_ms": lib, "bound_ms": bms, "bound_by": by}

    record = {"kernels": [
        {"name": "dia_spmv (K1: dia_vec, dia_scalar)", "route": "cuda",
         "variants": ["dia_vec", "dia_scalar"],
         "source": "hpclinalg_torch/csrc/dia_spmv.cu",
         "replaces": "hpclinalg/ops/pallas_dia.py:60",
         "launches": launches["dia"],
         "device_solver_launches": launches9["dia"],
         "kkt_launches": launches10["dia"],
         "kkt_dist_launches": kkt_dist["dia"],
         "dist_launches": dist_launches["dia"],
         "dist_solver_launches": sol_launches["dia"],
         "graph_launches": graph_launches["dia"],
         "graph_dist_launches": graph_dist["dia"],
         "max_abs_err": errs["dia"],
         **timed(("dia", 1, f64))},
        {"name": "ell_spmv (K2)", "route": "cuda",
         "source": "hpclinalg_torch/csrc/ell_spmv.cu",
         "replaces": "hpclinalg/ops/pallas_shuffle.py:321",
         "launches": launches["ell"], "kkt_launches": launches10["ell"],
         "kkt_dist_launches": kkt_dist["ell"],
         "dist_launches": dist_launches["ell"],
         "dist_solver_launches": sol_launches["ell"],
         "graph_launches": graph_launches["ell"],
         "max_abs_err": errs["ell"],
         **timed(("random8", 1, f64))},
        {"name": "gather (K2 gather-only mode)", "route": "cuda",
         "source": "hpclinalg_torch/csrc/ell_spmv.cu",
         "replaces": "hpclinalg/ops/pallas_shuffle.py:548",
         "launches": launches["gather"],
         "device_solver_launches": launches9["gather"],
         "kkt_launches": launches10["gather"],
         "kkt_dist_launches": kkt_dist["gather"],
         "dist_launches": dist_launches["gather"],
         "dist_solver_launches": sol_launches["gather"],
         "graph_launches": graph_launches["gather"],
         "graph_dist_launches": graph_dist["gather"],
         "max_abs_err": errs["gather"],
         **timed(("gather", 1, f64))},
        {"name": "ell_resident_spmv (K3)", "route": "cuda",
         "source": "hpclinalg_torch/csrc/ell_resident_spmv.cu",
         "replaces": "hpclinalg/ops/pallas_csr.py:123",
         "launches": launches["resident"],
         "kkt_launches": launches10["resident"],
         "dist_launches": dist_launches["resident"],
         "dist_solver_launches": sol_launches["resident"],
         "graph_launches": graph_launches["resident"],
         "max_abs_err": errs["resident"],
         **timed(("k3", "N", 1, f64))},
        {"name": "dia_flat_spmv (K4)", "route": "cuda",
         "source": "hpclinalg_torch/csrc/dia_probe.cu",
         "replaces": "tools/probe_dia_kernels.py:222",
         "launches": launches7["dia_flat"],
         "max_abs_err": max(dv[k][v]["err"] for k in dv for v in ("v4", "v1")),
         **probe(v4, (v4["O"] + 2) * v4["n"] * 4, csr2000_ms)},
        {"name": "table_stream (K4)", "route": "cuda",
         "source": "hpclinalg_torch/csrc/dia_probe.cu",
         "replaces": "tools/probe_dia_kernels.py:169",
         "launches": launches7["stream"],
         "max_abs_err": max(r["err"] for r in streams),
         **probe(dv[2000]["v3"], (v4["O"] + 1) * v4["n"] * 4,
                 dv[2000]["v3"]["lib_ms"])},
        {"name": "kpayload (K5)", "route": "cuda",
         "source": "hpclinalg_torch/csrc/kpayload.cu",
         "replaces": "tools/probe_kpayload.py:40",
         "launches": launches7["kpayload"], "max_abs_err": kp["err"],
         **probe(kp, kp["bound_bytes"], k5_lib_ms),
         "sector_floor_ms": kp["sector_floor_ms"]},
    ] + [
        {"name": f"{k} (CG step: {what})", "route": "cuda",
         "source": "hpclinalg_torch/csrc/cg_vec.cu",
         "replaces": "none: XLA fuses the JAX step's vector work "
                     "(__graft_entry__.py _cg_step_fn)",
         "plain": "entry.cg_step_fn's plain step",
         "graph_launches": graph_launches[k],
         "graph_dist_launches": graph_dist[k], **cgk[k]}
        for k, what in (("cg_dots", "p.Ap, r.r"),
                        ("cg_update_xr", "x + alpha p, r - alpha Ap, r'.r'"),
                        ("cg_update_p", "r' + beta p"))
    ] + [
        {"name": "ldl_leaf (the device LDLT's base case)", "route": "cuda",
         "source": "hpclinalg_torch/csrc/ldl_leaf.cu",
         "replaces": "none: the JAX engine's recursion runs to 1 x 1 blocks "
                     "(hpclinalg/solver/device_mf.py:452)",
         "plain": "solver/device_mf._ldl_plain",
         "dtypes": ["float32", "float64", "complex64", "complex128"],
         "dist_solver_launches": sol_launches["ldl_leaf"], **ldk},
    ] + [
        {"name": name, "route": "cuda", "source": source,
         "replaces": replaces, "dtypes": ["complex64", "complex128"],
         "launches": sum(launches11[key].values()),
         "launches_by_dtype": launches11[key],
         "max_abs_err": max(errs11[key].values()),
         "max_abs_err_by_dtype": errs11[key], **timed11[key]}
        for key, name, source, replaces in (
            ("dia", "dia_spmv complex (K1: dia_vec in c64, c128)",
             "hpclinalg_torch/csrc/dia_spmv.cu",
             "hpclinalg/ops/pallas_dia.py:60"),
            ("ell", "ell_spmv complex (K2: ell_rows, ell_tail in c64, c128)",
             "hpclinalg_torch/csrc/ell_spmv.cu",
             "hpclinalg/ops/pallas_shuffle.py:321"),
            ("resident", "ell_resident_spmv complex (K3 in c64, c128)",
             "hpclinalg_torch/csrc/ell_resident_spmv.cu",
             "hpclinalg/ops/pallas_csr.py:123"))]}
    print(f"chip_smoke took {time.perf_counter() - t_start:.1f} s, the build "
          f"included  [{card}]")
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
