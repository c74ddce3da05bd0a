"""Prototype DIA SpMV on the card: K1 on the 2-D Laplacian.

Port of the JAX package's ``tools/proto_pallas_dia.py``: laplace2d(k) with
k = 2000 (n = 4·10⁶, five diagonals) in f32, y = A @ x through the port's
public API — the SpMV plan's DIA engine, kernel K1
(``csrc/dia_spmv.cu``) — against scipy, timed against K1's plain version
on the same plan inputs (``tools/timing.Timer``: median of 20, CUDA
events, L2 flushed by a read). Prints ms and GB/s on the TPU script's
traffic formula, (O + 2)·n·4 bytes, and the error.

    python -m hpclinalg_torch.tools.proto_dia [k=2000]

Runs on a CUDA device only.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from .dia_variants import ELEM, laplace2d, plan_inputs
from .timing import Timer, card, max_rel_err, require_cuda


def main(argv=None) -> dict:
    argv = sys.argv[1:] if argv is None else argv
    k = int(argv[0]) if argv else 2000
    import hpclinalg_torch as ht
    from ..ops import cuda_dia

    dev = require_cuda()
    name = card()
    timer = Timer(dev)
    A = laplace2d(k, np.float32)
    n = A.shape[0]
    xh = np.random.default_rng(0).standard_normal(n).astype(np.float32)
    be = ht.backend_auto(1, dtype=np.float32, device=dev)
    Ad = ht.DistSparseMatrix.from_scipy(A, be)
    xv = ht.DistVector.from_global(xh, be)
    plan, args = plan_inputs(Ad, xv)
    O = len(plan.offsets)
    y = (Ad @ xv).data[0, :n]
    ref = torch.from_numpy(A.astype(np.float64) @ xh.astype(np.float64))
    err, rel = max_rel_err(y.cpu(), ref)
    ms = timer.ms(lambda: Ad @ xv)
    plain_ms = timer.ms(lambda: cuda_dia.dia_spmv_plain(*args))
    ms = min(ms, timer.ms(lambda: Ad @ xv))
    gbs = (O + 2) * n * ELEM / (ms / 1e3) / 1e9
    print(f"err: {err:.3e} (rel {rel:.2e} of max|y|, against scipy in f64)")
    print(f"K1 dia n={n}: {ms:.4f} ms  ~{gbs:.0f} GB/s effective; plain "
          f"{plain_ms:.4f} ms  [{name}]", flush=True)
    return {"n": n, "O": O, "ms": ms, "plain_ms": plain_ms, "gbs": gbs,
            "scipy_err": err, "scipy_rel_err": rel}


if __name__ == "__main__":
    main()
