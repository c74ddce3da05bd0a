"""Warmup: run tiny instances of the hot operations once.

Port of the JAX package's ``hpclinalg/utils/warmup.py`` (ref: the
PrecompileTools workload, HPCLinearAlgebra.jl:1473-1607). There is no
compile cache to fill on PyTorch; on the card the first use builds the
hand-written kernels with nvcc, so warming up builds them all (one nvcc
for each source, started together) and launches them, and a user's first
real call pays neither.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import scipy.sparse as sp

KERNEL_SOURCES = ("dia_spmv", "ell_spmv", "ell_resident_spmv", "dia_probe",
                  "kpayload", "cg_vec", "ldl_leaf", "front_solve")


def build_kernels() -> None:
    """Build and load every kernel library of ``csrc/`` and bind every
    entry point (K1-K3 in f32, f64, c64 and c128, the CG step's vector
    kernels in f32 and f64, the device LDLᵀ's leaf and the device solve's
    level steps in all four); raises when a build fails or an entry point
    is missing."""
    from ..ops import (cuda_build, cuda_cg, cuda_dia, cuda_dia_probe,
                       cuda_ell, cuda_ell_resident, cuda_front_solve,
                       cuda_kpayload, cuda_ldl)

    with ThreadPoolExecutor(len(KERNEL_SOURCES)) as pool:
        list(pool.map(cuda_build.load_kernel_lib, KERNEL_SOURCES))
    for mod in (cuda_dia, cuda_ell, cuda_ell_resident, cuda_dia_probe,
                cuda_kpayload, cuda_cg, cuda_ldl, cuda_front_solve):
        mod._lib()


def warmup(backend) -> None:
    """Run tiny versions of the hot operations on ``backend``; on a process
    group every rank calls it (its steps are collectives)."""
    from ..dense import DistDenseMatrix
    from ..solver.api import ldlt
    from ..sparse import DistSparseMatrix
    from ..vector import DistVector

    if backend.device.type == "cuda":
        build_kernels()
    n = 16
    rng = np.random.default_rng(0)
    T = sp.diags([-np.ones(n - 1), 2 * np.ones(n), -np.ones(n - 1)],
                 [-1, 0, 1]).tocsr()
    R = sp.random(n, n, 0.3, format="csr", random_state=rng) + sp.eye(n)
    A = DistSparseMatrix.from_scipy(T, backend)      # DIA engine
    B = DistSparseMatrix.from_scipy(R, backend)      # a general pattern
    x = DistVector.from_global(rng.standard_normal(n), backend)
    M = DistDenseMatrix.from_global(rng.standard_normal((n, 4)), backend)

    _ = (A @ x).data
    _ = (B @ x).data
    # complex products: on the card each launches K1's complex
    # instantiation (both small matrices take the DIA engine)
    z = DistVector.from_global(rng.standard_normal(n)
                               + 1j * rng.standard_normal(n), backend)
    _ = (A @ z).data
    _ = (B @ z).data
    _ = (A + B).nzval
    _ = (A @ B).nzval
    _ = A.transpose_materialized().nzval
    _ = (A @ M).data
    _ = x.dot(x)
    _ = x[2: n - 2].data
    F = ldlt(A)
    _ = F.solve(x)
