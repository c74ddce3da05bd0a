"""The plain references against the program's outputs on the CPU, at small
sizes: a k = 8 HPCG grid and a 16^2 variable-coefficient Poisson problem;
then each cell's whole run through the harness on the CPU."""

import json

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from pbcore import grids, main
from pbcore.env import forbidden_loaded
from pbtest_util import cpu_run, small_cell
from reference import hpcg, poisson


def test_hpcg_step_and_product_match_the_program():
    import hpclinalg_torch as ht
    from hpclinalg_torch.entry import cg_step_fn

    dims = (8, 8, 8)
    A = grids.hpcg27(dims)
    be = ht.backend_auto(1, device="cpu")
    Ad = ht.DistSparseMatrix.from_scipy(A, be)
    gen = torch.Generator().manual_seed(11)
    b = hpcg.stencil27(torch.randn(A.shape[0], generator=gen,
                                   dtype=torch.float64), dims)
    y = (Ad @ ht.DistVector.from_global(b.numpy(), be)).to_numpy()
    np.testing.assert_allclose(y, hpcg.stencil27(b, dims).numpy(),
                               rtol=1e-14, atol=1e-12)
    step, x0 = cg_step_fn(Ad, be)
    x, r, p = x0.data, b[None].clone(), b[None].clone()
    for _ in range(12):
        x, r, p = step(x, r, p)
    xr, rr = hpcg.cg(lambda v: hpcg.stencil27(v, dims), b, 12)
    assert float(torch.linalg.vector_norm(x[0] - xr)
                 / torch.linalg.vector_norm(xr)) < 1e-13
    assert float(torch.linalg.vector_norm(r[0] - rr)
                 / torch.linalg.vector_norm(rr)) < 1e-9


def test_poisson_device_cholesky_matches_the_reference():
    import hpclinalg_torch as ht

    k = 16
    gen = torch.Generator().manual_seed(12)
    ch, cv = grids.conductivities(1, k, 0.5, 1.5, gen, "cpu")
    L = grids.laplace2d(k)
    L.sort_indices()
    M = sp.csr_matrix((grids.poisson_values(ch, cv)[0].numpy(), L.indices,
                       L.indptr), shape=L.shape)
    be = ht.backend_auto(1, device="cpu")
    F = ht.ldlt(ht.DistSparseMatrix.from_scipy(M, be), method="device",
                spd=True)
    b = torch.randn(k * k, generator=gen, dtype=torch.float64)
    x = F.solve(ht.DistVector.from_global(b.numpy(), be)).to_numpy()
    assert poisson.relative_residual(ch[0], cv[0], torch.from_numpy(x),
                                     b) < 1e-13
    # a wrong solution reads as one
    assert poisson.relative_residual(ch[0], cv[0], torch.from_numpy(x),
                                     2 * b) > 0.4


@pytest.mark.parametrize("name, ranks", [("hpcg-104.cg50", 1),
                                         ("poisson2d-512-chol.refactor", 1),
                                         ("hpcg-104.cg50", 4)])
@pytest.mark.parametrize("traced", [False, True])
def test_a_sound_run_on_the_cpu_is_correct(name, ranks, traced):
    cell = small_cell(name, ranks)
    rec = cpu_run(cell, trace=traced)
    assert rec.correct and rec.failed == 0 and rec.attempted >= 1
    assert rec.notes["plans_built_in_window"] == {}
    assert set(rec.checks) == set(cell.config["limits"])
    if not traced:
        # the result line holds exactly the cell's end-to-end metrics
        rec.kind = "cpu"
        line = json.loads(main.report(cell, rec, False))
        assert set(line["metrics"]) == {m["name"] for m in cell.end_to_end}
    if traced:
        assert rec.trace is not None and rec.trace.window_s > 0
        if "local_grid" in cell.config:
            # rank 0's rows, entries and x columns, by hand: 8 x 8 planes
            # of 22^2 neighbour pairs a plane pair, the halo plane beside
            # them on a 4-rank 8 x 8 x 32 grid
            world = rec.world
            assert rec.rows_local == 512
            assert rec.xcols_local == (576 if world == 4 else 512)
            assert rec.nnz_local == 22 * 22 * (22 if world == 1 else 23)
    assert forbidden_loaded() == []
