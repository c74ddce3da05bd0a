"""K3, the resident-x ELL SpMV: its plain version and the engine choice.

* The plain version on the JAX package's own ELL tables agrees with its TPU
  kernel ``pallas_ell_matvec`` run in interpret mode, on the inputs of
  tests/test_engines.py::test_pallas_ell_kernel_interpret (f32, rtol 1e-5
  of max|y|: both sum f32 products, in different orders).
* On the JAX package's ELL + COO-tail tables it agrees with ``_ell_exec``
  (f64, rtol 1e-12 of max|y|).
* The SpMV plan takes the resident engine when the ELL plan has at least
  MIN_NNZ entries and the gathered x fits the shared-memory cap, K2's ELL
  engine when x is over the cap (in that dtype) or nnz under MIN_NNZ, and
  DIA before either for a stencil. ``A @ x`` through it equals scipy's.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import hpclinalg as hl
import hpclinalg.ops.spmv as jspmv
import hpclinalg_torch as ht
import hpclinalg_torch.ops.spmv as tspmv
from hpclinalg_torch.ops.cuda_ell_resident import (H100_SMEM_CAP,
                                                   ell_resident_spmv,
                                                   ell_resident_spmv_plain,
                                                   smem_cap)

torch.set_num_threads(1)


def _close(got, want, rtol):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * max(1.0, float(np.abs(want).max())))


def _rows(y, part):
    y = np.asarray(y)
    return np.concatenate([y[s, : int(part[s + 1] - part[s])]
                           for s in range(y.shape[0])])


def test_plain_matches_pallas_ell_interpret():
    from hpclinalg.ops.pallas_csr import ell_pack, pallas_ell_matvec

    be4 = hl.backend_auto(nshards=4)
    rng = np.random.default_rng(17)
    n = 600
    A = sp.random(n, n, 0.02, format="csr", random_state=rng).astype(np.float32)
    Ad = hl.DistSparseMatrix.from_scipy(A, be4, dtype=np.float32)
    x = rng.standard_normal(n).astype(np.float32)
    xv = hl.DistVector.from_global(x, be4, dtype=np.float32)
    plan = jspmv.get_spmv_plan(Ad, xv)
    xb = xv.data if plan.exchange.is_identity else plan.exchange.apply(xv.data)
    yj = pallas_ell_matvec(Ad, plan, xb, interpret=True)
    vals, cols, W = ell_pack(Ad, plan)
    S, Lrow = vals.shape[:2]
    yt = ell_resident_spmv_plain(
        torch.tensor(np.asarray(vals)),
        torch.tensor(np.asarray(cols).reshape(S, Lrow * W)),
        torch.tensor(np.asarray(xb)), None, plan.exchange.out_pad)
    assert yt.dtype == torch.float32
    _close(yt.numpy(), np.asarray(yj), 1e-5)
    _close(_rows(yt.numpy(), Ad.row_partition), A @ x, 1e-5)


@pytest.mark.parametrize("S", [1, 4])
def test_plain_matches_ell_exec(S, monkeypatch):
    """A heavy row spills into the COO tail; the JAX tables go through the
    wrapper (CPU tensors: the plain version) and through _ell_exec."""
    monkeypatch.setattr(jspmv, "DENSE_MAX_ELEMS", 0)
    rng = np.random.default_rng(7)
    n = 400
    A = sp.random(n, n, 0.03, format="lil", random_state=rng)
    A[5, :200] = rng.standard_normal(200)
    A = A.tocsr()
    x = rng.standard_normal(n)
    Ad = hl.DistSparseMatrix.from_scipy(A, hl.backend_auto(nshards=S))
    xv = hl.DistVector.from_global(x, Ad.backend)
    plan = jspmv.get_spmv_plan(Ad, xv)
    assert plan.ell and plan.ell_Tpad > 0
    vals, tvals = jspmv._ell_values(Ad, plan)
    pad_to = plan.exchange.out_pad if plan.exchange.is_identity else 0
    g = xv.data if plan.exchange.is_identity else plan.exchange.apply(xv.data)
    yj = jspmv._ell_exec(Ad.structure.Lrow, plan.ell_W, plan.ell_Tpad, pad_to)(
        vals, plan.ell_cols, tvals, plan.ell_tail_rows, plan.ell_tail_gidx, g)
    t = (lambda a: torch.tensor(np.asarray(a)))
    tail = (t(tvals), t(plan.ell_tail_rows), t(plan.ell_tail_gidx))
    yt = ell_resident_spmv(t(vals), t(plan.ell_cols), t(g), tail, pad_to)
    _close(yt.numpy(), np.asarray(yj), 1e-12)
    _close(_rows(yt.numpy(), Ad.row_partition), A @ x, 1e-12)


def _cyclic(m, n, per_row):
    """m x n, per_row distinct columns (i*7 + 61k) mod n in row i: random
    enough to refuse DIA, regular enough to build fast."""
    rows = np.repeat(np.arange(m, dtype=np.int64), per_row)
    cols = ((np.arange(m)[:, None] * 7 + 61 * np.arange(per_row)) % n).ravel()
    vals = np.random.default_rng(m + n + per_row).standard_normal(m * per_row)
    return sp.csr_matrix((vals, (rows, cols)), shape=(m, n))


def laplace2d(k):
    T = sp.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(k, k))
    return (sp.kron(sp.eye(k), T) + sp.kron(T, sp.eye(k))).tocsr()


# (name, matrix, {dtype: engine})
ENGINE_CASES = [
    # nnz = 2^20, gathered x 4104 slots: 32 KiB in f64, under the cap
    ("resident", lambda: _cyclic(16384, 4096, 64),
     {torch.float64: "resident", torch.float32: "resident"}),
    # 32776 slots: 256 KiB in f64 (over the cap), 128 KiB in f32 (under)
    ("over_cap_f64", lambda: _cyclic(16384, 32768, 64),
     {torch.float64: "ell", torch.float32: "resident"}),
    # nnz just under MIN_NNZ
    ("few_nnz", lambda: _cyclic(16384, 4096, 63),
     {torch.float64: "ell", torch.float32: "ell"}),
    # 1.3M entries on 5 diagonals: DIA before any ELL engine
    ("stencil", lambda: laplace2d(512),
     {torch.float64: "dia", torch.float32: "dia"}),
]


@pytest.mark.parametrize("S", [1, 4])
@pytest.mark.parametrize("name,make,want", ENGINE_CASES,
                         ids=[c[0] for c in ENGINE_CASES])
def test_engine_choice(S, name, make, want):
    A = make()
    be = ht.backend_auto(S, device="cpu")
    At = ht.DistSparseMatrix.from_scipy(A, be)
    x = np.random.default_rng(2).standard_normal(A.shape[1])
    xt = ht.DistVector.from_global(x, be)
    plan = tspmv.get_spmv_plan(At, xt)
    for dt, engine in want.items():
        assert plan.engine(dt) == engine, (dt, plan.engine(dt))
    f64_bytes, cap = plan.exchange.out_pad * 8, smem_cap(be.device)
    if name == "resident":
        assert At.nnz() >= tspmv.MIN_NNZ and f64_bytes <= cap
        _close((At @ xt).to_numpy(), A @ x, 1e-12)
    if name == "over_cap_f64":
        assert At.nnz() >= tspmv.MIN_NNZ and f64_bytes // 2 <= cap < f64_bytes
    ht.clear_plan_cache("vector_plan")


def test_cpu_cap_is_the_h100s():
    assert smem_cap(torch.device("cpu")) == H100_SMEM_CAP == 227 * 1024
