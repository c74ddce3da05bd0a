"""The port's SpMV plan and engines against the JAX package's.

* SpMVPlan makes the same engine choice with the same parameters.
* ``A @ x`` agrees with hpclinalg at S in {1, 4, 8} in f64 (rtol 1e-12:
  the engines sum the same products in another order).
* The kernels' plain twins take the JAX package's own tables and gathered
  buffers and agree with its XLA engines and its Pallas kernels, the latter
  run in interpret mode as the JAX suite runs them (f32: rtol 1e-5).
* The gather-only twin is bit-exact against the shuffle engine's simulator
  and its interpret-mode kernels.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import hpclinalg as hl
import hpclinalg.ops.spmv as jspmv
import hpclinalg_torch as ht
import hpclinalg_torch.ops.spmv as tspmv
from hpclinalg_torch.ops.cuda_dia import dia_spmv, dia_spmv_plain
from hpclinalg_torch.ops.cuda_ell import (check_index, ell_spmv,
                                          ell_spmv_plain, gather, gather_plain)

torch.set_num_threads(1)

SHARDS = [1, 4, 8]


def laplace2d(k):
    T = sp.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(k, k))
    I = sp.eye(k)
    return (sp.kron(I, T) + sp.kron(T, I)).tocsr()


def power_law(n, seed, max_len=200):
    """Rows with Zipf-like lengths: a few long rows spill into the tail."""
    rng = np.random.default_rng(seed)
    lens = np.minimum(rng.zipf(1.6, n), max_len)
    rows = np.repeat(np.arange(n), lens)
    cols = rng.integers(0, n, lens.sum())
    A = sp.csr_matrix((rng.standard_normal(lens.sum()), (rows, cols)),
                      shape=(n, n))
    A.sum_duplicates()
    return A


def heavy_row(n, seed):
    rng = np.random.default_rng(seed)
    A = sp.random(n, n, 0.03, format="lil", random_state=rng)
    A[5, : n // 2] = rng.standard_normal(n // 2)
    return A.tocsr()


def _patterns():
    rng = np.random.default_rng(0)
    return [
        ("stencil", laplace2d(12), False),
        ("tridiag", sp.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(100, 100))
         .tocsr(), False),
        ("random", sp.random(144, 144, 0.05, format="csr", random_state=rng),
         False),
        ("random_ell", sp.random(400, 400, 0.03, format="csr",
                                 random_state=rng), True),
        ("heavy_row", heavy_row(400, 7), True),
        ("power_law", power_law(900, 3), True),
        ("rect", sp.random(90, 130, 0.05, format="csr", random_state=rng),
         True),
    ]


PATTERNS = _patterns()


@pytest.fixture
def force_ell(monkeypatch):
    def apply(on):
        if on:
            monkeypatch.setattr(jspmv, "DENSE_MAX_ELEMS", 0)
            monkeypatch.setattr(tspmv, "DENSE_MAX_ELEMS", 0)
    return apply


def _plans(A, S, dtype=np.float64):
    Aj = hl.DistSparseMatrix.from_scipy(A, hl.backend_auto(nshards=S),
                                        dtype=dtype)
    At = ht.DistSparseMatrix.from_scipy(A, ht.backend_auto(S, device="cpu"),
                                        dtype=dtype)
    x = np.random.default_rng(1).standard_normal(A.shape[1]).astype(dtype)
    xj = hl.DistVector.from_global(x, Aj.backend, dtype=dtype)
    xt = ht.DistVector.from_global(x, At.backend, dtype=dtype)
    return (Aj, xj, jspmv.get_spmv_plan(Aj, xj),
            At, xt, tspmv.get_spmv_plan(At, xt), x)


@pytest.mark.parametrize("S", SHARDS)
@pytest.mark.parametrize("name,A,ell", PATTERNS, ids=[p[0] for p in PATTERNS])
def test_plan_choices_match(S, name, A, ell, force_ell):
    force_ell(ell)
    _, _, pj, _, _, pt, _ = _plans(A, S)
    assert pt.offsets == pj.offsets
    assert pt.densify == pj.densify and pt.ell == pj.ell
    assert pt.exchange.is_identity == pj.exchange.is_identity
    assert pt.exchange.out_pad == pj.exchange.out_pad
    if pt.offsets is not None:
        assert (pt.bias_lo, pt.bias_hi) == (pj.bias_lo, pj.bias_hi)
        np.testing.assert_array_equal(pt.dia_scatter.numpy(),
                                      np.asarray(pj.dia_scatter))
    if pt.ell:
        assert (pt.ell_W, pt.ell_Tpad) == (pj.ell_W, pj.ell_Tpad)
        np.testing.assert_array_equal(pt.ell_cols.numpy(),
                                      np.asarray(pj.ell_cols))
        if pt.ell_Tpad:
            for a in ("ell_tail_rows", "ell_tail_gidx", "ell_tail_scat"):
                np.testing.assert_array_equal(getattr(pt, a).numpy(),
                                              np.asarray(getattr(pj, a)))
    if name == "stencil":
        assert pt.offsets is not None
    if name in ("heavy_row", "power_law"):
        assert pt.ell and pt.ell_Tpad > 0


@pytest.mark.parametrize("S", SHARDS)
@pytest.mark.parametrize("name,A,ell", PATTERNS, ids=[p[0] for p in PATTERNS])
def test_matvec_matches(S, name, A, ell, force_ell):
    force_ell(ell)
    Aj, xj, _, At, xt, _, x = _plans(A, S)
    yj = (Aj @ xj).to_numpy()
    yt = At @ xt
    np.testing.assert_allclose(yt.to_numpy(), yj, rtol=1e-12,
                               atol=1e-12 * max(1.0, abs(yj).max()))
    np.testing.assert_allclose(yt.to_numpy(), A @ x, rtol=1e-12,
                               atol=1e-12 * max(1.0, abs(yj).max()))
    mask = yt.mask().numpy()
    assert np.all(yt.data.numpy()[~mask] == 0), "padding invariant"


def test_matvec_dimension_mismatch():
    be = ht.backend_auto(2, device="cpu")
    A = ht.DistSparseMatrix.from_scipy(laplace2d(4), be)
    with pytest.raises(ValueError):
        A @ ht.DistVector.from_global(np.ones(15), be)


def _jax_gathered(pj, xj):
    if pj.exchange.is_identity:
        return xj.data, pj.exchange.out_pad
    return pj.exchange.apply(xj.data), 0


@pytest.mark.parametrize("S", [1, 4])
def test_dia_twin_matches_xla_and_pallas(S):
    """dia_spmv_plain on the JAX package's own table and gathered buffer,
    against _dia_exec and the Pallas DIA kernel in interpret mode (f32)."""
    from hpclinalg.ops.pallas_dia import pallas_dia_matvec

    Aj, xj, pj, _, _, _, _ = _plans(laplace2d(64), S, np.float32)
    assert pj.offsets is not None
    dval = jspmv._dia_values(Aj, pj)
    g, pad_to = _jax_gathered(pj, xj)
    y_xla = np.asarray(jspmv._dia_exec(pj.offsets, Aj.structure.Lrow,
                                       pj.bias_lo, pj.bias_hi, pad_to)(dval, g))
    y_pal = np.asarray(pallas_dia_matvec(Aj, pj, g, interpret=True))
    y_port = dia_spmv_plain(torch.from_numpy(np.array(dval)),
                            torch.from_numpy(np.array(g)), pj.offsets,
                            pj.bias_lo, pj.bias_hi, pad_to).numpy()
    assert y_port.dtype == np.float32
    scale = abs(y_xla).max()
    np.testing.assert_allclose(y_port, y_xla, rtol=1e-5, atol=1e-5 * scale)
    np.testing.assert_allclose(y_port, y_pal, rtol=1e-5, atol=1e-5 * scale)


@pytest.mark.parametrize("S", [1, 4])
@pytest.mark.parametrize("name,A", [("heavy_row", heavy_row(400, 7)),
                                    ("power_law", power_law(900, 3))],
                         ids=["heavy_row", "power_law"])
def test_ell_twin_matches_xla(S, name, A, force_ell):
    """ell_spmv_plain on the JAX package's own ELL tables, tail and gathered
    buffer, against _ell_exec (f64, rtol 1e-12)."""
    force_ell(True)
    Aj, xj, pj, _, _, _, _ = _plans(A, S)
    assert pj.ell and pj.ell_Tpad > 0
    vals, tvals = jspmv._ell_values(Aj, pj)
    g, pad_to = _jax_gathered(pj, xj)
    Lrow = Aj.structure.Lrow
    y_xla = np.asarray(jspmv._ell_exec(Lrow, pj.ell_W, pj.ell_Tpad, pad_to)(
        vals, pj.ell_cols, tvals, pj.ell_tail_rows, pj.ell_tail_gidx, g))
    t = (lambda a: torch.from_numpy(np.array(a)))
    y_port = ell_spmv_plain(t(vals), t(pj.ell_cols), t(g),
                            (t(tvals), t(pj.ell_tail_rows),
                             t(pj.ell_tail_gidx)), pad_to).numpy()
    np.testing.assert_allclose(y_port, y_xla, rtol=1e-12,
                               atol=1e-12 * abs(y_xla).max())


def test_ell_twin_matches_pallas_interpret(force_ell):
    """The port's ELL engine (twin) against the Pallas ELL kernel in
    interpret mode on the inputs of test_pallas_ell_kernel_interpret (f32,
    rtol 1e-5: the two sum a row in different orders)."""
    from hpclinalg.ops.pallas_csr import pallas_ell_matvec

    force_ell(True)
    rng = np.random.default_rng(17)
    n = 600
    A = sp.random(n, n, 0.02, format="csr", random_state=rng).astype(np.float32)
    Aj, xj, pj, At, xt, pt, _ = _plans(A, 4, np.float32)
    g, _ = _jax_gathered(pj, xj)
    y_pal = np.asarray(pallas_ell_matvec(Aj, pj, g, interpret=True))
    vals, tvals = tspmv._ell_values(At, pt)
    gt, pad_to = (xt.data, pt.exchange.out_pad) if pt.exchange.is_identity \
        else (pt.exchange.apply(xt.data), 0)
    tail = (tvals, pt.ell_tail_rows, pt.ell_tail_gidx) if pt.ell_Tpad else None
    y_port = ell_spmv_plain(vals, pt.ell_cols, gt, tail, pad_to).numpy()
    scale = abs(y_pal).max()
    np.testing.assert_allclose(y_port, y_pal, rtol=1e-5, atol=1e-5 * scale)


def _shuffle_cases():
    """The source streams of tests/test_shuffle.py:16-66."""
    out = []
    for seed in (0, 1, 2):
        rng = np.random.default_rng(seed)
        src = rng.integers(0, 5000, 40000).astype(np.int64)
        src[rng.random(40000) < 0.03] = -1
        out.append((f"random{seed}", src, 5000))
    rng = np.random.default_rng(7)
    src = rng.integers(0, 4000 // 50, 50000).astype(np.int64)
    src[rng.random(50000) < 0.03] = -1
    out.append(("dup_heavy", src, 4000))
    rng = np.random.default_rng(3)
    src = rng.integers(0, 100, 300).astype(np.int64)
    src[rng.random(300) < 0.3] = -1
    out.append(("tiny", src, 100))
    out.append(("all_dead", np.full(200, -1, np.int64), 50))
    n = 3000
    rows = np.arange(n)
    src = np.stack([np.clip(rows + o, 0, n - 1) for o in (-64, -1, 0, 1, 64)],
                   axis=1).reshape(-1).astype(np.int64)
    out.append(("structured", src, n))
    return out


SHUFFLE = _shuffle_cases()


@pytest.mark.parametrize("name,src,n", SHUFFLE, ids=[c[0] for c in SHUFFLE])
def test_gather_twin_matches_router_simulate(name, src, n):
    from hpclinalg.ops.shuffle_router import build_route, simulate

    x = np.random.default_rng(99).standard_normal(n).astype(np.float32)
    xe_sim = simulate(build_route(src, n), x)[: len(src)]
    check_index("src", src, n, dead_below_zero=True)
    xe = gather_plain(torch.from_numpy(x)[None],
                      torch.from_numpy(src.astype(np.int32))[None])[0].numpy()
    np.testing.assert_array_equal(xe, xe_sim)   # bit-exact: a copy
    assert np.all(xe[src < 0] == 0)


@pytest.mark.parametrize("name,src,n", [SHUFFLE[4], SHUFFLE[6]],
                         ids=["tiny", "structured"])
def test_gather_twin_matches_shuffle_interpret(name, src, n):
    import jax.numpy as jnp

    from hpclinalg.ops.pallas_shuffle import PackedRoute, shuffle_apply
    from hpclinalg.ops.shuffle_router import build_route

    x = np.random.default_rng(98).standard_normal(n).astype(np.float32)
    xe_pal = np.asarray(shuffle_apply(PackedRoute(build_route(src, n)),
                                      jnp.asarray(x), interpret=True))
    xe = gather_plain(torch.from_numpy(x)[None],
                      torch.from_numpy(src.astype(np.int32))[None])[0].numpy()
    live = src >= 0
    np.testing.assert_array_equal(xe[live], xe_pal[: len(src)][live])
    assert np.all(xe[~live] == 0)


def test_wrappers_take_twins_on_cpu_and_never_fall_back():
    """CPU tensors go to the twin without a launch; any other device goes
    to the kernel or raises — it never falls back to the twin."""
    rng = np.random.default_rng(4)
    dval = torch.from_numpy(rng.standard_normal((2, 3, 50)))
    g = torch.from_numpy(rng.standard_normal((2, 60)))
    before = (dia_spmv.launches, ell_spmv.launches, gather.launches)
    y = dia_spmv(dval, g, (-2, 0, 3), 2, 0, 0)
    torch.testing.assert_close(y, dia_spmv_plain(dval, g, (-2, 0, 3), 2, 0, 0),
                               rtol=0, atol=0)
    cols = torch.from_numpy(rng.integers(0, 60, (2, 50 * 4)).astype(np.int32))
    vals = torch.from_numpy(rng.standard_normal((2, 50, 4)))
    torch.testing.assert_close(ell_spmv(vals, cols, g),
                               ell_spmv_plain(vals, cols, g), rtol=0, atol=0)
    src = torch.from_numpy(rng.integers(-1, 60, (2, 30)).astype(np.int32))
    torch.testing.assert_close(gather(g, src), gather_plain(g, src),
                               rtol=0, atol=0)
    assert (dia_spmv.launches, ell_spmv.launches, gather.launches) == before
    with pytest.raises(ValueError):
        dia_spmv(dval.to("meta"), g.to("meta"), (-2, 0, 3), 2, 0, 0)
    with pytest.raises(ValueError):
        ell_spmv(vals.to("meta"), cols.to("meta"), g.to("meta"))
    with pytest.raises(ValueError):
        gather(g.to("meta"), src.to("meta"))


def test_index_tables_checked_at_plan_build():
    with pytest.raises(IndexError):
        check_index("cols", np.array([0, 5, 10]), 10)
    check_index("rows", np.array([0, 9, 10]), 10, sentinel=10)
    with pytest.raises(IndexError):
        check_index("rows", np.array([-1, 3]), 10, sentinel=10)
    check_index("src", np.array([-1, 0, 9]), 10, dead_below_zero=True)
