"""The tables the redesigned ELL kernels (K2, K3) read beside the ELL plan.

* The row-length table ``ell_rowlen`` equals ``min(diff(indptr), W)`` for
  every row of every shard, and 0 on the padding rows.
* K3's column windows: every column a row tile's stored entries read lies
  in that tile's ``[lo, hi)``, the window lies in ``[0, G]`` (G the gathered
  width), and the staging width covers every window widened to 16 bytes.
* The plain model of the tail kernel's warp-segmented reduction
  (``ell_tail_segmented_plain``) adds what ``scatter_add_`` adds (f64, rtol
  1e-12 of max|y|: the same products summed in another order), in sorted
  and in shuffled order, with fewer adds than entries on sorted runs.
* The ELL and tail tables themselves stay equal to the JAX package's.

Random, power-law and banded patterns at S = 1 and 4, small sizes.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import hpclinalg as hl
import hpclinalg.ops.spmv as jspmv
import hpclinalg_torch as ht
import hpclinalg_torch.ops.spmv as tspmv
from hpclinalg_torch.ops.cuda_dia import pad_trunc
from hpclinalg_torch.ops.cuda_ell import (TAIL_PER_THREAD, ell_spmv,
                                          ell_spmv_plain,
                                          ell_tail_segmented_plain, lanes_for,
                                          rows_per_pass, tail_segments)
from hpclinalg_torch.ops.cuda_ell_resident import (H100_SMEM_CAP, MAX_PASSES,
                                                   TILES, WINDOW_ALIGN,
                                                   Windows, ell_resident_spmv,
                                                   ell_windows, make_windows,
                                                   tile_rows)

torch.set_num_threads(1)


def power_law(n, seed, max_len=200):
    rng = np.random.default_rng(seed)
    lens = np.minimum(rng.zipf(1.6, n), max_len)
    rows = np.repeat(np.arange(n), lens)
    A = sp.csr_matrix((rng.standard_normal(lens.sum()),
                       (rows, rng.integers(0, n, lens.sum()))), shape=(n, n))
    A.sum_duplicates()
    return A


def banded(m, n, seed, per_row=4, half=12):
    """Row i holds per_row columns near i*n/m (the ridge design's shape)."""
    rng = np.random.default_rng(seed)
    c = (np.arange(m) * n) // m
    cols = np.clip(c[:, None] + rng.integers(-half, half + 1, (m, per_row)),
                   0, n - 1)
    A = sp.csr_matrix((rng.standard_normal(m * per_row),
                       (np.repeat(np.arange(m), per_row), cols.ravel())),
                      shape=(m, n))
    A.sum_duplicates()
    return A


PATTERNS = [
    ("random", lambda: sp.random(500, 500, 0.02, format="csr",
                                 random_state=np.random.default_rng(5))),
    ("power_law", lambda: power_law(900, 3)),
    ("banded", lambda: banded(1200, 300, 6)),
]


@pytest.fixture
def plans(monkeypatch):
    """(JAX plan, port plan, port matrix) of a pattern on S shards, ELL
    forced in both packages and the resident engine allowed at any nnz."""
    monkeypatch.setattr(jspmv, "DENSE_MAX_ELEMS", 0)
    monkeypatch.setattr(tspmv, "DENSE_MAX_ELEMS", 0)
    monkeypatch.setattr(tspmv, "MIN_NNZ", 0)

    def build(A, S):
        Aj = hl.DistSparseMatrix.from_scipy(A, hl.backend_auto(nshards=S))
        At = ht.DistSparseMatrix.from_scipy(A, ht.backend_auto(S, device="cpu"))
        x = np.random.default_rng(1).standard_normal(A.shape[1])
        pj = jspmv.get_spmv_plan(Aj, hl.DistVector.from_global(x, Aj.backend))
        xt = ht.DistVector.from_global(x, At.backend)
        pt = tspmv.get_spmv_plan(At, xt)
        assert pj.ell and pt.ell
        return pj, pt, At, xt
    yield build
    ht.clear_plan_cache("vector_plan")


@pytest.mark.parametrize("S", [1, 4])
@pytest.mark.parametrize("name,make", PATTERNS, ids=[p[0] for p in PATTERNS])
def test_ell_tables_still_equal_the_jax_packages(S, name, make, plans):
    pj, pt, _, _ = plans(make(), S)
    assert (pt.ell_W, pt.ell_Tpad) == (pj.ell_W, pj.ell_Tpad)
    np.testing.assert_array_equal(pt.ell_cols.numpy(), np.asarray(pj.ell_cols))
    np.testing.assert_array_equal(pt.ell_scat.numpy(), np.asarray(pj.ell_scat))
    if pt.ell_Tpad:
        for a in ("ell_tail_rows", "ell_tail_gidx", "ell_tail_scat"):
            np.testing.assert_array_equal(getattr(pt, a).numpy(),
                                          np.asarray(getattr(pj, a)))
    if name == "power_law":
        assert pt.ell_Tpad > 0


@pytest.mark.parametrize("S", [1, 4])
@pytest.mark.parametrize("name,make", PATTERNS, ids=[p[0] for p in PATTERNS])
def test_row_length_table(S, name, make, plans):
    _, pt, At, _ = plans(make(), S)
    st = At.structure
    rowlen = pt.ell_rowlen.numpy()
    assert rowlen.dtype == np.int32 and rowlen.shape == (S, st.Lrow)
    np.testing.assert_array_equal(rowlen, pt.ell_rowlen_np)
    for s in range(S):
        lens = np.diff(st.indptr[s])
        np.testing.assert_array_equal(rowlen[s, : lens.size],
                                      np.minimum(lens, pt.ell_W))
        assert not rowlen[s, lens.size:].any()
    # the padding past each row's length holds column 0 and value 0
    cols = pt.ell_cols.numpy().reshape(S, st.Lrow, pt.ell_W)
    pad = np.arange(pt.ell_W) >= rowlen[:, :, None]
    assert not cols[pad].any()
    vals, _ = tspmv._ell_values(At, pt)
    assert not vals.numpy()[pad].any()
    assert pt.ell_mean_len == pytest.approx(
        rowlen.sum() / sum(np.diff(ip).size for ip in st.indptr))


@pytest.mark.parametrize("S", [1, 4])
@pytest.mark.parametrize("name,make", PATTERNS, ids=[p[0] for p in PATTERNS])
@pytest.mark.parametrize("lanes", [1, 4, 32])
def test_column_windows_cover_each_tile(S, name, make, lanes, plans):
    _, pt, At, _ = plans(make(), S)
    st = At.structure
    G = pt.exchange.out_pad
    tile = tile_rows(lanes, S * st.Lrow)
    table, width = ell_windows(pt.ell_cols_np, pt.ell_rowlen_np, tile)
    ntiles = -(-st.Lrow // tile)
    assert table.dtype == np.int32 and table.shape == (S, ntiles, 2)
    lo, hi = table[..., 0], table[..., 1]
    assert (0 <= lo).all() and (lo <= hi).all() and (hi <= G).all()
    cols = pt.ell_cols_np.reshape(S, st.Lrow, pt.ell_W)
    live = np.arange(pt.ell_W) < pt.ell_rowlen_np[:, :, None]
    for s in range(S):
        for t in range(ntiles):
            c = cols[s, t * tile:(t + 1) * tile][live[s, t * tile:(t + 1) * tile]]
            if c.size:
                assert lo[s, t] <= c.min() and c.max() < hi[s, t]
                assert lo[s, t] == c.min() and hi[s, t] == c.max() + 1
            else:
                assert lo[s, t] == hi[s, t] == 0
    a = WINDOW_ALIGN
    assert width % a == 0
    assert width >= ((-(-hi // a)) * a - (lo // a) * a).max()
    if name == "banded":
        assert width < G     # a banded tile stages less than the whole x


@pytest.mark.parametrize("S", [1, 4])
def test_plan_layout_gives_the_windows_of_its_tiles(S, plans):
    _, pt, At, xt = plans(banded(1200, 300, 6), S)
    for dt in (torch.float64, torch.float32):
        assert pt.engine(dt) == "resident"
        lanes, win = pt.ell_layout(dt)
        assert lanes == lanes_for(pt.ell_W, pt.ell_mean_len, dt.itemsize)
        assert isinstance(win, Windows) and win.tile_rows == tile_rows(
            lanes, S * At.structure.Lrow)
        table, width = ell_windows(pt.ell_cols_np, pt.ell_rowlen_np,
                                   win.tile_rows)
        np.testing.assert_array_equal(win.table.numpy(), table)
        assert win.width == width and win.lanes == lanes
        assert win.staged == width            # two windows fit the cap
        assert pt.ell_layout(dt)[1] is win    # built once a dtype
    # CPU tensors: the wrapper takes the plain version, windows or not
    vals, _ = tspmv._ell_values(At, pt)
    lanes, win = pt.ell_layout(torch.float64)
    y = ell_resident_spmv(vals, pt.ell_cols, xt.data, None,
                          pt.exchange.out_pad, pt.ell_rowlen, lanes, win)
    torch.testing.assert_close(
        y, ell_spmv_plain(vals, pt.ell_cols, xt.data, None,
                          pt.exchange.out_pad), rtol=0, atol=0)


@pytest.mark.parametrize("S", [1, 4])
def test_plan_kernel_args_give_the_plain_product(S, plans):
    """A @ x's arguments for K2 and K3 (``ell_kernel_args``, the plan's
    tables marked checked) give the plain version's y on CPU tensors, and
    checked operands off the plan's device are refused."""
    _, pt, At, xt = plans(power_law(900, 3), S)
    ex = pt.exchange
    g, pad_to = (xt.data, ex.out_pad) if ex.is_identity \
        else (ex.apply(xt.data), 0)
    args, kw, windows = tspmv.ell_kernel_args(At, pt, g, pad_to)
    assert kw["checked"] and kw["lanes"] == pt.ell_layout(torch.float64)[0]
    want = ell_spmv_plain(*args)
    torch.testing.assert_close(ell_spmv(*args, **kw), want, rtol=0, atol=0)
    torch.testing.assert_close(
        ell_resident_spmv(*args, **kw, windows=windows), want, rtol=0,
        atol=0)
    meta = (args[0].to("meta"),) + args[1:]
    with pytest.raises(ValueError):
        ell_spmv(*meta, **kw)


def test_make_windows_checks_its_tiles():
    A = banded(1200, 300, 6)
    S, Lrow = 1, A.shape[0]
    W = int(np.diff(A.indptr).max())
    cols = np.zeros((S, Lrow, W), np.int32)
    rowlen = np.diff(A.indptr).astype(np.int32)[None]
    for r in range(Lrow):
        cols[0, r, : rowlen[0, r]] = A.indices[A.indptr[r]:A.indptr[r + 1]]
    cpu = torch.device("cpu")
    win = make_windows(cols, rowlen, 4, torch.float64, cpu)
    assert win.tile_rows == tile_rows(4, Lrow) and win.staged == win.width
    # tiles must be whole passes of rows_per_pass(lanes) rows
    per = rows_per_pass(4)
    for bad in (per - 1, per + 1):
        with pytest.raises(ValueError):
            make_windows(cols, rowlen, 4, torch.float64, cpu, bad)
    # a window wider than half the cap stages the whole x instead
    wide = cols.copy()
    wide[0, 0, 0], wide[0, 1, 0] = 0, H100_SMEM_CAP // 8
    rl = rowlen.copy()
    rl[0, :2] = np.maximum(rl[0, :2], 1)
    win = make_windows(wide, rl, 4, torch.float64, cpu)
    assert win.width > H100_SMEM_CAP // 16 and win.staged == 0


def test_group_width_and_tile_height():
    # units of 16 bytes of values when W allows: 2 entries in f64, 4 in f32;
    # the geometric mean of the mean row length and W, in units, rounded up
    # to a power of two
    assert lanes_for(8, 8.0, 8) == 4 and lanes_for(8, 8.0, 4) == 2
    assert lanes_for(7, 7.0, 8) == 8          # odd W: one entry a unit
    assert lanes_for(20, 2.78, 8) == 4        # the power law: mean 2.78
    assert lanes_for(4, 4.0, 8) == 2 and lanes_for(4, 0.0, 4) == 1
    assert lanes_for(184, 168.15, 8) == 32    # capped at a warp
    assert rows_per_pass(1) == 256 and rows_per_pass(32) == 8
    # K3's tile: whole passes, the fewest that leave at most TILES tiles,
    # 1 to MAX_PASSES passes
    for lanes in (1, 2, 4, 8, 16, 32):
        per = rows_per_pass(lanes)
        for rows in (1, 1000, 16384, 10**6, 10**8):
            t = tile_rows(lanes, rows)
            assert t % per == 0 and per <= t <= MAX_PASSES * per
            if rows <= MAX_PASSES * per * TILES:
                assert -(-rows // t) <= TILES
                if t > per:
                    assert -(-rows // (t - per)) > TILES
    assert tile_rows(32, 16384) == 16         # N of the ridge path: 2 passes
    assert tile_rows(2, 10**6) == 8 * 128     # its design A: 8, 977 tiles


@pytest.mark.parametrize("S", [1, 4])
@pytest.mark.parametrize("order", ["sorted", "shuffled"])
def test_segmented_tail_sum_equals_scatter_add(S, order, plans):
    _, pt, At, xt = plans(power_law(900, 3), S)
    assert pt.ell_Tpad > 0 and pt.ell_Tpad % TAIL_PER_THREAD == 0
    _, tvals = tspmv._ell_values(At, pt)
    trows, tgidx = pt.ell_tail_rows, pt.ell_tail_gidx
    if order == "shuffled":
        perm = torch.from_numpy(np.random.default_rng(2).permutation(
            pt.ell_Tpad))
        tvals, trows, tgidx = tvals[:, perm], trows[:, perm], tgidx[:, perm]
    ex = pt.exchange
    g = pad_trunc(xt.data, ex.out_pad) if ex.is_identity \
        else ex.apply(xt.data)
    Lrow = At.structure.Lrow
    y0 = torch.from_numpy(np.random.default_rng(3).standard_normal((S, Lrow)))
    want = torch.cat([y0, y0.new_zeros((S, 1))], 1).scatter_add_(
        1, trows.long(), tvals * torch.gather(g, 1, tgidx.long()))[:, :Lrow]
    got = ell_tail_segmented_plain(tvals, trows, tgidx, g, y0)
    torch.testing.assert_close(got, want, rtol=1e-12,
                               atol=1e-12 * float(want.abs().max()))
    for s in range(S):
        r = trows[s].numpy()
        seg, rows = tail_segments(r)
        np.testing.assert_array_equal(rows[seg], r)   # one row an add
        if order == "sorted":
            # long rows are summed before their atomics: far fewer adds
            live = r < Lrow
            assert rows.size < 0.5 * live.sum() + TAIL_PER_THREAD


def test_tail_segments_small_cases():
    E, Wp = TAIL_PER_THREAD, 32
    # one row over two whole warps: one add a warp
    seg, rows = tail_segments(np.full(2 * Wp * E, 3))
    assert rows.tolist() == [3, 3] and (seg[: Wp * E] == 0).all()
    # every entry its own row: one add each
    r = np.arange(4 * E)
    seg, rows = tail_segments(r)
    np.testing.assert_array_equal(rows[seg], r)
    assert rows.size == r.size
    with pytest.raises(ValueError):
        tail_segments(np.zeros(E + 1, np.int64))
    assert tail_segments(np.zeros(0, np.int64))[0].size == 0
