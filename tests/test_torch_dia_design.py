"""CPU model of K1's kernels (csrc/dia_spmv.cu) against the plain twin and
the JAX package's ``_dia_exec``.

K1 runs the 16-byte kernel ``dia_vec`` or the scalar ``dia_scalar``, as
``cuda_dia.dia_vector_width`` says; both stage each tile's x window, the
pieces ``cuda_dia.dia_layout`` merges from the diagonals' row intervals.
``dia_spmv_split_plain`` models the choice, the staged window (a slot no
piece stages reads NaN) and the kernel's walk over y; it must equal
``dia_spmv_plain`` bit for bit, and so must ``_dia_exec`` run op by op
(``jax.disable_jit``): every version rounds each term as product, then sum,
in offset order. Jitted on the CPU, XLA contracts the multiply-adds of its
fused loop into FMAs, so the jitted ``_dia_exec`` is held to rtol 1e-12
(f64) and 1e-5 (f32) of max|y| instead. Sizes are small: a few tiles.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import hpclinalg_torch as ht
from hpclinalg.ops import spmv as jspmv
from hpclinalg_torch.ops import cuda_dia as k1
from hpclinalg_torch.ops import spmv as tspmv

torch.set_num_threads(1)

DTYPES = {"f32": (torch.float32, np.float32, 1e-5),
          "f64": (torch.float64, np.float64, 1e-12)}


def laplace2d(k):
    T = sp.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(k, k))
    return (sp.kron(sp.eye(k), T) + sp.kron(T, sp.eye(k))).tocsr()


def _plan_args(A, S, npdt, seed=0, cut=False):
    """K1's arguments as ``A @ x`` passes them, through the port's plan;
    ``cut``: the table cut to the matrix's own rows (the plan pads Lrow to
    a multiple of 8; an odd n then gives an odd Lrow)."""
    be = ht.backend_auto(S, dtype=npdt, device="cpu")
    Ad = ht.DistSparseMatrix.from_scipy(A, be)
    x = ht.DistVector.from_global(
        np.random.default_rng(seed).standard_normal(A.shape[1]), be)
    plan = tspmv.get_spmv_plan(Ad, x)
    assert plan.offsets is not None
    ex = plan.exchange
    g, pad_to = (x.data, ex.out_pad) if ex.is_identity \
        else (ex.apply(x.data), 0)
    dval = tspmv._dia_values(Ad, plan)
    if cut:
        dval = dval[:, :, : A.shape[0]].contiguous()
    return (dval, g, plan.offsets, plan.bias_lo, plan.bias_hi, pad_to)


def _direct_args(S, Lrow, G, offsets, bias_lo, bias_hi, pad_to, dt, seed=1):
    rng = np.random.default_rng(seed)
    return (torch.from_numpy(rng.standard_normal((S, len(offsets), Lrow))).to(dt),
            torch.from_numpy(rng.standard_normal((S, G))).to(dt),
            tuple(offsets), bias_lo, bias_hi, pad_to)


def _unaligned(g):
    """A copy of g whose data starts one element past its buffer's start:
    4 or 8 bytes off 16."""
    buf = torch.empty(g.numel() + 1, dtype=g.dtype)
    out = buf[1:].view(g.shape)
    out.copy_(g)
    return out


def _jax_dia(args):
    dval, g, offsets, bias_lo, bias_hi, pad_to = args
    run = jspmv._dia_exec(tuple(offsets), dval.shape[2], bias_lo, bias_hi,
                          pad_to)
    dj, gj = jnp.asarray(dval.numpy()), jnp.asarray(g.numpy())
    with jax.disable_jit():
        eager = np.asarray(run(dj, gj))
    return eager, np.asarray(run(dj, gj))


CASES = {
    # (the arguments, the kernel dia_vector_width must pick: True = dia_vec)
    "laplace2d(48)": (lambda dt, npdt: _plan_args(laplace2d(48), 1, npdt), True),
    "laplace2d(47) odd Lrow": (lambda dt, npdt: _plan_args(
        laplace2d(47), 1, npdt, cut=True), False),
    "laplace2d(48) S=4": (lambda dt, npdt: _plan_args(laplace2d(48), 4, npdt),
                          True),
    "S=4 bias_lo/bias_hi": (lambda dt, npdt: _direct_args(
        4, 1000, 1000, (-70, -1, 0, 1, 70), 70, 70, 0, dt), True),
    "pad_to cuts g": (lambda dt, npdt: _direct_args(
        2, 3000, 3200, (-37, -5, 0, 3, 11, 50), 37, 100, 2950, dt), True),
    "pad_to pads g": (lambda dt, npdt: _direct_args(
        3, 3000, 2900, (-37, -5, 0, 3, 11, 50), 37, 60, 3100, dt), True),
    "wide span +-w": (lambda dt, npdt: _direct_args(
        1, 20000, 20000, (-6000, 0, 6000), 6000, 6000, 0, dt), True),
    "offsets not multiples of 4": (lambda dt, npdt: _direct_args(
        2, 4096, 4160, (-33, -7, -2, 5, 13, 31, 63), 33, 0, 0, dt), True),
    "g 1 element off 16 bytes": (lambda dt, npdt: (lambda a: (
        a[0], _unaligned(a[1])) + a[2:])(_direct_args(
            2, 3000, 3000, (-50, -1, 0, 1, 50), 50, 50, 0, dt)), False),
}


@pytest.mark.parametrize("name", list(CASES))
@pytest.mark.parametrize("dtn", list(DTYPES))
def test_dia_model_bit_for_bit(name, dtn):
    dt, npdt, rtol = DTYPES[dtn]
    make, vec = CASES[name]
    args = make(dt, npdt)
    dval, g = args[0], args[1]
    y = torch.empty((dval.shape[0], dval.shape[2]), dtype=dt)
    assert k1.dia_vector_width(dval, g, y) == (16 // dt.itemsize if vec else 1)
    want = k1.dia_spmv_plain(*args)
    got = k1.dia_spmv_split_plain(*args)
    assert torch.equal(got, want)
    assert torch.equal(k1.dia_spmv(*args), want)    # the wrapper on the CPU
    eager, jitted = _jax_dia(args)
    np.testing.assert_array_equal(got.numpy(), eager)
    scale = float(np.abs(eager).max())
    np.testing.assert_allclose(got.numpy(), jitted, rtol=0, atol=rtol * scale)


def test_merge_intervals():
    assert k1.merge_intervals((-1000, -1, 0, 1, 1000), 1024) == [(0, 4)]
    assert k1.merge_intervals((-300000, 0, 300000), 2048) == \
        [(0, 0), (1, 1), (2, 2)]
    assert k1.merge_intervals((-5000, -1, 0, 1, 5000), 1024) == \
        [(0, 0), (1, 3), (4, 4)]
    # intervals that touch merge; one row apart they do not
    assert k1.merge_intervals((0, 1024), 1024) == [(0, 1)]
    assert k1.merge_intervals((0, 1025), 1024) == [(0, 0), (1, 1)]


def test_dia_layout_main_patterns():
    """16 bytes of rows a thread, 256 threads. laplace2d(1000)'s five
    diagonals: in f64 (512-row tiles, shorter than the 999-row gaps) the
    three diagonals -1, 0, 1 share a piece and +-1000 take one each; in
    f32 (1024-row tiles) one piece of tile + span. The wide pattern: three
    pieces of one tile."""
    lap = (-1000, -1, 0, 1, 1000)
    f64, f32 = k1.dia_layout(lap, 8, k1.H100_SMEM_CAP), \
        k1.dia_layout(lap, 4, k1.H100_SMEM_CAP)
    assert (f64.threads, f64.tile, f32.tile) == (256, 512, 1024)
    assert f64.pieces == ((-1000, 512, 0), (-2, 516, 512), (1000, 512, 1028))
    assert f64.shifts == (0, 513, 514, 515, 1028)
    assert f64.smem_bytes == 1540 * 8
    assert f32.pieces == ((-1000, 3024, 0),)
    wide = k1.dia_layout((-300000, 0, 300000), 8, k1.H100_SMEM_CAP)
    assert wide.pieces == ((-300000, 512, 0), (0, 512, 512),
                           (300000, 512, 1024))
    assert wide.shifts == (0, 512, 1024)
    odd = k1.dia_layout((-37, -5, 0, 3, 11, 50), 8, k1.H100_SMEM_CAP)
    assert odd.pieces == ((-38, 600, 0),) and odd.shifts[0] == 1


@pytest.mark.parametrize("esize", [4, 8])
def test_dia_layout_window_fits_and_covers(esize):
    """For seeded patterns of 1 to 64 offsets over spans up to 10^6: the
    window fits the cap, pieces start and end on 16-byte units at 16-byte
    aligned slots, and every diagonal's reads over the tile stay inside
    its piece. A cap too small for the window takes fewer threads."""
    rng = np.random.default_rng(esize)
    V = 16 // esize
    for _ in range(200):
        O = int(rng.integers(1, 65))
        span = int(rng.choice([64, 5000, 10 ** 6]))
        offs = tuple(sorted(rng.choice(np.arange(-span, span), O,
                                       replace=False).tolist()))
        lay = k1.dia_layout(offs, esize, k1.H100_SMEM_CAP)
        assert lay.smem_bytes <= k1.H100_SMEM_CAP
        assert lay.smem_bytes == sum(p[1] for p in lay.pieces) * esize
        ends = []
        for lo, length, base in lay.pieces:
            assert lo % V == 0 and length % V == 0 and base % V == 0
            ends.append((base, base + length))
        for t, sh in enumerate(lay.shifts):
            assert any(b <= sh and sh + lay.tile <= e for b, e in ends)
    small = k1.dia_layout(tuple(range(0, 64 * 5000, 5000)), esize, 40000)
    assert small.threads < k1.THREADS and small.smem_bytes <= 40000
    with pytest.raises(ValueError):
        k1.dia_layout(tuple(range(0, 64 * 5000, 5000)), esize, 1000)


def test_dia_vector_width_rule():
    d = torch.zeros((2, 3, 256), dtype=torch.float32)
    g = torch.zeros((2, 300), dtype=torch.float32)
    y = torch.zeros((2, 256), dtype=torch.float32)
    assert k1.dia_vector_width(d, g, y) == 4
    assert k1.dia_vector_width(d.double(), g.double(), y.double()) == 2
    assert k1.dia_vector_width(torch.zeros((2, 3, 258)), g, y) == 1   # Lrow
    assert k1.dia_vector_width(d, torch.zeros((2, 302)), y) == 1      # stride
    assert k1.dia_vector_width(d, _unaligned(g), y) == 1              # g
    assert k1.dia_vector_width(d, g, _unaligned(y)) == 1              # y
    assert k1.dia_vector_width(_unaligned(d), g, y) == 1              # dval
    assert k1.dia_vector_width(d, torch.zeros(2 * 300 + 4)[4:].view(2, 300),
                               y) == 4                                # 16 off


@pytest.mark.parametrize("which", ["both", "values", "x"])
def test_complex_products_match_complex_dia(which):
    """The real products of the parts (``complex_products``, the route K1
    took for complex operands before its complex instantiations, and the
    route the JAX package's split planes take) over the plain version give
    the complex plain product and the JAX package's ``_dia_exec`` on the
    complex operands, to f64 rounding."""
    dval, g, offsets, bias_lo, bias_hi, pad_to = _direct_args(
        2, 3000, 3200, (-37, -5, 0, 3, 11, 50), 37, 100, 2950, torch.float64)
    rng = np.random.default_rng(4)
    if which in ("both", "values"):
        dval = dval + 1j * torch.from_numpy(rng.standard_normal(dval.shape))
    if which in ("both", "x"):
        g = g + 1j * torch.from_numpy(rng.standard_normal(g.shape))
    calls = []

    def plain(v, x):
        assert not v.is_complex() and not x.is_complex()
        calls.append(1)
        return k1.dia_spmv_plain(v, x, offsets, bias_lo, bias_hi, pad_to)

    got = k1.complex_products(plain, dval, g)
    assert len(calls) == (4 if which == "both" else 2)
    want = k1.dia_spmv_plain(dval, g, offsets, bias_lo, bias_hi, pad_to)
    assert got.dtype == want.dtype == torch.complex128
    scale = float(want.abs().max())
    torch.testing.assert_close(got, want, rtol=0, atol=1e-14 * scale)
    _eager, jitted = _jax_dia((dval, g, offsets, bias_lo, bias_hi, pad_to))
    np.testing.assert_allclose(got.numpy(), jitted, rtol=0,
                               atol=1e-14 * scale)
