"""The plain versions of the probe kernels K4 and K5 against the TPU
kernels of the JAX package's probe scripts, rebuilt here and run in Pallas
interpret mode on the CPU.

The scripts under tools/ cannot be imported (proto_pallas_dia.py runs its
benchmark at import; the others nest their kernels inside main()), so each
kernel body below is copied unchanged from the cited lines; only the sizes
differ: TR = 256 rows a tile and laplace2d(40), n = 1600, in f32, as the
scripts run it. The port's wrappers take their plain versions for CPU
tensors. Tolerance: rtol 1e-5 of max|y| (f32 sums in another order); the
k-payload copy must be exact. v4 is also held against the JAX package's
DIA engine (``_dia_exec``) and scipy.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

import hpclinalg as hl
import hpclinalg_torch as ht
from hpclinalg.ops.spmv import _dia_exec, _dia_values, get_spmv_plan
from hpclinalg_torch.ops import cuda_dia, cuda_dia_probe as k4
from hpclinalg_torch.ops import cuda_kpayload as k5

torch.set_num_threads(1)

TR = 256
K = 40
RTOL = 1e-5


def laplace2d(k, dtype=np.float32):
    T = sp.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(k, k))
    I = sp.eye(k)
    return (sp.kron(I, T) + sp.kron(T, I)).tocsr().astype(dtype)


class Lap:
    """laplace2d(K) in the scripts' layouts: the (O, npad) table, the
    tile-flat (ntiles, O, TR) table and x, padded as each script pads it."""

    def __init__(self):
        A = laplace2d(K)
        self.A, self.n = A, A.shape[0]
        coo = A.tocoo()
        offs = coo.col - coo.row
        self.offsets = tuple(sorted(np.unique(offs).tolist()))
        self.O = len(self.offsets)
        self.minoff = self.offsets[0]
        self.span = self.offsets[-1] - self.minoff
        self.ntiles = -(-self.n // TR)
        self.npad = self.ntiles * TR
        tbl = np.zeros((self.O, self.npad), np.float32)
        tbl[np.searchsorted(self.offsets, offs), coo.row] = coo.data
        self.tbl = tbl
        self.tflat = np.ascontiguousarray(
            tbl.reshape(self.O, self.ntiles, TR).transpose(1, 0, 2))
        self.x = np.random.default_rng(1).standard_normal(self.n) \
            .astype(np.float32)
        # the port's pre-padded x: -minoff zeros, x, zeros to npad + span
        xp = np.zeros(self.npad + self.span, np.float32)
        xp[-self.minoff: -self.minoff + self.n] = self.x
        self.xp = xp
        self.c = np.array([0.5], np.float32)


@pytest.fixture(scope="module")
def lap():
    return Lap()


def _close(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= RTOL * max(np.abs(want).max(), 1e-30), err


def T(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def test_proto_dia_kernel_against_k1_path(lap):
    """tools/proto_pallas_dia.py:30-57 (kern, spmv_pallas) against the
    port's ``A @ x`` through the DIA engine (K1's plain version)."""
    n, O, minoff = lap.n, lap.O, lap.minoff
    uoffs, span = lap.offsets, lap.span
    SPAN_PAD = ((span + 511) // 512) * 512
    ntiles, NPAD = lap.ntiles, lap.npad

    def kern(dval_ref, xp_ref, y_ref):
        i = pl.program_id(0)
        def inner(xw, sem):
            cp = pltpu.make_async_copy(
                xp_ref.at[pl.ds(i * TR, TR + SPAN_PAD)], xw, sem)
            cp.start(); cp.wait()
            acc = jnp.zeros((TR,), jnp.float32)
            for t, o in enumerate(uoffs):
                acc = acc + dval_ref[t, :] * xw[pl.ds(o - minoff, TR)]
            y_ref[:] = acc
        pl.run_scoped(inner, xw=pltpu.VMEM((TR + SPAN_PAD,), jnp.float32),
                      sem=pltpu.SemaphoreType.DMA)

    @jax.jit
    def spmv_pallas(dval_d, x):
        xp = jnp.pad(x, (-minoff, SPAN_PAD + minoff + (NPAD - n)))
        dv = jnp.pad(dval_d, ((0, 0), (0, NPAD - n)))
        out = pl.pallas_call(
            kern,
            grid=(ntiles,),
            in_specs=[pl.BlockSpec((O, TR), lambda i: (0, i), memory_space=pltpu.VMEM),
                      pl.BlockSpec(memory_space=pl.ANY)],
            out_specs=pl.BlockSpec((TR,), lambda i: (i,), memory_space=pltpu.VMEM),
            out_shape=jax.ShapeDtypeStruct((NPAD,), jnp.float32),
            interpret=True,
        )(dv, xp)
        return out[:n]

    y_tpu = spmv_pallas(jnp.asarray(lap.tbl[:, :n]), jnp.asarray(lap.x))
    be = ht.backend_auto(1, dtype=np.float32, device="cpu")
    Ad = ht.DistSparseMatrix.from_scipy(lap.A, be)
    y = (Ad @ ht.DistVector.from_global(lap.x, be)).to_numpy()
    _close(y, y_tpu)
    _close(y, lap.A @ lap.x)


def test_bench_raw_kernel_against_k1_raw(lap):
    """tools/bench_dia_variants.py:98-133 (raw kern on a pre-padded x)
    against K1's plain version on the port's pre-padded x (offsets shifted
    by -minoff, no bias)."""
    offsets, O, n = lap.offsets, lap.O, lap.n
    minoff, span, ntiles = lap.minoff, lap.span, lap.ntiles
    span_pad = ((span + 1023) // 1024) * 1024
    WIN = TR + span_pad

    def kern(dval_ref, xp_ref, y_ref, xw0, xw1, sem0, sem1):
        i = pl.program_id(0)

        def start(j, buf, sem):
            pltpu.make_async_copy(
                xp_ref.at[pl.ds(j * TR, WIN)], buf, sem).start()

        def compute(xw):
            acc = jnp.zeros((TR,), jnp.float32)
            for t, o in enumerate(offsets):
                acc = acc + dval_ref[t, :] * xw[pl.ds(o - minoff, TR)]
            y_ref[:] = acc

        @pl.when(i == 0)
        def _():
            start(0, xw0, sem0)

        @pl.when(i % 2 == 0)
        def _():
            @pl.when(i + 1 < ntiles)
            def _():
                start(i + 1, xw1, sem1)
            pltpu.make_async_copy(
                xp_ref.at[pl.ds(i * TR, WIN)], xw0, sem0).wait()
            compute(xw0)

        @pl.when(i % 2 == 1)
        def _():
            @pl.when(i + 1 < ntiles)
            def _():
                start(i + 1, xw0, sem0)
            pltpu.make_async_copy(
                xp_ref.at[pl.ds(i * TR, WIN)], xw1, sem1).wait()
            compute(xw1)

    raw = pl.pallas_call(
        kern,
        grid=(ntiles,),
        in_specs=[pl.BlockSpec((O, TR), lambda i: (0, i),
                               memory_space=pltpu.VMEM),
                  pl.BlockSpec(memory_space=pl.ANY)],
        out_specs=pl.BlockSpec((TR,), lambda i: (i,),
                               memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((ntiles * TR,), jnp.float32),
        scratch_shapes=[
            pltpu.VMEM((WIN,), jnp.float32),
            pltpu.VMEM((WIN,), jnp.float32),
            pltpu.SemaphoreType.DMA,
            pltpu.SemaphoreType.DMA,
        ],
        interpret=True,
    )
    xpad = jnp.pad(jnp.asarray(lap.x), (-minoff, ntiles * TR + span_pad
                                        - n - (-minoff)))
    y_tpu = raw(jnp.asarray(lap.tbl), xpad)
    shifted = tuple(o - minoff for o in offsets)
    y = cuda_dia.dia_spmv(T(lap.tbl)[None], T(lap.xp)[None], shifted, 0, 0)
    _close(y[0].numpy(), y_tpu)


def test_bench_stream_kernel_against_table_stream(lap):
    """tools/bench_dia_variants.py:162-175 (skern) against K4's
    ``table_stream`` with R = 1, scale = 0.125 on the (O, npad) table."""
    O, ntiles = lap.O, lap.ntiles

    def skern(dval_ref, c_ref, y_ref):
        y_ref[:] = dval_ref[0, :] * 0.125 + c_ref[0]

    stream = pl.pallas_call(
        skern,
        grid=(ntiles,),
        in_specs=[pl.BlockSpec((O, TR), lambda i: (0, i),
                               memory_space=pltpu.VMEM),
                  pl.BlockSpec(memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec((TR,), lambda i: (i,),
                               memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((ntiles * TR,), jnp.float32),
        interpret=True,
    )
    y_tpu = stream(jnp.asarray(lap.tbl), jnp.asarray(lap.c))
    y = k4.table_stream(T(lap.tbl), T(lap.c), ntiles, TR, 1, TR, lap.npad,
                        0.125)
    _close(y.numpy(), y_tpu)


def _probe_runner(lap, kern, scratch):
    """tools/probe_dia_kernels.py:98-114 (runner)."""
    O, n, minoff = lap.O, lap.n, lap.minoff
    npad, ntiles = lap.npad, lap.ntiles
    span_pad = ((lap.span + 1023) // 1024) * 1024
    tbl1 = jnp.asarray(lap.tbl)

    def run(xb):
        xv = xb[0]
        xp = jnp.pad(xv, (-minoff, npad + span_pad - n + minoff))
        y = pl.pallas_call(
            kern,
            grid=(ntiles,),
            in_specs=[pl.BlockSpec((O, TR), lambda i: (0, i),
                                   memory_space=pltpu.VMEM),
                      pl.BlockSpec(memory_space=pl.ANY)],
            out_specs=pl.BlockSpec((TR,), lambda i: (i,),
                                   memory_space=pltpu.VMEM),
            out_shape=jax.ShapeDtypeStruct((npad,), jnp.float32),
            scratch_shapes=scratch,
            interpret=True,
        )(tbl1, xp)
        return y[:n][None]
    return run


def test_probe_v1_against_dia_flat_aligned(lap):
    """tools/probe_dia_kernels.py:117-151 (kern1, v1: every read at the
    window base) against K4's ``dia_flat_spmv`` with aligned=1."""
    O, ntiles = lap.O, lap.ntiles
    span_pad = ((lap.span + 1023) // 1024) * 1024
    WIN = TR + span_pad

    def kern1(dval_ref, xp_ref, y_ref, xw0, xw1, sem0, sem1):
        i = pl.program_id(0)

        def start(j, buf, sem):
            pltpu.make_async_copy(
                xp_ref.at[pl.ds(j * TR, WIN)], buf, sem).start()

        def compute(xw):
            acc = jnp.zeros((TR,), jnp.float32)
            for t in range(O):
                acc = acc + dval_ref[t, :] * xw[pl.ds(0, TR)]
            y_ref[:] = acc

        @pl.when(i == 0)
        def _():
            start(0, xw0, sem0)

        @pl.when(i % 2 == 0)
        def _():
            @pl.when(i + 1 < ntiles)
            def _():
                start(i + 1, xw1, sem1)
            pltpu.make_async_copy(
                xp_ref.at[pl.ds(i * TR, WIN)], xw0, sem0).wait()
            compute(xw0)

        @pl.when(i % 2 == 1)
        def _():
            @pl.when(i + 1 < ntiles)
            def _():
                start(i + 1, xw0, sem0)
            pltpu.make_async_copy(
                xp_ref.at[pl.ds(i * TR, WIN)], xw1, sem1).wait()
            compute(xw1)

    run1 = _probe_runner(lap, kern1, [pltpu.VMEM((WIN,), jnp.float32),
                                      pltpu.VMEM((WIN,), jnp.float32),
                                      pltpu.SemaphoreType.DMA,
                                      pltpu.SemaphoreType.DMA])
    y_tpu = run1(jnp.asarray(lap.x)[None])[0]
    y = k4.dia_flat_spmv(T(lap.tflat), T(lap.xp), lap.offsets, aligned=True)
    _close(y[: lap.n].numpy(), y_tpu)


def _dflat(lap):
    return jnp.asarray(lap.tflat.reshape(-1))


def _stream_call(lap, kern, scratch):
    return pl.pallas_call(
        kern,
        grid=(lap.ntiles,),
        in_specs=[pl.BlockSpec(memory_space=pl.ANY),
                  pl.BlockSpec(memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec((TR,), lambda i: (i,),
                               memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((lap.npad,), jnp.float32),
        scratch_shapes=scratch,
        interpret=True)


def test_probe_v3_against_table_stream(lap):
    """tools/probe_dia_kernels.py:169-214 (kern3, v3: the tile-flat table
    streamed and summed) against K4's ``table_stream`` with R = O."""
    O, ntiles = lap.O, lap.ntiles
    CH = O * TR

    def kern3(df_ref, c_ref, y_ref, dv0, dv1, sem0, sem1):
        i = pl.program_id(0)

        def start(j, buf, sem):
            pltpu.make_async_copy(
                df_ref.at[pl.ds(j * CH, CH)], buf, sem).start()

        def compute(dv):
            acc = jnp.full((TR,), c_ref[0], jnp.float32)
            for t in range(O):
                acc = acc + dv[pl.ds(t * TR, TR)]
            y_ref[:] = acc

        @pl.when(i == 0)
        def _():
            start(0, dv0, sem0)

        @pl.when(i % 2 == 0)
        def _():
            @pl.when(i + 1 < ntiles)
            def _():
                start(i + 1, dv1, sem1)
            pltpu.make_async_copy(
                df_ref.at[pl.ds(i * CH, CH)], dv0, sem0).wait()
            compute(dv0)

        @pl.when(i % 2 == 1)
        def _():
            @pl.when(i + 1 < ntiles)
            def _():
                start(i + 1, dv0, sem0)
            pltpu.make_async_copy(
                df_ref.at[pl.ds(i * CH, CH)], dv1, sem1).wait()
            compute(dv1)

    p3 = _stream_call(lap, kern3, [pltpu.VMEM((CH,), jnp.float32),
                                   pltpu.VMEM((CH,), jnp.float32),
                                   pltpu.SemaphoreType.DMA,
                                   pltpu.SemaphoreType.DMA])
    y_tpu = p3(_dflat(lap), jnp.asarray(lap.c))
    y = k4.table_stream(T(lap.tflat), T(lap.c), ntiles, TR, O, O * TR, TR,
                        1.0)
    _close(y.numpy(), y_tpu)


@pytest.mark.parametrize("depth", [2, 3])
def test_probe_v5_ring_against_table_stream(lap, depth):
    """tools/probe_dia_kernels.py:362-415 (ring_probe's kern5: v3 with two
    half-copies in flight) against K4's ``table_stream`` with ``depth``
    rows in flight a thread (the same function)."""
    O, ntiles = lap.O, lap.ntiles
    CH = O * TR
    H = CH // 2  # two concurrent half-DMAs per chunk

    def kern5(df_ref, c_ref, y_ref, dv0, dv1, s0a, s0b, s1a, s1b):
        i = pl.program_id(0)

        def start(j, buf, sa, sb):
            pltpu.make_async_copy(
                df_ref.at[pl.ds(j * CH, H)], buf.at[pl.ds(0, H)],
                sa).start()
            pltpu.make_async_copy(
                df_ref.at[pl.ds(j * CH + H, H)], buf.at[pl.ds(H, H)],
                sb).start()

        def wait(j, buf, sa, sb):
            pltpu.make_async_copy(
                df_ref.at[pl.ds(j * CH, H)], buf.at[pl.ds(0, H)],
                sa).wait()
            pltpu.make_async_copy(
                df_ref.at[pl.ds(j * CH + H, H)], buf.at[pl.ds(H, H)],
                sb).wait()

        def compute(dv):
            acc = jnp.full((TR,), c_ref[0], jnp.float32)
            for t in range(O):
                acc = acc + dv[pl.ds(t * TR, TR)]
            y_ref[:] = acc

        @pl.when(i == 0)
        def _():
            start(0, dv0, s0a, s0b)

        @pl.when(i % 2 == 0)
        def _():
            @pl.when(i + 1 < ntiles)
            def _():
                start(i + 1, dv1, s1a, s1b)
            wait(i, dv0, s0a, s0b)
            compute(dv0)

        @pl.when(i % 2 == 1)
        def _():
            @pl.when(i + 1 < ntiles)
            def _():
                start(i + 1, dv0, s0a, s0b)
            wait(i, dv1, s1a, s1b)
            compute(dv1)

    p5 = _stream_call(lap, kern5, [pltpu.VMEM((CH,), jnp.float32),
                                   pltpu.VMEM((CH,), jnp.float32),
                                   pltpu.SemaphoreType.DMA,
                                   pltpu.SemaphoreType.DMA,
                                   pltpu.SemaphoreType.DMA,
                                   pltpu.SemaphoreType.DMA])
    y_tpu = p5(_dflat(lap), jnp.asarray(lap.c))
    y = k4.table_stream(T(lap.tflat), T(lap.c), ntiles, TR, O, O * TR, TR,
                        1.0, depth=depth)
    _close(y.numpy(), y_tpu)


def test_probe_v4_against_dia_flat(lap):
    """tools/probe_dia_kernels.py:222-281 (kern4, v4: the DIA SpMV on the
    tile-flat table and a padded x window) against K4's ``dia_flat_spmv``,
    and that against the JAX package's DIA engine and scipy."""
    O, n, ntiles, npad = lap.O, lap.n, lap.ntiles, lap.npad
    offsets, minoff = lap.offsets, lap.minoff
    span_pad = ((lap.span + 1023) // 1024) * 1024
    WIN = TR + span_pad
    CH = O * TR

    def kern4(df_ref, xp_ref, y_ref, dv0, dv1, xw0, xw1, s0, s1, s2, s3):
        i = pl.program_id(0)

        def startd(j, buf, sem):
            pltpu.make_async_copy(
                df_ref.at[pl.ds(j * CH, CH)], buf, sem).start()

        def startx(j, buf, sem):
            pltpu.make_async_copy(
                xp_ref.at[pl.ds(j * TR, WIN)], buf, sem).start()

        def compute(dv, xw):
            acc = jnp.zeros((TR,), jnp.float32)
            for t, o in enumerate(offsets):
                acc = acc + dv[pl.ds(t * TR, TR)] * xw[pl.ds(o - minoff,
                                                             TR)]
            y_ref[:] = acc

        @pl.when(i == 0)
        def _():
            startd(0, dv0, s0)
            startx(0, xw0, s2)

        @pl.when(i % 2 == 0)
        def _():
            @pl.when(i + 1 < ntiles)
            def _():
                startd(i + 1, dv1, s1)
                startx(i + 1, xw1, s3)
            pltpu.make_async_copy(
                df_ref.at[pl.ds(i * CH, CH)], dv0, s0).wait()
            pltpu.make_async_copy(
                xp_ref.at[pl.ds(i * TR, WIN)], xw0, s2).wait()
            compute(dv0, xw0)

        @pl.when(i % 2 == 1)
        def _():
            @pl.when(i + 1 < ntiles)
            def _():
                startd(i + 1, dv0, s0)
                startx(i + 1, xw0, s2)
            pltpu.make_async_copy(
                df_ref.at[pl.ds(i * CH, CH)], dv1, s1).wait()
            pltpu.make_async_copy(
                xp_ref.at[pl.ds(i * TR, WIN)], xw1, s3).wait()
            compute(dv1, xw1)

    p4 = pl.pallas_call(
        kern4,
        grid=(ntiles,),
        in_specs=[pl.BlockSpec(memory_space=pl.ANY),
                  pl.BlockSpec(memory_space=pl.ANY)],
        out_specs=pl.BlockSpec((TR,), lambda i: (i,),
                               memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((npad,), jnp.float32),
        scratch_shapes=[pltpu.VMEM((CH,), jnp.float32),
                        pltpu.VMEM((CH,), jnp.float32),
                        pltpu.VMEM((WIN,), jnp.float32),
                        pltpu.VMEM((WIN,), jnp.float32),
                        pltpu.SemaphoreType.DMA,
                        pltpu.SemaphoreType.DMA,
                        pltpu.SemaphoreType.DMA,
                        pltpu.SemaphoreType.DMA],
        interpret=True)

    def run4(xb):
        xv = xb[0]
        xp = jnp.pad(xv, (-minoff, npad + span_pad - n + minoff))
        return p4(_dflat(lap), xp)[:n][None]

    y_tpu = run4(jnp.asarray(lap.x)[None])[0]
    y = k4.dia_flat_spmv(T(lap.tflat), T(lap.xp), offsets)[:n].numpy()
    _close(y, y_tpu)
    # the JAX package's DIA engine on the same matrix and x
    be = hl.backend_auto(nshards=1, dtype=np.float64)
    Ad = hl.DistSparseMatrix.from_scipy(lap.A, be, dtype=np.float32)
    x = hl.DistVector.from_global(lap.x, be, dtype=np.float32)
    plan = get_spmv_plan(Ad, x)
    assert plan.offsets == offsets
    ex = _dia_exec(plan.offsets, Ad.structure.Lrow, plan.bias_lo,
                   plan.bias_hi, pad_to=plan.exchange.out_pad)
    _close(y, np.asarray(ex(_dia_values(Ad, plan), x.data))[0][:n])
    _close(y, lap.A.astype(np.float64) @ lap.x.astype(np.float64))


@pytest.mark.parametrize("k,F,ntiles", [(8, 3, 4), (16, 8, 3)])
def test_kpayload_kernel_against_plain(k, F, ntiles):
    """tools/probe_kpayload.py:40-60 (kern, run) against K5's plain
    version: the same copy, bit for bit."""
    LANES = 128
    rng = np.random.default_rng(0)
    src = rng.standard_normal((ntiles, F, k, LANES)).astype(np.float32)
    idx = rng.integers(0, LANES, (ntiles, 1, LANES)).astype(np.int8)
    sel = rng.integers(0, F, (ntiles, 1, LANES)).astype(np.uint8)

    def kern(idx_ref, sel_ref, src_ref, out_ref):
        ib = jnp.broadcast_to(idx_ref[0, 0].astype(jnp.int32)[None],
                              (k, LANES))
        sl = jnp.broadcast_to(sel_ref[0, 0].astype(jnp.int32)[None],
                              (k, LANES))
        acc = jnp.zeros((k, LANES), jnp.float32)
        for f in range(F):
            g = jnp.take_along_axis(src_ref[0, f], ib, axis=1)
            acc = jnp.where(sl == f, g, acc)
        out_ref[0] = acc

    @jax.jit
    def run(idx, sel, src):
        return pl.pallas_call(
            kern,
            grid=(ntiles,),
            in_specs=[
                pl.BlockSpec((1, 1, LANES), lambda t: (t, 0, 0),
                             memory_space=pltpu.VMEM),
                pl.BlockSpec((1, 1, LANES), lambda t: (t, 0, 0),
                             memory_space=pltpu.VMEM),
                pl.BlockSpec((1, F, k, LANES), lambda t: (t, 0, 0, 0),
                             memory_space=pltpu.VMEM),
            ],
            out_specs=pl.BlockSpec((1, k, LANES), lambda t: (t, 0, 0),
                                   memory_space=pltpu.VMEM),
            out_shape=jax.ShapeDtypeStruct((ntiles, k, LANES), jnp.float32),
            interpret=True,
        )(idx, sel, src)

    out_tpu = np.asarray(run(jnp.asarray(idx), jnp.asarray(sel),
                             jnp.asarray(src)))
    k5.check_tables(idx, sel, F)
    out = k5.kpayload(T(src), T(idx), T(sel))
    assert out.dtype == torch.float32 and tuple(out.shape) == (ntiles, k, LANES)
    np.testing.assert_array_equal(out.numpy(), out_tpu)


def test_probe_wrappers_check_their_inputs(lap):
    """The wrappers refuse what their kernels do not take, on any device."""
    with pytest.raises(ValueError, match="reads reach"):
        k4.dia_flat_spmv_plain(T(lap.tflat), T(lap.xp[:-1]), lap.offsets)
    with pytest.raises(ValueError, match="ascending"):
        k4.dia_flat_spmv(T(lap.tflat), T(lap.xp), lap.offsets[::-1])
    with pytest.raises(ValueError, match="reach"):
        k4.table_stream(T(lap.tflat), T(lap.c), lap.ntiles + 1, TR, lap.O,
                        lap.O * TR, TR, 1.0)
    with pytest.raises(ValueError, match="rows"):
        k4.table_stream(T(lap.tflat), T(lap.c), 1, TR, 9, 0, 0, 1.0)
    with pytest.raises(IndexError, match="sel"):
        k5.check_tables(np.zeros((1, 1, 128), np.int8),
                        np.full((1, 1, 128), 3, np.uint8), 3)
    with pytest.raises(IndexError, match="idx"):
        k5.check_tables(np.full((1, 1, 128), -1, np.int8),
                        np.zeros((1, 1, 128), np.uint8), 3)
    with pytest.raises(TypeError, match="int8"):
        k5.kpayload(torch.zeros(1, 2, 3, 128),
                    torch.zeros(1, 1, 128, dtype=torch.int64),
                    torch.zeros(1, 1, 128, dtype=torch.uint8))
