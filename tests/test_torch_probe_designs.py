"""CPU models of the redesigned probe kernels against their plain versions
and the TPU kernels of the JAX package's probe scripts (Pallas interpret
mode).

K5 (``csrc/kpayload.cu``) stages each tile's touched 32-byte sectors in
shared memory and gathers from them: ``cuda_kpayload.touched_sectors`` is
the list it builds and ``kpayload_staged_plain`` the whole copy, which must
equal ``kpayload_plain`` and the TPU ``kern`` of tools/probe_kpayload.py
bit for bit. K4's ``table_stream`` runs a 16-byte kernel or a scalar one,
by ``stream_vector_width``: ``table_stream_split_plain`` models the choice
and each kernel's walk over y, and must equal ``table_stream_plain`` and
the TPU kernels skern (tools/bench_dia_variants.py) and kern3
(tools/probe_dia_kernels.py) bit for bit: every version rounds each term
as product, then sum, in row order. Sizes are small: 256-row tiles.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from hpclinalg_torch.ops import cuda_dia_probe as k4
from hpclinalg_torch.ops import cuda_kpayload as k5

torch.set_num_threads(1)

LANES = 128
TR = 256


def _tables(k, F, ntiles, pattern, seed=0):
    rng = np.random.default_rng(seed)
    src = rng.standard_normal((ntiles, F, k, LANES)).astype(np.float32)
    idx = rng.integers(0, LANES, (ntiles, 1, LANES)).astype(np.int8)
    sel = rng.integers(0, F, (ntiles, 1, LANES)).astype(np.uint8)
    if pattern == "one sector":          # every lane in sector 5 of plane 0
        idx, sel = (idx % 8 + 40).astype(np.int8), sel * 0
    elif pattern == "even sectors":      # every lane on its pair's even half
        idx = idx & ~8
    return src, idx, sel


def _tpu_kpayload(src, idx, sel):
    """tools/probe_kpayload.py:40-60 (kern, run) in interpret mode."""
    ntiles, F, k, _ = src.shape

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

    run = pl.pallas_call(
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
    )
    return np.asarray(run(jnp.asarray(idx), jnp.asarray(sel),
                          jnp.asarray(src)))


@pytest.mark.parametrize("F,ntiles,pattern,seed", [
    (8, 64, "random", 0), (1, 16, "random", 1), (3, 32, "random", 2),
    (255, 8, "random", 3), (8, 16, "one sector", 4),
    (8, 32, "even sectors", 5)])
def test_touched_sectors_against_numpy(F, ntiles, pattern, seed):
    """Each tile's sector count equals a numpy count of its distinct
    (plane, lane // 8) pairs (the sector form of probe_kpayload's byte
    bound count); the list is sorted and each lane's slot holds its key."""
    _, idx, sel = _tables(1, F, ntiles, pattern, seed)
    keys, count, slot = k5.touched_sectors(torch.from_numpy(idx),
                                           torch.from_numpy(sel), F)
    want = [np.unique(sel[t, 0].astype(np.int64) * 16 + idx[t, 0] // 8).size
            for t in range(ntiles)]
    assert count.tolist() == want
    lane_key = (torch.from_numpy(sel[:, 0]).long() * 16
                + torch.from_numpy(idx[:, 0]).long() // 8)
    assert torch.equal(torch.gather(keys, 1, slot), lane_key)
    for t in range(ntiles):
        n = want[t]
        assert torch.all(keys[t, 1:n] > keys[t, :n - 1])
        assert torch.all(keys[t, n:] == -1)


def test_touched_sectors_refuses_out_of_range():
    idx = np.zeros((1, 1, LANES), np.int8)
    sel = np.full((1, 1, LANES), 3, np.uint8)
    with pytest.raises(IndexError, match="sel"):
        k5.touched_sectors(torch.from_numpy(idx), torch.from_numpy(sel), 3)


@pytest.mark.parametrize("k,F,ntiles,kc,pattern", [
    (64, 8, 6, 8, "random"),        # the probe's k and F
    (13, 8, 5, 8, "random"),        # k not a multiple of kc
    (1, 8, 4, 8, "random"),         # k = 1
    (8, 1, 4, 8, "random"),         # F = 1
    (9, 8, 4, 8, "one sector"),     # every lane in one sector
    (20, 3, 3, 4, "even sectors"),  # the granule control's tables
    (16, 255, 2, 16, "random")])    # every plane sel can name
def test_staged_kpayload_bit_exact(k, F, ntiles, kc, pattern):
    """kpayload_staged_plain (the kernel's sectors, staged kc rows at a
    time) equals kpayload_plain, the wrapper on CPU tensors and the TPU
    kernel, bit for bit."""
    src, idx, sel = _tables(k, F, ntiles, pattern)
    S, I, L = (torch.from_numpy(a) for a in (src, idx, sel))
    staged = k5.kpayload_staged_plain(S, I, L, kc)
    assert staged.dtype == torch.float32 and staged.shape == (ntiles, k, LANES)
    assert torch.equal(staged, k5.kpayload_plain(S, I, L))
    assert torch.equal(staged, k5.kpayload(S, I, L))
    np.testing.assert_array_equal(staged.numpy(), _tpu_kpayload(src, idx, sel))


def _stream_case(layout, R, dtype=np.float32, ntiles=3):
    """(table, c, args) for table_stream on a tile-flat table of R rows:
    aligned, with an odd row stride, or starting one element past a
    16-byte boundary."""
    rng = np.random.default_rng(R)
    row = TR + 1 if layout == "odd row stride" else TR
    ts = R * TR + (R - 1)
    flat = torch.from_numpy(rng.standard_normal(ntiles * ts + TR + 8)
                            .astype(dtype))
    if layout == "unaligned table":
        flat = flat[1:]
    else:
        ts = R * TR
    c = torch.from_numpy(np.array([0.375], dtype))
    return flat, c, (flat, c, ntiles, TR, R, ts, row, 0.5)


@pytest.mark.parametrize("layout", ["aligned", "odd row stride",
                                    "unaligned table"])
@pytest.mark.parametrize("depth", [1, 2, 3])
@pytest.mark.parametrize("R", range(1, 9))
def test_table_stream_split_model(R, depth, layout):
    """The split model (vector body or scalar path, and its walk over y)
    equals table_stream_plain bit for bit, and takes the path the alignment
    rule names."""
    flat, c, args = _stream_case(layout, R)
    want = k4.table_stream_plain(*args, depth=depth)
    got = k4.table_stream_split_plain(*args, depth=depth)
    assert torch.equal(got, want)
    width = k4.stream_vector_width(flat, TR, args[5], args[6])
    assert width == (4 if layout == "aligned" else 1)


def test_table_stream_split_model_f64():
    flat, c, args = _stream_case("aligned", 5, np.float64, ntiles=2)
    assert k4.stream_vector_width(flat, TR, args[5], args[6]) == 2
    for depth in (1, 3):
        assert torch.equal(k4.table_stream_split_plain(*args, depth=depth),
                           k4.table_stream_plain(*args, depth=depth))


def test_stream_vector_width_rule():
    t = torch.zeros(4096, dtype=torch.float32)
    assert k4.stream_vector_width(t, 256, 512, 256) == 4
    assert k4.stream_vector_width(t, 258, 512, 256) == 1      # TR
    assert k4.stream_vector_width(t, 256, 514, 256) == 1      # tile stride
    assert k4.stream_vector_width(t, 256, 512, 257) == 1      # row stride
    assert k4.stream_vector_width(t[1:], 256, 512, 256) == 1  # 4 bytes off
    assert k4.stream_vector_width(t[4:], 256, 512, 256) == 4  # 16 bytes off
    assert k4.stream_vector_width(t, 256, 512, 256, y=t[2:]) == 1
    assert k4.stream_vector_width(t.double(), 256, 512, 256) == 2
    assert [k4.stream_units(d) for d in (1, 2, 3)] == [2, 4, 6]


def _tpu_kern3(tflat, c):
    """tools/probe_dia_kernels.py:169-214 (kern3, v3) in interpret mode on a
    tile-flat (ntiles, R, TR) table."""
    ntiles, R, _ = tflat.shape
    CH = R * TR

    def kern3(df_ref, c_ref, y_ref, dv0, dv1, sem0, sem1):
        i = pl.program_id(0)

        def start(j, buf, sem):
            pltpu.make_async_copy(
                df_ref.at[pl.ds(j * CH, CH)], buf, sem).start()

        def compute(dv):
            acc = jnp.full((TR,), c_ref[0], jnp.float32)
            for t in range(R):
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

    p3 = pl.pallas_call(
        kern3,
        grid=(ntiles,),
        in_specs=[pl.BlockSpec(memory_space=pl.ANY),
                  pl.BlockSpec(memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec((TR,), lambda i: (i,),
                               memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((ntiles * TR,), jnp.float32),
        scratch_shapes=[pltpu.VMEM((CH,), jnp.float32),
                        pltpu.VMEM((CH,), jnp.float32),
                        pltpu.SemaphoreType.DMA,
                        pltpu.SemaphoreType.DMA],
        interpret=True)
    return np.asarray(p3(jnp.asarray(tflat.reshape(-1)), jnp.asarray(c)))


@pytest.mark.parametrize("R", range(1, 9))
def test_table_stream_split_model_against_kern3(R):
    """v3 with R rows: the split model's vector body, at depth 1 + R % 3,
    equals the TPU kern3 bit for bit (scale 1)."""
    ntiles = 3
    rng = np.random.default_rng(10 + R)
    tflat = rng.standard_normal((ntiles, R, TR)).astype(np.float32)
    c = np.array([0.5], np.float32)
    args = (torch.from_numpy(tflat), torch.from_numpy(c), ntiles, TR, R,
            R * TR, TR, 1.0)
    assert k4.stream_vector_width(args[0], TR, R * TR, TR) == 4
    y = k4.table_stream_split_plain(*args, depth=1 + R % 3)
    np.testing.assert_array_equal(y.numpy(), _tpu_kern3(tflat, c))


def test_table_stream_split_model_against_skern():
    """tools/bench_dia_variants.py:162-175 (skern: y = 0.125 row 0 + c on
    the (O, ntiles * TR) table) against the split model's vector body with
    R = 1, bit for bit."""
    O, ntiles = 5, 4
    rng = np.random.default_rng(7)
    tbl = rng.standard_normal((O, ntiles * TR)).astype(np.float32)
    c = np.array([0.5], np.float32)

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
    y_tpu = np.asarray(stream(jnp.asarray(tbl), jnp.asarray(c)))
    args = (torch.from_numpy(tbl), torch.from_numpy(c), ntiles, TR, 1, TR,
            ntiles * TR, 0.125)
    assert k4.stream_vector_width(args[0], TR, TR, ntiles * TR) == 4
    np.testing.assert_array_equal(
        k4.table_stream_split_plain(*args).numpy(), y_tpu)
