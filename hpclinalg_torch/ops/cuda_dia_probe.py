"""K4: the DIA probe kernels — the CUDA kernels' wrappers and their plain
versions.

``dia_flat_spmv`` is the stencil SpMV on a tile-flat table
``tbl`` (ntiles, O, TR) and an x pre-padded by ``-offsets[0]`` zeros:

    y[i] = sum_t tbl[i // TR, t, i % TR] * xp[i + off_t - off_0]   (aligned=0)
    y[i] = sum_t tbl[i // TR, t, i % TR] * xp[i]                   (aligned=1)

for i < ntiles * TR: the functions of the TPU kernels ``kern4`` (v4) and
``kern1`` (v1, wrong by design: it prices the shifted reads) of
``tools/probe_dia_kernels.py``. ``table_stream`` is the stream probe

    y[i] = c + sum_{t<R} scale * tbl.flat[(i // TR) * tile_stride
                                          + t * row_stride + i % TR]

with ``c`` a one-element tensor: ``skern`` of ``tools/bench_dia_variants.py``
(R = 1, scale = 0.125 on the (O, ntiles * TR) table) and ``kern3``/``kern5``
of ``tools/probe_dia_kernels.py`` (R = O, scale = 1 on the tile-flat table;
``depth`` rows in flight a thread). Both write ``ntiles * TR`` rows, the
TPU kernels' output length.

A CUDA tensor goes to the kernels in ``csrc/dia_probe.cu``; a CPU tensor
goes to the plain versions. There is no fallback from one to the other.
``table_stream`` runs one of two kernels, by ``stream_vector_width``: the
16-byte kernel when the table and y are 16-byte aligned and ``TR`` and
both strides are multiples of the vector width, else the scalar one;
``table_stream_split_plain`` models that split and each kernel's walk
over y on the CPU.
They are run by ``python -m hpclinalg_torch.tools.dia_variants`` and
``proto_dia``.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import torch

from ..utils.graphs import count_launch

PROBE_MAX_OFFSETS = 64
STREAM_MAX_R = 8
THREADS = 256   # dia_flat_spmv's and table_stream_scalar's block
STREAM_THREADS = 256   # table_stream_vec's block


def _check_offsets(offsets):
    offsets = [int(o) for o in offsets]
    if not 1 <= len(offsets) <= PROBE_MAX_OFFSETS or any(
            b <= a for a, b in zip(offsets, offsets[1:])):
        raise ValueError(f"offsets must be 1 to {PROBE_MAX_OFFSETS} strictly "
                         "ascending ints")
    return offsets


def _check_flat(tbl, xp, offsets):
    if tbl.dim() != 3 or xp.dim() != 1 or tbl.shape[1] != len(offsets):
        raise ValueError(f"dia_flat_spmv: table {tuple(tbl.shape)} (ntiles, "
                         f"O, TR), xp {tuple(xp.shape)}, {len(offsets)} "
                         "offsets")
    ntiles, _, TR = tbl.shape
    need = ntiles * TR + offsets[-1] - offsets[0]
    if xp.shape[0] < need:
        raise ValueError(f"dia_flat_spmv: xp has {xp.shape[0]} entries, the "
                         f"reads reach {need}")


def dia_flat_spmv_plain(tbl: torch.Tensor, xp: torch.Tensor, offsets,
                        aligned: bool = False) -> torch.Tensor:
    """Plain PyTorch version of ``dia_flat_spmv``."""
    offsets = _check_offsets(offsets)
    _check_flat(tbl, xp, offsets)
    ntiles, O, TR = tbl.shape
    n = ntiles * TR
    rows = tbl.permute(1, 0, 2).reshape(O, n)
    y = torch.zeros(n, dtype=tbl.dtype, device=tbl.device)
    for t, o in enumerate(offsets):
        j = 0 if aligned else o - offsets[0]
        y = y + rows[t] * xp[j: j + n]
    return y


def _check_stream(tbl, ntiles, TR, R, tile_stride, row_stride):
    if not 1 <= R <= STREAM_MAX_R:
        raise ValueError(f"table_stream reads 1 to {STREAM_MAX_R} rows, not "
                         f"{R}")
    reach = (ntiles - 1) * tile_stride + (R - 1) * row_stride + TR
    if ntiles < 1 or TR < 1 or tile_stride < 0 or row_stride < 0 \
            or reach > tbl.numel():
        raise ValueError(f"table_stream: {ntiles} tiles of {TR} with strides "
                         f"({tile_stride}, {row_stride}) reach {reach} of a "
                         f"{tbl.numel()}-element table")


def _stream_rows(tbl, ntiles, TR, R, tile_stride, row_stride):
    """(R, ntiles * TR) copy of the rows the stream probe reads."""
    _check_stream(tbl, ntiles, TR, R, tile_stride, row_stride)
    v = torch.as_strided(tbl.reshape(-1), (R, ntiles, TR),
                         (row_stride, tile_stride, 1))
    return v.reshape(R, ntiles * TR)


def table_stream_plain(tbl: torch.Tensor, c: torch.Tensor, ntiles: int,
                       TR: int, R: int, tile_stride: int, row_stride: int,
                       scale: float, depth: int = 1) -> torch.Tensor:
    """Plain PyTorch version of ``table_stream`` (``depth`` changes only
    how the kernel issues its loads, not what it computes)."""
    v = _stream_rows(tbl, ntiles, TR, R, tile_stride, row_stride)
    y = c.reshape(1).expand(ntiles * TR).to(tbl.dtype)
    for t in range(R):
        y = y + scale * v[t]
    return y


def stream_vector_width(tbl: torch.Tensor, TR: int, tile_stride: int,
                        row_stride: int, y: torch.Tensor | None = None) -> int:
    """The elements of one 16-byte access that ``table_stream`` reads and
    writes: 16 // itemsize when ``tbl`` (and ``y``, if given) start on a
    16-byte boundary and TR, tile_stride and row_stride are multiples of
    it (the vector kernel), else 1 (the scalar kernel)."""
    w = 16 // tbl.element_size()
    ptrs = [tbl.data_ptr()] + ([] if y is None else [y.data_ptr()])
    if all(p % 16 == 0 for p in ptrs) and TR % w == 0 \
            and tile_stride % w == 0 and row_stride % w == 0:
        return w
    return 1


def stream_units(depth: int) -> int:
    """16-byte units a thread of the vector kernel loads, each from all R
    rows, before it sums: 2 * depth (csrc/dia_probe.cu launch_vec)."""
    return 2 * depth


def table_stream_split_plain(tbl: torch.Tensor, c: torch.Tensor, ntiles: int,
                             TR: int, R: int, tile_stride: int,
                             row_stride: int, scale: float,
                             depth: int = 1) -> torch.Tensor:
    """CPU model of ``table_stream``'s two kernels: the path
    ``stream_vector_width`` picks, and that kernel's walk over y (the
    vector kernel's blocks of STREAM_THREADS * U units of one tile, U
    units a thread, a block apart; the scalar kernel's depth rows a
    thread, a depth-th of the tile apart), each element summed in the
    kernels' order. Raises unless every element of y is written exactly
    once."""
    _check_stream(tbl, ntiles, TR, R, tile_stride, row_stride)
    if depth not in (1, 2, 3):
        raise ValueError(f"table_stream: depth {depth} is not 1, 2 or 3")
    flat = tbl.reshape(-1)
    y = torch.empty(ntiles * TR, dtype=tbl.dtype)
    written = torch.zeros(ntiles * TR, dtype=torch.int64)
    c0 = c.reshape(1).to(tbl.dtype)
    w = stream_vector_width(tbl, TR, tile_stride, row_stride, y)
    if w > 1:
        U = stream_units(depth)
        per = STREAM_THREADS * U
        TRv = TR // w
        chunks = -(-TRv // per)
        lane = torch.arange(U)[:, None] * STREAM_THREADS \
            + torch.arange(STREAM_THREADS)[None, :]
        walks = []
        for ch in range(chunks):      # the units of block (ch, tile)
            r = (ch * per + lane).reshape(-1)
            walks.append(r[r < TRv])
        elems = [(r[:, None] * w + torch.arange(w)[None, :]).reshape(-1)
                 for r in walks]
    else:
        Gt = -(-TR // depth)
        g = torch.arange(Gt)
        elems = []
        for d in range(depth):        # row g + d * Gt of thread g
            r = g + d * Gt
            elems.append(r[r < TR])
    for tile in range(ntiles):
        for e in elems:
            acc = c0.expand(e.numel())
            for t in range(R):
                acc = acc + scale * flat[tile * tile_stride + t * row_stride
                                         + e]
            y[tile * TR + e] = acc
            written[tile * TR + e] += 1
    if not bool((written == 1).all()):
        raise AssertionError("table_stream's walk missed or repeated rows")
    return y


@lru_cache(maxsize=1)
def _lib():
    from .cuda_build import load_kernel_lib

    lib = load_kernel_lib("dia_probe")
    vp, i64, ci = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    for fn in (lib.dia_flat_spmv_f32, lib.dia_flat_spmv_f64):
        fn.argtypes = [vp, vp, vp, i64, ci, ci, ctypes.POINTER(ci), ci, ci,
                       vp]
        fn.restype = ci
    for fn in (lib.table_stream_f32, lib.table_stream_f64):
        fn.argtypes = [vp, vp, vp, i64, ci, ci, i64, i64, ctypes.c_double,
                       ci, ci, ci, vp]
        fn.restype = ci
    return lib


def _cuda_float(name, *ts):
    dev = ts[0].device
    if dev.type != "cuda" or any(t.device != dev for t in ts):
        raise ValueError(f"{name}: operands on {[str(t.device) for t in ts]}")
    dt = ts[0].dtype
    if dt not in (torch.float32, torch.float64) \
            or any(t.dtype != dt for t in ts):
        raise TypeError(f"{name} takes float32 or float64 operands of one "
                        f"type, got {[t.dtype for t in ts]}")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError(f"{name}: operands must be contiguous")


def dia_flat_spmv(tbl: torch.Tensor, xp: torch.Tensor, offsets,
                  aligned: bool = False) -> torch.Tensor:
    """K4's SpMV. tbl: (ntiles, O, TR); xp: (>= ntiles*TR + span,);
    offsets: O strictly ascending ints. Returns y (ntiles * TR,)."""
    if tbl.device.type == "cpu" and xp.device.type == "cpu":
        return dia_flat_spmv_plain(tbl, xp, offsets, aligned)
    _cuda_float("dia_flat_spmv", tbl, xp)
    offsets = _check_offsets(offsets)
    _check_flat(tbl, xp, offsets)
    ntiles, O, TR = tbl.shape
    y = torch.empty(ntiles * TR, dtype=tbl.dtype, device=tbl.device)
    lib = _lib()
    fn = lib.dia_flat_spmv_f64 if tbl.dtype == torch.float64 \
        else lib.dia_flat_spmv_f32
    from .cuda_build import check, stream_ptr

    rc = fn(tbl.data_ptr(), xp.data_ptr(), y.data_ptr(), ntiles, TR, O,
            (ctypes.c_int * O)(*offsets), int(bool(aligned)), THREADS,
            stream_ptr(tbl))
    check(rc, "dia_flat_spmv")
    count_launch(dia_flat_spmv)
    return y


dia_flat_spmv.launches = 0


def table_stream(tbl: torch.Tensor, c: torch.Tensor, ntiles: int, TR: int,
                 R: int, tile_stride: int, row_stride: int, scale: float,
                 depth: int = 1) -> torch.Tensor:
    """K4's stream probe. tbl: any contiguous table; c: one element of
    tbl's dtype; depth: 1, 2 or 3 (the loads in flight a thread). Runs the
    vector or the scalar kernel, as ``stream_vector_width`` says. Returns
    y (ntiles * TR,)."""
    if tbl.device.type == "cpu" and c.device.type == "cpu":
        return table_stream_plain(tbl, c, ntiles, TR, R, tile_stride,
                                  row_stride, scale, depth)
    _cuda_float("table_stream", tbl, c)
    if c.numel() != 1:
        raise ValueError("table_stream: c must hold one element")
    if depth not in (1, 2, 3):
        raise ValueError(f"table_stream: depth {depth} is not 1, 2 or 3")
    _check_stream(tbl, ntiles, TR, R, tile_stride, row_stride)
    y = torch.empty(ntiles * TR, dtype=tbl.dtype, device=tbl.device)
    lib = _lib()
    fn = lib.table_stream_f64 if tbl.dtype == torch.float64 \
        else lib.table_stream_f32
    from .cuda_build import check, stream_ptr

    vec = stream_vector_width(tbl, TR, tile_stride, row_stride, y)
    rc = fn(tbl.data_ptr(), c.data_ptr(), y.data_ptr(), ntiles, TR, R,
            tile_stride, row_stride, float(scale), depth, THREADS, vec,
            stream_ptr(tbl))
    check(rc, "table_stream")
    count_launch(table_stream)
    return y


table_stream.launches = 0
