"""K1: DIA (stencil) SpMV — the CUDA kernels' wrapper and their plain twin.

``dia_spmv`` computes, for every stacked shard s,

    y[s, i] = sum_t dval[s, t, i] * gp[s, bias_lo + off_t + i]

with ``gp`` the gathered buffer ``g`` cut or zero-padded to ``pad_to``
columns (when given) and zero-padded by ``bias_lo``/``bias_hi`` on either
side: the function of the JAX package's ``_dia_exec``
(hpclinalg/ops/spmv.py) and of its TPU kernels ``_pallas_dia_fn`` /
``_pallas_dia_fn_monolithic`` (hpclinalg/ops/pallas_dia.py).

A CUDA tensor goes to the kernels in ``csrc/dia_spmv.cu``; a CPU tensor
goes to ``dia_spmv_plain``. There is no fallback from one to the other.
Which kernel runs is decided by ``dia_kernel`` from the operands'
alignment: the 16-byte kernel ``dia_vec`` or the scalar ``dia_scalar``
(``dia_vector_width`` rows an access). Both stage the tile's x window that
``dia_layout`` lays out for the pattern; ``dia_spmv_split_plain`` models
the choice, the window and each kernel's walk over y on the CPU. The
kernels take float32, float64, complex64 and complex128 (``KERNEL_DTYPES``),
a complex product in one launch on torch's interleaved values; a c128 row
is one 16-byte unit, so c128 runs ``dia_vec`` a row an access.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from functools import lru_cache

import torch

from ..utils.graphs import count_launch

# The H100's opt-in maximum of dynamic shared memory per block (227 KiB),
# which K1's window and K3's staged x may fill whole (neither kernel has
# static shared memory). A CPU-resident plan or model uses this constant so
# that the CPU tests choose what the card would.
H100_SMEM_CAP = 232448
DIA_MAX_OFFSETS = 64
# The value types of the SpMV kernels K1-K3 and the suffix of each type's
# entry point (csrc/values.cuh)
KERNEL_DTYPES = {torch.float32: "f32", torch.float64: "f64",
                 torch.complex64: "c64", torch.complex128: "c128"}
# a block's threads; a pattern whose window does not fit the shared memory
# at this many takes fewer (dia_layout)
THREADS = 256


def pad_trunc(g: torch.Tensor, pad_to: int) -> torch.Tensor:
    """Cut or zero-pad the slot axis (axis 1) of ``g`` to ``pad_to``
    columns; 0 leaves ``g`` unchanged."""
    if not pad_to or pad_to == g.shape[1]:
        return g
    if pad_to < g.shape[1]:
        return g[:, :pad_to]
    out = g.new_zeros((g.shape[0], pad_to))
    out[:, : g.shape[1]] = g
    return out


def dia_spmv_plain(dval: torch.Tensor, g: torch.Tensor, offsets, bias_lo: int,
                   bias_hi: int, pad_to: int = 0) -> torch.Tensor:
    """Plain PyTorch twin of the kernel: O shifted multiply-adds."""
    g = pad_trunc(g, pad_to)
    dt = torch.promote_types(dval.dtype, g.dtype)
    dval, g = dval.to(dt), g.to(dt)
    S, G = g.shape
    Lrow = dval.shape[2]
    gp = g
    if bias_lo or bias_hi:
        gp = g.new_zeros((S, bias_lo + G + bias_hi))
        gp[:, bias_lo: bias_lo + G] = g
    y = torch.zeros((S, Lrow), dtype=dt, device=g.device)
    for i, o in enumerate(offsets):
        y = y + dval[:, i, :] * gp[:, bias_lo + o: bias_lo + o + Lrow]
    return y


@dataclass(frozen=True)
class DiaLayout:
    """How the kernels walk one pattern. A block takes a ``tile`` of rows,
    16 bytes of rows a thread; piece p = (lo, length, base) of ``pieces``
    stages g[row0 + lo, row0 + lo + length) at win[base, base + length),
    and diagonal t reads tile row r at win[shifts[t] + r]. Pieces are the O
    row intervals [off_t, off_t + tile) merged where they overlap or touch,
    widened to whole 16-byte units."""
    offsets: tuple
    threads: int
    tile: int
    pieces: tuple
    shifts: tuple
    smem_bytes: int


def merge_intervals(offsets, tile: int) -> list[tuple[int, int]]:
    """The diagonals' row intervals [off_t, off_t + tile), merged where they
    overlap or touch: [(first t, last t)] of each merged interval."""
    groups = [[0, 0]]
    for t in range(1, len(offsets)):
        if offsets[t] - offsets[t - 1] <= tile:
            groups[-1][1] = t
        else:
            groups.append([t, t])
    return [tuple(grp) for grp in groups]


@lru_cache(maxsize=256)
def dia_layout(offsets: tuple, esize: int, cap: int) -> DiaLayout:
    """The layout of ``offsets`` for items of ``esize`` bytes whose window
    must fit ``cap`` bytes of shared memory: THREADS a block, or the most
    of 128, 64, 32 whose window fits."""
    offsets = tuple(int(o) for o in offsets)
    if not 1 <= len(offsets) <= DIA_MAX_OFFSETS or any(
            b <= a for a, b in zip(offsets, offsets[1:])):
        raise ValueError("dia_spmv: offsets must be 1 to "
                         f"{DIA_MAX_OFFSETS} strictly ascending ints")
    V = 16 // esize
    for threads in (THREADS, 128, 64, 32):
        tile = threads * V
        pieces, shifts, base = [], [], 0
        for first, last in merge_intervals(offsets, tile):
            lo = offsets[first] // V * V
            length = -(-(offsets[last] + tile) // V) * V - lo
            pieces.append((lo, length, base))
            shifts += [base + offsets[t] - lo for t in range(first, last + 1)]
            base += length
        if base * esize <= cap:
            return DiaLayout(offsets, threads, tile, tuple(pieces),
                             tuple(shifts), base * esize)
    raise ValueError(f"dia_layout: the window of {offsets} does not fit "
                     f"{cap} bytes of shared memory")


def dia_kernel(dval: torch.Tensor, g: torch.Tensor, y: torch.Tensor) -> str:
    """The kernel that runs: ``dia_vec`` (16-byte accesses) when dval, g
    and y start on a 16-byte boundary and Lrow and g's shard stride are
    multiples of the rows of 16 bytes, so every row of the table, of y and
    every shard of g is aligned; else ``dia_scalar``. The window's pieces
    start on whole 16-byte units whatever the offsets, so the offsets do
    not enter."""
    w = 16 // dval.element_size()
    if all(t.data_ptr() % 16 == 0 for t in (dval, g, y)) \
            and dval.shape[2] % w == 0 and g.stride(0) % w == 0:
        return "dia_vec"
    return "dia_scalar"


def dia_vector_width(dval: torch.Tensor, g: torch.Tensor,
                     y: torch.Tensor) -> int:
    """The rows of one access of the kernel that runs: 16 // itemsize
    (``dia_vec``: 4 f32, 2 f64 or c64, 1 c128 row) or 1 (``dia_scalar``;
    ``dia_kernel``)."""
    return 16 // dval.element_size() \
        if dia_kernel(dval, g, y) == "dia_vec" else 1


def dia_spmv_split_plain(dval: torch.Tensor, g: torch.Tensor, offsets,
                         bias_lo: int, bias_hi: int, pad_to: int = 0,
                         cap: int = H100_SMEM_CAP) -> torch.Tensor:
    """CPU model of the kernels: the operands as the wrapper passes them,
    the kernel ``dia_vector_width`` picks, the window ``dia_layout`` lays
    out (staged from g with the kernels' bounds mask; a slot no piece
    stages reads NaN) and that kernel's walk over y (a block a tile; 16
    bytes of rows a thread, as U units of W rows, unit u of thread x at
    tile row (u * threads + x) * W), each row summed in offset order. Raises unless the window
    fits ``cap`` and every element of y is written exactly once."""
    dt = torch.promote_types(dval.dtype, g.dtype)
    dval = dval.to(dt).contiguous()
    g = g.to(dt)
    S, O, Lrow = dval.shape
    G = g.shape[1]
    gcols = min(G, pad_to) if pad_to else G
    lay = dia_layout(tuple(offsets), dt.itemsize, cap)
    if lay.smem_bytes > cap:
        raise AssertionError(f"the window takes {lay.smem_bytes} bytes, "
                             f"over the {cap}-byte cap")
    y = torch.empty((S, Lrow), dtype=dt)
    W = dia_vector_width(dval, g, y)
    U = 16 // dt.itemsize // W
    written = torch.zeros((S, Lrow), dtype=torch.int64)
    tile = lay.tile
    # the tile rows of the block's threads, in the kernel's order
    lane = torch.arange(U)[:, None] * lay.threads + torch.arange(lay.threads)
    rows = (lane[..., None] * W + torch.arange(W)).reshape(-1)
    nwin = lay.smem_bytes // dt.itemsize
    for s in range(S):
        for row0 in range(0, Lrow, tile):
            r = rows[row0 + rows < Lrow]
            i = row0 + r
            win = torch.full((nwin,), float("nan"), dtype=dt)
            for lo, length, base in lay.pieces:
                c = row0 + lo + torch.arange(length)
                live = (c >= 0) & (c < gcols)
                win[base: base + length] = torch.where(
                    live, g[s, c.clamp(0, G - 1)], torch.zeros((), dtype=dt))
            acc = torch.zeros(r.numel(), dtype=dt)
            for t in range(O):
                acc = acc + dval[s, t, i] * win[lay.shifts[t] + r]
            y[s, i] = acc
            written[s, i] += 1
    if not bool((written == 1).all()):
        raise AssertionError("dia_spmv's walk missed or repeated rows")
    return y


@lru_cache(maxsize=1)
def _lib():
    from .cuda_build import load_kernel_lib

    lib = load_kernel_lib("dia_spmv")
    vp, i64, ci = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    for suffix in KERNEL_DTYPES.values():
        fn = getattr(lib, f"dia_spmv_{suffix}")
        fn.argtypes = [vp, vp, vp, i64, i64, i64, i64, vp, ci, ci, i64, vp]
        fn.restype = ci
    lib.dia_spmv_smem_cap.argtypes = [ci]
    lib.dia_spmv_smem_cap.restype = i64
    return lib


class _CLayout(ctypes.Structure):
    """csrc/dia_spmv.cu DiaLayout."""
    _fields_ = [("n", ctypes.c_int), ("npieces", ctypes.c_int)] + [
        (f, ctypes.c_int * DIA_MAX_OFFSETS)
        for f in ("shift", "lo", "len", "base")]


@lru_cache(maxsize=256)
def _c_layout(lay: DiaLayout) -> _CLayout:
    c = _CLayout(len(lay.offsets), len(lay.pieces))
    c.shift[: len(lay.shifts)] = lay.shifts
    for p, (lo, length, base) in enumerate(lay.pieces):
        c.lo[p], c.len[p], c.base[p] = lo, length, base
    return c


@lru_cache(maxsize=None)
def smem_cap(index: int) -> int:
    """The opt-in shared memory a block may take on CUDA device ``index``."""
    from .cuda_build import check

    cap = _lib().dia_spmv_smem_cap(index)
    check(0 if cap >= 0 else -cap, "dia_spmv_smem_cap")
    return cap


def complex_products(fn, vals: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``fn(vals, x)`` of a product linear in each operand, for complex
    operands, as real products of their parts: (vr + i vi)(xr + i xi) =
    (vr xr - vi xi) + i (vr xi + vi xr). Two calls of ``fn`` when one
    operand is complex, four when both are. No kernel runs this way (each
    takes complex in one launch): the tests hold the complex plain versions
    to it."""
    def parts(t):
        return (t.real, t.imag) if t.is_complex() else (t, None)

    (vr, vi), (xr, xi) = parts(vals), parts(x)
    re = fn(vr, xr)
    im = fn(vr, xi) if xi is not None else torch.zeros_like(re)
    if vi is not None:
        im = im + fn(vi, xr)
        if xi is not None:
            re = re - fn(vi, xi)
    return torch.complex(re, im)


def dia_spmv(dval: torch.Tensor, g: torch.Tensor, offsets, bias_lo: int,
             bias_hi: int, pad_to: int = 0) -> torch.Tensor:
    """K1. dval: (S, O, Lrow) contiguous; g: (S, G) with unit column
    stride; offsets: O strictly ascending ints. Runs the kernel
    ``dia_kernel`` picks on the window ``dia_layout`` lays out for this
    device, in one launch for every type of ``KERNEL_DTYPES``. Returns y
    (S, Lrow)."""
    if dval.device.type == "cpu" and g.device.type == "cpu":
        return dia_spmv_plain(dval, g, offsets, bias_lo, bias_hi, pad_to)
    if dval.device != g.device or dval.device.type != "cuda":
        raise ValueError(f"dia_spmv: operands on {dval.device} and {g.device}")
    dt = torch.promote_types(dval.dtype, g.dtype)
    if dt not in KERNEL_DTYPES:
        raise TypeError(f"dia_spmv kernel takes float32/float64/complex64/"
                        f"complex128, got {dt}")
    if dval.dim() != 3 or g.dim() != 2 or dval.shape[0] != g.shape[0] \
            or dval.shape[1] != len(offsets):
        raise ValueError(f"dia_spmv: shapes {tuple(dval.shape)}, "
                         f"{tuple(g.shape)}, {len(offsets)} offsets")
    dval = dval.to(dt).contiguous()
    g = g.to(dt)
    if g.stride(1) != 1:
        g = g.contiguous()
    S, O, Lrow = dval.shape
    y = torch.empty((S, Lrow), dtype=dt, device=g.device)
    if O == 0 or Lrow == 0:
        return y.zero_()
    layout = dia_layout(tuple(offsets), dt.itemsize,
                        smem_cap(g.device.index))
    gcols = min(g.shape[1], pad_to) if pad_to else g.shape[1]
    fn = getattr(_lib(), f"dia_spmv_{KERNEL_DTYPES[dt]}")
    from .cuda_build import check, launch_range, stream_ptr

    kernel = dia_kernel(dval, g, y)
    with launch_range(kernel):
        rc = fn(dval.data_ptr(), g.data_ptr(), y.data_ptr(), S, Lrow, gcols,
                g.stride(0), ctypes.byref(_c_layout(layout)), layout.threads,
                int(kernel == "dia_vec"), layout.smem_bytes, stream_ptr(g))
    check(rc, "dia_spmv")
    count_launch(dia_spmv)
    dia_spmv.kernel = kernel
    return y


dia_spmv.launches = 0
# the kernel of the last launch: "dia_vec" or "dia_scalar" (the entry point
# runs dia_vec exactly when it is passed vector = 1)
dia_spmv.kernel = None
