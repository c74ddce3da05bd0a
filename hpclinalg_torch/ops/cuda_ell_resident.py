"""K3: ELL SpMV with x read from shared memory — the CUDA kernel's wrapper
and its plain version.

``ell_resident_spmv`` computes K2's function (``ops/cuda_ell.py``) on the
same plan tables, for every stacked shard s,

    y[s, r] = sum_w vals[s, r, w] * g[s, cols[s, r*W + w]]
    y[s, trows[s, j]] += tvals[s, j] * g[s, tgidx[s, j]]   (row Lrow: dropped)

with ``g`` cut or zero-padded to ``pad_to`` columns when given: the function
of the JAX package's TPU kernel ``_pallas_ell_fn``
(hpclinalg/ops/pallas_csr.py) and of its ``_ell_exec``
(hpclinalg/ops/spmv.py). The kernel (``csrc/ell_resident_spmv.cu``) stages
in shared memory, for each row tile, the column window its stored entries
read (``make_windows``, built once with the plan), or the whole gathered
x when two windows do not fit the device's shared-memory cap per block
(``smem_cap``); the SpMV plan picks the engine by the whole x fitting that
cap (``ops/spmv.py``), as the JAX package's ``ell_policy_would_accept``.

The kernel takes float32, float64, complex64 and complex128
(``cuda_dia.KERNEL_DTYPES``), a complex product in one launch; the staged
x and the cap are counted in the complex item size (a c128 slot is 16
bytes), so half as many c128 columns fit as f64 ones.

A CUDA tensor goes to the kernel; a CPU tensor goes to the plain version.
There is no fallback from one to the other. Index tables must be validated
on the host (``check_index``) when they are built: the kernel does not clip.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

from typing import NamedTuple

import numpy as np
import torch

from ..utils.graphs import count_launch
from .cuda_dia import H100_SMEM_CAP, KERNEL_DTYPES
from .cuda_ell import ell_operands, ell_spmv_plain, on_cpu, rows_per_pass

# The plain version: K3 computes K2's function, so it is K2's plain version.
ell_resident_spmv_plain = ell_spmv_plain
# window ends are widened to 16 bytes of every type: 4 slots (f32's 16
# bytes, a multiple of f64's, c64's and c128's)
WINDOW_ALIGN = 4
# Row tiles over all shards that tile_rows aims at. The kernel's persistent
# grid gives each block a fixed share of the tiles, so the tile count
# against the blocks the card holds at once decides how even that share is;
# this count is the one chip_smoke.py's tile sweep favoured on N and the
# ridge design A on the H100 (PERF.md). It is a tuned constant, not a figure
# read from the card.
TILES = 1024
MAX_PASSES = 8     # row passes a tile at most


def tile_rows(lanes: int, rows: int) -> int:
    """Rows of K3's tile for groups of ``lanes`` threads, ``rows`` rows in
    all shards: whole passes of the block (``rows_per_pass``), the fewest
    that leave at most TILES tiles, 1 to MAX_PASSES. One staged window
    serves the whole tile. (chip_smoke.py times tiles of 1 to 16 passes on
    N and on the ridge design A beside this choice; PERF.md has the
    numbers.)"""
    per = rows_per_pass(lanes)
    return per * max(1, min(MAX_PASSES, -(-rows // (per * TILES))))


class Windows(NamedTuple):
    """K3's staging layout for one plan, dtype and group width, checked
    when it is made (``make_windows``): ``table`` (S, ntiles, 2) int32 on
    the device holds [lo, hi) of tile t (rows t*tile_rows ...), (0, 0) for
    a tile with no stored entry; ``width`` is the slots a staging buffer
    needs; ``staged`` is ``width``, or 0 when two buffers do not fit the
    device's shared-memory cap and the kernel stages the whole x."""
    table: torch.Tensor
    lanes: int
    tile_rows: int
    width: int
    staged: int


def ell_windows(cols: np.ndarray, rowlen: np.ndarray, tile_rows: int):
    """Host table of the columns each tile of ``tile_rows`` rows reads
    through its stored entries (entries w < rowlen of each row; padding is
    never read). cols: (S, Lrow*W) or (S, Lrow, W); rowlen: (S, Lrow).
    Returns (table (S, ntiles, 2) int32, width): width is the largest
    window with both ends widened to WINDOW_ALIGN slots."""
    S, Lrow = rowlen.shape
    c = np.asarray(cols).reshape(S, Lrow, -1)
    live = np.arange(c.shape[2]) < rowlen[:, :, None]
    big = np.iinfo(np.int32).max
    cmin = np.where(live, c, np.int32(big)).min(axis=2)
    cmax = np.where(live, c, np.int32(-1)).max(axis=2)
    ntiles = -(-Lrow // tile_rows)
    pad = ntiles * tile_rows - Lrow
    cmin = np.pad(cmin, ((0, 0), (0, pad)), constant_values=big)
    cmax = np.pad(cmax, ((0, 0), (0, pad)), constant_values=-1)
    lo = cmin.reshape(S, ntiles, tile_rows).min(axis=2)
    hi = cmax.reshape(S, ntiles, tile_rows).max(axis=2) + 1
    empty = hi == 0
    lo[empty] = 0
    table = np.stack([lo, hi], axis=2).astype(np.int32)
    a = WINDOW_ALIGN
    width = int(((-(-hi // a)) * a - (lo // a) * a).max()) if table.size else 0
    return table, max(width, a)


def make_windows(cols: np.ndarray, rowlen: np.ndarray, lanes: int,
                 dtype: torch.dtype, device: torch.device,
                 tile: int = 0, shards: range | None = None) -> Windows:
    """K3's windows of the host tables ``cols`` and ``rowlen`` for groups
    of ``lanes`` threads in ``dtype`` on ``device``, in tiles of ``tile``
    rows (default ``tile_rows(lanes, rowlen.size)``; whole row passes).
    The tile and the staging width are those of all shards; the table on
    the device holds the rows ``shards`` (default all: a process group's
    rank keeps its own)."""
    per = rows_per_pass(lanes)
    tile = tile or tile_rows(lanes, rowlen.size)
    if tile < per or tile % per:
        raise ValueError(f"make_windows: {tile}-row tiles are not whole "
                         f"passes of {per} rows")
    table, width = ell_windows(cols, rowlen, tile)
    staged = width if 2 * width * dtype.itemsize <= smem_cap(device) else 0
    if shards is not None:
        table = table[shards.start: shards.stop]
    return Windows(torch.from_numpy(table).to(device), lanes, tile, width,
                   staged)


@lru_cache(maxsize=1)
def _lib():
    from .cuda_build import load_kernel_lib

    lib = load_kernel_lib("ell_resident_spmv")
    vp, i64, ci = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    for suffix in KERNEL_DTYPES.values():
        fn = getattr(lib, f"ell_resident_spmv_{suffix}")
        fn.argtypes = [vp] * 9 + [i64, i64, ci, i64, i64, i64, i64, ci, ci,
                                  i64, ci, ci, vp]
        fn.restype = ci
    lib.ell_resident_smem_cap.argtypes = [ci]
    lib.ell_resident_smem_cap.restype = i64
    return lib


@lru_cache(maxsize=None)
def _device_cap(index: int) -> int:
    cap = int(_lib().ell_resident_smem_cap(index))
    if cap < 0:
        raise RuntimeError(f"ell_resident_smem_cap: CUDA error {-cap}")
    return cap


def smem_cap(device: torch.device) -> int:
    """Largest gathered-x size in bytes the kernel can stage on ``device``:
    read from the card for a CUDA device, the H100's for the CPU."""
    if device.type != "cuda":
        return H100_SMEM_CAP
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    return _device_cap(index)


def ell_resident_spmv(vals: torch.Tensor, cols: torch.Tensor, g: torch.Tensor,
                      tail=None, pad_to: int = 0,
                      rowlen: torch.Tensor | None = None, lanes: int = 0,
                      windows: Windows | None = None,
                      checked: bool = False) -> torch.Tensor:
    """K3. vals: (S, Lrow, W); cols: (S, Lrow*W) int32; g: (S, G) with unit
    column stride; tail: None or (tvals, trows, tgidx), each (S, Tpad), the
    last two int32; rowlen, lanes: as for K2 (``cuda_ell.ell_spmv``);
    windows: ``make_windows`` of these tables for ``lanes`` (the plan's
    ``ell_layout`` holds them). Without windows, or when they stage the
    whole x, the gathered width ``pad_to`` (or G) times the item size must
    fit ``smem_cap``. checked: the index tables and windows come from the
    plan (``cuda_ell.ell_operands``). The plain version on CPU tensors
    needs none of rowlen, lanes, windows. Returns y (S, Lrow)."""
    if on_cpu("ell_resident_spmv", vals, cols, g, tail, checked):
        return ell_resident_spmv_plain(vals, cols, g, tail, pad_to)
    dt, vals, g, tail, vec = ell_operands("ell_resident_spmv", vals, cols, g,
                                          tail, rowlen, lanes, checked)
    S, Lrow, W = vals.shape
    G = pad_to if pad_to else g.shape[1]
    win_cap, wt = 0, None
    if windows is None:
        tile = tile_rows(lanes, S * Lrow)
    else:
        wt, tile, win_cap = windows.table, windows.tile_rows, windows.staged
        if not checked and (windows.lanes != lanes or wt.device != g.device
                            or wt.shape[:2] != (S, -(-Lrow // tile))):
            raise ValueError(f"ell_resident_spmv: windows of {windows.lanes}"
                             f" lanes, {tuple(wt.shape)}, for {lanes} lanes "
                             f"and {S} x {Lrow} rows")
    if not win_cap and -(-G * dt.itemsize // 16) * 16 > smem_cap(g.device):
        raise ValueError(f"ell_resident_spmv: {G} gathered slots of {dt} "
                         f"exceed the shared-memory cap "
                         f"{smem_cap(g.device)} bytes")
    tv, tr, tg = tail if tail is not None else (vals,) * 3  # not read
    Tpad = tv.shape[1] if tail is not None else 0
    y = torch.empty((S, Lrow), dtype=dt, device=g.device)
    if Lrow == 0 or W == 0 or G == 0:
        return y.zero_()
    gcols = min(g.shape[1], G)
    aligned = int(g.data_ptr() % 16 == 0
                  and g.stride(0) * dt.itemsize % 16 == 0)
    fn = getattr(_lib(), f"ell_resident_spmv_{KERNEL_DTYPES[dt]}")
    from .cuda_build import check, launch_range, stream_ptr

    with launch_range("ell_resident_rows"):
        rc = fn(vals.data_ptr(), cols.data_ptr(), rowlen.data_ptr(),
                wt.data_ptr() if win_cap else None,
                tv.data_ptr(), tr.data_ptr(), tg.data_ptr(), g.data_ptr(),
                y.data_ptr(), S, Lrow, W, Tpad, G, gcols, g.stride(0), lanes,
                vec, tile, win_cap, aligned, stream_ptr(g))
    check(rc, "ell_resident_spmv")
    count_launch(ell_resident_spmv)
    return y


ell_resident_spmv.launches = 0
