"""K2: ELL gather SpMV with a COO tail, and its gather-only mode — the CUDA
kernels' wrappers and their plain twins.

``ell_spmv`` computes, for every stacked shard s,

    y[s, r] = sum_w vals[s, r, w] * g[s, cols[s, r*W + w]]
    y[s, trows[s, j]] += tvals[s, j] * g[s, tgidx[s, j]]   (row Lrow: dropped)

with ``g`` cut or zero-padded to ``pad_to`` columns when given: the
function of the JAX package's ``_ell_exec`` (hpclinalg/ops/spmv.py) and of
its TPU shuffle engine (hpclinalg/ops/pallas_shuffle.py, kernels A, B1 and
B2 plus the SpMV epilogue). ``gather`` is the shuffle engine's own
function, ``xe[s, d] = x[s, src[s, d]]`` with dead slots (``src < 0``) set
to 0 (``shuffle_apply``).

A CUDA tensor goes to the kernels in ``csrc/ell_spmv.cu``; a CPU tensor
goes to the twins. There is no fallback from one to the other. Index tables
must be validated on the host (``check_index``) when they are built: the
kernels do not clip.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import numpy as np
import torch

from .cuda_dia import pad_trunc

THREADS = 256


def check_index(name: str, idx: np.ndarray, hi: int,
                sentinel: int | None = None, dead_below_zero: bool = False):
    """Raise unless every entry of the host table ``idx`` lies in
    ``[0, hi)``, equals the drop ``sentinel``, or (``dead_below_zero``) is
    negative, which marks a dead gather slot."""
    a = np.asarray(idx)
    if not a.size:
        return
    bad = (a >= hi) | (a < 0)
    if sentinel is not None:
        bad &= a != sentinel
    if dead_below_zero:
        bad &= a >= 0
    if bad.any():
        v = a[bad].reshape(-1)[0]
        raise IndexError(f"{name}: index {int(v)} outside [0, {hi})"
                         + (f" and not the drop slot {sentinel}"
                            if sentinel is not None else ""))


def ell_spmv_plain(vals: torch.Tensor, cols: torch.Tensor, g: torch.Tensor,
                   tail=None, pad_to: int = 0) -> torch.Tensor:
    """Plain PyTorch twin: a gather, a row sum and a scatter-add tail."""
    g = pad_trunc(g, pad_to)
    dt = torch.promote_types(vals.dtype, g.dtype)
    g = g.to(dt)
    S, Lrow, W = vals.shape
    xg = torch.gather(g, 1, cols.long()).reshape(S, Lrow, W)
    y = (vals.to(dt) * xg).sum(dim=2)
    if tail is not None:
        tvals, trows, tgidx = tail
        yt = torch.cat([y, y.new_zeros((S, 1))], dim=1)  # column Lrow: drop
        yt.scatter_add_(1, trows.long(),
                        tvals.to(dt) * torch.gather(g, 1, tgidx.long()))
        y = yt[:, :Lrow].contiguous()
    return y


def gather_plain(x: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch twin of the gather-only mode."""
    xe = torch.gather(x, 1, src.clamp(min=0).long())
    return torch.where(src >= 0, xe, torch.zeros((), dtype=x.dtype,
                                                 device=x.device))


@lru_cache(maxsize=1)
def _lib():
    from .cuda_build import load_kernel_lib

    lib = load_kernel_lib("ell_spmv")
    vp, i64, ci = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    for fn in (lib.ell_spmv_f32, lib.ell_spmv_f64):
        fn.argtypes = [vp, vp, vp, vp, vp, vp, vp, i64, i64, ci, i64, i64,
                       i64, ci, ci, vp]
        fn.restype = ci
    for fn in (lib.gather_f32, lib.gather_f64):
        fn.argtypes = [vp, vp, vp, i64, i64, i64, ci, vp]
        fn.restype = ci
    return lib


def _threads_per_row(W: int) -> int:
    """Power of two <= 32 covering W: a row's entries are read by that many
    neighbouring threads."""
    p = 1
    while p < W and p < 32:
        p *= 2
    return p


def _cuda_operands(name, *ts):
    dev = ts[0].device
    if dev.type != "cuda" or any(t.device != dev for t in ts):
        raise ValueError(f"{name}: operands on {[str(t.device) for t in ts]}")


def _int32_contig(name, t):
    if t.dtype != torch.int32 or not t.is_contiguous():
        raise TypeError(f"{name}: index tables must be contiguous int32")


def ell_spmv(vals: torch.Tensor, cols: torch.Tensor, g: torch.Tensor,
             tail=None, pad_to: int = 0) -> torch.Tensor:
    """K2. vals: (S, Lrow, W); cols: (S, Lrow*W) int32; g: (S, G) with unit
    column stride; tail: None or (tvals, trows, tgidx), each (S, Tpad), the
    last two int32. Returns y (S, Lrow)."""
    ops = [vals, cols, g] + (list(tail) if tail is not None else [])
    if all(t.device.type == "cpu" for t in ops):
        return ell_spmv_plain(vals, cols, g, tail, pad_to)
    _cuda_operands("ell_spmv", *ops)
    dt = torch.promote_types(vals.dtype, g.dtype)
    if dt not in (torch.float32, torch.float64):
        raise TypeError(f"ell_spmv kernel takes float32/float64, got {dt}")
    if vals.dim() != 3 or g.dim() != 2 or cols.shape != (
            vals.shape[0], vals.shape[1] * vals.shape[2]) \
            or g.shape[0] != vals.shape[0]:
        raise ValueError(f"ell_spmv: shapes {tuple(vals.shape)}, "
                         f"{tuple(cols.shape)}, {tuple(g.shape)}")
    _int32_contig("ell_spmv", cols)
    S, Lrow, W = vals.shape
    vals = vals.to(dt).contiguous()
    g = g.to(dt)
    if g.stride(1) != 1:
        g = g.contiguous()
    Tpad = 0
    tv = tr = tg = vals  # not read when Tpad == 0
    if tail is not None:
        tv, tr, tg = tail
        if tv.dim() != 2 or tv.shape[0] != S or tr.shape != tv.shape \
                or tg.shape != tv.shape:
            raise ValueError("ell_spmv: tail tables must all be (S, Tpad)")
        _int32_contig("ell_spmv tail", tr)
        _int32_contig("ell_spmv tail", tg)
        tv = tv.to(dt).contiguous()
        Tpad = tv.shape[1]
    y = torch.empty((S, Lrow), dtype=dt, device=g.device)
    if Lrow == 0 or W == 0:
        return y.zero_()
    gcols = min(g.shape[1], pad_to) if pad_to else g.shape[1]
    lib = _lib()
    fn = lib.ell_spmv_f64 if dt == torch.float64 else lib.ell_spmv_f32
    from .cuda_build import check, stream_ptr

    rc = fn(vals.data_ptr(), cols.data_ptr(), tv.data_ptr(), tr.data_ptr(),
            tg.data_ptr(), g.data_ptr(), y.data_ptr(), S, Lrow, W, Tpad,
            gcols, g.stride(0), _threads_per_row(W), THREADS, stream_ptr(g))
    check(rc, "ell_spmv")
    ell_spmv.launches += 1
    return y


ell_spmv.launches = 0


def gather(x: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """K2's gather-only mode. x: (S, Lx) with unit column stride; src:
    (S, D) int32 with entries in [0, Lx) or negative (dead slot -> 0).
    Returns xe (S, D) in x's dtype."""
    if x.device.type == "cpu" and src.device.type == "cpu":
        return gather_plain(x, src)
    _cuda_operands("gather", x, src)
    if x.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"gather kernel takes float32/float64, got {x.dtype}")
    if x.dim() != 2 or src.dim() != 2 or src.shape[0] != x.shape[0]:
        raise ValueError(f"gather: shapes {tuple(x.shape)}, {tuple(src.shape)}")
    _int32_contig("gather", src)
    if x.stride(1) != 1:
        x = x.contiguous()
    S, D = src.shape
    xe = torch.empty((S, D), dtype=x.dtype, device=x.device)
    if D == 0:
        return xe
    lib = _lib()
    fn = lib.gather_f64 if x.dtype == torch.float64 else lib.gather_f32
    from .cuda_build import check, stream_ptr

    rc = fn(x.data_ptr(), src.data_ptr(), xe.data_ptr(), S, D, x.stride(0),
            THREADS, stream_ptr(x))
    check(rc, "gather")
    gather.launches += 1
    return xe


gather.launches = 0
