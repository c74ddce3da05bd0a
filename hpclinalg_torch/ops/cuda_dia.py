"""K1: DIA (stencil) SpMV — the CUDA kernel's wrapper and its plain twin.

``dia_spmv`` computes, for every stacked shard s,

    y[s, i] = sum_t dval[s, t, i] * gp[s, bias_lo + off_t + i]

with ``gp`` the gathered buffer ``g`` cut or zero-padded to ``pad_to``
columns (when given) and zero-padded by ``bias_lo``/``bias_hi`` on either
side: the function of the JAX package's ``_dia_exec``
(hpclinalg/ops/spmv.py) and of its TPU kernels ``_pallas_dia_fn`` /
``_pallas_dia_fn_monolithic`` (hpclinalg/ops/pallas_dia.py).

A CUDA tensor goes to the kernel in ``csrc/dia_spmv.cu``; a CPU tensor goes
to ``dia_spmv_plain``. There is no fallback from one to the other.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import torch

DIA_MAX_OFFSETS = 64
# rows per block of the shared-memory variant, and the dynamic shared
# memory it may take; wider offset spans use the __ldg variant; threads per
# block of both variants.
SMEM_TILE = 2048
SMEM_MAX_BYTES = 160 * 1024
THREADS = 512


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


@lru_cache(maxsize=1)
def _lib():
    from .cuda_build import load_kernel_lib

    lib = load_kernel_lib("dia_spmv")
    vp, i64, ci = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    for fn in (lib.dia_spmv_f32, lib.dia_spmv_f64):
        fn.argtypes = [vp, vp, vp, i64, i64, i64, i64, ci,
                       ctypes.POINTER(ci), ci, ci, ci, vp]
        fn.restype = ci
    return lib


def dia_variant(offsets, dtype: torch.dtype) -> int:
    """0: shared-memory window; 1: __ldg reads (span too wide for it)."""
    span = offsets[-1] - offsets[0]
    esize = torch.finfo(dtype).bits // 8
    return 0 if (SMEM_TILE + span) * esize <= SMEM_MAX_BYTES else 1


def dia_spmv(dval: torch.Tensor, g: torch.Tensor, offsets, bias_lo: int,
             bias_hi: int, pad_to: int = 0) -> torch.Tensor:
    """K1. dval: (S, O, Lrow) contiguous; g: (S, G) with unit column
    stride; offsets: O strictly ascending ints. Returns y (S, Lrow)."""
    if dval.device.type == "cpu" and g.device.type == "cpu":
        return dia_spmv_plain(dval, g, offsets, bias_lo, bias_hi, pad_to)
    if dval.device != g.device or dval.device.type != "cuda":
        raise ValueError(f"dia_spmv: operands on {dval.device} and {g.device}")
    dt = torch.promote_types(dval.dtype, g.dtype)
    if dt not in (torch.float32, torch.float64):
        raise TypeError(f"dia_spmv kernel takes float32/float64, got {dt}")
    offsets = [int(o) for o in offsets]
    if dval.dim() != 3 or g.dim() != 2 or dval.shape[0] != g.shape[0] \
            or dval.shape[1] != len(offsets):
        raise ValueError(f"dia_spmv: shapes {tuple(dval.shape)}, "
                         f"{tuple(g.shape)}, {len(offsets)} offsets")
    if len(offsets) > DIA_MAX_OFFSETS or any(
            b <= a for a, b in zip(offsets, offsets[1:])):
        raise ValueError("dia_spmv: offsets must be at most "
                         f"{DIA_MAX_OFFSETS} strictly ascending ints")
    dval = dval.to(dt).contiguous()
    g = g.to(dt)
    if g.stride(1) != 1:
        g = g.contiguous()
    S, O, Lrow = dval.shape
    y = torch.empty((S, Lrow), dtype=dt, device=g.device)
    if O == 0 or Lrow == 0:
        return y.zero_()
    gcols = min(g.shape[1], pad_to) if pad_to else g.shape[1]
    lib = _lib()
    fn = lib.dia_spmv_f64 if dt == torch.float64 else lib.dia_spmv_f32
    from .cuda_build import check, stream_ptr

    rc = fn(dval.data_ptr(), g.data_ptr(), y.data_ptr(), S, Lrow, gcols,
            g.stride(0), O, (ctypes.c_int * O)(*offsets),
            dia_variant(offsets, dt), SMEM_TILE, THREADS, stream_ptr(g))
    check(rc, "dia_spmv")
    dia_spmv.launches += 1
    return y


dia_spmv.launches = 0
