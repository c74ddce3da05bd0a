"""K3: ELL SpMV with the whole gathered x resident in shared memory — the
CUDA kernel's wrapper and its plain version.

``ell_resident_spmv`` computes K2's function (``ops/cuda_ell.py``) on the
same plan tables, for every stacked shard s,

    y[s, r] = sum_w vals[s, r, w] * g[s, cols[s, r*W + w]]
    y[s, trows[s, j]] += tvals[s, j] * g[s, tgidx[s, j]]   (row Lrow: dropped)

with ``g`` cut or zero-padded to ``pad_to`` columns when given: the function
of the JAX package's TPU kernel ``_pallas_ell_fn``
(hpclinalg/ops/pallas_csr.py) and of its ``_ell_exec``
(hpclinalg/ops/spmv.py). The kernel (``csrc/ell_resident_spmv.cu``) stages
the gathered x of each shard in shared memory, so it takes only a gathered
width whose bytes fit the device's shared-memory cap per block
(``smem_cap``); the SpMV plan picks it by that rule (``ops/spmv.py``).

A CUDA tensor goes to the kernel; a CPU tensor goes to the plain version.
There is no fallback from one to the other. Index tables must be validated
on the host (``check_index``) when they are built: the kernel does not clip.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import torch

from .cuda_ell import (_cuda_operands, _int32_contig, _threads_per_row,
                       ell_spmv_plain)

THREADS = 1024
# The H100's opt-in maximum of dynamic shared memory per block (227 KiB),
# which the kernel may fill whole (it has no static shared memory). A
# CPU-resident plan uses this constant so that the CPU tests choose the
# engines the card would.
H100_SMEM_CAP = 232448

# The plain version: K3 computes K2's function, so it is K2's plain version.
ell_resident_spmv_plain = ell_spmv_plain


@lru_cache(maxsize=1)
def _lib():
    from .cuda_build import load_kernel_lib

    lib = load_kernel_lib("ell_resident_spmv")
    vp, i64, ci = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    for fn in (lib.ell_resident_spmv_f32, lib.ell_resident_spmv_f64):
        fn.argtypes = [vp, vp, vp, vp, vp, vp, vp, i64, i64, ci, i64, i64,
                       i64, i64, ci, ci, vp]
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
                      tail=None, pad_to: int = 0) -> torch.Tensor:
    """K3. vals: (S, Lrow, W); cols: (S, Lrow*W) int32; g: (S, G) with unit
    column stride; tail: None or (tvals, trows, tgidx), each (S, Tpad), the
    last two int32. The gathered width ``pad_to`` (or G) times the item
    size must fit ``smem_cap``. Returns y (S, Lrow)."""
    ops = [vals, cols, g] + (list(tail) if tail is not None else [])
    if all(t.device.type == "cpu" for t in ops):
        return ell_resident_spmv_plain(vals, cols, g, tail, pad_to)
    _cuda_operands("ell_resident_spmv", *ops)
    dt = torch.promote_types(vals.dtype, g.dtype)
    if dt not in (torch.float32, torch.float64):
        raise TypeError(f"ell_resident_spmv kernel takes float32/float64, "
                        f"got {dt}")
    if vals.dim() != 3 or g.dim() != 2 or cols.shape != (
            vals.shape[0], vals.shape[1] * vals.shape[2]) \
            or g.shape[0] != vals.shape[0]:
        raise ValueError(f"ell_resident_spmv: shapes {tuple(vals.shape)}, "
                         f"{tuple(cols.shape)}, {tuple(g.shape)}")
    _int32_contig("ell_resident_spmv", cols)
    S, Lrow, W = vals.shape
    G = pad_to if pad_to else g.shape[1]
    if G * dt.itemsize > smem_cap(g.device):
        raise ValueError(f"ell_resident_spmv: {G} gathered slots of {dt} "
                         f"exceed the shared-memory cap "
                         f"{smem_cap(g.device)} bytes")
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
            raise ValueError("ell_resident_spmv: tail tables must all be "
                             "(S, Tpad)")
        _int32_contig("ell_resident_spmv tail", tr)
        _int32_contig("ell_resident_spmv tail", tg)
        tv = tv.to(dt).contiguous()
        Tpad = tv.shape[1]
    y = torch.empty((S, Lrow), dtype=dt, device=g.device)
    if Lrow == 0 or W == 0 or G == 0:
        return y.zero_()
    gcols = min(g.shape[1], G)
    lib = _lib()
    fn = lib.ell_resident_spmv_f64 if dt == torch.float64 \
        else lib.ell_resident_spmv_f32
    from .cuda_build import check, stream_ptr

    rc = fn(vals.data_ptr(), cols.data_ptr(), tv.data_ptr(), tr.data_ptr(),
            tg.data_ptr(), g.data_ptr(), y.data_ptr(), S, Lrow, W, Tpad, G,
            gcols, g.stride(0), _threads_per_row(W), THREADS, stream_ptr(g))
    check(rc, "ell_resident_spmv")
    ell_resident_spmv.launches += 1
    return y


ell_resident_spmv.launches = 0
