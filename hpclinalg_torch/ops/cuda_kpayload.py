"""K5: the k-payload probe — the CUDA kernel's wrapper and its plain version.

``kpayload`` computes, for src (ntiles, F, k, 128) float32, idx
(ntiles, 1, 128) int8 and sel (ntiles, 1, 128) uint8,

    out[t, j, l] = src[t, sel[t, 0, l], j, idx[t, 0, l]]

an (ntiles, k, 128) float32 tensor: the function of the TPU kernel of
``tools/probe_kpayload.py`` (``kern`` via ``run``), the column-payload
primitive the JAX package timed to design its random-SpMM k tier. The
kernel (``csrc/kpayload.cu``) reads only the selected plane of each lane.

A CUDA tensor goes to the kernel; a CPU tensor goes to the plain version.
There is no fallback from one to the other. The index ranges (``idx`` in
[0, 128), ``sel`` in [0, F)) are checked before a launch unless the caller
has checked the same tables on the host when it built them
(``check_tables``) and says so with ``checked=True``: the kernel does not
clip. ``python -m hpclinalg_torch.tools.probe_kpayload`` runs it.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import numpy as np
import torch

from .cuda_ell import check_index

LANES = 128
ROWS = 8   # threadIdx.y extent: blocks of 128 x 8 threads


def check_tables(idx: np.ndarray, sel: np.ndarray, F: int) -> None:
    """Raise unless the host tables index a (.., F, k, 128) source."""
    check_index("kpayload idx", idx, LANES)
    check_index("kpayload sel", sel, F)


def _check_shapes(src, idx, sel):
    if src.dim() != 4 or src.shape[3] != LANES:
        raise ValueError(f"kpayload: src must be (ntiles, F, k, {LANES}), got "
                         f"{tuple(src.shape)}")
    want = (src.shape[0], 1, LANES)
    if tuple(idx.shape) != want or tuple(sel.shape) != want:
        raise ValueError(f"kpayload: idx and sel must be {want}, got "
                         f"{tuple(idx.shape)}, {tuple(sel.shape)}")
    if src.dtype != torch.float32 or idx.dtype != torch.int8 \
            or sel.dtype != torch.uint8:
        raise TypeError("kpayload takes float32 src, int8 idx and uint8 sel, "
                        f"got {src.dtype}, {idx.dtype}, {sel.dtype}")


def kpayload_plain(src: torch.Tensor, idx: torch.Tensor,
                   sel: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: one advanced-indexing gather."""
    _check_shapes(src, idx, sel)
    ntiles, _F, k, _ = src.shape
    dev = src.device
    t = torch.arange(ntiles, device=dev)[:, None, None]
    j = torch.arange(k, device=dev)[None, :, None]
    # uint8 indices would index as a mask: widen both tables first
    return src[t, sel.long(), j, idx.long()]


@lru_cache(maxsize=1)
def _lib():
    from .cuda_build import load_kernel_lib

    lib = load_kernel_lib("kpayload")
    vp, i64, ci = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    lib.kpayload_f32.argtypes = [vp, vp, vp, vp, i64, ci, ci, ci, vp]
    lib.kpayload_f32.restype = ci
    return lib


def kpayload(src: torch.Tensor, idx: torch.Tensor, sel: torch.Tensor,
             checked: bool = False) -> torch.Tensor:
    """K5. Returns out (ntiles, k, 128) float32."""
    ops = (src, idx, sel)
    if all(t.device.type == "cpu" for t in ops):
        return kpayload_plain(src, idx, sel)
    dev = src.device
    if dev.type != "cuda" or any(t.device != dev for t in ops):
        raise ValueError(f"kpayload: operands on {[str(t.device) for t in ops]}")
    _check_shapes(src, idx, sel)
    if not all(t.is_contiguous() for t in ops):
        raise ValueError("kpayload: operands must be contiguous")
    ntiles, F, k, _ = src.shape
    if not checked:
        # one device reduction and one read-back per table
        if int(idx.min()) < 0 or int(sel.max()) >= F:
            raise IndexError(f"kpayload: idx outside [0, {LANES}) or sel "
                             f"outside [0, {F})")
    out = torch.empty((ntiles, k, LANES), dtype=torch.float32, device=dev)
    from .cuda_build import check, stream_ptr

    rc = _lib().kpayload_f32(src.data_ptr(), idx.data_ptr(), sel.data_ptr(),
                             out.data_ptr(), ntiles, F, k, ROWS,
                             stream_ptr(src))
    check(rc, "kpayload")
    kpayload.launches += 1
    return out


kpayload.launches = 0
