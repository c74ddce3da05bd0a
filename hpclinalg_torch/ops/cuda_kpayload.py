"""K5: the k-payload probe — the CUDA kernel's wrapper and its plain version.

``kpayload`` computes, for src (ntiles, F, k, 128) float32, idx
(ntiles, 1, 128) int8 and sel (ntiles, 1, 128) uint8,

    out[t, j, l] = src[t, sel[t, 0, l], j, idx[t, 0, l]]

an (ntiles, k, 128) float32 tensor: the function of the TPU kernel of
``tools/probe_kpayload.py`` (``kern`` via ``run``), the column-payload
primitive the JAX package timed to design its random-SpMM k tier. The
kernel (``csrc/kpayload.cu``) stages each tile's touched 32-byte sectors
(``touched_sectors``) in shared memory, KC rows at a time, and writes out
from there; ``kpayload_staged_plain`` models that on the CPU.

A CUDA tensor goes to the kernel; a CPU tensor goes to the plain version.
There is no fallback from one to the other. The index ranges (``idx`` in
[0, 128), ``sel`` in [0, F)) are checked before a launch unless the caller
has checked the same tables on the host when it built them
(``check_tables``) and says so with ``checked=True``: the kernel does not
check them (it wraps idx into [0, 128) only to keep its shared-memory map
in bounds). ``python -m hpclinalg_torch.tools.probe_kpayload`` runs it.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import numpy as np
import torch

from ..utils.graphs import count_launch
from .cuda_ell import check_index

LANES = 128
SECTOR = 8          # floats in a 32-byte sector
KC = 8              # rows of j a stage holds (csrc/kpayload.cu KP_KC)


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


def touched_sectors(idx: torch.Tensor, sel: torch.Tensor, F: int):
    """Each tile's touched (plane, sector) pairs in address order, as the
    kernel builds them: (keys, count, slot). keys (ntiles, 128) int64 holds
    a tile's sorted distinct plane * 16 + sector in its first count[t]
    entries and -1 after; slot (ntiles, 128) is each lane's position in
    its tile's list. A tile reads these sectors in every one of its k rows:
    count.sum() * k * 32 bytes of src."""
    il = idx.reshape(-1, LANES).long()
    sl = sel.reshape(-1, LANES).long()
    if il.numel() and (int(il.min()) < 0 or int(il.max()) >= LANES
                       or int(sl.max()) >= F):
        raise IndexError(f"kpayload: idx outside [0, {LANES}) or sel "
                         f"outside [0, {F})")
    key = sl * (LANES // SECTOR) + il // SECTOR
    s, order = key.sort(dim=1)
    first = torch.ones_like(s, dtype=torch.bool)
    first[:, 1:] = s[:, 1:] != s[:, :-1]
    rank = first.long().cumsum(1) - 1
    slot = torch.empty_like(rank).scatter_(1, order, rank)
    keys = torch.full_like(s, -1).scatter_(1, rank, s)
    return keys, first.sum(1), slot


def kpayload_staged_plain(src: torch.Tensor, idx: torch.Tensor,
                          sel: torch.Tensor, kc: int = KC) -> torch.Tensor:
    """CPU model of the kernel: per tile and chunk of kc rows, stage exactly
    the touched sectors (``touched_sectors``; the rest of the stage stays
    zero), then gather each lane's float from the stage."""
    _check_shapes(src, idx, sel)
    ntiles, F, k, _ = src.shape
    keys, _count, slot = touched_sectors(idx, sel, F)
    live = (keys >= 0)[:, None, :, None]
    key = keys.clamp(min=0)
    plane = (key // (LANES // SECTOR))[:, None, :, None]
    first = (key % (LANES // SECTOR) * SECTOR)[:, None, :, None]
    word = slot * SECTOR + idx.reshape(-1, LANES).long() % SECTOR
    t = torch.arange(ntiles)[:, None, None, None]
    w = torch.arange(SECTOR)[None, None, None, :]
    out = torch.empty((ntiles, k, LANES), dtype=src.dtype)
    for j0 in range(0, k, kc):
        rows = min(kc, k - j0)
        j = torch.arange(j0, j0 + rows)[None, :, None, None]
        stage = torch.where(live, src[t, plane, j, first + w], 0.0)
        stage = stage.reshape(ntiles, rows, LANES * SECTOR)
        out[:, j0:j0 + rows] = torch.gather(
            stage, 2, word[:, None, :].expand(ntiles, rows, LANES))
    return out


@lru_cache(maxsize=1)
def _lib():
    from .cuda_build import load_kernel_lib

    lib = load_kernel_lib("kpayload")
    vp, i64, ci = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    lib.kpayload_f32.argtypes = [vp, vp, vp, vp, i64, ci, ci, vp]
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
                             out.data_ptr(), ntiles, F, k, stream_ptr(src))
    check(rc, "kpayload")
    count_launch(kpayload)
    return out


kpayload.launches = 0
