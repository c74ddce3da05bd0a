"""One level's step of the device solver's wave solve as one hand-written
kernel a sweep (``csrc/front_solve.cu``), launched on torch's current
stream.

A level holds S × B fronts (S shards stacked, B fronts a shard; a top level
is S = 1). Front f of shard s has ``ncol[s, f]`` live columns
``ccol[s, f, :ncol]`` and ``nrow[s, f]`` live update rows ``crow[s, f,
:nrow]``, slots of its shard's right-hand side ``y[s]`` (S, rows, k), which
both steps update in place:

* ``front_fwd(y, ccol, crow, ncol, nrow, A, M, d)``: w = A y[ccol], then
  y[ccol] = w / d (w where d is None) and y[crow] −= M w; A (S, B, NC, NC)
  lower-triangular, M (S, B, NR, NC), d (S, B, NC).
* ``front_bwd(y, ccol, crow, ncol, nrow, A, M)``: y[ccol] = A (y[ccol] −
  M y[crow]); A upper-triangular, M (S, B, NC, NR).

Only the live rows of y and the live entries of A's triangle and of M are
read or written. A and M may be any strided views (the transposes of the
stored factors); d, y's rows and the tables as ``solver/device_mf.py``
makes them. ``device_mf.DeviceMF._fwd_step`` and ``_bwd_step`` choose the
operands of each kind and ask ``front_route`` whether a level takes the
kernel.

Operands are CUDA tensors of one type of ``DTYPES``; anything else raises,
and nothing falls back to other arithmetic: the CPU, the other types and
the levels the shape rule keeps take ``device_mf._fwd_plain`` and
``_bwd_plain``, the same single-buffer step in plain PyTorch, which is
this kernel's plain version.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import torch

from ..utils.graphs import count_launch
from .cuda_build import check, launch_range, load_kernel_lib, stream_ptr

# the types of the kernel and the suffix of each's entry point
DTYPES = {torch.float32: "f32", torch.float64: "f64",
          torch.complex64: "c64", torch.complex128: "c128"}
# the rows of a tile and the columns of a two-phase block's span
# (csrc/front_solve.cu FS_TILE and FS_SPAN, checked at load)
TILE = 32
SPAN = 256
# the most flops a byte of a level's padded products that the kernel takes:
# above it the products are bound by arithmetic, and cuBLAS's tensor-core
# products outrun the kernel's FMAs (on an H100 the FP64 FMA rate over the
# memory bandwidth is about 10, and the padded count overstates the live
# work; the 512² plan's c128 levels at 64 columns, timed on an H100 with the
# kernel and with the plain step, cross between 17 and 20 a byte)
MAX_FLOPS_A_BYTE = 20.0
# the most row tiles a block walks in series (mode 0): a block's chain grows
# with their square, and past 4 (the 512² plan's 136-column fronts, on an
# H100) the two-phase mode's extra pass costs less
SERIAL_TILES = 4


def intensity(NC: int, NF: int, k: int, dtype) -> float:
    """Flops a byte of one padded front's two products at ``k`` right-hand
    sides: the triangular block and the update block read once, the
    front's rows of y read and written once."""
    NR = NF - NC
    macs = NC * (NC + 1) // 2 + NC * NR
    flops = k * macs * (8 if dtype.is_complex else 2)
    item = torch.empty((), dtype=dtype).element_size()
    return flops / (item * (macs + 2 * k * NF))


def front_route(device, dtype, NC: int, NF: int, k: int) -> bool:
    """Whether a level of fronts NC columns of NF wide steps through this
    kernel at ``k`` right-hand sides: a CUDA device, a type of ``DTYPES``,
    and products bound by bytes or latency (``intensity`` at most
    ``MAX_FLOPS_A_BYTE``): every level at narrow widths, the small fronts
    at wide ones."""
    return (torch.device(device).type == "cuda" and dtype in DTYPES
            and intensity(NC, NF, k, dtype) <= MAX_FLOPS_A_BYTE)


def column_tile(k: int) -> int:
    """The right-hand-side columns a block: 1, 8 or 32."""
    return 1 if k == 1 else 8 if k <= 8 else 32


def launch_mode(fronts: int, NC: int, k: int, sm_count: int) -> int:
    """How a launch lays its blocks out: 2, a warp a front, at k = 1 where
    fronts have at most ``TILE`` columns; 1, the two-phase mode, a block a
    row tile and span of a front's products, where a block a front would
    walk more than ``SERIAL_TILES`` row tiles in series, or fronts of more
    than one tile would leave most of the card idle (fewer blocks than two
    an SM); else 0, a block a front and column tile."""
    if k == 1 and NC <= TILE:
        return 2
    nq = -(-k // column_tile(k))
    if NC > SERIAL_TILES * TILE:
        return 1
    return 1 if NC > TILE and fronts * nq < 2 * sm_count else 0


@lru_cache(maxsize=1)
def _lib():
    lib = load_kernel_lib("front_solve")
    vp, ci = ctypes.c_void_p, ctypes.c_int
    p64 = ctypes.POINTER(ctypes.c_int64)
    for s in DTYPES.values():
        fn = getattr(lib, f"front_solve_{s}")
        fn.argtypes = [ci, vp, vp, vp, vp, vp, vp, vp, vp, vp, vp, p64, p64,
                       vp]
        fn.restype = ci
    for name, want in (("tile", TILE), ("span", SPAN)):
        fn = getattr(lib, f"front_solve_{name}")
        fn.argtypes = []
        fn.restype = ci
        if fn() != want:
            raise RuntimeError(f"front_solve: the library's {name} is {fn()}"
                               f", the wrapper's {want}")
    return lib


@lru_cache(maxsize=None)
def _sm_count(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _ptr(t):
    return None if t is None else t.data_ptr()


def operands(what, y, ccol, crow, ncol, nrow, A, M, d, bwd):
    """Raise unless the operands are what a launch takes (see the module's
    docstring), on any one device; returns (S, B, NC, NR, k)."""
    if y.dtype not in DTYPES:
        raise TypeError(f"{what}: the kernel takes float32, float64, "
                        f"complex64 or complex128 values, got {y.dtype}")
    if y.dim() != 3 or y.stride(-1) != 1:
        raise ValueError(f"{what}: y is (S, rows, k) with contiguous "
                         f"columns, got shape {tuple(y.shape)}, strides "
                         f"{y.stride()}")
    S, k = y.shape[0], y.shape[2]
    if ccol.dim() != 3 or ccol.shape[0] != S:
        raise ValueError(f"{what}: ccol is (S, B, NC) for y's {S} shards, "
                         f"got {tuple(ccol.shape)}")
    B, NC = ccol.shape[1], ccol.shape[2]
    NR = crow.shape[-1]
    want = {"ccol": (ccol, (S, B, NC), torch.int64),
            "crow": (crow, (S, B, NR), torch.int64),
            "ncol": (ncol, (S, B), torch.int32),
            "nrow": (nrow, (S, B), torch.int32),
            "A": (A, (S, B, NC, NC), y.dtype),
            "M": (M, (S, B, NC, NR) if bwd else (S, B, NR, NC), y.dtype)}
    if d is not None:
        want["d"] = (d, (S, B, NC), y.dtype)
    for name, (t, shape, dt) in want.items():
        if (tuple(t.shape), t.dtype, t.device) != (shape, dt, y.device):
            raise ValueError(f"{what}: {name} of {tuple(t.shape)} {t.dtype} "
                             f"on {t.device}, wanted {shape} {dt} on "
                             f"{y.device}")
        if name in ("ccol", "crow", "ncol", "nrow") and not t.is_contiguous():
            raise ValueError(f"{what}: {name} is not contiguous")
        if t.data_ptr() % t.element_size():
            raise ValueError(f"{what}: {name}'s data is not aligned to its "
                             "entries")
    if y.data_ptr() % y.element_size():
        raise ValueError(f"{what}: y's data is not aligned to its entries")
    return S, B, NC, NR, k


def _launch(name, wrapper, bwd, y, ccol, crow, ncol, nrow, A, M, d):
    S, B, NC, NR, k = operands(name, y, ccol, crow, ncol, nrow, A, M, d,
                               bwd)
    if y.device.type != "cuda":
        raise ValueError(f"{name}: the kernel takes CUDA tensors, got one on "
                         f"{y.device}; on the CPU the solve runs its plain "
                         "step")
    scratch = counts = None
    mode = launch_mode(S * B, NC, k, _sm_count(y.device))
    KT = column_tile(k)
    if mode == 1:
        # the front's sums, a counter a front and column tile, the ticket
        scratch = y.new_zeros((S * B, NC, k))
        counts = torch.zeros(S * B * -(-k // KT) + 1, dtype=torch.int32,
                             device=y.device)
    dims = (ctypes.c_int64 * 9)(S, B, NC, NR, k, KT, y.stride(0),
                                y.stride(1), mode)
    dst = d.stride() if d is not None else (0, 0, 0)
    st = (ctypes.c_int64 * 11)(*A.stride(), *M.stride(), *dst)
    fn = getattr(_lib(), f"front_solve_{DTYPES[y.dtype]}")
    with launch_range(name):
        rc = fn(int(bwd), y.data_ptr(), ccol.data_ptr(), crow.data_ptr(),
                ncol.data_ptr(), nrow.data_ptr(), A.data_ptr(), M.data_ptr(),
                _ptr(d), _ptr(scratch), _ptr(counts), dims, st,
                stream_ptr(y))
    check(rc, name)
    count_launch(wrapper)
    return y


def front_fwd(y, ccol, crow, ncol, nrow, A, M, d=None):
    """The forward step of one level on ``y`` in place (see the module's
    docstring); returns y."""
    return _launch("front_fwd", front_fwd, False, y, ccol, crow, ncol, nrow,
                   A, M, d)


def front_bwd(y, ccol, crow, ncol, nrow, A, M):
    """The backward step of one level on ``y`` in place (see the module's
    docstring); returns y."""
    return _launch("front_bwd", front_bwd, True, y, ccol, crow, ncol, nrow,
                   A, M, None)


front_fwd.launches = 0
front_bwd.launches = 0
