"""The CG step's vector work as three hand-written kernels
(``csrc/cg_vec.cu``), launched on torch's current stream.

Between one SpMV and the next, textbook CG's three-dot step
(``entry.cg_step_fn``) reads and writes its vectors in three passes:

* ``cg_dots(p, Ap, r, ws)``: (p·Ap, r·r) into ``ws.dots``;
* ``cg_update_xr(x, r, p, Ap, ws, xo, ro)``: α = r·r / p·Ap from
  ``ws.dots``, x + αp into ``xo``, r − αAp into ``ro`` and the new r·r
  into ``ws.rr``;
* ``cg_update_p(r, p, ws, po)``: β = ``ws.rr`` / r·r, r + βp into ``po``.

On a process group the caller ``all_reduce``s ``ws.dots`` after the first
and ``ws.rr`` after the second. The outputs may be the inputs they replace
(``xo`` x, ``ro`` r, ``po`` p). Every operand is a contiguous CUDA tensor of
one real type of ``DTYPES`` with the workspace's entries, its data 16-byte
aligned (fresh allocations and a graph's static tensors are); anything else
raises, and nothing falls back to other arithmetic: the CPU and complex
types take the plain step of ``entry.cg_step_fn``, which is these kernels'
plain version (``fused_route`` decides). The dots are reduced in double, in
a fixed order over a fixed grid (``grid_blocks``), so a replay of a captured
step equals an eager step bit for bit.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import torch

from ..utils.graphs import count_launch
from .cuda_build import check, launch_range, load_kernel_lib, stream_ptr

# the real value types of the kernels and the suffix of each's entry points
DTYPES = {torch.float32: "f32", torch.float64: "f64"}
# a block's threads (csrc/cg_vec.cu CG_THREADS) and the most blocks an SM
# of the grid: one grid-stride walk a thread, a partial a block
THREADS = 256
BLOCKS_PER_SM = 8
# the alignment of every operand's data: a whole unit of the kernels' walk
# is one 16-byte access
ALIGN = 16


def fused_route(device, dtype) -> bool:
    """Whether a step over vectors of ``dtype`` on ``device`` runs these
    kernels: a CUDA device and a real type of ``DTYPES``."""
    return torch.device(device).type == "cuda" and dtype in DTYPES


def grid_blocks(n: int, sm_count: int) -> int:
    """The blocks of every launch over vectors of ``n`` entries: a thread
    an entry, at most ``BLOCKS_PER_SM`` blocks an SM, at least one."""
    return max(1, min(-(-n // THREADS), BLOCKS_PER_SM * sm_count))


def _operands(what: str, *ts) -> None:
    """Raise unless every tensor is a contiguous, ``ALIGN``-byte aligned
    CUDA tensor of one real type of ``DTYPES``, all on one device with one
    type and size."""
    for t in ts:
        if t.dtype not in DTYPES:
            raise TypeError(f"{what}: the kernels take float32 or float64 "
                            f"vectors, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: the kernels take contiguous vectors, "
                             f"got strides {t.stride()}")
        if t.data_ptr() % ALIGN:
            raise ValueError(f"{what}: the kernels take vectors whose data "
                             f"is {ALIGN}-byte aligned, got one at "
                             f"{t.data_ptr() % ALIGN} bytes past it")
        if t.device.type != "cuda":
            raise ValueError(f"{what}: the kernels take CUDA tensors, got "
                             f"one on {t.device}; on the CPU the step runs "
                             "its plain arithmetic")
    t0 = ts[0]
    if any((t.dtype, t.device, t.numel()) != (t0.dtype, t0.device,
                                               t0.numel()) for t in ts):
        raise ValueError(f"{what}: operands of several types, devices or "
                         "sizes: " + ", ".join(
                             f"{t.dtype} {t.device} {t.numel()}" for t in ts))


class Workspace:
    """What the kernels of one step share, allocated once before any
    capture: the grid (``grid_blocks``), its per-block partials (2 a block,
    float64), the last-block ticket (0 between launches), ``dots`` (p·Ap,
    r·r) and ``rr`` (the new r·r), both of the vectors' type. One step's
    launches follow each other on one stream."""

    def __init__(self, n: int, dtype: torch.dtype, device):
        device = torch.device(device)
        if not fused_route(device, dtype):
            raise ValueError(f"Workspace: the kernels take CUDA tensors of "
                             f"float32 or float64, got {dtype} on {device}")
        sms = torch.cuda.get_device_properties(device).multi_processor_count
        self.n, self.dtype = int(n), dtype
        self.grid = grid_blocks(self.n, sms)
        self.partials = torch.zeros(2 * self.grid, dtype=torch.float64,
                                    device=device)
        self.ticket = torch.zeros(1, dtype=torch.int32, device=device)
        self.dots = torch.zeros(2, dtype=dtype, device=device)
        self.rr = torch.zeros(1, dtype=dtype, device=device)

    def fits(self, what: str, t: torch.Tensor) -> None:
        """Raise unless vectors like ``t`` fit the workspace."""
        if (t.numel(), t.dtype, t.device) != (self.n, self.dtype,
                                              self.dots.device):
            raise ValueError(f"{what}: vectors of {t.numel()} {t.dtype} on "
                             f"{t.device} for a workspace of {self.n} "
                             f"{self.dtype} on {self.dots.device}")


@lru_cache(maxsize=1)
def _lib():
    lib = load_kernel_lib("cg_vec")
    vp, i64, ci = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    for s in DTYPES.values():
        for name, args in (
                ("cg_dots", [vp] * 3 + [i64, ci] + [vp] * 4),
                ("cg_update_xr", [vp] * 7 + [i64, ci] + [vp] * 4),
                ("cg_update_p", [vp] * 5 + [i64, ci, vp])):
            fn = getattr(lib, f"{name}_{s}")
            fn.argtypes, fn.restype = args, ci
    return lib


def _launch(name: str, wrapper, dtype, *args) -> None:
    fn = getattr(_lib(), f"{name}_{DTYPES[dtype]}")
    with launch_range(name):
        rc = fn(*args)
    check(rc, name)
    count_launch(wrapper)


def cg_dots(p: torch.Tensor, Ap: torch.Tensor, r: torch.Tensor,
            ws: Workspace) -> torch.Tensor:
    """(p·Ap, r·r) of this process's entries into ``ws.dots``, returned."""
    _operands("cg_dots", p, Ap, r)
    ws.fits("cg_dots", p)
    _launch("cg_dots", cg_dots, ws.dtype, p.data_ptr(), Ap.data_ptr(),
            r.data_ptr(), ws.n, ws.grid, ws.partials.data_ptr(),
            ws.ticket.data_ptr(), ws.dots.data_ptr(), stream_ptr(p))
    return ws.dots


def cg_update_xr(x: torch.Tensor, r: torch.Tensor, p: torch.Tensor,
                 Ap: torch.Tensor, ws: Workspace, xo=None, ro=None):
    """(x + αp, r − αAp) with α = ``ws.dots[1] / ws.dots[0]``, into ``xo``
    and ``ro`` (new tensors when None; either may be x or r), and the new
    r·r into ``ws.rr``."""
    xo = torch.empty_like(x) if xo is None else xo
    ro = torch.empty_like(r) if ro is None else ro
    _operands("cg_update_xr", x, r, p, Ap, xo, ro)
    ws.fits("cg_update_xr", x)
    _launch("cg_update_xr", cg_update_xr, ws.dtype, x.data_ptr(),
            r.data_ptr(), p.data_ptr(), Ap.data_ptr(), xo.data_ptr(),
            ro.data_ptr(), ws.dots.data_ptr(), ws.n, ws.grid,
            ws.partials.data_ptr(), ws.ticket.data_ptr(), ws.rr.data_ptr(),
            stream_ptr(x))
    return xo, ro


def cg_update_p(r: torch.Tensor, p: torch.Tensor, ws: Workspace,
                po=None) -> torch.Tensor:
    """r + βp with β = ``ws.rr[0] / ws.dots[1]``, into ``po`` (a new tensor
    when None; may be p)."""
    po = torch.empty_like(p) if po is None else po
    _operands("cg_update_p", r, p, po)
    ws.fits("cg_update_p", r)
    _launch("cg_update_p", cg_update_p, ws.dtype, r.data_ptr(),
            p.data_ptr(), po.data_ptr(), ws.dots.data_ptr(),
            ws.rr.data_ptr(), ws.n, ws.grid, stream_ptr(r))
    return po


cg_dots.launches = cg_update_xr.launches = cg_update_p.launches = 0
