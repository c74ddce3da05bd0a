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

The kernel reads a row only up to its length in the plan's row-length
table ``rowlen`` (``min(row length, W)``): the padding entries (value 0,
column 0) add nothing, so the sum is the same for finite x. The plan also
picks the row group width ``lanes`` from the stored row lengths and W
(``lanes_for``). ``tail_segments`` is the plain model of the tail
kernel's reduction: which entries each of its atomic adds sums.

The SpMV kernel takes float32, float64, complex64 and complex128 values
and x (``cuda_dia.KERNEL_DTYPES``), a complex product in one launch on
torch's interleaved values; the gather-only mode takes reals (a complex
payload crosses it as real pairs, ``parallel/exchange.py``).

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

from ..utils.graphs import count_launch
from .cuda_dia import KERNEL_DTYPES, pad_trunc

THREADS = 256          # threads a block of the row kernels (kRowThreads)
TAIL_PER_THREAD = 8    # tail entries a thread (kTailPerThread)
TAIL_WARP = 32


def lanes_for(W: int, mean_len: float, itemsize: int) -> int:
    """Threads that share a row: the power of two <= 32 covering, in units
    (``unit_entries``: 16 bytes of values when W is a multiple, else 1
    entry), the geometric mean of the mean stored row length and the
    width W. Short rows thus share a warp, and a pattern whose rows run to
    W (a power law) gives its long rows more lanes than its mean alone
    would. (chip_smoke.py times every width from 1 to 32 on the random,
    power-law, N and A matrices beside this choice; PERF.md has the
    numbers.)"""
    unit = unit_entries(W, itemsize)
    need = max(1, int(np.ceil(np.sqrt(max(mean_len, 1.0) * W) / unit)))
    p = 1
    while p < need and p < 32:
        p *= 2
    return p


def unit_entries(W: int, itemsize: int) -> int:
    """Entries a lane loads at once: 16 bytes of values when W allows (4
    f32, 2 f64 or c64 entries; a c128 entry is 16 bytes by itself)."""
    v = 16 // itemsize
    return v if W % v == 0 else 1


def rows_per_pass(lanes: int) -> int:
    """Rows a block of the row kernels sums in one pass: its groups of
    ``lanes`` threads, one row each."""
    return THREADS // lanes


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


def tail_segments(trows: np.ndarray):
    """Plain model of the tail kernel's reduction on one shard's row table
    (length a multiple of TAIL_PER_THREAD): a thread takes TAIL_PER_THREAD
    consecutive entries and adds each of its runs of one row but the last
    itself; the last runs of a warp's TAIL_WARP threads merge where
    neighbouring lanes share a row. Returns (seg, rows): ``seg[j]`` is the
    atomic add entry j goes into and ``rows[a]`` the row of add a."""
    r = np.asarray(trows, np.int64).reshape(-1)
    E, n = TAIL_PER_THREAD, r.size
    if n % E:
        raise ValueError(f"tail length {n} is not a multiple of {E}")
    if not n:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    j = np.arange(n)
    start = np.ones(n, bool)          # a run opens a thread or a new row
    start[1:] = (r[1:] != r[:-1]) | (j[1:] % E == 0)
    run = np.cumsum(start) - 1
    last_open = np.maximum.reduceat(np.where(start, j, -1), np.arange(0, n, E))
    is_last = j >= last_open[j // E]  # in its thread's last run
    key = r[last_open]                # row of each thread's last run
    head = np.ones(key.size, bool)
    head[1:] = (key[1:] != key[:-1]) | (np.arange(1, key.size) % TAIL_WARP == 0)
    wseg = np.cumsum(head) - 1        # warp segment of each thread
    own = np.unique(run[~is_last])    # runs a thread adds itself
    add_of_run = np.full(run[-1] + 1, -1, np.int64)
    add_of_run[own] = np.arange(own.size)
    seg = np.where(is_last, own.size + wseg[j // E], add_of_run[run])
    rows = np.empty(own.size + int(wseg[-1]) + 1, np.int64)
    rows[seg] = r
    return seg, rows


def ell_tail_segmented_plain(tvals: torch.Tensor, trows: torch.Tensor,
                             tgidx: torch.Tensor, g: torch.Tensor,
                             y: torch.Tensor) -> torch.Tensor:
    """The tail added to y (S, Lrow) the way the kernel adds it: products
    summed per atomic add of ``tail_segments``, then one add per segment
    (the drop row Lrow discarded). Returns a new tensor."""
    S, Lrow = y.shape
    dt = y.dtype
    out = torch.cat([y, y.new_zeros((S, 1))], dim=1)
    prod = tvals.to(dt) * torch.gather(g.to(dt), 1, tgidx.long())
    for s in range(S):
        seg, rows = tail_segments(trows[s].cpu().numpy())
        sums = prod.new_zeros(rows.size)
        sums.index_add_(0, torch.from_numpy(seg).to(prod.device), prod[s])
        out[s].index_add_(0, torch.from_numpy(rows).to(prod.device), sums)
    return out[:, :Lrow].contiguous()


@lru_cache(maxsize=1)
def _lib():
    from .cuda_build import load_kernel_lib

    lib = load_kernel_lib("ell_spmv")
    vp, i64, ci = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    for suffix in KERNEL_DTYPES.values():
        fn = getattr(lib, f"ell_spmv_{suffix}")
        fn.argtypes = [vp] * 8 + [i64, i64, ci, i64, i64, i64, ci, ci, vp]
        fn.restype = ci
    for fn in (lib.gather_f32, lib.gather_f64):
        fn.argtypes = [vp, vp, vp, i64, i64, i64, vp]
        fn.restype = ci
    return lib


def _cuda_operands(name, *ts):
    dev = ts[0].device
    if dev.type != "cuda" or any(t.device != dev for t in ts):
        raise ValueError(f"{name}: operands on {[str(t.device) for t in ts]}")


def _int32_contig(name, t):
    if t.dtype != torch.int32 or not t.is_contiguous():
        raise TypeError(f"{name}: index tables must be contiguous int32")


def _aligned16(*ts) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in ts)


def on_cpu(name, vals, cols, g, tail, checked) -> bool:
    """Whether K2's or K3's operands lie on the CPU (the plain version runs
    then). ``checked``: the index tables come from a plan on one device, so
    only vals and g are compared with it."""
    if checked:
        if vals.device != cols.device or g.device != cols.device:
            raise ValueError(f"{name}: vals on {vals.device}, x on "
                             f"{g.device}, the plan's tables on "
                             f"{cols.device}")
        return cols.device.type == "cpu"
    ops = [vals, cols, g] + (list(tail) if tail is not None else [])
    return all(t.device.type == "cpu" for t in ops)


def ell_operands(name, vals, cols, g, tail, rowlen, lanes, checked=False):
    """Check and cast the operands of K2 or K3 on a CUDA device; the kernels
    need the plan's row lengths and group width. ``checked``: the caller
    built cols, rowlen and the tail's index tables with a plan
    (``SpMVPlan``: int32, contiguous, shaped for vals, on vals' device, the
    tail 16-byte aligned with Tpad % TAIL_PER_THREAD == 0), and only the
    values and x are cast here. Returns (dtype, vals, g, (tvals, trows,
    tgidx) or None, vec): vec is the entries a lane loads at once
    (``unit_entries``; 1 unless the tables are 16-byte aligned)."""
    if lanes not in (1, 2, 4, 8, 16, 32) or rowlen is None:
        raise ValueError(f"{name}: the kernel takes the plan's rowlen and a "
                         f"group width of 1-32 lanes (SpMVPlan.ell_rowlen, "
                         f"ell_layout), got lanes {lanes}")
    dt = torch.promote_types(vals.dtype, g.dtype)
    if dt not in KERNEL_DTYPES:
        raise TypeError(f"{name} kernel takes float32/float64/complex64/"
                        f"complex128, got {dt}")
    if not checked:
        _cuda_operands(name, vals, cols, g, rowlen, *(tail or ()))
        if vals.dim() != 3 or g.dim() != 2 or cols.shape != (
                vals.shape[0], vals.shape[1] * vals.shape[2]) \
                or g.shape[0] != vals.shape[0]:
            raise ValueError(f"{name}: shapes {tuple(vals.shape)}, "
                             f"{tuple(cols.shape)}, {tuple(g.shape)}")
        _int32_contig(name, cols)
        _int32_contig(f"{name} rowlen", rowlen)
        if rowlen.shape != vals.shape[:2]:
            raise ValueError(f"{name}: rowlen must be "
                             f"{tuple(vals.shape[:2])}, got "
                             f"{tuple(rowlen.shape)}")
        if tail is not None:
            tv, tr, tg = tail
            if tv.dim() != 2 or tv.shape[0] != vals.shape[0] \
                    or tr.shape != tv.shape or tg.shape != tv.shape:
                raise ValueError(f"{name}: tail tables must all be (S, Tpad)")
            _int32_contig(f"{name} tail", tr)
            _int32_contig(f"{name} tail", tg)
            if tv.shape[1] % TAIL_PER_THREAD or not _aligned16(tr, tg):
                raise ValueError(f"{name}: the tail kernel takes Tpad % "
                                 f"{TAIL_PER_THREAD} == 0 and 16-byte "
                                 f"aligned tables, got Tpad {tv.shape[1]}")
    vals = vals.to(dt).contiguous()
    g = g.to(dt)
    if g.stride(1) != 1:
        g = g.contiguous()
    if tail is not None:
        tv = tail[0].to(dt).contiguous()
        if tv.data_ptr() % 16:
            raise ValueError(f"{name}: tail values not 16-byte aligned")
        tail = (tv, tail[1], tail[2])
    vec = unit_entries(vals.shape[2], dt.itemsize) \
        if _aligned16(vals, cols) else 1
    return dt, vals, g, tail, vec


def ell_spmv(vals: torch.Tensor, cols: torch.Tensor, g: torch.Tensor,
             tail=None, pad_to: int = 0, rowlen: torch.Tensor | None = None,
             lanes: int = 0, checked: bool = False) -> torch.Tensor:
    """K2. vals: (S, Lrow, W); cols: (S, Lrow*W) int32; g: (S, G) with unit
    column stride; tail: None or (tvals, trows, tgidx), each (S, Tpad), the
    last two int32; rowlen: (S, Lrow) int32, ``min(row length, W)`` (the
    plan's ``ell_rowlen``); lanes: threads a row (``lanes_for``); checked:
    the index tables come from the plan (``ell_operands``). The plain
    version on CPU tensors needs none of them. Returns y (S, Lrow)."""
    if on_cpu("ell_spmv", vals, cols, g, tail, checked):
        return ell_spmv_plain(vals, cols, g, tail, pad_to)
    dt, vals, g, tail, vec = ell_operands("ell_spmv", vals, cols, g, tail,
                                          rowlen, lanes, checked)
    S, Lrow, W = vals.shape
    tv, tr, tg = tail if tail is not None else (vals,) * 3  # not read
    Tpad = tv.shape[1] if tail is not None else 0
    y = torch.empty((S, Lrow), dtype=dt, device=g.device)
    if Lrow == 0 or W == 0:
        return y.zero_()
    gcols = min(g.shape[1], pad_to) if pad_to else g.shape[1]
    fn = getattr(_lib(), f"ell_spmv_{KERNEL_DTYPES[dt]}")
    from .cuda_build import check, launch_range, stream_ptr

    with launch_range("ell_rows"):
        rc = fn(vals.data_ptr(), cols.data_ptr(), rowlen.data_ptr(),
                tv.data_ptr(), tr.data_ptr(), tg.data_ptr(), g.data_ptr(),
                y.data_ptr(), S, Lrow, W, Tpad, gcols, g.stride(0), lanes,
                vec, stream_ptr(g))
    check(rc, "ell_spmv")
    count_launch(ell_spmv)
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
    from .cuda_build import check, launch_range, stream_ptr

    with launch_range("gather_rows"):
        rc = fn(x.data_ptr(), src.data_ptr(), xe.data_ptr(), S, D,
                x.stride(0), stream_ptr(x))
    check(rc, "gather")
    count_launch(gather)
    return xe


gather.launches = 0
