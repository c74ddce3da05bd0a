"""The base case of the device LDLᵀ as one hand-written kernel
(``csrc/ldl_leaf.cu``), launched on torch's current stream.

``ldl_leaf(F, eps, L, d, count)`` factors every n × n block of a batch
(..., n, n), n ≤ ``LEAF``, by the unpivoted LDLᵀ with the plain transpose
and ``solver/device_mf._clamp``'s static-pivot clamp, reading F's lower
triangle only: unit-lower L, d, and the clamped pivots added into
``count``. F may be any strided view (a diagonal block of the front
buffer): its batch axes are collapsed where their strides allow, and it
is copied only where they do not. L and d may be views into larger
outputs (the recursion of ``device_mf._ldl_blocked`` writes its leaves
into one L and d), whose batch axes must collapse. ``eps`` is read from a
0-d device tensor when the kernel runs, so a captured graph replays with
each factorization's threshold.

Operands are CUDA tensors of one type of ``DTYPES``; anything else
raises, and nothing falls back to other arithmetic: the CPU and the other
types take ``device_mf._ldl_plain``, the recursion to 1 × 1 blocks, which
is this kernel's plain version (``device_mf._ldl_leaf`` asks
``leaf_route``).
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
# the most columns of a block the kernel factors: a lane a row, the row in
# registers; csrc/ldl_leaf.cu's LDL_LEAF, which ``_lib`` checks at load
LEAF = 32


def leaf_route(device, dtype) -> bool:
    """Whether an LDLᵀ of ``dtype`` blocks on ``device`` runs this kernel:
    a CUDA device and a type of ``DTYPES``."""
    return torch.device(device).type == "cuda" and dtype in DTYPES


def eps_tensor(eps, dtype, device) -> torch.Tensor:
    """``eps`` as the kernel reads it: a 0-d tensor of ``dtype``'s real
    type on ``device`` (taken as it is when it already is one)."""
    real = dtype.to_real()
    if not isinstance(eps, torch.Tensor):
        return torch.full((), float(eps), dtype=real, device=device)
    if (eps.dim(), eps.dtype, eps.device) == (0, real, torch.device(device)):
        return eps
    return eps.to(device=device, dtype=real).reshape(())


@lru_cache(maxsize=1)
def _lib():
    lib = load_kernel_lib("ldl_leaf")
    vp, i64, ci = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    p64 = ctypes.POINTER(ctypes.c_int64)
    for s in DTYPES.values():
        fn = getattr(lib, f"ldl_leaf_{s}")
        fn.argtypes = [vp, i64, ci, p64, vp, p64, vp, p64, vp, vp, vp]
        fn.restype = ci
    lib.ldl_leaf_cols.argtypes = []
    lib.ldl_leaf_cols.restype = ci
    if lib.ldl_leaf_cols() != LEAF:
        raise RuntimeError(f"ldl_leaf: the library takes blocks of up to "
                           f"{lib.ldl_leaf_cols()} columns (LDL_LEAF), the "
                           f"wrapper {LEAF} (LEAF)")
    return lib


def _strides(t: torch.Tensor):
    return (ctypes.c_int64 * t.dim())(*t.stride())


def _aligned(t: torch.Tensor) -> bool:
    return t.data_ptr() % t.element_size() == 0


def _collapsed(t: torch.Tensor, keep: int, what: str) -> torch.Tensor:
    """An output's view with its batch axes collapsed into one (``keep``
    trailing axes kept); raises where its strides do not allow it."""
    try:
        v = t.view((-1,) + tuple(t.shape[t.dim() - keep:]))
    except RuntimeError:
        raise ValueError(f"ldl_leaf: the batch axes of {what} (shape "
                         f"{tuple(t.shape)}, strides {t.stride()}) do not "
                         "collapse into one") from None
    if not _aligned(v):
        raise ValueError(f"ldl_leaf: {what}'s data is not aligned to its "
                         "entries")
    return v


def ldl_leaf(F: torch.Tensor, eps, L=None, d=None, count=None):
    """Unpivoted LDLᵀ of every n × n block of ``F`` (..., n, n), 1 ≤ n ≤
    ``LEAF`` (see the module's docstring). ``L`` (..., n, n), ``d`` (..., n)
    and ``count`` (a 0-d int64 tensor) are new tensors when None; the
    clamped pivots are added to ``count``. Returns (L, d, count)."""
    if F.dtype not in DTYPES:
        raise TypeError(f"ldl_leaf: the kernel takes float32, float64, "
                        f"complex64 or complex128 blocks, got {F.dtype}")
    n = F.shape[-1] if F.dim() >= 2 else 0
    if F.dim() < 2 or F.shape[-2] != n or not 1 <= n <= LEAF:
        raise ValueError(f"ldl_leaf: blocks of 1 to {LEAF} columns, square, "
                         f"got shape {tuple(F.shape)}")
    if F.device.type != "cuda":
        raise ValueError(f"ldl_leaf: the kernel takes CUDA tensors, got one "
                         f"on {F.device}; on the CPU the factorization runs "
                         "its plain recursion")
    batch = F.shape[:-2]
    L = F.new_empty(F.shape) if L is None else L
    d = F.new_empty(batch + (n,)) if d is None else d
    count = torch.zeros((), dtype=torch.int64, device=F.device) \
        if count is None else count
    for what, t, shape in (("L", L, F.shape), ("d", d, batch + (n,))):
        if (t.shape, t.dtype, t.device) != (shape, F.dtype, F.device):
            raise ValueError(f"ldl_leaf: {what} of {tuple(t.shape)} "
                             f"{t.dtype} on {t.device} for blocks "
                             f"{tuple(F.shape)} {F.dtype} on {F.device}")
    if (count.numel(), count.dtype, count.device) != (1, torch.int64,
                                                      F.device):
        raise ValueError("ldl_leaf: count is one int64 on the blocks' "
                         "device")
    A = F.reshape(-1, n, n)
    if not _aligned(A):
        A = A.clone()
    L3, D2 = _collapsed(L, 2, "L"), _collapsed(d, 1, "d")
    e = eps_tensor(eps, F.dtype, F.device)
    fn = getattr(_lib(), f"ldl_leaf_{DTYPES[F.dtype]}")
    with launch_range("ldl_leaf"):
        rc = fn(A.data_ptr(), A.shape[0], n, _strides(A), L3.data_ptr(),
                _strides(L3), D2.data_ptr(), _strides(D2), e.data_ptr(),
                count.data_ptr(), stream_ptr(F))
    check(rc, "ldl_leaf")
    count_launch(ldl_leaf)
    return L, d, count


ldl_leaf.launches = 0
