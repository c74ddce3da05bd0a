"""Backend: the device/shard-count/dtype configuration object.

PyTorch counterpart of the JAX package's ``Backend``. The 1-D device mesh
becomes one ``torch.device`` holding all S shards stacked in one tensor of
shape (S, L, ...): the shard axis is a batch axis, and what the JAX package
moves with collectives is a gather plus a scatter on that tensor.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np
import torch


def torch_dtype(dt) -> torch.dtype:
    """The torch dtype for a numpy or torch dtype."""
    if isinstance(dt, torch.dtype):
        return dt
    return torch.from_numpy(np.zeros(0, np.dtype(dt))).dtype


def numpy_dtype(dt) -> np.dtype:
    """The numpy dtype for a numpy or torch dtype."""
    if isinstance(dt, torch.dtype):
        return torch.zeros(0, dtype=dt).numpy().dtype
    return np.dtype(dt)


@dataclass(frozen=True)
class Backend:
    """Configuration: device + shard count + element dtype + index dtype +
    solver. ``nshards`` plays the role of the reference's MPI world size;
    ``solver="device"`` routes ``lu``/``ldlt``/``solve`` to the device
    multifrontal engine (the reference's Solver type parameter selecting
    MUMPS or cuDSS), ``"multifrontal"`` to the host engine."""

    device: torch.device
    nshards: int = 1
    dtype: Any = np.float64
    index_dtype: Any = np.int32
    solver: str = "multifrontal"

    def __post_init__(self):
        dev = torch.device(self.device)
        if dev.type == "cuda" and dev.index is None:
            # tensors report an indexed device; keep equality checks exact
            dev = torch.device("cuda", torch.cuda.current_device())
        object.__setattr__(self, "device", dev)
        object.__setattr__(self, "dtype", numpy_dtype(self.dtype))
        object.__setattr__(self, "index_dtype", numpy_dtype(self.index_dtype))
        if self.nshards <= 0:
            raise ValueError("nshards must be positive")
        if self.solver not in ("multifrontal", "device"):
            raise ValueError(f"unknown solver {self.solver!r}")

    @property
    def complex_capable(self) -> bool:
        """Complex dtypes are held natively on every torch device."""
        return True

    @property
    def key(self) -> tuple:
        """Hashable identity for plan-cache keys: a plan holds tensors on
        one device for one shard count."""
        return (str(self.device), self.nshards, self.dtype.str,
                self.index_dtype.str)

    def tensor(self, arr, dtype=None) -> torch.Tensor:
        """Host array -> tensor on this backend's device. Always a copy:
        the tensor never aliases the caller's array."""
        t = torch.from_numpy(np.array(arr))
        if dtype is not None:
            t = t.to(torch_dtype(dtype))
        return t.to(self.device)


def resolve_dtype(backend: Backend, src_dtype, dtype) -> np.dtype:
    """Allocation dtype for container constructors: an explicit ``dtype``
    wins; otherwise the backend default, promoted to complex when the
    SOURCE data is complex, so a complex input never silently drops its
    imaginary part."""
    if dtype is not None:
        return numpy_dtype(dtype)
    dt = backend.dtype
    src = numpy_dtype(src_dtype)
    if np.issubdtype(src, np.complexfloating) \
            and not np.issubdtype(dt, np.complexfloating):
        dt = np.result_type(src, dt)
    return dt


def backends_compatible(a: Backend, b: Backend) -> bool:
    """Same device, shard count and index dtype; operands may differ in
    element dtype."""
    return (a.device == b.device and a.nshards == b.nshards
            and a.index_dtype == b.index_dtype)


def backend_auto(nshards: int = 1, dtype=np.float64, index_dtype=np.int32,
                 device=None, solver: str = "multifrontal") -> Backend:
    """Backend on ``device``, by default the current CUDA device. Raises
    when ``device`` is None and there is no CUDA device: the port runs on
    the CPU only when the caller asks for it (``device="cpu"``)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("backend_auto: no CUDA device; pass "
                               "device='cpu' to run on the CPU")
        device = "cuda"
    return Backend(torch.device(device), nshards, dtype, index_dtype, solver)


def backend_serial(dtype=np.float64, index_dtype=np.int32,
                   solver: str = "multifrontal", device=None) -> Backend:
    """One shard (ref: CommSerial, backends.jl:207-327) on ``device``, by
    default the current CUDA device; raises without one unless the caller
    asks for the CPU (``device="cpu"``), as ``backend_auto`` does."""
    return backend_auto(1, dtype, index_dtype, device=device, solver=solver)
