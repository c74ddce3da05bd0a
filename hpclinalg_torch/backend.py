"""Backend: the device/shard-count/dtype configuration object.

PyTorch counterpart of the JAX package's ``Backend``. The JAX package's 1-D
device mesh takes one of two forms here:

  * stacked (no process group): one ``torch.device`` holds all S shards in
    one tensor of shape (S, L, ...); the shard axis is a batch axis, and
    what the JAX package moves with collectives is a gather plus a scatter
    on that tensor;
  * distributed (a ``torch.distributed`` process group, ``backend_dist``):
    one process a shard, as the reference runs one MPI rank a shard. Shard
    ``rank`` lives on this process's device as a (1, L, ...) tensor, and
    the exchange and the reductions are collectives over the group
    (``parallel/comm.py``).

Host metadata (partitions, sparse structures, plans' host tables) is
global and identical on every rank in both forms: plans are built without
communication, as the JAX package builds them on its single controller.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, replace
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
    solver + process group. ``nshards`` plays the role of the reference's
    MPI world size; ``solver="device"`` routes ``lu``/``ldlt``/``solve`` to
    the device multifrontal engine (the reference's Solver type parameter
    selecting MUMPS or cuDSS), ``"multifrontal"`` to the host engine.
    ``group``: a ``torch.distributed`` process group of ``nshards``
    processes, one shard each (``backend_dist``), or None for the stacked
    form."""

    device: torch.device
    nshards: int = 1
    dtype: Any = np.float64
    index_dtype: Any = np.int32
    solver: str = "multifrontal"
    group: Any = None

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
        rank = 0
        if self.group is not None:
            import torch.distributed as dist

            rank = dist.get_rank(self.group)
            if rank < 0:
                raise ValueError("this process is not a member of the group")
            if dist.get_world_size(self.group) != self.nshards:
                raise ValueError(f"nshards {self.nshards} != the group's "
                                 f"size {dist.get_world_size(self.group)}")
        object.__setattr__(self, "rank", rank)

    @property
    def is_dist(self) -> bool:
        """True on a process group: this process holds one shard."""
        return self.group is not None

    @property
    def world(self) -> int:
        """The number of shards, one a process on a group."""
        return self.nshards

    @property
    def shards(self) -> range:
        """The global shards this process holds: all of them stacked, or
        shard ``rank`` on a group."""
        return range(self.rank, self.rank + 1) if self.is_dist \
            else range(self.nshards)

    @property
    def nlocal(self) -> int:
        """Leading extent of every container's device tensor."""
        return len(self.shards)

    def shard_tensor(self, host_stack, dtype=None) -> torch.Tensor:
        """A host (S, ...) stack -> the tensor of this process's shards,
        rows ``shards`` of it, on the device (a copy, as ``tensor``)."""
        sh = self.shards
        return self.tensor(np.asarray(host_stack)[sh.start: sh.stop], dtype)

    def with_dtype(self, dtype) -> "Backend":
        """This backend with another element dtype, on the same device and
        group (ref: retype_backend, backends.jl:482)."""
        return replace(self, dtype=dtype)

    @property
    def complex_capable(self) -> bool:
        """Complex dtypes are held natively on every torch device."""
        return True

    @property
    def key(self) -> tuple:
        """Hashable identity for plan-cache keys: a plan holds tensors on
        one device for one shard count, and on a group for one rank of one
        group."""
        key = (str(self.device), self.nshards, self.dtype.str,
               self.index_dtype.str)
        return key + (("group", id(self.group), self.rank),) \
            if self.is_dist else key

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
    """Same device, shard count, index dtype and process group; operands
    may differ in element dtype."""
    return (a.device == b.device and a.nshards == b.nshards
            and a.index_dtype == b.index_dtype and a.group is b.group)


def backend_auto(nshards: int | None = None, dtype=np.float64,
                 index_dtype=np.int32, solver: str = "multifrontal",
                 device=None) -> Backend:
    """``nshards`` shards stacked on ``device``, by default the current
    CUDA device; ``nshards=None`` is one shard, as the JAX package's mesh
    over a one-device host. The parameters are the JAX package's, with
    ``device`` for its ``platform``. Raises when ``device`` is None and
    there is no CUDA device: the port runs on the CPU only when the
    caller asks for it (``device="cpu"``)."""
    if nshards is None:
        nshards = 1
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


def backend_dist(dtype=np.float64, index_dtype=np.int32,
                 solver: str = "multifrontal", group=None,
                 device=None) -> Backend:
    """One shard a process over a ``torch.distributed`` process group (ref:
    backend_cuda_mpi / backend_cpu_mpi, backends.jl:348-432): ``group``, by
    default the default group, which the caller has initialised
    (``torchrun`` with ``torch.distributed.init_process_group``, or
    ``parallel.launch.run_ranks``). Rank r takes ``cuda:LOCAL_RANK``, or
    ``cuda:(r % device_count)`` without LOCAL_RANK, and makes it the
    current device; ``device="cpu"`` keeps the shard on the CPU. Raises
    when no process group is up: it never makes a one-process backend in
    place of the caller's group, nor changes the group's transport."""
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("backend_dist: no process group; initialise one "
                           "first (torch.distributed.init_process_group, "
                           "torchrun, or parallel.launch.run_ranks)")
    group = dist.group.WORLD if group is None else group
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("backend_dist: no CUDA device; pass "
                               "device='cpu' to run on the CPU")
        local = os.environ.get("LOCAL_RANK")
        index = int(local) if local is not None \
            else dist.get_rank(group) % torch.cuda.device_count()
        device = torch.device("cuda", index)
    device = torch.device(device)
    if device.type == "cuda" and device.index is not None:
        torch.cuda.set_device(device)
    return Backend(device, dist.get_world_size(group), dtype, index_dtype,
                   solver, group)
