"""Mesh-level helpers: full-array gathers and their inverse.

Port of the JAX package's ``hpclinalg/parallel/mesh.py``. There the
stacked shards are all-gathered across the mesh and a static take drops
the padding. Stacked, all S shards of the port live in one tensor on one
device, so the all-gather is one ``index_select`` of the flattened
``(S·L, ...)`` stack with the cached unpad index, and its inverse one
``index_copy_`` into a zeroed stack. On a process group the all-gather is
a collective of the (1, L, ...) shards first (``comm.all_gather_rows``),
and the inverse keeps this rank's rows.
"""

from __future__ import annotations

import numpy as np
import torch

from ..backend import Backend
from ..cache import cached_plan
from ..hashing import partition_hash
from ..partition import nshards_of, padded_size, partition_sizes
from . import comm


def _unpad_index(partition: np.ndarray, L: int) -> np.ndarray:
    """Flat (n,) indices into a reshaped (S*L, ...) stacked array that pick
    out the valid entries in global order."""
    sizes = partition_sizes(partition)
    return np.concatenate(
        [s * L + np.arange(sz) for s, sz in enumerate(sizes)]
    ).astype(np.int64) if len(sizes) else np.zeros(0, np.int64)


def _unpad_index_dev(partition: np.ndarray, L: int,
                     backend: Backend) -> torch.Tensor:
    return cached_plan(
        "unpad_index", (partition_hash(partition), L, backend.key),
        lambda: backend.tensor(_unpad_index(partition, L)))


def allgather_full(x: torch.Tensor, partition: np.ndarray,
                   backend: Backend) -> torch.Tensor:
    """This process's shards (S, L, ...), or (1, L, ...) on a group -> the
    full (n, ...) array in global order, on the same device. On a group
    every rank must call it: it is a collective."""
    x = comm.all_gather_rows(backend, x)
    S, L = x.shape[0], x.shape[1]
    idx = _unpad_index_dev(partition, L, backend)
    return x.reshape((S * L,) + tuple(x.shape[2:])).index_select(0, idx)


def scatter_from_full(arr: torch.Tensor, partition: np.ndarray,
                      backend: Backend) -> torch.Tensor:
    """The full (n, ...) array -> this process's shards (S, L, ...), or
    (1, L, ...) on a group, with zero padding: the inverse of
    :func:`allgather_full`, on the device."""
    L = padded_size(partition)
    S = nshards_of(partition)
    trail = tuple(arr.shape[1:])
    if backend.is_dist:
        lo, hi = int(partition[backend.rank]), int(partition[backend.rank + 1])
        out = arr.new_zeros((1, L) + trail)
        out[0, : hi - lo] = arr[lo:hi]
        return out
    idx = _unpad_index_dev(partition, L, backend)
    flat = arr.new_zeros((S * L,) + trail)
    flat.index_copy_(0, idx, arr)
    return flat.reshape((S, L) + trail)


def gather_to_host(x: torch.Tensor, partition: np.ndarray,
                   backend: Backend | None = None) -> np.ndarray:
    """Host copy of the full (unpadded) array in global order; ``x`` is
    the whole stack, or this process's shards of ``backend`` (a collective
    on a group)."""
    if backend is not None:
        x = comm.all_gather_rows(backend, x)
    arr = x.detach().cpu().numpy()
    sizes = partition_sizes(partition)
    return np.concatenate([arr[s, : sizes[s]]
                           for s in range(nshards_of(partition))], axis=0)
