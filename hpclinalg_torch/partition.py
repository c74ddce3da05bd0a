"""Row partitions: contiguous 1-D ownership of global indices across shards.

Mirrors the reference's partition concept — an ``nranks+1`` boundary vector
shared by all ranks (``uniform_partition``, reference
src/HPCLinearAlgebra.jl:262-289). The partition is a host-side numpy array;
local shards are padded to a common length so the S shards stack into one
(S, L) tensor, and the padding slots stay zero.
"""

from __future__ import annotations

import numpy as np

from .config import PAD_MULTIPLE, round_up


def uniform_partition(n: int, nshards: int) -> np.ndarray:
    """Evenly split ``n`` rows over ``nshards`` contiguous blocks.

    Returns the boundary vector ``p`` with ``p[0] == 0``, ``p[-1] == n``;
    shard ``s`` owns global rows ``[p[s], p[s+1])``. Equivalent to the
    reference's ``uniform_partition`` (HPCLinearAlgebra.jl:279), with
    0-based half-open ranges instead of Julia's 1-based inclusive ones.
    """
    if nshards <= 0:
        raise ValueError("nshards must be positive")
    if n < 0:
        raise ValueError("n must be nonnegative")
    base, rem = divmod(n, nshards)
    sizes = np.full(nshards, base, dtype=np.int64)
    sizes[:rem] += 1
    return np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)


def validate_partition(p: np.ndarray, n: int | None = None) -> np.ndarray:
    p = np.asarray(p, dtype=np.int64)
    if p.ndim != 1 or p.shape[0] < 2:
        raise ValueError("partition must be a 1-D boundary vector of length nshards+1")
    if p[0] != 0:
        raise ValueError("partition must start at 0")
    if np.any(np.diff(p) < 0):
        raise ValueError("partition boundaries must be nondecreasing")
    if n is not None and p[-1] != n:
        raise ValueError(f"partition covers {p[-1]} rows, expected {n}")
    return p


def partition_sizes(p: np.ndarray) -> np.ndarray:
    """Local row counts per shard."""
    return np.diff(np.asarray(p, dtype=np.int64))


def padded_size(p: np.ndarray, multiple: int = PAD_MULTIPLE) -> int:
    """Static per-shard local length: max shard size rounded up.

    This is the single biggest semantic delta vs the reference's ragged MPI
    shards: the stacked (S, L) layout needs uniform shard lengths, so every
    shard stores ``padded_size`` entries and keeps its padding region zero.
    """
    sizes = partition_sizes(p)
    m = int(sizes.max()) if sizes.size else 0
    return round_up(m, multiple)


def owner_of(p: np.ndarray, global_idx: np.ndarray) -> np.ndarray:
    """Shard owning each global index (vectorized searchsorted).

    Analogue of the reference's ``searchsortedlast`` over ``x.partition``
    (vectors.jl gather planning, sparse.jl:1888-1896).
    """
    return np.searchsorted(p, np.asarray(global_idx), side="right") - 1


def nshards_of(p: np.ndarray) -> int:
    return int(np.asarray(p).shape[0] - 1)


def shard_mask(p: np.ndarray, padded: int | None = None) -> np.ndarray:
    """(S, L) bool mask of valid (non-padding) slots per shard."""
    sizes = partition_sizes(p)
    L = padded if padded is not None else padded_size(p)
    return np.arange(L)[None, :] < sizes[:, None]


def global_to_local(p: np.ndarray, global_idx: np.ndarray, owners: np.ndarray | None = None):
    """(owner shard, local index) for each global index."""
    g = np.asarray(global_idx, dtype=np.int64)
    own = owners if owners is not None else owner_of(p, g)
    return own, g - p[own]
