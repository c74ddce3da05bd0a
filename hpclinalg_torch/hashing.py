"""Structural hashing: stable identity of partitions and sparsity patterns.

All structure metadata (partitions, indptr, column indices) is host
numpy, so hashing is local blake2b over the raw bytes. The byte stream is
the JAX package's, so a pattern hashes to the same digest in both packages.
Hashes key the plan caches.
"""

from __future__ import annotations

import hashlib

import numpy as np

DIGEST_SIZE = 16  # 128-bit; collision-safe for cache keying


def _h(*arrays: np.ndarray) -> str:
    h = hashlib.blake2b(digest_size=DIGEST_SIZE)
    for a in arrays:
        a = np.ascontiguousarray(a)
        h.update(str(a.dtype).encode())
        h.update(np.asarray(a.shape, dtype=np.int64).tobytes())
        h.update(a.tobytes())
    return h.hexdigest()


def partition_hash(p: np.ndarray) -> str:
    """Identity of a partition boundary vector."""
    return _h(np.asarray(p, dtype=np.int64))


def sparse_structural_hash(
    row_partition: np.ndarray,
    col_partition: np.ndarray,
    indptr: list[np.ndarray],
    col_indices: list[np.ndarray],
    colval: list[np.ndarray],
) -> str:
    """Identity of a distributed CSR structure: both partitions and the full
    local sparsity pattern of every shard."""
    h = hashlib.blake2b(digest_size=DIGEST_SIZE)
    h.update(partition_hash(row_partition).encode())
    h.update(partition_hash(col_partition).encode())
    for s in range(len(indptr)):
        h.update(_h(indptr[s], col_indices[s], colval[s]).encode())
    return h.hexdigest()


def dense_structural_hash(row_partition: np.ndarray, ncols: int) -> str:
    """Identity of a distributed dense matrix structure: its row partition
    and its column count."""
    h = hashlib.blake2b(digest_size=DIGEST_SIZE)
    h.update(partition_hash(row_partition).encode())
    h.update(np.int64(ncols).tobytes())
    return h.hexdigest()
