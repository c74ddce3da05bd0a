"""Generic gather/scatter plans keyed by global row ids.

Counterparts of the reference's VectorPlan handshake (src/vectors.jl:
229-380: group requested global indices by owner, exchange index lists,
preallocate buffers) and of its fancy-indexing scatter paths
(indexing.jl:1339-1483). The handshake disappears — owners and local
offsets come from a host searchsorted — leaving one static ExchangePlan.
Host planning only (numpy), identical to the JAX package's module.
"""

from __future__ import annotations

import numpy as np

from ..backend import Backend
from ..config import round_up
from ..partition import global_to_local, partition_sizes
from ..parallel.exchange import ExchangePlan


def gather_exchange_plan(
    backend: Backend,
    src_partition: np.ndarray,
    wanted_per_shard: list[np.ndarray],
    out_len: int | None = None,
) -> ExchangePlan:
    """Plan delivering, to each destination shard d, the source entries at
    global ids ``wanted_per_shard[d]`` — placed at output slots 0..len-1 in
    order. This is exactly the reference VectorPlan's gather contract: shard
    d's "gathered" buffer is x[wanted[d]] (vectors.jl:394-463)."""
    S = backend.nshards
    send = [[np.zeros(0, np.int64) for _ in range(S)] for _ in range(S)]
    recv = [[np.zeros(0, np.int64) for _ in range(S)] for _ in range(S)]
    maxlen = 0
    for d in range(S):
        ids = np.asarray(wanted_per_shard[d], dtype=np.int64)
        maxlen = max(maxlen, len(ids))
        owners, loc = global_to_local(src_partition, ids)
        pos = np.arange(len(ids), dtype=np.int64)
        for s in range(S):
            m = owners == s
            if m.any():
                send[s][d] = loc[m]
                recv[d][s] = pos[m]
    if out_len is None:
        out_len = round_up(maxlen)
    return ExchangePlan(backend, send, recv, out_len,
                        src_sizes=partition_sizes(src_partition))


def scatter_exchange_plan(
    backend: Backend,
    src_partition: np.ndarray,
    dst_global_per_shard: list[np.ndarray],
    dst_partition: np.ndarray,
) -> ExchangePlan:
    """Plan shipping source entry j of shard s (local order) to the global
    row ``dst_global_per_shard[s][j]`` under ``dst_partition``. Used by
    setindex! analogues (ref: indexing.jl scatter paths)."""
    S = backend.nshards
    send = [[np.zeros(0, np.int64) for _ in range(S)] for _ in range(S)]
    recv = [[np.zeros(0, np.int64) for _ in range(S)] for _ in range(S)]
    for s in range(S):
        ids = np.asarray(dst_global_per_shard[s], dtype=np.int64)
        owners, loc = global_to_local(dst_partition, ids)
        src_pos = np.arange(len(ids), dtype=np.int64)
        for d in range(S):
            m = owners == d
            if m.any():
                send[s][d] = src_pos[m]
                recv[d][s] = loc[m]
    from ..partition import padded_size

    # The payload here is POSITIONAL: shard s's valid length is
    # len(dst_global_per_shard[s]), not its partition size.
    valid = [len(np.asarray(ids)) for ids in dst_global_per_shard]
    return ExchangePlan(backend, send, recv, padded_size(dst_partition),
                        src_sizes=valid)
