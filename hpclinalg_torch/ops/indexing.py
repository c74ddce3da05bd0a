"""Indexing and index assignment of distributed vectors.

Port of the JAX package's ``hpclinalg/ops/indexing.py``: range
getindex, fancy getindex with host or distributed integer index vectors,
and setindex. Scalar indexing is rejected (TypeError), as in the JAX
package and the reference (indexing.jl:17-21): it would synchronise the
device once per element. Every movement is one cached ``ExchangePlan``
(K2's gather mode on the card), built from global host data in every rank
of a process group; a distributed id vector is gathered to the host first,
a collective every rank calls.
"""

from __future__ import annotations

import numpy as np

from ..cache import cached_plan
from ..hashing import _h, partition_hash
from ..partition import nshards_of, padded_size, uniform_partition
from .gather import gather_exchange_plan, scatter_exchange_plan


def subrange_partition(p: np.ndarray, start: int, stop: int,
                       step: int = 1) -> np.ndarray:
    """The partition induced on ``range(start, stop, step)`` by the parent
    partition ``p``: each shard keeps the selected entries it already owns
    (ref: _compute_subpartition, indexing.jl:38)."""
    S = nshards_of(p)
    sizes = np.zeros(S, dtype=np.int64)
    for s in range(S):
        lo, hi = max(start, int(p[s])), min(stop, int(p[s + 1]))
        if lo < hi:
            # count of k in [lo, hi) with (k - start) % step == 0
            first = lo + (-(lo - start)) % step
            sizes[s] = max(0, (hi - 1 - first) // step + 1) if first < hi else 0
    return np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)


def _split(ids: np.ndarray, p: np.ndarray) -> list[np.ndarray]:
    """``ids`` cut into the pieces the shards of partition ``p`` hold."""
    return [ids[p[d]: p[d + 1]] for d in range(nshards_of(p))]


def check_ids_bounds(ids: np.ndarray, n: int, what: str = "index") -> None:
    """Ids must lie in [0, n): an id out of range has no owner shard and
    would read zeros or drop a write unseen (the reference throws a
    BoundsError)."""
    if len(ids) and (ids.min() < 0 or ids.max() >= n):
        bad = ids[(ids < 0) | (ids >= n)][0]
        raise IndexError(f"{what} {bad} out of bounds for size {n}")


def key_ids(key, n: int, what: str = "index"):
    """An index expression over range(n) as (explicit int64 ids, cache
    tag): a slice (tag ("slice", start, stop, step); a negative step is
    rejected), a host id array or list (("arr", hash)) or a distributed id
    vector (("vec", hash)). Ids out of range raise IndexError, a scalar
    TypeError: scalar indexing would synchronise the device per element
    (as the reference removed it, indexing.jl:17-21)."""
    from ..vector import DistVector

    if isinstance(key, slice):
        start, stop, step = key.indices(n)
        if step <= 0:
            raise ValueError("negative slice steps are not supported")
        return (np.arange(start, stop, step, dtype=np.int64),
                ("slice", start, stop, step))
    if isinstance(key, DistVector):
        ids, tag = v_to_int_host(key), "vec"
    elif isinstance(key, (list, np.ndarray)):
        ids, tag = np.asarray(key, dtype=np.int64), "arr"
    elif isinstance(key, (int, np.integer)):
        raise TypeError("scalar indexing of distributed containers is "
                        "unsupported; use slices or index vectors")
    else:
        raise TypeError(f"unsupported index type {type(key)}")
    check_ids_bounds(ids, n, what)
    return ids, (tag, _h(ids))


def v_to_int_host(key) -> np.ndarray:
    """A distributed index vector's ids on the host (ref:
    _gather_vector_to_all, indexing.jl:1821). Floating ids are rounded
    with rint, not truncated: 2.9999999999999996 selects 3."""
    arr = key.to_numpy_ro()
    if not np.issubdtype(arr.dtype, np.integer):
        if np.issubdtype(arr.dtype, np.complexfloating):
            arr = arr.real  # index vectors on a complex backend hold Re + 0j
        arr = np.rint(arr).astype(np.int64)
    return arr


def dedup_last(ids: np.ndarray):
    """Positions keeping the LAST occurrence of each id, in their original
    order, or None when the ids are distinct (last-write-wins assignment:
    on the card an index_copy_ with repeated destinations has an
    unspecified winner, so the repeats go before any plan is built)."""
    if len(ids) and len(np.unique(ids)) != len(ids):
        _, first_in_rev = np.unique(ids[::-1], return_index=True)
        return np.sort(len(ids) - 1 - first_in_rev)
    return None


def vector_getindex(v, key):
    """v[key] as a DistVector: for a slice on the subrange's partition, for
    a distributed id vector on its partition, else on the uniform one."""
    from ..vector import DistVector

    backend = v.backend
    ids, tag = key_ids(key, v.n)
    if tag[0] == "slice":
        sub_p = subrange_partition(v.partition, *tag[1:])
    elif tag[0] == "vec":
        sub_p = key.partition.copy()
    else:
        sub_p = uniform_partition(len(ids), backend.nshards)
    plan = cached_plan(
        "vec_getindex",
        (v.partition_hash, partition_hash(sub_p), tag, backend.key),
        lambda: gather_exchange_plan(backend, v.partition, _split(ids, sub_p),
                                     out_len=padded_size(sub_p)))
    return DistVector(plan.apply(v.data), sub_p, backend)


def vector_setindex(v, key, value) -> None:
    """``v[key] = value`` (ref: indexing.jl:1871-...). The vector's tensor
    is swapped for the fresh one the exchange returns: a tensor that
    another container may share is never written."""
    from ..backend import numpy_dtype
    from ..vector import DistVector

    ids = key_ids(key, v.n)[0]
    dtype = numpy_dtype(v.dtype)
    if np.isscalar(value) or isinstance(value, (int, float, complex)):
        src = DistVector.from_global(np.full(len(ids), value), v.backend,
                                     dtype=dtype)
    elif isinstance(value, DistVector):
        src = value
    else:
        src = DistVector.from_global(np.asarray(value), v.backend, dtype=dtype)
    if len(src) != len(ids):
        raise ValueError("value length must match index count")

    keep = dedup_last(ids)
    if keep is not None:
        ids = ids[keep]
        src = src[keep]

    sp_ = src.partition
    plan = cached_plan(
        "vec_setindex",
        (v.partition_hash, src.partition_hash, _h(ids), v.backend.key),
        lambda: scatter_exchange_plan(v.backend, sp_, _split(ids, sp_),
                                      v.partition))
    v.data = plan.apply(src.data.to(v.dtype), base=v.data)
    v._host_cache = None
