"""ExchangePlan: the universal static data-movement primitive.

Every communication pattern of the reference is a memoized two-phase plan:
a handshake exchanging counts and index lists at plan time, then an
allocation-free movement of value payloads at execution time. The structure
metadata is host numpy, so phase (1) is local numpy with no handshake, and
the host planning below follows the JAX package's ExchangePlan
(hpclinalg/parallel/exchange.py): the same counts and the same identity
classification.

Phase (2) differs. All S shards live stacked in one (S, L) tensor on one
device, so every tier of the JAX package (identity pad, window slice,
local permute, all_to_all with its self modes) is the same two steps on
the flattened tensor:

    vals = x.flat[src]               (K2's gather mode, ops/cuda_ell.py)
    out.flat[dst] = vals             (or += with add=True)

``src``/``dst`` hold exactly the live (source slot, destination slot)
pairs. A destination of ``out_pad`` is the drop slot, as in the JAX plan,
whose static-width tables send their padding there: such pairs are dropped
when the plan is built. Any other destination outside ``[0, out_pad)`` is
an error raised at plan build. Output slots nobody writes stay zero — the
padding invariant.
"""

from __future__ import annotations

import numpy as np
import torch

from ..backend import Backend
from ..config import round_up
from ..ops.cuda_ell import gather


class ExchangePlan:
    """A static exchange.

    Host inputs:
      send[s][d]     : np int array — local slot indices on shard s to ship to d
      recv_pos[d][s] : np int array — output slots on shard d for data from s
                       (same length as send[s][d]; positions unique per shard)
      out_len        : logical output-buffer length per shard (padded up
                       internally; padding slots stay zero)
    """

    def __init__(self, backend: Backend, send, recv_pos, out_len: int,
                 src_sizes=None):
        S = backend.nshards
        self.backend = backend
        self.out_len = int(out_len)
        self.out_pad = round_up(self.out_len)

        counts = np.zeros((S, S), dtype=np.int64)
        for s in range(S):
            for d in range(S):
                counts[s, d] = len(send[s][d])
        self.counts = counts
        self.local_only = bool(np.all(counts[~np.eye(S, dtype=bool)] == 0)) \
            if S > 1 else True
        # identity: every shard keeps ALL of its own data in place. SpMV
        # skips the exchange for such plans and reads x directly.
        self.is_identity = (
            src_sizes is not None and self.local_only and all(
                len(send[s][s]) == int(src_sizes[s])
                and np.array_equal(send[s][s], np.arange(int(src_sizes[s])))
                and np.array_equal(recv_pos[s][s], np.arange(int(src_sizes[s])))
                for s in range(S)
            )
        )
        src_shard, src_loc, dst = [], [], []
        for s in range(S):
            for d in range(S):
                c = int(counts[s, d])
                if not c:
                    continue
                sd = np.asarray(send[s][d], dtype=np.int64)
                rv = np.asarray(recv_pos[d][s], dtype=np.int64)
                if len(rv) != c:
                    raise ValueError(f"send[{s}][{d}] and recv_pos[{d}][{s}] "
                                     "differ in length")
                if (sd < 0).any():
                    raise IndexError(f"send[{s}][{d}] has a negative slot")
                if (rv < 0).any() or (rv > self.out_pad).any():
                    raise IndexError(f"recv_pos[{d}][{s}] outside "
                                     f"[0, {self.out_pad}) and not the drop "
                                     f"slot {self.out_pad}")
                live = rv != self.out_pad
                src_shard.append(np.full(int(live.sum()), s, np.int64))
                src_loc.append(sd[live])
                dst.append(d * self.out_pad + rv[live])
        cat = (lambda a: np.concatenate(a) if a else np.zeros(0, np.int64))
        self._src_shard, self._src_loc = cat(src_shard), cat(src_loc)
        # one past the largest source slot read: apply checks the payload
        # is at least this long before any gather
        self.src_need = int(self._src_loc.max()) + 1 if self._src_loc.size else 0
        if src_sizes is not None and self._src_loc.size:
            sizes = np.asarray(src_sizes, np.int64)
            if (self._src_loc >= sizes[self._src_shard]).any():
                raise IndexError("send slots beyond the source shard sizes")
        self._dst_np = cat(dst)
        self.dst = backend.tensor(self._dst_np, torch.int64)
        self._src_flat = {}   # (payload length L, slot width k) -> (1, N) int32
        self._dst_wide = {1: self.dst}  # slot width k -> (N*k,) int64

    @property
    def nmoved(self) -> int:
        """Number of (source slot, destination slot) pairs the plan moves."""
        return int(self._src_loc.size)

    def _src(self, L: int, k: int) -> torch.Tensor:
        t = self._src_flat.get((L, k))
        if t is None:
            S = self.backend.nshards
            if S * L * k >= 2 ** 31:
                raise ValueError("exchange payload exceeds int32 indexing")
            flat = self._src_shard * L + self._src_loc
            if k > 1:
                flat = (flat[:, None] * k + np.arange(k)).reshape(-1)
            t = self.backend.tensor(flat.astype(np.int32)[None])
            self._src_flat[(L, k)] = t
        return t

    def _dst(self, k: int) -> torch.Tensor:
        t = self._dst_wide.get(k)
        if t is None:
            t = self.backend.tensor(
                (self._dst_np[:, None] * k + np.arange(k)).reshape(-1))
            self._dst_wide[k] = t
        return t

    def apply(self, x: torch.Tensor, base: torch.Tensor | None = None,
              add: bool = False) -> torch.Tensor:
        """x: stacked shards (S, L, ...): each slot may carry a payload of
        trailing axes, which moves whole (a complex payload as its real
        pairs). Returns (S, out_pad, ...) with the
        exchanged payload scattered to its destination slots; remaining
        slots are zero, or copied from ``base`` (S, out_pad, ...) when
        provided. ``add=True`` scatter-adds (assembly patterns with
        overlapping destinations)."""
        S = self.backend.nshards
        if x.dim() < 2 or x.shape[0] != S:
            raise ValueError(f"exchange payload must be (S={S}, L, ...), got "
                             f"{tuple(x.shape)}")
        if x.is_complex():
            # the gather kernel moves real words: a complex slot travels as
            # its (real, imaginary) pair, one more trailing axis of 2
            rb = None if base is None else torch.view_as_real(
                base.to(x.dtype).contiguous())
            out = self.apply(torch.view_as_real(x.contiguous()), rb, add)
            return torch.view_as_complex(out)
        L, trail = x.shape[1], tuple(x.shape[2:])
        k = int(np.prod(trail, dtype=np.int64))
        if L < self.src_need:
            raise IndexError(f"payload length {L} < slots read {self.src_need}")
        if base is not None:
            if tuple(base.shape) != (S, self.out_pad) + trail:
                raise ValueError(f"base must be {(S, self.out_pad) + trail}")
            out = base.to(x.dtype).reshape(-1).clone()
        else:
            out = x.new_zeros(S * self.out_pad * k)
        if self.nmoved and k:
            vals = gather(x.reshape(1, S * L * k), self._src(L, k))[0]
            if add:
                out.index_add_(0, self._dst(k), vals)
            else:
                out.index_copy_(0, self._dst(k), vals)
        return out.reshape((S, self.out_pad) + trail)
