"""ExchangePlan: the universal static data-movement primitive.

Every communication pattern of the reference is a memoized two-phase plan:
a handshake exchanging counts and index lists at plan time, then an
allocation-free movement of value payloads at execution time. The structure
metadata is host numpy, so phase (1) is local numpy with no handshake, and
the host planning below follows the JAX package's ExchangePlan
(hpclinalg/parallel/exchange.py): the same counts and the same identity
classification.

Phase (2) differs. Without a process group all S shards live stacked in
one (S, L) tensor on one device, so every tier of the JAX package (identity
pad, window slice, local permute, all_to_all with its self modes) is the
same two steps on the flattened tensor:

    vals = x.flat[src]               (K2's gather mode, ops/cuda_ell.py)
    out.flat[dst] = vals             (or += with add=True)

On a process group (``Backend.group``: one shard a process) it is the JAX
package's three steps (hpclinalg/parallel/exchange.py:50-110), run on this
rank's shard with this rank's tables only:

    vals = x.flat[self_src ++ send_src]     one gather: the self slots and
                                            the send buffer, by destination
    recv = all_to_all_single(vals[nself:])  one collective; self traffic
                                            never rides it
    out.flat[self_dst] = vals[:nself]; out.flat[recv_dst] = recv

The split sizes are the live counts ``moved[rank, :]`` / ``moved[:, rank]``
with the diagonal left out. Whether the collective runs at all is decided
from the global counts, so every rank calls it or none does.

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
from . import comm


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
        src_shard, src_loc, dst_shard, dst = [], [], [], []
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
                dst_shard.append(np.full(int(live.sum()), d, np.int64))
                dst.append(rv[live])
        cat = (lambda a: np.concatenate(a) if a else np.zeros(0, np.int64))
        src_shard, src_loc = cat(src_shard), cat(src_loc)
        dst_shard, dst = cat(dst_shard), cat(dst)
        self.nmoved = int(src_loc.size)
        # one past the largest source slot read: apply checks the payload
        # is at least this long before any gather
        self.src_need = int(src_loc.max()) + 1 if src_loc.size else 0
        if src_sizes is not None and src_loc.size:
            sizes = np.asarray(src_sizes, np.int64)
            if (src_loc >= sizes[src_shard]).any():
                raise IndexError("send slots beyond the source shard sizes")
        if backend.is_dist:
            r = backend.rank
            own, mine = src_shard == r, dst_shard == r
            moved = np.zeros((S, S), np.int64)
            np.add.at(moved, (src_shard, dst_shard), 1)
            np.fill_diagonal(moved, 0)
            # the global order is (source, destination), so this rank's
            # sends come by destination and its receipts by source
            self.crosses = bool(moved.any())
            self._in_splits = moved[r].tolist()
            self._out_splits = moved[:, r].tolist()
            self._nself = int((own & mine).sum())
            self._gather_shard = np.zeros(int(own.sum()), np.int64)
            self._gather_loc = np.concatenate([src_loc[own & mine],
                                               src_loc[own & ~mine]])
            self._dst_np = (dst[own & mine], dst[mine & ~own])
        else:
            self.crosses = False
            self._nself = self.nmoved
            self._gather_shard, self._gather_loc = src_shard, src_loc
            self._dst_np = (dst_shard * self.out_pad + dst,
                            np.zeros(0, np.int64))
        self._src_flat = {}   # (payload length L, slot width k) -> (1, N) int32
        self._dst_wide = {}   # slot width k -> (self, received) (N*k,) int64

    def _src(self, L: int, k: int) -> torch.Tensor:
        t = self._src_flat.get((L, k))
        if t is None:
            if self.backend.nlocal * L * k >= 2 ** 31:
                raise ValueError("exchange payload exceeds int32 indexing")
            flat = self._gather_shard * L + self._gather_loc
            if k > 1:
                flat = (flat[:, None] * k + np.arange(k)).reshape(-1)
            t = self.backend.tensor(flat.astype(np.int32)[None])
            self._src_flat[(L, k)] = t
        return t

    def _dst(self, k: int):
        t = self._dst_wide.get(k)
        if t is None:
            t = self._dst_wide[k] = tuple(
                self.backend.tensor((d[:, None] * k + np.arange(k))
                                    .reshape(-1)) for d in self._dst_np)
        return t

    def apply(self, x: torch.Tensor, base: torch.Tensor | None = None,
              add: bool = False) -> torch.Tensor:
        """x: this process's shards (S stacked, or 1 on a group; (nlocal,
        L, ...)): each slot may carry a payload of trailing axes, which
        moves whole (a complex payload as its real pairs). Returns
        (nlocal, out_pad, ...) with the exchanged payload scattered to its
        destination slots; remaining slots are zero, or copied from
        ``base`` (nlocal, out_pad, ...) when provided. ``add=True``
        scatter-adds (assembly patterns with overlapping destinations). On
        a group every rank must call it: it is a collective."""
        S = self.backend.nlocal
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
        if k and (self._gather_loc.size or self.crosses):
            vals = gather(x.reshape(1, S * L * k), self._src(L, k))[0]
            nself = self._nself * k
            recv = comm.all_to_all_v(
                self.backend, vals[nself:], [c * k for c in self._in_splits],
                [c * k for c in self._out_splits]) if self.crosses else None
            put = out.index_add_ if add else out.index_copy_
            dst_self, dst_recv = self._dst(k)
            if nself:
                put(0, dst_self, vals[:nself])
            if recv is not None and recv.numel():
                put(0, dst_recv, recv)
        return out.reshape((S, self.out_pad) + trail)
