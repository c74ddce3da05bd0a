"""Collectives over a backend's process group.

Counterparts of the mesh collectives the JAX package calls inside
``shard_map`` (``all_to_all``, ``psum``, ``pmax``/``pmin``,
``all_gather``), as thin wrappers over ``torch.distributed`` on
``backend.group``. Without a group every shard is in this process's stacked
tensor already, and each wrapper returns its input: the stacked path runs
no collective.

Complex payloads travel as their (real, imaginary) pairs
(``torch.view_as_real``) on every transport: NCCL takes complex tensors
for a sum only, so every collective here moves real words.

Each collective adds one to the counter ``comm.calls`` and the bytes it
hands to the transport to ``comm.bytes`` (``utils/profiling.count``; held
through a CUDA graph's capture and added at each replay): the tensor's, or
the sent splits' for ``all_to_all_v``.
"""

from __future__ import annotations

import torch

from ..backend import Backend
from ..utils.profiling import count

_OPS = {"sum": "SUM", "max": "MAX", "min": "MIN"}


def _real(t: torch.Tensor) -> torch.Tensor:
    return torch.view_as_real(t) if t.is_complex() else t


def _counted(nbytes: int) -> None:
    count("comm.calls")
    count("comm.bytes", nbytes)


def all_to_all_v(backend: Backend, send: torch.Tensor, in_splits,
                 out_splits) -> torch.Tensor:
    """One ``all_to_all_single`` of the 1-D ``send``: ``in_splits[d]``
    entries of it, in rank order, go to rank d, and ``out_splits[s]``
    entries arrive from rank s, in rank order, in the returned tensor."""
    if not backend.is_dist:
        return send
    import torch.distributed as dist

    out = send.new_empty(int(sum(out_splits)))
    if send.is_complex():
        o, s, f = torch.view_as_real(out), torch.view_as_real(send), 2
    else:
        o, s, f = out, send, 1
    dist.all_to_all_single(o.reshape(-1), s.contiguous().reshape(-1),
                           [f * int(c) for c in out_splits],
                           [f * int(c) for c in in_splits],
                           group=backend.group)
    _counted(s.element_size() * f * int(sum(in_splits)))
    return out


def all_reduce(backend: Backend, t: torch.Tensor,
               op: str = "sum") -> torch.Tensor:
    """``t`` reduced over the group in place (``op``: "sum", "max" or
    "min") and returned: the same value on every rank."""
    if not backend.is_dist:
        return t
    import torch.distributed as dist

    if t.is_complex() and op != "sum":
        raise TypeError(f"all_reduce: {op} of a complex tensor")
    dist.all_reduce(_real(t), op=getattr(dist.ReduceOp, _OPS[op]),
                    group=backend.group)
    _counted(t.nbytes)
    return t


def all_gather_rows(backend: Backend, t: torch.Tensor) -> torch.Tensor:
    """This process's (1, ...) rows -> the (S, ...) stack of every rank's,
    in rank order."""
    if not backend.is_dist:
        return t
    import torch.distributed as dist

    src = _real(t.contiguous())
    outs = [torch.empty_like(src) for _ in range(backend.world)]
    dist.all_gather(outs, src, group=backend.group)
    _counted(src.nbytes)
    out = torch.cat(outs)
    return torch.view_as_complex(out) if t.is_complex() else out


def broadcast(backend: Backend, t: torch.Tensor) -> torch.Tensor:
    """``t`` of the group's rank 0 copied into ``t`` on every rank, in
    place, and returned."""
    if not backend.is_dist:
        return t
    import torch.distributed as dist

    dist.broadcast(_real(t), src=dist.get_global_rank(backend.group, 0),
                   group=backend.group)
    _counted(t.nbytes)
    return t
