"""Where a run executes: its device, its rank in a process group of one
process a card (``world`` > 1), and the collectives the harness itself
needs (not the program's: its stop flag, gathers of results for the check,
and the reduction of per-rank readings)."""

from __future__ import annotations

import datetime
import os
import socket
import sys

import torch

FORBIDDEN = ("jax", "jaxlib", "flax", "hpclinalg")


def forbidden_loaded() -> list[str]:
    """The top-level names in ``sys.modules`` that belong to JAX or to the
    JAX package, compared whole (``hpclinalg_torch`` is the program)."""
    tops = {m.split(".")[0] for m in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN))


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


class Env:
    """One rank of a run: ``device`` "cuda" (rank r on cuda:r) or "cpu";
    ``transport`` "nccl" or "gloo" when ``world`` > 1."""

    def __init__(self, device: str, rank: int = 0, world: int = 1,
                 transport: str | None = None, port: int | None = None):
        self.rank, self.world, self.transport = rank, world, transport
        self.cuda = device == "cuda"
        self.device = torch.device("cuda", rank) if self.cuda \
            else torch.device("cpu")
        if self.cuda:
            torch.cuda.set_device(self.device)
        if world > 1:
            import torch.distributed as dist

            os.environ["LOCAL_RANK"] = str(rank)
            os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
            os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
            dist.init_process_group(
                transport, init_method=f"tcp://localhost:{port}",
                rank=rank, world_size=world,
                timeout=datetime.timedelta(seconds=300))

    @property
    def is_dist(self) -> bool:
        return self.world > 1

    def backend(self, dtype):
        import hpclinalg_torch as ht

        if self.is_dist:
            return ht.backend_dist(dtype=dtype,
                                   device=None if self.cuda else "cpu")
        return ht.backend_auto(1, dtype=dtype, device=str(self.device))

    def sync(self):
        if self.cuda:
            torch.cuda.synchronize(self.device)

    def barrier(self):
        self.sync()
        if self.is_dist:
            import torch.distributed as dist

            if self.cuda:
                dist.barrier(device_ids=[self.rank])
            else:
                dist.barrier()

    def all_gather(self, t: torch.Tensor) -> list[torch.Tensor]:
        """Every rank's ``t`` (same shape on every rank), in rank order."""
        if not self.is_dist:
            return [t]
        import torch.distributed as dist

        t = t.contiguous()
        out = [torch.empty_like(t) for _ in range(self.world)]
        dist.all_gather(out, t)
        return out

    def floats(self, values) -> list[list[float]]:
        """Each rank's list of floats, in rank order."""
        t = torch.tensor(list(values), dtype=torch.float64,
                         device=self.device)
        return [g.tolist() for g in self.all_gather(t)]

    def close(self, wait: bool = True):
        """Leaves the process group: after a barrier, or at once (``wait``
        false, after a failure, when a peer may never reach one)."""
        if self.is_dist:
            import torch.distributed as dist

            if wait:
                self.barrier()
            dist.destroy_process_group()
