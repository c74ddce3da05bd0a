"""Run a function on n ranks of a fresh ``torch.distributed`` process group.

``run_ranks`` starts n processes with the ``spawn`` method, each of which
joins a process group through a file store in a private temporary
directory (never a fixed TCP port, so concurrent callers cannot collide),
calls the function named by ``fn_path`` and writes the dictionary of numpy
arrays it returns to ``rank<r>.npz`` there. The parent waits for all of
them until a hard deadline, kills every child when one fails or the
deadline passes, and raises; otherwise it returns the ranks' results in
rank order. The function must be importable by its module path (a child
cannot import a test module's local function). Every rank is on this
host, so the transports bootstrap over the loopback interface unless
``GLOO_SOCKET_IFNAME`` / ``NCCL_SOCKET_IFNAME`` say otherwise.

A user with ``torchrun`` needs none of this: torchrun starts the
processes, ``torch.distributed.init_process_group()`` joins them, and
``hpclinalg_torch.backend_dist()`` makes the backend.
"""

from __future__ import annotations

import datetime
import importlib
import multiprocessing as mp
import os
import shutil
import sys
import tempfile
import time
import traceback
from multiprocessing.connection import wait

import numpy as np


def _resolve(fn_path: str):
    module, _, name = fn_path.partition(":")
    return getattr(importlib.import_module(module), name)


def _child(fn_path, rank, n, transport, device, workdir, group_timeout_s,
           args):
    """One rank: join the group, run the function, write its results."""
    code = 1
    try:
        import torch
        import torch.distributed as dist

        # every rank is on this host: bootstrap over the loopback interface
        for var in ("GLOO_SOCKET_IFNAME", "NCCL_SOCKET_IFNAME"):
            os.environ.setdefault(var, "lo")
        if device == "cpu":
            torch.set_num_threads(1)
        else:
            torch.cuda.set_device(rank % torch.cuda.device_count())
        dist.init_process_group(
            transport, init_method="file://" + os.path.join(workdir, "store"),
            rank=rank, world_size=n,
            timeout=datetime.timedelta(seconds=group_timeout_s))
        try:
            out = _resolve(fn_path)(device, *args)
            np.savez(os.path.join(workdir, f"rank{rank}.npz"),
                     **{k: np.asarray(v) for k, v in out.items()})
            # no rank closes its connections while a peer still uses them
            dist.barrier()
        finally:
            dist.destroy_process_group()
        code = 0
    except BaseException:
        with open(os.path.join(workdir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
    finally:
        # The rank's work is done and on disk: leave without the
        # interpreter's teardown, whose C++ static destructors can abort
        # (SIGABRT, "terminate called without an active exception") while
        # the transport's threads are still alive.
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(code)


def run_ranks(fn_path: str, n: int, backend: str = "nccl",
              device: str = "cuda", deadline_s: float = 120.0,
              args: tuple = ()) -> list[dict[str, np.ndarray]]:
    """Run ``fn(device, *args)`` on ranks 0..n-1 of a new process group
    with the ``backend`` transport ("nccl" or "gloo"); ``fn_path`` is
    "package.module:function", and ``fn`` returns a dict of arrays.
    ``device`` is "cuda" (rank r takes cuda:(r % device_count)); raises
    without a CUDA device unless the caller asks for the CPU with
    ``device="cpu"`` and ``backend="gloo"`` (each child then uses one
    thread). The group's collectives time out after ``deadline_s``; after
    ``deadline_s`` seconds the parent kills every child still running and
    raises TimeoutError. A child's exception kills the others at once and
    raises RuntimeError with its traceback."""
    if device not in ("cpu", "cuda"):
        raise ValueError(f"device must be 'cpu' or 'cuda', got {device!r}")
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend must be 'nccl' or 'gloo', got {backend!r}")
    if device == "cuda":
        import torch

        if not torch.cuda.is_available():
            raise RuntimeError("run_ranks: no CUDA device; pass device='cpu' "
                               "and backend='gloo' to run on the CPU")
    elif backend == "nccl":
        raise ValueError("run_ranks: NCCL needs device='cuda'; use "
                         "backend='gloo' on the CPU")
    ctx = mp.get_context("spawn")
    workdir = tempfile.mkdtemp(prefix="hpclinalg_ranks_")
    procs = []
    try:
        for r in range(n):
            p = ctx.Process(target=_child, daemon=True, args=(
                fn_path, r, n, backend, device, workdir, deadline_s, args))
            p.start()
            procs.append(p)
        end = time.monotonic() + deadline_s
        running = list(procs)
        while running:
            left = end - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"run_ranks({fn_path}, {n}): ranks "
                                   f"{[procs.index(p) for p in running]} "
                                   f"still running after {deadline_s} s")
            for s in wait([p.sentinel for p in running], timeout=left):
                p = next(p for p in running if p.sentinel == s)
                p.join()
                running.remove(p)
                if p.exitcode != 0:
                    r = procs.index(p)
                    err = os.path.join(workdir, f"rank{r}.err")
                    text = open(err).read() if os.path.exists(err) \
                        else f"exit code {p.exitcode}"
                    raise RuntimeError(f"run_ranks({fn_path}, {n}): rank "
                                       f"{r} failed:\n{text}")
        out = []
        for r in range(n):
            with np.load(os.path.join(workdir, f"rank{r}.npz")) as z:
                out.append({k: z[k] for k in z.files})
        return out
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join(timeout=10)
        shutil.rmtree(workdir, ignore_errors=True)
