"""Kernel timing on the card, shared by the probe tools and chip_smoke.py.

Nothing here runs at import time; every function needs a CUDA device.
"""

from __future__ import annotations

import subprocess
import time

import numpy as np
import torch

# a captured graph's nodes by type: in ``utils/graphs`` beside the capture
from ..utils.graphs import GRAPH_NODE_TYPES, graph_nodes  # noqa: F401


def require_cuda() -> torch.device:
    """The first CUDA device; raises when there is none (the probes measure
    the card and have no CPU version)."""
    if not torch.cuda.is_available():
        raise SystemExit("this probe runs on a CUDA device and found none")
    return torch.device("cuda", 0)


def card() -> str:
    """The card's name and power limit, as
    ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` gives
    them (first card)."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    return out.splitlines()[0]


HEAD_START = 64   # flushes queued before the timed launches: about 5 ms


class Timer:
    """Median kernel time over 20 launches, CUDA events around each launch,
    a 256 MiB read before each so L2 (50 MB) starts cold (``cold=False``:
    no read, so what the launch before left in L2 stays). (A write would
    leave dirty lines whose write-back lands inside the timed launch.)
    Every launch is queued before the card reaches it, behind a head start
    of HEAD_START reads, so the events time the card and not the host's
    work in the wrapper, and the card runs at its load clocks throughout."""

    def __init__(self, dev):
        self.flush = torch.ones(64 << 20, dtype=torch.float32, device=dev)

    def ms(self, fn, reps=20, warm=3, cold=True):
        for _ in range(warm):
            fn()
        torch.cuda.synchronize()
        for _ in range(HEAD_START):
            self.flush.sum()
        ev = []
        for _ in range(reps):
            if cold:
                self.flush.sum()
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            ev.append((a, b))
        torch.cuda.synchronize()
        return float(np.median([a.elapsed_time(b) for a, b in ev]))

    def turns(self, *fns, cold=True):
        """The ms of each of ``fns`` timed in turns, forward then backward
        (a, b, c, c, b, a): the better of its two rounds. None stays None.
        ``cold``: as for ``ms``."""
        live = [f for f in fns if f is not None]
        a = [self.ms(f, cold=cold) for f in live]
        b = [self.ms(f, cold=cold) for f in reversed(live)][::-1]
        it = iter(min(x, y) for x, y in zip(a, b))
        return [None if f is None else next(it) for f in fns]


def chain_ms(steps_by_name: dict, steps: int = 50, runs: int = 5) -> dict:
    """For each ``name: (step, args)``: ``step`` chained ``steps`` times
    from ``args`` (``args = step(*args)``), ``runs`` times, the names
    taken in turns (forward, then backward, and so on), each step run
    once first: {name: {"step_ms": the median wall time a step by CUDA
    events, "host_ms": the median host time a step spent enqueueing}}."""
    for step, args in steps_by_name.values():
        step(*args)
    wall = {name: [] for name in steps_by_name}
    host = {name: [] for name in steps_by_name}
    names = list(steps_by_name)
    for run in range(runs):
        for name in (names if run % 2 == 0 else names[::-1]):
            step, args = steps_by_name[name]
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            a.record()
            for _ in range(steps):
                args = step(*args)
            host[name].append((time.perf_counter() - t0) * 1e3 / steps)
            b.record()
            torch.cuda.synchronize()
            wall[name].append(a.elapsed_time(b) / steps)
    return {name: {"step_ms": float(np.median(wall[name])),
                   "host_ms": float(np.median(host[name]))}
            for name in names}


# The H100 SXM's data-sheet peaks (NVIDIA): HBM3 bytes/s and the FP64 and
# FP32 rates outside the tensor cores, the denominators of a kernel's bound.
# Complex work is counted in real operations (a complex multiply-add is
# four FMAs, 8 operations) at the rate of its parts' type.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float64: 34e12, torch.float32: 67e12,
              torch.complex128: 34e12, torch.complex64: 67e12}


def bound_ms(nbytes: float, flops: float = 0.0,
             dtype: torch.dtype = torch.float32) -> tuple[float, str]:
    """The least time the card could take for work that moves ``nbytes``
    and does ``flops`` operations in ``dtype``: (ms, "bytes" or
    "operations", whichever bounds it)."""
    tb, to = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype]
    return (max(tb, to) * 1e3, "bytes" if tb >= to else "operations")


def max_rel_err(got: torch.Tensor, want: torch.Tensor) -> tuple[float, float]:
    """(max |got - want|, that over max |want|)."""
    err = float((got.double() - want.double()).abs().max()) \
        if got.numel() else 0.0
    scale = float(want.double().abs().max()) if want.numel() else 0.0
    return err, err / max(scale, 1e-300)
