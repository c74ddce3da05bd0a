"""Kernel timing on the card, shared by the probe tools and chip_smoke.py.

Nothing here runs at import time; every function needs a CUDA device.
"""

from __future__ import annotations

import subprocess

import numpy as np
import torch


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


class Timer:
    """Median kernel time over 20 launches, CUDA events around each launch,
    a 256 MiB read before each so L2 (50 MB) starts cold. (A write would
    leave dirty lines whose write-back lands inside the timed launch.)"""

    def __init__(self, dev):
        self.flush = torch.ones(64 << 20, dtype=torch.float32, device=dev)

    def ms(self, fn, reps=20, warm=3):
        for _ in range(warm):
            fn()
        out = []
        for _ in range(reps):
            self.flush.sum()
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            torch.cuda.synchronize()
            out.append(a.elapsed_time(b))
        return float(np.median(out))


def max_rel_err(got: torch.Tensor, want: torch.Tensor) -> tuple[float, float]:
    """(max |got - want|, that over max |want|)."""
    err = float((got.double() - want.double()).abs().max()) \
        if got.numel() else 0.0
    scale = float(want.double().abs().max()) if want.numel() else 0.0
    return err, err / max(scale, 1e-300)
