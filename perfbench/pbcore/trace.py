"""The traced segment of a ``--trace 1`` run and its reduction.

``Session`` runs ``torch.profiler`` (CPU and CUDA activity) around a fixed
number of requests, marks the segment with a host range, exports the Chrome
trace into ``$TMPDIR``, reads it back and deletes it. ``summarize`` reduces
it to what the per-layer readers and the result line need: every device
operation (kernels, copies, sets) inside the segment, the union of their
intervals (busy), the segment's length (window), the device operations that
took most time, and the idle gaps named by the innermost host range the
host was in at the gap's middle.
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
from dataclasses import dataclass, field

WINDOW_RANGE = "pb.traced_window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")


@dataclass
class TraceSummary:
    ops: list = field(default_factory=list)   # (name, start_us, dur_us)
    busy_s: float = 0.0
    window_s: float = 0.0
    device_ops: list = field(default_factory=list)   # [name, seconds]
    idle_gaps: list = field(default_factory=list)    # [name, seconds]

    def time_of(self, names) -> tuple[float, int]:
        """(µs, count) of the device operations whose name contains one of
        ``names``."""
        t, n = 0.0, 0
        for name, _s, d in self.ops:
            if any(k in name for k in names):
                t += d
                n += 1
        return t, n


def short(name: str) -> str:
    """A kernel's name without its argument list and return type."""
    base = name.split("(")[0]
    return base[5:] if base.startswith("void ") else base


def _union(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1][1] = b
        else:
            out.append([a, b])
    return out


def summarize(events: list) -> TraceSummary:
    """The reduction of a Chrome trace's events (see the module's
    docstring). Raises when the trace holds no traced window."""
    win = [e for e in events if e.get("name") == WINDOW_RANGE
           and e.get("cat") == "user_annotation"]
    if not win:
        raise RuntimeError("trace: the traced window's range is missing")
    w0 = float(win[0]["ts"])
    w1 = w0 + float(win[0]["dur"])
    ops = []
    for e in events:
        if e.get("cat") in DEVICE_CATS and e.get("ph") == "X":
            s, d = float(e["ts"]), float(e["dur"])
            if s + d > w0 and s < w1:
                ops.append((e["name"], s, d))
    busy = _union((max(s, w0), min(s + d, w1)) for _n, s, d in ops)
    busy_us = sum(b - a for a, b in busy)

    by_name = {}
    for name, _s, d in ops:
        k = short(name)
        by_name[k] = by_name.get(k, 0.0) + d
    top_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]

    host = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                   e["name"]) for e in events
                  if e.get("cat") in HOST_CATS and e.get("ph") == "X"
                  and e.get("name") != WINDOW_RANGE)
    starts = [h[0] for h in host]
    gaps = {}
    edges = [w0] + [x for ab in busy for x in ab] + [w1]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        mid = 0.5 * (a + b)
        name = "host outside any traced range"
        i = bisect.bisect_right(starts, mid) - 1
        # the latest-starting range that still covers mid: the innermost
        for j in range(i, max(i - 4000, -1), -1):
            if host[j][1] >= mid:
                name = host[j][2]
                break
        gaps[name] = gaps.get(name, 0.0) + (b - a)
    top_gaps = sorted(gaps.items(), key=lambda kv: -kv[1])[:10]
    return TraceSummary(
        ops=ops, busy_s=busy_us * 1e-6, window_s=(w1 - w0) * 1e-6,
        device_ops=[[n, t * 1e-6] for n, t in top_ops],
        idle_gaps=[[n, t * 1e-6] for n, t in top_gaps])


class Session:
    """``with Session(env) as s: ...`` traces the block on ``env``'s rank;
    afterwards ``s.summary`` is its ``TraceSummary``. The block runs inside
    the window's host range, which opens after every rank's profiler has
    started (a barrier: a profiler's start takes a varying time, which a
    rank's first collective would otherwise wait out inside the window) and
    closes after a device synchronisation."""

    def __init__(self, env):
        self.env = env
        self.summary = None

    def __enter__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if self.env.cuda else [])
        self._prof = profile(activities=acts)
        self._prof.start()
        self.env.barrier()
        self.env.sync()
        self._range = torch.profiler.record_function(WINDOW_RANGE)
        self._range.__enter__()
        return self

    def __exit__(self, *exc):
        self.env.sync()
        self._range.__exit__(None, None, None)
        self._prof.stop()
        if exc[0] is not None:
            return False
        fd, path = tempfile.mkstemp(prefix=f"pb_trace_r{self.env.rank}_",
                                    suffix=".json")
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.remove(path)
        self.summary = summarize(events)
        return False
