"""Profiling hooks and the port's span recorder.

Port of the JAX package's ``hpclinalg/utils/profiling.py`` on
``torch.profiler``: a trace context that also reports which plans were
built inside it, and named regions for the timeline. Beside them, one
recorder for the process, off by default:

* ``span(name, args=None)`` is the one way the port opens a host range.
  With the recorder off and no profiler running it returns a shared no-op
  context. With the recorder on it keeps, per name, the calls, the total
  time and the self time (the total less the time its child spans cover).
  An outermost span takes the next request id, and every span inside it
  carries that id (``.request``). Whenever a ``torch.profiler`` session
  is on, a span is also a ``record_function`` range, so a Chrome trace
  names the host's time after the program's spans, on the clock of the
  kernels they launched.
* ``count(name, n=1)`` adds to a named counter while the recorder is on.
  Inside a ``utils/graphs.CapturedStep``'s capture, where nothing runs,
  the count is held for the graph (on or off), and each replay adds it
  while the recorder is on.
* ``tracing(on)`` switches the recorder, ``trace_report()`` returns what
  it holds, ``reset_trace()`` clears it.

The span and counter names the port records are listed in README's
profiling section.
"""

from __future__ import annotations

import contextlib
import json
import os
import time

import torch
from torch.autograd import _profiler_enabled
from torch.profiler import record_function

from ..cache import cache_sizes
from . import graphs

_on = False
_spans = {}       # name -> [calls, total_s, self_s]
_counters = {}    # name -> int
_stack = []       # the open spans of the recorder, innermost last
_requests = 0     # outermost spans opened since the last reset
_NOOP = contextlib.nullcontext()


def tracing(on: bool) -> None:
    """Switches the recorder on or off; what it holds stays."""
    global _on
    _on = bool(on)


def reset_trace() -> None:
    """Clears the recorder's spans, counters and request ids."""
    global _requests
    _spans.clear()
    _counters.clear()
    _requests = 0


def trace_report() -> dict:
    """``{"spans": {name: {"calls", "total_s", "self_s"}}, "counters":
    {name: int}}``: what the recorder holds."""
    return {"spans": {k: {"calls": c, "total_s": t, "self_s": s}
                      for k, (c, t, s) in _spans.items()},
            "counters": dict(_counters)}


class _Span:
    """A span while the recorder is on (``span``)."""

    __slots__ = ("name", "args", "request", "_t0", "_child", "_range")

    def __init__(self, name: str, args):
        self.name, self.args = name, args

    def __enter__(self):
        global _requests
        if _stack:
            self.request = _stack[-1].request
        else:
            _requests += 1
            self.request = _requests
        self._child = 0.0
        self._range = None
        if _profiler_enabled():
            tag = f"request={self.request}"
            self._range = record_function(
                self.name, tag if self.args is None else f"{self.args}; {tag}")
            self._range.__enter__()
        _stack.append(self)
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self._t0
        _stack.pop()
        if self._range is not None:
            self._range.__exit__(*exc)
        if _stack:
            _stack[-1]._child += dt
        agg = _spans.get(self.name)
        if agg is None:
            agg = _spans[self.name] = [0, 0.0, 0.0]
        agg[0] += 1
        agg[1] += dt
        agg[2] += dt - self._child
        return False


def span(name: str, args: str | None = None):
    """A host range named ``name`` (see the module's docstring): a no-op
    with the recorder off and no profiler on; a ``torch.profiler`` range
    while a profiler is on; recorded while the recorder is on."""
    if _on:
        return _Span(name, args)
    if _profiler_enabled():
        return record_function(name, args)
    return _NOOP


annotate = span


def active() -> bool:
    """Whether a span does anything: the recorder or a profiler is on (a
    caller that opens several spans checks once)."""
    return _on or _profiler_enabled()


def count(name: str, n: int = 1) -> None:
    """``n`` more on the counter ``name``: held for the graph during a
    ``CapturedStep``'s capture, else added while the recorder is on."""
    held = graphs._held
    if held is not None:
        held[name] = held.get(name, 0) + n
    elif _on:
        _counters[name] = _counters.get(name, 0) + n


def add_counts(counts: dict) -> None:
    """A replay's held counts (``CapturedStep.held_counts``), added while
    the recorder is on."""
    if _on:
        for name, n in counts.items():
            _counters[name] = _counters.get(name, 0) + n


def trace_path(log_dir: str, backend=None, stem: str = "trace") -> str:
    """The file ``profile_trace`` writes: ``log_dir/trace.json``, or
    ``log_dir/trace.rank<r>.json`` on rank r of a process group (the
    backend's, or without a backend the default group when one is up), so
    the ranks never write one file; ``stem`` "spans" names the recorder's
    file beside it."""
    if backend is not None:
        rank = backend.rank if backend.is_dist else None
    else:
        import torch.distributed as dist

        rank = dist.get_rank() if dist.is_available() \
            and dist.is_initialized() else None
    name = f"{stem}.json" if rank is None else f"{stem}.rank{rank}.json"
    return os.path.join(log_dir, name)


def _difference(before: dict, after: dict) -> dict:
    """What the recorder gained between two ``trace_report`` readings."""
    spans = {}
    for k, a in after["spans"].items():
        b = before["spans"].get(k, {"calls": 0, "total_s": 0.0,
                                    "self_s": 0.0})
        if a["calls"] != b["calls"]:
            spans[k] = {f: a[f] - b[f] for f in a}
    counters = {k: v - before["counters"].get(k, 0)
                for k, v in after["counters"].items()
                if v != before["counters"].get(k, 0)}
    return {"spans": spans, "counters": counters}


@contextlib.contextmanager
def profile_trace(log_dir: str, backend=None):
    """Trace the region with ``torch.profiler`` (CPU activity, and CUDA
    activity when ``backend`` is on the card, or with no backend when a
    CUDA device is present) and the recorder on, write the trace to
    ``trace_path(log_dir, backend)`` (Chrome trace format) and, beside it
    (``stem="spans"``), the region's ``trace_report()`` and the plan-cache
    entries built inside (``{"spans", "counters", "plans_built"}``), and
    print those entries. The recorder is switched back off after, unless
    it was on; what it recorded stays."""
    from torch.profiler import ProfilerActivity, profile

    cuda = (backend.device.type == "cuda" if backend is not None
            else torch.cuda.is_available())
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    before, report0, was_on = cache_sizes(), trace_report(), _on
    prof = profile(activities=acts)
    prof.start()
    tracing(True)
    try:
        yield
    finally:
        tracing(was_on)
        if cuda:
            torch.cuda.synchronize()
        prof.stop()
        os.makedirs(log_dir, exist_ok=True)
        prof.export_chrome_trace(trace_path(log_dir, backend))
        after = cache_sizes()
        delta = {k: after.get(k, 0) - before.get(k, 0)
                 for k in set(before) | set(after)
                 if after.get(k, 0) != before.get(k, 0)}
        with open(trace_path(log_dir, backend, "spans"), "w") as f:
            json.dump({**_difference(report0, trace_report()),
                       "plans_built": delta}, f, indent=1)
        if delta:
            print(f"[hpclinalg_torch] plans built during trace: {delta}")
