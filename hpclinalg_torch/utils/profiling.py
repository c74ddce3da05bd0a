"""Profiling hooks.

Port of the JAX package's ``hpclinalg/utils/profiling.py`` on
``torch.profiler``: a trace context that also reports which plans were
built inside it, and named regions for the timeline.
"""

from __future__ import annotations

import contextlib
import os

from ..cache import cache_sizes


def trace_path(log_dir: str, backend=None) -> str:
    """The file ``profile_trace`` writes: ``log_dir/trace.json``, or
    ``log_dir/trace.rank<r>.json`` on rank r of a process group (the
    backend's, or without a backend the default group when one is up), so
    the ranks never write one file."""
    if backend is not None:
        rank = backend.rank if backend.is_dist else None
    else:
        import torch.distributed as dist

        rank = dist.get_rank() if dist.is_available() \
            and dist.is_initialized() else None
    name = "trace.json" if rank is None else f"trace.rank{rank}.json"
    return os.path.join(log_dir, name)


@contextlib.contextmanager
def profile_trace(log_dir: str, backend=None):
    """Trace the region with ``torch.profiler`` (CPU activity, and CUDA
    activity when ``backend`` is on the card, or with no backend when a
    CUDA device is present), write it to ``trace_path(log_dir, backend)``
    (Chrome trace format) and print the plan-cache entries built inside."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    cuda = (backend.device.type == "cuda" if backend is not None
            else torch.cuda.is_available())
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    before = cache_sizes()
    prof = profile(activities=acts)
    prof.start()
    try:
        yield
    finally:
        if cuda:
            torch.cuda.synchronize()
        prof.stop()
        os.makedirs(log_dir, exist_ok=True)
        prof.export_chrome_trace(trace_path(log_dir, backend))
        after = cache_sizes()
        delta = {k: after.get(k, 0) - before.get(k, 0)
                 for k in set(before) | set(after)
                 if after.get(k, 0) != before.get(k, 0)}
        if delta:
            print(f"[hpclinalg_torch] plans built during trace: {delta}")


def annotate(name: str):
    """A named region on the profiler's timeline."""
    from torch.profiler import record_function

    return record_function(name)
