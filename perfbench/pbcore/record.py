"""What a run collected (``RunRecord``, on rank 0) and the result line made
from it.

The per-layer readers (``metrics/<name>.py``) read a ``RunRecord``:

* ``itemsize``: bytes of one value in the configuration's dtype;
* ``plan_build_s``: host seconds of the program's plan builds (rank 0);
* ``attempted``, ``iterations``: requests (all of them complete: the
  loop is closed) and CG iterations in the measured window;
* ``rates``: the loop's own end-to-end metrics over its window, by name
  (``cg_iter_ms``, ``factor_solve_ms``); every loop has ``setup_s`` and
  ``request_p95_ms`` besides;
* ``trace``: the traced segment's ``trace.TraceSummary`` (rank 0), with
  ``traced_iterations`` done inside it;
* ``rows_local``, ``nnz_local``, ``xcols_local``: rank 0's rows, stored
  entries, and distinct columns its rows read (the CG loop, trace runs);
* ``refactor_ms``, ``solve_ms``: per request, CUDA events (the direct loop);
* ``peak``: the device's published peaks (``peaks.json``), or None.
"""

from __future__ import annotations

import json
import statistics
import sys
from dataclasses import dataclass, field


@dataclass
class RunRecord:
    itemsize: int = 8
    world: int = 1
    setup_s: float = 0.0
    setup_split: dict = field(default_factory=dict)
    plan_build_s: float | None = None
    latencies_s: list = field(default_factory=list)
    window_s: float = 0.0
    iterations: int = 0
    rates: dict = field(default_factory=dict)      # name -> value
    attempted: int = 0
    failed: int = 0
    checks: dict = field(default_factory=dict)     # name -> [value, limit]
    memory_peak_bytes: int = 0
    kind: str = ""
    peak: dict | None = None
    trace: object = None
    busy_s_mean: float | None = None
    traced_iterations: int = 0
    rows_local: int | None = None
    nnz_local: int | None = None
    xcols_local: int | None = None
    refactor_ms: list = field(default_factory=list)
    solve_ms: list = field(default_factory=list)
    notes: dict = field(default_factory=dict)      # printed before the result

    @property
    def correct(self) -> bool:
        return self.failed == 0 and all(v <= lim for v, lim in
                                        self.checks.values())


def worse(a: float, b: float) -> float:
    """The worse of two readings of a number held below a limit; a NaN is
    worst."""
    if a != a or b != b:
        return float("nan")
    return max(a, b)


def cache_sizes() -> dict:
    """The program's plan caches' entry counts."""
    from hpclinalg_torch.cache import cache_sizes as sizes

    return sizes()


def delta(before: dict, after: dict) -> dict:
    """The entries built between two ``cache_sizes`` readings."""
    return {k: after.get(k, 0) - before.get(k, 0)
            for k in set(before) | set(after)
            if after.get(k, 0) != before.get(k, 0)}


def free_program_state(env):
    """Drops the program's plan caches and returns their device memory, so
    the reference runs on a freed device."""
    import torch
    from hpclinalg_torch.cache import clear_plan_cache

    clear_plan_cache()
    if env.cuda:
        torch.cuda.empty_cache()


def p95(values) -> float:
    """The 95th percentile of all values (``statistics.quantiles``,
    inclusive); the value itself for a single one."""
    if len(values) == 1:
        return values[0]
    return statistics.quantiles(values, n=100, method="inclusive")[94]


def end_to_end(rec: RunRecord) -> dict:
    """Every end-to-end metric a run gives, by name: the set-up time, the
    p95 over all the window's requests, and the loop's own ``rates``."""
    return {"setup_s": rec.setup_s,
            "request_p95_ms": 1e3 * p95(rec.latencies_s), **rec.rates}


def result_line(rec: RunRecord, metrics: dict, units: dict,
                trace: bool) -> str:
    device = {"platform": "gpu", "kind": rec.kind, "count": rec.world,
              "memory_peak_bytes": int(rec.memory_peak_bytes)}
    out = {"correct": rec.correct, "attempted": rec.attempted,
           "failed": rec.failed,
           "metrics": {k: {"value": v, "unit": units[k]}
                       for k, v in metrics.items()},
           "device": device}
    if trace and rec.trace is not None:
        device["busy_s"] = rec.busy_s_mean
        device["window_s"] = rec.trace.window_s
        out["breakdown"] = {"device_ops": rec.trace.device_ops,
                            "idle_gaps": rec.trace.idle_gaps}
    out["checks"] = {k: {"value": v, "limit": lim}
                     for k, (v, lim) in rec.checks.items()}
    return json.dumps(out)


def print_checks(rec: RunRecord):
    for k, (v, lim) in rec.checks.items():
        print(f"check {k} {v!r} limit {lim!r}", file=sys.stderr)
