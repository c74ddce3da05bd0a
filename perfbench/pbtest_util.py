"""Helpers of the benchmark's tests: a cell cut to a size the CPU holds, and
one run of it through the harness on the CPU (gloo between ranks)."""

import time

from pbcore import main, spec

SMALL = {"local_grid": [8, 8, 8], "grid": 16}


def small_cell(name: str, ranks: int = 1, **config):
    """The cell ``name`` at the small sizes of ``SMALL``, with CG sets of 8
    (a set of 50 on 512 unknowns solves to rounding, where the residual's
    relative error means nothing), on ``ranks`` ranks of a 1 x 1 x ranks
    process grid (the four-card cell's layout; one process a rank), and
    ``config`` overriding its configuration."""
    cell = spec.Cell(name)
    if ranks > 1:
        cell.config["process_grid"] = [1, 1, ranks]
    for k, v in SMALL.items():
        if k in cell.config:
            cell.config[k] = v
    if "iterations_per_set" in cell.traffic:
        cell.traffic["iterations_per_set"] = 8
    cell.config.update(config)
    return cell


def cpu_run(cell, seed=2 ** 33 + 7, seconds=0.3, trace=False, **kw):
    """Rank 0's ``RunRecord`` of one run of ``cell`` on the CPU."""
    return main.run_cell(cell, seed, seconds, trace, time.perf_counter(),
                         device="cpu", transport="gloo", **kw)
