"""One run of one cell: ``run.py``'s body.

A cell whose configuration names more than one rank (``process_grid``) runs
one process a card: this process is rank 0 and spawns ranks 1..world-1
(``multiprocessing`` with ``spawn``), each of which joins the process group
over ``tcp://localhost:<free port>``, as a launcher's ranks would. Every rank
runs the same loop, and each looks in its own ``sys.modules`` for JAX or
the JAX package once its window has closed; rank 0 prints the result.
"""

from __future__ import annotations

import argparse
import multiprocessing as mp
import sys
import time

from . import spec
from .env import Env, forbidden_loaded, free_port
from .record import end_to_end, print_checks, result_line

def world_of(cell) -> int:
    w = 1
    for d in cell.config.get("process_grid", [1]):
        w *= int(d)
    return w


def rank_body(cell, seed, seconds, trace, t0, device, rank, world, port,
              transport):
    """The loop of ``cell``'s traffic on one rank; rank 0's ``RunRecord``
    (None on the others). Raises, after leaving the process group, if this
    rank's process holds a module of JAX or of the JAX package."""
    env = Env(device, rank, world, transport, port)
    loop = spec.load_module("loops", cell.traffic["loop"])
    try:
        out = loop.run(env, cell, seed, seconds, trace, t0)
    except BaseException:
        env.close(wait=False)
        raise
    env.close()
    bad = forbidden_loaded()
    if bad:
        raise RuntimeError(f"rank {rank}: modules of JAX or of the JAX "
                           f"package were loaded: {bad}")
    return out


def child(cell, seed, seconds, trace, device, rank, world, port, transport):
    """Rank ``rank`` > 0, in a process of its own."""
    rank_body(cell, seed, seconds, trace, time.perf_counter(), device, rank,
              world, port, transport)


def run_cell(cell, seed: int, seconds: float, trace: bool, t0: float,
             device: str = "cuda", transport: str = "nccl",
             child_entry=child):
    """Rank 0's ``RunRecord`` of one run of ``cell``; the other ranks (if
    any) run ``child_entry`` in processes of their own, each waited for (a
    minute past rank 0's end) and stopped. A rank that fails or hangs ends
    the others' collectives within the group's timeout."""
    world = world_of(cell)
    procs = []
    port = free_port() if world > 1 else None
    try:
        ctx = mp.get_context("spawn")
        for r in range(1, world):
            p = ctx.Process(target=child_entry, args=(
                cell, seed, seconds, trace, device, r, world, port,
                transport))
            p.start()
            procs.append(p)
        rec = rank_body(cell, seed, seconds, trace, t0, device, 0, world,
                        port, transport)
        end = time.monotonic() + 60
        for p in procs:
            p.join(timeout=max(1.0, end - time.monotonic()))
            if p.exitcode != 0:
                raise RuntimeError(f"rank {procs.index(p) + 1} ended with "
                                   f"exit code {p.exitcode}")
        return rec
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join(timeout=10)


def report(cell, rec, trace: bool) -> str:
    """The result line: the cell's end-to-end metrics (``--trace 0``) or
    its per-layer metrics that found something to read (``--trace 1``)."""
    if trace:
        metrics, units = {}, {}
        for m in cell.per_layer:
            v = spec.load_reader(m["name"])(rec)
            if v is not None:
                metrics[m["name"]], units[m["name"]] = float(v), m["unit"]
    else:
        have = end_to_end(rec)
        missing = [m["name"] for m in cell.end_to_end
                   if m["name"] not in have]
        if missing:
            raise KeyError(f"the {cell.traffic['loop']} loop gives no "
                           f"{missing}")
        metrics = {m["name"]: have[m["name"]] for m in cell.end_to_end}
        units = {m["name"]: m["unit"] for m in cell.end_to_end}
    return result_line(rec, metrics, units, trace)


def parse(argv):
    ap = argparse.ArgumentParser(prog="perfbench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv, t0: float) -> int:
    import torch

    args = parse(argv)
    cell = spec.Cell(args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"perfbench: {cell.name} needs {cell.chips} CUDA device(s), "
              f"found {have}", file=sys.stderr)
        return 2
    rec = run_cell(cell, args.seed, args.seconds, bool(args.trace), t0)
    bad = forbidden_loaded()
    if bad:
        print(f"perfbench: modules of JAX or of the JAX package were "
              f"loaded: {bad}", file=sys.stderr)
        return 3
    rec.kind = torch.cuda.get_device_name(0)
    rec.peak = spec.peaks(rec.kind)
    line = report(cell, rec, bool(args.trace))
    print("setup split:", {k: round(v, 4) for k, v in
                           rec.setup_split.items()}, flush=True)
    print("notes:", rec.notes, flush=True)
    print_checks(rec)
    print(line, flush=True)
    return 0
