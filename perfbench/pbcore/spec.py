"""The benchmark's specification: ``BENCHMARK.json`` at the checkout's root,
and the files it names. A cell (an entry of ``workloads``) is found by its
name; its configuration by the ``file`` its entry gives; its traffic mix as
``traffic/<traffic>.json``, and the loop that mix names as
``loops/<loop>.py``; the configuration's kind as ``problems/<kind>.py``;
each per-layer metric as ``metrics/<name>.py``. Adding a cell, a
configuration, a kind, a mix, a loop or a metric adds files and entries
and edits none."""

from __future__ import annotations

import importlib.util
import json
import os
import sys

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


def load_benchmark(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def _by_name(entries, name, what):
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


class Cell:
    """One workload of the benchmark with everything it names: ``workload``
    (its entry), ``config`` and ``traffic`` (their files' contents),
    ``end_to_end`` and ``per_layer`` (the metric entries that apply to it)."""

    def __init__(self, name: str, bench: dict | None = None,
                 root: str = ROOT):
        bench = load_benchmark(root) if bench is None else bench
        self.workload = _by_name(bench["workloads"], name, "workload")
        self.name = name
        self.chips = int(self.workload["chips"])
        entry = _by_name(bench["configs"], self.workload["config"], "config")
        with open(os.path.join(root, entry["file"])) as f:
            self.config = json.load(f)
        with open(os.path.join(BENCH_DIR, "traffic",
                               self.workload["traffic"] + ".json")) as f:
            self.traffic = json.load(f)

        def applies(m):
            return name in m.get("workloads", [name])

        self.end_to_end = [m for m in bench["end_to_end"] if applies(m)]
        self.per_layer = [m for m in bench["per_layer"] if applies(m)]


def load_module(folder: str, name: str):
    """The module ``<folder>/<name>.py`` beside this package: a traffic
    loop (``loops/``), a configuration kind (``problems/``) or a per-layer
    metric's reader (``metrics/``)."""
    key = f"pb_{folder}_" + name.replace(".", "_").replace("-", "_")
    mod = sys.modules.get(key)
    if mod is None:
        spec = importlib.util.spec_from_file_location(
            key, os.path.join(BENCH_DIR, folder, name + ".py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        sys.modules[key] = mod
    return mod


def load_reader(name: str):
    """The ``read(run)`` function of ``metrics/<name>.py``."""
    return load_module("metrics", name).read


def peaks(kind: str) -> dict | None:
    """The published peaks of the device named ``kind``
    (``torch.cuda.get_device_name()``), or None for a device the table does
    not hold."""
    with open(os.path.join(BENCH_DIR, "peaks.json")) as f:
        return json.load(f)["devices"].get(kind)
