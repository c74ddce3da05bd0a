"""BENCHMARK.json against the files it names and the contract's shape; the
metric readers' byte counts against hand counts; the trace reduction and
the result line; and the check that nothing here loads JAX or the JAX
package."""

import ast
import json
import os
import re
import sys
import types

import pytest

from pbcore import main, record, spec, trace
from pbcore.env import forbidden_loaded
from pbcore.record import RunRecord
from pbtest_util import cpu_run, small_cell

BENCH = spec.load_benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_every_name_resolves_to_its_file():
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    files = set()
    for c in BENCH["configs"]:
        assert c["file"].startswith("perfbench/configs/")
        assert c["file"] not in files
        files.add(c["file"])
        with open(os.path.join(spec.ROOT, c["file"])) as f:
            assert json.load(f)["name"] == c["name"]
    used = set()
    for w in BENCH["workloads"]:
        cell = spec.Cell(w["name"])
        used.add(w["config"])
        assert hasattr(spec.load_module("loops", cell.traffic["loop"]), "run")
        assert hasattr(spec.load_module("problems", cell.config["kind"]),
                       "matrix")
        names = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in names and len(names) >= 2
        assert cell.per_layer
        for m in cell.per_layer:
            assert m["moves"] in names
            assert callable(spec.load_reader(m["name"]))
        assert main.world_of(cell) in (1, cell.chips) and \
            cell.chips in (1, 4)
    assert used == {c["name"] for c in BENCH["configs"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e


def test_names_units_and_keys_keep_to_the_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in BENCH[group]]
        assert len(set(names)) == len(names)
        for e in BENCH[group]:
            assert NAME.match(e["name"]), e["name"]
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert 1 <= len(c["source"]) <= 200 and 1 <= len(c["why"]) <= 200
        assert all(NAME.match(k) for k in c["reduced"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert len(w["why"]) <= 200
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert re.match(r"^[A-Za-z0-9_/%.-]{1,16}$", m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= 1
    assert os.path.getsize(os.path.join(spec.ROOT, "BENCHMARK.json")) \
        <= 64 * 1024


def _hpcg_104_rank():
    return RunRecord(itemsize=8, nnz_local=29_791_000,
                     rows_local=1_124_864, xcols_local=1_124_864,
                     peak=spec.peaks("NVIDIA H100 80GB HBM3"))


def test_byte_counts_of_hpcg_104():
    spmv = spec.load_reader("spmv_roofline.cg").__globals__["bound_bytes"]
    step = spec.load_reader("step_roofline.cg").__globals__["bound_bytes"]
    rec = _hpcg_104_rank()
    # 238.3 MB of values, x and y 9.0 MB each: 256.3 MB, 76.5 µs
    assert spmv(rec) == 8 * (29_791_000 + 2 * 1_124_864) == 256_325_824
    # values once, x, r and p each read and written: 292.3 MB, 87.3 µs
    assert step(rec) == 8 * (29_791_000 + 6 * 1_124_864) == 292_321_472
    bw = rec.peak["hbm_bytes_per_s"]
    assert round(1e6 * spmv(rec) / bw, 1) == 76.5
    assert round(1e6 * step(rec) / bw, 1) == 87.3


def _event(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


def _synthetic_trace():
    return [
        _event(trace.WINDOW_RANGE, "user_annotation", 100.0, 100.0),
        _event("set", "user_annotation", 100.0, 100.0),
        _event("cudaStreamSynchronize", "cuda_runtime", 150.0, 20.0),
        _event("void dia_vec<double>(double const*)", "kernel", 100.0, 40.0),
        _event("void dia_vec<double>(double const*)", "kernel", 170.0, 20.0),
        _event("ncclDevKernel_SendRecv(x)", "kernel", 130.0, 20.0),
        _event("Memcpy DtoD", "gpu_memcpy", 195.0, 10.0),
        _event("void early<float>()", "kernel", 10.0, 5.0),
    ]


def test_trace_summary_of_a_synthetic_trace():
    s = trace.summarize(_synthetic_trace())
    # busy [100, 150] + [170, 190] + [195, 200] inside the window [100, 200]
    assert s.busy_s == pytest.approx(75e-6)
    assert s.window_s == pytest.approx(100e-6)
    assert s.time_of(("dia_vec",)) == (60.0, 2)
    assert s.time_of(("nccl",)) == (20.0, 1)
    assert s.device_ops[0] == ["dia_vec<double>", pytest.approx(60e-6)]
    assert "early<float>" not in dict(s.device_ops)
    # the gaps: [150, 170] while the host waited in a synchronisation, and
    # [190, 195] inside the set's range only
    assert s.idle_gaps == [["cudaStreamSynchronize", pytest.approx(20e-6)],
                           ["set", pytest.approx(5e-6)]]
    rec = _hpcg_104_rank()
    rec.trace, rec.traced_iterations, rec.world = s, 1, 4
    assert spec.load_reader("device_idle.cg")(rec) == pytest.approx(25.0)
    assert spec.load_reader("comm_ms.cg")(rec) == pytest.approx(0.02)
    with pytest.raises(RuntimeError):
        trace.summarize(_synthetic_trace()[1:])


def test_readers_find_nothing_in_an_empty_run():
    for m in BENCH["per_layer"]:
        assert spec.load_reader(m["name"])(RunRecord()) is None, m["name"]


@pytest.mark.parametrize("world", [1, 4])
def test_set_p95_reads_the_window_where_ranks_exchange(world):
    rec = RunRecord(world=world, latencies_s=[0.1, 0.2, 0.3])
    got = spec.load_reader("set_p95_ms.dist")(rec)
    if world == 1:
        assert got is None
    else:
        assert got == pytest.approx(1e3 * record.p95(rec.latencies_s))
        assert got == pytest.approx(290)


@pytest.mark.parametrize("traced", [False, True])
def test_result_line_keys(traced):
    rec = RunRecord(attempted=3, kind="NVIDIA H100 80GB HBM3",
                    memory_peak_bytes=123, busy_s_mean=0.5,
                    latencies_s=[0.1, 0.2, 0.3], window_s=0.6,
                    rates={"factor_solve_ms": 200.0},
                    checks={"rel_residual": [1e-15, 1e-9]})
    rec.trace = trace.summarize(_synthetic_trace())
    metrics = record.end_to_end(rec)
    units = {k: "x" for k in metrics}
    out = json.loads(record.result_line(rec, metrics, units, traced))
    keys = ["correct", "attempted", "failed", "metrics", "device"]
    assert list(out) == keys + (["breakdown"] if traced else []) + ["checks"]
    assert out["correct"] is True and out["failed"] == 0
    assert out["metrics"]["factor_solve_ms"]["value"] == pytest.approx(200)
    assert out["metrics"]["request_p95_ms"]["value"] == pytest.approx(290)
    dev = {"platform", "kind", "count", "memory_peak_bytes"}
    assert set(out["device"]) == dev | ({"busy_s", "window_s"} if traced
                                        else set())
    assert out["checks"]["rel_residual"] == {"value": 1e-15, "limit": 1e-9}
    if traced:
        assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    rec.checks["rel_residual"][0] = float("nan")
    assert not rec.correct


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_nothing_here_imports_jax_or_the_jax_package():
    bad = {"jax", "jaxlib", "flax", "hpclinalg"}
    for dirpath, _d, files in os.walk(spec.BENCH_DIR):
        for f in files:
            if not f.endswith(".py"):
                continue
            path = os.path.join(dirpath, f)
            tops = {m.split(".")[0] for m in _imports(path)}
            assert not tops & bad, path
            if os.path.basename(dirpath) == "reference":
                # the reference takes nothing of the program or the harness
                assert tops <= {"__future__", "torch", "numpy"}, path


def test_the_run_time_check_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "hpclinalg_torch_like", sys)
    assert forbidden_loaded() == []
    monkeypatch.setitem(sys.modules, "hpclinalg.sparse", sys)
    monkeypatch.setitem(sys.modules, "jaxlib", sys)
    assert forbidden_loaded() == ["hpclinalg", "jaxlib"]


def test_a_cell_whose_loop_gives_no_listed_metric_has_no_result():
    # the end-to-end metrics a loop gives are its own (``rates``): a cell
    # that lists one its loop does not give is refused, not reported short
    cell = spec.Cell("hpcg-104.cg50")
    rec = RunRecord(latencies_s=[0.1], window_s=0.1, attempted=1,
                    rates={"factor_solve_ms": 100.0})
    with pytest.raises(KeyError, match="cg_iter_ms"):
        main.report(cell, rec, False)


def child_loading_jax(*args):
    """A rank > 0 whose process loads a module named ``jax``; the last rank
    only."""
    rank, world = args[5], args[6]
    if rank == world - 1:
        sys.modules["jax"] = types.ModuleType("jax")
    main.child(*args)


@pytest.mark.parametrize("rank", [0, 3])
def test_jax_loaded_on_any_rank_ends_the_run_without_a_record(rank,
                                                              monkeypatch):
    kw = {}
    if rank:
        kw["child_entry"] = child_loading_jax
    else:
        monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    with pytest.raises(RuntimeError,
                       match="exit code" if rank else "rank 0: modules"):
        cpu_run(small_cell("hpcg-104.cg50", 4), **kw)
