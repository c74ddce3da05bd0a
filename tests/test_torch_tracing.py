"""The port's span recorder (``hpclinalg_torch/utils/profiling.py``) and
the spans and counters at its layers' boundaries, on the CPU.

Off, a span is a shared no-op and nothing is kept; on, each name keeps its
calls, total and self time, and nested spans carry their outermost span's
request id. Counts made inside a ``CapturedStep``'s capture (the stand-in
graph of ``test_torch_entry.standin_graphs``) are held for the graph and
added once a replay while the recorder is on. On a gloo group of two
ranks, ``comm.calls`` and ``comm.bytes`` over CG steps equal what the
SpMV's exchange plan sends plus the three dots' 8 bytes each; the device
solver counts its host reads a request; ``profile_trace`` writes the
region's report beside its trace. The ``card`` case replays a captured CG
step on a NCCL group of one rank (``python -m pytest --noconftest -m card
tests/test_torch_tracing.py`` on a CUDA machine; it skips without one).
"""

import contextlib
import json

import numpy as np
import pytest
import torch

import hpclinalg_torch as ht
from hpclinalg_torch.parallel.launch import run_ranks
from hpclinalg_torch.tools import dist_checks as dc
from hpclinalg_torch.tools.matrices import laplace2d
from hpclinalg_torch.utils import graphs, profiling

torch.set_num_threads(1)

DEADLINE_S = 120


@pytest.fixture(autouse=True)
def recorder_off():
    """Every test starts and ends with the recorder off and empty."""
    profiling.tracing(False)
    profiling.reset_trace()
    yield
    profiling.tracing(False)
    profiling.reset_trace()


class Clock:
    """``time.perf_counter`` for the recorder: each call returns the next
    of ``ticks``."""

    def __init__(self, ticks):
        self.ticks = iter(ticks)

    def perf_counter(self):
        return next(self.ticks)


def test_off_keeps_nothing_and_opens_no_range():
    """Off and with no profiler: one shared no-op context, no aggregate,
    no count. With a profiler on and the recorder off: a profiler range
    named after the span, still no aggregate."""
    a, b = ht.span("plan.spmv"), ht.span("graph.cg_step", "x")
    assert a is b and isinstance(a, contextlib.nullcontext)
    with a:
        profiling.count("comm.calls")
    assert ht.trace_report() == {"spans": {}, "counters": {}}
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with ht.span("solver.solve"):
            torch.ones(3).sum()
    assert "solver.solve" in {e.name for e in prof.events()}
    assert ht.trace_report() == {"spans": {}, "counters": {}}


def test_nesting_gives_self_time_and_request_id(monkeypatch):
    """outer [0, 10] holds a [1, 3] and b [4, 8], and b holds c [5, 6]:
    outer's self time is 10 - 2 - 4, b's 4 - 1. Every span inside an
    outermost one carries its request id; the next outermost span takes
    the next."""
    monkeypatch.setattr(profiling, "time", Clock(
        [0.0, 1.0, 3.0, 4.0, 5.0, 6.0, 8.0, 10.0, 20.0, 21.0]))
    ht.tracing(True)
    with ht.span("outer") as o:
        with ht.span("a") as a:
            pass
        with ht.span("b") as b:
            with ht.span("c") as c:
                pass
    with ht.span("a") as a2:
        pass
    assert {s.request for s in (o, a, b, c)} == {1} and a2.request == 2
    got = ht.trace_report()["spans"]
    assert got == {
        "outer": {"calls": 1, "total_s": 10.0, "self_s": 4.0},
        "a": {"calls": 2, "total_s": 3.0, "self_s": 3.0},
        "b": {"calls": 1, "total_s": 4.0, "self_s": 3.0},
        "c": {"calls": 1, "total_s": 1.0, "self_s": 1.0}}
    ht.tracing(False)
    with ht.span("outer"):
        pass
    assert ht.trace_report()["spans"]["outer"]["calls"] == 1
    profiling.reset_trace()
    assert ht.trace_report() == {"spans": {}, "counters": {}}


def counting_step(monkeypatch, on_at_capture: bool):
    """(step, kernel): a CapturedStep over a stand-in graph whose body
    launches ``kernel`` once and counts "probe" 2 and ("probe.bytes", 8),
    captured with the recorder on or off."""
    from test_torch_entry import standin_graphs

    standin_graphs(monkeypatch)
    monkeypatch.setattr(graphs, "graph_nodes", lambda g: {"kernel": 7,
                                                          "memcpy": 2})

    def kernel(t):
        graphs.count_launch(kernel)
        profiling.count("probe", 2)
        profiling.count("probe.bytes", 8)
        return t * 2

    kernel.launches = 0
    ht.tracing(on_at_capture)
    step = graphs.CapturedStep(kernel, (torch.ones(3),), name="probe_step")
    return step, kernel


def test_counts_in_a_capture_are_held_and_added_per_replay(monkeypatch):
    """Captured with the recorder off: the warm-up's counts are lost (off),
    the capture's are held for the graph, replays while off add nothing,
    and each replay after ``tracing(True)`` adds them once; the wrappers'
    launches count every replay either way."""
    step, kernel = counting_step(monkeypatch, on_at_capture=False)
    assert step.held == {kernel: 1}
    assert step.held_counts == {"probe": 2, "probe.bytes": 8}
    assert graphs._held is None
    for _ in range(2):
        step(torch.ones(3))
    assert ht.trace_report() == {"spans": {}, "counters": {}}
    ht.tracing(True)
    for _ in range(3):
        out = step(torch.ones(3))
    assert torch.equal(out, torch.full((3,), 2.0))
    rep = ht.trace_report()
    assert rep["counters"] == {"probe": 6, "probe.bytes": 24}
    assert rep["spans"]["graph.probe_step"]["calls"] == 3
    assert rep["spans"]["graph.probe_step.launch"]["calls"] == 3
    assert kernel.launches == 1 + 5


def test_capture_with_the_recorder_on(monkeypatch):
    """Captured with the recorder on: the warm-up's counts count at once
    (it ran), the capture's are held, ``graph.capture`` is one span and
    ``graph.<name>.nodes`` the graph's node count, added once."""
    step, _ = counting_step(monkeypatch, on_at_capture=True)
    rep = ht.trace_report()
    assert rep["counters"] == {"probe": 2, "probe.bytes": 8,
                               "graph.probe_step.nodes": 9}
    assert rep["spans"]["graph.capture"]["calls"] == 1
    step(torch.ones(3))
    assert ht.trace_report()["counters"] == {
        "probe": 4, "probe.bytes": 16, "graph.probe_step.nodes": 9}


@pytest.fixture(scope="module")
def two_ranks():
    return run_ranks("hpclinalg_torch.tools.dist_checks:on_rank", 2,
                     backend="gloo", device="cpu", deadline_s=DEADLINE_S,
                     args=("comm_counts", {"steps": 5}))


def test_comm_counters_equal_the_plans_splits(two_ranks):
    """Each CG step on a gloo world of two ranks hands the transport one
    ``all_to_all_single`` of the exchange's sent splits, one 16-byte
    ``all_reduce`` of p·Ap and r·r and one 8-byte ``all_reduce`` of the
    new r·r, on every rank; stacked, no collective runs."""
    for r in two_ranks:
        sent = int(r["counts.sent_bytes"])
        assert bool(r["counts.crosses"]) and sent == 8
        assert int(r["counts.comm.calls"]) == 5 * 3
        assert int(r["counts.comm.bytes"]) == 5 * (sent + 16 + 8)
    stacked = dc.comm_counts(ht.backend_auto(2, device="cpu"))
    assert int(stacked["counts.comm.calls"]) == 0
    assert int(stacked["counts.comm.bytes"]) == 0


def test_device_solver_spans_and_host_reads():
    """The device Cholesky on the CPU: the analysis phases once, at
    ``ldlt``; then each refactorize + solve request reads the host three
    times (the factor's counts, ‖b‖, one ‖r‖) under its two spans."""
    be = ht.backend_auto(2, device="cpu")
    A = ht.DistSparseMatrix.from_scipy(laplace2d(12), be)
    ht.clear_plan_cache("device_mf")
    ht.tracing(True)
    F = ht.ldlt(A, method="device", spd=True)
    first = ht.trace_report()
    assert {k: first["spans"][k]["calls"] for k in
            ("solver.order", "solver.symbolic", "solver.schedule")} == \
        {"solver.order": 1, "solver.symbolic": 1, "solver.schedule": 1}
    assert first["counters"] == {"solver.host_reads": 1}
    profiling.reset_trace()
    b = ht.DistVector.from_global(np.ones(144), be)
    for _ in range(4):
        F.refactorize(A)
        x = F.solve(b)
    rep = ht.trace_report()
    assert rep["counters"]["solver.host_reads"] == 4 * 3
    assert rep["spans"]["solver.refactorize"]["calls"] == 4
    assert rep["spans"]["solver.solve"]["calls"] == 4
    assert "solver.order" not in rep["spans"]
    np.testing.assert_allclose(laplace2d(12) @ x.to_numpy(), np.ones(144),
                               atol=1e-10)


def test_graphed_device_solver_spans(monkeypatch):
    """On the graphed path (stand-in graphs), ``refactorize`` replays the
    ``solver_factor`` graph and ``solve`` the ``solver_solve`` graph, each
    under its own spans, and the captures count their nodes."""
    from test_torch_entry import standin_graphs

    standin_graphs(monkeypatch)
    monkeypatch.setattr(graphs, "graph_nodes", lambda g: {"kernel": 11})
    be = ht.backend_auto(1, device="cpu")
    A = ht.DistSparseMatrix.from_scipy(laplace2d(10), be)
    ht.tracing(True)
    F = ht.ldlt(A, method="device", spd=True)
    assert F.refusal is None
    b = ht.DistVector.from_global(np.ones(100), be)
    F.solve(b)
    profiling.reset_trace()
    for _ in range(3):
        F.refactorize(A)
        F.solve(b)
    spans = ht.trace_report()["spans"]
    assert spans["graph.solver_factor"]["calls"] == 3
    assert spans["graph.solver_factor.launch"]["calls"] == 3
    # a solve replays its graph once, and once more a refinement sweep
    assert spans["graph.solver_solve"]["calls"] == \
        spans["graph.solver_solve.launch"]["calls"] >= 3
    assert spans["graph.solver_factor"]["total_s"] <= \
        spans["solver.refactorize"]["total_s"]


def test_graph_capture_counts_nodes(monkeypatch):
    """``entry.capture`` names its graph ``cg_step``: the capture's span
    and node counter, then a call's span and its launch span; the CPU
    step's own counter ``cg.plain_steps`` counts the capture's warm-up
    call and the one replay (held through the record)."""
    from test_torch_entry import standin_graphs

    standin_graphs(monkeypatch)
    monkeypatch.setattr(graphs, "graph_nodes", lambda g: {"kernel": 5})
    from hpclinalg_torch import entry as te

    fn, args = te.entry(device="cpu")
    ht.tracing(True)
    step = te.capture(fn, args)
    step(*args)
    rep = ht.trace_report()
    assert rep["counters"] == {"graph.cg_step.nodes": 5, "cg.plain_steps": 2}
    assert {k: rep["spans"][k]["calls"] for k in
            ("graph.capture", "graph.cg_step", "graph.cg_step.launch")} == \
        {"graph.capture": 1, "graph.cg_step": 1, "graph.cg_step.launch": 1}


def test_plan_build_spans():
    """A CG step's plan build: the exchange, the SpMV plan and the engine's
    value tables, each once; a second step function on the same matrix
    builds no plan, and its value tables are cached on the matrix."""
    from hpclinalg_torch.entry import cg_step_fn

    be = ht.backend_auto(2, device="cpu")
    A = ht.DistSparseMatrix.from_scipy(laplace2d(9), be)
    ht.clear_plan_cache("vector_plan")
    ht.tracing(True)
    cg_step_fn(A, be)
    spans = ht.trace_report()["spans"]
    assert {k: spans[k]["calls"] for k in
            ("plan.exchange", "plan.spmv", "plan.values")} == \
        {"plan.exchange": 1, "plan.spmv": 1, "plan.values": 1}
    assert spans["plan.values"]["self_s"] <= spans["plan.values"]["total_s"]
    cg_step_fn(A, be)
    spans = ht.trace_report()["spans"]
    assert spans["plan.spmv"]["calls"] == 1
    assert spans["plan.values"]["calls"] == 2


def test_profile_trace_writes_the_regions_spans(tmp_path, capsys):
    """``profile_trace`` turns the recorder on for its region only (what it
    recorded stays) and writes ``spans.json`` beside ``trace.json``: the
    region's spans and counters and the plans built inside; the trace
    names the spans."""
    be = ht.backend_auto(2, device="cpu")
    A = ht.DistSparseMatrix.from_scipy(laplace2d(8), be)
    x = ht.DistVector.from_global(np.ones(64), be)
    ht.clear_plan_cache("vector_plan")
    with ht.span("before"):
        pass
    with ht.profile_trace(str(tmp_path), backend=be):
        with ht.annotate("region"):
            A @ x
    assert not profiling._on
    with open(tmp_path / "spans.json") as f:
        got = json.load(f)
    assert set(got) == {"spans", "counters", "plans_built"}
    assert {"region", "plan.exchange", "plan.spmv"} <= set(got["spans"])
    assert got["spans"]["region"]["calls"] == 1
    assert got["plans_built"] == {"vector_plan": 1}
    with open(tmp_path / "trace.json") as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"region", "plan.spmv"} <= names
    assert "plans built during trace" in capsys.readouterr().out
    assert ht.trace_report()["spans"]["region"]["calls"] == 1


def test_profile_trace_reports_only_its_region(tmp_path):
    """With the recorder already on, the span file holds the region's
    difference, and the recorder stays on with everything it held."""
    be = ht.backend_auto(1, device="cpu")
    ht.tracing(True)
    with ht.span("outside"):
        profiling.count("n", 3)
    with ht.profile_trace(str(tmp_path), backend=be):
        with ht.span("outside"):
            profiling.count("n", 2)
    with open(tmp_path / "spans.json") as f:
        got = json.load(f)
    assert got["spans"]["outside"]["calls"] == 1
    assert got["counters"] == {"n": 2}
    assert profiling._on
    assert ht.trace_report()["counters"] == {"n": 5}
    assert ht.trace_report()["spans"]["outside"]["calls"] == 2


@pytest.mark.card
def test_captured_cg_step_counters_on_the_card():
    """A NCCL group of one rank on the card: the CG step on the 1-D
    Laplacian captured with the recorder on (``graph.cg_step.nodes`` is
    ``graph_nodes`` of the graph), then 20 replays: each a
    ``graph.cg_step`` span around one launch span, a 16-byte ``all_reduce``
    of p·Ap and r·r and an 8-byte one of the new r·r (one rank: the
    exchange crosses no rank)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    (r,) = run_ranks("hpclinalg_torch.tools.dist_checks:on_rank", 1,
                     backend="nccl", device="cuda", deadline_s=DEADLINE_S,
                     args=("comm_counts", {"steps": 20, "graphed": True}))
    assert int(r["counts.counted_nodes"]) == int(r["counts.nodes"]) > 0
    assert not bool(r["counts.crosses"])
    assert int(r["counts.comm.calls"]) == 20 * 2
    assert int(r["counts.comm.bytes"]) == 20 * (16 + 8)
    assert int(r["counts.spans.graph.cg_step"]) == 20
    assert int(r["counts.spans.graph.cg_step.launch"]) == 20
