"""CUDA graphs: the port's counterpart of ``jax.jit`` for work whose shapes
are fixed.

The JAX package compiles its CG step (``__graft_entry__``) and its device
solver's factor, inversion and solve (``hpclinalg/solver/device_mf.py``
``_factor_jit``, ``_prep_jit``, ``_solve_jit``) into one program each. The
port records the same work once as a ``torch.cuda.CUDAGraph`` over static
input tensors and replays it: ``CapturedStep``. ``entry.capture`` (the CG
step) and ``solver.device_mf.DeviceFactorization`` (the factor and its
solves) both build on it, with the checks here.

A graph holds only CUDA work, and collectives only over NCCL: gloo stages
CUDA tensors through the host, which a graph cannot hold. ``refusal``
says why a piece of work cannot be captured; its callers either raise
it (``entry.capture``) or run the work eagerly where that is their
documented behaviour (``DeviceFactorization``). A capture that fails
raises RuntimeError: nothing here runs the work eagerly in a graph's
place. The kernels' wrappers count their launches through
``count_launch``, and the port's named counters go through
``profiling.count``: a launch or a count recorded into a graph is held
(``_held``) and counts once for each replay, not at the capture. A
``CapturedStep`` named ``<name>`` records the spans ``graph.<name>``
(a call) and ``graph.<name>.launch`` (its replay), ``graph.capture``, and
the counter ``graph.<name>.nodes`` (``utils/profiling.py``).
"""

from __future__ import annotations

import ctypes
import time

import torch

from . import profiling


def _device_refusal(tensors) -> str | None:
    """Why ``tensors`` cannot feed a CUDA graph (not CUDA tensors, or on
    several devices), or None."""
    if not tensors or any(not isinstance(t, torch.Tensor)
                          or t.device.type != "cuda" for t in tensors):
        got = [str(getattr(t, "device", type(t).__name__)) for t in tensors]
        return (f"capture: a CUDA graph takes CUDA tensors, got {got}; on "
                "the CPU call the step itself (eager)")
    if any(t.device != tensors[0].device for t in tensors):
        return "capture: the arguments lie on several devices"
    return None


def refusal(backend, tensors) -> str | None:
    """Why work over ``tensors`` on ``backend`` (None: no backend) cannot
    be captured as a CUDA graph, or None when it can: a process group that
    is not NCCL, or tensors that are not on one CUDA device."""
    if backend is not None and backend.is_dist:
        import torch.distributed as dist

        transport = str(dist.get_backend(backend.group))
        if transport != "nccl":
            return (f"capture: the step's process group runs over "
                    f"{transport}, which stages CUDA tensors through the "
                    "host and cannot be captured in a CUDA graph; call the "
                    "step itself (eager) on such a group, or use NCCL")
    return _device_refusal(tuple(tensors))


def warm_up(fn, device):
    """``fn()`` called once on a side stream, the device drained after:
    the one-time work a capture cannot hold happens at a first call (a
    library loads, a handle or workspace is made, a kernel's shared-memory
    opt-in or an exchange's index table is built, a NCCL communicator
    starts), so one call is needed before ``record`` and one is enough.
    Returns its result."""
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        out = fn()
    torch.cuda.current_stream(device).wait_stream(side)
    torch.cuda.synchronize(device)
    return out


# {wrapper: launches of its kernel, or counter name: its count, recorded
# into the graph that is being captured}, None outside a capture
# (``count_launch``, ``profiling.count``, ``CapturedStep``)
_held = None


def count_launch(wrapper):
    """One launch of ``wrapper``'s kernel, on its ``launches`` counter:
    counted at once when the kernel runs. Under a ``CapturedStep``'s
    capture, where the launch is recorded and nothing runs, it is held for
    the graph instead, and each replay of the graph adds it: the counter
    stays the number of times the kernel ran."""
    if _held is None:
        wrapper.launches += 1
    else:
        _held[wrapper] = _held.get(wrapper, 0) + 1


def record(fn, device):
    """``fn()`` captured as a CUDA graph on ``device`` with a memory pool of
    its own, then instantiated: (graph, what ``fn`` returned, {"capture_s",
    "instantiate_s"}). The returned tensors live in the graph's pool and
    hold ``fn``'s results only after a replay; each replay rewrites them
    in place. ``keep_graph``: the graph's nodes stay readable
    (``graph.raw_cuda_graph()``). Raises RuntimeError when the capture
    fails (e.g. ``fn`` reads a value on the host)."""
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    try:
        t0 = time.perf_counter()
        # thread_local: a NCCL watchdog thread's event queries stay legal
        # while this thread captures
        with torch.cuda.device(device), \
                torch.cuda.graph(graph, capture_error_mode="thread_local"):
            out = fn()
        t1 = time.perf_counter()
        graph.instantiate()
        t2 = time.perf_counter()
    except RuntimeError as e:
        raise RuntimeError(f"capture: the step could not be captured as a "
                           f"CUDA graph: {e}") from e
    return graph, out, {"capture_s": t1 - t0, "instantiate_s": t2 - t1}


# cuGraphNodeGetType's CUgraphNodeType values (cuda.h)
GRAPH_NODE_TYPES = {0: "kernel", 1: "memcpy", 2: "memset", 3: "host",
                    4: "graph", 5: "empty", 6: "wait_event",
                    7: "event_record", 10: "mem_alloc", 11: "mem_free"}


def graph_nodes(graph: torch.cuda.CUDAGraph) -> dict:
    """{node type: count} of a captured graph's nodes (``keep_graph=True``,
    as ``record`` captures), read through libcuda (``cuGraphGetNodes``,
    ``cuGraphNodeGetType``): its kernels are the launches of one replay."""
    cu = ctypes.CDLL("libcuda.so.1")
    cu.cuGraphGetNodes.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                   ctypes.POINTER(ctypes.c_size_t)]
    cu.cuGraphNodeGetType.argtypes = [ctypes.c_void_p,
                                      ctypes.POINTER(ctypes.c_int)]

    def ok(rc):
        if rc != 0:
            raise RuntimeError(f"graph_nodes: libcuda returned {rc}")

    g = ctypes.c_void_p(graph.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    ok(cu.cuGraphGetNodes(g, None, ctypes.byref(n)))
    nodes = (ctypes.c_void_p * n.value)()
    ok(cu.cuGraphGetNodes(g, nodes, ctypes.byref(n)))
    counts, kind = {}, ctypes.c_int()
    for node in nodes:
        ok(cu.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind)))
        name = GRAPH_NODE_TYPES.get(kind.value, str(kind.value))
        counts[name] = counts.get(name, 0) + 1
    return counts


def _shares_storage(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.untyped_storage().data_ptr() == b.untyped_storage().data_ptr()


class CapturedStep:
    """``fn`` captured once as a CUDA graph over static copies of its
    example arguments (``record``), after one call on them (``warm_up``;
    the caller checks ``refusal`` first). Calling it with tensors of the
    examples' shapes, dtypes and device copies each into its static
    tensor, replays the graph and returns ``out``: what ``fn`` returned at
    the capture, tensors that the replay has rewritten in place. The next
    call overwrites them; clone a result to keep it. ``held``: the
    launches of each counted kernel in one replay (``count_launch``),
    added to the kernels' counters at every call; ``held_counts``: the
    named counts of one replay (``profiling.count``), added at every call
    while the recorder is on. ``name`` names its spans and counter (the
    module's docstring).

    An argument that IS its position's static tensor is not copied, so
    ``x, r, p = step(x, r, p)`` on a step that writes its results into its
    arguments replays with no copy at all. An argument that shares storage
    with any other static tensor is cloned before the copies, so that no
    copy overwrites what a later one reads (``step(r, x, p)``). An argument
    of another shape, dtype or device raises ValueError: a graph holds one
    shape, as ``jax.jit`` traces one per shape."""

    def __init__(self, fn, example_args, name: str = "step"):
        global _held
        args = tuple(example_args)
        dev = args[0].device
        self._span, self._launch = f"graph.{name}", f"graph.{name}.launch"
        with profiling.span("graph.capture", name):
            self.static = tuple(a.detach().clone() for a in args)
            warm_up(lambda: fn(*self.static), dev)
            held = _held = {}
            try:
                self.graph, self.out, self.times = record(
                    lambda: fn(*self.static), dev)
            finally:
                _held = None
        self.held = {k: n for k, n in held.items() if not isinstance(k, str)}
        self.held_counts = {k: n for k, n in held.items()
                            if isinstance(k, str)}
        if profiling._on:
            profiling.count(f"graph.{name}.nodes",
                            sum(graph_nodes(self.graph).values()))

    def __call__(self, *args):
        if not profiling.active():
            return self._call(args, False)
        with profiling.span(self._span):
            return self._call(args, True)

    def _call(self, args, spans: bool):
        if len(args) != len(self.static):
            raise TypeError(f"the step takes {len(self.static)} tensors, "
                            f"got {len(args)}")
        for i, (s, a) in enumerate(zip(self.static, args)):
            if not isinstance(a, torch.Tensor) or (
                    a.shape, a.dtype, a.device) != (s.shape, s.dtype,
                                                    s.device):
                got = (tuple(a.shape), a.dtype, str(a.device)) \
                    if isinstance(a, torch.Tensor) else type(a).__name__
                raise ValueError(
                    f"argument {i}: the step was captured with "
                    f"{(tuple(s.shape), s.dtype, str(s.device))}, got {got}")
        args = tuple(a.clone() if a is not s and any(
            _shares_storage(a, t) for t in self.static) else a
            for s, a in zip(self.static, args))
        for s, a in zip(self.static, args):
            if a is not s:
                s.copy_(a)
        if spans:
            with profiling.span(self._launch):
                self.graph.replay()
        else:
            self.graph.replay()
        for wrapper, n in self.held.items():
            wrapper.launches += n
        if self.held_counts:
            profiling.add_counts(self.held_counts)
        return self.out
