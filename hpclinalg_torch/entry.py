"""The compiled CG step: the port's counterpart of the JAX package's entry
point (``__graft_entry__.py``).

    from hpclinalg_torch.entry import capture, cg_step_fn, entry

    step, args = entry()              # laplace2d(64), f32, one shard, on the card
    step = capture(step, args)        # the counterpart of jax.jit(step)
    x, r, p = args
    for _ in range(20):
        x, r, p = step(x, r, p)

``cg_step_fn(A, be)`` builds one conjugate-gradient step as a function of
this process's raw shards ``(x, r, p)``, each (nlocal, Lrow), closing over
the static plan of ``A @ x`` (``ops/spmv.get_spmv_plan``): its exchange,
its engine and the engine's value tables, built once here. The step is
the JAX package's ``_cg_step_fn`` (``__graft_entry__.py:23-64``) with its
three dots, ``all_reduce``d on a process group as ``DistVector.dot`` does
(p·Ap and r·r in one call, the new r·r in a second), and α and β kept on
the device: nothing in it reads a value on the host. Its SpMV takes the
engine that ``A @ x`` takes (``ops/spmv.py`` ``gathered``,
``local_spmv``): K1 on the DIA engine, K2's gather mode before it on a
non-identity exchange, K3 on the resident engine, K2 on the ELL engine.
(The JAX step takes the segment sum off the DIA engine, so the two steps
agree to a tolerance there, not bit for bit.) The vector work after the
SpMV runs as three hand-written kernels (``ops/cuda_cg.py``) when the
step's vectors are CUDA tensors of a real type, and as plain PyTorch
otherwise (the CPU, complex types), the kernels' oracle; a step counts
``cg.fused_steps`` or ``cg.plain_steps`` (``utils/profiling.count``).

``capture(fn, args)`` is the counterpart of ``jax.jit`` for a step whose
shapes are fixed: the step captured once as a ``torch.cuda.CUDAGraph`` and
replayed. It runs on CUDA tensors only, and on a process group only over
NCCL (gloo stages CUDA tensors through the host, which a graph cannot
hold); it raises in every other case and never runs the step eagerly in
the graph's place. A caller on the CPU or on a gloo group calls ``fn``
itself: the eager raw step.
"""

from __future__ import annotations

import numpy as np
import torch

from .backend import backend_auto, torch_dtype
from .ops import cuda_cg
from .ops.spmv import gathered, get_spmv_plan, local_spmv
from .parallel import comm
from .sparse import DistSparseMatrix
from .tools.matrices import laplace2d
from .utils import graphs
from .utils.graphs import CapturedStep
from .utils.profiling import count, span
from .vector import DistVector


def cg_step_fn(Ad: DistSparseMatrix, be):
    """(cg_step, x0): one CG step over raw tensors and the zero start
    vector on A's rows (``__graft_entry__._cg_step_fn``).
    ``cg_step(x, r, p)`` takes this process's shards of the iterate, the
    residual and the search direction, each (nlocal, Lrow) on ``be``'s
    device, and returns the next three; the padding rows stay zero.
    ``cg_step(x, r, p, out=(xo, ro, po))`` writes them into three tensors
    that overlap no other one of the three, but may be x, r and p
    themselves (each is written after its last read), with the same
    arithmetic: ``capture``'s graph updates its static tensors so.
    ``cg_step.backend``, ``.plan`` and ``.engine`` name what it runs on,
    ``.spmv`` is its product ``A @ p`` over raw shards; ``cg_step.fused``
    whether its vector work runs the kernels of ``ops/cuda_cg.py``, decided
    here from the device and the step's type (their workspace is allocated
    here, before any capture; on CUDA a backend whose vectors are not of
    the step's type raises ValueError)."""
    x0 = DistVector.zeros(Ad.m, be, partition=Ad.row_partition)
    plan = get_spmv_plan(Ad, x0)
    dt = torch.promote_types(Ad.dtype, torch_dtype(be.dtype))
    engine = plan.engine(dt)

    def spmv(p):
        g, pad_to = gathered(plan, p)
        return local_spmv(Ad, plan, engine, g, pad_to)

    # one product here (on every rank of a group, as the step) builds the
    # engine's value tables and K3's windows, cached on A and its plan
    with span("plan.values"):
        spmv(x0.data)

    ws = None
    if cuda_cg.fused_route(x0.data.device, dt):
        if x0.data.dtype != dt:
            raise ValueError(f"cg_step_fn: A @ x is {dt} but the backend's "
                             f"vectors are {x0.data.dtype}; on CUDA the "
                             "step's kernels take one type: build A on a "
                             f"{dt} backend")
        ws = cuda_cg.Workspace(x0.data.numel(), dt, x0.data.device)

    def vdot(a, b):
        return torch.vdot(a.reshape(-1), b.reshape(-1))

    def cg_step(x, r, p, out=None):
        xo, ro, po = (None,) * 3 if out is None else out
        Ap = spmv(p)
        if ws is not None:
            count("cg.fused_steps")
            comm.all_reduce(be, cuda_cg.cg_dots(p, Ap, r, ws))
            x2, r2 = cuda_cg.cg_update_xr(x, r, p, Ap, ws, xo, ro)
            comm.all_reduce(be, ws.rr)
            return x2, r2, cuda_cg.cg_update_p(r2, p, ws, po)
        count("cg.plain_steps")
        pAp, rr = comm.all_reduce(be, torch.stack([vdot(p, Ap), vdot(r, r)]))
        alpha = rr / pAp
        x2 = torch.add(x, alpha * p, out=xo)
        r2 = torch.sub(r, alpha * Ap, out=ro)
        beta = comm.all_reduce(be, vdot(r2, r2)) / rr
        p2 = torch.add(r2, beta * p, out=po)
        return x2, r2, p2

    cg_step.backend, cg_step.plan, cg_step.engine = be, plan, engine
    cg_step.spmv, cg_step.fused = spmv, ws is not None
    return cg_step, x0


def entry(device=None):
    """(fn, example_args): the CG step on laplace2d(64) (n = 4096) in f32
    on one shard, and its arguments ``(x0, b, b)`` with b all ones, each
    (1, 4096): ``__graft_entry__.entry()``. On the current CUDA device;
    without one it raises unless the caller asks for the CPU
    (``device="cpu"``)."""
    dtype = np.float32
    be = backend_auto(1, dtype=dtype, device=device)
    A = DistSparseMatrix.from_scipy(laplace2d(64), be, dtype=dtype)
    cg_step, x0 = cg_step_fn(A, be)
    b = DistVector.from_global(np.ones(A.m, dtype=dtype), be, dtype=dtype)
    return cg_step, (x0.data, b.data, b.data)


def capture(fn, example_args) -> CapturedStep:
    """``fn`` captured once as a CUDA graph with a memory pool of its own:
    the counterpart of ``jax.jit`` for a step whose shapes are fixed
    (``utils/graphs.CapturedStep``, whose calls check each argument's
    shape, dtype and device and copy it into the graph's static input).
    ``fn(*args, out=out)`` must write its results into ``out``, tensors
    shaped like its arguments that may be those arguments, and return
    ``out`` (``cg_step_fn``'s ``cg_step`` does). The example arguments are
    copied into static tensors, ``fn(*static, out=static)`` runs once on
    a side stream, so that the work a capture cannot hold happens outside
    it (the kernels' libraries load, the launchers' one-time
    shared-memory opt-ins and occupancy queries run, the exchange's and
    K3's tables and cuBLAS's workspace are built, a NCCL communicator
    starts), and is then captured: each replay updates the static tensors
    in place. Raises ValueError on CPU tensors, on a step over a group
    that is not NCCL or on a ``fn`` that does not return ``out``, and
    RuntimeError when the capture fails: it never runs ``fn`` eagerly in
    the graph's place."""
    args = tuple(example_args)
    why = graphs.refusal(getattr(fn, "backend", None), args)
    if why is not None:
        raise ValueError(why)
    step = CapturedStep(lambda *s: fn(*s, out=s), args, name="cg_step")
    out = step.out
    if not isinstance(out, (tuple, list)) or len(out) != len(step.static) \
            or any(o is not s for o, s in zip(out, step.static)):
        raise ValueError("capture: fn(*args, out=out) must write its results "
                         "into out and return it")
    return step
