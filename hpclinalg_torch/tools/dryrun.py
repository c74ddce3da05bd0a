"""The port's ``dryrun_multichip``: one distributed CG run, a host solve and
the device factor + solve over n ranks of a ``torch.distributed`` process
group, the analogue of the JAX package's ``__graft_entry__.dryrun_multichip``
over an n-device mesh.

    python -m hpclinalg_torch.tools.dryrun [n]      # n NCCL ranks, a card each
    python -m hpclinalg_torch.tools.dryrun [n] --device cpu   # n gloo ranks

It runs what the port runs on a group: 20 steps of the JAX function's CG
step, ``entry.cg_step_fn`` on laplace2d(16) in f32 over the raw shards
(the halo exchange, the SpMV, the all-reduced dots), run eagerly and, on
NCCL, also captured as a CUDA graph and replayed (``entry.capture``, the
counterpart of its ``jax.jit``; at two ranks or more the exchange's
``all_to_all_single`` is in the graph), the replays equal to the eager
steps bit for bit (``dist_checks.raw_steps``; on gloo ``capture`` must
refuse the group), with the residual below a tenth of
its start, then a host ``ldlt`` solve (rank 0 factors)
with its residual below 1e-5 in f32 and 1e-10 in f64, then the JAX
function's device part over the group in f32: ``ht.ldlt(A,
method="device")`` with local subtrees mapped to the ranks and its
residual below 1e-5, and ``ht.lu(method="device")`` on A plus a seeded
random pattern (``sp.random(n, n, 0.02, random_state=default_rng(0))``)
with its residual below 1e-5; then the complex part
(``__graft_entry__._dryrun_complex``) in native complex64: the SpMV of
laplace2d(12) - 0.4 I + 0.05i I within 1e-3 of scipy's (relative), and
``ht.lu(A).solve(b)`` through the host LU (rank 0 factors) with its
residual below 1e-5.
"""

from __future__ import annotations

import argparse

import numpy as np

from .matrices import laplace2d

SOLVE_RES = {np.float32: 1e-5, np.float64: 1e-10}
DEVICE_RES = 1e-5
COMPLEX_SPMV_RTOL = 1e-3
COMPLEX_LU_RES = 1e-5


def dryrun_multichip(n_devices: int, comm=None, device: str = "cuda",
                     backend: str = "nccl") -> dict:
    """Without ``comm``: start ``n_devices`` ranks with the ``backend``
    transport (``parallel.launch.run_ranks``), run this function on each
    and return rank 0's results. With ``comm``, a process group of
    ``n_devices`` ranks that this process belongs to: run on it here
    (``backend`` is then the group's own). The shard is on this rank's
    card; without a CUDA device this raises unless the caller asks for the
    CPU (``device="cpu"``, with ``backend="gloo"``). Raises when a check
    fails; returns the residuals."""
    if comm is None:
        from ..parallel.launch import run_ranks

        ranks = run_ranks("hpclinalg_torch.tools.dryrun:_on_rank", n_devices,
                          backend=backend, device=device, args=(n_devices,))
        return ranks[0]
    import torch.distributed as dist

    import hpclinalg_torch as ht
    from ..entry import cg_step_fn
    from .dist_checks import raw_steps

    be = ht.backend_dist(dtype=np.float32, group=comm,
                         device="cpu" if device == "cpu" else None)
    if be.world != n_devices:
        raise ValueError(f"the group has {be.world} ranks, not {n_devices}")
    L = laplace2d(16)                        # n = 256 over every rank
    A = ht.DistSparseMatrix.from_scipy(L, be)
    b = ht.DistVector.from_global(np.ones(L.shape[0]), be)
    step, x0 = cg_step_fn(A, be)
    x, r, _ = raw_steps(step, (x0.data, b.data, b.data), 20,
                        graphed=dist.get_backend(comm) == "nccl")["out"]
    x, r = (ht.DistVector(t, x0.partition, be) for t in (x, r))
    rn0, rn = float(b.norm()), float(r.norm())
    if not (np.isfinite(x.to_numpy()).all() and rn < 0.1 * rn0):
        raise AssertionError(f"CG did not converge: {rn} vs {rn0}")
    out = {"cg_residual": rn, "cg_residual0": rn0}
    bh = np.ones(L.shape[0])
    for dt, tol in SOLVE_RES.items():
        Ad = ht.DistSparseMatrix.from_scipy(L, be, dtype=dt)
        xs = ht.ldlt(Ad).solve(ht.DistVector.from_global(bh, be, dtype=dt))
        res = float(np.linalg.norm(L.astype(dt) @ xs.to_numpy() - bh)
                    / np.linalg.norm(bh))
        if not res < tol:
            raise AssertionError(f"host ldlt solve residual {res} in "
                                 f"{np.dtype(dt).name} is not below {tol}")
        out[f"solve_residual_{np.dtype(dt).name}"] = res
    out.update(_dryrun_device(be, L, A, b))
    out.update(_dryrun_complex(be))
    return out


def _dryrun_device(be, L, A, b) -> dict:
    """The device part (``__graft_entry__.py:121-141``) on the group, in
    A's f32: the device LDLᵀ of A, with local subtrees mapped, and the
    device LU of A plus a seeded random pattern, each solve's residual
    below DEVICE_RES."""
    import scipy.sparse as sp

    import hpclinalg_torch as ht

    n = L.shape[0]
    ones = np.ones(n)
    F = ht.ldlt(A, method="device")
    mapped = bool((F.engine.owner >= 0).any())
    if not mapped:
        raise AssertionError("no local subtrees mapped")
    res = float(np.linalg.norm(L @ F.solve(b).to_numpy() - ones)
                / np.linalg.norm(ones))
    if not res < DEVICE_RES:
        raise AssertionError(f"device ldlt residual {res} is not below "
                             f"{DEVICE_RES}")
    Au = (L + sp.random(n, n, 0.02, random_state=np.random.default_rng(0),
                        dtype=np.float64).astype(np.float32)).tocsr()
    Aud = ht.DistSparseMatrix.from_scipy(Au, be, dtype=np.float32)
    resu = float(np.linalg.norm(
        Au @ ht.lu(Aud, method="device").solve(b).to_numpy() - 1.0)
        / np.linalg.norm(ones))
    if not resu < DEVICE_RES:
        raise AssertionError(f"device lu residual {resu} is not below "
                             f"{DEVICE_RES}")
    return {"device_ldlt_residual": res, "device_lu_residual": resu,
            "device_ldlt_local_subtrees": mapped}


def _dryrun_complex(be) -> dict:
    """The complex part (``__graft_entry__._dryrun_complex``) in native
    complex64 on the group: the SpMV and a host LU solve."""
    import scipy.sparse as sp

    import hpclinalg_torch as ht

    k = 12
    n = k * k
    Ac = (laplace2d(k) - 0.4 * sp.eye(n) + 0.05j * sp.eye(n)) \
        .astype(np.complex64).tocsr()
    rng = np.random.default_rng(3)
    bc = (rng.standard_normal(n) + 1j * rng.standard_normal(n)) \
        .astype(np.complex64)
    A = ht.DistSparseMatrix.from_scipy(Ac, be)
    b = ht.DistVector.from_global(bc, be)
    want = Ac @ bc
    err = float(np.linalg.norm((A @ b).to_numpy() - want)
                / np.linalg.norm(want))
    if not err < COMPLEX_SPMV_RTOL:
        raise AssertionError(f"complex SpMV relative error {err} is not "
                             f"below {COMPLEX_SPMV_RTOL}")
    x = ht.lu(A).solve(b).to_numpy()
    res = float(np.linalg.norm(Ac @ x - bc) / np.linalg.norm(bc))
    if not res < COMPLEX_LU_RES:
        raise AssertionError(f"complex LU solve residual {res} is not below "
                             f"{COMPLEX_LU_RES}")
    return {"complex_spmv_rel_err": err, "complex_lu_residual": res}


def _on_rank(device: str, n_devices: int) -> dict:
    import torch.distributed as dist

    return dryrun_multichip(n_devices, comm=dist.group.WORLD, device=device)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("n", type=int, nargs="?", default=2, help="ranks")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="each rank's shard: on its card over NCCL "
                         "(default), or on the CPU over gloo")
    a = ap.parse_args(argv)
    print(dryrun_multichip(a.n, device=a.device,
                           backend="nccl" if a.device == "cuda" else "gloo"))


if __name__ == "__main__":
    main()
