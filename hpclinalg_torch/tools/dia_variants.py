"""DIA SpMV variants on the card: where the stencil SpMV's time goes.

Port of the JAX package's ``tools/bench_dia_variants.py`` and
``tools/probe_dia_kernels.py`` (with ``ring_probe``). At laplace2d(k),
n = k², f32, one shard, it times each variant against its plain version
and prints ms, GB/s on the TPU scripts' own traffic formulas and the error:

  plain      the plain DIA engine (the TPU scripts' XLA tier)
  k1_plan    K1 through the SpMV plan: the public ``A @ x``
  k1_raw     K1 alone on a pre-padded x (offsets shifted by -off_0, no bias)
  v4         K4 ``dia_flat_spmv`` on the tile-flat (ntiles, O, TR) table
  v1         the same with every read at the window base (wrong by design:
             it prices the shifted reads; held against its plain version)
  skern      K4 ``table_stream``: row 0 of the (O, ntiles·TR) table, scaled
  v3         K4 ``table_stream``: all O rows of the tile-flat table
  v5_d2/_d3  v3 with 2 or 3 times the loads in flight a thread
             (``ring_probe``)

Each ``table_stream`` case is also timed against the one PyTorch call that
computes its function (``lib_ms``; held to its plain version within a
relative error, ``lib_rel_err``: the library may fuse the multiply-add):
``torch.add(c, tbl[0], alpha=0.125)`` for skern, and for v3 and v5 one
strided-batched product that reads the table once,
``torch.baddbmm(c expanded to (ntiles, 1, TR), ones(ntiles, 1, O), tflat)``.
Their records say whether the kernel equals its plain version bit for bit
(``exact``) and which kernel ran (``vec``: the elements of one access).

The TPU scripts time chained loops by slope to cancel the relay's round
trip, and prescale their tables so the chain stays bounded; here each
launch is timed alone (``tools/timing.Timer``: median of 20, CUDA events,
L2 flushed by a read), so the tables are not prescaled.

    python -m hpclinalg_torch.tools.dia_variants [--k 1000 2000] [--ring]

``--ring`` runs only ``ring_probe``'s part (v3 and v5). Runs on a CUDA
device only.
"""

from __future__ import annotations

import argparse

import numpy as np
import scipy.sparse as sp
import torch

from .timing import Timer, card, max_rel_err, require_cuda

# rows per tile of the TPU layouts (hpclinalg/ops/pallas_dia.py TR)
TR = 131072
ELEM = 4  # bytes of an f32 element, as in the scripts' traffic formulas


def laplace2d(k, dtype=np.float32):
    T = sp.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(k, k))
    I = sp.eye(k)
    return (sp.kron(I, T) + sp.kron(T, I)).tocsr().astype(dtype)


def plan_inputs(Ad, xv):
    """The SpMV plan of ``Ad @ xv`` and the arguments its DIA engine
    passes to K1 (``dia_spmv``) or its plain version."""
    from ..ops import spmv as spmv_mod

    plan = spmv_mod.get_spmv_plan(Ad, xv)
    if plan.offsets is None:
        raise ValueError("the matrix does not take the DIA engine")
    g, pad_to = spmv_mod.gathered(plan, xv.data)
    return plan, (spmv_mod._dia_values(Ad, plan), g, plan.offsets,
                  plan.bias_lo, plan.bias_hi, pad_to)


def variants(k: int, timer: Timer, name: str, ring: bool = False) -> dict:
    """Every variant at laplace2d(k); returns {variant: record}."""
    import hpclinalg_torch as ht
    from ..ops import cuda_dia
    from ..ops.cuda_dia_probe import (dia_flat_spmv, dia_flat_spmv_plain,
                                      stream_vector_width, table_stream,
                                      table_stream_plain)

    dev = timer.flush.device
    A = laplace2d(k)
    n = A.shape[0]
    xh = np.random.default_rng(1).standard_normal(n).astype(np.float32)
    be = ht.backend_auto(1, dtype=np.float32, device=dev)
    Ad = ht.DistSparseMatrix.from_scipy(A, be)
    xv = ht.DistVector.from_global(xh, be)
    plan, args = plan_inputs(Ad, xv)
    offsets = plan.offsets
    O = len(offsets)
    off0, span = offsets[0], offsets[-1] - offsets[0]
    if off0 > 0:
        raise ValueError("the probes pad x on the left by -offsets[0] >= 0")
    Lrow = Ad.structure.Lrow
    ntiles = -(-Lrow // TR)
    npad = ntiles * TR
    tbl = torch.zeros((O, npad), dtype=torch.float32, device=dev)
    tbl[:, :Lrow] = args[0][0]
    tflat = tbl.reshape(O, ntiles, TR).permute(1, 0, 2).contiguous()
    xp = torch.zeros(npad + span, dtype=torch.float32, device=dev)
    xp[-off0: -off0 + n] = xv.data[0, :n]
    c = torch.full((1,), 0.5, dtype=torch.float32, device=dev)
    ref = torch.from_numpy(A.astype(np.float64) @ xh.astype(np.float64)).to(dev)
    shifted = tuple(o - off0 for o in offsets)
    eq = (O + 2) * n * ELEM            # the scripts' "GB/s-eq" traffic
    cases, libs, streams = {}, {}, {}
    if not ring:
        cases["plain"] = (None, lambda: cuda_dia.dia_spmv_plain(*args),
                          eq, True)
        cases["k1_plan"] = (lambda: (Ad @ xv).data[0],
                            lambda: cuda_dia.dia_spmv_plain(*args)[0],
                            eq, True)
        raw = (tbl[None], xp[None], shifted, 0, 0, 0)
        cases["k1_raw"] = (lambda: cuda_dia.dia_spmv(*raw)[0],
                           lambda: cuda_dia.dia_spmv_plain(*raw)[0], eq, True)
        cases["v4"] = (lambda: dia_flat_spmv(tflat, xp, offsets),
                       lambda: dia_flat_spmv_plain(tflat, xp, offsets),
                       eq, True)
        cases["v1"] = (lambda: dia_flat_spmv(tflat, xp, offsets, True),
                       lambda: dia_flat_spmv_plain(tflat, xp, offsets, True),
                       eq, False)
        sk = (tbl, c, ntiles, TR, 1, TR, npad, 0.125)
        cases["skern"] = (lambda: table_stream(*sk),
                          lambda: table_stream_plain(*sk),
                          (O + 1) * npad * ELEM, False)
        libs["skern"] = lambda: torch.add(c, tbl[0], alpha=0.125)
        streams["skern"] = sk
    ones = torch.ones((ntiles, 1, O), dtype=torch.float32, device=dev)
    cexp = c.view(1, 1, 1).expand(ntiles, 1, TR)
    for depth in (1, 2, 3):
        st = (tflat, c, ntiles, TR, O, O * TR, TR, 1.0, depth)
        key = "v3" if depth == 1 else f"v5_d{depth}"
        cases[key] = (lambda st=st: table_stream(*st),
                      lambda st=st: table_stream_plain(*st),
                      (O + 1) * n * ELEM, False)
        libs[key] = lambda: torch.baddbmm(cexp, ones, tflat).reshape(-1)
        streams[key] = st

    out = {}
    print(f"laplace2d({k}): n={n} O={O} span={span} ntiles={ntiles} "
          f"(TR={TR}) f32  [{name}]", flush=True)
    for key, (fk, fp, traffic, vs_scipy) in cases.items():
        rec = {"n": n, "O": O}
        yp = fp()
        if fk is None:
            rec["ms"] = timer.ms(fp)
            y = yp
        else:
            y = fk()
            torch.cuda.synchronize()
            rec["err"], rec["rel_err"] = max_rel_err(y, yp)
            if key in streams:
                rec["exact"] = bool(torch.equal(y, yp))
                tb, _, _, tr, _, ts, rs = streams[key][:7]
                rec["vec"] = stream_vector_width(tb, tr, ts, rs, y)
                rec["lib_err"], rec["lib_rel_err"] = max_rel_err(
                    libs[key](), yp)
                rec["ms"], rec["plain_ms"], rec["lib_ms"] = timer.turns(
                    fk, fp, libs[key])
            else:
                rec["ms"], rec["plain_ms"] = timer.turns(fk, fp)
        rec["gbs"] = traffic / (rec["ms"] / 1e3) / 1e9
        if vs_scipy:
            rec["scipy_err"], rec["scipy_rel_err"] = max_rel_err(
                y.reshape(-1)[:n], ref)
        if key == "skern":
            # the TPU block read all O rows; the card reads row 0 only
            rec["card_gbs"] = 2 * npad * ELEM / (rec["ms"] / 1e3) / 1e9
        out[key] = rec
        line = f"  {key:8s} {rec['ms']:.4f} ms  {rec['gbs']:.0f} GB/s"
        if "plain_ms" in rec:
            line += (f"  plain {rec['plain_ms']:.4f} ms  err {rec['err']:.3e}"
                     f" (rel {rec['rel_err']:.2e})")
        if "scipy_err" in rec:
            line += f"  vs scipy rel {rec['scipy_rel_err']:.2e}"
        if "card_gbs" in rec:
            line += f"  ({rec['card_gbs']:.0f} GB/s moved by the card)"
        if "lib_ms" in rec:
            line += (f"  {'torch.add' if key == 'skern' else 'baddbmm'} "
                     f"{rec['lib_ms']:.4f} ms (rel {rec['lib_rel_err']:.2e})"
                     f"  {'vector' if rec['vec'] > 1 else 'scalar'} kernel, "
                     f"bit-exact {rec['exact']}")
        print(line + f"  [{name}]", flush=True)
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--k", type=int, nargs="+", default=[1000, 2000],
                    help="laplace2d sizes (n = k^2)")
    ap.add_argument("--ring", action="store_true",
                    help="only the ring probe (v3 and v5)")
    args = ap.parse_args(argv)
    dev = require_cuda()
    name = card()
    timer = Timer(dev)
    return {k: variants(k, timer, name, args.ring) for k in args.k}


if __name__ == "__main__":
    main()
