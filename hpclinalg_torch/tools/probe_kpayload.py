"""The k-payload primitive on the card: K5 against its plain version.

Port of the JAX package's ``tools/probe_kpayload.py``, the probe it timed
to design its random-SpMM k tier: out[t, j, l] = src[t, sel[t, l], j,
idx[t, l]] for src (ntiles, F, k, 128) f32, idx int8 < 128 and sel
uint8 < F, made from seed 0. K5 (``csrc/kpayload.cu``) must equal its
plain version bit for bit. Prints, with the card's name and power limit,
the TPU script's quantities: ms per pass-set, Gelem/s, GB/s on its
formula (src and out bytes), and its estimate for a radix reorder of 64k
destination tiles; and the bytes the card's 32-byte sectors make it read.

    python -m hpclinalg_torch.tools.probe_kpayload [k=64] [F=8] [ntiles=4096]

Runs on a CUDA device only.
"""

from __future__ import annotations

import math
import sys

import numpy as np
import torch

from .timing import Timer, card, require_cuda

LANES = 128


def main(argv=None) -> dict:
    argv = sys.argv[1:] if argv is None else argv
    k = int(argv[0]) if len(argv) > 0 else 64
    F = int(argv[1]) if len(argv) > 1 else 8
    ntiles = int(argv[2]) if len(argv) > 2 else 4096
    from ..ops.cuda_kpayload import check_tables, kpayload, kpayload_plain

    dev = require_cuda()
    name = card()
    timer = Timer(dev)
    rng = np.random.default_rng(0)
    src_h = rng.standard_normal((ntiles, F, k, LANES), dtype=np.float32)
    idx_h = rng.integers(0, LANES, (ntiles, 1, LANES)).astype(np.int8)
    sel_h = rng.integers(0, F, (ntiles, 1, LANES)).astype(np.uint8)
    check_tables(idx_h, sel_h, F)
    src = torch.from_numpy(src_h).to(dev)
    idx = torch.from_numpy(idx_h).to(dev)
    sel = torch.from_numpy(sel_h).to(dev)
    del src_h
    out = kpayload(src, idx, sel)
    ref = kpayload_plain(src, idx, sel)
    torch.cuda.synchronize()
    exact = bool(torch.equal(out, ref))
    err = float((out - ref).abs().max())
    fk = (lambda: kpayload(src, idx, sel, checked=True))
    fp = (lambda: kpayload_plain(src, idx, sel))
    a, b = timer.ms(fk), timer.ms(fp)
    b2, a2 = timer.ms(fp), timer.ms(fk)
    ms, plain_ms = min(a, a2), min(b, b2)
    per = ms / 1e3
    elems = ntiles * LANES * k
    src_bytes, out_bytes = src.numel() * 4, out.numel() * 4
    gbs = (src_bytes + out_bytes) / per / 1e9
    touched = 1.0 - (1.0 - 1.0 / (16 * F)) ** LANES
    # the least the function must move: each distinct (plane, lane) a tile
    # selects, k values of it, read once; out written once; the two tables
    needed = sum(np.unique(sel_h[t, 0].astype(np.int64) * LANES
                           + idx_h[t, 0]).size for t in range(ntiles))
    bound_bytes = needed * k * 4 + out_bytes + 2 * idx_h.size
    card_gbs = (touched * src_bytes + out_bytes) / per / 1e9
    print(f"k={k} F={F} ntiles={ntiles}: {ms:.4f} ms/pass-set  "
          f"{elems / per / 1e9:.1f} Gelem/s(level)  {gbs:.0f} GB/s  "
          f"(sectors read: {touched:.1%} of src, {card_gbs:.0f} GB/s)  "
          f"plain {plain_ms:.4f} ms  bit-exact {exact}  [{name}]", flush=True)
    L = max(1, math.ceil(math.log(65536) / math.log(max(F, 2))))
    est = per * (65536 / ntiles) * L
    print(f"  -> {L} levels over 64k tiles: ~{est * 1e3:.0f} ms reorder; "
          f"8M x {k} = {8e6 * k / est / 1e9:.1f} Gelem/s end-to-end bound  "
          f"[{name}]", flush=True)
    return {"k": k, "F": F, "ntiles": ntiles, "ms": ms, "plain_ms": plain_ms,
            "gelems": elems / per / 1e9, "gbs": gbs, "card_gbs": card_gbs,
            "exact": exact, "err": err, "bound_bytes": bound_bytes,
            "inputs": (src, idx, sel)}


if __name__ == "__main__":
    main()
