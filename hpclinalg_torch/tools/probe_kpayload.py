"""The k-payload primitive on the card: K5 against its plain version.

Port of the JAX package's ``tools/probe_kpayload.py``, the probe it timed
to design its random-SpMM k tier: out[t, j, l] = src[t, sel[t, l], j,
idx[t, l]] for src (ntiles, F, k, 128) f32, idx int8 < 128 and sel
uint8 < F, made from seed 0. K5 (``csrc/kpayload.cu``) must equal its
plain version bit for bit. Prints, with the card's name and power limit,
the TPU script's quantities: ms per pass-set, Gelem/s, GB/s on its
formula (src and out bytes), and its estimate for a radix reorder of 64k
destination tiles; and the bytes the card's 32-byte sectors make it read.

It also measures what the card's memory does with this pattern, the floors
K5 is read against, each one PyTorch call timed like K5:
  (i)  every plane whole: ``torch.sum(src, dim=1)`` reads all of src once
       and writes an out-sized result;
  (ii) exactly the touched sectors in address order: src viewed as
       (ntiles * F * k * 16, 8) rows of 32 bytes and ``index_select`` of
       the sorted touched row ids (``ops.cuda_kpayload.touched_sectors``);
       it writes what it reads, and reads the int32 ids;
and the sector floor, the touched sectors plus out over 3.35 TB/s: the
least any kernel that reads whole sectors can take (the byte bound counts
only the selected 4-byte values); the 64-byte floor, the same for the
touched 64-byte granules (sector pairs); and the granule control: K5 with
every lane moved to the even sector of its pair (idx with bit 3 cleared),
which touches fewer sectors but the same granules, so it takes K5's time
if the memory fetches granules and less if it fetches sectors.

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
    from ..ops.cuda_kpayload import (check_tables, kpayload, kpayload_plain,
                                     touched_sectors)
    from .timing import bound_ms

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
    idx_even = idx & ~8
    fk = (lambda: kpayload(src, idx, sel, checked=True))
    fp = (lambda: kpayload_plain(src, idx, sel))
    fe = (lambda: kpayload(src, idx_even, sel, checked=True))
    ms, plain_ms, even_ms = timer.turns(fk, fp, fe)
    per = ms / 1e3
    elems = ntiles * LANES * k
    src_bytes, out_bytes = src.numel() * 4, out.numel() * 4
    gbs = (src_bytes + out_bytes) / per / 1e9
    # the least the function must move: each distinct (plane, lane) a tile
    # selects, k values of it, read once; out written once; the two tables
    needed = sum(np.unique(sel_h[t, 0].astype(np.int64) * LANES
                           + idx_h[t, 0]).size for t in range(ntiles))
    bound_bytes = needed * k * 4 + out_bytes + 2 * idx_h.size
    # what whole 32-byte sectors make any kernel read: each tile's touched
    # (plane, sector) pairs in all k rows
    keys, count, _ = touched_sectors(torch.from_numpy(idx_h),
                                     torch.from_numpy(sel_h), F)
    sect_bytes = int(count.sum()) * k * 32
    sector_floor_ms = bound_ms(sect_bytes + out_bytes + 2 * idx_h.size)[0]
    card_gbs = (sect_bytes + out_bytes) / per / 1e9
    # the same in 64-byte granules, (plane, sector // 2): keys are sorted
    gkey = torch.where(keys >= 0, keys // 2, -1)
    new = torch.ones_like(gkey, dtype=torch.bool)
    new[:, 1:] = gkey[:, 1:] != gkey[:, :-1]
    gran_bytes = int((new & (gkey >= 0)).sum()) * k * 64
    granule_floor_ms = bound_ms(gran_bytes + out_bytes + 2 * idx_h.size)[0]
    _, count_even, _ = touched_sectors(torch.from_numpy(idx_h & ~8),
                                       torch.from_numpy(sel_h), F)
    even_bytes = int(count_even.sum()) * k * 32
    print(f"k={k} F={F} ntiles={ntiles}: {ms:.4f} ms/pass-set  "
          f"{elems / per / 1e9:.1f} Gelem/s(level)  {gbs:.0f} GB/s  "
          f"(sectors read: {sect_bytes / src_bytes:.1%} of src, "
          f"{card_gbs:.0f} GB/s)  plain {plain_ms:.4f} ms  bit-exact {exact}"
          f"  [{name}]", flush=True)
    # the floors: (i) every plane whole, (ii) the touched sectors in order;
    # the row id of (t, plane, j, sector) in src viewed as 32-byte rows
    key = keys.to(dev)[:, :, None]
    t_ = torch.arange(ntiles, device=dev)[:, None, None]
    j_ = torch.arange(k, device=dev)[None, None, :]
    rid = ((t_ * F + key // 16) * k + j_) * 16 + key % 16
    rid = torch.sort(rid[(key >= 0).expand_as(rid)]).values.to(torch.int32)
    srcv = src.view(-1, 8)
    f1 = (lambda: torch.sum(src, dim=1))
    f2 = (lambda: torch.index_select(srcv, 0, rid))
    floor1_ms, floor2_ms = timer.turns(f1, f2)
    floor1_bytes = src_bytes + out_bytes
    floor2_bytes = 2 * sect_bytes + 4 * rid.numel()
    del rid
    print(f"  granules: 64-byte floor {granule_floor_ms:.4f} ms (granules "
          f"{gran_bytes / src_bytes:.1%} of src); the granule control, "
          f"every lane on the even sector of its pair: {even_ms:.4f} ms "
          f"(sectors {even_bytes / src_bytes:.1%} of src, granules as K5's)"
          f"  [{name}]", flush=True)
    print(f"  floors: (i) every plane whole, torch.sum(src, dim=1) "
          f"{floor1_ms:.4f} ms ({floor1_bytes / 1e6:.1f} MB, "
          f"{floor1_bytes / floor1_ms / 1e6:.0f} GB/s); (ii) the touched "
          f"sectors in order, index_select {floor2_ms:.4f} ms "
          f"({sect_bytes / 1e6:.1f} MB read and written, and the ids: "
          f"{floor2_bytes / floor2_ms / 1e6:.0f} GB/s); sector floor "
          f"{sector_floor_ms:.4f} ms (the touched sectors and out over 3.35 "
          f"TB/s)  [{name}]", flush=True)
    L = max(1, math.ceil(math.log(65536) / math.log(max(F, 2))))
    est = per * (65536 / ntiles) * L
    print(f"  -> {L} levels over 64k tiles: ~{est * 1e3:.0f} ms reorder; "
          f"8M x {k} = {8e6 * k / est / 1e9:.1f} Gelem/s end-to-end bound  "
          f"[{name}]", flush=True)
    return {"k": k, "F": F, "ntiles": ntiles, "ms": ms, "plain_ms": plain_ms,
            "gelems": elems / per / 1e9, "gbs": gbs, "card_gbs": card_gbs,
            "exact": exact, "err": err, "bound_bytes": bound_bytes,
            "sector_bytes": sect_bytes, "sector_floor_ms": sector_floor_ms,
            "granule_floor_ms": granule_floor_ms, "even_ms": even_ms,
            "floor1_ms": floor1_ms, "floor2_ms": floor2_ms,
            "inputs": (src, idx, sel)}


if __name__ == "__main__":
    main()
