"""The probe kernels on the card (``ops/cuda_dia_probe.py``: K4
``dia_flat_spmv`` and ``table_stream``; ``ops/cuda_kpayload.py``: K5), run
through the probe tools at their own sizes in f32 (``tools/proto_dia``:
K1 on laplace2d(2000) against scipy; ``tools/dia_variants`` at k = 1000
and 2000; ``tools/probe_kpayload`` at k = 64, F = 8, 4096 tiles), each
kernel against its plain version and the launch counters read around the
tools; then table_stream's scalar kernel and K5's edge cases bit for bit.

This file imports no JAX, so the card runs it with

    python -m pytest --noconftest -m card tests/test_torch_card_probes.py

Every test needs a CUDA device and skips without one.
"""

import numpy as np
import pytest
import torch

from hpclinalg_torch.ops import cuda_dia
from hpclinalg_torch.ops import cuda_dia_probe as k4
from hpclinalg_torch.ops import cuda_kpayload as k5
from hpclinalg_torch.tools import dia_variants, probe_kpayload, proto_dia
from hpclinalg_torch.tools.dia_variants import TR

SEED = 0
PROBE_RTOL = 1e-5      # the probes run in f32, as the TPU scripts do
STREAM_CASES = ["odd_row_stride", "table_off_16_depth_2"]
# K5's edge cases: (k, F, tiles, every lane in one sector)
K5_CASES = [(1, 1, 5, False), (13, 8, 300, True), (9, 255, 40, False)]


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def probes(card):
    """The three tools' results, with the launch counters of K1, K4's two
    kernels and K5 set to 0 just before them and read just after."""
    counted = {"dia": cuda_dia.dia_spmv, "dia_flat": k4.dia_flat_spmv,
               "stream": k4.table_stream, "kpayload": k5.kpayload}
    torch.cuda.synchronize()
    for f in counted.values():
        f.launches = 0
    out = {"proto": proto_dia.main([]),
           "dv": dia_variants.main(["--k", "1000", "2000"]),
           "kp": probe_kpayload.main(["64", "8", "4096"])}
    torch.cuda.synchronize()
    out["launches"] = {key: f.launches for key, f in counted.items()}
    return out


@pytest.fixture(scope="module")
def edges(card):
    """The edge cases' inputs, drawn from one generator in a fixed order:
    table_stream's table, then K5's (src, idx, sel) case by case."""
    rng = np.random.default_rng(SEED + 12)
    O, ntiles = 5, 31
    flat = rng.standard_normal(ntiles * O * TR + 8, dtype=np.float32)
    k5_in = []
    for k, F, nt, one in K5_CASES:
        src = rng.standard_normal((nt, F, k, 128), dtype=np.float32)
        idx = rng.integers(0, 128, (nt, 1, 128)).astype(np.int8)
        sel = rng.integers(0, F, (nt, 1, 128)).astype(np.uint8)
        if one:     # every lane in sector 5 of plane 0
            idx, sel = (idx % 8 + 40).astype(np.int8), sel * 0
        k5_in.append((src, idx, sel))
    return {"flat": flat, "O": O, "ntiles": ntiles, "k5": k5_in}


@pytest.mark.card
def test_probes_launch_each_kernel(probes):
    assert all(v > 0 for v in probes["launches"].values()), \
        probes["launches"]


@pytest.mark.card
def test_proto_dia_against_scipy(probes):
    assert probes["proto"]["scipy_rel_err"] <= PROBE_RTOL


@pytest.mark.card
def test_dia_variants(probes):
    """Each variant against its plain version and, where it computes the
    SpMV, scipy; table_stream's 16-byte kernel bit for bit against its
    plain version, the library call within PROBE_RTOL."""
    streams = 0
    for k, rows in probes["dv"].items():
        for name, rec in rows.items():
            where = f"k={k} {name}"
            if "rel_err" in rec:
                assert rec["rel_err"] <= PROBE_RTOL, where
            if "scipy_rel_err" in rec:
                assert rec["scipy_rel_err"] <= PROBE_RTOL, where
            if "lib_ms" in rec:
                streams += 1
                assert rec["exact"] and rec["vec"] > 1, where
                assert rec["lib_rel_err"] <= PROBE_RTOL, where
    assert streams > 0


@pytest.mark.card
def test_kpayload_is_exact(probes):
    assert probes["kp"]["exact"]


@pytest.mark.card
@pytest.mark.parametrize("case", STREAM_CASES)
def test_table_stream_scalar_kernel(card, edges, case):
    """An odd row stride, and a table 4 bytes off 16 at depth 2: the
    scalar kernel, bit for bit against the plain version."""
    O, ntiles = edges["O"], edges["ntiles"]
    flat = torch.from_numpy(edges["flat"]).to(card)
    c = torch.full((1,), 0.5, dtype=torch.float32, device=card)
    args = {"odd_row_stride": (flat, c, ntiles, TR, O, O * TR, TR + 1, 1.0,
                               1),
            "table_off_16_depth_2": (flat[1:], c, ntiles, TR, O, O * TR, TR,
                                     1.0, 2)}[case]
    y = k4.table_stream(*args)
    assert k4.stream_vector_width(args[0], TR, args[5], args[6], y) == 1
    assert torch.equal(y, k4.table_stream_plain(*args))


@pytest.mark.card
@pytest.mark.parametrize("i", range(len(K5_CASES)),
                         ids=[f"k{k}-F{F}-{t}tiles{'-one_sector' * one}"
                              for k, F, t, one in K5_CASES])
def test_kpayload_edges(card, edges, i):
    """K5 at k = 1, F = 1; at k = 13 with every lane in one sector; at
    F = 255: bit for bit against its plain version."""
    src, idx, sel = edges["k5"][i]
    k5.check_tables(idx, sel, K5_CASES[i][1])
    src, idx, sel = (torch.from_numpy(a).to(card) for a in (src, idx, sel))
    assert torch.equal(k5.kpayload(src, idx, sel),
                       k5.kpayload_plain(src, idx, sel))
