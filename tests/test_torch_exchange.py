"""The port's ExchangePlan against the JAX package's, on the cases of
tests/test_exchange.py plus an identity and a window plan.

Both packages take the same host send/recv lists; the port runs every tier
as one gather plus one scatter on the flattened stack. Moved values are
copied, not computed, so the comparison is exact, and every slot nobody
writes must be exactly 0 (the padding invariant)."""

import jax
import numpy as np
import pytest
import torch

from hpclinalg.parallel.exchange import ExchangePlan as JaxPlan
from hpclinalg_torch import backend_auto
from hpclinalg_torch.parallel.exchange import ExchangePlan

torch.set_num_threads(1)


def _empty(S):
    return ([[np.zeros(0, np.int64) for _ in range(S)] for _ in range(S)],
            [[np.zeros(0, np.int64) for _ in range(S)] for _ in range(S)])


def _oracle(send, recv, x_shards, out_pad, S):
    out = [np.zeros(out_pad, np.float64) for _ in range(S)]
    for s in range(S):
        for d in range(S):
            for j, src in enumerate(send[s][d]):
                out[d][recv[d][s][j]] = x_shards[s][src]
    return np.stack(out)


def _compare(be4, send, recv, out_len, x_shards, src_sizes):
    S = len(x_shards)
    x = np.stack(x_shards)
    jp = JaxPlan(be4, send, recv, out_len, src_sizes=src_sizes)
    want = np.asarray(jp.apply(jax.device_put(x, be4.row_sharding(0))))
    tp = ExchangePlan(backend_auto(S, device="cpu"), send, recv, out_len,
                      src_sizes=src_sizes)
    assert tp.out_pad == jp.out_pad
    assert tp.is_identity == jp.is_identity
    assert tp.local_only == jp.local_only
    got = tp.apply(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)  # exact: values are copied
    oracle = _oracle(send, recv, x_shards, tp.out_pad, S)
    np.testing.assert_array_equal(got, oracle)
    written = np.zeros_like(got, bool)
    for d in range(S):
        for s in range(S):
            written[d, np.asarray(recv[d][s], np.int64)] = True
    assert np.all(got[~written] == 0), "padding invariant violated"
    return tp, got


def test_halo_prefix_tier(be4):
    S, L, halo = 4, 16, 2
    rng = np.random.default_rng(0)
    x_shards = [rng.standard_normal(L) for _ in range(S)]
    send, recv = _empty(S)
    for s in range(S):
        send[s][s] = np.arange(L)
        recv[s][s] = np.arange(halo, halo + L)
        if s > 0:
            send[s][s - 1] = np.arange(halo)
            recv[s - 1][s] = np.arange(halo + L, halo + L + halo)
        if s < S - 1:
            send[s][s + 1] = np.arange(L - halo, L)
            recv[s + 1][s] = np.arange(halo)
    tp, _ = _compare(be4, send, recv, halo + L + halo, x_shards, [L] * S)
    assert not tp.local_only
    assert tp.nmoved == S * L + 2 * (S - 1) * halo


def test_self_scatter_tier(be4):
    S, L = 4, 12
    rng = np.random.default_rng(1)
    x_shards = [rng.standard_normal(L) for _ in range(S)]
    send, recv = _empty(S)
    for s in range(S):
        send[s][s] = np.array([0, 2, 4, 6])
        recv[s][s] = np.array([1, 3, 5, 7])
        d = (s + 1) % S
        send[s][d] = np.array([11])
        recv[d][s] = np.array([0])
    _compare(be4, send, recv, 16, x_shards, [L] * S)


def test_pure_exchange_no_self(be4):
    S, L = 4, 8
    rng = np.random.default_rng(2)
    x_shards = [rng.standard_normal(L) for _ in range(S)]
    send, recv = _empty(S)
    for s in range(S):
        d = (s + 1) % S
        send[s][d] = np.arange(L)
        recv[d][s] = np.arange(L)
    _compare(be4, send, recv, L, x_shards, [L] * S)


def test_prefix_tier_guard(be4):
    S, L = 4, 16
    rng = np.random.default_rng(3)
    keep = L - 2
    x_shards = []
    for _ in range(S):
        xs = rng.standard_normal(L)
        xs[keep:] = 0.0
        x_shards.append(xs)
    send, recv = _empty(S)
    start = 9
    for s in range(S):
        send[s][s] = np.arange(keep)
        recv[s][s] = np.arange(start, start + keep)
        d = (s + 1) % S
        send[s][d] = np.array([keep - 1])
        recv[d][s] = np.array([0])
    _compare(be4, send, recv, start + keep + 1, x_shards, [keep] * S)


@pytest.mark.parametrize("out_len", [8, 16, 21])
def test_identity_plan(be4, out_len):
    """Every shard keeps its whole block in place (pad or cut to out_pad)."""
    S, L = 4, 16
    sizes = [13, 16, 9, 0]
    rng = np.random.default_rng(4)
    x_shards = [np.where(np.arange(L) < n, rng.standard_normal(L), 0.0)
                for n in sizes]
    send, recv = _empty(S)
    for s in range(S):
        send[s][s] = np.arange(sizes[s])
        recv[s][s] = np.arange(sizes[s])
    if out_len < max(sizes):
        pytest.raises(IndexError, ExchangePlan, backend_auto(S, device="cpu"),
                      send, recv, out_len, src_sizes=sizes)
        return
    tp, _ = _compare(be4, send, recv, out_len, x_shards, sizes)
    assert tp.is_identity


def test_window_plan(be4):
    """Every shard copies the same contiguous run to the same place."""
    S, L = 4, 16
    rng = np.random.default_rng(5)
    x_shards = [rng.standard_normal(L) for _ in range(S)]
    send, recv = _empty(S)
    for s in range(S):
        send[s][s] = np.arange(3, 11)
        recv[s][s] = np.arange(5, 13)
    _, got = _compare(be4, send, recv, 20, x_shards, [L] * S)
    np.testing.assert_array_equal(got[:, 5:13], np.stack(x_shards)[:, 3:11])


def test_add_and_base_modes():
    """Scatter-add with overlapping destinations, and a base buffer."""
    S, L = 2, 4
    be = backend_auto(S, device="cpu")
    send, recv = _empty(S)
    send[0][1] = np.array([0, 1, 2])
    recv[1][0] = np.array([5, 5, 6])
    send[1][1] = np.array([3])
    recv[1][1] = np.array([0])
    tp = ExchangePlan(be, send, recv, 8)
    x = torch.arange(1.0, 1.0 + S * L, dtype=torch.float64).reshape(S, L)
    got = tp.apply(x, add=True).numpy()
    want = np.zeros((S, 8))
    want[1, 5] = 1.0 + 2.0
    want[1, 6] = 3.0
    want[1, 0] = 8.0
    np.testing.assert_array_equal(got, want)
    base = torch.full((S, 8), -1.0, dtype=torch.float64)
    got = tp.apply(x, base=base).numpy()
    assert got[0].tolist() == [-1.0] * 8
    assert got[1, 0] == 8.0 and got[1, 6] == 3.0 and got[1, 1] == -1.0


def test_index_safety():
    """Out-of-range tables raise at plan build or before any gather."""
    S = 2
    be = backend_auto(S, device="cpu")
    send, recv = _empty(S)
    send[0][1] = np.array([0, 1])
    recv[1][0] = np.array([9, 2])   # out_pad is 8; 8 is the drop slot
    with pytest.raises(IndexError):
        ExchangePlan(be, send, recv, 8)
    recv[1][0] = np.array([8, 2])
    tp = ExchangePlan(be, send, recv, 8)
    assert tp.nmoved == 1
    got = tp.apply(torch.ones((S, 4), dtype=torch.float64)).numpy()
    assert got.sum() == 1.0 and got[1, 2] == 1.0
    send[0][1] = np.array([0])
    recv[1][0] = np.array([-1])
    with pytest.raises(IndexError):
        ExchangePlan(be, send, recv, 8)
    recv[1][0] = np.array([7])
    send[0][1] = np.array([5])
    with pytest.raises(IndexError):
        ExchangePlan(be, send, recv, 8, src_sizes=[4, 4])
    tp = ExchangePlan(be, send, recv, 8)
    with pytest.raises(IndexError):
        tp.apply(torch.zeros((S, 4), dtype=torch.float64))


def test_complex_payload_moves_as_real_pairs(be4, monkeypatch):
    """A complex payload (c128, S = 4, with a trailing axis, in the copy,
    base and add modes) goes through the gather as its (real, imaginary)
    pairs — the gather kernel moves real words only — and lands exactly
    where the JAX plan puts it."""
    import hpclinalg_torch.parallel.exchange as ex

    S, L, k = 4, 12, 3
    rng = np.random.default_rng(17)
    send, recv = _empty(S)
    for s in range(S):
        for d in range(S):
            m = rng.integers(0, 4)
            send[s][d] = rng.choice(L, m, replace=False)
            recv[d][s] = np.arange(m) + 4 * s   # disjoint per source
    x = rng.standard_normal((S, L, k)) + 1j * rng.standard_normal((S, L, k))
    jp = JaxPlan(be4, send, recv, 16, src_sizes=[L] * S)
    want = np.asarray(jp.apply(jax.device_put(x, be4.row_sharding(1))))
    seen = []
    real_gather = ex.gather

    def spy(xs, src):
        seen.append(xs.dtype)
        return real_gather(xs, src)

    monkeypatch.setattr(ex, "gather", spy)
    tp = ExchangePlan(backend_auto(S, device="cpu"), send, recv, 16,
                      src_sizes=[L] * S)
    got = tp.apply(torch.from_numpy(x))
    assert got.dtype == torch.complex128 and seen == [torch.float64]
    np.testing.assert_array_equal(got.numpy(), want)
    base = torch.full((S, tp.out_pad, k), 2 - 1j, dtype=torch.complex128)
    jbase = jax.device_put(base.numpy(), be4.row_sharding(1))
    xj = jax.device_put(x, be4.row_sharding(1))
    np.testing.assert_array_equal(
        tp.apply(torch.from_numpy(x), base=base).numpy(),
        np.asarray(jp.apply(xj, base=jbase)))
    np.testing.assert_array_equal(
        tp.apply(torch.from_numpy(x), base=base, add=True).numpy(),
        np.asarray(jp.apply(xj, base=jbase, add=True)))
