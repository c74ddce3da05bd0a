"""The port's DistVector element-wise, reduction, map and constructor API
against the JAX package's (the scenarios of tests/test_vector.py:22-96).

Both packages get the same seeded numpy input; values must agree to rtol
1e-12 (f64 and complex128: the maps are elementwise, the reductions sum in
another order), and the port's padding must stay exactly zero.
"""

import numpy as np
import pytest
import torch

import hpclinalg as hl
import hpclinalg_torch as ht
from utils import rand_vector

torch.set_num_threads(1)

RTOL = 1e-12
CONFIGS = [(np.float64, 1), (np.float64, 4), (np.complex128, 4),
           (np.float64, 8)]
IDS = ["f64-serial", "f64-4shards", "c128-4shards", "f64-8shards"]


def _pair(x, S, dtype=np.float64, partition=None):
    jv = hl.DistVector.from_global(x, hl.backend_auto(nshards=S, dtype=dtype),
                                   partition=partition, dtype=dtype)
    tv = ht.DistVector.from_global(x, ht.backend_auto(S, dtype=dtype,
                                                      device="cpu"),
                                   partition=partition, dtype=dtype)
    return jv, tv


def _padding_zero(tv):
    data = tv.data.numpy()
    assert np.all(data[~tv.mask().numpy()] == 0), "padding invariant violated"


def _same(tv, jv):
    """The port's vector equals the JAX package's to RTOL, on the same
    partition, with its padding zero."""
    assert np.array_equal(tv.partition, jv.partition)
    np.testing.assert_allclose(tv.to_numpy(), np.asarray(jv.to_numpy()),
                               rtol=RTOL, atol=0)
    _padding_zero(tv)


def _same_scalar(t, j):
    np.testing.assert_allclose(np.asarray(t), np.asarray(j), rtol=RTOL, atol=0)


@pytest.mark.parametrize("dtype,S", CONFIGS, ids=IDS)
def test_vector_arithmetic_api(dtype, S):
    x = rand_vector(29, dtype, 3)
    y = rand_vector(29, dtype, 4)
    jx, tx = _pair(x, S, dtype)
    jy, ty = _pair(y, S, dtype)
    pairs = [(tx / 2.0, jx / 2.0), (tx / ty, jx / jy), (2.0 / tx, 2.0 / jx),
             (tx ** 2, jx ** 2), (tx ** -1, jx ** -1), (abs(tx), abs(jx)),
             (tx.abs(), jx.abs()), (tx.abs2(), jx.abs2()),
             (tx.conj(), jx.conj()), (tx.real(), jx.real()),
             (tx.imag(), jx.imag())]
    if dtype == np.float64:
        z = 5 * x
        jz, tz = _pair(z, S, dtype)
        pairs += [(tz.floor(), jz.floor()), (tz.ceil(), jz.ceil()),
                  (tz.round(), jz.round())]
    for t, j in pairs:
        _same(t, j)
    assert tx.abs2().dtype == torch.float64 and tx.real().dtype == torch.float64
    # v.H @ w is the sesquilinear product, v.T @ w the plain one
    _same_scalar(tx.H @ ty, jx.H @ jy)
    _same_scalar(tx.T @ ty, jx.T @ jy)
    assert isinstance(tx.H, ht.LazyTranspose)


@pytest.mark.parametrize("dtype,S", CONFIGS, ids=IDS)
def test_vector_reductions_api(dtype, S):
    """41 entries over S shards leave padding slots; max and min must not
    see them (all entries negative, then all positive)."""
    x = rand_vector(41, dtype, 5)
    jx, tx = _pair(x, S, dtype)
    _same_scalar(tx.sum(), jx.sum())
    _same_scalar(tx.mean(), jx.mean())
    if dtype == np.float64:
        for sign in (1.0, -1.0):
            ja, ta = _pair(sign * (np.abs(x) + 1.0), S)
            _same_scalar(ta.max(), ja.max())
            _same_scalar(ta.min(), ja.min())
            assert float(ta.max()) == np.max(sign * (np.abs(x) + 1.0))
            assert float(ta.min()) == np.min(sign * (np.abs(x) + 1.0))


@pytest.mark.parametrize("S", [1, 4, 8])
def test_vector_map_and_bmap_rezero(S):
    """exp and cos do not keep zeros: both maps re-zero the padding unless
    the caller says the map keeps zeros. bmap aligns a mismatched operand."""
    x = rand_vector(25)
    jv, tv = _pair(x, S)
    import jax.numpy as jnp

    _same(tv.map(torch.exp), jv.map(jnp.exp))
    _same(ht.DistVector.bmap(lambda a, b: a * 2 + torch.cos(b), tv, tv),
          hl.DistVector.bmap(lambda a, b: a * 2 + jnp.cos(b), jv, jv))
    _same(tv.map(lambda d: 3 * d, zero_preserving=True),
          jv.map(lambda d: 3 * d, zero_preserving=True))
    p = np.array([0] + list(np.linspace(3, 20, S - 1).astype(int)) + [25])
    jw, tw = _pair(rand_vector(25, seed=9), S, partition=p)
    got = ht.DistVector.bmap(lambda a, b: a - torch.exp(b), tv, tw)
    _same(got, hl.DistVector.bmap(lambda a, b: a - jnp.exp(b), jv, jw))
    assert np.array_equal(got.partition, tv.partition)


@pytest.mark.parametrize("S", [1, 4, 8])
def test_vector_nonfinite_scalars_keep_padding_zero(S):
    """A non-finite or zero divisor writes inf or NaN into the padding
    unless it is re-zeroed; norm(1) must still be inf and the padding zero
    (tests/test_vector.py:91-100)."""
    jv, tv = _pair(np.arange(1.0, 8.0), S)
    for t, j in ((tv * np.inf, jv * np.inf), (tv / 0.0, jv / 0.0),
                 (tv / np.inf, jv / np.inf), (1.0 / tv, 1.0 / jv),
                 (tv ** -1, jv ** -1), (tv ** 0, jv ** 0)):
        _same(t, j)
    assert np.isinf(float((tv / 0.0).norm(1)))
    assert np.isinf(float((tv * np.inf).norm(1)))
    # a divisor still on the device is never read back: always re-zeroed
    _padding_zero(tv / torch.tensor(0.0, dtype=torch.float64))
    _padding_zero(tv ** torch.tensor(-1.0, dtype=torch.float64))


def test_vector_from_local_and_constructors():
    be_t = ht.backend_auto(4, device="cpu")
    be_j = hl.backend_auto(nshards=4)
    shards = [np.arange(3.0), np.arange(4.0), np.zeros(0), np.arange(2.0)]
    tv = ht.DistVector.from_local(shards, be_t)
    jv = hl.DistVector.from_local(shards, be_j)
    assert np.array_equal(tv.partition, [0, 3, 7, 7, 9])
    np.testing.assert_array_equal(tv.data.numpy(), np.asarray(jv.data))
    _same(tv, jv)
    for t, j in ((ht.DistVector.ones(23, be_t), hl.DistVector.ones(23, be_j)),
                 (ht.DistVector.full(23, 2.5, be_t),
                  hl.DistVector.full(23, 2.5, be_j)),
                 (ht.DistVector.rand(23, be_t, seed=7),
                  hl.DistVector.rand(23, be_j, seed=7))):
        np.testing.assert_array_equal(t.to_numpy(), np.asarray(j.to_numpy()))
        _padding_zero(t)
    ro = tv.to_numpy_ro()
    assert not ro.flags.writeable and ro is tv.to_numpy_ro()
    np.testing.assert_array_equal(ro, np.concatenate(shards))
    assert tv.to_numpy().flags.writeable
    tv.data.mul_(2.0)    # a new version of the tensor: the cache is stale
    np.testing.assert_array_equal(tv.to_numpy_ro(), 2 * np.concatenate(shards))
