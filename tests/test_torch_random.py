"""The port's ``jax.random`` (``repro_torch.core.threefry``) against jax.

Both ``jax_threefry_partitionable`` modes.  What each case checks:

* exact: ``fold_in``, ``split``, ``bits`` and ``uniform`` (with bounds),
  numpy and torch versions, and the Threefry wrapper's plain path;
* near-exact: ``normal``.  The port's ``erf_inv`` is XLA's float32
  polynomial with its fused steps emulated in float64, but ``log1p`` is
  torch's, not XLA's.  Measured on 2 M draws of ``key(3)`` (jax 0.9.0 on
  an x86-64 CPU): 0.95 % of normals differ, by at most 3 ulp, in either mode
  (the tolerance below: at most 2 % differ, by at most 4 ulp).
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp

from repro_torch.core import threefry as tf
from repro_torch.kernels import threefry as tk

SEEDS = [0, 1, 0xACC_DE, 0x5EED, 2 ** 31 + 5]


@pytest.fixture(params=[True, False], ids=["partitionable", "original"])
def mode(request):
    """Set ``jax_threefry_partitionable`` for one test, then restore it."""
    old = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", request.param)
    yield request.param
    jax.config.update("jax_threefry_partitionable", old)


def _words(k) -> tuple:
    return tuple(int(x) for x in np.asarray(jax.random.key_data(k)))


def test_fold_in_exact(mode):
    for seed in SEEDS:
        k = jax.random.key(seed)
        for data in (0, 1, 2, 12345, 2 ** 31, 2 ** 32 - 1):
            assert tuple(map(int, tf.fold_in(tf.key(seed), data))) == \
                _words(jax.random.fold_in(k, data))
        # repro's per-(bank, source) chain and a digest on top
        chain = tf.fold_in(tf.fold_in(tf.fold_in(tf.key(seed), 1), 2),
                           0xDEADBEEF)
        want = jax.random.fold_in(jax.random.fold_in(jax.random.fold_in(
            k, 1), 2), jnp.asarray(0xDEADBEEF, jnp.uint32))
        assert tuple(map(int, chain)) == _words(want)


@pytest.mark.parametrize("num", [1, 2, 3, 160])
def test_split_exact(mode, num):
    for seed in SEEDS:
        np.testing.assert_array_equal(
            tf.split(tf.key(seed), num, partitionable=mode),
            np.asarray(jax.random.key_data(
                jax.random.split(jax.random.key(seed), num))))


@pytest.mark.parametrize("shape", [(1,), (7,), (3, 5), (2, 1001)])
def test_bits_and_bounded_uniform_exact(mode, shape):
    for seed in SEEDS:
        k, kk = jax.random.key(seed), tf.key(seed)
        size = int(np.prod(shape))
        keys = torch.tensor([[int(kk[0]), int(kk[1])]])
        np.testing.assert_array_equal(
            tf.bits_rows(keys, size, partitionable=mode)[0].numpy().astype(
                np.uint32),
            np.asarray(jax.random.bits(k, shape, jnp.uint32)).ravel())
        for lo, hi in ((0.0, 1.0), (-2.5, 3.0), (0.1, 0.2)):
            want = np.asarray(jax.random.uniform(k, shape, minval=lo,
                                                 maxval=hi))
            got = tf.uniform(kk, shape, minval=lo, maxval=hi,
                             partitionable=mode)
            np.testing.assert_array_equal(got.view(np.uint32),
                                          want.view(np.uint32))
            got_t = tf.uniform_rows(keys, size, minval=lo, maxval=hi,
                                    partitionable=mode)[0].numpy()
            np.testing.assert_array_equal(got_t.view(np.uint32),
                                          want.ravel().view(np.uint32))


def test_normal_within_stated_ulp(mode):
    n = 400_000
    k = jax.random.key(3)
    want = np.asarray(jax.random.normal(k, (n,)))
    got = tf.normal(tf.key(3), (n,), partitionable=mode)
    assert np.isfinite(got).all()
    ulp = np.abs(got.view(np.int32).astype(np.int64)
                 - want.view(np.int32).astype(np.int64))
    assert (ulp > 0).mean() <= 0.02
    assert ulp.max() <= 4


def test_wrapper_plain_path_draws_jax_words(mode):
    """``threefry_draw`` on CPU tensors: one row per key, each row the
    draw ``jax.random`` makes from that key (exact for bits and uniforms,
    the stated ulp for normals)."""
    keys = tf.split(tf.key(11), 4, partitionable=mode)
    jkeys = jax.random.split(jax.random.key(11), 4)
    kt = tk.keys_tensor(keys, "cpu")
    bits = tk.threefry_draw(kt, 333, epilogue="bits", partitionable=mode)
    uni = tk.threefry_draw(kt, 333, epilogue="uniform", partitionable=mode)
    nor = tk.threefry_draw(kt, 333, epilogue="normal", partitionable=mode)
    for i in range(4):
        np.testing.assert_array_equal(
            bits[i].numpy().view(np.uint32),
            np.asarray(jax.random.bits(jkeys[i], (333,), jnp.uint32)))
        np.testing.assert_array_equal(
            uni[i].numpy().view(np.uint32),
            np.asarray(jax.random.uniform(jkeys[i], (333,))).view(np.uint32))
        ulp = np.abs(nor[i].numpy().view(np.int32).astype(np.int64)
                     - np.asarray(jax.random.normal(jkeys[i], (333,))).view(
                         np.int32).astype(np.int64))
        assert ulp.max() <= 4


def test_erf_inv_edges():
    x = torch.tensor([0.0, -0.0, 1.0, -1.0, 0.5, -0.999999])
    y = tf.erf_inv(x)
    assert y[0] == 0 and y[2] == float("inf") and y[3] == float("-inf")
    assert abs(float(y[4]) - 0.4769362762) < 1e-6
    assert float(y[5]) < -3.4
