"""The port's Threefry and item memory against ``jax.random`` and
``repro.core.item_memory``: bit-exact words over seeds, dimensions and
densities, in both ``jax_threefry_partitionable`` modes."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.core import item_memory as jax_im
from repro.core.hd_space import HDSpace as JaxSpace
from repro_torch import convert
from repro_torch.core import item_memory, threefry
from repro_torch.core.hd_space import HDSpace

SEEDS = [0, 1, 0x5EED, 0x5EED ^ 0x7EB4EA4, 2 ** 31 + 5, -3]


@pytest.fixture
def threefry_mode(request):
    """Set ``jax_threefry_partitionable`` for one test, then restore it."""
    old = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", request.param)
    yield request.param
    jax.config.update("jax_threefry_partitionable", old)


def test_key_words_match_jax():
    for seed in SEEDS:
        want = np.asarray(jax.random.key_data(jax.random.key(seed)))
        np.testing.assert_array_equal(np.asarray(threefry.key(seed)), want)


@pytest.mark.parametrize("threefry_mode", [True, False], indirect=True)
@pytest.mark.parametrize("shape", [(4, 16), (7,), (3, 5), (1, 1280)])
def test_bits_and_uniform_match_jax(threefry_mode, shape):
    for seed in SEEDS:
        k = jax.random.key(seed)
        bits = threefry.random_bits(threefry.key(seed), shape,
                                    partitionable=threefry_mode)
        np.testing.assert_array_equal(
            bits, np.asarray(jax.random.bits(k, shape, dtype=jnp.uint32)))
        u = threefry.uniform(threefry.key(seed), shape,
                             partitionable=threefry_mode)
        np.testing.assert_array_equal(
            u.view(np.uint32),
            np.asarray(jax.random.uniform(k, shape)).view(np.uint32))


@pytest.mark.parametrize("dim", [64, 512, 40960])
@pytest.mark.parametrize("density", [0.5, 0.3])
def test_item_memory_matches_repro(dim, density):
    """The installed jax's mode (``jax_threefry_partitionable``) decides
    which words ``repro`` draws; the port draws the same ones."""
    mode = bool(jax.config.jax_threefry_partitionable)
    for seed in (0x5EED, 7, 123456789):
        kw = dict(dim=dim, ngram=2, density=density, seed=seed)
        js, ts = JaxSpace(**kw), HDSpace(**kw)
        np.testing.assert_array_equal(
            convert.tensor_to_words(
                item_memory.make_item_memory(ts, partitionable=mode)),
            np.asarray(jax_im.make_item_memory(js)))
        np.testing.assert_array_equal(
            convert.tensor_to_words(
                item_memory.make_tie_break(ts, partitionable=mode)),
            np.asarray(jax_im.make_tie_break(js)))


def test_default_mode_is_partitionable():
    assert threefry.PARTITIONABLE is True
    ts, js = HDSpace(dim=512, ngram=2), JaxSpace(dim=512, ngram=2)
    if jax.config.jax_threefry_partitionable:
        np.testing.assert_array_equal(
            convert.tensor_to_words(item_memory.make_item_memory(ts)),
            np.asarray(jax_im.make_item_memory(js)))


def test_rolled_matches_repro():
    ts, js = HDSpace(dim=512, ngram=5), JaxSpace(dim=512, ngram=5)
    np.testing.assert_array_equal(
        convert.tensor_to_words(
            item_memory.rolled(item_memory.make_item_memory(ts), 5)),
        np.asarray(jax_im.rolled(jax_im.make_item_memory(js), 5)))
