"""The port's Threefry and item memory against ``jax.random`` and
``repro.core.item_memory``: bit-exact words over seeds, dimensions and
densities, in both ``jax_threefry_partitionable`` modes."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp

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
    mode = bool(jax.config.jax_threefry_partitionable)
    np.testing.assert_array_equal(
        convert.tensor_to_words(item_memory.rolled(
            item_memory.make_item_memory(ts, partitionable=mode), 5)),
        np.asarray(jax_im.rolled(jax_im.make_item_memory(js), 5)))


# -- the mode at the session level: the config carries it ---------------------

SESSION_SPACE = dict(dim=512, ngram=5, z_threshold=3.0)
SESSION_CONFIG = dict(window=1024, batch_size=16)


@pytest.fixture(scope="module")
def community():
    from repro_torch.genomics import synth

    genomes, toks, lens, _, _ = synth.make_sample(
        synth.CommunitySpec(num_species=3, genome_len=4_000, seed=5),
        num_reads=40, present=[0, 2])
    return genomes, toks, lens


def _repro_run(community, partitionable):
    """``repro``'s reference prototypes and report under the given
    ``jax_threefry_partitionable`` (restored afterwards)."""
    from repro.pipeline import ArraySource as JaxArraySource
    from repro.pipeline import ProfilerConfig as JaxConfig
    from repro.pipeline import ProfilingSession as JaxSession

    genomes, toks, lens = community
    old = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", partitionable)
    try:
        s = JaxSession(JaxConfig(space=JaxSpace(**SESSION_SPACE),
                                 **SESSION_CONFIG))
        db = s.build_refdb(genomes)
        return (np.asarray(db.prototypes),
                s.profile(JaxArraySource(toks, lens)).to_dict())
    finally:
        jax.config.update("jax_threefry_partitionable", old)


def _port_run(community, backend, **config):
    from repro_torch.pipeline import (ArraySource, ProfilerConfig,
                                      ProfilingSession)

    genomes, toks, lens = community
    s = ProfilingSession(ProfilerConfig(
        space=HDSpace(**SESSION_SPACE), backend=backend, **SESSION_CONFIG,
        **config), device="cpu")
    db = s.build_refdb(genomes)
    return (convert.tensor_to_words(db.prototypes),
            s.profile(ArraySource(toks, lens)).to_dict())


def test_default_session_differs_from_repro_under_the_old_mode(community):
    """The fault the config field repairs: under jax's pre-0.5 mode
    (``jax_threefry_partitionable=False``) a default port session draws
    another item memory than ``repro`` and builds other prototypes."""
    want_protos, _ = _repro_run(community, False)
    got_protos, _ = _port_run(community, "reference")
    assert not np.array_equal(got_protos, want_protos)


@pytest.mark.parametrize("backend", ["reference", "cuda_fused"])
@pytest.mark.parametrize("partitionable", [True, False])
def test_session_matches_repro_in_its_mode(community, partitionable,
                                           backend):
    """With ``threefry_partitionable`` set to the mode ``repro`` runs
    under, prototypes and reports are equal in both modes."""
    want_protos, want = _repro_run(community, partitionable)
    got_protos, got = _port_run(community, backend,
                                threefry_partitionable=partitionable)
    np.testing.assert_array_equal(got_protos, want_protos)
    assert got == want


def test_fingerprints_by_mode():
    from repro.pipeline import ProfilerConfig as JaxConfig
    from repro_torch.pipeline import ProfilerConfig

    j = JaxConfig(space=JaxSpace(**SESSION_SPACE), **SESSION_CONFIG)
    t = ProfilerConfig(space=HDSpace(**SESSION_SPACE), **SESSION_CONFIG)
    old = ProfilerConfig(space=HDSpace(**SESSION_SPACE), **SESSION_CONFIG,
                         threefry_partitionable=False)
    assert (t.fingerprint(), t.refdb_fingerprint(), t.to_json()) == \
        (j.fingerprint(), j.refdb_fingerprint(), j.to_json())
    assert old.fingerprint() != t.fingerprint()
    assert old.refdb_fingerprint() != t.refdb_fingerprint()
    assert ProfilerConfig.from_json(old.to_json()) == old
    assert ProfilerConfig.from_json(t.to_json()) == t


def test_manifest_of_another_mode_is_a_cache_miss(tmp_path, community):
    """The port records its mode in the manifests it writes; an entry of
    the other mode under this config's key is rebuilt, and an entry
    ``repro`` wrote (no mode recorded) is taken as this config's mode."""
    from repro.pipeline import ProfilerConfig as JaxConfig
    from repro.pipeline import ProfilingSession as JaxSession
    from repro_torch.pipeline import (ProfilerConfig, ProfilingSession,
                                      refdb_store)

    genomes = community[0]
    config = ProfilerConfig(space=HDSpace(**SESSION_SPACE), **SESSION_CONFIG)
    old = ProfilerConfig(space=HDSpace(**SESSION_SPACE), **SESSION_CONFIG,
                         threefry_partitionable=False)
    s_old = ProfilingSession(old, device="cpu")
    s_old.build_or_load_refdb(genomes, cache_dir=tmp_path)
    m = refdb_store.manifest(s_old.refdb_cache_file)
    assert m["threefry_partitionable"] is False
    # the other mode's entry, planted under the default mode's key
    s = ProfilingSession(config, device="cpu")
    path = s.refdb_cache_path(tmp_path, genomes)
    path.write_bytes(s_old.refdb_cache_file.read_bytes())
    s.build_or_load_refdb(genomes, cache_dir=tmp_path)
    assert not s.refdb_loaded_from_cache
    assert refdb_store.manifest(path)["threefry_partitionable"] is True
    assert not np.array_equal(convert.tensor_to_words(s.refdb.prototypes),
                              convert.tensor_to_words(s_old.refdb.prototypes))
    # a repro-written entry records no mode and loads in either
    repro_dir = tmp_path / "repro"
    JaxSession(JaxConfig(space=JaxSpace(**SESSION_SPACE),
                         **SESSION_CONFIG)).build_or_load_refdb(
        genomes, cache_dir=repro_dir)
    t = ProfilingSession(config, device="cpu")
    t.build_or_load_refdb(genomes, cache_dir=repro_dir)
    assert t.refdb_loaded_from_cache
    assert "threefry_partitionable" not in refdb_store.manifest(
        t.refdb_cache_file)
