"""The port's noise-aware RefDB co-design against ``repro.accel.codesign``.

The cases of ``tests/test_codesign.py`` on the port, each also held
against ``repro`` on the same inputs:

* exact: ``write_verify_bits`` under shift and stuck faults (the device
  transfer is in {0, 1}, so every probe read, offset choice and stored
  bit is an integer decision on integer sums);
* exact at these sizes: ``noise_aware_refdb`` through ``racetrack_sim``
  with shift faults (the same numpy sampling, the same device draws, and
  no noisy sum on a rounding boundary), and through the digital
  ``reference`` backend;
* the fingerprint (equal to ``repro``'s in the default threefry mode)
  and the refusal of bad inputs.

Every port backend runs in the installed jax's threefry mode.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp

from repro_torch import convert
from repro_torch.accel.backend_pcm import split_options
from repro_torch.accel.codesign import noise_aware_refdb
from repro_torch.accel.crossbar import crossbar_agreement, write_verify_bits
from repro_torch.core.hd_space import HDSpace
from repro_torch.pipeline import ProfilingSession
from repro_torch.pipeline.backend import resolve_backend
from repro_torch.pipeline.config import ProfilerConfig

SP = dict(dim=512, ngram=5, z_threshold=3.0)
MODE = bool(jax.config.jax_threefry_partitionable)


def _config(backend="racetrack_sim", **options):
    return ProfilerConfig(space=HDSpace(**SP), window=512, batch_size=32,
                          backend=backend, backend_options=options,
                          threefry_partitionable=MODE)


def _jax_config(backend="racetrack_sim", **options):
    from repro.core.hd_space import HDSpace as JaxSpace
    from repro.pipeline.config import ProfilerConfig as JaxConfig
    return JaxConfig(space=JaxSpace(**SP), window=512, batch_size=32,
                     backend=backend, backend_options=options)


def _be(config):
    return resolve_backend(config.backend, config, device="cpu")


@pytest.fixture(scope="module")
def community():
    rng = np.random.default_rng(11)
    genomes = {f"s{i}": rng.integers(0, 4, 6000).astype(np.int32)
               for i in range(4)}
    toks = np.stack([np.asarray(g)[200 + 37 * i:200 + 37 * i + 96]
                     for i, g in enumerate(genomes.values())] * 8)
    lens = np.full(len(toks), 96, np.int32)
    labels = np.tile(np.arange(4), 8)
    return genomes, toks, lens, labels


def _encode(be, toks, lens):
    return be.encode(torch.from_numpy(toks), torch.from_numpy(lens))


def test_write_verify_is_identity_on_ideal_substrate():
    xcfg, sub = split_options({}, backend="racetrack_sim",
                              default_substrate="racetrack")
    rng = np.random.default_rng(0)
    ref = _be(_config(backend="reference"))
    protos = _encode(ref, rng.integers(0, 4, (6, 128), np.int32),
                     np.full(6, 128, np.int32))
    assert write_verify_bits(protos, xcfg, sub) is protos


@pytest.mark.parametrize("options", [
    {"shift_fault_rate": 1.0, "seed": 2},
    {"shift_fault_rate": 0.5, "stuck_on_rate": 0.05, "stuck_off_rate": 0.05,
     "seed": 7},
], ids=["all-misaligned", "shift-and-stuck"])
def test_write_verify_precompensates_and_equals_repro(community, options):
    """Exact against repro's write_verify_bits; with every track
    misaligned it recovers most of the readout error (repro's case)."""
    from repro.accel.backend_pcm import split_options as jax_split
    from repro.accel.crossbar import write_verify_bits as jax_wv
    genomes, toks, lens, _ = community
    ref = _be(_config(backend="reference"))
    q = _encode(ref, toks, lens)
    protos = _encode(ref, np.stack([np.asarray(g)[:512]
                                    for g in genomes.values()]),
                     np.full(4, 512, np.int32))
    expect = ref.agreement(q, protos)

    xcfg, sub = split_options(options, backend="racetrack_sim",
                              default_substrate="racetrack",
                              partitionable=MODE)
    fixed = write_verify_bits(protos, xcfg, sub)
    jx, jsub = jax_split(options, backend="racetrack_sim",
                         default_substrate="racetrack")
    want = np.asarray(jax_wv(jnp.asarray(convert.tensor_to_words(protos)),
                             jx, jsub))
    np.testing.assert_array_equal(convert.tensor_to_words(fixed), want)
    if options["shift_fault_rate"] == 1.0:
        naive = crossbar_agreement(q, protos, SP["dim"], xcfg, sub)
        assert (naive != expect).any()
        assert (fixed != protos).any()
        naive_err = (naive - expect).abs().float().mean()
        fixed_err = (crossbar_agreement(q, fixed, SP["dim"], xcfg, sub)
                     - expect).abs().float().mean()
        assert fixed_err < 0.6 * naive_err


def test_noise_aware_refdb_improves_and_equals_repro(community):
    """End to end at repro's sweep point: the refined build raises the
    own-species agreement the faulty device reads out, and equals
    repro's refined prototypes."""
    genomes, toks, lens, labels = community
    config = _config(shift_fault_rate=0.5, seed=3)
    db = ProfilingSession(config, device="cpu").build_refdb(genomes)
    be = _be(config)
    q = _encode(be, toks, lens)

    def own_score(refdb):
        agree = be.agreement(q, refdb.prototypes).numpy()
        own = np.where(refdb.proto_species.numpy()[None, :]
                       == labels[:, None], agree, -1)
        return own.max(axis=1).mean()

    stats = {}
    refined = noise_aware_refdb(db, genomes, config, iterations=1,
                                reads_per_species=16, read_len=64,
                                stats=stats)
    assert refined.species_names == db.species_names
    assert refined.num_species == db.num_species
    assert (refined.prototypes != db.prototypes).any()
    assert own_score(refined) > own_score(db)
    assert stats["best"] >= stats["naive"] and stats["candidates"] == 3
    assert stats["flagged"] > 0

    from repro.accel.codesign import noise_aware_refdb as jax_refine
    from repro.pipeline import ProfilingSession as JaxSession
    jcfg = _jax_config(shift_fault_rate=0.5, seed=3)
    jdb = JaxSession(jcfg).build_refdb(genomes)
    np.testing.assert_array_equal(convert.tensor_to_words(db.prototypes),
                                  np.asarray(jdb.prototypes))
    want = jax_refine(jdb, genomes, jcfg, iterations=1,
                      reads_per_species=16, read_len=64)
    np.testing.assert_array_equal(convert.tensor_to_words(refined.prototypes),
                                  np.asarray(want.prototypes))


def test_noise_aware_retraining_changes_prototypes_and_equals_repro(
        community):
    """Exact: two passes whose retraining changes prototypes (the case the
    one-pass test above does not reach: there write-verify alone wins)
    give repro's refined prototypes."""
    genomes = community[0]
    config = _config(shift_fault_rate=0.5, seed=3)
    db = ProfilingSession(config, device="cpu").build_refdb(genomes)
    stats = {}
    refined = noise_aware_refdb(db, genomes, config, iterations=2,
                                reads_per_species=16, read_len=64,
                                stats=stats)
    assert stats["candidates"] == 4 and stats["changed"] >= 1
    assert stats["best"] > stats["naive"]
    from repro.accel.codesign import noise_aware_refdb as jax_refine
    from repro.pipeline import ProfilingSession as JaxSession
    jcfg = _jax_config(shift_fault_rate=0.5, seed=3)
    want = jax_refine(JaxSession(jcfg).build_refdb(genomes), genomes, jcfg,
                      iterations=2, reads_per_species=16, read_len=64)
    np.testing.assert_array_equal(convert.tensor_to_words(refined.prototypes),
                                  np.asarray(want.prototypes))


def test_noise_aware_refdb_keeps_metadata_on_digital_backend(community):
    genomes, _, _, _ = community
    config = _config(backend="reference")
    db = ProfilingSession(config, device="cpu").build_refdb(genomes)
    out = noise_aware_refdb(db, genomes, config, iterations=1,
                            reads_per_species=8, read_len=64)
    assert out.prototypes.shape == db.prototypes.shape
    assert out.species_names == db.species_names
    assert torch.equal(out.genome_lengths, db.genome_lengths)
    from repro.accel.codesign import noise_aware_refdb as jax_refine
    from repro.pipeline import ProfilingSession as JaxSession
    jcfg = _jax_config(backend="reference")
    want = jax_refine(JaxSession(jcfg).build_refdb(genomes), genomes, jcfg,
                      iterations=1, reads_per_species=8, read_len=64)
    np.testing.assert_array_equal(convert.tensor_to_words(out.prototypes),
                                  np.asarray(want.prototypes))


def test_noise_aware_fingerprint_is_distinct():
    base = _config(shift_fault_rate=0.5, seed=3)
    aware = dataclasses.replace(base, noise_aware_refdb=True)
    aware2 = dataclasses.replace(aware, noise_aware_iters=5)
    prints = {c.refdb_fingerprint() for c in (base, aware, aware2)}
    assert len(prints) == 3
    if MODE:
        jaware = dataclasses.replace(_jax_config(shift_fault_rate=0.5,
                                                 seed=3),
                                     noise_aware_refdb=True)
        assert aware.refdb_fingerprint() == jaware.refdb_fingerprint()


def test_noise_aware_refdb_rejects_bad_inputs(community):
    genomes, _, _, _ = community
    config = _config(shift_fault_rate=0.5)
    db = ProfilingSession(config, device="cpu").build_refdb(genomes)
    with pytest.raises(ValueError, match="iterations"):
        noise_aware_refdb(db, genomes, config, iterations=0)
    with pytest.raises(KeyError, match="missing"):
        noise_aware_refdb(db, {"s0": genomes["s0"]}, config)


def test_session_refines_and_caches_noise_aware(community, tmp_path):
    """The session's build refines (no longer a refusal); the cached
    entry records ``noise_aware`` and reloads the refined prototypes,
    equal to repro's session."""
    from repro_torch.pipeline import refdb_store
    genomes = community[0]
    config = dataclasses.replace(_config(shift_fault_rate=0.5, seed=3),
                                 noise_aware_refdb=True,
                                 noise_aware_iters=1)
    s = ProfilingSession(config, device="cpu")
    db = s.build_or_load_refdb(genomes, cache_dir=tmp_path)
    m = refdb_store.manifest(s.refdb_cache_file)
    assert m["noise_aware"] == {"backend": "racetrack_sim",
                                "backend_options": [["seed", 3],
                                                    ["shift_fault_rate",
                                                     0.5]],
                                "iters": 1}
    again = ProfilingSession(config, device="cpu")
    again.build_or_load_refdb(genomes, cache_dir=tmp_path)
    assert again.refdb_loaded_from_cache
    assert torch.equal(again.refdb.prototypes, db.prototypes)
    assert torch.equal(ProfilingSession(config, device="cpu").build_refdb(
        genomes).prototypes, db.prototypes)
    from repro.pipeline import ProfilingSession as JaxSession
    jcfg = dataclasses.replace(_jax_config(shift_fault_rate=0.5, seed=3),
                               noise_aware_refdb=True, noise_aware_iters=1)
    np.testing.assert_array_equal(
        convert.tensor_to_words(db.prototypes),
        np.asarray(JaxSession(jcfg).build_refdb(genomes).prototypes))


def test_profile_run_noise_aware_cli(tmp_path, capsys):
    """``profile_run --synthetic --backend pcm_sim --backend-option
    preset=pcm --noise-aware-refdb --device cpu`` at a small D exits 0
    (it was a CLI error), and its cached entry records ``noise_aware``."""
    from repro_torch.launch import profile_run
    from repro_torch.pipeline import refdb_store
    profile_run.main([
        "--synthetic", "--backend", "pcm_sim", "--backend-option",
        "preset=pcm", "--noise-aware-refdb", "--noise-aware-iters", "1",
        "--device", "cpu", "--dim", "512", "--ngram", "5", "--window",
        "4096", "--cache-dir", str(tmp_path), "--json",
        str(tmp_path / "report.json")] + (
            [] if MODE else ["--no-threefry-partitionable"]))
    out = capsys.readouterr().out
    assert "backend pcm_sim" in out and "vs ground truth" in out
    entries = sorted(tmp_path.glob("refdb_*.npz"))
    assert len(entries) == 1
    m = refdb_store.manifest(entries[0])
    assert m["noise_aware"] == {"backend": "pcm_sim",
                                "backend_options": [["preset", "pcm"]],
                                "iters": 1}
    assert (tmp_path / "report.json").exists()
