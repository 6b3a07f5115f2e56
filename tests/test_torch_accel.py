"""The port's device model (``repro_torch.accel``) against ``repro.accel``.

The cases of ``tests/test_accel.py`` -- zero-noise bit-exactness, tiling
edge cases, the lossy ADC, per-seed determinism, read noise keyed by
batch content, stuck-on saturation, uncalibrated drift, programming once
per prototype tensor, options plumbing, the cost model and the sweep --
each also held against ``repro`` on the same numpy inputs, plus the read
of ``repro``'s own programmed banks (``convert.banks_from_repro``), which
separates read parity from programming parity.  Each case says which
parity it checks:

* exact: every configuration whose weights stay in {0, 1} (zero noise,
  stuck-at faults, racetrack shift faults, a lossy ADC at zero noise),
  the fault census, ``rebinarize_counters``, the batch digest and
  ``cost.py``; at the small sizes here the noisy presets come out equal
  too;
* near-exact: noisy configurations at a larger size
  (:func:`test_noisy_near_exact_at_width`): float32 sums of noisy weights
  run in another order than XLA's, so a sum on an ADC rounding boundary
  may round the other way.  Measured at D = 4,096, 128 x 300, preset
  ``pcm``: 1 of 38,400 agreements (2.6e-5) differed, by one count; the
  tolerance is 2e-4 of the agreements, each by at most one ADC step.

Every port backend runs in the installed jax's threefry mode.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp

from repro_torch import convert
from repro_torch.accel import (CrossbarConfig, DeviceConfig, accel_cost,
                               adc_quantize, crossbar, noise_sweep,
                               racetrack_cost)
from repro_torch.core import assoc_memory
from repro_torch.core.hd_space import HDSpace
from repro_torch.genomics import synth
from repro_torch.pipeline import (ArraySource, ProfilerConfig,
                                  ProfilingSession, available_backends,
                                  resolve_backend)

SP = dict(dim=512, ngram=5, z_threshold=3.0)
MODE = bool(jax.config.jax_threefry_partitionable)
NEAR_EXACT_SHARE = 2e-4


def _config(**kw):
    kw.setdefault("space", HDSpace(**SP))
    kw.setdefault("window", 1024)
    kw.setdefault("batch_size", 16)
    kw.setdefault("backend", "pcm_sim")
    kw.setdefault("threefry_partitionable", MODE)
    return ProfilerConfig(**kw)


def _jax_config(**kw):
    from repro.core.hd_space import HDSpace as JaxSpace
    from repro.pipeline import ProfilerConfig as JaxConfig
    kw.setdefault("space", JaxSpace(**SP))
    kw.setdefault("window", 1024)
    kw.setdefault("batch_size", 16)
    kw.setdefault("backend", "pcm_sim")
    return JaxConfig(**kw)


def _be(config):
    return resolve_backend(config.backend, config, device="cpu")


def _repro_agreement(q, protos, backend="pcm_sim", **options):
    from repro.pipeline import resolve_backend as jax_resolve
    jbe = jax_resolve(backend, _jax_config(backend=backend,
                                           backend_options=options))
    return np.asarray(jbe.agreement(convert.tensor_to_words(q),
                                    convert.tensor_to_words(protos)))


@pytest.fixture(scope="module")
def packed():
    """(queries, prototypes, reference agreement) on the shared space."""
    ref = _be(_config(backend="reference"))
    rng = np.random.default_rng(3)
    toks = torch.from_numpy(rng.integers(0, 4, (16, 64)).astype(np.int32))
    lens = torch.full((16,), 64, dtype=torch.int32)
    q = ref.encode(toks, lens)
    protos = q[:7].clone()               # S=7: not a multiple of anything
    return q, protos, ref.agreement(q, protos)


# -- zero-noise bit-exactness (exact) -----------------------------------------

def test_pcm_sim_registered():
    assert {"pcm_sim", "racetrack_sim"} <= set(available_backends())


def test_zero_noise_matches_reference_exactly(packed):
    q, protos, a_ref = packed
    got = _be(_config()).agreement(q, protos)
    assert torch.equal(got, a_ref)
    np.testing.assert_array_equal(got.numpy(), _repro_agreement(q, protos))


@pytest.mark.parametrize("rows,cols", [(64, 4), (100, 3), (512, 256),
                                       (1024, 7)])
def test_tiling_edge_cases_stay_exact(packed, rows, cols):
    """Exact: partial tiles must not leak padding into the agreement."""
    q, protos, a_ref = packed
    opts = dict(rows=rows, cols=cols, adc_bits=11)
    got = _be(_config().with_options(**opts)).agreement(q, protos)
    assert torch.equal(got, a_ref)
    np.testing.assert_array_equal(got.numpy(),
                                  _repro_agreement(q, protos, **opts))


def test_single_prototype_exact(packed):
    q, protos, a_ref = packed
    got = _be(_config()).agreement(q, protos[:1].clone())
    assert torch.equal(got, a_ref[:, :1])


def test_lossy_adc_quantizes_but_stays_in_range(packed):
    """Exact against repro (zero noise, weights in {0, 1})."""
    q, protos, a_ref = packed
    got = _be(_config().with_options(adc_bits=4)).agreement(q, protos)
    assert not torch.equal(got, a_ref)              # 15 levels < 256 counts
    assert got.min() >= 0 and got.max() <= SP["dim"]
    step = 256 / 15
    assert torch.diag(got[:7]).min() >= SP["dim"] - 4 * (step / 2) - 1
    np.testing.assert_array_equal(got.numpy(),
                                  _repro_agreement(q, protos, adc_bits=4))


# -- seeded determinism of the noisy path ---------------------------------------

def test_noisy_path_is_deterministic_per_seed(packed):
    """Equal to repro at this size (see the module note)."""
    q, protos, a_ref = packed
    cfg = _config().with_options(preset="pcm", seed=11)
    a1 = _be(cfg).agreement(q, protos)
    a2 = _be(cfg).agreement(q, protos)
    assert torch.equal(a1, a2)
    assert not torch.equal(a1, a_ref)               # noise really applied
    a3 = _be(_config().with_options(preset="pcm", seed=12)).agreement(
        q, protos)
    assert not torch.equal(a1, a3)                  # seed is load-bearing
    np.testing.assert_array_equal(
        a1.numpy(), _repro_agreement(q, protos, preset="pcm", seed=11))


def test_read_noise_keyed_by_batch_content(packed):
    """Replaying a batch reproduces its noise; the same queries in another
    batch draw fresh noise -- each read equal to repro's."""
    q, protos, _ = packed
    be = _be(_config().with_options(read_sigma=0.5))
    a_first = be.agreement(q, protos)
    assert torch.equal(a_first, be.agreement(q, protos))
    a_sub = be.agreement(q[:8].clone(), protos)         # different digest
    assert not torch.equal(a_sub, a_first[:8])
    np.testing.assert_array_equal(
        a_first.numpy(), _repro_agreement(q, protos, read_sigma=0.5))
    np.testing.assert_array_equal(
        a_sub.numpy(), _repro_agreement(q[:8], protos, read_sigma=0.5))


def test_batch_digest_is_reproes_uint32_sum(packed):
    """Exact: the read-event digest is jnp.sum(queries, dtype=uint32)."""
    q = packed[0]
    want = int(jnp.sum(jnp.asarray(convert.tensor_to_words(q)),
                       dtype=jnp.uint32))
    assert crossbar.batch_digest(q) == want


def test_stuck_on_saturates_agreement(packed):
    q, protos, _ = packed
    got = _be(_config().with_options(stuck_on_rate=1.0)).agreement(
        q, protos)
    assert torch.equal(got, torch.full((16, 7), SP["dim"],
                                       dtype=torch.int32))


def test_uncalibrated_drift_reads_low(packed):
    q, protos, a_ref = packed
    opts = dict(drift_nu=0.05, drift_t_s=86_400.0, drift_calibration=0.0)
    got = _be(_config().with_options(**opts)).agreement(q, protos)
    assert got.float().mean() < a_ref.float().mean() * 0.75
    np.testing.assert_array_equal(got.numpy(),
                                  _repro_agreement(q, protos, **opts))
    calibrated = dict(opts, drift_calibration=1.0)       # exact again
    assert torch.equal(_be(_config().with_options(**calibrated)).agreement(
        q, protos), a_ref)


def test_stuck_and_shift_faults_exact_against_repro(packed):
    """Exact: stuck-at and racetrack shift faults keep weights in {0, 1}."""
    q, protos, _ = packed
    for backend, opts in (
            ("pcm_sim", {"stuck_on_rate": 0.2, "stuck_off_rate": 0.1}),
            ("racetrack_sim", {"shift_fault_rate": 0.4}),
            ("racetrack_sim", {"shift_fault_rate": 1.0, "seed": 2,
                               "stuck_off_rate": 0.05})):
        got = _be(_config(backend=backend).with_options(**opts)).agreement(
            q, protos)
        np.testing.assert_array_equal(
            got.numpy(), _repro_agreement(q, protos, backend, **opts))


def test_noisy_near_exact_at_width():
    """Near-exact: D = 4,096, 128 random queries x 300 prototypes, preset
    pcm; at most NEAR_EXACT_SHARE of the agreements differ, each by one
    count (measured: 1 of 38,400)."""
    rng = np.random.default_rng(5)
    d = 4096
    q = rng.integers(0, 2 ** 32, (128, d // 32), dtype=np.uint32)
    p = rng.integers(0, 2 ** 32, (300, d // 32), dtype=np.uint32)
    opts = {"preset": "pcm", "seed": 11}
    from repro.core.hd_space import HDSpace as JaxSpace
    from repro.pipeline import resolve_backend as jax_resolve
    want = np.asarray(jax_resolve("pcm_sim", _jax_config(
        space=JaxSpace(dim=d, ngram=5), backend_options=opts)).agreement(
            q, p))
    got = _be(_config(space=HDSpace(dim=d, ngram=5),
                      backend_options=opts)).agreement(
        convert.words_to_tensor(q), convert.words_to_tensor(p)).numpy()
    diff = np.abs(got.astype(np.int64) - want)
    assert diff.max() <= 1
    assert (diff > 0).mean() <= NEAR_EXACT_SHARE


def test_read_of_repros_banks(packed):
    """Read parity alone: repro's programmed banks, carried across with
    ``convert.banks_from_repro``, read by the port's ``crossbar_read``
    equal repro's read of them (exact at this size), and the port's own
    banks equal repro's (exact without programming noise)."""
    from repro.accel.backend_pcm import split_options as jax_split
    from repro.accel.crossbar import crossbar_read as jax_read
    from repro.accel.crossbar import program_prototypes as jax_program
    from repro_torch.accel.backend_pcm import split_options
    q, protos, _ = packed
    qw, pw = convert.tensor_to_words(q), convert.tensor_to_words(protos)
    for opts in ({"preset": "pcm", "seed": 4},
                 {"stuck_on_rate": 0.1, "read_sigma": 0.4},
                 {"substrate": "racetrack", "preset": "racetrack",
                  "shift_fault_rate": 0.3}):
        jx, jsub = jax_split(opts)
        s_pos, s_neg = jax_program(jnp.asarray(pw), jx, jsub)
        want = np.asarray(jax_read(jnp.asarray(qw), s_pos, s_neg, SP["dim"],
                                   jx, jsub))
        xcfg, sub = split_options(opts, partitionable=MODE)
        t_pos, t_neg = convert.banks_from_repro(np.asarray(s_pos),
                                                np.asarray(s_neg),
                                                device="cpu")
        got = crossbar.crossbar_read(q, t_pos, t_neg, SP["dim"], xcfg, sub)
        np.testing.assert_array_equal(got.numpy(), want)
        own = crossbar.program_prototypes(protos, xcfg, sub)
        back = convert.banks_to_repro(*own)
        if "preset" in opts and opts.get("substrate") != "racetrack":
            # programming noise: near-exact (the same draws, float32 sums)
            for a, b in zip(back, (s_pos, s_neg)):
                np.testing.assert_allclose(a, np.asarray(b), rtol=0,
                                           atol=1e-5)
        else:
            for a, b in zip(back, (s_pos, s_neg)):
                np.testing.assert_array_equal(a, np.asarray(b))


# -- backend_options plumbing -----------------------------------------------------

def test_options_canonicalized_and_hashable():
    cfg = _config(backend_options={"read_sigma": 0.1, "adc_bits": 8})
    assert cfg.backend_options == (("adc_bits", 8), ("read_sigma", 0.1))
    assert hash(cfg) == hash(_config(
        backend_options=[("read_sigma", 0.1), ("adc_bits", 8)]))
    assert cfg.options == {"adc_bits": 8, "read_sigma": 0.1}


def test_options_json_roundtrip_and_fingerprint():
    cfg = _config(backend_options={"preset": "pcm", "seed": 3})
    assert ProfilerConfig.from_json(cfg.to_json()) == cfg
    assert cfg.fingerprint() != _config().fingerprint()
    assert cfg.refdb_fingerprint() == _config().refdb_fingerprint()
    if MODE:    # the default mode's fingerprints are repro's
        jcfg = _jax_config(backend_options={"preset": "pcm", "seed": 3})
        assert (cfg.fingerprint(), cfg.refdb_fingerprint()) == \
            (jcfg.fingerprint(), jcfg.refdb_fingerprint())


def test_with_options_merges():
    cfg = _config(backend_options={"read_sigma": 0.1})
    out = cfg.with_options(prog_sigma=0.2, read_sigma=0.3)
    assert out.options == {"read_sigma": 0.3, "prog_sigma": 0.2}


def test_invalid_options_rejected():
    with pytest.raises(ValueError, match="duplicate"):
        _config(backend_options=[("a", 1), ("a", 2)])
    with pytest.raises(ValueError, match="JSON primitive"):
        _config(backend_options={"a": [1, 2]})
    with pytest.raises(ValueError, match="non-empty string"):
        _config(backend_options={"": 1})


def test_unknown_pcm_option_and_preset_rejected():
    with pytest.raises(ValueError,
                       match="pcm_sim got unknown option 'nonsense'"):
        _be(_config().with_options(nonsense=1))
    with pytest.raises(ValueError, match="'preset' must be one of"):
        _be(_config().with_options(preset="tpu"))
    with pytest.raises(ValueError, match="shift_fault_rate"):
        _be(_config().with_options(shift_fault_rate=0.1))


def test_mistyped_option_values_rejected():
    with pytest.raises(ValueError, match="'rows' must be an integer"):
        _be(_config().with_options(rows="abc"))
    with pytest.raises(ValueError, match="'seed' must be an integer"):
        _be(_config().with_options(seed=1.5))
    with pytest.raises(ValueError, match="'read_sigma' must be a number"):
        _be(_config().with_options(read_sigma="x"))


def test_prototypes_programmed_once_per_array(packed):
    """Write-once: repeated reads of one prototype tensor program the
    banks once; a new tensor object reprograms."""
    q, protos, a_ref = packed
    be = _be(_config())
    calls = []
    real = be._program
    be._program = lambda p: (calls.append(1), real(p))[1]
    for _ in range(3):
        assert torch.equal(be.agreement(q, protos), a_ref)
    assert len(calls) == 1
    be.agreement(q, protos[:3].clone())
    assert len(calls) == 2


def test_device_config_validation():
    with pytest.raises(ValueError):
        DeviceConfig(g_on_us=1.0, g_off_us=2.0)
    with pytest.raises(ValueError):
        DeviceConfig(prog_sigma=-0.1)
    with pytest.raises(ValueError):
        DeviceConfig(stuck_on_rate=0.7, stuck_off_rate=0.7)
    with pytest.raises(ValueError):
        CrossbarConfig(adc_bits=0)
    assert DeviceConfig().is_ideal
    assert not DeviceConfig.pcm().is_ideal


# -- ADC model (exact) -------------------------------------------------------------

def test_adc_lossless_is_identity_on_counts():
    cfg = CrossbarConfig(rows=256, adc_bits=9)
    assert cfg.lossless
    counts = torch.arange(257.0)
    assert torch.equal(adc_quantize(counts, cfg), counts)


@pytest.mark.parametrize("adc_bits", [3, 4, 7])
def test_adc_lossy_snaps_to_grid_as_repro(adc_bits):
    """Exact, half-way values included: jnp.round and torch.round both
    round half to even on ``count / step``."""
    from repro.accel.crossbar import CrossbarConfig as JaxXcfg
    from repro.accel.crossbar import adc_quantize as jax_adc
    cfg = CrossbarConfig(rows=256, adc_bits=adc_bits)
    assert not cfg.lossless
    step = 256 / ((1 << adc_bits) - 1)
    counts = np.concatenate([np.arange(-3, 261, 0.25),
                             (np.arange(0, 40) + 0.5) * step]
                            ).astype(np.float32)
    got = adc_quantize(torch.from_numpy(counts), cfg).numpy()
    want = np.asarray(jax_adc(jnp.asarray(counts), JaxXcfg(
        rows=256, adc_bits=adc_bits)))
    np.testing.assert_array_equal(got, want)
    assert len(np.unique(got)) <= 1 << adc_bits


# -- cost model (exact) -------------------------------------------------------------

def test_cost_model_breakdown_consistent():
    c = accel_cost(num_protos=100, dim=2048, read_len=150, ngram=16,
                   xcfg=CrossbarConfig(rows=256, cols=256))
    assert c.num_arrays == 2 * 8 * 1
    assert c.total_pj == pytest.approx(
        sum(pj for _, pj, _ in c.energy_rows()))
    assert sum(pct for _, _, pct in c.energy_rows()) == pytest.approx(100.0)
    assert c.total_area_mm2 > 0 and c.latency_ns > 0
    assert c.mbp_per_joule(150) > 0
    c2 = accel_cost(num_protos=1000, dim=2048, read_len=150, ngram=16)
    assert c2.num_arrays > c.num_arrays
    assert c2.total_pj > c.total_pj


@pytest.mark.parametrize("args", [(100, 2048, 150, 16), (9780, 40960, 150, 16),
                                  (7, 512, 64, 5)])
def test_cost_reports_equal_repros(args):
    from repro.accel import cost as jax_cost
    from repro.accel.crossbar import CrossbarConfig as JaxXcfg
    for rows, cols, levels in ((256, 256, 2), (128, 64, 4)):
        got = accel_cost(*args, CrossbarConfig(rows=rows, cols=cols),
                         levels=levels)
        want = jax_cost.accel_cost(*args, JaxXcfg(rows=rows, cols=cols),
                                   levels=levels)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert got.total_pj == want.total_pj
        assert got.energy_rows() == want.energy_rows()
        got = racetrack_cost(*args, CrossbarConfig(rows=rows, cols=cols),
                             ports=2, tr_span=3)
        want = jax_cost.racetrack_cost(*args, JaxXcfg(rows=rows, cols=cols),
                                       ports=2, tr_span=3)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert got.mbp_per_joule(150) == want.mbp_per_joule(150)


def test_rebinarize_counters_equals_repro():
    from repro.core import assoc_memory as jax_am
    rng = np.random.default_rng(2)
    counters = rng.integers(-3, 4, (5, 128)).astype(np.int32)
    fallback = rng.integers(0, 2, (5, 128)).astype(np.uint8)
    got = assoc_memory.rebinarize_counters(torch.from_numpy(counters),
                                           torch.from_numpy(fallback))
    np.testing.assert_array_equal(
        convert.tensor_to_words(got),
        np.asarray(jax_am.rebinarize_counters(counters, fallback)))
    # an untouched row packs back byte-identical
    bits = torch.from_numpy(fallback)
    same = assoc_memory.rebinarize_counters(torch.zeros(5, 128,
                                                        dtype=torch.int32),
                                            bits)
    assert torch.equal(same, assoc_memory.rebinarize_counters(
        2 * bits.to(torch.int32) - 1, bits))


# -- sweep harness -------------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny_community():
    spec = synth.CommunitySpec(num_species=3, genome_len=4_000, seed=5)
    genomes = synth.make_reference_genomes(spec)
    ab = np.array([0.5, 0.5, 0.0])
    toks, lens, _ = synth.sample_reads(genomes, ab, 64, spec)
    return genomes, toks, lens, ab


def test_noise_sweep_zero_level_matches_reference(tiny_community):
    genomes, toks, lens, ab = tiny_community
    points = noise_sweep(genomes, toks, lens, ab, config=_config(),
                         knob="read_sigma", levels=(0.0, 0.3), device="cpu")
    assert [p.value for p in points] == [0.0, 0.3]
    ref = ProfilingSession(_config(backend="reference"), device="cpu")
    ref.build_refdb(genomes)
    rep = ref.profile(ArraySource(toks, lens))
    np.testing.assert_array_equal(points[0].report.abundance, rep.abundance)
    assert 0.0 <= points[0].metrics.precision <= 1.0
    assert 0.0 <= points[0].unmapped_frac <= 1.0
    # each point's report equals repro's sweep point
    from repro.accel import noise_sweep as jax_sweep
    want = jax_sweep(genomes, toks, lens, ab, config=_jax_config(),
                     knob="read_sigma", levels=(0.0, 0.3))
    for p, w in zip(points, want):
        assert p.report.to_dict() == w.report.to_dict()
        assert p.row() == w.row()


def test_noise_sweep_rejects_unknown_knob(tiny_community):
    genomes, toks, lens, ab = tiny_community
    with pytest.raises(ValueError, match="unknown sweep knob"):
        noise_sweep(genomes, toks, lens, ab, config=_config(),
                    knob="voltage", levels=(1.0,), device="cpu")


def test_bitline_read_noise_one_event_as_repro():
    """Near-exact (normals within the stated ulp): the one-event form of
    the PCM read noise, ``std(active_rows) * normal(key, shape)``."""
    from repro.accel import device as jax_device
    from repro_torch.accel import device
    cfg = DeviceConfig.pcm(read_sigma=0.2, seed=9)
    active = np.array([[0.0], [3.0], [128.0], [256.0]], np.float32)
    key = device.read_event_key(cfg, 1, 0xDEADBEEF)
    got = device.bitline_read_noise(key, (4, 300), torch.from_numpy(active),
                                    cfg, partitionable=MODE).numpy()
    jcfg = jax_device.DeviceConfig.pcm(read_sigma=0.2, seed=9)
    want = np.asarray(jax_device.bitline_read_noise(
        jax_device.read_event_key(jcfg, 1, 0xDEADBEEF), (4, 300),
        jnp.asarray(active), jcfg))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    assert (got[0] == 0).all()
    assert not device.bitline_read_noise(
        key, (2, 3), torch.ones(2, 1), DeviceConfig(), partitionable=MODE
    ).any()
