"""The shared substrate contract on the port's registry, plus parity with
``repro``'s ``pcm_sim`` and ``racetrack_sim``.

Every case of ``tests/test_substrate_contract.py`` at its sizes
(``HDSpace(dim=512, ngram=5)``), parametrized over the port's
``available_substrates()``: zero-noise bit-exactness with ``reference``
(exact), seeded determinism, the fault census, the options-schema round
trip, cross-substrate knobs, the uniform unknown-option error on every
backend, and the substrates' cost entries.  Then the parity cases: each
substrate backend's agreement equal to ``repro``'s on the same packed
inputs -- exact at zero noise and under stuck-at / shift faults (weights
stay in {0, 1}); noisy presets (programming noise, read noise) checked
for exact equality too at this size, where none of the 72 sums sits on
an ADC rounding boundary (the near-exact bound is measured at a larger
size in ``tests/test_torch_accel.py``).  Every port backend runs in the
installed jax's threefry mode.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro_torch import convert
from repro_torch.accel.substrate import (available_substrates,
                                         narrowed_schema, resolve_substrate,
                                         substrate_options)
from repro_torch.core.hd_space import HDSpace
from repro_torch.pipeline.backend import (available_backends, options_schema,
                                          resolve_backend)
from repro_torch.pipeline.config import ProfilerConfig
from repro_torch.pipeline.options import OptionError

SP = dict(dim=512, ngram=5, z_threshold=3.0)
MODE = bool(jax.config.jax_threefry_partitionable)

FAULT_OPTIONS = {
    "pcm": {"stuck_on_rate": 0.5, "stuck_off_rate": 0.25},
    "racetrack": {"stuck_on_rate": 0.5, "stuck_off_rate": 0.25,
                  "shift_fault_rate": 0.5},
}
CENSUS_KEYS = {
    "pcm": {"on", "off"},
    "racetrack": {"on", "off", "misaligned"},
}


def _config(backend="pcm_sim", **options):
    return ProfilerConfig(space=HDSpace(**SP), window=1024, batch_size=16,
                          backend=backend, backend_options=options,
                          threefry_partitionable=MODE)


def _resolve(backend, config):
    return resolve_backend(backend, config, device="cpu")


@pytest.fixture(scope="module")
def workload():
    ref = _resolve("reference", _config(backend="reference"))
    rng = np.random.default_rng(7)
    toks = torch.from_numpy(rng.integers(0, 4, (12, 96), np.int32))
    lens = torch.full((12,), 96, dtype=torch.int32)
    q = ref.encode(toks, lens)
    protos = ref.encode(torch.from_numpy(rng.integers(0, 4, (6, 96),
                                                      np.int32)),
                        torch.full((6,), 96, dtype=torch.int32))
    return q, protos, ref.agreement(q, protos)


def test_substrate_registry_is_populated():
    assert {"pcm", "racetrack"} <= set(available_substrates())


@pytest.mark.parametrize("substrate", ["pcm", "racetrack"])
@pytest.mark.parametrize("carrier", ["pcm_sim", "racetrack_sim"])
def test_zero_noise_bit_exact_with_reference(workload, carrier, substrate):
    """Exact: an ideal device of any substrate, through either substrate
    backend, reproduces the reference agreement bit for bit."""
    q, protos, expect = workload
    be = _resolve(carrier, _config(backend=carrier, substrate=substrate))
    assert torch.equal(be.agreement(q, protos), expect)


@pytest.mark.parametrize("substrate", ["pcm", "racetrack"])
def test_seeded_determinism(workload, substrate):
    q, protos, expect = workload
    noisy = dict(FAULT_OPTIONS[substrate], read_sigma=0.3, seed=5,
                 substrate=substrate)
    a1 = _resolve("pcm_sim", _config(**noisy)).agreement(q, protos)
    a2 = _resolve("pcm_sim", _config(**noisy)).agreement(q, protos)
    assert torch.equal(a1, a2)
    a3 = _resolve("pcm_sim", _config(**dict(noisy, seed=6))).agreement(
        q, protos)
    assert (a1 != a3).any()
    assert (a1 != expect).any()     # the noise actually bites


@pytest.mark.parametrize("substrate", ["pcm", "racetrack"])
def test_fault_census_counts_and_reproducibility(substrate):
    """Exact against repro's census of the same device (the counts come
    from the same uniform draws)."""
    sub = resolve_substrate(substrate, FAULT_OPTIONS[substrate],
                            partitionable=MODE)
    shape = (4, 64, 128)            # (tiles, prototypes, rows)
    census = sub.fault_census(shape, stream=0)
    assert set(census) == CENSUS_KEYS[substrate]
    assert all(isinstance(v, int) and v >= 0 for v in census.values())
    total = int(np.prod(shape))
    assert 0 < census["on"] < total
    assert 0 < census["off"] < total
    assert sub.fault_census(shape, stream=0) == census
    other = resolve_substrate(substrate,
                              dict(FAULT_OPTIONS[substrate], seed=99),
                              partitionable=MODE)
    assert other.fault_census(shape, stream=0) != census
    from repro.accel.substrate import resolve_substrate as jax_resolve
    for stream in (0, 1):
        assert sub.fault_census(shape, stream=stream) == jax_resolve(
            substrate, FAULT_OPTIONS[substrate]).fault_census(
                shape, stream=stream)


@pytest.mark.parametrize("substrate", ["pcm", "racetrack"])
def test_ideal_substrate_census_is_empty(substrate):
    sub = resolve_substrate(substrate, {})
    assert sub.is_ideal
    census = sub.fault_census((2, 16, 32), stream=0)
    assert set(census) == CENSUS_KEYS[substrate]
    assert all(v == 0 for v in census.values())


@pytest.mark.parametrize("substrate", ["pcm", "racetrack"])
def test_options_schema_round_trip(substrate):
    schema = narrowed_schema("pcm_sim", substrate)
    declared = {o.name for o in substrate_options(substrate)}
    assert declared <= {o.name for o in schema.options}
    for opt in schema.options:
        if opt.default is None or opt.name == "substrate":
            continue
        own, rest = schema.split({opt.name: opt.default})
        assert own == {opt.name: opt.default} and rest == {}
        assert schema.parse_cli(opt.name, str(opt.default)) == opt.default


@pytest.mark.parametrize("substrate", ["pcm", "racetrack"])
def test_cross_substrate_knob_rejected(substrate):
    foreign = {"pcm": "shift_fault_rate", "racetrack": "prog_sigma"}
    with pytest.raises(OptionError, match="got unknown option"):
        _resolve("pcm_sim", _config(substrate=substrate,
                                    **{foreign[substrate]: 0.1}))


@pytest.mark.parametrize("backend", ["reference", "reference_packed",
                                     "cuda_matmul", "cuda_packed",
                                     "cuda_fused", "pcm_sim",
                                     "racetrack_sim", "sharded"])
def test_misspelled_option_fails_identically_everywhere(backend):
    assert backend in available_backends()
    with pytest.raises(OptionError, match=r"got unknown option 'zzz_bogus'"):
        _resolve(backend, _config(backend=backend, zzz_bogus=1))


@pytest.mark.parametrize("backend", ["pcm_sim", "racetrack_sim"])
def test_substrate_backends_declare_repro_schemas(backend):
    """The union schema lists repro's option rows, in repro's words."""
    from repro.pipeline.backend import options_schema as jax_schema
    schema = options_schema(backend)
    assert schema.backend == backend
    assert schema.describe() == jax_schema(backend).describe()


def test_substrate_cost_models_disagree():
    """Exact: each substrate's cost entry equals repro's field for
    field."""
    import dataclasses
    from repro.accel.crossbar import CrossbarConfig as JaxXcfg
    from repro.accel.substrate import resolve_substrate as jax_resolve
    from repro_torch.accel.crossbar import CrossbarConfig
    pcm = resolve_substrate("pcm", {})
    rt = resolve_substrate("racetrack", {})
    a = pcm.cost(64, SP["dim"], 100, SP["ngram"], CrossbarConfig())
    b = rt.cost(64, SP["dim"], 100, SP["ngram"], CrossbarConfig())
    assert a.substrate == "pcm" and b.substrate == "racetrack"
    assert a.shift_pj == 0.0 and b.shift_pj > 0.0
    assert {n: e for n, e, _ in b.energy_rows()}.get("shift", 0.0) > 0.0
    for name, got in (("pcm", a), ("racetrack", b)):
        want = jax_resolve(name, {}).cost(64, SP["dim"], 100, SP["ngram"],
                                          JaxXcfg())
        assert dataclasses.asdict(got) == dataclasses.asdict(want)


# -- parity with repro's substrate backends ----------------------------------

PARITY_CASES = [
    ("pcm_sim", {}),
    ("racetrack_sim", {}),
    ("pcm_sim", {"adc_bits": 4}),
    ("pcm_sim", {"stuck_on_rate": 0.3, "stuck_off_rate": 0.2}),
    ("racetrack_sim", {"shift_fault_rate": 0.5, "stuck_on_rate": 0.1}),
    ("pcm_sim", {"preset": "pcm", "seed": 11}),
    ("racetrack_sim", {"preset": "racetrack", "read_sigma": 0.3}),
    ("pcm_sim", {"drift_nu": 0.05, "drift_t_s": 86_400.0,
                 "drift_calibration": 0.0}),
]


@pytest.mark.parametrize("backend,options", PARITY_CASES,
                         ids=[f"{b}-{'-'.join(o) or 'ideal'}"
                              for b, o in PARITY_CASES])
def test_agreement_equals_repro(workload, backend, options):
    from repro.core.hd_space import HDSpace as JaxSpace
    from repro.pipeline import ProfilerConfig as JaxConfig
    from repro.pipeline import resolve_backend as jax_resolve
    q, protos, _ = workload
    jbe = jax_resolve(backend, JaxConfig(
        space=JaxSpace(**SP), window=1024, batch_size=16, backend=backend,
        backend_options=options))
    want = np.asarray(jbe.agreement(convert.tensor_to_words(q),
                                    convert.tensor_to_words(protos)))
    got = _resolve(backend, _config(backend=backend, **options)).agreement(
        q, protos)
    np.testing.assert_array_equal(got.numpy(), want)


def test_list_backends_shows_the_union_schemas(capsys):
    """``profile_run --list-backends`` lists both substrate backends with
    their union schemas, row for row as ``repro`` declares them."""
    from repro.pipeline.backend import options_schema as jax_schema
    from repro_torch.launch import profile_run
    profile_run.main(["--list-backends"])
    out = capsys.readouterr().out.splitlines()
    for backend in ("pcm_sim", "racetrack_sim"):
        i = out.index(backend)
        rows = jax_schema(backend).describe()
        assert out[i + 1:i + 1 + len(rows)] == [f"  {r}" for r in rows]
    assert any(r.startswith("  preset=ideal|pcm|racetrack") for r in out)
