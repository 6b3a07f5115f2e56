"""The port's simulated PCM crossbars (``pcm_sim``) against the plain
reference of the benchmark, ``perfbench/reference/crossbar.py``, at a
small size on the CPU, and the chunked read that lets one read event run
under a byte cap.

* A ``pcm_sim`` session at preset ``pcm`` gives species scores within one
  count of the reference's, at most ``NEAR_SHARE`` of them off by one
  (float32 sums of noisy weights in another order may round a tile's
  count the other way), in both threefry modes; at preset ``ideal`` its
  scores equal the digital reference's bit for bit.
* ``read_banks`` in chunks of row tiles (the byte cap patched down)
  equals the one-chunk read bit for bit, agreements and the ADC clip
  count, on both substrates.
* The backend times each programming event (``program_seconds``), and
  with metrics on records it in ``<prefix>_program_seconds``.
* The reference's Threefry block function equals the frozen one it is
  copied from, and importing the reference loads nothing of the program
  or of JAX.
"""

import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = pathlib.Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from perfbench import check as bench_check  # noqa: E402
from perfbench.reference import crossbar as ref_xbar  # noqa: E402
from perfbench.reference import hdc as ref_hdc  # noqa: E402
from perfbench.reference import threefry as ref_threefry  # noqa: E402
from repro_torch.accel import crossbar  # noqa: E402
from repro_torch.accel.backend_pcm import split_options  # noqa: E402
from repro_torch.core import bitops  # noqa: E402
from repro_torch.core import threefry as tf_core  # noqa: E402
from repro_torch.core.hd_space import HDSpace  # noqa: E402
from repro_torch.kernels import threefry  # noqa: E402
from repro_torch.pipeline import ProfilerConfig, ProfilingSession  # noqa: E402

NEAR_SHARE = 1e-3
SPACE = dict(dim=2048, ngram=8, z_threshold=3.0)
WINDOW, SPECIES, GENOME, BATCH = 256, 4, 13_000, 64


@pytest.fixture(scope="module")
def community():
    rng = np.random.default_rng(2027)
    genomes = rng.integers(0, 4, (SPECIES, GENOME)).astype(np.uint8)
    starts = rng.integers(0, GENOME - 150, BATCH)
    species = rng.integers(0, SPECIES, BATCH)
    reads = genomes[species[:, None], starts[:, None] + np.arange(150)]
    return genomes, reads.astype(np.int32)


def _config_dict(options):
    return {"space": dict(SPACE, alphabet_size=4, density=0.5, seed=0x5EED),
            "window": WINDOW, "stride": WINDOW, "backend_options": options}


def _session(genomes, options, partitionable):
    cfg = ProfilerConfig(space=HDSpace(**SPACE), window=WINDOW,
                         batch_size=BATCH, backend="pcm_sim",
                         backend_options=options,
                         threefry_partitionable=partitionable)
    s = ProfilingSession(cfg, device="cpu")
    s.build_refdb({f"s{i}": g for i, g in enumerate(genomes)})
    return s


def _program_and_reference(community, options, partitionable):
    genomes, reads = community
    s = _session(genomes, options, partitionable)
    lens = np.full(len(reads), reads.shape[1])
    res = s.classify_batch(reads, lens)
    queries = s.encode_reads(reads, lens)
    ref = bench_check.Reference(_config_dict(options), genomes, "cpu")
    assert s.refdb.num_prototypes == ref.num_prototypes
    banks = ref_xbar.program(s.refdb.prototypes, SPACE["dim"],
                             ref_xbar.Device.from_options(options),
                             partitionable)
    want = ref_xbar.species_max(
        ref_xbar.read(queries, np.arange(len(reads)), banks), ref.rows)
    return s, ref, queries, res.classification.scores, want


@pytest.mark.parametrize("partitionable", [True, False])
def test_pcm_session_within_one_count_of_the_reference(community,
                                                       partitionable):
    options = {"preset": "pcm", "seed": 7}
    s, ref, queries, got, want = _program_and_reference(
        community, options, partitionable)
    if partitionable:   # the reference's item memory is this mode's
        reads = community[1]
        assert torch.equal(queries, ref.encode(reads, np.full(
            len(reads), reads.shape[1])))
    diff = (got.long() - want.long()).abs()
    assert int((diff > 1).sum()) == 0
    assert float((diff == 1).float().mean()) <= NEAR_SHARE
    # the noise is on: the digital scores are not the noisy ones
    digital = ref_hdc.species_scores(queries, s.refdb.prototypes, ref.rows)
    assert not torch.equal(got, digital)


def test_ideal_session_equals_the_digital_reference(community):
    s, ref, queries, got, want = _program_and_reference(
        community, {"preset": "ideal"}, True)
    assert torch.equal(got, want)
    assert torch.equal(got, ref_hdc.species_scores(
        queries, s.refdb.prototypes, ref.rows))


@pytest.mark.parametrize("partitionable", [True, False])
@pytest.mark.parametrize("backend,substrate", [("pcm_sim", "pcm"),
                                               ("racetrack_sim", "racetrack")])
@pytest.mark.parametrize("span", [1, 3])
def test_chunked_read_equals_one_chunk(partitionable, backend, substrate,
                                       span, monkeypatch):
    # a loud read noise, so that the converter clips codes to count
    xcfg, sub = split_options({"preset": substrate, "seed": 11, "rows": 128,
                               "cols": 64, "read_sigma": 1.5}, backend=backend,
                              default_substrate=substrate,
                              partitionable=partitionable)
    g = torch.Generator().manual_seed(5)
    dim, b, s = 1024, 37, 150
    queries = bitops.pack_bits(torch.randint(0, 2, (b, dim), generator=g,
                                             dtype=torch.uint8))
    protos = bitops.pack_bits(torch.randint(0, 2, (s, dim), generator=g,
                                            dtype=torch.uint8))
    s_pos, s_neg = crossbar.program_prototypes(protos, xcfg, sub)
    w_pos, w_neg = (sub.read_weights(s_pos, stream=0),
                    sub.read_weights(s_neg, stream=1))
    whole = crossbar.read_banks(queries, w_pos, w_neg, dim, xcfg, sub,
                                with_stats=True)
    t, s_pad = w_pos.shape[:2]
    assert crossbar.block_tiles(b, s_pad) >= t
    monkeypatch.setattr(crossbar, "BLOCK_BYTES", 4 * b * s_pad * span)
    assert crossbar.block_tiles(b, s_pad) == span      # 8 tiles in chunks
    chunked = crossbar.read_banks(queries, w_pos, w_neg, dim, xcfg, sub,
                                  with_stats=True)
    assert torch.equal(chunked[0], whole[0])
    assert chunked[1] == whole[1]
    assert whole[1] > 0


@pytest.mark.parametrize("backend", ["pcm_sim", "racetrack_sim"])
@pytest.mark.parametrize("metrics", [False, True])
def test_backend_times_each_programming_event(backend, metrics):
    from repro_torch import obs
    from repro_torch.pipeline.backend import resolve_backend

    cfg = ProfilerConfig(space=HDSpace(**SPACE), window=WINDOW,
                         batch_size=BATCH, backend=backend)
    prev = obs.metrics()
    reg = obs.enable_metrics(obs.MetricsRegistry()) if metrics else None
    try:
        be = resolve_backend(backend, cfg, device="cpu")
    finally:
        obs.enable_metrics(prev)
    g = torch.Generator().manual_seed(3)
    protos = bitops.pack_bits(torch.randint(
        0, 2, (40, SPACE["dim"]), generator=g, dtype=torch.uint8))
    assert be.program_seconds is None
    be.agreement(protos[:5], protos)
    first = be.program_seconds
    assert first is not None and first > 0
    be.agreement(protos[:5], protos)             # the banks hold them
    assert be.program_seconds == first
    be.agreement(protos[:5], protos.clone())     # a new tensor: programmed
    second = be.program_seconds
    assert second > 0
    if metrics:
        state = reg.histogram(
            f"{backend.removesuffix('_sim')}_program_seconds").merged()
        assert state.count == 2
        assert state.sum == pytest.approx(first + second)


@pytest.mark.parametrize("partitionable", [True, False])
def test_reference_draws_equal_the_frozen_block_and_the_program(
        partitionable):
    rng = np.random.default_rng(9)
    k = rng.integers(0, 2 ** 32, 2, dtype=np.uint32)
    x0, x1 = rng.integers(0, 2 ** 32, (2, 1000), dtype=np.uint32)
    o0, o1 = ref_xbar.threefry2x32(
        torch.tensor(int(k[0])), torch.tensor(int(k[1])),
        torch.from_numpy(x0.astype(np.int64)),
        torch.from_numpy(x1.astype(np.int64)))
    w0, w1 = ref_threefry.threefry2x32((int(k[0]), int(k[1])), x0, x1)
    assert np.array_equal(o0.numpy(), w0.astype(np.int64))
    assert np.array_equal(o1.numpy(), w1.astype(np.int64))
    # words, uniforms and normals of a 1,001-word draw at scattered counters
    keys = rng.integers(0, 2 ** 32, (2, 2), dtype=np.uint32)
    idx = torch.tensor([0, 1, 499, 500, 501, 777, 1000])
    kt = threefry.keys_tensor(keys, "cpu")
    for epi, fn in (("bits", ref_xbar.words_at),
                    ("uniform", ref_xbar.uniform_at),
                    ("normal", ref_xbar.normal_at)):
        want = threefry.threefry_draw_plain(kt, 1001, epilogue=epi,
                                            partitionable=partitionable)
        got = fn(keys, idx, 1001, partitionable)
        if epi == "bits":
            got = bitops.to_int32_words(got)
        assert torch.equal(got, want[:, idx]), epi
    key = ref_xbar.fold_in(ref_xbar.key(5), 77)
    assert key == tuple(map(int, tf_core.fold_in(tf_core.key(5), 77)))
    assert np.array_equal(ref_xbar.split(key, 3, partitionable),
                          tf_core.split(key, 3, partitionable=partitionable))


def test_importing_the_reference_loads_no_program_and_no_jax():
    code = ("import sys; import perfbench.reference.crossbar; "
            "bad = sorted({m.split('.')[0] for m in sys.modules} & "
            "{'repro_torch', 'repro', 'jax', 'jaxlib'}); print(bad)")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         env=dict(os.environ, PYTHONPATH=str(ROOT)))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
