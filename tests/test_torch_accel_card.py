"""The device model on the card against the CPU (``-m cuda``; torch only,
so it runs where jax is not installed, and skips without a GPU).

A read event in chunks of row tiles (the byte cap patched down) equals
the one-chunk read on the card bit for bit, agreements and ADC clips:
each tile draws its own noise over the whole batch, and cuBLAS takes each
tile's product over its 256 rows whatever the chunk's batch count.

Exact: the noise-aware retraining steps on the card -- flagged reads
bundled with ``index_add_``, ``rebinarize_counters``, the validation reads
through the encoder and Threefry kernels -- give the CPU's prototypes and
scores.  Shift faults keep the device transfer in {0, 1}, so no noisy
float sum can differ.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.accel import crossbar
from repro_torch.accel.backend_pcm import split_options
from repro_torch.accel.codesign import noise_aware_refdb
from repro_torch.core import bitops
from repro_torch.core.hd_space import HDSpace
from repro_torch.pipeline import ProfilingSession
from repro_torch.pipeline.config import ProfilerConfig


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device("cuda")


@pytest.mark.cuda
def test_noise_aware_refdb_card_equals_cpu(cuda):
    rng = np.random.default_rng(11)
    genomes = {f"s{i}": rng.integers(0, 4, 6000).astype(np.int32)
               for i in range(4)}
    config = ProfilerConfig(space=HDSpace(dim=512, ngram=5, z_threshold=3.0),
                            window=512, batch_size=32,
                            backend="racetrack_sim",
                            backend_options={"shift_fault_rate": 0.5,
                                             "seed": 3})
    out = {}
    for dev in (cuda, torch.device("cpu")):
        db = ProfilingSession(config, device=dev).build_refdb(genomes)
        stats = {}
        refined = noise_aware_refdb(db, genomes, config, iterations=2,
                                    reads_per_species=16, read_len=64,
                                    stats=stats)
        assert refined.prototypes.device.type == dev.type
        out[dev.type] = (refined.prototypes.cpu(), stats)
    assert out["cuda"][1]["candidates"] == 4
    assert out["cuda"][1]["changed"] >= 1
    assert out["cuda"][1] == out["cpu"][1]
    assert torch.equal(out["cuda"][0], out["cpu"][0])


@pytest.mark.cuda
@pytest.mark.parametrize("partitionable", [True, False])
def test_chunked_read_equals_one_chunk_on_the_card(cuda, partitionable,
                                                   monkeypatch):
    torch.backends.cuda.matmul.allow_tf32 = False
    xcfg, sub = split_options({"preset": "pcm"},
                              partitionable=partitionable)
    g = torch.Generator().manual_seed(8)
    dim, b, s = 40_000, 1024, 2_900
    queries = bitops.pack_bits(torch.randint(
        0, 2, (b, dim), generator=g, dtype=torch.uint8)).to(cuda)
    protos = bitops.pack_bits(torch.randint(
        0, 2, (s, dim), generator=g, dtype=torch.uint8)).to(cuda)
    s_pos, s_neg = crossbar.program_prototypes(protos, xcfg, sub)
    w_pos, w_neg = (sub.read_weights(s_pos, stream=0),
                    sub.read_weights(s_neg, stream=1))
    del s_pos, s_neg
    whole = crossbar.read_banks(queries, w_pos, w_neg, dim, xcfg, sub,
                                with_stats=True)
    t, s_pad = w_pos.shape[:2]
    assert crossbar.block_tiles(b, s_pad) >= t
    for span in (50, 17, 1):
        monkeypatch.setattr(crossbar, "BLOCK_BYTES", 4 * b * s_pad * span)
        got = crossbar.read_banks(queries, w_pos, w_neg, dim, xcfg, sub,
                                  with_stats=True)
        torch.cuda.synchronize()
        assert torch.equal(got[0], whole[0]), span
        assert got[1] == whole[1], span
