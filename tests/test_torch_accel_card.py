"""The device model on the card against the CPU (``-m cuda``; torch only,
so it runs where jax is not installed, and skips without a GPU).

Exact: the noise-aware retraining steps on the card -- flagged reads
bundled with ``index_add_``, ``rebinarize_counters``, the validation reads
through the encoder and Threefry kernels -- give the CPU's prototypes and
scores.  Shift faults keep the device transfer in {0, 1}, so no noisy
float sum can differ.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.accel.codesign import noise_aware_refdb
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
