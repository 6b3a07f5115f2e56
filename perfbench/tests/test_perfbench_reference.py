"""The plain reference against the port's ``reference`` backend at a
tiny size: item memory, encode, species scores, categories and the
report of a whole profile."""

import numpy as np
import pytest
import torch

from perfbench import check, generator
from perfbench.reference import hdc

SPACE = {"dim": 1024, "ngram": 8, "alphabet_size": 4, "density": 0.5,
         "encoding": "ngram", "metric": "hamming", "z_threshold": 5.0,
         "seed": 24301}
CONFIG = {"space": SPACE, "window": 200, "stride": 200, "batch_size": 32,
          "backend": "reference", "backend_options": {}}


@pytest.fixture(scope="module")
def port():
    from repro_torch.core.hd_space import HDSpace
    from repro_torch.pipeline.config import ProfilerConfig
    from repro_torch.pipeline.session import ProfilingSession

    refs = generator.genomes(5, 3, 1500, 0.06)
    orgs = generator.strains(5, refs, 0.002)
    session = ProfilingSession(ProfilerConfig(
        space=HDSpace(**SPACE), window=200, stride=200, batch_size=32,
        backend="reference"), device="cpu")
    session.build_refdb({f"s{i}": g for i, g in enumerate(refs)})
    return session, refs, orgs


def test_item_memory_and_threshold():
    from repro_torch.core import item_memory
    from repro_torch.core.hd_space import HDSpace

    im, tie = hdc.item_memory(SPACE)
    sp = HDSpace(**SPACE)
    assert np.array_equal(im, item_memory.make_item_memory(sp).numpy())
    assert np.array_equal(tie, item_memory.make_tie_break(sp).numpy())
    assert hdc.threshold(SPACE) == int(sp.threshold_bits)


def test_windows_and_prototypes(port):
    session, refs, _ = port
    ref = check.Reference(CONFIG, refs, "cpu")
    db = session.refdb
    assert ref.num_prototypes == db.num_prototypes        # 8 windows each
    assert ref.rows == [(0, 8), (8, 16), (16, 24)]
    rng = np.random.default_rng(0)
    assert check.proto_words(ref, db.prototypes, rng, 24) == 0
    broken = db.prototypes.clone()
    broken[5, 3] ^= 1
    assert check.proto_words(ref, broken, np.random.default_rng(0), 24) == 1


def test_scores_categories_and_report(port):
    session, refs, orgs = port
    ref = check.Reference(CONFIG, refs, "cpu")
    rng = np.random.default_rng(1)
    toks, _ = generator.reads(rng, orgs, np.array([0.5, 0.3, 0.2]), 100,
                              60, 0.002)
    lens = np.full(100, 60, np.int32)
    lens[:10] = 30                                  # shorter reads too
    res = session.classify_batch(toks, lens)
    cls = res.classification
    want = ref.scores(toks, lens, session.refdb.prototypes)
    assert torch.equal(cls.scores, want)
    hits, cat = hdc.classify(want, ref.threshold)
    assert torch.equal(cls.hits, hits) and torch.equal(cls.category, cat)
    assert check.chain(cls.scores, cls.hits, cls.category,
                       ref.threshold) == (0, 0)
    report = session.profile((toks, lens))
    counts, gap = check.report_diff(report, hdc.report(
        hits.numpy(), np.full(3, 1500)))
    assert counts == 0 and gap < 1e-12
    assert report.multi_reads > 0                   # the split is exercised


def test_bfloat16_control_changes_scores(port):
    session, refs, orgs = port
    ctl = check.Reference(CONFIG, refs, "cpu", "bfloat16")
    ref = check.Reference(CONFIG, refs, "cpu")
    toks, _ = generator.reads(np.random.default_rng(2), orgs,
                              np.array([0.4, 0.3, 0.3]), 64, 150, 0.002)
    lens = np.full(64, 150)
    a = ref.scores(toks, lens, session.refdb.prototypes)
    b = ctl.scores(toks, lens, session.refdb.prototypes)
    assert check.rows_differ(b, a) > 0
