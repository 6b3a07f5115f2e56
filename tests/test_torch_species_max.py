"""The species max (``kernels/species_max.py``) against ``repro``.

On the CPU :func:`species_max` runs its plain version, which must equal
``repro``'s ``partial_scores`` (XLA's ``segment_max``) exactly.  The
``cuda`` cases hold the CUDA kernel against the plain version bit for bit
on the card and skip without one: at the benchmark's ragged widths, with
ids in no order, with many species, with negative agreement, on strided
and misaligned views.  Every output is an integer: the tolerance is exact
equality.

The GPU machine has no JAX, so ``repro`` is imported inside the parity
test (which skips there) and the module itself needs only torch.
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import assoc_memory, classifier
from repro_torch.kernels import species_max as sm

INT_MIN = np.iinfo(np.int32).min
INT_MAX = np.iinfo(np.int32).max


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device("cuda")


def _runs(p, s, seed, *, lead=0, tail=0):
    """Non-decreasing ids of ``p`` prototypes over ``s`` species, as the
    RefDB builder makes them (some species may get none), after ``lead``
    ids of -1 and before ``tail`` ids of ``s`` (padding)."""
    rng = np.random.default_rng(seed)
    body = np.sort(rng.integers(0, s, p - lead - tail)) if s else \
        np.zeros(0, np.int64)
    return np.concatenate([np.full(lead, -1), body,
                           np.full(tail, s)]).astype(np.int32)


def _agreement(b, p, seed, lo=0, hi=40_000):
    rng = np.random.default_rng(seed)
    return rng.integers(lo, hi, (b, p), dtype=np.int64).astype(np.int32)


# -- the plain version against repro (CPU) -------------------------------

@pytest.mark.parametrize("b,p,s,lead,tail", [
    (7, 64, 5, 0, 0),          # sorted ids, every column a multiple of 4
    (9, 37, 6, 3, 4),          # ids < 0 and >= S (padding), 37 columns
    (5, 30, 12, 0, 0),         # more species than runs: absent species
    (0, 16, 4, 0, 0),          # B = 0
    (6, 0, 3, 0, 0),           # S_protos = 0: every species absent
    (3, 1, 2, 0, 1),           # one column, and it is padding
])
def test_plain_matches_repro(b, p, s, lead, tail):
    pytest.importorskip("jax")
    from repro.core import classifier as jax_cls

    ids = _runs(p, s, seed=b + p, lead=lead, tail=tail)
    agree = _agreement(b, p, seed=p)
    want = np.asarray(jax_cls.partial_scores(agree, ids, s))
    got = sm.species_max(torch.from_numpy(agree), torch.from_numpy(ids), s)
    assert got.dtype == torch.int32 and got.shape == (b, s)
    np.testing.assert_array_equal(got.numpy(), want)
    absent = np.setdiff1d(np.arange(s), ids)
    assert (got.numpy()[:, absent] == classifier.NO_SCORE).all()


def test_species_scores_takes_the_plain_version_on_the_cpu():
    agree = torch.from_numpy(_agreement(4, 40, seed=1))
    ids = torch.from_numpy(_runs(40, 3, seed=2, tail=2))
    before = sm.species_max.launches
    got = assoc_memory.species_scores(agree, ids, 3)
    assert sm.species_max.launches == before
    assert torch.equal(got, sm.species_max_plain(agree, ids, 3))


# -- the CUDA kernel against the plain version (card) ---------------------

def _ids(kind, p, s, seed):
    rng = np.random.default_rng(seed)
    if kind == "sorted":
        return _runs(p, s, seed)
    if kind == "padded":                       # sharded's tail padding
        return _runs(p, s, seed, lead=5, tail=p // 7)
    if kind == "unsorted":
        ids = rng.integers(0, s, p).astype(np.int32)
        ids[rng.integers(0, p, p // 50)] = -3
        ids[rng.integers(0, p, p // 50)] = s + 2
        return ids
    raise ValueError(kind)


@pytest.mark.cuda
@pytest.mark.parametrize("b,p,s,kind", [
    (257, 121_117, 31, "sorted"),      # afs31's width, ragged rows
    (257, 29_300, 20, "sorted"),       # afs20's width
    (33, 29_301, 20, "padded"),
    (65, 10_007, 31, "unsorted"),      # ids in no order: runs of one
    (9, 120_001, 60_000, "sorted"),    # two prototypes a species
    (17, 50_003, 200, "sorted"),       # runs of 250: many a chunk
    (3, 4_097, 1, "sorted"),
])
def test_kernel_matches_plain(cuda, b, p, s, kind):
    agree = torch.from_numpy(_agreement(b, p, seed=p)).to(cuda)
    ids = torch.from_numpy(_ids(kind, p, s, seed=b)).to(cuda)
    got = sm.species_max(agree, ids, s)
    want = sm.species_max_plain(agree, ids, s)
    torch.cuda.synchronize()
    assert got.is_contiguous() and got.dtype == torch.int32
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_kernel_takes_negative_agreement(cuda):
    """The whole int32 range, the minimum included: a species whose every
    agreement is the minimum reads the minimum, as an absent one does."""
    b, p, s = 41, 12_345, 9
    agree = _agreement(b, p, seed=4, lo=INT_MIN, hi=INT_MAX)
    ids = _runs(p, s, seed=5)
    agree[3, :] = INT_MAX
    agree[:, ids == 2] = INT_MIN
    agree = torch.from_numpy(agree).to(cuda)
    ids = torch.from_numpy(ids).to(cuda)
    got = sm.species_max(agree, ids, s)
    assert torch.equal(got, sm.species_max_plain(agree, ids, s))
    assert (got[:, 2] == INT_MIN).all()


@pytest.mark.cuda
@pytest.mark.parametrize("view", ["row_offset", "column_offset"])
def test_kernel_takes_views(cuda, view):
    """Rows that start off 16 bytes (a row slice of an odd width) and rows
    further apart than P (a column slice, as ``pcm_sim`` returns)."""
    b, p, s = 40, 3_001, 7
    big = torch.from_numpy(_agreement(b + 3, p + 1, seed=6)).to(cuda)
    ids = torch.from_numpy(_runs(p, s, seed=7, tail=11)).to(cuda)
    if view == "row_offset":
        agree = big[3:, :p].contiguous()[1:]    # offset by one row of 3,001
    else:
        agree = big[3:, 1:]
    got = sm.species_max(agree, ids, s)
    assert torch.equal(got, sm.species_max_plain(agree, ids, s))


@pytest.mark.cuda
def test_kernel_refuses_other_types(cuda):
    agree = torch.zeros((2, 8), dtype=torch.int32, device=cuda)
    ids = torch.zeros(8, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="int32"):
        sm.species_max(agree, ids.long(), 2)
    with pytest.raises(ValueError, match="int32"):
        sm.species_max(agree.float(), ids, 2)


@pytest.mark.cuda
@pytest.mark.parametrize("b,p,s", [(0, 100, 4), (5, 0, 4), (5, 100, 0)])
def test_kernel_takes_empty_shapes(cuda, b, p, s):
    agree = torch.zeros((b, p), dtype=torch.int32, device=cuda)
    ids = torch.zeros(p, dtype=torch.int32, device=cuda)
    got = sm.species_max(agree, ids, s)
    assert torch.equal(got, sm.species_max_plain(agree, ids, s))


@pytest.mark.cuda
def test_species_scores_launches_the_kernel_inside_its_span(cuda, tmp_path):
    """One launch a call, counted; under ``torch.profiler`` the kernel is
    launched inside ``repro_torch.species_scores`` and no scatter is."""
    from torch.profiler import ProfilerActivity, profile

    agree = torch.from_numpy(_agreement(64, 29_300, seed=8)).to(cuda)
    ids = torch.from_numpy(_runs(29_300, 20, seed=9)).to(cuda)
    assoc_memory.species_scores(agree, ids, 20)         # build and warm
    torch.cuda.synchronize()
    before = sm.species_max.launches
    for _ in range(3):
        assoc_memory.species_scores(agree, ids, 20)
    assert sm.species_max.launches == before + 3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        assoc_memory.species_scores(agree, ids, 20)
        torch.cuda.synchronize()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    spans = [(e["ts"], e["ts"] + e["dur"]) for e in events
             if e.get("name") == "repro_torch.species_scores"
             and e.get("cat") == "user_annotation"]
    launches = {e["args"]["correlation"]: e["ts"] for e in events
                if e.get("cat") in ("cuda_runtime", "cuda_driver")
                and "correlation" in e.get("args", {})}
    kernels = [e for e in events if e.get("cat") == "kernel"]
    ours = [k for k in kernels if "species_max_kernel" in k["name"]]
    assert len(spans) == 1 and len(ours) == 1
    lo, hi = spans[0]
    assert lo <= launches[ours[0]["args"]["correlation"]] <= hi
    assert ours[0]["dur"] > 0
    assert not [k for k in kernels if "scatter" in k["name"]]
