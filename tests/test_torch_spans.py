"""The port's own spans and build stages, on the CPU.

Under a ``torch.profiler``, ``ProfilingSession.profile`` records the
spans of ``repro_torch.obs.span`` with their documented nesting, one
species max a batch, and children that cover the call; the report and
every batch's classification are the same with the profiler on and off;
with no profiler a span is one shared null context.  ``RefDBBuilder``
times its four stages into ``refdb_build_stage_seconds``.
"""

import contextlib
import time

import pytest

torch = pytest.importorskip("torch")

from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repro_torch import obs  # noqa: E402
from repro_torch.core.hd_space import HDSpace  # noqa: E402
from repro_torch.genomics import synth  # noqa: E402
from repro_torch.pipeline import (ProfilerConfig, ProfilingSession,  # noqa
                                  SyntheticSource)

SP = HDSpace(dim=512, ngram=8, z_threshold=3.0)
SPEC = synth.CommunitySpec(num_species=4, genome_len=6_000, seed=11)
BATCH = 16
PATH = {"reference": "repro_torch.encode",
        "cuda_fused": "repro_torch.tokens_agreement"}


@pytest.fixture(scope="module")
def sample():
    return SyntheticSource(SPEC, num_reads=90, present=[0, 2])


def _session(sample, backend):
    s = ProfilingSession(ProfilerConfig(space=SP, window=1024,
                                        batch_size=BATCH, backend=backend),
                         device="cpu")
    s.build_refdb(sample.genomes)
    return s


def _profile(session, sample):
    seen = []
    rep = session.profile(sample, on_batch=lambda r: seen.append(
        r.classification))
    return rep, seen


def _traced(fn):
    """Run ``fn`` under a CPU profiler that records every thread; return
    its result, the program's spans as ``(name, thread, start, end)`` and
    the names of those recorded as user annotations."""
    cfg = torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
    with profile(activities=[ProfilerActivity.CPU],
                 experimental_config=cfg) as prof:
        out = fn()
    spans, annotations = [], set()
    for e in prof.events():
        if e.name.startswith("repro_torch."):
            r = e.time_range
            spans.append((e.name, e.thread, r.start, r.end))
            if e.is_user_annotation:
                annotations.add(e.name)
    return out, spans, annotations


def _parents(spans):
    """Each span's innermost enclosing span on its own thread."""
    out = []
    for name, th, s, e in spans:
        around = [(s2, -e2, n2) for n2, th2, s2, e2 in spans
                  if th2 == th and (s2, e2) != (s, e)
                  and s2 <= s and e <= e2]
        out.append((name, max(around)[2] if around else None))
    return out


@pytest.fixture(scope="module", params=["reference", "cuda_fused"])
def runs(request, sample):
    """One backend's profile of the sample with no profiler, then under
    one: ``(backend, (report, classifications) off, the same on, spans,
    annotations)``."""
    session = _session(sample, request.param)
    off = _profile(session, sample)
    on, spans, annotations = _traced(lambda: _profile(session, sample))
    return request.param, off, on, spans, annotations


def test_profile_records_every_span_with_its_nesting(sample, runs):
    backend, _, _, spans, _ = runs
    batches = -(-len(sample.tokens) // BATCH)
    path = PATH[backend]
    want = {
        "repro_torch.profile": {None},
        "repro_torch.profile.next_batch": {"repro_torch.profile"},
        "repro_torch.profile.d2h": {"repro_torch.profile"},
        "repro_torch.profile.accumulate": {"repro_torch.profile"},
        "repro_torch.profile.finalize": {"repro_torch.profile"},
        "repro_torch.classify_batch": {"repro_torch.profile"},
        "repro_torch.to_device": {"repro_torch.classify_batch"},
        path: {"repro_torch.classify_batch"},
        "repro_torch.species_scores": {path},
        "repro_torch.threshold": {path},
        "repro_torch.source.batch": {None},
    }
    got: dict[str, set] = {}
    for name, parent in _parents(spans):
        got.setdefault(name, set()).add(parent)
    assert got == want
    count = {n: sum(1 for s in spans if s[0] == n) for n in want}
    for name in ("repro_torch.classify_batch", "repro_torch.species_scores",
                 "repro_torch.threshold", "repro_torch.profile.d2h",
                 "repro_torch.profile.accumulate", path):
        assert count[name] == batches, name
    # the last wait finds the stream's end
    assert count["repro_torch.profile.next_batch"] == batches + 1
    assert count["repro_torch.profile"] == 1
    main = {th for n, th, _, _ in spans if n == "repro_torch.profile"}
    assert {th for n, th, _, _ in spans
            if n == "repro_torch.source.batch"}.isdisjoint(main)


def test_profile_children_cover_the_call(runs):
    spans = runs[3]
    (_, _, s0, e0), = [s for s in spans if s[0] == "repro_torch.profile"]
    children = sum(e - s for (_, _, s, e), (_, parent)
                   in zip(spans, _parents(spans))
                   if parent == "repro_torch.profile")
    assert children >= 0.9 * (e0 - s0)


def test_spans_do_not_perturb_results(runs):
    _, (rep_off, off), (rep_on, on), spans, _ = runs
    assert spans
    assert rep_on.to_json() == rep_off.to_json()
    assert len(on) == len(off)
    for a, b in zip(on, off):
        assert torch.equal(a.hits, b.hits)
        assert torch.equal(a.scores, b.scores)
        assert torch.equal(a.category, b.category)


def test_spans_over_torch_operations_are_annotations(runs):
    """A span over torch operations is a user annotation, which leaves
    them at the top level of the trace; the spans over host work alone
    are operator ranges, a tenth of the cost."""
    backend, _, _, spans, annotations = runs
    host = {"repro_torch.profile.next_batch",
            "repro_torch.profile.accumulate", "repro_torch.source.batch"}
    assert annotations == {s[0] for s in spans} - host
    assert "repro_torch.species_scores" in annotations


def test_torch_trace_records_the_sources_thread(sample, tmp_path):
    """``obs.torch_trace``, the CLIs' capture, records every thread: the
    producer's ``repro_torch.source.batch`` is in its Chrome trace."""
    import json

    session = _session(sample, "reference")
    with obs.torch_trace(tmp_path):
        session.profile(sample)
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    threads = {name: {e["tid"] for e in events if e.get("name") == name}
               for name in ("repro_torch.profile", "repro_torch.source.batch")}
    assert threads["repro_torch.source.batch"]
    assert threads["repro_torch.source.batch"].isdisjoint(
        threads["repro_torch.profile"])


def test_a_span_without_a_profiler_is_one_shared_null_context():
    a = obs.span("repro_torch.a")
    assert isinstance(a, contextlib.nullcontext)
    assert obs.span("repro_torch.b") is a
    with profile(activities=[ProfilerActivity.CPU]):
        inside = obs.span("repro_torch.a")
    assert inside is not a
    assert obs.span("repro_torch.a") is a


def test_build_records_four_stages_within_its_wall_time(sample):
    reg = obs.MetricsRegistry()
    session = ProfilingSession(ProfilerConfig(space=SP, window=1024,
                                              batch_size=BATCH,
                                              backend="cuda_fused"),
                               device="cpu", metrics=reg)
    t0 = time.perf_counter()
    session.build_refdb(sample.genomes)
    wall = time.perf_counter() - t0
    h = reg.histogram("refdb_build_stage_seconds")
    stages = {dict(k)["stage"]: v for k, v in h.series().items()}
    assert set(stages) == {"window", "upload", "encode", "assemble"}
    genomes = len(sample.genomes)
    assert [stages[s].count for s in ("window", "upload", "encode")] == \
        [genomes] * 3
    assert stages["assemble"].count == 1
    assert all(v.sum >= 0 for v in stages.values())
    assert 0 < sum(v.sum for v in stages.values()) <= wall
    # the encode (compute and copy back) is the bulk of a CPU build
    assert stages["encode"].sum > stages["window"].sum


def test_a_builder_without_metrics_records_into_the_global(sample):
    """``metrics=None`` resolves the process global at construction, as
    every instrumented component does."""
    from repro_torch.core.assoc_memory import RefDBBuilder

    reg = obs.enable_metrics()
    try:
        builder = RefDBBuilder(SP, window=1024, device="cpu")
    finally:
        obs.disable()
    for name, toks in sample.genomes.items():
        builder.add_genome(name, toks)
    builder.finish()
    h = reg.histogram("refdb_build_stage_seconds")
    assert h.count(stage="window") == len(sample.genomes)
    assert h.count(stage="assemble") == 1
