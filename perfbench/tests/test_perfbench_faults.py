"""A whole run at a tiny size on the CPU, past the harness's look for a
card, with the timed path broken underneath: ``correct`` has to come out
false for each fault a cell can have, and true without one.  The faults:
a step that leaves its state unchanged (the report accumulator ignores a
batch), half of each batch left out (its rows answered with the other
half's), an answer altered where it is produced (a report's count), and
the RefDB built wrong, in one species' prototypes or in one encode
launch's.  There is no exchange between chips to leave out: every cell
takes one.  The control, the reference in the program's place with its
product in bfloat16, has to fail too."""

import dataclasses
import time

import pytest

from perfbench import control, harness

CELLS = ["afs20.profile", "afs31.profile"]


def _run(cell, tiny_cell, trace=False, **config):
    wl, cfg = tiny_cell(cell)
    cfg.update(config)
    return harness.run_cell(cell, 2 ** 31 + 12345, 1.0, trace,
                            device="cpu", t_process=time.perf_counter(),
                            workload=wl, config=cfg)


def _unchanged(monkeypatch):
    from repro_torch.pipeline.report import ProfileAccumulator

    monkeypatch.setattr(ProfileAccumulator, "add",
                        lambda self, hits, category: None)


def _half_batch(monkeypatch):
    from repro_torch.pipeline.session import ProfilingSession

    orig = ProfilingSession.classify_batch

    def half(self, tokens, lengths, **kw):
        res = orig(self, tokens, lengths, **kw)
        c = res.classification
        h = len(c.scores) // 2

        def fold(x):
            x = x.clone()
            x[h:2 * h] = x[:h]
            return x

        return dataclasses.replace(res, classification=dataclasses.replace(
            c, scores=fold(c.scores), hits=fold(c.hits),
            category=fold(c.category)))

    monkeypatch.setattr(ProfilingSession, "classify_batch", half)


def _altered_answer(monkeypatch):
    from repro_torch.pipeline.report import ProfileAccumulator

    orig = ProfileAccumulator.finalize

    def altered(self, *a, **k):
        rep = orig(self, *a, **k)
        counts = rep.unique_counts.copy()
        counts[0] += 1
        return dataclasses.replace(rep, unique_counts=counts)

    monkeypatch.setattr(ProfileAccumulator, "finalize", altered)


def _species_prototypes(monkeypatch):
    """The second species' prototypes come out of the build altered."""
    from repro_torch.core.assoc_memory import RefDBBuilder

    orig = RefDBBuilder.add_genome

    def add_genome(self, name, tokens):
        block = orig(self, name, tokens)    # the builder keeps this array
        if len(self._names) == 2:
            block ^= 1
        return block

    monkeypatch.setattr(RefDBBuilder, "add_genome", add_genome)


def _launch_prototypes(monkeypatch):
    """The build's second encode launch (the first species' last
    windows, at a build batch of 8) returns altered rows."""
    from repro_torch.pipeline.session import ProfilingSession

    orig = ProfilingSession._builder

    def _builder(self):
        builder = orig(self)
        encode, launches = builder._encode, []

        def faulty(tokens, lengths):
            launches.append(len(tokens))
            out = encode(tokens, lengths)
            return out ^ 1 if len(launches) == 2 else out

        builder._encode = faulty
        return builder

    monkeypatch.setattr(ProfilingSession, "_builder", _builder)


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell, tiny_cell):
    out, checks = _run(cell, tiny_cell)
    assert out["correct"], out["checks"]
    assert list(out)[-1] == "checks"
    assert {"proto_words", "score_rows", "report_counts"} <= set(
        out["checks"])


@pytest.mark.parametrize("fault,fails", [
    (_unchanged, "report_counts"), (_half_batch, "score_rows"),
    (_altered_answer, "report_counts")])
@pytest.mark.parametrize("cell", CELLS)
def test_fault_is_not_correct(cell, fault, fails, tiny_cell, monkeypatch):
    fault(monkeypatch)
    out, _ = _run(cell, tiny_cell)
    assert not out["correct"]
    assert out["checks"][fails]["value"] > out["checks"][fails]["limit"]


@pytest.mark.parametrize("fault", [_species_prototypes, _launch_prototypes])
def test_build_fault_is_not_correct(fault, tiny_cell, monkeypatch):
    """Both sides score against the program's prototypes, so only the
    re-encoded sample of every launch can see a build that went wrong."""
    fault(monkeypatch)
    out, _ = _run("afs20.profile", tiny_cell, batch_size=8)
    assert not out["correct"]
    assert out["checks"]["proto_words"]["value"] > 0


def test_every_launch_of_the_build_is_sampled(tiny_cell):
    from perfbench import check, generator

    _, cfg = tiny_cell("afs20.profile")
    genomes = generator.genomes(5, cfg["num_species"], cfg["genome_len"],
                                cfg["homology_fraction"])
    ref = check.Reference(cfg, genomes, "cpu")
    strata = check.build_strata(ref, 8)
    # 12 windows a genome: launches of 8 and 4 windows, genome by genome
    assert strata[:3] == [(0, 8), (8, 12), (12, 20)]
    assert len(strata) == 2 * cfg["num_species"]
    assert strata[-1][1] == ref.num_prototypes


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell, tiny_cell):
    wl, cfg = tiny_cell(cell)
    r = control.readings(cell, 7, 1.0, "cpu", workload=wl, config=cfg)
    assert all(v == 0 for v in r["program"].values())
    assert r["control"]["score_rows"] > 0


@pytest.mark.parametrize("cell", CELLS)
def test_traced_run_reads_its_layers(cell, tiny_cell):
    """On the CPU the trace has no device work: the kernel readers find
    nothing and report nothing; the host readers still read."""
    out, _ = _run(cell, tiny_cell, trace=True)
    assert out["correct"]
    m = out["metrics"]
    assert "refdb_build_s" in m
    assert not any("roofline" in k or "species_max" in k for k in m)
    assert out["device"]["window_s"] > 0
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    # the host's operations are in the trace
    assert any(name.startswith("aten::")
               for name, _ in out["breakdown"]["idle_gaps"])
