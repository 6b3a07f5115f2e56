"""Every configuration, cell and metric loads by name, BENCHMARK.json
keeps the contract's shape, and a cell, a configuration and a metric are
added as new files only."""

import json
import re
import shutil

import pytest

from perfbench import harness, paths

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(scope="module")
def bench():
    return paths.benchmark()


def test_benchmark_keys_and_names(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["command"] == ["python3", "perfbench/run.py"]
    assert bench["paths"] == ["perfbench"]
    assert 1 <= bench["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in bench[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    assert len((paths.ROOT / "BENCHMARK.json").read_bytes()) < 64 * 1024


@pytest.mark.parametrize("kind", ["configs", "workloads"])
def test_every_entry_loads_by_name(bench, kind):
    for entry in bench[kind]:
        load = paths.config if kind == "configs" else paths.workload
        d = load(entry["name"])
        assert d["name"] == entry["name"]
        if kind == "configs":
            assert entry["file"] == f"perfbench/configs/{entry['name']}.json"
            assert d["source"] == entry["source"]
            assert d["reduced"] == entry["reduced"]
        else:
            for key in ("config", "traffic", "chips", "why"):
                assert d[key] == entry[key], key
            assert len(entry["why"]) <= 200
            assert hasattr(paths.mix(d["mix"]), "window")
            if "rate_metric" in d["params"]:
                assert d["params"]["rate_metric"] in \
                    harness.end_to_end_names(bench, entry["name"])


def test_every_metric_has_a_reader(bench):
    for m in bench["per_layer"]:
        assert callable(paths.metric(m["name"]).read)
        assert m["moves"] in [e["name"] for e in bench["end_to_end"]]
        for cell in m["workloads"]:
            assert m["moves"] in harness.end_to_end_names(bench, cell)


def test_every_cell_reports_setup_another_e2e_and_a_layer(bench):
    for w in bench["workloads"]:
        e2e = harness.end_to_end_names(bench, w["name"])
        assert "setup_s" in e2e and len(e2e) >= 2
        assert harness.per_layer_names(bench, w["name"])


def test_a_cell_a_config_and_a_metric_added_as_files(tmp_path):
    """A later change adds files only: a copy of the benchmark's folder
    with a new configuration, cell and metric finds all three by name."""
    base = tmp_path / "perfbench"
    shutil.copytree(paths.HERE, base,
                    ignore=shutil.ignore_patterns("__pycache__"))
    cfg = paths.config("afs20")
    cfg["name"] = "afs20-x"
    (base / "configs" / "afs20-x.json").write_text(json.dumps(cfg))
    wl = paths.workload("afs20.profile")
    wl.update(name="afs20-x.profile", config="afs20-x")
    (base / "workloads" / "afs20-x.profile.json").write_text(json.dumps(wl))
    (base / "metrics" / "new_metric.profile.py").write_text(
        "def read(ctx):\n    return ctx.get('refdb_build_s')\n")
    assert paths.workload("afs20-x.profile", base)["config"] == "afs20-x"
    assert paths.config("afs20-x", base)["num_species"] == 20
    assert paths.metric("new_metric.profile", base).read(
        {"refdb_build_s": 1.5}) == 1.5
    bench = paths.benchmark()
    bench["workloads"].append({"name": "afs20-x.profile"})
    bench["per_layer"].append({"name": "new_metric.profile", "unit": "s",
                               "moves": "setup_s",
                               "workloads": ["afs20-x.profile"]})
    for m in bench["end_to_end"]:
        if "afs20.profile" in m.get("workloads", []):
            m["workloads"].append("afs20-x.profile")
    assert "new_metric.profile" in harness.per_layer_names(
        bench, "afs20-x.profile")
    assert "profile_reads_per_s" in harness.end_to_end_names(
        bench, "afs20-x.profile")


def test_config_files_state_the_deployment():
    for name in ("afs20", "afs31"):
        c = paths.config(name)
        assert c["space"]["dim"] == 40000 and c["space"]["ngram"] == 16
        assert c["batch_size"] == 4096 and c["backend"] == "cuda_fused"
        assert c["window"] == c["stride"] == 8192
        assert c["reduced"] == ["genome_len"]
    assert paths.config("afs31")["num_species"] == 31
    # no genome below the smallest of the AFS databases (12 MB)
    assert paths.config("afs20")["genome_len"] == 12_000_000
    assert paths.config("afs31")["genome_len"] == 32_000_000


def test_a_split_metric_reads_through_its_base_file(tmp_path):
    """``<metric>.<part>`` needs no file of its own: it is read by
    ``metrics/<metric>.py`` unless it brings one."""
    assert paths.metric("device_idle_pct.serve") is \
        paths.metric("device_idle_pct")
    base = tmp_path / "perfbench"
    (base / "metrics").mkdir(parents=True)
    (base / "metrics" / "m.py").write_text("def read(c):\n    return 1\n")
    (base / "metrics" / "m.own.py").write_text(
        "def read(c):\n    return 2\n")
    assert paths.metric("m.other", base).read({}) == 1
    assert paths.metric("m.own", base).read({}) == 2
    with pytest.raises(FileNotFoundError):
        paths.metric("absent.part", base)
