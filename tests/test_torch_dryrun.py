"""The dry runs on a fake process group (each in a child process: the
fake group of 256 / 512 ranks must not meet the default group of the
test process).

``launch.dryrun``: ``stablelm-3b`` at full width cut to 2 layers, for
``train_4k``, ``prefill_32k`` and ``decode_32k`` on a fake 16 x 16
group, each rank's argument bytes held to a hand count of its shards,
FLOPs per device beside the 6ND / 2ND model count, a ``MemTracker``
peak, collectives by kind (the local collective ops and
``CommDebugMode`` agree).
``launch.dryrun_hdc``: every variant on both meshes, its per-device
shapes and its one collective.
"""

import json
import os
import pathlib
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

REPO = pathlib.Path(__file__).resolve().parent.parent
KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
         "collective-permute")

D, V, FF, L, H, DH = 2560, 50304, 6912, 2, 32, 80
BF16, F32, I32 = 2, 4, 4
ATTN = L * D * H * DH          # one of wq / wk / wv / wo, both layers
MLP = L * D * FF               # one of w_in / w_gate / w_out
NORMS = 2 * D + 4 * L * D      # final_norm + ln1 / ln2 (scale, bias), f32


def _train_params() -> int:
    """TRAIN / PREFILL rules on 16 x 16: vocab and heads over model, the
    fsdp dim over data (256-way); wk / wv split over data only (kv heads
    stay whole); norms replicated."""
    bf16 = (2 * V * D + 2 * ATTN + 3 * MLP) // 256 + 2 * ATTN // 16
    return bf16 * BF16 + NORMS * F32, bf16


def _train_args() -> int:
    params, bf16 = _train_params()
    moments = 2 * (bf16 + NORMS) * F32
    batch = 2 * (256 // 16) * 4096 * I32          # tokens, labels
    return params + moments + I32 + batch         # + step


def _prefill_args() -> int:
    return _train_params()[0] + (32 // 16) * 32768 * I32


def _decode_args() -> int:
    """DECODE rules: nothing over data for the parameters (fsdp off), the
    cache's batch over data and sequence over model."""
    bf16 = (2 * V * D + 2 * ATTN + 3 * MLP) // 16 + 2 * ATTN
    cache = 2 * (L * 128 * 32768 * H * DH * BF16) // 256 \
        + (L * 128 * 32768 * I32) // 256
    return bf16 * BF16 + NORMS * F32 + cache + (128 // 16) * I32


def _run(module: str, *args: str, timeout: int = 900) -> str:
    env = {**os.environ, "PYTHONPATH": str(REPO / "src"),
           "OMP_NUM_THREADS": "1"}
    out = subprocess.run([sys.executable, "-m", module, *args], env=env,
                         capture_output=True, text=True, timeout=timeout)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-3000:]
    return out.stdout


@pytest.fixture(scope="module")
def lm_cells(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun_torch")
    cells = {}
    for shape in ("train_4k", "prefill_32k", "decode_32k"):
        text = _run("repro_torch.launch.dryrun", "--arch", "stablelm-3b",
                    "--shape", shape, "--layers", "2", "--out", str(out))
        assert "failures=0" in text
        cells[shape] = json.loads(
            (out / f"stablelm-3b.{shape}.16x16.json").read_text())
    return cells


@pytest.mark.parametrize("shape,want", [("train_4k", _train_args),
                                        ("prefill_32k", _prefill_args),
                                        ("decode_32k", _decode_args)])
def test_dryrun_cell_per_device(lm_cells, shape, want):
    cell = lm_cells[shape]
    assert cell["ok"] and cell["mesh"] == "16x16", cell["error"]
    assert cell["memory"]["argument_size_in_bytes"] == want()
    assert cell["memory"]["output_size_in_bytes"] > 0
    assert cell["memory"]["peak_bytes"] > 0          # MemTracker's, local
    assert cell["extra"]["n_layers"] == 2
    flops = cell["cost"]["flops"]
    model = cell["extra"]["model_flops_6nd"] / 256
    # the step's local products: above the per-device model count (the
    # 6ND / 2ND count leaves attention and recompute out), and for train
    # and prefill within 3x of it.  Decode is not: ``cached_attention``
    # reads the cache in one product that spends KV (32) times a
    # per-head attention's products, which at 2,048 cache positions a
    # device outweighs the weights
    assert model < flops, (flops, model)
    if shape != "decode_32k":
        assert flops < 3 * model, (flops, model)
    coll = cell["collectives"]
    for kind in KINDS:
        assert coll[kind]["count"] == coll[kind]["comm_debug_count"]
    assert coll["total_link_bytes"] > 0
    roof = cell["extra"]["roofline"]
    assert roof["flops"] == flops and roof["depth_points"] == [2]


def test_dryrun_train_reduces_gradients(lm_cells):
    """The train step pins its gradients to the parameters' placements:
    data-parallel reductions land as reduce-scatters."""
    coll = lm_cells["train_4k"]["collectives"]
    assert coll["reduce-scatter"]["count"] > 0
    assert coll["all-gather"]["count"] > 0


def test_dryrun_hdc_both_meshes(tmp_path):
    text = _run("repro_torch.launch.dryrun_hdc", "--both-meshes", "--out",
                str(tmp_path))
    assert text.count("] OK") == 6
    want = {"d_contract": ("all-reduce", [4096, 2048], [2048, 2048]),
            "proto_shard": ("all-gather", [4096, 128], [2048, 128]),
            "query_a2a": ("all-to-all", [256, 2048], [128, 2048])}
    for variant, (kind, out16, out512) in want.items():
        for mesh, out in (("16x16", out16), ("2x16x16", out512)):
            res = json.loads((tmp_path / f"demeter_hdc.query.{variant}."
                              f"{mesh}.json").read_text())
            assert res["shard_shapes"]["out"] == out
            coll = res["collectives"]
            assert {k for k in KINDS if coll[k]["count"]} == {kind}
            assert coll[kind]["count"] == coll[kind]["comm_debug_count"] == 1
            assert res["cost"]["flops"] > 0
