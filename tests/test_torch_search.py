"""The port's standalone search kernels and CLI against ``repro``.

On the CPU the wrappers of ``hamming_am`` and ``am_matmul`` (both its
packed and its bf16 entry) run their plain torch versions, which must equal ``repro``'s ``ops.am_agreement``
(Pallas in interpret mode), ``ops.to_pm1`` and the oracles
``ref.hamming_am_ref`` / ``ref.am_matmul_ref`` exactly.  The ``cuda``
cases hold the CUDA kernels against those plain versions on the card and
skip without one.  Every output is an integer: the tolerance is exact
equality.

The CLI ``repro_torch.launch.profile_run`` must write the same report
JSON and print the same lines as ``repro.launch.profile_run``.

The GPU machine has no JAX, so ``repro`` is imported inside the parity
tests (which skip there) and the module itself needs only torch.
"""

import json
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import convert
from repro_torch.kernels import _search, am_matmul, hamming_am, ops
from repro_torch.launch import profile_run

#: ``tests/test_kernels.py::test_am_agreement_sweep``'s shapes (b, s, w).
SWEEP = [(8, 16, 64), (16, 128, 128), (8, 128, 40), (4, 300, 64),
         (128, 8, 8)]
#: CLI flags small enough for the CPU (dim 512, 2,000 reads).
FLAGS = ["--synthetic", "--dim", "512", "--ngram", "5", "--window", "1024"]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device("cuda")


def _repro():
    """The JAX package's modules (skips where JAX is not installed)."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.kernels import ops as kops, ref
    return jnp, kops, ref


def _jax_mode() -> bool:
    """The installed jax's threefry mode (``repro`` draws its item memory
    in it, so the port's parity cases take it too); True without jax."""
    try:
        import jax
    except ImportError:
        return True
    return bool(jax.config.jax_threefry_partitionable)


def _packed(b, s, w, seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 2 ** 32, (b, w), dtype=np.uint32),
            rng.integers(0, 2 ** 32, (s, w), dtype=np.uint32))


def _t(a):
    return convert.words_to_tensor(np.asarray(a))


# -- CPU: plain versions against repro --------------------------------------

@pytest.mark.parametrize("b,s,w", SWEEP)
def test_am_agreement_plain_matches_repro(b, s, w):
    jnp, kops, ref = _repro()
    q, p = _packed(b, s, w, seed=1000 * b + s + w)
    jq, jp = jnp.asarray(q), jnp.asarray(p)
    want = np.asarray(ref.hamming_am_ref(jq, jp))
    tq, tp = _t(q), _t(p)
    for formulation in ("matmul", "packed"):
        np.testing.assert_array_equal(
            np.asarray(kops.am_agreement(jq, jp, 32 * w, formulation)), want)
        got = ops.am_agreement(tq, tp, 32 * w, formulation)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
    # hamming_am's own contract: dim defaults to 32 W and shifts the result
    np.testing.assert_array_equal(hamming_am.hamming_am(tq, tp).numpy(), want)
    np.testing.assert_array_equal(
        hamming_am.hamming_am(tq, tp, dim=32 * w + 64).numpy(), want + 64)


@pytest.mark.parametrize("b,s,w", SWEEP)
def test_to_pm1_and_am_matmul_plain_match_repro(b, s, w):
    jnp, kops, ref = _repro()
    q, p = _packed(b, s, w, seed=7 * b + s + w)
    jq, jp = kops.to_pm1(jnp.asarray(q)), kops.to_pm1(jnp.asarray(p))
    tq, tp = ops.to_pm1(_t(q)), ops.to_pm1(_t(p))
    assert tq.dtype == torch.bfloat16 and tq.shape == (b, 32 * w)
    np.testing.assert_array_equal(tq.float().numpy(),
                                  np.asarray(jq, np.float32))
    np.testing.assert_array_equal(tp.float().numpy(),
                                  np.asarray(jp, np.float32))
    want = np.asarray(ref.am_matmul_ref(jq, jp))
    np.testing.assert_array_equal(am_matmul.am_matmul_plain(tq, tp).numpy(),
                                  want)
    np.testing.assert_array_equal(am_matmul.am_matmul(tq, tp).numpy(), want)


def test_empty_prototype_set():
    """S = 0 gives a ``(B, 0)`` result, as ``ref.hamming_am_ref`` does
    (``repro``'s ``am_agreement`` itself divides by a zero block there)."""
    jnp, _, ref = _repro()
    q, p = _packed(5, 0, 16, seed=5)
    want = np.asarray(ref.hamming_am_ref(jnp.asarray(q), jnp.asarray(p)))
    assert want.shape == (5, 0)
    for formulation in ("matmul", "packed"):
        got = ops.am_agreement(_t(q), _t(p), 512, formulation)
        assert got.shape == (5, 0) and got.dtype == torch.int32


def test_unknown_formulation_raises():
    jnp, kops, _ = _repro()
    q, p = _packed(2, 3, 4, seed=0)
    with pytest.raises(ValueError, match="unknown formulation"):
        kops.am_agreement(jnp.asarray(q), jnp.asarray(p), 128, "xnor")
    with pytest.raises(ValueError, match="unknown formulation 'xnor'"):
        ops.am_agreement(_t(q), _t(p), 128, "xnor")


def test_to_pm1_chunks_rows(monkeypatch):
    q, _ = _packed(37, 0, 6, seed=3)
    whole = ops.to_pm1(_t(q))
    monkeypatch.setattr(ops, "_PM1_CHUNK_ELEMS", 5 * 32 * 6)  # 5 rows
    assert torch.equal(ops.to_pm1(_t(q)), whole)
    assert torch.equal(ops.to_pm1(_t(q).reshape(37, 1, 6)),
                       whole.reshape(37, 1, 192))


def _counts():
    return (hamming_am.hamming_am.launches, am_matmul.am_matmul.launches,
            am_matmul.am_matmul_packed.launches)


def test_plain_versions_count_no_launches():
    q, p = _packed(4, 9, 8, seed=1)
    before = _counts()
    for formulation in ("matmul", "packed"):
        ops.am_agreement(_t(q), _t(p), 256, formulation)
    am_matmul.am_matmul(ops.to_pm1(_t(q)), ops.to_pm1(_t(p)))
    assert _counts() == before


@pytest.mark.parametrize("make,match", [
    (lambda: (torch.zeros(2, 4, dtype=torch.int64),
              torch.zeros(3, 4, dtype=torch.int32)), "int32"),
    (lambda: (torch.zeros(2, 4, dtype=torch.int32),
              torch.zeros(3, 5, dtype=torch.int32)), "differ in W"),
    (lambda: (torch.zeros(4, 2, dtype=torch.int32).T,
              torch.zeros(3, 4, dtype=torch.int32)), "contiguous"),
    (lambda: (torch.zeros(2, 4, dtype=torch.int32),
              torch.zeros(3, 2, 2, dtype=torch.int32)), "2-d"),
])
def test_hamming_am_checks_its_inputs(make, match):
    with pytest.raises(ValueError, match=f"hamming_am: .*{match}"):
        _search.check_packed(*make(), "hamming_am")


@pytest.mark.parametrize("make,match", [
    (lambda: (torch.zeros(2, 4, dtype=torch.int64),
              torch.zeros(3, 4, dtype=torch.int32)), "int32"),
    (lambda: (torch.zeros(2, 4, dtype=torch.int32),
              torch.zeros(3, 4, dtype=torch.bfloat16)), "int32"),
    (lambda: (torch.zeros(2, 4, dtype=torch.int32),
              torch.zeros(3, 5, dtype=torch.int32)), "differ in W"),
    (lambda: (torch.zeros(4, 2, dtype=torch.int32).T,
              torch.zeros(3, 4, dtype=torch.int32)), "contiguous"),
    (lambda: (torch.zeros(2, 4, dtype=torch.int32),
              torch.zeros(3, 2, 2, dtype=torch.int32)), "2-d"),
])
def test_am_matmul_packed_checks_its_inputs(make, match):
    """The packed entry shares hamming_am's checks, under its own name."""
    with pytest.raises(ValueError, match=f"am_matmul_packed: .*{match}"):
        _search.check_packed(*make(), "am_matmul_packed")


@pytest.mark.parametrize("make,match", [
    (lambda: (torch.zeros(2, 64, dtype=torch.float32),
              torch.zeros(3, 64, dtype=torch.bfloat16)), "bfloat16"),
    (lambda: (torch.zeros(2, 64, dtype=torch.bfloat16),
              torch.zeros(3, 32, dtype=torch.bfloat16)), "differ in D"),
    (lambda: (torch.zeros(64, 2, dtype=torch.bfloat16).T,
              torch.zeros(3, 64, dtype=torch.bfloat16)), "contiguous"),
])
def test_am_matmul_checks_its_inputs(make, match):
    with pytest.raises(ValueError, match=match):
        am_matmul._check(*make())


# -- CUDA: each kernel against its plain version ----------------------------

CUDA_CASES = SWEEP + [
    (37, 1001, 1001),    # ragged W: a word tail (kernel 4), a K tail (3)
    (253, 1001, 1280),   # the main path's width, ragged B and S
    (3, 130, 33),        # W = 33: not a multiple of any tile
    (1, 1, 1),
    (513, 130, 64),      # three 256-query tiles, the last of one row
    (300, 700, 40),      # W = 40: a partial 32-word step, 16-byte rows
]

#: am_matmul's tile edges (``am_matmul.plan``, on a 132-SM H100): the
#: slab is 32 prototypes below ~4,200 and 80 at ~9,800.  S one past and
#: one short of a slab, B around the 256-query tile, W = 1, 4 and
#: W % 8 != 0 (a partial 8-word stage), W % 4 != 0 (no TMA).
EDGE_CASES = [
    (1, 33, 8),          # B = 1; S one past a slab of 32
    (255, 31, 40),       # S one short of a slab of 32
    (257, 65, 4),        # two query tiles, the second of one row
    (513, 95, 12),       # three query tiles; W % 8 = 4
    (2, 9761, 5),        # S one past 122 slabs of 80; W % 4 != 0
    (255, 9759, 8),      # S one short of 122 slabs of 80
]


def _with_equal_and_complement(q, p):
    """Row 0 of q equals prototype 0 (agreement dim); row 1 is the
    complement of the last prototype (agreement 0)."""
    q = q.copy()
    q[0] = p[0]
    if len(q) > 1:
        q[1] = ~p[-1]
    return q


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,w", CUDA_CASES)
def test_hamming_am_kernel_matches_plain(cuda, b, s, w):
    q, p = _packed(b, s, w, seed=b * s + w)
    q = _with_equal_and_complement(q, p)
    want = hamming_am.hamming_am_plain(_t(q), _t(p))
    before = hamming_am.hamming_am.launches
    got = ops.am_agreement(_t(q).to(cuda), _t(p).to(cuda), 32 * w, "packed")
    torch.cuda.synchronize()
    assert hamming_am.hamming_am.launches == before + 1
    assert torch.equal(got.cpu(), want)
    assert int(got[0, 0]) == 32 * w
    if b > 1:
        assert int(got[1, s - 1]) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,w", CUDA_CASES + EDGE_CASES)
def test_am_matmul_kernel_matches_plain(cuda, b, s, w):
    """The bf16 entry (the TPU kernel's interface; no path calls it)."""
    q, p = _packed(b, s, w, seed=b * s + w + 1)
    q = _with_equal_and_complement(q, p)
    tq, tp = ops.to_pm1(_t(q)), ops.to_pm1(_t(p))
    want = am_matmul.am_matmul_plain(tq, tp)
    before = am_matmul.am_matmul.launches
    got = am_matmul.am_matmul(tq.to(cuda), tp.to(cuda), dim=32 * w)
    torch.cuda.synchronize()
    assert am_matmul.am_matmul.launches == before + 1
    assert torch.equal(got.cpu(), want)
    assert torch.equal(got.cpu(), hamming_am.hamming_am_plain(_t(q), _t(p)))
    assert int(got[0, 0]) == 32 * w
    if b > 1:
        assert int(got[1, s - 1]) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,w", CUDA_CASES + EDGE_CASES)
@pytest.mark.parametrize("extra", [0, 64, -7])
def test_am_matmul_packed_kernel_matches_plain(cuda, b, s, w, extra):
    """The packed entry on the search path (``ops.am_agreement(...,
    "matmul")``), at dim = 32 W (== hamming_am) and at dim != 32 W."""
    q, p = _packed(b, s, w, seed=b * s + w + 2)
    q = _with_equal_and_complement(q, p)
    dim = 32 * w + extra
    want = am_matmul.am_matmul_packed_plain(_t(q), _t(p), dim=dim)
    before = _counts()
    got = ops.am_agreement(_t(q).to(cuda), _t(p).to(cuda), dim, "matmul")
    torch.cuda.synchronize()
    assert _counts() == (before[0], before[1], before[2] + 1)
    assert torch.equal(got.cpu(), want)
    if extra == 0:
        assert torch.equal(got.cpu(),
                           hamming_am.hamming_am_plain(_t(q), _t(p)))
        assert int(got[0, 0]) == 32 * w
        if b > 1:
            assert int(got[1, s - 1]) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("k", [8, 40, 44, 63, 64, 72, 100, 128, 130, 4096,
                               4099])
def test_am_matmul_kernel_ragged_k(cuda, k):
    """K below, at, across and not a multiple of the 64-element (128-byte)
    TMA box, and K not a multiple of 8 (rows staged with plain loads,
    not TMA); entries +-1 or 0, as in a zero-padded operand; dim != K."""
    rng = np.random.default_rng(k)
    q = torch.from_numpy(rng.integers(-1, 2, (131, k)).astype(np.float32))
    p = torch.from_numpy(rng.integers(-1, 2, (257, k)).astype(np.float32))
    q, p = q.to(torch.bfloat16), p.to(torch.bfloat16)
    want = am_matmul.am_matmul_plain(q, p, dim=k + 3)
    got = am_matmul.am_matmul(q.to(cuda), p.to(cuda), dim=k + 3)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
def test_am_matmul_edge_cases_cut_the_tiles_as_they_say(cuda):
    """On a 132-SM card the edge cases' S falls one past or one short of
    the slab ``am_matmul.plan`` picks, for both entries; W % 4 decides
    whether the packed stages can come by TMA."""
    for b, s, w in EDGE_CASES:
        for packed, k in ((True, w), (False, 32 * w)):
            tiles = am_matmul.plan(b, s, k, packed=packed)
            n = tiles["protos"]
            assert tiles["rows"] == 256 and n in (32, 48, 64, 80, 96)
            assert tiles["blocks"] == -(-s // n) * -(-b // 256)
            assert tiles["tma"] == (k % (4 if packed else 8) == 0)
            if tiles["sms"] == 132:
                assert s == 1 or s % n in (1, n - 1), (b, s, n)


@pytest.mark.cuda
@pytest.mark.parametrize("w", [64, 1280])
def test_am_matmul_packed_rows_off_by_one_word(cuda, w):
    """Operands that start one word past a 16-byte boundary (a row slice
    of a larger buffer): W % 4 == 0, yet the stages must come by cp.async,
    not TMA, and give the same agreement."""
    b, s = 37, 130
    q, p = _packed(b, s, w, seed=w)
    q = _with_equal_and_complement(q, p)
    want = am_matmul.am_matmul_packed_plain(_t(q), _t(p))

    def shifted(a):
        buf = torch.zeros(a.size + 1, dtype=torch.int32, device=cuda)
        buf[1:] = _t(a).reshape(-1).to(cuda)
        view = buf[1:].view(a.shape)
        assert view.is_contiguous() and view.data_ptr() % 16 != 0
        return view

    assert am_matmul.plan(b, s, w)["tma"]   # only the alignment says no
    got = am_matmul.am_matmul_packed(shifted(q), shifted(p))
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)
    assert int(got[0, 0]) == 32 * w and int(got[1, s - 1]) == 0


@pytest.mark.cuda
def test_search_wrappers_reject_what_the_kernels_do_not_take(cuda):
    w = torch.zeros(4, 8, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="int32"):
        hamming_am.hamming_am(w.long(), w)
    with pytest.raises(ValueError, match="int32"):
        am_matmul.am_matmul_packed(w, w.float())
    with pytest.raises(ValueError, match="differ in W"):
        am_matmul.am_matmul_packed(w, w[:, :5].contiguous())
    with pytest.raises(ValueError, match="bfloat16"):
        am_matmul.am_matmul(w.float(), w.float())
    with pytest.raises(ValueError, match="contiguous"):
        am_matmul.am_matmul(torch.zeros(8, 4, dtype=torch.bfloat16,
                                        device=cuda).T,
                            torch.zeros(3, 8, dtype=torch.bfloat16,
                                        device=cuda))


# -- the CLI -----------------------------------------------------------------

def _run_repro_cli(argv):
    pytest.importorskip("jax")
    from repro.launch import profile_run as jax_run
    saved = sys.argv
    sys.argv = ["profile_run", *argv]
    try:
        jax_run.main()
    finally:
        sys.argv = saved


def _stable_lines(text):
    """The printed lines that do not carry times, paths or the backend."""
    return [ln for ln in text.splitlines()
            if not ln.startswith(("backend ", "wrote report JSON"))]


@pytest.fixture(scope="module")
def repro_cli_run(tmp_path_factory):
    path = tmp_path_factory.mktemp("repro_run") / "report.json"
    import contextlib
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        _run_repro_cli([*FLAGS, "--json", str(path)])
    return json.loads(path.read_text()), buf.getvalue()


@pytest.mark.parametrize("backend", ["reference", "cuda_packed",
                                     "cuda_matmul"])
def test_profile_run_matches_repro(repro_cli_run, tmp_path, capsys,
                                   backend):
    want_json, want_out = repro_cli_run
    path = tmp_path / "report.json"
    mode = [] if _jax_mode() else ["--no-threefry-partitionable"]
    profile_run.main([*FLAGS, "--backend", backend, "--device", "cpu",
                      "--json", str(path), *mode])
    out = capsys.readouterr().out
    assert json.loads(path.read_text()) == want_json
    assert _stable_lines(out) == _stable_lines(want_out)
    assert f"backend {backend} | build " in out
    assert "vs ground truth: precision=1.000 recall=1.000" in out


def test_profile_run_lists_every_backend(capsys):
    profile_run.main(["--list-backends"])
    names = [ln for ln in capsys.readouterr().out.splitlines()
             if not ln.startswith(" ")]
    assert names == ["cuda_fused", "cuda_matmul", "cuda_packed", "pcm_sim",
                     "racetrack_sim", "reference", "reference_packed",
                     "sharded"]


@pytest.mark.parametrize("argv,match", [
    # one rank here: two shards need two ranks (torchrun)
    (["--shards", "2"], "num_shards must equal the world size 1"),
    (["--mesh", "2"], "num_shards must equal the world size 1"),
    (["--shards", "2", "--mesh", "3"], "--mesh 3 conflicts with --shards 2"),
    # queue 1 item 10 (the device model): its CLI options fail as every
    # backend's do
    pytest.param(["--noise-aware-refdb", "--backend", "pcm_sim",
                  "--backend-option", "preset=tpu"],
                 "'preset' must be one of",
                 id="argv3-ROADMAP queue 1 item 10"),
    (["--backend", "pallas_matmul"], "unknown backend 'pallas_matmul'"),
    (["--backend", "cuda_packed", "--backend-option", "bb=4"],
     "cuda_packed got unknown option 'bb'"),
    (["--backend", "cuda_fused", "--backend-option", "bb=four"],
     "'bb' must be an integer"),
    (["--backend", "cuda_fused", "--backend-option", "cluster=3"],
     "must be one of"),
])
def test_profile_run_cli_errors(capsys, argv, match):
    with pytest.raises(SystemExit) as e:
        profile_run.main([*FLAGS, "--device", "cpu", *argv])
    assert e.value.code == 2
    assert match in capsys.readouterr().err


def test_profile_run_defaults_to_cuda(capsys):
    if torch.cuda.is_available():
        args = profile_run._parser().parse_args(FLAGS)
        assert args.device == "cuda"
        return
    with pytest.raises(SystemExit) as e:
        profile_run.main([*FLAGS, "--backend", "cuda_packed"])
    assert e.value.code == 2
    assert "torch.cuda.is_available() is false" in capsys.readouterr().err
