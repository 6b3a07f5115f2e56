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
@pytest.mark.parametrize("b,s,w", CUDA_CASES)
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
@pytest.mark.parametrize("b,s,w", CUDA_CASES)
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
@pytest.mark.parametrize("k", [8, 40, 44, 63, 100, 130, 4099])
def test_am_matmul_kernel_ragged_k(cuda, k):
    """K below, across and not a multiple of the 64-wide K tile, and K
    not a multiple of 8 (rows staged without cp.async); entries +-1 or 0,
    as in a zero-padded operand; dim != K."""
    rng = np.random.default_rng(k)
    q = torch.from_numpy(rng.integers(-1, 2, (131, k)).astype(np.float32))
    p = torch.from_numpy(rng.integers(-1, 2, (257, k)).astype(np.float32))
    q, p = q.to(torch.bfloat16), p.to(torch.bfloat16)
    want = am_matmul.am_matmul_plain(q, p, dim=k + 3)
    got = am_matmul.am_matmul(q.to(cuda), p.to(cuda), dim=k + 3)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)


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
    assert names == ["cuda_fused", "cuda_matmul", "cuda_packed",
                     "reference", "reference_packed", "sharded"]


@pytest.mark.parametrize("argv,match", [
    # one rank here: two shards need two ranks (torchrun)
    (["--shards", "2"], "num_shards must equal the world size 1"),
    (["--mesh", "2"], "num_shards must equal the world size 1"),
    (["--shards", "2", "--mesh", "3"], "--mesh 3 conflicts with --shards 2"),
    (["--noise-aware-refdb"], "ROADMAP queue 1 item 10"),
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
