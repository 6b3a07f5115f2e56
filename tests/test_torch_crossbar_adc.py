"""The crossbar read's per-chunk epilogue (``kernels/crossbar_adc.py``):
read noise, ADC and the sum over a chunk's row tiles.

On the CPU :func:`crossbar_adc` runs its plain version, which must equal
the read's earlier step-by-step ops -- the Threefry kernel's read-noise
epilogue into the partial counts, ``round_``, the clip count, ``clamp_``,
the step's ``mul_``, ``sum(dim=0)`` -- written out below as
``_stepwise_*``, on both substrates and in both threefry modes, one chunk
and a whole read event alike.

The ``cuda`` cases hold the CUDA kernel against the plain version on the
card and skip without one.  At a lossless ADC every code is a whole count
and the float32 sums are exact in any order, so the two are equal bit for
bit: outputs, agreements and clip counts.  At a lossy ADC the kernel sums
the scaled codes in tile order and ``torch.sum`` in its own, so the
agreements may differ by one count (the share that differs is printed).
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.accel import crossbar
from repro_torch.accel.backend_pcm import split_options
from repro_torch.core import bitops
from repro_torch.core import threefry as tf_core
from repro_torch.kernels import crossbar_adc as ca
from repro_torch.kernels import threefry

SUBSTRATES = [("pcm_sim", "pcm"), ("racetrack_sim", "racetrack")]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device("cuda")


def _substrate(backend, substrate, partitionable, **options):
    # a loud read noise by default, so that the converter clips codes
    opts = {"preset": substrate, "seed": 11, "read_sigma": 1.5, **options}
    return split_options(opts, backend=backend, default_substrate=substrate,
                         partitionable=partitionable)


def _stepwise_chunk(count, keys, active, sub, xcfg, out, clips):
    """The read's per-chunk ops before the kernel, one after the other."""
    levels = (1 << xcfg.adc_bits) - 1
    step = 1.0 if xcfg.lossless else xcfg.rows / levels
    t, b, s = count.shape
    std, divisor = sub.read_noise_scale(active)
    if std is not None:
        threefry.threefry_draw(
            threefry.keys_tensor(keys, count.device), b * s,
            epilogue="normal", partitionable=sub.partitionable,
            scale=std.contiguous(), inner=s, divisor=divisor, out=count)
    if step != 1.0:
        count = count.div_(torch.tensor(np.float32(step),
                                        device=count.device))
    code = count.round_()
    if clips is not None:
        clips += ((code < 0) | (code > levels)).sum()
    code.clamp_(0, levels)
    if step != 1.0:
        code.mul_(np.float32(step).item())
    part = code.sum(dim=0)
    return part if out is None else out.add_(part)


def _stepwise_read(queries, w_pos, w_neg, dim, xcfg, sub):
    """``read_banks(..., with_stats=True)`` with the per-chunk ops of
    :func:`_stepwise_chunk`: each bank summed on its own, then added."""
    digest = crossbar.batch_digest(queries)
    qbits = bitops.unpack_bits(queries).to(torch.float32)
    clips = torch.zeros((), dtype=torch.int64, device=qbits.device)
    total = None
    for stream, (bits, weights) in enumerate(((qbits, w_pos),
                                              (1.0 - qbits, w_neg))):
        q = crossbar._to_row_tiles(bits, xcfg.rows)
        t, b, _ = q.shape
        keys = tf_core.split(sub.read_event_key(stream, digest), t,
                             partitionable=sub.partitionable)
        span = crossbar.block_tiles(b, weights.shape[1])
        out = None
        for t0 in range(0, t, span):
            count = torch.bmm(q[t0:t0 + span],
                              weights[t0:t0 + span].transpose(1, 2))
            out = _stepwise_chunk(count, keys[t0:t0 + span],
                                  q[t0:t0 + span].sum(dim=-1), sub, xcfg,
                                  out, clips)
        total = out if total is None else total.add_(out)
    return total.round_().clamp_(0, dim).to(torch.int32), int(clips)


def _banks(xcfg, sub, dim, b, s, device, seed=5):
    g = torch.Generator().manual_seed(seed)
    queries = bitops.pack_bits(torch.randint(0, 2, (b, dim), generator=g,
                                             dtype=torch.uint8)).to(device)
    protos = bitops.pack_bits(torch.randint(0, 2, (s, dim), generator=g,
                                            dtype=torch.uint8)).to(device)
    s_pos, s_neg = crossbar.program_prototypes(protos, xcfg, sub)
    return queries, (sub.read_weights(s_pos, stream=0),
                     sub.read_weights(s_neg, stream=1))


def _chunk(xcfg, sub, t, b, s, device, seed):
    """A chunk's inputs as the read makes them: integer-ish partial counts
    of ``rows``-row tiles, the tiles' keys and the noise scale."""
    g = torch.Generator().manual_seed(seed)
    active = torch.randint(0, xcfg.rows + 1, (t, b), generator=g)
    counts = (torch.rand((t, b, s), generator=g) * active[:, :, None]
              ).floor_() + torch.rand((t, b, s), generator=g) * 0.02
    keys = np.random.default_rng(seed).integers(0, 2 ** 32, (t, 2),
                                                dtype=np.uint32)
    std, divisor = sub.read_noise_scale(active.to(device))
    return (counts.to(device), keys, active.to(device),
            threefry.keys_tensor(keys, device), std, divisor)


def _adc(xcfg):
    levels = (1 << xcfg.adc_bits) - 1
    return {"levels": levels,
            "step": 1.0 if xcfg.lossless else xcfg.rows / levels}


# -- the plain version against the step-by-step ops (CPU) -----------------

@pytest.mark.parametrize("adc_bits", [9, 7])
@pytest.mark.parametrize("partitionable", [True, False])
@pytest.mark.parametrize("backend,substrate", SUBSTRATES)
def test_plain_chunk_equals_stepwise(backend, substrate, partitionable,
                                     adc_bits):
    xcfg, sub = _substrate(backend, substrate, partitionable,
                           adc_bits=adc_bits)
    counts, keys_np, active, keys, std, divisor = _chunk(
        xcfg, sub, 3, 9, 70, "cpu", seed=adc_bits)
    prior = torch.rand((9, 70))
    clips_want = torch.zeros((), dtype=torch.int64)
    want = _stepwise_chunk(counts.clone(), keys_np, active, sub, xcfg,
                           prior.clone(), clips_want)
    clips = torch.zeros((), dtype=torch.int64)
    before = ca.crossbar_adc.launches
    got = ca.crossbar_adc(counts.clone(), keys, std, divisor, **_adc(xcfg),
                          partitionable=partitionable, out=prior.clone(),
                          clips=clips)
    assert ca.crossbar_adc.launches == before       # the plain version ran
    assert torch.equal(got, want)
    assert int(clips) == int(clips_want) > 0
    first = ca.crossbar_adc_plain(counts.clone(), keys, std, divisor,
                                  **_adc(xcfg), partitionable=partitionable)
    assert torch.equal(first, _stepwise_chunk(counts.clone(), keys_np,
                                              active, sub, xcfg, None, None))


@pytest.mark.parametrize("partitionable", [True, False])
@pytest.mark.parametrize("backend,substrate", SUBSTRATES)
@pytest.mark.parametrize("options", [{}, {"read_sigma": 0.0},
                                     {"adc_bits": 7}])
def test_read_banks_equals_stepwise(backend, substrate, partitionable,
                                    options):
    """A whole read event at D = 2,048: agreements and clip count."""
    xcfg, sub = _substrate(backend, substrate, partitionable, **options)
    dim = 2048
    queries, (w_pos, w_neg) = _banks(xcfg, sub, dim, 21, 300, "cpu")
    got = crossbar.read_banks(queries, w_pos, w_neg, dim, xcfg, sub,
                              with_stats=True)
    want = _stepwise_read(queries, w_pos, w_neg, dim, xcfg, sub)
    assert torch.equal(got[0], want[0])
    assert got[1] == want[1]
    if options.get("read_sigma", 1.5):
        assert got[1] > 0


@pytest.mark.parametrize("partitionable", [True, False])
@pytest.mark.parametrize("span", [1, 3])
def test_chunked_read_equals_stepwise(partitionable, span, monkeypatch):
    """Chunks of row tiles, the last one ragged (8 tiles)."""
    xcfg, sub = _substrate("pcm_sim", "pcm", partitionable)
    dim, b = 2048, 13
    queries, (w_pos, w_neg) = _banks(xcfg, sub, dim, b, 200, "cpu", seed=9)
    monkeypatch.setattr(crossbar, "BLOCK_BYTES", 4 * b * 256 * span)
    assert crossbar.block_tiles(b, 256) == span
    got = crossbar.read_banks(queries, w_pos, w_neg, dim, xcfg, sub,
                              with_stats=True)
    want = _stepwise_read(queries, w_pos, w_neg, dim, xcfg, sub)
    assert torch.equal(got[0], want[0])
    assert got[1] == want[1] > 0


def test_read_noise_scale_is_none_without_read_noise():
    for backend, substrate in SUBSTRATES:
        xcfg, sub = _substrate(backend, substrate, True, read_sigma=0.0)
        std, divisor = sub.read_noise_scale(torch.ones((2, 3)))
        assert std is None and divisor > 0
        _, noisy = _substrate(backend, substrate, True)
        std, _ = noisy.read_noise_scale(torch.full((2, 3), 4.0))
        assert std.shape == (2, 3) and bool((std > 0).all())


@pytest.mark.parametrize("bad", ["counts", "keys", "std", "out", "clips"])
def test_wrapper_refuses_bad_operands(bad):
    xcfg, sub = _substrate("pcm_sim", "pcm", True)
    counts, _, _, keys, std, divisor = _chunk(xcfg, sub, 2, 3, 8, "cpu", 1)
    kw = {"out": torch.zeros((3, 8)),
          "clips": torch.zeros((), dtype=torch.int64)}
    if bad == "counts":
        counts = counts.double()
    elif bad == "keys":
        keys = keys[:1]
    elif bad == "std":
        std = std[:, :2]
    elif bad == "out":
        kw["out"] = torch.zeros((3, 7))
    else:
        kw["clips"] = torch.zeros((), dtype=torch.int32)
    with pytest.raises(ValueError, match=bad):
        ca.crossbar_adc(counts, keys, std, divisor, **_adc(xcfg),
                        partitionable=True, **kw)


# -- the CUDA kernel against the plain version (card) ---------------------

@pytest.mark.cuda
@pytest.mark.parametrize("t,b,s", [
    (17, 64, 3_072),      # the cell's layout: 16-byte groups in both modes
    (5, 1, 260),          # B S = 260: groups of 4 partitionable, 1 original
    (4, 33, 255),         # an odd B S: the original mode's unpaired value
    (1, 7, 9),
])
@pytest.mark.parametrize("partitionable", [True, False])
@pytest.mark.parametrize("backend,substrate", SUBSTRATES)
def test_kernel_chunk_matches_plain(cuda, backend, substrate, partitionable,
                                    t, b, s):
    xcfg, sub = _substrate(backend, substrate, partitionable)
    counts, _, _, keys, std, divisor = _chunk(xcfg, sub, t, b, s, cuda,
                                              seed=t * b + s)
    for first in (True, False):
        prior = None if first else torch.rand((b, s), device=cuda) * 300
        outs, clips = [], []
        for fn in (ca.crossbar_adc, ca.crossbar_adc_plain):
            c = torch.zeros((), dtype=torch.int64, device=cuda)
            outs.append(fn(counts.clone(), keys, std, divisor, **_adc(xcfg),
                           partitionable=partitionable,
                           out=None if prior is None else prior.clone(),
                           clips=c))
            clips.append(int(c))
        torch.cuda.synchronize()
        assert torch.equal(outs[0], outs[1]), first
        assert clips[0] == clips[1], first
        assert clips[0] > 0 or t * b * s < 1000


@pytest.mark.cuda
@pytest.mark.parametrize("partitionable", [True, False])
@pytest.mark.parametrize("backend,substrate", SUBSTRATES)
def test_kernel_without_read_noise_matches_plain(cuda, backend, substrate,
                                                 partitionable):
    xcfg, sub = _substrate(backend, substrate, partitionable, read_sigma=0.0)
    counts, _, _, keys, std, divisor = _chunk(
        xcfg, sub, 6, 40, 1_000, cuda, seed=3)
    assert std is None
    got = ca.crossbar_adc(counts.clone(), keys, None, divisor, **_adc(xcfg),
                          partitionable=partitionable)
    want = ca.crossbar_adc_plain(counts.clone(), keys, None, divisor,
                                 **_adc(xcfg), partitionable=partitionable)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def _read_both(cuda, monkeypatch, xcfg, sub, queries, w_pos, w_neg, dim):
    """``read_banks`` on the card through the kernel, then through the
    plain version, with their clip counts."""
    got = crossbar.read_banks(queries, w_pos, w_neg, dim, xcfg, sub,
                              with_stats=True)
    with monkeypatch.context() as m:
        m.setattr(crossbar, "crossbar_adc", ca.crossbar_adc_plain)
        want = crossbar.read_banks(queries, w_pos, w_neg, dim, xcfg, sub,
                                   with_stats=True)
    torch.cuda.synchronize()
    return got, want


@pytest.mark.cuda
@pytest.mark.parametrize("partitionable", [True, False])
@pytest.mark.parametrize("backend,substrate", SUBSTRATES)
def test_chunked_read_matches_plain_on_the_card(cuda, backend, substrate,
                                                partitionable, monkeypatch):
    """D = 40,000 (157 tiles) in chunks of 50, 17 and 1 tiles (the first
    two ragged at the end), with a loud read noise: agreements and clips
    bit for bit."""
    torch.backends.cuda.matmul.allow_tf32 = False
    xcfg, sub = _substrate(backend, substrate, partitionable)
    dim, b = 40_000, 256
    queries, (w_pos, w_neg) = _banks(xcfg, sub, dim, b, 2_900, cuda)
    s_pad = w_pos.shape[1]
    for span in (50, 17, 1):
        monkeypatch.setattr(crossbar, "BLOCK_BYTES", 4 * b * s_pad * span)
        got, want = _read_both(cuda, monkeypatch, xcfg, sub, queries, w_pos,
                               w_neg, dim)
        assert torch.equal(got[0], want[0]), span
        assert got[1] == want[1] > 0, span


@pytest.mark.cuda
@pytest.mark.parametrize("partitionable", [True, False])
def test_read_with_odd_width_matches_plain_on_the_card(cuda, partitionable,
                                                       monkeypatch):
    """255 columns an array and 33 queries: B S_pad odd."""
    torch.backends.cuda.matmul.allow_tf32 = False
    xcfg, sub = _substrate("pcm_sim", "pcm", partitionable, cols=255)
    dim = 4_000
    queries, (w_pos, w_neg) = _banks(xcfg, sub, dim, 33, 200, cuda)
    assert 33 * w_pos.shape[1] % 2 == 1
    got, want = _read_both(cuda, monkeypatch, xcfg, sub, queries, w_pos,
                           w_neg, dim)
    assert torch.equal(got[0], want[0])
    assert got[1] == want[1] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("partitionable", [True, False])
def test_lossy_read_within_one_count_on_the_card(cuda, partitionable,
                                                 monkeypatch):
    """A 7-bit ADC: the scaled codes summed in another order than
    ``torch.sum``'s may round the agreement the other way."""
    torch.backends.cuda.matmul.allow_tf32 = False
    xcfg, sub = _substrate("pcm_sim", "pcm", partitionable, adc_bits=7)
    dim = 40_000
    queries, (w_pos, w_neg) = _banks(xcfg, sub, dim, 128, 2_000, cuda)
    got, want = _read_both(cuda, monkeypatch, xcfg, sub, queries, w_pos,
                           w_neg, dim)
    diff = (got[0].long() - want[0].long()).abs()
    share = float((diff > 0).float().mean())
    print(f"lossy 7-bit ADC, partitionable={partitionable}: {share:.3e} of "
          f"{diff.numel()} agreements differ, by at most {int(diff.max())}")
    assert int(diff.max()) <= 1
    assert got[1] == want[1] > 0


@pytest.mark.cuda
def test_read_launches_one_kernel_a_chunk_inside_its_span(cuda, tmp_path,
                                                          monkeypatch):
    """One launch a chunk and bank, counted; under ``torch.profiler``
    every ``crossbar_adc_kernel`` runs inside ``repro_torch.crossbar.read``
    and the read launches no Threefry kernel."""
    from torch.profiler import ProfilerActivity, profile

    torch.backends.cuda.matmul.allow_tf32 = False
    xcfg, sub = _substrate("pcm_sim", "pcm", True)
    dim, b = 40_000, 128
    queries, (w_pos, w_neg) = _banks(xcfg, sub, dim, b, 1_000, cuda)
    s_pad = w_pos.shape[1]
    monkeypatch.setattr(crossbar, "BLOCK_BYTES", 4 * b * s_pad * 17)
    chunks = -(-w_pos.shape[0] // 17)                 # 157 tiles: 10
    crossbar.read_banks(queries, w_pos, w_neg, dim, xcfg, sub)   # warm
    torch.cuda.synchronize()
    before = ca.crossbar_adc.launches
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        crossbar.read_banks(queries, w_pos, w_neg, dim, xcfg, sub)
        torch.cuda.synchronize()
    assert ca.crossbar_adc.launches == before + 2 * chunks
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    spans = [(e["ts"], e["ts"] + e["dur"]) for e in events
             if e.get("name") == "repro_torch.crossbar.read"
             and e.get("cat") == "user_annotation"]
    launches = {e["args"]["correlation"]: e["ts"] for e in events
                if e.get("cat") in ("cuda_runtime", "cuda_driver")
                and "correlation" in e.get("args", {})}
    kernels = [e for e in events if e.get("cat") == "kernel"]
    ours = [k for k in kernels if "crossbar_adc_kernel" in k["name"]]
    assert len(spans) == 1 and len(ours) == 2 * chunks
    lo, hi = spans[0]
    assert all(lo <= launches[k["args"]["correlation"]] <= hi for k in ours)
    assert not [k for k in kernels if "threefry" in k["name"]]
