"""The Threefry kernel (``csrc/threefry.cu``) against its plain version.

The ``cuda`` cases draw on the card in both ``jax_threefry_partitionable``
modes and every epilogue, and hold the kernel against
``threefry_draw_plain`` on the same keys on the same card: bits and
uniforms exactly; normals to at most 1 ulp in at most 1e-5 of the draws
(both sides use the card's ``log1pf``; the plain version's fused steps
are float64 emulations, which round a sum onto a float32 halfway point
only rarely).  They skip without a card.  The CPU cases check the wrapper's
plain path and its argument checks.  This file needs only torch (the GPU
machine has no JAX); ``tests/test_torch_random.py`` holds the plain
version against ``jax.random``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import threefry as tf
from repro_torch.kernels import threefry


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device("cuda")


def _keys(n, seed, device):
    rng = np.random.default_rng(seed)
    return threefry.keys_tensor(
        rng.integers(0, 2 ** 32, (n, 2), dtype=np.uint32), device)


def _ulp(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a.cpu().view(torch.int32).long()
            - b.cpu().view(torch.int32).long()).abs()


@pytest.mark.cuda
@pytest.mark.parametrize("partitionable", [True, False])
@pytest.mark.parametrize("n,m", [(1, 1), (1, 7), (3, 1000), (160, 4097),
                                 (2, 1 << 20)])
def test_kernel_bits_and_uniform_exact(cuda, partitionable, n, m):
    keys = _keys(n, m, cuda)
    for epi, kw in (("bits", {}), ("uniform", {}),
                    ("uniform", {"minval": -2.5, "maxval": 3.0})):
        got = threefry.threefry_draw(keys, m, epilogue=epi,
                                     partitionable=partitionable, **kw)
        want = threefry.threefry_draw_plain(keys, m, epilogue=epi,
                                            partitionable=partitionable, **kw)
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(), want.cpu()), (epi, kw)


@pytest.mark.cuda
@pytest.mark.parametrize("partitionable", [True, False])
def test_kernel_normal_epilogues_match_plain(cuda, partitionable):
    t, b, s = 6, 16, 331
    keys = _keys(t, 9, cuda)
    got = threefry.threefry_draw(keys, b * s, epilogue="normal",
                                 partitionable=partitionable)
    want = threefry.threefry_draw_plain(keys, b * s, epilogue="normal",
                                        partitionable=partitionable)
    ulp = _ulp(got, want)
    assert ulp.max() <= 1 and (ulp > 0).float().mean() <= 1e-5
    # the read-noise epilogue: counts + (std[t, b] * normal) / divisor
    std = torch.rand(t, b, device=cuda) * 3
    base = torch.randint(0, 256, (t, b, s), device=cuda).float()
    for divisor in (1.0, 19.9):
        acc = base.clone()
        threefry.threefry_draw(keys, b * s, epilogue="normal",
                               partitionable=partitionable, scale=std,
                               inner=s, divisor=divisor, out=acc)
        ref = base.clone()
        threefry.threefry_draw_plain(keys, b * s, epilogue="normal",
                                     partitionable=partitionable, scale=std,
                                     inner=s, divisor=divisor, out=ref)
        assert _ulp(acc, ref).max() <= 1
        assert (acc != ref).float().mean() <= 1e-4


@pytest.mark.cuda
def test_kernel_counts_launches_and_refuses_bad_shapes(cuda):
    keys = _keys(2, 1, cuda)
    before = threefry.threefry_draw.launches
    threefry.threefry_draw(keys, 10, epilogue="bits")
    assert threefry.threefry_draw.launches == before + 1
    with pytest.raises(ValueError, match="scale of"):
        threefry.threefry_draw(keys, 10, epilogue="normal", inner=3,
                               scale=torch.ones(2, device=cuda))


def test_plain_path_on_cpu_tensors():
    """On CPU tensors the wrapper is the plain version (no launch)."""
    keys = _keys(3, 4, "cpu")
    before = threefry.threefry_draw.launches
    got = threefry.threefry_draw(keys, 101, epilogue="bits",
                                 partitionable=False)
    assert threefry.threefry_draw.launches == before
    for row in range(3):
        k = tuple(np.uint32(x) for x in
                  keys[row].numpy().view(np.uint32))
        np.testing.assert_array_equal(
            got[row].numpy().view(np.uint32),
            tf.random_bits(k, (101,), partitionable=False))


def test_normal_scale_and_accumulate_on_cpu():
    keys = _keys(2, 5, "cpu")
    n = threefry.threefry_draw(keys, 12, epilogue="normal")
    std = torch.tensor([[1.0, 2.0, 3.0], [0.5, 0.0, 4.0]])
    out = torch.full((2, 12), 7.0)
    threefry.threefry_draw(keys, 12, epilogue="normal", scale=std, inner=4,
                           divisor=2.0, out=out)
    want = 7.0 + (std.repeat_interleave(4, dim=1) * n) / 2.0
    assert torch.equal(out, want)


@pytest.mark.parametrize("kwargs,match", [
    ({"epilogue": "gamma"}, "unknown epilogue"),
    ({"epilogue": "bits", "scale": 2.0}, "normal epilogue"),
    ({"epilogue": "normal", "out": torch.zeros(5)}, "out must hold"),
])
def test_bad_arguments_rejected(kwargs, match):
    with pytest.raises(ValueError, match=match):
        threefry.threefry_draw(_keys(2, 0, "cpu"), 12, **kwargs)
