"""Head padding for the model axis (``pad_heads`` / ``unpad_heads``) as
products with the plan's 0/1 slot matrix, against the index form they
replace and against ``repro``'s ``pad_heads`` / ``unpad_heads``: bit for
bit in float32 and bfloat16, for the head counts of the full
configurations that pad (hymba-1.5b 25 / 5, starcoder2-7b 36 / 4,
whisper-tiny 6 / 6, paligemma-3b 8 / 1) on model axes of 2, 4 and 16.
A head count the axis divides gets no plan, in both packages.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp

from repro.models import attention as jattn
from repro_torch.models import attention as tattn

HEADS = [(25, 5), (36, 4), (6, 6), (8, 1)]
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}
B, S, DH = 2, 3, 4


def _index_pad(q, k, v, plan):
    """The index form: ``qp[..., slots, :] = q``."""
    hp, kvp, slots = plan
    qp = q.new_zeros(q.shape[:-2] + (hp, q.shape[-1]))
    qp[..., torch.as_tensor(slots), :] = q

    def padkv(t):
        if t.shape[-2] == kvp:
            return t
        return torch.cat([t, t.new_zeros(t.shape[:-2] + (
            kvp - t.shape[-2], t.shape[-1]))], dim=-2)
    return qp, padkv(k), padkv(v)


def _bits(t: torch.Tensor) -> np.ndarray:
    view = torch.int16 if t.dtype == torch.bfloat16 else torch.int32
    return t.contiguous().view(view).numpy()


def _jbits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.int16 if a.dtype.itemsize == 2 else np.int32)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("tp", [2, 4, 16])
@pytest.mark.parametrize("h,kv", HEADS)
def test_slot_products_equal_index_form_and_repro(h, kv, tp, dtype):
    plan = tattn.head_padding_plan(h, kv, tp)
    jplan = jattn.head_padding_plan(h, kv, tp)
    if plan is None:
        assert jplan is None and h % tp == 0
        return
    assert plan[:2] == jplan[:2]
    np.testing.assert_array_equal(plan[2], jplan[2])
    hp, kvp, _ = plan
    tdt, jdt = DTYPES[dtype]
    rng = np.random.default_rng(h * 100 + tp)
    q, k, v = (rng.normal(size=(B, S, n, DH)).astype(np.float32)
               for n in (h, kv, kv))
    out = rng.normal(size=(B, S, hp, DH)).astype(np.float32)
    tq, tk, tv, tout = (torch.from_numpy(a).to(tdt) for a in (q, k, v, out))

    got = tattn.pad_heads(tq, tk, tv, plan)
    want = _index_pad(tq, tk, tv, plan)
    jgot = jattn.pad_heads(*(jnp.asarray(a, jdt) for a in (q, k, v)), jplan)
    for g, w, j in zip(got, want, jgot):
        assert g.dtype == tdt and g.shape == w.shape == j.shape
        np.testing.assert_array_equal(_bits(g), _bits(w))
        np.testing.assert_array_equal(_bits(g), _jbits(j))
    assert got[0].shape[-2] == hp and got[1].shape[-2] == kvp

    un = tattn.unpad_heads(tout, plan)
    np.testing.assert_array_equal(
        _bits(un), _bits(tout[..., torch.as_tensor(plan[2]), :]))
    np.testing.assert_array_equal(_bits(un), _jbits(jattn.unpad_heads(
        jnp.asarray(out, jdt), jplan)))
    # the round trip keeps every real head
    np.testing.assert_array_equal(_bits(tattn.unpad_heads(got[0], plan)),
                                  _bits(tq))
