"""Item memory (IM): the atomic HD vectors for the genome alphabet.

Counterpart of :mod:`repro.core.item_memory`.  The words are drawn with
the port's own Threefry (:mod:`repro_torch.core.threefry`) from the same
seeds as ``repro`` -- ``jax.random.key(space.seed)`` for the IM and
``space.seed ^ 0x7EB4EA4`` for the tie-break vector -- so both packages
hold bit-identical item memories.  ``partitionable`` selects the JAX
``jax_threefry_partitionable`` mode to reproduce (``None``: the default,
:data:`threefry.PARTITIONABLE`).
"""

from __future__ import annotations

import torch

from repro_torch.core import bitops, threefry
from repro_torch.core.hd_space import HDSpace

_TIE_SALT = 0x7EB4EA4


def make_item_memory(space: HDSpace, *, device: str | torch.device = "cpu",
                     partitionable: bool | None = None) -> torch.Tensor:
    """Generate the ``(alphabet_size, W)`` packed atomic HD vectors."""
    return bitops.random_packed(
        threefry.key(space.seed), (space.alphabet_size,), space.dim,
        space.density, partitionable=partitionable, device=device)


def make_tie_break(space: HDSpace, *, device: str | torch.device = "cpu",
                   partitionable: bool | None = None) -> torch.Tensor:
    """Fixed random ``(W,)`` packed vector used to break majority ties."""
    return bitops.random_packed(
        threefry.key(space.seed ^ _TIE_SALT), (), space.dim, 0.5,
        partitionable=partitionable, device=device)


def rolled(im: torch.Tensor, n: int) -> torch.Tensor:
    """Stack ``rho**j(im)`` for j in [0, n) -> ``(n, alphabet, W)``.

    The j-th character of an n-gram is bound through ``rho**j`` (paper
    Eq. 1); the rolled copies turn every gram into a gather + XOR.
    """
    return torch.stack([bitops.rho(im, j) for j in range(n)], dim=0)
