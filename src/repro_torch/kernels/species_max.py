"""Per-species max of the agreement: ``(B, P)`` -> ``(B, S)``.

Replaces no TPU kernel: ``repro`` leaves the reduction to XLA as
``jax.ops.segment_max(..., indices_are_sorted=True)``
(``repro/core/assoc_memory.py``).  The CUDA kernel (``csrc/species_max.cu``)
is bound by bytes, ``4 B P + 4 B S`` at the card's memory bandwidth; it
reads each agreement byte once in 16-byte loads and adds one atomic max a
run of equal ids a row, where ``scatter_reduce_`` added one an element.

:func:`species_max` launches the kernel for CUDA tensors and counts the
launch in ``species_max.launches``; for CPU tensors it runs
:func:`species_max_plain`, the plain torch version of the same function.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build


def species_max_plain(agreement: torch.Tensor, proto_species: torch.Tensor,
                      num_species: int) -> torch.Tensor:
    """Plain torch version: ``scatter_reduce_`` (amax) into one spare
    column for ids outside ``[0, num_species)``, which is cut off."""
    b = agreement.shape[0]
    ids = proto_species.long()
    ids = torch.where((ids < 0) | (ids >= num_species), num_species, ids)
    out = torch.full((b, num_species + 1), torch.iinfo(torch.int32).min,
                     dtype=torch.int32, device=agreement.device)
    out.scatter_reduce_(1, ids[None, :].expand(b, -1),
                        agreement.to(torch.int32), reduce="amax",
                        include_self=True)
    return out[:, :num_species]


def _lib():
    lib = _build.library("species_max")
    if not getattr(lib, "_typed", False):
        lib.species_max_launch.argtypes = (
            [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2
            + [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p])
        lib.species_max_launch.restype = ctypes.c_int
        lib._typed = True
    return lib


def species_max(agreement: torch.Tensor, proto_species: torch.Tensor,
                num_species: int) -> torch.Tensor:
    """Max agreement of every row over each species' prototypes.

    Args:
      agreement: ``(B, P)`` int32 agreement of B reads with P prototypes;
        rows may lie further apart than P (a column slice).
      proto_species: ``(P,)`` int32 species id of each prototype; ids
        outside ``[0, num_species)`` (padding) are skipped.
      num_species: S.

    Returns:
      ``(B, S)`` contiguous int32; the int32 minimum (``NO_SCORE``) where a
      species has no prototype.
    """
    if agreement.device.type == "cpu":
        return species_max_plain(agreement, proto_species, num_species)
    if agreement.device.type != "cuda":
        raise ValueError(f"species_max: unsupported device {agreement.device}")
    if agreement.dim() != 2 or proto_species.dim() != 1 or \
            proto_species.shape[0] != agreement.shape[1]:
        raise ValueError(f"species_max: agreement (B, P) and proto_species "
                         f"(P,) expected, got {tuple(agreement.shape)} and "
                         f"{tuple(proto_species.shape)}")
    if proto_species.device != agreement.device:
        raise ValueError(f"species_max: proto_species on "
                         f"{proto_species.device}, agreement on "
                         f"{agreement.device}")
    if agreement.dtype != torch.int32 or proto_species.dtype != torch.int32:
        raise ValueError(f"species_max: int32 agreement and proto_species "
                         f"expected, got {agreement.dtype} and "
                         f"{proto_species.dtype}")
    a = agreement
    if a.stride(1) != 1 or a.stride(0) < a.shape[1]:
        a = a.contiguous()
    ids = proto_species.contiguous()
    b, p = a.shape
    out = torch.full((b, num_species), torch.iinfo(torch.int32).min,
                     dtype=torch.int32, device=a.device)
    with torch.cuda.device(a.device):
        err = _lib().species_max_launch(
            *map(_build.ptr, (a, ids, out)), b, p, max(a.stride(0), p),
            num_species, _build.current_stream())
    if err != 0:
        raise RuntimeError(f"species_max: kernel launch failed with CUDA "
                           f"error {err} (B={b}, P={p}, S={num_species})")
    _build.count_launch(species_max)
    return out


species_max.launches = 0
