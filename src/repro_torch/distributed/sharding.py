"""The profiling mesh on ``torch.distributed``: one rank per shard.

Counterpart of the profiling part of :mod:`repro.distributed.sharding`
(``PROFILE_RULES`` and ``make_profile_mesh``).  ``repro`` splits the
associative memory over a 1-D ``('shard',)`` device mesh and runs the
search under ``shard_map``; the torch idiom for the same split is one
process (rank) per shard of a ``torch.distributed`` process group.  Every
rank runs the same session over the same reads, holds ``S_padded /
shards`` prototype rows, and the per-shard partial species scores merge
with ``all_reduce(MAX)``.

The group's backend is NCCL when every rank has a card of its own and
gloo otherwise: NCCL refuses two ranks on one GPU, and gloo all-reduces
CUDA tensors too.  CPU ranks use gloo.
"""

from __future__ import annotations

import dataclasses
import os

import torch
import torch.distributed as dist

from repro_torch.device import resolve_device

#: What each logical axis of the profiling path is split over, as in
#: ``repro``'s ``PROFILE_RULES``: reads, the packed HD words and the
#: merged species scores are replicated on every rank; the prototype rows
#: are split over the ``shard`` axis, one shard a rank.
PROFILE_RULES: dict[str, str | None] = {
    "reads": None,            # query batch: replicated (every shard scores it)
    "protos": "shard",        # prototype rows: split across the ranks
    "hd_words": None,         # packed HD dim: contiguous within a shard
    "species": None,          # per-species scores: replicated after merge
}


@dataclasses.dataclass(frozen=True)
class ProfileMesh:
    """The 1-D ``('shard',)`` mesh: ``size`` ranks, this process's
    ``rank``, the process group's ``backend`` (``"nccl"`` or ``"gloo"``)."""

    size: int
    rank: int
    backend: str

    def rows(self, total: int) -> tuple[int, int]:
        """This rank's ``[lo, hi)`` of ``total`` rows (a multiple of
        ``size``: pad first)."""
        if total % self.size:
            raise ValueError(f"{total} rows do not split {self.size} ways; "
                             f"pad them to a multiple first")
        per = total // self.size
        return self.rank * per, (self.rank + 1) * per


def group_backend(device: torch.device, world_size: int) -> str:
    """NCCL when each of ``world_size`` ranks can have its own card, gloo
    otherwise (CPU ranks, or several ranks on one card)."""
    if device.type == "cuda" and torch.cuda.device_count() >= world_size:
        return "nccl"
    return "gloo"


def init_process_group(device: str | torch.device | None = None) -> None:
    """Initialize the default process group unless one exists.

    Under ``torchrun`` (``WORLD_SIZE`` above 1 in the environment, with
    ``RANK``, ``MASTER_ADDR`` and ``MASTER_PORT``) the group is made from
    the environment, and an NCCL rank takes the card of its
    ``LOCAL_RANK``.  Otherwise it is a group of one rank, kept in this
    process (an in-memory store, no port).
    """
    if dist.is_initialized():
        return
    dev = resolve_device(device)
    world = int(os.environ.get("WORLD_SIZE", "1"))
    backend = group_backend(dev, world)
    if world > 1:
        if backend == "nccl":
            torch.cuda.set_device(int(os.environ.get(
                "LOCAL_RANK", os.environ.get("RANK", "0"))))
        dist.init_process_group(backend, init_method="env://")
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)


def make_profile_mesh(num_shards: int | None = None, *,
                      device: str | torch.device | None = None
                      ) -> ProfileMesh:
    """The profiling mesh over the default process group (initialized here
    if none exists, see :func:`init_process_group`).

    ``num_shards`` must equal the world size: one shard lives on each
    rank.  ``None`` means the world size.

    Raises:
      ValueError: ``num_shards`` is not the world size.
    """
    init_process_group(device)
    world = dist.get_world_size()
    n = world if num_shards is None else num_shards
    if n != world:
        raise ValueError(
            f"num_shards must equal the world size {world} (one shard a "
            f"rank; start {n} ranks, e.g. torchrun --nproc-per-node {n}), "
            f"got {n}")
    return ProfileMesh(size=world, rank=dist.get_rank(),
                       backend=str(dist.get_backend()))
