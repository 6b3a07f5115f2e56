"""Sharding rules for the LM stack and the profiling mesh.

Counterpart of :mod:`repro.distributed.sharding`, in two halves.

**The LM half.**  Models name each tensor dimension by a *logical* axis
(``batch``, ``heads``, ``ff``, ...); a rules table (``TRAIN_RULES``,
``PREFILL_RULES``, ``DECODE_RULES``, copies of ``repro``'s) maps the
logical names to mesh axes, and :func:`use_rules` installs a (mesh,
rules) pair for the process.  The spec layer (:func:`spec_for`,
:func:`safe_spec`) gives ``repro``'s ``PartitionSpec`` as a tuple with
one entry a tensor dimension: ``None``, a mesh axis name, or a tuple of
names (major to minor).  It needs no process group: the mesh may be a
:class:`MeshShape` (names and sizes) as well as a
:class:`~torch.distributed.device_mesh.DeviceMesh`.  The placement layer
(:func:`placements`) turns a spec into DTensor ``Shard`` / ``Replicate``
placements on a ``DeviceMesh``: a dimension split over ``("pod",
"data")`` gets ``Shard(d)`` on both mesh dimensions, which DTensor splits
in mesh order, pod major, as GSPMD does.  :func:`constrain_safe` is
``with_sharding_constraint``: it redistributes a DTensor to the resolved
placements, and is a no-op on a plain tensor or with no mesh active, so
the models run unchanged on one device.  Under a ``DeviceMesh``,
:func:`use_rules` also turns on DTensor's implicit replication, so
tensors made inside the forward (RoPE tables, masks, positions) join the
mesh as replicated DTensors.

**The profiling half.**  ``repro`` splits the
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

import contextlib
import dataclasses
import os
from typing import Sequence

import torch
import torch.distributed as dist

from repro_torch.device import resolve_device

# -- the LM half ----------------------------------------------------------------

class _Active:
    """The (mesh, rules) pair :func:`use_rules` installed.  Process-wide,
    not per thread: the autograd engine runs a CUDA backward (and the
    recomputed forward of a checkpointed layer) on threads of its own,
    which must see the rules of the step that recorded it."""
    ctx = None


_state = _Active()

Rules = dict[str, tuple[str, ...] | str | None]


class Spec(tuple):
    """``repro``'s ``PartitionSpec``: one entry a tensor dimension, None,
    a mesh axis, or a tuple of axes major to minor.  A leaf of
    :mod:`repro_torch.tree`'s trees (a tuple of its own type)."""

    def __new__(cls, entries=()):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"Spec{tuple(self)!r}"

# Logical axis vocabulary used by the models:
#   batch, seq, embed, heads, kv_heads, qk_dim, v_dim, ff, experts,
#   expert_group, capacity, vocab, kv_seq, state, conv, fsdp(=param ff dim)

TRAIN_RULES: Rules = {
    "batch": ("pod", "data"),
    "seq": None,
    "embed": None,
    "heads": "model",
    "kv_heads": None,        # kv heads often < model axis; keep replicated
    "ff": "model",
    "experts": "model",
    "expert_group": ("pod", "data"),
    "vocab": "model",
    "kv_seq": None,
    "fsdp": "data",          # FSDP: shard the non-TP param dim over data
    "state": None,
    "ssm_heads": "model",
    # Megatron-style sequence parallelism: the residual stream between
    # blocks lives sequence-sharded over 'model'.
    "residual_seq": "model",
}

PREFILL_RULES: Rules = dict(TRAIN_RULES, fsdp="data")

# Decode: params replicated over 'data' (fsdp=None); the KV cache is
# sequence-sharded over 'model'.
DECODE_RULES: Rules = dict(TRAIN_RULES, kv_seq="model", fsdp=None,
                           residual_seq=None)


@dataclasses.dataclass(frozen=True)
class MeshShape:
    """A mesh's axis names and sizes, without devices or ranks
    (``repro``'s ``AbstractMesh``): enough for the spec layer."""
    axis_sizes: tuple[int, ...]
    axis_names: tuple[str, ...]

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))


def mesh_shape(mesh) -> MeshShape:
    """The names and sizes of a :class:`MeshShape` or a ``DeviceMesh``."""
    if isinstance(mesh, MeshShape):
        return mesh
    return MeshShape(tuple(mesh.shape), tuple(mesh.mesh_dim_names))


@contextlib.contextmanager
def use_rules(mesh, rules: Rules | None):
    """Activate (mesh, rules) for :func:`constrain_safe` and the spec
    functions (for the process: see :class:`_Active`).  With a
    ``DeviceMesh``, plain tensors that meet DTensors are taken as
    replicated meanwhile."""
    prev = _state.ctx
    _state.ctx = (mesh, rules) if mesh is not None else None
    try:
        if mesh is not None and not isinstance(mesh, MeshShape):
            from torch.distributed.tensor.experimental import \
                implicit_replication
            with implicit_replication():
                yield
        else:
            yield
    finally:
        _state.ctx = prev


def active_mesh():
    ctx = _state.ctx
    return ctx[0] if ctx else None


def _target(mesh: MeshShape, rules: Rules, ax):
    """The mesh axes behind logical axis ``ax`` that the mesh has."""
    target = rules.get(ax) if ax else None
    if isinstance(target, tuple):
        return tuple(t for t in target if t in mesh.axis_names) or None
    if target is not None and target not in mesh.axis_names:
        return None
    return target


def target_size(mesh: MeshShape, target) -> int:
    """The number of shards a spec entry makes (1 for None)."""
    if target is None:
        return 1
    names = target if isinstance(target, tuple) else (target,)
    size = 1
    for n in names:
        size *= mesh.shape.get(n, 1)
    return size


def spec_for(axes: Sequence[str | None]) -> Spec:
    """The spec for a tuple of logical axis names under the active rules
    (``()`` with none active)."""
    ctx = _state.ctx
    if ctx is None:
        return Spec()
    mesh, rules = mesh_shape(ctx[0]), ctx[1]
    out = []
    for ax in axes:
        target = rules.get(ax) if ax else None
        if isinstance(target, tuple):
            out.append(tuple(t for t in target if t in mesh.axis_names))
        else:
            out.append(target if target in mesh.axis_names else None)
    return Spec(out)


def axis_size(logical: str) -> int:
    """Mesh size behind a logical axis in the active rules (1 if none)."""
    ctx = _state.ctx
    if ctx is None:
        return 1
    mesh, rules = mesh_shape(ctx[0]), ctx[1]
    return target_size(mesh, rules.get(logical))


def safe_spec(shape: Sequence[int], axes: Sequence[str | None]) -> Spec:
    """Like :func:`spec_for`, but drops axes whose mesh size doesn't
    divide the dim (kv_heads = 4 meeting model = 16)."""
    ctx = _state.ctx
    if ctx is None:
        return Spec()
    mesh, rules = mesh_shape(ctx[0]), ctx[1]
    out = []
    for dim, ax in zip(shape, axes):
        target = _target(mesh, rules, ax)
        size = target_size(mesh, target)
        out.append(target if target and size > 0 and dim % size == 0
                   else None)
    return Spec(out)


def shard_shape(shape: Sequence[int], spec: Spec, mesh) -> tuple:
    """One device's block of a tensor of ``shape`` laid out by ``spec``
    (``NamedSharding.shard_shape``; the spec's splits divide evenly)."""
    mesh = mesh_shape(mesh)
    out = list(shape)
    for d, entry in enumerate(spec):
        n = target_size(mesh, entry)
        if out[d] % n:
            raise ValueError(f"dim {d} of {tuple(shape)} does not split "
                             f"{n} ways")
        out[d] //= n
    return tuple(out)


def placements(spec: Spec, mesh) -> list:
    """DTensor placements on ``mesh`` for ``spec``: ``Shard(d)`` on each
    mesh dimension that splits tensor dimension ``d``, ``Replicate()`` on
    the rest.  Axes of one entry must come in mesh order (major first),
    which is the order DTensor splits in.  A mesh dimension of size 1
    splits nothing and stays ``Replicate()`` (DTensor refuses to merge
    an axis sharded there away, where GSPMD sees no split at all)."""
    from torch.distributed.tensor import Replicate, Shard
    shape = mesh_shape(mesh)
    names = shape.axis_names
    out: list = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        axes = () if entry is None else (
            entry if isinstance(entry, tuple) else (entry,))
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {entry!r} is not in the mesh's "
                             f"axis order {names}")
        for i in idx:
            if shape.axis_sizes[i] > 1:
                out[i] = Shard(d)
    return out


def constrain(x: torch.Tensor, axes: Sequence[str | None]) -> torch.Tensor:
    """``with_sharding_constraint`` by logical axes: a DTensor is
    redistributed to ``spec_for(axes)``; a no-op without a mesh or on a
    plain tensor."""
    return _redistribute(x, spec_for(axes))


def constrain_safe(x: torch.Tensor, axes: Sequence[str | None]
                   ) -> torch.Tensor:
    """:func:`constrain` with :func:`safe_spec`'s divisibility drop."""
    return _redistribute(x, safe_spec(tuple(x.shape), axes))


def split_ready(x: torch.Tensor, dim: int, lead: int) -> torch.Tensor:
    """``x`` ready for its dimension ``dim`` to be split into ``(lead,
    rest)``: a DTensor whose shards of ``dim`` do not fall on whole rows
    of ``lead`` (4 heads on 4 ranks into 2 kv heads x 2) has that
    dimension gathered first, as GSPMD reshards there; DTensor has no
    rule for an uneven split."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    if not isinstance(x, DTensor):
        return x
    mesh = x.device_mesh
    ways = 1
    for i, pl in enumerate(x.placements):
        if isinstance(pl, Shard) and pl.dim % x.ndim == dim % x.ndim:
            ways *= mesh.size(i)
    if lead % ways == 0:
        return x
    return x.redistribute(mesh, [
        Replicate() if isinstance(pl, Shard) and pl.dim % x.ndim
        == dim % x.ndim else pl for pl in x.placements])


class _PinGrad(torch.autograd.Function):
    """Identity whose gradient is laid out as its input was."""

    @staticmethod
    def forward(ctx, x):
        ctx.mesh, ctx.place = x.device_mesh, x.placements
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return grad.redistribute(ctx.mesh, ctx.place)


def pin_grad(x: torch.Tensor) -> torch.Tensor:
    """``x``, whose gradient is brought back to ``x``'s placements before
    it flows on: a product's gradient may come split along a merged axis
    that the reshape before it cannot split again (an uneven head
    split).  A no-op on a plain tensor."""
    from torch.distributed.tensor import DTensor
    return _PinGrad.apply(x) if isinstance(x, DTensor) else x


def as_dtensor(x: torch.Tensor, mesh, place: list) -> torch.Tensor:
    """``x`` laid out as ``place`` on ``mesh``: a DTensor redistributed,
    a plain tensor (the same on every rank) split where ``place``
    shards it."""
    from torch.distributed.tensor import DTensor, distribute_tensor
    if isinstance(x, DTensor):
        return x.redistribute(mesh, place)
    return distribute_tensor(x, mesh, place, src_data_rank=None)


@torch.no_grad()
def write_slot(dst: torch.Tensor, dim: int, index: int,
               value: torch.Tensor | float) -> None:
    """``dst.index_copy_(dim, [index], value)`` (``index_fill_`` for a
    number), in place, on a plain tensor or a DTensor: a DTensor cache
    sharded along ``dim`` (``kv_seq`` under ``DECODE_RULES``) is written
    on the rank whose shard holds the slot, from ``value`` made whole
    along ``dim`` and laid out as ``dst`` elsewhere (DTensor has no
    in-place rule for a write across a sharded axis;
    ``repro``'s ``dynamic_update_slice``)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    if not isinstance(dst, DTensor):
        idx = torch.tensor([index], device=dst.device)
        if isinstance(value, torch.Tensor):
            dst.index_copy_(dim, idx, value.to(dst.dtype))
        else:
            dst.index_fill_(dim, idx, value)
        return
    mesh = dst.device_mesh
    local = dst.to_local()
    shape, offset = compute_local_shape_and_global_offset(
        dst.shape, mesh, dst.placements)
    lo = offset[dim]
    if isinstance(value, torch.Tensor):
        place = [Replicate() if isinstance(pl, Shard) and pl.dim == dim
                 else pl for pl in dst.placements]
        if isinstance(value, DTensor):
            value = value.redistribute(mesh, place).to_local()
        else:
            from torch.distributed.tensor import distribute_tensor
            value = distribute_tensor(value, mesh, place,
                                      src_data_rank=None).to_local()
    if not lo <= index < lo + shape[dim]:
        return
    idx = torch.tensor([index - lo], device=local.device)
    if isinstance(value, torch.Tensor):
        local.index_copy_(dim, idx, value.to(local.dtype))
    else:
        local.index_fill_(dim, idx, value)


def _redistribute(x: torch.Tensor, spec: Spec) -> torch.Tensor:
    from torch.distributed.tensor import DTensor
    mesh = active_mesh()
    if mesh is None or isinstance(mesh, MeshShape) \
            or not isinstance(x, DTensor):
        return x
    return x.redistribute(x.device_mesh, placements(spec, x.device_mesh))


# -- the profiling half ---------------------------------------------------------

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
