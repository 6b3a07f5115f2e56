"""``sharded``: prototype-axis model parallelism for the AM search.

Counterpart of :mod:`repro.pipeline.sharded`, on ``torch.distributed``.
Demeter's query hot path is one ``(B, W) x (S, W)`` agreement against the
HD reference database, capped on one card by that card's memory.  This
backend splits the *prototype* axis over the ranks of a process group
(:mod:`repro_torch.distributed.sharding`, one rank per shard, the torch
form of ``repro``'s 1-D ``('shard',)`` mesh under ``shard_map``): every
rank runs the same session over the same reads, scores them against its
``S_padded / shards`` prototype rows with **any base backend**, takes the
species max of its rows, and the ranks merge the ``(B, num_species)``
int32 partial scores with ``all_reduce(MAX)`` -- exact, so reports are
bit-identical to the unsharded ones at any world size.

Entry points (step 4, and steps 3+4 when the base is fused):

* ``agreement(queries, prototypes)`` -- the Backend-protocol primitive;
  each rank scores its rows and the ``(B, S)`` columns are gathered (an
  ``all_reduce(SUM)`` of zero-filled blocks, which gloo also runs on CUDA
  tensors) with the padding columns sliced off.
* ``species_scores(queries, prototypes, proto_species, num_species)`` --
  agreement and the species max on each rank, then the MAX merge; the
  only traffic is the ``(B, num_species)`` scores.
* ``tokens_agreement`` / ``tokens_species_scores`` -- the same two with
  the base's fused encode->search kernel, present only when the base has
  ``tokens_agreement`` (``cuda_fused``).

``prototypes`` is either a whole prototype set (padded and cut here) or
the rows of a database this backend placed (:meth:`place_refdb`, which
the session runs after every build, load and adopt), used as they are.

Options (``ProfilerConfig.backend_options``):

    base    name of the wrapped backend ("reference" default; any
            registered name except "sharded" itself).
    shards  the number of shards, which must be the world size
            (default 0: the world size).  Prototype counts that do not
            divide it are zero-padded; padding rows carry species id
            ``num_species``, which the species max drops, so they never
            reach a report.
"""

from __future__ import annotations

import dataclasses
import weakref

import torch
import torch.distributed as dist

from repro_torch.core import bitops, classifier
from repro_torch.core.assoc_memory import RefDB
from repro_torch.distributed import sharding
from repro_torch.pipeline.backend import register_backend, resolve_backend
from repro_torch.pipeline.config import ProfilerConfig
from repro_torch.pipeline.options import Option, OptionsSchema


def _non_sharded(v) -> str | None:
    return None if v != "sharded" else "must name a non-sharded backend"


def _non_negative(v) -> str | None:
    return None if v >= 0 else "must be >= 0"


#: ``passthrough=True``: unknown options are forwarded to the wrapped
#: backend, whose own schema validates them -- so a misspelled base
#: option fails with the same error whether it rides directly or through
#: ``sharded``.
SHARDED_OPTIONS = OptionsSchema(backend="sharded", passthrough=True, options=(
    Option("base", "str", default="reference", check=_non_sharded,
           help="wrapped backend name (any registered name but 'sharded')"),
    Option("shards", "int", default=0, check=_non_negative,
           help="number of shards, the world size; 0 = the world size"),
))


def pad_refdb(db: RefDB, multiple: int) -> RefDB:
    """Pad the prototype axis up to a multiple of ``multiple``.

    Padding rows are all-zero vectors tagged with species id
    ``num_species`` -- out of range for the species max, so they are
    dropped there, and sliced off by the ``agreement`` path.  Idempotent
    when S already divides.
    """
    if db.prototypes.shape[0] % multiple == 0:
        return db
    return dataclasses.replace(
        db,
        prototypes=bitops.pad_to_multiple(db.prototypes, 0, multiple),
        proto_species=bitops.pad_to_multiple(db.proto_species, 0, multiple,
                                             fill=db.num_species),
    )


def per_device_bytes(db: RefDB, num_shards: int) -> int:
    """RefDB bytes resident on *each* rank at ``num_shards`` shards.

    The sharded halves (prototypes + species tags) divide by the shard
    count after padding; the genome-length vector is on every rank.  With
    ``num_shards=1`` this equals :meth:`RefDB.memory_bytes`.
    """
    s, w = db.prototypes.shape
    rows = -(-s // num_shards)          # ceil: padded rows per shard
    return rows * w * 4 + rows * 4 + db.genome_lengths.numel() * 4


def place_refdb(db: RefDB, mesh: sharding.ProfileMesh) -> RefDB:
    """Pad S to the shards and keep this rank's rows: prototypes and their
    species tags are split shard-major over the ranks (``S_padded /
    shards`` rows each); genome lengths, names and the species count stay
    whole."""
    db = pad_refdb(db, mesh.size)
    lo, hi = mesh.rows(db.prototypes.shape[0])
    return dataclasses.replace(
        db, prototypes=db.prototypes[lo:hi].contiguous(),
        proto_species=db.proto_species[lo:hi].contiguous())


@register_backend("sharded", schema=SHARDED_OPTIONS)
class ShardedBackend:
    """Prototype-axis sharding over the ranks, around any base backend."""

    name = "sharded"

    def __init__(self, config: ProfilerConfig, *,
                 device: str | torch.device | None = None):
        own, base_options = SHARDED_OPTIONS.split(config.options)
        base_name = own.get("base", "reference")
        shards = own.get("shards", 0)
        base_config = dataclasses.replace(
            config, backend=base_name, backend_options=base_options)
        self.config = config
        self.mesh = sharding.make_profile_mesh(shards or None, device=device)
        self.num_shards = self.mesh.size
        self.base = resolve_backend(base_name, base_config, device=device)
        self.space = base_config.space
        self.device = self.base.device
        # id -> weak reference of the prototype rows place_refdb kept here
        self._placed: dict[int, weakref.ref] = {}
        if self.device.type == "cuda" and self.num_shards > 1:
            self._build_kernels_in_turn()
        # A fused base stays fused under sharding: each rank streams the
        # tokens through the fused kernel against its own rows.  The
        # capabilities are instance attributes, present only when the
        # base has them, so the session's getattr dispatch sees exactly
        # what the base offers.
        if getattr(self.base, "tokens_agreement", None) is not None:
            self.tokens_agreement = self._tokens_agreement
            self.tokens_species_scores = self._tokens_species_scores

    def _build_kernels_in_turn(self) -> None:
        """Rank 0 builds the CUDA kernels while the others wait, so two
        ``nvcc`` runs never write one build directory; the others then
        load what it built."""
        from repro_torch.kernels import _build

        if self.mesh.rank == 0:
            _build.build_all()
        dist.barrier()
        if self.mesh.rank != 0:
            _build.build_all()

    # -- step 3: reads are replicated; encoding is the base's, bit-exact --
    def encode(self, tokens: torch.Tensor, lengths: torch.Tensor
               ) -> torch.Tensor:
        return self.base.encode(tokens, lengths)

    # -- step 4 ------------------------------------------------------------
    def agreement(self, queries: torch.Tensor, prototypes: torch.Tensor
                  ) -> torch.Tensor:
        """Per-prototype agreement, each rank scoring its rows, gathered to
        ``(B, S)`` (``(B, S_padded)`` for a placed shard's rows)."""
        rows, _ = self._rows(prototypes)
        full = self._gather(self.base.agreement(queries, rows))
        return full if rows is prototypes else full[:, :prototypes.shape[0]]

    def species_scores(self, queries: torch.Tensor, prototypes: torch.Tensor,
                       proto_species: torch.Tensor, num_species: int
                       ) -> torch.Tensor:
        """Agreement + species max on each rank, merged with a MAX
        all-reduce of the ``(B, num_species)`` scores.  Bit-identical to
        ``partial_scores(base.agreement(q, p))`` on the whole set."""
        rows, tags = self._rows(prototypes, proto_species, num_species)
        return self._merge(classifier.partial_scores(
            self.base.agreement(queries, rows), tags, num_species))

    # -- steps 3+4 fused on each rank (only when the base is fused) --------
    def _tokens_agreement(self, tokens: torch.Tensor, lengths: torch.Tensor,
                          prototypes: torch.Tensor) -> torch.Tensor:
        rows, _ = self._rows(prototypes)
        full = self._gather(self.base.tokens_agreement(tokens, lengths, rows))
        return full if rows is prototypes else full[:, :prototypes.shape[0]]

    def _tokens_species_scores(self, tokens: torch.Tensor,
                               lengths: torch.Tensor,
                               prototypes: torch.Tensor,
                               proto_species: torch.Tensor,
                               num_species: int) -> torch.Tensor:
        """Encode + search + species max on each rank, then the MAX merge:
        the encoded reads never leave the fused kernel on any rank."""
        rows, tags = self._rows(prototypes, proto_species, num_species)
        return self._merge(classifier.partial_scores(
            self.base.tokens_agreement(tokens, lengths, rows), tags,
            num_species))

    # -- device placement (ProfilingSession hook) -------------------------
    def place_refdb(self, db: RefDB) -> RefDB:
        """Pad a built/loaded RefDB to the shards and keep this rank's
        rows (a database this backend already placed passes through)."""
        if self._is_placed(db.prototypes):
            return db
        placed = place_refdb(db, self.mesh)
        self._placed[id(placed.prototypes)] = weakref.ref(placed.prototypes)
        return placed

    # -- internals ----------------------------------------------------------
    def _is_placed(self, prototypes: torch.Tensor) -> bool:
        ref = self._placed.get(id(prototypes))
        return ref is not None and ref() is prototypes

    def _rows(self, prototypes: torch.Tensor,
              proto_species: torch.Tensor | None = None,
              num_species: int = 0):
        """This rank's prototype rows and species tags: a placed shard as
        it is, a whole set padded to the shards and cut."""
        if self._is_placed(prototypes):
            return prototypes, proto_species
        p = bitops.pad_to_multiple(prototypes, 0, self.num_shards)
        lo, hi = self.mesh.rows(p.shape[0])
        tags = None
        if proto_species is not None:
            tags = bitops.pad_to_multiple(proto_species, 0, self.num_shards,
                                          fill=num_species)[lo:hi]
        return p[lo:hi].contiguous(), tags

    def _gather(self, part: torch.Tensor) -> torch.Tensor:
        """``(B, rows)`` on each rank -> ``(B, rows * shards)``, rank r's
        block at columns ``[r rows, (r + 1) rows)``."""
        b, rows = part.shape
        full = torch.zeros((b, rows * self.num_shards), dtype=torch.int32,
                           device=part.device)
        full[:, self.mesh.rank * rows:(self.mesh.rank + 1) * rows] = part
        dist.all_reduce(full, op=dist.ReduceOp.SUM)
        return full

    @staticmethod
    def _merge(partial: torch.Tensor) -> torch.Tensor:
        """Elementwise max of every rank's partial species scores."""
        partial = partial.contiguous()
        dist.all_reduce(partial, op=dist.ReduceOp.MAX)
        return partial
