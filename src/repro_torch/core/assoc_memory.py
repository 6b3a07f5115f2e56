"""Associative memory (AM): the HD reference database (HD-RefDB).

Counterpart of :mod:`repro.core.assoc_memory`: one prototype HD vector
per reference-genome window, tagged with its species.  ``RefDB`` holds
torch tensors (prototypes as ``int32`` bit patterns).  The add/remove
species deltas (:func:`apply_delta`) work on the database's own device.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import bitops, encoder, item_memory
from repro_torch.core.hd_space import HDSpace
from repro_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class RefDB:
    """HD reference database (the content of Acc-Demeter's AM unit).

    prototypes: ``(S, W)`` int32 packed prototype HD vectors.
    proto_species: ``(S,)`` int32 species index of each prototype.
    genome_lengths: ``(num_species,)`` int32 reference lengths.
    """
    prototypes: torch.Tensor
    proto_species: torch.Tensor
    genome_lengths: torch.Tensor
    num_species: int
    species_names: tuple[str, ...]

    @property
    def num_prototypes(self) -> int:
        return self.prototypes.shape[0]

    def memory_bytes(self) -> int:
        """Size of the working data structure (paper Fig. 6 comparison)."""
        return (self.prototypes.numel() * 4 + self.proto_species.numel() * 4
                + self.genome_lengths.numel() * 4)

    def to(self, device: str | torch.device) -> "RefDB":
        """The same database with its tensors on ``device``."""
        return dataclasses.replace(
            self, prototypes=self.prototypes.to(device),
            proto_species=self.proto_species.to(device),
            genome_lengths=self.genome_lengths.to(device))


def window_tokens(tokens: np.ndarray, window: int, stride: int
                  ) -> tuple[np.ndarray, np.ndarray]:
    """Slice a genome token array into ``(num_windows, window)`` (padded)."""
    length = len(tokens)
    if length <= window:
        out = np.zeros((1, window), np.int32)
        out[0, :length] = tokens
        return out, np.array([length], np.int32)
    starts = np.arange(0, length - window + 1, stride)
    if starts[-1] + window < length:  # tail window
        starts = np.append(starts, length - window)
    idx = starts[:, None] + np.arange(window)[None, :]
    return tokens[idx].astype(np.int32), np.full(len(starts), window, np.int32)


class RefDBBuilder:
    """Incremental RefDB construction, one reference genome at a time.

    Windows each genome, encodes the windows in batches of ``batch_size``
    on ``device`` (the last batch of a genome is partial) and keeps only
    the finished prototype rows.  ``encode_fn`` is
    ``(tokens, lengths) -> (B, W)`` on ``device`` tensors; it defaults to
    the reference encoder over an item memory drawn in the
    ``partitionable`` threefry mode.
    """

    def __init__(self, space: HDSpace, *, window: int = 8192,
                 stride: int | None = None, batch_size: int = 64,
                 encode_fn=None, device: str | torch.device | None = None,
                 partitionable: bool = True):
        self.space = space
        self.window = window
        self.stride = stride or window
        self.batch_size = batch_size
        self.device = resolve_device(device)
        if encode_fn is None:
            im = item_memory.make_item_memory(space, device=self.device,
                                              partitionable=partitionable)
            tie = item_memory.make_tie_break(space, device=self.device,
                                             partitionable=partitionable)

            def encode_fn(t, l):
                return encoder.encode(t, l, im, tie, space)
        self._encode = encode_fn
        self._protos: list[np.ndarray] = []
        self._species: list[np.ndarray] = []
        self._lengths: list[int] = []
        self._names: list[str] = []

    def add_genome(self, name: str, tokens: np.ndarray) -> np.ndarray:
        """Window + encode one genome; returns its ``(n_windows, W)`` block.

        Atomic on failure: state is committed only after the whole genome
        encoded.
        """
        if name in self._names:
            raise ValueError(f"genome {name!r} already added")
        wins, wlens = window_tokens(np.asarray(tokens), self.window,
                                    self.stride)
        blocks = []
        for i in range(0, len(wins), self.batch_size):
            batch = torch.from_numpy(wins[i:i + self.batch_size]).to(self.device)
            blen = torch.from_numpy(wlens[i:i + self.batch_size]).to(self.device)
            blocks.append(self._encode(batch, blen).cpu().numpy())
        block = np.concatenate(blocks)
        self._species.append(np.full(len(block), len(self._names), np.int32))
        self._names.append(name)
        self._lengths.append(len(tokens))
        self._protos.append(block)
        return block

    def finish(self) -> RefDB:
        """Assemble the immutable RefDB from everything added so far."""
        if not self._names:
            raise ValueError("no genomes added")
        return RefDB(
            prototypes=torch.from_numpy(np.concatenate(self._protos)).to(self.device),
            proto_species=torch.from_numpy(np.concatenate(self._species)).to(self.device),
            genome_lengths=torch.tensor(self._lengths, dtype=torch.int32,
                                        device=self.device),
            num_species=len(self._names),
            species_names=tuple(self._names),
        )


def build_refdb(genomes: dict[str, np.ndarray], space: HDSpace, *,
                window: int = 8192, stride: int | None = None,
                batch_size: int = 64, encode_fn=None,
                device: str | torch.device | None = None,
                partitionable: bool = True) -> RefDB:
    """Demeter step 2: encode every reference genome into the AM."""
    builder = RefDBBuilder(space, window=window, stride=stride,
                           batch_size=batch_size, encode_fn=encode_fn,
                           device=device, partitionable=partitionable)
    for name, toks in genomes.items():
        builder.add_genome(name, toks)
    return builder.finish()


def remove_species(db: RefDB, names) -> RefDB:
    """Drop species (and their prototype rows) from a RefDB.

    The surviving rows are byte-identical to the original build -- removal
    never re-encodes -- and species ids are remapped to stay contiguous.
    Because ``proto_species`` is non-decreasing and the remap is monotone,
    the invariant :func:`species_scores` relies on survives.  Raises on
    unknown names and on removing every species (an AM must stay
    non-empty; delete the database instead).  The result lives on
    ``db``'s device.
    """
    drop = set(names)
    unknown = drop - set(db.species_names)
    if unknown:
        raise KeyError(f"cannot remove unknown species {sorted(unknown)}; "
                       f"database has {list(db.species_names)}")
    if len(drop) == db.num_species:
        raise ValueError("refusing to remove every species (an associative "
                         "memory cannot be empty); delete the database")
    if not drop:
        return db
    dev = db.prototypes.device
    keep = [i for i, n in enumerate(db.species_names) if n not in drop]
    keep_t = torch.tensor(keep, dtype=torch.int64, device=dev)
    remap = torch.full((db.num_species,), -1, dtype=torch.int32, device=dev)
    remap[keep_t] = torch.arange(len(keep), dtype=torch.int32, device=dev)
    ps = db.proto_species.long()
    rows = remap[ps] >= 0
    return RefDB(
        prototypes=db.prototypes[rows].contiguous(),
        proto_species=remap[ps[rows]],
        genome_lengths=db.genome_lengths[keep_t].contiguous(),
        num_species=len(keep),
        species_names=tuple(db.species_names[i] for i in keep),
    )


def add_species(db: RefDB, addition: RefDB) -> RefDB:
    """Append another RefDB's species to ``db`` (incremental add delta).

    ``addition`` is a streaming build of only the *new* genomes (same
    space/window/stride -- the caller guarantees build-config parity; the
    packed widths are checked here).  Appending keeps ``proto_species``
    non-decreasing: new species take ids ``db.num_species ..``.  The
    existing rows are untouched, so queries against surviving species are
    bit-identical before and after the delta.  The result lives on
    ``db``'s device.
    """
    if db.prototypes.shape[1] != addition.prototypes.shape[1]:
        raise ValueError(
            f"packed width mismatch: database W={db.prototypes.shape[1]}, "
            f"addition W={addition.prototypes.shape[1]} (different HD "
            f"space/dim -- deltas must be built with the database's config)")
    clash = set(db.species_names) & set(addition.species_names)
    if clash:
        raise ValueError(
            f"species already present: {sorted(clash)} (remove them first "
            f"to replace, or rename the additions)")
    add = addition.to(db.prototypes.device)
    return RefDB(
        prototypes=torch.cat([db.prototypes, add.prototypes]),
        proto_species=torch.cat(
            [db.proto_species, add.proto_species + db.num_species]),
        genome_lengths=torch.cat([db.genome_lengths, add.genome_lengths]),
        num_species=db.num_species + addition.num_species,
        species_names=db.species_names + addition.species_names,
    )


def apply_delta(db: RefDB, *, add: RefDB | None = None,
                remove=()) -> RefDB:
    """One incremental update: remove species, then append new ones.

    Remove-before-add makes an in-place genome refresh a single delta
    (``remove=["x"], add=<rebuilt x>``).
    """
    out = remove_species(db, remove) if remove else db
    if add is not None:
        out = add_species(out, add)
    return out


def agreement_matmul(queries: torch.Tensor, prototypes: torch.Tensor,
                     dim: int) -> torch.Tensor:
    """Agreement scores via the +-1 matmul identity, in full float32.

    ``agreement = (D + Q_hat @ P_hat.T) / 2`` with ``Q_hat = 2Q - 1``; the
    sums are integers below 2**24, so float32 is exact -- provided the
    product really runs in float32.  The reference backend turns TF32 off
    on CUDA for that reason.
    """
    q = 2.0 * bitops.unpack_bits(queries).to(torch.float32) - 1.0
    p = 2.0 * bitops.unpack_bits(prototypes).to(torch.float32) - 1.0
    s = q @ p.T
    return ((dim + s) / 2.0).to(torch.int32)


def agreement_packed_chunked(queries: torch.Tensor, prototypes: torch.Tensor,
                             dim: int, chunk: int = 128) -> torch.Tensor:
    """Agreement via packed XOR + popcount, chunked over prototypes."""
    out = [dim - bitops.popcount_words(
        torch.bitwise_xor(queries[:, None, :], prototypes[None, c:c + chunk, :]))
        for c in range(0, prototypes.shape[0], chunk)]
    if not out:
        return torch.zeros((queries.shape[0], 0), dtype=torch.int32,
                           device=queries.device)
    return torch.cat(out, dim=1)


def species_scores(agreement: torch.Tensor, proto_species: torch.Tensor,
                   num_species: int) -> torch.Tensor:
    """Max agreement per species over its window prototypes -> ``(B, S)``.

    ``repro`` uses ``segment_max``: a species with no prototype comes back
    as the int32 minimum, and ids outside ``[0, num_species)`` (padding
    rows) are dropped.  Here the dropped ids land in one spare column
    that is cut off.
    """
    b = agreement.shape[0]
    ids = proto_species.long()
    ids = torch.where((ids < 0) | (ids >= num_species), num_species, ids)
    out = torch.full((b, num_species + 1), torch.iinfo(torch.int32).min,
                     dtype=torch.int32, device=agreement.device)
    out.scatter_reduce_(1, ids[None, :].expand(b, -1),
                        agreement.to(torch.int32), reduce="amax",
                        include_self=True)
    return out[:, :num_species]
