"""Versioned, crash-safe on-disk persistence for the HD reference database.

Counterpart of :mod:`repro.pipeline.refdb_store`, with the same file
format, so an entry written by either package loads bit-identically in
the other.  One ``refdb_<key>.npz`` per entry holds the three RefDB
arrays -- ``prototypes`` as ``uint32``, ``proto_species`` and
``genome_lengths`` as ``int32`` -- plus a JSON *manifest* under the
``manifest`` key (``magic``, ``format_version``, ``refdb_fingerprint``,
``genomes_digest``, ``num_species``, ``num_prototypes``, ``dim_words``,
``species_names``, ``genome_lengths``, the content-determining config
fields the session passes (:func:`config_fields`: space, window, stride
and, the port's own, ``threefry_partitionable``) and, on the serving
registry's snapshots, ``version`` / ``parent_version`` / ``delta``).
``repro`` ignores manifest fields it does not know, so the port's
entries load there too.

Writes are atomic (a same-directory temp file published with
``os.replace``).  Loads are tolerant: any undecodable entry -- a legacy
pickle, a truncated archive, another ``format_version``, arrays that
disagree with their manifest -- returns None, which callers treat as a
cache miss and rebuild.
"""

from __future__ import annotations

import dataclasses
import json
import os
import pathlib
import tempfile
from typing import Callable, Iterable

import numpy as np
import torch

from repro_torch.core.assoc_memory import RefDB, RefDBBuilder
from repro_torch.device import resolve_device

#: Bump on any change to the array layout or manifest schema.  Readers
#: accept exactly this version; everything else is a miss.
FORMAT_VERSION = 1

_MAGIC = "demeter-refdb"


def config_fields(config, **extra) -> dict:
    """The content-determining config fields a manifest records: space,
    window, stride and the threefry mode of the item memory."""
    return {"space": dataclasses.asdict(config.space),
            "window": config.window, "stride": config.effective_stride,
            "threefry_partitionable": config.threefry_partitionable,
            **extra}


def mode_matches(m: dict | None, partitionable: bool) -> bool:
    """Whether a manifest's recorded threefry mode is ``partitionable``.

    A manifest without the field was written by ``repro``, whose
    manifests record no mode: it is taken to be in the reader's mode (the
    same limit as ``repro``'s own cache key).  A missing or unreadable
    manifest matches too: :func:`load` decides about it."""
    if m is None or "threefry_partitionable" not in m:
        return True
    return m["threefry_partitionable"] is partitionable


def save(path: str | pathlib.Path, db: RefDB, *,
         refdb_fingerprint: str = "", genomes_digest: str = "",
         config_fields: dict | None = None,
         version: int | None = None, parent_version: int | None = None,
         delta: dict | None = None) -> pathlib.Path:
    """Atomically write ``db`` (npz arrays + embedded JSON manifest).

    ``version`` / ``parent_version`` / ``delta`` are the serving
    registry's live-update provenance (:mod:`repro_torch.serve.registry`);
    they are left out of the manifest when None, as in ``repro``.
    """
    path = pathlib.Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    genome_lengths = db.genome_lengths.cpu().numpy().astype(np.int32)
    provenance = {
        k: v for k, v in (("version", version),
                          ("parent_version", parent_version),
                          ("delta", delta))
        if v is not None
    }
    manifest = {
        **(config_fields or {}),
        **provenance,
        "magic": _MAGIC,
        "format_version": FORMAT_VERSION,
        "refdb_fingerprint": refdb_fingerprint,
        "genomes_digest": genomes_digest,
        "num_species": int(db.num_species),
        "num_prototypes": int(db.prototypes.shape[0]),
        "dim_words": int(db.prototypes.shape[1]),
        "species_names": list(db.species_names),
        "genome_lengths": [int(x) for x in genome_lengths],
    }
    fd, tmp = tempfile.mkstemp(dir=path.parent, prefix=path.name + ".tmp-")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(
                f,
                manifest=np.frombuffer(
                    json.dumps(manifest, sort_keys=True).encode(),
                    dtype=np.uint8),
                prototypes=db.prototypes.cpu().numpy().astype(
                    np.int32, copy=False).view(np.uint32),
                proto_species=db.proto_species.cpu().numpy().astype(np.int32),
                genome_lengths=genome_lengths,
            )
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)           # atomic publish
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    return path


def _manifest_from(z) -> dict | None:
    """Decode + magic-check the manifest member of an open archive."""
    try:
        m = json.loads(bytes(z["manifest"]).decode())
    except Exception:
        return None
    if not isinstance(m, dict) or m.get("magic") != _MAGIC:
        return None
    return m


def manifest(path: str | pathlib.Path) -> dict | None:
    """The entry's JSON manifest, or None if unreadable/not this format."""
    try:
        with np.load(path) as z:
            return _manifest_from(z)
    except Exception:
        return None


def load(path: str | pathlib.Path, *,
         device: str | torch.device | None = None) -> RefDB | None:
    """Load a store entry onto ``device``; None on *any* defect."""
    dev = resolve_device(device)
    path = pathlib.Path(path)
    if not path.exists():
        return None
    try:
        with np.load(path) as z:
            m = _manifest_from(z)
            if m is None or m.get("format_version") != FORMAT_VERSION:
                return None
            protos = z["prototypes"]
            proto_species = z["proto_species"]
            genome_lengths = z["genome_lengths"]
    except Exception:
        return None
    names = tuple(m.get("species_names", ()))
    if (protos.ndim != 2 or protos.dtype.itemsize != 4
            or protos.shape[0] != m.get("num_prototypes")
            or protos.shape[1] != m.get("dim_words")
            or proto_species.shape != (protos.shape[0],)
            or genome_lengths.shape != (len(names),)
            or len(names) != m.get("num_species")):
        return None
    return RefDB(
        prototypes=torch.from_numpy(
            np.ascontiguousarray(protos).view(np.int32)).to(dev),
        proto_species=torch.from_numpy(proto_species.astype(np.int32)).to(dev),
        genome_lengths=torch.from_numpy(genome_lengths.astype(np.int32)).to(dev),
        num_species=len(names),
        species_names=names,
    )


def build_streaming(genomes: dict[str, np.ndarray] |
                    Iterable[tuple[str, np.ndarray]],
                    builder: RefDBBuilder, *,
                    path: str | pathlib.Path | None = None,
                    refdb_fingerprint: str = "", genomes_digest: str = "",
                    config_fields: dict | None = None,
                    on_genome: Callable[[str, int], None] | None = None
                    ) -> RefDB:
    """Build a RefDB genome-by-genome and (optionally) persist it.

    Args:
      on_genome: progress hook ``(name, n_prototypes_so_far)`` per genome.
    """
    items = genomes.items() if isinstance(genomes, dict) else genomes
    total = 0
    for name, toks in items:
        block = builder.add_genome(name, toks)
        total += len(block)
        if on_genome is not None:
            on_genome(name, total)
    db = builder.finish()
    if path is not None:
        save(path, db, refdb_fingerprint=refdb_fingerprint,
             genomes_digest=genomes_digest, config_fields=config_fields)
    return db
