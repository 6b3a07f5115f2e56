"""`RefDBRegistry`: named reference databases with versioned live updates.

Counterpart of :mod:`repro.serve.registry`.  The registry owns a set of
**named databases**, each a chain of **versioned immutable snapshots**,
and publishes updates atomically so the serving layer
(:class:`repro_torch.serve.router.TenantRouter`) can hot-swap without
downtime::

    registry = RefDBRegistry(root="dbs/")            # root=None: in-memory
    registry.create("food", genomes, config)         # -> version 1
    snap = registry.apply_delta("food", add={"listeria": toks})   # -> v2
    registry.apply_delta("food", remove=["species_00"])           # -> v3
    registry.current("food").db                      # newest RefDB

The registry keeps its databases on one device (``device=None`` means
``cuda``, raising without a GPU unless ``device="cpu"``).  Builds and
deltas encode through the database's own backend: the encoder of
``resolve_backend(config.backend, config, device=...)``, so a
``cuda_fused`` / ``cuda_packed`` / ``cuda_matmul`` database is encoded
by the encoder kernel on the card (``repro``'s registry defaults to its
reference encoder, which is bit-exact with every backend; the port's
plain encoder would be the slow path on a card).

Deltas are **incremental**: an add encodes only the new genomes (one
streaming :class:`~repro_torch.core.assoc_memory.RefDBBuilder` pass,
same space/window/stride as the original build, so the new prototype
rows are bit-identical to what a from-scratch build would produce) and a
remove drops rows without re-encoding, via
:func:`repro_torch.core.assoc_memory.apply_delta`.  Every snapshot
records its ``version``, ``parent_version`` and the delta that produced
it in the :mod:`repro_torch.pipeline.refdb_store` manifest.

On disk the layout is ``repro``'s: each snapshot is its own
``<root>/<name>/v<N>.npz`` store entry (atomic temp + ``os.replace``)
and ``CURRENT.json`` flips to it with another ``os.replace``, so a
registry root either package wrote opens in the other.  In memory the
current-version pointer swaps under the registry lock, then subscribers
(the router's auto-swap hook) are notified outside it.
"""

from __future__ import annotations

import dataclasses
import json
import os
import pathlib
import re
import tempfile
import threading
import time
from typing import Callable, Sequence

import numpy as np

import torch

from repro_torch import obs
from repro_torch.core import assoc_memory
from repro_torch.core.assoc_memory import RefDB, RefDBBuilder
from repro_torch.device import resolve_device
from repro_torch.pipeline import refdb_store
from repro_torch.pipeline.backend import resolve_backend
from repro_torch.pipeline.config import ProfilerConfig
from repro_torch.pipeline.session import _genomes_digest

_NAME_RE = re.compile(r"^[A-Za-z0-9][A-Za-z0-9._-]*$")

#: CURRENT.json pointer schema version.
_POINTER_VERSION = 1


@dataclasses.dataclass(frozen=True)
class RefDBSnapshot:
    """One immutable published version of a named database."""

    database: str
    version: int                        # 1-based, monotone per database
    db: RefDB                           # on the registry's device
    parent_version: int | None = None   # None for the initial full build
    delta: dict | None = None           # {"added": [...], "removed": [...]}
    path: pathlib.Path | None = None    # on-disk entry (None in-memory)
    created_at: float = 0.0             # epoch seconds of the publish

    @property
    def species(self) -> tuple[str, ...]:
        return self.db.species_names


@dataclasses.dataclass(frozen=True)
class GCResult:
    """What one :meth:`RefDBRegistry.gc` sweep retired (or would retire).

    With ``dry_run=True`` the sweep is a pure report: ``collected`` are
    the victims an identical real sweep would take right now and
    ``reclaimed_bytes`` what their on-disk files measure — nothing was
    deleted.
    """

    collected: tuple[tuple[str, int], ...]   # (database, version) pairs
    reclaimed_bytes: int                     # on-disk bytes unlinked
    dry_run: bool = False


class _Entry:
    """Registry-internal mutable state of one named database."""

    def __init__(self, name: str, config: ProfilerConfig, encode_fn=None):
        self.name = name
        self.config = config
        self.encode_fn = encode_fn
        self.snapshots: dict[int, RefDBSnapshot] = {}
        self.current_version = 0
        # version -> live-service refcount (routers pin versions they
        # serve; gc never collects a pinned version).
        self.pins: dict[int, int] = {}
        # Serializes builds/deltas per database so version numbers are a
        # gapless chain even under concurrent writers; the registry-wide
        # lock is only held for pointer reads/swaps.
        self.mutate = threading.Lock()


class RefDBRegistry:
    """Named, versioned RefDBs with atomic publish and live deltas."""

    def __init__(self, root: str | pathlib.Path | None = None, *,
                 device: str | torch.device | None = None,
                 metrics: obs.MetricsRegistry | None = None):
        """Args:
          root: snapshot directory (one subdirectory per database).  None
            keeps everything in memory -- versioning, deltas, and hot-swap
            all work; nothing survives the process.
          device: where the databases live and are encoded; ``None``
            means ``cuda``.
          metrics: explicit metrics registry (default: the process
            global, a no-op unless ``obs.enable_metrics()`` ran).
        """
        self.root = pathlib.Path(root) if root is not None else None
        self.device = resolve_device(device)
        self._lock = threading.RLock()
        self._entries: dict[str, _Entry] = {}
        self._subscribers: list[Callable[[RefDBSnapshot], None]] = []
        self._obs = obs.resolve_metrics(metrics)
        self._m_publishes = self._obs.counter(
            "refdb_publishes_total",
            "Snapshot versions published, by database.")
        self._m_installs = self._obs.counter(
            "refdb_installs_total",
            "Snapshot versions installed from another registry "
            "(replication), by database.")
        self._m_build_time = self._obs.histogram(
            "refdb_build_seconds",
            "Wall time of a full build or delta, publish included.",
            unit="s")
        self._m_live_version = self._obs.gauge(
            "refdb_current_version",
            "Newest published version number, by database.")
        self._m_gc_versions = self._obs.counter(
            "refdb_gc_versions_total",
            "Snapshot versions retired by the garbage collector.")
        self._m_gc_bytes = self._obs.counter(
            "refdb_gc_reclaimed_bytes_total",
            "On-disk snapshot bytes reclaimed by the garbage collector.")

    # -- creation -----------------------------------------------------------
    def create(self, name: str, genomes: dict[str, np.ndarray],
               config: ProfilerConfig, *, encode_fn=None,
               on_genome: Callable[[str, int], None] | None = None
               ) -> RefDBSnapshot:
        """Build and publish version 1 of a new named database.

        The build streams genome-by-genome through
        :class:`RefDBBuilder`; ``config`` pins the content-determining
        fields (space/window/stride) every later delta must match.

        Args:
          encode_fn: optional encoder override (kept for this database's
            future deltas too).  The default is the encoder of
            ``config.backend`` on the registry's device (the encoder
            kernel for the CUDA backends); every backend's encoder is
            bit-exact with every other's.
          on_genome: streaming-build progress hook ``(name, total_rows)``.
        """
        if not _NAME_RE.match(name):
            raise ValueError(
                f"invalid database name {name!r} (need alphanumeric plus "
                f"'._-', not starting with a separator)")
        with self._lock:
            if name in self._entries:
                raise ValueError(f"database {name!r} already exists "
                                 f"(apply_delta to update it)")
            entry = _Entry(name, config, encode_fn)
            self._entries[name] = entry
        try:
            with entry.mutate:
                t0 = time.perf_counter()
                builder = self._builder(entry)
                db = refdb_store.build_streaming(genomes, builder,
                                                 on_genome=on_genome)
                snap = self._publish(
                    entry, db, parent=None, delta=None,
                    genomes_digest=_genomes_digest(genomes))
                if self._obs.enabled:
                    self._m_build_time.observe(time.perf_counter() - t0,
                                               database=name, kind="create")
        except BaseException:
            with self._lock:
                self._entries.pop(name, None)   # failed create leaves no stub
            raise
        self._notify(snap)
        return snap

    # -- live updates -------------------------------------------------------
    def apply_delta(self, name: str, *,
                    add: dict[str, np.ndarray] | None = None,
                    remove: Sequence[str] = ()) -> RefDBSnapshot:
        """Publish version N+1 = current version with species added/removed.

        Incremental: only ``add``'s genomes are encoded (streamed through
        a fresh builder under the database's pinned config), ``remove``
        drops prototype rows without touching the rest.  Removal applies
        first, so replacing a genome is one delta (``remove=[x],
        add={x: new_tokens}``).  The new snapshot is written and the
        current pointer flipped atomically; subscribers are notified
        after the in-memory swap.
        """
        if not add and not remove:
            raise ValueError("empty delta: pass add= genomes and/or "
                             "remove= species names")
        entry = self._entry(name)
        with entry.mutate:
            t0 = time.perf_counter()
            base = self.current(name)
            addition = None
            if add:
                builder = self._builder(entry)
                for gname, toks in add.items():
                    builder.add_genome(gname, toks)
                addition = builder.finish()
            db = assoc_memory.apply_delta(base.db, add=addition,
                                          remove=tuple(remove))
            delta = {"added": sorted(add) if add else [],
                     "removed": sorted(remove)}
            snap = self._publish(entry, db, parent=base.version, delta=delta)
            if self._obs.enabled:
                self._m_build_time.observe(time.perf_counter() - t0,
                                           database=name, kind="delta")
        self._notify(snap)
        return snap

    # -- replication --------------------------------------------------------
    def install(self, name: str, snapshot: RefDBSnapshot, *,
                config: ProfilerConfig) -> RefDBSnapshot:
        """Install an already-built snapshot from another registry.

        The replication seam: a fleet host's mirror registry pulls
        published versions from the source-of-truth registry without
        re-encoding anything -- the immutable ``RefDB`` object is shared
        (moved to this registry's device when it lives elsewhere).
        Installs keep the *source's* version number (so fleet-wide
        version talk is unambiguous) and tolerate gaps: a host that was
        down across publishes installs whatever the source currently
        retains and the chain simply skips the versions it missed.
        Idempotent per version; never moves the current pointer
        backwards; in-memory only (``path=None`` — durability lives at
        the source).  ``config`` must agree with the entry's pinned
        content fields (same ``refdb_fingerprint``), or the mirror would
        serve prototypes that mean something else than their name says.
        """
        if not _NAME_RE.match(name):
            raise ValueError(f"invalid database name {name!r}")
        with self._lock:
            entry = self._entries.get(name)
            if entry is None:
                entry = _Entry(name, config)
                self._entries[name] = entry
        if entry.config.refdb_fingerprint() != config.refdb_fingerprint():
            raise ValueError(
                f"database {name!r}: install config disagrees with the "
                f"pinned content fields (fingerprint mismatch)")
        with entry.mutate:
            with self._lock:
                existing = entry.snapshots.get(snapshot.version)
                if existing is not None:
                    return existing
                local = RefDBSnapshot(
                    database=name, version=snapshot.version,
                    db=snapshot.db.to(self.device),
                    parent_version=snapshot.parent_version,
                    delta=snapshot.delta, path=None,
                    created_at=time.time())
                entry.snapshots[local.version] = local
                if local.version > entry.current_version:
                    entry.current_version = local.version
        if self._obs.enabled:
            self._m_installs.inc(1, database=name)
            self._m_live_version.set(entry.current_version, database=name)
        return local

    # -- reads --------------------------------------------------------------
    def databases(self) -> tuple[str, ...]:
        with self._lock:
            return tuple(sorted(self._entries))

    def config(self, name: str) -> ProfilerConfig:
        """The build config pinned at ``create`` (content fields bind all
        later deltas; execution fields are just its defaults — the router
        overrides backend/batch per serving deployment)."""
        return self._entry(name).config

    def current(self, name: str) -> RefDBSnapshot:
        """The newest published snapshot of ``name``."""
        entry = self._entry(name)
        with self._lock:
            if entry.current_version == 0:
                raise KeyError(f"database {name!r} has no published version")
            return entry.snapshots[entry.current_version]

    def snapshot(self, name: str, version: int) -> RefDBSnapshot:
        """A specific retained version (every publish is retained)."""
        entry = self._entry(name)
        with self._lock:
            try:
                return entry.snapshots[version]
            except KeyError:
                raise KeyError(
                    f"database {name!r} has no version {version} "
                    f"(have {sorted(entry.snapshots)})") from None

    def versions(self, name: str) -> tuple[int, ...]:
        entry = self._entry(name)
        with self._lock:
            return tuple(sorted(entry.snapshots))

    # -- liveness pins + garbage collection ---------------------------------
    def pin(self, name: str, version: int) -> None:
        """Refcount ``version`` as held by a live service.

        The router pins every version it serves (current and draining);
        :meth:`gc` refuses to collect a pinned version no matter how old
        or deep in the chain it is.
        """
        entry = self._entry(name)
        with self._lock:
            if version not in entry.snapshots:
                raise KeyError(f"database {name!r} has no version "
                               f"{version} to pin")
            entry.pins[version] = entry.pins.get(version, 0) + 1

    def release(self, name: str, version: int) -> None:
        """Drop one pin of ``version`` (idempotent past zero)."""
        entry = self._entry(name)
        with self._lock:
            n = entry.pins.get(version, 0) - 1
            if n > 0:
                entry.pins[version] = n
            else:
                entry.pins.pop(version, None)

    def pins(self, name: str) -> dict[int, int]:
        """Live pin counts by version (a copy, for inspection/tests)."""
        entry = self._entry(name)
        with self._lock:
            return dict(entry.pins)

    def gc(self, name: str | None = None, *, keep_last: int = 2,
           max_age_s: float | None = None, dry_run: bool = False
           ) -> "GCResult":
        """Retire old snapshot versions no live service references.

        A version is collected only when it is **all** of: not the
        current version, not pinned by any service, not among the
        ``keep_last`` newest retained versions, and — when ``max_age_s``
        is given — older than that.  Collection drops the in-memory
        snapshot and unlinks its on-disk ``v*.npz`` file (on-disk-only
        versions from before :meth:`open` are swept by the same rules,
        aged by file mtime).

        Args:
          name: one database, or None for every database.
          keep_last: hard floor of newest versions always retained.
          max_age_s: additionally require a collected version to be at
            least this old (seconds since publish).
          dry_run: report the victims and reclaimable bytes an identical
            real sweep would take, deleting nothing — the safe preview
            operators (and the fleet retire phase) run first.

        Returns:
          :class:`GCResult` with the collected ``(database, version)``
          pairs and total bytes reclaimed on disk.
        """
        if keep_last < 1:
            raise ValueError("keep_last must be >= 1 (the current "
                             "version is always retained)")
        names = [name] if name is not None else list(self.databases())
        collected: list[tuple[str, int]] = []
        reclaimed = 0
        now = time.time()
        for dbname in names:
            entry = self._entry(dbname)
            with entry.mutate:      # serialize against concurrent publish
                got, nbytes = self._gc_one(entry, keep_last, max_age_s, now,
                                           dry_run)
            collected.extend((dbname, v) for v in got)
            reclaimed += nbytes
        if self._obs.enabled and collected and not dry_run:
            self._m_gc_versions.inc(len(collected))
            self._m_gc_bytes.inc(reclaimed)
        return GCResult(collected=tuple(collected),
                        reclaimed_bytes=reclaimed, dry_run=dry_run)

    def _gc_one(self, entry: _Entry, keep_last: int,
                max_age_s: float | None, now: float, dry_run: bool
                ) -> tuple[list[int], int]:
        """Collect one database's eligible versions; runs under
        ``entry.mutate``."""
        disk: dict[int, pathlib.Path] = {}
        if self.root is not None:
            for p in (self.root / entry.name).glob("v*.npz"):
                try:
                    disk[int(p.stem[1:])] = p
                except ValueError:
                    continue
        with self._lock:
            known = sorted(set(entry.snapshots) | set(disk))
            keep = set(known[-keep_last:])
            keep.add(entry.current_version)
            keep.update(v for v, n in entry.pins.items() if n > 0)
            victims = []
            for v in known:
                if v in keep:
                    continue
                if max_age_s is not None:
                    snap = entry.snapshots.get(v)
                    born = snap.created_at if snap is not None \
                        else disk[v].stat().st_mtime
                    if now - born < max_age_s:
                        continue
                victims.append(v)
            if not dry_run:
                for v in victims:
                    entry.snapshots.pop(v, None)
        nbytes = 0
        for v in victims:
            p = disk.get(v)
            if p is None:
                continue
            try:
                nbytes += p.stat().st_size
                if not dry_run:
                    p.unlink()
            except OSError:
                pass                # already gone: nothing reclaimed
        return victims, nbytes

    # -- change notification (the router's auto-swap hook) ------------------
    def subscribe(self, fn: Callable[[RefDBSnapshot], None]
                  ) -> Callable[[RefDBSnapshot], None]:
        """Call ``fn(snapshot)`` after every publish; returns ``fn``.

        Called outside registry locks, after the new version is already
        current — a subscriber that re-reads ``current`` sees it.
        """
        with self._lock:
            self._subscribers.append(fn)
        return fn

    def unsubscribe(self, fn: Callable[[RefDBSnapshot], None]) -> None:
        with self._lock:
            if fn in self._subscribers:
                self._subscribers.remove(fn)

    # -- persistence --------------------------------------------------------
    @classmethod
    def open(cls, root: str | pathlib.Path, *,
             device: str | torch.device | None = None,
             metrics: obs.MetricsRegistry | None = None,
             threefry_partitionable: bool | None = None
             ) -> "RefDBRegistry":
        """Reopen a persisted registry: every database's CURRENT version.

        Only the current snapshot of each database is loaded (onto
        ``device``; older versions stay on disk for audit via their
        manifests); the version counter continues from the published
        chain.  A root written by ``repro``'s registry opens here too:
        its snapshots record no threefry mode, so its databases are
        served in ``threefry_partitionable`` (None: the pointer's config's,
        the default True), which must be the mode of the jax that wrote
        it.  The port's snapshots record their mode; one whose mode is not
        its pointer's config's is skipped as a defect.
        """
        root = pathlib.Path(root)
        reg = cls(root, device=device, metrics=metrics)
        for pointer in sorted(root.glob("*/CURRENT.json")):
            try:
                meta = json.loads(pointer.read_text())
            except (OSError, json.JSONDecodeError):
                continue                      # torn dir: skip, don't poison
            if meta.get("pointer_version") != _POINTER_VERSION:
                continue
            name = meta["database"]
            path = pointer.parent / meta["file"]
            config = ProfilerConfig.from_dict(meta["config"])
            m = refdb_store.manifest(path) or {}
            if "threefry_partitionable" in m:   # written by the port
                if not refdb_store.mode_matches(
                        m, config.threefry_partitionable):
                    continue                  # snapshot of another mode
            elif threefry_partitionable is not None:   # written by repro
                config = dataclasses.replace(
                    config, threefry_partitionable=threefry_partitionable)
            db = refdb_store.load(path, device=reg.device)
            if db is None:
                continue                      # defect reads as absent
            entry = _Entry(name, config)
            snap = RefDBSnapshot(
                database=name, version=int(meta["version"]), db=db,
                parent_version=m.get("parent_version"),
                delta=m.get("delta"), path=path,
                created_at=path.stat().st_mtime)
            entry.snapshots[snap.version] = snap
            entry.current_version = snap.version
            reg._entries[name] = entry
        return reg

    # -- internals ----------------------------------------------------------
    def _entry(self, name: str) -> _Entry:
        with self._lock:
            try:
                return self._entries[name]
            except KeyError:
                raise KeyError(
                    f"unknown database {name!r}; registry has "
                    f"{list(sorted(self._entries))}") from None

    def _builder(self, entry: _Entry) -> RefDBBuilder:
        c = entry.config
        if entry.encode_fn is None:
            # Resolved once per database: the backend holds its item
            # memory on the device, and its encoder is the kernel's.
            entry.encode_fn = resolve_backend(c.backend, c,
                                              device=self.device).encode
        return RefDBBuilder(c.space, window=c.window,
                            stride=c.effective_stride,
                            batch_size=c.batch_size,
                            encode_fn=entry.encode_fn, device=self.device)

    def _publish(self, entry: _Entry, db: RefDB, *, parent: int | None,
                 delta: dict | None, genomes_digest: str = ""
                 ) -> RefDBSnapshot:
        """Write (optional) + swap the current pointer; runs under
        ``entry.mutate`` so versions are a gapless chain."""
        version = entry.current_version + 1
        path = None
        if self.root is not None:
            d = self.root / entry.name
            path = d / f"v{version:04d}.npz"
            c = entry.config
            refdb_store.save(
                path, db,
                refdb_fingerprint=c.refdb_fingerprint(),
                genomes_digest=genomes_digest,
                config_fields=refdb_store.config_fields(
                    c, database=entry.name),
                version=version, parent_version=parent, delta=delta)
            self._flip_pointer(d, entry, version, path.name)
        snap = RefDBSnapshot(database=entry.name, version=version, db=db,
                             parent_version=parent, delta=delta, path=path,
                             created_at=time.time())
        with self._lock:
            entry.snapshots[version] = snap
            entry.current_version = version
        if self._obs.enabled:
            self._m_publishes.inc(1, database=entry.name)
            self._m_live_version.set(version, database=entry.name)
        return snap

    def _flip_pointer(self, d: pathlib.Path, entry: _Entry, version: int,
                      filename: str) -> None:
        """Atomically repoint CURRENT.json at the new snapshot file."""
        meta = {
            "pointer_version": _POINTER_VERSION,
            "database": entry.name,
            "version": version,
            "file": filename,
            "config": entry.config.to_dict(),
        }
        fd, tmp = tempfile.mkstemp(dir=d, prefix="CURRENT.json.tmp-")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(meta, f, sort_keys=True, indent=2)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, d / "CURRENT.json")
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise

    def _notify(self, snap: RefDBSnapshot) -> None:
        with self._lock:
            subs = list(self._subscribers)
        for fn in subs:
            fn(snap)
