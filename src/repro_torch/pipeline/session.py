"""`ProfilingSession`: the facade over the five-step Demeter pipeline.

Counterpart of :mod:`repro.pipeline.session`.  One session binds a
:class:`~repro_torch.pipeline.config.ProfilerConfig` to a resolved
backend on one device and drives the whole pipeline::

    session = ProfilingSession(ProfilerConfig(backend="cuda_fused"))
    session.build_or_load_refdb(genomes, cache_dir="cache/")
    report = session.profile(FastqSource("sample.fastq"))

``device=None`` means ``cuda``; without a GPU the session raises unless
the caller passes ``device="cpu"``.  With ``config.noise_aware_refdb`` a
build is followed by ``repro``'s noise-aware refine
(:func:`repro_torch.accel.codesign.noise_aware_refdb`), and a cached entry
records ``noise_aware`` in its manifest, as ``repro``'s does.

Every way a session acquires a RefDB (build, cache load, adopt) ends in
the backend's ``place_refdb`` hook when it has one: the ``sharded``
backend keeps only this rank's share of the prototype rows there.
"""

from __future__ import annotations

import dataclasses
import hashlib
import itertools
import pathlib
import time
from typing import Callable

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core import classifier
from repro_torch.core.assoc_memory import RefDB, RefDBBuilder
from repro_torch.pipeline import refdb_store
from repro_torch.pipeline.backend import Backend, resolve_backend
from repro_torch.pipeline.config import ProfilerConfig
from repro_torch.pipeline.report import ProfileAccumulator, ProfileReport
from repro_torch.pipeline.source import as_source, prefetch


@dataclasses.dataclass(frozen=True)
class BatchResult:
    """What the per-batch callback sees: one classified read batch.

    ``queries`` is ``None`` when the backend fused encode into the AM
    search (``tokens_agreement``): the encoded ``(B, W)`` matrix is never
    materialized on that path.
    """
    index: int
    queries: torch.Tensor | None                        # (B, W) packed
    classification: classifier.ReadClassification      # over all B rows
    num_valid: int                                      # real rows (<= B)


BatchCallback = Callable[[BatchResult], None]


class ProfilingSession:
    """Facade binding a config + backend + (optionally cached) RefDB."""

    def __init__(self, config: ProfilerConfig, *,
                 backend: Backend | None = None,
                 device: str | torch.device | None = None,
                 metrics: obs.MetricsRegistry | None = None):
        """Args:
          backend: pre-resolved backend to use instead of resolving
            ``config.backend``; the session then runs on its device.
            Sessions sharing one backend share its item memory and its
            autotuned tiles -- the serving router runs one session per
            RefDB version on a single shared backend.
          device: where the backend (when resolved here) and the RefDB
            live; ``None`` means ``cuda``.
          metrics: observability registry; None resolves the process
            global (:func:`repro_torch.obs.metrics`, the no-op registry
            unless observability was enabled).  Recording is host-side
            only and never waits for the card, so metrics cannot perturb
            results.
        """
        self.config = config
        self.space = config.space
        self.backend: Backend = (
            backend if backend is not None
            else resolve_backend(config.backend, config, device=device))
        self.device = self.backend.device
        self._obs = obs.resolve_metrics(metrics)
        self._m_batch_time = self._obs.histogram(
            "session_classify_batch_seconds",
            "classify_batch dispatch wall time per dispatch path "
            "(async backends: time to hand off, not to complete)",
            unit="s")
        self._m_batches = self._obs.counter(
            "session_classify_batches_total",
            "classify_batch calls per backend and dispatch path")
        self._m_transfers = self._obs.counter(
            "session_host_transfers_total",
            "device->host array transfers on the query path")
        self.refdb: RefDB | None = None
        self.refdb_loaded_from_cache = False
        self.refdb_cache_file: pathlib.Path | None = None

    def _builder(self) -> RefDBBuilder:
        return RefDBBuilder(
            self.space, window=self.config.window,
            stride=self.config.effective_stride,
            batch_size=self.config.batch_size,
            encode_fn=self.backend.encode, device=self.device,
            metrics=self._obs)

    # -- Step 2 ------------------------------------------------------------
    def build_refdb(self, genomes: dict[str, np.ndarray]) -> RefDB:
        """Encode the reference genomes into the AM through the backend.

        With ``config.noise_aware_refdb`` the naive build is followed by
        the margin-maximizing retraining pass, read through this config's
        backend and options on the session's device.
        """
        db = refdb_store.build_streaming(genomes, self._builder())
        db = self._maybe_refine(db, genomes)
        self.refdb = self._place(db)
        self.refdb_loaded_from_cache = False
        return self.refdb

    def _maybe_refine(self, db: RefDB,
                      genomes: dict[str, np.ndarray]) -> RefDB:
        """Noise-aware co-design pass, when the config asks for it."""
        if not self.config.noise_aware_refdb:
            return db
        from repro_torch.accel.codesign import noise_aware_refdb
        return noise_aware_refdb(db, genomes, self.config,
                                 iterations=self.config.noise_aware_iters)

    def _config_fields(self) -> dict:
        """Provenance for the store manifest (``noise_aware`` as
        ``repro`` records it, when the build refines)."""
        extra = {}
        if self.config.noise_aware_refdb:
            extra["noise_aware"] = {
                "backend": self.config.backend,
                "backend_options": list(self.config.backend_options),
                "iters": self.config.noise_aware_iters}
        return refdb_store.config_fields(self.config, **extra)

    def adopt_refdb(self, db: RefDB) -> RefDB:
        """Make an externally built/loaded RefDB this session's database
        (moved to the session's device, then placed by the backend)."""
        self.refdb = self._place(db.to(self.device))
        self.refdb_loaded_from_cache = False
        return self.refdb

    def refdb_cache_path(self, cache_dir: str | pathlib.Path,
                         genomes: dict[str, np.ndarray]) -> pathlib.Path:
        """Cache location keyed by every input that determines RefDB
        content: the config's RefDB fingerprint plus an order-insensitive
        digest of the reference genomes (the same key as ``repro``)."""
        key = f"{self.config.refdb_fingerprint()}_{_genomes_digest(genomes)}"
        return pathlib.Path(cache_dir) / f"refdb_{key}.npz"

    def build_or_load_refdb(self, genomes: dict[str, np.ndarray], *,
                            cache_dir: str | pathlib.Path | None = None
                            ) -> RefDB:
        """Load the RefDB from the content-keyed cache, or build and cache it.

        The store format is ``repro``'s, so an entry either package wrote
        serves the other.  The port records its threefry mode in the
        manifests it writes; an entry whose recorded mode is not this
        config's is a miss (rebuilt), and an entry with no recorded mode
        (written by ``repro``, whose manifests do not carry one) is taken
        to be in this config's mode.
        """
        if cache_dir is None:
            return self.build_refdb(genomes)
        cache = self.refdb_cache_path(cache_dir, genomes)
        self.refdb_cache_file = cache
        db = None
        if refdb_store.mode_matches(refdb_store.manifest(cache),
                                    self.config.threefry_partitionable):
            db = refdb_store.load(cache, device=self.device)
        if db is not None:
            self.refdb = self._place(db)
            self.refdb_loaded_from_cache = True
            return self.refdb
        refine = self.config.noise_aware_refdb
        db = refdb_store.build_streaming(
            genomes, self._builder(), path=None if refine else cache,
            refdb_fingerprint=self.config.refdb_fingerprint(),
            genomes_digest=_genomes_digest(genomes),
            config_fields=self._config_fields())
        if refine:
            # Cache the *refined* database under the noise-aware key (the
            # fingerprint folds in backend + options + iters), so a later
            # load gets the retrained prototypes, not the naive build.
            db = self._maybe_refine(db, genomes)
            refdb_store.save(
                cache, db, refdb_fingerprint=self.config.refdb_fingerprint(),
                genomes_digest=_genomes_digest(genomes),
                config_fields=self._config_fields())
        self.refdb = self._place(db)
        self.refdb_loaded_from_cache = False
        return self.refdb

    # -- Step 3 ------------------------------------------------------------
    def encode_reads(self, tokens, lengths) -> torch.Tensor:
        """Convert a read batch ``(B, L)`` into query HD vectors ``(B, W)``."""
        return self.backend.encode(*self._to_device(tokens, lengths))

    # -- Step 4 ------------------------------------------------------------
    def classify_queries(self, queries: torch.Tensor,
                         refdb: RefDB | None = None
                         ) -> classifier.ReadClassification:
        """AM search + threshold over pre-encoded ``(B, W)`` query vectors.

        A backend with the ``species_scores`` capability (``sharded``:
        agreement and the species max on each shard, merged across the
        shards) skips the per-prototype agreement; both paths are
        bit-identical.
        """
        db = self._require_refdb(refdb)
        fused = getattr(self.backend, "species_scores", None)
        if fused is not None:
            scores = fused(queries, db.prototypes, db.proto_species,
                           db.num_species)
            return classifier.from_scores(scores, self.space.threshold_bits)
        agree = self.backend.agreement(queries, db.prototypes)
        return classifier.from_agreement(
            agree, db.proto_species, db.num_species, self.space.threshold_bits)

    # -- Steps 3+4: the step-level serving primitive -----------------------
    def classify_batch(self, tokens, lengths, *, refdb: RefDB | None = None,
                       num_valid: int | None = None, index: int = 0
                       ) -> BatchResult:
        """Encode + classify one read batch: the shared hot-path step.

        Capability dispatch, most-fused first (all bit-identical):
        ``tokens_species_scores``, then ``tokens_agreement`` (``queries``
        is ``None`` on the result), then ``encode`` +
        :meth:`classify_queries`.  Under a running ``torch.profiler`` the
        step is the span ``repro_torch.classify_batch``, with the upload
        (``repro_torch.to_device``) and the path taken (named for its
        capability, ``repro_torch.encode`` for the last) beneath it.
        """
        with obs.span("repro_torch.classify_batch"):
            db = self._require_refdb(refdb)
            with obs.span("repro_torch.to_device"):
                toks, lens = self._to_device(tokens, lengths)
            fused_full = getattr(self.backend, "tokens_species_scores", None)
            fused = getattr(self.backend, "tokens_agreement", None)
            recording = self._obs.enabled
            t0 = time.perf_counter() if recording else 0.0
            if fused_full is not None:
                path = "tokens_species_scores"
                with obs.span("repro_torch.tokens_species_scores"):
                    scores = fused_full(toks, lens, db.prototypes,
                                        db.proto_species, db.num_species)
                    res = classifier.from_scores(scores,
                                                 self.space.threshold_bits)
                q = None
            elif fused is not None:
                path = "tokens_agreement"
                with obs.span("repro_torch.tokens_agreement"):
                    agree = fused(toks, lens, db.prototypes)
                    res = classifier.from_agreement(
                        agree, db.proto_species, db.num_species,
                        self.space.threshold_bits)
                q = None
            else:
                path = "encode_classify"
                with obs.span("repro_torch.encode"):
                    q = self.backend.encode(toks, lens)
                    res = self.classify_queries(q, db)
            if recording:
                # Host clock only, with no synchronize: the dispatch time,
                # as repro records it; the kernels' work is untouched.
                labels = {"backend": self.config.backend, "path": path}
                self._m_batch_time.observe(time.perf_counter() - t0,
                                           **labels)
                self._m_batches.inc(1, **labels)
            n = len(toks) if num_valid is None else num_valid
            return BatchResult(index=index, queries=q, classification=res,
                               num_valid=n)

    # -- Steps 3+4+5 streamed ----------------------------------------------
    def profile(self, source, *, refdb: RefDB | None = None,
                on_batch: BatchCallback | None = None,
                prefetch_depth: int = 2) -> ProfileReport:
        """Profile a sample: stream, encode, classify, estimate abundance.

        Under a running ``torch.profiler`` the call is the span
        ``repro_torch.profile``; its children name the host's serial
        work between batches: the wait on the prefetch queue
        (``.next_batch``), the wait for the batch and the copy of its
        hits and categories (``.d2h``), the report's bookkeeping
        (``.accumulate``) and the multi-read split (``.finalize``).
        """
        with obs.span("repro_torch.profile"):
            db = self._require_refdb(refdb)
            acc = ProfileAccumulator(db.num_species)
            stream = prefetch(
                as_source(source).batches(self.config.batch_size),
                prefetch_depth)
            for i in itertools.count():
                with obs.span("repro_torch.profile.next_batch",
                              host_only=True):
                    batch = next(stream, None)
                if batch is None:
                    break
                res = self.classify_batch(batch.tokens, batch.lengths,
                                          refdb=db, num_valid=batch.num_valid,
                                          index=i)
                n = res.num_valid
                with obs.span("repro_torch.profile.d2h"):
                    hits = res.classification.hits[:n].cpu().numpy()
                    category = res.classification.category[:n].cpu().numpy()
                with obs.span("repro_torch.profile.accumulate",
                              host_only=True):
                    acc.add(hits, category)
                    self.note_host_transfers(2)   # hits + category to host
                    if on_batch is not None:
                        on_batch(res)
            with obs.span("repro_torch.profile.finalize"):
                return acc.finalize(db.genome_lengths.cpu().numpy(),
                                    db.species_names)

    def note_host_transfers(self, n: int) -> None:
        """Count ``n`` device->host transfers against this session.

        Called wherever classification outputs cross to numpy -- here in
        :meth:`profile` and by the serving demux
        (:meth:`repro_torch.serve.profiler_service.ProfilingService.step`).
        """
        if self._obs.enabled:
            self._m_transfers.inc(n, backend=self.config.backend)

    # ----------------------------------------------------------------------
    def _place(self, db: RefDB) -> RefDB:
        """Run the backend's device-placement step, if it has one (the
        ``sharded`` backend pads the prototype axis to its shards and
        keeps this rank's rows); other backends pass the db through."""
        place = getattr(self.backend, "place_refdb", None)
        return db if place is None else place(db)

    def _to_device(self, tokens, lengths) -> tuple[torch.Tensor, torch.Tensor]:
        def put(x):
            if isinstance(x, torch.Tensor):
                return x.to(device=self.device, dtype=torch.int32)
            return torch.from_numpy(np.asarray(x, np.int32)).to(self.device)
        return put(tokens), put(lengths)

    def _require_refdb(self, refdb: RefDB | None) -> RefDB:
        db = refdb if refdb is not None else self.refdb
        if db is None:
            raise RuntimeError(
                "no RefDB: call build_or_load_refdb()/build_refdb() first "
                "or pass refdb= explicitly")
        return db


def _genomes_digest(genomes: dict[str, np.ndarray]) -> str:
    """Stable, order-insensitive hash of the reference content (the same
    digest as ``repro``'s, so cache keys agree across the packages)."""
    parts = []
    for name, toks in genomes.items():
        h = hashlib.sha256(name.encode())
        h.update(b"\x00")
        h.update(np.ascontiguousarray(toks, dtype=np.int32).tobytes())
        parts.append(h.digest())
    return hashlib.sha256(b"".join(sorted(parts))).hexdigest()[:16]
