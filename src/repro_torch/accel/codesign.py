"""Noise-aware RefDB co-design: retrain prototypes on simulated readout.

Counterpart of :mod:`repro.accel.codesign`.  It takes a naively built
RefDB and a noisy substrate backend config, reads reference-derived
training reads through that backend, and nudges the prototypes to widen
the species margin under the device's own noise.  Two stages, both
validated on held-out reads:

1. **fault-aware programming**
   (:func:`repro_torch.accel.crossbar.write_verify_bits`) when the backend
   runs on a simulated substrate;
2. **margin retraining**: per-bit counters recovered from the binarized
   prototypes (``+-init_scale``), updated perceptron-style for every read
   whose true species fails its best rival or the hit threshold by
   ``margin`` counts, then re-binarized (ties keep the prior bit).

Every candidate -- the naive build, the write-verified build and each
retraining iterate -- is scored on noisy readout of a held-out split, and
the best validated one is returned.  The sampling is ``repro``'s numpy
sequence from ``seed`` (the same reads, the same split, the same shuffles),
so with ``repro``'s device draws the port retrains the same prototypes;
the counter arithmetic (integers) runs in torch on the database's device.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import assoc_memory, bitops, classifier
from repro_torch.core.assoc_memory import RefDB
from repro_torch.pipeline.config import ProfilerConfig


def _training_reads(db: RefDB, genomes: dict[str, np.ndarray], *,
                    read_len: int, reads_per_species: int,
                    rng: np.random.Generator
                    ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Seeded read-like windows from every reference genome + labels."""
    toks_out, labels = [], []
    for label, name in enumerate(db.species_names):
        toks = np.asarray(genomes[name])
        n = min(read_len, len(toks))
        row = np.zeros((reads_per_species, read_len), np.int32)
        starts = rng.integers(0, len(toks) - n + 1, reads_per_species)
        for i, s in enumerate(starts):
            row[i, :n] = toks[s:s + n]
        toks_out.append(row)
        labels.append(np.full(reads_per_species, label, np.int32))
    # per-read true length (genomes may be shorter than read_len)
    lengths = np.concatenate(
        [np.full(reads_per_species,
                 min(read_len, len(np.asarray(genomes[name]))), np.int32)
         for name in db.species_names])
    return (np.concatenate(toks_out), lengths, np.concatenate(labels))


def noise_aware_refdb(db: RefDB, genomes: dict[str, np.ndarray],
                      config: ProfilerConfig, *, iterations: int = 2,
                      reads_per_species: int = 48, read_len: int = 256,
                      margin: int | None = None, init_scale: int = 8,
                      seed: int = 0, stats: dict | None = None) -> RefDB:
    """Margin-maximizing retraining of ``db`` on simulated noisy readout.

    Args:
      db: the naively built RefDB; the pass runs on its device.
      genomes: the reference genomes the database was built from.
      config: the *profiling* config -- its backend + backend_options are
        the simulated substrate the retraining reads through.
      iterations: full passes over the training reads.
      reads_per_species: seeded training reads sampled per species.
      read_len: training read length in tokens (clipped per genome).
      margin: required winning margin in agreement counts; default
        ``dim // 32``.
      init_scale: magnitude of each recovered bundling counter.
      seed: sampling seed (independent of the device seed).
      stats: if given, filled with the validation scores the pass compared
        (``naive``, ``best``: ``(true-species hit rate, -false hits a
        read)``), ``candidates``, the number scored, ``flagged``, the
        training reads the passes flagged, and ``changed``, the prototypes
        the last retraining iterate changed from its base.

    Returns:
      A new RefDB with retrained prototypes; species metadata unchanged.
    """
    from repro_torch.pipeline.backend import resolve_backend

    if iterations < 1:
        raise ValueError("iterations must be >= 1")
    if margin is None:
        margin = max(1, config.space.dim // 32)
    missing = set(db.species_names) - set(genomes)
    if missing:
        raise KeyError(f"genomes missing for species {sorted(missing)}")

    dev = db.prototypes.device
    be = resolve_backend(config.backend, config, device=dev)
    rng = np.random.default_rng(seed)
    tokens, lengths, labels = _training_reads(
        db, genomes, read_len=read_len,
        reads_per_species=reads_per_species, rng=rng)

    # Stage 1: fault-aware programming, when the backend exposes a
    # probe-able simulated substrate; digital backends skip it.
    base_protos = db.prototypes
    if getattr(be, "substrate", None) is not None:
        from repro_torch.accel.crossbar import write_verify_bits
        base_protos = write_verify_bits(
            db.prototypes, be.crossbar_config, be.substrate)

    # Encode once, digitally (bit-exact on every backend), in batches.
    bs = config.batch_size
    queries = torch.cat([
        be.encode(torch.from_numpy(tokens[i:i + bs]).to(dev),
                  torch.from_numpy(lengths[i:i + bs]).to(dev))
        for i in range(0, len(tokens), bs)])
    dim = config.space.dim
    qpm = 2 * bitops.unpack_bits(queries)[:, :dim].to(torch.int32) - 1

    base_bits = bitops.unpack_bits(base_protos)[:, :dim]
    counters = (2 * base_bits.to(torch.int32) - 1) * init_scale
    proto_species = db.proto_species.cpu().numpy()
    same = proto_species[None, :] == labels[:, None]        # (B, S_protos)
    neg = np.iinfo(np.int64).min

    def noisy_agreement(idx, prototypes):
        out = np.empty((len(idx), len(proto_species)), np.int64)
        for i in range(0, len(idx), bs):
            sel = idx[i:i + bs]
            out[i:i + len(sel)] = be.agreement(
                queries[torch.from_numpy(sel).to(dev)], prototypes
            ).cpu().numpy()
        return out

    # Held-out validation split: candidates (the naive build included)
    # are scored on noisy readout of reads the updates never saw.
    split = rng.permutation(len(queries))
    n_val = max(len(proto_species) // 4, len(queries) // 5)
    val_idx, train_idx = split[:n_val], split[n_val:]

    def validate(prototypes):
        """Keep the true-species hit rate first, then minimize false hits
        on other species (step 4's classification of held-out reads)."""
        agree = noisy_agreement(val_idx, prototypes)
        res = classifier.from_agreement(
            torch.from_numpy(agree.astype(np.int32)),
            db.proto_species.cpu(), db.num_species,
            config.space.threshold_bits)
        hits = res.hits.numpy()
        rows = np.arange(len(val_idx))
        correct = hits[rows, labels[val_idx]].mean()
        false = (hits.sum(axis=1) - hits[rows, labels[val_idx]]).mean()
        return float(correct), -float(false)

    naive_score = best_score = validate(db.prototypes)
    best_protos, candidates = db.prototypes, 1
    if base_protos is not db.prototypes:
        score = validate(base_protos)
        candidates += 1
        if score > best_score:
            best_score, best_protos = score, base_protos
    prototypes = base_protos
    n_flagged = 0
    for _ in range(iterations):
        # Re-shuffled every pass: the device keys its read noise off the
        # batch digest, so a new batch composition draws new noise.
        order = rng.permutation(train_idx)
        agree = noisy_agreement(order, prototypes)
        sq, spm = same[order], qpm[torch.from_numpy(order).to(dev)]
        own = np.where(sq, agree, neg)
        rival = np.where(sq, neg, agree)
        own_best = own.argmax(axis=1)                      # proto indices
        rival_best = rival.argmax(axis=1)
        rows = np.arange(len(order))
        own_score = own[rows, own_best]
        rival_flag = own_score < rival[rows, rival_best] + margin
        thr_flag = own_score < config.space.threshold_bits + margin
        flagged = rival_flag | thr_flag
        if not flagged.any():
            break
        n_flagged += int(flagged.sum())
        # Bundle the read into its species' best prototype; un-bundle it
        # from the rival only when the rival was the binding constraint.
        def bundle(target, mask, sign):
            m = torch.from_numpy(mask).to(dev)
            counters.index_add_(0, torch.from_numpy(target).to(dev)[m],
                                sign * spm[m])
        bundle(own_best, flagged, 1)
        bundle(rival_best, rival_flag, -1)
        prototypes = assoc_memory.rebinarize_counters(counters, base_bits)
        score = validate(prototypes)
        candidates += 1
        if score > best_score:
            best_score, best_protos = score, prototypes

    if stats is not None:
        changed = int((prototypes != base_protos).any(dim=1).sum())
        stats.update(naive=naive_score, best=best_score,
                     candidates=candidates, flagged=n_flagged,
                     changed=changed)
    return RefDB(prototypes=best_protos,
                 proto_species=db.proto_species,
                 genome_lengths=db.genome_lengths,
                 num_species=db.num_species,
                 species_names=db.species_names)
