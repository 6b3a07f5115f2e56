"""`ReadSource`: streaming read input for the profiling pipeline.

Counterpart of :mod:`repro.pipeline.source` (numpy only).

A source yields fixed-shape :class:`ReadBatch` es — tokens padded to a
stable ``(batch_size, read_len)`` shape so the encode/classify path
sees one shape — while tracking how many rows of the final batch are real
reads (``num_valid``), so padding never leaks into the report.

Concrete sources:

  :class:`ArraySource`      in-memory token/length arrays.
  :class:`FastqSource`      a FASTQ file, parsed lazily record-by-record
                            (the file is never fully materialized).
  :class:`SyntheticSource`  a synthetic food community with ground truth.
  :class:`IterableSource`   adapter for pre-batched ``(tokens, lengths)``
                            iterables (the legacy ``batch_reads`` contract
                            and serving queues).

:func:`prefetch` overlaps host-side batch preparation (file parsing,
padding) with device compute by running the source iterator in a
background thread with a bounded queue.
"""

from __future__ import annotations

import abc
import dataclasses
import pathlib
import queue
import threading
from typing import Iterable, Iterator

import numpy as np

from repro_torch import obs
from repro_torch.genomics import fasta, synth


@dataclasses.dataclass(frozen=True)
class ReadBatch:
    """One fixed-shape batch of reads.

    tokens: ``(batch_size, L)`` int32, zero-padded rows past ``num_valid``.
    lengths: ``(batch_size,)`` int32, zero past ``num_valid``.
    num_valid: number of leading rows that are real reads.
    """
    tokens: np.ndarray
    lengths: np.ndarray
    num_valid: int


def _pad_batch(tokens: np.ndarray, lengths: np.ndarray,
               batch_size: int) -> ReadBatch:
    n = len(tokens)
    if n < batch_size:
        pad = batch_size - n
        tokens = np.concatenate(
            [tokens, np.zeros((pad,) + tokens.shape[1:], tokens.dtype)])
        lengths = np.concatenate([lengths, np.zeros(pad, lengths.dtype)])
    return ReadBatch(tokens=tokens, lengths=lengths, num_valid=n)


class ReadSource(abc.ABC):
    """Abstract stream of reads; iterate with :meth:`batches`."""

    @abc.abstractmethod
    def batches(self, batch_size: int) -> Iterator[ReadBatch]:
        """Yield :class:`ReadBatch` es padded to ``batch_size`` rows."""


class ArraySource(ReadSource):
    """Reads already materialized as ``(R, L)`` tokens + ``(R,)`` lengths."""

    def __init__(self, tokens: np.ndarray, lengths: np.ndarray):
        if len(tokens) != len(lengths):
            raise ValueError("tokens and lengths disagree on read count")
        self.tokens = np.asarray(tokens)
        self.lengths = np.asarray(lengths)

    def __len__(self) -> int:
        return len(self.tokens)

    def batches(self, batch_size: int) -> Iterator[ReadBatch]:
        for i in range(0, len(self.tokens), batch_size):
            yield _pad_batch(self.tokens[i:i + batch_size],
                             self.lengths[i:i + batch_size], batch_size)


class FastqSource(ReadSource):
    """Stream reads from a FASTQ file without loading it whole.

    Records are parsed lazily, ``batch_size`` at a time; sequences are
    truncated/zero-padded to ``read_len`` (the fixed query shape).
    """

    def __init__(self, path: str | pathlib.Path, read_len: int = 150):
        self.path = pathlib.Path(path)
        self.read_len = read_len

    def batches(self, batch_size: int) -> Iterator[ReadBatch]:
        toks: list[np.ndarray] = []
        lens: list[int] = []
        for row, n in fasta.iter_fastq(self.path, self.read_len):
            toks.append(row)
            lens.append(n)
            if len(toks) == batch_size:
                yield ReadBatch(np.stack(toks), np.asarray(lens, np.int32),
                                batch_size)
                toks, lens = [], []
        if toks:
            yield _pad_batch(np.stack(toks), np.asarray(lens, np.int32),
                             batch_size)


class SyntheticSource(ArraySource):
    """A synthetic food community sample with ground truth attached.

    Wraps :func:`repro_torch.genomics.synth.make_sample`; exposes ``genomes``
    (the reference database to build the RefDB from), per-read ``truth``
    and the ``true_abundance`` profile for scoring.
    """

    def __init__(self, spec: synth.CommunitySpec, num_reads: int,
                 present: list[int] | None = None):
        genomes, tokens, lengths, truth, true_ab = synth.make_sample(
            spec, num_reads=num_reads, present=present)
        super().__init__(tokens, lengths)
        self.spec = spec
        self.genomes = genomes
        self.truth = truth
        self.true_abundance = true_ab


class IterableSource(ReadSource):
    """Adapter for an iterable of pre-batched ``(tokens, lengths)`` pairs.

    Batches pass through at their own size (``batch_size`` is ignored);
    every row counts as valid — the legacy ``batch_reads`` contract, where
    tail padding was part of the batch.
    """

    def __init__(self, batches: Iterable[tuple[np.ndarray, np.ndarray]]):
        self._batches = batches

    def batches(self, batch_size: int) -> Iterator[ReadBatch]:
        for tokens, lengths in self._batches:
            yield ReadBatch(np.asarray(tokens), np.asarray(lengths),
                            len(tokens))


def as_source(obj) -> ReadSource:
    """Coerce supported inputs to a :class:`ReadSource`.

    Accepts a ``ReadSource`` (passed through), a ``(tokens, lengths)``
    array pair (numpy, CPU tensors, or nested lists), or an iterable of
    pre-batched ``(tokens, lengths)`` pairs.
    """
    if isinstance(obj, ReadSource):
        return obj
    if isinstance(obj, tuple) and len(obj) == 2:
        # A (tokens, lengths) pair of any array-likes; pre-batched streams
        # are lists/generators, not 2-tuples, so a 2-tuple is unambiguous.
        try:
            toks, lens = np.asarray(obj[0]), np.asarray(obj[1])
        except Exception:
            toks = lens = None
        if toks is not None and toks.ndim == 2 and lens.ndim == 1:
            return ArraySource(toks, lens)
        raise TypeError(
            "a (tokens, lengths) pair must be (R, L) x (R,) arrays; "
            "pass pre-batched pairs as a list or generator instead")
    if isinstance(obj, Iterable):
        return IterableSource(obj)
    raise TypeError(f"cannot interpret {type(obj).__name__} as a ReadSource")


def prefetch(it: Iterator, depth: int = 2) -> Iterator:
    """Run ``it`` in a background thread, keeping ``depth`` items ready.

    Host-side batch preparation (file IO, padding) overlaps with device
    compute; exceptions from the producer re-raise at the consumer.  If
    the consumer abandons the stream early (error mid-profile, generator
    closed), the producer is signalled to stop and closes ``it`` — no
    thread or file handle is left blocked on the full queue.  Under a
    running profiler each item the producer draws from ``it`` is the span
    ``repro_torch.source.batch`` on the producer's thread.
    """
    if depth <= 0:
        yield from it
        return
    q: queue.Queue = queue.Queue(maxsize=depth)
    done = object()
    stop = threading.Event()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.05)
                return True
            except queue.Full:
                continue
        return False

    def producer() -> None:
        try:
            items = iter(it)
            while True:
                with obs.span("repro_torch.source.batch", host_only=True):
                    item = next(items, done)
                if item is done:
                    break
                if not put((None, item)):
                    return
        except BaseException as e:  # re-raised on the consumer side
            put((e, None))
        else:
            put((None, done))
        finally:
            close = getattr(it, "close", None)
            if close is not None:
                close()

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    try:
        while True:
            err, item = q.get()
            if err is not None:
                raise err
            if item is done:
                return
            yield item
    finally:
        stop.set()
