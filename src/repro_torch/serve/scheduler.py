"""Generic fixed-shape cohort scheduler: the admission core of serving.

Counterpart of :mod:`repro.serve.scheduler` (a copy).  The profiler
service (:class:`repro_torch.serve.profiler_service.ProfilingService`)
must quantize work into a *small, bounded* set of shapes: each new
``(batch, read length)`` shape is a new launch configuration for the
kernels (and, for the fused kernel's autotuner, a new tile choice).
This module owns that policy once:

  * items are submitted FIFO with a ``size`` (read length);
  * :meth:`FixedShapeScheduler.next_cohort` pops up to ``slots`` items and
    pads their variable dimension up to a *bucket* -- the smallest
    configured padding length holding the cohort's largest item -- so the
    kernels see at most ``len(buckets)`` shapes per slot count;
  * ``buckets=None`` degrades to exact-max padding (one shape per
    distinct cohort max).

The scheduler is deliberately compute-free: it never touches arrays, only
decides *who* runs together and *at what padded length*.  Callers own the
actual padding (left-pad prompts, right-pad reads) and the step function.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Generic, Sequence, TypeVar

T = TypeVar("T")


def pow2_buckets(lo: int, hi: int) -> tuple[int, ...]:
    """Power-of-two padding lengths covering ``[lo, hi]`` (both rounded up).

    The default bounded-shape policy: ``pow2_buckets(64, 400)`` ->
    ``(64, 128, 256, 512)``; at most ``log2(hi/lo)+1`` shapes.
    """
    if lo < 1 or hi < lo:
        raise ValueError(f"need 1 <= lo <= hi, got lo={lo} hi={hi}")
    out = []
    b = 1
    while b < lo:
        b *= 2
    while True:
        out.append(b)
        if b >= hi:
            return tuple(out)
        b *= 2


@dataclasses.dataclass(frozen=True)
class Cohort(Generic[T]):
    """One admitted group: run these items together at ``length`` padding."""
    items: tuple[T, ...]
    length: int            # pad the variable dimension to this


class FixedShapeScheduler(Generic[T]):
    """FIFO admission into padding-bucketed, bounded-shape cohorts."""

    def __init__(self, *, slots: int, buckets: Sequence[int] | None = None):
        """Args:
          slots: maximum items per cohort (the fixed batch dimension).
          buckets: allowed padding lengths, ascending; an item longer than
            ``max(buckets)`` is rejected at submit.  ``None`` pads each
            cohort to its exact max size (unbounded shape set — only for
            callers that control sizes themselves).
        """
        if slots < 1:
            raise ValueError("slots must be >= 1")
        self.slots = slots
        self.buckets = tuple(sorted(buckets)) if buckets is not None else None
        if self.buckets is not None and not self.buckets:
            raise ValueError("buckets must be non-empty (or None)")
        self._queue: deque[tuple[T, int]] = deque()

    def bucket_for(self, size: int) -> int:
        """Smallest configured padding length >= ``size``."""
        if self.buckets is None:
            return size
        for b in self.buckets:
            if size <= b:
                return b
        raise ValueError(
            f"item size {size} exceeds the largest bucket "
            f"{self.buckets[-1]}; configure larger buckets")

    def submit(self, item: T, size: int) -> None:
        """Queue ``item`` whose variable dimension is ``size`` long."""
        if size < 0:
            raise ValueError(f"size must be >= 0, got {size}")
        self.bucket_for(max(size, 1))      # reject oversize at the door
        self._queue.append((item, size))

    def __len__(self) -> int:
        return len(self._queue)

    def next_cohort(self) -> Cohort[T] | None:
        """Pop the next FIFO cohort (<= ``slots`` items), or None if idle.

        The cohort's padding length is the bucket of its largest item;
        FIFO order is never reordered across cohorts, so a submitter's
        items come back in submission order — the property the profiler
        service's bit-exactness guarantee rests on.
        """
        if not self._queue:
            return None
        items, max_size = [], 1
        while self._queue and len(items) < self.slots:
            item, size = self._queue.popleft()
            items.append(item)
            max_size = max(max_size, size)
        return Cohort(items=tuple(items), length=self.bucket_for(max_size))

    def drain(self) -> list[Cohort[T]]:
        """Pop every remaining cohort (for batch-style callers)."""
        out = []
        while (c := self.next_cohort()) is not None:
            out.append(c)
        return out
