"""Cohort-based continuous batching for the LM decode loop.

Counterpart of :mod:`repro.serve.batching`.  Fixed-shape serving:
requests are admitted into a cohort of ``slots``; each slot decodes in
lockstep; finished slots (EOS or budget) are refilled from the queue at
cohort boundaries.  Per-slot positions are tracked host-side; the decode
step masks each slot's cache by the kpos tags built into it.

Admission (FIFO grouping into ``slots``-sized cohorts, choice of padded
prompt length) is delegated to the generic
:class:`repro_torch.serve.scheduler.FixedShapeScheduler`; this module
keeps only the LM-specific lockstep decode.  By default cohorts pad to
their exact prompt max; pass ``buckets=`` to bound the prefill shape set
instead.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.serve.scheduler import FixedShapeScheduler


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray              # (L,) int32
    max_new_tokens: int
    out: list = dataclasses.field(default_factory=list)
    done: bool = False


class CohortScheduler:
    """Admit-from-queue, decode-in-lockstep, emit-on-finish."""

    def __init__(self, *, slots: int, max_len: int,
                 prefill_fn: Callable, decode_fn: Callable,
                 sample_fn: Callable, eos_id: int | None = None,
                 buckets: Sequence[int] | None = None,
                 device: str | torch.device | None = None):
        """``buckets`` bounds the prefill shape set, at a cost: prompts
        are LEFT-padded to the bucket, and padded positions physically
        occupy cache slots, so a cohort's decode budget becomes
        ``max_len - bucket`` rather than ``max_len - true_prompt_max``.
        Size ``max_len`` with the largest bucket in mind.  Prompts go to
        ``prefill_fn`` as int32 tensors on ``device`` (``None``:
        ``cuda``)."""
        self.max_len = max_len
        self.prefill = prefill_fn
        self.decode = decode_fn
        self.sample = sample_fn
        self.eos_id = eos_id
        self.device = resolve_device(device)
        self._sched: FixedShapeScheduler[Request] = FixedShapeScheduler(
            slots=slots, buckets=buckets)
        self.finished: list[Request] = []

    @property
    def slots(self) -> int:
        return self._sched.slots

    def submit(self, req: Request) -> None:
        self._sched.submit(req, len(req.prompt))

    def run(self, max_steps: int = 10_000) -> list[Request]:
        """Serve until queue + cohort drain (cohort-granular admission)."""
        while (cohort := self._sched.next_cohort()) is not None:
            self._run_cohort(list(cohort.items), cohort.length, max_steps)
            self.finished.extend(cohort.items)
        return self.finished

    def _run_cohort(self, cohort: list[Request], plen: int,
                    max_steps: int) -> None:
        b = len(cohort)
        prompts = np.zeros((b, plen), np.int32)
        for i, r in enumerate(cohort):
            prompts[i, plen - len(r.prompt):] = r.prompt  # left-pad
        logits, caches = self.prefill(
            torch.from_numpy(prompts).to(self.device))
        tok = self.sample(logits)
        active = np.ones(b, bool)
        for step in range(max_steps):
            host = torch.as_tensor(tok).cpu().numpy()
            for i, r in enumerate(cohort):
                if not active[i]:
                    continue
                t = int(host[i])
                r.out.append(t)
                if (self.eos_id is not None and t == self.eos_id) or \
                        len(r.out) >= r.max_new_tokens:
                    r.done = True
                    active[i] = False
            if not active.any() or plen + step + 1 >= self.max_len:
                break
            logits, caches = self.decode(tok, caches, plen + step)
            tok = self.sample(logits)
