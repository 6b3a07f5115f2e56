"""Per-layer metric ``species_max_span_ms_per_kread`` (layer: the
classifier, ``core/classifier.py`` + ``core/assoc_memory.species_scores``:
the species max).

Source: the program's span ``repro_torch.species_scores``
(``perfbench/spans.py``): the device time of every kernel launched inside
it in the traced stretch, whatever kernels implement the species max, per
1,000 valid reads of the stretch's calls (the harness's ``classify_batch``
annotations).  Moves ``profile_reads_per_s``.  Reports nothing where the
program has no such span.
"""

from perfbench import spans


def read(ctx):
    sp = spans.load(ctx)
    if sp is None:
        return None
    reads = sum(c.get("valid", 0) for c in ctx["trace"].calls)
    t = sp.kernel_time(spans.SPECIES_MAX)
    if reads == 0 or t == 0:
        return None
    return t * 1e3 / (reads / 1e3)
