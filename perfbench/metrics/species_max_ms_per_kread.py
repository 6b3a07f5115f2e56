"""Per-layer metric ``species_max_ms_per_kread`` (layer: the
classifier, ``core/classifier.py`` + ``core/assoc_memory.species_scores``:
the species max and the threshold).

Source: ``torch.profiler``'s device time of the kernels the species max
launches today, ``scatter_reduce_``'s elementwise scatter (named below),
in the traced stretch, per 1,000 reads classified in it.  Moves
``profile_reads_per_s``.  Finds nothing, and reports nothing, once the
species max launches other kernels.
"""

KERNELS = r"_scatter_gather_elementwise_kernel"


def read(ctx):
    tr = ctx.get("trace")
    if tr is None:
        return None
    reads = sum(c.get("valid", 0) for c in tr.calls)
    t = tr.kernel_time(KERNELS)
    if reads == 0 or t == 0:
        return None
    return t * 1e3 / (reads / 1e3)
