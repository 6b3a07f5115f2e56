"""Genomics data substrate (numpy only): alphabet, synthetic communities, IO,
k-mers.  Kept as the port's own copy so it never imports the JAX package."""

from repro_torch.genomics import alphabet, kmers, synth

__all__ = ["alphabet", "kmers", "synth"]
