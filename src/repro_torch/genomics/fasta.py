"""Minimal FASTA/FASTQ IO (plain text, no external deps)."""

from __future__ import annotations

import pathlib
from typing import Iterator

import numpy as np

from repro_torch.genomics import alphabet


def read_fasta(path: str | pathlib.Path) -> dict[str, np.ndarray]:
    """FASTA file -> {name: int32 tokens}."""
    genomes: dict[str, np.ndarray] = {}
    name, chunks = None, []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            if line.startswith(">"):
                if name is not None:
                    genomes[name] = alphabet.seq_to_tokens("".join(chunks))
                name, chunks = line[1:].split()[0], []
            else:
                chunks.append(line)
    if name is not None:
        genomes[name] = alphabet.seq_to_tokens("".join(chunks))
    return genomes


def write_fasta(path: str | pathlib.Path, genomes: dict[str, np.ndarray],
                width: int = 80) -> None:
    with open(path, "w") as f:
        for name, toks in genomes.items():
            f.write(f">{name}\n")
            seq = alphabet.tokens_to_seq(toks)
            for i in range(0, len(seq), width):
                f.write(seq[i:i + width] + "\n")


def iter_fastq(path: str | pathlib.Path, read_len: int
               ) -> "Iterator[tuple[np.ndarray, int]]":
    """Lazily yield FASTQ records as (tokens (read_len,), length).

    Sequences are truncated/zero-padded to ``read_len``.  The single
    FASTQ-parsing loop: both the eager :func:`read_fastq` and the
    streaming ``repro_torch.pipeline.FastqSource`` consume it.
    """
    with open(path) as f:
        while True:
            header = f.readline()
            if not header:
                return
            if not header.strip():
                continue    # blank line (e.g. trailing newline), not a record
            seq = f.readline().strip()
            f.readline()  # '+'
            f.readline()  # quals
            t = alphabet.seq_to_tokens(seq)[:read_len]
            row = np.zeros(read_len, np.int32)
            row[:len(t)] = t
            yield row, len(t)


def read_fastq(path: str | pathlib.Path, read_len: int
               ) -> tuple[np.ndarray, np.ndarray]:
    """FASTQ -> (tokens (R, read_len) padded/truncated, lengths (R,))."""
    toks, lens = [], []
    for row, n in iter_fastq(path, read_len):
        toks.append(row)
        lens.append(n)
    return (np.stack(toks) if toks else np.empty((0, read_len), np.int32),
            np.asarray(lens, np.int32))


def write_fastq(path: str | pathlib.Path, tokens: np.ndarray,
                lengths: np.ndarray) -> None:
    with open(path, "w") as f:
        for i, (t, l) in enumerate(zip(tokens, lengths)):
            seq = alphabet.tokens_to_seq(t[:l])
            f.write(f"@read_{i}\n{seq}\n+\n{'I' * int(l)}\n")
