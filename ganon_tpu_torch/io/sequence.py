"""FASTA/FASTQ streaming with gzip/bzip2 support and fixed-size batching.

Host-side analogue of the reference's reader thread
(``GanonClassify.cpp:1220-1287``): yields id/sequence batches of
``n_reads`` to feed the device pipeline. Record ids are the full header
line after ``>``/``@`` (seqan3 field::id semantics).
"""

from __future__ import annotations

import bz2
import gzip
import io
import os
from dataclasses import dataclass, field


def xopen(path: str, mode: str = "rt"):
    """Open plain, gzip, bzip2 or xz files by magic bytes."""
    with open(path, "rb") as probe:
        magic = probe.read(6)
    if magic[:2] == b"\x1f\x8b":
        return gzip.open(path, mode)
    if magic[:3] == b"BZh":
        return bz2.open(path, mode)
    if magic == b"\xfd7zXZ\x00":
        import lzma

        return lzma.open(path, mode)
    return open(path, mode)


def _detect_format(fh) -> str:
    pos = fh.tell()
    first = fh.read(1)
    fh.seek(pos)
    if first == ">":
        return "fasta"
    if first == "@":
        return "fastq"
    raise ValueError("unrecognized sequence file format (expected fasta/fastq)")


class SequenceReader:
    """Iterate (id, seq) records from a fasta/fastq file (gz/bz2 ok)."""

    def __init__(self, path: str):
        self.path = path
        self._fh = xopen(path, "rt")
        self.format = _detect_format(self._fh)

    def __iter__(self):
        if self.format == "fasta":
            return self._iter_fasta()
        return self._iter_fastq()

    def _iter_fasta(self):
        header = None
        chunks: list[str] = []
        for line in self._fh:
            line = line.rstrip("\n").rstrip("\r")
            if line.startswith(">"):
                if header is not None:
                    yield header, "".join(chunks)
                header = line[1:]
                chunks = []
            elif line:
                chunks.append(line)
        if header is not None:
            yield header, "".join(chunks)
        self._fh.close()

    def _iter_fastq(self):
        fh = self._fh
        while True:
            h = fh.readline()
            if not h:
                break
            seq = fh.readline().rstrip("\n").rstrip("\r")
            fh.readline()  # +
            fh.readline()  # qual
            yield h[1:].rstrip("\n").rstrip("\r"), seq
        fh.close()


@dataclass
class ReadBatch:
    """One batch of reads (optionally paired) with a read-prefix label."""

    prefix: str = ""
    paired: bool = False
    ids: list = field(default_factory=list)
    seqs: list = field(default_factory=list)
    seqs2: list = field(default_factory=list)

    def __len__(self):
        return len(self.ids)


def read_batches(file1: str, file2: str | None, prefix: str, n_reads: int):
    """Yield ReadBatch of up to ``n_reads`` from one file (pair)."""
    r1 = iter(SequenceReader(file1))
    r2 = iter(SequenceReader(file2)) if file2 else None
    paired = r2 is not None
    while True:
        batch = ReadBatch(prefix=prefix, paired=paired)
        for _ in range(n_reads):
            try:
                rid, seq = next(r1)
            except StopIteration:
                break
            batch.ids.append(rid)
            batch.seqs.append(seq)
            if paired:
                try:
                    _, seq2 = next(r2)
                except StopIteration:
                    seq2 = ""
                batch.seqs2.append(seq2)
        if not batch.ids:
            return
        yield batch
        if len(batch.ids) < n_reads:
            return
