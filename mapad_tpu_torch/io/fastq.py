"""Minimal FASTQ reader (plain or gzip) — replaces noodles-fastq subset."""

from __future__ import annotations

import gzip
from typing import Iterator, NamedTuple


class FastqRecord(NamedTuple):
    name: bytes
    sequence: bytes
    quality: bytes


def read_fastq(fileobj) -> Iterator[FastqRecord]:
    it = iter(fileobj)
    while True:
        try:
            header = next(it)
        except StopIteration:
            return
        header = header.rstrip(b"\r\n")
        if not header:
            continue
        if not header.startswith(b"@"):
            raise ValueError(f"FASTQ: expected '@', got {header[:20]!r}")
        try:
            seq = next(it).rstrip(b"\r\n")
            plus = next(it)
            qual = next(it).rstrip(b"\r\n")
        except StopIteration:
            raise ValueError("FASTQ: truncated record")
        if not plus.startswith(b"+"):
            raise ValueError("FASTQ: expected '+' separator")
        if len(seq) != len(qual):
            raise ValueError("FASTQ: sequence/quality length mismatch")
        name = header[1:].split(b" ", 1)[0].split(b"\t", 1)[0]
        yield FastqRecord(name, seq, qual)


def open_fastq(path: str):
    f = open(path, "rb")
    magic = f.read(2)
    f.seek(0)
    if magic == b"\x1f\x8b":
        return gzip.open(f, "rb")
    return f
