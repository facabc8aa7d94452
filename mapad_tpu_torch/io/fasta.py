"""Minimal FASTA reader (replaces the used subset of noodles-fasta)."""

from __future__ import annotations

import gzip
from typing import Iterator, NamedTuple


class FastaRecord(NamedTuple):
    name: str
    sequence: bytes


def _open(path: str):
    f = open(path, "rb")
    magic = f.read(2)
    f.seek(0)
    if magic == b"\x1f\x8b":
        return gzip.open(f, "rb")
    return f


def read_fasta(path: str) -> Iterator[FastaRecord]:
    name = None
    chunks: list[bytes] = []
    with _open(path) as f:
        for raw in f:
            line = raw.rstrip(b"\r\n")
            if line.startswith(b">"):
                if name is not None:
                    yield FastaRecord(name, b"".join(chunks))
                # name = first whitespace-delimited token after '>'
                name = line[1:].split(None, 1)[0].decode("utf-8", "replace") if len(line) > 1 else ""
                chunks = []
            elif line:
                if name is None:
                    raise ValueError("FASTA: sequence data before first header")
                chunks.append(line)
        if name is not None:
            yield FastaRecord(name, b"".join(chunks))
