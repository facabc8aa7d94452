"""Input format sniffing and the chunked task queue.

Counterpart of reference src/map/input_chunk_reader.rs: magic-byte detection
(CRAM / gzip->{BAM, fastq.gz} / FASTQ) over file or stdin, and `task_queue`
yielding TaskSheets of at most chunk_size records, skipping malformed records
with an error log.
"""

from __future__ import annotations

import gzip
import io
import logging
import sys
from dataclasses import dataclass

from ..errors import InvalidInputType
from ..map.record import Record
from .bam import BamReader
from .fastq import read_fastq

logger = logging.getLogger(__name__)


@dataclass
class TaskSheet:
    """Chunk of reads (input_chunk_reader.rs:246-253)."""

    chunk_id: int
    records: list
    reference_path: str | None = None
    alignment_parameters: object | None = None


class InputSource:
    """Sniffs the input format and exposes records + an optional header.

    Internally iterates RAW reader records (FastqRecord / BamRecord-like)
    and converts to map.Record lazily per task chunk: multihost sharding
    skips non-owned chunks without paying conversion cost, while chunk
    boundaries still count exactly the records the reference would accept
    (validity is checked in-stream, input_chunk_reader.rs:196-216)."""

    def __init__(self, kind: str, records_iter, header=None):
        self.kind = kind  # "bam" | "cram" | "fastq" | "fastq.gz"
        self._records = records_iter
        self.header = header
        self._is_fastq = kind in ("fastq", "fastq.gz")

    def validate(self, raw) -> bool:
        """Cheap in-stream validity check; logs and rejects like the
        reference's per-record skip."""
        from ..map.record import MAX_READ_LENGTH

        if len(raw.sequence) > MAX_READ_LENGTH:
            logger.error(
                "Skip invalid record: read %s is longer than %d",
                getattr(raw, "name", b"?"), MAX_READ_LENGTH,
            )
            return False
        if self._is_fastq and len(raw.quality) and min(raw.quality) < 33:
            logger.error(
                "Skip invalid record: %s has base quality below '!'",
                raw.name,
            )
            return False
        return True

    def convert(self, raw):
        if self._is_fastq:
            return Record.from_fastq(raw.name, raw.sequence, raw.quality)
        return Record.from_bam(
            raw.name, raw.flags, raw.sequence, raw.quals, raw.tags
        )

    @classmethod
    def from_path(cls, path: str):
        if path == "-":
            data = sys.stdin.buffer.read()
            return cls._from_bytes(data)
        f = open(path, "rb")
        magic = f.read(4)
        f.seek(0)
        return cls._sniff(f, magic)

    @classmethod
    def _from_bytes(cls, data: bytes):
        return cls._sniff(io.BytesIO(data), data[:4])

    @classmethod
    def _sniff(cls, f, magic: bytes):
        if magic[:4] == b"CRAM":
            raise InvalidInputType(
                "CRAM input is not yet in mapad_tpu_torch (later slice); "
                "convert to BAM or FASTQ"
            )
        if magic[:2] == b"\x1f\x8b":
            # gzip container: BAM (BGZF) or fastq.gz
            # Peek decompressed start
            pos = f.tell()
            with gzip.open(f, "rb") as gz:
                inner = gz.read(4)
            f.seek(pos)
            if inner[:4] == b"BAM\x01":
                reader = BamReader(f)
                return cls("bam", cls._bam_records(reader), header=reader.header)
            return cls("fastq.gz", cls._fastq_records(gzip.open(f, "rb")))
        if magic[:1] in (b"@", b">"):
            if magic[:1] == b">":
                raise InvalidInputType("FASTA reads input is not supported")
            return cls("fastq", cls._fastq_records(f))
        raise InvalidInputType("Could not detect input file format")

    @staticmethod
    def _fastq_records(f):
        return read_fastq(f)

    @staticmethod
    def _bam_records(reader):
        return iter(reader)

    def task_queue(self, chunk_size: int):
        return TaskQueue(
            self._records, chunk_size, self.validate, self.convert
        )


class TaskQueue:
    """Yields TaskSheets of <= chunk_size records; supports re-queueing
    failed distributed chunks (input_chunk_reader.rs:178-243)."""

    def __init__(self, records_iter, chunk_size: int, validate=None,
                 convert=None):
        self._records = records_iter
        self._chunk_size = chunk_size
        self._validate = validate or (lambda r: True)
        self._convert = convert or (lambda r: r)
        self._chunk_id = -1
        self._requeried: list[TaskSheet] = []

    def requery_task(self, task: TaskSheet):
        self._requeried.append(task)

    def __iter__(self):
        return self

    @property
    def next_chunk_id(self) -> int:
        return self._chunk_id + 1

    def _pull_raw(self):
        chunk = []
        for rec in self._records:
            if not self._validate(rec):
                continue
            chunk.append(rec)
            if len(chunk) >= self._chunk_size:
                break
        return chunk

    def skip_chunk(self) -> bool:
        """Consume one chunk's worth of records without converting them
        (multihost: non-owned chunks).  Returns False when exhausted."""
        if self._requeried:
            return True  # requeried sheets are never skipped
        chunk = self._pull_raw()
        if not chunk:
            return False
        self._chunk_id += 1
        return True

    def __next__(self) -> TaskSheet:
        if self._requeried:
            return self._requeried.pop()
        chunk = self._pull_raw()
        if not chunk:
            raise StopIteration
        self._chunk_id += 1
        records = []
        for rec in chunk:
            try:
                records.append(self._convert(rec))
            except Exception as e:  # conversion failure: skip with log
                logger.error("Skip invalid record: %s", e)
        return TaskSheet(self._chunk_id, records)
