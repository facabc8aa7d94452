"""Read record model and BAM-field generation (CIGAR/MD/NM).

Counterpart of reference src/map/record.rs.  `to_bam_fields` re-substitutes
`OriginalSymbols` so positions whose ambiguous reference bases were randomly
replaced at indexing time emit the true (original) base in the MD tag
(record.rs:302-321), and complements reference bases on the reverse strand.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..errors import SeqLenError
from ..utils.seq import COMPLEMENT_TABLE, revcomp
from . import OP_DELETION, OP_INSERTION, OP_MATCH, OP_MISMATCH, EditOperation

CIGAR_MATCH = "M"
CIGAR_INS = "I"
CIGAR_DEL = "D"

_KIND_TO_CIGAR = {
    OP_MATCH: CIGAR_MATCH,
    OP_MISMATCH: CIGAR_MATCH,
    OP_INSERTION: CIGAR_INS,
    OP_DELETION: CIGAR_DEL,
}

MAX_READ_LENGTH = 32767  # i16::MAX (record.rs:144-150)


@dataclass
class Record:
    """Input read (record.rs:129-136)."""

    sequence: bytes
    base_qualities: bytes
    name: bytes | None = None
    bam_tags: list = field(default_factory=list)  # [( b"XY", (type_char, value) )]
    bam_flags: int = 0

    @classmethod
    def from_fastq(cls, name: bytes, sequence: bytes, quality: bytes) -> "Record":
        if len(sequence) > MAX_READ_LENGTH:
            raise SeqLenError(name.decode("utf-8", "replace"))
        return cls(
            sequence=sequence.upper(),
            base_qualities=bytes(q - 33 for q in quality),
            name=name,
            bam_tags=[],
            bam_flags=0,
        )

    @classmethod
    def from_bam(cls, name, flags, sequence, quality, tags) -> "Record":
        """BAM/CRAM input conversion (record.rs:138-184): un-reverse-complement
        reads flagged as mapped to the reverse strand."""
        if len(sequence) > MAX_READ_LENGTH:
            raise SeqLenError(
                name.decode("utf-8", "replace") if name else "unnamed record"
            )
        sequence = bytes(sequence)
        quality = bytes(quality)
        if flags & 0x10:  # REVERSE_COMPLEMENTED
            sequence = revcomp(sequence)
            quality = quality[::-1]
        return cls(
            sequence=sequence,
            base_qualities=quality,
            name=name,
            bam_tags=list(tags),
            bam_flags=flags,
        )

    def __str__(self):
        return (self.name or b"*").decode("utf-8", "replace")


def effective_len(ops) -> int:
    """Genome positions covered by the read (record.rs:267-278)."""
    return sum(1 for op in ops if op.kind != OP_INSERTION)


def read_len(ops) -> int:
    """Read bases consumed (record.rs:440-449)."""
    return sum(1 for op in ops if op.kind != OP_DELETION)


def _comp_if_necessary(base: int, forward: bool) -> int:
    return base if forward else int(COMPLEMENT_TABLE[base])


def to_bam_fields(ops, forward: bool, absolute_pos: int, original_symbols):
    """-> (cigar [(count, 'M'|'I'|'D')], md bytes, nm int).

    Exact port of record.rs:282-438 including original-symbol
    re-substitution indexed by output-track offset.
    """
    num_matches = 0
    num_operations = 1
    edit_distance = 0
    last_kind = None  # CIGAR class of the current run's first op
    cigar: list[tuple[int, str]] = []
    md_parts: list[str] = []

    track = ops if forward else list(reversed(ops))
    no_orig = len(original_symbols) == 0

    def md_add(op, last_op_kind):
        nonlocal num_matches
        if op is None:
            md_parts.append(str(num_matches))
            return
        kind = op.kind
        if kind == OP_MATCH:
            num_matches += 1
        elif kind == OP_MISMATCH:
            base = _comp_if_necessary(op.base, forward)
            md_parts.append(f"{num_matches}{chr(base)}")
            num_matches = 0
        elif kind == OP_DELETION:
            base = _comp_if_necessary(op.base, forward)
            if last_op_kind == OP_DELETION:
                md_parts.append(chr(base))
            else:
                md_parts.append(f"{num_matches}^{chr(base)}")
            num_matches = 0
        # insertions are ignored in MD tags

    for i, op in enumerate(track):
        # Re-substitute original symbols (record.rs:302-321)
        if no_orig:
            pass
        elif op.kind == OP_MATCH:
            orig = original_symbols.get(absolute_pos + i)
            if orig is not None:
                op = EditOperation(OP_MISMATCH, op.pos, orig)
        elif op.kind == OP_DELETION:
            orig = original_symbols.get(absolute_pos + i)
            if orig is not None:
                op = EditOperation(OP_DELETION, op.pos, orig)
        elif op.kind == OP_MISMATCH:
            orig = original_symbols.get(absolute_pos + i)
            if orig is not None:
                op = EditOperation(OP_MISMATCH, op.pos, orig)

        if op.kind != OP_MATCH:
            edit_distance += 1

        md_add(op, last_kind)

        if last_kind is not None:
            same_class = _KIND_TO_CIGAR[op.kind] == _KIND_TO_CIGAR[last_kind]
            if same_class:
                num_operations += 1
            else:
                cigar.append((num_operations, _KIND_TO_CIGAR[last_kind]))
                num_operations = 1
                last_kind = op.kind
        else:
            last_kind = op.kind

    if last_kind is not None:
        cigar.append((num_operations, _KIND_TO_CIGAR[last_kind]))
    md_add(None, None)

    return cigar, "".join(md_parts).encode("ascii"), edit_distance


def cigar_to_string(cigar) -> str:
    return "".join(f"{count}{kind}" for count, kind in cigar)
