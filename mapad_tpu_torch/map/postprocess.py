"""Hit postprocessing: coordinates, MAPQ, alternative alignments, BAM records.

Counterpart of reference src/map/mapping.rs:300-927 (create_bam_header,
intervals_to_bam, interval2coordinate, estimate_mapping_quality,
create_bam_record).

RNG policy: the reference seeds PrRange from a per-thread OS RNG, making
multi-mapper reported positions nondeterministic for interval sizes > 2.
Here the RNG is injected; the pipeline seeds it deterministically per read
(seed, chunk_id, read index) so runs are reproducible.
"""

from __future__ import annotations

import sys
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np

from .. import CRATE_NAME, build_info_version
from ..io.bam import BamRecord, SamHeader
from ..utils.f32 import mul_add
from ..utils.seq import revcomp
from . import HitInterval
from .prrange import PrRange
from .record import effective_len, read_len, to_bam_fields

MAX_MAPQ = 37
MIN_MAPQ_UNIQ = 20

# BAM flag bits
FLAG_PAIRED = 0x1
FLAG_PROPERLY_SEGMENTED = 0x2
FLAG_UNMAPPED = 0x4
FLAG_MATE_UNMAPPED = 0x8
FLAG_REVERSE = 0x10
FLAG_MATE_REVERSE = 0x20
FLAG_SECONDARY = 0x100
FLAG_SUPPLEMENTARY = 0x800

# BWA/mapAD-specific aux tags stripped from the input (mapping.rs:834-837)
TAG_FILTER = {
    b"AS", b"MD", b"NM", b"X0", b"X1", b"XA", b"XD", b"XE", b"XF", b"XG",
    b"XM", b"XN", b"XO", b"XS", b"XT",
}


class SplitMixRng:
    """Deterministic 64-bit splitmix RNG used to seed PrRange per read."""

    def __init__(self, seed: int):
        self.state = seed & 0xFFFFFFFFFFFFFFFF

    def next_u64(self) -> int:
        self.state = (self.state + 0x9E3779B97F4A7C15) & 0xFFFFFFFFFFFFFFFF
        z = self.state
        z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & 0xFFFFFFFFFFFFFFFF
        z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & 0xFFFFFFFFFFFFFFFF
        return z ^ (z >> 31)

    def next_u32(self) -> int:
        return self.next_u64() & 0xFFFFFFFF


class IntToCoordOutput(NamedTuple):
    tid: int
    contig_name: str
    relative_pos: int
    absolute_pos: int
    forward: bool
    num_skipped: int
    hit: HitInterval


@dataclass
class AlternativeAlignments:
    x0: int
    x1: int
    xa: str
    xs: np.float32
    xt: str


def interval_cross_check(a, b) -> bool:
    """Duplicate-interval filter (mapping.rs:651-653)."""
    return a.size == b.size and (a.lower == b.lower or a.lower_rev == b.lower_rev)


def interval2coordinate(hit: HitInterval, suffix_array, id_pos_map, rng):
    """Lazily yields valid reference coordinates of a hit in pseudo-random
    order (mapping.rs:590-649)."""
    strand_len = len(suffix_array) // 2
    eff_len = effective_len(hit.edit_operations)
    seed = rng.next_u32()
    pr = PrRange.try_new(
        hit.interval.lower, hit.interval.lower + hit.interval.size, seed
    )
    if pr is None:
        return
    for i, sar_pos in enumerate(pr):
        absolute_pos = suffix_array.get(sar_pos)
        if absolute_pos is None:
            continue
        if absolute_pos < strand_len:
            forward = True
        else:
            absolute_pos = len(suffix_array) - absolute_pos - eff_len - 1
            forward = False
        located = id_pos_map.get_reference_identifier(absolute_pos, eff_len)
        if located is None:
            continue
        tid, rel_pos, contig_name = located
        yield IntToCoordOutput(tid, contig_name, rel_pos, absolute_pos, forward, i, hit)


def estimate_mapping_quality(
    best_alignment, best_alignment_interval_size, other_alignments, alignment_parameters
) -> int:
    """MAPQ (mapping.rs:655-718)."""
    # exp2/log10 are computed in float64 and rounded once to f32 (i.e. the
    # correctly-rounded f32 function) so the native C++ postprocess path
    # produces bit-identical MAPQ values.
    prob_best = np.float32(np.exp2(np.float64(best_alignment.alignment_score)))
    if best_alignment_interval_size > 1:
        alignment_probability = np.float32(1.0) / np.float32(
            best_alignment_interval_size
        )
    else:
        weighted = np.float32(0.0)
        for sub in other_alignments:
            if interval_cross_check(best_alignment.interval, sub.interval):
                continue
            weighted = mul_add(
                np.float32(np.exp2(np.float64(sub.alignment_score))),
                np.float32(sub.interval.size),
                weighted,
            )
        alignment_probability = np.float32(prob_best / np.float32(prob_best + weighted))
    alignment_probability = np.float32(np.clip(alignment_probability, 0.0, 1.0))

    with np.errstate(divide="ignore"):  # p == 1 -> -inf -> clamped to MAX_MAPQ
        raw = np.float32(
            np.float32(-10.0)
            * np.float32(
                np.log10(np.float64(np.float32(1.0) - alignment_probability))
            )
        )
    mapping_quality = _round_u8(np.minimum(raw, np.float32(MAX_MAPQ)))

    if mapping_quality == MAX_MAPQ:
        remaining = alignment_parameters.mismatch_bound.remaining_frac_of_repr_mm(
            best_alignment.alignment_score, read_len(best_alignment.edit_operations)
        )
        scaled = mul_add(
            np.float32(MAX_MAPQ - MIN_MAPQ_UNIQ),
            np.minimum(remaining, np.float32(1.0)),
            np.float32(MIN_MAPQ_UNIQ),
        )
        return _round_u8(scaled)
    return mapping_quality


def _round_u8(x) -> int:
    """Rust `f32::round() as u8`: half away from zero, saturating to [0, 255]."""
    x = float(x)
    if np.isnan(x):
        return 0
    r = np.floor(x + 0.5) if x >= 0 else np.ceil(x - 0.5)
    return int(np.clip(r, 0, 255))


def _format_cigar(cigar) -> str:
    return "".join(f"{n}{op}" for n, op in cigar)


def intervals_to_bam(
    input_record,
    intervals,
    suffix_array,
    id_pos_map,
    original_symbols,
    duration,
    alignment_parameters,
    read_group,
    rng,
) -> BamRecord:
    """Convert a read's hit set to one BAM record (mapping.rs:402-567)."""
    hits_found = bool(intervals)
    # BinaryHeap::into_sorted_vec: ascending by score; equal scores end up in
    # reverse insertion order (verified for 2-element heaps), so the final
    # .pop() reports the FIRST-completed hit among ties.
    order = {id(h): i for i, h in enumerate(intervals)}
    intervals = sorted(
        intervals, key=lambda h: (float(h.alignment_score), -order[id(h)])
    )

    while intervals:
        best_alignment = intervals.pop()
        i2co_iter = interval2coordinate(
            best_alignment, suffix_array, id_pos_map, rng
        )
        best_i2co = next(i2co_iter, None)
        if best_i2co is None:
            continue  # all positions overlap contig boundaries: next-best hit

        updated_size = best_alignment.interval.size - best_i2co.num_skipped

        # Alternative hits: best's remaining positions, then suboptimal
        # alignments in descending score order (mapping.rs:434-491)
        def xa_entries():
            yield from i2co_iter
            for sub in reversed(intervals):
                if interval_cross_check(best_alignment.interval, sub.interval):
                    continue
                yield from interval2coordinate(sub, suffix_array, id_pos_map, rng)

        xa_parts = []
        for i2co in xa_entries():
            if len(xa_parts) >= 2:
                break
            cigar, md, nm = to_bam_fields(
                i2co.hit.edit_operations, i2co.forward, i2co.absolute_pos,
                original_symbols,
            )
            xa_parts.append(
                "{},{}{},{},{},{},{},{:.2f};".format(
                    i2co.contig_name,
                    "+" if i2co.forward else "-",
                    i2co.relative_pos + 1,
                    _format_cigar(cigar),
                    md.decode("ascii"),
                    nm,
                    i2co.hit.interval.size,
                    float(i2co.hit.alignment_score),
                )
            )

        x1 = sum(
            sub.interval.size
            for sub in intervals
            if not interval_cross_check(best_alignment.interval, sub.interval)
        )
        alternative_hits = AlternativeAlignments(
            x0=min(updated_size, 2**31 - 1),
            x1=min(x1, 2**31 - 1),
            xa="".join(xa_parts),
            xs=(
                intervals[-1].alignment_score if intervals else np.float32(0.0)
            ),
            xt="N" if updated_size == 0 else ("U" if updated_size == 1 else "R"),
        )

        mapq = estimate_mapping_quality(
            best_alignment, updated_size, intervals, alignment_parameters
        )
        return create_bam_record(
            input_record,
            relative_position=best_i2co.relative_pos,
            absolute_position=best_i2co.absolute_pos,
            hit_interval=best_alignment,
            mapq=mapq,
            tid=best_i2co.tid,
            forward=best_i2co.forward,
            duration=duration,
            alternative_hits=alternative_hits,
            original_symbols=original_symbols,
            read_group=read_group,
        )

    # No valid coordinate found: unmapped record
    return create_bam_record(
        input_record,
        relative_position=None,
        absolute_position=None,
        hit_interval=None,
        mapq=0,
        tid=None,
        forward=None,
        duration=duration,
        alternative_hits=None,
        original_symbols=original_symbols,
        read_group=read_group,
    )


def create_bam_record(
    input_record,
    relative_position,
    absolute_position,
    hit_interval,
    mapq,
    tid,
    forward,
    duration,
    alternative_hits,
    original_symbols,
    read_group,
) -> BamRecord:
    """mapping.rs:720-927."""
    cigar, md_tag, edit_distance = (None, None, None)
    if hit_interval is not None:
        cigar, md_tag, edit_distance = to_bam_fields(
            hit_interval.edit_operations, forward, absolute_position, original_symbols
        )

    flags = input_record.bam_flags
    # Remove flags mapAD does not know about (mapping.rs:750-755)
    flags &= ~(
        FLAG_MATE_UNMAPPED
        | FLAG_MATE_REVERSE
        | FLAG_PROPERLY_SEGMENTED
        | FLAG_SECONDARY
        | FLAG_SUPPLEMENTARY
    )

    pos = -1
    if relative_position is not None:
        flags &= ~FLAG_UNMAPPED
        pos = int(relative_position)
    else:
        flags |= FLAG_UNMAPPED
        flags &= ~(FLAG_REVERSE | FLAG_PROPERLY_SEGMENTED)

    if forward is False:
        flags |= FLAG_REVERSE
    else:
        flags &= ~FLAG_REVERSE

    if forward is False:
        sequence = revcomp(input_record.sequence)
        quals = bytes(input_record.base_qualities)[::-1]
    else:
        sequence = bytes(input_record.sequence)
        quals = bytes(input_record.base_qualities)

    tags = []
    for tag, type_char, value in input_record.bam_tags:
        if bytes(tag) in TAG_FILTER:
            continue
        if bytes(tag) == b"RG" and read_group is not None:
            continue
        tags.append((bytes(tag), type_char, value))

    if read_group is not None:
        rg_id = read_group[0] if isinstance(read_group, tuple) else read_group
        tags.append((b"RG", "Z", rg_id if isinstance(rg_id, bytes) else str(rg_id).encode()))

    if hit_interval is not None:
        tags.append((b"AS", "f", float(hit_interval.alignment_score)))
    if edit_distance is not None:
        tags.append((b"NM", "i", int(edit_distance)))
    if md_tag is not None:
        tags.append((b"MD", "Z", md_tag))

    if alternative_hits is not None:
        if alternative_hits.xa:
            tags.append((b"XA", "Z", alternative_hits.xa.encode()))
        tags.append((b"X0", "i", alternative_hits.x0))
        tags.append((b"X1", "i", alternative_hits.x1))
        if alternative_hits.x1 > 0:
            tags.append((b"XS", "f", float(alternative_hits.xs)))
        tags.append((b"XT", "A", ord(alternative_hits.xt)))

    if duration is not None:
        tags.append((b"XD", "f", float(duration)))

    return BamRecord(
        name=input_record.name,
        flags=flags,
        ref_id=tid if tid is not None else -1,
        pos=pos,
        mapq=mapq if mapq is not None else 255,
        cigar=cigar or [],
        sequence=sequence,
        quals=quals,
        tags=tags,
    )


def create_bam_header(
    src_header: SamHeader | None, id_pos_map, read_group=None, cmdline: str | None = None
) -> SamHeader:
    """mapping.rs:298-398: @HD SO:unsorted, @PG chain copy with unique ID,
    @CO / @RG passthrough (or override), @SQ from the contig map."""
    header = SamHeader()
    header.hd = [("VN", "1.6"), ("SO", "unsorted")]

    program_id = CRATE_NAME
    if src_header is not None:
        header.pg = [(pg_id, list(fields)) for pg_id, fields in src_header.pg]
        count = sum(
            1
            for pg_id, _ in src_header.pg
            if pg_id == program_id or pg_id.startswith(program_id + ".")
        )
        if count > 0:
            program_id = f"{program_id}.{count}"
        header.co = list(src_header.co)
        if read_group is not None:
            rg_id, rg_fields = read_group
            header.rg = [(rg_id, list(rg_fields))]
        else:
            header.rg = [(rg_id, list(fields)) for rg_id, fields in src_header.rg]
    elif read_group is not None:
        rg_id, rg_fields = read_group
        header.rg = [(rg_id, list(rg_fields))]

    for contig in id_pos_map:
        header.sq.append((contig.identifier, contig.end - contig.start + 1, []))

    if cmdline is None:
        cmdline = " ".join(sys.argv)
    header.pg.append(
        (
            program_id,
            [
                ("PN", CRATE_NAME),
                ("VN", build_info_version()),
                (
                    "DS",
                    "An aDNA aware short-read mapper (TPU-native implementation)",
                ),
                ("CL", cmdline),
            ],
        )
    )
    return header
