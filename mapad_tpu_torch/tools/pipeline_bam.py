"""An unaligned BAM as a sequencing pipeline hands it to mapAD.

mapAD's users map the unaligned BAM that comes out of base calling and
adapter trimming, not a clean FASTQ.  `make(path, genome, n, seed)` writes
one such BAM of `n` records from a seed with the port's `BamWriter`:

- merged reads, 35-120 bp (`assembly.make_reads`), flag 0x4;
- unmerged pairs as two records under one name (R1 0x4D, R2 0x8D), both
  mates MATE_LENGTHS long, so that the 150 bp ones are longer than the
  pool search's `max_len` (128);
- QC-failed reads (0x204);
- reads stored reverse-complemented under 0x10 (0x14), each a copy of a
  merged read stored forward elsewhere in the file under another name
  (its "twin", on the same side of the quality-less run), so that both
  must map alike;
- reads holding `=` and IUPAC codes beside an N;
- a few zero-length records;
- quality-less records (QUAL 0xFF on every base): a run of them
  (`qualityless=(start, length)`, placed by the caller to fill whole
  blocks) and a few scattered elsewhere (no twin among them);
- on every record the tags `RG:Z` (two read groups), `XI:Z` and `YI:Z`
  (index reads) and `FZ:B:S` (an array); on some records `NM:i`, `MD:Z`,
  `AS:i` and `XD:i` between them, which mapAD's output filters out.

The header has two `@RG` lines and an `@PG` line; every record has
`ref_id` and `pos` -1.  `make` returns a `Truth` with what the checks
need, and `check_output` holds a mapped BAM of this input to it:

    truth = make("reads.bam", genome, 524_288, seed=20)
    write_fastq_gz("merged.fastq.gz", truth)   # the merged reads alone
    counts = check_output(truth, "out.bam", read_group=None)
"""

from __future__ import annotations

import gzip
from dataclasses import dataclass, field

import numpy as np

from ..io.bam import BamReader, BamRecord, BamWriter, SamHeader
from ..map.postprocess import (
    FLAG_MATE_REVERSE,
    FLAG_MATE_UNMAPPED,
    FLAG_PROPERLY_SEGMENTED,
    FLAG_REVERSE,
    FLAG_SECONDARY,
    FLAG_SUPPLEMENTARY,
    FLAG_UNMAPPED,
    TAG_FILTER,
)
from ..utils.seq import revcomp
from .assembly import make_reads

# the record kinds
MERGED, R1, R2, QCFAIL, REVERSE, IUPAC, EMPTY = range(7)
KINDS = ("merged", "r1", "r2", "qcfail", "reverse", "iupac", "empty")
FLAGS = {MERGED: 0x4, R1: 0x4D, R2: 0x8D, QCFAIL: 0x204, REVERSE: 0x14,
         IUPAC: 0x4, EMPTY: 0x4}
# shares of the records (the pairs' counts both mates); the rest merged.
# A mix chosen to cover every kind of record, not one measured in a
# library: the share of unmerged pairs decides how much of a run the
# overlong mates take.
SHARES = dict(pairs=0.20, qcfail=0.02, reverse=0.03, iupac=0.01)
EMPTY_RECORDS = 4
MATE_LENGTHS = (76, 150)
SCATTERED = 6  # quality-less records outside the run
IUPAC_CODES = b"MRSVWYHKDB"
READ_GROUPS = ("lane1", "lane2")
POOL_MAX_LEN = 128  # the pool search's longest read (ops/search.py)
FILTERED_SHARE = 0.1  # records that carry NM, MD, AS and XD
# the output bits the mapping sets or clears whatever the input had
# (map/postprocess.py create_bam_record)
CLEARED = (FLAG_MATE_UNMAPPED | FLAG_MATE_REVERSE | FLAG_PROPERLY_SEGMENTED
           | FLAG_SECONDARY | FLAG_SUPPLEMENTARY)


@dataclass
class Truth:
    """What a pipeline BAM holds, record by record: its input flags and
    tags (in order), its kind, its forward twin's record index (-1: none),
    whether it is quality-less, and whether it is longer than
    POOL_MAX_LEN (overlong); with its sequence and qualities as stored."""

    header: SamHeader
    names: list
    flags: np.ndarray
    kinds: np.ndarray
    tags: list
    twin: np.ndarray
    qualityless: np.ndarray
    overlong: np.ndarray
    sequences: list = field(repr=False)
    qualities: list = field(repr=False)

    def __len__(self):
        return len(self.names)

    def counts(self) -> dict:
        """Records of each kind, quality-less, overlong, twins."""
        out = {k: int((self.kinds == i).sum()) for i, k in enumerate(KINDS)}
        out.update(records=len(self), qualityless=int(self.qualityless.sum()),
                   overlong=int(self.overlong.sum()),
                   twins=int((self.twin >= 0).sum()))
        return out


def header() -> SamHeader:
    return SamHeader(
        hd=[("VN", "1.6"), ("SO", "unsorted")],
        rg=[(g, [("SM", "sample1"), ("LB", f"lib{i + 1}"),
                 ("PL", "ILLUMINA")]) for i, g in enumerate(READ_GROUPS)],
        pg=[("bcl2bam", [("PN", "bcl2bam"), ("VN", "1.2")])])


def _pairs(genome, n_pairs, rng, starts):
    """n_pairs fragments of the genome, each read from both ends ->
    [(R1 (seq, quals), R2 (seq, quals))]; a fragment is longer than its
    mates and may come from either strand."""
    plain = np.zeros(256, dtype=bool)
    plain[np.frombuffer(b"ACGT", dtype=np.uint8)] = True
    acgt = np.frombuffer(b"ACGT", dtype=np.uint8)
    out = []
    for k in range(n_pairs):
        ln = int(rng.choice(MATE_LENGTHS))
        frag = ln + int(rng.integers(10, 250))
        hi = len(genome) - frag
        st = (int(rng.integers(0, hi)) if starts is None
              else min(int(starts[k]), hi))
        part = np.array(genome[st : st + frag])
        part[~plain[part]] = ord("N")
        err = rng.random(frag) < 0.002
        part[err] = acgt[rng.integers(0, 4, size=int(err.sum()))]
        seq = part.tobytes()
        if rng.random() < 0.5:
            seq = revcomp(seq)
        mates = (seq[:ln], revcomp(seq[-ln:]))
        out.append(tuple(
            (m, np.clip(rng.normal(34, 5, size=ln), 2, 41).astype(
                np.uint8).tobytes()) for m in mates))
    return out


def _tags(rng, filtered):
    """A record's tags in the order a pipeline writes them, the filtered
    ones (NM, MD, AS, XD) between the others where `filtered`."""
    index = [bytes(np.frombuffer(b"ACGT", dtype=np.uint8)[
        rng.integers(0, 4, size=8)]) for _ in range(2)]
    tags = [(b"RG", "Z", READ_GROUPS[int(rng.integers(0, 2))].encode())]
    if filtered:
        tags.append((b"NM", "i", int(rng.integers(0, 5))))
    tags.append((b"XI", "Z", index[0]))
    if filtered:
        tags.append((b"MD", "Z", b"12A30"))
    tags.append((b"YI", "Z", index[1]))
    if filtered:
        tags.append((b"AS", "i", int(rng.integers(0, 60))))
    tags.append((b"FZ", "B", ("S", [int(v) for v in
                                    rng.integers(0, 65535, size=4)])))
    if filtered:
        tags.append((b"XD", "i", int(rng.integers(0, 1000))))
    return tags


def make(path: str, genome, n: int, seed: int = 20, starts=None,
         qualityless=(16_384, 8_192), scattered: int = SCATTERED) -> Truth:
    """Write a pipeline BAM of `n` records of `genome` ((N,) uint8 ASCII)
    to `path` -> its Truth.  `starts`: where the reads begin (the merged
    reads' first, then the pairs'; `assembly.read_starts`), else at random.
    `qualityless`: (first record, records) of the quality-less run;
    `scattered`: quality-less records outside it."""
    rng = np.random.default_rng(seed)
    n_pairs = int(round(n * SHARES["pairs"] / 2))
    n_qc = int(round(n * SHARES["qcfail"]))
    n_rev = int(round(n * SHARES["reverse"]))
    n_iupac = int(round(n * SHARES["iupac"]))
    n_empty = min(EMPTY_RECORDS, n)
    n_merged = n - 2 * n_pairs - n_qc - n_rev - n_iupac - n_empty
    if n_merged < n_rev or n_merged < 0:
        raise ValueError(f"{n} records are too few for the shares {SHARES}")
    n_single = n_merged + n_qc + n_iupac
    singles = make_reads(genome, n_single, seed,
                         None if starts is None else starts[:n_single])
    pairs = _pairs(genome, n_pairs, rng,
                   None if starts is None else starts[n_single:])
    # units: (kind, payload); a pair is one unit of two records
    units = [(MERGED, r) for r in singles[:n_merged]]
    units += [(QCFAIL, r) for r in singles[n_merged : n_merged + n_qc]]
    for seq, q in singles[n_merged + n_qc :]:
        seq = bytearray(seq)
        at = rng.choice(len(seq), size=int(rng.integers(2, 5)),
                        replace=False)
        seq[at[0]], seq[at[1]] = ord("N"), ord("=")
        for a in at[2:]:
            seq[a] = IUPAC_CODES[int(rng.integers(0, len(IUPAC_CODES)))]
        units.append((IUPAC, (bytes(seq), q)))
    units += [(REVERSE, None)] * n_rev
    units += [(EMPTY, (b"", b""))] * n_empty
    units += [(R1, p) for p in pairs]
    names, kinds, seqs, quals = [], [], [], []
    for u in rng.permutation(len(units)):
        kind, payload = units[u]
        name = b"HX7:1:%d:%07d" % (1101 + u % 16, u)
        for k, (s, q) in (((R1, payload[0]), (R2, payload[1])) if kind == R1
                          else ((kind, payload or (b"", b"")),)):
            names.append(name)
            kinds.append(k)
            seqs.append(s)
            quals.append(q)
    kinds = np.array(kinds, dtype=np.uint8)
    qless = np.zeros(n, dtype=bool)
    lo, run = qualityless
    qless[lo : lo + run] = True
    # each reverse record copies a merged read on its side of the run, so
    # that twins share their qualities (or their lack of them)
    twin = np.full(n, -1, dtype=np.int64)
    for side in (qless, ~qless):
        rev = np.flatnonzero(side & (kinds == REVERSE))
        fwd = rng.choice(np.flatnonzero(side & (kinds == MERGED)),
                         size=rev.size, replace=False)
        twin[rev] = fwd
        for i, j in zip(rev, fwd):
            seqs[i], quals[i] = revcomp(seqs[j]), quals[j][::-1]
    is_twin = np.zeros(n, dtype=bool)
    is_twin[twin[twin >= 0]] = True
    outside = np.flatnonzero(~qless & (kinds != EMPTY) & (kinds != REVERSE)
                             & ~is_twin)
    qless[rng.choice(outside, size=min(scattered, outside.size),
                     replace=False)] = True
    qless &= kinds != EMPTY
    filtered = rng.random(n) < FILTERED_SHARE
    tags = [_tags(rng, bool(f)) for f in filtered]
    flags = np.array([FLAGS[k] for k in kinds], dtype=np.int64)
    hd = header()
    with open(path, "wb") as raw, BamWriter(raw, hd) as w:
        for i in range(n):
            w.write_record(BamRecord(
                name=names[i], flags=int(flags[i]), sequence=seqs[i],
                quals=b"" if qless[i] else quals[i], tags=tags[i]))
    lengths = np.array([len(s) for s in seqs], dtype=np.int64)
    return Truth(header=hd, names=names, flags=flags, kinds=kinds,
                 tags=tags, twin=twin, qualityless=qless,
                 overlong=lengths > POOL_MAX_LEN, sequences=seqs,
                 qualities=[b"\xff" * len(s) if ql else q
                            for s, q, ql in zip(seqs, quals, qless)])


def head(truth: Truth, src: str, dst: str, n: int) -> Truth:
    """The first `n` records of the pipeline BAM `src` (header and all)
    written to `dst` -> their Truth (twins past `n` dropped)."""
    with open(src, "rb") as f_in, open(dst, "wb") as f_out:
        reader = BamReader(f_in)
        with BamWriter(f_out, reader.header) as w:
            for _i, rec in zip(range(n), reader):
                w.write_record(rec)
    twin = truth.twin[:n].copy()
    twin[twin >= n] = -1
    return Truth(header=truth.header, names=truth.names[:n],
                 flags=truth.flags[:n], kinds=truth.kinds[:n],
                 tags=truth.tags[:n], twin=twin,
                 qualityless=truth.qualityless[:n],
                 overlong=truth.overlong[:n], sequences=truth.sequences[:n],
                 qualities=truth.qualities[:n])


def merged_records(truth: Truth) -> np.ndarray:
    """The merged reads that carry qualities (FASTQ has no quality-less
    record), in file order."""
    return np.flatnonzero((truth.kinds == MERGED) & ~truth.qualityless)


def write_fastq_gz(path: str, truth: Truth) -> int:
    """The merged reads of `truth` (`merged_records`) as a gzipped FASTQ
    -> their number."""
    keep = merged_records(truth)
    with gzip.open(path, "wb", compresslevel=6) as f:
        for i in keep:
            f.write(b"@" + truth.names[i] + b"\n" + truth.sequences[i]
                    + b"\n+\n" + bytes(q + 33 for q in truth.qualities[i])
                    + b"\n")
    return int(keep.size)


def expected_tags(tags, read_group=None):
    """The input tags a mapped record keeps, in order: those outside
    TAG_FILTER, RG dropped for `-R`'s, which comes after them."""
    out = [(t, c, v) for t, c, v in tags
           if t not in TAG_FILTER and not (t == b"RG" and read_group)]
    if read_group:
        out.append((b"RG", "Z", read_group.encode()))
    return out


def check_output(truth: Truth, path: str, read_group=None) -> dict:
    """Hold the BAM at `path` (the mapping of truth's records, in input
    order) to the input, independently of any engine: every record keeps
    its name, its input flags less CLEARED with 0x4 set where unmapped and
    0x10 where mapped to the reverse strand, its input tags less
    TAG_FILTER in order (`read_group`: the `-R` ID, whose RG comes last),
    followed by the mapping's own; a quality-less record's QUAL is 0xFF
    on every base; a 0x10 record maps as its forward twin does (mapped or
    not, AS; where both have one best place, X0 1, the place, strand,
    CIGAR, MD, NM, SEQ and QUAL).  Raises AssertionError -> counts:
    mapped, twins compared (and by place), quality-less, overlong
    mapped."""
    with open(path, "rb") as f:
        recs = list(BamReader(f))
    if len(recs) != len(truth):
        raise AssertionError(f"{path}: {len(recs)} records, not "
                             f"{len(truth)}")
    generated = {b"AS", b"NM", b"MD", b"XA", b"X0", b"X1", b"XS", b"XT",
                 b"XD"}
    bad = []
    for i, r in enumerate(recs):
        mapped = r.pos >= 0
        want_flags = ((int(truth.flags[i]) & ~CLEARED
                       & ~(FLAG_UNMAPPED | FLAG_REVERSE))
                      | (0 if mapped else FLAG_UNMAPPED)
                      | (r.flags & FLAG_REVERSE if mapped else 0))
        keep = expected_tags(truth.tags[i], read_group)
        tags = [(bytes(t), c, v) for t, c, v in r.tags]
        ok = (r.name == truth.names[i] and r.flags == want_flags
              and tags[: len(keep)] == keep
              and all(t in generated for t, _c, _v in tags[len(keep):])
              and mapped == (r.tag("MD") is not None))
        if truth.qualityless[i]:
            ok = ok and r.quals == b"\xff" * len(r.sequence)
        if not ok:
            bad.append((i, r.name, r.flags, want_flags, tags, keep))
    if bad:
        raise AssertionError(f"{path}: {len(bad)} records differ from "
                             f"their input, the first {bad[:3]}")
    compared = placed = 0
    for i in np.flatnonzero(truth.twin >= 0):
        a, b = recs[i], recs[int(truth.twin[i])]
        same = a.flags & 0x4 == b.flags & 0x4 and a.tag("AS") == b.tag("AS")
        # the place is drawn from the best interval (seeded by the record's
        # index), and X0 counts its positions from the first one drawn that
        # lies within a sequence: where both have one best place left it is
        # the same
        if same and a.tag("X0") == b.tag("X0") == 1:
            same = ((a.flags & 0x14, a.ref_id, a.pos, a.cigar, a.sequence,
                     a.quals) == (b.flags & 0x14, b.ref_id, b.pos, b.cigar,
                                  b.sequence, b.quals)
                    and all(a.tag(t) == b.tag(t) for t in ("MD", "NM")))
            placed += 1
        if not same:
            raise AssertionError(
                f"{path}: record {i} ({a.name}, 0x10 in the input) maps "
                f"unlike its forward twin {int(truth.twin[i])} ({b.name}): "
                f"{a.flags, a.ref_id, a.pos, a.cigar_string(), a.tags} "
                f"against {b.flags, b.ref_id, b.pos, b.cigar_string(), b.tags}")
        compared += 1
    mapped = np.array([r.pos >= 0 for r in recs])
    return dict(records=len(recs), mapped=int(mapped.sum()),
                twins=compared, twins_placed=placed,
                qualityless=int(truth.qualityless.sum()),
                qualityless_mapped=int((mapped & truth.qualityless).sum()),
                overlong_mapped=int((mapped & truth.overlong).sum()))
