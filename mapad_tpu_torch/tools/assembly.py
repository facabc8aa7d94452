"""A reference shaped like GRCh37 / hs37d5, made from a seed, and its reads.

mapAD's users map ancient DNA to hg19; hs37d5 (the 1000 Genomes build of
GRCh37) holds 86 sequences: chromosomes 1-22, X, Y and MT, 59 unplaced GL
scaffolds, NC_007605 and the hs37d5 decoy.  `layout(scale, seed)` gives
those 86 sequences in hs37d5's order and GRCh37's published lengths, times
`scale`, and GRCh37's gap layout on each chromosome:

  - 10,000 bp N telomere runs at both ends;
  - one pericentromeric N run of 3-21 Mbp;
  - 50,000 bp clone gaps about every 5 Mbp;
  - short IUPAC runs of 1-19 bp (R, Y, K, M, S, W, N) about every 1 Mbp.

Chromosomes 1-5 keep their lengths (1,062,541,960 bp in all); 6-22, X and
Y are cut to 1/1000 of theirs (CUT), so that the whole assembly is about
1.107e9 bp, a text of about 2.21e9 symbols (past 2^31), and its index
builds within one run.  The GL scaffolds carry a few short runs, the decoy
short runs at the chromosomes' density, MT and NC_007605 none.

At `scale < 1` every length and spacing shrinks by the same factor; the
sequence count and the run structure stay: a long run keeps at least
MIN_LONG bp (so that the index builder still makes it X), a short run its
1-19 bp, a sequence at least MIN_SEQ bp, and a run that would touch one
placed before it is left out (on the shortest sequences at small scales).

`genome(lay, seed)` fills the layout: the bases from `gen_genome`'s
repeat-rich generator, the runs written over them.  `read_starts` places
reads: most at random where no long run is near, READ_EDGE_SHARE of them
at the edges the genome holds (long N runs' edges, short runs, sequence
joins), so that those are really hit; `make_reads` draws bench.py's
damaged reads at those starts (any base outside ACGT written as N).
`make` writes the FASTA and the reads' FASTQ; `check_records` holds a
BAM's mapped records to the invariants of such a reference.
"""

from __future__ import annotations

import os
import re
from typing import NamedTuple

import numpy as np

# GRCh37's chromosome lengths (Genome Reference Consortium, GRCh37.p13)
CHROMOSOMES = (
    ("1", 249_250_621), ("2", 243_199_373), ("3", 198_022_430),
    ("4", 191_154_276), ("5", 180_915_260),
)
CUT_CHROMOSOMES = (
    ("6", 171_115_067), ("7", 159_138_663), ("8", 146_364_022),
    ("9", 141_213_431), ("10", 135_534_747), ("11", 135_006_516),
    ("12", 133_851_895), ("13", 115_169_878), ("14", 107_349_540),
    ("15", 102_531_392), ("16", 90_354_753), ("17", 81_195_210),
    ("18", 78_077_248), ("19", 59_128_983), ("20", 63_025_520),
    ("21", 48_129_895), ("22", 51_304_566), ("X", 155_270_560),
    ("Y", 59_373_566),
)
CUT = 1e-3  # chromosomes 6-22, X and Y at 1/1000 of their lengths
MT = ("MT", 16_569)
# the unplaced scaffolds of hs37d5, in its order
GL_SCAFFOLDS = (
    ("GL000207.1", 4_262), ("GL000226.1", 15_008), ("GL000229.1", 19_913),
    ("GL000231.1", 27_386), ("GL000210.1", 27_682), ("GL000239.1", 33_824),
    ("GL000235.1", 34_474), ("GL000201.1", 36_148), ("GL000247.1", 36_422),
    ("GL000245.1", 36_651), ("GL000197.1", 37_175), ("GL000203.1", 37_498),
    ("GL000246.1", 38_154), ("GL000249.1", 38_502), ("GL000196.1", 38_914),
    ("GL000248.1", 39_786), ("GL000244.1", 39_929), ("GL000238.1", 39_939),
    ("GL000202.1", 40_103), ("GL000234.1", 40_531), ("GL000232.1", 40_652),
    ("GL000206.1", 41_001), ("GL000240.1", 41_933), ("GL000236.1", 41_934),
    ("GL000241.1", 42_152), ("GL000243.1", 43_341), ("GL000242.1", 43_523),
    ("GL000230.1", 43_691), ("GL000237.1", 45_867), ("GL000233.1", 45_941),
    ("GL000204.1", 81_310), ("GL000198.1", 90_085), ("GL000208.1", 92_689),
    ("GL000191.1", 106_433), ("GL000227.1", 128_374),
    ("GL000228.1", 129_120), ("GL000214.1", 137_718),
    ("GL000221.1", 155_397), ("GL000209.1", 159_169),
    ("GL000218.1", 161_147), ("GL000220.1", 161_802),
    ("GL000213.1", 164_239), ("GL000211.1", 166_566),
    ("GL000199.1", 169_874), ("GL000217.1", 172_149),
    ("GL000216.1", 172_294), ("GL000215.1", 172_545),
    ("GL000205.1", 174_588), ("GL000219.1", 179_198),
    ("GL000224.1", 179_693), ("GL000223.1", 180_455),
    ("GL000195.1", 182_896), ("GL000212.1", 186_858),
    ("GL000222.1", 186_861), ("GL000200.1", 187_035),
    ("GL000193.1", 189_789), ("GL000194.1", 191_469),
    ("GL000225.1", 211_173), ("GL000192.1", 547_496),
)
NC_007605 = ("NC_007605", 171_823)
DECOY = ("hs37d5", 35_477_943)

TELOMERE = 10_000
PERICENTROMERE = (3_000_000, 21_000_000)
CLONE_GAP, CLONE_EVERY = 50_000, 5_000_000
SHORT_EVERY = 1_000_000
SHORT_SYMBOLS = b"RYKMSWN"
MIN_LONG = 20  # the index builder's MIN_RUN_LEN: such a run becomes X
MIN_SEQ = 1_000
SEED = 37
READ_EDGE_SHARE = 0.1
# the edge reads' kinds and their shares: a long run's edge, a short run
# covered, a join of two sequences
EDGE_KINDS = (("long", 0.3), ("short", 0.5), ("join", 0.2))
EDGE_SPAN = 200  # an edge read starts within this many bp of its edge
READ_SPAN = 128  # the longest read bench.py's generator draws, and some
_ACGT = np.frombuffer(b"ACGT", dtype=np.uint8)


class Layout(NamedTuple):
    """The sequences and their runs, positions on the concatenation of the
    sequences in FASTA order."""

    names: tuple
    lengths: np.ndarray  # (S,) int64
    starts: np.ndarray  # (S,) int64
    run_start: np.ndarray  # (R,) int64, in order
    run_len: np.ndarray  # (R,) int64
    run_sym: np.ndarray  # (R,) uint8 ASCII

    @property
    def total(self) -> int:
        return int(self.lengths.sum())

    @property
    def text_len(self) -> int:
        """Symbols of the index's text: both strands and two sentinels."""
        return 2 * self.total + 2

    def long_runs(self):
        """(starts, ends) of the runs that become X, in order."""
        keep = self.run_len >= MIN_LONG
        return self.run_start[keep], self.run_start[keep] + self.run_len[keep]

    def short_runs(self):
        keep = self.run_len < MIN_LONG
        return self.run_start[keep], self.run_start[keep] + self.run_len[keep]

    def summary(self) -> dict:
        ls, le = self.long_runs()
        ss, se = self.short_runs()
        return dict(sequences=len(self.names), bp=self.total,
                    text_len=self.text_len, long_runs=int(ls.size),
                    long_run_bp=int((le - ls).sum()),
                    n_share=float((le - ls).sum() / self.total),
                    short_runs=int(ss.size),
                    short_run_bp=int((se - ss).sum()))


def _place(runs, length, start, run_len, sym):
    """Append the run [start, start + run_len) to `runs` unless it leaves
    [0, length) or touches a run placed before it."""
    if start < 0 or start + run_len > length or run_len < 1:
        return
    for s, n, _c in runs:
        if start <= s + n and s <= start + run_len:
            return
    runs.append((start, run_len, sym))


def _chromosome_runs(full, factor, length, rng):
    """A chromosome's runs at `factor` of its GRCh37 length `full`."""
    runs = []
    tel = max(MIN_LONG, round(TELOMERE * factor))
    _place(runs, length, 0, tel, ord("N"))
    _place(runs, length, length - tel, tel, ord("N"))
    peri = max(MIN_LONG, round(rng.uniform(*PERICENTROMERE) * factor))
    _place(runs, length, round(rng.uniform(0.3, 0.6) * length) - peri // 2,
           peri, ord("N"))
    gap = max(MIN_LONG, round(CLONE_GAP * factor))
    for i in range(full // CLONE_EVERY):
        at = (i + 0.5 + rng.uniform(-0.2, 0.2)) * CLONE_EVERY * factor
        _place(runs, length, round(at), gap, ord("N"))
    runs += _short_runs(full // SHORT_EVERY, length, rng, runs)
    return runs


def _short_runs(count, length, rng, placed):
    """`count` short runs spread over [0, length), one in each of `count`
    equal spans, most of them a base or two long."""
    runs = list(placed)
    for i in range(count):
        at = round((i + rng.uniform(0, 1)) * length / max(count, 1))
        n = int(min(MIN_LONG - 1, rng.geometric(0.6)))
        sym = SHORT_SYMBOLS[int(rng.integers(0, len(SHORT_SYMBOLS)))]
        # a base of ACGT at either end, so that no short run meets one of
        # the next sequence (the index builder sees the sequences joined)
        _place(runs, length, min(max(at, 1), length - n - 1), n, sym)
    return runs[len(placed):]


def layout(scale: float = 1.0, seed: int = SEED) -> Layout:
    """hs37d5's 86 sequences at `scale` of their lengths (chromosomes 6-22,
    X and Y at CUT of theirs besides), with their runs."""
    rng = np.random.default_rng(seed)
    names, lengths, runs = [], [], []

    def seq(name, full, factor, kind):
        length = max(MIN_SEQ, round(full * factor))
        if kind == "chromosome":
            r = _chromosome_runs(full, factor, length, rng)
        elif kind == "scaffold":
            r = _short_runs(int(rng.integers(1, 4)), length, rng, [])
        elif kind == "decoy":
            r = _short_runs(full // SHORT_EVERY, length, rng, [])
        else:
            r = []
        names.append(name)
        lengths.append(length)
        runs.append(sorted(r))

    for name, full in CHROMOSOMES:
        seq(name, full, scale, "chromosome")
    for name, full in CUT_CHROMOSOMES:
        seq(name, full, scale * CUT, "chromosome")
    seq(*MT, scale, "plain")
    for name, full in GL_SCAFFOLDS:
        seq(name, full, scale, "scaffold")
    seq(*NC_007605, scale, "plain")
    seq(*DECOY, scale, "decoy")
    lengths = np.asarray(lengths, dtype=np.int64)
    starts = np.concatenate([[0], np.cumsum(lengths)[:-1]]).astype(np.int64)
    flat = [(int(o) + s, n, c) for o, r in zip(starts, runs)
            for s, n, c in r]
    return Layout(
        names=tuple(names), lengths=lengths, starts=starts,
        run_start=np.asarray([s for s, _n, _c in flat], dtype=np.int64),
        run_len=np.asarray([n for _s, n, _c in flat], dtype=np.int64),
        run_sym=np.asarray([c for _s, _n, c in flat], dtype=np.uint8))


# --- the bases: bench.py's generators (its gen_genome and make_reads) -----


def gen_genome(size: int, seed: int = 42) -> np.ndarray:
    """Deterministic genome with repeat structure: ~20% of it is segments
    duplicated from elsewhere with ~1% divergence.  -> (size,) uint8 ACGT."""
    rng = np.random.default_rng(seed)
    out = _ACGT[rng.integers(0, 4, size=size, dtype=np.uint8)]
    rep = np.random.default_rng(seed + 1)
    placed = 0
    while placed < int(size * 0.2):
        seg = int(10 ** rep.uniform(3.0, min(5.0, np.log10(size / 4))))
        src = int(rep.integers(0, size - seg))
        dst = int(rep.integers(0, size - seg))
        chunk = out[src : src + seg].copy()
        n_mut = rep.binomial(seg, 0.01)
        if n_mut:
            pos = rep.integers(0, seg, size=n_mut)
            chunk[pos] = _ACGT[rep.integers(0, 4, size=n_mut)]
        out[dst : dst + seg] = chunk
        placed += seg
    return out


def make_reads(genome, n_reads: int, seed: int = 7, starts=None) -> list:
    """Lognormal fragment lengths (35..120 bp), C->T deamination decaying
    from both ends, sequencing errors, per-base qualities, ~8% exogenous
    reads; at random starts, or at `starts` (each at most
    len(genome) - READ_SPAN).  Any base outside ACGT is written as N.
    Returns [(sequence, qualities)]."""
    from ..utils.seq import revcomp

    rng = np.random.default_rng(seed)
    if starts is None:
        starts = rng.integers(0, len(genome) - READ_SPAN, size=n_reads)
    acgt = b"ACGT"
    plain = np.zeros(256, dtype=bool)
    plain[_ACGT] = True
    reads = []
    for i in range(n_reads):
        ln = int(np.clip(rng.lognormal(np.log(60), 0.25), 35, 120))
        if rng.random() < 0.08:
            seq = bytearray(acgt[c] for c in rng.integers(0, 4, size=ln))
        else:
            part = np.array(genome[starts[i] : starts[i] + ln])
            part[~plain[part]] = ord("N")
            seq = bytearray(part.tobytes())
            for pos in range(ln):
                p = 0.4 * (0.55 ** pos) + 0.4 * (0.55 ** (ln - 1 - pos)) + 0.005
                if seq[pos] == ord("C") and rng.random() < p:
                    seq[pos] = ord("T")
                elif rng.random() < 0.002:
                    seq[pos] = acgt[int(rng.integers(0, 4))]
            if rng.random() < 0.5:
                seq = bytearray(revcomp(seq))
        quals = bytes(int(q) for q in np.clip(
            rng.normal(36, 4, size=ln), 10, 41).astype(np.uint8))
        reads.append((bytes(seq), quals))
    return reads


def genome(lay: Layout, seed: int = SEED) -> np.ndarray:
    """The concatenated sequences of `lay`: `gen_genome`'s bases with the
    runs written over them -> (total,) uint8 ASCII."""
    out = gen_genome(lay.total, seed)
    for s, n, c in zip(lay.run_start, lay.run_len, lay.run_sym):
        out[s : s + n] = c
    return out


def read_starts(lay: Layout, n_reads: int, seed: int = SEED):
    """Where `n_reads` reads start -> ((n,) int64 starts, (n,) kinds: "" for
    a read placed at random where no long run is within READ_SPAN bp, else
    the kind of edge of EDGE_KINDS it was placed at)."""
    rng = np.random.default_rng(seed + 1)
    hi = lay.total - READ_SPAN
    ls, le = lay.long_runs()
    ss, _se = lay.short_runs()
    joins = lay.starts[1:]
    n_edge = int(round(n_reads * READ_EDGE_SHARE))
    kinds = np.full(n_reads, "", dtype=object)
    starts = np.empty(n_reads, dtype=np.int64)
    counts = rng.multinomial(n_edge, [s for _k, s in EDGE_KINDS])
    at = 0
    for (kind, _s), c in zip(EDGE_KINDS, counts):
        if kind == "long":
            pick = rng.integers(0, ls.size, size=c)
            edge = np.where(rng.random(c) < 0.5, ls[pick], le[pick])
            st = edge + rng.integers(-EDGE_SPAN, EDGE_SPAN + 1, size=c)
        elif kind == "short":
            # the run covered by the shortest read (35 bp)
            st = ss[rng.integers(0, ss.size, size=c)] \
                - rng.integers(0, 35, size=c)
        else:
            st = joins[rng.integers(0, joins.size, size=c)] \
                + rng.integers(-EDGE_SPAN, 1, size=c)
        starts[at : at + c] = np.clip(st, 0, hi)
        kinds[at : at + c] = kind
        at += c
    # the rest at random, clear of the long runs
    while at < n_reads:
        st = rng.integers(0, hi, size=2 * (n_reads - at))
        nxt = np.searchsorted(ls, st, side="left")
        prev_end = np.where(nxt > 0, le[np.maximum(nxt - 1, 0)], -1)
        ok = (prev_end < st) & ((nxt >= ls.size)
                                | (ls[np.minimum(nxt, ls.size - 1)]
                                   >= st + READ_SPAN))
        st = st[ok][: n_reads - at]
        starts[at : at + st.size] = st
        at += st.size
    order = rng.permutation(n_reads)
    return starts[order], kinds[order]


def write_fasta(fasta: str, bases: np.ndarray, names, starts,
                lengths) -> None:
    """The sequences bases[start : start + length] under their names at
    `fasta` (lines of 80), written whole under a temporary name first."""
    tmp = f"{fasta}.{os.getpid()}.tmp"
    with open(tmp, "wb") as f:
        for name, s, n in zip(names, starts, lengths):
            f.write(f">{name}\n".encode())
            seq = bases[s : s + n]
            full = len(seq) // 80 * 80
            lines = np.empty((full // 80, 81), dtype=np.uint8)
            lines[:, :80] = seq[:full].reshape(-1, 80)
            lines[:, 80] = ord("\n")
            f.write(lines.tobytes())
            if full < len(seq):
                f.write(seq[full:].tobytes() + b"\n")
    os.replace(tmp, fasta)


def write_fastq(reads, fastq: str) -> None:
    with open(fastq, "w") as f:
        for i, (s, q) in enumerate(reads):
            f.write(f"@read{i}\n{s.decode()}\n+\n"
                    + "".join(chr(c + 33) for c in q) + "\n")


def make(out_dir: str, scale: float = 1.0, seed: int = SEED,
         n_reads: int = 16_384):
    """The assembly's FASTA and reads under `out_dir` -> (layout, bases,
    reads, read kinds, fasta path, fastq path).  An existing FASTA of the
    same layout is kept (its index with it); the bases are made anew."""
    lay = layout(scale, seed)
    bases = genome(lay, seed)
    fasta = os.path.join(out_dir, f"assembly_{scale:g}_{seed}.fa")
    fastq = os.path.join(out_dir, f"reads_{scale:g}_{seed}.fq")
    os.makedirs(out_dir, exist_ok=True)
    if not os.path.exists(fasta):
        write_fasta(fasta, bases, lay.names, lay.starts, lay.lengths)
    starts, kinds = read_starts(lay, n_reads, seed)
    reads = make_reads(bases, n_reads, seed + 100, starts)
    write_fastq(reads, fastq)
    return lay, bases, reads, kinds, fasta, fastq


# --- a BAM's records against the reference --------------------------------


def ref_span(cigar: str) -> int:
    """Reference bases a CIGAR string covers (M, D, N, =, X)."""
    return sum(int(n) for n in re.findall(r"(\d+)[MDN=X]", cigar))


_MD_TOKEN = re.compile(rb"(\d+)|\^([A-Za-z]+)|([A-Za-z])")


def md_letters(md: bytes):
    """The reference offsets and letters of an MD string's mismatches and
    deletions, and the reference bases it covers -> ([(offset, letter)],
    span)."""
    out, off = [], 0
    for n, deleted, letter in _MD_TOKEN.findall(md):
        if n:
            off += int(n)
            continue
        for c in deleted or letter:
            out.append((off, c))
            off += 1
    return out, off


def check_records(lay: Layout, bases: np.ndarray, header_refs,
                  records) -> dict:
    """Hold mapped BAM records to the reference: the header names the
    layout's sequences with their lengths; no record covers a long run's
    base (X in the index) or passes its sequence's end; every M-only
    record's mismatches against the reference, where a short run's base
    (replaced in the index, its original kept) always counts, equal its
    NM; the MD string covers the record's reference span, each of its
    letters is the reference's base at its offset (a short run's original
    symbol complemented on the reverse strand, as the record conversion
    writes it there), and its letters outside ACGT fall on exactly the
    short runs' bases covered.  Raises AssertionError on the first fault.
    `records`: (name, flags, ref_id, pos, mapq, cigar, seq, quals, tags)
    with tags (key, type, value) or (key, value).  -> counts: mapped, the
    text positions of the mapped records (a reverse-strand hit sits in the
    text's second half), the records within EDGE_SPAN bp of a long run,
    the M-only records checked, the records whose MD carries an original
    symbol (and the largest text position of one)."""
    from ..utils.seq import COMPLEMENT_TABLE

    refs = [(n.decode() if isinstance(n, bytes) else n, int(ln))
            for n, ln in header_refs]
    want = list(zip(lay.names, lay.lengths.tolist()))
    if refs != want:
        raise AssertionError(f"BAM header: {len(refs)} sequences, not the "
                             f"layout's {len(want)} (names and lengths)")
    ls, le = lay.long_runs()
    plain = np.zeros(256, dtype=bool)
    plain[_ACGT] = True
    text_len = lay.text_len
    where, near_n, checked, md_orig, md_max = [], 0, 0, 0, -1
    for rec in records:
        name, flags, ref_id, pos, _mq, cigar, seq, _q, tags = rec[:9]
        if flags & 0x4:
            continue
        tag = {bytes(t[0]): t[-1] for t in tags}
        span = ref_span(cigar)
        if pos < 0 or pos + span > lay.lengths[ref_id]:
            raise AssertionError(f"{name}: {cigar} at {pos} passes the end "
                                 f"of {lay.names[ref_id]}")
        a = int(lay.starts[ref_id]) + pos
        i = int(np.searchsorted(le, a, side="right"))
        if i < ls.size and ls[i] < a + span:
            raise AssertionError(f"{name}: {cigar} at {a:,} covers the "
                                 f"long run at {int(ls[i]):,}")
        j = np.searchsorted(ls, a, side="left")
        gap = min(int(ls[j]) - (a + span) if j < ls.size else EDGE_SPAN + 1,
                  a - int(le[j - 1]) if j > 0 else EDGE_SPAN + 1)
        near_n += gap <= EDGE_SPAN
        tpos = text_len - a - span - 1 if flags & 0x10 else a
        where.append(tpos)
        ref = bases[a : a + span]
        md = tag.get(b"MD", b"")
        md = md.encode() if isinstance(md, str) else bytes(md)
        letters, md_span = md_letters(md)
        if md_span != span:
            raise AssertionError(f"{name}: MD {md!r} covers {md_span} "
                                 f"reference bases, {cigar} {span}")
        orig = {off: c for off, c in letters if not plain[c]}
        replaced = np.flatnonzero(~plain[ref]).tolist()
        if sorted(orig) != replaced:
            raise AssertionError(f"{name}: MD {md!r} has letters outside "
                                 f"ACGT at offsets {sorted(orig)}, the "
                                 f"reference's replaced bases at {replaced}")
        for off, c in letters:
            if flags & 0x10 and not plain[c]:
                c = int(COMPLEMENT_TABLE[c])
            if c != ref[off]:
                raise AssertionError(
                    f"{name}: MD {md!r} writes {chr(c)!r} at offset {off}, "
                    f"the reference holds {chr(ref[off])!r}")
        if orig:
            md_orig += 1
            md_max = max(md_max, tpos)
        if cigar == f"{len(seq)}M":
            read = np.frombuffer(bytes(seq), dtype=np.uint8)
            mism = int(((ref != read) | ~plain[ref]).sum())
            if mism != int(tag[b"NM"]):
                raise AssertionError(
                    f"{name}: {mism} mismatches against the reference at "
                    f"{a:,}, NM {int(tag[b'NM'])}")
            checked += 1
    return dict(mapped=len(where),
                text_pos=np.asarray(where, dtype=np.int64),
                beside_long_run=near_n, checked=checked,
                md_original=md_orig, md_original_max_text_pos=md_max)
