"""BAM reader/writer and SAM header model (replaces noodles bam/sam subset)."""

from __future__ import annotations

import struct
from dataclasses import dataclass, field

from ..errors import MapadError
from .bgzf import BgzfStream, BgzfWriter

CIGAR_OPS = "MIDNSHP=X"
CIGAR_OP_TO_CODE = {c: i for i, c in enumerate(CIGAR_OPS)}
SEQ_NIBBLES = "=ACMGRSVTWYHKDBN"
SEQ_TO_NIBBLE = {ord(c): i for i, c in enumerate(SEQ_NIBBLES)}
NIBBLE_TO_SEQ = {i: c for i, c in enumerate(SEQ_NIBBLES)}


# ---------------------------------------------------------------------------
# SAM header model
# ---------------------------------------------------------------------------


@dataclass
class SamHeader:
    """Structured SAM header; rendered @HD, @SQ, @RG, @PG, @CO (noodles order)."""

    hd: list = field(default_factory=list)  # [(key, value)]
    sq: list = field(default_factory=list)  # [(name, length, [(key, value)])]
    rg: list = field(default_factory=list)  # [(id, [(key, value)])]
    pg: list = field(default_factory=list)  # [(id, [(key, value)])]
    co: list = field(default_factory=list)  # [str]

    def to_text(self) -> str:
        lines = []
        if self.hd:
            lines.append("@HD\t" + "\t".join(f"{k}:{v}" for k, v in self.hd))
        for name, length, extra in self.sq:
            fields = [f"SN:{name}", f"LN:{length}"] + [f"{k}:{v}" for k, v in extra]
            lines.append("@SQ\t" + "\t".join(fields))
        for rg_id, extra in self.rg:
            lines.append(
                "@RG\t" + "\t".join([f"ID:{rg_id}"] + [f"{k}:{v}" for k, v in extra])
            )
        for pg_id, extra in self.pg:
            lines.append(
                "@PG\t" + "\t".join([f"ID:{pg_id}"] + [f"{k}:{v}" for k, v in extra])
            )
        for comment in self.co:
            lines.append(f"@CO\t{comment}")
        return "".join(line + "\n" for line in lines)

    @classmethod
    def from_text(cls, text: str) -> "SamHeader":
        h = cls()
        for line in text.splitlines():
            if not line.startswith("@"):
                continue
            parts = line.rstrip("\n").split("\t")
            tag = parts[0]
            if tag == "@CO":
                h.co.append("\t".join(parts[1:]))
                continue
            fields = []
            for p in parts[1:]:
                if ":" in p:
                    k, v = p.split(":", 1)
                    fields.append((k, v))
            if tag == "@HD":
                h.hd = fields
            elif tag == "@SQ":
                name = length = None
                extra = []
                for k, v in fields:
                    if k == "SN":
                        name = v
                    elif k == "LN":
                        length = int(v)
                    else:
                        extra.append((k, v))
                h.sq.append((name, length, extra))
            elif tag == "@RG":
                rg_id = None
                extra = []
                for k, v in fields:
                    if k == "ID":
                        rg_id = v
                    else:
                        extra.append((k, v))
                h.rg.append((rg_id, extra))
            elif tag == "@PG":
                pg_id = None
                extra = []
                for k, v in fields:
                    if k == "ID":
                        pg_id = v
                    else:
                        extra.append((k, v))
                h.pg.append((pg_id, extra))
        return h


# ---------------------------------------------------------------------------
# BAM record
# ---------------------------------------------------------------------------


@dataclass
class BamRecord:
    name: bytes | None = None
    flags: int = 0
    ref_id: int = -1
    pos: int = -1  # 0-based leftmost
    mapq: int = 255
    cigar: list = field(default_factory=list)  # [(count, op_char)]
    sequence: bytes = b""
    quals: bytes = b""  # raw phred values (no +33)
    tags: list = field(default_factory=list)  # [(tag2bytes, type_char, value)]

    def tag(self, name):
        key = name if isinstance(name, bytes) else name.encode()
        for tag, _type, value in self.tags:
            if tag == key:
                return value
        return None

    def cigar_string(self) -> str:
        if not self.cigar:
            return "*"
        return "".join(f"{n}{op}" for n, op in self.cigar)


def reg2bin(beg: int, end: int) -> int:
    """BAM bin from a zero-based half-open interval (SAM spec 4.2.1)."""
    end -= 1
    if beg >> 14 == end >> 14:
        return ((1 << 15) - 1) // 7 + (beg >> 14)
    if beg >> 17 == end >> 17:
        return ((1 << 12) - 1) // 7 + (beg >> 17)
    if beg >> 20 == end >> 20:
        return ((1 << 9) - 1) // 7 + (beg >> 20)
    if beg >> 23 == end >> 23:
        return ((1 << 6) - 1) // 7 + (beg >> 23)
    if beg >> 26 == end >> 26:
        return ((1 << 3) - 1) // 7 + (beg >> 26)
    return 0


_TAG_FMT = {
    "A": ("c", 1), "c": ("b", 1), "C": ("B", 1), "s": ("h", 2), "S": ("H", 2),
    "i": ("i", 4), "I": ("I", 4), "f": ("f", 4),
}


def _encode_tags(tags) -> bytes:
    out = bytearray()
    for tag, type_char, value in tags:
        out += tag if isinstance(tag, bytes) else tag.encode()
        out += type_char.encode()
        if type_char == "A":
            out += bytes([value if isinstance(value, int) else ord(value)])
        elif type_char in "cCsSiI":
            out += struct.pack("<" + _TAG_FMT[type_char][0], int(value))
        elif type_char == "f":
            out += struct.pack("<f", float(value))
        elif type_char in "ZH":
            v = value if isinstance(value, bytes) else str(value).encode()
            out += v + b"\x00"
        elif type_char == "B":
            sub, arr = value
            out += sub.encode() + struct.pack("<i", len(arr))
            fmt = "<" + _TAG_FMT[sub][0] * len(arr)
            out += struct.pack(fmt, *arr)
        else:
            raise ValueError(f"unsupported tag type {type_char}")
    return bytes(out)


def _decode_tags(buf: bytes):
    tags = []
    pos = 0
    n = len(buf)
    while pos + 3 <= n:
        tag = bytes(buf[pos : pos + 2])
        type_char = chr(buf[pos + 2])
        pos += 3
        if type_char == "A":
            tags.append((tag, "A", buf[pos]))
            pos += 1
        elif type_char in "cCsSiI":
            fmt, size = _TAG_FMT[type_char]
            tags.append((tag, type_char, struct.unpack_from("<" + fmt, buf, pos)[0]))
            pos += size
        elif type_char == "f":
            tags.append((tag, "f", struct.unpack_from("<f", buf, pos)[0]))
            pos += 4
        elif type_char in "ZH":
            end = buf.index(b"\x00", pos)
            tags.append((tag, type_char, bytes(buf[pos:end])))
            pos = end + 1
        elif type_char == "B":
            sub = chr(buf[pos])
            count = struct.unpack_from("<i", buf, pos + 1)[0]
            fmt, size = _TAG_FMT[sub]
            vals = list(struct.unpack_from("<" + fmt * count, buf, pos + 5))
            tags.append((tag, "B", (sub, vals)))
            pos += 5 + size * count
        else:
            raise ValueError(f"unsupported tag type {type_char}")
    return tags


def encode_record(rec: BamRecord) -> bytes:
    name = rec.name if rec.name else b"*"
    l_read_name = len(name) + 1
    n_cigar = len(rec.cigar)
    l_seq = len(rec.sequence)
    ref_len = sum(n for n, op in rec.cigar if op in "MDN=X")
    if rec.pos >= 0:
        bin_ = reg2bin(rec.pos, rec.pos + max(ref_len, 1))
    else:
        bin_ = 4680
    body = bytearray()
    body += struct.pack(
        "<iiBBHHHiiii",
        rec.ref_id,
        rec.pos,
        l_read_name,
        rec.mapq,
        bin_,
        n_cigar,
        rec.flags,
        l_seq,
        -1,  # next_refID
        -1,  # next_pos
        0,  # tlen
    )
    body += name + b"\x00"
    for count, op in rec.cigar:
        body += struct.pack("<I", (count << 4) | CIGAR_OP_TO_CODE[op])
    packed = bytearray((l_seq + 1) // 2)
    for i, b in enumerate(rec.sequence):
        nib = SEQ_TO_NIBBLE.get(b, 15)
        if i % 2 == 0:
            packed[i // 2] = nib << 4
        else:
            packed[i // 2] |= nib
    body += packed
    if rec.quals and len(rec.quals) == l_seq:
        body += bytes(rec.quals)
    else:
        body += b"\xff" * l_seq
    body += _encode_tags(rec.tags)
    return struct.pack("<i", len(body)) + bytes(body)


def decode_record(buf: bytes, offset: int):
    (block_size,) = struct.unpack_from("<i", buf, offset)
    base = offset + 4
    (
        ref_id, pos, l_read_name, mapq, _bin, n_cigar, flags, l_seq,
        _next_ref, _next_pos, _tlen,
    ) = struct.unpack_from("<iiBBHHHiiii", buf, base)
    p = base + 32
    name = bytes(buf[p : p + l_read_name - 1])
    p += l_read_name
    cigar = []
    for _ in range(n_cigar):
        (v,) = struct.unpack_from("<I", buf, p)
        cigar.append((v >> 4, CIGAR_OPS[v & 0xF]))
        p += 4
    seq = bytearray(l_seq)
    for i in range(l_seq):
        nib = buf[p + i // 2]
        nib = (nib >> 4) if i % 2 == 0 else (nib & 0xF)
        seq[i] = ord(NIBBLE_TO_SEQ[nib])
    p += (l_seq + 1) // 2
    quals = bytes(buf[p : p + l_seq])
    p += l_seq
    tags = _decode_tags(buf[p : base + block_size])
    rec = BamRecord(
        name=name if name != b"*" else None,
        flags=flags, ref_id=ref_id, pos=pos, mapq=mapq, cigar=cigar,
        sequence=bytes(seq), quals=quals, tags=tags,
    )
    return rec, offset + 4 + block_size


# ---------------------------------------------------------------------------
# File-level reader/writer
# ---------------------------------------------------------------------------


class BamWriter:
    def __init__(self, fileobj, header: SamHeader):
        self._w = BgzfWriter(fileobj)
        self.header = header
        text = header.to_text().encode()
        buf = b"BAM\x01" + struct.pack("<i", len(text)) + text
        buf += struct.pack("<i", len(header.sq))
        for name, length, _extra in header.sq:
            if length > 0x7FFFFFFF:
                raise MapadError(
                    f"BAM cannot represent contig {name!r} of length "
                    f"{length}: the @SQ LN field is int32 (split the "
                    "reference into chromosome-sized contigs)"
                )
            nm = name.encode() + b"\x00"
            buf += struct.pack("<i", len(nm)) + nm + struct.pack("<i", length)
        self._w.write(buf)

    def write_record(self, rec: BamRecord):
        self._w.write(encode_record(rec))

    def write_raw(self, data: bytes):
        """Append pre-encoded BAM record bytes (native postprocess path)."""
        self._w.write(data)

    def close(self):
        self._w.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class BamReader:
    """Streaming BAM reader (one BGZF block inflated at a time)."""

    def __init__(self, fileobj):
        self._stream = BgzfStream(fileobj)
        magic = self._stream.read(4)
        if magic != b"BAM\x01":
            raise ValueError("not a BAM file")
        (l_text,) = struct.unpack("<i", self._stream.read(4))
        self.header_text = self._stream.read(l_text).decode("utf-8", "replace")
        self.header = SamHeader.from_text(self.header_text)
        (n_ref,) = struct.unpack("<i", self._stream.read(4))
        self.references = []
        for _ in range(n_ref):
            (l_name,) = struct.unpack("<i", self._stream.read(4))
            name = self._stream.read(l_name)[:-1].decode()
            (l_ref,) = struct.unpack("<i", self._stream.read(4))
            self.references.append((name, l_ref))

    def __iter__(self):
        while True:
            head = self._stream.read(4)
            if head == b"":
                return
            (block_size,) = struct.unpack("<i", head)
            body = self._stream.read(block_size)
            rec, _ = decode_record(head + body, 0)
            yield rec
