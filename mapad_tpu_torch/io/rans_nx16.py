"""rANS-Nx16 codec (CRAM 3.1 block compression method 5).

Implemented from the public CRAM codecs specification (hts-specs
CRAMcodecs: "rANS Nx16" section): N-way interleaved rANS with 16-bit
renormalization, order-0 and order-1 contexts, and the bit-stream
transforms (PACK, RLE, STRIPE, CAT, NOSZ).  The reference reads CRAM 3.1
through noodles-cram 0.83 (Cargo.lock; input path
src/map/input_chunk_reader.rs:81-89); this module provides the equivalent
read capability for `io/cram.py`.

Layout summary (all varints are 7-bit big-endian "uint7"):

  stream   := flags:u8 [len:uint7 unless NOSZ] body
  flags    := ORDER1 0x01 | X32 0x04 | STRIPE 0x08 | NOSZ 0x10
            | CAT 0x20 | RLE 0x40 | PACK 0x80
  body     := STRIPE: n:u8, clen[n]:uint7, n nested streams (interleaved)
            | otherwise: [pack meta] [rle meta] (CAT: raw | rANS payload)
  pack meta:= nsym:u8, map[nsym]:u8, packed_len:uint7
  rle meta := meta_len:uint7, rans_len:uint7,
              (meta_len&1 ? raw meta[meta_len>>1]
                          : clen:uint7 + order-0-compressed meta)
              meta := nsym:u8 (0 => 256), syms[], run-length uint7 stream
  order-0  := alphabet (sym/+1-run scheme), uint7 freqs (sum 4096),
              N x u32le states, 16-bit-renorm symbol stream
  order-1  := comp:u8 (shift<<4 | compressed-flag), optionally
              order-0-compressed table; per-context rows over the shared
              alphabet (rows sum to 1<<shift); N states decode N
              contiguous output fragments

Decode applies: rANS -> un-RLE -> un-PACK (encode packs first, then RLE,
then entropy-codes).  Every stage validates its expected output length
and raises InvalidInputType on mismatch, so a malformed (or
mis-interpreted) stream fails loudly rather than yielding corrupt data.
Round-trip coverage: tests/test_cram.py encodes with every flag
combination here and decodes both with this module and through the CRAM
block layer.
"""

from __future__ import annotations

from ..errors import InvalidInputType

ORDER1 = 0x01
X32 = 0x04
STRIPE = 0x08
NOSZ = 0x10
CAT = 0x20
RLE = 0x40
PACK = 0x80

RANS_L = 1 << 15
TOTFREQ = 4096  # order-0 frequency total (shift 12)


class _Cur:
    __slots__ = ("buf", "pos")

    def __init__(self, buf: bytes):
        self.buf = buf
        self.pos = 0

    def u8(self) -> int:
        if self.pos >= len(self.buf):
            raise InvalidInputType("rans-nx16: truncated stream")
        v = self.buf[self.pos]
        self.pos += 1
        return v

    def u16le(self) -> int:
        if self.pos + 2 > len(self.buf):
            raise InvalidInputType("rans-nx16: truncated stream")
        v = self.buf[self.pos] | (self.buf[self.pos + 1] << 8)
        self.pos += 2
        return v

    def u32le(self) -> int:
        if self.pos + 4 > len(self.buf):
            raise InvalidInputType("rans-nx16: truncated stream")
        v = int.from_bytes(self.buf[self.pos : self.pos + 4], "little")
        self.pos += 4
        return v

    def uint7(self) -> int:
        v = 0
        while True:
            if self.pos >= len(self.buf):
                raise InvalidInputType("rans-nx16: truncated stream")
            c = self.buf[self.pos]
            self.pos += 1
            v = (v << 7) | (c & 0x7F)
            if not c & 0x80:
                return v

    def read(self, n: int) -> bytes:
        v = self.buf[self.pos : self.pos + n]
        if len(v) != n:
            raise InvalidInputType("rans-nx16: truncated stream")
        self.pos += n
        return v

    def remaining(self) -> bool:
        return self.pos < len(self.buf)


def _put_uint7(v: int) -> bytes:
    out = bytearray([v & 0x7F])
    v >>= 7
    while v:
        out.append(0x80 | (v & 0x7F))
        v >>= 7
    return bytes(reversed(out))


# ---------------------------------------------------------------------------
# alphabet + frequency tables
# ---------------------------------------------------------------------------


def _read_alphabet(cur: _Cur) -> list[int]:
    """Symbol list with the +1-run scheme (shared with rANS 4x8);
    terminated by a 0 symbol (0 may only occur first, lists are sorted)."""
    syms = []
    rle = 0
    sym = cur.u8()
    last = sym
    while True:
        syms.append(sym)
        if rle > 0:
            rle -= 1
            sym += 1
        else:
            sym = cur.u8()
            if sym == last + 1:
                rle = cur.u8()
        last = sym
        if rle == 0 and sym == 0:
            break
        if rle > 0 and sym == 0:  # pragma: no cover - malformed
            break
    return syms


def _write_alphabet(syms: list[int]) -> bytes:
    out = bytearray()
    i = 0
    n = len(syms)
    while i < n:
        j = i
        while j + 1 < n and syms[j + 1] == syms[j] + 1:
            j += 1
        out.append(syms[i])
        if j > i:
            out.append(syms[i] + 1)
            out.append(j - i - 1)
        i = j + 1
    out.append(0)
    return bytes(out)


def _normalize_to(freqs: dict[int, int], total: int) -> dict[int, int]:
    """Scale a frequency table so it sums exactly to `total` (decoder-side
    tolerance for encoders that store unnormalized counts; a no-op for
    already-normalized tables)."""
    tot = sum(freqs.values())
    if tot == total or tot == 0:
        return freqs
    out = {}
    acc = 0
    for sym, f in freqs.items():
        g = max(1, (f * total) // tot)
        out[sym] = g
        acc += g
    top = max(out, key=lambda s: out[s])
    out[top] += total - acc
    if out[top] <= 0:
        raise InvalidInputType("rans-nx16: degenerate frequency table")
    return out


def _cum_lookup(freqs: dict[int, int], total: int):
    cum = {}
    lookup = bytearray(total)
    x = 0
    for sym in freqs:  # insertion order == ascending (alphabet order)
        f = freqs[sym]
        if not 0 <= sym <= 255 or f < 0 or x + f > total:
            raise InvalidInputType("rans-nx16: invalid frequency table")
        cum[sym] = x
        lookup[x : x + f] = bytes([sym]) * f
        x += f
    if x != total:
        raise InvalidInputType("rans-nx16: frequencies do not sum to total")
    return cum, bytes(lookup)


# ---------------------------------------------------------------------------
# order-0 core
# ---------------------------------------------------------------------------


def _decode_o0_core(cur: _Cur, n: int, N: int) -> bytes:
    if n == 0:
        return b""
    syms = _read_alphabet(cur)
    freqs = {s: cur.uint7() for s in syms}
    freqs = _normalize_to(freqs, TOTFREQ)
    cum, lookup = _cum_lookup(freqs, TOTFREQ)
    R = [cur.u32le() for _ in range(N)]
    out = bytearray(n)
    buf = cur.buf
    for i in range(n):
        j = i % N
        r = R[j]
        m = r & (TOTFREQ - 1)
        sym = lookup[m]
        out[i] = sym
        r = freqs[sym] * (r >> 12) + m - cum[sym]
        if r < RANS_L and cur.pos + 1 < len(buf):
            r = (r << 16) | buf[cur.pos] | (buf[cur.pos + 1] << 8)
            cur.pos += 2
        R[j] = r
    return bytes(out)


def _encode_o0_core(data: bytes, N: int) -> bytes:
    counts: dict[int, int] = {}
    for b in data:
        counts[b] = counts.get(b, 0) + 1
    freqs = _normalize_to(dict(sorted(counts.items())), TOTFREQ)
    cum, _ = _cum_lookup(freqs, TOTFREQ)
    table = _write_alphabet(list(freqs)) + b"".join(
        _put_uint7(freqs[s]) for s in freqs
    )
    R = [RANS_L] * N
    body = bytearray()
    for i in range(len(data) - 1, -1, -1):
        j = i % N
        sym = data[i]
        f = freqs[sym]
        x_max = ((RANS_L >> 12) << 16) * f
        r = R[j]
        if r >= x_max:
            body.append(r & 0xFF)
            body.append((r >> 8) & 0xFF)
            r >>= 16
        R[j] = ((r // f) << 12) + (r % f) + cum[sym]
    states = b"".join(r.to_bytes(4, "little") for r in R)
    # body bytes were collected in reverse 16-bit-chunk order
    rev = bytearray()
    for k in range(len(body) - 2, -2, -2):
        rev.append(body[k])
        rev.append(body[k + 1])
    return table + states + bytes(rev)


# ---------------------------------------------------------------------------
# order-1 core
# ---------------------------------------------------------------------------


def _decode_o1_core(cur: _Cur, n: int, N: int) -> bytes:
    if n == 0:
        return b""
    comp = cur.u8()
    shift = comp >> 4
    if comp & 1:
        ulen = cur.uint7()
        clen = cur.uint7()
        tab = _Cur(_decode_o0_core(_Cur(cur.read(clen)), ulen, 4))
    else:
        tab = cur
    syms = _read_alphabet(tab)
    total = 1 << shift
    tables = {}
    for ctx in syms:
        # per-row frequencies with the spec's zero-run escape: a stored
        # frequency of 0 is followed by a u8 count of ADDITIONAL zero
        # entries (hts-specs CRAMcodecs "rANS Nx16" ReadFrequenciesOrder1)
        row = {}
        zero_run = 0
        for s in syms:
            if zero_run > 0:
                zero_run -= 1
                row[s] = 0
                continue
            f = tab.uint7()
            row[s] = f
            if f == 0:
                zero_run = tab.u8()
        row = _normalize_to(
            {s: f for s, f in row.items() if f > 0} or {syms[0]: total},
            total,
        )
        tables[ctx] = (*_cum_lookup(row, total), row)
    R = [cur.u32le() for _ in range(N)]
    out = bytearray(n)
    isz = n // N
    starts = [isz * j for j in range(N)]
    ends = [isz * (j + 1) for j in range(N)]
    ends[N - 1] = n
    last = [0] * N
    buf = cur.buf
    mask = total - 1
    pos = [starts[j] for j in range(N)]
    alive = True
    while alive:
        alive = False
        for j in range(N):
            p = pos[j]
            if p >= ends[j]:
                continue
            alive = True
            entry = tables.get(last[j])
            if entry is None:
                raise InvalidInputType(
                    "rans-nx16: order-1 context has no frequency table"
                )
            cum, lookup, row = entry
            r = R[j]
            m = r & mask
            sym = lookup[m]
            out[p] = sym
            r = row[sym] * (r >> shift) + m - cum[sym]
            if r < RANS_L and cur.pos + 1 < len(buf):
                r = (r << 16) | buf[cur.pos] | (buf[cur.pos + 1] << 8)
                cur.pos += 2
            R[j] = r
            last[j] = sym
            pos[j] = p + 1
    return bytes(out)


def _encode_o1_core(data: bytes, N: int) -> bytes:
    n = len(data)
    isz = n // N
    starts = [isz * j for j in range(N)]
    ends = [isz * (j + 1) for j in range(N)]
    ends[N - 1] = n
    shift = 12
    total = 1 << shift
    counts: dict[int, dict[int, int]] = {}
    for j in range(N):
        last = 0
        for p in range(starts[j], ends[j]):
            sym = data[p]
            row = counts.setdefault(last, {})
            row[sym] = row.get(sym, 0) + 1
            last = sym
    tables = {}
    syms = sorted({s for row in counts.values() for s in row} | set(counts))
    table = bytearray([shift << 4])
    table += _write_alphabet(syms)
    for ctx in syms:
        row = counts.get(ctx) or {syms[0]: 1}
        row = _normalize_to(
            {s: row.get(s, 0) for s in syms if row.get(s, 0) > 0}, total
        )
        tables[ctx] = (*_cum_lookup(row, total), row)
        # zero-run escape on the encode side: each stored 0 frequency is
        # followed by a u8 count of additional zeros (capped at 255)
        k = 0
        while k < len(syms):
            f = row.get(syms[k], 0)
            table += _put_uint7(f)
            if f == 0:
                run_end = k + 1
                while (
                    run_end < len(syms)
                    and row.get(syms[run_end], 0) == 0
                    and run_end - k - 1 < 255
                ):
                    run_end += 1
                table.append(run_end - k - 1)
                k = run_end
            else:
                k += 1
    R = [RANS_L] * N
    chunks: list[bytearray] = [bytearray() for _ in range(N)]
    # encode each fragment in reverse (contexts known from forward pass)
    for j in range(N):
        frag = data[starts[j] : ends[j]]
        ctxs = [0] + [frag[i] for i in range(len(frag) - 1)]
        for i in range(len(frag) - 1, -1, -1):
            sym = frag[i]
            cum, _lookup, row = tables[ctxs[i]]
            f = row[sym]
            x_max = ((RANS_L >> shift) << 16) * f
            r = R[j]
            if r >= x_max:
                chunks[j].append(r & 0xFF)
                chunks[j].append((r >> 8) & 0xFF)
                r >>= 16
            R[j] = ((r // f) << shift) + (r % f) + cum[sym]
    states = b"".join(r.to_bytes(4, "little") for r in R)
    # interleave the per-state chunks in decode order: walk positions
    # forward, replaying which state renormalizes when
    sim_R = list(R)
    body = bytearray()
    rev_chunks = []
    for j in range(N):
        c = chunks[j]
        rc = bytearray()
        for k in range(len(c) - 2, -2, -2):
            rc.append(c[k])
            rc.append(c[k + 1])
        rev_chunks.append(rc)
    idx = [0] * N
    pos = list(starts)
    last = [0] * N
    alive = True
    while alive:
        alive = False
        for j in range(N):
            p = pos[j]
            if p >= ends[j]:
                continue
            alive = True
            entry = tables.get(last[j])
            if entry is None:
                raise InvalidInputType(
                    "rans-nx16: order-1 context has no frequency table"
                )
            cum, lookup, row = entry
            r = sim_R[j]
            m = r & (total - 1)
            sym = lookup[m]
            r = row[sym] * (r >> shift) + m - cum[sym]
            if r < RANS_L:
                body.append(rev_chunks[j][idx[j]])
                body.append(rev_chunks[j][idx[j] + 1])
                r = (r << 16) | rev_chunks[j][idx[j]] | (
                    rev_chunks[j][idx[j] + 1] << 8
                )
                idx[j] += 2
            sim_R[j] = r
            last[j] = sym
            pos[j] = p + 1
    return bytes(table) + states + bytes(body)


# ---------------------------------------------------------------------------
# transforms
# ---------------------------------------------------------------------------


def _unpack(data: bytes, pmap: bytes, out_len: int) -> bytes:
    nsym = len(pmap)
    if nsym <= 1:
        return bytes([pmap[0] if pmap else 0]) * out_len
    need = (
        (out_len + 7) // 8 if nsym <= 2
        else (out_len + 3) // 4 if nsym <= 4
        else (out_len + 1) // 2
    )
    if len(data) < need:
        raise InvalidInputType("rans-nx16: packed data shorter than output")
    out = bytearray(out_len)
    try:
        if nsym <= 2:
            for i in range(out_len):
                out[i] = pmap[(data[i >> 3] >> (i & 7)) & 1]
        elif nsym <= 4:
            for i in range(out_len):
                out[i] = pmap[(data[i >> 2] >> ((i & 3) << 1)) & 3]
        elif nsym <= 16:
            for i in range(out_len):
                out[i] = pmap[(data[i >> 1] >> ((i & 1) << 2)) & 15]
        else:
            raise InvalidInputType("rans-nx16: pack with >16 symbols")
    except IndexError:
        raise InvalidInputType(
            "rans-nx16: PACK index outside symbol map"
        ) from None
    return bytes(out)


def _pack(data: bytes) -> tuple[bytes, bytes]:
    syms = sorted(set(data))
    nsym = len(syms)
    if nsym > 16:
        raise ValueError("pack: >16 distinct symbols")
    rmap = {s: i for i, s in enumerate(syms)}
    if nsym <= 1:
        return bytes(syms), b""
    if nsym <= 2:
        per, bits = 8, 1
    elif nsym <= 4:
        per, bits = 4, 2
    else:
        per, bits = 2, 4
    out = bytearray((len(data) + per - 1) // per)
    for i, b in enumerate(data):
        out[i // per] |= rmap[b] << ((i % per) * bits)
    return bytes(syms), bytes(out)


def _rle_expand(data: bytes, rle_syms, runs: _Cur, out_len: int) -> bytes:
    out = bytearray()
    for b in data:
        out.append(b)
        if rle_syms[b]:
            run = runs.uint7()
            out += bytes([b]) * run
    if len(out) != out_len:
        raise InvalidInputType(
            f"rans-nx16: RLE expansion produced {len(out)} of {out_len} bytes"
        )
    return bytes(out)


def _rle_contract(data: bytes) -> tuple[bytes, bytes, bytes]:
    """-> (meta, contracted_data) choosing every symbol that saves space."""
    # per-symbol saving: runs collapse to 1 byte + uint7 run length
    saving: dict[int, int] = {}
    i = 0
    n = len(data)
    while i < n:
        j = i
        while j < n and data[j] == data[i]:
            j += 1
        run = j - i
        saving[data[i]] = saving.get(data[i], 0) + run - 1 - len(
            _put_uint7(run - 1)
        )
        i = j
    chosen = sorted(s for s, v in saving.items() if v > 0)
    if not chosen:  # keep the stream well-formed when nothing saves space
        chosen = [data[0] if data else 0]
    meta = bytearray([len(chosen) & 0xFF])  # 256 wraps to 0 per spec
    meta += bytes(chosen)
    runs = bytearray()
    out = bytearray()
    in_set = bytearray(256)
    for s in chosen:
        in_set[s] = 1
    i = 0
    while i < n:
        b = data[i]
        out.append(b)
        if in_set[b]:
            j = i
            while j < n and data[j] == b:
                j += 1
            runs += _put_uint7(j - i - 1)
            i = j
        else:
            i += 1
    return bytes(meta + runs), bytes(out)


# ---------------------------------------------------------------------------
# public stream codec
# ---------------------------------------------------------------------------


def decode(data: bytes, out_len: int | None = None) -> bytes:
    """Decode one complete rANS-Nx16 stream."""
    return _decode_stream(_Cur(data), out_len)


def _decode_stream(cur: _Cur, out_len: int | None) -> bytes:
    flags = cur.u8()
    if not flags & NOSZ:
        embedded = cur.uint7()
        if out_len is not None and embedded != out_len:
            raise InvalidInputType(
                "rans-nx16: embedded size disagrees with block raw size"
            )
        out_len = embedded
    if out_len is None:
        raise InvalidInputType("rans-nx16: NOSZ stream without external size")
    if flags & STRIPE:
        n_str = cur.u8()
        clens = [cur.uint7() for _ in range(n_str)]
        subs = []
        for j in range(n_str):
            sub_len = (out_len - j + n_str - 1) // n_str
            subs.append(_decode_stream(_Cur(cur.read(clens[j])), sub_len))
        out = bytearray(out_len)
        for j in range(n_str):
            out[j::n_str] = subs[j]
        return bytes(out)
    N = 32 if flags & X32 else 4
    length = out_len
    pmap = None
    if flags & PACK:
        nsym = cur.u8()
        pmap = cur.read(nsym)
        length = cur.uint7()
    rle_syms = runs = None
    rle_out = length
    if flags & RLE:
        meta_len = cur.uint7()
        length = cur.uint7()
        if meta_len & 1:
            meta = cur.read(meta_len >> 1)
        else:
            clen = cur.uint7()
            meta = _decode_o0_core(_Cur(cur.read(clen)), meta_len >> 1, 4)
        mcur = _Cur(meta)
        n_rle = mcur.u8() or 256
        rle_syms = bytearray(256)
        for _ in range(n_rle):
            rle_syms[mcur.u8()] = 1
        runs = mcur
    if flags & CAT:
        data = cur.read(length)
    elif flags & ORDER1:
        data = _decode_o1_core(cur, length, N)
    else:
        data = _decode_o0_core(cur, length, N)
    if flags & RLE:
        data = _rle_expand(data, rle_syms, runs, rle_out)
    if flags & PACK:
        data = _unpack(data, pmap, out_len)
    if len(data) != out_len:
        raise InvalidInputType("rans-nx16: output size mismatch")
    return data


def encode(data: bytes, flags: int = 0) -> bytes:
    """Encode one rANS-Nx16 stream (decoder counterpart above; primarily
    for round-trip tests and CRAM writing)."""
    out = bytearray([flags])
    if not flags & NOSZ:
        out += _put_uint7(len(data))
    if flags & STRIPE:
        n_str = 4
        out.append(n_str)
        subs = [
            encode(data[j::n_str], flags & ~STRIPE & ~NOSZ | NOSZ)
            for j in range(n_str)
        ]
        for s in subs:
            out += _put_uint7(len(s))
        for s in subs:
            out += s
        return bytes(out)
    N = 32 if flags & X32 else 4
    payload = data
    if flags & PACK:
        pmap, payload = _pack(data)
        out.append(len(pmap))
        out += pmap
        out += _put_uint7(len(payload))
    if flags & RLE:
        meta, payload = _rle_contract(payload)
        out += _put_uint7((len(meta) << 1) | 1)  # raw meta
        out += _put_uint7(len(payload))
        out += meta
    if flags & CAT or not payload:
        out += payload
    elif flags & ORDER1:
        out += _encode_o1_core(payload, N)
    else:
        out += _encode_o0_core(payload, N)
    return bytes(out)
