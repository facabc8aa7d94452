"""CRAM 3.1 fqzcomp quality codec (block compression method 7).

Implemented from the public CRAM codecs specification (hts-specs
CRAMcodecs: "fqzcomp quality codec" section): the same carry-aware
byte-oriented range coder and self-organizing adaptive frequency models
as the adaptive-arithmetic codec (io/arith.py, shared implementation),
driving a 16-bit context mixing quality history, read position, delta
count and parameter selector.  The reference reads CRAM 3.1 through
noodles-cram (/root/reference/Cargo.toml:28); this module provides the
equivalent read capability for `io/cram.py`.

Stream layout (all per the spec pseudocode):

  fqz := vers:u8(=5) gflags:u8
         [nparam:u8 if MULTI_PARAM]
         [max_sel:u8 stab:read_array(256) if HAVE_STAB]
         param[nparam]
         range-coded payload
  param := context:u16(BE) pflags:u8 max_sym:u8
           (qbits<<4|qshift):u8 (qloc<<4|sloc):u8 (ploc<<4|dloc):u8
           [qmap:u8[max_sym] if HAVE_QMAP]
           [qtab:read_array(256) if HAVE_QTAB]
           [ptab:read_array(1024) if HAVE_PTAB]
           [dtab:read_array(256) if HAVE_DTAB]

  read_array: a non-decreasing integer sequence starting from value 0,
  stored as the run length of each successive value j = 0, 1, 2, ... in
  255-continuation chunks (a chunk of 255 means "add 255 to this value's
  run and read another chunk"; values absent from the sequence store a
  0-length run).

  Payload, per record: selector (model `sel`, only when max_sel > 0),
  length (4 bytes little-endian through 4 byte models, decoded for the
  first record and whenever the selected parameter set lacks FIXED_LEN),
  a reverse flag (model `rev`, when gflags.DO_REV), a duplicate flag
  (model `dup`, when pflags.DO_DEDUP; 1 copies the previous record's
  qualities verbatim), then per quality the symbol through the context's
  model.  Context update (fqz_update_ctx in the spec):

     qctx = (qctx << qshift) + qtab[q]          # 32-bit wrap
     ctx  = context + ((qctx & (2^qbits-1)) << qloc)
          [+ ptab[min(p, 1023)] << ploc]        # p = remaining bases,
          [+ dtab[min(delta, 255)] << dloc]     #     pre-decrement
          [+ s << sloc  if DO_SEL]
     delta += (prevq != q);  prevq = q;  p -= 1;  ctx &= 0xFFFF

  DO_REV reverses each flagged record's qualities after the main loop.

Confidence notes: the model update rule, range coder, context formula,
record framing and table RLE follow the spec pseudocode directly;
encoder and decoder are independent implementations round-trip-tested
over every flag combination, and the decoder is additionally pinned by
hand-assembled byte vectors (tests/test_cram.py).  Two layout details
were unverifiable offline (no network, no vendored htscodecs): the
byte order of `context` (big-endian here) and the +1 sizing of the
quality models (max_sym + 1 symbols).  Mismatches against real-world
streams fail loudly (strict length/symbol validation), never silently.
"""

from __future__ import annotations

from ..errors import InvalidInputType
from .arith import _Model, _RangeDecoder, _RangeEncoder

FQZ_VERS = 5

# gflags
GFLAG_MULTI_PARAM = 1
GFLAG_HAVE_STAB = 2
GFLAG_DO_REV = 4

# pflags
PFLAG_DO_DEDUP = 2
PFLAG_DO_LEN = 4
PFLAG_DO_SEL = 8
PFLAG_HAVE_QMAP = 16
PFLAG_HAVE_PTAB = 32
PFLAG_HAVE_DTAB = 64
PFLAG_HAVE_QTAB = 128

_M32 = 0xFFFFFFFF


def _read_array(buf: bytes, pos: int, size: int) -> tuple[list[int], int]:
    """Expand the spec's run-length table format (see module docstring)."""
    out = []
    j = 0
    while len(out) < size:
        run = 0
        while True:
            if pos >= len(buf):
                raise InvalidInputType("fqzcomp: truncated table")
            chunk = buf[pos]
            pos += 1
            run += chunk
            if chunk < 255:
                break
        if len(out) + run > size:
            raise InvalidInputType("fqzcomp: table run overflows")
        out.extend([j] * run)
        j += 1
    return out, pos


def _store_array(vals: list[int]) -> bytes:
    """Inverse of _read_array; `vals` must be non-decreasing from >= 0."""
    out = bytearray()
    i = 0
    j = 0
    n = len(vals)
    while i < n:
        if vals[i] < j:
            raise ValueError("fqzcomp tables must be non-decreasing")
        run = 0
        while i < n and vals[i] == j:
            run += 1
            i += 1
        while True:
            chunk = min(255, run)
            out.append(chunk)
            run -= chunk
            if chunk < 255:
                break
        j += 1
    return bytes(out)


class _Param:
    __slots__ = ("context", "pflags", "max_sym", "qbits", "qshift", "qloc",
                 "sloc", "ploc", "dloc", "qmap", "qtab", "ptab", "dtab",
                 "fixed_len")

    def __init__(self):
        self.qmap = b""
        self.qtab = list(range(256))
        self.ptab = [0] * 1024
        self.dtab = [0] * 256


def _decode_param(buf: bytes, pos: int) -> tuple[_Param, int]:
    if pos + 7 > len(buf):
        raise InvalidInputType("fqzcomp: truncated parameter block")
    p = _Param()
    p.context = (buf[pos] << 8) | buf[pos + 1]
    p.pflags = buf[pos + 2]
    p.max_sym = buf[pos + 3]
    p.qbits, p.qshift = buf[pos + 4] >> 4, buf[pos + 4] & 15
    p.qloc, p.sloc = buf[pos + 5] >> 4, buf[pos + 5] & 15
    p.ploc, p.dloc = buf[pos + 6] >> 4, buf[pos + 6] & 15
    pos += 7
    p.fixed_len = not (p.pflags & PFLAG_DO_LEN)
    if p.pflags & PFLAG_HAVE_QMAP:
        p.qmap = buf[pos : pos + p.max_sym]
        if len(p.qmap) != p.max_sym:
            raise InvalidInputType("fqzcomp: truncated qmap")
        pos += p.max_sym
    if p.pflags & PFLAG_HAVE_QTAB:
        p.qtab, pos = _read_array(buf, pos, 256)
    if p.pflags & PFLAG_HAVE_PTAB:
        p.ptab, pos = _read_array(buf, pos, 1024)
    if p.pflags & PFLAG_HAVE_DTAB:
        p.dtab, pos = _read_array(buf, pos, 256)
    return p, pos


class _GParams:
    __slots__ = ("gflags", "nparam", "max_sel", "stab", "params")


def _decode_gparams(buf: bytes, pos: int) -> tuple[_GParams, int]:
    if pos + 2 > len(buf):
        raise InvalidInputType("fqzcomp: truncated header")
    if buf[pos] != FQZ_VERS:
        raise InvalidInputType(
            f"fqzcomp: unsupported version {buf[pos]} (expected {FQZ_VERS})"
        )
    gp = _GParams()
    gp.gflags = buf[pos + 1]
    pos += 2
    if gp.gflags & GFLAG_MULTI_PARAM:
        if pos >= len(buf):
            raise InvalidInputType("fqzcomp: truncated nparam")
        gp.nparam = buf[pos]
        pos += 1
        if gp.nparam < 1:
            raise InvalidInputType("fqzcomp: nparam = 0")
    else:
        gp.nparam = 1
    gp.max_sel = gp.nparam - 1
    if gp.gflags & GFLAG_HAVE_STAB:
        if pos >= len(buf):
            raise InvalidInputType("fqzcomp: truncated max_sel")
        gp.max_sel = buf[pos]
        pos += 1
        gp.stab, pos = _read_array(buf, pos, 256)
    else:
        gp.stab = [min(i, gp.nparam - 1) for i in range(256)]
    gp.params = []
    for _ in range(gp.nparam):
        p, pos = _decode_param(buf, pos)
        gp.params.append(p)
    if max(gp.stab[: gp.max_sel + 1]) >= gp.nparam:
        raise InvalidInputType("fqzcomp: selector table exceeds nparam")
    return gp, pos


def decode(buf: bytes, expected_len: int | None = None) -> bytes:
    """Decode one fqzcomp stream into `expected_len` quality bytes (the
    CRAM block's raw size; fqzcomp streams carry no own size field)."""
    if expected_len is None:
        raise InvalidInputType("fqzcomp: stream needs external size")
    gp, pos = _decode_gparams(buf, 0)
    rc = _RangeDecoder(buf, pos)
    nsym = max(p.max_sym for p in gp.params) + 1
    qual_models: dict[int, _Model] = {}
    len_models = [_Model(256) for _ in range(4)]
    rev_model = _Model(2)
    dup_model = _Model(2)
    sel_model = _Model(gp.max_sel + 1) if gp.max_sel > 0 else None

    out = bytearray()
    recs: list[tuple[int, int, int]] = []  # (start, len, rev)
    pm = gp.params[0]
    p = 0
    s = 0
    delta = 0
    qctx = 0
    prevq = 0
    rec_len = 0
    first_len = True
    last_ctx = 0
    while len(out) < expected_len:
        if p == 0:
            # new record: selector, length, reverse flag, duplicate flag
            s = sel_model.decode(rc) if sel_model is not None else 0
            pm = gp.params[gp.stab[min(s, 255)]]
            if not pm.fixed_len or first_len:
                rec_len = (
                    len_models[0].decode(rc)
                    | (len_models[1].decode(rc) << 8)
                    | (len_models[2].decode(rc) << 16)
                    | (len_models[3].decode(rc) << 24)
                )
                first_len = False
            if rec_len <= 0 or len(out) + rec_len > expected_len:
                raise InvalidInputType(
                    f"fqzcomp: record length {rec_len} overflows block"
                )
            rev = rev_model.decode(rc) if gp.gflags & GFLAG_DO_REV else 0
            if pm.pflags & PFLAG_DO_DEDUP and dup_model.decode(rc):
                if len(out) < rec_len:
                    raise InvalidInputType("fqzcomp: dup of nothing")
                recs.append((len(out), rec_len, rev))
                out.extend(out[-rec_len:])
                continue
            recs.append((len(out), rec_len, rev))
            p = rec_len
            delta = 0
            qctx = 0
            prevq = 0
            last_ctx = pm.context
        m = qual_models.get(last_ctx)
        if m is None:
            m = qual_models[last_ctx] = _Model(nsym)
        q = m.decode(rc)
        if pm.pflags & PFLAG_HAVE_QMAP:
            if q >= len(pm.qmap):
                raise InvalidInputType("fqzcomp: symbol outside qmap")
            out.append(pm.qmap[q])
        else:
            out.append(q)
        qctx = ((qctx << pm.qshift) + pm.qtab[q]) & _M32
        last = pm.context + ((qctx & ((1 << pm.qbits) - 1)) << pm.qloc)
        if pm.pflags & PFLAG_HAVE_PTAB:
            last += pm.ptab[min(p, 1023)] << pm.ploc
        if pm.pflags & PFLAG_HAVE_DTAB:
            last += pm.dtab[min(delta, 255)] << pm.dloc
        if pm.pflags & PFLAG_DO_SEL:
            last += s << pm.sloc
        last_ctx = last & 0xFFFF
        delta += 1 if prevq != q else 0
        prevq = q
        p -= 1
    if gp.gflags & GFLAG_DO_REV:
        for start, length, rev in recs:
            if rev:
                out[start : start + length] = out[start : start + length][::-1]
    return bytes(out)


def _pick_param(data: bytes, lens: list[int], *, qmap: bool, ptab: bool,
                dtab: bool, dedup: bool, do_len: bool, do_sel: bool,
                context: int) -> _Param:
    p = _Param()
    p.context = context & 0xFFFF
    p.pflags = (
        (PFLAG_DO_LEN if do_len else 0)
        | (PFLAG_DO_DEDUP if dedup else 0)
        | (PFLAG_DO_SEL if do_sel else 0)
    )
    syms = sorted(set(data)) or [0]
    if qmap and len(syms) <= 16:
        p.pflags |= PFLAG_HAVE_QMAP
        p.qmap = bytes(syms)
        p.max_sym = len(syms)
        # qtab compresses the history to the map indices' width
        p.pflags |= PFLAG_HAVE_QTAB
        p.qtab = list(range(256))
        p.qshift = max(1, (len(syms) - 1).bit_length())
    else:
        p.max_sym = max(syms)
        p.qshift = 6
    p.qbits = 9 if not do_sel else 7
    p.qloc = 7
    p.sloc = 14
    if ptab:
        p.pflags |= PFLAG_HAVE_PTAB
        p.ptab = [min(7, i.bit_length()) for i in range(1024)]
        p.ploc = 0
    if dtab:
        p.pflags |= PFLAG_HAVE_DTAB
        p.dtab = [min(7, i.bit_length()) for i in range(256)]
        p.dloc = 3
    if not ptab:
        p.ploc = 0
    if not dtab:
        p.dloc = 0
    p.fixed_len = not do_len
    return p


def _encode_param(p: _Param) -> bytes:
    out = bytearray()
    out.append(p.context >> 8)
    out.append(p.context & 0xFF)
    out.append(p.pflags)
    out.append(p.max_sym)
    out.append((p.qbits << 4) | p.qshift)
    out.append((p.qloc << 4) | p.sloc)
    out.append((p.ploc << 4) | p.dloc)
    if p.pflags & PFLAG_HAVE_QMAP:
        out += p.qmap
    if p.pflags & PFLAG_HAVE_QTAB:
        out += _store_array(p.qtab)
    if p.pflags & PFLAG_HAVE_PTAB:
        out += _store_array(p.ptab)
    if p.pflags & PFLAG_HAVE_DTAB:
        out += _store_array(p.dtab)
    return bytes(out)


def encode(data: bytes, lens: list[int] | None = None, *, qmap=False,
           ptab=False, dtab=False, dedup=False, rev=None, selectors=None,
           nparam: int = 1, context: int = 0) -> bytes:
    """Encode quality bytes as one fqzcomp stream (testing + write
    support; the mapping pipeline itself never writes CRAM).

    `lens` gives the per-record quality lengths (default: one record).
    `rev` is an optional per-record reverse-flag list; `selectors` an
    optional per-record parameter-selector list (forces a selector
    stream with `nparam` identically-derived parameter sets)."""
    if lens is None:
        lens = [len(data)] if data else []
    if sum(lens) != len(data):
        raise ValueError("fqzcomp: lens do not sum to data length")
    if rev is not None and len(rev) != len(lens):
        raise ValueError("fqzcomp: rev flags do not match lens")
    if rev is not None:
        rev = [f for f, n in zip(rev, lens) if n > 0]
    if selectors is not None:
        selectors = [s for s, n in zip(selectors, lens) if n > 0]
    lens = [n for n in lens if n > 0]  # empty records code as nothing
    do_len = len(set(lens)) > 1 if lens else False
    do_sel = selectors is not None and nparam > 1
    gflags = 0
    if rev is not None:
        gflags |= GFLAG_DO_REV
    params = [
        _pick_param(data, lens, qmap=qmap, ptab=ptab, dtab=dtab,
                    dedup=dedup, do_len=do_len, do_sel=do_sel,
                    context=context)
        for _ in range(nparam)
    ]
    max_sel = 0
    stab = [0] * 256
    if nparam > 1:
        gflags |= GFLAG_MULTI_PARAM | GFLAG_HAVE_STAB
        max_sel = nparam - 1
        stab = [min(i, nparam - 1) for i in range(256)]

    head = bytearray([FQZ_VERS, gflags])
    if gflags & GFLAG_MULTI_PARAM:
        head.append(nparam)
    if gflags & GFLAG_HAVE_STAB:
        head.append(max_sel)
        head += _store_array(stab)
    for p in params:
        head += _encode_param(p)

    rc = _RangeEncoder()
    nsym = max(p.max_sym for p in params) + 1
    qual_models: dict[int, _Model] = {}
    len_models = [_Model(256) for _ in range(4)]
    rev_model = _Model(2)
    dup_model = _Model(2)
    sel_model = _Model(max_sel + 1) if max_sel > 0 else None

    if rev is not None:
        # the decoder reverses flagged records at the end, so the encoder
        # must code each flagged record's qualities pre-reversed
        data = bytearray(data)
        off = 0
        for i, length in enumerate(lens):
            if rev[i]:
                data[off : off + length] = data[off : off + length][::-1]
            off += length
        data = bytes(data)

    inv = {}
    for p in params:
        if p.pflags & PFLAG_HAVE_QMAP:
            inv = {b: i for i, b in enumerate(p.qmap)}
            break

    first_len = True
    off = 0
    prev_rec: bytes | None = None
    for ri, length in enumerate(lens):
        chunk = data[off : off + length]
        off += length
        s = selectors[ri] if do_sel else 0
        if sel_model is not None:
            sel_model.encode(rc, s)
        pm = params[stab[min(s, 255)]]
        if not pm.fixed_len or first_len:
            len_models[0].encode(rc, length & 0xFF)
            len_models[1].encode(rc, (length >> 8) & 0xFF)
            len_models[2].encode(rc, (length >> 16) & 0xFF)
            len_models[3].encode(rc, (length >> 24) & 0xFF)
            first_len = False
        if rev is not None:
            rev_model.encode(rc, 1 if rev[ri] else 0)
        if pm.pflags & PFLAG_DO_DEDUP:
            is_dup = prev_rec is not None and chunk == prev_rec
            dup_model.encode(rc, 1 if is_dup else 0)
            if is_dup:
                prev_rec = chunk
                continue
        prev_rec = chunk
        p = length
        delta = 0
        qctx = 0
        prevq = 0
        last_ctx = pm.context
        for b in chunk:
            q = inv[b] if pm.pflags & PFLAG_HAVE_QMAP else b
            m = qual_models.get(last_ctx)
            if m is None:
                m = qual_models[last_ctx] = _Model(nsym)
            m.encode(rc, q)
            qctx = ((qctx << pm.qshift) + pm.qtab[q]) & _M32
            last = pm.context + ((qctx & ((1 << pm.qbits) - 1)) << pm.qloc)
            if pm.pflags & PFLAG_HAVE_PTAB:
                last += pm.ptab[min(p, 1023)] << pm.ploc
            if pm.pflags & PFLAG_HAVE_DTAB:
                last += pm.dtab[min(delta, 255)] << pm.dloc
            if pm.pflags & PFLAG_DO_SEL:
                last += s << pm.sloc
            last_ctx = last & 0xFFFF
            delta += 1 if prevq != q else 0
            prevq = q
            p -= 1
    return bytes(head) + rc.finish()
