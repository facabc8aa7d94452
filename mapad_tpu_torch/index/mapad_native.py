"""Interop with mapAD's native on-disk index format (.tbw/.tle/.tsa/...).

Lets users of the reference implementation point this framework at an
index built by ``mapad index`` and map reads without re-indexing.

Format (derived from the reference sources; cited per item):
  * Container: each file is a snappy *frame* stream (snap crate) wrapping a
    bincode-1.3-encoded ``Item { version: u8, data: T }`` with
    INDEX_VERSION = 5 (src/index/versioned_index.rs:12-20,28).
    bincode 1.3 defaults: little-endian, fixed-width integers, ``usize`` and
    collection length prefixes as u64, String = u64 len + UTF-8 bytes.
  * NAME.tbw  Item<Vec<u8>>         rank-transformed BWT
              (src/index/indexing.rs:191-196)
  * NAME.tle  Item<Vec<usize>>      C ("less") table (indexing.rs:198-203)
  * NAME.tsa  Item<SampledSuffixArrayOwned { sample: Vec<usize>,
              sampling_rate: NonZeroUsize, extra_rows: BTreeMap<usize,usize>,
              sentinel: u8 }>       (src/index/mod.rs:79-86, indexing.rs:168-183)
  * NAME.tpi  Item<FastaIdPositions { id_position: Vec<FastaIdPosition {
              start: u64, end: u64, identifier: String }> }>
              (src/index/mod.rs:31-42, indexing.rs:115-137)
  * NAME.tos  Item<OriginalSymbols(BTreeMap<usize, u8>)>
              (src/index/mod.rs:198-199, indexing.rs:99-113)
  * NAME.trt  Item<RankTransform { ranks: VecMap<u8> }> -- vec_map's serde
    impl writes a map: u64 count + (u64 symbol, u8 rank) entries
    (indexing.rs:155-161)
  * NAME.toc  Item<Occ> from the reference's rust-bio "occ_small_k" fork
    (Cargo.toml:33-34), written with k = 128 (indexing.rs:188).  Layout =
    mainline rust-bio `Occ { occ: Vec<Vec<usize>>, k: u32 }` with one
    INCLUSIVE checkpoint per BWT position i where i % k == 0 (the count
    covers bwt[0..=i]; rust-bio bwt.rs Occ::new increments before
    pushing).  The fork adds the `get_small_k` accessor; its struct
    fields are the mainline ones (assumption documented here because the
    fork's source is not vendored and cannot be fetched in this
    environment -- round-tripping through our own parser is what the
    tests can pin).  At load time occurrence checkpoints are still
    re-derived from the BWT (`compute_occ_checkpoints`): that is cheap,
    uses our own stride, and keeps load working for bundles missing
    .toc.

BTreeMap serializes in ascending key order, which we rely on for the
sampled-SA extra-row binary search.
"""

from __future__ import annotations

import os
import struct

import numpy as np

from ..errors import IndexVersionMismatch, InvalidIndex
from ..utils.seq import RankTransform
from .fmd import FmdIndex, compute_occ_checkpoints
from .runtime import (
    DEFAULT_OCC_K,
    FastaIdPosition,
    FastaIdPositions,
    Index,
    OriginalSymbols,
    SampledSuffixArray,
)

MAPAD_INDEX_VERSION = 5  # reference versioned_index.rs:20
MAPAD_SUFFIXES = (".tbw", ".tle", ".tsa", ".tpi", ".tos", ".trt")

# ---------------------------------------------------------------------------
# snappy (raw block + framing format)
# ---------------------------------------------------------------------------

_SNAPPY_STREAM_ID = b"\xff\x06\x00\x00sNaPpY"
_CHUNK_COMPRESSED = 0x00
_CHUNK_UNCOMPRESSED = 0x01
_CHUNK_PADDING = 0xFE
_MAX_CHUNK = 65536


def _crc32c_table():
    poly = 0x82F63B78
    table = np.zeros(256, dtype=np.uint32)
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ poly if (c & 1) else (c >> 1)
        table[i] = c
    return table


_CRC_TABLE = _crc32c_table()


def _crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    tbl = _CRC_TABLE
    for b in data:
        crc = (crc >> 8) ^ int(tbl[(crc ^ b) & 0xFF])
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = _crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


def _read_uvarint(buf, pos):
    shift = 0
    out = 0
    while True:
        b = buf[pos]
        pos += 1
        out |= (b & 0x7F) << shift
        if not b & 0x80:
            return out, pos
        shift += 7


_snappy_lib = None
_snappy_tried = False


def _native_snappy():
    """Load (compiling on demand, see _build.py) the C++ block decoder
    (csrc/host/snappy.cpp); None if unavailable."""
    global _snappy_lib, _snappy_tried
    if _snappy_tried:
        return _snappy_lib
    _snappy_tried = True
    import ctypes

    from .._build import host_library

    try:
        dll = host_library("snappy")
        dll.snappy_block_decompress.restype = ctypes.c_longlong
        dll.snappy_block_decompress.argtypes = [
            ctypes.c_char_p, ctypes.c_longlong,
            ctypes.c_char_p, ctypes.c_longlong,
        ]
        _snappy_lib = dll
    except Exception:
        _snappy_lib = None
    return _snappy_lib


def snappy_block_decompress(buf: bytes) -> bytes:
    """Raw snappy block format: varint output length, then literal/copy tags."""
    lib = _native_snappy()
    if lib is not None:
        import ctypes

        n, _pos = _read_uvarint(buf, 0)
        if n == 0:
            return b""
        out = ctypes.create_string_buffer(n)
        got = lib.snappy_block_decompress(buf, len(buf), out, n)
        if got != n:
            raise InvalidIndex("snappy: malformed block")
        return out.raw
    return _snappy_block_decompress_py(buf)


def _snappy_block_decompress_py(buf: bytes) -> bytes:
    n, pos = _read_uvarint(buf, 0)
    out = bytearray(n)
    opos = 0
    blen = len(buf)
    while pos < blen:
        tag = buf[pos]
        pos += 1
        kind = tag & 3
        if kind == 0:  # literal
            ln = tag >> 2
            if ln >= 60:
                nb = ln - 59
                ln = int.from_bytes(buf[pos : pos + nb], "little")
                pos += nb
            ln += 1
            out[opos : opos + ln] = buf[pos : pos + ln]
            pos += ln
            opos += ln
            continue
        if kind == 1:  # copy, 1-byte offset
            ln = ((tag >> 2) & 0x7) + 4
            off = ((tag >> 5) << 8) | buf[pos]
            pos += 1
        elif kind == 2:  # copy, 2-byte offset
            ln = (tag >> 2) + 1
            off = buf[pos] | (buf[pos + 1] << 8)
            pos += 2
        else:  # copy, 4-byte offset
            ln = (tag >> 2) + 1
            off = int.from_bytes(buf[pos : pos + 4], "little")
            pos += 4
        if off == 0:
            raise InvalidIndex("snappy: zero copy offset")
        src = opos - off
        if off >= ln:
            out[opos : opos + ln] = out[src : src + ln]
            opos += ln
        else:  # overlapping copy: byte-by-byte semantics
            for _ in range(ln):
                out[opos] = out[src]
                opos += 1
                src += 1
    if opos != n:
        raise InvalidIndex("snappy: truncated block")
    return bytes(out)


def snappy_frame_decompress(data: bytes) -> bytes:
    """Decode the snappy framing format (what the snap crate writes)."""
    if not data.startswith(_SNAPPY_STREAM_ID[:1]) or data[:10] != _SNAPPY_STREAM_ID:
        raise InvalidIndex("not a snappy frame stream")
    pos = 10
    parts = []
    n = len(data)
    while pos < n:
        ctype = data[pos]
        clen = int.from_bytes(data[pos + 1 : pos + 4], "little")
        body = data[pos + 4 : pos + 4 + clen]
        pos += 4 + clen
        if ctype == _CHUNK_COMPRESSED:
            chunk = snappy_block_decompress(body[4:])
            parts.append(chunk)
        elif ctype == _CHUNK_UNCOMPRESSED:
            parts.append(body[4:])
        elif ctype == _CHUNK_PADDING or 0x80 <= ctype <= 0xFD:
            continue
        elif ctype == 0xFF:  # repeated stream identifier
            continue
        else:
            raise InvalidIndex(f"snappy: unskippable chunk type 0x{ctype:02x}")
    return b"".join(parts)


def snappy_frame_compress(data: bytes) -> bytes:
    """Encode as *uncompressed* framed chunks (valid for any snap reader)."""
    out = [_SNAPPY_STREAM_ID]
    for i in range(0, len(data), _MAX_CHUNK):
        chunk = data[i : i + _MAX_CHUNK]
        body = struct.pack("<I", _masked_crc(chunk)) + chunk
        out.append(bytes([_CHUNK_UNCOMPRESSED]) + len(body).to_bytes(3, "little"))
        out.append(body)
    if not data:
        body = struct.pack("<I", _masked_crc(b""))
        out.append(bytes([_CHUNK_UNCOMPRESSED]) + len(body).to_bytes(3, "little"))
        out.append(body)
    return b"".join(out)


# ---------------------------------------------------------------------------
# bincode 1.3 (fixed-int little-endian) primitives
# ---------------------------------------------------------------------------


class _Cursor:
    def __init__(self, buf: bytes):
        self.buf = buf
        self.pos = 0

    def u8(self) -> int:
        v = self.buf[self.pos]
        self.pos += 1
        return v

    def u64(self) -> int:
        v = int.from_bytes(self.buf[self.pos : self.pos + 8], "little")
        self.pos += 8
        return v

    def bytes_(self, n: int) -> bytes:
        v = self.buf[self.pos : self.pos + n]
        if len(v) != n:
            raise InvalidIndex("mapAD index: truncated stream")
        self.pos += n
        return v

    def u64_array(self, n: int) -> np.ndarray:
        return np.frombuffer(self.bytes_(8 * n), dtype="<u8").astype(np.int64)

    def string(self) -> str:
        return self.bytes_(self.u64()).decode("utf-8")

    def done(self) -> bool:
        return self.pos == len(self.buf)


def _read_item(path: str) -> _Cursor:
    with open(path, "rb") as f:
        raw = f.read()
    cur = _Cursor(snappy_frame_decompress(raw))
    version = cur.u8()
    if version != MAPAD_INDEX_VERSION:
        raise IndexVersionMismatch(version, MAPAD_INDEX_VERSION)
    return cur


def _write_item(path: str, payload: bytes):
    with open(path, "wb") as f:
        f.write(
            snappy_frame_compress(bytes([MAPAD_INDEX_VERSION]) + payload)
        )


# ---------------------------------------------------------------------------
# loaders
# ---------------------------------------------------------------------------


def is_mapad_native_index(reference_path: str) -> bool:
    return all(os.path.exists(reference_path + s) for s in MAPAD_SUFFIXES)


def _load_rank_transform(path: str) -> RankTransform:
    cur = _read_item(path)
    count = cur.u64()
    pairs = [(cur.u64(), cur.u8()) for _ in range(count)]
    if not cur.done():
        raise InvalidIndex("mapAD .trt: trailing bytes")
    symbols = bytes(sym for sym, _rank in pairs)
    rt = RankTransform(symbols)
    # vec_map iterates in key order, so ranks must match our sorted ranks
    for sym, rank in pairs:
        if rt.ranks.get(sym) != rank:
            raise InvalidIndex(
                f"mapAD .trt: unexpected rank {rank} for symbol {sym!r}"
            )
    return rt


def load_mapad_index(reference_path: str, occ_k: int = DEFAULT_OCC_K) -> Index:
    """Load a reference-built index (``mapad index -g ref.fa``) as an Index."""
    for s in MAPAD_SUFFIXES:
        if not os.path.exists(reference_path + s):
            raise InvalidIndex(
                f"mapAD native index: missing {reference_path + s}"
            )

    rt = _load_rank_transform(reference_path + ".trt")

    cur = _read_item(reference_path + ".tbw")
    bwt = np.frombuffer(cur.bytes_(cur.u64()), dtype=np.uint8)

    cur = _read_item(reference_path + ".tle")
    less = cur.u64_array(cur.u64())

    occ_cp = compute_occ_checkpoints(bwt, occ_k, len(rt))
    fmd = FmdIndex(bwt, less[: len(rt)], occ_cp, occ_k, rt)

    cur = _read_item(reference_path + ".tsa")
    sample = cur.u64_array(cur.u64())
    sampling_rate = cur.u64()
    n_extra = cur.u64()
    extra = cur.u64_array(2 * n_extra).reshape(n_extra, 2)
    sentinel = cur.u8()
    if sentinel != 0:
        raise InvalidIndex(f"mapAD .tsa: unexpected sentinel rank {sentinel}")
    ssa = SampledSuffixArray(
        fmd, sample, sampling_rate, extra[:, 0].copy(), extra[:, 1].copy()
    )

    cur = _read_item(reference_path + ".tpi")
    n_contig = cur.u64()
    contigs = []
    for _ in range(n_contig):
        start = cur.u64()
        end = cur.u64()
        contigs.append(FastaIdPosition(start, end, cur.string()))
    id_pos = FastaIdPositions(contigs)

    cur = _read_item(reference_path + ".tos")
    n_orig = cur.u64()
    positions = np.zeros(n_orig, dtype=np.int64)
    symbols = np.zeros(n_orig, dtype=np.uint8)
    for i in range(n_orig):
        positions[i] = cur.u64()
        symbols[i] = cur.u8()
    orig = OriginalSymbols(positions, symbols)

    meta = {
        "version": MAPAD_INDEX_VERSION,
        "format": "mapad-native",
        "alphabet": rt.symbols.decode("ascii"),
        "occ_k": occ_k,
        "sa_sampling_rate": int(sampling_rate),
        "text_len": int(len(bwt)),
        "contigs": [
            {"start": int(c.start), "end": int(c.end), "identifier": c.identifier}
            for c in id_pos
        ],
    }
    return Index(fmd, ssa, id_pos, orig, meta)


# ---------------------------------------------------------------------------
# writer (round-trip tests + partial export; see module docstring re .toc)
# ---------------------------------------------------------------------------


def save_mapad_index(reference_path, fmd: FmdIndex, suffix_array, id_pos_map,
                     original_symbols):
    bwt = np.asarray(fmd.bwt, dtype=np.uint8)
    _write_item(
        reference_path + ".tbw",
        struct.pack("<Q", len(bwt)) + bwt.tobytes(),
    )

    less = np.asarray(fmd.less, dtype="<u8")
    _write_item(
        reference_path + ".tle",
        struct.pack("<Q", len(less)) + less.tobytes(),
    )

    rt_pairs = sorted(fmd.rank_transform.ranks.items())
    payload = struct.pack("<Q", len(rt_pairs))
    for sym, rank in rt_pairs:
        payload += struct.pack("<QB", sym, rank)
    _write_item(reference_path + ".trt", payload)

    sample = np.asarray(suffix_array.sample, dtype="<u8")
    payload = struct.pack("<Q", len(sample)) + sample.tobytes()
    payload += struct.pack("<Q", suffix_array.sampling_rate)
    keys = np.asarray(suffix_array.extra_keys, dtype=np.int64)
    vals = np.asarray(suffix_array.extra_vals, dtype=np.int64)
    payload += struct.pack("<Q", len(keys))
    pairs = np.empty((len(keys), 2), dtype="<u8")
    pairs[:, 0] = keys
    pairs[:, 1] = vals
    payload += pairs.tobytes()
    payload += struct.pack("<B", 0)  # sentinel rank
    _write_item(reference_path + ".tsa", payload)

    payload = struct.pack("<Q", len(id_pos_map))
    for c in id_pos_map:
        ident = c.identifier.encode("utf-8")
        payload += struct.pack("<QQQ", c.start, c.end, len(ident)) + ident
    _write_item(reference_path + ".tpi", payload)

    positions = np.asarray(original_symbols.positions, dtype=np.int64)
    symbols = np.asarray(original_symbols.symbols, dtype=np.uint8)
    payload = struct.pack("<Q", len(positions))
    for p, s in zip(positions, symbols):
        payload += struct.pack("<QB", p, s)
    _write_item(reference_path + ".tos", payload)

    _write_item(
        reference_path + ".toc", _occ_payload(bwt, MAPAD_TOC_OCC_K)
    )


MAPAD_TOC_OCC_K = 128  # reference indexing.rs:188


def _occ_payload(bwt: np.ndarray, occ_k: int) -> bytes:
    """bincode payload of rust-bio `Occ { occ: Vec<Vec<usize>>, k: u32 }`:
    inclusive checkpoints (count over bwt[0..=b*k]) for every b*k < n,
    each an m-vector where m = max symbol + 1 (docstring at module top).
    Vectorized row build: a Python loop over the ~48M hg19 checkpoint
    rows would take minutes."""
    n = len(bwt)
    m = int(bwt.max()) + 1 if n else 0
    nb = -(-n // occ_k) if n else 0  # #checkpoints: i = 0, k, 2k, ... < n
    cp = compute_occ_checkpoints(bwt, occ_k, m)  # exclusive, (nb+1, m)
    rows = np.empty((nb, m + 1), dtype="<u8")
    rows[:, 0] = m  # each inner Vec's u64 length prefix
    rows[:, 1:] = cp[:nb]
    # exclusive -> inclusive: add bwt[b*k] to its own checkpoint
    at_cp = bwt[: nb * occ_k : occ_k]
    np.add.at(rows, (np.arange(nb), at_cp.astype(np.int64) + 1), 1)
    return (
        struct.pack("<Q", nb) + rows.tobytes() + struct.pack("<I", occ_k)
    )


def load_mapad_occ(path: str):
    """Parse a NAME.toc back into (inclusive checkpoint matrix (nb, m)
    int64, k).  The runtime itself re-derives checkpoints from the BWT;
    this parser pins the emitted layout in tests and serves external
    tooling."""
    cur = _read_item(path)
    nb = cur.u64()
    rows = []
    m = None
    for _ in range(nb):
        mm = cur.u64()
        if m is None:
            m = mm
        elif mm != m:
            raise InvalidIndex("mapAD .toc: ragged checkpoint rows")
        rows.append(cur.u64_array(mm))
    k = struct.unpack("<I", cur.bytes_(4))[0]
    if not cur.done():
        raise InvalidIndex("mapAD .toc: trailing bytes")
    occ = (
        np.stack(rows).astype(np.int64)
        if rows else np.zeros((0, 0), np.int64)
    )
    return occ, int(k)
