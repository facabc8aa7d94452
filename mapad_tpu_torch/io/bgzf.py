"""BGZF (blocked gzip) reader/writer using zlib (replaces noodles-bgzf)."""

from __future__ import annotations

import struct
import zlib

BGZF_EOF = bytes.fromhex(
    "1f8b08040000000000ff0600424302001b0003000000000000000000"
)
MAX_BLOCK_UNCOMPRESSED = 65280


class BgzfWriter:
    def __init__(self, fileobj, compresslevel: int = 6):
        self._f = fileobj
        self._buf = bytearray()
        self._level = compresslevel
        self._closed = False

    def write(self, data: bytes):
        self._buf += data
        while len(self._buf) >= MAX_BLOCK_UNCOMPRESSED:
            self._flush_block(self._buf[:MAX_BLOCK_UNCOMPRESSED])
            del self._buf[:MAX_BLOCK_UNCOMPRESSED]

    def _flush_block(self, chunk: bytes):
        chunk = bytes(chunk)
        co = zlib.compressobj(self._level, zlib.DEFLATED, -15)
        cdata = co.compress(chunk) + co.flush()
        header = (
            b"\x1f\x8b\x08\x04"
            + b"\x00\x00\x00\x00"  # MTIME
            + b"\x00\xff"  # XFL, OS
            + struct.pack("<H", 6)  # XLEN
            + b"BC"
            + struct.pack("<H", 2)
            + struct.pack("<H", len(cdata) + 25)  # BSIZE - 1
        )
        crc = zlib.crc32(chunk) & 0xFFFFFFFF
        self._f.write(header + cdata + struct.pack("<II", crc, len(chunk)))

    def flush(self):
        while self._buf:
            chunk = self._buf[:MAX_BLOCK_UNCOMPRESSED]
            del self._buf[:MAX_BLOCK_UNCOMPRESSED]
            self._flush_block(chunk)

    def close(self):
        if self._closed:
            return
        self.flush()
        self._f.write(BGZF_EOF)
        self._f.flush()
        self._closed = True

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class BgzfReader:
    """Decompresses a whole BGZF stream into memory-backed chunks."""

    def __init__(self, fileobj):
        self._f = fileobj
        self._chunks = []
        self._pos = 0
        self._data = None

    def _inflate_all(self):
        out = []
        raw = self._f.read()
        pos = 0
        n = len(raw)
        while pos + 18 <= n:
            if raw[pos : pos + 2] != b"\x1f\x8b":
                raise ValueError("corrupt BGZF stream")
            xlen = struct.unpack_from("<H", raw, pos + 10)[0]
            # find BC subfield
            extra = raw[pos + 12 : pos + 12 + xlen]
            bsize = None
            off = 0
            while off + 4 <= len(extra):
                si1, si2, slen = extra[off], extra[off + 1], struct.unpack_from("<H", extra, off + 2)[0]
                if si1 == 0x42 and si2 == 0x43 and slen == 2:
                    bsize = struct.unpack_from("<H", extra, off + 4)[0] + 1
                off += 4 + slen
            if bsize is None:
                raise ValueError("BGZF: missing BC subfield")
            cdata = raw[pos + 12 + xlen : pos + bsize - 8]
            isize = struct.unpack_from("<I", raw, pos + bsize - 4)[0]
            if isize:
                out.append(zlib.decompress(cdata, -15, isize + 16))
            pos += bsize
        return b"".join(out)

    def read_all(self) -> bytes:
        if self._data is None:
            self._data = self._inflate_all()
        return self._data


class BgzfStream:
    """Streaming BGZF inflater: decompresses one block at a time so
    arbitrarily large BAM inputs map in bounded memory."""

    def __init__(self, fileobj):
        self._f = fileobj
        self._buf = bytearray()
        self._off = 0
        self._eof = False

    def _inflate_next(self) -> bool:
        head = self._f.read(12)
        if not head:
            self._eof = True
            return False
        if len(head) < 12 or head[:2] != b"\x1f\x8b":
            raise ValueError("corrupt BGZF stream")
        xlen = struct.unpack_from("<H", head, 10)[0]
        extra = self._f.read(xlen)
        bsize = None
        off = 0
        while off + 4 <= len(extra):
            si1, si2, slen = extra[off], extra[off + 1], struct.unpack_from(
                "<H", extra, off + 2
            )[0]
            if si1 == 0x42 and si2 == 0x43 and slen == 2:
                bsize = struct.unpack_from("<H", extra, off + 4)[0] + 1
            off += 4 + slen
        if bsize is None:
            raise ValueError("BGZF: missing BC subfield")
        rest = self._f.read(bsize - 12 - xlen)
        cdata = rest[:-8]
        isize = struct.unpack_from("<I", rest, len(rest) - 4)[0]
        if isize:
            self._buf += zlib.decompress(cdata, -15, isize + 16)
        return True

    def read(self, n: int) -> bytes:
        while len(self._buf) - self._off < n and not self._eof:
            self._inflate_next()
            if self._off > MAX_BLOCK_UNCOMPRESSED * 4:
                del self._buf[: self._off]
                self._off = 0
        avail = len(self._buf) - self._off
        if avail == 0 and n > 0:
            return b""
        if avail < n:
            raise ValueError("BGZF: truncated stream")
        out = bytes(self._buf[self._off : self._off + n])
        self._off += n
        return out


def is_bgzf(magic: bytes) -> bool:
    return magic[:4] == b"\x1f\x8b\x08\x04"
