"""BAM header construction and the input-tag filter.

Counterpart of mapad_tpu/map/postprocess.py, reduced to what the native
postprocess path (map/native_post.py) needs: the per-record conversion
itself runs in C++ (csrc/host/postprocess.cpp).  Reference
src/map/mapping.rs:298-398 and :834-837.
"""

from __future__ import annotations

import sys

from .. import CRATE_NAME, build_info_version
from ..io.bam import SamHeader

# BWA/mapAD-specific aux tags stripped from the input (mapping.rs:834-837)
TAG_FILTER = {
    b"AS", b"MD", b"NM", b"X0", b"X1", b"XA", b"XD", b"XE", b"XF", b"XG",
    b"XM", b"XN", b"XO", b"XS", b"XT",
}



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
