"""Wire protocol for the dispatcher/worker cluster mode.

Counterpart of reference src/distributed/mod.rs + comm_buffers.rs: messages
are length-prefixed binary frames over TCP.  Instead of bincode, a small
explicit struct codec is used (no arbitrary object deserialization).

Frame: [u64 LE total_size][u8 msg_type][payload]; total_size includes the
9-byte header, mirroring the reference's self-describing first field
(distributed/mod.rs:14-18).
"""

from __future__ import annotations

import json
import struct
from dataclasses import dataclass

import numpy as np

from ..index.fmd import BiInterval
from ..io.bam import _decode_tags, _encode_tags
from ..io.sniff import TaskSheet
from ..map import AlignmentParameters, EditOperation, HitInterval
from ..map.record import Record

MSG_TASK = 1
MSG_RESULT = 2

HEADER = struct.Struct("<QB")


# --- AlignmentParameters <-> JSON (small, field-validated) ---


def params_to_json(p: AlignmentParameters) -> bytes:
    from ..models import Continuous, Discrete, SimpleAncientDnaModel, TestBound
    from ..models import TestDifferenceModel, VindijaPwm

    dm = p.difference_model
    if isinstance(dm, SimpleAncientDnaModel):
        dmj = {
            "kind": "adna",
            "library_prep": [dm.library_prep[0]] + [float(x) for x in dm.library_prep[1:]],
            "ds": float(dm.ds_deamination_rate),
            "ss": float(dm.ss_deamination_rate),
            "div": float(dm.divergence),
            "ignore_bq": dm.use_default_base_quality is not None,
        }
    elif isinstance(dm, VindijaPwm):
        dmj = {"kind": "vindija"}
    elif isinstance(dm, TestDifferenceModel):
        dmj = {
            "kind": "test",
            "deam": float(dm.deam_score), "mm": float(dm.mm_score),
            "match": float(dm.match_score),
        }
    else:
        raise TypeError(f"unknown model {type(dm)}")

    mb = p.mismatch_bound
    if isinstance(mb, Discrete):
        mbj = {
            "kind": "discrete", "p": float(mb.poisson_threshold),
            "rate": float(mb.base_error_rate),
            "repr": float(mb.representative_mismatch_penalty),
        }
    elif isinstance(mb, Continuous):
        mbj = {
            "kind": "continuous", "cutoff": float(mb.cutoff),
            "exp": float(mb.exponent),
            "repr": float(mb.representative_mismatch_penalty),
        }
    elif isinstance(mb, TestBound):
        mbj = {
            "kind": "testbound", "threshold": float(mb.threshold),
            "repr": float(mb.representative_mm_bound),
        }
    else:
        raise TypeError(f"unknown bound {type(mb)}")

    return json.dumps(
        {
            "difference_model": dmj,
            "mismatch_bound": mbj,
            "penalty_gap_open": float(p.penalty_gap_open),
            "penalty_gap_extend": float(p.penalty_gap_extend),
            "chunk_size": p.chunk_size,
            "gap_dist_ends": p.gap_dist_ends,
            "max_num_gaps_open": p.max_num_gaps_open,
            "stack_limit_abort": p.stack_limit_abort,
        }
    ).encode()


def params_from_json(blob: bytes) -> AlignmentParameters:
    from ..models import Continuous, Discrete, SimpleAncientDnaModel, TestBound
    from ..models import TestDifferenceModel, VindijaPwm

    d = json.loads(blob)
    dmj = d["difference_model"]
    if dmj["kind"] == "adna":
        lp = dmj["library_prep"]
        dm = SimpleAncientDnaModel(
            tuple([lp[0]] + [np.float32(x) for x in lp[1:]]),
            dmj["ds"], dmj["ss"], dmj["div"], dmj["ignore_bq"],
        )
    elif dmj["kind"] == "vindija":
        dm = VindijaPwm()
    elif dmj["kind"] == "test":
        dm = TestDifferenceModel(dmj["deam"], dmj["mm"], dmj["match"])
    else:
        raise ValueError(dmj["kind"])

    mbj = d["mismatch_bound"]
    if mbj["kind"] == "discrete":
        mb = Discrete(mbj["p"], mbj["rate"], mbj["repr"])
    elif mbj["kind"] == "continuous":
        mb = Continuous(mbj["cutoff"], mbj["exp"], mbj["repr"])
    elif mbj["kind"] == "testbound":
        mb = TestBound(mbj["threshold"], mbj["repr"])
    else:
        raise ValueError(mbj["kind"])

    return AlignmentParameters(
        difference_model=dm,
        mismatch_bound=mb,
        penalty_gap_open=np.float32(d["penalty_gap_open"]),
        penalty_gap_extend=np.float32(d["penalty_gap_extend"]),
        chunk_size=d["chunk_size"],
        gap_dist_ends=d["gap_dist_ends"],
        max_num_gaps_open=d["max_num_gaps_open"],
        stack_limit_abort=d["stack_limit_abort"],
    )


# --- record / hit codecs ---


def _pack_bytes(out: bytearray, b: bytes | None):
    if b is None:
        out += struct.pack("<i", -1)
    else:
        out += struct.pack("<i", len(b)) + b


def _unpack_bytes(buf, pos):
    (ln,) = struct.unpack_from("<i", buf, pos)
    pos += 4
    if ln < 0:
        return None, pos
    return bytes(buf[pos : pos + ln]), pos + ln


def encode_record(out: bytearray, r: Record):
    _pack_bytes(out, r.name)
    out += struct.pack("<H", r.bam_flags)
    _pack_bytes(out, bytes(r.sequence))
    _pack_bytes(out, bytes(r.base_qualities))
    tag_blob = _encode_tags(r.bam_tags)
    _pack_bytes(out, tag_blob)


def decode_record(buf, pos):
    name, pos = _unpack_bytes(buf, pos)
    (flags,) = struct.unpack_from("<H", buf, pos)
    pos += 2
    seq, pos = _unpack_bytes(buf, pos)
    quals, pos = _unpack_bytes(buf, pos)
    tag_blob, pos = _unpack_bytes(buf, pos)
    tags = _decode_tags(tag_blob)
    return Record(seq, quals, name, tags, flags), pos


def encode_hit(out: bytearray, h: HitInterval):
    out += struct.pack(
        "<qqqf", h.interval.lower, h.interval.lower_rev, h.interval.size,
        float(h.alignment_score),
    )
    out += struct.pack("<I", len(h.edit_operations))
    for op in h.edit_operations:
        out += struct.pack("<BHB", op.kind, op.pos, op.base)


def decode_hit(buf, pos):
    lower, lrev, size, score = struct.unpack_from("<qqqf", buf, pos)
    pos += 28
    (n_ops,) = struct.unpack_from("<I", buf, pos)
    pos += 4
    ops = []
    for _ in range(n_ops):
        kind, p, base = struct.unpack_from("<BHB", buf, pos)
        pos += 4
        ops.append(EditOperation(kind, p, base))
    return HitInterval(BiInterval(lower, lrev, size), np.float32(score), ops), pos


# --- messages ---


def encode_task_sheet(sheet: TaskSheet) -> bytes:
    out = bytearray()
    out += struct.pack("<I", sheet.chunk_id)
    _pack_bytes(out, sheet.reference_path.encode() if sheet.reference_path else None)
    _pack_bytes(
        out,
        params_to_json(sheet.alignment_parameters)
        if sheet.alignment_parameters
        else None,
    )
    out += struct.pack("<I", len(sheet.records))
    for r in sheet.records:
        encode_record(out, r)
    return frame(MSG_TASK, bytes(out))


def decode_task_sheet(payload) -> TaskSheet:
    pos = 0
    (chunk_id,) = struct.unpack_from("<I", payload, pos)
    pos += 4
    ref, pos = _unpack_bytes(payload, pos)
    params_blob, pos = _unpack_bytes(payload, pos)
    (n,) = struct.unpack_from("<I", payload, pos)
    pos += 4
    records = []
    for _ in range(n):
        r, pos = decode_record(payload, pos)
        records.append(r)
    return TaskSheet(
        chunk_id, records,
        reference_path=ref.decode() if ref else None,
        alignment_parameters=params_from_json(params_blob) if params_blob else None,
    )


def encode_result_sheet(chunk_id: int, results) -> bytes:
    """results: [(record, hits, duration_seconds)]"""
    out = bytearray()
    out += struct.pack("<I", chunk_id)
    out += struct.pack("<I", len(results))
    for record, hits, duration in results:
        encode_record(out, record)
        out += struct.pack("<f", float(duration))
        out += struct.pack("<H", len(hits))
        for h in hits:
            encode_hit(out, h)
    return frame(MSG_RESULT, bytes(out))


def decode_result_sheet(payload):
    pos = 0
    (chunk_id,) = struct.unpack_from("<I", payload, pos)
    pos += 4
    (n,) = struct.unpack_from("<I", payload, pos)
    pos += 4
    results = []
    for _ in range(n):
        record, pos = decode_record(payload, pos)
        (duration,) = struct.unpack_from("<f", payload, pos)
        pos += 4
        (n_hits,) = struct.unpack_from("<H", payload, pos)
        pos += 2
        hits = []
        for _ in range(n_hits):
            h, pos = decode_hit(payload, pos)
            hits.append(h)
        results.append((record, hits, duration))
    return chunk_id, results


def frame(msg_type: int, payload: bytes) -> bytes:
    return HEADER.pack(HEADER.size + len(payload), msg_type) + payload


def read_message(sock):
    """Blocking read of one framed message -> (msg_type, payload) or None on EOF."""
    header = _read_exact(sock, HEADER.size)
    if header is None:
        return None
    total, msg_type = HEADER.unpack(header)
    payload = _read_exact(sock, total - HEADER.size)
    if payload is None:
        return None
    return msg_type, payload


def _read_exact(sock, size):
    buf = bytearray()
    while len(buf) < size:
        chunk = sock.recv(size - len(buf))
        if not chunk:
            return None
        buf += chunk
    return bytes(buf)
