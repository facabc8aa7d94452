"""CRAM input in mapad_tpu_torch against mapad_tpu: the JAX package's own
CRAM cases run on the port, the port's CramWriter writes mapad_tpu's bytes
for every block method and CRAM 3.1 codec, both readers decode the same
records from each file, `InputSource` yields the same records, and `map
--engine native` of a CRAM gives mapad_tpu's BAM."""

import functools
import gzip
import io

import numpy as np
import pytest

from mapad_tpu.io import cram as jcram
from mapad_tpu.io.sniff import InputSource as JInputSource
from mapad_tpu_torch.io import cram as tcram
from mapad_tpu_torch.io.sniff import InputSource as TInputSource
from torch_port_helpers import bam_records, port_twin

# tests/test_cram.py's cases, every one of them on the port's modules
globals().update({k: v for k, v in port_twin("test_cram").items()
                  if k.startswith("test_")})

HEADER = ("@HD\tVN:1.6\tSO:unsorted\n@SQ\tSN:chr1\tLN:64\n"
          "@RG\tID:lab1\tSM:sample\n")

# the codecs of CRAM 3.0 (one method for every block) and the stream
# codecs of CRAM 3.1 as real writers apply them: tok3 on the names (6),
# fqzcomp on the qualities (9), arith on the bases (8), rANS-Nx16 on the
# rest
_NX16_ALL = {i: jcram.M_RANSNX16 for i in range(1, 20)}
METHODS = {
    "raw": (jcram.M_RAW, (3, 0)),
    "gzip": (jcram.M_GZIP, (3, 0)),
    "bzip2": (jcram.M_BZIP2, (3, 0)),
    "lzma": (jcram.M_LZMA, (3, 0)),
    "rans4x8": (jcram.M_RANS4X8, (3, 0)),
    "rans_nx16": (jcram.M_RANSNX16, (3, 1)),
    "arith": (jcram.M_ARITH, (3, 1)),
    "fqzcomp_tok3": ({6: jcram.M_TOK3, 9: jcram.M_FQZCOMP}, (3, 1)),
    "all_31": ({**_NX16_ALL, 6: jcram.M_TOK3, 8: jcram.M_ARITH,
                9: jcram.M_FQZCOMP}, (3, 1)),
}


@pytest.fixture(autouse=True)
def _gzip_without_a_clock(monkeypatch):
    """gzip stamps the time of compression into its header: pin it, so
    that two writers' bytes can be compared."""
    monkeypatch.setattr(gzip, "compress",
                        functools.partial(gzip.compress, mtime=0))


def _unmapped(rng, i):
    n = int(rng.integers(20, 90))
    flags = jcram.BF_UNMAPPED | (jcram.BF_REVERSE if i % 3 == 1 else 0)
    tags = [(b"XY", "i", int(rng.integers(-1000, 1000)))] if i % 4 == 0 else []
    if i % 5 == 2:
        tags.append((b"ZA", "Z", f"note{i}"))
    return {"name": b"A00%d:1:HX:%d:%d" % (i % 7, i, 3 * i + 1),
            "flags": flags,
            "seq": bytes(rng.choice(np.frombuffer(b"ACGTN", np.uint8), n,
                                    p=[0.24, 0.24, 0.24, 0.24, 0.04])),
            "quals": bytes(rng.integers(2, 42, n, dtype=np.uint8)),
            "tags": tags}


def _chunks(seed):
    """Two chunks of unmapped records and one of mapped records against an
    embedded reference (substitution, deletion and insertion features)."""
    rng = np.random.default_rng(seed)
    ref = bytes(rng.choice(np.frombuffer(b"ACGT", np.uint8), 64))
    mapped = [
        {"name": b"m%d" % i, "flags": 16 if i % 2 else 0, "pos": 3 + 5 * i,
         "mapq": 20 + i, "rl": 12, "quals": bytes([30 + i] * 12),
         "tags": [(b"NM", "i", i)],
         "features": [("X", 4, i % 4), ("D", 7, 2), ("I", 9, b"TT")]}
        for i in range(4)
    ]
    return [
        ([_unmapped(rng, i) for i in range(40)], {}),
        ([_unmapped(rng, i) for i in range(40, 57)], {}),
        (mapped, {"embedded_ref": ref, "ref_id": 0, "start": 1}),
    ]


def _write(mod, method, version, seed=3):
    buf = io.BytesIO()
    w = mod.CramWriter(buf, HEADER, block_method=method, version=version)
    for recs, kw in _chunks(seed):
        w.write_chunk(recs, **kw)
    w.close()
    return buf.getvalue()


def _fields(r):
    return (r.name, r.flags, r.ref_id, r.pos, r.mapq, r.sequence, r.quals,
            [tuple(t) for t in r.tags], r.read_group)


@pytest.mark.parametrize("method", sorted(METHODS))
def test_port_cram_writer_writes_the_jax_packages_bytes(method):
    m, version = METHODS[method]
    ours, theirs = _write(tcram, m, version), _write(jcram, m, version)
    assert ours[4:6] == bytes(version)
    assert ours == theirs


@pytest.mark.parametrize("method", sorted(METHODS))
def test_port_cram_reader_decodes_the_same_records(method):
    data = _write(jcram, *METHODS[method])
    theirs = list(jcram.CramReader(io.BytesIO(data)))
    ours = list(tcram.CramReader(io.BytesIO(data)))
    assert tcram.CramReader(io.BytesIO(data)).header_text == \
        jcram.CramReader(io.BytesIO(data)).header_text
    assert len(ours) == len(theirs) == 61
    assert [_fields(r) for r in ours] == [_fields(r) for r in theirs]
    # the unmapped records come back as written
    want = [r for recs, _ in _chunks(3)[:2] for r in recs]
    assert [(r.name, r.sequence, r.quals) for r in ours[:57]] == [
        (r["name"], r["seq"], r["quals"]) for r in want]


@pytest.mark.parametrize("method", ["gzip", "all_31"])
def test_port_input_source_yields_the_same_records(tmp_path, method):
    path = tmp_path / "in.cram"
    path.write_bytes(_write(jcram, *METHODS[method]))
    ours, theirs = (TInputSource.from_path(str(path)),
                    JInputSource.from_path(str(path)))
    assert ours.kind == theirs.kind == "cram"
    assert ours.header.to_text() == theirs.header.to_text()

    def sheets(src):
        return [(t.chunk_id, [(r.name, r.sequence, r.base_qualities,
                               r.bam_flags, r.bam_tags) for r in t.records])
                for t in src.task_queue(16)]

    got, want = sheets(ours), sheets(theirs)
    assert len(got) == len(want) >= 3
    assert got == want


def _cram_of_the_fixture(tmp_path):
    """The integration fixture's reads (tests/test_integration.py) as a
    CRAM 3.1 with the stream codecs, every record unmapped."""
    from test_integration import INPUT_HEADER_TEXT, _input_reads, prepare

    genome, _bam, _params = prepare(tmp_path)
    recs = [
        {"name": name, "flags": flags | jcram.BF_UNMAPPED, "seq": seq,
         "quals": bytes(q - 33 for q in qual),
         "tags": [(k, t, v.decode() if isinstance(v, bytes) else v)
                  for k, t, v in tags if k != b"RG"]}
        for name, flags, seq, qual, tags in _input_reads()
    ]
    path = tmp_path / "input_reads.cram"
    buf = io.BytesIO()
    w = tcram.CramWriter(buf, INPUT_HEADER_TEXT,
                         block_method=METHODS["all_31"][0], version=(3, 1))
    w.write_chunk(recs[:9])
    w.write_chunk(recs[9:])
    w.close()
    path.write_bytes(buf.getvalue())
    return genome, path


def test_port_native_map_of_a_cram_equals_the_jax_packages(tmp_path):
    from mapad_tpu.cli import main as j_main
    from mapad_tpu_torch.cli import main as t_main

    genome, cram_path = _cram_of_the_fixture(tmp_path)
    flags = ["-p", "0.03", "-l", "single_stranded", "-f", "0.6", "-t",
             "0.55", "-d", "0.01", "-s", "1.0", "-i", "0.001", "--engine",
             "native"]
    outs = {}
    for tag, main in (("port", t_main), ("jax", j_main)):
        outs[tag] = tmp_path / f"{tag}.bam"
        assert main(["map", "-r", str(cram_path), "-g", str(genome), "-o",
                     str(outs[tag]), *flags]) == 0
    ours, theirs = bam_records(outs["port"]), bam_records(outs["jax"])
    assert len(ours) == 17
    assert ours == theirs
    assert sum(1 for r in ours if not r[1] & 0x4) >= 10
