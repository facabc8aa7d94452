"""The port's sequential Python search (`map/oracle.py`, `--engine oracle`)
and its Python per-record BAM conversion (`map/postprocess.py`,
MAPAD_NO_NATIVE_POST) against the JAX package's: equal hits on the reads of
tests/test_search_oracle.py, equal BAM records field for field, and equal
BAMs through the CLI."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import mapad_tpu.map.oracle as j_oracle  # noqa: E402
import mapad_tpu.map.postprocess as j_post  # noqa: E402
import mapad_tpu_torch.map.oracle as t_oracle  # noqa: E402
import mapad_tpu_torch.map.postprocess as t_post  # noqa: E402
from mapad_tpu.cli import main as j_main  # noqa: E402
from mapad_tpu.index.builder import (  # noqa: E402
    build_auxiliary_structures,
    build_from_sequences,
)
from mapad_tpu_torch.cli import main as t_main  # noqa: E402
from mapad_tpu_torch.index.builder import (  # noqa: E402
    build_auxiliary_structures as t_build,
    build_from_sequences as t_build_from_sequences,
)
from mapad_tpu_torch.io.bam import BamReader  # noqa: E402
from mapad_tpu_torch.map.pipeline import OracleSearchEngine  # noqa: E402
from test_integration import prepare  # noqa: E402
from torch_port_helpers import adna_params, bench_ref, hits_equal, records  # noqa: E402


def _params(pkg, model, bound, gap_open, gap_extend, gap_dist_ends=0,
            max_gaps=2):
    models = __import__(f"{pkg}.models", fromlist=["x"])
    mapping = __import__(f"{pkg}.map", fromlist=["x"])
    if model[0] == "test":
        dm = models.TestDifferenceModel(deam_score=model[1],
                                        mm_score=model[2], match_score=0.0)
    else:
        dm = models.VindijaPwm()
    repr_mm = dm.get_representative_mismatch_penalty()
    if bound[0] == "test":
        mmb = models.TestBound(
            threshold=bound[1],
            representative_mm_bound=repr_mm if bound[2] is None else bound[2])
    else:
        mmb = models.Discrete(0.01, 0.02, repr_mm)
    if gap_open is None:  # test_corner_cases: multiples of the penalty
        gap_open = np.float32(3.0) * repr_mm
        gap_extend = np.float32(0.6) * repr_mm
    return mapping.AlignmentParameters(
        difference_model=dm, mismatch_bound=mmb, penalty_gap_open=gap_open,
        penalty_gap_extend=gap_extend, chunk_size=1,
        gap_dist_ends=gap_dist_ends, stack_limit_abort=False,
        max_num_gaps_open=max_gaps,
    )


_CORNER_REF = (b"GTTGTATTTTTAGTAGAGACAGGGTTTCATCATGTTGGCCAG" + b"A" * 20
               + b"TTTGTATTTTTAGTAGAGACAGGCTTTCATCATGTTGGCCAG")
# the searches of tests/test_search_oracle.py:
# (reference, pattern, quality, parameter arguments)
SEARCHES = {
    "inexact": (b"ACGTACGTACGTACGT", b"GTTC", 0,
                (("test", -0.5, -1.0), ("test", -1.0, -1.0), -2.0, -1.0)),
    "reverse_strand": (b"GAAAAG", b"TTTT", 0,
                       (("test", -10.0, -10.0), ("test", -1.0, -10.0),
                        -20.0, -10.0)),
    "gapped": (b"TAT", b"TT", 0,
               (("test", -10.0, -10.0), ("test", -3.0, -10.0), -2.0, -1.0)),
    "gap_middle": (b"AAAAAAGGGGAAAAAA", b"AAAAAAAAAAAA", 0,
                   (("test", -10.0, -10.0), ("test", -6.0, -10.0), -2.0,
                    -1.0, 5)),
    "gap_read_end": (b"AAAAAAGGGGAAAAAA", b"AGGGAAAAAA", 0,
                     (("test", -10.0, -10.0), ("test", -6.0, -10.0), -2.0,
                      -1.0, 5)),
    "one_gap": (b"CTAGCCAGCGATTTACATGCTCTCGGAATATCGACATGTA",
                b"CTAGCCAGCGAACATGCTCTCGGAATATCGACATGTA", 0,
                (("test", -10.0, -10.0), ("test", -6.0, -10.0), -2.0, -1.0,
                 5, 1)),
    "two_gaps": (b"CTAGCCAGCGATTTACATGCTCTCGGAATATCGACATGTA",
                 b"CTAGCCAGCGATTACATGCTCTCGGAATTCGACATGTA", 0,
                 (("test", -10.0, -10.0), ("test", -6.0, -10.0), -2.0, -1.0,
                  5, 1)),
    "vindija_deaminated": (b"CCCCCC", b"TTCCCT", 40,
                           (("vindija",), ("test", -30.0, None), -200.0,
                            -100.0)),
    "vindija_exact": (b"CCCCCC", b"CCCCCC", 0,
                      (("vindija",), ("test", -30.0, None), -200.0, -100.0)),
    "vindija_mismatch": (b"AAAAAA", b"AAGAAA", 0,
                         (("vindija",), ("test", -30.0, None), -200.0,
                          -100.0)),
    "corner_cases": (_CORNER_REF,
                     b"GTTGTATTTTTAGTAGAGACAGGCTTTCATCATGTTGGCCAG", 40,
                     (("vindija",), ("discrete",), None, None)),
}


@pytest.mark.parametrize("case", sorted(SEARCHES))
def test_oracle_search_equals_jax_package(case):
    ref, pattern, qual, args = SEARCHES[case]
    jfmd, _ = build_auxiliary_structures(ref, b"ACGT")
    tfmd, _ = t_build(ref, b"ACGT")
    quals = [qual] * len(pattern)
    want = j_oracle.k_mismatch_search(pattern, quals,
                                      _params("mapad_tpu", *args), jfmd)
    got = t_oracle.k_mismatch_search(pattern, quals,
                                     _params("mapad_tpu_torch", *args), tfmd)
    assert hits_equal(got, want)
    assert (len(got) == 0) == (case in ("gap_read_end", "two_gaps"))


@pytest.fixture(scope="module")
def bench():
    """(fmd, sampled suffix array, contig map, original symbols) of the
    bench reference as two contigs, from either package."""
    ref = bench_ref()
    contigs = [("chrA", ref[:3000]), ("chrB", ref[3000:])]
    return build_from_sequences(contigs), t_build_from_sequences(contigs)


def _bench_reads(n, seed=3):
    ref = bench_ref()
    rng = np.random.default_rng(seed)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    reads = []
    for _ in range(n):
        ln = int(rng.integers(20, 61))
        start = int(rng.integers(0, len(ref) - ln))
        seq = bytearray(ref[start : start + ln])
        for _ in range(int(rng.integers(0, 3))):
            seq[int(rng.integers(0, ln))] = int(rng.choice(bases))
        reads.append(bytes(seq))
    reads.append(bytes(rng.choice(bases, size=40)))  # unmapped
    return reads


def test_oracle_engine_and_bam_records_equal_jax_package(bench):
    """`OracleSearchEngine.search_chunk`, then `intervals_to_bam` on its
    hits: every field and tag of every record equal (XD, the search time,
    aside)."""
    from mapad_tpu.map.pipeline import OracleSearchEngine as JOracle

    (jfmd, jsa, jmap, jorig), (tfmd, tsa, tmap, torig) = bench
    reads = _bench_reads(12)
    jp, tp = adna_params("mapad_tpu"), adna_params("mapad_tpu_torch")
    jrecs, trecs = records("mapad_tpu", reads), records("mapad_tpu_torch",
                                                        reads)
    jout = JOracle(jfmd, jp).search_chunk(jrecs)
    tout = OracleSearchEngine(tfmd, tp).search_chunk(trecs)
    assert len(tout) == len(reads)
    mapped = 0
    for i, ((jh, _), (th, _)) in enumerate(zip(jout, tout)):
        assert hits_equal(th, jh), i
        want = j_post.intervals_to_bam(
            jrecs[i], jh, jsa, jmap, jorig, 0.25, jp, "rg1",
            j_post.SplitMixRng(1000 + i))
        got = t_post.intervals_to_bam(
            trecs[i], th, tsa, tmap, torig, 0.25, tp, "rg1",
            t_post.SplitMixRng(1000 + i))
        for f in ("name", "flags", "ref_id", "pos", "mapq", "cigar",
                  "sequence", "quals"):
            assert getattr(got, f) == getattr(want, f), (i, f)
        assert [(bytes(t), c, v) for t, c, v in got.tags] == [
            (bytes(t), c, v) for t, c, v in want.tags], i
        mapped += not got.flags & 0x4
    assert 0 < mapped < len(reads)


def _bam(path):
    with open(path, "rb") as f:
        reader = BamReader(f)
        header = [
            "\t".join(x for x in line.split("\t") if not x.startswith("CL:"))
            for line in reader.header_text.splitlines()
        ]
        return header, [
            (r.name, r.flags, r.ref_id, r.pos, r.mapq, r.cigar_string(),
             r.sequence, r.quals,
             [(bytes(t), tc, v) for t, tc, v in r.tags if bytes(t) != b"XD"])
            for r in reader
        ]


_FLAGS = ["-p", "0.03", "-l", "single_stranded", "-f", "0.6", "-t", "0.55",
          "-d", "0.01", "-s", "1.0", "-i", "0.001", "--batch_size", "7"]


def test_cli_engine_oracle_equals_jax_cli(tmp_path):
    """`--engine oracle` runs the sequential Python search through the chunk
    loop; its BAM equals the JAX package's."""
    genome, input_bam, _ = prepare(tmp_path)
    io = ["-r", str(input_bam), "-g", str(genome)]
    assert t_main(["map", *io, *_FLAGS, "-o", str(tmp_path / "t.bam"),
                   "--engine", "oracle"]) == 0
    assert j_main(["map", *io, *_FLAGS, "-o", str(tmp_path / "j.bam"),
                   "--engine", "oracle"]) == 0
    got = _bam(tmp_path / "t.bam")
    assert got == _bam(tmp_path / "j.bam")
    assert len(got[1]) == 17 and sum(not r[1] & 0x4 for r in got[1]) > 4


@pytest.mark.parametrize("engine", ["oracle", "native", "device"])
def test_cli_python_postprocess_equals_native_postprocess(tmp_path, engine,
                                                          monkeypatch):
    """MAPAD_NO_NATIVE_POST=1: the Python per-record conversion writes the
    BAM the C++ postprocessor writes, through the chunk loop (oracle,
    native) and the streaming pipeline (device)."""
    genome, input_bam, _ = prepare(tmp_path)
    monkeypatch.setenv("MAPAD_POOL_STEPS", "2048")
    monkeypatch.setenv("MAPAD_BLOCK_READS", "8")
    argv = ["--threads", "2", "map", "-r", str(input_bam), "-g", str(genome),
            *_FLAGS, "--engine", engine, "--lanes", "8", "--device", "cpu"]
    assert t_main([*argv, "-o", str(tmp_path / "cpp.bam")]) == 0
    monkeypatch.setenv("MAPAD_NO_NATIVE_POST", "1")
    assert t_main([*argv, "-o", str(tmp_path / "py.bam")]) == 0
    got = _bam(tmp_path / "py.bam")
    assert got == _bam(tmp_path / "cpp.bam")
    assert len(got[1]) == 17 and sum(not r[1] & 0x4 for r in got[1]) > 4
