"""mapAD's input as its users supply it, through the port against
mapad_tpu on the CPU: a small unaligned pipeline BAM (tools/pipeline_bam.py:
pairs with overlong mates, QC-failed reads, reads stored reverse-
complemented under 0x10 beside their forward twins, IUPAC and `=` bases,
zero-length and quality-less records, tags to keep and tags to filter)
through `pipeline.run` with the port's pool engine (the plain kernels) in
both interval widths against mapad_tpu's, with a block of quality-less
reads (the host-scored upload) beside blocks of the device-LUT upload;
through both CLIs with and without `-R`, from stdin and as a gzipped FASTQ
of its merged reads; and through the port's dispatcher and workers, a
worker's death and the requeue of its chunk included.  BAMs are compared
record for record (tags in order, XD aside) and held to the input
(`pipeline_bam.check_output`)."""

import gzip
import io
import socket
import sys
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from mapad_tpu.cli import main as j_main  # noqa: E402
from mapad_tpu.distributed.dispatcher import Dispatcher as JDispatcher  # noqa: E402
from mapad_tpu.distributed.worker import Worker as JWorker  # noqa: E402
from mapad_tpu.index.runtime import load_index as j_load_index  # noqa: E402
from mapad_tpu.map import pipeline as j_pipeline  # noqa: E402
from mapad_tpu.map.native_search import NativeSearchEngine as JNative  # noqa: E402
from mapad_tpu.ops.engine import DeviceSearchEngine as JEngine  # noqa: E402
from mapad_tpu.ops.search_pool import PoolConfig as JPoolConfig  # noqa: E402
from mapad_tpu_torch.cli import main as t_main  # noqa: E402
from mapad_tpu_torch.distributed import wire as twire  # noqa: E402
from mapad_tpu_torch.distributed.dispatcher import Dispatcher  # noqa: E402
from mapad_tpu_torch.distributed.worker import Worker  # noqa: E402
from mapad_tpu_torch.index.builder import run as t_index_run  # noqa: E402
from mapad_tpu_torch.index.runtime import load_index  # noqa: E402
from mapad_tpu_torch.io.sniff import InputSource  # noqa: E402
from mapad_tpu_torch.map import pipeline as t_pipeline  # noqa: E402
from mapad_tpu_torch.map.native_search import NativeSearchEngine  # noqa: E402
from mapad_tpu_torch.ops import engine as teng  # noqa: E402
from mapad_tpu_torch.ops.prep import _DEV_LUT_Q  # noqa: E402
from mapad_tpu_torch.ops.search_pool import PoolConfig  # noqa: E402
from mapad_tpu_torch.tools import pipeline_bam as pb  # noqa: E402
from mapad_tpu_torch.tools.sheets import SheetWatch  # noqa: E402
from mapad_tpu_torch.utils.seq import revcomp  # noqa: E402
from test_torch_distributed import _serve, free_port  # noqa: E402
from test_torch_integration import _header_without_cl, _records  # noqa: E402
from torch_port_helpers import adna_params, bench_ref  # noqa: E402
from torch_port_helpers import unsharded_env  # noqa: E402,F401

N = 256      # records: two sheets of SHEET, four blocks of BLOCK
SHEET = 128
BLOCK = 64
QLESS = (64, 64)  # the quality-less run: the first sheet's second block
CHUNK = 64   # the dispatcher's chunks
CFG = dict(max_len=128, lanes=8, total_steps=1024, read_step_cap=256,
           max_chains=512)
FLAGS = ["-p", "0.03", "-l", "single_stranded", "-f", "0.6", "-t", "0.55",
         "-d", "0.01", "-s", "1.0", "-i", "0.001", "--batch_size",
         str(SHEET), "--force_overwrite"]
READ_GROUP = "@RG\tID:x\tSM:y"
JOIN_S = 120  # a hang fails the test instead of eating the suite's limit


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    """bench_ref indexed by the port, and a pipeline BAM of N of its records
    with one scattered quality-less record besides the run -> dict."""
    d = tmp_path_factory.mktemp("inputs")
    ref = bench_ref()
    fasta = d / "genome.fa"
    fasta.write_text(">chr1\n" + "\n".join(
        ref[i : i + 80].decode() for i in range(0, len(ref), 80)) + "\n")
    t_index_run(str(fasta), seed=1234)
    bam = d / "reads.bam"
    truth = pb.make(str(bam), np.frombuffer(ref, dtype=np.uint8), N,
                    seed=20, qualityless=QLESS, scattered=1)
    return dict(dir=d, fasta=str(fasta), bam=str(bam), truth=truth,
                t=load_index(str(fasta)), j=j_load_index(str(fasta)))


def _params(pkg, chunk=SHEET):
    p = adna_params(pkg)
    p.chunk_size = chunk
    return p


@pytest.fixture(scope="module")
def device_run(work):
    """(package, big) -> `pipeline.run` of the pipeline BAM with that
    package's pool engine (the port's on the CPU, watched by SheetWatch)
    in blocks of BLOCK: its BAM, stats and the watch's run; each made
    once."""
    made = {}

    def get(pkg, big):
        if (pkg, big) in made:
            return made[pkg, big]
        out = str(work["dir"] / f"{pkg}_{'big' if big else 'i32'}.bam")
        if pkg == "port":
            engine = teng.DeviceSearchEngine(
                work["t"].fmd, _params("mapad_tpu_torch", 1),
                pool_config=PoolConfig(**CFG), packed_hits=True,
                device="cpu", big=big)
            engine.block_reads = BLOCK
            with SheetWatch() as watch:
                t_pipeline.run(work["bam"], work["fasta"], out, True,
                               _params("mapad_tpu_torch"), None,
                               engine=engine, cmdline="mapad map",
                               index=work["t"])
            run = watch.runs[-1]
        else:
            engine = JEngine(
                work["j"].fmd, _params("mapad_tpu", 1), mode="pool",
                pool_config=JPoolConfig(compute_forward_part=False, **CFG),
                packed_hits=True, big=big)
            engine.block_reads = BLOCK
            j_pipeline.run(work["bam"], work["fasta"], out, True,
                           _params("mapad_tpu"), None, engine=engine,
                           cmdline="mapad map", index=work["j"])
            run = None
        made[pkg, big] = dict(bam=out, stats=engine._stats, run=run)
        return made[pkg, big]

    return get


def _same(got, want):
    got, want = _records(got), _records(want)
    assert got[1] == want[1]
    assert _header_without_cl(got[0]) == _header_without_cl(want[0])
    return got[1]


def test_pipeline_bam_is_made_from_its_seed(work, tmp_path):
    """The same seed writes the same bytes and Truth, another seed other
    reads; the mix holds every kind, the run of quality-less records and
    the overlong mates; the records read back are the Truth's."""
    ref = np.frombuffer(bench_ref(), dtype=np.uint8)
    a = pb.make(str(tmp_path / "a.bam"), ref, N, seed=20, qualityless=QLESS,
                scattered=1)
    b = pb.make(str(tmp_path / "b.bam"), ref, N, seed=21, qualityless=QLESS,
                scattered=1)
    assert open(tmp_path / "a.bam", "rb").read() == open(work["bam"],
                                                         "rb").read()
    assert a.names == work["truth"].names and a.tags == work["truth"].tags
    assert a.sequences != b.sequences
    counts = a.counts()
    assert all(counts[k] for k in pb.KINDS), counts
    assert counts["r1"] == counts["r2"] and counts["overlong"] > 0
    run = slice(QLESS[0], sum(QLESS))  # zero-length records have no QUAL
    assert (a.qualityless[run] | (a.kinds[run] == pb.EMPTY)).all()
    # one scattered outside the run, no twin among them
    assert counts["qualityless"] == int((a.kinds[run] != pb.EMPTY).sum()) + 1
    has = a.twin >= 0
    assert (a.qualityless[has] == a.qualityless[a.twin[has]]).all()
    assert counts["twins"] == counts["reverse"]
    src = InputSource.from_path(work["bam"])
    recs = [r for sheet in src.task_queue(N) for r in sheet.records]
    assert src.kind == "bam" and [g for g, _ in src.header.rg] == list(
        pb.READ_GROUPS)
    for i, r in enumerate(recs):
        assert (r.name, r.bam_flags, r.bam_tags) == (
            a.names[i], a.flags[i], a.tags[i])
        j = int(a.twin[i])
        if j >= 0:  # un-reversed on input: its forward twin's read
            assert (r.sequence, r.base_qualities) == (
                recs[j].sequence, recs[j].base_qualities)
        if a.qualityless[i]:
            assert r.base_qualities == b"\xff" * len(r.sequence)


@pytest.mark.parametrize("big", [False, True])
def test_pipeline_bam_quality_less_block_beside_a_normal_one(work,
                                                             device_run, big):
    """The pool engine in either width: a block holding a quality-less read
    takes the host-scored upload (no K4, or no K6 in big mode), the others
    the device-LUT blob; the BAM and the escalations equal mapad_tpu's."""
    port, jax = device_run("port", big), device_run("jax", big)
    _same(port["bam"], jax["bam"])
    for k in ("escalated", "oracle", "deep_retried", "nohit_host",
              "esc_why"):
        assert port["stats"].get(k) == jax["stats"].get(k), k
    blocks = [b for b in port["run"]["blocks"] if not b["tier"]]
    assert len(blocks) == N // BLOCK
    routes = [b["route"] for b in blocks]
    assert routes == ["lut" if b["max_qual"] < _DEV_LUT_Q else "host"
                      for b in blocks]
    assert routes[QLESS[0] // BLOCK] == "host" and "lut" in routes
    assert sorted(r["route"] for r in port["run"]["runs"]) == sorted(
        b["route"] for b in port["run"]["blocks"])
    pb.check_output(work["truth"], port["bam"])


def test_pipeline_bam_overlong_mates_go_to_the_host(work, device_run):
    """150 bp mates enter their block empty and escalate as overlong; they
    map as mapad_tpu maps them."""
    truth, port = work["truth"], device_run("port", False)
    assert port["stats"]["esc_why"]["overlong"] == int(truth.overlong.sum())
    assert set(truth.kinds[truth.overlong]) <= {pb.R1, pb.R2}
    got = pb.check_output(truth, port["bam"])
    assert got["overlong_mapped"] > 0
    _same(port["bam"], device_run("jax", False)["bam"])


def test_pipeline_bam_iupac_and_equals_bases(work, device_run):
    """Reads holding `=`, N and IUPAC codes: their SEQ comes back as read
    (complemented, reversed, where mapped to the reverse strand), as
    mapad_tpu writes it."""
    truth = work["truth"]
    recs = _same(device_run("port", False)["bam"],
                 device_run("jax", False)["bam"])
    iupac = np.flatnonzero(truth.kinds == pb.IUPAC)
    assert iupac.size
    for i in iupac:
        seq, flags = recs[i][6], recs[i][1]
        want = truth.sequences[i]
        assert b"=" in want and b"N" in want
        assert seq == (revcomp(want) if flags & 0x10 else want)


def test_pipeline_bam_reverse_flagged_twins(work, device_run):
    """A record stored reverse-complemented under 0x10 maps as its forward
    twin does (un-reversed on input)."""
    got = pb.check_output(work["truth"], device_run("port", False)["bam"])
    assert got["twins"] == int((work["truth"].twin >= 0).sum()) > 0
    assert got["twins_placed"] > 0


def test_pipeline_bam_zero_length_records(work, device_run):
    """Zero-length records come back unmapped, empty, with their tags."""
    truth = work["truth"]
    recs = _same(device_run("port", False)["bam"],
                 device_run("jax", False)["bam"])
    empty = np.flatnonzero(truth.kinds == pb.EMPTY)
    assert empty.size
    for i in empty:
        name, flags, ref_id, pos, _mapq, cigar, seq, quals, tags = recs[i]
        assert (name, flags, ref_id, pos, cigar, seq, quals) == (
            truth.names[i], 0x4, -1, -1, "*", b"", b"")
        assert tags == pb.expected_tags(truth.tags[i])


def test_pipeline_bam_tag_filter(work, device_run):
    """The input's NM, MD, AS and XD go; its other tags stay in order, the
    mapping's own after them."""
    truth = work["truth"]
    recs = _same(device_run("port", False)["bam"],
                 device_run("jax", False)["bam"])
    filtered = [i for i, t in enumerate(truth.tags)
                if any(k == b"NM" for k, _c, _v in t)]
    assert filtered
    for i in filtered:
        tags = recs[i][8]
        keep = pb.expected_tags(truth.tags[i])
        assert tags[: len(keep)] == keep
        assert not any(k in (b"NM", b"MD", b"AS") for k, _c, _v in
                       tags[: len(keep)])
    pb.check_output(truth, device_run("port", False)["bam"])


@pytest.mark.parametrize("read_group", [None, READ_GROUP])
def test_pipeline_bam_read_group(work, tmp_path, read_group):
    """Both CLIs on the pipeline BAM: its two @RG lines and each record's
    RG pass through, or `-R`'s replaces them."""
    extra = ["-R", read_group] if read_group else []
    argv = ["map", "-r", work["bam"], "-g", work["fasta"], *FLAGS,
            "--engine", "native", *extra]
    assert t_main([*argv, "-o", str(tmp_path / "t.bam")]) == 0
    assert j_main([*argv, "-o", str(tmp_path / "j.bam")]) == 0
    _same(tmp_path / "t.bam", tmp_path / "j.bam")
    header = _records(tmp_path / "t.bam")[0]
    rg = [line for line in header.splitlines() if line.startswith("@RG")]
    assert rg == ([read_group] if read_group else [
        "@RG\tID:lane1\tSM:sample1\tLB:lib1\tPL:ILLUMINA",
        "@RG\tID:lane2\tSM:sample1\tLB:lib2\tPL:ILLUMINA"])
    pb.check_output(work["truth"], str(tmp_path / "t.bam"),
                    read_group="x" if read_group else None)


def test_pipeline_bam_from_stdin(work, tmp_path, monkeypatch):
    """`map -r -` with the BAM on stdin equals the map of the file, and
    mapad_tpu's."""
    argv = ["map", "-g", work["fasta"], *FLAGS, "--engine", "native",
            "-R", READ_GROUP]
    with open(work["bam"], "rb") as f:
        monkeypatch.setattr(sys, "stdin", io.TextIOWrapper(f))
        assert t_main([*argv, "-r", "-", "-o", str(tmp_path / "s.bam")]) == 0
    monkeypatch.undo()
    assert t_main([*argv, "-r", work["bam"], "-o",
                   str(tmp_path / "f.bam")]) == 0
    assert j_main([*argv, "-r", work["bam"], "-o",
                   str(tmp_path / "j.bam")]) == 0
    _same(tmp_path / "s.bam", tmp_path / "f.bam")
    _same(tmp_path / "s.bam", tmp_path / "j.bam")


def test_pipeline_bam_merged_reads_as_fastq_gz(work, tmp_path):
    """The merged reads as a gzipped FASTQ: sniffed as such, mapped as
    mapad_tpu maps them, their SEQ and QUAL those of the BAM's records."""
    gz = str(tmp_path / "merged.fastq.gz")
    n = pb.write_fastq_gz(gz, work["truth"])
    assert InputSource.from_path(gz).kind == "fastq.gz"
    with gzip.open(gz, "rb") as f:
        assert f.read().count(b"\n") == 4 * n
    argv = ["map", "-r", gz, "-g", work["fasta"], *FLAGS, "--engine",
            "native"]
    assert t_main([*argv, "-o", str(tmp_path / "t.bam")]) == 0
    assert j_main([*argv, "-o", str(tmp_path / "j.bam")]) == 0
    recs = _same(tmp_path / "t.bam", tmp_path / "j.bam")
    keep = pb.merged_records(work["truth"])
    assert len(recs) == n == keep.size
    for r, i in zip(recs, keep):
        t = work["truth"]
        fwd = not r[1] & 0x10
        assert r[0] == t.names[i]
        assert r[6] == (t.sequences[i] if fwd else revcomp(t.sequences[i]))
        assert r[7] == (t.qualities[i] if fwd else t.qualities[i][::-1])


# --- the dispatcher and its workers ---------------------------------------


def _native_worker(port):
    return Worker("127.0.0.1", port, engine_factory=lambda fmd, p:
                  NativeSearchEngine(fmd, p, threads=2))


def _sorted(path):
    return sorted(_records(path)[1])


def _start(target, *args):
    t = threading.Thread(target=target, args=args, daemon=True)
    t.start()
    return t


@pytest.fixture(scope="module")
def jax_dispatched(work):
    """mapad_tpu's dispatcher over the pipeline BAM in chunks of CHUNK with
    two workers on its native engine -> its BAM."""
    out = work["dir"] / "jax_dispatched.bam"
    port = free_port()
    d = JDispatcher(work["bam"], work["fasta"], str(out), False,
                    _params("mapad_tpu", CHUNK), None, cmdline="mapad map")
    threads = [_start(d.run, port)] + [
        _start(_serve, JWorker("127.0.0.1", port, engine_factory=lambda fmd,
                               p: JNative(fmd, p, threads=2)))
        for _ in range(2)]
    for t in threads:
        t.join(timeout=JOIN_S)
        assert not t.is_alive()
    return out


def test_pipeline_bam_through_the_dispatcher(work, jax_dispatched, tmp_path,
                                            monkeypatch):
    """The port's dispatcher with a port worker on the plain kernels and
    one on the native engine: flags, tags and the twins cross the wire
    both ways, and the BAM equals mapad_tpu's dispatcher's."""
    monkeypatch.setenv("MAPAD_POOL_STEPS", "2048")
    out = tmp_path / "port.bam"
    port = free_port()
    d = Dispatcher(work["bam"], work["fasta"], str(out), False,
                   _params("mapad_tpu_torch", CHUNK), None,
                   cmdline="mapad map")
    threads = [_start(d.run, port),
               _start(_serve, Worker("127.0.0.1", port, device="cpu",
                                     lanes=8)),
               _start(_serve, _native_worker(port))]
    for t in threads:
        t.join(timeout=JOIN_S)
        assert not t.is_alive()
    # each record once (the dispatcher writes a chunk as it comes in)
    assert _sorted(out) == _sorted(jax_dispatched)
    assert sorted(r[0] for r in _records(out)[1]) == sorted(
        work["truth"].names)


@pytest.mark.parametrize("when", ["with_chunks_left", "after_the_queue_ran_out"])
def test_pipeline_bam_dead_workers_chunk_is_requeued(work, jax_dispatched,
                                                    tmp_path, when):
    """A worker takes the first chunk and dies holding it, while chunks are
    left or once the other worker has mapped every other chunk and found
    the queue empty: the chunk is queued again and the other worker maps
    it.  (mapad_tpu's dispatcher, and the port's before this was pinned,
    never woke the idle worker: the run hung.)"""
    out = tmp_path / f"{when}.bam"
    port = free_port()
    d = Dispatcher(work["bam"], work["fasta"], str(out), False,
                   _params("mapad_tpu_torch", CHUNK), None,
                   cmdline="mapad map")
    written, write = [], d._write_results

    def counted(chunk_id, results):
        write(chunk_id, results)
        written.append(chunk_id)

    d._write_results = counted
    d_thread = _start(d.run, port)
    for _ in range(200):
        try:
            sock = socket.create_connection(("127.0.0.1", port))
            break
        except ConnectionRefusedError:
            time.sleep(0.05)
    task = twire.decode_task_sheet(twire.read_message(sock)[1])
    assert task.chunk_id == 0 and len(task.records) == CHUNK
    if when == "with_chunks_left":
        sock.close()
    w_thread = _start(_serve, _native_worker(port))
    if when == "after_the_queue_ran_out":
        deadline = time.perf_counter() + JOIN_S
        while not (len(written) == N // CHUNK - 1 and d._queue_exhausted):
            assert time.perf_counter() < deadline, written
            time.sleep(0.05)
        sock.close()
    w_thread.join(timeout=JOIN_S)
    d_thread.join(timeout=5)
    assert not d_thread.is_alive(), "the dispatcher hangs"
    assert not w_thread.is_alive()
    assert sorted(written) == list(range(N // CHUNK))
    assert written[-1] == 0 or when == "with_chunks_left"
    assert _sorted(out) == _sorted(jax_dispatched)
