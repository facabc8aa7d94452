"""Long streams through the port's streaming driver (`pipeline.run` over
`search_stream`), held against mapad_tpu on the CPU with the port's plain
kernels: sheets of `chunk_size` reads that no block size divides, so that
every sheet ends in a short block in the middle of the stream (the int32
pool engine and the hybrid), and the hybrid's rule that a block of fewer
than 256 reads goes wholly to the device, on a sheet's short block
between full ones.  BAMs are compared record for record, MAPQ and tags
included, XD (a timing) aside, and the blocks' keys in the order the
engines yield them.  The genome holds a repeat, so that reads of several
best hits draw their position from the PrRange seed, which carries each
sheet's `chunk_id`.  The tiers' long streams are in
test_torch_long_stream_tiers.py."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from mapad_tpu.index.runtime import load_index as j_load_index  # noqa: E402
from mapad_tpu.map import pipeline as j_pipeline  # noqa: E402
from mapad_tpu.ops.engine import DeviceSearchEngine as JEngine  # noqa: E402
from mapad_tpu.ops.engine import HybridSearchEngine as JHybrid  # noqa: E402
from mapad_tpu.ops.search_pool import PoolConfig as JPoolConfig  # noqa: E402
from mapad_tpu_torch.index.builder import run as t_index_run  # noqa: E402
from mapad_tpu_torch.index.runtime import load_index  # noqa: E402
from mapad_tpu_torch.map import pipeline as t_pipeline  # noqa: E402
from mapad_tpu_torch.ops import engine as teng  # noqa: E402
from mapad_tpu_torch.ops.search_pool import PoolConfig  # noqa: E402
from mapad_tpu_torch.tools.assembly import make_reads, write_fastq  # noqa: E402
from mapad_tpu_torch.tools.sheets import SheetWatch  # noqa: E402
from test_torch_integration import _header_without_cl, _records  # noqa: E402
from torch_port_helpers import adna_params, bench_ref  # noqa: E402

# a block holds at least `lanes` reads
CFG = dict(max_len=128, lanes=8, total_steps=1024, read_step_cap=256,
           max_chains=512)
NARROW = dict(CFG, lanes=4)
REPEAT = (2000, 2600)  # bench_ref's span copied once more at its end
N_READS = 21


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    """bench_ref with one span repeated, indexed by the port (the bundle
    is mapad_tpu's, file for file), and reads of it from a seed, a third
    of them inside the repeat -> dict of paths and both packages'
    indexes."""
    d = tmp_path_factory.mktemp("long_stream")
    ref = bench_ref()
    genome = ref + ref[REPEAT[0]:REPEAT[1]]
    fasta = d / "genome.fa"
    fasta.write_text(">chr1\n" + "\n".join(
        genome[i : i + 80].decode() for i in range(0, len(genome), 80))
        + "\n")
    t_index_run(str(fasta), seed=1234)
    bases = np.frombuffer(genome, dtype=np.uint8)
    rng = np.random.default_rng(19)
    starts = rng.integers(0, len(genome) - 128, size=600)
    starts[::3] = rng.integers(REPEAT[0], REPEAT[1] - 128, size=200)
    reads = make_reads(bases, 600, 19, starts=starts)
    paths = {}
    for n in (8, N_READS, 560):
        paths[n] = d / f"reads_{n}.fq"
        write_fastq(reads[:n], str(paths[n]))
    return dict(dir=d, fasta=str(fasta), fastq=paths,
                j=j_load_index(str(fasta)), t=load_index(str(fasta)))


def _params(pkg, chunk):
    p = adna_params(pkg)
    p.chunk_size = chunk
    return p


def _port(work, cfg=CFG, **kw):
    return teng.DeviceSearchEngine(
        work["t"].fmd, _params("mapad_tpu_torch", 1),
        pool_config=PoolConfig(**cfg), packed_hits=True, device="cpu", **kw)


def _jax(work, cfg=CFG, **kw):
    return JEngine(work["j"].fmd, _params("mapad_tpu", 1), mode="pool",
                   pool_config=JPoolConfig(compute_forward_part=False, **cfg),
                   packed_hits=True, **kw)


def _hybrids(work, fraction, cfg=CFG):
    common = dict(threads=2, device_fraction=fraction, packed_hits=True,
                  mode="pool")
    return (
        teng.HybridSearchEngine(work["t"].fmd, _params("mapad_tpu_torch", 1),
                                pool_config=PoolConfig(**cfg), device="cpu",
                                **common),
        JHybrid(work["j"].fmd, _params("mapad_tpu", 1),
                pool_config=JPoolConfig(compute_forward_part=False, **cfg),
                **common))


def _run(pipeline, pkg, work, engine, reads, chunk, out):
    """`pipeline.run` of `pkg` over `reads` in sheets of `chunk` -> the
    (chunk_id, offset) keys its engine yielded, in order."""
    keys = []
    if hasattr(engine, "search_stream"):
        inner = engine.search_stream

        def stream(blocks, **kw):
            for key, out_ in inner(blocks, **kw):
                keys.append((key[0].chunk_id, key[1]))
                yield key, out_

        engine.search_stream = stream
    pipeline.run(str(work["fastq"][reads]), work["fasta"], str(out), True,
                 _params(pkg, chunk), None, engine=engine,
                 cmdline="mapad map",
                 index=work["t" if pkg == "mapad_tpu_torch" else "j"])
    return keys


def _same_bam(got, want):
    got, want = _records(got), _records(want)
    assert len(got[1]) == len(want[1])
    for g, w in zip(got[1], want[1]):
        assert g == w, (g[0], g, w)
    assert _header_without_cl(got[0]) == _header_without_cl(want[0])
    return got[1]


def _blocks(n, chunk, block):
    """The (chunk_id, offset, size) of each input block of n reads in
    sheets of `chunk`, blocks of `block`."""
    out = []
    for c, lo in enumerate(range(0, n, chunk)):
        size = min(chunk, n - lo)
        out += [(c, off, min(block, size - off))
                for off in range(0, size, block)]
    return out


class _Card:
    """Stands in for `torch` in a SheetWatch on the CPU: its readings
    count up."""

    def __init__(self):
        self.cuda, self.n = self, 0

    def memory_allocated(self):
        self.n += 1
        return self.n

    def memory_reserved(self):
        return 0

    def synchronize(self):
        pass


@pytest.mark.parametrize("kind", ["device", "hybrid"])
def test_long_stream_sheets_end_in_short_blocks(work, kind, tmp_path):
    """Sheets of 9 reads in blocks of 4: each sheet ends in a block of
    one read, the next sheet's first block behind it.  The BAM and the
    keys' order equal mapad_tpu's, the keys are every block of every
    sheet once, and a read of several best hits is among them."""
    chunk, block = 9, 4
    if kind == "device":
        te, je = _port(work, NARROW), _jax(work, NARROW)
        te.block_reads = je.block_reads = block
    else:
        te, je = _hybrids(work, 0.6, NARROW)
        te.device.block_reads = je.device.block_reads = block
    with SheetWatch(_Card()) as watch:
        t_keys = _run(t_pipeline, "mapad_tpu_torch", work, te, N_READS,
                      chunk, tmp_path / "t.bam")
    j_keys = _run(j_pipeline, "mapad_tpu", work, je, N_READS, chunk,
                  tmp_path / "j.bam")
    recs = _same_bam(tmp_path / "t.bam", tmp_path / "j.bam")
    assert t_keys == j_keys == [(c, off) for c, off, _ in
                                _blocks(N_READS, chunk, block)]
    assert sum(1 for _c, _o, size in _blocks(N_READS, chunk, block)
               if size < block) == 3
    # the watch's sheets and blocks: a reading at each sheet turn and at
    # the end, the reads pulled by then
    (run,) = watch.runs
    assert run["sheets"] == [9, 9, 3] and run["input_blocks"] == 7
    assert [x["reads"] for x in run["samples"]] == [9, 18, 21]
    assert all(x["rss"] > 0 for x in run["samples"])
    # a turn's card reading is taken as the next block begins; the last
    # after the run
    assert all(x["allocated"] is not None for x in run["samples"])
    assert not run["pending"]
    assert run["samples"][-1]["stats"]["batches"] == 7
    # X0 (best hits) above 1: the position came from the PrRange seed
    assert any(v > 1 for r in recs for t, _tc, v in r[8] if t == b"X0")


def test_long_stream_hybrid_short_block_goes_to_the_device(work, tmp_path):
    """Sheets of 276 reads in blocks of 256: each sheet ends in a block of
    20, under the 256 below which the hybrid does not split; the full
    blocks split at the device fraction (0.05; 560 reads: too few for the
    fraction to move).  The reads each side searched, the BAM and the
    keys equal mapad_tpu's hybrid's."""
    te, je = _hybrids(work, 0.05)
    te.device.block_reads = je.device.block_reads = 256
    t_keys = _run(t_pipeline, "mapad_tpu_torch", work, te, 560, 276,
                  tmp_path / "t.bam")
    j_keys = _run(j_pipeline, "mapad_tpu", work, je, 560, 276,
                  tmp_path / "j.bam")
    _same_bam(tmp_path / "t.bam", tmp_path / "j.bam")
    assert t_keys == j_keys == [(0, 0), (0, 256), (1, 0), (1, 256), (2, 0)]
    # mapad_tpu's hybrid counts the reads its device side searched as
    # the device engine's `device_lanes`
    full = int(256 * 0.05)
    dev = 2 * full + 20 + 20 + 8
    assert te._stats["hybrid_device_reads"] == te._stats["device_lanes"] \
        == je._stats["device_lanes"] == dev
    assert te._stats["hybrid_native_reads"] == 560 - dev
    assert te._p == je._p == 0.05
