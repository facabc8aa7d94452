"""The hybrid engine of the port (the default engine of `map`): the device
pool search on the head of every block, the exact host C++ searcher on its
tail.  Whatever the split, `search_chunk` and `search_stream` return what
the device engine alone and the native engine alone return, and both equal
the JAX package's hybrid engine; `map` with no `--engine` writes the BAM
that `--engine native` writes."""

from concurrent.futures import Future

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from mapad_tpu.index.builder import build_auxiliary_structures  # noqa: E402
from mapad_tpu.ops.engine import HybridSearchEngine as JHybrid  # noqa: E402
from mapad_tpu.ops.search_pool import PoolConfig as JPoolConfig  # noqa: E402
from mapad_tpu_torch.cli import main as t_main  # noqa: E402
from mapad_tpu_torch.index.builder import (  # noqa: E402
    build_auxiliary_structures as t_build,
)
from mapad_tpu_torch.map import native_search  # noqa: E402
from mapad_tpu_torch.ops.engine import (  # noqa: E402
    DeviceSearchEngine,
    HybridSearchEngine,
)
from mapad_tpu_torch.ops.search_pool import PoolConfig  # noqa: E402
from torch_port_helpers import (  # noqa: E402
    adna_params,
    bench_ref,
    hits_equal,
    records,
)

# a wide pool: the plain kernels' time on the CPU goes with the steps
CFG = dict(max_len=128, lanes=64, total_steps=2048, read_step_cap=1024,
           max_chains=1024)
N = 260  # > 256, so a chunk really splits


def _reads(n=N, seed=9):
    ref = bench_ref()
    rng = np.random.default_rng(seed)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    reads = []
    for _ in range(n):
        ln = int(rng.integers(20, 101))
        start = int(rng.integers(0, len(ref) - ln))
        seq = bytearray(ref[start : start + ln])
        for _ in range(int(rng.integers(0, 3))):
            seq[int(rng.integers(0, ln))] = int(rng.choice(bases))
        reads.append(bytes(seq))
    return reads


def _resolve(out):
    return [(o.result() if isinstance(o, Future) else o)[0] for o in out]


def _same(a, b):
    """Two packed hit sets hold the same hits (the device pads a read's op
    words to its block's width, the host searcher to the read's own)."""
    return hits_equal(a.decode(), b.decode())


@pytest.fixture(scope="module")
def tfmd():
    return t_build(bench_ref(), b"ACGT")[0]


@pytest.fixture(scope="module")
def expected(tfmd):
    """The reads' hits from the native engine alone and from the device
    engine alone (packed): equal to each other, and what every hybrid split
    must return."""
    params = adna_params("mapad_tpu_torch")
    recs = records("mapad_tpu_torch", _reads())
    nat = native_search.NativeSearchEngine(tfmd, params, threads=2,
                                           packed_hits=True)
    want = _resolve(nat.search_chunk(recs))
    dev = DeviceSearchEngine(tfmd, params, pool_config=PoolConfig(**CFG),
                             packed_hits=True, device="cpu")
    got = _resolve(dev.search_chunk(recs[:100]))
    assert all(_same(a, b) for a, b in zip(got, want))
    assert sum(len(h) > 0 for h in want) > N // 2
    return recs, want


def _hybrid(tfmd, fraction, **kw):
    return HybridSearchEngine(
        tfmd, adna_params("mapad_tpu_torch"), threads=2,
        device_fraction=fraction, packed_hits=True, mode="pool",
        pool_config=PoolConfig(**CFG), device="cpu", **kw)


@pytest.mark.parametrize("fraction", [0.05, 0.6, 0.95])
def test_hybrid_search_chunk(tfmd, expected, fraction):
    recs, want = expected
    eng = _hybrid(tfmd, fraction)
    got = _resolve(eng.search_chunk(recs, lazy_fallback=True))
    assert len(got) == N
    assert all(_same(a, b) for a, b in zip(got, want))
    k = max(1, min(N - 1, int(N * fraction)))
    assert eng._stats["hybrid_device_reads"] == k
    assert eng._stats["hybrid_native_reads"] == N - k
    assert eng._stats["device_lanes"] == k
    assert 0.05 <= eng._p <= 0.95
    assert eng.stats()["device_fraction"] == eng._p


@pytest.mark.parametrize("fraction", [0.05, 0.6, 0.95])
def test_hybrid_search_stream(tfmd, expected, fraction):
    """Blocks come back in order, unhashable keys included, each the head
    from the device followed by the tail from the host; a block below 256
    reads is not split."""
    recs, want = expected
    eng = _hybrid(tfmd, fraction)
    eng.device.block_reads = N
    assert eng.block_reads == N
    blocks = [(["key", 0], recs), (["key", 1], recs[:40])]
    got = list(eng.search_stream(iter(blocks), lazy_fallback=True))
    assert [k for k, _ in got] == [k for k, _ in blocks]
    for (_key, out), (_k, blk), exp in zip(got, blocks, (want, want[:40])):
        flat = _resolve(out)
        assert len(flat) == len(blk)
        assert all(_same(a, b) for a, b in zip(flat, exp))
    k = max(1, min(N, int(N * fraction)))
    assert eng._stats["hybrid_device_reads"] == k + 40
    assert eng._stats["hybrid_native_reads"] == N - k


def test_hybrid_below_threshold_is_device_only(tfmd, expected):
    recs, want = expected
    eng = _hybrid(tfmd, 0.05)
    got = _resolve(eng.search_chunk(recs[:60]))
    assert all(_same(a, b) for a, b in zip(got, want[:60]))
    assert eng._stats["device_lanes"] == 60
    assert eng._stats["hybrid_native_reads"] == 0
    assert eng._p == 0.05


def test_hybrid_equals_jax_hybrid(tfmd):
    """Decoded hits, a center of the test matrix: the port's hybrid engine
    against the JAX package's at the same split."""
    jfmd = build_auxiliary_structures(bench_ref(), b"ACGT")[0]
    reads = _reads(280, seed=23)
    je = JHybrid(jfmd, adna_params("mapad_tpu"), threads=2, mode="pool",
                 device_fraction=0.2,
                 pool_config=JPoolConfig(compute_forward_part=False, **CFG))
    te = HybridSearchEngine(
        tfmd, adna_params("mapad_tpu_torch"), threads=2, mode="pool",
        device_fraction=0.2, pool_config=PoolConfig(**CFG), device="cpu")
    want = _resolve(je.search_chunk(records("mapad_tpu", reads)))
    got = _resolve(te.search_chunk(records("mapad_tpu_torch", reads)))
    assert all(hits_equal(a, b) for a, b in zip(got, want))
    assert te._stats["device_lanes"] == je._stats["device_lanes"] == 56


def test_hybrid_passes_device_kw_through(tfmd):
    eng = HybridSearchEngine(tfmd, adna_params("mapad_tpu_torch"),
                             pool_config=PoolConfig(**CFG), big=True,
                             device="cpu")
    assert eng.device.device_index.big
    assert eng.device.pool_config.lanes == 64
    eng = HybridSearchEngine(tfmd, adna_params("mapad_tpu_torch"),
                             mode="batch", tiers=((64, None),), device="cpu")
    assert eng.device.mode == "batch" and eng.device.tiers == ((64, None),)


def test_cli_default_engine_is_hybrid_and_equals_native(tmp_path,
                                                        monkeypatch):
    """`map` with no `--engine` runs the hybrid engine (a 300-read sheet is
    split between the device and the host) and writes the BAM that
    `--engine native` writes, XD (a timing) and the command line aside."""
    import logging

    from mapad_tpu_torch.io.bam import BamReader

    fa = tmp_path / "g.fa"
    fa.write_text(">g\n" + bench_ref().decode() + "\n")
    fq = tmp_path / "r.fq"
    fq.write_text("".join(
        f"@r{i}\n{s.decode()}\n+\n{'I' * len(s)}\n"
        for i, s in enumerate(_reads())
    ))
    monkeypatch.setenv("MAPAD_POOL_STEPS", "2048")
    monkeypatch.setenv("MAPAD_BLOCK_READS", str(N))
    flags = ["-r", str(fq), "-g", str(fa), "-p", "0.03", "-l",
             "single_stranded", "-f", "0.6", "-t", "0.55", "-d", "0.01",
             "-s", "1.0", "-i", "0.001"]
    assert t_main(["index", "-g", str(fa)]) == 0

    seen = []

    class Tap(logging.Handler):
        def emit(self, record):
            if hasattr(record, "search_stats"):
                seen.append(record.search_stats)

    tap = Tap()
    log = logging.getLogger("mapad_tpu_torch.map.pipeline")
    level = log.level
    log.addHandler(tap)
    log.setLevel(logging.INFO)
    try:
        assert t_main(["--threads", "2", "map", *flags, "-o",
                       str(tmp_path / "hybrid.bam"), "--lanes", "64",
                       "--device", "cpu"]) == 0
    finally:
        log.removeHandler(tap)
        log.setLevel(level)
    assert t_main(["--threads", "2", "map", *flags, "-o",
                   str(tmp_path / "native.bam"), "--engine", "native"]) == 0
    stats = seen[-1]
    assert stats["hybrid_device_reads"] == int(N * 0.6)
    assert stats["hybrid_native_reads"] == N - int(N * 0.6)
    assert 0.05 <= stats["device_fraction"] <= 0.95

    def recs(path):
        with open(path, "rb") as f:
            return [
                (r.name, r.flags, r.ref_id, r.pos, r.mapq, r.cigar_string(),
                 r.sequence, r.quals,
                 [(bytes(t), tc, v) for t, tc, v in r.tags
                  if bytes(t) != b"XD"])
                for r in BamReader(f)
            ]

    got, want = recs(tmp_path / "hybrid.bam"), recs(tmp_path / "native.bam")
    assert len(got) == N and got == want
    assert sum(1 for r in got if not r[1] & 0x4) > N // 2
