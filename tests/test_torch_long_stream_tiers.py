"""Long streams through the port's streaming driver with the deep and
retry tiers, held against mapad_tpu on the CPU with the port's plain
kernels (the workload and helpers of test_torch_long_stream.py): tier
blocks prepared between input blocks in big mode, and a deep tier that
fills more slowly than the ordered writer's window, which stops
mapad_tpu's stream and must not stop the port's."""

import pytest

torch = pytest.importorskip("torch")

from mapad_tpu.index.runtime import load_index as j_load_index  # noqa: E402
from mapad_tpu.map import pipeline as j_pipeline  # noqa: E402
from mapad_tpu.map.native_search import (  # noqa: E402
    NativeSearchEngine as JNative,
)
from mapad_tpu_torch.map import pipeline as t_pipeline  # noqa: E402
from test_torch_long_stream import (  # noqa: E402
    CFG,
    _jax,
    _port,
    _run,
    _same_bam,
    work,  # noqa: F401  (the fixture)
)

# two lanes and a per-read cap of 48: some reads abandon and take the
# deep tier
DEEP = dict(CFG, lanes=2, read_step_cap=48)
# a starved step budget under a per-read cap far above it: unfinished
# reads that spent little of their cap, for the retry tier
STARVED = dict(CFG, lanes=2, total_steps=128, read_step_cap=1024,
               max_chains=256)


def _tier_run(work, monkeypatch, tmp_path, env, cfg, tag):
    """Big mode over 8 reads in sheets of 5, blocks of 2, under `env`: the
    port's preps in order (input blocks by their first read's name), its
    BAM against mapad_tpu's under the same variables -> (preps, port
    engine)."""
    for name in ("MAPAD_DEEP_TIER", "MAPAD_HOST_BID", "MAPAD_RETRY_TIER",
                 "MAPAD_DEEP_NOHIT_HOST", "MAPAD_DEEP_LANES"):
        monkeypatch.delenv(name, raising=False)
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    te, je = _port(work, cfg, big=True), _jax(work, cfg, big=True)
    te.block_reads = je.block_reads = 2
    preps, prep = [], te._prep_block

    def recording(recs, R, c):
        preps.append([r.name for r in recs])
        return prep(recs, R, c)

    te._prep_block = recording
    t_keys = _run(t_pipeline, "mapad_tpu_torch", work, te, 8, 5,
                  tmp_path / f"t_{tag}.bam")
    j_keys = _run(j_pipeline, "mapad_tpu", work, je, 8, 5,
                  tmp_path / f"j_{tag}.bam")
    _same_bam(tmp_path / f"t_{tag}.bam", tmp_path / f"j_{tag}.bam")
    assert t_keys == j_keys == [(0, 0), (0, 2), (0, 4), (1, 0), (1, 2)]
    return preps, te


@pytest.mark.parametrize("tier", ["deep", "retry"])
def test_long_stream_tier_block_between_input_blocks(work, monkeypatch,
                                                     tmp_path, tier):
    """Big mode, the deep tier at its default (on) with MAPAD_DEEP_BLOCK=1,
    or MAPAD_RETRY_TIER=1 with MAPAD_RETRY_BLOCK=1 on a starved step
    budget: a tier block is prepared before the last input block, and the
    BAM equals mapad_tpu's under the same variables."""
    if tier == "deep":
        env, cfg, stat = dict(MAPAD_DEEP_BLOCK="1",
                              MAPAD_DEEP_NOHIT_HOST="0"), DEEP, "deep_retried"
    else:
        env, cfg, stat = dict(MAPAD_RETRY_TIER="1", MAPAD_RETRY_BLOCK="1",
                              MAPAD_DEEP_TIER="0"), STARVED, "retried"
    preps, te = _tier_run(work, monkeypatch, tmp_path, env, cfg, tier)
    inputs = [[b"read%d" % (lo + i) for i in range(size)]
              for lo, size in ((0, 2), (2, 2), (4, 1), (5, 2), (7, 1))]
    at = [preps.index(names) for names in inputs]
    assert at == sorted(at)
    tiers = [i for i in range(len(preps)) if i not in at]
    assert tiers and tiers[0] < at[-1], (tiers, at)
    assert te._stats.get(stat, 0) > 0


# the port's `pipeline.run` in a process of its own (a stream that stops
# would hold the test process's threads at exit)
_STALL_RUN = """
import pickle, sys
import torch
torch.set_num_threads(1)
from mapad_tpu_torch.index.runtime import load_index
from mapad_tpu_torch.map import pipeline
from mapad_tpu_torch.ops.engine import DeviceSearchEngine
from mapad_tpu_torch.ops.search_pool import PoolConfig
genome, reads, out, params_path, cfg = sys.argv[1:6]
with open(params_path, "rb") as f:
    params = pickle.load(f)
index = load_index(genome)
engine = DeviceSearchEngine(index.fmd, params, packed_hits=True,
                            device="cpu", pool_config=PoolConfig(**eval(cfg)))
engine.block_reads = 8
pipeline.run(reads, genome, out, True, params, None, engine=engine,
             cmdline="mapad map", index=index)
print(engine.stats()["deep_retried"])
"""


def test_long_stream_deep_tier_slower_than_the_writer(tmp_path,
                                                      monkeypatch):
    """A deep tier whose block fills more slowly than the ordered writer's
    window: the integration fixture's 17 reads in sheets of one read, the
    deep tier forced on with MAPAD_DEEP_BLOCK above the reads.  The writer
    waits on the first deep read's future while the stream runs on until
    STREAM_WAIT blocks are queued behind it; the stream must flush the
    tier itself and run to its end.  mapad_tpu's stops there, so the BAM
    is held against mapad_tpu's native engine's (the same sheets and
    PrRange seeds)."""
    import os
    import pickle
    import subprocess
    import sys

    from test_integration import _check_results, prepare
    from test_torch_integration import _port_params

    genome, input_bam, jparams = prepare(tmp_path)
    assert jparams.chunk_size == 1
    params_path = tmp_path / "params.pkl"
    with open(params_path, "wb") as f:
        pickle.dump(_port_params(jparams), f)
    for name in ("MAPAD_HOST_BID", "MAPAD_RETRY_TIER", "MAPAD_DEEP_LANES"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("MAPAD_DEEP_TIER", "1")
    monkeypatch.setenv("MAPAD_DEEP_BLOCK", "18")
    here = os.path.dirname(os.path.abspath(__file__))
    monkeypatch.setenv("PYTHONPATH", os.path.dirname(here))
    cfg = dict(max_len=64, lanes=8, total_steps=2048, read_step_cap=48,
               max_chains=256)
    out = tmp_path / "port.bam"
    try:
        run = subprocess.run(
            [sys.executable, "-c", _STALL_RUN, str(genome), str(input_bam),
             str(out), str(params_path), repr(cfg)],
            capture_output=True, text=True, timeout=60)
    except subprocess.TimeoutExpired:
        pytest.fail("the stream stopped")
    assert run.returncode == 0, run.stderr[-2000:]
    assert int(run.stdout.split()[-1]) > 0  # deep reads
    _check_results(out)
    j_pipeline.run(str(input_bam), str(genome), str(tmp_path / "j.bam"),
                   True, jparams, None,
                   engine=JNative(j_load_index(str(genome)).fmd, jparams,
                                  packed_hits=True),
                   cmdline="mapad map")
    _same_bam(out, tmp_path / "j.bam")
