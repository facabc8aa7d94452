"""The port's DeviceSearchEngine(device="cpu") against the JAX package's
engine over several streamed blocks: the same reads escalate, and every
read's hits are equal bit for bit, packed and decoded; in small mode, in
big (int64) mode with its defaults (Bi-D on the device, deep tier on), and
through the retry and deep tiers with equal counters.  Every guard of a
later slice raises when the engine or its config is made."""

import os

from concurrent.futures import Future

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from mapad_tpu.index.builder import build_auxiliary_structures  # noqa: E402
from mapad_tpu.ops.engine import DeviceSearchEngine as JEngine  # noqa: E402
from mapad_tpu.ops.search_pool import PoolConfig as JPoolConfig  # noqa: E402
from mapad_tpu_torch.index.builder import (  # noqa: E402
    build_auxiliary_structures as t_build,
)
from mapad_tpu_torch.ops.engine import DeviceSearchEngine as TEngine  # noqa: E402
from mapad_tpu_torch.ops.search_pool import PoolConfig as TPoolConfig  # noqa: E402
from torch_port_helpers import (  # noqa: E402
    adna_params,
    bench_reads,
    bench_ref,
    hits_equal,
    packed_equal,
    records,
)

CFG = dict(max_len=128, lanes=8, total_steps=2048, read_step_cap=512,
           max_chains=256)
BLOCK = 24


@pytest.fixture(scope="module")
def indexes():
    ref = bench_ref()
    return build_auxiliary_structures(ref, b"ACGT")[0], t_build(ref, b"ACGT")[0]


def _stream(engine, recs, block=BLOCK):
    """search_stream over block-read blocks -> (escalated indexes, hits)."""
    blocks = [(b, recs[b : b + block]) for b in range(0, len(recs), block)]
    out = []
    for _key, block_out in engine.search_stream(blocks, lazy_fallback=True):
        out.extend(block_out)
    escalated = {i for i, o in enumerate(out) if isinstance(o, Future)}
    hits = [(o.result() if isinstance(o, Future) else o)[0] for o in out]
    return escalated, hits


@pytest.mark.parametrize("packed,qual", [(True, 40), (False, 40),
                                         (True, 100)])
def test_engine_equals_jax(indexes, packed, qual):
    """qual 100 is past the device LUT's quality ceiling: the blob then
    carries the full LUT rows instead of (class, qual) cells."""
    jfmd, tfmd = indexes
    ref = bench_ref()
    # an empty read and an overlong one (escalated to the exact searcher)
    reads = bench_reads(seed=5, n_random=50, n_exo=6,
                        extra=[b"", ref[1000:1200]])
    je = JEngine(jfmd, adna_params("mapad_tpu"), mode="pool",
                 pool_config=JPoolConfig(compute_forward_part=False, **CFG),
                 packed_hits=packed)
    te = TEngine(tfmd, adna_params("mapad_tpu_torch"),
                 pool_config=TPoolConfig(**CFG), packed_hits=packed,
                 device="cpu")
    je.block_reads = te.block_reads = BLOCK
    j_esc, j_hits = _stream(je, records("mapad_tpu", reads, qual))
    t_esc, t_hits = _stream(te, records("mapad_tpu_torch", reads, qual))
    assert len(reads) > 2 * BLOCK
    assert t_esc == j_esc and len(t_esc) > 0
    assert te._stats["esc_why"] == je._stats["esc_why"]
    same = packed_equal if packed else hits_equal
    for i, (a, b) in enumerate(zip(j_hits, t_hits)):
        assert same(a, b), i
    assert sum(len(h) > 0 for h in t_hits) > len(reads) // 2


def test_engine_default_shape(indexes):
    _jfmd, tfmd = indexes
    te = TEngine(tfmd, adna_params("mapad_tpu_torch"), lanes=2048,
                 device="cpu")
    cfg = te.pool_config
    assert (cfg.lanes, cfg.total_steps, cfg.read_step_cap,
            cfg.max_chains) == (512, 8192, 3072, 16384)
    assert te.block_reads == 8192
    assert np.float32(te._params().pgo_pge.item()) == np.float32(
        te.parameters.penalty_gap_open + te.parameters.penalty_gap_extend
    )


# --- big (int64) mode -----------------------------------------------------


def _pair(indexes, cfg, **kw):
    jfmd, tfmd = indexes
    je = JEngine(jfmd, adna_params("mapad_tpu"), mode="pool",
                 pool_config=JPoolConfig(compute_forward_part=False, **cfg),
                 **kw)
    te = TEngine(tfmd, adna_params("mapad_tpu_torch"),
                 pool_config=TPoolConfig(**cfg), device="cpu", **kw)
    return je, te


def _assert_same_run(je, te, reads, block, packed, qual=40,
                     counters=("retried", "deep_retried", "nohit_host",
                               "oracle", "escalated", "batches",
                               "device_lanes")):
    je.block_reads = te.block_reads = block
    j_esc, j_hits = _stream(je, records("mapad_tpu", reads, qual), block)
    t_esc, t_hits = _stream(te, records("mapad_tpu_torch", reads, qual),
                            block)
    assert t_esc == j_esc
    assert te._stats["esc_why"] == je._stats["esc_why"]
    for name in counters:
        assert te._stats.get(name, 0) == je._stats.get(name, 0), name
    same = packed_equal if packed else hits_equal
    for i, (a, b) in enumerate(zip(j_hits, t_hits)):
        assert same(a, b), i
    return t_esc, t_hits


@pytest.mark.parametrize("packed,qual", [(True, 40), (False, 40),
                                         (True, 100)])
def test_big_engine_equals_jax(indexes, packed, qual, monkeypatch):
    """big=True with its defaults: the small blob unpacked on the device
    (K6; past the LUT's quality ceiling the dense arrays go up as they
    are), the Bi-D on the device (K7), int64 intervals, the deep tier on
    (a cap of 512 against 2048 steps: the deep config has the whole
    budget)."""
    monkeypatch.delenv("MAPAD_DEEP_TIER", raising=False)
    monkeypatch.delenv("MAPAD_HOST_BID", raising=False)
    ref = bench_ref()
    reads = bench_reads(seed=5, n_random=50, n_exo=6,
                        extra=[b"", ref[1000:1200]])
    je, te = _pair(indexes, CFG, big=True, packed_hits=packed)
    assert te.device_index.big and je.device_index.big
    assert not te._host_bid_active() and not je._host_bid_active()
    assert te.deep_tier_enabled() and je.deep_tier_enabled()
    t_esc, t_hits = _assert_same_run(je, te, reads, BLOCK, packed, qual)
    assert len(t_esc) > 0
    assert sum(len(h) > 0 for h in t_hits) > len(reads) // 2


def test_big_engine_default_shape(indexes, monkeypatch):
    for name in ("MAPAD_DEEP_TIER", "MAPAD_HOST_BID", "MAPAD_BLOCK_READS",
                 "MAPAD_DEEP_LANES"):
        monkeypatch.delenv(name, raising=False)
    jfmd, tfmd = indexes
    te = TEngine(tfmd, adna_params("mapad_tpu_torch"), lanes=2048, big=True,
                 device="cpu")
    je = JEngine(jfmd, adna_params("mapad_tpu"), lanes=2048, mode="pool",
                 big=True)
    assert te.block_reads == je.block_reads == 4096
    assert not te._host_bid_active() and te.deep_tier_enabled()
    cfg, deep, jdeep = te.pool_config, te._deep_config(), je._deep_config()
    assert (cfg.lanes, cfg.total_steps, cfg.read_step_cap) == (512, 8192,
                                                                3072)
    # full width, the whole step budget as the per-read cap, one generation
    assert (deep.lanes, deep.total_steps, deep.read_step_cap,
            deep.generations) == (512, 8192, 8192, 1)
    for f in ("lanes", "total_steps", "read_step_cap", "generations",
              "min_live", "spill_steps", "max_chains", "max_len"):
        assert getattr(deep, f) == getattr(jdeep, f), f
    monkeypatch.setenv("MAPAD_HOST_BID", "1")
    assert te._host_bid_active() == je._host_bid_active()
    monkeypatch.setenv("MAPAD_DEEP_TIER", "0")
    assert not te.deep_tier_enabled()
    monkeypatch.setenv("MAPAD_BLOCK_READS", "1024")
    assert te.block_reads == je.block_reads == 1024


# --- the retry and deep tiers ----------------------------------------------

TIER_CASES = {
    # a starved shared step budget: unfinished / undispatched reads re-run
    # in retry blocks of the same shapes
    "retry": dict(env=dict(MAPAD_RETRY_TIER="1", MAPAD_DEEP_TIER="0"),
                  cfg=dict(max_len=128, lanes=8, total_steps=192,
                           read_step_cap=192, max_chains=1024),
                  reads=3, block=64, stat="retried"),
    # a tiny per-read cap: abandons re-run under the deep config
    "deep": dict(env=dict(MAPAD_RETRY_TIER="1", MAPAD_DEEP_TIER="1",
                          MAPAD_DEEP_NOHIT_HOST="0"),
                 cfg=dict(max_len=128, lanes=8, total_steps=4096,
                          read_step_cap=64, max_chains=1024),
                 reads=1, block=64, stat="deep_retried"),
    # the default routing: escalatees without a hit go straight to the host
    "deep_nohit_host": dict(env=dict(MAPAD_DEEP_TIER="1"),
                            cfg=dict(max_len=128, lanes=8, total_steps=4096,
                                     read_step_cap=64, max_chains=1024),
                            reads=1, block=64, stat="nohit_host"),
    # big mode's default: the deep tier on without any variable set
    "deep_big_default": dict(env=dict(), big=True,
                             cfg=dict(max_len=128, lanes=8, total_steps=4096,
                                      read_step_cap=64, max_chains=1024),
                             reads=1, block=64, stat="deep_retried"),
}
_TIER_ENV = ("MAPAD_RETRY_TIER", "MAPAD_DEEP_TIER", "MAPAD_DEEP_NOHIT_HOST",
             "MAPAD_DEEP_LANES", "MAPAD_DEEP_KGENS", "MAPAD_HOST_BID")


@pytest.mark.parametrize("case", sorted(TIER_CASES))
def test_tiers_equal_jax(indexes, case, monkeypatch):
    """The same reads take the same way through the tiers in both
    packages: equal escalations by cause, equal `retried`, `deep_retried`,
    `nohit_host` and host-fallback counts, equal hits."""
    spec = TIER_CASES[case]
    for name in _TIER_ENV:
        monkeypatch.delenv(name, raising=False)
    for name, value in spec["env"].items():
        monkeypatch.setenv(name, value)
    reads = bench_reads(seed=13, n_random=24, n_exo=8) * spec["reads"]
    je, te = _pair(indexes, spec["cfg"], big=spec.get("big", False),
                   packed_hits=True)
    _assert_same_run(je, te, reads, spec["block"], True)
    assert te._stats.get(spec["stat"], 0) > 0
    assert te._stats["escalated"] > 0


def test_narrow_deep_config_shape_and_guard(indexes, monkeypatch):
    """MAPAD_DEEP_LANES narrows the deep config and asks for store
    generations: the fields equal the JAX package's; running it needs
    kernel K8, so the stream refuses before any block is launched."""
    monkeypatch.setenv("MAPAD_DEEP_TIER", "1")
    monkeypatch.setenv("MAPAD_DEEP_LANES", "4")
    cfg = dict(max_len=128, lanes=8, total_steps=2048, read_step_cap=64,
               max_chains=1024)
    je, te = _pair(indexes, cfg)
    deep, jdeep = te._deep_config(), je._deep_config()
    assert (deep.lanes, deep.total_steps, deep.read_step_cap) == (4, 4096,
                                                                   2048)
    for f in ("lanes", "total_steps", "read_step_cap", "generations",
              "min_live", "spill_steps"):
        assert getattr(deep, f) == getattr(jdeep, f), f
    assert deep.generations > 1
    recs = records("mapad_tpu_torch", bench_reads(seed=2, n_random=4))
    with pytest.raises(NotImplementedError, match="K8.*later slice"):
        te.search_chunk(recs, lazy_fallback=True)
    assert te._stats["batches"] == 0 and te._stats["steps"] == 0
    with pytest.raises(NotImplementedError, match="K8.*later slice"):
        te.warm(recs)
    # one generation (or no deep tier) runs
    monkeypatch.setenv("MAPAD_DEEP_KGENS", "1")
    assert len(te.search_chunk(recs)) == len(recs)


@pytest.mark.parametrize("what", ["mode", "generations", "shard",
                                  "bidirectional", "nohit_probe"])
def test_later_slices_raise_when_made(indexes, what, monkeypatch):
    """What is not ported yet refuses at construction or config time, not
    in the middle of a stream."""
    _jfmd, tfmd = indexes
    params = adna_params("mapad_tpu_torch")
    kw = dict(pool_config=TPoolConfig(**CFG), device="cpu")
    if what == "mode":
        kw["mode"] = "batch"  # fixed-batch engine, kernel K10
    elif what == "generations":
        kw["pool_config"] = TPoolConfig(**dict(CFG, generations=2))  # K8
    elif what == "shard":
        monkeypatch.setenv("MAPAD_SHARD", "1")  # the mesh, kernel K9
    elif what == "bidirectional":
        kw["pool_config"] = TPoolConfig(**dict(CFG, backward_only=False))
    elif what == "nohit_probe":
        monkeypatch.setenv("MAPAD_NOHIT_PROBE", "1")
        te = TEngine(tfmd, params, **kw)
        with pytest.raises(NotImplementedError, match="later slice"):
            te.search_chunk(records("mapad_tpu_torch", [b"ACGTACGTACGT"]))
        assert te._stats["batches"] == 0
        return
    with pytest.raises(NotImplementedError, match="later slice"):
        TEngine(tfmd, params, **kw)


def test_host_bid_off_on_a_small_index_equals_jax(indexes, monkeypatch):
    """MAPAD_HOST_BID=0: the device Bi-D path (K6, K7) with int32
    intervals."""
    monkeypatch.setenv("MAPAD_HOST_BID", "0")
    reads = bench_reads(seed=9, n_random=30, n_exo=4)
    je, te = _pair(indexes, CFG, packed_hits=True)
    assert not te._host_bid_active()
    _assert_same_run(je, te, reads, BLOCK, True)


def test_overflow_cause_equals_jax(indexes):
    """A chain log too small for the block: every read with a sequence
    escalates under `overflow`, as in the JAX package."""
    reads = bench_reads(seed=3, n_random=20, n_exo=2)
    je, te = _pair(indexes, dict(CFG, max_chains=8), packed_hits=True)
    _assert_same_run(je, te, reads, BLOCK, True)
    assert te._stats["esc_why"]["overflow"] > 0
