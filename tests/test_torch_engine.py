"""The port's DeviceSearchEngine(device="cpu") against the JAX package's
engine over several streamed blocks: the same reads escalate, and every
read's hits are equal bit for bit, packed and decoded; in small mode, in
big (int64) mode with its defaults (Bi-D on the device, deep tier on), and
through the retry and deep tiers with equal counters; with store
generations (MAPAD_KGENS, the narrow deep config), the bidirectional search
of center-start models and the batched no-hit probe.  What the engine
cannot run raises when it is made."""

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
    vindija_params,
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


def _count_steps(je):
    """The JAX engine keeps no step count: sum `steps` of every result it
    unpacks into `je._stats["steps"]`, as the port's engine does."""
    unpack = je._unpack_result

    def counting(handle, flat):
        res = unpack(handle, flat)
        je._stats["steps"] = je._stats.get("steps", 0) + int(res.steps)
        return res

    je._unpack_result = counting


def _assert_same_run(je, te, reads, block, packed, qual=40,
                     counters=("retried", "deep_retried", "nohit_host",
                               "oracle", "escalated", "batches",
                               "device_lanes", "steps")):
    je.block_reads = te.block_reads = block
    _count_steps(je)
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
    generations (kernel K8): the fields equal the JAX package's, and the
    same reads take the same way through it in both packages."""
    for name in _TIER_ENV:
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("MAPAD_DEEP_TIER", "1")
    monkeypatch.setenv("MAPAD_DEEP_LANES", "4")
    monkeypatch.setenv("MAPAD_DEEP_NOHIT_HOST", "0")
    monkeypatch.setenv("MAPAD_KGENS_MIN_LIVE", "1")
    cfg = dict(max_len=128, lanes=8, total_steps=2048, read_step_cap=64,
               max_chains=1024)
    je, te = _pair(indexes, cfg, packed_hits=True)
    deep, jdeep = te._deep_config(), je._deep_config()
    assert (deep.lanes, deep.total_steps, deep.read_step_cap) == (4, 4096,
                                                                   2048)
    for f in ("lanes", "total_steps", "read_step_cap", "generations",
              "min_live", "spill_steps"):
        assert getattr(deep, f) == getattr(jdeep, f), f
    assert deep.generations == 4
    reads = bench_reads(seed=13, n_random=24, n_exo=8)
    _assert_same_run(je, te, reads, 64, True)
    assert te._stats.get("deep_retried", 0) > 0
    recs = records("mapad_tpu_torch", bench_reads(seed=2, n_random=4))
    te.warm(recs)  # the deep config runs in warm too
    monkeypatch.setenv("MAPAD_DEEP_KGENS", "1")
    assert te._deep_config().generations == 1
    assert len(te.search_chunk(recs)) == len(recs)


_POOL_ENV = ("MAPAD_POOL_STEPS", "MAPAD_POOL_CAP", "MAPAD_KGENS",
             "MAPAD_KGENS_MIN_LIVE", "MAPAD_SPILL")


@pytest.mark.parametrize("env", [
    {},
    dict(MAPAD_KGENS="4", MAPAD_KGENS_MIN_LIVE="8", MAPAD_SPILL="512"),
    dict(MAPAD_POOL_STEPS="4096", MAPAD_POOL_CAP="1024", MAPAD_KGENS="2"),
    # no margin for a boundary: one generation
    dict(MAPAD_POOL_STEPS="3074", MAPAD_KGENS="4"),
], ids=["defaults", "kgens", "steps_cap", "no_margin"])
def test_default_pool_config_equals_jax(indexes, env, monkeypatch):
    """The config an engine makes for itself is the JAX package's, field by
    field, under the same environment."""
    for name in _POOL_ENV:
        monkeypatch.delenv(name, raising=False)
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    jfmd, tfmd = indexes
    for lanes in (2048, 64):
        je = JEngine(jfmd, adna_params("mapad_tpu"), lanes=lanes, mode="pool")
        te = TEngine(tfmd, adna_params("mapad_tpu_torch"), lanes=lanes,
                     device="cpu")
        for f in TPoolConfig._fields:
            assert getattr(te.pool_config, f) == getattr(je.pool_config, f), f
    if not env:
        assert (te.pool_config.min_live, te.pool_config.spill_steps) == (32,
                                                                         768)


# the starved shape of tests/test_device_search.py: 8 lanes x 640 steps
# cannot finish the block in one store generation
_STARVED = dict(max_len=128, lanes=8, total_steps=640, read_step_cap=512,
                max_chains=1024, min_live=1)


@pytest.mark.parametrize("spill", [0, 96])
def test_store_generations_engine_equals_jax(indexes, spill, monkeypatch):
    """Four store generations (what MAPAD_KGENS=4 asks for) on a starved
    step budget: reads left unfinished or undispatched at a full store
    resume after the compaction; every counter and every hit equals the
    JAX engine's, and the host searches fewer reads than at one
    generation."""
    for name in _TIER_ENV:
        monkeypatch.delenv(name, raising=False)
    reads = bench_reads(seed=31, n_random=40, n_exo=0)
    reads = (reads * 2)[:96]
    host = {}
    for gens in (1, 4):
        je, te = _pair(indexes, dict(_STARVED, generations=gens,
                                     spill_steps=spill), packed_hits=True)
        assert te.pool_config.generations == gens
        _assert_same_run(je, te, reads, 96, True)
        host[gens] = te._stats["oracle"]
    assert host[1] > 0, host
    assert host[4] < host[1] if spill == 0 else host[4] <= host[1], host


def test_nohit_probe_equals_jax(indexes, monkeypatch):
    """MAPAD_NOHIT_PROBE=1: escalatees without a hit go through the batched
    exhaustion probes of the host C++ searcher (several batches of 5).  The
    chimeric reads of tests/test_device_search.py: both halves extend far,
    no full alignment exists."""
    for name in _TIER_ENV:
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("MAPAD_NOHIT_PROBE", "1")
    monkeypatch.setenv("MAPAD_PROBE_BATCH", "5")
    ref = bench_ref()
    rng = np.random.default_rng(41)
    reads = bench_reads(n_random=0, n_exo=0)
    for _ in range(24):
        ln = int(rng.integers(48, 90))
        h = ln // 2
        a = int(rng.integers(0, len(ref) - h))
        b = int(rng.integers(0, len(ref) - h))
        reads.append(ref[a : a + h] + ref[b : b + ln - h])
    cfg = dict(max_len=128, lanes=8, total_steps=4096, read_step_cap=16,
               max_chains=256)
    for packed in (True, False):
        je, te = _pair(indexes, cfg, packed_hits=packed)
        _assert_same_run(je, te, reads, len(reads), packed)
        assert te._stats["oracle"] > 0
        # read after every future resolved: fallback-pool tasks write it
        assert te._stats.get("probe_empty", 0) > 0
        assert te._stats["probe_empty"] == je._stats["probe_empty"]


def _test_model_params(pkg):
    """tests/test_device_search.py::test_test_model_device_equals_oracle: a
    model whose alignment starts in the middle of the read."""
    models = __import__(f"{pkg}.models", fromlist=["x"])
    mapping = __import__(f"{pkg}.map", fromlist=["x"])
    return mapping.AlignmentParameters(
        difference_model=models.TestDifferenceModel(
            deam_score=-0.5, mm_score=-1.0, match_score=0.0),
        mismatch_bound=models.TestBound(threshold=-2.0,
                                        representative_mm_bound=-1.0),
        penalty_gap_open=-2.0, penalty_gap_extend=-1.0, chunk_size=1,
        gap_dist_ends=0, stack_limit_abort=False, max_num_gaps_open=2,
    )


@pytest.mark.parametrize("big", [False, True])
@pytest.mark.parametrize("model", ["test", "vindija"])
def test_bidirectional_engine_equals_jax_and_oracle(indexes, model, big,
                                                    monkeypatch):
    """A center-start model turns `backward_only` off in both engines; the
    hits equal the JAX engine's and the port's own sequential oracle's."""
    from mapad_tpu_torch.map.oracle import k_mismatch_search

    for name in _TIER_ENV:
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("MAPAD_DEEP_TIER", "0")
    params_of = _test_model_params if model == "test" else vindija_params
    qual = 0 if model == "test" else 40
    jfmd, tfmd = indexes
    cfg = dict(max_len=128, lanes=8, total_steps=4096, read_step_cap=1024,
               max_chains=512)
    je = JEngine(jfmd, params_of("mapad_tpu"), mode="pool",
                 pool_config=JPoolConfig(compute_forward_part=True, **cfg),
                 big=big)
    tparams = params_of("mapad_tpu_torch")
    te = TEngine(tfmd, tparams, pool_config=TPoolConfig(
        compute_forward_part=True, **cfg), big=big, device="cpu")
    assert not te.pool_config.backward_only
    assert not je.pool_config.backward_only
    reads = bench_reads(seed=21, n_random=20, n_exo=3)[:40]
    _esc, hits = _assert_same_run(je, te, reads, 40, False, qual)
    assert sum(len(h) > 0 for h in hits) > len(reads) // 2
    for read, got in zip(reads, hits):
        want = k_mismatch_search(read, [qual] * len(read), tparams, tfmd)
        assert hits_equal(got, want), read[:16]


@pytest.mark.parametrize("what", ["mode"])
def test_later_slices_raise_when_made(indexes, what):
    """What the engine cannot run refuses at construction time, not in the
    middle of a stream: the fixed-batch mode with a big (int64) index, as
    in mapad_tpu."""
    _jfmd, tfmd = indexes
    params = adna_params("mapad_tpu_torch")
    kw = dict(pool_config=TPoolConfig(**CFG), device="cpu")
    with pytest.raises(ValueError, match="mode='pool'"):
        TEngine(tfmd, params, mode="batch", big=True, **kw)


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
