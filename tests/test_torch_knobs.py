"""The reference's last knobs on the port, against the JAX package: the
environment variables MAPAD_DEV_LUT, MAPAD_XD_STEPS, MAPAD_INFLIGHT,
MAPAD_PREP_THREADS and MAPAD_FB_THREADS (each read where and when the JAX
engine reads it, with its default), PoolConfig's `debug_ablate` and
`debug_fixed_steps` (the plain K2 in its four forms, below and above the
natural end of the loop), and the public helpers `occ4_batch` and
`unpack_op_*`.  Hits, PoolResult fields and routing counts are compared
bit for bit, with the same numpy inputs on both sides."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from mapad_tpu.ops import fm as jfm  # noqa: E402
from mapad_tpu.ops import search as jsearch  # noqa: E402
from mapad_tpu.ops.search_pool import PoolConfig as JPoolConfig  # noqa: E402
from mapad_tpu_torch.ops import engine as teng  # noqa: E402
from mapad_tpu_torch.ops import fm as tfm  # noqa: E402
from mapad_tpu_torch.ops import search as tsearch  # noqa: E402
from mapad_tpu_torch.ops import search_pool2 as sp2  # noqa: E402
from mapad_tpu_torch.ops.search_pool import PoolConfig as TPoolConfig  # noqa: E402
from test_torch_engine import (  # noqa: E402
    BLOCK,
    CFG,
    _assert_same_run,
    _pair,
    _stream,
    indexes,  # noqa: F401 (a fixture)
)
from torch_port_helpers import (  # noqa: E402
    adna_params,
    assert_bits_equal,
    assert_pool_results_equal,
    bench_reads,
    bench_ref,
    port_index,
    records,
    run_pool_both,
    vindija_params,
)

# every variable of the engine's routing and upload that a test here sets
_KNOBS = ("MAPAD_DEV_LUT", "MAPAD_XD_STEPS", "MAPAD_INFLIGHT",
          "MAPAD_PREP_THREADS", "MAPAD_FB_THREADS", "MAPAD_HOST_BID",
          "MAPAD_DEEP_TIER", "MAPAD_RETRY_TIER", "MAPAD_DEEP_NOHIT_HOST",
          "MAPAD_DEEP_LANES", "MAPAD_BID_RLE")


@pytest.fixture(autouse=True)
def _no_knobs(monkeypatch):
    for name in _KNOBS:
        monkeypatch.delenv(name, raising=False)


def _forbid(monkeypatch, module, name):
    """Make `module.name` raise: the path under test must not reach it."""
    def refuse(*a, **k):
        raise AssertionError(f"{name} was called")

    monkeypatch.setattr(module, name, refuse)


def _count(monkeypatch, module, name):
    """Count the calls of `module.name` (a list that grows by one a call)."""
    calls = []
    real = getattr(module, name)

    def counted(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(module, name, counted)
    return calls


# --- MAPAD_DEV_LUT ---------------------------------------------------------


@pytest.mark.parametrize("qual", [40, 100])
def test_dev_lut_off_small_equals_jax(indexes, qual, monkeypatch):
    """MAPAD_DEV_LUT=0 in small mode: every block uploads the host-scored
    rows (5L + 6RM words), reinterpreted as views: K4 never runs.  At
    quality 100 the device LUT is off anyway, and the two agree."""
    monkeypatch.setenv("MAPAD_DEV_LUT", "0")
    _forbid(monkeypatch, teng, "_unpack_prep_lut")
    views = _count(monkeypatch, teng, "_unpack_prep")
    ref = bench_ref()
    reads = bench_reads(seed=5, n_random=50, n_exo=6,
                        extra=[b"", ref[1000:1200]])
    je, te = _pair(indexes, CFG, packed_hits=True)
    assert te._host_bid_active()
    t_esc, t_hits = _assert_same_run(je, te, reads, BLOCK, True, qual)
    assert len(views) == te._stats["batches"] > 1
    assert len(t_esc) > 0
    assert sum(len(h) > 0 for h in t_hits) > len(reads) // 2


def test_dev_lut_off_big_equals_jax(indexes, monkeypatch):
    """MAPAD_DEV_LUT=0 in big mode: the dense arrays go up as they are, K6
    never runs, K7 still makes the Bi-D from them; the deep tier on."""
    monkeypatch.setenv("MAPAD_DEV_LUT", "0")
    _forbid(monkeypatch, teng, "_unpack_prep_full")
    bid = _count(monkeypatch, sp2, "compute_bi_d")
    reads = bench_reads(seed=5, n_random=50, n_exo=6)
    je, te = _pair(indexes, CFG, big=True, packed_hits=True)
    assert te.deep_tier_enabled() and not te._host_bid_active()
    t_esc, _hits = _assert_same_run(je, te, reads, BLOCK, True)
    assert len(bid) >= te._stats["batches"] > 1
    assert len(t_esc) > 0


def test_dev_lut_reads_the_environment_at_each_block(indexes, monkeypatch):
    """One engine follows the variable between calls: the blob of a block
    prepared with it unset is the small one, with "0" the full one."""
    _jfmd, tfmd = indexes
    te = teng.DeviceSearchEngine(tfmd, adna_params("mapad_tpu_torch"),
                                 pool_config=TPoolConfig(**CFG),
                                 device="cpu")
    recs = records("mapad_tpu_torch", bench_reads(seed=5)[:BLOCK])
    sizes = {}
    for value in (None, "0", "1"):
        if value is None:
            monkeypatch.delenv("MAPAD_DEV_LUT", raising=False)
        else:
            monkeypatch.setenv("MAPAD_DEV_LUT", value)
        cfg, prep, _ = te._prep_block(recs, BLOCK, te.pool_config)
        sizes[value] = (prep["dev_lut"], prep["blob"].size)
    L, M = BLOCK, cfg.max_len
    assert sizes[None] == sizes["1"] and sizes[None][0]
    assert sizes["0"] == (False, 5 * L + 6 * L * M)


# --- MAPAD_XD_STEPS --------------------------------------------------------


def test_xd_steps_off_big_deep_equals_jax(indexes, monkeypatch):
    """MAPAD_XD_STEPS=0 in big mode with the deep and retry tiers: K2
    keeps no step log, `read_steps` comes back as (R,) of -1 (so no read
    counts as deep by its steps, and unfinished lanes do not either), the
    XD tag falls back to the block's average, and the routing of escalated
    reads (retried, deep_retried, nohit_host, escalations by cause) equals
    the JAX engine's under the same variable, and differs from the
    default's."""
    cfg = dict(max_len=128, lanes=8, total_steps=192, read_step_cap=192,
               max_chains=1024)
    monkeypatch.setenv("MAPAD_RETRY_TIER", "1")
    reads = bench_reads(seed=13, n_random=24, n_exo=8) * 2
    routing = ("retried", "deep_retried", "nohit_host", "oracle")

    def run_port():
        _je, te = _pair(indexes, cfg, big=True, packed_hits=True)
        te.block_reads = 64
        seen = []
        decode = te._decode_pool

        def spy(chunk, result, out, *a, **k):
            seen.append(np.asarray(result.read_steps).copy())
            esc = decode(chunk, result, out, *a, **k)
            seen[-1] = (seen[-1], [o[1] for o in out if o is not None])
            return esc

        te._decode_pool = spy
        _stream(te, records("mapad_tpu_torch", reads), 64)
        return te, seen

    default, seen_on = run_port()
    monkeypatch.setenv("MAPAD_XD_STEPS", "0")
    je, te = _pair(indexes, cfg, big=True, packed_hits=True)
    assert te.deep_tier_enabled()
    _assert_same_run(je, te, reads, 64, True)
    off, seen_off = run_port()
    assert off._stats["esc_why"] == te._stats["esc_why"]
    for (rs, xd), (rs_on, _xd_on) in zip(seen_off, seen_on):
        assert rs.shape == rs_on.shape and (rs == -1).all()
        assert len(set(xd)) <= 1  # one average a block
    assert any((rs >= 0).any() for rs, _ in seen_on)
    assert (tuple(off._stats.get(k, 0) for k in routing)
            != tuple(default._stats.get(k, 0) for k in routing))


def test_xd_steps_sets_the_step_log_of_each_block(indexes, monkeypatch):
    _jfmd, tfmd = indexes
    te = teng.DeviceSearchEngine(tfmd, adna_params("mapad_tpu_torch"),
                                 pool_config=TPoolConfig(**CFG),
                                 device="cpu")
    recs = records("mapad_tpu_torch", bench_reads(seed=5)[:BLOCK])
    for value, track in ((None, True), ("0", False), ("1", True)):
        if value is not None:
            monkeypatch.setenv("MAPAD_XD_STEPS", value)
        cfg, _prep, _ = te._prep_block(recs, BLOCK, te.pool_config)
        assert cfg.track_read_steps is track


# --- MAPAD_INFLIGHT and MAPAD_PREP_THREADS ---------------------------------


@pytest.mark.parametrize("inflight", ["1", "3"])
def test_prep_threads_and_inflight_equal_jax(indexes, inflight, monkeypatch):
    """Two prep threads and 1 or 3 invocations in flight: the blocks come
    back in submission order, at most `inflight` invocations wait at once
    (exactly that many with enough blocks), and the hits, escalations and
    counters equal the JAX engine's under the same variables."""
    monkeypatch.setenv("MAPAD_PREP_THREADS", "2")
    monkeypatch.setenv("MAPAD_INFLIGHT", inflight)
    reads = bench_reads(seed=9, n_random=60, n_exo=6)
    je, te = _pair(indexes, CFG, packed_hits=True)
    waiting, most = [0], [0]
    launch, collect = te._launch_block, te._collect_pool

    def launched(*a, **k):
        waiting[0] += 1
        most[0] = max(most[0], waiting[0])
        return launch(*a, **k)

    def collected(*a, **k):
        waiting[0] -= 1
        return collect(*a, **k)

    te._launch_block, te._collect_pool = launched, collected
    _assert_same_run(je, te, reads, BLOCK, True)
    n_blocks = -(-len(reads) // BLOCK)
    assert n_blocks > 3
    assert most[0] == int(inflight)
    assert te._prep_exec._max_workers == 2
    # submission order, with the keys the caller gave
    recs = records("mapad_tpu_torch", reads)
    blocks = [(f"b{k}", recs[b : b + BLOCK])
              for k, b in enumerate(range(0, len(recs), BLOCK))]
    keys = [key for key, _ in te.search_stream(blocks, lazy_fallback=True)]
    assert keys == [key for key, _ in blocks]


def test_prep_executor_follows_the_variable(indexes, monkeypatch):
    """The prep executor is made anew when MAPAD_PREP_THREADS changes
    between calls; the one it replaces is shut down."""
    _jfmd, tfmd = indexes
    te = teng.DeviceSearchEngine(tfmd, adna_params("mapad_tpu_torch"),
                                 pool_config=TPoolConfig(**CFG),
                                 device="cpu")
    te.block_reads = BLOCK
    recs = records("mapad_tpu_torch", bench_reads(seed=5)[:BLOCK])
    te.search_chunk(recs)
    first = te._prep_exec
    assert first._max_workers == 1
    te.search_chunk(recs)
    assert te._prep_exec is first
    monkeypatch.setenv("MAPAD_PREP_THREADS", "3")
    te.search_chunk(recs)
    assert te._prep_exec._max_workers == 3 and first._shutdown


def test_prep_threads_share_one_helper_each(indexes):
    """Prep threads that ask at once for the engine's lazily made helpers
    (the host LUT cache, the C++ Bi-D and its one thread) get one object
    each: more threads than cores, a short switch interval."""
    import os
    import sys
    import threading

    _jfmd, tfmd = indexes
    te = teng.DeviceSearchEngine(tfmd, adna_params("mapad_tpu_torch"),
                                 pool_config=TPoolConfig(**CFG),
                                 device="cpu")
    n = 2 * (os.cpu_count() or 2) + 4
    start = threading.Barrier(n)
    got = [None] * n

    def ask(i):
        start.wait(timeout=60)
        got[i] = (te._lut_cache(), te._bid_exec(), te._native_bid())

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=ask, args=(i,)) for i in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert all(g is not None for g in got)
    for k in range(3):
        assert len({id(g[k]) for g in got}) == 1, k


# --- MAPAD_FB_THREADS ------------------------------------------------------


def test_fb_threads_follow_the_variable_between_calls(indexes, monkeypatch):
    """The exact fallback's pool has MAPAD_FB_THREADS threads, read at
    every call as the JAX engine reads it: 1, then 2 (a new pool, the old
    one shut down), then unset (the engine's `threads`); the hits equal
    the JAX engine's at each size."""
    reads = bench_reads(seed=11, n_random=40, n_exo=6)
    je, te = _pair(indexes, CFG, packed_hits=True, threads=3)
    pools = []
    # the counters add up over the three calls in both engines (the JAX
    # engine's steps are counted by a wrapper made once, in the first)
    counters = ("oracle", "escalated", "batches", "device_lanes")
    for value, want in (("1", 1), ("2", 2), (None, 3)):
        if value is None:
            monkeypatch.delenv("MAPAD_FB_THREADS")
        else:
            monkeypatch.setenv("MAPAD_FB_THREADS", value)
        t_esc, _hits = _assert_same_run(
            je, te, reads, BLOCK, True,
            counters=counters + (("steps",) if not pools else ()))
        assert len(t_esc) > 0
        assert te._fb_pool._max_workers == want == je._fb_threads
        pools.append(te._fb_pool)
    assert pools[0]._shutdown and pools[1]._shutdown
    assert not pools[2]._shutdown


# --- PoolConfig's debug fields ---------------------------------------------


def test_pool_config_fields_equal_jax():
    assert TPoolConfig._fields == JPoolConfig._fields
    for name, value in JPoolConfig()._asdict().items():
        assert getattr(TPoolConfig(), name) == value, name


@pytest.fixture(scope="module")
def ablate_case(indexes):
    """One small invocation's inputs on the port, and its result with no
    ablation flag."""
    _jfmd, tfmd = indexes
    te = teng.DeviceSearchEngine(
        tfmd, adna_params("mapad_tpu_torch"),
        pool_config=TPoolConfig(max_len=128, lanes=8, total_steps=512,
                                read_step_cap=256, max_chains=256),
        device="cpu")
    recs = records("mapad_tpu_torch", bench_reads(seed=21)[:24])
    cfg, prep, _ = te._prep_block(recs, 24, te.pool_config)
    consts, kw = te._upload(prep)

    def run(cfg):
        return sp2.k_mismatch_search_pool2(te.device_index, *consts,
                                           te._params(), cfg, **kw)

    return run, cfg, run(cfg)


@pytest.mark.parametrize("flags", [("pop",), ("extend",), ("lut",),
                                   ("frame",), ("store",), ("ring",),
                                   ("pop", "extend", "lut", "frame", "store",
                                    "ring")])
def test_debug_ablate_changes_nothing(ablate_case, flags):
    """As in the JAX package, the search reads no ablation flag."""
    run, cfg, want = ablate_case
    got = run(cfg._replace(debug_ablate=flags))
    assert int(want.n_chains) > 0
    for name in want._fields:
        assert_bits_equal(getattr(want, name).numpy(),
                          getattr(got, name).numpy(), (flags, name))


# the natural end of each form's loop on its reads (the JAX package's
# `steps` without a fixed count): 1591 backward-only, 1344 bidirectional
FIXED_FORMS = {
    "backward": dict(reads=dict(), params=adna_params,
                     cfg=dict(lanes=8, total_steps=2048,
                              read_step_cap=2048, max_chains=512),
                     natural=1591),
    "bidirectional": dict(reads=dict(seed=17, n_random=30, n_exo=4),
                          params=vindija_params,
                          cfg=dict(lanes=8, total_steps=3072,
                                   read_step_cap=512, max_chains=512),
                          natural=1344),
}


@pytest.mark.parametrize("where", ["below", "above"])
@pytest.mark.parametrize("form", sorted(FIXED_FORMS))
@pytest.mark.parametrize("big", [False, True])
def test_fixed_steps_plain_equals_jax(indexes, big, form, where):
    """debug_fixed_steps: exactly that many steps, whether or not every
    lane is done, in the plain K2 against the JAX package's loop, field by
    field: half the natural end (lanes come back unfinished, reads never
    dispatched) and past it (steps run with every lane done)."""
    jfmd, _tfmd = indexes
    spec = FIXED_FORMS[form]
    natural = spec["natural"]
    fixed = natural // 2 if where == "below" else natural + 100
    assert fixed < spec["cfg"]["total_steps"]
    reads = bench_reads(**spec["reads"])[:48]
    jr, tr, _eng = run_pool_both(
        jfmd, reads, 48, big=big, dense=big, params_of=spec["params"],
        debug_fixed_steps=fixed, **spec["cfg"])
    assert_pool_results_equal(jr, tr, (big, form, where))
    assert int(jr.steps) == fixed
    if where == "below":
        assert jr.lane_unfinished.any() and int(jr.next_read) < 48
    else:
        assert not jr.lane_unfinished.any() and int(jr.next_read) == 48


def test_fixed_steps_need_one_generation(indexes):
    """The JAX package asserts that a fixed step count runs one store
    generation; so does the port."""
    jfmd, _tfmd = indexes
    cfg = dict(lanes=8, total_steps=2048, read_step_cap=512,
               max_chains=512, generations=2, debug_fixed_steps=100)
    with pytest.raises(AssertionError, match="gens=1"):
        run_pool_both(jfmd, bench_reads()[:16], 16, **cfg)
    with pytest.raises(AssertionError, match="gens=1"):
        sp2._check_config(TPoolConfig(**cfg), 16)


# --- occ4_batch and unpack_op_* -------------------------------------------


@pytest.mark.parametrize("big", [False, True])
def test_occ4_batch_equals_jax(indexes, big):
    jfmd, _tfmd = indexes
    jidx = jfm.DeviceFmIndex.from_host(jfmd, big=big)
    tidx = port_index(jidx)
    idt = np.int64 if big else np.int32
    rng = np.random.default_rng(8)
    n = jidx.text_len
    r = np.concatenate([
        rng.integers(-1, n, size=300), [-1, 0, n - 1],
        rng.integers(np.iinfo(idt).min, np.iinfo(idt).max, size=40),
    ]).astype(idt)
    want = np.asarray(jfm.occ4_batch(jidx, jnp.asarray(r)))
    got = tfm.occ4_batch(tidx, torch.from_numpy(r))
    assert got.dtype == tidx.idx_dtype
    assert_bits_equal(want, got.numpy(), "occ4_batch")


def test_unpack_op_equals_jax():
    rng = np.random.default_rng(4)
    words = np.concatenate([
        np.asarray([int(jsearch.pack_op(k, p, b)) for k in range(4)
                    for p in (0, 1, 127, 0x7FFF) for b in range(4)]),
        rng.integers(-2**31, 2**31, size=200),
    ]).astype(np.int32)
    for name in ("unpack_op_kind", "unpack_op_pos", "unpack_op_base"):
        want = np.asarray(getattr(jsearch, name)(jnp.asarray(words)))
        got = getattr(tsearch, name)(torch.from_numpy(words)).numpy()
        assert_bits_equal(want, got, name)
        for w in words[:64].tolist():
            assert getattr(tsearch, name)(w) == getattr(jsearch, name)(w)
