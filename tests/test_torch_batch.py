"""The port's fixed-batch search (the plain version of kernel K10, with the
plain K7 before it) against the JAX package's `k_mismatch_search_batch`,
field by field and bit for bit (f32 by its bits), on the same prep of one
batch: the aDNA model, a center-start model, a step budget that leaves
lanes live, a hit cap below the completions of reads from a repeat, and a
batch with empty, overlong and N-containing reads.  Then the batch engine
(`mode="batch"`, two tiers) of both packages: the same hits per read, the
same counters, and the hits of the port's sequential oracle; reads with
more completions than hit slots; the engine's construction rules; and the
hybrid engine in batch mode."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from mapad_tpu.index.builder import build_auxiliary_structures  # noqa: E402
from mapad_tpu.ops.engine import DeviceSearchEngine as JEngine  # noqa: E402
from mapad_tpu.ops.engine import HybridSearchEngine as JHybrid  # noqa: E402
from mapad_tpu.ops.search import SearchConfig as JSearchConfig  # noqa: E402
from mapad_tpu.ops.search import k_mismatch_search_batch as jsearch  # noqa: E402
from mapad_tpu_torch.index.builder import (  # noqa: E402
    build_auxiliary_structures as t_build,
)
from mapad_tpu_torch.map.oracle import k_mismatch_search  # noqa: E402
from mapad_tpu_torch.ops.engine import DeviceSearchEngine as TEngine  # noqa: E402
from mapad_tpu_torch.ops.engine import HybridSearchEngine as THybrid  # noqa: E402
from mapad_tpu_torch.ops.fm import DeviceFmIndex  # noqa: E402
from mapad_tpu_torch.ops.search import (  # noqa: E402
    SearchConfig,
    SearchParams,
    k_mismatch_search_batch,
)
from torch_port_helpers import (  # noqa: E402
    adna_params,
    assert_bits_equal,
    bench_reads,
    bench_ref,
    hits_equal,
    packed_equal,
    records,
    repeat_ref,
    vindija_params,
)

M = 128
TIERS = ((64, None), (2048, 8))


@pytest.fixture(scope="module")
def indexes():
    ref = bench_ref()
    return build_auxiliary_structures(ref, b"ACGT")[0], t_build(ref, b"ACGT")[0]


def _case(name):
    """-> (reference, reads, lanes, alignment parameters of a package,
    config fields)."""
    ref = bench_ref()
    if name == "adna":
        return ref, bench_reads(seed=3)[:40], 40, adna_params, dict(
            max_steps=512)
    if name == "center":
        return ref, bench_reads(seed=4, n_random=20)[:24], 24, \
            vindija_params, dict(max_steps=512, compute_forward_part=True)
    if name == "budget":
        return ref, bench_reads(seed=5)[:32], 32, adna_params, dict(
            max_steps=32)
    if name == "hit_cap":
        rref, seg = repeat_ref()
        reads = [seg, seg[5:55], seg[:50], seg[8:], ref[2000:2060]]
        return rref, reads * 4, 20, adna_params, dict(max_steps=512,
                                                      hit_cap=4)
    assert name == "edges"
    reads = bench_reads(seed=6, n_random=12, n_exo=2)
    reads[1] = b""
    reads[3] = ref[3000:3000 + M + 7]  # overlong: enters the batch empty
    reads[4] = reads[4][:20] + b"N" + reads[4][21:]
    reads[6] = b"NNNN" + reads[6][4:]
    return ref, reads[:16], 16, adna_params, dict(max_steps=512)


@pytest.mark.parametrize("name", ["adna", "center", "budget", "hit_cap",
                                  "edges"])
def test_batch_search_plain_equals_jax(name):
    ref, reads, L, params_of, cfg_kw = _case(name)
    jfmd = build_auxiliary_structures(ref, b"ACGT")[0]
    je = JEngine(jfmd, params_of("mapad_tpu"), lanes=L)
    recs = records("mapad_tpu", [r if len(r) <= M else b"" for r in reads])
    prep = je._prepare(recs, M, L)
    jcfg = JSearchConfig(max_len=M, **cfg_kw)
    jr = jax.tree.map(np.asarray, jsearch(
        je.device_index, prep["pattern_rank"], prep["pattern_code"],
        prep["n"], prep["score_lut"], prep["pen"], prep["split"],
        prep["cutoff_scale"], prep["cutoff_thresh"], prep["repr_mm"],
        je._params(), jcfg))

    di = je.device_index
    tidx = DeviceFmIndex.from_numpy(
        np.asarray(di.rows), np.asarray(di.less), np.asarray(di.sentinels),
        di.occ_k, di.text_len, device="cpu")

    def t(k):
        return torch.from_numpy(np.array(prep[k]))

    tr = k_mismatch_search_batch(
        tidx, t("pattern_rank").to(torch.int32), t("pattern_code"), t("n"),
        t("score_lut"), t("pen"), t("split"), t("cutoff_scale"),
        t("cutoff_thresh"), t("repr_mm"),
        SearchParams.from_alignment(params_of("mapad_tpu_torch"), "cpu"),
        SearchConfig(*jcfg))
    assert tuple(tr._fields) == tuple(jr._fields)
    for field in jr._fields:
        assert_bits_equal(np.asarray(getattr(jr, field)),
                          getattr(tr, field).numpy(), (name, field))

    # what each case is there to reach
    hc, esc, steps = jr.hcount, jr.escalate, int(jr.steps)
    assert (hc > 0).any() and (~esc).any()
    if name == "budget":
        assert steps == 32 and esc.any()
    if name == "hit_cap":
        assert (hc > 4).any()  # more completions than hit slots
    if name == "center":
        assert (np.asarray(prep["split"])[:len(reads)] < [len(r) for r in
                                                           reads]).all()
    if name == "edges":
        empty = np.asarray(prep["n"]) == 0
        assert empty[1] and empty[3] and (hc[empty] == 0).all()


def _batch_engines(indexes, packed, **kw):
    jfmd, tfmd = indexes
    kw = dict(mode="batch", lanes=16, tiers=TIERS, packed_hits=packed, **kw)
    return (JEngine(jfmd, adna_params("mapad_tpu"), **kw),
            TEngine(tfmd, adna_params("mapad_tpu_torch"), device="cpu", **kw))


@pytest.mark.parametrize("packed", [False, True])
def test_batch_engine_equals_jax_and_oracle(indexes, packed):
    """Two tiers: the first (64 steps, 16 lanes) escalates most reads to
    the second (2,048 steps, 8 lanes), whose escalatees and the overlong
    read go to the exact host searcher."""
    ref = bench_ref()
    reads = bench_reads(seed=11, n_random=14, n_exo=3,
                        extra=[b"", ref[1000:1200]])
    je, te = _batch_engines(indexes, packed)
    want = je.search_chunk(records("mapad_tpu", reads))
    got = te.search_chunk(records("mapad_tpu_torch", reads))
    same = packed_equal if packed else hits_equal
    assert len(got) == len(reads)
    assert all(same(a[0], b[0]) for a, b in zip(got, want))
    for k in ("device_lanes", "escalated", "batches", "oracle"):
        assert te._stats[k] == je._stats[k], k
    # both tiers ran, and the host searched the overlong read at least
    assert te._stats["batches"] > -(-len(reads) // 16)
    assert te._stats["escalated"] > 0 and te._stats["oracle"] >= 1
    if not packed:
        params = adna_params("mapad_tpu_torch")
        tfmd = indexes[1]
        for read, (hits, _secs) in zip(reads, got):
            want_o = k_mismatch_search(read, [40] * len(read), params, tfmd)
            assert hits_equal(hits, want_o), read[:16]


def test_batch_engine_hit_overflow_goes_to_the_host():
    """Reads that complete more often than the config has hit slots: the
    port sends them on like escalatees and returns the exact hits, where
    mapad_tpu's decoder indexes past the slots and fails."""
    from mapad_tpu.ops.search import SearchConfig as JCfg

    rref, seg = repeat_ref()
    reads = [seg, seg[5:55], bench_ref()[2000:2060]]
    kw = dict(mode="batch", lanes=8, tiers=((512, None),))
    params = adna_params("mapad_tpu_torch")
    tfmd = t_build(rref, b"ACGT")[0]
    te = TEngine(tfmd, params, config=SearchConfig(hit_cap=4),
                 device="cpu", **kw)
    got = te.search_chunk(records("mapad_tpu_torch", reads))
    assert te._stats["escalated"] == te._stats["oracle"] == 2
    for read, (hits, _secs) in zip(reads, got):
        assert hits_equal(hits, k_mismatch_search(read, [40] * len(read),
                                                  params, tfmd))
    assert len(got[0][0]) > 4
    je = JEngine(build_auxiliary_structures(rref, b"ACGT")[0],
                 adna_params("mapad_tpu"), config=JCfg(hit_cap=4), **kw)
    with pytest.raises(IndexError):
        je.search_chunk(records("mapad_tpu", reads))


@pytest.mark.parametrize("pkg", ["mapad_tpu", "mapad_tpu_torch"])
def test_batch_mode_with_a_big_index_raises(indexes, pkg):
    jfmd, tfmd = indexes
    if pkg == "mapad_tpu":
        make = lambda: JEngine(jfmd, adna_params(pkg), mode="batch",  # noqa: E731
                               big=True)
    else:
        make = lambda: TEngine(tfmd, adna_params(pkg), mode="batch",  # noqa: E731
                               big=True, device="cpu")
    with pytest.raises(ValueError, match="pool"):
        make()


def test_batch_mode_constructs_with_shard_set(indexes, monkeypatch):
    """MAPAD_SHARD=1 asks for the mesh of pool mode only: the batch engine
    is made (as in mapad_tpu, which shards only `mode == "pool"`)."""
    monkeypatch.setenv("MAPAD_SHARD", "1")
    eng = TEngine(indexes[1], adna_params("mapad_tpu_torch"), mode="batch",
                  device="cpu")
    assert eng.mode == "batch" and eng.tiers == ((2048, None),)


def test_hybrid_batch_mode_equals_jax(indexes):
    """The device part of the chunk (its head) runs the batch engine, the
    native searcher the tail."""
    jfmd, tfmd = indexes
    ref = bench_ref()
    rng = np.random.default_rng(17)
    reads = []
    for _ in range(260):  # > 256, so the chunk really splits
        ln = int(rng.integers(30, 90))
        st = int(rng.integers(0, len(ref) - ln))
        reads.append(ref[st : st + ln])
    kw = dict(mode="batch", lanes=16, tiers=((64, None), (512, 8)),
              threads=2, device_fraction=0.1)
    je = JHybrid(jfmd, adna_params("mapad_tpu"), **kw)
    te = THybrid(tfmd, adna_params("mapad_tpu_torch"), device="cpu", **kw)
    assert te.device.mode == "batch"
    want = je.search_chunk(records("mapad_tpu", reads))
    got = te.search_chunk(records("mapad_tpu_torch", reads))
    assert len(got) == len(reads)
    assert all(hits_equal(a[0], b[0]) for a, b in zip(got, want))
    for k in ("device_lanes", "escalated", "batches", "oracle"):
        assert te._stats[k] == je._stats[k], k
    # 26 reads on the device: two tiers, so more lanes than reads
    assert te._stats["hybrid_device_reads"] == 26
    assert te._stats["device_lanes"] > 26
