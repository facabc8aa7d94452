"""The hand-written CUDA kernels against their plain PyTorch versions, on
the card, at small shapes that reach the edge cases (abandon markers, chain
log overflow, an exhausted step budget, the RLE and raw Bi-D blobs, store
boundaries with and without overlap of the moved window, the bidirectional
search), with int32 intervals and with the int64 intervals of big mode;
the fixed-batch search (K10) and its engine; and the pool search over
several shards (K9 and its `shard_rebase`), on one card and, where the
machine has them, over distinct cards; and the ports of the TPU's DMA
probes (P1 `gather_steps`, P2-P4 `copy_src_slice` / `copy_dst_slice`) at
their edge cases, with the probe tools themselves.  Engines run on one card unless a
test asks for a mesh (MAPAD_SHARD=0 by default here).

Needs an NVIDIA GPU with nvcc; skips elsewhere.  On the card:

    python -m pytest --noconftest -m gpu tests/test_torch_cuda.py
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_port_helpers import (  # noqa: E402
    adna_params,
    bench_reads,
    bench_ref,
    records,
)

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernels have no CPU mode)")
    from mapad_tpu_torch import _build

    if _build.nvcc_path() is None:
        pytest.skip("needs nvcc to build the kernels")
    _build.build_cuda()
    return torch.device("cuda")


@pytest.fixture(autouse=True)
def _one_card(monkeypatch):
    """On a machine with several cards an engine would shard over all of
    them by default: the tests of one card keep to one."""
    monkeypatch.setenv("MAPAD_SHARD", "0")


@pytest.fixture(scope="module")
def fmd():
    from mapad_tpu_torch.index.builder import build_auxiliary_structures

    return build_auxiliary_structures(bench_ref(), b"ACGT")[0]


def _equal(got, want, what):
    for k, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape and g.dtype == w.dtype, (what, k)
        if g.dtype == torch.float32:
            g, w = g.view(torch.int32), w.view(torch.int32)
        assert torch.equal(g, w), (what, k, int((g != w).sum()))


def _prepped(fmd, cuda, cfg_kw, seed, rle=True, monkeypatch=None, big=False,
             qual=40, params=None, reads=None, R=48):
    from mapad_tpu_torch.ops.engine import DeviceSearchEngine
    from mapad_tpu_torch.ops.search_pool import PoolConfig

    if not rle:
        monkeypatch.setenv("MAPAD_BID_RLE", "0")
    eng = DeviceSearchEngine(fmd, params or adna_params("mapad_tpu_torch"),
                             pool_config=PoolConfig(**cfg_kw), device=cuda,
                             big=big)
    recs = records("mapad_tpu_torch",
                   bench_reads(seed=seed) if reads is None else reads, qual)
    cfg, prep, _ = eng._prep_block(recs, R, eng.pool_config)
    return eng, cfg, prep


def _pool_both(eng, cfg, prep, cuda):
    """K2 (+ K8) + K3 on the card and their plain versions on the same
    device inputs -> (kernel result, plain result, K8 calls)."""
    from mapad_tpu_torch.ops import search_pool2 as sp2

    with torch.cuda.device(cuda):
        consts, kw = eng._upload(prep)
        slut = kw["slut"] if "slut" in kw else sp2._dense_slut(
            eng.device_index, kw["dense"], consts[0], consts[1], cfg,
            kw["bid_steps"])
        args = (eng.device_index, *consts, eng._params(), cfg, slut)
        fired = []
        got = sp2._extract_chains_cuda(
            *sp2._pool_loop_cuda(*args, boundary_log=fired), cfg)
        want = sp2._extract_chains_plain(*sp2._pool_loop_plain(*args), cfg)
        torch.cuda.synchronize()
    return got, want, len(fired)


@pytest.mark.parametrize("rle", [True, False])
def test_unpack_prep_kernel(fmd, cuda, rle, monkeypatch):
    from mapad_tpu_torch.ops import engine as teng
    from mapad_tpu_torch.ops.prep import _DEV_LUT_Q

    eng, _cfg, prep = _prepped(fmd, cuda, dict(lanes=8, total_steps=256),
                               1, rle, monkeypatch)
    assert prep["rle"] == rle
    blob = torch.from_numpy(prep["blob"]).to(cuda)
    tab, _pen_tab, off = eng._device_lut()
    R, M = prep["L"], prep["max_len"]
    got = teng._unpack_prep_lut(blob, tab, off, R, M, _DEV_LUT_Q, rle)
    want = teng._unpack_prep_lut_plain(blob, tab, off, R, M, _DEV_LUT_Q, rle)
    _equal(got, want, "unpack_prep")


def test_unpack_prep_full_kernel(fmd, cuda):
    """K6: the small blob of big mode -> the nine dense inputs."""
    from mapad_tpu_torch.ops import engine as teng
    from mapad_tpu_torch.ops.prep import _DEV_LUT_Q

    eng, _cfg, prep = _prepped(fmd, cuda, dict(lanes=8, total_steps=256), 1,
                               big=True)
    assert prep["dev_full"]
    blob = torch.from_numpy(prep["blob"]).to(cuda)
    tab, pen_tab, off = eng._device_lut()
    R, M = prep["L"], prep["max_len"]
    got = teng._unpack_prep_full(blob, tab, pen_tab, off, R, M, _DEV_LUT_Q)
    want = teng._unpack_prep_full_plain(blob, tab, pen_tab, off, R, M,
                                        _DEV_LUT_Q)
    _equal(got, want, "unpack_prep_full")


@pytest.mark.parametrize("big", [False, True])
def test_extend_batch_kernel(fmd, cuda, big):
    from mapad_tpu_torch.ops import fm

    idx = fm.DeviceFmIndex.from_host(fmd, big=big, device=cuda)
    idt = np.int64 if big else np.int32
    rng = np.random.default_rng(3)
    n = idx.text_len
    lower = rng.integers(0, n, size=300).astype(idt)
    size = np.minimum(rng.integers(0, 50, size=300), n - lower).astype(idt)
    lower[:5] = 0
    size[:3] = n
    lrev = rng.integers(0, n, size=300).astype(idt)
    t = [torch.from_numpy(a).to(cuda) for a in (lower, lrev, size)]
    _equal(fm.extend_batch(idx, *t), fm.extend_batch_plain(idx, *t), "K1")
    # intervals no read holds: garbage wraps and clamps as in the plain
    # version
    info = np.iinfo(idt)
    g = [torch.from_numpy(rng.integers(info.min, info.max, size=64,
                                       dtype=idt)).to(cuda)
         for _ in range(3)]
    _equal(fm.extend_batch(idx, *g), fm.extend_batch_plain(idx, *g),
           "K1 garbage")
    if big:
        # counts above 2^32: nonzero checkpoint high words
        rows = idx.rows.clone()
        cp = ((rows[:, 0:6].long() & 0xFFFFFFFF)
              | (rows[:, 6:12].long() << 32)) + ((3 << 32) + 12345)
        rows[:, 0:6] = (cp & 0xFFFFFFFF).to(torch.int32)
        rows[:, 6:12] = (cp >> 32).to(torch.int32)
        shifted = idx._replace(rows=rows, less=idx.less + ((5 << 32) + 999))
        got = fm.extend_batch(shifted, *t)
        _equal(got, fm.extend_batch_plain(shifted, *t), "K1 above 2^32")
        assert int(got[0].min()) > 2**32


@pytest.mark.parametrize("big", [False, True])
@pytest.mark.parametrize("forward_part", [False, True])
@pytest.mark.parametrize("longest", [100, 37])
def test_bi_d_kernel(fmd, cuda, big, forward_part, longest):
    """K7 against its plain version: both index widths, with and without
    the forward part, and a block whose longest read is shorter than the
    pattern axis (the padding columns)."""
    from mapad_tpu_torch.ops import bi_d, fm

    idx = fm.DeviceFmIndex.from_host(fmd, big=big, device=cuda)
    ref = bench_ref()
    rng = np.random.default_rng(longest)
    L, M = 70, 112
    n = rng.integers(0, longest + 1, size=L).astype(np.int32)
    n[0], n[1] = 0, longest
    split = (n * rng.uniform(0.3, 1, size=L)).astype(np.int32)
    split[1], split[2] = n[1], 0
    rank = np.zeros((L, M), np.int32)
    pen = np.zeros((L, M), np.float32)
    for i in range(L):
        st = int(rng.integers(0, len(ref) - M))
        rank[i, : n[i]] = [b"ACGT".index(c) + 1
                           for c in ref[st : st + n[i]]]
        for _ in range(3):
            if n[i]:
                rank[i, rng.integers(0, n[i])] = rng.integers(0, 5)
        pen[i, : n[i]] = -rng.uniform(0.1, 5, size=n[i]).astype(np.float32)
    t = [torch.from_numpy(a).to(cuda) for a in (rank, pen, n, split)]
    steps = (int(split.max()), int((n - split).max()))
    for st in (steps, None):
        got = bi_d.compute_bi_d(idx, *t, forward_part, st)
        want = bi_d.compute_bi_d_plain(idx, *t, forward_part, st)
        _equal((got,), (want,), ("bi_d", st))
    assert bool((got != 0).any())


CASES = {
    "bench": dict(lanes=8, total_steps=2048, read_step_cap=2048,
                  max_chains=512),
    "abandon": dict(lanes=8, total_steps=2048, read_step_cap=64,
                    max_chains=512),
    "overflow": dict(lanes=8, total_steps=2048, read_step_cap=2048,
                     max_chains=16),
    "budget": dict(lanes=8, total_steps=96, read_step_cap=64,
                   max_chains=512),
    "wide": dict(lanes=64, total_steps=512, read_step_cap=300,
                 max_chains=64),
}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("track", [True, False])
@pytest.mark.parametrize("big", [False, True])
def test_pool_search_and_pack_kernels(fmd, cuda, case, track, big):
    """K2 + K3 + K5; with `big` the int64 forms behind K6 and K7 (the small
    blob unpacked and the Bi-D computed on the card)."""
    from mapad_tpu_torch.ops import engine as teng
    from mapad_tpu_torch.ops import search_pool2 as sp2

    eng, cfg, prep = _prepped(fmd, cuda, CASES[case], seed=len(case),
                              big=big)
    cfg = cfg._replace(track_read_steps=track)
    assert ("blob" in prep and bool(prep.get("dev_full"))) == big
    got, want, _fired = _pool_both(eng, cfg, prep, cuda)
    _equal(tuple(got), tuple(want), case)
    _equal((teng._pack_result(got),), (teng._pack_result_plain(got),),
           "pack_result")


# store generations: (config, K8 calls the reads force at least)
GEN_CASES = {
    # cap > steps / 2: the moved window overlaps its old place (4 chunks)
    "overlap": (dict(lanes=8, total_steps=640, read_step_cap=512,
                     max_chains=1024, generations=4, min_live=1), 2),
    # cap < steps / 2: one move
    "no_overlap": (dict(lanes=8, total_steps=448, read_step_cap=160,
                        max_chains=1024, generations=4, min_live=1), 2),
    # a capped spill: the generation after the boundary stops early
    "spill": (dict(lanes=8, total_steps=640, read_step_cap=512,
                   max_chains=1024, generations=4, min_live=1,
                   spill_steps=96), 1),
    # more chains than the log holds: the append offset clamps
    "overflow": (dict(lanes=8, total_steps=640, read_step_cap=512,
                      max_chains=24, generations=4, min_live=1), 2),
    # a generation left but too few live lanes: no boundary
    "min_live": (dict(lanes=8, total_steps=640, read_step_cap=512,
                      max_chains=1024, generations=4, min_live=9), 0),
    # wider than a warp, the margin at its least (cap + 4 == steps)
    "margin": (dict(lanes=40, total_steps=132, read_step_cap=128,
                    max_chains=1024, generations=3, min_live=1), 2),
}


@pytest.mark.parametrize("case", sorted(GEN_CASES))
@pytest.mark.parametrize("track", [True, False])
@pytest.mark.parametrize("big", [False, True])
def test_pool_compact_kernel(fmd, cuda, case, track, big):
    """K8 (and K3 at the boundaries, K2 going on after them) against the
    plain generations loop: every PoolResult field equal."""
    cfg_kw, least = GEN_CASES[case]
    reads = (bench_reads(seed=31, n_random=40, n_exo=0) * 2)[:96]
    eng, cfg, prep = _prepped(fmd, cuda, cfg_kw, 0, big=big, reads=reads,
                              R=96)
    cfg = cfg._replace(track_read_steps=track)
    got, want, fired = _pool_both(eng, cfg, prep, cuda)
    _equal(tuple(got), tuple(want), case)
    assert fired >= least and (least or not fired), fired
    if fired:
        assert int(got.steps) > cfg.total_steps


def _center_params(model):
    from mapad_tpu_torch import models
    from mapad_tpu_torch.map import AlignmentParameters

    if model == "test":
        return AlignmentParameters(
            difference_model=models.TestDifferenceModel(
                deam_score=-0.5, mm_score=-1.0, match_score=0.0),
            mismatch_bound=models.TestBound(threshold=-2.0,
                                            representative_mm_bound=-1.0),
            penalty_gap_open=-2.0, penalty_gap_extend=-1.0, chunk_size=1,
            gap_dist_ends=0, stack_limit_abort=False, max_num_gaps_open=2,
        )
    dm = models.VindijaPwm()
    repr_mm = dm.get_representative_mismatch_penalty()
    return AlignmentParameters(
        difference_model=dm,
        mismatch_bound=models.Discrete(0.01, 0.02, repr_mm),
        penalty_gap_open=np.float32(3.0) * repr_mm,
        penalty_gap_extend=np.float32(0.6) * repr_mm, chunk_size=1,
        gap_dist_ends=5, stack_limit_abort=False, max_num_gaps_open=2,
    )


@pytest.mark.parametrize("model", ["test", "vindija"])
@pytest.mark.parametrize("gens", [1, 3])
@pytest.mark.parametrize("big", [False, True])
def test_pool_search_bidirectional_kernel(fmd, cuda, model, gens, big):
    """K2 in its bidirectional form (center-start models), alone and with
    store boundaries."""
    cfg_kw = dict(lanes=8, total_steps=3072, read_step_cap=512,
                  max_chains=512, compute_forward_part=True)
    if gens > 1:
        cfg_kw.update(total_steps=320, read_step_cap=256, generations=gens,
                      min_live=1)
    eng, cfg, prep = _prepped(fmd, cuda, cfg_kw, 17, big=big,
                              qual=0 if model == "test" else 40,
                              params=_center_params(model))
    assert not cfg.backward_only
    got, want, fired = _pool_both(eng, cfg, prep, cuda)
    _equal(tuple(got), tuple(want), (model, gens))
    n = min(int(got.n_chains), cfg.max_chains)
    assert int((~got.c_abandon[:n]).sum()) > 8
    assert fired > 0 or gens == 1


@pytest.mark.parametrize("big,qual", [(False, 40), (True, 40), (True, 100)])
def test_engine_on_the_card_equals_plain(fmd, cuda, big, qual, monkeypatch):
    """The whole device path (upload, K4 or K6 + K7, K2+K3, K5, the pinned
    copy on the side stream) against the same engine on the CPU's plain
    versions, over several streamed blocks; with `big`, the deep tier runs
    (a starved per-read cap), and past the LUT's quality ceiling the dense
    arrays go up as they are."""
    from concurrent.futures import Future

    from mapad_tpu_torch.ops.engine import DeviceSearchEngine
    from mapad_tpu_torch.ops.search_pool import PoolConfig
    from torch_port_helpers import packed_equal

    for name in ("MAPAD_DEEP_TIER", "MAPAD_HOST_BID", "MAPAD_RETRY_TIER"):
        monkeypatch.delenv(name, raising=False)
    if big:
        monkeypatch.setenv("MAPAD_DEEP_NOHIT_HOST", "0")
        # the narrow deep config: 4 lanes x 4096 steps, 4 store generations
        monkeypatch.setenv("MAPAD_DEEP_LANES", "4")
        monkeypatch.setenv("MAPAD_KGENS_MIN_LIVE", "1")
    cfg = PoolConfig(lanes=16, total_steps=1024,
                     read_step_cap=48 if big else 256, max_chains=256)
    reads = records("mapad_tpu_torch", bench_reads(seed=4, n_random=60),
                    qual)
    outs = []
    for dev in (cuda, "cpu"):
        eng = DeviceSearchEngine(fmd, adna_params("mapad_tpu_torch"),
                                 pool_config=cfg, packed_hits=True,
                                 device=dev, big=big)
        eng.block_reads = 32
        res = eng.search_chunk(reads, lazy_fallback=True)
        outs.append(({i for i, r in enumerate(res) if isinstance(r, Future)},
                     [(r.result() if isinstance(r, Future) else r)[0]
                      for r in res], eng._stats["esc_why"],
                     eng._stats.get("deep_retried", 0)))
    (esc_g, hits_g, why_g, deep_g), (esc_c, hits_c, why_c, deep_c) = outs
    assert esc_g == esc_c and why_g == why_c and deep_g == deep_c
    assert all(packed_equal(a, b) for a, b in zip(hits_g, hits_c))
    if big:
        assert deep_g > 0


# (reads, their reference, params, config fields) of the K10 checks; each
# batch also holds an empty read (a lane with n = 0)
def _batch_case(name):
    from torch_port_helpers import repeat_ref, vindija_params

    ref = bench_ref()
    reads = bench_reads(seed=8, n_random=20)[:24]
    if name == "backward":
        return ref, reads, adna_params, dict(max_steps=512)
    if name == "center":
        return ref, reads, vindija_params, dict(max_steps=512,
                                                compute_forward_part=True)
    if name == "budget":
        return ref, reads, adna_params, dict(max_steps=32)
    assert name == "hit_cap"
    # a read of the segment completes seven times
    rref, seg = repeat_ref()
    return rref, [seg, seg[5:55], seg[:50]] * 4, adna_params, \
        dict(max_steps=512, hit_cap=4)


@pytest.mark.parametrize("name", ["backward", "center", "budget",
                                  "hit_cap"])
def test_search_batch_kernel(cuda, name):
    """K7 + K10 against their plain versions on the same card inputs: both
    extension directions (a center-start model), a budget that leaves
    lanes live (S=32), a hit cap below a read's completions (H=4), and an
    empty lane in every batch."""
    from mapad_tpu_torch.index.builder import build_auxiliary_structures
    from mapad_tpu_torch.ops.engine import DeviceSearchEngine
    from mapad_tpu_torch.ops.search import (
        k_mismatch_search_batch,
        k_mismatch_search_batch_plain,
    )

    ref, reads, params_of, cfg_kw = _batch_case(name)
    fmd = build_auxiliary_structures(ref, b"ACGT")[0]
    L = len(reads) + 1
    eng = DeviceSearchEngine(fmd, params_of("mapad_tpu_torch"), lanes=L,
                             mode="batch", device=cuda)
    cfg = eng.config._replace(**cfg_kw)
    with torch.cuda.device(cuda):
        prep = eng._prepare(records("mapad_tpu_torch", [b""] + reads), 128,
                            L, host_bid=False, dense=True)
        args = [prep["dense"][k] for k in (
            "pattern_rank", "pattern_code", "n", "score_lut", "pen", "split",
            "scale", "thresh", "repr_mm")]
        got = k_mismatch_search_batch(eng.device_index, *args,
                                      eng._params(), cfg)
        want = k_mismatch_search_batch_plain(eng.device_index, *args,
                                             eng._params(), cfg)
        torch.cuda.synchronize()
    _equal(tuple(got), tuple(want), name)
    hc = got.hcount.cpu()
    assert int(hc[0]) == 0 and not bool(got.escalate[0])
    assert int((hc > 0).sum()) > 4 or name == "budget"
    if name == "budget":
        assert int(got.steps) == 32 and bool(got.escalate.any())
    if name == "hit_cap":
        assert int(hc.max()) > 4


@pytest.mark.parametrize("packed", [False, True])
def test_batch_engine_on_the_card_equals_plain(fmd, cuda, packed):
    """The batch engine (two tiers, escalatees of the last to the host) on
    the card against the same engine on the CPU's plain versions."""
    from mapad_tpu_torch.ops.engine import DeviceSearchEngine
    from torch_port_helpers import hits_equal, packed_equal

    ref = bench_ref()
    reads = records("mapad_tpu_torch",
                    bench_reads(seed=12, n_random=40,
                                extra=[b"", ref[500:700]]))
    outs = []
    for dev in (cuda, "cpu"):
        eng = DeviceSearchEngine(fmd, adna_params("mapad_tpu_torch"),
                                 lanes=16, mode="batch",
                                 tiers=((64, None), (2048, 8)),
                                 packed_hits=packed, device=dev)
        res = eng.search_chunk(reads)
        outs.append(([r[0] for r in res],
                     {k: eng._stats[k] for k in ("device_lanes", "escalated",
                                                 "batches", "oracle",
                                                 "steps")}))
    (hits_g, st_g), (hits_c, st_c) = outs
    assert st_g == st_c and st_g["escalated"] > 0
    same = packed_equal if packed else hits_equal
    assert all(same(a, b) for a, b in zip(hits_g, hits_c))


def test_profile_trace_shows_the_kernels(cuda, tmp_path, monkeypatch):
    """`map --profile` on the card records the ctypes-launched kernels."""
    import json

    from mapad_tpu_torch.cli import main

    ref = bench_ref()
    fa = tmp_path / "g.fa"
    fa.write_text(">g\n" + ref.decode() + "\n")
    fq = tmp_path / "r.fq"
    fq.write_text("".join(
        f"@r{i}\n{s.decode()}\n+\n{'I' * len(s)}\n"
        for i, s in enumerate(bench_reads(seed=2, n_random=20))
    ))
    monkeypatch.setenv("MAPAD_POOL_STEPS", "1024")
    assert main(["index", "-g", str(fa)]) == 0
    assert main(["map", "-r", str(fq), "-g", str(fa), "-o",
                 str(tmp_path / "o.bam"), "-p", "0.03", "-l",
                 "single_stranded", "-f", "0.6", "-t", "0.55", "-d", "0.01",
                 "-s", "1.0", "-i", "0.001", "--profile",
                 str(tmp_path / "trace")]) == 0
    events = json.load(open(tmp_path / "trace" / "trace.json"))
    names = {e.get("name", "") for e in events.get("traceEvents", [])}
    for kernel in ("pool_lane_kernel", "pool_refill_kernel",
                   "unpack_prep_kernel", "pack_result_kernel"):
        assert any(kernel in n for n in names), kernel


# --- K9: the pool search over several shards ------------------------------


def test_shard_rebase_kernel(cuda):
    from mapad_tpu_torch.ops.search_pool import PoolResult
    from mapad_tpu_torch.parallel import pool_sharded as tps

    g = torch.Generator().manual_seed(3)
    for C, L, base, r_local in ((16384, 512, 8192, 8192), (37, 5, 0, 9)):
        c_read = torch.randint(-1, r_local, (C,), generator=g,
                               dtype=torch.int32)
        lane_read = torch.randint(0, r_local + 1, (L,), generator=g,
                                  dtype=torch.int32)
        outs = []
        for rebase, dev in ((tps.shard_rebase, cuda),
                            (tps._shard_rebase_plain, cuda)):
            res = PoolResult(*[None] * len(PoolResult._fields))._replace(
                c_read=c_read.to(dev), lane_read=lane_read.to(dev),
                next_read=torch.tensor(r_local // 2, dtype=torch.int32,
                                       device=dev))
            outs.append(rebase(res, base, r_local, base + 2 * r_local))
        torch.cuda.synchronize()
        got, want = outs
        _equal((got.c_read, got.lane_read, got.next_read),
               (want.c_read, want.lane_read, want.next_read), "shard_rebase")
        assert int(got.next_read) == r_local // 2 + base


def _sharded_prep(eng, cfg, prep, dev):
    """One engine prep uploaded to `dev` and unpacked -> the prep dict of
    `pool_search_sharded` (the packed rows, or the dense arrays)."""
    from mapad_tpu_torch.parallel import pool_sharded as tps

    with torch.cuda.device(dev):
        consts, kw = eng._upload(prep, dev)
    out = dict(zip(tps.CONST_KEYS, consts))
    if "slut" in kw:
        out["slut_packed"] = kw["slut"]
    else:
        out.update(zip(tps.DENSE_KEYS, kw["dense"]))
    return out


def _k9_both(fmd, mesh, big, monkeypatch):
    from mapad_tpu_torch._build import LAUNCHES
    from mapad_tpu_torch.parallel import pool_sharded as tps
    from mapad_tpu_torch.parallel import sharding as tsh

    eng, cfg, prep = _prepped(fmd, mesh[0], CASES["bench"], seed=5, big=big,
                              R=48)
    cfg = cfg._replace(track_read_steps=True)
    p = _sharded_prep(eng, cfg, prep, mesh[0])
    indexes = tsh.replicate(mesh, eng.device_index)
    LAUNCHES.reset()
    got = tps.pool_search_sharded(mesh, indexes, p, eng._params(), cfg)
    torch.cuda.synchronize()
    assert LAUNCHES.get("shard_rebase") == len(mesh)
    want = tps.pool_search_sharded_plain(mesh, indexes, p, eng._params(),
                                         cfg)
    torch.cuda.synchronize()
    _equal(tuple(got), tuple(want), "pool_search_sharded")
    assert got.c_read.shape[0] == len(mesh)
    assert (got.steps > 0).all()


@pytest.mark.parametrize("D", [2, 4])
@pytest.mark.parametrize("big", [False, True])
def test_pool_search_sharded_kernel(fmd, cuda, D, big, monkeypatch):
    """K9 with D shards on one card (one host thread and stream each)
    against the plain per-shard loops, int32 (packed rows) and int64
    (dense inputs, each shard's own Bi-D)."""
    _k9_both(fmd, [torch.device("cuda", torch.cuda.current_device())] * D,
             big, monkeypatch)


def _sharded_engine_run(fmd, dev, mesh, monkeypatch, shard="1"):
    from concurrent.futures import Future

    from mapad_tpu_torch.ops.engine import DeviceSearchEngine
    from mapad_tpu_torch.ops.search_pool import PoolConfig

    if shard is None:
        monkeypatch.delenv("MAPAD_SHARD")
    else:
        monkeypatch.setenv("MAPAD_SHARD", shard)
    monkeypatch.setenv("MAPAD_BLOCK_READS", "32")
    eng = DeviceSearchEngine(
        fmd, adna_params("mapad_tpu_torch"), packed_hits=True, device=dev,
        mesh=mesh, pool_config=PoolConfig(lanes=8, total_steps=1024,
                                          read_step_cap=256,
                                          max_chains=256, generations=2))
    res = eng.search_chunk(records("mapad_tpu_torch",
                                   bench_reads(seed=4, n_random=60)),
                           lazy_fallback=True)
    return (eng, {i for i, r in enumerate(res) if isinstance(r, Future)},
            [(r.result() if isinstance(r, Future) else r)[0] for r in res])


def test_sharded_engine_on_the_card_equals_cpu(fmd, cuda, monkeypatch):
    """The mesh path of the engine (each shard's upload, K4, K2 + K3, the
    rebase, K5 and copy on its own thread and streams) with two shards on
    one card against the same mesh on the CPU's plain versions."""
    from mapad_tpu_torch._build import LAUNCHES
    from torch_port_helpers import packed_equal

    card = torch.device("cuda", torch.cuda.current_device())
    LAUNCHES.reset()
    eng_g, esc_g, hits_g = _sharded_engine_run(fmd, card, [card] * 2,
                                               monkeypatch)
    assert LAUNCHES.get("shard_rebase") == 2 * eng_g._stats["batches"]
    eng_c, esc_c, hits_c = _sharded_engine_run(
        fmd, "cpu", [torch.device("cpu")] * 2, monkeypatch)
    assert eng_g.n_shards == eng_c.n_shards == 2
    assert esc_g == esc_c
    assert eng_g._stats["shard_steps"] == eng_c._stats["shard_steps"]
    assert all(packed_equal(a, b) for a, b in zip(hits_g, hits_c))


def test_pool_search_sharded_over_distinct_cards(fmd, cuda, monkeypatch):
    """Where the machine has several cards: K9 over all of them (an index
    replica on each, each shard's launches on its own card) against its
    plain version, and the engine's automatic mesh (MAPAD_SHARD unset)
    against the same mesh on the CPU."""
    from mapad_tpu_torch.parallel import sharding as tsh
    from torch_port_helpers import packed_equal

    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip("needs more than one card")
    mesh = tsh.make_mesh()
    for big in (False, True):
        _k9_both(fmd, mesh, big, monkeypatch)
    eng_g, esc_g, hits_g = _sharded_engine_run(fmd, None, None, monkeypatch,
                                               shard=None)
    assert eng_g.mesh == mesh
    eng_c, esc_c, hits_c = _sharded_engine_run(
        fmd, "cpu", [torch.device("cpu")] * n, monkeypatch)
    assert esc_g == esc_c
    assert eng_g._stats["shard_steps"] == eng_c._stats["shard_steps"]
    assert all(packed_equal(a, b) for a, b in zip(hits_g, hits_c))


# --- the ports of the TPU's DMA probes (P1-P4, mapad_tpu_torch/tools/) ------


@pytest.fixture(scope="module")
def probe_cuda():
    """The card with only the probe kernels built (they are on no mapping
    path)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernels have no CPU mode)")
    from mapad_tpu_torch import _build

    if _build.nvcc_path() is None:
        pytest.skip("needs nvcc to build the kernels")
    _build.build_cuda(_build.PROBE_SOURCES)
    return torch.device("cuda")


def _gather_equal(got, want, what):
    assert torch.equal(got[0].view(torch.int32), want[0].view(torch.int32)), \
        (what, float(got[0]), float(want[0]))
    assert torch.equal(got[1], want[1]), (what, "chk")


@pytest.mark.parametrize("nb,lanes,width,steps,lo,hi", [
    (8197, 1024, 128, 40, 0, 100),         # path 1's index rows: in L2
    (300_000, 1024, 128, 20, 0, 100),      # 153 MB: above the 50 MB L2
    (4096, 1001, 128, 12, 0, 100),         # L not a multiple of 8 lanes
    (4096, 5, 128, 12, 0, 100),            # fewer lanes than one block's warps
    (4096, 1024, 128, 12, 0, 16_000),      # acc passes 2^24 and rounds
    (4096, 777, 128, 16, -16_000, 16_000), # negative acc
    (4096, 200, 32, 8, 0, 1000),           # 128-byte rows
    (4096, 200, 33, 8, 0, 1000),           # rows not 16-byte aligned
    (4096, 64, 2048, 4, 0, 1000),          # 8 KB rows: a block's lanes fit
])
def test_gather_steps_kernel(probe_cuda, nb, lanes, width, steps, lo, hi):
    """P1 on the card against its plain version on the same inputs."""
    from mapad_tpu_torch.tools import dma

    rng = np.random.default_rng(nb + lanes + width)
    rows = torch.from_numpy(rng.integers(lo, hi, size=(nb, width),
                                         dtype=np.int32)).to(probe_cuda)
    blk = torch.from_numpy(rng.integers(0, nb, size=lanes,
                                        dtype=np.int32)).to(probe_cuda)
    got = dma.gather_steps(rows, blk, steps)
    want = dma.gather_steps_plain(rows, blk, steps)
    torch.cuda.synchronize()
    _gather_equal(got, want, "gather_steps")
    if hi == 16_000 and lo == 0:
        assert float(got[0]) > 2**24


def test_gather_steps_launch_per_step_equals_one_launch(probe_cuda):
    """T launches of one step (from Python, and queued from the library's
    host loop) equal one launch of T steps and the plain version."""
    from mapad_tpu_torch.tools import bench_dma, dma

    rows, blk = bench_dma.make_inputs(8197, 128, 1024, seed=3,
                                      device=probe_cuda)
    T = 24
    one = dma.gather_steps(rows, blk, T)
    queued = dma.gather_steps(rows, blk, T, launch_per_step=True)
    acc = chk = None
    for t in range(T):
        acc, chk = dma.gather_steps(rows, blk, 1, t0=t, acc=acc, chk=chk)
    want = dma.gather_steps_plain(rows, blk, T)
    torch.cuda.synchronize()
    for what, got in (("one launch", one), ("queued", queued),
                      ("python loop", (acc, chk))):
        _gather_equal(got, want, what)
    assert float(bench_dma.library_steps(rows, blk, T)[0]) == float(want[0])


@pytest.mark.parametrize("shape,row0,nrows,col0,ncols", [
    ((1024, 32), 7, 1, 0, 32),          # P3: 128-byte rows
    ((64, 128), 6, 2, 0, 128),
    ((64, 384), 3, 1, 0, 384),
    ((64, 2, 128), 3, 1, 0, 256),       # a 3-D array viewed (R, 256)
    ((64, 8, 128), 3, 5, 0, 1024),
    ((64, 256), 3, 1, 0, 128),          # the strided 2-minor slice
    ((64, 256), 3, 4, 128, 128),
    ((64, 130), 1, 9, 3, 101),          # nothing 16-byte aligned
    ((300, 128), 20, 250, 0, 128),      # more rows than one block stages
])
def test_copy_src_slice_kernel(probe_cuda, shape, row0, nrows, col0, ncols):
    from mapad_tpu_torch.tools import dma

    x = torch.randint(-2**31, 2**31 - 1, shape, dtype=torch.int32,
                      device=probe_cuda)
    got = dma.copy_src_slice(x, row0, nrows, col0, ncols)
    want = dma.copy_src_slice_plain(x, row0, nrows, col0, ncols)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    m = x.reshape(shape[0], -1)
    assert torch.equal(got, m[row0:row0 + nrows, col0:col0 + ncols])


@pytest.mark.parametrize("shape,row0,col0,blk,addend", [
    ((1024, 128), 100, 0, (72, 128), 0),       # P2's destination
    ((8, 128), 3, 0, (1, 128), 1),             # P4's k_dst
    ((64, 8, 128), 10, 0, (2, 8, 128), 0),     # a 3-D destination
    ((64, 256), 5, 128, (3, 128), 7),
    ((64, 130), 2, 3, (9, 101), -5),           # nothing 16-byte aligned
    ((400, 128), 30, 0, (300, 128), 2**31 - 1),  # several blocks; wraps
])
def test_copy_dst_slice_leaves_the_rest_untouched(probe_cuda, shape, row0,
                                                  col0, blk, addend):
    from mapad_tpu_torch.tools import dma

    g = torch.Generator(device=probe_cuda)
    g.manual_seed(row0)
    inp = torch.randint(-2**31, 2**31 - 1, blk, dtype=torch.int32,
                        device=probe_cuda, generator=g)
    before = torch.randint(-2**31, 2**31 - 1, shape, dtype=torch.int32,
                           device=probe_cuda, generator=g)
    got = dma.copy_dst_slice(inp, before.clone(), row0, col0, addend)
    want = dma.copy_dst_slice_plain(inp, before.clone(), row0, col0, addend)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    m, b = got.reshape(shape[0], -1), before.reshape(shape[0], -1)
    src = inp.reshape(blk[0], -1)
    r1, c1 = row0 + src.shape[0], col0 + src.shape[1]
    assert torch.equal(m[row0:r1, col0:c1], src + addend)
    keep = torch.ones_like(m, dtype=torch.bool)
    keep[row0:r1, col0:c1] = False
    assert torch.equal(m[keep], b[keep])


def test_probe_tools_on_the_card(probe_cuda, tmp_path):
    """The four tools' checks on the card, P4's PTX/SASS dump, and P1's
    three forms agreeing at a small size."""
    from mapad_tpu_torch.tools import _dump_pair, _probe_shapes, _t9, bench_dma

    assert all(ok for _name, ok in _probe_shapes.check()), \
        _probe_shapes.check()
    assert torch.equal(*_t9.run())
    for what, got, want in _dump_pair.run_pair():
        assert torch.equal(got, want), what
    counts = _dump_pair.dump(str(tmp_path))
    for kernel in _dump_pair.KERNELS:
        for ext in ("ptx", "sass"):
            text = (tmp_path / f"{kernel}.{ext}").read_text()
            assert f"{kernel}_kernel" in text, (kernel, ext)
        assert min(counts[kernel]) > 0, counts
    rows, blk = bench_dma.make_inputs(4096, 128, 256, device=probe_cuda)
    us = bench_dma.measure(rows, blk, 10, rounds=1)
    assert set(us) == set(bench_dma.FORMS) and min(us.values()) > 0
