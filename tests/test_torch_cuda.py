"""The hand-written CUDA kernels against their plain PyTorch versions, on
the card, at small shapes that reach the edge cases (abandon markers, chain
log overflow, an exhausted step budget, the RLE and raw Bi-D blobs, store
boundaries with and without overlap of the moved window, the bidirectional
search, K3's one launch at its edges on synthetic loop states, K6 with
blob words that hold two reads' cells), with int32 intervals and with the
int64 intervals of big mode;
the fixed-batch search (K10) and its engine; and the pool search over
several shards (K9 and its `shard_rebase`), on one card and, where the
machine has them, over distinct cards; and the ports of the TPU's DMA
probes (P1 `gather_steps`, P2-P4 `copy_src_slice` / `copy_dst_slice`) at
their edge cases, with the probe tools themselves; and the reference's
knobs: K2 with a fixed step count in its four forms, MAPAD_DEV_LUT=0 with
no K4 or K6 launch, `occ4_batch`.  Engines run on one card unless a
test asks for a mesh (MAPAD_SHARD=0 by default here).

Needs an NVIDIA GPU with nvcc; skips elsewhere.  On the card:

    python -m pytest --noconftest -m gpu tests/test_torch_cuda.py
"""

import ctypes

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


def _bid_block(L, M, longest, seed, full=0):
    """Reads cut from the bench reference with a few invalid symbols, an
    empty read, a read of `longest` with no forward part, one with no
    backward part and `full` reads of length M."""
    ref = bench_ref()
    rng = np.random.default_rng(seed)
    n = rng.integers(0, longest + 1, size=L).astype(np.int32)
    n[0] = 0 if L > 1 else longest
    n[min(1, L - 1)] = longest
    n[L - full:] = M if full else n[L - full:]
    split = (n * rng.uniform(0.3, 1, size=L)).astype(np.int32)
    split[min(1, L - 1)] = n[min(1, L - 1)]
    if L > 2:
        split[2] = 0
    rank = np.zeros((L, M), np.int32)
    pen = np.zeros((L, M), np.float32)
    for i in range(L):
        st = int(rng.integers(0, len(ref) - M))
        rank[i, : n[i]] = [b"ACGT".index(c) + 1
                           for c in ref[st : st + n[i]]]
        for _ in range(3):
            if n[i]:
                rank[i, rng.integers(0, n[i])] = rng.integers(-1, 7)
        pen[i, : n[i]] = -rng.uniform(0.1, 5, size=n[i]).astype(np.float32)
    return rank, pen, n, split


@pytest.mark.parametrize("big", [False, True])
@pytest.mark.parametrize("forward_part", [False, True])
@pytest.mark.parametrize("L,M,longest,full", [
    (1, 128, 128, 1),     # one read of length M: a block of 15 or 16 warps
    (70, 112, 100, 0),    # a read a block
    (800, 128, 120, 20),  # above one wave of blocks, reads of length M
    (4096, 128, 120, 0),  # path 2's block size
])
def test_bi_d_kernel_at_the_plans_edges(fmd, cuda, big, forward_part, L, M,
                                        longest, full):
    """K7 against its plain version under each plan `bid_card_plan`
    makes: a read a block of 15 walks (backward only) or 30 on 16 warps,
    45 warps or more resident on an SM."""
    from mapad_tpu_torch.ops import bi_d, fm

    idx = fm.DeviceFmIndex.from_host(fmd, big=big, device=cuda)
    rank, pen, n, split = _bid_block(L, M, longest, L + M, full)
    t = [torch.from_numpy(a).to(cuda) for a in (rank, pen, n, split)]
    steps = (int(split.max()), int((n - split).max()))
    got = bi_d.compute_bi_d(idx, *t, forward_part, steps)
    want = bi_d.compute_bi_d_plain(idx, *t, forward_part, steps)
    _equal((got,), (want,), ("bi_d", L, M))
    plan = bi_d.bid_card_plan(t[0].device, M, 2 if forward_part else 1,
                              big)
    assert plan.warps == (16 if forward_part else 15)
    assert plan.smem == bi_d.bid_smem(M, 2 if forward_part else 1)
    assert plan.resident_warps >= 45, plan


def test_bi_d_kernel_on_a_one_row_index(cuda):
    """An index of one row (a 420 bp genome): every interval lies in one
    row, so K1 takes its one-row path with ranges up to the whole row."""
    from mapad_tpu_torch.index.builder import build_auxiliary_structures
    from mapad_tpu_torch.ops import bi_d, fm

    rng = np.random.default_rng(5)
    genome = bytes(rng.choice(np.frombuffer(b"ACGT", np.uint8), size=420))
    tiny = build_auxiliary_structures(genome, b"ACGT")[0]
    for big in (False, True):
        idx = fm.DeviceFmIndex.from_host(tiny, big=big, device=cuda)
        assert idx.rows.shape[0] == 1
        L, M = 40, 128
        rank = np.zeros((L, M), np.int32)
        pen = -rng.uniform(0.1, 5, size=(L, M)).astype(np.float32)
        n = rng.integers(20, M + 1, size=L).astype(np.int32)
        split = (n * rng.uniform(0, 1, size=L)).astype(np.int32)
        for i in range(L):
            st = int(rng.integers(0, len(genome) - M))
            rank[i, : n[i]] = [b"ACGT".index(c) + 1
                               for c in genome[st : st + n[i]]]
            rank[i, rng.integers(0, n[i])] = rng.integers(1, 5)
        t = [torch.from_numpy(a).to(cuda) for a in (rank, pen, n, split)]
        steps = (int(split.max()), int((n - split).max()))
        for fwd in (False, True):
            got = bi_d.compute_bi_d(idx, *t, fwd, steps)
            want = bi_d.compute_bi_d_plain(idx, *t, fwd, steps)
            _equal((got,), (want,), ("bi_d one row", big, fwd))


@pytest.mark.parametrize("forward_part", [False, True])
def test_bi_d_kernel_with_counts_above_2_32(fmd, cuda, forward_part):
    """Big mode with the checkpoints and `less` shifted past 2^32, as K1's
    test does: intervals above 2^32, row numbers past the index (clamped)
    through the kernel's multiply-high division."""
    from mapad_tpu_torch.ops import bi_d, fm

    idx = fm.DeviceFmIndex.from_host(fmd, big=True, device=cuda)
    rows = idx.rows.clone()
    cp = ((rows[:, 0:6].long() & 0xFFFFFFFF)
          | (rows[:, 6:12].long() << 32)) + ((3 << 32) + 12345)
    rows[:, 0:6] = (cp & 0xFFFFFFFF).to(torch.int32)
    rows[:, 6:12] = (cp >> 32).to(torch.int32)
    shifted = idx._replace(rows=rows, less=idx.less + ((5 << 32) + 999))
    rank, pen, n, split = _bid_block(96, 128, 110, 5, 4)
    t = [torch.from_numpy(a).to(cuda) for a in (rank, pen, n, split)]
    steps = (int(split.max()), int((n - split).max()))
    got = bi_d.compute_bi_d(shifted, *t, forward_part, steps)
    want = bi_d.compute_bi_d_plain(shifted, *t, forward_part, steps)
    _equal((got,), (want,), "bi_d above 2^32")
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


def _random_result(buf, cfg, R, big, seed):
    """Random words in every PoolResult field of K3's allocation (0/1 in
    the bools, op words with pos < MW)."""
    from mapad_tpu_torch.ops import search_pool2 as sp2

    rng = np.random.default_rng(seed)
    res = sp2._pool_result(buf, cfg, R, big)
    for f in res:
        if f.dtype == torch.bool:
            v = rng.integers(0, 2, f.shape).astype(bool)
        elif f.dtype == torch.float32:
            v = rng.standard_normal(f.shape).astype(np.float32)
        elif f.dtype == torch.int64:
            v = rng.integers(-2**40, 2**40, f.shape)
        else:
            v = rng.integers(-2**31, 2**31 - 1, f.shape).astype(np.int32)
        f.copy_(torch.from_numpy(np.asarray(v)).to(f.device))
    C, MW = res.c_ops.shape
    ops = (rng.integers(0, 4, (C, MW)) | rng.integers(0, MW, (C, MW)) << 2
           | rng.integers(0, 4, (C, MW)) << 17
           | rng.integers(0, 2, (C, MW)) << 20
           | rng.integers(0, 8, (C, MW)) << 21)
    res.c_ops.copy_(torch.from_numpy(ops.astype(np.int32)))
    return res


# (L, C, max_len, R) of K5's checks: pool_check's shape (MW = 144, K = 4),
# MW = 37 with C % 4 != 0 (the ragged last tile by cp.async), MW = 128
# (K = 5) with C % 4 == 3, one of each
PACK_EDGES = [(512, 16384, 128, 1024), (8, 33, 21, 41), (13, 1023, 112, 7),
              (4, 64, 128, 9), (1, 1, 1, 1)]


@pytest.mark.parametrize("entry", ["buffer", "result", "apart"])
@pytest.mark.parametrize("big", [False, True])
@pytest.mark.parametrize("shape", PACK_EDGES, ids=str)
def test_pack_result_kernel_at_its_edges(cuda, shape, big, entry):
    """K5 in one launch against its plain version: on K3's allocation
    through `_pack_buffer`, on the PoolResult views of it, and on fields
    apart, each at a 4-byte but not 16-byte phase and without
    read_steps."""
    from mapad_tpu_torch._build import LAUNCHES
    from mapad_tpu_torch.ops import engine as teng
    from mapad_tpu_torch.ops import search_pool2 as sp2
    from mapad_tpu_torch.ops.search_pool import PoolConfig, PoolResult

    L, C, max_len, R = shape
    cfg = PoolConfig(max_len=max_len, lanes=L, total_steps=64,
                     read_step_cap=60, max_chains=C)
    buf = sp2._alloc_result(cfg, R, big, cuda)
    res = _random_result(buf, cfg, R, big, seed=C + L + big)
    if entry == "apart":
        rng = np.random.default_rng(C)
        parts = []
        for f in res[:13]:
            n = f.numel() * f.element_size()
            at = max(4, f.element_size()) * int(rng.integers(1, 4))
            raw = torch.zeros(n + 32, dtype=torch.uint8, device=cuda)
            v = raw[at : at + n].view(f.dtype).view(f.shape)
            v.copy_(f)
            parts.append(v)
        res = PoolResult(*parts, None)
    want = teng._pack_result_plain(PoolResult(*[
        None if f is None else f.cpu() for f in res]))
    LAUNCHES.reset()
    got = (teng._pack_buffer(buf, cfg, R, big) if entry == "buffer"
           else teng._pack_result(res))
    torch.cuda.synchronize()
    assert LAUNCHES.get("pack_result_i64" if big else "pack_result") == 1
    _equal((got.cpu(),), (want,), f"pack_result {entry}")


# (R, M) of K4's checks: path 1's block width at an odd R, M past 128,
# blocks whose first cell is odd (M = 35, 37), one read
UNPACK_EDGES = [(8191, 128), (61, 35), (21, 100), (13, 255), (100, 37),
                (1, 16)]


@pytest.mark.parametrize("rle", [True, False])
@pytest.mark.parametrize("shape", UNPACK_EDGES, ids=str)
def test_unpack_prep_kernel_at_its_edges(fmd, cuda, shape, rle):
    """K4 against its plain version on a random blob (any break bytes,
    sorted or not; every class and quality; lengths 0 to M) at each 4-byte
    phase of a 16-byte line."""
    from mapad_tpu_torch._build import LAUNCHES
    from mapad_tpu_torch.ops import engine as teng
    from mapad_tpu_torch.ops import prep as tprep

    R, M = shape
    p = adna_params("mapad_tpu_torch")
    tab, _pen, off = tprep._build_all_lut(p.difference_model, p, M)
    rng = np.random.default_rng(R * M + rle)
    cells = (rng.integers(0, 5, R * M) << 7) | rng.integers(0, 128, R * M)
    cells = np.concatenate([cells, np.zeros((-len(cells)) % 3, np.int64)])
    words = (cells[0::3] | (cells[1::3] << 10) | (cells[2::3] << 20))
    parts = [rng.integers(0, M + 1, R), rng.integers(0, M + 1, R),
             rng.standard_normal(3 * R).astype(np.float32).view(np.int32)]
    if rle:
        br = rng.integers(0, 256, (R, 32)).astype(np.uint8)
        br[: R // 2].sort(axis=1)
        parts += [br.reshape(-1).view(np.int32),
                  rng.standard_normal(32 * R).astype(np.float32).view(
                      np.int32)]
    else:
        parts.append(rng.standard_normal(R * M).astype(np.float32).view(
            np.int32))
    blob = np.concatenate(parts + [words]).astype(np.int32)
    want = teng._unpack_prep_lut_plain(
        torch.from_numpy(blob), torch.from_numpy(tab), torch.from_numpy(off),
        R, M, tprep._DEV_LUT_Q, rle)
    tab_d, off_d = torch.from_numpy(tab).to(cuda), torch.from_numpy(off).to(
        cuda)
    for phase in range(4):
        raw = torch.zeros(blob.size + 4, dtype=torch.int32, device=cuda)
        b = raw[phase : phase + blob.size]
        b.copy_(torch.from_numpy(blob))
        LAUNCHES.reset()
        got = teng._unpack_prep_lut(b, tab_d, off_d, R, M, tprep._DEV_LUT_Q,
                                    rle)
        torch.cuda.synchronize()
        assert LAUNCHES.get("unpack_prep") == 1
        _equal(tuple(g.cpu() for g in got), want, f"unpack_prep {phase}")


@pytest.mark.parametrize("big", [False, True])
def test_run_block_packs_without_views(fmd, cuda, big, monkeypatch):
    """The engine's path (`_run_block`, unsharded) packs K3's allocation as
    it is: with `_pool_result` made to raise, its wire words equal
    `_pack_result_plain` of the same invocation."""
    from mapad_tpu_torch.ops import engine as teng
    from mapad_tpu_torch.ops import search_pool2 as sp2

    eng, cfg, prep = _prepped(fmd, cuda, CASES["bench"], seed=9, big=big)
    with torch.cuda.device(cuda):
        consts, kw = eng._upload(dict(prep))
        res = sp2.k_mismatch_search_pool2(eng.device_index, *consts,
                                          eng._params(), cfg, **kw)
        want = teng._pack_result_plain(res).cpu()

    def no_views(*a, **k):
        raise AssertionError("the engine's path made PoolResult views")

    monkeypatch.setattr(sp2, "_pool_result", no_views)
    monkeypatch.setattr(teng, "_pool_result", no_views)
    spec, host, done = eng._run_block(cfg, dict(prep), eng._params())
    done.synchronize()
    assert torch.equal(host, want)
    for name, g, w in zip(res._fields, spec, teng._result_spec(res)):
        assert g.shape == w.shape and g.dtype == w.dtype, name


# K2's one launch a generation at the edges of its launch plan (ops/
# search_pool2.py pool_plan): (config, reads, whether the plan keeps the
# key rings in shared memory)
PLAN_CASES = {
    # full width, the primary's ring (RB = 3,073) in shared memory
    "full_width": (dict(lanes=512, total_steps=3200, read_step_cap=3072,
                        max_chains=16384), 640, True),
    # 1,024 lanes: 8 a block
    "L1024": (dict(lanes=1024, total_steps=512, read_step_cap=300,
                   max_chains=4096), 1100, True),
    # one lane, one block of one warp
    "L1": (dict(lanes=1, total_steps=2048, read_step_cap=512,
                max_chains=512), 8, True),
    # lane counts that leave warps of the last block, or SMs, empty
    "L40": (dict(lanes=40, total_steps=1024, read_step_cap=256,
                 max_chains=512), 48, True),
    "L13": (dict(lanes=13, total_steps=1024, read_step_cap=256,
                 max_chains=512), 48, True),
    # a deep ring (RB = 8,192)
    "deep_ring": (dict(lanes=64, total_steps=8192, read_step_cap=8191,
                       max_chains=1024), 96, True),
    # a ring too large for a block's shared memory: the global layout
    "global_ring": (dict(lanes=8, total_steps=60000, read_step_cap=59999,
                         max_chains=512), 24, False),
}


def _plan_reads(n):
    return bench_reads(seed=41, n_random=max(0, n - 10), n_exo=4)[:n]


@pytest.mark.parametrize("case", sorted(PLAN_CASES))
@pytest.mark.parametrize("big", [False, True])
def test_pool_search_launch_plans(fmd, cuda, case, big):
    """K2 in one launch at the plan's edges, bit for bit against the plain
    loop: the plan's ring home as expected, one launch and one K1 count
    for the generation."""
    from mapad_tpu_torch._build import LAUNCHES
    from mapad_tpu_torch.ops import search_pool2 as sp2

    cfg_kw, R, shared = PLAN_CASES[case]
    eng, cfg, prep = _prepped(fmd, cuda, cfg_kw, 0, big=big,
                              reads=_plan_reads(R), R=R)
    RB = min(cfg.total_steps, cfg.read_step_cap + 1)
    plan = sp2.card_plan(cuda, cfg.lanes, RB, big, not cfg.backward_only)
    assert plan.ring_shared == shared, plan
    LAUNCHES.reset()
    got, want, fired = _pool_both(eng, cfg, prep, cuda)
    _equal(tuple(got), tuple(want), case)
    sfx = "_i64" if big else ""
    assert LAUNCHES.get("pool_search" + sfx) == 2 and not fired
    # K1 inline in the one generation (K7's own K1 aside, in big mode)
    assert LAUNCHES.get("extend_batch" + sfx) - LAUNCHES.get(
        "bi_d" + sfx) == 1


@pytest.mark.parametrize("big", [False, True])
def test_pool_search_stops_at_the_step_limit(fmd, cuda, big):
    """A capped spill: the generation after the store boundary stops at
    the step limit K8 set, with lanes live and the store not full."""
    from mapad_tpu_torch._build import LAUNCHES
    from mapad_tpu_torch.ops import search_pool2 as sp2

    cfg_kw = dict(GEN_CASES["spill"][0], generations=2)
    reads = (bench_reads(seed=31, n_random=40, n_exo=0) * 2)[:96]
    eng, cfg, prep = _prepped(fmd, cuda, cfg_kw, 0, big=big, reads=reads,
                              R=96)
    with torch.cuda.device(cuda):
        consts, kw = eng._upload(prep)
        args = (eng.device_index, *consts, eng._params(), cfg, kw["slut"]
                if "slut" in kw else sp2._dense_slut(
                    eng.device_index, kw["dense"], consts[0], consts[1],
                    cfg, kw["bid_steps"]))
        LAUNCHES.reset()
        state = sp2._pool_loop_cuda(*args)
        g = state[3].tolist()
        got = sp2._extract_chains_cuda(*state, cfg)
        want = sp2._extract_chains_plain(*sp2._pool_loop_plain(*args), cfg)
        torch.cuda.synchronize()
    assert g[sp2.G_STEP] == g[sp2.G_LIMIT] < cfg.total_steps, g
    assert not g[sp2.G_DONE] and g[sp2.G_LIVE] > 0, g
    # 1 init + 1 a generation
    assert LAUNCHES.get("pool_search" + ("_i64" if big else "")) == 3
    _equal(tuple(got), tuple(want), "spill stop")


def test_two_pool_searches_on_two_streams_of_one_card(fmd, cuda):
    """Two full-width K2 grids at once on two streams of one card (as two
    shards of a mesh on one card run them) both finish, within a time
    limit, each bit for bit against its plain loop."""
    import threading

    from mapad_tpu_torch.ops import search_pool2 as sp2

    cfg_kw = dict(lanes=512, total_steps=2048, read_step_cap=1024,
                  max_chains=8192)
    runs = []
    for seed in (3, 4):
        eng, cfg, prep = _prepped(fmd, cuda, cfg_kw, seed,
                                  reads=_plan_reads(600)[seed:seed + 560],
                                  R=560)
        with torch.cuda.device(cuda):
            consts, kw = eng._upload(prep)
        runs.append((eng.device_index, *consts, eng._params(), cfg,
                     kw["slut"]))
    out = [None, None]
    start = threading.Barrier(2)

    def shard(i):
        with torch.cuda.device(cuda), torch.cuda.stream(
                torch.cuda.Stream(cuda)):
            start.wait()
            res = sp2._extract_chains_cuda(*sp2._pool_loop_cuda(*runs[i]),
                                           runs[i][7])
            torch.cuda.current_stream().synchronize()
            out[i] = res

    threads = [threading.Thread(target=shard, args=(i,), daemon=True)
               for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads), "a K2 grid hung"
    for i, res in enumerate(out):
        with torch.cuda.device(cuda):
            want = sp2._extract_chains_plain(*sp2._pool_loop_plain(*runs[i]),
                                             runs[i][7])
        _equal(tuple(res), tuple(want), f"stream {i}")


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
    from mapad_tpu_torch._build import LAUNCHES

    LAUNCHES.reset()
    got, want, fired = _pool_both(eng, cfg, prep, cuda)
    _equal(tuple(got), tuple(want), case)
    assert fired >= least and (least or not fired), fired
    if fired:
        assert int(got.steps) > cfg.total_steps
    # K3: one launch at each boundary and one at the end
    assert LAUNCHES.get("extract_chains" + ("_i64" if big else "")) == \
        fired + 1


# K3 at its edges, on synthetic loop states (frames, marks, parents, the
# finish log and the counters drawn from a seed), kernel against the plain
# extraction: the final extraction and the ones at store boundaries (the
# loop counters G_BASE, G_CUM, G_ACC_N, G_ACC_NCH as after earlier
# boundaries, the entries those wrote already in the result).  Masks and
# finish-log words outside the steps an extraction reads hold garbage.
K3_EDGES = {
    "final": dict(L=8, S=130, steps=101, C=64, max_len=48),
    "no_marks": dict(L=8, S=37, steps=30, C=40, max_len=20, no_marks=True),
    "no_marks_full": dict(L=8, S=37, steps=37, C=40, max_len=20,
                          no_marks=True),
    "past_C": dict(L=8, S=130, steps=120, C=24, max_len=48, mark_p=0.2),
    # chains of more than MW - 1 hops: cut at MW words
    "full_MW": dict(L=8, S=203, steps=190, C=100, max_len=20, deep=True,
                    mark_p=0.03),
    # the most lanes, C at the production's 16,384 (a full grid)
    "wide": dict(L=1024, S=45, steps=45, C=16384, max_len=128, deep=True,
                 mark_p=0.04),
    "boundary_first": dict(L=8, S=130, steps=130, C=64, max_len=48,
                           final=False, cum=7),
    "boundary_later": dict(L=8, S=130, steps=130, base=17, C=64, max_len=48,
                           final=False, first=False, cum=33, acc_n=20,
                           acc_nch=50),
    "boundary_past_C": dict(L=40, S=130, steps=130, base=9, C=48, max_len=48,
                            final=False, first=False, cum=3, acc_n=40,
                            acc_nch=45, mark_p=0.1),
    "final_after_boundaries": dict(L=8, S=130, steps=90, base=13, C=64,
                                   max_len=48, first=False, cum=5, acc_n=30,
                                   acc_nch=31),
    "final_log_full": dict(L=8, S=130, steps=90, base=13, C=64, max_len=48,
                           first=False, cum=5, acc_n=70, acc_nch=71),
}


def _k3_state(seed, L, S, steps, C, max_len, big, track, R=40, base=0,
              mark_p=0.05, deep=False, no_marks=False, cum=0, acc_n=0,
              acc_nch=0, final=True, first=True):
    """A synthetic loop state -> (the plain store (L, S+1, 9, NF) in the
    interval type, the card's (L, S+1, 9, NFW) int32 words, the masks,
    the plain and the card's finish log, the lane state, glob)."""
    from mapad_tpu_torch.ops.search import (
        CANDS, F_GAPS, F_LOWER, F_LREV, F_OP, F_PARENT, F_SCOREBITS, F_SIZE,
        F_STARTLEN, NF, OP_COMP_BIT, OP_VALID_BIT)
    from mapad_tpu_torch.ops.search_pool import OP_ABANDON_BIT

    rng = np.random.default_rng(seed)
    ROOT = S * CANDS
    lo, hi = S - steps, S - base
    st = np.zeros((L, S + 1, CANDS, NF), dtype=np.int64)
    shp = (L, steps, CANDS)
    w = st[:, lo:S]
    span = 2**33 if big else 2**31 - 1
    w[..., F_LOWER] = rng.integers(-span, span, shp)
    w[..., F_LREV] = rng.integers(0, span, shp)
    w[..., F_SIZE] = rng.integers(0, 2**35 if big else 2**20, shp)
    w[..., F_GAPS] = rng.integers(0, R, shp)
    w[..., F_STARTLEN] = rng.integers(0, 2**20, shp)
    w[..., F_SCOREBITS] = rng.integers(-2**31, 2**31 - 1, shp)
    op = OP_VALID_BIT | rng.integers(0, 1 << 17, shp)
    blk = np.arange(lo, S)[None, :, None]
    if not no_marks:
        m = (rng.random(shp) < mark_p) & (blk < hi)
        ab = rng.random(shp) < 0.3
        op |= np.where(m & ~ab, OP_COMP_BIT, 0)
        op |= np.where(m & ab, OP_ABANDON_BIT, 0)
    w[..., F_OP] = op
    # a parent: a frame of an earlier step (a higher block), or ROOT
    pb = blk + (1 if deep else rng.integers(1, 6, shp))
    root = (pb >= S) | ((not deep) & (rng.random(shp) >= 0.9))
    w[..., F_PARENT] = np.where(
        root, ROOT, np.minimum(pb, S - 1) * CANDS + rng.integers(0, CANDS,
                                                                   shp))
    NFW = NF + 3 if big else NF
    dev_st = np.zeros((L, S + 1, CANDS, NFW), dtype=np.int64)
    dev_st[..., :NF] = st
    if big:
        for k, f in enumerate((F_LOWER, F_LREV, F_SIZE)):
            dev_st[..., NF + k] = st[..., f] >> 32
    dev_st = (dev_st & 0xFFFFFFFF).astype(np.uint32).view(np.int32)
    marks = (st[:, :S, :, F_OP] & (OP_COMP_BIT | OP_ABANDON_BIT)) != 0
    bmask = (marks.astype(np.int32) << np.arange(CANDS)).sum(2).astype(
        np.int32)
    win = np.zeros(S, bool)
    win[lo:hi] = True
    bmask = np.where(win, bmask, rng.integers(0, 512, (L, S))).astype(
        np.int32)
    swin = np.zeros(S, bool)
    swin[base:steps] = True
    ev = (rng.random((L, S)) < 0.1) & swin
    vals = rng.integers(0, R + 1, (L, S)) * 4096 + rng.integers(0, 4096,
                                                                  (L, S))
    fin = np.where(ev, vals, -1).astype(np.int32)
    fin_dev = np.where(swin, fin, rng.integers(-5, 2**24, (L, S))).astype(
        np.int32)
    lane = rng.integers(0, 4096, (16, L)).astype(np.int32)
    lane[0] = rng.integers(-1, R + 2, L)  # LS_READ_ID
    lane[2] = rng.integers(0, 2, L)       # LS_DONE
    glob = np.zeros(12, dtype=np.int32)
    glob[[0, 1, 5, 6, 7, 8]] = (steps, int(rng.integers(0, R + 1)), base,
                                cum, acc_n, acc_nch)
    plain_st = st if big else st.astype(np.int32)
    return plain_st, dev_st, bmask, fin, fin_dev, lane, glob


def _k3_earlier(res, n, R, first, track, seed=99):
    """Fill the first n entries of a result (and read_steps, unless this
    is the first extraction: folded steps with `track`, else the -1 the
    first one wrote) as earlier extractions left them."""
    rng = np.random.default_rng(seed)
    for f in res[:8]:
        shape = f[:n].shape
        if f.dtype == torch.bool:
            v = torch.from_numpy(rng.integers(0, 2, shape).astype(bool))
        elif f.dtype == torch.float32:
            v = torch.from_numpy(rng.standard_normal(shape).astype(
                np.float32))
        else:
            v = torch.from_numpy(rng.integers(-100, 100, shape)).to(f.dtype)
        f[:n] = v.to(f.device)
    if not first:
        res.read_steps[:] = torch.from_numpy(rng.integers(
            -1, 4000 if track else 0, R).astype(np.int32)).to(
                res.read_steps.device)


@pytest.mark.parametrize("case", sorted(K3_EDGES))
@pytest.mark.parametrize("track", [True, False])
@pytest.mark.parametrize("big", [False, True])
def test_extract_chains_kernel_at_its_edges(cuda, case, track, big):
    """K3 in one launch against the plain extraction (the final one: every
    PoolResult field; one at a store boundary: the entries it appends,
    read_steps and the loop counters it moves)."""
    from mapad_tpu_torch._build import LAUNCHES
    from mapad_tpu_torch.ops import search_pool2 as sp2
    from mapad_tpu_torch.ops.search_pool import PoolConfig

    kw = dict(K3_EDGES[case])
    final, first = kw.get("final", True), kw.get("first", True)
    R, C, L = 40, kw["C"], kw["L"]
    acc_n, acc_nch = kw.get("acc_n", 0), kw.get("acc_nch", 0)
    cfg = PoolConfig(max_len=kw["max_len"], lanes=L, total_steps=kw["S"],
                     read_step_cap=kw["S"], max_chains=C,
                     track_read_steps=track)
    plain_st, dev_st, bmask, fin, fin_dev, lane, glob = _k3_state(
        len(case), big=big, track=track, R=R, **kw)
    t = [torch.from_numpy(x).to(cuda) for x in (dev_st, bmask, lane, glob)]
    fin_d = torch.from_numpy(fin_dev).to(cuda) if track else None
    ext = sp2._Extraction(*t, fin_d, R, big, cfg, torch.zeros(
        sp2.EXT_FLAGS, dtype=torch.int32, device=cuda))
    ext.boundaries = 0 if first else 1
    ext.out = sp2._alloc_result(cfg, R, big, cuda)
    _k3_earlier(sp2._pool_result(ext.out, cfg, R, big), min(acc_n, C), R,
                first, track)
    LAUNCHES.reset()
    with torch.cuda.device(cuda):
        got = sp2._extract_chains_cuda(*t, fin_d, R, big, ext, cfg,
                                       final=final)
        torch.cuda.synchronize()
    assert LAUNCHES.get("extract_chains" + ("_i64" if big else "")) == 1

    # the plain version, from the same earlier entries
    idt = torch.int64 if big else torch.int32
    cpu = torch.device("cpu")
    acc = sp2._ChainLog(cfg, idt, cpu)
    pre = sp2._pool_result(sp2._alloc_result(cfg, R, big, cpu), cfg, R, big)
    _k3_earlier(pre, min(acc_n, C), R, first, track)
    for name, f in zip(("read", "slot", "ab", "lower", "lrev", "size",
                        "score", "ops"), pre[:8]):
        acc.f[name][:C] = f
    acc.n, acc.nch = acc_n, torch.tensor(acc_nch, dtype=torch.int32)
    rs = torch.full((R + 1,), -1, dtype=torch.int32)
    if not first:
        rs[:R] = pre.read_steps
        rs[R] = int(ext.out[sp2._result_layout(
            L, C, kw["max_len"] + 16, R, kw["S"], big).at["read_steps"] + R])
    st, fin_t, lane_t = (torch.from_numpy(x) for x in (plain_st, fin, lane))
    steps, cum = int(glob[0]), int(glob[6])
    if final:
        want = sp2._extract_chains_plain(
            st, fin_t, lane_t[0], (lane_t[2] == 0) & (lane_t[0] < R),
            lane_t[4], int(glob[1]), steps, R, cum, acc, rs, cfg)
        _equal(tuple(x.cpu() for x in got), tuple(want), case)
        return
    assert got is None
    acc.append(*sp2._extract_plain(st, cfg, cum * 9))
    if track:
        sp2._fold_read_steps(fin_t, rs, R)
    res = sp2._pool_result(ext.out, cfg, R, big)
    hi = min(acc.n, C)
    _equal(tuple(f[:hi].cpu() for f in res[:8]),
           tuple(acc.f[n][:hi] for n in ("read", "slot", "ab", "lower",
                                          "lrev", "size", "score", "ops")),
           case)
    g = t[3].cpu()
    assert (int(g[7]), int(g[8])) == (acc.n, int(acc.nch))
    if track or first:
        assert torch.equal(res.read_steps.cpu(), rs[:R])


@pytest.mark.parametrize("R", [41, 1])
def test_unpack_prep_full_kernel_cells_across_reads(fmd, cuda, R):
    """K6 at M=34: a read's 34 cells end inside a blob word, so words hold
    the cells of two reads; lengths 0 to M and every class and quality."""
    from mapad_tpu_torch.ops import engine as teng
    from mapad_tpu_torch.ops.prep import _DEV_LUT_Q

    M = 34
    # the all-length tables serve any M up to the engine's max_len
    eng, _cfg, _prep = _prepped(fmd, cuda, dict(lanes=8, total_steps=256), 1,
                                big=True)
    tab, pen_tab, off = eng._device_lut()
    rng = np.random.default_rng(R)
    cells = (rng.integers(0, 5, R * M) << 7) | rng.integers(0, 128, R * M)
    cells = np.concatenate([cells, np.zeros((-len(cells)) % 3, np.int64)])
    words = (cells[0::3] | (cells[1::3] << 10) | (cells[2::3] << 20))
    consts = np.concatenate([
        rng.integers(0, M + 1, R), rng.integers(0, M + 1, R),
        rng.standard_normal(3 * R).astype(np.float32).view(np.int32)])
    blob = torch.from_numpy(np.concatenate([consts, words]).astype(
        np.int32)).to(cuda)
    got = teng._unpack_prep_full(blob, tab, pen_tab, off, R, M, _DEV_LUT_Q)
    want = teng._unpack_prep_full_plain(blob, tab, pen_tab, off, R, M,
                                        _DEV_LUT_Q)
    _equal(got, want, "unpack_prep_full, M=34")
    # a second call with the same tables, and one with the tables copied
    got = teng._unpack_prep_full(blob, tab.clone(), pen_tab.clone(),
                                 off.clone(), R, M, _DEV_LUT_Q)
    _equal(got, want, "unpack_prep_full, the tables copied")


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


def _assembly_index_and_reads(tmp_path, n_reads):
    """tools/assembly.py's GRCh37-shaped assembly at 1/2000 (86 sequences,
    N runs as X, short IUPAC runs) indexed by the port -> (its FmdIndex,
    the reads: edge reads first, then reads placed at random)."""
    from mapad_tpu_torch.index import builder, load_index
    from mapad_tpu_torch.tools import assembly

    _lay, _b, reads, kinds, fasta, _fq = assembly.make(
        str(tmp_path), 1 / 2000, n_reads=2000)
    builder.run(fasta)
    order = sorted(range(len(reads)), key=lambda i: kinds[i] == "")
    return load_index(fasta).fmd, [reads[i][0] for i in order[:n_reads]]


@pytest.mark.parametrize("genome", ["bench", "assembly"])
def test_retry_tier_on_the_card_equals_plain(fmd, cuda, genome, tmp_path,
                                             monkeypatch):
    """MAPAD_RETRY_TIER=1 on big-mode blocks (a starved step budget, so
    that unfinished and undispatched reads re-run in retry blocks, their
    futures resolved inside the lazy fallback, beside the deep tier): the
    engine on the card against the same engine on the CPU's plain
    versions, the same escalations, tier counts and hits; on the bench
    genome and on the assembly's rows, X in them, with its edge reads and
    reads carrying N."""
    from concurrent.futures import Future

    from mapad_tpu_torch._build import LAUNCHES
    from mapad_tpu_torch.ops.engine import DeviceSearchEngine
    from mapad_tpu_torch.ops.search_pool import PoolConfig
    from torch_port_helpers import packed_equal

    for name in ("MAPAD_DEEP_TIER", "MAPAD_HOST_BID", "MAPAD_DEEP_LANES",
                 "MAPAD_DEEP_NOHIT_HOST"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("MAPAD_RETRY_TIER", "1")
    index = fmd
    seqs = bench_reads(seed=4, n_random=60)
    if genome == "assembly":
        index, seqs = _assembly_index_and_reads(tmp_path, 96)
    cfg = PoolConfig(lanes=16, total_steps=128, read_step_cap=128,
                     max_chains=256)
    reads = records("mapad_tpu_torch", seqs)
    outs = []
    for dev in (cuda, "cpu"):
        eng = DeviceSearchEngine(index, adna_params("mapad_tpu_torch"),
                                 pool_config=cfg, packed_hits=True,
                                 device=dev, big=True)
        assert eng.device_index.big and eng.deep_tier_enabled()
        eng.block_reads = 48
        LAUNCHES.reset()
        res = eng.search_chunk(reads, lazy_fallback=True)
        outs.append(({i for i, r in enumerate(res) if isinstance(r, Future)},
                     [(r.result() if isinstance(r, Future) else r)[0]
                      for r in res], eng._stats["esc_why"],
                     {k: eng._stats.get(k, 0) for k in (
                         "retried", "deep_retried", "oracle", "batches")},
                     LAUNCHES.get("pool_search_i64")))
    (esc_g, hits_g, why_g, tiers_g, k2), (esc_c, hits_c, why_c, tiers_c,
                                          _) = outs
    assert esc_g == esc_c and why_g == why_c and tiers_g == tiers_c
    assert all(packed_equal(a, b) for a, b in zip(hits_g, hits_c))
    assert tiers_g["retried"] > 0, tiers_g
    assert k2 > 0
    assert sum(len(h) > 0 for h in hits_g) > len(reads) // 4


@pytest.mark.parametrize("where", ["below", "above"])
@pytest.mark.parametrize("model", ["adna", "vindija"])
@pytest.mark.parametrize("big", [False, True])
def test_pool_search_fixed_steps_kernel(fmd, cuda, big, model, where):
    """PoolConfig.debug_fixed_steps: K2 runs exactly that many steps in one
    generation, below the loop's natural end (lanes come back unfinished)
    and past it (steps with every lane done), in its four forms, against
    its plain version field by field."""
    from mapad_tpu_torch._build import LAUNCHES

    cfg_kw = dict(lanes=8, total_steps=3072, read_step_cap=512,
                  max_chains=512)
    params = None
    if model == "vindija":
        params = _center_params("vindija")
        cfg_kw["compute_forward_part"] = True
    eng, cfg, prep = _prepped(fmd, cuda, cfg_kw, 17, big=big, params=params)
    assert cfg.backward_only == (model == "adna")
    natural = int(_pool_both(eng, cfg, prep, cuda)[0].steps)
    fixed = natural // 2 if where == "below" else natural + 50
    assert fixed < cfg.total_steps
    LAUNCHES.reset()
    got, want, _ = _pool_both(eng, cfg._replace(debug_fixed_steps=fixed),
                              prep, cuda)
    _equal(tuple(got), tuple(want), (model, where, fixed))
    assert int(got.steps) == fixed
    assert bool(got.lane_unfinished.any()) == (where == "below")
    name = ("pool_search" + ("" if model == "adna" else "_bidir")
            + ("_i64" if big else ""))
    assert LAUNCHES.get(name) == 2  # init + one generation


@pytest.mark.parametrize("big", [False, True])
def test_dev_lut_off_launches_no_unpack_kernel(fmd, cuda, big, monkeypatch):
    """MAPAD_DEV_LUT=0: no K4 launch (small mode: the host-scored rows,
    as views) and no K6 launch (big mode: the dense arrays, K7 on them);
    the engine on the card equals the same engine on the CPU."""
    from concurrent.futures import Future

    from mapad_tpu_torch._build import LAUNCHES
    from mapad_tpu_torch.ops.engine import DeviceSearchEngine
    from mapad_tpu_torch.ops.search_pool import PoolConfig
    from torch_port_helpers import packed_equal

    for name in ("MAPAD_DEEP_TIER", "MAPAD_HOST_BID", "MAPAD_RETRY_TIER"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("MAPAD_DEV_LUT", "0")
    cfg = PoolConfig(lanes=16, total_steps=1024, read_step_cap=256,
                     max_chains=256)
    reads = records("mapad_tpu_torch", bench_reads(seed=4, n_random=60))
    outs = []
    for dev in (cuda, "cpu"):
        eng = DeviceSearchEngine(fmd, adna_params("mapad_tpu_torch"),
                                 pool_config=cfg, packed_hits=True,
                                 device=dev, big=big)
        eng.block_reads = 32
        LAUNCHES.reset()
        res = eng.search_chunk(reads, lazy_fallback=True)
        counts = {k: LAUNCHES.get(k) for k in (
            "unpack_prep", "unpack_prep_full", "bi_d_i64",
            "pool_search" + ("_i64" if big else ""))}
        outs.append(([(r.result() if isinstance(r, Future) else r)[0]
                      for r in res], eng._stats["esc_why"], counts))
    (hits_g, why_g, counts), (hits_c, why_c, _) = outs
    assert why_g == why_c
    assert all(packed_equal(a, b) for a, b in zip(hits_g, hits_c))
    assert counts["unpack_prep"] == counts["unpack_prep_full"] == 0
    assert counts["pool_search" + ("_i64" if big else "")] > 0
    assert (counts["bi_d_i64"] > 0) == big


@pytest.mark.parametrize("big", [False, True])
def test_occ4_batch_kernel(fmd, cuda, big):
    """K1's rank query alone (`occ4_batch`, a warp a position) against
    `_row_occ4`: positions -1, 0, the last, random, garbage; in big mode
    also with counts above 2^32."""
    from mapad_tpu_torch._build import LAUNCHES
    from mapad_tpu_torch.ops import fm

    idx = fm.DeviceFmIndex.from_host(fmd, big=big, device=cuda)
    idt = np.int64 if big else np.int32
    rng = np.random.default_rng(6)
    n = idx.text_len
    info = np.iinfo(idt)
    r = torch.from_numpy(np.concatenate([
        [-1, 0, n - 1], rng.integers(-1, n, size=500),
        rng.integers(info.min, info.max, size=77),
    ]).astype(idt)).to(cuda)
    name = "occ4_batch" + ("_i64" if big else "")
    LAUNCHES.reset()
    _equal((fm.occ4_batch(idx, r),), (fm._row_occ4(idx, r),), name)
    assert LAUNCHES.get(name) == 1
    if big:
        rows = idx.rows.clone()
        cp = ((rows[:, 0:6].long() & 0xFFFFFFFF)
              | (rows[:, 6:12].long() << 32)) + ((3 << 32) + 12345)
        rows[:, 0:6] = (cp & 0xFFFFFFFF).to(torch.int32)
        rows[:, 6:12] = (cp >> 32).to(torch.int32)
        shifted = idx._replace(rows=rows)
        got = fm.occ4_batch(shifted, r)
        _equal((got,), (fm._row_occ4(shifted, r),), name + " above 2^32")
        assert int(got.max()) > 2**32
    with pytest.raises(ValueError):
        fm.occ4_batch(idx, r.to(torch.int32 if big else torch.int64))


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
    if name == "default_tier":
        # the engine's default tier: exogenous reads run many chunks long
        return ref, bench_reads(seed=9, n_random=24, n_exo=8)[:40], \
            adna_params, dict(max_steps=2048)
    if name == "mid_chunk":
        # 9 * 100 + 1 = 901 key slots: the last chunk holds 5
        return ref, reads, adna_params, dict(max_steps=100)
    if name == "one_chunk":
        # 19 key slots, below one chunk of 32
        return ref, reads, adna_params, dict(max_steps=2, hit_cap=4)
    assert name == "hit_cap"
    # a read of the segment completes seven times
    rref, seg = repeat_ref()
    return rref, [seg, seg[5:55], seg[:50]] * 4, adna_params, \
        dict(max_steps=512, hit_cap=4)


@pytest.mark.parametrize("name", ["backward", "center", "budget",
                                  "hit_cap", "default_tier", "mid_chunk",
                                  "one_chunk"])
def test_search_batch_kernel(cuda, name):
    """K7 + K10 against their plain versions on the same card inputs: both
    extension directions (a center-start model), a budget that leaves
    lanes live (S=32), a hit cap below a read's completions (H=4), the
    default tier (S=2048) with lanes that pop from many chunks, a store
    whose last chunk is partial (S=100) and one below a single chunk
    (S=2), and an empty lane in every batch."""
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
    assert int((hc > 0).sum()) > 4 or name in ("budget", "one_chunk")
    if name == "budget":
        assert int(got.steps) == 32 and bool(got.escalate.any())
    if name == "hit_cap":
        assert int(hc.max()) > 4
    if name == "default_tier":
        assert int(got.steps) >= 64  # 577 slots and more: 18 chunks
    if name in ("mid_chunk", "one_chunk"):
        S = cfg_kw["max_steps"]
        assert int(got.steps) == S and (9 * S + 1) % 32
        assert bool(got.escalate.any())


# the batch engine's tiers (max_steps, lanes; None: the engine's 2,048):
# ops/engine.py DEFAULT_TIERS, then chip_smoke.py PATH6_TIERS
BATCH_TIERS = ((2048, None), (512, None), (2048, 512))


@pytest.mark.parametrize("tier", BATCH_TIERS)
def test_search_batch_launch_plans(cuda, tier):
    """K10's plan on the card at each tier of the engine's defaults and of
    `chip_smoke.py`'s path 6, over reads of 128 positions: ceil(L / SMs)
    lanes a block, chunks of 32 slots, every lane resident at once."""
    from mapad_tpu_torch.ops import search as srch
    from mapad_tpu_torch.ops.engine import DEFAULT_TIERS

    assert set(DEFAULT_TIERS) <= set(BATCH_TIERS)
    S, L = tier[0], tier[1] or 2048
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    plan = srch.batch_card_plan(cuda, L, S, 128)
    assert plan.lanes_per_block == -(-L // sms)
    assert plan.blocks == -(-L // plan.lanes_per_block)
    assert (plan.chunk, plan.chunks) == (32, -(-(9 * S + 1) // 32))
    assert plan.lane_smem == -(-(8 * plan.chunks + 24 * 128) // 16) * 16
    assert plan.smem == plan.lanes_per_block * plan.lane_smem
    assert plan.resident == 1


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
    for kernel in ("pool_search_kernel", "unpack_prep_kernel",
                   "pack_result_kernel"):
        assert any(kernel in n for n in names), kernel


# --- distributed mode and CRAM input on the card ---------------------------


def _index_of_bench_ref(tmp_path, mapad_format=False):
    """bench_ref as a FASTA, indexed by the port's CLI -> its path."""
    from mapad_tpu_torch.cli import main

    fa = tmp_path / "g.fa"
    fa.write_text(">g\n" + bench_ref().decode() + "\n")
    argv = ["index", "-g", str(fa)]
    assert main(argv + (["--mapad_format"] if mapad_format else [])) == 0
    return str(fa)


def _worker_chunk(worker, sheet):
    """One task sheet through `worker.run()` over localhost TCP -> the
    decoded result sheet's [(record, hits, seconds)]."""
    import socket
    import threading

    from mapad_tpu_torch.distributed import wire

    with socket.socket() as listener:
        listener.bind(("127.0.0.1", 0))
        listener.listen()
        worker.port = listener.getsockname()[1]
        thread = threading.Thread(target=worker.run, daemon=True)
        thread.start()
        conn, _ = listener.accept()
        with conn:
            conn.settimeout(300)
            conn.sendall(wire.encode_task_sheet(sheet))
            msg_type, payload = wire.read_message(conn)
    thread.join(timeout=60)
    assert msg_type == wire.MSG_RESULT and not thread.is_alive()
    chunk_id, results = wire.decode_result_sheet(payload)
    assert chunk_id == sheet.chunk_id
    return results


@pytest.mark.parametrize("lanes", [8, 2048])
def test_worker_on_the_card_equals_the_worker_on_the_cpu(cuda, tmp_path,
                                                         monkeypatch, lanes):
    """One chunk through a worker on the card (K4, K2 with K1, K3, K5; at
    the CPU worker's 8 lanes, and at the production 512) and through one on
    the CPU's plain versions: equal hits for every read."""
    from mapad_tpu_torch._build import LAUNCHES
    from mapad_tpu_torch.distributed.worker import Worker
    from mapad_tpu_torch.io.sniff import TaskSheet
    from torch_port_helpers import hits_equal

    monkeypatch.setenv("MAPAD_POOL_STEPS", "2048")
    fa = _index_of_bench_ref(tmp_path)
    params = adna_params("mapad_tpu_torch")
    reads = records("mapad_tpu_torch", bench_reads(seed=9, n_random=40))
    outs = {}
    for dev, n_lanes in (("cuda", lanes), ("cpu", 8)):
        LAUNCHES.reset()
        worker = Worker("127.0.0.1", 0, device=dev, lanes=n_lanes)
        outs[dev] = _worker_chunk(worker, TaskSheet(5, reads, fa, params))
        if dev == "cuda":
            assert worker.engine.device.type == "cuda"
            for k in ("unpack_prep", "pool_search", "extract_chains",
                      "pack_result"):
                assert LAUNCHES.get(k) > 0, k
    assert len(outs["cuda"]) == len(outs["cpu"]) == len(reads)
    with_hits = 0
    for (rg, hg, _), (rc, hc, _) in zip(outs["cuda"], outs["cpu"]):
        assert rg.name == rc.name and rg.sequence == rc.sequence
        assert hits_equal(hg, hc), rg.sequence
        with_hits += bool(hg)
    assert with_hits > len(reads) // 2


def test_device_map_of_a_cram_on_a_mapad_native_index(cuda, tmp_path):
    """`map --engine device` of a CRAM 3.1 (rANS-Nx16, arith on the bases,
    fqzcomp on the qualities, tok3 on the names) against an index in
    mapAD's own format only (the bundle removed): the BAM equals the
    native engine's, record for record (XD aside)."""
    import io
    import shutil

    from mapad_tpu_torch.cli import main
    from mapad_tpu_torch.io import cram
    from mapad_tpu_torch.index.runtime import load_index
    from torch_port_helpers import bam_records

    fa = _index_of_bench_ref(tmp_path, mapad_format=True)
    shutil.rmtree(fa + ".tpx")
    assert load_index(fa).meta["format"] == "mapad-native"
    rng = np.random.default_rng(1)
    recs = [{"name": b"r%d" % i, "flags": cram.BF_UNMAPPED, "seq": s,
             "quals": bytes(rng.integers(10, 42, len(s), dtype=np.uint8)),
             "tags": []}
            for i, s in enumerate(bench_reads(seed=3, n_random=60))]
    methods = {i: cram.M_RANSNX16 for i in range(1, 20)}
    methods.update({6: cram.M_TOK3, 8: cram.M_ARITH, 9: cram.M_FQZCOMP})
    buf = io.BytesIO()
    w = cram.CramWriter(buf, "@HD\tVN:1.6\tSO:unsorted\n",
                        block_method=methods, version=(3, 1))
    w.write_chunk(recs[:40])
    w.write_chunk(recs[40:])
    w.close()
    reads = tmp_path / "reads.cram"
    reads.write_bytes(buf.getvalue())
    argv = ["map", "-r", str(reads), "-g", fa, "-p", "0.03", "-l",
            "single_stranded", "-f", "0.6", "-t", "0.55", "-d", "0.01",
            "-s", "1.0", "-i", "0.001", "-o"]
    for engine in ("device", "native"):
        assert main([*argv, str(tmp_path / f"{engine}.bam"), "--engine",
                     engine]) == 0
    got = bam_records(tmp_path / "device.bam")
    assert len(got) == len(recs)
    assert got == bam_records(tmp_path / "native.bam")
    assert sum(1 for r in got if not r[1] & 0x4) > len(recs) // 2


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


def test_shard_rebase_kernel_bound_once(cuda):
    """The wrapper binds once a thread: its argument block stays, set anew
    a call (each shard's base) and re-checked where the shape changes;
    every call against the plain version."""
    from mapad_tpu_torch.ops.search_pool import PoolResult
    from mapad_tpu_torch.parallel import pool_sharded as tps

    rng = np.random.default_rng(4)
    args = None
    for C, L, R, D in ((16384, 512, 8192, 2), (16384, 512, 8192, 2),
                       (300, 7, 50, 4), (16384, 512, 8192, 2)):
        for d in range(D):
            c_read = torch.from_numpy(rng.integers(-1, R, C, dtype=np.int32))
            lane_read = torch.from_numpy(rng.integers(0, R + 1, L,
                                                      dtype=np.int32))
            outs = []
            for rebase, dev in ((tps.shard_rebase, cuda),
                                (tps._shard_rebase_plain, "cpu")):
                res = PoolResult(*[None] * len(PoolResult._fields))._replace(
                    c_read=c_read.to(dev), lane_read=lane_read.to(dev),
                    next_read=torch.tensor(R, dtype=torch.int32,
                                           device=dev))
                outs.append(rebase(res, d * R, R, D * R))
            torch.cuda.synchronize()
            got, want = outs
            _equal((got.c_read.cpu(), got.lane_read.cpu(),
                    got.next_read.cpu()),
                   (want.c_read, want.lane_read, want.next_read),
                   f"shard_rebase C={C} shard {d}")
            assert args is None or tps._rebase.args is args
            args = tps._rebase.args
    with pytest.raises(ValueError, match="outside the block"):
        tps.shard_rebase(got, 8, 8, 15)


@pytest.mark.parametrize("shard", [0, 1])
@pytest.mark.parametrize("big", [False, True])
@pytest.mark.parametrize("shape", PACK_EDGES[:3], ids=str)
def test_pack_result_kernel_with_a_shards_rebase(cuda, shape, big, shard):
    """K5 on K3's allocation with shard `shard` of two's rebase against the
    plain rebase and pack; then without it, the same buffer packed as
    before (the rebase leaves the allocation as it was)."""
    from mapad_tpu_torch._build import LAUNCHES
    from mapad_tpu_torch.ops import engine as teng
    from mapad_tpu_torch.ops import search_pool2 as sp2
    from mapad_tpu_torch.ops.search_pool import PoolConfig, PoolResult
    from mapad_tpu_torch.parallel import pool_sharded as tps

    L, C, max_len, R = shape
    cfg = PoolConfig(max_len=max_len, lanes=L, total_steps=64,
                     read_step_cap=60, max_chains=C)
    buf = sp2._alloc_result(cfg, R, big, cuda)
    res = _random_result(buf, cfg, R, big, seed=C + shard)
    rng = np.random.default_rng(C)
    res.c_read.copy_(torch.from_numpy(rng.integers(-1, R, C,
                                                   dtype=np.int32)))
    res.lane_read.copy_(torch.from_numpy(rng.integers(0, R + 1, L,
                                                      dtype=np.int32)))
    res.next_read.fill_(int(rng.integers(0, R + 1)))
    rebase = (shard * R, R, 2 * R)
    host = PoolResult(*[None if f is None else f.cpu() for f in res])
    plain = teng._pack_result_plain(host)
    want = teng._pack_result_plain(tps._shard_rebase_plain(host, *rebase))
    LAUNCHES.reset()
    got = teng._pack_buffer(buf, cfg, R, big, rebase).cpu()
    again = teng._pack_buffer(buf, cfg, R, big).cpu()
    torch.cuda.synchronize()
    assert LAUNCHES.get("pack_result_rebase") == 1
    assert LAUNCHES.get("pack_result_i64" if big else "pack_result") == 2
    _equal((got, again), (want, plain), "pack_result with the rebase")


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
    """The mesh path of the engine (each shard's upload, K4, K2 + K3, K5
    with the shard's id rebase and copy on its own thread and streams) with
    two shards on one card against the same mesh on the CPU's plain
    versions."""
    from mapad_tpu_torch._build import LAUNCHES
    from torch_port_helpers import packed_equal

    card = torch.device("cuda", torch.cuda.current_device())
    LAUNCHES.reset()
    eng_g, esc_g, hits_g = _sharded_engine_run(fmd, card, [card] * 2,
                                               monkeypatch)
    # each shard's K5 makes its ids global: no shard_rebase launch
    assert LAUNCHES.get("shard_rebase") == 0
    assert LAUNCHES.get("pack_result_rebase") == 2 * eng_g._stats["batches"]
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


def test_big_mode_engine_over_distinct_cards(cuda, tmp_path, monkeypatch):
    """Where the machine has several cards: the engine's automatic mesh
    (MAPAD_SHARD unset) in big mode on the assembly's rows at 1/2000 (X in
    them; edge reads and reads carrying N), the deep tier on and a starved
    step budget, so that every shard runs K6, K7, K2, K3 and K5 with its
    rebase on its own card, in the primary blocks and the deep tier's,
    against the same mesh of CPU devices on the plain versions: the same
    hits, escalated reads, tier counts and shard steps."""
    from concurrent.futures import Future

    from mapad_tpu_torch._build import LAUNCHES
    from mapad_tpu_torch.ops.engine import DeviceSearchEngine
    from mapad_tpu_torch.ops.search_pool import PoolConfig
    from mapad_tpu_torch.parallel import sharding as tsh
    from torch_port_helpers import packed_equal

    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip("needs more than one card")
    for name in ("MAPAD_DEEP_TIER", "MAPAD_HOST_BID", "MAPAD_DEEP_LANES",
                 "MAPAD_DEEP_NOHIT_HOST", "MAPAD_RETRY_TIER",
                 "MAPAD_BLOCK_READS"):
        monkeypatch.delenv(name, raising=False)
    index, seqs = _assembly_index_and_reads(tmp_path, 128)
    cfg = PoolConfig(lanes=16, total_steps=128, read_step_cap=128,
                     max_chains=256)
    reads = records("mapad_tpu_torch", seqs)
    outs = []
    for dev, mesh, shard in ((None, None, None),
                             ("cpu", [torch.device("cpu")] * n, "1")):
        if shard is None:
            monkeypatch.delenv("MAPAD_SHARD")
        else:
            monkeypatch.setenv("MAPAD_SHARD", shard)
        eng = DeviceSearchEngine(index, adna_params("mapad_tpu_torch"),
                                 pool_config=cfg, packed_hits=True,
                                 device=dev, mesh=mesh, big=True)
        assert eng.device_index.big and eng.deep_tier_enabled()
        assert eng.n_shards == n
        eng.block_reads = 16 * n
        LAUNCHES.reset()
        res = eng.search_chunk(reads, lazy_fallback=True)
        torch.cuda.synchronize()
        outs.append((eng, {i for i, r in enumerate(res)
                           if isinstance(r, Future)},
                     [(r.result() if isinstance(r, Future) else r)[0]
                      for r in res],
                     {k: eng._stats.get(k, 0) for k in (
                         "deep_retried", "nohit_host", "oracle", "batches",
                         "escalated")},
                     {k: LAUNCHES.get(k) for k in (
                         "unpack_prep_full", "bi_d_i64", "pool_search_i64",
                         "extract_chains_i64", "pack_result_rebase",
                         "shard_rebase", "pool_search", "bi_d")}))
    (eng_g, esc_g, hits_g, tiers_g, k_g), (eng_c, esc_c, hits_c, tiers_c,
                                           _) = outs
    assert eng_g.mesh == tsh.make_mesh()
    assert esc_g == esc_c and tiers_g == tiers_c
    assert eng_g._stats["shard_steps"] == eng_c._stats["shard_steps"]
    assert all(packed_equal(a, b) for a, b in zip(hits_g, hits_c))
    assert tiers_g["deep_retried"] > 0, tiers_g
    # every block on every card: K6, K7 and K5's rebase a shard and block
    blocks = k_g["pack_result_rebase"] // n
    assert k_g["pack_result_rebase"] == n * blocks and blocks >= 2, k_g
    for name in ("unpack_prep_full", "bi_d_i64", "extract_chains_i64"):
        assert k_g[name] == n * blocks, (name, k_g)
    assert k_g["shard_rebase"] == k_g["pool_search"] == k_g["bi_d"] == 0
    assert sum(len(h) > 0 for h in hits_g) > len(reads) // 4


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


@pytest.mark.parametrize("steps", [1, 200, 512])
def test_gather_steps_kernel_in_every_form(probe_cuda, steps):
    """P1 at the probe's shape (L=1024, W=128, path 1's index rows) in
    bench_dma's three forms against the plain version, each called again
    from t0 = 0 (the barrier's slots then hold the tags of the calls
    before: the tags must go on, not repeat); and at W = 33 (rows not
    16-byte aligned: 4-byte copies)."""
    from mapad_tpu_torch.tools import bench_dma, dma

    for nb, width in ((8197, 128), (4096, 33)):
        rows, blk = bench_dma.make_inputs(nb, width, 1024, seed=steps,
                                          device=probe_cuda)
        want = dma.gather_steps_plain(rows, blk, steps)
        for rep in range(2):
            one = dma.gather_steps(rows, blk, steps)
            queued = dma.gather_steps(rows, blk, steps, launch_per_step=True)
            torch.cuda.synchronize()
            for what, got in (("one launch", one), ("queued", queued)):
                _gather_equal(got, want, (what, rep, width))
        lib = bench_dma.library_steps(rows, blk, steps)
        assert torch.equal(lib.view(torch.int32), want[0].view(torch.int32))


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


def _copy_route(src, dst, ld, col0, ncols):
    """The route csrc/probe_copy.cu's launch takes for this slice: 1 the
    bulk copies, 0 the 4-byte one."""
    from mapad_tpu_torch import _build
    from mapad_tpu_torch.tools import dma

    fn = _build.cuda_function("probe_copy", "copy_route",
                              [ctypes.POINTER(dma._CopyArgs)])
    return fn(ctypes.byref(dma._CopyArgs(src.data_ptr(), dst.data_ptr(),
                                         None, ld, 0, col0, 1, ncols, 0)))


def test_copy_route_of_the_probe_cases(probe_cuda):
    """Every P2-P4 slice, from and into tensors as the allocator gives
    them, takes the bulk copies."""
    from mapad_tpu_torch.tools import _dump_pair, _probe_shapes, _t9

    cases = [(name, shape, _probe_shapes.slice_args(shape, sl), kind == "src")
             for name, kind, shape, sl, _blk in _probe_shapes.SHAPES]
    cases += [("P3", (_t9.NB, _t9.W), (_t9.ROW, 1, 0, _t9.W), True),
              ("P4 k_src", (8, _dump_pair.W), (_dump_pair.SRC_ROW, 1, 0,
                                               _dump_pair.W), True),
              ("P4 k_dst", (8, _dump_pair.W), (_dump_pair.DST_ROW, 1, 0,
                                               _dump_pair.W), False)]
    assert len(cases) == 11
    for what, shape, sl, strided_src in cases:
        _row0, nrows, col0, ncols = sl
        x = torch.zeros(shape, dtype=torch.int32, device=probe_cuda)
        dense = torch.zeros((nrows, ncols), dtype=torch.int32,
                            device=probe_cuda)
        ld = x.numel() // shape[0]
        pair = (x, dense) if strided_src else (dense, x)
        assert _copy_route(*pair, ld, col0, ncols) == 1, what


@pytest.mark.parametrize("shape,row0,nrows,col0,ncols,shift,route", [
    ((64, 8, 128), 3, 1, 0, 1024, 0, "bulk"),   # contiguous rows: one copy
    ((64, 256), 3, 4, 128, 128, 0, "bulk"),     # a copy a strided row
    ((300, 132), 20, 250, 4, 124, 0, "bulk"),   # several blocks
    ((64, 128), 6, 2, 0, 128, 1, "words"),      # a base off 16 bytes
    ((64, 130), 1, 9, 3, 101, 0, "words"),      # nothing aligned
    ((300, 128), 20, 250, 2, 120, 0, "words"),  # rows off 16 bytes
])
def test_copy_routes_on_the_card(probe_cuda, shape, row0, nrows, col0, ncols,
                                 shift, route):
    """Both kernels by both routes, the route as the launch chooses it:
    `copy_src_slice` against torch slicing, `copy_dst_slice` (+ addend)
    into the same slice with every word outside it untouched."""
    from mapad_tpu_torch.tools import dma

    g = torch.Generator(device=probe_cuda)
    g.manual_seed(nrows + ncols)
    n = int(np.prod(shape))
    base = torch.randint(-2**31, 2**31 - 1, (n + 4,), dtype=torch.int32,
                         device=probe_cuda, generator=g)
    x = base[shift:shift + n].view(shape)
    C = n // shape[0]
    out = torch.empty((nrows, ncols), dtype=torch.int32, device=probe_cuda)
    want_route = 1 if route == "bulk" else 0
    assert _copy_route(x, out, C, col0, ncols) == want_route
    got = dma.copy_src_slice(x, row0, nrows, col0, ncols)
    m = x.reshape(shape[0], -1)
    assert torch.equal(got, m[row0:row0 + nrows, col0:col0 + ncols])
    inp = torch.randint(-2**31, 2**31 - 1, (nrows, ncols), dtype=torch.int32,
                        device=probe_cuda, generator=g)
    for addend in (0, -3):
        before = x.clone()
        dst_base = base.clone()
        dst = dst_base[shift:shift + n].view(shape)
        assert _copy_route(inp, dst, C, col0, ncols) == want_route
        dma.copy_dst_slice(inp, dst, row0, col0, addend)
        torch.cuda.synchronize()
        md, mb = dst.reshape(shape[0], -1), before.reshape(shape[0], -1)
        assert torch.equal(md[row0:row0 + nrows, col0:col0 + ncols],
                           inp + addend)
        keep = torch.ones_like(md, dtype=torch.bool)
        keep[row0:row0 + nrows, col0:col0 + ncols] = False
        assert torch.equal(md[keep], mb[keep])
        assert torch.equal(dst_base[:shift], base[:shift])
        assert torch.equal(dst_base[shift + n:], base[shift + n:])


def test_launches_follow_the_current_card_over_distinct_cards(probe_cuda):
    """Where the machine has several cards: a thread that moves between
    them in a seeded order (by `torch.cuda.device` and by `set_device`),
    and a second thread beside it in the reverse order, launch two
    libraries' kernels (the copies and P1) on whichever card is current,
    each result against its plain version.  `_build.cuda_function` sets a
    library's device only where the thread's current card has changed, so
    a launch that kept a card it left would meet another card's stream and
    fail."""
    import threading

    from mapad_tpu_torch.tools import dma

    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip("needs more than one card")
    cards = [torch.device("cuda", i) for i in range(n)]
    rng = np.random.default_rng(11)
    data = {}
    for d in cards:
        x = torch.from_numpy(rng.integers(-2**31, 2**31 - 1, size=(64, 256),
                                          dtype=np.int32)).to(d)
        rows = torch.from_numpy(rng.integers(0, 100, size=(4096, 128),
                                             dtype=np.int32)).to(d)
        blk = torch.from_numpy(rng.integers(0, 4096, size=64,
                                            dtype=np.int32)).to(d)
        data[d] = (x, rows, blk, dma.copy_src_slice_plain(x, 3, 5, 4, 100),
                   dma.gather_steps_plain(rows, blk, 6))
    order = [cards[i] for i in rng.integers(0, n, size=48)]
    failures = []

    def one(d, k):
        x, rows, blk, want_copy, want_gather = data[d]
        got = dma.copy_src_slice(x, 3, 5, 4, 100)
        out = torch.full((64, 256), 7, dtype=torch.int32, device=d)
        dma.copy_dst_slice(want_copy, out, 10, 8, 0)
        acc, chk = dma.gather_steps(rows, blk, 6)
        # torch's own work on another card between two launches
        torch.ones(3, device=cards[(d.index + 1) % n]).sum()
        if not (torch.equal(got, want_copy)
                and torch.equal(out[10:15, 8:108], want_copy)
                and torch.equal(acc, want_gather[0])
                and torch.equal(chk, want_gather[1])):
            failures.append((k, str(d)))

    def walk(seq, tag):
        try:
            for k, d in enumerate(seq):
                if k % 2:
                    with torch.cuda.device(d):
                        one(d, (tag, k))
                else:
                    torch.cuda.set_device(d)
                    one(d, (tag, k))
            torch.cuda.synchronize()
        except Exception as e:  # noqa: BLE001 -- reported below
            failures.append((tag, repr(e)))

    other = threading.Thread(target=walk, args=(order[::-1], "second"))
    other.start()
    walk(order, "first")
    other.join()
    torch.cuda.set_device(cards[0])
    assert not failures, failures


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


# --- big mode past 2^32: K1 and K7 in int64 on a synthetic table of
# 4.4e9 symbols (4,741,380 rows, 2.43 GB; tools/big_rows.py), at the
# smoke's boundary ranks (`edge_ranks`) ---

ROWS64_N = 4_400_000_000


@pytest.fixture(scope="module")
def rows64(cuda):
    from mapad_tpu_torch.tools.big_rows import synthetic_index

    idx = synthetic_index(ROWS64_N, 64, cuda)
    yield idx
    del idx
    torch.cuda.empty_cache()


def test_occ4_batch_int64_rows_past_2_32(rows64):
    from mapad_tpu_torch.ops import fm
    from mapad_tpu_torch.tools.big_rows import edge_ranks

    r = edge_ranks(rows64, 65_536, 1)
    got = fm.occ4_batch(rows64, r)
    _equal((got,), (fm._row_occ4(rows64, r),), "occ4_batch_i64")
    assert int(got.sum(dim=1).max()) > 2**32


@pytest.mark.parametrize("end", ["lower", "upper"])
def test_extend_batch_int64_rows_past_2_32(rows64, end):
    """K1's sweep where the interval's lower end (r1 = lower - 1) or upper
    end (r2 = lower + size - 1) ranks the boundary positions."""
    from mapad_tpu_torch.ops import fm
    from mapad_tpu_torch.tools.big_rows import edge_ranks

    n = rows64.text_len
    r = edge_ranks(rows64, 32_768, 2)
    g = torch.Generator().manual_seed(3)
    size = torch.randint(0, 65, r.shape, generator=g,
                         dtype=torch.int64).to(r.device)
    lower = ((r + 1) if end == "lower" else (r - size + 1)).clamp(0, n - 1)
    size = torch.minimum(size, n - lower)
    lower[0], size[0] = 0, n
    lrev = torch.randint(0, n, r.shape, generator=g,
                         dtype=torch.int64).to(r.device)
    got = fm.extend_batch(rows64, lower, lrev, size)
    _equal(got, fm.extend_batch_plain(rows64, lower, lrev, size),
           f"extend_batch_i64 ({end} ends)")
    assert int(got[0].max()) > 2**32


@pytest.mark.parametrize("forward_part", [False, True])
def test_bi_d_int64_rows_past_2_32(rows64, forward_part):
    """K7 on 256 random reads at M = 128: each walk restarts over the whole
    table, its rows reached by K7's multiply-high past 2^31 and 2^32."""
    from mapad_tpu_torch.ops import bi_d

    g = torch.Generator().manual_seed(4)
    R, M = 256, 128
    dev = rows64.rows.device
    rank = torch.randint(1, 5, (R, M), generator=g, dtype=torch.int32)
    pen = -4 * torch.rand((R, M), generator=g)
    n = torch.randint(M // 2, M + 1, (R,), generator=g, dtype=torch.int32)
    rank[torch.arange(M)[None, :] >= n[:, None]] = 0
    split = n // 2 if forward_part else n
    steps = (int(split.max()), int((n - split).max()))
    t = [x.to(dev) for x in (rank, pen, n, split)]
    got = bi_d.compute_bi_d(rows64, *t, forward_part, steps)
    _equal((got,), (bi_d.compute_bi_d_plain(rows64, *t, forward_part,
                                            steps),), "bi_d_i64")


# --- mapAD's other settings (chip_smoke.py path 14) ------------------------

CONFIG_NAMES = ["cutoff", "gaps_0_1"]


def _config_params(name, center=False):
    """Setting `name` of tools/configs.py as the port's CLI builds it;
    `center`: with the center-start model (VindijaPwm) and its bound
    rebuilt on that model's representative mismatch."""
    import dataclasses

    from mapad_tpu_torch import cli, models
    from mapad_tpu_torch.tools import configs

    params = configs.parameters(cli, name)
    if not center:
        return params
    pwm = models.VindijaPwm()
    repr_mm = pwm.get_representative_mismatch_penalty()
    mb = params.mismatch_bound
    bound = (models.Continuous(mb.cutoff, mb.exponent, repr_mm)
             if isinstance(mb, models.Continuous)
             else models.Discrete(0.03, np.float32(0.02), repr_mm))
    return dataclasses.replace(params, difference_model=pwm,
                               mismatch_bound=bound)


def _config_reads(n=40, seed=3):
    """Reads of the bench reference with indels at 1% a base (and damage)."""
    from mapad_tpu_torch.tools.assembly import make_reads

    ref = np.frombuffer(bench_ref(), dtype=np.uint8)
    return [s for s, _q in make_reads(ref, n, seed, indel_rate=0.01)]


@pytest.mark.parametrize("name", CONFIG_NAMES)
@pytest.mark.parametrize("big", [False, True])
def test_configs_unpack_kernels(fmd, cuda, name, big):
    """K4 (int32) and K6 (int64) on the tables of the setting: the bound's
    scale in the consts (len^e under `-c`), the Bi-D penalty column of its
    gap_dist_ends."""
    from mapad_tpu_torch.ops import engine as teng
    from mapad_tpu_torch.ops.prep import _DEV_LUT_Q

    eng, _cfg, prep = _prepped(fmd, cuda, dict(lanes=8, total_steps=256),
                               1, big=big, params=_config_params(name),
                               reads=_config_reads())
    blob = torch.from_numpy(prep["blob"]).to(cuda)
    tab, pen_tab, off = eng._device_lut()
    R, M = prep["L"], prep["max_len"]
    if big:
        got = teng._unpack_prep_full(blob, tab, pen_tab, off, R, M,
                                     _DEV_LUT_Q)
        want = teng._unpack_prep_full_plain(blob, tab, pen_tab, off, R, M,
                                            _DEV_LUT_Q)
        scale = got[6]
    else:
        got = teng._unpack_prep_lut(blob, tab, off, R, M, _DEV_LUT_Q,
                                    prep["rle"])
        want = teng._unpack_prep_lut_plain(blob, tab, off, R, M, _DEV_LUT_Q,
                                           prep["rle"])
        scale = got[2]
    _equal(got, want, (name, big))
    live = scale[:40].cpu()
    assert bool((live != 1.0).any()) == (name == "cutoff")


@pytest.mark.parametrize("name", CONFIG_NAMES)
@pytest.mark.parametrize("big", [False, True])
def test_configs_bi_d_kernel(fmd, cuda, name, big):
    """K7 on the penalty elements of the setting's gap rule, from the dense
    inputs of the batch engine (int32) or of big mode's K6 (int64)."""
    from mapad_tpu_torch.ops import bi_d
    from mapad_tpu_torch.ops.engine import DeviceSearchEngine

    eng = DeviceSearchEngine(fmd, _config_params(name), lanes=41,
                             mode="pool" if big else "batch", big=big,
                             device=cuda)
    with torch.cuda.device(cuda):
        prep = eng._prepare(records("mapad_tpu_torch", _config_reads()),
                            128, 41, host_bid=False, dense=True)
        d = prep["dense"]
        args = [d[k] for k in ("pattern_rank", "pen", "n", "split")]
        if not args[0].is_cuda:
            args = [torch.as_tensor(np.asarray(a)).to(cuda) for a in args]
        args[0] = args[0].to(torch.int32)
        st = prep["_stash"]
        steps = (int(st["split"].max()), int((st["n"] - st["split"]).max()))
        got = bi_d.compute_bi_d(eng.device_index, *args, False, steps)
        want = bi_d.compute_bi_d_plain(eng.device_index, *args, False, steps)
    _equal((got,), (want,), (name, big))
    assert bool((got != 0).any())


@pytest.mark.parametrize("name", CONFIG_NAMES)
@pytest.mark.parametrize("bidir", [False, True])
@pytest.mark.parametrize("big", [False, True])
def test_configs_pool_search_kernels(fmd, cuda, name, bidir, big):
    """K2 in its four forms + K3 + K5 under the setting, on reads with
    indels: hits whose chains hold insertions or deletions."""
    from mapad_tpu_torch.ops import engine as teng
    from mapad_tpu_torch.ops.search import OP_DELETION, OP_INSERTION

    cfg_kw = dict(lanes=8, total_steps=3072, read_step_cap=512,
                  max_chains=512, compute_forward_part=bidir)
    eng, cfg, prep = _prepped(fmd, cuda, cfg_kw, 17, big=big,
                              params=_config_params(name, bidir),
                              reads=_config_reads())
    assert cfg.backward_only != bidir
    got, want, _ = _pool_both(eng, cfg, prep, cuda)
    _equal(tuple(got), tuple(want), (name, bidir, big))
    _equal((teng._pack_result(got),), (teng._pack_result_plain(got),),
           "pack_result")
    n = min(int(got.n_chains), cfg.max_chains)
    hit = (got.c_read[:n] >= 0) & ~got.c_abandon[:n]
    kind = (got.c_ops[:n] >> 17) & 3
    valid = (got.c_ops[:n] & (1 << 20)) != 0
    gap = (valid & ((kind == OP_INSERTION) | (kind == OP_DELETION))).any(1)
    assert int(hit.sum()) > 4 and (name == "gaps_0_1") <= bool(
        (hit & gap).any())


@pytest.mark.parametrize("name", CONFIG_NAMES)
def test_configs_search_batch_kernel(fmd, cuda, name):
    """K7 + K10 of the batch engine under the setting against their plain
    versions."""
    from mapad_tpu_torch.ops.engine import DeviceSearchEngine
    from mapad_tpu_torch.ops.search import (
        k_mismatch_search_batch,
        k_mismatch_search_batch_plain,
    )

    eng = DeviceSearchEngine(fmd, _config_params(name), lanes=41,
                             mode="batch", device=cuda)
    cfg = eng.config._replace(max_steps=512)
    with torch.cuda.device(cuda):
        prep = eng._prepare(records("mapad_tpu_torch", _config_reads()),
                            128, 41, host_bid=False, dense=True)
        args = [prep["dense"][k] for k in (
            "pattern_rank", "pattern_code", "n", "score_lut", "pen", "split",
            "scale", "thresh", "repr_mm")]
        got = k_mismatch_search_batch(eng.device_index, *args,
                                      eng._params(), cfg)
        want = k_mismatch_search_batch_plain(eng.device_index, *args,
                                             eng._params(), cfg)
        torch.cuda.synchronize()
    _equal(tuple(got), tuple(want), name)
    assert int((got.hcount.cpu() > 0).sum()) > 4


# --- long streams: sheets that end in short blocks mid-stream -------------

# sheets of 25,000, 25,000 and 10,000 reads: blocks of 4,096, seven a full
# sheet (the first sheet long enough for the card's memory pool to reach
# its steady state before the first turn), each sheet ending in a short one
LONG_STREAM_READS = 60_000
LONG_STREAM_FLAGS = ["-p", "0.03", "-l", "single_stranded", "-f", "0.6",
                     "-t", "0.55", "-d", "0.01", "-s", "1.0", "-i", "0.001",
                     "--batch_size", "25000"]


@pytest.fixture(scope="module")
def long_stream(cuda, tmp_path_factory):
    """A 2 Mbp genome of tools/assembly.py's generator indexed by the CLI,
    LONG_STREAM_READS of its reads with indels, and the native engine's BAM
    of them in sheets of 25,000 -> dict."""
    from mapad_tpu_torch.cli import main
    from mapad_tpu_torch.tools.assembly import (
        gen_genome,
        make_reads,
        write_fasta,
        write_fastq,
    )
    from torch_port_helpers import bam_records

    d = tmp_path_factory.mktemp("long_stream")
    genome = gen_genome(2_000_000, 42)
    fa, fq = str(d / "g.fa"), str(d / "r.fq")
    write_fasta(fa, genome, ("chr1",), np.array([0]),
                np.array([len(genome)]))
    write_fastq(make_reads(genome, LONG_STREAM_READS, 142, indel_rate=0.001),
                fq)
    assert main(["index", "-g", fa]) == 0
    native = str(d / "native.bam")
    assert main(["map", "-r", fq, "-g", fa, "-o", native, "--engine",
                 "native", *LONG_STREAM_FLAGS]) == 0
    return dict(dir=d, fa=fa, fq=fq, native=bam_records(native))


@pytest.mark.parametrize("big", [False, True])
def test_long_stream_sheets_on_the_card(long_stream, big):
    """`pipeline.run` on the card over sheets of 25,000 reads in blocks of
    4,096, so that each sheet ends in a short block in the middle of the
    stream, in int32 and in big mode (the deep tier on): the BAM equals the
    native engine's; the card's allocated bytes between blocks and its
    reserved bytes stay within 64 MiB of the first sheet's end at every
    later sheet boundary (a drop allowed at the run's end, when nothing is
    in flight); K5 launched once a block, tier blocks included."""
    import os

    from mapad_tpu_torch import cli
    from mapad_tpu_torch._build import LAUNCHES
    from mapad_tpu_torch.index.runtime import load_index
    from mapad_tpu_torch.map import pipeline
    from mapad_tpu_torch.ops.engine import DeviceSearchEngine
    from mapad_tpu_torch.tools.sheets import SheetWatch
    from torch_port_helpers import bam_records

    w = long_stream
    args = cli.build_parser().parse_args(
        ["map", "-r", w["fq"], "-g", w["fa"], "-o", "x",
         *LONG_STREAM_FLAGS])
    params = cli.build_alignment_parameters(args)
    index = load_index(w["fa"])
    engine = DeviceSearchEngine(index.fmd, params, big=big, packed_hits=True)
    assert engine.device.type == "cuda" and engine.deep_tier_enabled() == big
    engine.block_reads = 4096
    out = str(w["dir"] / f"device_{big}.bam")
    LAUNCHES.reset()
    with SheetWatch(torch) as watch:
        pipeline.run(w["fq"], w["fa"], out, True, params, None,
                     engine=engine, position_seed=args.seed,
                     cmdline="mapad map", threads=os.cpu_count() or 1,
                     index=index)
    run = watch.runs[-1]
    assert run["sheets"] == [25_000, 25_000, 10_000]
    assert run["input_blocks"] == 17
    blocks = run["input_blocks"] + len(run["tier_blocks"])
    assert LAUNCHES.get("pack_result" + ("_i64" if big else "")) == blocks
    first, *later = run["samples"]
    assert len(later) == 2
    for i, s in enumerate(later):
        for key in ("allocated", "reserved"):
            grown = s[key] - first[key]
            assert grown <= 64 << 20, (key, i, grown)
            if s is not later[-1]:
                assert -grown <= 64 << 20, (key, i, grown)
    assert bam_records(out) == w["native"]


# --- mapAD's input as its users supply it (chip_smoke.py path 16) ---------

PIPELINE_BAM_READS = 12_288  # three sheets of 4,096 reads, a block each
PIPELINE_BAM_FLAGS = ["-p", "0.03", "-l", "single_stranded", "-f", "0.6",
                      "-t", "0.55", "-d", "0.01", "-s", "1.0", "-i",
                      "0.001", "--batch_size", "4096"]


@pytest.fixture(scope="module")
def pipeline_bam(cuda, tmp_path_factory):
    """A 1 Mbp genome of tools/assembly.py's generator indexed by the CLI, a
    pipeline BAM of PIPELINE_BAM_READS of its records (tools/pipeline_bam.py;
    the second 4,096 quality-less) and the native engine's BAM of it ->
    dict."""
    from mapad_tpu_torch.cli import main
    from mapad_tpu_torch.tools import pipeline_bam as pb
    from mapad_tpu_torch.tools.assembly import gen_genome, write_fasta
    from torch_port_helpers import bam_records

    d = tmp_path_factory.mktemp("pipeline_bam")
    genome = gen_genome(1_000_000, 42)
    fa, bam = str(d / "g.fa"), str(d / "reads.bam")
    write_fasta(fa, genome, ("chr1",), np.array([0]),
                np.array([len(genome)]))
    truth = pb.make(bam, genome, PIPELINE_BAM_READS, 20,
                    qualityless=(4096, 4096), scattered=1)
    assert main(["index", "-g", fa]) == 0
    native = str(d / "native.bam")
    assert main(["map", "-r", bam, "-g", fa, "-o", native, "--engine",
                 "native", *PIPELINE_BAM_FLAGS]) == 0
    return dict(dir=d, fa=fa, bam=bam, truth=truth,
                native=bam_records(native))


@pytest.mark.parametrize("big", [False, True])
def test_pipeline_bam_routes_and_launches_on_the_card(pipeline_bam, big):
    """`pipeline.run` on the card over a pipeline BAM in blocks of 4,096:
    each block's upload route follows its reads' highest quality (the
    quality-less block: the host-scored rows, or big mode's dense arrays),
    K4 (K6) launches on the device-LUT blocks alone, K5 (and K7) on every
    block; the BAM equals the native engine's and is held to the input."""
    import os

    from mapad_tpu_torch import cli
    from mapad_tpu_torch._build import LAUNCHES
    from mapad_tpu_torch.index.runtime import load_index
    from mapad_tpu_torch.map import pipeline
    from mapad_tpu_torch.ops.engine import DeviceSearchEngine
    from mapad_tpu_torch.ops.prep import _DEV_LUT_Q
    from mapad_tpu_torch.tools import pipeline_bam as pb
    from mapad_tpu_torch.tools.sheets import SheetWatch
    from torch_port_helpers import bam_records

    w = pipeline_bam
    args = cli.build_parser().parse_args(
        ["map", "-r", w["bam"], "-g", w["fa"], "-o", "x",
         *PIPELINE_BAM_FLAGS])
    params = cli.build_alignment_parameters(args)
    index = load_index(w["fa"])
    engine = DeviceSearchEngine(index.fmd, params, big=big, packed_hits=True)
    engine.block_reads = 4096
    out = str(w["dir"] / f"device_{big}.bam")
    LAUNCHES.reset()
    with SheetWatch(torch) as watch:
        pipeline.run(w["bam"], w["fa"], out, True, params, None,
                     engine=engine, position_seed=args.seed,
                     cmdline="mapad map", threads=os.cpu_count() or 1,
                     index=index)
    blocks = watch.runs[-1]["blocks"]
    routes = [b["route"] for b in blocks]
    assert routes == ["lut" if b["max_qual"] < _DEV_LUT_Q else "host"
                      for b in blocks]
    assert routes[1] == "host" and "lut" in routes
    sfx = "_i64" if big else ""
    assert LAUNCHES.get("unpack_prep_full" if big else "unpack_prep") == \
        routes.count("lut")
    assert LAUNCHES.get("pack_result" + sfx) == len(blocks)
    if big:
        assert LAUNCHES.get("bi_d_i64") == len(blocks)
    assert engine._stats["esc_why"]["overlong"] == int(
        w["truth"].overlong.sum())
    assert bam_records(out) == w["native"]
    pb.check_output(w["truth"], out)


@pytest.mark.parametrize("block,big", [("qualityless", False),
                                       ("iupac", False), ("iupac", True)])
def test_pipeline_bam_kernels_against_plain(fmd, cuda, tmp_path, block, big):
    """One block of a pipeline BAM of the bench reference against the plain
    versions: K2 + K3 + K5 on quality-less reads in the host-scored upload;
    K4 (int32) or K6 and K7 (int64), then K2 + K3 + K5, on reads led by
    those holding `=` and IUPAC codes."""
    from mapad_tpu_torch.map.record import Record
    from mapad_tpu_torch.ops import bi_d
    from mapad_tpu_torch.ops import engine as teng
    from mapad_tpu_torch.ops.engine import DeviceSearchEngine
    from mapad_tpu_torch.ops.prep import _DEV_LUT_Q
    from mapad_tpu_torch.ops.search_pool import PoolConfig
    from mapad_tpu_torch.tools import pipeline_bam as pb

    t = pb.make(str(tmp_path / "p.bam"), np.frombuffer(bench_ref(),
                                                       dtype=np.uint8),
                256, 20, qualityless=(64, 64), scattered=1)
    lens = np.array([len(s) for s in t.sequences])
    fits = (lens > 0) & ~t.overlong
    first = (t.qualityless if block == "qualityless"
             else (t.kinds == pb.IUPAC) & ~t.qualityless)
    idx = [*np.flatnonzero(fits & first),
           *np.flatnonzero(fits & ~first & ~t.qualityless)][:48]
    recs = [Record.from_bam(t.names[i], int(t.flags[i]), t.sequences[i],
                            t.qualities[i], t.tags[i]) for i in idx]
    eng = DeviceSearchEngine(
        fmd, adna_params("mapad_tpu_torch"), big=big, device=cuda,
        pool_config=PoolConfig(lanes=8, total_steps=3072, read_step_cap=512,
                               max_chains=512))
    cfg, prep, _ = eng._prep_block(recs, 48, eng.pool_config)
    R, M = prep["L"], prep["max_len"]
    if block == "qualityless":
        assert not prep["dev_lut"]
    elif big:
        assert prep["dev_full"]
        blob = torch.from_numpy(prep["blob"]).to(cuda)
        tab, pen_tab, off = eng._device_lut()
        dense = teng._unpack_prep_full(blob, tab, pen_tab, off, R, M,
                                       _DEV_LUT_Q)
        _equal(dense, teng._unpack_prep_full_plain(blob, tab, pen_tab, off,
                                                   R, M, _DEV_LUT_Q), "K6")
        rank, _code, n, _lut, pen, split, *_rest = dense
        args = (eng.device_index, rank, pen, n, split,
                cfg.compute_forward_part, prep["bid_steps"])
        _equal((bi_d.compute_bi_d(*args),), (bi_d.compute_bi_d_plain(*args),),
               "K7")
    else:
        assert prep["dev_lut"]
        blob = torch.from_numpy(prep["blob"]).to(cuda)
        tab, _pen_tab, off = eng._device_lut()
        _equal(teng._unpack_prep_lut(blob, tab, off, R, M, _DEV_LUT_Q,
                                     prep["rle"]),
               teng._unpack_prep_lut_plain(blob, tab, off, R, M, _DEV_LUT_Q,
                                           prep["rle"]), "K4")
    got, want, _ = _pool_both(eng, cfg, prep, cuda)
    _equal(tuple(got), tuple(want), (block, big))
    _equal((teng._pack_result(got),), (teng._pack_result_plain(got),), "K5")
    n_chains = min(int(got.n_chains), cfg.max_chains)
    assert int(((got.c_read[:n_chains] >= 0)
                & ~got.c_abandon[:n_chains]).sum()) > 4
