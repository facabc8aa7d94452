"""K3's launch plan (`ops/search_pool2.py` `extract_plan`), a pure function
of the lane count, the chain log's capacity and the card's figures, and
the one allocation its wrapper carves the PoolResult from
(`_result_layout`, `_pool_result`), on the CPU.

On an H100's figures (132 SMs, 48 KB of shared memory a block without
opting in) and with given blocks-per-SM figures: the grid never exceeds
what the card holds at once, a block's shared memory stays within the
limit, and the kernel's work, split as csrc/extract_chains.cu splits it
(a warp a lane for the count and the emit, 1 to 32 entries a warp for
the walks, a lane a warp from the last warp down for the fold, the masks
and the finish log in rounds of 128 words), reaches every lane, every
entry and every (lane, step) exactly once, at the edges of C and MW."""

import pytest

torch = pytest.importorskip("torch")

SMS = 132
SMEM_BLOCK = 49152


def _occupancy(regs, smem_sm=233472, reserved=1024):
    """Blocks an SM holds at once, as the occupancy query counts them."""
    def per_sm(threads, smem):
        return min(32, 2048 // threads, 65536 // (threads * regs),
                   smem_sm // (smem + reserved))
    return per_sm


OCCUPANCY = {
    "regs40": _occupancy(40),
    "regs128": _occupancy(128),
    "one": lambda threads, smem: 1,
}

# (L, C, MW): the smoke's and the engine's shapes, and the edges
SHAPES = [
    (512, 16384, 144),   # the production pool config (paths 1, 2, 7)
    (128, 16384, 144),   # the narrow deep config (path 4)
    (1024, 16384, 144),  # the most lanes
    (1, 1, 17),          # one lane, one entry, max_len 1
    (8, 24, 64),         # the GPU tests' chain-log overflow
    (40, 1024, 144),     # lanes that fill no warp's worth of blocks
    (13, 33, 33),        # one entry past a warp, MW past a round
    (1024, 1, 144),      # a chain log of one entry
    (1, 65536, 272),     # a long log, max_len 256
]


def _plan(L, C, MW, per_sm, sms=SMS):
    from mapad_tpu_torch.ops.search_pool2 import extract_plan

    return extract_plan(L, C, MW, sms, SMEM_BLOCK, per_sm)


@pytest.mark.parametrize("occ", sorted(OCCUPANCY))
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_extract_plan_fits_the_card(shape, occ):
    """The grid is co-resident, a block's shared memory fits, and every
    unit of work has a warp of its own where the card has the warps."""
    from mapad_tpu_torch.ops.search_pool2 import (
        EXT_BLOCKS_PER_SM,
        EXT_MAX_BLOCKS,
        EXT_MISC,
        EXT_STAGE,
        EXT_WARPS,
    )

    L, C, MW = shape
    per_sm = OCCUPANCY[occ]
    plan = _plan(L, C, MW, per_sm)
    resident = per_sm(32 * plan.warps, plan.smem)
    assert 1 <= plan.blocks <= min(EXT_BLOCKS_PER_SM * SMS, EXT_MAX_BLOCKS)
    assert plan.blocks <= resident * SMS
    assert plan.warps == EXT_WARPS
    assert plan.smem <= SMEM_BLOCK and plan.smem % 16 == 0
    # the lane offsets (L + 1), the block's totals, a warp's staged rows
    assert plan.smem >= 4 * (L + 1 + EXT_MISC + plan.warps * EXT_STAGE)
    # a warp for each entry and each lane where the card has them, and no
    # more blocks than that needs
    units = C + L
    NW = plan.blocks * plan.warps
    assert NW >= min(units, min(resident, EXT_BLOCKS_PER_SM) * SMS
                     * plan.warps)
    assert (plan.blocks - 1) * plan.warps < units


def _grid_stride(n, first, step):
    return list(range(first, n, step))


@pytest.mark.parametrize("track", [True, False])
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_extract_plan_covers_every_lane_and_entry(shape, track):
    """Split as the kernel splits it, every lane is counted and emitted by
    one warp, every entry walked by one thread (`we` a warp, as few as the
    warps left beside the fold allow), every lane's finish log folded by
    one warp, and no warp both walks and folds where the grid has the
    warps, at the edges of C."""
    L, C, MW = shape
    plan = _plan(L, C, MW, OCCUPANCY["regs40"])
    NW = plan.blocks * plan.warps
    folders = L if track and NW > L else 0
    for n_walk in sorted({0, 1, 31, 32, 33, C - 1, C} & set(range(C + 1))):
        we = min(32, max(1, -(-n_walk // (NW - folders))))
        counted, walked, folded, walkers = [], [], [], set()
        for gw in range(NW):
            counted += _grid_stride(L, gw, NW)
            for j in _grid_stride(-(-n_walk // we), gw, NW):
                walked += [e for e in range(we * j, we * j + we)
                           if e < n_walk]
                walkers.add(gw)
            if track:
                folded += [(l, gw) for l in _grid_stride(L, NW - 1 - gw, NW)]
        assert sorted(counted) == list(range(L))
        assert sorted(walked) == list(range(n_walk))
        if track:
            assert sorted(l for l, _gw in folded) == list(range(L))
            if -(-n_walk // we) + L <= NW:
                assert not walkers & {gw for _l, gw in folded}


def _rounds(row, lo, hi):
    """{round: the words of [row + lo, row + hi) it takes}, as the kernel
    takes them: rounds of 128 words from the 16-byte word at or before the
    first, thread t of the warp 4 words at 4t, the masked ones left out."""
    g0, g1 = row + lo, row + hi
    q0 = g0 & ~3
    nr = (g1 - q0 + 127) >> 7
    return {r: [w for t in range(32)
                for w in range(q0 + 128 * r + 4 * t, q0 + 128 * r + 4 * t + 4)
                if g0 <= w < g1] for r in range(nr)}


@pytest.mark.parametrize("S", [1, 2, 5, 37, 130, 8192])
@pytest.mark.parametrize("lane", [0, 1, 3])
def test_mask_and_log_rounds_cover_every_step_once(S, lane):
    """The count, the emit and the fold reach every step of the range
    once, whatever the row's alignment, in no more rounds than a lane's
    round counts hold (S // 128 + 2)."""
    row = lane * S
    for lo, hi in {(0, S), (S - 1, S), (0, 1), (S // 3, S - S // 5)}:
        if not 0 <= lo < hi <= S:
            continue
        rounds = _rounds(row, lo, hi)
        assert len(rounds) <= S // 128 + 2
        assert sorted(w for ws in rounds.values() for w in ws) == list(
            range(row + lo, row + hi))


@pytest.mark.parametrize("bad", ["no_lanes", "too_many_lanes", "no_chains",
                                 "not_resident", "ops_overflow"])
def test_extract_plan_raises_where_nothing_fits(bad):
    L, C, MW, per_sm = 512, 16384, 144, OCCUPANCY["regs40"]
    if bad == "no_lanes":
        L = 0
    elif bad == "too_many_lanes":
        L = 1025
    elif bad == "no_chains":
        C = 0
    elif bad == "not_resident":
        per_sm = OCCUPANCY["one"]
        with pytest.raises(ValueError):
            _plan(L, C, MW, lambda threads, smem: 0)
        return
    elif bad == "ops_overflow":
        C, MW = 1 << 20, 1 << 12
    with pytest.raises(ValueError):
        _plan(L, C, MW, per_sm)


@pytest.mark.parametrize("big", [False, True])
@pytest.mark.parametrize("shape", [(512, 16384, 128, 1024), (8, 24, 48, 48),
                                   (13, 33, 17, 7), (1, 1, 1, 1)], ids=str)
def test_result_layout_views(shape, big):
    """One allocation holds every PoolResult field, each with its dtype
    and shape, contiguous, where the kernel's pointer puts it, the rows at
    16-byte boundaries, apart from the other fields and the scratch."""
    from mapad_tpu_torch.ops.search_pool import PoolConfig
    from mapad_tpu_torch.ops.search_pool2 import (
        _EXT_PTRS,
        _alloc_result,
        _pool_result,
        _result_layout,
    )

    L, C, max_len, R = shape
    cfg = PoolConfig(max_len=max_len, lanes=L, total_steps=64,
                     read_step_cap=60, max_chains=C)
    MW = max_len + 16
    buf = _alloc_result(cfg, R, big, torch.device("cpu"))
    lay = _result_layout(L, C, MW, R, 64, big)
    assert buf.dtype == torch.int32 and buf.numel() == lay.words
    res = _pool_result(buf, cfg, R, big)
    idt = torch.int64 if big else torch.int32
    want = dict(
        c_read=((C,), torch.int32), c_slot=((C,), torch.int32),
        c_abandon=((C,), torch.bool), c_lower=((C,), idt),
        c_lrev=((C,), idt), c_size=((C,), idt),
        c_score=((C,), torch.float32), c_ops=((C, MW), torch.int32),
        n_chains=((), torch.int32), lane_read=((L,), torch.int32),
        lane_unfinished=((L,), torch.bool), next_read=((), torch.int32),
        steps=((), torch.int32), read_steps=((R,), torch.int32))
    base = buf.data_ptr()
    offs = dict(zip(_EXT_PTRS, lay.ptrs))
    for name, (shp, dt) in want.items():
        t = getattr(res, name)
        assert tuple(t.shape) == shp and t.dtype == dt, name
        assert t.is_contiguous(), name
        assert t.data_ptr() - base == offs[name], name
        # the rows 16-byte aligned, the scalars after n_chains and the
        # second bool row on 4 bytes
        assert (t.data_ptr() - base) % (4 if name in (
            "lane_unfinished", "next_read", "steps") else 16) == 0, name
    # every field and every scratch part apart from every other, inside
    # the allocation
    spans = [(getattr(res, n).data_ptr() - base,
              getattr(res, n).data_ptr() - base
              + getattr(res, n).numel() * getattr(res, n).element_size())
             for n in want]
    for name, words in (("lane_cnt", 4 * L), ("lane_first", 4 * L),
                        ("c_lane", C),
                        ("e_slot", C), ("round_cnt", L * (64 // 128 + 2))):
        assert offs[name] % 16 == 0, name
        spans.append((offs[name], offs[name] + 4 * words))
    spans.sort()
    assert spans[0][0] >= 0 and spans[-1][1] <= 4 * lay.words
    for (_a0, a1), (b0, _b1) in zip(spans, spans[1:]):
        assert a1 <= b0
