"""K10's launch plan (`ops/search.py` `batch_plan`), a pure function of the
lane count, the step budget, the read length and the card's figures: on an
H100's figures (132 SMs, 227 KB of shared memory a block, 228 KB an SM)
and with given blocks-per-SM figures, for L from 1 to 2,048 and step
budgets from 2 to 32,768.  Every lane is placed exactly once, a lane's
chunk maxima cover its 9S+1 key slots in at most 1,024 chunks of a power
of two of 32 or more, a block's shared memory stays within the limits,
and the plan raises where no block holds a lane.  Then the ctypes mirrors
of `struct BatchArgs` and `struct BatchPlan` against csrc/search_batch.cu,
and the K10 timing tool's refusal without a card."""

import os
import re

import pytest

torch = pytest.importorskip("torch")

SMS = 132
SMEM_BLOCK = 232448  # 227 KB: what a block may opt into
SMEM_SM = 233472     # 228 KB an SM
STATIC = 0           # the kernel's own shared memory
RESERVED = 1024      # the runtime's reserve a block
M = 128              # the engine's read length
STEPS = [2, 32, 512, 2048, 8192, 32768]


def _occupancy(regs):
    """Blocks an SM holds at once, as the occupancy query counts them, for
    a kernel of `regs` registers a thread."""
    def per_sm(threads, smem):
        by_smem = SMEM_SM // (smem + STATIC + RESERVED)
        return min(32, 2048 // threads, 65536 // (threads * regs), by_smem)
    return per_sm


def _plan(L, S, per_sm, m=M):
    from mapad_tpu_torch.ops.search import batch_plan

    return batch_plan(L, S, m, SMS, SMEM_BLOCK, SMEM_SM, per_sm, STATIC,
                      RESERVED)


def _check(plan, L, S, per_sm, m=M):
    """The plan's invariants for L lanes of S steps over reads of m."""
    from mapad_tpu_torch.ops.search import MAX_LANES_PER_BLOCK

    lpb = plan.lanes_per_block
    assert 1 <= lpb <= min(MAX_LANES_PER_BLOCK, -(-L // SMS))
    # every lane exactly once, and no block without a lane
    placed = [b * lpb + w for b in range(plan.blocks) for w in range(lpb)
              if b * lpb + w < L]
    assert placed == list(range(L))
    assert (plan.blocks - 1) * lpb < L
    # the chunks: a power of two of 32 or more, the least one that cuts the
    # key slots into at most 1,024 chunks
    slots = 9 * S + 1
    c = plan.chunk
    assert c >= 32 and c & (c - 1) == 0
    assert plan.chunks == -(-slots // c) <= 1024
    assert c == 32 or -(-slots // (c // 2)) > 1024
    # a lane's shared memory: its chunk maxima, then 24 B a position,
    # 16-byte aligned; a block's within what a block and an SM hold
    need = 8 * plan.chunks + 24 * m
    assert plan.lane_smem % 16 == 0
    assert need <= plan.lane_smem < need + 16
    assert plan.smem == lpb * plan.lane_smem
    assert plan.smem + STATIC <= SMEM_BLOCK
    assert plan.smem + STATIC + RESERVED <= SMEM_SM
    assert plan.resident == int(
        plan.blocks <= per_sm(32 * lpb, plan.smem) * SMS)


@pytest.mark.parametrize("S", STEPS)
def test_plan_every_lane_count(S):
    """L from 1 to 2,048 at each step budget."""
    per_sm = _occupancy(128)
    for L in range(1, 2049):
        _check(_plan(L, S, per_sm), L, S, per_sm)


@pytest.mark.parametrize("regs", [64, 96, 128])
@pytest.mark.parametrize("S", [512, 2048])
def test_plan_of_the_engine_tiers(S, regs):
    """The batch engine's tiers (2,048 lanes at S=2,048; the two tiers of
    `chip_smoke.py`'s path 6, 512 and 2,048 steps): 16 lanes a block, one
    block an SM, every lane resident at once."""
    per_sm = _occupancy(regs)
    plan = _plan(2048, S, per_sm)
    _check(plan, 2048, S, per_sm)
    assert (plan.lanes_per_block, plan.blocks, plan.chunk) == (16, 128, 32)
    assert plan.chunks == -(-(9 * S + 1) // 32)
    assert plan.resident == 1
    # a lane's summary and inputs: 4.6 KB + 3 KB at S=2,048
    if S == 2048:
        assert plan.lane_smem == 7696


@pytest.mark.parametrize("S,chunk", [(2, 32), (113, 32), (3640, 32),
                                     (3641, 64), (8192, 128),
                                     (32768, 512), (10**8, 2**20)])
def test_plan_chunk_grows_with_the_steps(S, chunk):
    """A lane keeps at most 1,024 chunk maxima, so the chunk width doubles
    as the store grows: 3,640 steps are the most at 32 slots a chunk."""
    per_sm = _occupancy(128)
    plan = _plan(64, S, per_sm)
    _check(plan, 64, S, per_sm)
    assert plan.chunk == chunk


def test_plan_narrows_the_block_to_its_shared_memory():
    """Long reads: fewer lanes a block where a block's shared memory
    would not hold ceil(L / SMs) lanes, and more blocks."""
    per_sm = _occupancy(64)
    for m in (512, 2048, 8192):
        plan = _plan(2048, 2048, per_sm, m)
        _check(plan, 2048, 2048, per_sm, m)
        room = SMEM_SM - STATIC - RESERVED
        assert plan.lanes_per_block == min(16, room // plan.lane_smem)
    assert _plan(2048, 2048, per_sm, 512).lanes_per_block == 13
    assert _plan(2048, 2048, per_sm, 8192).lanes_per_block == 1
    assert _plan(2048, 2048, per_sm, 8192).resident == 0


def test_plan_refusals():
    """No lane, a step budget or a read length the kernel does not take,
    a lane larger than a block's shared memory, a card that holds no
    block: each raises."""
    from mapad_tpu_torch.ops.search import batch_plan

    per_sm = _occupancy(64)
    for L, S, m in ((0, 2048, M), (-1, 2048, M), (8, 0, M),
                    (8, 2**31 // 9 + 1, M), (8, 2048, 0), (8, 2048, 0x8000),
                    (8, 2048, 0x7FFF)):
        with pytest.raises(ValueError):
            _plan(L, S, per_sm, m)
    with pytest.raises(ValueError, match="holds no block"):
        _plan(8, 2048, lambda threads, smem: 0)
    # the largest step budget and read length that still fit one lane,
    # and a read length past what a block's shared memory holds
    assert _plan(1, 2**31 // 9, per_sm).chunk == 2**21
    assert _plan(1, 2048, per_sm, 9000).lanes_per_block == 1
    with pytest.raises(ValueError, match="shared memory"):
        _plan(1, 2048, per_sm, 9500)
    with pytest.raises(ValueError, match="shared memory"):
        batch_plan(8, 2048, M, SMS, 4096, SMEM_SM, per_sm)


def _struct_fields(src, name):
    """The field names of `struct name` in a CUDA source, in order."""
    body = re.search(r"struct %s \{(.*?)\n\};" % name, src, re.S).group(1)
    body = re.sub(r"//[^\n]*", "", body)
    names = []
    for decl in body.split(";"):
        decl = decl.strip()
        if decl:
            names += [re.sub(r"^.*[\s*]", "", v.strip())
                      for v in decl.split(",")]
    return names


def _source():
    from mapad_tpu_torch import _build

    with open(os.path.join(_build.CSRC, "search_batch.cu")) as f:
        return f.read()


def test_args_mirror_the_kernel_struct():
    """`_BatchArgs` carries `struct BatchArgs`'s fields in its order, each
    a pointer where the struct has one."""
    import ctypes

    from mapad_tpu_torch.ops.search import _BatchArgs

    src = _source()
    assert [f for f, _ in _BatchArgs._fields_] == _struct_fields(
        src, "BatchArgs")
    body = re.search(r"struct BatchArgs \{(.*?)\n\};", src, re.S).group(1)
    pointers = set(re.findall(r"\*\s*(\w+);", body))
    for f, t in _BatchArgs._fields_:
        assert (t is ctypes.c_void_p) == (f in pointers), f


def test_plan_mirrors_the_kernel_struct():
    """`_BatchPlanC` carries the plan's fields in the order of `struct
    BatchPlan` in csrc/search_batch.cu, and the lane bound is the
    kernel's."""
    from mapad_tpu_torch.ops import search as srch

    src = _source()
    assert [f for f, _ in srch._BatchPlanC._fields_] == list(
        srch.BatchPlan._fields) == _struct_fields(src, "BatchPlan")
    assert (f"constexpr int MAX_LANES_PER_BLOCK = "
            f"{srch.MAX_LANES_PER_BLOCK};") in src
    # the pop loops over the chunk maxima, never over the written key
    # window [lo, ROOT]
    assert "for (int c = (lo >> csh) + t; c < NC; c += 32)" in src
    assert "for (int s = lo" not in src


def test_k10_timing_tool_raises_without_cuda(monkeypatch):
    from mapad_tpu_torch.tools import k10_time

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        k10_time.main([])


def test_k10_timing_tool_instruments_the_kernel():
    """`tools/k10_time.py --phases` finds every phase end it probes in the
    checkout's csrc/search_batch.cu, once each, and raises where one is
    gone."""
    from mapad_tpu_torch.tools import k10_time

    src = _source()
    probed = k10_time.instrument(src)
    assert probed.count("K10_PHASE(") == len(k10_time.PHASES) + 1
    with pytest.raises(ValueError, match="search_batch.cu"):
        k10_time.instrument(src.replace("best = warp_max(best);", "x"))
