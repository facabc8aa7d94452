"""K2's launch plan (`ops/search_pool2.py` `pool_plan`), a pure function of
the lane count, the key ring's length and the card's figures: on an H100's
figures (132 SMs, 227 KB of shared memory a block, 228 KB an SM) and with
given blocks-per-SM figures, for every pool config the engine builds and
for L from 1 to 1024.  Every lane is placed exactly once, the grid fits
what the card holds at once, the key rings live in shared memory exactly
where they fit, and a block's shared memory stays within the limits."""

import pytest

torch = pytest.importorskip("torch")

from torch_port_helpers import adna_params, bench_ref  # noqa: E402

SMS = 132
SMEM_BLOCK = 232448  # 227 KB: what a block may opt into
SMEM_SM = 233472     # 228 KB an SM
STATIC = 144         # the kernel's own shared memory (the refill's counts)
RESERVED = 1024      # the runtime's reserve a block


def _occupancy(regs):
    """Blocks an SM holds at once, as the occupancy query counts them, for
    a kernel of `regs` registers a thread."""
    def per_sm(threads, smem):
        by_smem = SMEM_SM // (smem + STATIC + RESERVED)
        return min(32, 2048 // threads, 65536 // (threads * regs), by_smem)
    return per_sm


OCCUPANCY = {
    "regs64": _occupancy(64),
    "regs128": _occupancy(128),
    "one": lambda threads, smem: 1,
    "two": lambda threads, smem: 2,
}


def _plan(L, RB, per_sm):
    from mapad_tpu_torch.ops.search_pool2 import pool_plan

    return pool_plan(L, RB, SMS, SMEM_BLOCK, SMEM_SM, per_sm, STATIC,
                     RESERVED)


def _ring_fits(L, RB):
    from mapad_tpu_torch.ops.search_pool2 import STAGE_BYTES

    lpb = -(-L // SMS)
    need = lpb * (RB * 4 + STAGE_BYTES) + STATIC
    return need <= SMEM_BLOCK and need + RESERVED <= SMEM_SM


def _check(plan, L, RB, per_sm):
    """The plan's invariants for L lanes and rings of RB slots."""
    from mapad_tpu_torch.ops.search_pool2 import (
        MAX_LANES_PER_BLOCK,
        STAGE_BYTES,
    )

    lpb = plan.lanes_per_block
    assert 1 <= lpb <= MAX_LANES_PER_BLOCK
    # every lane exactly once, and no block without a lane
    placed = [b * lpb + w for b in range(plan.blocks) for w in range(lpb)
              if b * lpb + w < L]
    assert placed == list(range(L))
    assert (plan.blocks - 1) * lpb < L
    # the whole grid is co-resident
    threads = 32 * lpb
    assert plan.blocks <= per_sm(threads, plan.smem) * SMS
    # shared memory: each lane's staging, and its ring where it lives there
    assert plan.smem == lpb * (STAGE_BYTES + (RB * 4 if plan.ring_shared
                                              else 0))
    assert plan.smem + STATIC <= SMEM_BLOCK
    assert plan.smem + STATIC + RESERVED <= SMEM_SM


def _engine_configs(monkeypatch):
    """The pool configs the engine builds: the primary, the full-width deep
    tier and the deep tier narrowed by MAPAD_DEEP_LANES."""
    from mapad_tpu_torch.index.builder import build_auxiliary_structures
    from mapad_tpu_torch.ops.engine import DeviceSearchEngine

    fmd = build_auxiliary_structures(bench_ref(), b"ACGT")[0]
    eng = DeviceSearchEngine(fmd, adna_params("mapad_tpu_torch"),
                             device="cpu")
    out = {"primary": eng.pool_config, "deep": eng._deep_config()}
    for lanes in (128, 32, 16):
        monkeypatch.setenv("MAPAD_DEEP_LANES", str(lanes))
        out[f"deep{lanes}"] = eng._deep_config()
    return out


# (lanes, ring slots, rings in shared memory) of each engine config
ENGINE = {
    "primary": (512, 3073, True),
    "deep": (512, 8192, True),
    "deep128": (128, 12289, True),
    "deep32": (32, 49153, True),
    "deep16": (16, 98305, False),
}


def test_engine_configs_are_the_planned_shapes(monkeypatch):
    cfgs = _engine_configs(monkeypatch)
    for name, (lanes, rb, _shared) in ENGINE.items():
        cfg = cfgs[name]
        assert (cfg.lanes, min(cfg.total_steps, cfg.read_step_cap + 1)) == (
            lanes, rb), name


@pytest.mark.parametrize("occupancy", sorted(OCCUPANCY))
@pytest.mark.parametrize("name", sorted(ENGINE))
def test_plan_of_engine_config(name, occupancy):
    L, RB, shared = ENGINE[name]
    per_sm = OCCUPANCY[occupancy]
    plan = _plan(L, RB, per_sm)
    _check(plan, L, RB, per_sm)
    assert plan.ring_shared == shared
    # one block an SM: ceil(L / SMs) lanes a block
    assert plan.lanes_per_block == -(-L // SMS)


# the pool configs of tests/test_torch_cuda.py (CASES, GEN_CASES, the
# bidirectional and the new shapes): (lanes, total steps, per-read cap)
TEST_SHAPES = [
    (8, 2048, 2048), (8, 2048, 64), (8, 96, 64), (64, 512, 300),
    (8, 640, 512), (8, 448, 160), (40, 132, 128), (8, 3072, 512),
    (8, 320, 256), (512, 3200, 3072), (1024, 512, 300), (1, 2048, 512),
    (40, 1024, 256), (13, 1024, 256), (64, 8192, 8191),
    (8, 60000, 59999),
]


@pytest.mark.parametrize("shape", TEST_SHAPES)
def test_plan_of_test_shapes(shape):
    L, S, cap = shape
    RB = min(S, cap + 1)
    per_sm = OCCUPANCY["regs128"]
    plan = _plan(L, RB, per_sm)
    _check(plan, L, RB, per_sm)
    assert plan.ring_shared == _ring_fits(L, RB)


@pytest.mark.parametrize("RB", [3073, 8192, 12289, 49153])
def test_plan_every_lane_count(RB):
    """L from 1 to 1024 at the rings of the engine's configs."""
    per_sm = OCCUPANCY["regs64"]
    for L in range(1, 1025):
        plan = _plan(L, RB, per_sm)
        _check(plan, L, RB, per_sm)
        assert plan.ring_shared == _ring_fits(L, RB), (L, RB)


def test_plan_ring_home_follows_the_occupancy():
    """Where the card holds no block with the rings in shared memory, they
    stay in global memory; where it holds none at all, the plan raises."""
    big_smem = lambda threads, smem: 0 if smem > 100_000 else 1  # noqa: E731
    plan = _plan(512, 8192, big_smem)
    _check(plan, 512, 8192, big_smem)
    assert not plan.ring_shared
    assert _plan(512, 3073, big_smem).ring_shared
    with pytest.raises(ValueError):
        _plan(512, 3073, lambda threads, smem: 0)


def test_plan_refuses_what_no_grid_holds():
    with pytest.raises(ValueError):
        _plan(0, 3073, OCCUPANCY["one"])
    with pytest.raises(ValueError):
        _plan(1025, 3073, OCCUPANCY["one"])
    from mapad_tpu_torch.ops.search_pool2 import pool_plan

    # 16 lanes a block at most: 1,024 lanes need 64 SMs
    with pytest.raises(ValueError):
        pool_plan(1024, 3073, 63, SMEM_BLOCK, SMEM_SM, OCCUPANCY["one"])
    assert pool_plan(1024, 3073, 64, SMEM_BLOCK, SMEM_SM,
                     OCCUPANCY["one"]).lanes_per_block == 16


def test_plan_mirrors_the_kernel_struct():
    """`_PoolPlanC` carries the plan's fields in the order of `struct
    PoolPlan` in csrc/pool_search.cu."""
    import os

    from mapad_tpu_torch.ops import search_pool2 as sp2

    assert [f for f, _ in sp2._PoolPlanC._fields_] == list(
        sp2.PoolPlan._fields)
    src = open(os.path.join(os.path.dirname(sp2.__file__), "..", "csrc",
                            "pool_search.cu")).read()
    assert "int lanes_per_block, blocks, ring_shared, smem;" in src
    assert (f"constexpr int MAX_LANES_PER_BLOCK = "
            f"{sp2.MAX_LANES_PER_BLOCK};") in src
    assert sp2.STAGE_BYTES == 2 * 9 * 11 * 4


def test_k2_phase_profiler_instruments_the_kernel():
    """`tools/k2_phases.py` finds every phase end it probes in the
    checkout's csrc/pool_search.cu, once each."""
    import os

    from mapad_tpu_torch import _build
    from mapad_tpu_torch.tools import k2_phases

    with open(os.path.join(_build.CSRC, "pool_search.cu")) as f:
        src = k2_phases.instrument(f.read())
    assert src.count("K2_PHASE(") == len(k2_phases.PHASES) + 1
    with pytest.raises(ValueError):
        k2_phases.instrument(src.replace("__all_sync", "x").replace(
            "const bool popped", "bool popped"))


def test_k2_phase_profiler_raises_without_cuda(monkeypatch):
    from mapad_tpu_torch.tools import k2_phases

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        k2_phases.main([])
