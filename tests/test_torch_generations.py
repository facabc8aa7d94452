"""Store generations of the pool search (kernel K8 and the loop over the
generations, plain versions) against the JAX package: `k_mismatch_search_pool2`
with `generations` > 1, every PoolResult field equal, padding entries
included; with source and destination of the store move overlapping
(cap > steps / 2) and not, an uncapped and a capped spill, int32 and int64
intervals."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from mapad_tpu.index.builder import build_auxiliary_structures  # noqa: E402
from torch_port_helpers import (  # noqa: E402
    assert_pool_results_equal,
    bench_reads,
    bench_ref,
    run_pool_both,
)

R = 96
# the starved shape of tests/test_device_search.py: 8 lanes x 640 steps
# cannot finish the block in one store generation; cap 512 > 640 / 2, so
# the moved window overlaps its old place
STARVED = dict(lanes=8, total_steps=640, read_step_cap=512, max_chains=1024,
               min_live=1)
# cap 160 < 448 / 2: no overlap, one move
NO_OVERLAP = dict(lanes=8, total_steps=448, read_step_cap=160,
                  max_chains=1024, min_live=1)


@pytest.fixture(scope="module")
def bench():
    return build_auxiliary_structures(bench_ref(), b"ACGT")[0]


def _reads():
    reads = bench_reads(seed=31, n_random=40, n_exo=0)
    return (reads * 2)[:R]


@pytest.mark.parametrize("big", [False, True])
@pytest.mark.parametrize("spill", [0, 96])
@pytest.mark.parametrize("gens", [1, 4])
def test_generations_equal_jax(bench, gens, spill, big):
    jr, tr, _eng = run_pool_both(
        bench, _reads(), R, big=big, dense=big, generations=gens,
        spill_steps=spill, **STARVED,
    )
    assert_pool_results_equal(jr, tr, (gens, spill, big))
    if gens == 1:
        assert int(jr.steps) == STARVED["total_steps"]
        assert jr.lane_unfinished.any() or int(jr.next_read) < R
    else:
        # at least one boundary fired: more steps ran than the store holds
        assert int(tr.steps) > STARVED["total_steps"]
        # chains of later generations have slots below those of earlier
        # ones: global completion order
        assert int(tr.c_slot.min()) < 0
    if gens == 4 and spill == 0:
        assert int(tr.steps) > 2 * STARVED["total_steps"] - 512, "2 boundaries"


@pytest.mark.parametrize("big", [False, True])
def test_generations_no_overlap_equal_jax(bench, big):
    jr, tr, _eng = run_pool_both(
        bench, _reads(), R, big=big, dense=big, generations=4,
        **NO_OVERLAP,
    )
    assert_pool_results_equal(jr, tr, big)
    assert int(tr.steps) > NO_OVERLAP["total_steps"]


def test_generations_chain_log_clamps_at_capacity(bench):
    """More chains than the log holds, over several generations: the append
    offset clamps at C, `n_chains` keeps counting."""
    jr, tr, _eng = run_pool_both(
        bench, _reads(), R, generations=4,
        **dict(STARVED, max_chains=24),
    )
    assert_pool_results_equal(jr, tr)
    assert int(tr.n_chains) > 24 and int(tr.steps) > STARVED["total_steps"]


def test_generations_noop_when_budget_suffices(bench):
    """With a budget that finishes the block in the first generation no
    boundary fires and the result equals one generation's."""
    cfg = dict(lanes=16, total_steps=4096, read_step_cap=2048,
               max_chains=512)
    reads = bench_reads(seed=31, n_random=10, n_exo=2)[:48]
    jr3, tr3, _ = run_pool_both(bench, reads, 48, generations=3, **cfg)
    _jr1, tr1, _ = run_pool_both(bench, reads, 48, generations=1, **cfg)
    assert_pool_results_equal(jr3, tr3)
    assert int(tr3.steps) < 4096
    for name in tr1._fields:
        assert torch.equal(getattr(tr1, name), getattr(tr3, name)), name


def test_generations_need_margin(bench):
    from mapad_tpu_torch.ops.search_pool import PoolConfig
    from mapad_tpu_torch.ops.search_pool2 import _check_config

    with pytest.raises(ValueError, match="read_step_cap \\+ 4"):
        _check_config(PoolConfig(total_steps=640, read_step_cap=638,
                                 generations=2), 8)
