"""Kernels K2 + K3 (pool search, chain extraction) and K5 (result pack),
plain versions, against the JAX package: `k_mismatch_search_pool2`
PoolResult field by field, `_pack_result` word for word, and the numpy
`_unpack_result` round trip; with the host-packed LUT/Bi-D rows and int32
intervals, and with the dense inputs (Bi-D on the device, K7) and the
int64 intervals of big mode."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from mapad_tpu.index.builder import build_auxiliary_structures  # noqa: E402
from mapad_tpu.ops.engine import DeviceSearchEngine  # noqa: E402
from mapad_tpu_torch.ops import engine as teng  # noqa: E402
from mapad_tpu_torch.ops import prep as tprep  # noqa: E402
from torch_port_helpers import (  # noqa: E402
    assert_bits_equal,
    assert_pool_results_equal,
    bench_reads,
    bench_ref,
    run_pool_both,
)

R = 48


@pytest.fixture(scope="module")
def bench():
    fmd, _ = build_auxiliary_structures(bench_ref(), b"ACGT")
    return fmd


CASES = {
    # bench + random + exogenous reads, every read finishes
    "bench": dict(reads=dict(), cfg=dict(lanes=8, total_steps=2048,
                                         read_step_cap=2048, max_chains=512)),
    # per-read cap 64: abandon markers
    "abandon": dict(reads=dict(seed=5), cfg=dict(lanes=8, total_steps=2048,
                                                  read_step_cap=64,
                                                  max_chains=512)),
    # more chains than the log holds, step tracking off
    "overflow": dict(reads=dict(seed=6), cfg=dict(
        lanes=8, total_steps=2048, read_step_cap=2048, max_chains=16,
        track_read_steps=False)),
    # a step budget too small for the block: unfinished and undispatched
    "budget": dict(reads=dict(seed=7), cfg=dict(lanes=8, total_steps=96,
                                                read_step_cap=64,
                                                max_chains=512)),
    # exogenous reads only: no block marked anywhere, the unused entries
    # copy lane 0's slot 0 (an unwritten block: zeros)
    "no_marks": dict(reads="exogenous", cfg=dict(
        lanes=8, total_steps=2048, read_step_cap=2048, max_chains=64)),
    # the same with the store full: slot 0 is written
    "no_marks_full": dict(reads="exogenous", cfg=dict(
        lanes=8, total_steps=10, read_step_cap=10, max_chains=64)),
}


def _exogenous_reads(n=R, seed=11):
    """Random reads of 30-80 bases: none maps, none reaches the cap."""
    rng = np.random.default_rng(seed)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    return [bytes(rng.choice(bases, size=int(rng.integers(30, 80))))
            for _ in range(n)]


def _check_case(bench, case, **mode):
    spec = CASES[case]
    reads = (_exogenous_reads() if spec["reads"] == "exogenous"
             else bench_reads(**spec["reads"]))
    jr, tr, eng = run_pool_both(bench, reads, R, **mode, **spec["cfg"])
    assert_pool_results_equal(jr, tr, case)
    n = int(jr.n_chains)
    if case.startswith("no_marks"):
        assert n == 0
        full = int(jr.steps) == spec["cfg"]["total_steps"]
        assert full == (case == "no_marks_full")
    if case == "abandon":
        assert jr.c_abandon[: min(n, jr.c_read.shape[0])].any()
    if case == "overflow":
        assert n > jr.c_read.shape[0]
    if case == "budget":
        assert jr.lane_unfinished.any() and int(jr.next_read) < R

    # K5: the plain pack equals the JAX pack word for word, and the numpy
    # reader restores every field
    want = np.asarray(DeviceSearchEngine._pack_result(
        jax.tree.map(jnp.asarray, jr)
    ))
    got = teng._pack_result(tr).numpy()
    assert_bits_equal(want, got, "packed")
    back = tprep._unpack_result(teng._result_spec(tr), got)
    wire = jr._replace(c_ops=jr.c_ops & 0x1FFFFF)
    for name in jr._fields:
        assert_bits_equal(np.asarray(getattr(wire, name)),
                          np.asarray(getattr(back, name)), name)
    return jr, tr


@pytest.mark.parametrize("case", sorted(CASES))
def test_pool_search_plain_equals_jax(bench, case):
    _check_case(bench, case)


@pytest.mark.parametrize("case", sorted(CASES))
def test_pool_search_dense_big_equals_jax(bench, case):
    """Big mode: dense inputs (the Bi-D and the LUT/Bi-D rows made on the
    device) and int64 intervals; `c_lower`, `c_lrev`, `c_size` are int64
    and travel through the pack as int32 pairs."""
    jr, tr = _check_case(bench, case, big=True, dense=True)
    for name in ("c_lower", "c_lrev", "c_size"):
        assert getattr(tr, name).dtype == torch.int64
        assert np.asarray(getattr(jr, name)).dtype == np.int64


def test_pool_search_dense_small_equals_jax(bench, monkeypatch):
    """MAPAD_HOST_BID=0 on a small index: the dense entry with int32
    intervals."""
    monkeypatch.setenv("MAPAD_HOST_BID", "0")
    _jr, tr = _check_case(bench, "bench", dense=True)
    assert tr.c_lower.dtype == torch.int32


# --- the bidirectional search of center-start models ----------------------


def _center_params(model):
    """Alignment parameters around a model whose alignment starts in the
    middle of the read, from either package's classes."""

    def make(pkg):
        models = __import__(f"{pkg}.models", fromlist=["x"])
        mapping = __import__(f"{pkg}.map", fromlist=["x"])
        if model == "test":
            dm = models.TestDifferenceModel(deam_score=-0.5, mm_score=-1.0,
                                            match_score=0.0)
            return mapping.AlignmentParameters(
                difference_model=dm,
                mismatch_bound=models.TestBound(threshold=-2.0,
                                                representative_mm_bound=-1.0),
                penalty_gap_open=-2.0, penalty_gap_extend=-1.0, chunk_size=1,
                gap_dist_ends=0, stack_limit_abort=False,
                max_num_gaps_open=2,
            )
        dm = models.VindijaPwm()
        repr_mm = dm.get_representative_mismatch_penalty()
        return mapping.AlignmentParameters(
            difference_model=dm,
            mismatch_bound=models.Discrete(0.01, 0.02, repr_mm),
            penalty_gap_open=np.float32(3.0) * repr_mm,
            penalty_gap_extend=np.float32(0.6) * repr_mm, chunk_size=1,
            gap_dist_ends=5, stack_limit_abort=False, max_num_gaps_open=2,
        )

    return make


@pytest.mark.parametrize("big", [False, True])
@pytest.mark.parametrize("model", ["test", "vindija"])
def test_pool_search_bidirectional_equals_jax(bench, model, big):
    """`backward_only=False`: the extension direction is chosen per step,
    the Bi-D bound comes from both read halves (`compute_forward_part`)."""
    reads = bench_reads(seed=17, n_random=30, n_exo=4)[:R]
    jr, tr, eng = run_pool_both(
        bench, reads, R, big=big, dense=big, params_of=_center_params(model),
        qual=0 if model == "test" else 40, lanes=8, total_steps=3072,
        read_step_cap=512, max_chains=512,
    )
    assert not eng.pool_config.backward_only
    assert_pool_results_equal(jr, tr, (model, big))
    n = min(int(jr.n_chains), 512)
    assert (~jr.c_abandon[:n]).sum() > R // 4  # real hits were compared
    # both directions ran: an op left of a read's start and one right of it
    pos = (jr.c_ops[:n] >> 2) & 0x7FFF
    valid = jr.c_ops[:n] != 0
    assert (pos[valid] < 10).any() and (pos[valid] > 10).any()
