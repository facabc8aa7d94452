"""Kernels K2 + K3 (pool search, chain extraction) and K5 (result pack),
plain versions, against the JAX package: `k_mismatch_search_pool2`
PoolResult field by field, `_pack_result` word for word, and the numpy
`_unpack_result` round trip."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from mapad_tpu.index.builder import build_auxiliary_structures  # noqa: E402
from mapad_tpu.ops.engine import DeviceSearchEngine  # noqa: E402
from mapad_tpu.ops.search_pool import PoolConfig as JPoolConfig  # noqa: E402
from mapad_tpu.ops.search_pool2 import k_mismatch_search_pool2 as jpool  # noqa: E402
from mapad_tpu_torch.ops import engine as teng  # noqa: E402
from mapad_tpu_torch.ops import prep as tprep  # noqa: E402
from mapad_tpu_torch.ops.fm import DeviceFmIndex  # noqa: E402
from mapad_tpu_torch.ops.search import SearchParams  # noqa: E402
from mapad_tpu_torch.ops.search_pool import PoolConfig  # noqa: E402
from mapad_tpu_torch.ops.search_pool2 import k_mismatch_search_pool2  # noqa: E402
from torch_port_helpers import (  # noqa: E402
    adna_params,
    assert_bits_equal,
    assert_pool_results_equal,
    bench_reads,
    bench_ref,
    records,
)

R = 48


@pytest.fixture(scope="module")
def bench():
    fmd, _ = build_auxiliary_structures(bench_ref(), b"ACGT")
    return fmd


def _run_both(fmd, reads, **cfg_kw):
    """Prep one invocation with the JAX engine, then run the JAX pool
    search and the port's plain K2+K3 on the same numpy inputs."""
    cfg = JPoolConfig(max_len=128, compute_forward_part=False, **cfg_kw)
    eng = DeviceSearchEngine(fmd, adna_params("mapad_tpu"), mode="pool",
                             pool_config=cfg)
    track = cfg_kw.get("track_read_steps", True)
    jcfg, prep, host_bid, _ = eng._prep_block(
        records("mapad_tpu", reads), R, cfg
    )
    assert host_bid
    jcfg = jcfg._replace(track_read_steps=track)
    jr = jpool(eng.device_index, prep["pattern_rank"], prep["pattern_code"],
               prep["n"], prep["score_lut"], prep["pen"], prep["split"],
               prep["cutoff_scale"], prep["cutoff_thresh"], prep["repr_mm"],
               eng._params(), jcfg, slut_packed=prep["slut_packed"])
    jr = jax.tree.map(np.asarray, jr)

    di = eng.device_index
    tidx = DeviceFmIndex.from_numpy(np.asarray(di.rows), np.asarray(di.less),
                                    np.asarray(di.sentinels), di.occ_k,
                                    di.text_len, device="cpu")
    tcfg = PoolConfig(
        max_len=jcfg.max_len, lanes=jcfg.lanes,
        total_steps=jcfg.total_steps, read_step_cap=jcfg.read_step_cap,
        max_chains=jcfg.max_chains, track_read_steps=track,
    )

    def t(name):
        return torch.from_numpy(np.array(prep[name]))

    tr = k_mismatch_search_pool2(
        tidx, t("n"), t("split"), t("cutoff_scale"), t("cutoff_thresh"),
        t("repr_mm"), SearchParams.from_alignment(eng.parameters, "cpu"),
        tcfg, t("slut_packed"),
    )
    return jr, tr, eng


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
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_pool_search_plain_equals_jax(bench, case):
    spec = CASES[case]
    jr, tr, eng = _run_both(bench, bench_reads(**spec["reads"]), **spec["cfg"])
    assert_pool_results_equal(jr, tr, case)
    n = int(jr.n_chains)
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
