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


def _run_both(fmd, reads, big=False, dense=False, **cfg_kw):
    """Prep one invocation with the JAX engine, then run the JAX pool
    search and the port's plain K2+K3 on the same numpy inputs: the
    host-packed LUT/Bi-D rows, or (`dense`, the default of `big`) the dense
    per-read arrays from which both compute the Bi-D themselves."""
    cfg = JPoolConfig(max_len=128, compute_forward_part=False, **cfg_kw)
    eng = DeviceSearchEngine(fmd, adna_params("mapad_tpu"), mode="pool",
                             pool_config=cfg, big=big)
    track = cfg_kw.get("track_read_steps", True)
    jcfg, prep, host_bid, _ = eng._prep_block(
        records("mapad_tpu", reads), R, cfg
    )
    assert host_bid == (not dense)
    jcfg = jcfg._replace(track_read_steps=track)
    kw = {"slut_packed": prep["slut_packed"]} if host_bid else {}
    jr = jpool(eng.device_index, prep["pattern_rank"], prep["pattern_code"],
               prep["n"], prep["score_lut"], prep["pen"], prep["split"],
               prep["cutoff_scale"], prep["cutoff_thresh"], prep["repr_mm"],
               eng._params(), jcfg, **kw)
    jr = jax.tree.map(np.asarray, jr)

    di = eng.device_index
    assert bool(di.big) == big
    tidx = DeviceFmIndex.from_numpy(np.asarray(di.rows), np.asarray(di.less),
                                    np.asarray(di.sentinels), di.occ_k,
                                    di.text_len, big, device="cpu")
    tcfg = PoolConfig(
        max_len=jcfg.max_len, lanes=jcfg.lanes,
        total_steps=jcfg.total_steps, read_step_cap=jcfg.read_step_cap,
        max_chains=jcfg.max_chains, track_read_steps=track,
    )

    def t(name):
        return torch.from_numpy(np.array(prep[name]))

    tkw = (dict(slut=t("slut_packed")) if host_bid else
           dict(dense=(t("pattern_rank").to(torch.int32), t("pattern_code"),
                       t("score_lut"), t("pen"))))
    tr = k_mismatch_search_pool2(
        tidx, t("n"), t("split"), t("cutoff_scale"), t("cutoff_thresh"),
        t("repr_mm"), SearchParams.from_alignment(eng.parameters, "cpu"),
        tcfg, **tkw,
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


def _check_case(bench, case, **mode):
    spec = CASES[case]
    jr, tr, eng = _run_both(bench, bench_reads(**spec["reads"]), **mode,
                            **spec["cfg"])
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
