"""The port's engines against the JAX package's under mapAD's other `map`
settings (mapad_tpu_torch/tools/configs.py), on reads with deletions and
insertions: the pool engine in big mode (int64 intervals, K6 and K7, the
deep tier), the fixed-batch engine (K10) and the hybrid engine's
`search_chunk`; two engines of one process whose settings differ in the
score table's inputs only; the settings as both CLIs parse them; and the
smoke's read generator (tools/assembly.py `make_reads`) with its new
library and indel rate, its default output pinned."""

import hashlib
from concurrent.futures import Future

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from mapad_tpu.index.builder import build_auxiliary_structures  # noqa: E402
from mapad_tpu.ops.engine import DeviceSearchEngine as JEngine  # noqa: E402
from mapad_tpu.ops.engine import HybridSearchEngine as JHybrid  # noqa: E402
from mapad_tpu.ops.search_pool import PoolConfig as JPoolConfig  # noqa: E402
from mapad_tpu_torch.index.builder import (  # noqa: E402
    build_auxiliary_structures as t_build,
)
from mapad_tpu_torch.ops import prep as tprep  # noqa: E402
from mapad_tpu_torch.ops.engine import DeviceSearchEngine as TEngine  # noqa: E402
from mapad_tpu_torch.ops.engine import HybridSearchEngine as THybrid  # noqa: E402
from mapad_tpu_torch.ops.search_pool import PoolConfig as TPoolConfig  # noqa: E402
from mapad_tpu_torch.tools import configs  # noqa: E402
from test_device_configs import _reads  # noqa: E402
from test_torch_engine import _assert_same_run  # noqa: E402
from torch_port_helpers import (  # noqa: E402
    assert_pool_results_equal,
    bench_ref,
    config_params,
    hits_equal,
    packed_equal,
    records,
    run_pool_both,
)
from torch_port_helpers import unsharded_env  # noqa: E402,F401


@pytest.fixture(scope="module")
def indexes():
    ref = bench_ref()
    return build_auxiliary_structures(ref, b"ACGT")[0], t_build(ref, b"ACGT")[0]


def _params(name):
    return (lambda pkg: config_params(pkg, name))


# --- big mode --------------------------------------------------------------

BIG_CFG = dict(max_len=128, lanes=8, total_steps=1024, read_step_cap=256,
               max_chains=256)


@pytest.mark.parametrize("name,seed", [("cutoff", 21), ("gaps_0_1", 22)])
def test_big_engine_under_a_setting_equals_jax(indexes, name, seed,
                                               monkeypatch):
    """One invocation of the plain int64 kernels (K6's dense inputs, K7,
    K2, K3) against the JAX pool search, every PoolResult field bit for
    bit; then big=True at its defaults (the Bi-D on the device, the deep
    tier on): the same escalations by cause, tier counters and steps,
    every read's hits bit for bit."""
    for var in ("MAPAD_DEEP_TIER", "MAPAD_HOST_BID", "MAPAD_RETRY_TIER"):
        monkeypatch.delenv(var, raising=False)
    jfmd, tfmd = indexes
    params_of = _params(name)
    reads = _reads(bench_ref(), 8, seed)
    jr, tr, _eng = run_pool_both(
        jfmd, reads, len(reads), big=True, dense=True, params_of=params_of,
        compute_forward_part=False,
        **{k: v for k, v in BIG_CFG.items() if k != "max_len"})
    assert_pool_results_equal(jr, tr, name)
    assert tr.c_lower.dtype == torch.int64
    je = JEngine(jfmd, params_of("mapad_tpu"), mode="pool",
                 pool_config=JPoolConfig(compute_forward_part=False,
                                         **BIG_CFG),
                 packed_hits=True, big=True)
    te = TEngine(tfmd, params_of("mapad_tpu_torch"),
                 pool_config=TPoolConfig(**BIG_CFG), packed_hits=True,
                 big=True, device="cpu")
    assert te.device_index.big and not te._host_bid_active()
    _esc, hits = _assert_same_run(je, te, reads, 8, True)
    assert any(len(h) for h in hits)


# --- the fixed-batch engine (K10) ------------------------------------------


@pytest.mark.parametrize("name,seed", [("cutoff", 31), ("gaps_0_1", 32),
                                       ("no_gaps", 33)])
def test_batch_engine_under_a_setting_equals_jax(indexes, name, seed):
    """Two tiers: the first (64 steps) passes most reads to the second,
    whose escalatees go to the host searcher."""
    jfmd, tfmd = indexes
    params_of = _params(name)
    kw = dict(mode="batch", lanes=16, tiers=((64, None), (1024, 8)),
              packed_hits=True)
    je = JEngine(jfmd, params_of("mapad_tpu"), **kw)
    te = TEngine(tfmd, params_of("mapad_tpu_torch"), device="cpu", **kw)
    reads = _reads(bench_ref(), 16, seed)
    want = je.search_chunk(records("mapad_tpu", reads))
    got = te.search_chunk(records("mapad_tpu_torch", reads))
    assert len(got) == len(reads)
    assert all(packed_equal(a[0], b[0]) for a, b in zip(got, want))
    for k in ("device_lanes", "escalated", "batches", "oracle"):
        assert te._stats[k] == je._stats[k], k
    assert sum(len(h) > 0 for h, _ in got) > len(reads) // 4


# --- the hybrid engine -----------------------------------------------------

HYB_CFG = dict(max_len=128, lanes=16, total_steps=2048, read_step_cap=1024,
               max_chains=1024)


def _resolve(out):
    return [(o.result() if isinstance(o, Future) else o)[0] for o in out]


@pytest.mark.parametrize("name,seed", [("ds", 41), ("cutoff", 42)])
def test_hybrid_under_a_setting_equals_jax(indexes, name, seed):
    """260 reads (a chunk above 256 is split): the head of 13 on the
    device, the tail on the host searcher, decoded hits equal."""
    jfmd, tfmd = indexes
    params_of = _params(name)
    kw = dict(threads=2, mode="pool", device_fraction=0.05)
    je = JHybrid(jfmd, params_of("mapad_tpu"),
                 pool_config=JPoolConfig(compute_forward_part=False,
                                         **HYB_CFG), **kw)
    te = THybrid(tfmd, params_of("mapad_tpu_torch"),
                 pool_config=TPoolConfig(**HYB_CFG), device="cpu", **kw)
    reads = _reads(bench_ref(), 260, seed)
    want = _resolve(je.search_chunk(records("mapad_tpu", reads)))
    got = _resolve(te.search_chunk(records("mapad_tpu_torch", reads)))
    assert len(got) == len(reads)
    assert all(hits_equal(a, b) for a, b in zip(got, want))
    assert te._stats["hybrid_device_reads"] == 13
    assert te._stats["device_lanes"] == je._stats["device_lanes"] == 13
    assert sum(len(h) > 0 for h in got) > len(reads) // 4


# --- two engines in one process --------------------------------------------

PAIRS = {
    "library": ("base", "ds", None),
    "ignore_base_quality": ("base", "ibq", None),
    "gap_extension": ("base", "base", {"-x": "0.5"}),
}
ONE_CFG = dict(max_len=128, lanes=16, total_steps=2048, read_step_cap=512,
               max_chains=512)


def _engine_hits(tfmd, params, reads, big=False):
    eng = TEngine(tfmd, params, pool_config=TPoolConfig(**ONE_CFG),
                  packed_hits=True, big=big, device="cpu")
    eng.block_reads = len(reads)
    out = eng.search_chunk(records("mapad_tpu_torch", reads))
    return eng, [h for h, _ in out]


@pytest.mark.parametrize("pair,big", [(p, False) for p in sorted(PAIRS)]
                         + [("gap_extension", True)])
def test_engines_that_differ_in_the_table_share_none(indexes, pair, big):
    """Two engines whose settings differ only in the library, only in
    ignore_base_quality or only in `-x` (the device score table's inputs;
    `-x` reaches the card in big mode only, through K6's penalty column),
    built one after the other in one process: each one's hits equal those
    of the same engine built after the table's memo is cleared, and their
    tables differ."""
    tfmd = indexes[1]
    first, second, changes = PAIRS[pair]
    pa = config_params("mapad_tpu_torch", first)
    pb = config_params("mapad_tpu_torch", second, changes)
    reads = _reads(bench_ref(), 8, 50)
    ea, hits_a = _engine_hits(tfmd, pa, reads, big)
    eb, hits_b = _engine_hits(tfmd, pb, reads, big)
    ta, tb = ea._device_lut(), eb._device_lut()
    assert any(x.shape != y.shape or not torch.equal(x, y)
               for x, y in zip(ta, tb)), pair
    for params, hits in ((pb, hits_b), (pa, hits_a)):
        tprep._DEV_LUT_MEMO.clear()
        _eng, again = _engine_hits(tfmd, params, reads, big)
        assert all(packed_equal(a, b) for a, b in zip(hits, again)), pair
    assert any(len(h) for h in hits_a)


# --- the settings as both CLIs parse them ----------------------------------


@pytest.mark.parametrize("name", sorted(configs.SETTINGS))
def test_both_clis_build_the_same_parameters(name):
    a = config_params("mapad_tpu", name)
    b = config_params("mapad_tpu_torch", name)
    for field in ("penalty_gap_open", "penalty_gap_extend", "chunk_size",
                  "gap_dist_ends", "stack_limit_abort", "max_num_gaps_open"):
        assert repr(getattr(a, field)) == repr(getattr(b, field)), field
    for part in ("difference_model", "mismatch_bound"):
        x, y = getattr(a, part), getattr(b, part)
        assert type(x).__name__ == type(y).__name__, part
        assert sorted(vars(x)) == sorted(vars(y)), part
        for k, v in vars(x).items():
            w = vars(y)[k]
            assert repr(np.asarray(v).tolist()) == repr(
                np.asarray(w).tolist()), (part, k)
    what = {"ds": ("library_prep", ("double_stranded", np.float32(0.475))),
            "ibq": ("use_default_base_quality", None)}
    if name in what:
        k, v = what[name]
        got = vars(b.difference_model)[k]
        assert (got is not None) if v is None else got == v
    if name == "cutoff":
        assert type(b.mismatch_bound).__name__ == "Continuous"
    if name.startswith("gaps") or name == "no_gaps":
        assert (b.gap_dist_ends, b.max_num_gaps_open) == {
            "gaps_0_1": (0, 1), "gaps_10_3": (10, 3),
            "no_gaps": (5, 0)}[name]
    assert b.stack_limit_abort == (name == "abort")


def test_setting_flags():
    base = configs.flags("base")
    assert base == configs.BASE_FLAGS
    cut = configs.flags("cutoff")
    assert "-p" not in cut and cut[cut.index("-c") + 1] == "0.15"
    assert configs.flags("ibq") == base + ["--ignore_base_quality"]
    smoke = base + ["--lanes", "8"]
    assert configs.flags("no_gaps", smoke) == smoke + [
        "--max_num_gaps_open", "0"]


# --- the smoke's reads ----------------------------------------------------


def _digest(reads):
    h = hashlib.sha256()
    for s, q in reads:
        h.update(s + b"|" + q + b"\n")
    return h.hexdigest()


def test_make_reads_defaults_are_the_earlier_reads():
    """The defaults draw the reads they drew before the library and the
    indel rate were added (digests of the earlier generator's output), so
    every earlier path of the smoke maps the same reads."""
    from mapad_tpu_torch.tools.assembly import gen_genome, make_reads

    g = gen_genome(200_000, 5)
    assert _digest(make_reads(g, 400, 107)) == (
        "83d40aae3e8f875240d58b0ec1077c2cf02e416099db3c734c870e2c3fc9b3d0")
    assert _digest(make_reads(g, 64, 9, starts=np.arange(64) * 1000)) == (
        "0763fbd7b92497afd3a2ae35e127a9015ac35989d6b6162787c1f782af36fe70")


def test_make_reads_library_and_indels():
    """A double-stranded read: C->T at its 5' end and G->A at its 3' end;
    a single-stranded one C->T at both ends and no G->A beyond the
    sequencing errors.  An indel rate changes reads' lengths by whole
    bases, away from the ends."""
    from mapad_tpu_torch.tools.assembly import (
        INDEL_MARGIN,
        gen_genome,
        make_reads,
    )
    from mapad_tpu_torch.utils.seq import revcomp

    g = gen_genome(100_000, 6)
    n = 3000
    starts = np.random.default_rng(1).integers(0, len(g) - 128, size=n)

    def changes(library):
        """Per read end (first / last 3 bases, in the fragment's
        orientation): C->T and G->A counts against the genome."""
        out = np.zeros((2, 2), int)
        for (seq, _q), st in zip(make_reads(g, n, 8, starts, library), starts):
            ref = g[st : st + len(seq)].tobytes()
            for read in (seq, revcomp(seq)):
                if sum(a != b for a, b in zip(read, ref)) <= len(seq) // 4:
                    break
            else:
                continue  # exogenous
            for end, cols in ((0, range(3)), (1, range(len(seq) - 3,
                                                       len(seq)))):
                for j in cols:
                    out[end, 0] += ref[j] == ord("C") and read[j] == ord("T")
                    out[end, 1] += ref[j] == ord("G") and read[j] == ord("A")
        return out

    ss, ds = changes("single_stranded"), changes("double_stranded")
    assert ss[0, 0] > 100 and ss[1, 0] > 100
    assert ss[0, 1] < 20 and ss[1, 1] < 20
    assert ds[0, 0] > 100 and ds[1, 1] > 100
    assert ds[1, 0] < ds[0, 0] // 4 and ds[0, 1] < ds[1, 1] // 4

    plain = make_reads(g, n, 8, starts)
    with_indels = make_reads(g, n, 8, starts, indel_rate=0.01)
    lens = np.array([len(s) for s, _q in with_indels])
    assert all(len(q) == len(s) for s, q in with_indels)
    assert (lens != [len(s) for s, _q in plain]).sum() > n // 4
    assert lens.max() <= 120 + 4 and lens.min() >= 35 - 4
    # an indel keeps the read's first and last INDEL_MARGIN bases
    kept = 0
    for (seq, _q), st in zip(with_indels, starts):
        ref = g[st : st + 140].tobytes()
        for read in (seq, revcomp(seq)):
            if read[:INDEL_MARGIN] == ref[:INDEL_MARGIN]:
                kept += 1
                break
    assert kept > n // 2
