"""Shared inputs of the tests that hold mapad_tpu_torch against mapad_tpu.

Both packages get the same inputs, made with numpy from a seed; the JAX
side runs on the CPU as the JAX package's own tests run it.  Every
comparison is bit-exact (f32 compared by its bits).
"""

from __future__ import annotations

import os
import re

import numpy as np
import pytest
import torch

# the plain kernels run thousands of tiny tensor ops; one intra-op thread
# per test worker keeps them from spinning against the other workers
torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))


@pytest.fixture(scope="module", autouse=True)
def unsharded_env():
    """MAPAD_SHARD and MAPAD_BLOCK_READS unset for a whole module (its
    module fixtures too).  mapad_tpu's multi-chip dry run
    (`__graft_entry__.dryrun_multichip`, run by tests/test_multichip.py)
    sets MAPAD_SHARD=1 and MAPAD_BLOCK_READS=1024 for the rest of its
    process, and with them mapad_tpu's engine shards every block over the
    8 virtual devices.  A module that compares unsharded engines imports
    this fixture; a test that wants a mesh sets the variables itself."""
    with pytest.MonkeyPatch.context() as mp:
        mp.delenv("MAPAD_SHARD", raising=False)
        mp.delenv("MAPAD_BLOCK_READS", raising=False)
        yield


def port_twin(test_module: str, subs=()) -> dict:
    """The names of tests/<test_module>.py run against mapad_tpu_torch: its
    source with every `mapad_tpu.` import pointed at the port (and each
    (old, new) text of `subs` replaced), executed as a module of its own.
    A test file re-exports the `test_*` functions (and the fixtures they
    take) to run the JAX package's cases on the port unchanged."""
    path = os.path.join(HERE, f"{test_module}.py")
    src = re.sub(r"\bmapad_tpu\.", "mapad_tpu_torch.", open(path).read())
    for old, new in subs:
        assert old in src, (test_module, old)
        src = src.replace(old, new)
    ns = {"__name__": f"{test_module}_on_the_port", "__file__": path}
    exec(compile(src, path, "exec"), ns)
    return ns


def bench_ref() -> bytes:
    return open(os.path.join(HERE, "data", "bench_ref.txt")).read().strip().encode()


def bench_reads(seed: int = 123, n_random: int = 30, n_exo: int = 4,
                extra=()) -> list:
    """The bench fixture's reads, then reads drawn from the reference with
    up to two substitutions, then exogenous (random) reads."""
    ref = bench_ref()
    reads = [
        line.strip().encode()
        for line in open(os.path.join(HERE, "data", "bench_reads.txt"))
    ]
    rng = np.random.default_rng(seed)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    for _ in range(n_random):
        ln = int(rng.integers(20, 101))
        st = int(rng.integers(0, len(ref) - ln))
        seq = bytearray(ref[st : st + ln])
        for _ in range(int(rng.integers(0, 3))):
            seq[int(rng.integers(0, ln))] = int(rng.choice(bases))
        reads.append(bytes(seq))
    for _ in range(n_exo):
        reads.append(bytes(rng.choice(bases, size=int(rng.integers(30, 80)))))
    reads.extend(extra)
    return reads


def adna_params(pkg):
    """The production single-stranded aDNA parameters of
    tests/test_device_search.py, built from `pkg`'s own model classes."""
    models = __import__(f"{pkg}.models", fromlist=["x"])
    mapping = __import__(f"{pkg}.map", fromlist=["x"])
    dm = models.SimpleAncientDnaModel(
        ("single_stranded", 0.475, 0.475), 0.001, 0.9,
        np.float32(0.02) / np.float32(3.0), False,
    )
    repr_mm = dm.get_representative_mismatch_penalty()
    return mapping.AlignmentParameters(
        difference_model=dm,
        mismatch_bound=models.Discrete(0.04, 0.02, repr_mm),
        penalty_gap_open=np.log2(np.float32(0.00001)),
        penalty_gap_extend=repr_mm,
        chunk_size=1000, gap_dist_ends=5, stack_limit_abort=False,
        max_num_gaps_open=2,
    )


def port_adna_params():
    """`adna_params` of mapad_tpu_torch."""
    return adna_params("mapad_tpu_torch")


def vindija_params(pkg):
    """A center-start model (the alignment starts inside the read: the
    searches extend both ways), built from `pkg`'s own classes."""
    models = __import__(f"{pkg}.models", fromlist=["x"])
    mapping = __import__(f"{pkg}.map", fromlist=["x"])
    dm = models.VindijaPwm()
    repr_mm = dm.get_representative_mismatch_penalty()
    return mapping.AlignmentParameters(
        difference_model=dm,
        mismatch_bound=models.Discrete(0.01, 0.02, repr_mm),
        penalty_gap_open=np.float32(3.0) * repr_mm,
        penalty_gap_extend=np.float32(0.6) * repr_mm, chunk_size=1,
        gap_dist_ends=5, stack_limit_abort=False, max_num_gaps_open=2,
    )


def config_params(pkg, name, changes=None):
    """The AlignmentParameters of setting `name` of
    mapad_tpu_torch/tools/configs.py (`changes`: its flags replaced), as
    `pkg`'s own CLI parser builds them."""
    from mapad_tpu_torch.tools import configs

    cli = __import__(f"{pkg}.cli", fromlist=["x"])
    if changes is not None:
        changes = {**configs.SETTINGS.get(name, {}), **changes}
    return configs.parameters(cli, name, changes)


def dryrun_params(pkg, chunk_size=1000):
    """The alignment parameters of the multi-chip dry run and the multi-host
    test of the JAX package (`__graft_entry__.dryrun_multichip`,
    tests/test_multihost_e2e.py), built from `pkg`'s own classes."""
    models = __import__(f"{pkg}.models", fromlist=["x"])
    mapping = __import__(f"{pkg}.map", fromlist=["x"])
    dm = models.SimpleAncientDnaModel(
        ("single_stranded", 0.6, 0.55), 0.01, 1.0,
        np.float32(0.02) / np.float32(3.0), False,
    )
    repr_mm = dm.get_representative_mismatch_penalty()
    return mapping.AlignmentParameters(
        difference_model=dm,
        mismatch_bound=models.Discrete(0.03, 0.02, repr_mm),
        penalty_gap_open=repr_mm * np.float32(1.5),
        penalty_gap_extend=repr_mm * np.float32(0.5),
        chunk_size=chunk_size, gap_dist_ends=5, stack_limit_abort=False,
        max_num_gaps_open=2,
    )


def bam_records(path):
    """Every record of a BAM file (read with mapad_tpu_torch's reader) as
    a tuple of its fields and its tags, XD (a timing) left out."""
    from mapad_tpu_torch.io.bam import BamReader

    with open(path, "rb") as f:
        return [
            (r.name, r.flags, r.ref_id, r.pos, r.mapq, r.cigar_string(),
             r.sequence, r.quals,
             tuple(sorted((bytes(k), v) for k, _t, v in r.tags
                          if bytes(k) != b"XD")))
            for r in BamReader(f)
        ]


def port_index(di):
    """The port's DeviceFmIndex on the CPU from the arrays of a JAX
    package's DeviceFmIndex."""
    from mapad_tpu_torch.ops.fm import DeviceFmIndex

    return DeviceFmIndex.from_numpy(np.asarray(di.rows), np.asarray(di.less),
                                    np.asarray(di.sentinels), di.occ_k,
                                    di.text_len, bool(di.big), device="cpu")


def repeat_ref():
    """-> (bench_ref followed by six copies of one 60 bp segment of it, each
    with one substitution at its own position and a random 50 bp spacer
    before it, the segment): a read of the segment completes once on the
    original and once on each copy."""
    ref = bench_ref()
    rng = np.random.default_rng(0)
    seg = ref[1000:1060]
    parts = [ref]
    for c in range(6):
        s = bytearray(seg)
        p = 10 + 6 * c
        s[p] = b"ACGT"[(b"ACGT".index(s[p]) + 1) % 4]
        parts.append(bytes(rng.choice(np.frombuffer(b"ACGT", np.uint8), 50)))
        parts.append(bytes(s))
    return b"".join(parts), seg


def records(pkg, seqs, qual=40):
    record = __import__(f"{pkg}.map.record", fromlist=["x"])
    return [
        record.Record(sequence=bytes(s), base_qualities=bytes([qual] * len(s)))
        for s in seqs
    ]


def f32_bits(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def assert_bits_equal(a, b, ctx=""):
    a, b = f32_bits(a), f32_bits(b)
    assert a.shape == b.shape, (ctx, a.shape, b.shape)
    assert a.dtype == b.dtype, (ctx, a.dtype, b.dtype)
    assert np.array_equal(a, b), (ctx, np.flatnonzero(a.ravel() != b.ravel())[:8])


def assert_pool_results_equal(jr, tr, ctx=""):
    """Field by field: a JAX PoolResult (numpy leaves) against the port's
    (torch leaves)."""
    assert tuple(jr._fields) == tuple(tr._fields)
    for name in jr._fields:
        a, b = getattr(jr, name), getattr(tr, name)
        assert_bits_equal(np.asarray(a), b.cpu().numpy(), (ctx, name))


def packed_equal(a, b) -> bool:
    """Two PackedHits (either package) hold the same hits bit for bit."""
    if len(a) != len(b):
        return False
    if not len(a):
        return True
    return (
        np.array_equal(np.asarray(a.ivals), np.asarray(b.ivals))
        and np.array_equal(f32_bits(a.scores), f32_bits(b.scores))
        and np.array_equal(np.asarray(a.ops), np.asarray(b.ops))
        and int(a.split) == int(b.split)
    )


def hits_equal(a, b) -> bool:
    """Two decoded hit lists (either package) are equal hit for hit."""
    if len(a) != len(b):
        return False
    for x, y in zip(a, b):
        if tuple(x.interval) != tuple(y.interval):
            return False
        if np.float32(x.alignment_score).view(np.int32) != np.float32(
            y.alignment_score
        ).view(np.int32):
            return False
        if [tuple(o) for o in x.edit_operations] != [
            tuple(o) for o in y.edit_operations
        ]:
            return False
    return True


def bid_rows(seed, L=10, M=128):
    """Step-function Bi-D rows with 1 to 60 runs: rows past 32 runs take
    the RLE overflow path (truncated code, routed to the host)."""
    rng = np.random.default_rng(seed)
    bid = np.zeros((L, M), np.float32)
    for i in range(L):
        runs = 1 + (i * 7) % 60
        cuts = np.sort(rng.choice(np.arange(1, M), size=runs - 1,
                                  replace=False))
        vals = np.cumsum(rng.uniform(-4, 0, size=runs)).astype(np.float32)
        bid[i] = np.repeat(vals, np.diff(np.r_[0, cuts, M]))
    return bid


def run_pool_both(fmd, reads, R, big=False, dense=False, params_of=adna_params,
                  qual=40, **cfg_kw):
    """Prep one invocation of R reads with the JAX engine, then run the JAX
    pool search and the port's plain kernels on the same numpy inputs: the
    host-packed LUT/Bi-D rows, or (`dense`, the default of `big`) the dense
    per-read arrays from which both compute the Bi-D themselves.
    `params_of(pkg)` makes the alignment parameters from `pkg`'s classes;
    `cfg_kw` are PoolConfig fields.  -> (JAX result, port result, engine)."""
    import jax

    from mapad_tpu.ops.engine import DeviceSearchEngine
    from mapad_tpu.ops.search_pool import PoolConfig as JPoolConfig
    from mapad_tpu.ops.search_pool2 import k_mismatch_search_pool2 as jpool
    from mapad_tpu_torch.ops.search import SearchParams
    from mapad_tpu_torch.ops.search_pool import PoolConfig
    from mapad_tpu_torch.ops.search_pool2 import k_mismatch_search_pool2

    params = params_of("mapad_tpu")
    backward = params.difference_model.find_alignment_start(100) == 100
    cfg = JPoolConfig(**{"max_len": 128, "compute_forward_part": not backward,
                         "backward_only": backward, **cfg_kw})
    eng = DeviceSearchEngine(fmd, params, mode="pool", pool_config=cfg,
                             big=big)
    track = cfg_kw.get("track_read_steps", True)
    jcfg, prep, host_bid, _ = eng._prep_block(
        records("mapad_tpu", reads, qual), R, cfg
    )
    assert host_bid == (not dense)
    jcfg = jcfg._replace(track_read_steps=track)
    kw = {"slut_packed": prep["slut_packed"]} if host_bid else {}
    jr = jpool(eng.device_index, prep["pattern_rank"], prep["pattern_code"],
               prep["n"], prep["score_lut"], prep["pen"], prep["split"],
               prep["cutoff_scale"], prep["cutoff_thresh"], prep["repr_mm"],
               eng._params(), jcfg, **kw)
    jr = jax.tree.map(np.asarray, jr)

    assert bool(eng.device_index.big) == big
    tidx = port_index(eng.device_index)
    tcfg = PoolConfig(**{f: getattr(jcfg, f) for f in PoolConfig._fields})

    def t(name):
        return torch.from_numpy(np.array(prep[name]))

    tkw = (dict(slut=t("slut_packed")) if host_bid else
           dict(dense=(t("pattern_rank").to(torch.int32), t("pattern_code"),
                       t("score_lut"), t("pen"))))
    tr = k_mismatch_search_pool2(
        tidx, t("n"), t("split"), t("cutoff_scale"), t("cutoff_thresh"),
        t("repr_mm"),
        SearchParams.from_alignment(params_of("mapad_tpu_torch"), "cpu"),
        tcfg, **tkw,
    )
    return jr, tr, eng
