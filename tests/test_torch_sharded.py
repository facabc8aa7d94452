"""The port's pool search over several devices (kernel K9,
mapad_tpu_torch/parallel/) against the JAX package's mesh, on the CPU: a
mesh there is a list of devices that may name the CPU several times, the
counterpart of JAX's virtual CPU devices (tests/conftest.py gives JAX 8).

- the plain K9 against JAX's `pool_search_sharded`, every PoolResult field
  bit for bit, with int32 and with int64 intervals;
- the sharded `DeviceSearchEngine` (MAPAD_SHARD=1) against JAX's sharded
  engine: hits read for read, the escalated reads and the per-shard steps;
  packed hits against the port's unsharded engine;
- reads the prep neutralizes (Bi-D RLE overflow) go to the host under
  their own index;
- `pipeline.run` with the sharded engine writes the unsharded engine's BAM;
- the mesh rule, the deal and the helpers of parallel/.

Every comparison is exact (f32 by its bits)."""

import time
from concurrent.futures import Future

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from mapad_tpu.index.builder import build_auxiliary_structures  # noqa: E402
from mapad_tpu.ops.engine import DeviceSearchEngine as JEngine  # noqa: E402
from mapad_tpu.ops.search_pool import PoolConfig as JPoolConfig  # noqa: E402
from mapad_tpu_torch.index.builder import (  # noqa: E402
    build_auxiliary_structures as t_build,
)
from mapad_tpu_torch.ops.engine import DeviceSearchEngine as TEngine  # noqa: E402
from mapad_tpu_torch.ops.search_pool import PoolConfig as TPoolConfig  # noqa: E402
from mapad_tpu_torch.parallel import pool_sharded as tps  # noqa: E402
from mapad_tpu_torch.parallel import sharding as tsh  # noqa: E402
from torch_port_helpers import (  # noqa: E402
    adna_params,
    assert_bits_equal,
    assert_pool_results_equal,
    bam_records,
    bench_reads,
    bench_ref,
    dryrun_params,
    hits_equal,
    packed_equal,
    port_index,
    records,
)
from torch_port_helpers import unsharded_env  # noqa: E402,F401

CPU = torch.device("cpu")
# tests/test_multichip.py's engine config (store generations on)
MC_CFG = dict(max_len=128, lanes=8, total_steps=2048, read_step_cap=512,
              max_chains=2048, generations=2)


def _stream_out(out):
    """search_chunk(lazy_fallback=True) output -> (escalated, hits)."""
    escalated = {i for i, o in enumerate(out) if isinstance(o, Future)}
    hits = [(o.result() if isinstance(o, Future) else o)[0] for o in out]
    return escalated, hits


# --- K9: the plain version against JAX's pool_search_sharded -------------


@pytest.mark.parametrize("big", [False, True])
def test_pool_search_sharded_plain_equals_jax(big):
    """4 shards of 16 reads, L=8: JAX's shard_map over 4 of its virtual CPU
    devices against the port's plain per-shard loops on [cpu] * 4.  int32
    takes the host-packed LUT/Bi-D rows, int64 the dense inputs (each shard
    computes its own Bi-D, as under shard_map)."""
    import jax

    from mapad_tpu.parallel.pool_sharded import pool_search_sharded
    from mapad_tpu.parallel.pool_sharded import shard_reads as j_shard_reads
    from mapad_tpu.parallel.sharding import make_mesh as j_make_mesh
    from mapad_tpu.parallel.sharding import replicate as j_replicate
    from mapad_tpu_torch.ops.search import SearchParams

    D, R = 4, 64
    cfg = JPoolConfig(max_len=128, lanes=8, total_steps=1024,
                      read_step_cap=512, max_chains=512,
                      compute_forward_part=False, track_read_steps=True)
    ref = bench_ref()
    fmd = build_auxiliary_structures(ref, b"ACGT")[0]
    reads = bench_reads(seed=31, n_random=R - 7 - 4, n_exo=4)
    assert len(reads) == R
    eng = JEngine(fmd, adna_params("mapad_tpu"), mode="pool",
                  pool_config=cfg, big=big)
    prep = eng._prepare(records("mapad_tpu", reads), cfg.max_len, R,
                        host_bid=not big)
    # (with the packed rows the dense arrays are empty (R, 0) placeholders)
    keys = tps.CONST_KEYS + tps.DENSE_KEYS + (() if big else ("slut_packed",))
    prep = {k: np.asarray(prep[k]) for k in keys}
    mesh = j_make_mesh(D)
    jr = pool_search_sharded(mesh, j_replicate(mesh, eng.device_index),
                             j_shard_reads(mesh, prep), eng._params(), cfg)
    jr = jax.tree.map(np.asarray, jr)

    tmesh = [CPU] * D
    tidx = port_index(eng.device_index)
    tr = tps.pool_search_sharded_plain(
        tmesh, tsh.replicate(tmesh, tidx),
        {k: torch.from_numpy(v.copy()) for k, v in prep.items()},
        SearchParams.from_alignment(adna_params("mapad_tpu_torch"), "cpu"),
        TPoolConfig(**{f: getattr(cfg, f) for f in TPoolConfig._fields}),
    )
    assert tr.c_read.shape[0] == D and tr.steps.shape == (D,)
    assert_pool_results_equal(jr, tr, "big" if big else "int32")
    # global ids: every chain's read lies in its own shard's slice
    cr, R_local = jr.c_read, R // D
    for d in range(D):
        n = min(int(jr.n_chains[d]), cfg.max_chains)
        assert ((cr[d, :n] // R_local) == d).all()
    assert (jr.lane_read <= R).all()

    # the host collectors of the two packages on these results
    from mapad_tpu.parallel.pool_sharded import collect_sharded

    j_out, t_out = [None] * R, [None] * R
    j_esc = collect_sharded(eng, records("mapad_tpu", reads), jr, j_out,
                            time.perf_counter())
    te = TEngine(t_build(ref, b"ACGT")[0], adna_params("mapad_tpu_torch"),
                 pool_config=TPoolConfig(max_len=128, lanes=8), device="cpu")
    t_esc = tps.collect_sharded(te, records("mapad_tpu_torch", reads), tr,
                                t_out, time.perf_counter())
    assert t_esc == j_esc and len(t_esc) > 0
    for i, (a, b) in enumerate(zip(j_out, t_out)):
        assert (a is None) == (b is None) == (i in t_esc), i
        assert a is None or hits_equal(a[0], b[0]), i


def test_pool_search_sharded_on_an_engines_shard_runner(mc_fixture,
                                                        monkeypatch):
    """K9 on a sharded engine's shard threads (its `ShardRunner`, which the
    engine's mesh path runs its shards on), over a block the engine dealt
    and prepared per shard, against its plain version bit for bit, and
    against the engine's own fetched result of that block (the wire form
    of c_ops keeps its low 21 bits)."""
    _jfmd, tfmd, seqs = mc_fixture
    monkeypatch.setenv("MAPAD_SHARD", "1")
    monkeypatch.setenv("MAPAD_BLOCK_READS", "32")
    te = _t_engine(tfmd, [CPU] * 2)
    R = te.block_reads
    assert R == 32
    cfg, prep, t0 = te._prep_block(records("mapad_tpu_torch", seqs[:R]), R,
                                   te.pool_config)
    ups = [te._upload(part, CPU) for part in prep["shards"]]
    p = {k: torch.cat([consts[i] for consts, _ in ups])
         for i, k in enumerate(tps.CONST_KEYS)}
    p["slut_packed"] = torch.cat([kw["slut"] for _, kw in ups])
    params = te._params()
    got = tps.pool_search_sharded(te.mesh, te._mesh_index, p, params, cfg,
                                  runner=te._shards)
    want = tps.pool_search_sharded_plain(te.mesh, te._mesh_index, p, params,
                                         cfg)
    assert_pool_results_equal(
        tps.PoolResult(*[t.numpy() for t in want]), got, "runner")
    assert (got.lane_read <= R).all() and got.steps.shape == (2,)
    fetched = te._fetch(te._launch_block((cfg, prep, t0), params)[0])
    for name, a, b in zip(got._fields, got, fetched):
        a = a.numpy()
        if name == "c_ops":
            a, b = a & 0x1FFFFF, b & 0x1FFFFF
        assert_bits_equal(a, b, ("engine", name))


# --- the sharded engine ---------------------------------------------------


@pytest.fixture(scope="module")
def mc_fixture():
    """tests/test_multichip.py's random 20 kbp genome and reads (cut to
    one 64-read block: 60 drawn from the genome with up to two
    substitutions, 4 exogenous), both packages' indexes."""
    rng = np.random.default_rng(5)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    ref = bytes(rng.choice(bases, 20000))
    seqs = []
    for _ in range(60):
        ln = int(rng.integers(24, 90))
        start = int(rng.integers(0, len(ref) - ln))
        seq = bytearray(ref[start : start + ln])
        for _ in range(int(rng.integers(0, 3))):
            seq[int(rng.integers(0, ln))] = int(rng.choice(bases))
        seqs.append(bytes(seq))
    seqs += [bytes(rng.choice(bases, 60)) for _ in range(4)]
    return (build_auxiliary_structures(ref, b"ACGT")[0],
            t_build(ref, b"ACGT")[0], seqs)


def _t_engine(tfmd, mesh, cfg=MC_CFG, **kw):
    return TEngine(tfmd, adna_params("mapad_tpu_torch"),
                   pool_config=TPoolConfig(**cfg), device="cpu", mesh=mesh,
                   **kw)


def test_sharded_engine_equals_jax(mc_fixture, monkeypatch):
    """MAPAD_SHARD=1, MAPAD_BLOCK_READS=32: JAX shards over its 8 virtual
    devices, the port over [cpu] * 8 (one 64-read block, 8 reads a shard).
    Hits read for read, the escalated reads and `shard_steps` are equal."""
    jfmd, tfmd, seqs = mc_fixture
    monkeypatch.setenv("MAPAD_SHARD", "1")
    monkeypatch.setenv("MAPAD_BLOCK_READS", "32")
    je = JEngine(jfmd, adna_params("mapad_tpu"), mode="pool",
                 pool_config=JPoolConfig(compute_forward_part=False,
                                         **MC_CFG))
    te = _t_engine(tfmd, [CPU] * 8)
    assert je.n_shards == te.n_shards == 8
    assert je.block_reads == te.block_reads == 64
    j_esc, j_hits = _stream_out(
        je.search_chunk(records("mapad_tpu", seqs), lazy_fallback=True))
    t_esc, t_hits = _stream_out(
        te.search_chunk(records("mapad_tpu_torch", seqs), lazy_fallback=True))
    assert t_esc == j_esc and len(t_esc) > 0
    for i, (a, b) in enumerate(zip(j_hits, t_hits)):
        assert hits_equal(a, b), i
    assert te._stats["shard_steps"] == je._stats["shard_steps"]
    assert len(te._stats["shard_steps"]) == 8
    assert sum(len(h) > 0 for h in t_hits) > len(seqs) // 2
    # the mode keeps no per-cause counts, as in JAX
    assert "esc_why" not in te._stats and "esc_why" not in je._stats


def test_sharded_engine_packed_equals_unsharded(mc_fixture, monkeypatch):
    """The same reads with packed hits over [cpu] * 2 against the port's own
    unsharded engine: the same hits and the same escalated reads."""
    _jfmd, tfmd, seqs = mc_fixture
    recs = records("mapad_tpu_torch", seqs)
    monkeypatch.setenv("MAPAD_BLOCK_READS", "64")
    monkeypatch.setenv("MAPAD_SHARD", "0")
    single = _t_engine(tfmd, None, packed_hits=True)
    assert single.mesh is None
    s_esc, s_hits = _stream_out(single.search_chunk(recs, lazy_fallback=True))
    monkeypatch.setenv("MAPAD_SHARD", "1")
    te = _t_engine(tfmd, [CPU] * 2, packed_hits=True)
    t_esc, t_hits = _stream_out(te.search_chunk(recs, lazy_fallback=True))
    assert t_esc == s_esc
    for i, (a, b) in enumerate(zip(s_hits, t_hits)):
        assert packed_equal(a, b), i
    assert te._stats["batches"] == 1 and len(te._stats["shard_steps"]) == 2


def test_mesh_path_packs_k3s_allocation_with_the_rebase(mc_fixture,
                                                        monkeypatch):
    """The engine's mesh path over [cpu] * 2: each shard's K5 packs K3's
    one allocation with its own rebase, (d * R, R, 2 * R) for shard d of R
    reads; no `shard_rebase`, no `search_shard`, no PoolResult entry; the
    hits and escalations those of the unsharded engine."""
    from mapad_tpu_torch.ops import engine as teng

    _jfmd, tfmd, seqs = mc_fixture
    recs = records("mapad_tpu_torch", seqs)
    monkeypatch.setenv("MAPAD_BLOCK_READS", "64")
    monkeypatch.setenv("MAPAD_SHARD", "0")
    s_esc, s_hits = _stream_out(_t_engine(tfmd, None, packed_hits=True)
                                .search_chunk(recs, lazy_fallback=True))

    def refuse(*a, **kw):
        raise AssertionError("not on the engine's mesh path")

    for mod, name in ((tps, "shard_rebase"), (tps, "search_shard"),
                      (teng, "_pack_result"), (teng, "_result_spec")):
        monkeypatch.setattr(mod, name, refuse)
    seen = []
    pack = teng._pack_buffer

    def spy(buf, config, R, big, rebase=None):
        seen.append(rebase)
        return pack(buf, config, R, big, rebase)

    monkeypatch.setattr(teng, "_pack_buffer", spy)
    monkeypatch.setenv("MAPAD_SHARD", "1")
    te = _t_engine(tfmd, [CPU] * 2, packed_hits=True)
    t_esc, t_hits = _stream_out(te.search_chunk(recs, lazy_fallback=True))
    assert sorted(seen) == [(0, 32, 64), (32, 32, 64)]
    assert t_esc == s_esc
    for i, (a, b) in enumerate(zip(s_hits, t_hits)):
        assert packed_equal(a, b), i


@pytest.mark.parametrize("shard", [0, 1])
@pytest.mark.parametrize("big", [False, True])
def test_pack_buffer_with_a_shards_rebase(shard, big):
    """`_pack_buffer(..., rebase=...)` on the CPU, word for word: the plain
    rebase of the allocation's views, then the plain pack; unpacked, its
    ids follow the rule of mapad_tpu's pool_sharded.py:122-135 and every
    other field is the pack without the rebase's."""
    from mapad_tpu_torch.ops.engine import (
        _buffer_spec,
        _pack_buffer,
        _pack_result_plain,
    )
    from mapad_tpu_torch.ops.prep import _unpack_result
    from mapad_tpu_torch.ops.search_pool2 import _alloc_result, _pool_result

    L, C, max_len, R, D = 8, 37, 21, 24, 2
    cfg = TPoolConfig(max_len=max_len, lanes=L, total_steps=64,
                      read_step_cap=60, max_chains=C, track_read_steps=True)
    buf = _alloc_result(cfg, R, big, CPU)
    rng = np.random.default_rng(7 + shard + 2 * big)
    for f in _pool_result(buf, cfg, R, big):
        v = rng.integers(0, 2, f.shape) if f.dtype == torch.bool else \
            rng.integers(-2**20, 2**20, f.shape)
        f.copy_(torch.from_numpy(np.asarray(v)).to(f.dtype))
    res = _pool_result(buf, cfg, R, big)
    res.c_read.copy_(torch.from_numpy(rng.integers(-1, R, C)))
    res.lane_read.copy_(torch.from_numpy(rng.integers(0, R + 1, L)))
    res.next_read.fill_(int(rng.integers(0, R + 1)))
    rebase = (shard * R, R, D * R)
    want = _pack_result_plain(tps._shard_rebase_plain(
        _pool_result(buf.clone(), cfg, R, big), *rebase))
    plain = _pack_buffer(buf.clone(), cfg, R, big)
    got = _pack_buffer(buf.clone(), cfg, R, big, rebase)
    assert got.dtype == torch.int32 and torch.equal(got, want)
    spec = _buffer_spec(L, C, max_len + 16, R, big)
    back = _unpack_result(spec, got.numpy())
    before = _unpack_result(spec, plain.numpy())
    base = shard * R
    c, lane = np.asarray(before.c_read), np.asarray(before.lane_read)
    assert np.array_equal(back.c_read, np.where(c >= 0, c + base, -1))
    assert np.array_equal(back.lane_read,
                          np.where(lane < R, lane + base, D * R))
    assert int(back.next_read) == int(before.next_read) + base
    for name, b, p in zip(back._fields, back, before):
        if name not in ("c_read", "lane_read", "next_read"):
            assert np.array_equal(np.asarray(b), np.asarray(p)), name


def test_bid_rle_overflow_goes_to_the_host_under_its_own_index(monkeypatch):
    """A read whose Bi-D needs more runs than the RLE upload carries is
    neutralized on the card and routed to the host at collect time.  With
    a mesh its stash row is a row of the dealt block: the port maps it
    through the deal to the read's own input index.  mapad_tpu differs
    here: its sharded collect injects the dealt row as an input index
    (mapad_tpu/ops/engine.py:1714), so another read goes to the host and
    the overflowed read keeps the card's empty result.  The sharded port
    escalates the same reads as the unsharded one, with the same hits."""
    fmd = t_build(bench_ref(), b"ACGT")[0]
    rng = np.random.default_rng(0)
    bases = np.frombuffer(b"ACGT", np.uint8)
    # exogenous 128 bp reads: some fail extension often enough for more
    # than 32 Bi-D runs against this 10 kbp reference
    seqs = bench_reads(seed=8, n_random=9, n_exo=0)
    seqs += [bytes(rng.choice(bases, 128)) for _ in range(16)]
    cfg = dict(max_len=128, lanes=8, total_steps=2048, read_step_cap=512,
               max_chains=256)
    monkeypatch.setenv("MAPAD_BLOCK_READS", "32")
    monkeypatch.setenv("MAPAD_SHARD", "0")
    single = _t_engine(fmd, None, cfg)
    prep = single._prepare(records("mapad_tpu_torch", seqs), 128, 32)
    over = set(prep["_stash"]["pre_escalate"].tolist())
    assert over, "the fixture must hold reads past the RLE's runs"
    # the deal moves them: an injection of dealt rows would miss them
    inv = np.argsort(tps.round_robin_permutation(32, 4))
    assert any(int(inv[i]) != i for i in over)
    recs = records("mapad_tpu_torch", seqs)
    s_esc, s_hits = _stream_out(single.search_chunk(recs, lazy_fallback=True))
    monkeypatch.setenv("MAPAD_SHARD", "1")
    te = _t_engine(fmd, [CPU] * 4, cfg)
    t_esc, t_hits = _stream_out(te.search_chunk(recs, lazy_fallback=True))
    assert over <= t_esc and t_esc == s_esc
    for i, (a, b) in enumerate(zip(s_hits, t_hits)):
        assert hits_equal(a, b), i


def test_pipeline_run_with_the_sharded_engine(tmp_path, monkeypatch):
    """`dryrun_multichip`'s flow (mapad_tpu's __graft_entry__.py) at 64
    reads and 4 shards: FASTQ -> `pipeline.run` with MAPAD_SHARD=1 -> BAM,
    equal record for record (XD aside) to the unsharded engine's BAM."""
    from mapad_tpu_torch.index.builder import build_from_sequences
    from mapad_tpu_torch.index.runtime import load_index, save_index
    from mapad_tpu_torch.map import pipeline

    rng = np.random.default_rng(42)
    genome = rng.choice(np.frombuffer(b"ACGT", dtype=np.uint8), size=50_000)
    prefix = str(tmp_path / "ref")
    fmd, ssa, idp, orig = build_from_sequences([("dryrun_chr",
                                                 genome.tobytes())])
    save_index(prefix, fmd, ssa, idp, orig)
    index = load_index(prefix)
    R, READ_LEN = 64, 75
    starts = rng.integers(0, len(genome) - READ_LEN, size=R)
    fastq = str(tmp_path / "reads.fq")
    with open(fastq, "w") as f:
        for i in range(R):
            seq = bytearray(genome[starts[i] : starts[i] + READ_LEN].tobytes())
            for pos in range(READ_LEN):
                p = 0.3 * (0.55 ** pos) + 0.3 * (0.55 ** (READ_LEN - 1 - pos))
                if seq[pos] == ord("C") and rng.random() < p:
                    seq[pos] = ord("T")
            f.write(f"@dryrun{i}\n{seq.decode()}\n+\n{'I' * READ_LEN}\n")
    params = dryrun_params("mapad_tpu_torch", chunk_size=R)
    cfg = TPoolConfig(max_len=128, lanes=8, total_steps=2048,
                      read_step_cap=1024, max_chains=1024, generations=2,
                      spill_steps=768)
    monkeypatch.setenv("MAPAD_BLOCK_READS", str(R))
    bams = {}
    for shard in ("0", "1"):
        monkeypatch.setenv("MAPAD_SHARD", shard)
        engine = TEngine(fmd, params, pool_config=cfg, device="cpu",
                         mesh=[CPU] * 4)
        assert (engine.mesh is not None) == (shard == "1")
        bams[shard] = str(tmp_path / f"out{shard}.bam")
        pipeline.run(fastq, prefix, bams[shard], True, params, engine=engine,
                     threads=2, index=index)
    steps = engine.stats()["shard_steps"]
    assert len(steps) == 4 and min(steps) > 0
    want, got = bam_records(bams["0"]), bam_records(bams["1"])
    assert len(got) == R and got == want
    assert sum(1 for r in got if not r[1] & 0x4) >= R * 3 // 4


# --- the mesh rule, the deal and the helpers ------------------------------


@pytest.mark.parametrize("env,mesh,want", [
    ("1", 4, 4),      # asked for, over the given devices
    (None, 4, 1),     # on the CPU the mesh is opt-in, as in mapad_tpu
    ("0", 4, 1),      # refused
    ("1", 1, 1),      # one device is no mesh
    ("1", None, 1),   # no card: nothing visible to shard over
])
def test_mesh_rule(env, mesh, want, monkeypatch):
    tfmd = t_build(b"ACGTTGCAACGGTACA" * 8, b"ACGT")[0]
    if env is None:
        monkeypatch.delenv("MAPAD_SHARD", raising=False)
    else:
        monkeypatch.setenv("MAPAD_SHARD", env)
    te = _t_engine(tfmd, None if mesh is None else [CPU] * mesh)
    assert te.n_shards == want
    assert (te.mesh is None) == (want == 1)
    # block_reads scales with the shards and divides by them
    assert te.block_reads == 8192 * want
    te.block_reads = 30
    assert te.block_reads % want == 0
    assert te.block_reads == max(8 * want, 30 if want == 1 else 32)
    # batch mode is never sharded
    assert _t_engine(tfmd, [CPU] * 4, mode="batch").mesh is None


@pytest.mark.parametrize("R,D", [(64, 8), (30, 3), (8192, 2)])
def test_deal_equals_jax(R, D):
    from mapad_tpu.parallel import pool_sharded as jps

    perm = tps.round_robin_permutation(R, D)
    assert np.array_equal(perm, jps.round_robin_permutation(R, D))
    # shard d holds every D-th read from d on
    assert np.array_equal(perm[: R // D], np.arange(0, R, D))
    costs = np.random.default_rng(R).random(R)
    assert np.array_equal(tps.balanced_shard_permutation(costs, D),
                          jps.balanced_shard_permutation(costs, D))


def test_shard_rebase_plain_equals_jax_rule():
    """The plain rebase against the rule of pool_sharded.py:122-135, in
    place."""
    from mapad_tpu_torch.ops.search_pool import PoolResult

    rng = np.random.default_rng(1)
    base, r_local, r_global = 32, 16, 64
    c_read = rng.integers(-1, r_local, 40).astype(np.int32)
    lane_read = rng.integers(0, r_local + 1, 8).astype(np.int32)
    res = PoolResult(*[torch.zeros(1)] * len(PoolResult._fields))._replace(
        c_read=torch.from_numpy(c_read.copy()),
        lane_read=torch.from_numpy(lane_read.copy()),
        next_read=torch.tensor(11, dtype=torch.int32))
    c_ptr = res.c_read.data_ptr()
    out = tps.shard_rebase(res, base, r_local, r_global)
    assert out.c_read.data_ptr() == c_ptr
    assert np.array_equal(out.c_read.numpy(),
                          np.where(c_read >= 0, c_read + base, -1))
    assert np.array_equal(out.lane_read.numpy(),
                          np.where(lane_read < r_local, lane_read + base,
                                   r_global))
    assert int(out.next_read) == 11 + base


def test_make_mesh_and_replicate(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert tsh.make_mesh() == [torch.device("cuda", 0),
                               torch.device("cuda", 1)]
    assert tsh.make_mesh(1) == [torch.device("cuda", 0)]
    with pytest.raises(RuntimeError, match="only 2 devices"):
        tsh.make_mesh(4)
    tfmd = t_build(b"ACGTTGCAACGGTACA" * 8, b"ACGT")[0]
    from mapad_tpu_torch.ops.fm import DeviceFmIndex

    idx = DeviceFmIndex.from_host(tfmd, device="cpu")
    reps = tsh.replicate([CPU] * 3, idx)
    assert len(reps) == 3 and all(r is idx for r in reps)


def test_shard_search_inputs():
    prep = {"n": torch.arange(8, dtype=torch.int32),
            "slut_packed": torch.arange(48.0).reshape(16, 3),
            "_stash": {"x": 1}}
    parts = tsh.shard_search_inputs([CPU] * 4, prep)
    assert len(parts) == 4
    for d, part in enumerate(parts):
        assert part["n"].tolist() == [2 * d, 2 * d + 1]
        assert part["slut_packed"].shape == (4, 3)
        assert part["_stash"] is prep["_stash"]
    with pytest.raises(AssertionError, match="must divide"):
        tps.shard_reads([CPU] * 3, prep)
