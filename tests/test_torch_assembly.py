"""A GRCh37-shaped assembly (`mapad_tpu_torch/tools/assembly.py`: hs37d5's
86 sequences, long N runs that the index makes X, short IUPAC runs whose
bases it replaces) at 1/2000 of its size, through both packages on the
CPU: the index bundles byte for byte, original symbols included; the
device rows in both widths with X in them; the pool engine (the plain
kernels) in int32 and in big mode, with and without the retry tier, hits,
counters and PoolResult fields equal; the Python BAM conversion of reads
beside N runs, across sequence joins and over replaced bases, MD included;
and the invariants the smoke holds the card's BAMs to, on the host
engine's BAM."""

import os
import re
import shutil
from concurrent.futures import Future

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import mapad_tpu.map.postprocess as j_post  # noqa: E402
import mapad_tpu_torch.map.postprocess as t_post  # noqa: E402
from mapad_tpu.index import builder as j_builder  # noqa: E402
from mapad_tpu.index import load_index as j_load  # noqa: E402
from mapad_tpu.map.native_search import (  # noqa: E402
    NativeSearchEngine as JNative,
)
from mapad_tpu.map.record import Record as JRecord  # noqa: E402
from mapad_tpu.ops import fm as jfm  # noqa: E402
from mapad_tpu.ops.engine import DeviceSearchEngine as JEngine  # noqa: E402
from mapad_tpu.ops.search_pool import PoolConfig as JPoolConfig  # noqa: E402
from mapad_tpu_torch import cli  # noqa: E402
from mapad_tpu_torch.index import builder as t_builder  # noqa: E402
from mapad_tpu_torch.index import load_index as t_load  # noqa: E402
from mapad_tpu_torch.io.bam import BamReader  # noqa: E402
from mapad_tpu_torch.map.native_search import (  # noqa: E402
    NativeSearchEngine as TNative,
)
from mapad_tpu_torch.map.record import Record as TRecord  # noqa: E402
from mapad_tpu_torch.ops import fm as tfm  # noqa: E402
from mapad_tpu_torch.ops.engine import DeviceSearchEngine as TEngine  # noqa: E402
from mapad_tpu_torch.ops.search_pool import PoolConfig as TPoolConfig  # noqa: E402
from mapad_tpu_torch.tools import assembly  # noqa: E402
from torch_port_helpers import (  # noqa: E402
    adna_params,
    assert_bits_equal,
    assert_pool_results_equal,
    hits_equal,
    packed_equal,
    run_pool_both,
)
from torch_port_helpers import unsharded_env  # noqa: E402,F401

SCALE = 1 / 2000
N_READS = 2000
MAP_FLAGS = ["-p", "0.03", "-l", "single_stranded", "-f", "0.6", "-t",
             "0.55", "-d", "0.01", "-s", "1.0", "-i", "0.001"]


@pytest.fixture(scope="module")
def asm(tmp_path_factory):
    """The assembly, its reads, and each package's index of it."""
    d = tmp_path_factory.mktemp("assembly")
    lay, bases, reads, kinds, fasta, fastq = assembly.make(
        str(d / "work"), SCALE, n_reads=N_READS)
    paths = {}
    for tag, builder in (("j", j_builder), ("t", t_builder)):
        (d / tag).mkdir()
        paths[tag] = str(d / tag / "ref.fa")
        shutil.copy(fasta, paths[tag])
        builder.run(paths[tag])
    return dict(lay=lay, bases=bases, reads=reads, kinds=kinds, fasta=fasta,
                fastq=fastq, paths=paths, dir=d,
                j=j_load(paths["j"]), t=t_load(paths["t"]))


def _pick(asm, per_kind=3, n_random=3, with_n=5):
    """Reads of every kind (a long run's edge, a short run covered, a
    join, placed at random), then `with_n` more that carry N."""
    reads, kinds = asm["reads"], asm["kinds"]
    out = []
    for kind in ("long", "short", "join", ""):
        out += [i for i in range(len(reads))
                if kinds[i] == kind][:per_kind if kind else n_random]
    out += [i for i in range(len(reads))
            if b"N" in reads[i][0] and i not in out][:with_n]
    return sorted(out)


def _records(pkg_record, reads, picked):
    return [pkg_record(sequence=reads[i][0], base_qualities=reads[i][1])
            for i in picked]


# --- the layout -------------------------------------------------------------


def test_layout_is_hs37d5_shaped():
    lay = assembly.layout(1.0)
    assert len(lay.names) == 86
    assert lay.names[:25] == tuple(
        [str(i) for i in range(1, 23)] + ["X", "Y", "MT"])
    assert lay.names[-2:] == ("NC_007605", "hs37d5")
    assert all(n.startswith("GL000") for n in lay.names[25:84])
    assert lay.lengths[:5].sum() == 1_062_541_960
    assert lay.lengths[24] == 16_569 and lay.lengths[-1] == 35_477_943
    assert lay.text_len > 2**31
    s = lay.summary()
    assert 0.05 <= s["n_share"] <= 0.08
    assert (lay.run_len >= 1).all() and np.all(np.diff(lay.run_start) > 0)
    ends = lay.run_start + lay.run_len
    # no two runs touch but two telomeres at a join
    touch = np.flatnonzero(ends[:-1] >= lay.run_start[1:])
    assert np.isin(ends[touch], lay.starts).all()
    assert (lay.run_len[touch] >= assembly.MIN_LONG).all()
    assert (lay.run_len[touch + 1] >= assembly.MIN_LONG).all()
    short = lay.run_len < assembly.MIN_LONG
    assert set(lay.run_sym[short].tobytes()) == set(b"RYKMSWN")
    assert set(lay.run_sym[~short].tobytes()) == {ord("N")}
    # a chromosome: both telomeres, a pericentromeric run of 3-21 Mbp
    first = lay.run_start < lay.lengths[0]
    assert lay.run_start[0] == 0 and lay.run_len[0] == 10_000
    assert ends[first][-1] == lay.lengths[0]
    assert 3e6 <= lay.run_len[first].max() <= 21e6
    # the same structure at the test's scale
    small = assembly.layout(SCALE)
    assert len(small.names) == 86
    assert 0.05 <= small.summary()["n_share"] <= 0.08
    assert small.run_len[small.run_len >= assembly.MIN_LONG].min() \
        == assembly.MIN_LONG


def test_reads_hit_the_edges(asm):
    lay, kinds, reads = asm["lay"], asm["kinds"], asm["reads"]
    edge = kinds != ""
    assert abs(edge.mean() - assembly.READ_EDGE_SHARE) < 0.01
    assert {"long", "short", "join"} <= set(kinds[edge])
    assert all(set(s) <= set(b"ACGTN") for s, _q in reads)
    assert sum(b"N" in s for s, _q in reads) > 50
    starts, k2 = assembly.read_starts(lay, N_READS)
    assert (k2 == kinds).all()
    assert starts.max() <= lay.total - assembly.READ_SPAN


# --- the index --------------------------------------------------------------


def test_index_bundle_equals_the_jax_package(asm):
    jdir, tdir = asm["paths"]["j"] + ".tpx", asm["paths"]["t"] + ".tpx"
    names = sorted(n for n in os.listdir(jdir) if not n.startswith("device"))
    assert names == sorted(n for n in os.listdir(tdir)
                           if not n.startswith("device"))
    for name in names:
        with open(os.path.join(jdir, name), "rb") as a, \
                open(os.path.join(tdir, name), "rb") as b:
            assert a.read() == b.read(), name
    idx = asm["t"]
    lay = asm["lay"]
    # every short run's bases replaced, their originals kept; the long
    # runs X on both strands
    ss, se = lay.short_runs()
    want = np.concatenate([np.arange(s, e) for s, e in zip(ss, se)])
    assert np.array_equal(idx.original_symbols.positions, want)
    assert np.array_equal(idx.original_symbols.symbols,
                          asm["bases"][want])
    ls, le = lay.long_runs()
    assert int((np.asarray(idx.fmd.bwt) == 5).sum()) \
        == 2 * int((le - ls).sum())
    assert [c.identifier for c in idx.id_pos_map] == list(lay.names)


@pytest.mark.parametrize("big", [False, True])
def test_device_rows_equal_the_jax_package(asm, big):
    want = jfm.DeviceFmIndex.from_host(asm["j"].fmd, big=big)
    got = tfm.DeviceFmIndex.from_host(asm["t"].fmd, big=big, device="cpu")
    assert got.big == big and got.occ_k == want.occ_k
    assert_bits_equal(np.asarray(want.rows), got.rows.numpy())
    assert_bits_equal(np.asarray(want.less), got.less.numpy())
    assert_bits_equal(np.asarray(want.sentinels), got.sentinels.numpy())
    words = got.rows[:, got.n_cp_cols:].numpy().view(np.uint32)
    nib = (words[:, :, None] >> np.arange(0, 32, 4, dtype=np.uint32)) & 0xF
    assert (nib == 5).any(axis=(1, 2)).sum() > 10  # rows with X in them
    # the X counts in the checkpoints: rank 5's column
    cp5 = got.rows[:, 5].long()
    if big:
        cp5 = (cp5 & 0xFFFFFFFF) | (got.rows[:, 11].long() << 32)
    assert int(cp5[-1]) > 0
    r = torch.from_numpy(np.random.default_rng(3).integers(
        -1, got.text_len, 512)).to(got.idx_dtype)
    assert_bits_equal(np.asarray(jfm._row_occ4(want, np.asarray(r))),
                      tfm._row_occ4(got, r).numpy())


# --- the pool engine on the plain kernels -----------------------------------

CFG = dict(max_len=128, lanes=8, total_steps=1024, read_step_cap=256,
           max_chains=512)
# a starved step budget: unfinished and undispatched reads for the retry
# tier
STARVED = dict(max_len=128, lanes=8, total_steps=192, read_step_cap=192,
               max_chains=512)
BLOCK = 12


def _stream(engine, recs, block):
    blocks = [(b, recs[b : b + block]) for b in range(0, len(recs), block)]
    out = []
    for _key, block_out in engine.search_stream(blocks, lazy_fallback=True):
        out.extend(block_out)
    escalated = {i for i, o in enumerate(out) if isinstance(o, Future)}
    return escalated, [(o.result() if isinstance(o, Future) else o)[0]
                       for o in out]


@pytest.mark.parametrize("retry", [False, True])
@pytest.mark.parametrize("big", [False, True])
def test_engine_equals_the_jax_package(asm, big, retry, monkeypatch):
    """The same reads escalate by the same causes, take the same tiers
    and get the same hits, bit for bit."""
    for name in ("MAPAD_RETRY_TIER", "MAPAD_DEEP_TIER", "MAPAD_HOST_BID",
                 "MAPAD_DEEP_NOHIT_HOST", "MAPAD_DEEP_LANES"):
        monkeypatch.delenv(name, raising=False)
    if retry:
        monkeypatch.setenv("MAPAD_RETRY_TIER", "1")
    cfg = STARVED if retry else CFG
    picked = _pick(asm)
    reads = asm["reads"]
    je = JEngine(asm["j"].fmd, adna_params("mapad_tpu"), mode="pool",
                 pool_config=JPoolConfig(compute_forward_part=False, **cfg),
                 big=big, packed_hits=True)
    te = TEngine(asm["t"].fmd, adna_params("mapad_tpu_torch"),
                 pool_config=TPoolConfig(**cfg), big=big, packed_hits=True,
                 device="cpu")
    assert te.device_index.big == big
    je.block_reads = te.block_reads = BLOCK
    j_esc, j_hits = _stream(je, _records(JRecord, reads, picked), BLOCK)
    t_esc, t_hits = _stream(te, _records(TRecord, reads, picked), BLOCK)
    assert t_esc == j_esc
    assert te._stats["esc_why"] == je._stats["esc_why"]
    for name in ("retried", "deep_retried", "nohit_host", "oracle",
                 "escalated", "batches", "device_lanes"):
        assert te._stats.get(name, 0) == je._stats.get(name, 0), name
    for i, (a, b) in enumerate(zip(j_hits, t_hits)):
        assert packed_equal(a, b), picked[i]
    assert sum(len(h) > 0 for h in t_hits) > len(picked) // 2
    assert (te._stats.get("retried", 0) > 0) == retry


@pytest.mark.parametrize("big", [False, True])
def test_pool_result_equals_the_jax_package(asm, big):
    """One invocation of K2 + K3 (plain) on the assembly's rows: the
    PoolResult field by field (the host-packed rows in int32, the dense
    inputs and the Bi-D on the device in big mode)."""
    reads = [asm["reads"][i][0] for i in _pick(asm, 2, 2, 4)]
    jr, tr, _eng = run_pool_both(asm["j"].fmd, reads, len(reads), big=big,
                                 dense=big, **CFG)
    assert_pool_results_equal(jr, tr, f"assembly, big={big}")
    assert int(jr.n_chains) > 0


# --- the BAM records --------------------------------------------------------


def test_bam_records_equal_the_jax_package(asm):
    """The host searcher's hits of reads beside N runs, across joins and
    over replaced bases, through each package's `intervals_to_bam`: every
    field and tag equal, MD included; some hit's every position crosses a
    join (the next-best hit reported), some MD carries an original
    symbol."""
    reads = asm["reads"]
    picked = [i for i, k in enumerate(asm["kinds"]) if k][:120]
    jp, tp = adna_params("mapad_tpu"), adna_params("mapad_tpu_torch")
    jrecs = _records(JRecord, reads, picked)
    trecs = _records(TRecord, reads, picked)
    jidx, tidx = asm["j"], asm["t"]
    jout = JNative(jidx.fmd, jp, threads=1).search_chunk(jrecs)
    tout = TNative(tidx.fmd, tp, threads=1).search_chunk(trecs)
    crossed = []
    get = tidx.id_pos_map.get_reference_identifier

    def counting(position, pattern_length):
        got = get(position, pattern_length)
        if got is None:
            crossed.append(position)
        return got

    tidx.id_pos_map.get_reference_identifier = counting
    try:
        got_all = []
        for i, ((jh, _), (th, _)) in enumerate(zip(jout, tout)):
            assert hits_equal(th, jh), picked[i]
            want = j_post.intervals_to_bam(
                jrecs[i], jh, jidx.suffix_array, jidx.id_pos_map,
                jidx.original_symbols, 0.25, jp, "rg1",
                j_post.SplitMixRng(1000 + i))
            got = t_post.intervals_to_bam(
                trecs[i], th, tidx.suffix_array, tidx.id_pos_map,
                tidx.original_symbols, 0.25, tp, "rg1",
                t_post.SplitMixRng(1000 + i))
            for f in ("name", "flags", "ref_id", "pos", "mapq", "cigar",
                      "sequence", "quals"):
                assert getattr(got, f) == getattr(want, f), (picked[i], f)
            assert [(bytes(t), c, v) for t, c, v in got.tags] == [
                (bytes(t), c, v) for t, c, v in want.tags], picked[i]
            got_all.append(got)
    finally:
        del tidx.id_pos_map.get_reference_identifier
    assert crossed, "no hit position crossed a join"
    joins = set(asm["lay"].starts[1:].tolist())
    assert any(any(j - 130 < p < j for j in joins) for p in crossed)
    md = [dict((bytes(t), v) for t, _c, v in r.tags).get(b"MD", b"")
          for r in got_all if not r.flags & 0x4]
    assert any(set(bytes(m)) & set(b"RYKMSWN") for m in md)


def test_native_bam_holds_the_invariants(asm, tmp_path):
    """The port's host engine through the CLI on every read: the header's
    86 sequences; no record on an X or across a join; M-only records'
    mismatches equal NM; MD's letters the reference's, its original
    symbols on exactly the replaced bases."""
    bam = str(tmp_path / "native.bam")
    assert cli.main(["--threads", "2", "map", "-r", asm["fastq"], "-g",
                     asm["paths"]["t"], "-o", bam, "--engine", "native",
                     *MAP_FLAGS]) == 0
    with open(bam, "rb") as f:
        reader = BamReader(f)
        refs = list(reader.references)
        recs = [(r.name, r.flags, r.ref_id, r.pos, r.mapq, r.cigar_string(),
                 r.sequence, r.quals, list(r.tags)) for r in reader]
    assert len(recs) == N_READS
    got = assembly.check_records(asm["lay"], asm["bases"], refs, recs)
    assert got["mapped"] > N_READS // 2
    assert got["checked"] > N_READS // 2
    assert got["beside_long_run"] > 0 and got["md_original"] > 0
    # a fault the check must see: a record moved onto a long run
    lay = asm["lay"]
    ls, le = lay.long_runs()
    at = int(ls[np.argmax(le - ls)])  # the longest pericentromeric run
    ref_id = int(np.searchsorted(lay.starts, at, "right")) - 1
    bad = next(r for r in recs if not r[1] & 0x4)
    moved = (bad[0], bad[1], ref_id, at - int(lay.starts[ref_id]),
             *bad[4:])
    with pytest.raises(AssertionError, match="long run"):
        assembly.check_records(asm["lay"], asm["bases"], refs, [moved])
    # and an original symbol in MD one base off, or another symbol there
    orig_md = re.compile(rb"^(.*?)(\d+)([RYKMSWN])(\d+)(.*)$")
    for rec in recs:
        md = dict((bytes(t[0]), t[-1]) for t in rec[8]).get(b"MD", b"")
        m = orig_md.match(bytes(md))
        if not rec[1] & 0x4 and m and int(m[2]) > 0:
            break
    head, n, sym, after, tail = m.groups()
    shifted = (head + str(int(n) - 1).encode() + sym
               + str(int(after) + 1).encode() + tail)
    other = head + n + (b"K" if sym != b"K" else b"M") + after + tail
    for bad_md, match in ((shifted, "offsets"), (other, "writes")):
        tags = [t[:-1] + (bad_md,) if bytes(t[0]) == b"MD" else t
                for t in rec[8]]
        with pytest.raises(AssertionError, match=match):
            assembly.check_records(asm["lay"], asm["bases"], refs,
                                   [rec[:8] + (tags,)])
