"""Big mode at the sizes that select it, on the CPU: the synthetic index of
`mapad_tpu_torch/tools/big_rows.py` against the device index both packages
build from the same BWT; `DeviceFmIndex.from_host` packing a chunk of rows
at a time (rows and cache file byte for byte the reference's); the host's
locate past text position 2^31 against the JAX package on a stub suffix
array of a 1.1 Gbp genome's text; `tools/measure_big.py` on the plain
kernels."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from mapad_tpu.index import fmd as jfmd_mod  # noqa: E402
from mapad_tpu.index import runtime as jruntime  # noqa: E402
from mapad_tpu.map import EditOperation as JEditOperation  # noqa: E402
from mapad_tpu.map import HitInterval as JHitInterval  # noqa: E402
from mapad_tpu.map import postprocess as jpost  # noqa: E402
from mapad_tpu.ops import fm as jfm  # noqa: E402
from mapad_tpu.utils.seq import RankTransform as JRankTransform  # noqa: E402
from mapad_tpu_torch.index import fmd as tfmd_mod  # noqa: E402
from mapad_tpu_torch.index import runtime as truntime  # noqa: E402
from mapad_tpu_torch.map import EditOperation, HitInterval  # noqa: E402
from mapad_tpu_torch.map import postprocess as tpost  # noqa: E402
from mapad_tpu_torch.ops import fm as tfm  # noqa: E402
from mapad_tpu_torch.tools import big_rows  # noqa: E402
from mapad_tpu_torch.utils.seq import RankTransform  # noqa: E402
from torch_port_helpers import assert_bits_equal  # noqa: E402

ALPHABET = b"ACGTX$"
# a text past 2^31: a 1.1 Gbp genome, both strands and two sentinels
TEXT_LEN = 2_200_000_002
CONTIG = 50_000_000


def _fmds(bwt, occ_k=64):
    """The same BWT as each package's host FmdIndex."""
    out = []
    for mod, rt in ((tfmd_mod, RankTransform), (jfmd_mod, JRankTransform)):
        out.append(mod.FmdIndex(
            bwt, mod.compute_less(bwt, 6),
            mod.compute_occ_checkpoints(bwt, occ_k, 6), occ_k,
            rt(ALPHABET)))
    return out


def _synthetic_bwt(n, seed):
    return torch.cat([s.reshape(-1) for _, s in big_rows.synthetic_bwt(
        n, seed, "cpu")])[:n].numpy()


@pytest.mark.parametrize("n,chunk_rows", [(928 * 7 + 300, 2),
                                          (928 * 12, 5), (3001, 1)])
def test_synthetic_index_equals_both_device_indexes(monkeypatch, n,
                                                    chunk_rows):
    monkeypatch.setattr(big_rows, "SYNTHETIC_CHUNK_ROWS", chunk_rows)
    syn = big_rows.synthetic_index(n, 11, "cpu")
    bwt = _synthetic_bwt(n, 11)
    assert np.array_equal(np.flatnonzero(bwt == 0),
                          big_rows.synthetic_sentinels(n, 11))
    assert set(np.unique(bwt)) == {0, 1, 2, 3, 4, 5}
    tf, jf = _fmds(bwt)
    want = tfm.DeviceFmIndex.from_host(tf, big=True, device="cpu")
    assert syn.big and syn.occ_k == want.occ_k == 928
    assert syn.text_len == want.text_len == n
    assert torch.equal(syn.rows, want.rows)
    assert torch.equal(syn.less, want.less)
    assert torch.equal(syn.sentinels, want.sentinels)
    jidx = jfm.DeviceFmIndex.from_host(jf, big=True)
    assert_bits_equal(np.asarray(jidx.rows), syn.rows.numpy())
    assert_bits_equal(np.asarray(jidx.less), syn.less.numpy())
    assert_bits_equal(np.asarray(jidx.sentinels), syn.sentinels.numpy())


@pytest.mark.parametrize("n", [928 * 7 + 300, 3001, 4_400_000_000])
def test_synthetic_x_runs(n):
    """X runs of 20 bp to X_RUN_MAX, none touching another, about one a
    SYNTHETIC_X_EVERY symbols; in a table the BWT holds X exactly there
    (sentinels aside)."""
    start, end = big_rows.synthetic_x_runs(n, 64)
    length = end - start
    assert start.size >= 1 and (start[1:] > end[:-1]).all()
    assert length.min() >= big_rows.X_RUN_MIN and end.max() <= n
    assert length.max() <= max(big_rows.X_RUN_MIN, n // 256)
    if n > 2**32:
        assert start.size > 0.95 * (n // big_rows.SYNTHETIC_X_EVERY)
        assert length.max() > 10_000 and 0.003 < length.sum() / n < 0.01
        return
    bwt = _synthetic_bwt(n, 64)
    x = np.zeros(n, dtype=bool)
    for a, b in zip(start, end):
        x[a:b] = True
    sent = np.asarray(big_rows.synthetic_sentinels(n, 64))
    x[sent] = False
    assert np.array_equal(bwt == 5, x)


def test_synthetic_bwt_does_not_depend_on_the_chunk(monkeypatch):
    n = 928 * 9 + 17
    got = []
    for chunk_rows in (2, 4):
        monkeypatch.setattr(big_rows, "SYNTHETIC_CHUNK_ROWS", chunk_rows)
        got.append(_synthetic_bwt(n, 3))
    assert np.array_equal(*got)


def test_text_strings_never_run_empty(monkeypatch):
    n = 928 * 30 + 5
    monkeypatch.setattr(big_rows, "SYNTHETIC_CHUNK_ROWS", 7)
    syn = big_rows.synthetic_index(n, 5, "cpu")
    tf, _jf = _fmds(_synthetic_bwt(n, 5))
    strings = big_rows.text_strings(syn, 24, 40, 9)
    assert strings.shape == (24, 40)
    assert int(strings.min()) >= 1 and int(strings.max()) <= 4
    for s in strings.tolist():
        iv = tf.init_interval()
        for c in reversed(s):
            iv = tf.backward_ext(iv, b"ACGT"[c - 1])
        assert iv.size > 0


def _random_bwt(n, seed):
    """A genome's index BWT stand-in: ranks 1..5 (X too) and two
    sentinels."""
    rng = np.random.default_rng(seed)
    bwt = rng.integers(1, 6, size=n).astype(np.uint8)
    bwt[rng.choice(n, size=2, replace=False)] = 0
    return bwt


@pytest.mark.parametrize("big", [False, True])
@pytest.mark.parametrize("chunk_rows", [1, 3, 1 << 15])
def test_from_host_chunks_rows_and_cache(monkeypatch, tmp_path, big,
                                        chunk_rows):
    """A chunk smaller than the table: the rows, and the cache file byte
    for byte, equal the JAX package's; the cache read back by chunks gives
    them again."""
    monkeypatch.setattr(tfm, "PACK_CHUNK_ROWS", chunk_rows)
    n = 976 * 9 + 123
    tf, jf = _fmds(_random_bwt(n, 21))
    jdir, tdir = tmp_path / "j", tmp_path / "t"
    jdir.mkdir()
    tdir.mkdir()
    jf.cache_dir, tf.cache_dir = str(jdir), str(tdir)
    jidx = jfm.DeviceFmIndex.from_host(jf, big=big)
    got = tfm.DeviceFmIndex.from_host(tf, big=big, device="cpu")
    assert_bits_equal(np.asarray(jidx.rows), got.rows.numpy())
    k = 928 if big else 976
    name = f"device_rows_k{k}{'_big' if big else ''}.npy"
    assert (jdir / name).read_bytes() == (tdir / name).read_bytes()
    assert sorted(p.name for p in tdir.iterdir()) == [name]
    again = tfm.DeviceFmIndex.from_host(tf, big=big, device="cpu")
    assert torch.equal(again.rows, got.rows)


def test_from_host_without_a_writable_bundle(monkeypatch, tmp_path):
    """A cache directory that cannot be written gets no cache and leaves
    no temporary file; the rows are the same."""
    monkeypatch.setattr(tfm, "PACK_CHUNK_ROWS", 2)
    tf, jf = _fmds(_random_bwt(928 * 5 + 9, 22))
    tf.cache_dir = str(tmp_path / "missing")
    got = tfm.DeviceFmIndex.from_host(tf, big=True, device="cpu")
    assert_bits_equal(np.asarray(jfm.DeviceFmIndex.from_host(jf, big=True)
                                 .rows), got.rows.numpy())
    assert list(tmp_path.iterdir()) == []


def test_from_host_takes_the_index_checkpoints_at_its_spacing(monkeypatch):
    """Where the index's checkpoint spacing is the device k, its own
    checkpoints go into the rows (shifted ones show it), as in the
    JAX package."""
    monkeypatch.setattr(tfm, "PACK_CHUNK_ROWS", 2)
    n = 928 * 6 + 40
    bwt = _random_bwt(n, 4)
    tf, jf = _fmds(bwt, occ_k=928)
    shift = (3 << 32) + 7
    tf.occ_cp = tf.occ_cp + shift
    jf.occ_cp = jf.occ_cp + shift
    got = tfm.DeviceFmIndex.from_host(tf, big=True, device="cpu")
    jidx = jfm.DeviceFmIndex.from_host(jf, big=True)
    assert_bits_equal(np.asarray(jidx.rows), got.rows.numpy())
    assert int(got.rows[1, 7]) == 3  # a checkpoint's high word


# --- the host's locate past text position 2^31 ---


class _StubSA:
    """The sampled suffix array of a 2,200,000,002-symbol text, stubbed:
    rows `lower + i` hold `values[i]`."""

    def __init__(self, lower, values):
        self.lower, self.values = lower, list(values)

    def __len__(self):
        return TEXT_LEN

    def get(self, index):
        i = index - self.lower
        return self.values[i] if 0 <= i < len(self.values) else None


def _id_pos(mod):
    return mod.FastaIdPositions(
        mod.FastaIdPosition(o, o + CONTIG - 1, f"big_chr{i + 1}")
        for i, o in enumerate(range(0, TEXT_LEN // 2 - 1, CONTIG)))


# suffix array values: the forward half (< 1,100,000,001), the reverse
# half on both sides of 2^31, contig boundaries in both halves, the ends
SA_VALUES = [
    0, 1, 49_999_960, 49_999_961, 50_000_000, 1_049_999_999,
    1_099_999_960, 1_099_999_999, 1_100_000_000, 1_100_000_001,
    1_100_000_002, 1_149_999_999, 1_150_000_001,
    2**31 - 41, 2**31 - 40, 2**31 - 1, 2**31, 2**31 + 1,
    2_150_000_001 - 40, 2_150_000_001, 2_199_999_960, 2_199_999_999,
    2_200_000_000, 2_200_000_001,
]


@pytest.mark.parametrize("lower", [17, 2**31 - 10, 2_199_999_970])
@pytest.mark.parametrize("eff_len", [1, 40])
def test_interval2coordinate_past_2_31(lower, eff_len):
    values = SA_VALUES
    out = []
    for fmd, runtime, post, edit, hit_cls in (
            (tfmd_mod, truntime, tpost, EditOperation, HitInterval),
            (jfmd_mod, jruntime, jpost, JEditOperation, JHitInterval)):
        ops = [edit(1, i, 0) for i in range(eff_len)]
        hit = hit_cls(fmd.BiInterval(lower, 5, len(values)),
                      np.float32(-1.5), ops)
        got = list(post.interval2coordinate(
            hit, _StubSA(lower, values), _id_pos(runtime),
            post.SplitMixRng(2024)))
        out.append([(o.tid, o.contig_name, o.relative_pos, o.absolute_pos,
                     o.forward, o.num_skipped) for o in got])
    assert out[0] == out[1]
    reverse = [o for o in out[0] if not o[4]]
    assert reverse and any(o[3] < 50_000_000 for o in reverse)
    assert len(out[0]) < len(values)  # reads over a boundary are dropped


@pytest.mark.parametrize("length", [1, 40, 120])
def test_reference_identifier_batch_past_2_31(length):
    rng = np.random.default_rng(length)
    pos = np.concatenate([
        np.asarray(SA_VALUES, dtype=np.int64) % (TEXT_LEN // 2 - 1),
        np.arange(-3, 3, dtype=np.int64) + CONTIG * 21,
        rng.integers(0, TEXT_LEN // 2 - 1, size=200),
        [2**31 - 1, 2**31, 2**32],
    ])
    lens = np.full(pos.shape, length, dtype=np.int64)
    t_tid, t_rel = _id_pos(truntime).get_reference_identifier_batch(pos, lens)
    j_tid, j_rel = _id_pos(jruntime).get_reference_identifier_batch(pos, lens)
    assert_bits_equal(j_tid, t_tid)
    assert_bits_equal(j_rel, t_rel)
    for p, tid, rel in zip(pos[:40], t_tid[:40], t_rel[:40]):
        one = _id_pos(truntime).get_reference_identifier(int(p), length)
        assert (one is None) == (tid == -1)
        if one is not None:
            assert one[:2] == (tid, rel)


# --- tools/measure_big.py on the plain kernels ---


def test_measure_big_on_the_plain_kernels():
    from mapad_tpu_torch.index.builder import build_from_sequences
    from mapad_tpu_torch.index.runtime import Index, OriginalSymbols
    from mapad_tpu_torch.map.record import Record
    from mapad_tpu_torch.tools import measure_big
    from torch_port_helpers import adna_params, bench_reads, bench_ref

    fmd, ssa, idp, _orig = build_from_sequences([("chr1", bench_ref())])
    index = Index(fmd, ssa, idp, OriginalSymbols.from_dict({}), {})
    recs = [Record(sequence=s, base_qualities=bytes([30] * len(s)))
            for s in bench_reads()[:12]]
    params = adna_params("mapad_tpu_torch")
    with pytest.raises(AssertionError, match="did not select int64"):
        measure_big.measure(index, params, recs, lanes=8, steps=256,
                            cap=128, device="cpu")
    m = measure_big.measure(index, params, recs, lanes=8, steps=256,
                            cap=128, device="cpu", big=True)
    assert m["big"] and m["reads"] == 12 and m["lanes"] == 8
    assert 0 < m["steps"] <= 256 and m["chains"] > 0
    assert m["max_lower"] >= 0 and m["invocation_peak_gb"] == 0
    assert m["store_gb"] == 8 * 257 * 9 * 11 * 4 / 1e9
    assert "us a step" in measure_big.line(m)


# --- the index build's host memory: the same bundle with every
# genome-sized buffer dropped early and the whole-BWT scans by chunks ---


def test_index_bundle_equals_the_jax_package(tmp_path):
    import json
    import os

    from mapad_tpu.index import builder as jbuilder
    from mapad_tpu_torch.index import builder as tbuilder

    rng = np.random.default_rng(15)
    contigs = []
    for i, ln in enumerate((5000, 3200, 7100)):
        seq = bytearray(rng.choice(np.frombuffer(b"ACGTacgt", np.uint8),
                                   size=ln).tobytes())
        seq[100:140] = b"N" * 40  # a long ambiguous run: X
        seq[300:305] = b"NRYKM"  # short runs: seeded bases
        contigs.append((f"chr{i + 1}", bytes(seq)))
    text = "".join(f">{n} desc\n" + "\n".join(
        s[j : j + 60].decode() for j in range(0, len(s), 60)) + "\n"
        for n, s in contigs)
    paths = {}
    for tag, builder in (("j", jbuilder), ("t", tbuilder)):
        d = tmp_path / tag
        d.mkdir()
        paths[tag] = str(d / "ref.fa")
        open(paths[tag], "w").write(text)
        builder.run(paths[tag])
    jdir, tdir = paths["j"] + ".tpx", paths["t"] + ".tpx"
    names = sorted(os.listdir(jdir))
    assert names == sorted(os.listdir(tdir)) and "bwt.npy" in names
    for name in names:
        j = open(os.path.join(jdir, name), "rb").read()
        t = open(os.path.join(tdir, name), "rb").read()
        if name == "meta.json":
            assert json.loads(j) == json.loads(t)
        else:
            assert j == t, name


def test_whole_bwt_scans_by_chunks(monkeypatch):
    from mapad_tpu_torch.index import fmd as fmd_mod
    from mapad_tpu_torch.index.runtime import SampledSuffixArray

    bwt = _random_bwt(5000, 8)
    bwt[[31, 64, 4999]] = 0
    sa = np.random.default_rng(9).permutation(5000).astype(np.int64)
    want_less = jfmd_mod.compute_less(bwt, 6)
    tf, jf = _fmds(bwt)
    want = jruntime.SampledSuffixArray.sample_from(jf, sa, 32)
    assert len(want.extra_keys) >= 3
    for chunk in (7, 64, 1 << 26):
        monkeypatch.setattr(fmd_mod, "SCAN_CHUNK", chunk)
        assert_bits_equal(want_less, fmd_mod.compute_less(bwt, 6))
        assert_bits_equal(np.flatnonzero(bwt == 0).astype(np.int64),
                          fmd_mod.symbol_positions(bwt, 0))
        got = SampledSuffixArray.sample_from(tf, sa, 32)
        assert_bits_equal(want.extra_keys, got.extra_keys)
        assert_bits_equal(want.extra_vals, got.extra_vals)
        assert_bits_equal(want.sample, got.sample)
        assert_bits_equal(jf.sentinel_occ, _fmds(bwt)[0].sentinel_occ)


def test_edge_ranks():
    n = 928 * 4 + 10
    syn = big_rows.synthetic_index(n, 2, "cpu")
    r = big_rows.edge_ranks(syn, 64, 3)
    assert r.shape == (64,) and r.dtype == torch.int64
    assert r[:10].tolist() == [-1, 0, 1, 927, 928, 929, 928 * 4 - 1,
                               928 * 4, n - 2, n - 1]
    assert int(r.min()) == -1 and int(r.max()) < n
    assert torch.equal(r, big_rows.edge_ranks(syn, 64, 3))


# --- the host memory of both repairs, by tracemalloc (numpy's buffers) ---


def _numpy_peak(fn):
    import tracemalloc

    tracemalloc.start()
    try:
        fn()
        return tracemalloc.get_traced_memory()[1]
    finally:
        tracemalloc.stop()


def test_compute_less_holds_no_whole_text_temporary(monkeypatch):
    """np.bincount widens its input to int64: over the whole BWT that is 8
    bytes a symbol (17.6 GB at a 2.2e9-symbol text)."""
    from mapad_tpu_torch.index import fmd as fmd_mod

    bwt = _random_bwt(1 << 22, 5)
    monkeypatch.setattr(fmd_mod, "SCAN_CHUNK", 1 << 14)
    assert _numpy_peak(lambda: fmd_mod.compute_less(bwt, 6)) < len(bwt) // 8
    assert _numpy_peak(lambda: fmd_mod.symbol_positions(bwt, 0)) \
        < len(bwt) // 8


def test_from_host_holds_no_whole_text_copy(monkeypatch):
    """The rows by chunks: no host buffer the size of the text (the JAX
    package's whole-array packing holds 1 + 4 + 0.5 bytes a symbol and
    two copies of the rows)."""
    monkeypatch.setattr(tfm, "PACK_CHUNK_ROWS", 16)
    n = 928 * 2000 + 7
    tf, jf = _fmds(_random_bwt(n, 6))
    peak = _numpy_peak(lambda: tfm.DeviceFmIndex.from_host(
        tf, big=True, device="cpu"))
    assert peak < n // 8
    assert _numpy_peak(lambda: jfm.DeviceFmIndex.from_host(
        jf, big=True)) > 4 * n
