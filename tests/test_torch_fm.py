"""Kernel K1's plain version (rank query + 4-symbol extension sweep,
mapad_tpu_torch/ops/fm.py) and the device index build against the JAX
package's ops/fm.py, bit for bit on a random genome's index, with int32
intervals and with the int64 intervals of big mode."""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from mapad_tpu.index.builder import build_auxiliary_structures  # noqa: E402
from mapad_tpu.ops import fm as jfm  # noqa: E402
from mapad_tpu_torch.index.builder import (  # noqa: E402
    build_auxiliary_structures as t_build,
)
from mapad_tpu_torch.ops import fm as tfm  # noqa: E402
from torch_port_helpers import assert_bits_equal  # noqa: E402


@pytest.fixture(scope="module")
def indexes():
    rng = np.random.default_rng(2024)
    genome = bytes(rng.choice(np.frombuffer(b"ACGT", np.uint8), size=6000))
    jfmd, _ = build_auxiliary_structures(genome, b"ACGT")
    tfmd, _ = t_build(genome, b"ACGT")
    jidx = jfm.DeviceFmIndex.from_host(jfmd)
    tidx = tfm.DeviceFmIndex.from_host(tfmd, device="cpu")
    return jfmd, tfmd, jidx, tidx


def _queries(n, L=256, seed=7):
    rng = np.random.default_rng(seed)
    lower = rng.integers(0, n, size=L).astype(np.int32)
    size = (rng.integers(0, n + 1, size=L) % (n - lower + 1)).astype(np.int32)
    lower_rev = rng.integers(0, n, size=L).astype(np.int32)
    lower[:8] = 0  # the lower == 0 sentinel branch
    size[:4] = n - lower[:4]
    c = rng.integers(-1, 7, size=L).astype(np.int32)
    return lower, lower_rev, size, c


def test_device_rows_equal(indexes):
    _jfmd, _tfmd, jidx, tidx = indexes
    assert tidx.occ_k == jidx.occ_k and tidx.text_len == jidx.text_len
    assert_bits_equal(np.asarray(jidx.rows), tidx.rows.numpy())
    assert_bits_equal(np.asarray(jidx.less), tidx.less.numpy())
    assert_bits_equal(np.asarray(jidx.sentinels), tidx.sentinels.numpy())
    again = tfm.DeviceFmIndex.from_numpy(
        np.asarray(jidx.rows), np.asarray(jidx.less),
        np.asarray(jidx.sentinels), jidx.occ_k, jidx.text_len, device="cpu",
    )
    assert torch.equal(again.rows, tidx.rows)


def test_device_rows_cache_shared(indexes, tmp_path):
    jfmd, tfmd, jidx, _ = indexes
    jdir, tdir = tmp_path / "j", tmp_path / "t"
    jdir.mkdir()
    tdir.mkdir()
    jfmd.cache_dir, tfmd.cache_dir = str(jdir), str(tdir)
    try:
        jfm.DeviceFmIndex.from_host(jfmd)
        tfm.DeviceFmIndex.from_host(tfmd, device="cpu")
        name = "device_rows_k976.npy"
        assert (jdir / name).read_bytes() == (tdir / name).read_bytes()
        # the port reads the JAX package's cache file
        tfmd.cache_dir = str(jdir)
        got = tfm.DeviceFmIndex.from_host(tfmd, device="cpu")
        assert_bits_equal(np.asarray(jidx.rows), got.rows.numpy())
        assert sorted(os.listdir(jdir)) == [name]
    finally:
        jfmd.cache_dir = tfmd.cache_dir = None


@pytest.mark.parametrize("seed", [7, 8])
def test_extend_batch(indexes, seed):
    _jfmd, _tfmd, jidx, tidx = indexes
    lower, lower_rev, size, _c = _queries(jidx.text_len, seed=seed)
    want = jfm.extend_batch(jidx, jnp.asarray(lower), jnp.asarray(lower_rev),
                            jnp.asarray(size))
    got = tfm.extend_batch(tidx, torch.from_numpy(lower),
                           torch.from_numpy(lower_rev), torch.from_numpy(size))
    for w, g in zip(want, got):
        assert_bits_equal(np.asarray(w), g.numpy())


@pytest.mark.parametrize("fn", ["backward_ext_by_rank", "forward_ext_by_rank"])
def test_ext_by_rank(indexes, fn):
    _jfmd, _tfmd, jidx, tidx = indexes
    lower, lower_rev, size, c = _queries(jidx.text_len, seed=9)
    want = getattr(jfm, fn)(jidx, jnp.asarray(lower), jnp.asarray(lower_rev),
                            jnp.asarray(size), jnp.asarray(c))
    got = getattr(tfm, fn)(tidx, torch.from_numpy(lower),
                           torch.from_numpy(lower_rev),
                           torch.from_numpy(size), torch.from_numpy(c))
    for w, g in zip(want, got):
        assert_bits_equal(np.asarray(w), g.numpy())


# --- big mode: int64 intervals, lo/hi checkpoint words, k = 928 ---


@pytest.fixture(scope="module")
def big_indexes(indexes):
    jfmd, tfmd, _jidx, _tidx = indexes
    return (jfm.DeviceFmIndex.from_host(jfmd, big=True),
            tfm.DeviceFmIndex.from_host(tfmd, big=True, device="cpu"))


def _to_torch_index(jidx):
    return tfm.DeviceFmIndex.from_numpy(
        np.asarray(jidx.rows), np.asarray(jidx.less),
        np.asarray(jidx.sentinels), jidx.occ_k, jidx.text_len, jidx.big,
        device="cpu",
    )


def test_big_device_rows_equal(big_indexes):
    jidx, tidx = big_indexes
    assert tidx.big and tidx.occ_k == jidx.occ_k == 928
    assert tidx.text_len == jidx.text_len
    assert tidx.less.dtype == tidx.sentinels.dtype == torch.int64
    assert tidx.idx_dtype == torch.int64 and tidx.n_cp_cols == 12
    assert_bits_equal(np.asarray(jidx.rows), tidx.rows.numpy())
    assert_bits_equal(np.asarray(jidx.less), tidx.less.numpy())
    assert_bits_equal(np.asarray(jidx.sentinels), tidx.sentinels.numpy())
    again = _to_torch_index(jidx)
    assert torch.equal(again.rows, tidx.rows)
    assert torch.equal(again.less, tidx.less)


def test_big_device_rows_cache_shared(indexes, tmp_path):
    jfmd, tfmd, _jidx, _tidx = indexes
    jdir, tdir = tmp_path / "j", tmp_path / "t"
    jdir.mkdir()
    tdir.mkdir()
    jfmd.cache_dir, tfmd.cache_dir = str(jdir), str(tdir)
    try:
        jfm.DeviceFmIndex.from_host(jfmd, big=True)
        tfm.DeviceFmIndex.from_host(tfmd, big=True, device="cpu")
        name = "device_rows_k928_big.npy"
        assert (jdir / name).read_bytes() == (tdir / name).read_bytes()
        assert sorted(os.listdir(tdir)) == [name]
    finally:
        jfmd.cache_dir = tfmd.cache_dir = None


def test_big_is_off_for_a_small_text(indexes):
    """`big=None` asks the text: int64 mode only from 2^31-1 symbols on."""
    _jfmd, tfmd, jidx, _tidx = indexes
    auto = tfm.DeviceFmIndex.from_host(tfmd, device="cpu")
    assert not auto.big and not jidx.big and auto.less.dtype == torch.int32


@pytest.mark.parametrize("seed", [7, 8])
def test_big_extend_batch(big_indexes, seed):
    jidx, tidx = big_indexes
    q = [a.astype(np.int64) for a in _queries(jidx.text_len, seed=seed)[:3]]
    want = jfm.extend_batch(jidx, *[jnp.asarray(a) for a in q])
    got = tfm.extend_batch(tidx, *[torch.from_numpy(a) for a in q])
    for w, g in zip(want, got):
        assert g.dtype == torch.int64
        assert_bits_equal(np.asarray(w), g.numpy())


def test_big_extend_batch_garbage_lanes_wrap(big_indexes):
    """Intervals no read holds (lanes without a read compute on garbage):
    huge and negative int64 values wrap and clamp as XLA's do."""
    jidx, tidx = big_indexes
    rng = np.random.default_rng(31)
    q = [rng.integers(-2**63, 2**63 - 1, size=64, dtype=np.int64)
         for _ in range(3)]
    q[0][:8] = rng.integers(2**40, 2**62, size=8)
    want = jfm.extend_batch(jidx, *[jnp.asarray(a) for a in q])
    got = tfm.extend_batch(tidx, *[torch.from_numpy(a) for a in q])
    for w, g in zip(want, got):
        assert_bits_equal(np.asarray(w), g.numpy())


def _shifted(jidx, off_occ, off_less):
    """Every absolute count moved past 2^32 (nonzero checkpoint high
    words), as a genome-scale index has them."""
    rows = np.asarray(jidx.rows).copy()
    cp = ((rows[:, 0:6].astype(np.int64) & 0xFFFFFFFF)
          | (rows[:, 6:12].astype(np.int64) << 32)) + off_occ
    rows[:, 0:6] = (cp & 0xFFFFFFFF).astype(np.uint32).view(np.int32)
    rows[:, 6:12] = (cp >> 32).astype(np.int32)
    return jfm.DeviceFmIndex(
        rows=jnp.asarray(rows), less=jnp.asarray(np.asarray(jidx.less)
                                                 + off_less),
        sentinels=jidx.sentinels, occ_k=jidx.occ_k, text_len=jidx.text_len,
        big=True,
    )


def test_big_extend_batch_beyond_int32(big_indexes):
    jidx, tidx = big_indexes
    off_occ, off_less = (3 << 32) + 12345, (5 << 32) + 999
    jshift = _shifted(jidx, off_occ, off_less)
    tshift = _to_torch_index(jshift)
    lower, lower_rev, size, _c = _queries(jidx.text_len, seed=11)
    lower[:8] = np.arange(1, 9)  # lower == 0 takes no checkpoint
    q = [a.astype(np.int64) for a in (lower, lower_rev, size)]
    want = jfm.extend_batch(jshift, *[jnp.asarray(a) for a in q])
    got = tfm.extend_batch(tshift, *[torch.from_numpy(a) for a in q])
    for w, g in zip(want, got):
        assert_bits_equal(np.asarray(w), g.numpy())
    base = tfm.extend_batch(tidx, *[torch.from_numpy(a) for a in q])
    assert torch.equal(got[0], base[0] + off_occ + off_less)
    assert torch.equal(got[1], base[1]) and torch.equal(got[2], base[2])
    assert int(got[0].min()) > 2**32


@pytest.mark.parametrize("fn", ["backward_ext_by_rank", "forward_ext_by_rank"])
def test_big_ext_by_rank(big_indexes, fn):
    jidx, tidx = big_indexes
    lower, lower_rev, size, c = _queries(jidx.text_len, seed=9)
    q = [a.astype(np.int64) for a in (lower, lower_rev, size)]
    want = getattr(jfm, fn)(jidx, *[jnp.asarray(a) for a in q],
                            jnp.asarray(c))
    got = getattr(tfm, fn)(tidx, *[torch.from_numpy(a) for a in q],
                           torch.from_numpy(c))
    for w, g in zip(want, got):
        assert_bits_equal(np.asarray(w), g.numpy())
    s = torch.from_numpy(np.arange(-3, 5, dtype=np.int64))
    want_s = jfm.sentinel_count(jidx, jnp.asarray(s.numpy()))
    assert_bits_equal(np.asarray(want_s), tfm.sentinel_count(tidx, s).numpy())
