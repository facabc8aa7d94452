"""Kernel K1's plain version (rank query + 4-symbol extension sweep,
mapad_tpu_torch/ops/fm.py) and the device index build against the JAX
package's ops/fm.py, bit for bit on a random genome's index."""

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
