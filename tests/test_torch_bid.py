"""Kernel K7's plain version (`compute_bi_d`, mapad_tpu_torch/ops/bi_d.py)
against the JAX package's ops/bi_d.py, bit for bit: small and big (int64)
index, forward part on and off, blocks whose longest read is shorter than
the pattern axis (the lock-step loop's `n_steps` shows in the padding
columns), and against the host C++ Bi-D over each read's own positions."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from mapad_tpu.index.builder import build_auxiliary_structures  # noqa: E402
from mapad_tpu.ops import bi_d as jbid  # noqa: E402
from mapad_tpu.ops import fm as jfm  # noqa: E402
from mapad_tpu_torch.index.builder import (  # noqa: E402
    build_auxiliary_structures as t_build,
)
from mapad_tpu_torch.map import native_search  # noqa: E402
from mapad_tpu_torch.ops import bi_d as tbid  # noqa: E402
from mapad_tpu_torch.ops import fm as tfm  # noqa: E402
from torch_port_helpers import assert_bits_equal  # noqa: E402

GENOME_LEN = 6000


@pytest.fixture(scope="module")
def indexes():
    rng = np.random.default_rng(1)
    genome = bytes(rng.choice(np.frombuffer(b"ACGT", np.uint8),
                              size=GENOME_LEN))
    jfmd, _ = build_auxiliary_structures(genome, b"ACGT")
    tfmd, _ = t_build(genome, b"ACGT")
    out = {"genome": genome, "tfmd": tfmd}
    for big in (False, True):
        ji = jfm.DeviceFmIndex.from_host(jfmd, big=big)
        ti = tfm.DeviceFmIndex.from_numpy(
            np.asarray(ji.rows), np.asarray(ji.less),
            np.asarray(ji.sentinels), ji.occ_k, ji.text_len, big,
            device="cpu",
        )
        out[big] = (ji, ti)
    return out


def _block(genome, seed, L=12, M=48, longest=40):
    """Reads cut from the genome with a few substitutions and invalid
    symbols (rank 0), an empty read, a read with no backward part and one
    with no forward part; negative penalty elements."""
    rng = np.random.default_rng(seed)
    n = rng.integers(0, longest + 1, size=L).astype(np.int32)
    n[0] = 0
    n[1] = longest
    split = (n * rng.uniform(0.3, 1, size=L)).astype(np.int32)
    split[1] = n[1]
    split[2] = 0
    rank = np.zeros((L, M), np.int32)
    pen = np.zeros((L, M), np.float32)
    for i in range(L):
        st = int(rng.integers(0, GENOME_LEN - M))
        rank[i, : n[i]] = [b"ACGT".index(c) + 1
                           for c in genome[st : st + n[i]]]
        for _ in range(3):
            if n[i]:
                rank[i, rng.integers(0, n[i])] = rng.integers(0, 5)
        pen[i, : n[i]] = -rng.uniform(0.1, 5, size=n[i]).astype(np.float32)
    return rank, pen, n, split


def _both(indexes, big, block, forward_part, steps=None):
    ji, ti = indexes[big]
    rank, pen, n, split = block
    want = np.asarray(jbid.compute_bi_d(
        ji, jnp.asarray(rank), jnp.asarray(pen), jnp.asarray(n),
        jnp.asarray(split), compute_forward_part=forward_part,
    ))
    got = tbid.compute_bi_d(
        ti, torch.from_numpy(rank), torch.from_numpy(pen),
        torch.from_numpy(n), torch.from_numpy(split), forward_part,
        steps=steps,
    ).numpy()
    return want, got


@pytest.mark.parametrize("big", [False, True])
@pytest.mark.parametrize("forward_part", [False, True])
@pytest.mark.parametrize("longest", [40, 48, 9])
def test_compute_bi_d_plain_equals_jax(indexes, big, forward_part, longest):
    """longest < M: the columns past the block's longest part stay 0, those
    up to it repeat the last sum, for every read of the block."""
    block = _block(indexes["genome"], seed=longest, longest=longest)
    want, got = _both(indexes, big, block, forward_part)
    assert_bits_equal(want, got)
    assert (want != 0).any()
    # the engine passes the longest parts from the host: same result
    _rank, _pen, n, split = block
    steps = (int(split.max()), int((n - split).max()))
    _want, got2 = _both(indexes, big, block, forward_part, steps=steps)
    assert_bits_equal(want, got2)


def test_padding_columns_follow_the_blocks_longest_read(indexes):
    """The same read in two blocks: its padding columns differ with the
    longest read beside it, in JAX and in the port alike."""
    rank, pen, n, split = _block(indexes["genome"], seed=3, L=4, longest=20)
    n[2:] = (12, 10)
    rank[2:, :12] = np.maximum(rank[2:, :12], 1)
    rank[2:, 5] = 0  # an invalid symbol: every walk past it fails once
    pen[2:, :12] = -1.5
    split[:] = n  # backward-only
    short = (rank[2:], pen[2:], n[2:], split[2:])
    a_want, a_got = _both(indexes, True, (rank, pen, n, split), False)
    b_want, b_got = _both(indexes, True, short, False)
    assert_bits_equal(a_want, a_got)
    assert_bits_equal(b_want, b_got)
    assert int(n[2:].max()) < int(n.max())
    assert a_got[2, 15] != 0 and b_got[0, 15] == 0


def test_compute_bi_d_equals_host_bid(indexes):
    """Over each read's own positions the composite equals the host C++
    Bi-D (the small-genome default) bit for bit."""
    if not native_search.available():
        pytest.skip("needs a C++ compiler for the host Bi-D")
    block = _block(indexes["genome"], seed=21)
    rank, pen, n, split = block
    host = native_search.NativeBiD(indexes["tfmd"]).compute(
        rank.astype(np.uint8), pen, n, split, threads=1)
    for big in (False, True):
        _want, got = _both(indexes, big, block, True)
        for i, ln in enumerate(n):
            assert_bits_equal(host[i, :ln], got[i, :ln], (big, i))


def test_bi_d_get(indexes):
    block = _block(indexes["genome"], seed=8)
    _rank, _pen, n, split = block
    want, got = _both(indexes, False, block, True)
    rng = np.random.default_rng(4)
    L, M = want.shape
    bk = rng.integers(-2, M + 2, size=L).astype(np.int32)
    fw = rng.integers(-2, M + 2, size=L).astype(np.int32)
    w = jbid.bi_d_get(jnp.asarray(want), jnp.asarray(split), jnp.asarray(n),
                      jnp.asarray(bk), jnp.asarray(fw))
    g = tbid.bi_d_get(torch.from_numpy(got), torch.from_numpy(split),
                      torch.from_numpy(n), torch.from_numpy(bk),
                      torch.from_numpy(fw))
    assert_bits_equal(np.asarray(w), g.numpy())
