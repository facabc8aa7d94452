"""Kernel K4's plain version (`_unpack_prep_lut_plain`) against the JAX
package's `_unpack_prep_lut`, bit for bit, with and without the Bi-D RLE,
and kernel K6's (`_unpack_prep_full_plain`) against `_unpack_prep_full`,
all nine outputs."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from mapad_tpu.ops import engine as jeng  # noqa: E402
from mapad_tpu_torch.ops import engine as teng  # noqa: E402
from mapad_tpu_torch.ops import prep  # noqa: E402
from torch_port_helpers import (  # noqa: E402
    adna_params,
    assert_bits_equal,
    bid_rows,
)

R, M = 10, 64


def _blob(rle: bool, seed: int):
    """An upload blob as ops/engine.py `_prepare` lays it out: consts,
    Bi-D (RLE or raw), 10-bit (class, qual) cells; one read empty and, with
    rle, rows past 32 runs neutralized with thresh = +inf."""
    rng = np.random.default_rng(seed)
    n = rng.integers(1, M + 1, size=R).astype(np.int32)
    n[3] = 0
    seqs = np.zeros((R, M), np.uint8)
    quals = np.zeros((R, M), np.uint8)
    for i, ln in enumerate(n):
        seqs[i, :ln] = rng.choice(np.frombuffer(b"ACGTN", np.uint8), size=ln)
        quals[i, :ln] = rng.integers(0, prep._DEV_LUT_Q, size=ln)
    bid = bid_rows(seed, R, M)
    consts = [n, rng.integers(0, M, size=R).astype(np.int32),
              rng.uniform(0.5, 2, R).astype(np.float32),
              rng.uniform(-9, -1, R).astype(np.float32),
              rng.uniform(-3, -1, R).astype(np.float32)]
    parts = [c.view(np.int32) for c in consts]
    if rle:
        br, vv, ovf = prep._pack_bid_rle(bid)
        assert ovf.size
        parts[3] = parts[3].copy()
        parts[3][ovf] = np.float32(np.inf).view(np.int32)
        parts += [br, vv]
    else:
        parts.append(bid.reshape(-1).view(np.int32))
    parts.append(prep._pack_cq10(seqs, quals))
    return np.concatenate(parts).astype(np.int32)


@pytest.mark.parametrize("rle", [False, True])
def test_unpack_prep_lut_plain_equals_jax(rle):
    p = adna_params("mapad_tpu_torch")
    tab, _pen, off = prep._build_all_lut(p.difference_model, p, M)
    blob = _blob(rle, seed=11 if rle else 12)
    want = jeng._unpack_prep_lut(
        jnp.asarray(blob), jnp.asarray(tab), jnp.asarray(off), R, M,
        prep._DEV_LUT_Q, rle=rle,
    )
    got = teng._unpack_prep_lut(
        torch.from_numpy(blob), torch.from_numpy(tab), torch.from_numpy(off),
        R, M, prep._DEV_LUT_Q, rle=rle,
    )
    names = ("n", "split", "scale", "thresh", "repr_mm", "slut")
    for name, w, g in zip(names, want, got):
        assert_bits_equal(np.asarray(w), g.numpy(), name)


def test_unpack_prep_full_blob_is_a_view():
    rng = np.random.default_rng(5)
    blob = rng.integers(-2**31, 2**31 - 1, size=5 * R + R * M * 6,
                        dtype=np.int64).astype(np.int32)
    want = jeng._unpack_prep(jnp.asarray(blob), R, M)
    got = teng._unpack_prep(torch.from_numpy(blob), R, M)
    for w, g in zip(want, got):
        assert_bits_equal(np.asarray(w), g.numpy())


@pytest.mark.parametrize("seed,m", [(21, 64), (22, 34), (23, 16)])
def test_unpack_prep_full_plain_equals_jax(seed, m):
    """K6: consts + (class, qual) cells -> the nine dense inputs; reads of
    length 0, odd lengths, non-ACGT bytes, and a pattern axis that is not a
    multiple of three cells."""
    rng = np.random.default_rng(seed)
    p = adna_params("mapad_tpu_torch")
    tab, pen_tab, off = prep._build_all_lut(p.difference_model, p, M)
    n = rng.integers(1, m + 1, size=R).astype(np.int32)
    n[3] = 0
    n[4] = m
    n[5] = 7
    seqs = np.zeros((R, m), np.uint8)
    quals = np.zeros((R, m), np.uint8)
    for i, ln in enumerate(n):
        seqs[i, :ln] = rng.choice(np.frombuffer(b"ACGTNacgtRY", np.uint8),
                                  size=ln)
        quals[i, :ln] = rng.integers(0, prep._DEV_LUT_Q, size=ln)
    consts = [n, (n // 2).astype(np.int32),
              rng.uniform(0.5, 2, R).astype(np.float32),
              rng.uniform(-9, -1, R).astype(np.float32),
              rng.uniform(-3, -1, R).astype(np.float32)]
    blob = np.concatenate(
        [c.view(np.int32) for c in consts] + [prep._pack_cq10(seqs, quals)]
    ).astype(np.int32)
    assert blob.size == 5 * R + prep._cq_words(R * m)
    want = jeng._unpack_prep_full(
        jnp.asarray(blob), jnp.asarray(tab), jnp.asarray(pen_tab),
        jnp.asarray(off), R, m, prep._DEV_LUT_Q,
    )
    got = teng._unpack_prep_full(
        torch.from_numpy(blob), torch.from_numpy(tab),
        torch.from_numpy(pen_tab), torch.from_numpy(off), R, m,
        prep._DEV_LUT_Q,
    )
    names = ("rank", "code", "n", "score_lut", "pen", "split", "scale",
             "thresh", "repr_mm")
    assert len(want) == len(got) == 9
    for name, w, g in zip(names, want, got):
        assert_bits_equal(np.asarray(w), g.numpy(), name)
    assert (got[0] == 0).any() and (got[4] != 0).any()


def test_all_length_tables_equal_jax():
    """The one-time tables K4 and K6 gather from: score rows, penalty
    elements and per-length offsets, equal to the JAX package's."""
    jp, tp = adna_params("mapad_tpu"), adna_params("mapad_tpu_torch")
    want = jeng._build_all_lut(jp.difference_model, jp, 24)
    got = prep._build_all_lut(tp.difference_model, tp, 24)
    for name, w, g in zip(("tab", "pen_tab", "off"), want, got):
        assert_bits_equal(w, g, name)
