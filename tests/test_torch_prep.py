"""The port's host prep helpers (mapad_tpu_torch/ops/prep.py) against the
JAX package's (mapad_tpu/ops/engine.py), bit for bit on the same inputs."""

import numpy as np
import pytest

pytest.importorskip("torch")

from mapad_tpu.ops import engine as jeng  # noqa: E402
from mapad_tpu_torch.ops import prep  # noqa: E402
from torch_port_helpers import (  # noqa: E402
    adna_params,
    assert_bits_equal,
    bid_rows,
)


def _read_grid(seed, L=12, M=48):
    rng = np.random.default_rng(seed)
    n = rng.integers(0, M + 1, size=L).astype(np.int32)
    n[0] = M
    seqs = np.zeros((L, M), dtype=np.uint8)
    quals = np.zeros((L, M), dtype=np.uint8)
    alphabet = np.frombuffer(b"ACGTN", dtype=np.uint8)
    for i, ln in enumerate(n):
        seqs[i, :ln] = rng.choice(alphabet, size=ln, p=[0.24] * 4 + [0.04])
        quals[i, :ln] = rng.integers(0, 60, size=ln)
    return seqs, quals, n


def test_tables_are_the_same():
    assert_bits_equal(prep._RANK_TABLE, jeng._RANK_TABLE)
    assert_bits_equal(prep._CLS_TABLE, jeng._CLS_TABLE)
    assert_bits_equal(prep._CLS_REPR, jeng._CLS_REPR)
    assert prep._BID_SEG == jeng._BID_SEG
    assert prep._DEV_LUT_Q == jeng._DEV_LUT_Q


@pytest.mark.parametrize("MW", [17, 64, 96, 128, 144])
def test_wire_opbits(MW):
    assert prep._wire_opbits(MW) == jeng._wire_opbits(MW)


def test_build_all_lut_bitexact():
    tp = adna_params("mapad_tpu_torch")
    jp = adna_params("mapad_tpu")
    got = prep._build_all_lut(tp.difference_model, tp, 24)
    want = jeng._build_all_lut(jp.difference_model, jp, 24)
    for g, w in zip(got, want):
        assert_bits_equal(g, w)


@pytest.mark.parametrize("seed", [0, 1])
def test_batch_luts_and_lut_cache_bitexact(seed):
    seqs, quals, n = _read_grid(seed)
    tp = adna_params("mapad_tpu_torch")
    jp = adna_params("mapad_tpu")
    got = prep._batch_luts(tp.difference_model, tp, seqs, quals, n)
    want = jeng._batch_luts(jp.difference_model, jp, seqs, quals, n)
    for g, w in zip(got, want):
        assert_bits_equal(g, w)
    outs = []
    for mod, p in ((prep, tp), (jeng, jp)):
        score = np.zeros(seqs.shape + (4,), np.float32)
        pen = np.zeros(seqs.shape, np.float32)
        mod._LutCache(p.difference_model, p).fill(seqs, quals, n, score, pen)
        outs.append((score, pen))
    for g, w in zip(*outs):
        assert_bits_equal(g, w)


@pytest.mark.parametrize("RM", [30, 31, 32])
def test_pack_cq10(RM):
    rng = np.random.default_rng(RM)
    seqs = rng.choice(np.frombuffer(b"ACGTNX", dtype=np.uint8), size=(1, RM))
    quals = rng.integers(0, prep._DEV_LUT_Q, size=(1, RM)).astype(np.int32)
    assert_bits_equal(prep._pack_cq10(seqs, quals),
                      jeng._pack_cq10(seqs, quals))
    assert prep._cq_words(RM) == jeng._cq_words(RM)


@pytest.mark.parametrize("seed", [3, 4])
def test_pack_bid_rle_with_overflow_rows(seed):
    bid = bid_rows(seed)
    got = prep._pack_bid_rle(bid)
    want = jeng._pack_bid_rle(bid)
    assert len(want[2]) > 0, "fixture must hold rows of more than 32 runs"
    for g, w in zip(got, want):
        assert_bits_equal(g, w)


def test_inject_pre_escalate():
    stash = {"pre_escalate": np.array([1, 4, 9])}
    outs = []
    for mod in (prep, jeng):
        esc, ab, nh = {4, 7}, set(), set()
        added = mod._inject_pre_escalate(stash, 8, esc, ab, nh)
        outs.append((added, esc, ab, nh))
    assert outs[0] == outs[1]
    assert prep._inject_pre_escalate(None, 8, set(), None, None) == 0
