"""The launch plan of K7 (`bid_plan`, mapad_tpu_torch/ops/bi_d.py), its row
division by a multiply-high (`occ_divisor`, `occ_div`), its walk-step count,
and the copy wrappers' checks (mapad_tpu_torch/tools/dma.py): pure
functions, checked on the CPU over an H100's figures and smaller cards."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from mapad_tpu_torch.ops import bi_d  # noqa: E402
from mapad_tpu_torch.ops.fm import OCC_K, OCC_K_BIG  # noqa: E402
from mapad_tpu_torch.tools import dma  # noqa: E402

SMEM_DEFAULT = 48 * 1024  # the shared memory a block has without opting in


def occupancy(regs, sm_regs=65536, max_warps=64, smem_sm=233472,
              reserved=1024, max_blocks=32):
    """blocks_per_sm of a kernel of `regs` registers a thread, as the
    occupancy query counts them (registers by the warp, 256 at a time); an
    H100 SXM by default: 65,536 registers, 64 warps and 228 KB of shared
    memory an SM, 1 KB reserved a block."""

    def blocks_per_sm(threads, smem):
        warps = -(-threads // 32)
        per_warp = -(-regs * 32 // 256) * 256
        by_regs = sm_regs // (per_warp * warps)
        by_warps = max_warps // warps
        by_smem = smem_sm // (smem + reserved) if smem else max_blocks
        return min(by_regs, by_warps, by_smem, max_blocks)

    return blocks_per_sm


@pytest.mark.parametrize("M,parts", [
    (128, 1),   # path 2's block and path 6's batch, backward only
    (128, 2),   # both parts
    (112, 2),   # the GPU test's block
    (1, 1),     # the shortest read
    (64, 2),
    (1024, 2),  # the longest read the kernel takes, both parts
])
@pytest.mark.parametrize("regs,per_sm", [(32, 4), (40, 3), (64, 2)])
def test_bid_plan_on_an_h100(M, parts, regs, per_sm):
    """A warp a walk up to 16, the read's bytes to 16 B, and the blocks an
    SM that the registers leave room for (at 40, K7's own: three)."""
    plan = bi_d.bid_plan(M, parts, occupancy(regs))
    assert plan.warps == min(bi_d.BID_WARPS, parts * bi_d.MAX_OFFSET)
    assert plan.smem == bi_d.bid_smem(M, parts)
    assert plan.smem % 16 == 0
    assert parts * M * 9 <= plan.smem < parts * M * 9 + 16
    assert plan.smem <= SMEM_DEFAULT
    assert plan.per_sm == per_sm
    assert plan.resident_warps == per_sm * plan.warps


def test_bid_plan_default_is_a_read_a_block():
    """Path 2's block: blocks of 15 warps (backward only) or 16 (both
    parts: 30 walks), three an SM, 45 or 48 warps in flight."""
    one = bi_d.bid_plan(128, 1, occupancy(40))
    both = bi_d.bid_plan(128, 2, occupancy(40))
    assert (one.warps, one.smem) == (15, 1152)
    assert (both.warps, both.smem) == (16, 2304)
    assert one.resident_warps == 45 and both.resident_warps == 48


def test_bid_plan_registers_set_the_warps():
    few = bi_d.bid_plan(128, 2, occupancy(32))
    many = bi_d.bid_plan(128, 2, occupancy(64))
    assert few.per_sm == 4 and many.per_sm == 2
    assert few.resident_warps == 64 and many.resident_warps == 32


@pytest.mark.parametrize("card", [
    dict(sm_regs=65536, max_warps=48, smem_sm=65536, reserved=0),
    dict(sm_regs=32768, max_warps=32, smem_sm=49152, reserved=1024),
])
def test_bid_plan_on_small_cards(card):
    for M, parts in ((128, 1), (1024, 2), (64, 2)):
        plan = bi_d.bid_plan(M, parts, occupancy(40, **card))
        assert plan.per_sm >= 1 and plan.smem <= SMEM_DEFAULT
        assert plan.resident_warps <= card["max_warps"]


@pytest.mark.parametrize("parts", [1, 2])
def test_bid_smem_fits_every_block(parts):
    """Every read the kernel takes fits the shared memory a block has
    without opting in, so the launch sets no attribute."""
    for M in range(1, bi_d.MAX_M + 1):
        smem = bi_d.bid_smem(M, parts)
        assert parts * M * 9 <= smem <= SMEM_DEFAULT and smem % 16 == 0


def test_bid_plan_refuses_what_no_block_holds():
    with pytest.raises(ValueError, match="at most"):
        bi_d.bid_plan(1025, 1, occupancy(40))
    with pytest.raises(ValueError, match="at most"):
        bi_d.bid_plan(0, 1, occupancy(40))
    with pytest.raises(ValueError, match="one part or two"):
        bi_d.bid_plan(128, 3, occupancy(40))
    with pytest.raises(ValueError, match="no block"):
        bi_d.bid_plan(128, 1, occupancy(256))


def _points(k, text_len, bits):
    top = (1 << (bits - 1)) - 1
    pts = {0, 1, k - 1, k, k + 1, 2 * k, 2 * k - 1, 1000 * k, 1000 * k + 1,
           2**31 - 1, text_len - 1, text_len, text_len + 1,
           (text_len // k) * k, top, top - 1, (top // k) * k,
           (top // k) * k - 1}
    if bits == 64:
        pts |= {2**31, 2**31 + 1, 2**32 - 1, 2**32, 2**32 + 1,
                (5 << 32) + 999, (2**32 // k) * k}
    return sorted(p for p in pts if 0 <= p <= top)


@pytest.mark.parametrize("k,bits", [(OCC_K, 32), (OCC_K_BIG, 64),
                                    (OCC_K, 64), (OCC_K_BIG, 32), (8, 32),
                                    (1024, 64), (1000, 64), (2, 32),
                                    (3, 64), (7, 32), (977, 32), (4096, 64),
                                    (2**20 + 1, 32), (2**31 - 1, 64)])
def test_occ_divisor_is_exact(k, bits):
    """The multiply-high equals // and % at the edges (0, 1, k +- 1,
    multiples of k, 2^31 +- 1, 2^32 +- 1, a text length) and over random
    values of the whole non-negative range of the interval type."""
    magic, shift = bi_d.occ_divisor(k, bits)
    assert 0 < magic < 2**bits
    text_len = 3_000_000_007 if bits == 64 else 2**31 - 2
    rng = np.random.default_rng(k + bits)
    top = 2**(bits - 1) - 1
    randoms = [int(x) for x in rng.integers(0, top, size=20_000,
                                            dtype=np.int64)]
    randoms += [int(x) for x in rng.integers(0, 2**33, size=5_000)]
    for n in _points(k, text_len, bits) + randoms:
        n %= top + 1
        assert bi_d.occ_div(n, k, magic, shift, bits) == (n // k, n % k), n


def test_occ_divisor_shift_and_constant():
    """k = 928: 2^9 < k <= 2^10, so shift 9 and a 64-bit constant just above
    2^63; k = 976 in 32 bits: shift 9."""
    magic, shift = bi_d.occ_divisor(OCC_K_BIG, 64)
    assert shift == 9 and 2**63 < magic < 2**64
    assert magic == -(-(1 << 73) // OCC_K_BIG)
    magic, shift = bi_d.occ_divisor(OCC_K, 32)
    assert shift == 9 and 2**31 < magic < 2**32
    with pytest.raises(ValueError):
        bi_d.occ_divisor(1, 32)


def test_walk_steps_count_both_parts_with_the_forward_part():
    n = torch.tensor([0, 20, 35, 3], dtype=torch.int32)
    split = torch.tensor([0, 20, 10, 1], dtype=torch.int32)
    back = sum(max(0, int(s) - w) for s in split for w in range(15))
    fwd = sum(max(0, int(a - s) - w) for a, s in zip(n, split)
              for w in range(15))
    assert bi_d.walk_steps(n, split, False) == back
    assert bi_d.walk_steps(n, split, True) == back + fwd
    assert bi_d.walk_steps(n, split, True) > bi_d.walk_steps(n, split, False)


def test_copy_wrappers_check_before_any_launch():
    """The slice checks run on any device and name the slice only when
    they fail."""
    x = torch.zeros((8, 16), dtype=torch.int32)
    assert dma._strided(x, "x") == (8, 16)
    assert dma._strided(torch.zeros((4, 2, 8), dtype=torch.int32),
                        "x") == (4, 16)
    dma._check_slice(8, 16, 0, 8, 0, 16)
    with pytest.raises(ValueError, match=r"slice \[7:9, 0:16\] outside"):
        dma._check_slice(8, 16, 7, 2, 0, 16)
    with pytest.raises(ValueError, match="staging buffer"):
        dma._check_slice(1, 10**5, 0, 1, 0, 10**5)
    with pytest.raises(ValueError, match="contiguous int32"):
        dma._strided(torch.zeros((8, 16), dtype=torch.int64), "x")
    with pytest.raises(ValueError, match="contiguous int32"):
        dma._strided(x.t(), "x")
