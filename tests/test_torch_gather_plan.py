"""P1's launch plan (`mapad_tpu_torch/tools/dma.py` `gather_plan`), a pure
function of the lanes, the row width and the card's figures: on an H100's
figures (227 KB of dynamic shared memory a block, 228 KB an SM) with the
occupancy the query would give for a block of 256 threads, and on cards of
fewer and more SMs.  Every lane is gathered by exactly one block, the grid
is all co-resident (the grid barrier waits on every block), a block's rows
fit its shared memory, and the barrier slots cover the grid, two to a
16-byte load."""

import pytest

torch = pytest.importorskip("torch")

from mapad_tpu_torch.tools import dma  # noqa: E402

SMEM_BLOCK = 232448 - 48  # a block's opt-in, less the kernel's own
SMEM_SM = 233472
RESERVED = 1024


def _per_sm(smem):
    """Blocks of 256 threads (32 registers each) an SM holds at once."""
    return min(2048 // dma.GATHER_THREADS, SMEM_SM // (smem + 48 + RESERVED))


@pytest.mark.parametrize("sms", [1, 8, 66, 132, 144])
@pytest.mark.parametrize("W", [4, 32, 128])
@pytest.mark.parametrize("L", [1, 31, 1024, 4096])
def test_gather_plan_is_co_resident_and_covered(L, W, sms):
    """Or, where it raises, no number of lanes a block fits the card."""
    try:
        p = dma.gather_plan(L, W, sms, _per_sm, SMEM_BLOCK)
    except ValueError:
        assert not any(
            lpb * W * 4 <= SMEM_BLOCK
            and -(-L // lpb) <= _per_sm(lpb * W * 4) * sms
            for lpb in range(dma.GATHER_WARPS, L + dma.GATHER_WARPS))
        return
    lpb = p.lanes_per_block
    # every lane in exactly one block, no block without a lane
    assert lpb >= dma.GATHER_WARPS
    assert (p.blocks - 1) * lpb < L <= p.blocks * lpb
    # the rows a block stages, in its shared memory
    assert p.smem == lpb * W * 4 <= SMEM_BLOCK
    # every block resident at once
    assert p.blocks <= _per_sm(p.smem) * sms
    # a slot a block for each step parity, two slots a 16-byte load, and
    # the parity halves 16-byte aligned after the 16-byte head
    assert p.stride >= p.blocks and p.stride % 2 == 0
    assert dma.slot_words(p) == 4 + 2 * 2 * p.stride
    assert (4 + 2 * p.stride) % 4 == 0


@pytest.mark.parametrize("L,W,sms", [(1024, 128, 132), (4096, 128, 132),
                                     (1001, 33, 132), (64, 2048, 132)])
def test_gather_plan_takes_a_warp_a_lane_where_the_card_holds_them(L, W,
                                                                   sms):
    """The probe's shapes (and the GPU tests'): a lane a warp, so the most
    blocks and each step's loads over the most SMs."""
    p = dma.gather_plan(L, W, sms, _per_sm, SMEM_BLOCK)
    assert p.lanes_per_block == dma.GATHER_WARPS
    assert p.blocks == -(-L // dma.GATHER_WARPS)


def test_gather_plan_grows_blocks_until_the_grid_fits():
    """With room for one block an SM, 4096 lanes on 132 SMs take 32 lanes
    a block (4 a warp): the fewest that fit."""
    p = dma.gather_plan(4096, 128, 132, lambda smem: 1, SMEM_BLOCK)
    assert p.blocks <= 132 and p.lanes_per_block == 32
    assert p.blocks == 128


def test_gather_plan_refuses_what_no_block_holds():
    with pytest.raises(ValueError, match="shared memory"):
        dma.gather_plan(1024, 8192, 132, _per_sm, SMEM_BLOCK)
    with pytest.raises(ValueError, match="shared memory"):
        dma.gather_plan(1024, 128, 132, lambda smem: 0, SMEM_BLOCK)
