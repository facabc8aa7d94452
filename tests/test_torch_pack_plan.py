"""K5's and K4's launch plans (`ops/engine.py` `pack_plan`, `unpack_plan`),
pure functions of the shapes, and K5's entry on K3's one allocation
(`_pack_buffer`), on the CPU.

The plans: the kernels' work, split as csrc/pack_result.cu and
csrc/unpack_prep.cu split it (K5: four words a thread of each head field,
a tile of whole chain rows a block, a word a thread of the tail; K4: whole
reads a block), reaches every output word exactly once, every tile of
K3's op words starts on a 16-byte boundary, and a block's shared memory
holds what it stages, at the smoke's shapes and at the edges (C % 4 != 0,
MW of 37, 128 and 144, M of 35 to 255, R odd).

The buffer entry: on the CPU it is the plain version over the views of
the allocation, equal word for word to `_pack_result_plain` of the views
and to the JAX package's `_pack_result`, in both interval widths, with and
without per-read steps; `k_mismatch_search_pool2(views=False)` returns the
same result in one allocation; the result spec made from the shapes alone
equals the one made from the tensors."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from mapad_tpu.ops.engine import DeviceSearchEngine as JaxEngine  # noqa: E402
from mapad_tpu.ops.search_pool import PoolResult as JaxPoolResult  # noqa: E402
from torch_port_helpers import bench_reads, bench_ref  # noqa: E402

SMEM_BLOCK = 49152

# (L, C, max_len, R): the smoke's and the engine's shapes, and the edges
PACK_SHAPES = [
    (512, 16384, 128, 1024),   # pool_check (MW = 144, K = 4)
    (512, 16384, 128, 8192),   # path 1's invocation
    (512, 16384, 128, 4096),   # path 2's invocation (big)
    (128, 16384, 128, 4096),   # the deep config
    (8, 33, 21, 41),           # MW = 37 (K = 6), C % 4 != 0, R odd
    (13, 1023, 112, 7),        # MW = 128 (K = 5), C % 4 == 3
    (1, 1, 1, 1),              # one of each
    (40, 1030, 128, 0),        # a result without read_steps
]


def _mw(max_len):
    return max_len + 16


@pytest.mark.parametrize("big", [False, True])
@pytest.mark.parametrize("shape", PACK_SHAPES, ids=str)
def test_pack_plan_covers_every_word_once(shape, big):
    """Head, ops and tail blocks write every word of the packed result
    once; the tiles are whole chain rows, a multiple of 4, each starting
    on a 16-byte boundary of c_ops; their shared memory fits a block."""
    from mapad_tpu_torch.ops.engine import (
        PACK_THREADS,
        _head_words,
        _packed_words,
        pack_plan,
    )
    from mapad_tpu_torch.ops.prep import _wire_opbits

    L, C, max_len, R = shape
    MW = _mw(max_len)
    p = pack_plan(C, MW, L, R, big)
    _opbits, K, _pb = _wire_opbits(MW)
    G = -(-MW // K)
    T = p.threads
    assert T == PACK_THREADS and T % 32 == 0
    hits = np.zeros(_packed_words(C, MW, L, R, big), np.int32)
    # the head: each block finds its field as the kernel does
    heads = _head_words(C, big)
    for b in range(p.head_blocks):
        f, at, bb = 0, 0, b
        while True:
            n = heads[f]
            nb = -(-(-(-n // 4)) // T)
            if bb < nb:
                break
            bb -= nb
            at += n
            f += 1
        for t in range(T):
            w0 = (bb * T + t) * 4
            if w0 < n:
                hits[at + w0 : at + min(w0 + 4, n)] += 1
    pre = sum(heads)
    assert pre == (10 if big else 7) * C
    # the ops tiles
    assert p.rows % 4 == 0 and p.rows >= 4
    assert p.smem == 4 * p.rows * MW <= SMEM_BLOCK
    covered = 0
    for b in range(p.ops_blocks):
        row0 = b * p.rows
        rows = min(p.rows, C - row0)
        assert rows >= 1
        assert (row0 * MW) % 4 == 0  # 16-byte aligned in K3's c_ops part
        covered += rows
        hits[pre + 2 * row0 * G : pre + 2 * (row0 + rows) * G] += 1
    assert covered == C
    # the tail, a word a thread
    tail = 3 + 2 * L + R
    at = pre + 2 * C * G
    assert (p.tail_blocks - 1) * T < tail <= p.tail_blocks * T
    hits[at : at + tail] += 1
    assert (hits == 1).all()
    # 32-bit index math inside the kernel
    assert C * MW < 2**31 and hits.size < 2**31


# (R, M): path 1's block, the GPU tests' edges
UNPACK_SHAPES = [(8192, 128), (1024, 128), (41, 128), (7, 35), (61, 35),
                 (21, 100), (13, 255), (100, 37), (1, 16), (4097, 100)]


@pytest.mark.parametrize("rle", [True, False])
@pytest.mark.parametrize("shape", UNPACK_SHAPES, ids=str)
def test_unpack_plan_stages_fit(shape, rle):
    """Whole reads a block, every read once; for every block the staged
    parts (the output rows at their 16-byte phase, the cell words that
    straddle its reads, the n, the run values or raw Bi-D, the break
    lanes) fit their places in a block's shared memory, each at a 16-byte
    boundary."""
    from mapad_tpu_torch.ops.engine import (
        UNPACK_CELLS,
        UNPACK_THREADS,
        unpack_plan,
    )
    from mapad_tpu_torch.ops.prep import _BID_SEG

    R, M = shape
    p = unpack_plan(R, M, rle)
    assert p.threads == UNPACK_THREADS and p.threads > 64
    assert p.reads == max(1, min(R, UNPACK_CELLS // M))
    assert (p.blocks - 1) * p.reads < R <= p.blocks * p.reads
    assert p.smem <= SMEM_BLOCK and p.smem % 16 == 0
    parts = [0, p.cq_at, p.n_at, p.bid_at, p.brk_at, p.smem // 4]
    assert all(x % 4 == 0 for x in parts) and parts == sorted(parts)
    for b in range(p.blocks):
        r0 = b * p.reads
        nr = min(p.reads, R - r0)
        c0, cells = r0 * M, nr * M
        # the output span at its 16-byte phase: 2 words of phase at most
        assert (6 * c0) % 4 + 6 * cells <= p.cq_at
        words = (c0 + cells - 1) // 3 - c0 // 3 + 1
        assert 3 + words <= p.n_at - p.cq_at
        assert 3 + nr <= p.bid_at - p.n_at
        assert 3 + (_BID_SEG * nr if rle else cells) <= p.brk_at - p.bid_at
        assert (_BID_SEG // 2 * nr if rle else 0) <= p.smem // 4 - p.brk_at
    assert 6 * R * M < 2**31


def _random_result(buf, cfg, R, big, track, seed):
    """Random words in every PoolResult field of K3's allocation (0/1 in
    the bools; read_steps -1 where steps are not tracked)."""
    from mapad_tpu_torch.ops.search_pool2 import _pool_result

    rng = np.random.default_rng(seed)
    res = _pool_result(buf, cfg, R, big)
    for f in res:
        if f.dtype == torch.bool:
            v = rng.integers(0, 2, f.shape).astype(bool)
        elif f.dtype == torch.float32:
            v = rng.standard_normal(f.shape).astype(np.float32)
        elif f.dtype == torch.int64:
            v = rng.integers(-2**40, 2**40, f.shape)
        else:
            v = rng.integers(-2**31, 2**31 - 1, f.shape).astype(np.int32)
        f.copy_(torch.from_numpy(np.asarray(v)))
    # op words as K3 writes them: base | pos < MW | kind | VALID, and the
    # flag bits above them, which the wire drops
    C, MW = res.c_ops.shape
    ops = (rng.integers(0, 4, (C, MW)) | rng.integers(0, MW, (C, MW)) << 2
           | rng.integers(0, 4, (C, MW)) << 17
           | rng.integers(0, 2, (C, MW)) << 20
           | rng.integers(0, 8, (C, MW)) << 21)
    res.c_ops.copy_(torch.from_numpy(ops.astype(np.int32)))
    if not track:
        res.read_steps.fill_(-1)
    return res


@pytest.mark.parametrize("track", [True, False])
@pytest.mark.parametrize("big", [False, True])
@pytest.mark.parametrize("shape", [(8, 33, 21, 41), (13, 100, 112, 7),
                                   (4, 64, 128, 9)], ids=str)
def test_pack_buffer_equals_plain_and_jax(shape, big, track):
    from mapad_tpu_torch.ops.engine import (
        _buffer_spec,
        _pack_buffer,
        _pack_result_plain,
    )
    from mapad_tpu_torch.ops.prep import _unpack_result
    from mapad_tpu_torch.ops.search_pool import PoolConfig
    from mapad_tpu_torch.ops.search_pool2 import _alloc_result

    L, C, max_len, R = shape
    cfg = PoolConfig(max_len=max_len, lanes=L, total_steps=64,
                     read_step_cap=60, max_chains=C, track_read_steps=track)
    buf = _alloc_result(cfg, R, big, torch.device("cpu"))
    res = _random_result(buf, cfg, R, big, track, seed=L + C)
    got = _pack_buffer(buf, cfg, R, big)
    want = _pack_result_plain(res)
    assert got.dtype == torch.int32 and torch.equal(got, want)
    jres = JaxPoolResult(*[jnp.asarray(f.numpy()) for f in res])
    jwant = np.asarray(JaxEngine._pack_result(jres))  # x64: mapad_tpu.ops
    np.testing.assert_array_equal(got.numpy(), jwant)
    back = _unpack_result(_buffer_spec(L, C, max_len + 16, R, big),
                          got.numpy())
    for name, f, b in zip(res._fields, res, back):
        f = f & 0x1FFFFF if name == "c_ops" else f
        assert np.array_equal(np.asarray(b), f.numpy()), name


@pytest.mark.parametrize("big", [False, True])
@pytest.mark.parametrize("shape", PACK_SHAPES, ids=str)
def test_buffer_spec_equals_result_spec(shape, big):
    from mapad_tpu_torch.ops.engine import _buffer_spec, _result_spec
    from mapad_tpu_torch.ops.search_pool import PoolConfig
    from mapad_tpu_torch.ops.search_pool2 import _alloc_result, _pool_result

    L, C, max_len, R = shape
    cfg = PoolConfig(max_len=max_len, lanes=L, total_steps=64,
                     read_step_cap=60, max_chains=C)
    res = _pool_result(_alloc_result(cfg, R, big, torch.device("cpu")), cfg,
                       R, big)
    want = _result_spec(res)
    got = _buffer_spec(L, C, max_len + 16, R, big)
    for name, g, w in zip(res._fields, got, want):
        assert g.shape == w.shape and g.dtype == w.dtype, name


@pytest.fixture(scope="module")
def bench():
    from mapad_tpu_torch.index.builder import build_auxiliary_structures

    return build_auxiliary_structures(bench_ref(), b"ACGT")[0]


@pytest.mark.parametrize("track", [True, False])
@pytest.mark.parametrize("big", [False, True])
def test_search_without_views_returns_the_allocation(bench, big, track):
    """`k_mismatch_search_pool2(views=False)` on the CPU: the plain result
    in one `_result_layout` allocation, field for field the PoolResult of
    `views=True`, and its pack the PoolResult's pack."""
    from mapad_tpu_torch.ops.engine import (
        DeviceSearchEngine,
        _pack_buffer,
        _pack_result,
    )
    from mapad_tpu_torch.ops.search_pool import PoolConfig
    from mapad_tpu_torch.ops.search_pool2 import (
        _pool_result,
        _result_layout,
        k_mismatch_search_pool2,
    )
    from torch_port_helpers import adna_params, records

    eng = DeviceSearchEngine(bench, adna_params("mapad_tpu_torch"),
                             pool_config=PoolConfig(lanes=8, total_steps=256),
                             device="cpu", big=big)
    R = 16
    cfg, prep, _ = eng._prep_block(
        records("mapad_tpu_torch", bench_reads(seed=3)[:R], 40), R,
        eng.pool_config)
    cfg = cfg._replace(track_read_steps=track)
    consts, kw = eng._upload(prep)
    args = (eng.device_index, *consts, eng._params(), cfg)
    res = k_mismatch_search_pool2(*args, **kw)
    buf = k_mismatch_search_pool2(*args, views=False, **kw)
    lay = _result_layout(cfg.lanes, cfg.max_chains, cfg.max_len + 16, R,
                         cfg.total_steps, big)
    assert buf.dtype == torch.int32 and buf.numel() == lay.words
    for name, g, w in zip(res._fields, _pool_result(buf, cfg, R, big), res):
        assert g.dtype == w.dtype and torch.equal(g, w), name
    assert torch.equal(_pack_buffer(buf, cfg, R, big), _pack_result(res))
