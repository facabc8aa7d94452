"""The port's DeviceSearchEngine(device="cpu") against the JAX package's
engine over several streamed blocks: the same reads escalate, and every
read's hits are equal bit for bit, packed and decoded."""

from concurrent.futures import Future

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from mapad_tpu.index.builder import build_auxiliary_structures  # noqa: E402
from mapad_tpu.ops.engine import DeviceSearchEngine as JEngine  # noqa: E402
from mapad_tpu.ops.search_pool import PoolConfig as JPoolConfig  # noqa: E402
from mapad_tpu_torch.index.builder import (  # noqa: E402
    build_auxiliary_structures as t_build,
)
from mapad_tpu_torch.ops.engine import DeviceSearchEngine as TEngine  # noqa: E402
from mapad_tpu_torch.ops.search_pool import PoolConfig as TPoolConfig  # noqa: E402
from torch_port_helpers import (  # noqa: E402
    adna_params,
    bench_reads,
    bench_ref,
    hits_equal,
    packed_equal,
    records,
)

CFG = dict(max_len=128, lanes=8, total_steps=2048, read_step_cap=512,
           max_chains=256)
BLOCK = 24


@pytest.fixture(scope="module")
def indexes():
    ref = bench_ref()
    return build_auxiliary_structures(ref, b"ACGT")[0], t_build(ref, b"ACGT")[0]


def _stream(engine, recs):
    """search_stream over BLOCK-read blocks -> (escalated indexes, hits)."""
    blocks = [(b, recs[b : b + BLOCK]) for b in range(0, len(recs), BLOCK)]
    out = []
    for _key, block_out in engine.search_stream(blocks, lazy_fallback=True):
        out.extend(block_out)
    escalated = {i for i, o in enumerate(out) if isinstance(o, Future)}
    hits = [(o.result() if isinstance(o, Future) else o)[0] for o in out]
    return escalated, hits


@pytest.mark.parametrize("packed,qual", [(True, 40), (False, 40),
                                         (True, 100)])
def test_engine_equals_jax(indexes, packed, qual):
    """qual 100 is past the device LUT's quality ceiling: the blob then
    carries the full LUT rows instead of (class, qual) cells."""
    jfmd, tfmd = indexes
    ref = bench_ref()
    # an empty read and an overlong one (escalated to the exact searcher)
    reads = bench_reads(seed=5, n_random=50, n_exo=6,
                        extra=[b"", ref[1000:1200]])
    je = JEngine(jfmd, adna_params("mapad_tpu"), mode="pool",
                 pool_config=JPoolConfig(compute_forward_part=False, **CFG),
                 packed_hits=packed)
    te = TEngine(tfmd, adna_params("mapad_tpu_torch"),
                 pool_config=TPoolConfig(**CFG), packed_hits=packed,
                 device="cpu")
    je.block_reads = te.block_reads = BLOCK
    j_esc, j_hits = _stream(je, records("mapad_tpu", reads, qual))
    t_esc, t_hits = _stream(te, records("mapad_tpu_torch", reads, qual))
    assert len(reads) > 2 * BLOCK
    assert t_esc == j_esc and len(t_esc) > 0
    assert te._stats["esc_why"] == je._stats["esc_why"]
    same = packed_equal if packed else hits_equal
    for i, (a, b) in enumerate(zip(j_hits, t_hits)):
        assert same(a, b), i
    assert sum(len(h) > 0 for h in t_hits) > len(reads) // 2


def test_engine_default_shape(indexes):
    _jfmd, tfmd = indexes
    te = TEngine(tfmd, adna_params("mapad_tpu_torch"), lanes=2048,
                 device="cpu")
    cfg = te.pool_config
    assert (cfg.lanes, cfg.total_steps, cfg.read_step_cap,
            cfg.max_chains) == (512, 8192, 3072, 16384)
    assert te.block_reads == 8192
    assert np.float32(te._params().pgo_pge.item()) == np.float32(
        te.parameters.penalty_gap_open + te.parameters.penalty_gap_extend
    )
