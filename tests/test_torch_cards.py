"""The port on a node of several cards, held against the JAX package on
the CPU: big mode over the mesh (the engine's deal of every block, the
deep tier's blocks included, on the GRCh37-shaped assembly's X-bearing
rows) and the rule by which an engine takes the automatic mesh.

The port's mesh is `[cpu] * 8` there, the JAX package's its 8 virtual CPU
devices (tests/conftest.py).  Every comparison is exact."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from mapad_tpu.map.record import Record as JRecord  # noqa: E402
from mapad_tpu.ops.engine import DeviceSearchEngine as JEngine  # noqa: E402
from mapad_tpu.ops.search_pool import PoolConfig as JPoolConfig  # noqa: E402
from mapad_tpu_torch.map.record import Record as TRecord  # noqa: E402
from mapad_tpu_torch.ops.engine import DeviceSearchEngine as TEngine  # noqa: E402
from mapad_tpu_torch.ops.search_pool import PoolConfig as TPoolConfig  # noqa: E402
from mapad_tpu_torch.parallel import sharding as tsh  # noqa: E402
from test_torch_assembly import (  # noqa: E402,F401 (asm: a fixture)
    STARVED,
    _pick,
    _records,
    _stream,
    asm,
)
from torch_port_helpers import adna_params, packed_equal  # noqa: E402

CPU = torch.device("cpu")
D = 8


def test_big_mode_over_the_mesh_equals_jax(asm, monkeypatch):
    """MAPAD_SHARD=1, big mode, the deep tier on (big mode's default) and a
    starved step budget, so that the deep tier's blocks are dealt over the
    shards too: the same reads escalate, take the same tiers and get the
    same hits bit for bit, with the same steps on every shard."""
    for name in ("MAPAD_RETRY_TIER", "MAPAD_DEEP_TIER", "MAPAD_HOST_BID",
                 "MAPAD_DEEP_NOHIT_HOST", "MAPAD_DEEP_LANES",
                 "MAPAD_BLOCK_READS"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("MAPAD_SHARD", "1")
    picked = _pick(asm, per_kind=6, n_random=6, with_n=8)
    reads = asm["reads"]
    je = JEngine(asm["j"].fmd, adna_params("mapad_tpu"), mode="pool",
                 pool_config=JPoolConfig(compute_forward_part=False,
                                         **STARVED),
                 big=True, packed_hits=True)
    te = TEngine(asm["t"].fmd, adna_params("mapad_tpu_torch"),
                 pool_config=TPoolConfig(**STARVED), big=True,
                 packed_hits=True, device="cpu", mesh=[CPU] * D)
    assert te.device_index.big and te.deep_tier_enabled()
    assert je.n_shards == te.n_shards == D
    je.block_reads = te.block_reads = block = STARVED["lanes"] * D
    assert je.block_reads == te.block_reads == block
    j_esc, j_hits = _stream(je, _records(JRecord, reads, picked), block)
    t_esc, t_hits = _stream(te, _records(TRecord, reads, picked), block)
    assert t_esc == j_esc and len(t_esc) > 0
    for i, (a, b) in enumerate(zip(j_hits, t_hits)):
        assert packed_equal(a, b), picked[i]
    assert te._stats["shard_steps"] == je._stats["shard_steps"]
    assert len(te._stats["shard_steps"]) == D
    for name in ("deep_retried", "nohit_host", "oracle", "escalated",
                 "batches", "device_lanes"):
        assert te._stats.get(name, 0) == je._stats.get(name, 0), name
    assert te._stats["deep_retried"] > 0
    assert sum(len(h) > 0 for h in t_hits) > len(picked) // 2


@pytest.mark.parametrize("device,cards,want", [
    ("cuda", 4, 4),    # the default: every visible card
    ("cuda", 8, 8),
    ("cuda", 1, 0),    # one card is no mesh
    ("cuda:2", 4, 0),  # a named card alone: a worker or process per card
    ("cuda:0", 8, 0),
    ("cpu", 4, 0),     # the CPU shards only over a mesh it is given
])
def test_automatic_mesh(device, cards, want, monkeypatch):
    """The mesh an engine takes by itself.  With no card named it is every
    visible card, as mapad_tpu's engine takes every device of its process
    (its 8 virtual devices under MAPAD_SHARD=1); `cuda:i` keeps to card i
    (else a worker per card, each started with --device cuda:i, would
    shard every chunk over all of them)."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    mesh = tsh.automatic_mesh(device)
    assert (0 if mesh is None else len(mesh)) == want
    if want:
        assert mesh == [torch.device("cuda", i) for i in range(cards)]
    if cards == 8 and want:
        from mapad_tpu.index.builder import build_auxiliary_structures

        monkeypatch.setenv("MAPAD_SHARD", "1")
        ref = bytes(np.random.default_rng(2).choice(
            np.frombuffer(b"ACGT", dtype=np.uint8), 2000))
        je = JEngine(build_auxiliary_structures(ref, b"ACGT")[0],
                     adna_params("mapad_tpu"), mode="pool",
                     pool_config=JPoolConfig(lanes=8, total_steps=256,
                                             read_step_cap=64))
        assert je.n_shards == len(mesh)
