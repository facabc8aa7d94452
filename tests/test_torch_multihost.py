"""Multi-host mapping of the port (mapad_tpu_torch/parallel/multihost.py)
over `torch.distributed`: the shard assignment and the BAM shard merge as
tests/test_multihost.py tests the JAX package's, and a two-process run
over gloo on localhost as tests/test_multihost_e2e.py runs the JAX
package's, whose merged BAM equals the single-process run of the port and
of mapad_tpu record for record (XD, a timing, aside; the order differs by
shard)."""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from mapad_tpu_torch.io.bam import (  # noqa: E402
    BamReader,
    BamRecord,
    SamHeader,
)
from mapad_tpu_torch.io.sniff import TaskQueue  # noqa: E402
from mapad_tpu_torch.parallel.multihost import (  # noqa: E402
    BamShardWriter,
    ShardedTaskQueue,
    _merge_bam_shards,
)
from torch_port_helpers import bam_records, dryrun_params  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# one process of the run: the port only (no JAX), the oracle engine
PROCESS = r"""
import sys
repo, ref_path, reads, out, coordinator, pid = sys.argv[1:7]
sys.path.insert(0, repo)
sys.path.insert(0, repo + "/tests")
from torch_port_helpers import dryrun_params
from mapad_tpu_torch.index import load_index
from mapad_tpu_torch.map.pipeline import OracleSearchEngine
from mapad_tpu_torch.parallel.multihost import run_multihost

params = dryrun_params("mapad_tpu_torch", chunk_size=5)
index = load_index(ref_path)
run_multihost(
    reads, ref_path, out, True, params,
    engine=OracleSearchEngine(index.fmd, params),
    coordinator=coordinator, num_processes=2, process_id=int(pid),
)
print("process done", pid)
"""


# one process of the four-process run: the port's device engine on the CPU
# (the plain versions of the kernels) at a small pool shape
DEVICE_PROCESS = r"""
import sys
repo, ref_path, reads, out, coordinator, pid, count = sys.argv[1:8]
sys.path.insert(0, repo)
sys.path.insert(0, repo + "/tests")
from torch_port_helpers import dryrun_params
from mapad_tpu_torch.index import load_index
from mapad_tpu_torch.ops.engine import DeviceSearchEngine
from mapad_tpu_torch.ops.search_pool import PoolConfig
from mapad_tpu_torch.parallel.multihost import run_multihost

params = dryrun_params("mapad_tpu_torch", chunk_size=5)
engine = DeviceSearchEngine(load_index(ref_path).fmd, params, device="cpu",
                            packed_hits=True, pool_config=PoolConfig(
                                lanes=8, total_steps=1024,
                                read_step_cap=512, max_chains=512))
run_multihost(reads, ref_path, out, True, params, engine=engine,
              coordinator=coordinator, num_processes=int(count),
              process_id=int(pid))
print("process done", pid, engine.stats()["batches"])
"""


def test_sharded_task_queue():
    records = list(range(25))
    seen = {}
    for pid in range(3):
        q = ShardedTaskQueue(TaskQueue(iter(records), 4), pid, 3)
        for sheet in q:
            assert sheet.chunk_id % 3 == pid
            for r in sheet.records:
                assert r not in seen
                seen[r] = pid
    assert sorted(seen) == records


def test_merge_bam_shards(tmp_path):
    header = SamHeader(hd=[("VN", "1.6")], sq=[("chr1", 100, [])])
    out = tmp_path / "merged.bam"
    for pid in range(2):
        with open(f"{out}.shard{pid}", "wb") as f:
            with BamShardWriter(f) as w:
                w.write_record(
                    BamRecord(name=f"r{pid}".encode(), flags=4,
                              sequence=b"ACGT", quals=bytes([30] * 4))
                )
    _merge_bam_shards(str(out), 2, header, force_overwrite=False)
    with open(out, "rb") as f:
        names = [r.name for r in BamReader(f)]
    assert names == [b"r0", b"r1"]
    assert not os.path.exists(f"{out}.shard0")
    with pytest.raises(FileExistsError):
        _merge_bam_shards(str(out), 0, header, force_overwrite=False)


def _fixture(tmp):
    """tests/test_multihost_e2e.py's genome and 23 damaged reads; the index
    bundle built by the port (either package reads it)."""
    from mapad_tpu_torch.index.builder import build_from_sequences
    from mapad_tpu_torch.index.runtime import save_index

    rng = np.random.default_rng(11)
    genome = rng.choice(np.frombuffer(b"ACGT", dtype=np.uint8), size=20000)
    ref_path = os.path.join(tmp, "ref.fa")
    fmd, ssa, idp, orig = build_from_sequences([("chrT", genome.tobytes())])
    save_index(ref_path, fmd, ssa, idp, orig)
    reads = os.path.join(tmp, "reads.fq")
    with open(reads, "w") as f:
        for i in range(23):
            start = int(rng.integers(0, len(genome) - 60))
            seq = bytearray(genome[start : start + 60].tobytes())
            for p in range(len(seq)):
                if seq[p] == ord("C") and rng.random() < 0.3 * (0.5 ** p):
                    seq[p] = ord("T")
            f.write(f"@r{i}\n{bytes(seq).decode()}\n+\n{'I' * len(seq)}\n")
    return ref_path, reads


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_multihost_equals_single(tmp_path):
    from mapad_tpu.map import pipeline as j_pipeline
    from mapad_tpu_torch.map import pipeline as t_pipeline

    tmp = str(tmp_path)
    ref_path, reads = _fixture(tmp)
    want = {}
    for name, pl, pkg in (("port", t_pipeline, "mapad_tpu_torch"),
                          ("jax", j_pipeline, "mapad_tpu")):
        out = os.path.join(tmp, f"single_{name}.bam")
        pl.run(reads, ref_path, out, True, dryrun_params(pkg, chunk_size=5))
        want[name] = {r[0]: r for r in bam_records(out)}

    merged = os.path.join(tmp, "merged.bam")
    coordinator = f"127.0.0.1:{_free_port()}"
    env = dict(os.environ, MAPAD_NO_NATIVE_POST="")
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", PROCESS, REPO, ref_path, reads, merged,
             coordinator, str(pid)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        )
        for pid in range(2)
    ]
    try:
        outs = [p.communicate(timeout=120)[0] for p in procs]
    finally:
        for p in procs:  # a hung rendezvous fails here, not the suite
            p.kill()
            p.wait()
    for p, o in zip(procs, outs):
        assert p.returncode == 0, o.decode(errors="replace")[-3000:]

    recs = bam_records(merged)
    got = {r[0]: r for r in recs}
    assert len(recs) == len(got) == 23
    assert got == want["port"] == want["jax"]
    assert sum(1 for r in recs if not r[1] & 0x4) > 15
    assert not os.path.exists(merged + ".shard0")
    assert not os.path.exists(merged + ".shard1")
    # each host wrote its own chunks: the merge keeps host 0's first
    order = [int(r[0][1:]) // 5 % 2 for r in recs]
    assert order == sorted(order)


def test_four_process_multihost_with_the_device_engine(tmp_path):
    """`run_multihost` in four processes, each with the port's pool engine
    on the CPU, over five chunks of five reads (process 0 maps two, the
    others one): the merged BAM equals the port's single-process BAM with
    the same engine and mapad_tpu's single-process BAM of the same chunks
    (XD aside)."""
    from mapad_tpu.map import pipeline as j_pipeline
    from mapad_tpu_torch.index import load_index
    from mapad_tpu_torch.map import pipeline as t_pipeline
    from mapad_tpu_torch.ops.engine import DeviceSearchEngine
    from mapad_tpu_torch.ops.search_pool import PoolConfig

    tmp, n = str(tmp_path), 4
    ref_path, reads = _fixture(tmp)
    want = {}
    params = dryrun_params("mapad_tpu_torch", chunk_size=5)
    engine = DeviceSearchEngine(
        load_index(ref_path).fmd, params, device="cpu", packed_hits=True,
        pool_config=PoolConfig(lanes=8, total_steps=1024, read_step_cap=512,
                               max_chains=512))
    for name, pl, kw in (("port", t_pipeline, dict(engine=engine)),
                         ("jax", j_pipeline, {})):
        out = os.path.join(tmp, f"single_{name}.bam")
        pl.run(reads, ref_path, out, True,
               dryrun_params(f"mapad_tpu{'_torch' * (name == 'port')}",
                             chunk_size=5), **kw)
        want[name] = {r[0]: r for r in bam_records(out)}
    assert engine.stats()["batches"] == 5

    merged = os.path.join(tmp, "merged.bam")
    coordinator = f"127.0.0.1:{_free_port()}"
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", DEVICE_PROCESS, REPO, ref_path, reads,
             merged, coordinator, str(pid), str(n)],
            env=dict(os.environ), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
        )
        for pid in range(n)
    ]
    try:
        outs = [p.communicate(timeout=300)[0].decode(errors="replace")
                for p in procs]
    finally:
        for p in procs:  # a hung rendezvous fails here, not the suite
            p.kill()
            p.wait()
    for p, o in zip(procs, outs):
        assert p.returncode == 0, o[-3000:]
    # chunk k on process k mod 4: process 0 takes chunks 0 and 4
    blocks = [int(o.split("process done")[1].split()[1]) for o in outs]
    assert blocks == [2, 1, 1, 1]

    recs = bam_records(merged)
    got = {r[0]: r for r in recs}
    assert len(recs) == len(got) == 23
    assert got == want["port"] == want["jax"]
    assert sum(1 for r in recs if not r[1] & 0x4) > 15
    assert not any(os.path.exists(f"{merged}.shard{i}") for i in range(n))
    # the merge keeps the processes' order: chunk k's reads after process
    # k mod 4's earlier ones
    order = [int(r[0][1:]) // 5 % n for r in recs]
    assert order == sorted(order)
