"""Multi-host data-parallel mapping over `torch.distributed`.

Counterpart of mapad_tpu/parallel/multihost.py.  The FMD-index replicates
per host; each host maps its own static share of the read stream (chunk k
goes to host k mod N) with its local devices -- no dynamic work
assignment, no TCP work queue -- and host 0 concatenates the per-host BAM
shards.  Fault tolerance is left to the job scheduler.

Only a barrier crosses processes and the BAM shards are files on a shared
file system, so the `gloo` backend serves on every machine.  A library
call, one process per host:

    run_multihost(reads, reference, out, force_overwrite, params,
                  coordinator="host0:port", num_processes=N, process_id=I)

or, with no coordinator, the `env://` variables of `torch.distributed`
(MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK), as a launcher sets them.

On a node of several cards the launcher chooses the layout; nothing here
does.  A process that sees every card and is given no engine takes the
engine's automatic mesh over all of them (one process per host, as in
mapad_tpu).  One process per card is made by giving each process one
visible card (CUDA_VISIBLE_DEVICES=i, the usual launcher layout), or by
passing an engine built with `device="cuda:i"`; a process that sees two
cards takes its own mesh over the pair.
"""

from __future__ import annotations

import logging
import os

logger = logging.getLogger(__name__)


def initialize(coordinator: str | None = None, num_processes: int | None = None,
               process_id: int | None = None):
    """Join the process group -> (this process's index, process count)."""
    import torch.distributed as dist

    if coordinator is not None:
        dist.init_process_group(
            "gloo", init_method=f"tcp://{coordinator}",
            world_size=num_processes, rank=process_id,
        )
    else:
        dist.init_process_group("gloo", init_method="env://")
    return dist.get_rank(), dist.get_world_size()


class ShardedTaskQueue:
    """Wraps a TaskQueue, yielding only this host's chunks (round-robin).

    Non-owned chunks are skipped via TaskQueue.skip_chunk, which counts
    records for exact chunk-boundary parity but never converts them --
    each host pays full parse cost only for its own 1/N of the input."""

    def __init__(self, task_queue, process_id: int, process_count: int):
        self._inner = task_queue
        self._pid = process_id
        self._count = process_count

    def __iter__(self):
        return self

    def __next__(self):
        while True:
            if self._inner.next_chunk_id % self._count == self._pid:
                return next(self._inner)
            if not self._inner.skip_chunk():
                raise StopIteration


def run_multihost(
    reads_path: str,
    reference_path: str,
    out_file_path: str,
    force_overwrite: bool,
    alignment_parameters,
    read_group=None,
    engine=None,
    position_seed: int = 0,
    cmdline: str | None = None,
    coordinator: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
):
    """Each process maps chunk_id % nprocs == pid; process 0 merges the
    shard BAMs.  `engine` defaults to `DeviceSearchEngine(index.fmd,
    alignment_parameters)`: with several visible cards its automatic mesh
    over all of them.  For a process per card, launch each with one
    visible card (CUDA_VISIBLE_DEVICES) or pass an engine built with
    `device="cuda:i"`."""
    import torch.distributed as dist

    pid, count = initialize(coordinator, num_processes, process_id)
    logger.info("multihost: process %d/%d", pid, count)

    from ..index import load_index
    from ..io.sniff import InputSource
    from ..map.pipeline import run_inner
    from ..map.postprocess import create_bam_header

    index = load_index(reference_path)
    if engine is None:
        from ..ops.engine import DeviceSearchEngine

        engine = DeviceSearchEngine(index.fmd, alignment_parameters)

    shard_path = f"{out_file_path}.shard{pid}"
    input_source = InputSource.from_path(reads_path)
    out_header = create_bam_header(
        input_source.header, index.id_pos_map, read_group, cmdline
    )
    queue = ShardedTaskQueue(
        input_source.task_queue(alignment_parameters.chunk_size), pid, count
    )
    with open(shard_path, "wb") as raw:
        with BamShardWriter(raw) as writer:
            run_inner(
                queue, index, alignment_parameters, read_group, engine, writer,
                position_seed,
            )

    # every host's shard is written before host 0 merges them
    dist.barrier()
    dist.destroy_process_group()

    if pid == 0:
        _merge_bam_shards(out_file_path, count, out_header, force_overwrite)


class BamShardWriter:
    """Headerless BGZF record stream for one host's shard.

    Shards carry only record blocks (no BAM header, no BGZF EOF): BGZF
    streams are block-concatenable, so host 0 merges shards by raw byte
    append, with no per-record decode or re-encode."""

    def __init__(self, fileobj):
        from ..io.bgzf import BgzfWriter

        self._w = BgzfWriter(fileobj)
        self._f = fileobj

    def write_record(self, rec):
        from ..io.bam import encode_record

        self._w.write(encode_record(rec))

    def write_raw(self, data: bytes):
        self._w.write(data)

    def close(self):
        self._w.flush()
        self._f.flush()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _merge_bam_shards(out_file_path: str, count: int, header, force_overwrite):
    """Merge: header + raw shard bytes + EOF.  Streams at disk bandwidth."""
    import shutil

    from ..io.bam import BamWriter
    from ..io.bgzf import BGZF_EOF

    if not force_overwrite and os.path.exists(out_file_path):
        raise FileExistsError(out_file_path)
    with open(out_file_path, "wb") as raw:
        writer = BamWriter(raw, header)
        writer._w.flush()  # header blocks out, no EOF yet
        for i in range(count):
            shard = f"{out_file_path}.shard{i}"
            with open(shard, "rb") as f:
                shutil.copyfileobj(f, raw, 1 << 20)
            os.remove(shard)
        raw.write(BGZF_EOF)
