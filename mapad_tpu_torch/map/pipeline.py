"""Local mapping driver (counterpart of mapad_tpu/map/pipeline.py and
reference mapping.rs:57-296).

Chunks the input, runs a search engine over each chunk, converts hit
intervals to BAM records and writes them in input order.  The conversion
runs in the native C++ postprocessor (map/native_post.py) or, without a
C++ compiler or with MAPAD_NO_NATIVE_POST set, per record in Python
(map/postprocess.py).  The search engine is pluggable:

- OracleSearchEngine: exact sequential host search in Python (the default
  of `run` when no engine is passed; `--engine oracle`);
- NativeSearchEngine (map/native_search.py): the exact host C++ search;
- DeviceSearchEngine, HybridSearchEngine (ops/engine.py): the pool search
  on the card, with the host C++ searcher for escalated reads (and, in the
  hybrid engine, for the tail of every block), through the streaming block
  pipeline `_run_inner_streaming`.
"""

from __future__ import annotations

import json
import logging
import os
import time

from ..errors import MapadError
from ..index import load_index
from ..io.bam import BamWriter
from ..io.sniff import InputSource
from .oracle import k_mismatch_search
from .postprocess import SplitMixRng, create_bam_header, intervals_to_bam

logger = logging.getLogger(__name__)


class OracleSearchEngine:
    """Sequential host search engine: exact reference semantics."""

    def __init__(self, fmd_index, parameters):
        self.fmd = fmd_index
        self.parameters = parameters

    def search_chunk(self, records):
        """-> list of (hits, duration_seconds) aligned with records."""
        out = []
        for record in records:
            start = time.perf_counter()
            hits = k_mismatch_search(
                record.sequence,
                record.base_qualities,
                self.parameters,
                self.fmd,
            )
            out.append((hits, time.perf_counter() - start))
        return out


def run(
    reads_path: str,
    reference_path: str,
    out_file_path: str,
    force_overwrite: bool,
    alignment_parameters,
    read_group=None,
    engine=None,
    position_seed: int = 0,
    cmdline: str | None = None,
    threads: int = 1,
    index=None,
):
    """Load index parts and launch the mapping process (mapping.rs:57-125).

    `index`: a preloaded LoadedIndex to reuse across runs (the reference
    loads once per process, mapping.rs:75-90; callers mapping several
    inputs against one genome -- or benchmarking repeat passes -- skip
    the multi-minute genome-scale reload)."""
    if reads_path != "-" and not os.path.exists(reads_path):
        raise MapadError("The given input file could not be found")

    if index is None:
        logger.info("Load index")
        index = load_index(reference_path)
    mb = alignment_parameters.mismatch_bound
    if hasattr(mb, "__str__") and type(mb).__str__ is not object.__str__:
        logger.debug("Allowed mismatches:\n%s", mb)

    if engine is None:
        engine = OracleSearchEngine(index.fmd, alignment_parameters)

    if not force_overwrite and os.path.exists(out_file_path):
        raise MapadError(f"Output file {out_file_path} exists (use --force_overwrite)")

    logger.info("Map reads")
    input_source = InputSource.from_path(reads_path)
    out_header = create_bam_header(
        input_source.header, index.id_pos_map, read_group, cmdline
    )

    with open(out_file_path, "wb") as raw:
        with BamWriter(raw, out_header) as writer:
            run_inner(
                input_source.task_queue(alignment_parameters.chunk_size),
                index,
                alignment_parameters,
                read_group,
                engine,
                writer,
                position_seed,
                threads,
            )
    logger.info("Done")


def run_inner(
    task_queue, index, alignment_parameters, read_group, engine, writer,
    position_seed: int = 0, threads: int = 1,
):
    """Search and postprocess run as a two-stage pipeline: a background
    thread converts and writes chunk k while the engine searches chunk k+1
    (the device work releases the GIL while the host waits).  With
    threads > 1 the per-record conversions inside a chunk additionally run
    on a thread pool (order-preserving; the reference parallelizes this
    loop with rayon, mapping.rs:193-215); SA lookups through the native
    accelerator release the GIL.

    Engines exposing `search_stream` (the device pool engine) instead run
    the fully streaming pipeline: sheets are sliced into device-sized blocks
    and prep / device search / result fetch / fallback / BAM conversion /
    ordered write all overlap across neighbouring blocks."""
    if hasattr(engine, "search_stream"):
        return _run_inner_streaming(
            task_queue, index, alignment_parameters, read_group, engine,
            writer, position_seed, threads,
        )
    from concurrent.futures import ThreadPoolExecutor

    from . import native_post

    read_group_id = read_group[0] if read_group else None

    # Hot output path: the whole chunk's coordinate resolution / MAPQ /
    # CIGAR/MD / BAM encode runs in one GIL-released native call
    # (byte-equivalent to the Python path below; tests/test_native_post.py).
    native_pp = None
    if native_post.available() and not os.environ.get("MAPAD_NO_NATIVE_POST"):
        try:
            native_pp = native_post.NativePostprocessor(
                index, alignment_parameters, threads=max(threads, 1)
            )
        except Exception:  # pragma: no cover - fall back to Python path
            logger.warning("native postprocessor init failed", exc_info=True)

    def convert(sheet, i, record, hits, duration):
        if isinstance(hits, native_post.PackedHits):
            hits = hits.decode()
        # Deterministic per-read RNG for PrRange position enumeration
        rng = SplitMixRng(
            (position_seed << 40) ^ (sheet.chunk_id << 20) ^ i
        )
        return intervals_to_bam(
            record,
            hits,
            index.suffix_array,
            index.id_pos_map,
            index.original_symbols,
            duration,
            alignment_parameters,
            (read_group_id if read_group else None),
            rng,
        )

    convert_pool = (
        ThreadPoolExecutor(max_workers=threads) if threads > 1 else None
    )

    def postprocess(sheet, results):
        t0 = time.perf_counter()
        if lazy:
            # escalated reads' exact fallback searches are still running
            # on the engine's thread pool; resolving here (the postprocess
            # thread) overlaps them with the next sheet's search
            from concurrent.futures import Future

            results = [
                r.result() if isinstance(r, Future) else r for r in results
            ]
        if native_pp is not None:
            blob = native_pp.convert_chunk(
                sheet.records, results, sheet.chunk_id, position_seed,
                read_group,
            )
            t1 = time.perf_counter()
            writer.write_raw(blob)
            logger.debug(
                "postprocess chunk %d: convert %.0fms write %.0fms",
                sheet.chunk_id, (t1 - t0) * 1e3,
                (time.perf_counter() - t1) * 1e3,
            )
            return
        if convert_pool is not None:
            bam_records = list(
                convert_pool.map(
                    lambda args: convert(sheet, *args),
                    [
                        (i, record, hits, duration)
                        for i, (record, (hits, duration)) in enumerate(
                            zip(sheet.records, results)
                        )
                    ],
                )
            )
        else:
            bam_records = [
                convert(sheet, i, record, hits, duration)
                for i, (record, (hits, duration)) in enumerate(
                    zip(sheet.records, results)
                )
            ]
        for bam_record in bam_records:
            writer.write_record(bam_record)

    import inspect

    lazy = "lazy_fallback" in inspect.signature(
        engine.search_chunk
    ).parameters

    try:
        with ThreadPoolExecutor(max_workers=1) as pool:
            pending = None
            for sheet in task_queue:
                logger.debug("Map chunk %d of records", sheet.chunk_id)
                results = (
                    engine.search_chunk(sheet.records, lazy_fallback=True)
                    if lazy else engine.search_chunk(sheet.records)
                )
                if pending is not None:
                    pending.result()
                pending = pool.submit(postprocess, sheet, results)
            if pending is not None:
                pending.result()
    finally:
        if convert_pool is not None:
            convert_pool.shutdown()


def _run_inner_streaming(
    task_queue, index, alignment_parameters, read_group, engine, writer,
    position_seed: int = 0, threads: int = 1,
):
    """Fully overlapped block pipeline over a streaming-capable engine.

    Stages (all concurrent, rayon-loop analogue of mapping.rs:146-296):
      prep thread (inside engine.search_stream) -> device search (<=2 pool
      invocations in flight) -> collect/decode (this thread) -> fallback
      pool (escalated reads) -> conversion pool (coordinates/MAPQ/CIGAR/MD/
      BAM encode, GIL-released C++) -> ordered writer thread.

    Output record order is identical to the sequential path: blocks are
    written in submission order and the per-read PrRange seed uses the
    in-sheet index (index_offset), so the BAM is byte-identical.
    """
    import queue as queue_mod
    import threading
    from concurrent.futures import Future, ThreadPoolExecutor

    from . import native_post

    read_group_id = read_group[0] if read_group else None

    native_pp = None
    if native_post.available() and not os.environ.get("MAPAD_NO_NATIVE_POST"):
        try:
            native_pp = native_post.NativePostprocessor(
                index, alignment_parameters, threads=max(threads, 1)
            )
        except Exception:  # pragma: no cover - fall back to Python path
            logger.warning("native postprocessor init failed", exc_info=True)

    R = engine.block_reads

    def sheets_prefetched():
        """Parse input sheets on a reader thread so record decoding
        overlaps the pipeline instead of stalling the block feed.

        The reader checks a `closed` flag while putting so an abandoned
        consumer (e.g. a downstream exception unwinding the pipeline)
        releases the thread instead of leaving it blocked on a full
        queue pinning parsed sheets and open input handles."""
        q: "queue_mod.Queue" = queue_mod.Queue(maxsize=2)
        closed = threading.Event()

        def put_until_closed(item) -> bool:
            while not closed.is_set():
                try:
                    q.put(item, timeout=0.2)
                    return True
                except queue_mod.Full:
                    continue
            return False

        def reader():
            try:
                for sheet in task_queue:
                    if not put_until_closed(sheet):
                        return
                put_until_closed(None)
            except BaseException as e:  # surfaced on the consumer side
                put_until_closed(e)

        threading.Thread(
            target=reader, name="input-reader", daemon=True
        ).start()
        try:
            while True:
                s = q.get()
                if s is None:
                    return
                if isinstance(s, BaseException):
                    raise s
                yield s
        finally:
            closed.set()

    def blocks():
        for sheet in sheets_prefetched():
            logger.debug("Map chunk %d of records", sheet.chunk_id)
            recs = sheet.records
            for off in range(0, max(len(recs), 1), R):
                yield (sheet, off), recs[off : off + R]

    def convert_py(sheet, off, block, results):
        out = []
        for i, (record, (hits, duration)) in enumerate(zip(block, results)):
            if isinstance(hits, native_post.PackedHits):
                hits = hits.decode()
            rng = SplitMixRng(
                (position_seed << 40) ^ (sheet.chunk_id << 20) ^ (off + i)
            )
            out.append(
                intervals_to_bam(
                    record, hits, index.suffix_array, index.id_pos_map,
                    index.original_symbols, duration, alignment_parameters,
                    (read_group_id if read_group else None), rng,
                )
            )
        return out

    def pp_task(sheet, off, block, results):
        t0 = time.perf_counter()
        # escalated reads' exact fallback searches may still be running on
        # the engine's pool; resolving here overlaps them with later blocks
        results = [
            r.result() if isinstance(r, Future) else r for r in results
        ]
        t_wait = time.perf_counter() - t0
        if native_pp is not None:
            out = native_pp.convert_chunk(
                block, results, sheet.chunk_id, position_seed, read_group,
                index_offset=off,
            )
        else:
            out = convert_py(sheet, off, block, results)
        logger.debug(
            "postprocess block (chunk %d @%d): %.0fms (fallback wait %.0fms)",
            sheet.chunk_id, off, (time.perf_counter() - t0) * 1e3,
            t_wait * 1e3,
        )
        return out

    # Ordered writer: conversion futures are enqueued in block-submission
    # order and written in that order, whatever order they complete in.
    # While it waits on one, the stream runs on until STREAM_WAIT more are
    # queued: the engine's tiers resolve a block's futures by then.
    from ..ops.engine import STREAM_WAIT

    write_q: "queue_mod.Queue" = queue_mod.Queue(maxsize=STREAM_WAIT)
    write_err: list = []

    def writer_loop():
        while True:
            fut = write_q.get()
            if fut is None:
                return
            if write_err:
                continue  # drain without writing after a failure
            try:
                out = fut.result()
                if isinstance(out, (bytes, bytearray)):
                    writer.write_raw(out)
                else:
                    for rec in out:
                        writer.write_record(rec)
            except BaseException as e:  # surfaced on the main thread
                write_err.append(e)

    wt = threading.Thread(target=writer_loop, name="bam-writer", daemon=True)
    wt.start()
    pp_pool = ThreadPoolExecutor(max_workers=2, thread_name_prefix="postproc")
    try:
        for (sheet, off), results in engine.search_stream(
            blocks(), lazy_fallback=True
        ):
            block = sheet.records[off : off + R]
            write_q.put(pp_pool.submit(pp_task, sheet, off, block, results))
        write_q.put(None)
        wt.join()
        if write_err:
            raise write_err[0]
    finally:
        pp_pool.shutdown(wait=False)
    stats = engine.stats()
    logger.info("search stats: %s", json.dumps(stats),
                extra={"search_stats": stats})
