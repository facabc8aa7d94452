"""Dispatcher: distributes read chunks to TCP workers, writes BAM output.

Counterpart of reference src/distributed/dispatcher.rs: a selectors-based
single-threaded non-blocking event loop.  The dispatcher owns the input task
queue, suffix array, contig map, original symbols and the output BAM;
workers hold only the FMD-index and return raw hit intervals.  A dying
worker's chunk is re-queued (dispatcher.rs:384-401); the loop ends when the
queue is exhausted and all connections are drained.
"""

from __future__ import annotations

import logging
import selectors
import socket

from ..errors import MapadError
from ..index import load_index
from ..io.bam import BamWriter
from ..io.sniff import InputSource
from ..map.postprocess import SplitMixRng, create_bam_header, intervals_to_bam
from . import wire

logger = logging.getLogger(__name__)


class _Connection:
    def __init__(self, sock):
        self.sock = sock
        self.rx = bytearray()
        self.tx = b""
        self.tx_sent = 0
        self.assigned_task = None


class Dispatcher:
    def __init__(self, reads_path, reference_path, out_file_path,
                 force_overwrite, alignment_parameters, read_group=None,
                 cmdline=None, position_seed: int = 0):
        import os

        if reads_path != "-" and not os.path.exists(reads_path):
            raise MapadError("The given input file could not be found")
        if not force_overwrite and os.path.exists(out_file_path):
            raise MapadError(
                f"Output file {out_file_path} exists (use --force_overwrite)"
            )

        logger.info("Load suffix array and position maps")
        self.index = load_index(reference_path)
        self.reference_path = reference_path
        self.parameters = alignment_parameters
        self.read_group = read_group
        self.position_seed = position_seed

        self.input_source = InputSource.from_path(reads_path)
        self.out_header = create_bam_header(
            self.input_source.header, self.index.id_pos_map, read_group, cmdline
        )
        self.task_queue = self.input_source.task_queue(
            alignment_parameters.chunk_size
        )
        self._out_file = open(out_file_path, "wb")
        self.writer = BamWriter(self._out_file, self.out_header)
        self._queue_exhausted = False

    def run(self, port: int):
        sel = selectors.DefaultSelector()
        listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        listener.bind(("0.0.0.0", port))
        listener.listen()
        listener.setblocking(False)
        sel.register(listener, selectors.EVENT_READ, None)
        logger.info("Dispatcher listening on port %d", port)

        connections: set[_Connection] = set()
        first_task_sent: set[int] = set()

        try:
            while True:
                if self._finished(connections):
                    break
                events = sel.select(timeout=0.2)
                for key, mask in events:
                    if key.data is None:
                        try:
                            sock, addr = listener.accept()
                        except OSError:
                            continue
                        if self._queue_exhausted:
                            # decline late workers (dispatcher.rs:215-217)
                            sock.close()
                            continue
                        sock.setblocking(False)
                        conn = _Connection(sock)
                        connections.add(conn)
                        sel.register(sock, selectors.EVENT_WRITE, conn)
                        logger.info("Worker connected: %s", addr)
                        continue

                    conn = key.data
                    try:
                        if mask & selectors.EVENT_WRITE:
                            self._handle_writable(sel, conn, first_task_sent)
                        if mask & selectors.EVENT_READ:
                            self._handle_readable(sel, conn)
                    except (ConnectionError, OSError) as e:
                        logger.warning("Worker connection lost: %s", e)
                        self._release_worker(sel, conn, connections)
        finally:
            for conn in connections:
                try:
                    conn.sock.close()
                except OSError:
                    pass
            listener.close()
            self.writer.close()
            self._out_file.close()
        logger.info("Done")

    # --- event handlers ---

    def _next_task(self):
        try:
            return next(self.task_queue)
        except StopIteration:
            self._queue_exhausted = True
            return None

    def _handle_writable(self, sel, conn, first_task_sent):
        if not conn.tx:
            task = self._next_task()
            if task is None:
                # nothing to send: wait for results only
                sel.modify(conn.sock, selectors.EVENT_READ, conn)
                return
            if id(conn) not in first_task_sent:
                task.reference_path = self.reference_path
                task.alignment_parameters = self.parameters
                first_task_sent.add(id(conn))
            conn.assigned_task = task
            conn.tx = wire.encode_task_sheet(task)
            conn.tx_sent = 0
        sent = conn.sock.send(conn.tx[conn.tx_sent :])
        conn.tx_sent += sent
        if conn.tx_sent >= len(conn.tx):
            conn.tx = b""
            conn.tx_sent = 0
            sel.modify(conn.sock, selectors.EVENT_READ, conn)

    def _handle_readable(self, sel, conn):
        data = conn.sock.recv(1 << 20)
        if not data:
            raise ConnectionError("EOF from worker")
        conn.rx += data
        while len(conn.rx) >= wire.HEADER.size:
            total, msg_type = wire.HEADER.unpack_from(conn.rx, 0)
            if len(conn.rx) < total:
                break
            payload = bytes(conn.rx[wire.HEADER.size : total])
            del conn.rx[:total]
            if msg_type == wire.MSG_RESULT:
                chunk_id, results = wire.decode_result_sheet(payload)
                conn.assigned_task = None
                self._write_results(chunk_id, results)
                sel.modify(conn.sock, selectors.EVENT_WRITE, conn)

    def _release_worker(self, sel, conn, connections):
        try:
            sel.unregister(conn.sock)
        except (KeyError, ValueError):
            pass
        try:
            conn.sock.close()
        except OSError:
            pass
        connections.discard(conn)
        if conn.assigned_task is not None:
            logger.info("Re-queue chunk %d", conn.assigned_task.chunk_id)
            task = conn.assigned_task
            task.reference_path = None
            task.alignment_parameters = None
            self.task_queue.requery_task(task)
            self._queue_exhausted = False
            conn.assigned_task = None
            # a worker that found the queue empty waits for a task without
            # being watched for writing: only this chunk would reach it
            for other in connections:
                if other.assigned_task is None and not other.tx:
                    sel.modify(other.sock, selectors.EVENT_WRITE, other)

    def _finished(self, connections):
        # Queue drained and no chunk in flight (dispatcher.rs:323-332).
        return self._queue_exhausted and not any(
            c.assigned_task is not None for c in connections
        )

    # --- output (dispatcher-side interval -> BAM, dispatcher.rs:340-379) ---

    def _write_results(self, chunk_id, results):
        logger.debug("Write chunk %d of BAM records to output file", chunk_id)
        rg_id = self.read_group[0] if self.read_group else None
        for i, (record, hits, duration) in enumerate(results):
            rng = SplitMixRng((self.position_seed << 40) ^ (chunk_id << 20) ^ i)
            bam_record = intervals_to_bam(
                record, hits, self.index.suffix_array, self.index.id_pos_map,
                self.index.original_symbols, duration, self.parameters,
                rg_id, rng,
            )
            self.writer.write_record(bam_record)
