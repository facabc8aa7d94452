"""Worker: maps task-sheet chunks against the FMD-index.

Counterpart of reference src/distributed/worker.rs: a blocking TCP client
that lazily loads the FMD-index from the shared filesystem path carried by
the first task sheet (workers never load the suffix array), caches the
alignment parameters, maps each chunk and returns raw hit intervals.

The engine is the pool-mode `DeviceSearchEngine` on the card unless the
caller names another device (`device="cpu"` runs the plain PyTorch
versions of the kernels); without CUDA and with no device named, the
constructor raises.  It is built at the first chunk and kept until a task sheet
brings new alignment parameters, so the kernels' set-up is paid once.
"""

from __future__ import annotations

import logging
import socket

from ..index import load_index
from . import wire

logger = logging.getLogger(__name__)


class Worker:
    def __init__(self, host: str, port: int, engine_factory=None,
                 device=None, lanes: int = 2048):
        self.host = host
        self.port = port
        self.fmd = None
        self.parameters = None
        self.engine = None
        # engine_factory(fmd, params) -> search engine (tests); else the
        # device engine on `device` (the card when None) at `lanes`
        self._engine_factory = engine_factory
        self.device = None
        if engine_factory is None:
            from ..ops.fm import resolve_device

            self.device = resolve_device(device)
        self.lanes = lanes

    def _make_engine(self):
        if self._engine_factory is not None:
            return self._engine_factory(self.fmd, self.parameters)
        from ..ops.engine import DeviceSearchEngine

        return DeviceSearchEngine(self.fmd, self.parameters,
                                  lanes=self.lanes, device=self.device)

    def run(self):
        sock = socket.create_connection((self.host, self.port))
        logger.info("Connected to dispatcher %s:%d", self.host, self.port)
        try:
            while True:
                msg = wire.read_message(sock)
                if msg is None:
                    logger.info("Dispatcher closed the connection; exiting")
                    return
                msg_type, payload = msg
                if msg_type != wire.MSG_TASK:
                    continue
                task = wire.decode_task_sheet(payload)
                if task.alignment_parameters is not None:
                    self.parameters = task.alignment_parameters
                    self.engine = None
                if task.reference_path is not None and self.fmd is None:
                    logger.info("Load FMD-index")
                    self.fmd = load_index(task.reference_path).fmd
                if self.engine is None:
                    self.engine = self._make_engine()
                logger.debug("Map chunk %d (%d reads)", task.chunk_id,
                             len(task.records))
                search_out = self.engine.search_chunk(task.records)
                results = [
                    (record, hits, duration)
                    for record, (hits, duration) in zip(task.records, search_out)
                ]
                sock.sendall(wire.encode_result_sheet(task.chunk_id, results))
        finally:
            sock.close()
