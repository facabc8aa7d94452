"""Readings at the sheet boundaries of a streaming `map`.

While a `SheetWatch` is on, every run of the streaming driver
(`map/pipeline.py` `_run_inner_streaming`, which `pipeline.run` takes for
the device and hybrid engines) is watched through its blocks iterator.
Each time the engine pulls the first block of a sheet after the first, and
once more when the run has ended, it records the card's allocated and
reserved bytes (where `torch` is given), the process's resident set
(VmRSS), the reads pulled so far, the seconds since the run began, the
engine's blocks and stage seconds (STAGE_STATS) and, for the hybrid
engine, its device fraction.  The allocated bytes of a sheet boundary are
those the device thread sees as it begins the next block after the turn,
before that block's own tensors: what the engine holds between blocks,
whatever block is in flight when the sheet turns.  It also counts the
input blocks and the tier blocks prepared (a block prepared under a
config other than the primary: the deep tier's), and takes the engine's
tier counters when the input ran out.  For each block it records the
upload route the engine took (`route`: "lut", the device-LUT blob that K4
or K6 unpacks; "host", the host-scored rows or dense arrays), the highest
base quality among its reads that fit the pool (`max_qual`: the route's
input), and its prep seconds; for each block the device thread ran, its
route and seconds.

    with SheetWatch(torch) as watch:
        pipeline.run(...)
    run = watch.runs[-1]
"""

from __future__ import annotations

import time

TIER_STATS = ("deep_retried", "retried")
# the engine's counters taken at each reading: its blocks (`batches`) and
# stage seconds, for each sheet's share
STAGE_STATS = ("batches", "prep_s", "device_s", "wait_s", "decode_s",
               "fb_secs")


def deep_before(run) -> int:
    """The deep blocks of a watched run submitted before its input ran
    out: those whose reads, summed in the order prepared, fit in the
    `deep_retried` count taken then."""
    n = total = 0
    for size in run["tier_blocks"]:
        total += size
        n += total <= run["exhausted"]["deep_retried"]
    return n


def route(prep) -> str:
    """The upload route of one prepared block (a shard's, with a mesh):
    "lut" where the card unpacks the device-LUT blob (K4, or K6 in big
    mode), else "host" (the host-scored rows, or big mode's dense
    arrays)."""
    if "shards" in prep:
        return route(prep["shards"][0])
    return "lut" if prep.get("dev_lut") or prep.get("dev_full") else "host"


def resident_bytes() -> int:
    """This process's resident set (VmRSS of /proc/self/status)."""
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) * 1024
    raise RuntimeError("no VmRSS in /proc/self/status")


class SheetWatch:
    """Patches `pipeline._run_inner_streaming` while on; `runs` holds a
    dict for each run: `samples` (one at each sheet boundary, the last at
    the end), `sheets` (reads a sheet), `input_blocks`, `tier_blocks`
    (the reads of each tier block, in the order prepared), `exhausted`
    (the tier counters when the input ran out; `deep_before`), `blocks`
    (a dict a block prepared: `tier`, `reads`, `max_qual`, `route`,
    `prep_s`), `runs` (a dict a block the device thread ran: `route`,
    `device_s`) and `seconds`."""

    def __init__(self, torch=None):
        self.torch = torch
        self.runs: list = []

    def sample(self, run, engine, dev, chunk_id, allocated=None):
        s = dict(chunk_id=chunk_id, reads=run["reads"],
                 seconds=time.perf_counter() - run["t0"],
                 rss=resident_bytes(),
                 stats={k: dev._stats.get(k, 0) for k in STAGE_STATS})
        if self.torch is not None:
            s.update(allocated=allocated,
                     reserved=self.torch.cuda.memory_reserved())
            if allocated is None:  # filled as the next block begins
                run["pending"].append(s)
        if hasattr(engine, "_p"):
            s["device_fraction"] = engine._p
        run["samples"].append(s)

    def __enter__(self):
        from ..map import pipeline
        from ..ops.engine import HybridSearchEngine

        self._pipeline = pipeline
        self._inner = inner = pipeline._run_inner_streaming
        watch = self

        def watched(task_queue, index, params, read_group, engine, *a, **kw):
            dev = (engine.device if isinstance(engine, HybridSearchEngine)
                   else engine)
            run = dict(samples=[], sheets=[], input_blocks=0, tier_blocks=[],
                       exhausted=None, reads=0, t0=time.perf_counter(),
                       pending=[], blocks=[], runs=[])
            watch.runs.append(run)
            prep, stream = dev._prep_block, engine.search_stream
            run_block = dev._run_block

            def prep_block(recs, R, cfg):
                tier = cfg != dev.pool_config
                if tier:
                    run["tier_blocks"].append(len(recs))
                t = time.perf_counter()
                out = prep(recs, R, cfg)
                run["blocks"].append(dict(
                    tier=tier, reads=len(recs), route=route(out[1]),
                    prep_s=time.perf_counter() - t,
                    max_qual=max((max(r.base_qualities, default=0)
                                  for r in recs
                                  if len(r.sequence) <= cfg.max_len),
                                 default=0)))
                return out

            def timed_block(cfg, prep_, *a, **k):
                while True:  # the shards of a mesh begin blocks at once
                    try:
                        s = run["pending"].pop()
                    except IndexError:
                        break
                    s["allocated"] = watch.torch.cuda.memory_allocated()
                t = time.perf_counter()
                out = run_block(cfg, prep_, *a, **k)
                run["runs"].append(dict(route=route(prep_),
                                        device_s=time.perf_counter() - t))
                return out

            def pulled(blocks):
                for (sheet, off), recs in blocks:
                    if off == 0:
                        if sheet.chunk_id:
                            watch.sample(run, engine, dev, sheet.chunk_id)
                        run["sheets"].append(len(sheet.records))
                    run["input_blocks"] += 1
                    run["reads"] += len(recs)
                    yield (sheet, off), recs
                run["exhausted"] = {k: dev._stats.get(k, 0)
                                    for k in TIER_STATS}

            dev._prep_block, dev._run_block = prep_block, timed_block
            engine.search_stream = lambda blocks, **k: stream(pulled(blocks),
                                                              **k)
            try:
                return inner(task_queue, index, params, read_group, engine,
                             *a, **kw)
            finally:
                del dev._prep_block, dev._run_block, engine.search_stream
                now = None
                if watch.torch is not None:
                    watch.torch.cuda.synchronize()
                    now = watch.torch.cuda.memory_allocated()
                watch.sample(run, engine, dev, None, now)
                run["seconds"] = time.perf_counter() - run["t0"]

        pipeline._run_inner_streaming = watched
        return self

    def __exit__(self, *exc):
        self._pipeline._run_inner_streaming = self._inner
