"""The pool search over several devices (kernel K9).

Counterpart of mapad_tpu/parallel/pool_sharded.py.  A block's reads are
dealt into D contiguous shard slices; shard d runs its *own* persistent
pool loop (K2 with K1 inline, then K3, ops/search_pool2.py) on its own
device and stream, from its own host thread, over its R/D reads -- there is
no lock step between shards, so a shard whose reads finish early stops
stepping instead of idling behind the slowest one (what `shard_map`'s
per-device loops amount to in mapad_tpu).  Each shard's read ids are then
re-based to global ids (`shard_rebase`, csrc/pool_sharded.cu) and the
results are stacked along a leading device axis, so the host collector can
take the shards one by one (completion-order slot semantics hold within a
shard).

K9 is the whole of `pool_search_sharded`; its device part of its own is
`shard_rebase`, launched once per shard per invocation after K3.  The
engine's mesh path (ops/engine.py) runs its shards on the same per-shard
threads and streams (`ShardRunner`), each shard's upload, K4, K2 + K3 into
K3's one allocation and K5, which makes the ids global as it packs them
(`_pack_buffer(..., rebase=...)`: no `shard_rebase` launch and no
PoolResult there).  Bound on the card: bytes, the sum of the shards'
K2 + K3 bytes plus the rebase's (C + L) * 4 * 2.  The plain version
`pool_search_sharded_plain` runs the shards' plain pool loops one after
another on their tensors' device and stacks them.
"""

from __future__ import annotations

import ctypes
import threading
from concurrent.futures import Future, ThreadPoolExecutor

import numpy as np
import torch

from .._build import (LAUNCHES, check, cuda_function, current_raw_stream,
                      require)
from ..ops import search_pool2 as sp2
from ..ops.search_pool import PoolConfig, PoolResult
from .sharding import canonical, shard_search_inputs

CONST_KEYS = ("n", "split", "cutoff_scale", "cutoff_thresh", "repr_mm")
DENSE_KEYS = ("pattern_rank", "pattern_code", "score_lut", "pen")


def shard_reads(mesh, prep: dict) -> list:
    """Per-read arrays cut into the mesh's shard slices (R must divide)."""
    R = prep["n"].shape[0]
    assert R % len(mesh) == 0, f"reads {R} must divide mesh size {len(mesh)}"
    return shard_search_inputs(mesh, prep)


def round_robin_permutation(R: int, D: int) -> np.ndarray:
    """Permutation placing reads round-robin into the D contiguous shard
    slices (reads[perm][d*R/D:(d+1)*R/D] = every D-th read, offset d).

    Input files carry positional correlation (damage, length and
    repeat-region runs), so a contiguous split bears more per-shard step
    spread than dealing; a cost-model deal did no better in mapad_tpu's
    measurements (tools/balance_probe.py there).  Invert with
    np.argsort(perm) to map results back."""
    shard_of = np.arange(R, dtype=np.int64) % D
    return np.argsort(shard_of, kind="stable")


def balanced_shard_permutation(pred_costs: np.ndarray, D: int) -> np.ndarray:
    """Permutation placing reads so the D contiguous shard slices have
    near-equal predicted total cost (snake deal over descending cost), for
    workloads where a real per-read cost estimate exists.  Returns `perm`
    such that reads[perm] has shard d's reads at [d*R/D, (d+1)*R/D)."""
    R = len(pred_costs)
    order = np.argsort(-np.asarray(pred_costs), kind="stable")
    shard_of = np.empty(R, dtype=np.int64)
    for k in range(R):
        d = k % (2 * D)
        shard_of[order[k]] = d if d < D else 2 * D - 1 - d
    return np.argsort(shard_of, kind="stable")


# --- shard_rebase: local -> global read ids ------------------------------


def _shard_rebase_plain(res: PoolResult, base: int, r_local: int,
                        r_global: int) -> PoolResult:
    """Plain PyTorch `shard_rebase`, in place: c_read + base where >= 0
    (else -1), lane_read + base where < r_local (else r_global),
    next_read + base."""
    res.c_read.copy_(torch.where(res.c_read >= 0, res.c_read + base, -1))
    res.lane_read.copy_(torch.where(res.lane_read < r_local,
                                    res.lane_read + base, r_global))
    res.next_read.add_(base)
    return res


class _RebaseArgs(ctypes.Structure):
    """Mirror of `struct RebaseArgs` in csrc/pool_sharded.cu."""

    _fields_ = [
        ("c_read", ctypes.c_void_p), ("lane_read", ctypes.c_void_p),
        ("next_read", ctypes.c_void_p), ("C", ctypes.c_int),
        ("L", ctypes.c_int), ("base", ctypes.c_int),
        ("r_local", ctypes.c_int), ("r_global", ctypes.c_int),
    ]


class _Rebase(threading.local):
    """A thread's launches of `shard_rebase`: the entry point, typed once,
    and one argument block, its sizes checked only when the result's shape
    changes; a call sets the three pointers and the shard's slice."""

    def __init__(self):
        self.args = _RebaseArgs()
        self.fn = cuda_function("pool_sharded", "shard_rebase",
                                [ctypes.POINTER(_RebaseArgs),
                                 ctypes.c_void_p])
        self.shape = None

    def set_shape(self, res: PoolResult):
        shape = (res.c_read.shape, res.lane_read.shape, res.next_read.shape)
        if self.shape == shape:
            return
        for t in (res.c_read, res.lane_read, res.next_read):
            require(t.is_cuda and t.dtype == torch.int32 and t.is_contiguous(),
                    "shard_rebase takes contiguous int32 CUDA tensors")
        require(res.c_read.ndim == res.lane_read.ndim == 1
                and res.next_read.numel() == 1,
                "c_read and lane_read are vectors, next_read one word")
        self.args.C, self.args.L = res.c_read.shape[0], res.lane_read.shape[0]
        self.shape = shape


_rebase = None


def shard_rebase(res: PoolResult, base: int, r_local: int,
                 r_global: int) -> PoolResult:
    """`shard_rebase` wrapper, in place on c_read, lane_read and next_read:
    the plain version for CPU tensors, the kernel for CUDA tensors (never a
    fallback)."""
    global _rebase
    if not res.c_read.is_cuda:
        return _shard_rebase_plain(res, base, r_local, r_global)
    require(0 <= base and base + r_local <= r_global < 2**31,
            "shard slice outside the block")
    if _rebase is None:
        _rebase = _Rebase()
    k = _rebase
    k.set_shape(res)
    a = k.args
    a.c_read, a.lane_read, a.next_read = (res.c_read.data_ptr(),
                                          res.lane_read.data_ptr(),
                                          res.next_read.data_ptr())
    a.base, a.r_local, a.r_global = base, r_local, r_global
    LAUNCHES.add("shard_rebase")
    rc = k.fn(a, current_raw_stream())
    if rc:
        check(rc, "shard_rebase")
    return res


# --- K9 ---------------------------------------------------------------


def search_shard(index, consts, params, config: PoolConfig, base: int,
                 r_global: int, slut=None, dense=None, bid_steps=None,
                 plain: bool = False) -> PoolResult:
    """One shard's pool invocation over its R/D reads, then its ids made
    global: the body of every shard of K9, in `pool_search_sharded` and in
    the engine's mesh path.  `consts` and the keyword inputs are those of
    `k_mismatch_search_pool2` (the five per-read consts; the (R*M, 6)
    LUT/Bi-D rows or the dense arrays).  `plain`: the plain versions on the
    tensors' device."""
    r_local = consts[0].shape[0]
    if not plain:
        res = sp2.k_mismatch_search_pool2(index, *consts, params, config,
                                          slut=slut, dense=dense,
                                          bid_steps=bid_steps)
        return shard_rebase(res, base, r_local, r_global)
    sp2._check_config(config, r_local)
    if dense is not None:
        slut = sp2._dense_slut(index, dense, consts[0], consts[1], config,
                               bid_steps, plain=True)
    res = sp2._extract_chains_plain(
        *sp2._pool_loop_plain(index, *consts, params, config, slut), config)
    return _shard_rebase_plain(res, base, r_local, r_global)


def _shard_inputs(part: dict):
    """A shard's slice of a K9 prep (CONST_KEYS and either `slut_packed` or
    the DENSE_KEYS) -> (consts, keyword inputs) of `search_shard`."""
    consts = tuple(part[k] for k in CONST_KEYS)
    if "slut_packed" in part:
        return consts, dict(slut=part["slut_packed"])
    dense = [part[k] for k in DENSE_KEYS]
    dense[0] = dense[0].to(torch.int32)
    return consts, dict(dense=tuple(dense))


class ShardRunner:
    """A host thread, a stream and a copy stream for each shard of a mesh
    (also for shards that share a card), kept for the runner's life: what
    `shard_map`'s per-device loops amount to.  No shard waits for another.
    The engine's mesh path and `pool_search_sharded` run their shards
    through one."""

    def __init__(self, mesh):
        self.mesh = [canonical(dev) for dev in mesh]
        self._execs = [
            ThreadPoolExecutor(max_workers=1,
                               thread_name_prefix=f"pool-shard{d}")
            for d in range(len(self.mesh))
        ]
        # (stream, copy stream) of each shard on a card
        self.streams = [
            (torch.cuda.Stream(dev), torch.cuda.Stream(dev))
            if dev.type == "cuda" else (None, None)
            for dev in self.mesh
        ]

    def submit(self, d, fn, *args, **kw) -> Future:
        """fn(*args, **kw) on shard d's thread.  On a card it runs with
        shard d's device and stream current, and that stream first waits
        for the submitting thread's current stream there (inputs made
        there are ready; torch's current stream is per thread)."""
        dev = self.mesh[d]
        stream = self.streams[d][0]
        if stream is None:
            return self._execs[d].submit(fn, *args, **kw)
        stream.wait_stream(torch.cuda.current_stream(dev))

        def run():
            with torch.cuda.device(dev), torch.cuda.stream(stream):
                return fn(*args, **kw)

        return self._execs[d].submit(run)

    def shutdown(self):
        for ex in self._execs:
            ex.shutdown()


def stack_results(results, dev, runner: ShardRunner | None = None
                  ) -> PoolResult:
    """The shards' PoolResults stacked along a leading device axis on
    `dev`.  The caller's current stream on each card first waits for the
    shards' streams of `runner`, and the shards' buffers are marked as in
    use by it."""
    if runner is not None:
        for d, (stream, _copy) in enumerate(runner.streams):
            if stream is not None:
                torch.cuda.current_stream(runner.mesh[d]).wait_stream(stream)
    for res in results:
        for t in res:
            if t is not None and t.is_cuda:
                t.record_stream(torch.cuda.current_stream(t.device))
    return PoolResult(*[
        None if f[0] is None else torch.stack([t.to(dev) for t in f])
        for f in zip(*results)
    ])


def pool_search_sharded(mesh, indexes, prep: dict, params,
                        config: PoolConfig,
                        runner: ShardRunner | None = None) -> PoolResult:
    """K9: the pool search as D concurrent per-shard loops over `mesh`.

    `prep` holds the per-read arrays (CONST_KEYS and either `slut_packed`
    or the DENSE_KEYS, the names of mapad_tpu's `_prepare`) with a leading
    read axis R divisible by the mesh size; `indexes[d]` is the index on
    shard d's device (`sharding.replicate`); `config.lanes` is the
    per-shard lane count; `runner` the shards' threads and streams (an
    engine's, or a new one for this call).  Returns a PoolResult whose
    fields all have a leading device axis (D, ...) on the first shard's
    device; c_read, lane_read and next_read carry global read ids, the "no
    read" sentinel of lane_read is R."""
    D = len(mesh)
    R = prep["n"].shape[0]
    parts = shard_reads(mesh, prep)
    R_local = R // D
    own = runner is None
    if own:
        runner = ShardRunner(mesh)
    try:
        futs = []
        for d in range(D):
            consts, kw = _shard_inputs(parts[d])
            futs.append(runner.submit(d, search_shard, indexes[d], consts,
                                      params, config, d * R_local, R, **kw))
        results = [f.result() for f in futs]
    finally:
        if own:
            runner.shutdown()
    return stack_results(results, canonical(mesh[0]), runner)


def pool_search_sharded_plain(mesh, indexes, prep: dict, params,
                              config: PoolConfig) -> PoolResult:
    """Plain PyTorch K9: the shards' plain pool loops (and plain Bi-D for
    dense inputs) one after another on their tensors' devices, re-based and
    stacked as `pool_search_sharded` does."""
    D = len(mesh)
    R = prep["n"].shape[0]
    parts = shard_reads(mesh, prep)
    R_local = R // D
    results = []
    for d in range(D):
        consts, kw = _shard_inputs(parts[d])
        results.append(search_shard(indexes[d], consts, params, config,
                                    d * R_local, R, plain=True, **kw))
    return stack_results(results, canonical(mesh[0]))


def collect_sharded(engine, chunk, result: PoolResult, out, t0):
    """Host-side collection of a sharded PoolResult over reads in shard
    order (not dealt): shard d owns reads [d*R_local, (d+1)*R_local) and
    collects through the engine's single-shard decoder.  Returns the set of
    escalated global read indexes."""
    import time

    result = PoolResult(*[None if t is None else t.cpu().numpy()
                          for t in result])
    D = result.c_read.shape[0]
    R_local = (len(chunk) + D - 1) // D
    elapsed = time.perf_counter() - t0
    escalated = set()
    for d in range(D):
        lo = d * R_local
        hi = min(lo + R_local, len(chunk))
        sub = chunk[lo:hi]
        shard_res = _local_view(result, d, lo, len(chunk), len(sub))
        sub_out = [None] * len(sub)
        esc = engine._decode_pool(sub, shard_res, sub_out, elapsed, None)
        out[lo:hi] = sub_out
        escalated.update(lo + i for i in esc)
    return escalated


def _local_view(result: PoolResult, d: int, lo: int, r_global: int,
                n_sub: int) -> PoolResult:
    """Shard d's numpy slice of a stacked result with its ids made local
    again (the collector decodes one shard as one invocation over `n_sub`
    reads)."""
    res = PoolResult(*[None if x is None else x[d] for x in result])
    return res._replace(
        c_read=np.where(res.c_read >= 0, res.c_read - lo, -1),
        lane_read=np.where(res.lane_read < r_global, res.lane_read - lo,
                           n_sub),
        next_read=min(max(int(res.next_read) - lo, 0), n_sub),
    )
