#!/usr/bin/env python3
"""Smoke run of mapad_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --path7   # path 7 alone (a machine of several cards)
    python3 chip_smoke.py --probes  # the probe phase alone (P1-P4)

Builds the port's CUDA kernels from csrc/ (one nvcc per source, all at
once), holds every kernel bit for bit against its plain PyTorch version on
the card at its path's shapes, then drives ten paths (paths 1-6, 9 and 10
on one card, MAPAD_SHARD=0, whatever the machine has):

  path 1 (small genome, int32): generate a 4 Mbp repeat-rich genome and
  16,384 aDNA-damaged reads from a seed (bench.py's generators, copied) ->
  `index` -> `map --engine device` through the CLI (two 8192-read blocks
  through the streaming driver; kernels K4, K2 with K1 inline, K3, K5);

  path 2 (big-genome mode forced, int64): a second, larger genome with its
  own reads -> `index` -> `pipeline.run` with
  `DeviceSearchEngine(fmd, params, big=True, packed_hits=True)` at the
  big-mode defaults (Bi-D on the card, 4096-read blocks, deep tier on, full
  width; kernels K6, K7 and the int64 forms of K1, K2, K3, K5).

  path 3 (the default engine): `map` with no `--engine` on path 1's
  workload: the hybrid engine, the device stream on the head of each block
  and the host C++ searcher on its tail (timed once more with two native
  threads);

  path 4 (store generations, kernel K8): `map --engine device` on path 1's
  workload with MAPAD_KGENS=4 and MAPAD_KGENS_MIN_LIVE=1; then one 4096-read
  block of path 2's workload in big mode with the deep tier narrowed
  (MAPAD_DEEP_LANES=128: 32,768 steps, cap 12,288, 4 generations;
  MAPAD_RETRY_MIN=32 so that one block's escalatees fill a deep block), once
  more with the batched no-hit probe (MAPAD_NOHIT_PROBE=1), and once with
  store generations on a primary config starved to 4,096 steps;

  path 5 (the bidirectional search): 2,048 reads of path 1's workload under
  a center-start model (VindijaPwm) through `DeviceSearchEngine`, with
  int32 and with int64 intervals;

  path 6 (the fixed-batch engine, kernel K10): path 1's workload through
  `DeviceSearchEngine(fmd, params, mode="batch")` at its defaults (2,048
  lanes, one tier of 2,048 steps, M=128, H=24: eight batches, each the
  dense upload, K7 in int32 and K10, escalatees to the host searcher),
  then once more with two tiers ((512, None), (2048, 512)), both set
  beside the pool engine's `search_chunk` on the same reads;

  path 7 (the pool search over several shards, kernel K9): path 1's
  workload through `pipeline.run` with `DeviceSearchEngine(fmd, params,
  mesh=[cuda:0, cuda:0])` and MAPAD_SHARD=1: one 16,384-read block dealt
  into two shards of 8,192, each at path 1's per-invocation shape on its
  own host thread and streams (K4, K2 + K3, K5 making the shard's read
  ids global as it packs: no `shard_rebase` launch), beside
  the same `pipeline.run` unsharded; on a machine with more than one card
  once more over all of them with no `mesh` (the automatic mesh);

  path 8 (multi-host mapping on one machine): two processes, gloo on
  localhost, each `run_multihost` with a `DeviceSearchEngine` on cuda:0
  over path 1's reads in 8,192-read chunks (one chunk each); process 0
  merges the BAM shards, which equal `map --engine native --batch_size
  8192`'s BAM;

  path 9 (distributed mode): `map --dispatcher --batch_size 8192` in a
  subprocess on path 1's workload with two workers on cuda:0, the CLI's
  `worker` in a subprocess and a `Worker` on a thread of this process (its
  launches counted: K4, K2 with K1 inline, K3, K5), one chunk each; the
  BAM equals `map --seed 0 --engine native --batch_size 8192`'s (the
  dispatcher's position seed is 0) in read-name order;

  path 10 (CRAM input, the mapAD-native index): path 1's reads as a CRAM
  3.1 (rANS-Nx16, arith, fqzcomp and tok3 blocks) and path 1's genome
  indexed by `index --mapad_format` with its bundle removed, so that
  `load_index` reads mapAD's own files; `map --engine device` at the
  defaults, its BAM equal to `map --engine native`'s on the same CRAM and
  index (the CRAM decode timed on its own line: pure Python on the host).

Before the paths, K8 runs against its plain version at full width with a
step budget just above the per-read cap, so that the check's reads force
store boundaries whose moved window overlaps itself (uncapped and capped
spill, both interval widths), and at a shape where it does not, as on the
main path; the K8 launches of every run are counted and held against the
boundaries it fired.  Then the bidirectional K2 against its plain version,
and before path 6 K10 against its plain version at full width (the first
2,048 reads, S=2048, H=24; and 512 reads under the center-start model,
both directions; each with its launch plan, its longest lane's steps and
its us a step) and the int32 K7 at R=2048, M=128 (each K7 run with the
walk steps its data needs, both parts where the forward part is on, its
launch plan with the resident warps an SM, and the -Xptxas -v figures of
both forms of its kernel).  After path 1's
kernels, K9 (`pool_search_sharded`) runs on the shard threads and streams
of a two-shard engine on the one card (path 7's): two shards of 512 reads
of path 1's workload against its plain version, and path 7's block (two
shards of 8,192) against its shards run unsharded, each timed beside the
same shards run one after the other (its `shard_rebase` launches counted
in the first call at path 7's block: one a shard); then `shard_rebase`
alone against its plain version, timed three ways as K3-K6 are.

K3 (one cooperative launch a call, both widths), K4, K5 and K6 are timed
three ways: by CUDA events around calls back to back, on the host alone,
and, after path 8, by the profiler's card time.  K5 is held against its
plain version through both its entries, on K3's one allocation (as the
engine's path calls it, and as it is timed; and with a shard's id rebase,
as the mesh path calls it, timed too) and on the PoolResult; K4 and
K5 rows carry their launch plans.  K3's rows also carry the walk's
floor, the deepest walked chain's op words times the card's dependent-load
latency (measured at the start: `tools/dma.py` `load_latency_ns`, one
thread through 256 MB with the L2 flushed), and its plan and ptxas
figures.  The launch counts of paths 1-4 and 7 hold K3 at one launch a
call: one an invocation and one a store boundary.

Last, the probe phase: the ports of the TPU round's DMA probes (P1-P4,
mapad_tpu_torch/tools/; on no mapping path).  P1 (`probe_dma`) is held
against its plain version at the TPU probe's defaults (L=1024, W=128,
T=200, a 512 MiB table of 2^20 rows) and over T=512 steps (acc passes
2^24), P2-P4 (`copy_src_slice`, `copy_dst_slice`) at their shapes against
their plain versions and torch slicing, each timed in turns with
`x[sl].clone()` or `out[sl] = inp + 1` (medians of five rounds by CUDA
events and by the profiler's device time, beside a kernel that does
nothing);
then the counted run of the tools: P1 timed a step in three forms (one
launch, one launch a step, plain PyTorch on the card) against path 1's
index rows (in L2), path 2's and 2^20 rows, P2's shapes, P3, P4's copies
and its PTX/SASS dump.

Paths 1 and 2 map their reads again with `map --engine native` (the exact
host C++ search); the BAMs of paths 1, 3, 4 and 7 equal path 1's native
BAM (path 8's the native BAM of its chunks, path 9's that of its chunks
with seed 0, path 10's the native engine's on its own CRAM and index) and
path 2's its own, record for record except XD (a timing); the
blocks of paths 4, 5 and 6 equal the native engine's hits.  The launch counts are
set to 0 just before each path is driven and read just after.

Prints the card's name and power limit, each kernel's time beside its plain
version's and its bound, reads/s, stage seconds, escalations by cause, the
tier counters and the kernel launch counts of each path; then, on a line of
its own, one JSON object with the kernel table, and as the last line
{"ok": true, "device": {...}}.  Any failed check exits non-zero.
Work files go to .smoke/ (ignored by git).
"""

from __future__ import annotations

import json
import logging
import os
import shutil
import subprocess
import sys
import threading
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(ROOT, ".smoke")
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate (NVIDIA data sheet)
GENOME_SIZE = 4_000_000
N_READS = 16_384
CHECK_READS = 1024
# path 2: big-genome mode forced on the largest genome whose index build
# fits the run (a text that needs int64 by itself, 2^31 symbols, does not)
GENOME2_SIZE = 64_000_000
BLOCK2_READS = 4096  # big mode's invocation size
CHECK2_READS = 512
# the K8 check: S = CAP + this, so 1,024 reads (about 3,400 steps in one
# generation) force two store boundaries or more; and its capped spill
K8_MARGIN = 128
K8_SPILL = 64
# and a (CAP, S) whose window does not overlap itself when it moves
K8_FLAT_CAP = 256
K8_FLAT_READS = 2048
K8_READS = 1024
BIDIR_READS = 512   # the bidirectional K2 check
PATH5_READS = 2048
# the K10 checks: one full batch of the engine's defaults, and the
# center-start model (both directions) on fewer lanes
BATCH_CHECK_READS = 2048
BATCH_CENTER_READS = 512
PATH6_TIERS = ((512, None), (2048, 512))
PATH4_BIG_STEPS = 4096  # path 4, last run: a primary store of 4,096 steps
# path 4: the narrow deep config (lanes, steps, per-read cap, generations)
DEEP_LANES = 128
DEEP_SHAPE = (128, 32768, 12288, 4)
# one block escalates about 100 reads with hits: fewer than the least size
# of a tier block (a quarter of the lanes), so that is lowered for path 4
DEEP_MIN = "32"
# the K9 check: two shards of 512 reads on the one card
K9_SHARDS = 2
K9_READS = 512
# path 8: two processes, one 8,192-read chunk each; a hung rendezvous or
# a failed process fails the smoke within this many seconds
PATH8_CHUNK = 8192
PATH8_TIMEOUT = 300
# path 9: the dispatcher's chunks (two, one a worker) and the time within
# which every process and the worker's thread must have ended
PATH9_TIMEOUT = 300
# path 10: the CRAM's records a container (four containers)
CRAM_CHUNK = 4096
# the probe phase: P1 at the TPU probe's defaults (W, L, T, and NB = 2^20,
# a 512 MiB table), checked once more over T = 512 steps (acc passes 2^24)
PROBE_W, PROBE_L, PROBE_T, PROBE_T_LONG = 128, 1024, 200, 512
PROBE_NB = 1 << 20
COPY_ROUNDS = 5  # the copies and their PyTorch calls, timed in turns


def index_rows(genome_size: int, k: int) -> int:
    """Fused index rows of a genome (`DeviceFmIndex.from_host`: the doubled
    text, two sentinels, k symbols a row)."""
    return -(-(2 * genome_size + 2) // k)


# P1 is timed against three tables: path 1's index rows (in the 50 MB
# L2), path 2's (above it) and the TPU probe's 2^20 rows
PROBE_TABLES = (("path 1's index rows", index_rows(GENOME_SIZE, 976)),
                ("path 2's index rows", index_rows(GENOME2_SIZE, 928)),
                ("the TPU probe's 2^20 rows", PROBE_NB))

MAP_FLAGS = ["-p", "0.03", "-l", "single_stranded", "-f", "0.6", "-t",
             "0.55", "-d", "0.01", "-s", "1.0", "-i", "0.001"]


def log(*a):
    print(*a, flush=True)


# --- bench workload (copied from bench.py: gen_genome, make_reads) ------


def gen_genome(size, np, seed=42):
    """Deterministic genome with repeat structure: ~20% of it is segments
    duplicated from elsewhere with ~1% divergence."""
    rng = np.random.default_rng(seed)
    acgt = np.frombuffer(b"ACGT", dtype=np.uint8)
    out = acgt[rng.integers(0, 4, size=size, dtype=np.uint8)]
    rep = np.random.default_rng(seed + 1)
    placed = 0
    while placed < int(size * 0.2):
        seg = int(10 ** rep.uniform(3.0, min(5.0, np.log10(size / 4))))
        src = int(rep.integers(0, size - seg))
        dst = int(rep.integers(0, size - seg))
        chunk = out[src : src + seg].copy()
        n_mut = rep.binomial(seg, 0.01)
        if n_mut:
            pos = rep.integers(0, seg, size=n_mut)
            chunk[pos] = acgt[rep.integers(0, 4, size=n_mut)]
        out[dst : dst + seg] = chunk
        placed += seg
    return out


def make_reads(genome, n_reads, np, seed=7):
    """Lognormal fragment lengths (35..120 bp), C->T deamination decaying
    from both ends, sequencing errors, per-base qualities, ~8% exogenous
    reads.  Returns [(sequence, qualities)]."""
    from mapad_tpu_torch.utils.seq import revcomp

    rng = np.random.default_rng(seed)
    starts = rng.integers(0, len(genome) - 128, size=n_reads)
    acgt = b"ACGT"
    reads = []
    for i in range(n_reads):
        ln = int(np.clip(rng.lognormal(np.log(60), 0.25), 35, 120))
        if rng.random() < 0.08:
            seq = bytearray(acgt[c] for c in rng.integers(0, 4, size=ln))
        else:
            seq = bytearray(genome[starts[i] : starts[i] + ln].tobytes())
            for pos in range(ln):
                p = 0.4 * (0.55 ** pos) + 0.4 * (0.55 ** (ln - 1 - pos)) + 0.005
                if seq[pos] == ord("C") and rng.random() < p:
                    seq[pos] = ord("T")
                elif rng.random() < 0.002:
                    seq[pos] = acgt[int(rng.integers(0, 4))]
            if rng.random() < 0.5:
                seq = bytearray(revcomp(seq))
        quals = bytes(int(q) for q in np.clip(
            rng.normal(36, 4, size=ln), 10, 41).astype(np.uint8))
        reads.append((bytes(seq), quals))
    return reads


# --- measurement helpers --------------------------------------------------


def timed(torch, fn, reps):
    """Mean ms of fn() over reps launches, CUDA events around the run."""
    from mapad_tpu_torch.tools import cuda_ms

    return cuda_ms(fn, reps)


def compare(torch, got, want, what):
    """Bit-exact check of two tensor tuples; returns the max abs error."""
    err = 0.0
    for k, (g, w) in enumerate(zip(got, want)):
        g, w = g.contiguous(), w.contiguous()
        if g.shape != w.shape or g.dtype != w.dtype:
            raise AssertionError(f"{what}[{k}]: {g.shape}/{g.dtype} vs "
                                 f"{w.shape}/{w.dtype}")
        gi = g.view(torch.int32) if g.dtype == torch.float32 else g
        wi = w.view(torch.int32) if w.dtype == torch.float32 else w
        if not torch.equal(gi, wi):
            bad = int((gi != wi).sum())
            raise AssertionError(f"{what}[{k}]: {bad} elements differ")
        d = (g.double() - w.double()).abs()
        d = d[torch.isfinite(d)]
        if d.numel():
            err = max(err, float(d.max()))
    return err


class _StatsTap(logging.Handler):
    """Keeps the engine stats the streaming driver logs at the end of a
    device map."""

    stats = None

    def emit(self, record):
        if hasattr(record, "search_stats"):
            self.stats = record.search_stats


def median(values):
    v = sorted(values)
    return (v[(len(v) - 1) // 2] + v[len(v) // 2]) / 2


def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def bound_ms(n_bytes):
    return n_bytes / HBM_BYTES_PER_S * 1e3


def bam_records(path):
    from mapad_tpu_torch.io.bam import BamReader

    with open(path, "rb") as f:
        reader = BamReader(f)
        header = [
            "\t".join(x for x in line.split("\t") if not x.startswith("CL:"))
            for line in reader.header_text.splitlines()
        ]
        recs = [
            (r.name, r.flags, r.ref_id, r.pos, r.mapq, r.cigar_string(),
             r.sequence, r.quals,
             [(bytes(t), tc, v) for t, tc, v in r.tags if bytes(t) != b"XD"])
            for r in reader
        ]
    return header, recs


# --- phases ---------------------------------------------------------------


def k1_check(torch, fm, idx_d, name, what, replaces="mapad_tpu/ops/fm.py:195"):
    """K1 alone: 2 x 512 rank queries over `idx_d`, kernel against plain.
    Returns the kernel-table row (launches filled later)."""
    dev = idx_d.rows.device
    idt = idx_d.idx_dtype
    g = torch.Generator(device="cpu").manual_seed(1)
    n = idx_d.text_len
    lower = torch.randint(0, n, (512,), generator=g, dtype=idt)
    size = torch.randint(0, 64, (512,), generator=g, dtype=idt)
    size = torch.minimum(size, n - lower)
    lower[:8] = 0
    size[:4] = n
    lrev = torch.randint(0, n, (512,), generator=g, dtype=idt)
    lower, size, lrev = lower.to(dev), size.to(dev), lrev.to(dev)
    out = fm.extend_batch(idx_d, lower, lrev, size)
    err = compare(torch, out, fm.extend_batch_plain(idx_d, lower, lrev, size),
                  what)
    row = dict(
        route="cuda", source="mapad_tpu_torch/csrc/common.cuh",
        replaces=replaces, max_abs_err=err,
        ms=timed(torch, lambda: fm.extend_batch(idx_d, lower, lrev, size),
                 50),
        plain_ms=timed(torch, lambda: fm.extend_batch_plain(
            idx_d, lower, lrev, size), 10),
        bound_ms=bound_ms(1024 * 512 + nbytes(lower, lrev, size, *out)),
        bound_by="bytes", library_ms=None,
    )
    log(f"K1 {what}: bit-exact on 512 intervals (lowest child lower bound "
        f"{int(out[0].min())}), {row['ms']:.4f} ms (plain "
        f"{row['plain_ms']:.4f} ms)")
    return row


def pool_check(torch, sp2, eng, idx_d, consts, slut, params, cfg, M, big):
    """K2 + K3 + K5 at full width on a subset of reads, kernels against
    plain.  Returns the three kernel-table rows."""
    sfx = "_i64" if big else ""
    r = consts[0].shape[0]
    args = (idx_d, *consts, params, cfg, slut)
    state, k2_ms = k2_timed(torch, sp2, args)
    res = sp2._extract_chains_cuda(*state, cfg)
    k3 = k3_numbers(torch, sp2, state, cfg, res, big)
    k3_ms = k3["ms"]
    torch.cuda.synchronize()
    t = time.perf_counter()
    pstate = sp2._pool_loop_plain(*args)
    torch.cuda.synchronize()
    k2_plain_ms = (time.perf_counter() - t) * 1e3
    t = time.perf_counter()
    pres = sp2._extract_chains_plain(*pstate, cfg)
    torch.cuda.synchronize()
    k3_plain_ms = (time.perf_counter() - t) * 1e3
    err = compare(torch, tuple(res), tuple(pres), "pool_search+extract" + sfx)
    steps = int(res.steps)
    L = cfg.lanes
    k2_bytes = pool_search_bytes(idx_d, consts, slut, cfg, steps, big)
    k3_bytes = extract_bytes(torch, cfg, res, big)
    rows = {}
    rows["pool_search" + sfx] = dict(
        route="cuda", source="mapad_tpu_torch/csrc/pool_search.cu",
        replaces="mapad_tpu/ops/search_pool2.py:81", max_abs_err=err,
        ms=k2_ms, plain_ms=k2_plain_ms, bound_ms=bound_ms(k2_bytes),
        bound_by="bytes", library_ms=None,
        **k2_numbers(sp2, idx_d, cfg, steps, k2_ms, big),
    )
    rows["extract_chains" + sfx] = dict(
        route="cuda", source="mapad_tpu_torch/csrc/extract_chains.cu",
        replaces="mapad_tpu/ops/search_pool2.py:617", max_abs_err=err,
        plain_ms=k3_plain_ms, bound_ms=bound_ms(k3_bytes),
        bound_by="bytes", library_ms=None, **k3,
    )
    CARD_LATER.append((f"K3 extract_chains{sfx}", rows["extract_chains" + sfx],
                       lambda: sp2._extract_chains_cuda(*state, cfg)))
    log(f"K2+K3{sfx} L={L} S={cfg.total_steps} CAP={cfg.read_step_cap} "
        f"C={cfg.max_chains} M={M} on {r} reads: bit-exact; {steps} steps, "
        f"{int(res.n_chains)} chains; K2 {k2_ms:.2f} ms "
        f"({k2_ms * 1e3 / max(steps, 1):.3f} us/step; bound "
        f"{bound_ms(k2_bytes) * 1e3 / max(steps, 1):.3f} us/step; plan "
        f"{rows['pool_search' + sfx]['plan']}), plain {k2_plain_ms:.1f} ms; "
        f"K3 {k3_ms:.4f} ms by events (host {k3['host_ms']:.4f} ms, "
        f"{k3['launches_per_call']} launch a "
        f"call; walk floor {k3['walk_floor_ms']:.4f} ms: the deepest chain's "
        f"{k3['deepest_chain']} words x {LOAD_NS['DRAM']:.1f} ns; bytes "
        f"bound {bound_ms(k3_bytes):.5f} ms; plan {k3['plan']}), plain "
        f"{k3_plain_ms:.1f} ms")

    # K5 on that result: through the engine's entry on K3's one allocation
    # (as `_run_block` calls it) and through the PoolResult entry
    name = "pack_result" + sfx
    want = eng._pack_result_plain(res)
    buf = sp2._extract_chains_cuda(*state, cfg, views=False)
    err = compare(torch, (eng._pack_buffer(buf, cfg, r, big),), (want,),
                  name + " (K3's allocation)")
    err = max(err, compare(torch, (eng._pack_result(res),), (want,),
                           name + " (PoolResult)"))
    # and as a shard's (shard 1 of two of r reads), its ids made global
    from mapad_tpu_torch.parallel.pool_sharded import _shard_rebase_plain

    rebase = (r, r, 2 * r)
    err = max(err, compare(
        torch, (eng._pack_buffer(buf, cfg, r, big, rebase),),
        (eng._pack_result_plain(_shard_rebase_plain(
            sp2._extract_chains_cuda(*state, cfg), *rebase)),),
        name + " (K3's allocation, a shard's rebase)"))

    def k5():
        return eng._pack_buffer(buf, cfg, r, big)

    def k5_rebase():
        return eng._pack_buffer(buf, cfg, r, big, rebase)

    ms, host, per_call = split_ms(torch, k5, 20, name)
    if per_call != 1:
        raise AssertionError(f"{name}: {per_call} launches a call")
    rows[name] = row = dict(
        route="cuda", source="mapad_tpu_torch/csrc/pack_result.cu",
        replaces="mapad_tpu/ops/engine.py:1591", max_abs_err=err,
        ms=ms, plain_ms=timed(torch, lambda: eng._pack_result_plain(res), 5),
        bound_ms=bound_ms(nbytes(*res, want)), bound_by="bytes",
        library_ms=None, host_ms=host, launches_per_call=per_call,
        result_entry_ms=timed(torch, lambda: eng._pack_result(res), 20),
        plan=dict(eng.pack_plan(cfg.max_chains, cfg.max_len + 16, cfg.lanes,
                                r, big)._asdict()),
    )
    CARD_LATER.append((f"K5 {name}", row, k5))
    ms, host, per_call = split_ms(torch, k5_rebase, 20, name)
    row["rebase"] = dict(ms=ms, host_ms=host, bound_ms=row["bound_ms"])
    CARD_LATER.append((f"K5 {name} with a shard's rebase", row["rebase"],
                       k5_rebase))
    log(f"K5 {name} C={cfg.max_chains}: bit-exact through both entries "
        f"and with a shard's rebase, {row['ms']:.4f} ms by events on K3's "
        f"allocation (host {row['host_ms']:.4f} ms, one launch a call; with "
        f"the rebase {row['rebase']['ms']:.4f}, host "
        f"{row['rebase']['host_ms']:.4f}; the PoolResult entry "
        f"{row['result_entry_ms']:.4f} ms; bound {row['bound_ms']:.5f} ms; "
        f"plan {row['plan']}), plain {row['plain_ms']:.4f} ms")
    return rows


def pool_search_bytes(idx_d, consts, slut, cfg, steps, big):
    """Bytes K2 must move across HBM for `steps` steps: it reads the index
    rows, the LUT/Bi-D rows and the consts once, and writes the frame store
    blocks (9 frames of 8 words, 11 with int64 intervals), masks and finish
    log of its steps.  The key rings stay on chip (K2's plan keeps them in
    shared memory at every shape the paths run)."""
    frame_words = 11 if big else 8
    return (nbytes(idx_d.rows, *consts, slut)
            + steps * cfg.lanes * (9 * frame_words + 1 + 1) * 4)


def k2_timed(torch, sp2, args):
    """K2 at a check's shape: a first run (the library loaded, the
    allocator primed), then the timed run -> (its loop state, ms by the
    host clock around one synchronized call)."""
    sp2._pool_loop_cuda(*args)
    torch.cuda.synchronize()
    t = time.perf_counter()
    state = sp2._pool_loop_cuda(*args)
    torch.cuda.synchronize()
    return state, (time.perf_counter() - t) * 1e3


def k2_numbers(sp2, idx_d, cfg, steps, ms, big):
    """A K2 row's extra keys: the check's steps, us a step, the launch plan
    of its shape and the ptxas figures of its kernel form (`floor_ms`,
    P1's one-launch us a step at the same index table times these steps,
    is added after the probe phase)."""
    RB = min(cfg.total_steps, cfg.read_step_cap + 1)
    bidir = not cfg.backward_only
    plan = sp2.card_plan(idx_d.rows.device, cfg.lanes, RB, big, bidir)
    return dict(check_steps=steps, us_step=ms * 1e3 / max(steps, 1),
                plan=dict(lanes_per_block=plan.lanes_per_block,
                          blocks=plan.blocks,
                          ring="shared" if plan.ring_shared else "global",
                          smem=plan.smem),
                ptxas=PTXAS.get(k2_form(big, bidir)))


# ptxas figures of each K2 form, from the build's -Xptxas -v output
PTXAS: dict = {}


def k2_form(big, bidir):
    return (f"{'int64' if big else 'int32'} "
            f"{'bidirectional' if bidir else 'backward'}")


def ptxas_entries(text):
    """[(kernel, its ptxas figures)] of one library's nvcc -Xptxas -v
    output: registers, shared memory, stack and spills."""
    out, entry, frame = [], None, ""
    for line in text.splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1]
        elif "spill" in line:
            frame = line.strip()
        elif "Used" in line and "registers" in line and entry:
            out.append((entry, line.split(":", 1)[1].strip() + "; " + frame))
            entry, frame = None, ""
    return out


def k2_forms(logs):
    """The ptxas figures of the four forms of K2's kernel, by form."""
    forms = {}
    for entry, figs in ptxas_entries(logs.get("pool_search", "")):
        if "pool_search_kernel" not in entry:
            continue
        big = "pool_search_kernelIl" in entry
        bidir = "Lb1E" in entry
        forms[k2_form(big, bidir)] = figs
    return forms


def k7_forms(logs):
    """The ptxas figures of K7's kernel in both interval widths."""
    return {f"K7 {'int64' if 'bi_d_kernelIl' in entry else 'int32'}": figs
            for entry, figs in ptxas_entries(logs.get("bi_d", ""))
            if "bi_d_kernel" in entry}


def k7_plan(bi_d, dev, rank, fwd, big):
    """K7's launch plan at this input, as a dict with the resident warps an
    SM (the occupancy query at the plan's block shape)."""
    plan = bi_d.bid_card_plan(dev, rank.shape[1], 2 if fwd else 1, big)
    return dict(plan._asdict(), resident_warps=plan.resident_warps)


def k3_forms(logs):
    """The ptxas figures of both forms of K3's kernel, by form."""
    return {f"K3 {'int64' if 'extract_kernelIl' in entry else 'int32'}":
            figs for entry, figs in ptxas_entries(
                logs.get("extract_chains", ""))
            if "extract_kernel" in entry}


def k10_form(logs):
    """The ptxas figures of K10's kernel, under "K10"."""
    return {"K10": figs for entry, figs in ptxas_entries(
        logs.get("search_batch", "")) if "search_batch_kernel" in entry}


def check_k2_launches(launches, what, boundaries=0, sfx="", name=None):
    """K2 counts 1 init + 1 a store generation, and K1 one inline launch a
    K2 generation (K7's inline K1 aside): so K2 = 2 x K1 - boundaries.
    Where the run counts K3, one launch a call: a call an invocation and
    one a store boundary."""
    k2 = launches[name or "pool_search" + sfx]
    k1 = launches["extend_batch" + sfx] - launches.get("bi_d" + sfx, 0)
    log(f"  K2 launches {k2}: {k2 - k1} invocations (init) + {k1} "
        f"generations ({boundaries} store boundaries)")
    if k1 < 1 or k2 != 2 * k1 - boundaries:
        raise AssertionError(f"{what}: K2 {k2} launches, K1 in K2 {k1}, "
                             f"{boundaries} boundaries")
    k3 = launches.get("extract_chains" + sfx)
    if k3 is None or name is not None:
        return
    log(f"  K3 launches {k3}: one a call, {k2 - k1} invocations + "
        f"{boundaries} store boundaries")
    if k3 != k2 - k1 + boundaries:
        raise AssertionError(f"{what}: K3 {k3} launches for {k2 - k1} "
                             f"invocations and {boundaries} boundaries")


def extract_bytes(torch, cfg, res, big):
    """Bytes K3 must move for one invocation's result: it reads the masks,
    finish log and the frame records it walks, and writes the
    PoolResult."""
    n_ext = min(int(res.n_chains), cfg.max_chains)
    walked = int((res.c_ops[:n_ext] != 0).sum())
    return (int(res.steps) * cfg.lanes * 8
            + walked * (11 if big else 8) * 4 + nbytes(*res))


# the card's dependent-load latency, ns (`dma.load_latency_ns`, measured
# once at the start): through 256 MB with the L2 flushed ("DRAM")
LOAD_NS: dict = {}


# (kernel, its row, a call): the rows whose card time the profiler takes
# after the paths, so that no profiler session comes before a path's timing
CARD_LATER: list = []


def split_ms(torch, fn, reps, name):
    """A kernel's time split: (ms a call by CUDA events around `reps`
    calls back to back, on the host alone; the launches of `name` one call
    makes).  The card time comes later (`CARD_LATER`)."""
    from mapad_tpu_torch import tools
    from mapad_tpu_torch._build import LAUNCHES

    ms = timed(torch, fn, reps)
    host = tools.host_us(fn, reps) / 1e3
    torch.cuda.synchronize()
    before = LAUNCHES.get(name)
    fn()
    torch.cuda.synchronize()
    return ms, host, LAUNCHES.get(name) - before


def card_times(torch):
    """The profiler's card time a call of each row of `CARD_LATER`."""
    from mapad_tpu_torch import tools

    for name, row, fn in CARD_LATER:
        row["device_ms"] = dev = tools.device_ms(fn, 20)
        log(f"{name}: card "
            + ("not measured (the profiler saw no device time)"
               if dev is None else f"{dev:.4f} ms a call (profiler)")
            + f", {row['ms']:.4f} by events, host {row['host_ms']:.4f}; "
            f"bound {row['bound_ms']:.5f}"
            + (f", walk floor {row['walk_floor_ms']:.4f}"
               if "walk_floor_ms" in row else ""))
    CARD_LATER.clear()


def k3_numbers(torch, sp2, state, cfg, res, big):
    """A K3 row's time by events and on the host (its card time comes
    after the paths), its launches a call, the deepest walked chain (its
    non-zero op words) and the walk's floor (those words x the
    dependent-load latency), its launch plan and ptxas figures."""
    name = "extract_chains" + ("_i64" if big else "")
    ms, host, per_call = split_ms(
        torch, lambda: sp2._extract_chains_cuda(*state, cfg), 20, name)
    n_ext = min(int(res.n_chains), cfg.max_chains)
    depth = int((res.c_ops[:n_ext] != 0).sum(1).max()) if n_ext else 0
    plan = sp2.extract_card_plan(res.c_ops.device, cfg.lanes,
                                 cfg.max_chains, cfg.max_len + 16, big)
    if per_call != 1:
        raise AssertionError(f"{name}: {per_call} launches a call")
    return dict(ms=ms, host_ms=host, launches_per_call=per_call,
                deepest_chain=depth,
                walk_floor_ms=depth * LOAD_NS["DRAM"] / 1e6,
                load_ns=LOAD_NS["DRAM"], plan=dict(plan._asdict()),
                ptxas=PTXAS.get(f"K3 {'int64' if big else 'int32'}"))


def compact_bytes(cfg, big):
    """Bytes one K8 boundary must move: the window of the last CAP steps
    read once and written once, both rings read and written, lane_start."""
    L, CAP = cfg.lanes, cfg.read_step_cap
    RB = min(cfg.total_steps, CAP + 1)
    block = 9 * (11 if big else 8) * 4
    return 2 * L * CAP * block + 4 * L * RB * 4 + 2 * L * 4


def compact_launches(cfg):
    """The `__global__` launches one K8 boundary should make: the window
    moves in chunks of delta = S - CAP blocks, then one launch for rings
    and counters.  The counts taken in the run are held against it."""
    delta = cfg.total_steps - cfg.read_step_cap
    return -(-cfg.read_step_cap // delta) + 1


def launches_per_boundary(launches, cfgs, what):
    """The K8 launches counted over a run, held against what its boundaries
    (`cfgs`: the config of each) should make -> launches of one boundary,
    by config shape."""
    want = sum(compact_launches(c) for c in cfgs)
    if not cfgs or launches != want:
        raise AssertionError(f"{what}: {launches} K8 launches counted over "
                             f"{len(cfgs)} boundaries, {want} expected")
    per = {(c.total_steps, c.read_step_cap): compact_launches(c)
           for c in cfgs}
    return per.popitem()[1] if len(per) == 1 else per


def compact_check(torch, sp2, idx_d, params, cfg, big, main):
    """K8 at full width, with K3 at the boundaries and K2 going on behind
    them, against the plain generations loop.  On the first K8_READS reads
    with a step budget of CAP + K8_MARGIN, so the reads force store
    boundaries and the moved window overlaps itself (many launches a
    boundary), once with an uncapped and once with a capped spill; then on
    K8_FLAT_READS reads with a per-read cap of K8_FLAT_CAP and a store of
    more than twice that, where the window does not overlap itself (one
    launch for it, the branch the main path's shapes take); every
    PoolResult field bit for bit.  `main`: (consts, slut, config) of a
    whole block at a shape of the main path, run on the card alone to time
    a boundary there.  Returns the kernel-table row."""
    from mapad_tpu_torch._build import LAUNCHES

    sfx = "_i64" if big else ""
    k8 = "pool_compact" + sfx
    gens = dict(generations=4, min_live=1)
    m_consts, m_slut, m_cfg = main

    def head(r):
        return (tuple(p[:r].contiguous() for p in m_consts),
                m_slut[: r * cfg.max_len].contiguous())

    tight = cfg._replace(total_steps=cfg.read_step_cap + K8_MARGIN, **gens)
    # the no-overlap shape: a store three quarters of the steps these reads
    # take in one generation (so a boundary fires), at least twice the cap
    flat = cfg._replace(read_step_cap=K8_FLAT_CAP, spill_steps=0)
    f_consts, f_slut = head(K8_FLAT_READS)
    once = int(sp2._extract_chains_cuda(*sp2._pool_loop_cuda(
        idx_d, *f_consts, params, flat, f_slut), flat).steps)
    flat = flat._replace(total_steps=max(2 * K8_FLAT_CAP, once * 3 // 4),
                         generations=2, min_live=1)
    err, ms, plain_s, fired, per = 0.0, [], [], [], []
    for c, (consts, slut) in (
            (tight._replace(spill_steps=0), head(K8_READS)),
            (tight._replace(spill_steps=K8_SPILL), head(K8_READS)),
            (flat, (f_consts, f_slut))):
        args = (idx_d, *consts, params, c, slut)
        ev, plog = [], []
        LAUNCHES.reset()
        state = sp2._pool_loop_cuda(*args, boundary_log=ev)
        counted = LAUNCHES.get(k8)
        res = sp2._extract_chains_cuda(*state, c)
        torch.cuda.synchronize()
        pres = sp2._extract_chains_plain(
            *sp2._pool_loop_plain(*args, boundary_log=plog), c)
        what = (f"{k8} (S={c.total_steps} CAP={c.read_step_cap} spill "
                f"{c.spill_steps})")
        err = max(err, compare(torch, tuple(res), tuple(pres), what))
        if not ev or len(ev) != len(plog):
            raise AssertionError(f"{what}: {len(ev)} boundaries on the card, "
                                 f"{len(plog)} in the plain version"
                                 + (f" ({once} steps in one generation)"
                                    if c is flat else ""))
        per.append(launches_per_boundary(counted, [c] * len(ev), what))
        fired.append(len(ev))
        times = [a.elapsed_time(b) for a, b in ev]
        if c is not flat:
            ms += times
            plain_s += plog
        log(f"K8 {what} L={c.lanes} on {consts[0].shape[0]} reads: "
            f"bit-exact over {len(ev)} boundaries of {per[-1]} launches "
            f"(counted), {int(res.steps)} steps, {int(res.n_chains)} "
            f"chains, {int(res.lane_unfinished.sum())} lanes unfinished; ms "
            f"a boundary {', '.join(f'{x:.4f}' for x in times)}")
    if fired[0] < 2:
        raise AssertionError(f"{k8}: the uncapped run fired {fired[0]} "
                             f"boundaries, fewer than 2")
    row = dict(
        route="cuda", source="mapad_tpu_torch/csrc/pool_compact.cu",
        replaces="mapad_tpu/ops/search_pool2.py:812", max_abs_err=err,
        # medians: the first boundary of a process also loads the library
        ms=median(ms), plain_ms=median(plain_s) * 1e3,
        bound_ms=bound_ms(compact_bytes(tight, big)), bound_by="bytes",
        library_ms=None, boundaries=sum(fired),
        launches_per_boundary=per[0],
    )
    log(f"K8 {k8}: {row['ms']:.4f} ms a boundary at S={tight.total_steps} "
        f"CAP={tight.read_step_cap} (median of {len(ms)}) in "
        f"{row['launches_per_boundary']} launches (plain "
        f"{row['plain_ms']:.1f} ms, bound {row['bound_ms']:.4f} ms)")
    m_cfg = m_cfg._replace(spill_steps=0, **gens)
    ev = []
    LAUNCHES.reset()
    state = sp2._pool_loop_cuda(idx_d, *m_consts, params, m_cfg, m_slut,
                                boundary_log=ev)
    counted = LAUNCHES.get(k8)
    steps = int(sp2._extract_chains_cuda(*state, m_cfg).steps)
    torch.cuda.synchronize()
    if not ev:
        raise AssertionError(f"{k8}: no boundary at "
                             f"S={m_cfg.total_steps}")
    row.update(
        main_shape=f"L={m_cfg.lanes} S={m_cfg.total_steps} "
                   f"CAP={m_cfg.read_step_cap}",
        main_ms=median([a.elapsed_time(b) for a, b in ev]),
        main_bound_ms=bound_ms(compact_bytes(m_cfg, big)),
        main_launches_per_boundary=launches_per_boundary(
            counted, [m_cfg] * len(ev), f"{k8} at S={m_cfg.total_steps}"),
    )
    log(f"K8 {k8} at {row['main_shape']} on "
        f"{m_consts[0].shape[0]} reads (card only): {len(ev)} "
        f"boundaries, {steps} steps, {row['main_ms']:.4f} ms a boundary "
        f"in {row['main_launches_per_boundary']} launches (counted; "
        f"bound {row['main_bound_ms']:.4f} ms)")
    return row


class _BoundaryTap:
    """While it is entered, every K8 call of the engine's pool loop leaves
    its config and its pair of CUDA events in `events` (from the loop's own
    `boundary_log`)."""

    def __init__(self, sp2):
        self.sp2, self.events = sp2, []

    def __enter__(self):
        self.loop = loop = self.sp2._pool_loop_cuda
        self.sp2._pool_loop_cuda = self._run
        return self

    def _run(self, *args):
        ev = []
        out = self.loop(*args, boundary_log=ev)
        self.events += [(args[7], pair) for pair in ev]  # args[7]: config
        return out

    def __exit__(self, *exc):
        self.sp2._pool_loop_cuda = self.loop

    def take(self):
        """The boundaries since the last take."""
        out, self.events[:] = list(self.events), []
        return out


def bidir_check(torch, sp2, engine, reads, big):
    """K2 in its bidirectional form (a center-start model, `engine`'s)
    against its plain version at full width.  Returns the kernel-table
    row."""
    from mapad_tpu_torch.map.record import Record

    sfx = "_i64" if big else ""
    recs = [Record(sequence=s, base_qualities=q)
            for s, q in reads[:BIDIR_READS]]
    cfg, prep, _t0 = engine._prep_block(recs, BIDIR_READS,
                                        engine.pool_config)
    assert not cfg.backward_only and bool(engine.device_index.big) == big
    with torch.cuda.device(engine.device):
        consts, kw = engine._upload(prep)
        slut = kw["slut"] if "slut" in kw else sp2._dense_slut(
            engine.device_index, kw["dense"], consts[0], consts[1], cfg,
            kw["bid_steps"])
    args = (engine.device_index, *consts, engine._params(), cfg, slut)
    state, k2_ms = k2_timed(torch, sp2, args)
    res = sp2._extract_chains_cuda(*state, cfg)
    t = time.perf_counter()
    pstate = sp2._pool_loop_plain(*args)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t) * 1e3
    pres = sp2._extract_chains_plain(*pstate, cfg)
    err = compare(torch, tuple(res), tuple(pres), "pool_search_bidir" + sfx)
    steps = int(res.steps)
    n_ext = min(int(res.n_chains), cfg.max_chains)
    hits = int((~res.c_abandon[:n_ext]).sum())
    if not hits:
        raise AssertionError("the bidirectional check found no hit")
    k2_bytes = pool_search_bytes(engine.device_index, consts, slut, cfg,
                                 steps, big)
    extra = k2_numbers(sp2, engine.device_index, cfg, steps, k2_ms, big)
    log(f"K2 pool_search_bidir{sfx} (VindijaPwm) L={cfg.lanes} "
        f"S={cfg.total_steps} CAP={cfg.read_step_cap} M={cfg.max_len} on "
        f"{BIDIR_READS} reads: bit-exact; {steps} steps, {hits} hits; "
        f"{k2_ms:.2f} ms ({extra['us_step']:.3f} us/step; plan "
        f"{extra['plan']}), plain {plain_ms:.1f} ms")
    return dict(
        route="cuda", source="mapad_tpu_torch/csrc/pool_search.cu",
        replaces="mapad_tpu/ops/search_pool2.py:311", max_abs_err=err,
        ms=k2_ms, plain_ms=plain_ms, bound_ms=bound_ms(k2_bytes),
        bound_by="bytes", library_ms=None, steps=steps, **extra,
    )


def k9_run(torch, engine, recs, plain):
    """K9 (`pool_search_sharded`) on the block `recs` through the sharded
    `engine`'s shard threads and streams (`ShardRunner`) and shard body, as
    path 7 runs it: the block dealt and prepared per shard by the engine,
    uploaded to the shards' card.  Held bit for bit against the same
    shards run one after the other through the unsharded pool search and
    re-based, and with `plain` against its plain version; timed in turns
    with the shards one after the other (do two streams on one card
    overlap?).  -> (K9's numbers, the shards' unsharded results)."""
    from mapad_tpu_torch._build import LAUNCHES
    from mapad_tpu_torch.ops import search_pool2 as sp2
    from mapad_tpu_torch.ops.search_pool import PoolResult
    from mapad_tpu_torch.parallel import pool_sharded as tps

    D, R = engine.n_shards, len(recs)
    r = R // D
    mesh, indexes, params = engine.mesh, engine._mesh_index, engine._params()
    cfg, prep, _t0 = engine._prep_block(recs, R, engine.pool_config)
    ups = []
    for d, part in enumerate(prep["shards"]):
        with torch.cuda.device(mesh[d]):
            ups.append(engine._upload(part, mesh[d]))
    p = {k: torch.cat([consts[i] for consts, _ in ups])
         for i, k in enumerate(tps.CONST_KEYS)}
    p["slut_packed"] = torch.cat([kw["slut"] for _, kw in ups])
    parts = tps.shard_reads(mesh, p)

    def wall_ms(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t) * 1e3

    def k9():
        return tps.pool_search_sharded(mesh, indexes, p, params, cfg,
                                       runner=engine._shards)

    def one_after_the_other():
        return [sp2.k_mismatch_search_pool2(
            indexes[d], *[parts[d][k] for k in tps.CONST_KEYS], params, cfg,
            slut=parts[d]["slut_packed"]) for d in range(D)]

    def fields(res):
        return tuple(t for t in res if t is not None)

    LAUNCHES.reset()
    res, first_ms = wall_ms(k9)
    rebases = LAUNCHES.get("shard_rebase")
    if rebases != D:
        raise AssertionError(f"K9: {rebases} shard_rebase launches for {D} "
                             "shards")
    err, plain_ms = 0.0, None
    if plain:
        pres, plain_ms = wall_ms(lambda: tps.pool_search_sharded_plain(
            mesh, indexes, p, params, cfg))
        err = compare(torch, fields(res), fields(pres),
                      "pool_search_sharded")
    times = {"k9": [], "seq": []}
    for which in ("seq", "k9", "k9", "seq", "seq", "k9"):
        out, ms = wall_ms(k9 if which == "k9" else one_after_the_other)
        times[which].append(ms)
        if which == "seq":
            seq = out
    for d in range(D):
        want = tps._shard_rebase_plain(
            PoolResult(*[None if t is None else t.clone() for t in seq[d]]),
            d * r, r, R)
        err = max(err, compare(
            torch, fields(PoolResult(*[None if t is None else t[d]
                                       for t in res])),
            fields(want), f"K9 shard {d} against its unsharded run"))
    steps = [int(x) for x in res.steps]
    C, L = cfg.max_chains, cfg.lanes
    k9_bytes = D * ((C + L) * 4 * 2 + 8) + sum(
        pool_search_bytes(indexes[d], [parts[d][k] for k in tps.CONST_KEYS],
                          parts[d]["slut_packed"], cfg, steps[d], False)
        + extract_bytes(torch, cfg, seq[d], False)
        for d in range(D))
    k9_ms, seq_ms = median(times["k9"]), median(times["seq"])
    log(f"K9 pool_search_sharded {D} shards x {r} reads on one card through "
        f"a sharded engine's shard threads (L={L} S={cfg.total_steps} "
        f"CAP={cfg.read_step_cap} C={C}): bit-exact against "
        f"{'its plain version and ' if plain else ''}the same shards "
        f"unsharded; shard steps {steps} (step efficiency "
        f"{sum(steps) / (D * max(steps)):.4f}); {k9_ms:.1f} ms (median of "
        f"{', '.join(f'{x:.1f}' for x in times['k9'])}; first call "
        f"{first_ms:.1f}), the same shards one after the other {seq_ms:.1f} "
        f"ms (median of {', '.join(f'{x:.1f}' for x in times['seq'])}): "
        f"K9 at {k9_ms / seq_ms:.2f}x; bound {bound_ms(k9_bytes):.3f} ms"
        + (f", plain {plain_ms:.1f} ms" if plain else ""))
    return dict(reads=R, steps=steps, ms=k9_ms, plain_ms=plain_ms,
                bound_ms=bound_ms(k9_bytes), sequential_ms=seq_ms,
                max_abs_err=err, rebase_launches=rebases), seq


def k9_check(torch, engine, reads):
    """K9 on `engine` (a sharded engine: K9_SHARDS shards on one card) at
    K9_SHARDS x K9_READS reads of path 1's workload against its plain
    version, and at path 7's block (K9_SHARDS x 8,192 reads) against its
    shards run unsharded; then `shard_rebase` alone on a shard's result
    against its plain version, its time split into events, host and card.
    Returns the kernel-table row of `shard_rebase` (its launches those of
    K9's first call at path 7's block, counts reset just before it: one a
    shard), with K9's numbers beside it."""
    from mapad_tpu_torch.map.record import Record
    from mapad_tpu_torch.ops.search_pool import PoolResult
    from mapad_tpu_torch.parallel import pool_sharded as tps

    D, r = K9_SHARDS, K9_READS
    R = D * r
    recs = [Record(sequence=s, base_qualities=q) for s, q in reads]
    small, seq = k9_run(torch, engine, recs[:R], plain=True)
    main, _ = k9_run(torch, engine, recs[:engine.block_reads], plain=False)

    # shard_rebase alone: shard 1's local ids made global, kernel and plain
    def shard1():
        return PoolResult(*[None if t is None else t.clone()
                            for t in seq[1]])

    got = tps.shard_rebase(shard1(), r, r, R)
    want = tps._shard_rebase_plain(shard1(), r, r, R)
    err = max(small["max_abs_err"], main["max_abs_err"], compare(
        torch, (got.c_read, got.lane_read, got.next_read),
        (want.c_read, want.lane_read, want.next_read), "shard_rebase"))
    # timed at base 0 (the rewrite leaves its result as it is)
    a, b = shard1(), shard1()
    cfg = engine.pool_config
    C, L = cfg.max_chains, cfg.lanes

    def rebase():
        return tps.shard_rebase(a, 0, r, R)

    ms, host, per_call = split_ms(torch, rebase, 50, "shard_rebase")
    if per_call != 1:
        raise AssertionError(f"shard_rebase: {per_call} launches a call")
    row = dict(
        route="cuda", source="mapad_tpu_torch/csrc/pool_sharded.cu",
        replaces="mapad_tpu/parallel/pool_sharded.py:122", max_abs_err=err,
        ms=ms, host_ms=host, launches_per_call=per_call,
        plain_ms=timed(torch, lambda: tps._shard_rebase_plain(b, 0, r, R),
                       20),
        bound_ms=bound_ms((C + L) * 4 * 2 + 8), bound_by="bytes",
        library_ms=None, k9_launches=main["rebase_launches"],
        **{f"k9_{k}": v for k, v in small.items()
           if k not in ("max_abs_err", "rebase_launches")},
        **{f"k9_main_{k}": v for k, v in main.items()
           if k not in ("max_abs_err", "plain_ms", "rebase_launches")},
    )
    CARD_LATER.append(("shard_rebase", row, rebase))
    log(f"shard_rebase C={C} L={L}: bit-exact, {row['ms']:.4f} ms by events "
        f"(host {row['host_ms']:.4f} ms, one launch a call; plain "
        f"{row['plain_ms']:.4f} ms, bound {row['bound_ms']:.6f} ms); "
        f"{row['k9_launches']} launches in K9's call at path 7's block")
    return row


# --- the probe phase: P1-P4, the ports of the TPU's DMA probes -------------


def probe_cases():
    """P2's eight shapes (tools/_probe_shapes.py:58-70), P3 (tools/_t9.py)
    and P4 (tools/_dump_pair.py): (what, direction, array shape, slice,
    block shape, addend)."""
    from mapad_tpu_torch.tools import _dump_pair, _probe_shapes, _t9

    cases = [(f"P2 {name}", kind, shape, sl, blk, 0)
             for name, kind, shape, sl, blk in _probe_shapes.SHAPES]
    w = _dump_pair.W
    return cases + [
        (f"P3 row {_t9.ROW} of ({_t9.NB}, {_t9.W})", "src", (_t9.NB, _t9.W),
         (slice(_t9.ROW, _t9.ROW + 1),), (1, _t9.W), 0),
        (f"P4 k_src: row {_dump_pair.SRC_ROW} of (8, {w})", "src", (8, w),
         (slice(_dump_pair.SRC_ROW, _dump_pair.SRC_ROW + 1),), (1, w), 0),
        (f"P4 k_dst: in + 1 into row {_dump_pair.DST_ROW} of (8, {w})",
         "dst", (8, w), (slice(_dump_pair.DST_ROW, _dump_pair.DST_ROW + 1),),
         (1, w), 1),
    ]


def copy_case(torch, what, kind, shape, sl, blk, addend, floor_ms):
    """One P2-P4 copy on the card against its plain version and torch
    slicing of `arange` data, then timed: the kernel and the one PyTorch
    call that does the same (`x[sl].clone()`, or `out[sl] = inp + addend`)
    in turns, COPY_ROUNDS rounds each by CUDA events over 200 calls and by
    the profiler's device time over 50 (a round whose profile saw no device
    time left out), medians kept; the plain version once by events.  `floor_ms`: the device time of a kernel that does nothing.
    Returns its measurements."""
    from mapad_tpu_torch.tools import _probe_shapes, cuda_ms, device_ms

    fn, plain, library, ref = _probe_shapes.case(
        kind, shape, sl, blk, torch.device("cuda", 0), addend)
    got, want = fn(), plain()
    torch.cuda.synchronize()
    err = max(compare(torch, (got,), (want,), f"{what}: kernel against plain"),
              compare(torch, (got,), (ref,),
                      f"{what}: kernel against torch slicing"))
    _row0, nrows, _col0, ncols = _probe_shapes.slice_args(shape, sl)
    n = nrows * ncols * 4 * 2
    runs = {k: [] for k in ("ms", "library_ms", "device_ms",
                            "library_device_ms")}
    for _ in range(COPY_ROUNDS):
        runs["ms"].append(cuda_ms(fn, 200))
        runs["library_ms"].append(cuda_ms(library, 200))
        runs["device_ms"].append(device_ms(fn, 50))
        runs["library_device_ms"].append(device_ms(library, 50))
    r = dict(what=what, kind=kind, max_abs_err=err, bytes=n,
             bound_ms=bound_ms(n), plain_ms=cuda_ms(plain, 200),
             floor_device_ms=floor_ms,
             **{k: median([x for x in v if x is not None])
                if any(x is not None for x in v) else None
                for k, v in runs.items()})
    shown = {k: "not measured" if v is None else f"{v:.4g} ms"
             for k, v in r.items() if k.endswith("ms")}
    log(f"{what}: bit-exact; kernel {shown['ms']} a call by events, "
        f"{shown['device_ms']} device; library {shown['library_ms']} by "
        f"events, {shown['library_device_ms']} device (medians of "
        f"{COPY_ROUNDS} rounds in turns); plain {shown['plain_ms']}; bound "
        f"{shown['bound_ms']}; an empty kernel {shown['floor_device_ms']} "
        "device")
    return r


def probe_phase(torch, card):
    """P1-P4 on the card.  Checks first, outside the counted run: P1 against
    its plain version at the TPU probe's defaults and over T = 512 steps;
    P2-P4 at their shapes against their plain versions and torch slicing,
    each timed.  Then the counted run, the tools as a user runs them: P1's
    three forms timed at the three tables of PROBE_TABLES (bench_dma), P2's
    shapes (_probe_shapes), P3 (_t9), P4's copies and its PTX/SASS dump
    (_dump_pair).  Returns (kernel-table rows, launches of that run)."""
    from mapad_tpu_torch._build import LAUNCHES
    from mapad_tpu_torch.tools import (_dump_pair, _probe_shapes, _t9,
                                       bench_dma, device_ms, dma)

    dev = torch.device("cuda", 0)
    rows, blk = bench_dma.make_inputs(PROBE_NB, PROBE_W, PROBE_L, seed=0,
                                      device=dev)
    err = 0.0
    for steps in (PROBE_T, PROBE_T_LONG):
        got = dma.gather_steps(rows, blk, steps)
        want = dma.gather_steps_plain(rows, blk, steps)
        err = max(err, compare(torch, got, want, f"probe_dma T={steps}"))
        log(f"P1 probe_dma L={PROBE_L} W={PROBE_W} NB={PROBE_NB} T={steps}: "
            f"bit-exact (acc {float(got[0])!r}, chk {int(got[1])})")
    if not float(got[0]) > 2**24:
        raise AssertionError("P1's check never took acc past 2^24")
    plain_ms = timed(torch, lambda: dma.gather_steps_plain(rows, blk,
                                                           PROBE_T), 1)
    del rows, blk
    # the device time of a kernel that does nothing (a zero-cycle spin)
    floor_ms = device_ms(lambda: torch.cuda._sleep(0), 50) \
        if hasattr(torch.cuda, "_sleep") else None
    cases = [copy_case(torch, *c, floor_ms) for c in probe_cases()]

    LAUNCHES.reset()
    torch.cuda.synchronize()
    tables = []
    for what, nb in PROBE_TABLES:
        rows, blk = bench_dma.make_inputs(nb, PROBE_W, PROBE_L, seed=0,
                                          device=dev)
        us = bench_dma.measure(rows, blk, PROBE_T)
        tables.append(dict(what=what, nb=nb, mb=nb * PROBE_W * 4 / 1e6,
                           **{f"{f}_us": us[f] for f in bench_dma.FORMS}))
        log(f"P1 at {what} (NB={nb}, {tables[-1]['mb']:.1f} MB), "
            f"L={PROBE_L} W={PROBE_W} T={PROBE_T}, us a step: " + ", ".join(
                f"{f} {us[f]:.3f}" for f in bench_dma.FORMS)
            + f" (bound {bench_dma.step_bound_us(PROBE_L, PROBE_W):.4f}; "
            f"{card})")
        del rows, blk
    bad = [n for n, ok in _probe_shapes.check() if not ok]
    got, want = _t9.run()
    bad += [] if torch.equal(got, want) else ["P3"]
    bad += [w for w, g, x in _dump_pair.run_pair() if not torch.equal(g, x)]
    dump_dir = os.path.join(WORK, "dump_pair")
    counts = _dump_pair.dump(dump_dir)
    torch.cuda.synchronize()
    launches = {k: LAUNCHES.get(k)
                for k in ("probe_dma", "copy_src_slice", "copy_dst_slice")}
    log(f"probe tools: kernel launches {launches}")
    if bad:
        raise AssertionError(f"probe tools failed: {bad}")
    for kernel, (ptx, sass) in counts.items():
        for ext in ("ptx", "sass"):
            text = open(os.path.join(dump_dir, f"{kernel}.{ext}")).read()
            if f"{kernel}_kernel" not in text:
                raise AssertionError(f"P4 dump {kernel}.{ext} lacks its "
                                     "kernel")
        log(f"P4 dump: {kernel} {ptx} PTX, {sass} SASS instructions")
    for name, n in launches.items():
        if not n:
            raise AssertionError(f"probe tools: {name} did not launch")

    step_bytes = PROBE_L * PROBE_W * 4
    last = tables[-1]
    out = {"probe_dma": dict(
        route="cuda", source="mapad_tpu_torch/csrc/probe_dma.cu",
        replaces="tools/bench_dma.py:34", max_abs_err=err,
        ms=last["one_launch_us"] * PROBE_T / 1e3, plain_ms=plain_ms,
        bound_ms=bound_ms(PROBE_T * step_bytes + PROBE_L * 4 + 8),
        bound_by="bytes", library_ms=last["library_us"] * PROBE_T / 1e3,
        launch_per_step_ms=last["launch_per_step_us"] * PROBE_T / 1e3,
        step_tables=tables,
        # one dependent load a step through a table past the L2 (the
        # latency measured before path 1; not in --probes alone)
        latency_floor_ms=(PROBE_T * LOAD_NS["DRAM"] / 1e6
                          if "DRAM" in LOAD_NS else None))}
    # each copy kernel's row: its time at P2's largest slice of its
    # direction, every probe shape's measurements beside it
    for name, kind, head, replaces, also in (
            ("copy_src_slice", "src", "P2 src 3d (64,8,128)->(1,8,128)",
             "tools/_probe_shapes.py:29",
             ["tools/_t9.py:10", "tools/_dump_pair.py:32"]),
            ("copy_dst_slice", "dst", "P2 dst (1024,128) write (72,128)",
             "tools/_probe_shapes.py:44", ["tools/_dump_pair.py:39"])):
        mine = [c for c in cases if c["kind"] == kind]
        h = next(c for c in mine if c["what"] == head)
        out[name] = dict(
            route="cuda", source="mapad_tpu_torch/csrc/probe_copy.cu",
            replaces=replaces, also_replaces=also,
            max_abs_err=max(c["max_abs_err"] for c in mine),
            **{k: h[k] for k in ("ms", "plain_ms", "bound_ms", "library_ms",
                                 "device_ms", "library_device_ms",
                                 "floor_device_ms")},
            bound_by="bytes", shape=head, ptx_sass=list(counts[name]),
            shapes=mine)
    return out, launches


PATH8_PROCESS = r"""
import dataclasses, json, sys, time
(root, fasta, fastq, out, coordinator, pid, flags, seed, chunk,
 device) = sys.argv[1:]
sys.path.insert(0, root)
from mapad_tpu_torch import cli
from mapad_tpu_torch.index import load_index
from mapad_tpu_torch.ops.engine import DeviceSearchEngine
from mapad_tpu_torch.parallel.multihost import run_multihost

t = time.perf_counter()
args = cli.build_parser().parse_args(
    ["map", "-r", fastq, "-g", fasta, "-o", out, *json.loads(flags)])
params = dataclasses.replace(cli.build_alignment_parameters(args),
                             chunk_size=int(chunk))
engine = DeviceSearchEngine(load_index(fasta).fmd, params, lanes=args.lanes,
                            packed_hits=True, device=device)
run_multihost(fastq, fasta, out, True, params, engine=engine,
              position_seed=int(seed), cmdline="mapad map",
              coordinator=coordinator, num_processes=2, process_id=int(pid))
st = engine.stats()
print(f"process {pid}: {st['device_lanes']} reads in {st['batches']} "
      f"blocks, {time.perf_counter() - t:.2f} s from start to merge", flush=True)
"""


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def path8(cli, fasta, fastq, native_bam, seed, device="cuda:0"):
    """Two processes on one machine run `run_multihost` over gloo on
    localhost, each over its own chunk on cuda:0; process 0 merges.  The
    merged BAM equals the native engine's BAM of the same chunks (the
    position drawn for a read with several best hits is seeded by its
    chunk's id and its place in the chunk, as in mapAD, so it depends on
    the chunk size: path 1's native BAM, one chunk, differs there).  A
    process that fails or hangs fails the smoke."""
    native_chunks = os.path.join(WORK, f"native_{PATH8_CHUNK}.bam")
    t = time.perf_counter()
    if cli.main(["--threads", "0", "map", "-r", fastq, "-g", fasta, "-o",
                 native_chunks, "--force_overwrite", "--engine", "native",
                 "--batch_size", str(PATH8_CHUNK), *MAP_FLAGS]) != 0:
        raise SystemExit("native map failed")
    a, b = bam_records(native_chunks)[1], bam_records(native_bam)[1]
    log(f"path 8: map --engine native --batch_size {PATH8_CHUNK} "
        f"{time.perf_counter() - t:.2f} s; {sum(x != y for x, y in zip(a, b))}"
        f" records differ from the one-chunk native BAM (positions of reads "
        f"with several best hits)")
    out = os.path.join(WORK, "multihost.bam")
    coordinator = f"127.0.0.1:{free_port()}"
    env = dict(os.environ, MAPAD_SHARD="0")
    t = time.perf_counter()
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", PATH8_PROCESS, ROOT, fasta, fastq, out,
             coordinator, str(pid), json.dumps(MAP_FLAGS), str(seed),
             str(PATH8_CHUNK), device],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        )
        for pid in range(2)
    ]
    try:
        outs = [p.communicate(timeout=PATH8_TIMEOUT)[0].decode(
            errors="replace") for p in procs]
    finally:
        for p in procs:
            p.kill()
            p.wait()
    for pid, (p, text) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise AssertionError(f"path 8: process {pid} exited with "
                                 f"{p.returncode}:\n{text[-4000:]}")
        for line in text.splitlines():
            if line.startswith("process "):
                log(f"  {line}")
    secs = time.perf_counter() - t
    log(f"path 8, run_multihost in 2 processes (gloo on localhost, "
        f"{PATH8_CHUNK}-read chunks): {N_READS} reads in {secs:.2f} s = "
        f"{N_READS / secs:.1f} reads/s, process start to merged BAM")
    bam_compare(out, native_chunks, "path 8")
    return secs


class _Lines:
    """A process's output, read on a thread of its own (the pipe never
    fills); `wait_for` blocks until a line holds a text."""

    def __init__(self, proc):
        self.proc, self.lines, self.done = proc, [], False
        self.cond = threading.Condition()
        self.thread = threading.Thread(target=self._read, daemon=True)
        self.thread.start()

    def _read(self):
        for raw in self.proc.stdout:
            with self.cond:
                self.lines.append(raw.decode(errors="replace").rstrip())
                self.cond.notify_all()
        with self.cond:
            self.done = True
            self.cond.notify_all()

    def wait_for(self, text, timeout, what, other=None):
        """Until a line holds `text`; fails at the timeout, when this
        process ends first, or when `other` (a _Lines) ends."""
        end = time.perf_counter() + timeout
        with self.cond:
            while not any(text in line for line in self.lines):
                left = end - time.perf_counter()
                gone = other is not None and other.proc.poll() is not None
                if self.done or gone or left <= 0:
                    raise AssertionError(
                        f"{what}: no {text!r} in its output:\n"
                        + "\n".join(self.lines[-40:])
                        + (f"\nthe other process:\n{other.tail()}"
                           if gone else ""))
                self.cond.wait(min(left, 1.0))

    def tail(self, n=40):
        self.thread.join(timeout=10)
        with self.cond:
            return "\n".join(self.lines[-n:])


def path9(torch, cli, fasta, fastq, card, kernels):
    """Distributed mode on the card: `map --dispatcher` in a subprocess
    with two workers on cuda:0, the CLI's `worker` in a subprocess and a
    `Worker` on a thread of this process (its launches counted), one
    8,192-read chunk each.  The BAM equals `map --engine native` of the
    same chunks with the dispatcher's position seed (0): the position
    drawn for a read with several best hits is seeded by the seed, the
    chunk's id and the read's place in it.  The dispatcher writes a chunk
    as its result comes in, so the records are compared in name order.  A
    process or thread that fails or hangs fails the smoke.  -> the
    in-process worker's launch counts."""
    from mapad_tpu_torch._build import LAUNCHES
    from mapad_tpu_torch.distributed.worker import Worker

    native = os.path.join(WORK, f"native_{PATH8_CHUNK}_seed0.bam")
    t = time.perf_counter()
    if cli.main(["--seed", "0", "--threads", "0", "map", "-r", fastq, "-g",
                 fasta, "-o", native, "--force_overwrite", "--engine",
                 "native", "--batch_size", str(PATH8_CHUNK),
                 *MAP_FLAGS]) != 0:
        raise SystemExit("native map failed")
    log(f"path 9: map --seed 0 --engine native --batch_size {PATH8_CHUNK} "
        f"{time.perf_counter() - t:.2f} s")
    out = os.path.join(WORK, "distributed.bam")
    port = str(free_port())
    cmd = [sys.executable, "-m", "mapad_tpu_torch.cli", "--port", port]
    env = dict(os.environ, MAPAD_SHARD="0")
    procs, errors = [], []

    def start(argv):
        procs.append(subprocess.Popen(
            cmd + argv, cwd=ROOT, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT))
        return _Lines(procs[-1])

    def serve(worker):
        try:
            worker.run()
        except Exception as e:  # noqa: BLE001 - fails the path below
            errors.append(e)

    LAUNCHES.reset()
    torch.cuda.synchronize()
    t = time.perf_counter()
    try:
        dispatcher = start(["map", "--dispatcher", "--batch_size",
                            str(PATH8_CHUNK), "-r", fastq, "-g", fasta, "-o",
                            out, "--force_overwrite", *MAP_FLAGS])
        dispatcher.wait_for("Dispatcher listening", PATH9_TIMEOUT,
                            "path 9 dispatcher")
        cli_worker = start(["worker", "--host", "127.0.0.1"])
        # the CLI worker holds the first chunk before this one connects
        dispatcher.wait_for("Worker connected", PATH9_TIMEOUT,
                            "path 9 dispatcher", other=cli_worker)
        worker = Worker("127.0.0.1", int(port))
        thread = threading.Thread(target=serve, args=(worker,), daemon=True)
        thread.start()
        for proc, lines, what in ((procs[0], dispatcher, "dispatcher"),
                                  (procs[1], cli_worker, "CLI worker")):
            try:
                rc = proc.wait(timeout=PATH9_TIMEOUT)
            except subprocess.TimeoutExpired:
                raise AssertionError(f"path 9: the {what} hangs:\n"
                                     + lines.tail()) from None
            if rc != 0:
                raise AssertionError(f"path 9: the {what} exited with {rc}:"
                                     f"\n{lines.tail()}")
        thread.join(timeout=PATH9_TIMEOUT)
        if thread.is_alive() or errors:
            raise AssertionError(f"path 9: the in-process worker "
                                 f"{'hangs' if not errors else errors[0]}")
    finally:
        for proc in procs:
            proc.kill()
            proc.wait()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t
    counts = {k: LAUNCHES.get(k) for k in kernels}
    st = worker.engine.stats()
    log(f"path 9, map --dispatcher with a CLI worker and an in-process "
        f"worker on cuda:0 ({PATH8_CHUNK}-read chunks): {N_READS} reads in "
        f"{secs:.2f} s = {N_READS / secs:.1f} reads/s, dispatcher start to "
        f"BAM, on {card}")
    log(f"  in-process worker: {st['device_lanes']} reads in "
        f"{st['batches']} blocks ({st['steps']} pool steps), escalated "
        f"{st['escalated']} by cause {st.get('esc_why')}")
    log("  its seconds per stage: " + ", ".join(
        f"{k} {st[k]:.3f}" for k in ("prep_s", "device_s", "wait_s",
                                     "decode_s", "fb_secs")))
    log(f"  its kernel launches: {counts}")
    missing = [k for k, v in counts.items() if v <= 0]
    if missing:
        raise AssertionError(f"kernels not launched on path 9: {missing}")
    if st["batches"] != 1:
        raise AssertionError(f"path 9: the in-process worker ran "
                             f"{st['batches']} blocks, not one chunk's")
    check_k2_launches(counts, "path 9")
    bam_compare(out, native, "path 9", in_name_order=True)
    return counts


def path10(torch, cli, fasta, reads, native_bam, card, kernels, tap):
    """CRAM input against a mapAD-native index: path 1's reads as a CRAM
    3.1 written by the port's CramWriter (rANS-Nx16, arith on the bases,
    fqzcomp on the qualities, tok3 on the names), path 1's genome indexed
    by `index --mapad_format` in a directory of its own with the bundle
    removed, so that `load_index` reads mapAD's own files; `map --engine
    device` at the defaults, its BAM equal to `map --engine native`'s on
    the same CRAM and index.  -> its launch counts."""
    from mapad_tpu_torch._build import LAUNCHES
    from mapad_tpu_torch.index import load_index
    from mapad_tpu_torch.io import cram

    d = os.path.join(WORK, "path10")
    os.makedirs(d, exist_ok=True)
    reads_cram = os.path.join(d, "reads.cram")
    methods = {i: cram.M_RANSNX16 for i in range(1, 20)}
    methods.update({6: cram.M_TOK3, 8: cram.M_ARITH, 9: cram.M_FQZCOMP})
    recs = [{"name": b"read%d" % i, "flags": cram.BF_UNMAPPED, "seq": seq,
             "quals": quals, "tags": []}
            for i, (seq, quals) in enumerate(reads)]
    t = time.perf_counter()
    with open(reads_cram, "wb") as f:
        w = cram.CramWriter(f, "@HD\tVN:1.6\tSO:unsorted\n",
                            block_method=methods, version=(3, 1))
        for i in range(0, len(recs), CRAM_CHUNK):
            w.write_chunk(recs[i : i + CRAM_CHUNK])
        w.close()
    log(f"path 10: CRAM 3.1 of {len(recs)} reads written in "
        f"{time.perf_counter() - t:.2f} s, {os.path.getsize(reads_cram)} "
        f"bytes")
    t = time.perf_counter()
    with open(reads_cram, "rb") as f:
        back = [(r.sequence, r.quals) for r in cram.CramReader(f)]
    decode_s = time.perf_counter() - t
    log(f"path 10: CRAM decode (pure Python, host): {len(back)} records in "
        f"{decode_s:.3f} s = {len(back) / decode_s:.1f} records/s")
    if back != [(s, q) for s, q in reads]:
        raise AssertionError("path 10: the CRAM decodes to other reads")
    genome = os.path.join(d, "genome.fa")
    shutil.copy(fasta, genome)
    t = time.perf_counter()
    if cli.main(["index", "--mapad_format", "-g", genome]) != 0:
        raise SystemExit("index --mapad_format failed")
    shutil.rmtree(genome + ".tpx")
    fmt = load_index(genome).meta["format"]
    log(f"path 10: index --mapad_format {time.perf_counter() - t:.1f} s, "
        f"bundle removed: load_index reads the {fmt} files")
    if fmt != "mapad-native":
        raise AssertionError(f"path 10: load_index read {fmt}")
    dev_bam = os.path.join(d, "device.bam")
    tap.stats = None
    LAUNCHES.reset()
    torch.cuda.synchronize()
    t = time.perf_counter()
    if cli.main(["--threads", "0", "map", "-r", reads_cram, "-g", genome,
                 "-o", dev_bam, "--force_overwrite", "--engine", "device",
                 *MAP_FLAGS]) != 0:
        raise SystemExit("device map of the CRAM failed")
    torch.cuda.synchronize()
    secs = time.perf_counter() - t
    counts = {k: LAUNCHES.get(k) for k in kernels}
    if tap.stats is None:
        raise AssertionError("the device map logged no search stats")
    report_run("path 10, map --engine device of a CRAM 3.1 on a "
               "mapAD-native index", card, secs, tap.stats, counts)
    check_k2_launches(counts, "path 10")
    nat_bam = os.path.join(d, "native.bam")
    native_map_and_compare(cli, reads_cram, genome, dev_bam, nat_bam,
                           "path 10")
    a, b = bam_records(nat_bam)[1], bam_records(native_bam)[1]
    log(f"path 10: {sum(x != y for x, y in zip(a, b))} records differ from "
        f"path 1's native BAM (FASTQ input, .tpx bundle)")
    return counts


def search_batch_bytes(idx_d, inputs, res, lane_steps, chunk):
    """Bytes K10 must move for the steps its lanes ran -> (bound bytes, scan
    bytes).  Bound: its inputs once (pattern codes, score LUT, Bi-D and the
    five per-lane consts), per lane-step the popped row (32 B), the 9 rows
    (32 B each) and 9 keys written and K1's two 512 B index rows (over the
    run at most the whole index), the outputs once.  Scan: the keys of the
    popped chunk this kernel reads at each pop, 4 x `chunk` B a lane-step,
    its own traffic (the chunk maxima in shared memory name the chunk)."""
    lane_step_total = float(lane_steps.double().sum())
    need = (nbytes(*inputs) + lane_step_total * (32 + 9 * 32 + 9 * 4)
            + min(nbytes(idx_d.rows), lane_step_total * 2 * 512)
            + nbytes(*res))
    return need, lane_step_total * 4 * chunk


def batch_check(torch, engine, reads, r, what, bid_row=False):
    """K10 (and K7, int32) against their plain versions on the card on the
    first `r` reads, at `engine`'s config (a batch engine), every
    SearchResult field bit for bit.  Returns the K10 kernel-table row (and
    the K7 one with `bid_row`)."""
    from mapad_tpu_torch.map.record import Record
    from mapad_tpu_torch.ops import bi_d
    from mapad_tpu_torch.ops import search as srch

    recs = [Record(sequence=s, base_qualities=q) for s, q in reads[:r]]
    cfg, M = engine.config, engine.config.max_len
    with torch.cuda.device(engine.device):
        prep = engine._prepare(recs, M, r, host_bid=False, dense=True)
    rank, code, n, score_lut, pen, split, scale, thresh, repr_mm = (
        prep["dense"][k] for k in ("pattern_rank", "pattern_code", "n",
                                   "score_lut", "pen", "split", "scale",
                                   "thresh", "repr_mm"))
    st = prep["_stash"]
    steps = (int(st["split"].max()), int((st["n"] - st["split"]).max()))
    idx_d, params = engine.device_index, engine._params()
    fwd = cfg.compute_forward_part
    rows = {}

    def k7():
        return bi_d.compute_bi_d(idx_d, rank, pen, n, split, fwd, steps)

    def k7_plain():
        return bi_d.compute_bi_d_plain(idx_d, rank, pen, n, split, fwd, steps)

    bid = k7()
    err7 = compare(torch, (bid,), (k7_plain(),), f"bi_d ({what})")
    if bid_row:
        walk_steps = bi_d.walk_steps(n, split, fwd)
        rows["bi_d"] = dict(
            route="cuda", source="mapad_tpu_torch/csrc/bi_d.cu",
            replaces="mapad_tpu/ops/bi_d.py:27", max_abs_err=err7,
            ms=timed(torch, k7, 10), plain_ms=timed(torch, k7_plain, 1),
            bound_ms=bound_ms(nbytes(rank, pen, n, split, bid) + min(
                nbytes(idx_d.rows), walk_steps * 2 * 512)),
            bound_by="bytes", library_ms=None, walk_steps=walk_steps,
            plan=k7_plan(bi_d, engine.device, rank, fwd, False),
            ptxas=PTXAS.get("K7 int32"),
        )
        log(f"K7 bi_d (int32) R={r} M={M} ({walk_steps} walk steps, longest "
            f"parts {steps}, forward part {fwd}): bit-exact, "
            f"{rows['bi_d']['ms']:.4f} ms (plain "
            f"{rows['bi_d']['plain_ms']:.1f} ms); plan {rows['bi_d']['plan']}"
            f"; ptxas {rows['bi_d']['ptxas']}")

    args = (idx_d, code, n, score_lut, bid, split, scale, thresh, repr_mm,
            params, cfg)
    res, lane_steps = srch._search_batch_cuda(*args)
    torch.cuda.synchronize()
    t = time.perf_counter()
    pres = srch._search_batch_plain(*args)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t) * 1e3
    err = compare(torch, tuple(res), tuple(pres), f"search_batch ({what})")
    times = []
    for _ in range(3):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        srch._search_batch_cuda(*args)
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    ls = lane_steps.cpu()
    hc, esc = res.hcount.cpu(), res.escalate.cpu()
    if not int((hc > 0).sum()):
        raise AssertionError(f"search_batch ({what}): no hit")
    plan = srch.batch_card_plan(engine.device, r, cfg.max_steps, M)
    need, scan = search_batch_bytes(
        idx_d, (code, n, score_lut, bid, split, scale, thresh, repr_mm), res,
        ls, plan.chunk)
    top = int(ls.max())
    row = dict(
        route="cuda", source="mapad_tpu_torch/csrc/search_batch.cu",
        replaces="mapad_tpu/ops/search.py:99", max_abs_err=err,
        ms=median(times), plain_ms=plain_ms,
        bound_ms=bound_ms(need), bound_by="bytes",
        library_ms=None, steps=int(res.steps), scan_bytes=scan,
        scan_ms=bound_ms(scan), max_lane_steps=top,
        us_step=median(times) * 1e3 / max(top, 1),
        plan=dict(plan._asdict()), ptxas=PTXAS.get("K10"),
    )
    log(f"K10 search_batch ({what}) L={r} S={cfg.max_steps} H={cfg.hit_cap} "
        f"M={M}: bit-exact; steps {int(res.steps)}, lane steps mean "
        f"{float(ls.double().mean()):.1f} max {top}, {int(esc.sum())} "
        f"escalate, {int((hc > 0).sum())} lanes with hits; "
        f"{', '.join(f'{x:.3f}' for x in times)} ms (median {row['ms']:.3f}),"
        f" {row['us_step']:.3f} us a step of the longest lane, plain "
        f"{plain_ms:.1f} ms, bound {row['bound_ms']:.4f} ms "
        f"({need:.0f} B), {row['ms'] / row['bound_ms']:.1f}x it; the popped "
        f"chunks' keys {scan:.0f} B more ({row['scan_ms']:.4f} ms); plan "
        f"{row['plan']}; ptxas {row['ptxas']}")
    rows["search_batch"] = row
    return rows


class _BatchTap:
    """While it is entered, every K7 + K10 call of the batch engine leaves
    its SearchResult in `results` (their `steps` are read afterwards)."""

    def __init__(self, eng_mod):
        self.mod, self.results = eng_mod, []

    def __enter__(self):
        self.fn = fn = self.mod.k_mismatch_search_batch

        def run(*args, **kw):
            res = fn(*args, **kw)
            self.results.append(res)
            return res

        self.mod.k_mismatch_search_batch = run
        return self

    def __exit__(self, *exc):
        self.mod.k_mismatch_search_batch = self.fn

    def steps(self):
        return [int(r.steps) for r in self.results]


def batch_path(np, engine, recs, want, kernels, pool):
    """Path 6: `engine` (a batch engine) on `recs` against the native
    engine's hits, with the launches of `kernels` counted from 0, set
    beside `pool` (the stats of the pool engine on the same reads) ->
    (launch counts, steps of each batch)."""
    from mapad_tpu_torch._build import LAUNCHES
    from mapad_tpu_torch.ops import engine as eng_mod

    LAUNCHES.reset()
    with _BatchTap(eng_mod) as tap:
        st = block_against_native(
            np, engine, recs, want,
            f"path 6, mode='batch', lanes {engine.lanes}, tiers "
            f"{engine.tiers}")
    counts = {k: LAUNCHES.get(k) for k in kernels}
    steps = tap.steps()
    log(f"  {st['batches']} batches, steps per batch {steps}; seconds per "
        f"stage: prep_s {st['prep_s']:.3f}, wait_s {st['wait_s']:.3f}, "
        f"decode_s {st['decode_s']:.3f}, fb_secs {st['fb_secs']:.3f}")
    log(f"  against the pool engine on the same reads: "
        f"{pool['secs'] / st['secs']:.3f}x its reads/s, escalated "
        f"{st['escalated']} ({pool['escalated']}), host searches "
        f"{st['oracle']} ({pool['oracle']}), fb_secs {st['fb_secs']:.3f} "
        f"({pool['fb_secs']:.3f})")
    log(f"  kernel launches on this path: {counts}")
    if any(v != st["batches"] for v in counts.values()):
        raise AssertionError(f"path 6: {counts} launches for "
                             f"{st['batches']} batches")
    return counts, steps


def table_rows_touched(torch, blob, cls, off, tab_rows, R, M, Q):
    """Distinct rows of the all-length LUT table that an (R, M) block's
    cells gather (the bytes a K4/K6 launch needs of the table)."""
    dev = blob.device
    n_rows = blob[:R].repeat_interleave(M)
    j = torch.arange(M, device=dev, dtype=torch.int32).repeat(R)
    w = blob[blob.numel() - (-(-(R * M) // 3)):]
    q = torch.stack([w & 0x3FF, (w >> 10) & 0x3FF, (w >> 20) & 0x3FF],
                    1).reshape(-1)[: R * M] & 0x7F
    idx = torch.where(j < n_rows,
                      off[n_rows.long()] + (j * 5 + cls) * Q + q,
                      tab_rows - 1)
    return int(torch.unique(idx).numel())


def check_kernels(torch, np, engine, reads):
    """Path 1's kernels against their plain versions on the card, at its
    shapes.  Returns the kernel table rows (launches filled later)."""
    from mapad_tpu_torch.map.record import Record
    from mapad_tpu_torch.ops import engine as eng
    from mapad_tpu_torch.ops import fm
    from mapad_tpu_torch.ops import search_pool2 as sp2
    from mapad_tpu_torch.ops.prep import _DEV_LUT_Q

    dev = engine.device
    recs = [Record(sequence=s, base_qualities=q) for s, q in reads[:8192]]
    cfg, prep, _t0 = engine._prep_block(recs, 8192, engine.pool_config)
    R, M = prep["L"], prep["max_len"]
    assert prep["dev_lut"] and prep["rle"], "path 1 uses the RLE blob"
    blob = torch.from_numpy(prep["blob"]).to(dev)
    tab, _pen_tab, off = engine._device_lut()
    rows = {}

    # K4 at R=8192, M=128 with the Bi-D RLE
    def k4():
        return eng._unpack_prep_lut(blob, tab, off, R, M, _DEV_LUT_Q, True)

    def k4_plain():
        return eng._unpack_prep_lut_plain(blob, tab, off, R, M, _DEV_LUT_Q,
                                          True)

    parts = k4()
    err = compare(torch, parts, k4_plain(), "unpack_prep")
    # bytes the data needs: the blob, each table row it gathers once, the
    # LUT/Bi-D rows written
    touched = table_rows_touched(torch, blob, parts[5][:, 4].to(torch.int32),
                                 off, tab.shape[0], R, M, _DEV_LUT_Q)
    ms, host, per_call = split_ms(torch, k4, 20, "unpack_prep")
    if per_call != 1:
        raise AssertionError(f"unpack_prep: {per_call} launches a call")
    rows["unpack_prep"] = row = dict(
        route="cuda", source="mapad_tpu_torch/csrc/unpack_prep.cu",
        replaces="mapad_tpu/ops/engine.py:231", max_abs_err=err,
        ms=ms, plain_ms=timed(torch, k4_plain, 3),
        bound_ms=bound_ms(nbytes(blob, parts[5]) + touched * 16),
        bound_by="bytes", library_ms=None, host_ms=host,
        launches_per_call=per_call,
        plan=dict(eng.unpack_plan(R, M, True)._asdict()),
    )
    CARD_LATER.append(("K4 unpack_prep", row, k4))
    log(f"K4 unpack_prep R={R} M={M} rle: bit-exact, {row['ms']:.4f} ms by "
        f"events (host {row['host_ms']:.4f} ms, one launch a call; bound "
        f"{row['bound_ms']:.5f} ms; plan {row['plan']}), plain "
        f"{row['plain_ms']:.4f} ms")

    idx_d = engine.device_index
    rows["extend_batch"] = k1_check(torch, fm, idx_d, "extend_batch",
                                    "extend_batch")

    # K2 + K3 + K5 at full width on the block's first CHECK_READS reads
    r = CHECK_READS
    rows.update(pool_check(
        torch, sp2, eng, idx_d, tuple(p[:r] for p in parts[:5]),
        parts[5][: r * M], engine._params(), cfg, M, False,
    ))
    # K8 on K8_READS reads, then timed on the whole block at path 4's shape
    rows["pool_compact"] = compact_check(
        torch, sp2, idx_d, engine._params(), cfg, False,
        main=(parts[:5], parts[5], cfg),
    )
    return rows


def check_kernels_big(torch, np, engine, reads):
    """Path 2's kernels (K6, K7 and the int64 forms of K1, K2, K3, K5)
    against their plain versions on the card, at big mode's shapes."""
    from mapad_tpu_torch.map.record import Record
    from mapad_tpu_torch.ops import bi_d
    from mapad_tpu_torch.ops import engine as eng
    from mapad_tpu_torch.ops import fm
    from mapad_tpu_torch.ops import search_pool2 as sp2
    from mapad_tpu_torch.ops.prep import _DEV_LUT_Q

    dev = engine.device
    R = BLOCK2_READS
    assert engine.block_reads == R and not engine._host_bid_active()
    recs = [Record(sequence=s, base_qualities=q) for s, q in reads[:R]]
    cfg, prep, _t0 = engine._prep_block(recs, R, engine.pool_config)
    M = prep["max_len"]
    assert prep.get("dev_full"), "path 2 uploads the small blob"
    blob = torch.from_numpy(prep["blob"]).to(dev)
    tab, pen_tab, off = engine._device_lut()
    idx_d = engine.device_index
    rows = {}

    # K6 at R=4096, M=128
    def k6():
        return eng._unpack_prep_full(blob, tab, pen_tab, off, R, M,
                                     _DEV_LUT_Q)

    def k6_plain():
        return eng._unpack_prep_full_plain(blob, tab, pen_tab, off, R, M,
                                           _DEV_LUT_Q)

    dense = k6()
    err = compare(torch, dense, k6_plain(), "unpack_prep_full")
    rank, code, n, score_lut, pen, split, scale, thresh, repr_mm = dense
    touched = table_rows_touched(torch, blob, code.reshape(-1), off,
                                 tab.shape[0], R, M, _DEV_LUT_Q)
    ms, host, per_call = split_ms(torch, k6, 20, "unpack_prep_full")
    rows["unpack_prep_full"] = row = dict(
        route="cuda", source="mapad_tpu_torch/csrc/unpack_prep.cu",
        replaces="mapad_tpu/ops/engine.py:292", max_abs_err=err,
        ms=ms, plain_ms=timed(torch, k6_plain, 3),
        bound_ms=bound_ms(nbytes(blob, rank, code, score_lut, pen)
                          + touched * 20),
        bound_by="bytes", library_ms=None, host_ms=host,
        launches_per_call=per_call,
    )
    CARD_LATER.append(("K6 unpack_prep_full", row, k6))
    if per_call != 1:
        raise AssertionError(f"unpack_prep_full: {per_call} launches a call")
    log(f"K6 unpack_prep_full R={R} M={M}: bit-exact, {row['ms']:.4f} ms "
        f"by events (host {row['host_ms']:.4f} ms, one launch a call; bound "
        f"{row['bound_ms']:.5f} ms), plain {row['plain_ms']:.4f} ms")

    # K7 at R=4096, M=128: the main path's backward part, then both parts
    steps = prep["bid_steps"]

    def k7(fwd=cfg.compute_forward_part):
        return bi_d.compute_bi_d(idx_d, rank, pen, n, split, fwd, steps)

    def k7_plain(fwd=cfg.compute_forward_part):
        return bi_d.compute_bi_d_plain(idx_d, rank, pen, n, split, fwd,
                                       steps)

    bid = k7()
    err = compare(torch, (bid,), (k7_plain(),), "bi_d_i64")
    # a second split puts reads into both parts, for the forward part
    half = torch.div(n, 2, rounding_mode="floor").to(torch.int32)
    n_h, half_h = n.cpu(), half.cpu()
    steps2 = (int(half_h.max()), int((n_h - half_h).max()))
    both = bi_d.compute_bi_d(idx_d, rank, pen, n, half, True, steps2)
    err = max(err, compare(
        torch, (both,),
        (bi_d.compute_bi_d_plain(idx_d, rank, pen, n, half, True, steps2),),
        "bi_d_i64 (both parts)"))
    # the walk steps each run's data needs (both parts where the forward
    # part is on), two 512 B index rows each
    fwd = cfg.compute_forward_part
    walk_steps = bi_d.walk_steps(n, split, fwd)
    both_steps = bi_d.walk_steps(n, half, True)
    k7_bytes = (nbytes(rank, pen, n, split, bid)
                + min(nbytes(idx_d.rows), walk_steps * 2 * 512))
    rows["bi_d_i64"] = dict(
        route="cuda", source="mapad_tpu_torch/csrc/bi_d.cu",
        replaces="mapad_tpu/ops/bi_d.py:27", max_abs_err=err,
        ms=timed(torch, k7, 10), plain_ms=timed(torch, k7_plain, 1),
        bound_ms=bound_ms(k7_bytes), bound_by="bytes", library_ms=None,
        walk_steps=walk_steps, plan=k7_plan(bi_d, dev, rank, fwd, True),
        both_ms=timed(torch, lambda: bi_d.compute_bi_d(
            idx_d, rank, pen, n, half, True, steps2), 10),
        both_walk_steps=both_steps,
        both_bound_ms=bound_ms(nbytes(rank, pen, n, half, both) + min(
            nbytes(idx_d.rows), both_steps * 2 * 512)),
        both_plan=k7_plan(bi_d, dev, rank, True, True),
        ptxas=PTXAS.get("K7 int64"),
    )
    row = rows["bi_d_i64"]
    log(f"K7 bi_d_i64 R={R} M={M} ({R * bi_d.MAX_OFFSET} walks a part): "
        f"bit-exact with and without the forward part; forward part {fwd}: "
        f"{walk_steps} walk steps, longest parts {steps}, {row['ms']:.4f} "
        f"ms (plain {row['plain_ms']:.1f} ms), plan {row['plan']}; both "
        f"parts (split n // 2): {both_steps} walk steps, longest parts "
        f"{steps2}, {row['both_ms']:.4f} ms, plan {row['both_plan']}; "
        f"ptxas {row['ptxas']}")

    # K1 in int64: on the real index, and on one whose counts pass 2^32
    rows["extend_batch_i64"] = k1_check(torch, fm, idx_d, "extend_batch_i64",
                                        "extend_batch_i64")
    off_occ, off_less = (3 << 32) + 12345, (5 << 32) + 999
    r64 = idx_d.rows.clone()
    cp = ((r64[:, 0:6].long() & 0xFFFFFFFF) | (r64[:, 6:12].long() << 32))
    cp = cp + off_occ
    r64[:, 0:6] = (cp & 0xFFFFFFFF).to(torch.int32)
    r64[:, 6:12] = (cp >> 32).to(torch.int32)
    shifted = idx_d._replace(rows=r64, less=idx_d.less + off_less)
    k1s = k1_check(torch, fm, shifted, "extend_batch_i64",
                   "extend_batch_i64 (counts above 2^32)")
    rows["extend_batch_i64"]["max_abs_err"] = max(
        rows["extend_batch_i64"]["max_abs_err"], k1s["max_abs_err"])

    # K2 + K3 + K5 in int64 at full width on the first CHECK2_READS reads
    r = CHECK2_READS
    slut = sp2._dense_slut(idx_d, (rank, code, score_lut, pen), n, split,
                           cfg, steps)
    consts = (n, split, scale, thresh, repr_mm)
    rows.update(pool_check(
        torch, sp2, eng, idx_d, tuple(p[:r].contiguous() for p in consts),
        slut[: r * M].contiguous(), engine._params(), cfg, M, True,
    ))
    # K8 in int64 on K8_READS reads, then timed on the whole block at the
    # starved primary shape of path 4's last run (4,096 steps)
    rows["pool_compact_i64"] = compact_check(
        torch, sp2, idx_d, engine._params(), cfg, True,
        main=(consts, slut, cfg._replace(total_steps=PATH4_BIG_STEPS)),
    )
    return rows


def write_workload(np, size, seed, tag):
    """Genome and reads from a seed -> (fasta path, fastq path, reads)."""
    fasta = os.path.join(WORK, f"genome{tag}.fa")
    fastq = os.path.join(WORK, f"reads{tag}.fq")
    t = time.perf_counter()
    genome = gen_genome(size, np, seed)
    with open(fasta, "w") as f:
        f.write(f">bench{tag}_chr1\n")
        s = genome.tobytes().decode()
        f.writelines(s[i : i + 80] + "\n" for i in range(0, len(s), 80))
    reads = make_reads(genome, N_READS, np, seed + 100)
    with open(fastq, "w") as f:
        for i, (s, q) in enumerate(reads):
            f.write(f"@read{i}\n{s.decode()}\n+\n"
                    + "".join(chr(c + 33) for c in q) + "\n")
    log(f"data{tag}: {size} bp genome, {N_READS} reads in "
        f"{time.perf_counter() - t:.1f} s")
    return fasta, fastq, reads


def report_run(what, card, dev_s, stats, launches):
    log(f"{what}: {N_READS} reads in {dev_s:.2f} s = "
        f"{N_READS / dev_s:.1f} reads/s on {card}")
    log(f"  device blocks {stats['batches']} ({stats['steps']} pool steps), "
        f"escalated {stats['escalated']} by cause {stats.get('esc_why')}, "
        f"host searches {stats['oracle']}, retried "
        f"{stats.get('retried', 0)}, deep_retried "
        f"{stats.get('deep_retried', 0)}, nohit_host "
        f"{stats.get('nohit_host', 0)}")
    log("  seconds per stage: " + ", ".join(
        f"{k} {stats[k]:.3f}" for k in ("prep_s", "device_s", "wait_s",
                                        "decode_s", "fb_secs")))
    log(f"  kernel launches on this path: {launches}")
    missing = [k for k, v in launches.items() if v <= 0]
    if missing:
        raise AssertionError(f"kernels not launched on {what}: {missing}")


def native_map_and_compare(cli, fastq, fasta, dev_bam, nat_bam, what):
    t = time.perf_counter()
    if cli.main(["--threads", "0", "map", "-r", fastq, "-g", fasta, "-o",
                 nat_bam, "--force_overwrite", "--engine", "native",
                 *MAP_FLAGS]) != 0:
        raise SystemExit("native map failed")
    log(f"{what}: map --engine native {time.perf_counter() - t:.2f} s")
    bam_compare(dev_bam, nat_bam, what)


def bam_compare(dev_bam, nat_bam, what, in_name_order=False):
    """The BAM of a path against the native engine's, record for record
    (`in_name_order`: both sorted by read name first)."""
    dh, dr = bam_records(dev_bam)
    nh, nr = bam_records(nat_bam)
    if in_name_order:
        dr, nr = sorted(dr), sorted(nr)
    assert len(dr) == N_READS, len(dr)
    if dh != nh:
        raise AssertionError(f"{what}: BAM headers differ")
    diff = [i for i, (a, b) in enumerate(zip(dr, nr)) if a != b]
    if diff:
        raise AssertionError(f"{what}: {len(diff)} BAM records differ from "
                             f"the native engine's, first at {diff[:5]}")
    mapped = sum(1 for r in dr if not r[1] & 0x4)
    log(f"{what}: BAM of {len(dr)} records equal to --engine native (XD "
        f"aside), {mapped} mapped")
    assert mapped > N_READS // 2, mapped


class _Env:
    """Environment variables set (None: unset) for one call and restored
    after."""

    def __init__(self, **values):
        self.values = values

    def __enter__(self):
        self.old = {k: os.environ.get(k) for k in self.values}
        for k, v in self.values.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v

    def __exit__(self, *exc):
        for k, v in self.old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def packed_same(np, a, b, comp_bit=False):
    """Two packed hit sets hold the same hits bit for bit (the device pads a
    read's op words to its block's width, the host searcher to the read's
    own).  `comp_bit`: `a` comes from the batch search, whose first op word
    of a hit keeps the store's completion mark (OP_COMP_BIT, as in
    mapad_tpu; the decoders ignore it), which is cleared before comparing."""
    if len(a) != len(b):
        return False
    if not len(a):
        return True
    ao, bo = np.asarray(a.ops), np.asarray(b.ops)
    if comp_bit:
        ao = ao & np.uint32(~(1 << 21) & 0xFFFFFFFF)
    w = max(ao.shape[1], bo.shape[1])
    ao = np.pad(ao, ((0, 0), (0, w - ao.shape[1])))
    bo = np.pad(bo, ((0, 0), (0, w - bo.shape[1])))
    return (np.array_equal(np.asarray(a.ivals), np.asarray(b.ivals))
            and np.array_equal(np.asarray(a.scores).view(np.int32),
                               np.asarray(b.scores).view(np.int32))
            and np.array_equal(ao, bo) and int(a.split) == int(b.split))


def block_against_native(np, engine, recs, want, what):
    """`engine.search_chunk(recs)` against the native engine's hits."""
    t0 = time.perf_counter()
    out = engine.search_chunk(recs)
    secs = time.perf_counter() - t0
    comp_bit = getattr(engine, "mode", "pool") == "batch"
    bad = [i for i, ((got, _), (exp, _)) in enumerate(zip(out, want))
           if not packed_same(np, got, exp, comp_bit)]
    if len(out) != len(recs) or bad:
        raise AssertionError(f"{what}: {len(bad)} reads' hits differ from "
                             f"the native searcher's, first at {bad[:5]}")
    stats = engine.stats()
    with_hits = sum(1 for hits, _ in out if len(hits))
    log(f"{what}: {len(recs)} reads in {secs:.2f} s = "
        f"{len(recs) / secs:.1f} reads/s, hits of every read equal to the "
        f"native searcher's ({with_hits} reads with hits)")
    log(f"  steps {stats['steps']}, escalated {stats['escalated']} by cause "
        f"{stats.get('esc_why')}, host searches {stats['oracle']}, "
        f"deep_retried {stats.get('deep_retried', 0)}, nohit_host "
        f"{stats.get('nohit_host', 0)}, probe_empty "
        f"{stats.get('probe_empty', 0)}")
    return dict(stats, secs=secs)


def path7(torch, index, params, args, fastq, fasta, native_bam, card,
          kernels):
    """Path 1's workload through `pipeline.run` with one card's pool engine,
    then over two shards on cuda:0 (MAPAD_SHARD=1, `mesh`), and, on a
    machine with more than one card, over all of them with no `mesh` (the
    automatic mesh); each BAM equal to path 1's native BAM.  A run makes
    no `shard_rebase` launch: a shard's K5 makes its ids global
    (`pack_result_rebase` counts those launches, one a shard and block).
    -> the launch counts of the two-shard run (`kernels`, shard_rebase and
    pack_result_rebase) and its shards' steps."""
    from mapad_tpu_torch._build import LAUNCHES
    from mapad_tpu_torch.map import pipeline
    from mapad_tpu_torch.ops.engine import DeviceSearchEngine

    def run(what, engine):
        bam = os.path.join(WORK, "sharded.bam")
        LAUNCHES.reset()
        torch.cuda.synchronize()
        t = time.perf_counter()
        pipeline.run(fastq, fasta, bam, True, params, None, engine=engine,
                     position_seed=args.seed, cmdline="mapad map",
                     threads=os.cpu_count() or 1, index=index)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t
        st = engine.stats()
        counts = {k: LAUNCHES.get(k) for k in kernels}
        report_run(what, card, secs, st, counts)
        check_k2_launches(counts, what)
        counts.update((k, LAUNCHES.get(k))
                      for k in ("shard_rebase", "pack_result_rebase"))
        rebases = engine.n_shards * st["batches"] if engine.mesh else 0
        log(f"  shard_rebase launches {counts['shard_rebase']}, K5's "
            f"rebasing launches {counts['pack_result_rebase']} (one a shard "
            f"and block: {rebases})")
        if counts["shard_rebase"] or counts["pack_result_rebase"] != rebases:
            raise AssertionError(
                f"{what}: {counts['shard_rebase']} shard_rebase and "
                f"{counts['pack_result_rebase']} rebasing K5 launches for "
                f"{st['batches']} blocks")
        if engine.mesh:
            steps = st["shard_steps"]
            log(f"  shards {engine.n_shards} on {engine.mesh}, "
                f"block_reads {engine.block_reads}, shard steps {steps}, "
                f"step efficiency {sum(steps) / (len(steps) * max(steps)):.4f}"
                f" (sum / (D x max))")
        bam_compare(bam, native_bam, what.split(",")[0])
        return secs, counts, st.get("shard_steps")

    def pool_engine(**kw):
        return DeviceSearchEngine(index.fmd, params, lanes=args.lanes,
                                  packed_hits=True, **kw)

    secs_1card, _, _ = run("path 7 unsharded, pipeline.run", pool_engine())
    card0 = torch.device("cuda", 0)
    with _Env(MAPAD_SHARD="1"):
        eng = pool_engine(mesh=[card0, card0])
    assert eng.n_shards == 2 and eng.block_reads == 2 * 8192
    secs, counts, steps = run("path 7, pipeline.run over two shards on "
                              "cuda:0", eng)
    log(f"path 7: {N_READS / secs:.1f} reads/s over two shards on one card, "
        f"{N_READS / secs_1card:.1f} unsharded just before")
    n_cards = torch.cuda.device_count()
    if n_cards > 1:
        with _Env(MAPAD_SHARD=None):
            auto = pool_engine()
        assert auto.n_shards == n_cards, auto.n_shards
        secs_all, _, _ = run(f"path 7, automatic mesh over {n_cards} cards",
                             auto)
        log(f"path 7 over {n_cards} cards: {N_READS / secs_all:.1f} reads/s "
            f"({N_READS / secs_1card:.1f} on one card unsharded)")
    return counts, steps


def path7_alone(torch, np, cli, load_index, params, args, card, t_start):
    """`--path7`: path 7 alone, with what it needs of path 1 (its workload,
    index and native BAM), for a machine with several cards."""
    fasta, fastq, _reads = write_workload(np, GENOME_SIZE, 42, "")
    if cli.main(["index", "-g", fasta]) != 0:
        raise SystemExit("index failed")
    native_bam = os.path.join(WORK, "native.bam")
    t = time.perf_counter()
    if cli.main(["--threads", "0", "map", "-r", fastq, "-g", fasta, "-o",
                 native_bam, "--force_overwrite", "--engine", "native",
                 *MAP_FLAGS]) != 0:
        raise SystemExit("native map failed")
    log(f"path 1's workload: map --engine native "
        f"{time.perf_counter() - t:.2f} s")
    path7(torch, load_index(fasta), params, args, fastq, fasta, native_bam,
          card, ["unpack_prep", "extend_batch", "pool_search",
                 "extract_chains", "pack_result"])
    log(f"total: {time.perf_counter() - t_start:.1f} s")
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import numpy as np

    from mapad_tpu_torch import _build, cli, tools
    from mapad_tpu_torch._build import LAUNCHES
    from mapad_tpu_torch.index import load_index
    from mapad_tpu_torch.map import pipeline
    from mapad_tpu_torch.ops.engine import DeviceSearchEngine

    t_start = time.perf_counter()
    # paths 1-6 run on one card whatever the machine has; paths 7 and 8 set
    # the mesh themselves
    os.environ["MAPAD_SHARD"] = "0"
    card = tools.card()
    log(card)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")

    t = time.perf_counter()
    logs = _build.build_cuda(_build.CUDA_SOURCES + _build.PROBE_SOURCES,
                             verbose=True)
    for name in ("searcher", "postprocess", "sais"):
        _build.host_library(name, ["-pthread"] if name == "postprocess"
                            else [])
    log(f"build: {time.perf_counter() - t:.1f} s (nvcc for "
        f"{sorted(logs) or 'none: cached'})")
    for name, text in sorted(logs.items()):
        for entry, figs in ptxas_entries(text):
            log(f"  {name}: {entry}: {figs}")
    PTXAS.update(k2_forms(logs))
    PTXAS.update(k10_form(logs))
    PTXAS.update(k7_forms(logs))
    PTXAS.update(k3_forms(logs))
    for form, figs in sorted(PTXAS.items()):
        kernel = ("K10 search_batch_kernel" if form == "K10"
                  else f"{form[:2]} bi_d_kernel, {form[3:]}"
                  if form.startswith("K7")
                  else f"{form[:2]} extract_kernel, {form[3:]}"
                  if form.startswith("K3")
                  else f"K2 pool_search_kernel, {form}")
        log(f"  {kernel}: {figs}")

    os.makedirs(WORK, exist_ok=True)
    args = cli.build_parser().parse_args(
        ["map", "-r", "x", "-g", "x", "-o", "x", *MAP_FLAGS])
    params = cli.build_alignment_parameters(args)
    if "--path7" in sys.argv[1:]:
        return path7_alone(torch, np, cli, load_index, params, args, card,
                           t_start)

    if "--probes" in sys.argv[1:]:
        probe_rows, probe_launches = probe_phase(torch, card)
        return finish(torch, probe_rows, probe_launches,
                      {name: "probes" for name in probe_rows}, card, t_start)

    # the dependent-load latency K3's walk floor counts in
    from mapad_tpu_torch.tools.dma import load_latency_ns

    flush = torch.empty(1 << 25, dtype=torch.int32, device="cuda")
    LOAD_NS["DRAM"] = load_latency_ns(torch.device("cuda", 0), 1 << 26,
                                      flush=flush)
    del flush
    log(f"dependent load: {LOAD_NS['DRAM']:.1f} ns (one thread, a random "
        f"cycle through 256 MB, the L2 flushed first)")

    # --- path 1: small genome through the CLI ---
    fasta, fastq, reads = write_workload(np, GENOME_SIZE, 42, "")
    t = time.perf_counter()
    if cli.main(["index", "-g", fasta]) != 0:
        raise SystemExit("index failed")
    log(f"index: {GENOME_SIZE} bp in {time.perf_counter() - t:.1f} s")
    index = load_index(fasta)
    check_engine = DeviceSearchEngine(index.fmd, params, lanes=args.lanes,
                                      packed_hits=True)
    rows = check_kernels(torch, np, check_engine, reads)
    path_of = {name: 1 for name in rows}
    del check_engine
    card0 = torch.device("cuda", 0)
    with _Env(MAPAD_SHARD="1"):
        k9_engine = DeviceSearchEngine(index.fmd, params, lanes=args.lanes,
                                       packed_hits=True, mesh=[card0] * 2)
    rows["shard_rebase"] = k9_check(torch, k9_engine, reads)
    path_of["shard_rebase"] = "K9"
    del k9_engine

    # K10 and the int32 K7 of path 6 against their plain versions: one
    # batch at the batch engine's defaults, then the center-start model
    import dataclasses

    from mapad_tpu_torch.models import Discrete, VindijaPwm

    pwm = VindijaPwm()
    vparams = dataclasses.replace(
        params, difference_model=pwm, mismatch_bound=Discrete(
            args.poisson_prob, np.float32(args.divergence),
            pwm.get_representative_mismatch_penalty()))
    rows6 = batch_check(
        torch, DeviceSearchEngine(index.fmd, params, mode="batch"), reads,
        BATCH_CHECK_READS, "aDNA model, backward", bid_row=True)
    center = batch_check(
        torch, DeviceSearchEngine(index.fmd, vparams, mode="batch"), reads,
        BATCH_CENTER_READS, "VindijaPwm, both directions")["search_batch"]
    rows6["search_batch"]["max_abs_err"] = max(
        rows6["search_batch"]["max_abs_err"], center["max_abs_err"])
    for k in ("ms", "max_lane_steps", "us_step", "plan"):
        rows6["search_batch"][f"center_{k}"] = center[k]

    # `map --engine device` through the CLI; the streaming driver logs the
    # engine's stats when the run ends
    dev_bam = os.path.join(WORK, "device.bam")
    tap = _StatsTap()
    logging.getLogger("mapad_tpu_torch.map.pipeline").addHandler(tap)
    LAUNCHES.reset()
    torch.cuda.synchronize()
    t = time.perf_counter()
    if cli.main(["--threads", "0", "map", "-r", fastq, "-g", fasta, "-o",
                 dev_bam, "--force_overwrite", "--engine", "device",
                 *MAP_FLAGS]) != 0:
        raise SystemExit("device map failed")
    torch.cuda.synchronize()
    dev_s = time.perf_counter() - t
    launches = {k: LAUNCHES.get(k) for k in rows
                if k not in ("pool_compact", "shard_rebase")}
    stats = tap.stats
    if stats is None:
        raise AssertionError("the device map logged no search stats")
    rows["pool_search"]["steps"] = stats["steps"]
    report_run("path 1, map --engine device", card, dev_s, stats, launches)
    check_k2_launches(launches, "path 1")
    path1_s = dev_s
    native_map_and_compare(cli, fastq, fasta, dev_bam,
                           os.path.join(WORK, "native.bam"), "path 1")
    del index

    # --- path 2: big-genome mode (int64) forced, through pipeline.run ---
    fasta2, fastq2, reads2 = write_workload(np, GENOME2_SIZE, 52, "2")
    t = time.perf_counter()
    if cli.main(["index", "-g", fasta2]) != 0:
        raise SystemExit("index failed")
    log(f"index: {GENOME2_SIZE} bp in {time.perf_counter() - t:.1f} s")
    index2 = load_index(fasta2)

    def big_engine(**kw):
        return DeviceSearchEngine(index2.fmd, params, lanes=args.lanes,
                                  big=True, packed_hits=True, **kw)

    rows2 = check_kernels_big(torch, np, big_engine(), reads2)
    engine2 = big_engine()
    assert engine2.device_index.big and engine2.deep_tier_enabled()
    rows.update(rows2)
    path_of.update({name: 2 for name in rows2})

    dev_bam2 = os.path.join(WORK, "device2.bam")
    LAUNCHES.reset()
    torch.cuda.synchronize()
    t = time.perf_counter()
    pipeline.run(fastq2, fasta2, dev_bam2, True, params, None,
                 engine=engine2, position_seed=args.seed,
                 cmdline="mapad map", threads=os.cpu_count() or 1,
                 index=index2)
    torch.cuda.synchronize()
    dev_s = time.perf_counter() - t
    launches2 = {k: LAUNCHES.get(k) for k in rows2
                 if k != "pool_compact_i64"}
    stats2 = engine2.stats()
    rows["pool_search_i64"]["steps"] = stats2["steps"]
    report_run("path 2, pipeline.run big=True", card, dev_s, stats2,
               launches2)
    check_k2_launches(launches2, "path 2", sfx="_i64")
    launches.update(launches2)
    native_map_and_compare(cli, fastq2, fasta2, dev_bam2,
                           os.path.join(WORK, "native2.bam"), "path 2")
    deep_blocks = stats2.get("deep_retried", 0)
    if not deep_blocks:
        # the workload abandoned too few reads with hits for a deep block:
        # a short second run with a starved primary cap makes some
        log("path 2 ran no deep block; a second run of one block with a "
            "primary cap of 256")
        short = big_engine(pool_config=engine2.pool_config._replace(
            read_step_cap=256))
        from mapad_tpu_torch.map.record import Record

        out = short.search_chunk(
            [Record(sequence=s, base_qualities=q)
             for s, q in reads2[:BLOCK2_READS]])
        deep_blocks = short.stats().get("deep_retried", 0)
        log(f"  {len(out)} reads, stats {short.stats()}")
    if not deep_blocks:
        raise AssertionError("no deep block ran on path 2")

    from mapad_tpu_torch.map.native_search import NativeSearchEngine
    from mapad_tpu_torch.map.record import Record
    from mapad_tpu_torch.ops import search_pool2 as sp2

    native_bam = os.path.join(WORK, "native.bam")
    path1 = [k for k, v in path_of.items() if v == 1 and k != "pool_compact"]
    map_argv = ["--threads", "0", "map", "-r", fastq, "-g", fasta,
                "--force_overwrite", *MAP_FLAGS]

    # --- path 3: the default engine (hybrid) on path 1's workload ---
    hyb_bam = os.path.join(WORK, "hybrid.bam")
    tap.stats = None
    LAUNCHES.reset()
    torch.cuda.synchronize()
    t = time.perf_counter()
    if cli.main([*map_argv, "-o", hyb_bam]) != 0:
        raise SystemExit("hybrid map failed")
    torch.cuda.synchronize()
    dev_s = time.perf_counter() - t
    stats3 = tap.stats
    if stats3 is None or "device_fraction" not in stats3:
        raise AssertionError("map with no --engine did not run the hybrid "
                             "engine")
    launches3 = {k: LAUNCHES.get(k) for k in path1}
    report_run("path 3, map (default engine: hybrid)", card, dev_s, stats3,
               launches3)
    check_k2_launches(launches3, "path 3")
    log(f"  device fraction at the end {stats3['device_fraction']:.3f}; "
        f"reads searched by the device engine "
        f"{stats3['hybrid_device_reads']}, by the native engine "
        f"{stats3['hybrid_native_reads']}")
    if not stats3["hybrid_native_reads"]:
        raise AssertionError("the hybrid engine gave the host no reads")
    bam_compare(hyb_bam, native_bam, "path 3")
    # the same with two native threads instead of all cores but two: does
    # the native pool take the cores the device side's prep needs?
    tap.stats = None
    t = time.perf_counter()
    if cli.main(["--threads", "2", *map_argv[2:], "-o", hyb_bam]) != 0:
        raise SystemExit("hybrid map with two threads failed")
    dev_s2 = time.perf_counter() - t
    st = tap.stats
    log(f"path 3 with --threads 2: {N_READS / dev_s2:.1f} reads/s "
        f"({N_READS / dev_s:.1f} with --threads 0 just before), prep_s "
        f"{st['prep_s']:.3f} ({stats3['prep_s']:.3f}), device_s "
        f"{st['device_s']:.3f} ({stats3['device_s']:.3f}), fraction "
        f"{st['device_fraction']:.3f}, native reads "
        f"{st['hybrid_native_reads']}")
    bam_compare(hyb_bam, native_bam, "path 3 with --threads 2")

    # --- path 4: store generations (K8) on the main path ---
    gen_bam = os.path.join(WORK, "generations.bam")
    tap.stats = None
    LAUNCHES.reset()
    torch.cuda.synchronize()
    t = time.perf_counter()
    with _Env(MAPAD_KGENS="4", MAPAD_KGENS_MIN_LIVE="1"), \
            _BoundaryTap(sp2) as k8_tap:
        if cli.main([*map_argv, "-o", gen_bam, "--engine", "device"]) != 0:
            raise SystemExit("device map with store generations failed")
    torch.cuda.synchronize()
    dev_s = time.perf_counter() - t
    stats4 = tap.stats
    launches4 = {k: LAUNCHES.get(k) for k in [*path1, "pool_compact"]}
    report_run("path 4, map --engine device, MAPAD_KGENS=4 "
               "MAPAD_KGENS_MIN_LIVE=1 (MAPAD_SPILL 768)", card, dev_s,
               stats4, launches4)
    ev4 = k8_tap.take()
    per = launches_per_boundary(launches4["pool_compact"],
                                [c for c, _ in ev4], "path 4")
    check_k2_launches(launches4, "path 4", boundaries=len(ev4))
    log(f"  K8 ran {len(ev4)} boundaries ({per} launches each, counted; "
        f"{median([a.elapsed_time(b) for _, (a, b) in ev4]):.4f} ms a "
        f"boundary); unfinished {stats4['esc_why']['unfinished']} "
        f"(path 1: {stats['esc_why']['unfinished']}), steps "
        f"{stats4['steps']} (path 1: {stats['steps']})")
    bam_compare(gen_bam, native_bam, "path 4")
    launches["pool_compact"] = launches4["pool_compact"]
    path_of["pool_compact"] = 4

    # one 4096-read block of path 2's workload in big mode
    recs2 = [Record(sequence=s, base_qualities=q)
             for s, q in reads2[:BLOCK2_READS]]
    t = time.perf_counter()
    want2 = NativeSearchEngine(index2.fmd, params,
                               packed_hits=True).search_chunk(recs2)
    log(f"path 4: native engine on {len(recs2)} reads of workload 2 "
        f"{time.perf_counter() - t:.2f} s")
    LAUNCHES.reset()
    with _Env(MAPAD_DEEP_LANES=str(DEEP_LANES), MAPAD_RETRY_MIN=DEEP_MIN), \
            _BoundaryTap(sp2) as k8_tap:
        eng = big_engine()
        deep = eng._deep_config()
        assert (deep.lanes, deep.total_steps, deep.read_step_cap,
                deep.generations) == DEEP_SHAPE, deep
        st = block_against_native(
            np, eng, recs2, want2,
            f"path 4, big mode, MAPAD_DEEP_LANES={DEEP_LANES} "
            f"MAPAD_RETRY_MIN={DEEP_MIN}")
    if not st.get("deep_retried"):
        raise AssertionError("path 4: no read took the narrow deep config")
    log(f"  the narrow deep blocks (L, S, CAP, generations = {DEEP_SHAPE}) "
        f"ran {len(k8_tap.take())} boundaries "
        f"({LAUNCHES.get('pool_compact_i64')} K8 launches)")
    with _Env(MAPAD_DEEP_LANES=str(DEEP_LANES), MAPAD_RETRY_MIN=DEEP_MIN,
              MAPAD_NOHIT_PROBE="1"):
        st = block_against_native(
            np, big_engine(), recs2, want2,
            f"path 4, big mode, MAPAD_DEEP_LANES={DEEP_LANES} "
            f"MAPAD_NOHIT_PROBE=1")
    log(f"  probe_empty {st.get('probe_empty', 0)} of nohit_host "
        f"{st.get('nohit_host', 0)}")
    if not st.get("nohit_host"):
        raise AssertionError("path 4: the no-hit probe saw no read")
    deep_launches = LAUNCHES.get("pool_compact_i64")
    with _Env(MAPAD_KGENS="4", MAPAD_KGENS_MIN_LIVE="1",
              MAPAD_POOL_STEPS=str(PATH4_BIG_STEPS),
              MAPAD_RETRY_MIN=DEEP_MIN), _BoundaryTap(sp2) as k8_tap:
        eng = big_engine()
        assert eng.pool_config.generations == 4
        block_against_native(
            np, eng, recs2, want2,
            f"path 4, big mode, MAPAD_KGENS=4 MAPAD_KGENS_MIN_LIVE=1 "
            f"MAPAD_POOL_STEPS={PATH4_BIG_STEPS}")
    launches["pool_compact_i64"] = LAUNCHES.get("pool_compact_i64")
    path_of["pool_compact_i64"] = 4
    ev4b = k8_tap.take()
    per = launches_per_boundary(
        launches["pool_compact_i64"] - deep_launches, [c for c, _ in ev4b],
        "path 4, big mode")
    log(f"  K8 launches in int64 on path 4: {launches['pool_compact_i64']} "
        f"({deep_launches} of them in the narrow deep blocks): {len(ev4b)} "
        f"boundaries of {per} launches (counted)")
    del index2, want2

    # --- path 5: the bidirectional search (a center-start model) ---
    index1 = load_index(fasta)
    recs5 = [Record(sequence=s, base_qualities=q)
             for s, q in reads[:PATH5_READS]]
    want5 = NativeSearchEngine(index1.fmd, vparams,
                               packed_hits=True).search_chunk(recs5)
    for big in (False, True):
        name = "pool_search_bidir" + ("_i64" if big else "")
        eng = DeviceSearchEngine(index1.fmd, vparams, lanes=args.lanes,
                                 big=big, packed_hits=True)
        rows[name] = bidir_check(torch, sp2, eng, reads, big)
        LAUNCHES.reset()
        st = block_against_native(
            np, eng, recs5, want5,
            f"path 5, VindijaPwm, {'int64' if big else 'int32'} intervals")
        launches[name] = LAUNCHES.get(name)
        rows[name]["steps"] = st["steps"]
        path_of[name] = 5
        log(f"  kernel launches on this path: {name} {launches[name]}")
        if not launches[name]:
            raise AssertionError(f"path 5: {name} did not launch")
        sfx = "_i64" if big else ""
        check_k2_launches(
            {k: LAUNCHES.get(k) for k in (name, "extend_batch" + sfx,
                                          "bi_d" + sfx)},
            f"path 5 {name}", sfx=sfx, name=name)

    # --- path 6: the fixed-batch engine (K7 in int32, K10) ---
    recs6 = [Record(sequence=s, base_qualities=q) for s, q in reads]
    t = time.perf_counter()
    want6 = NativeSearchEngine(index1.fmd, params,
                               packed_hits=True).search_chunk(recs6)
    log(f"path 6: native engine on {len(recs6)} reads "
        f"{time.perf_counter() - t:.2f} s")
    # the same search_chunk span on the same reads through the pool engine
    # at its defaults, the yardstick of the batch engine's numbers
    pool6 = block_against_native(
        np, DeviceSearchEngine(index1.fmd, params, packed_hits=True), recs6,
        want6, "path 6, the same reads through the pool engine")
    for tiers in (None, PATH6_TIERS):
        counts, steps6 = batch_path(
            np, DeviceSearchEngine(index1.fmd, params, mode="batch",
                                   packed_hits=True,
                                   **({"tiers": tiers} if tiers else {})),
            recs6, want6, tuple(rows6), pool6)
        if tiers is None:
            rows6["search_batch"]["path_steps"] = steps6
            rows.update(rows6)
            launches.update(counts)
            path_of.update({name: 6 for name in rows6})

    # --- path 7: the pool search over two shards on the card (K9) ---
    launches7, steps7 = path7(torch, index1, params, args, fastq, fasta,
                              native_bam, card, path1)
    for name in path1:
        rows[name]["path7_launches"] = launches7[name]
    rows["pool_search"]["path7_steps"] = steps7
    rows["shard_rebase"]["path7_launches"] = launches7["shard_rebase"]
    rows["pack_result"]["path7_rebase_launches"] = \
        launches7["pack_result_rebase"]
    launches["shard_rebase"] = rows["shard_rebase"]["k9_launches"]
    log(f"  path 1 (`cli.main` whole) in this run: "
        f"{N_READS / path1_s:.1f} reads/s")

    # --- path 8: multi-host mapping, two processes on this machine ---
    path8(cli, fasta, fastq, native_bam, args.seed)

    # --- path 9: distributed mode, two workers on the card ---
    launches9 = path9(torch, cli, fasta, fastq, card, path1)
    # --- path 10: CRAM input against a mapAD-native index ---
    launches10 = path10(torch, cli, fasta, reads, native_bam, card, path1,
                        tap)
    for name in path1:
        rows[name]["path9_launches"] = launches9[name]
        rows[name]["path10_launches"] = launches10[name]

    # --- the profiler's card times of K3 and K6, then the probe phase:
    # P1-P4, on no mapping path; last, so that the profiler they run
    # cannot touch any path's timing ---
    card_times(torch)
    probe_rows, probe_launches = probe_phase(torch, card)
    rows.update(probe_rows)
    launches.update(probe_launches)
    path_of.update({name: "probes" for name in probe_rows})
    k2_floors(rows, probe_rows["probe_dma"]["step_tables"], card)
    return finish(torch, rows, launches, path_of, card, t_start)


def k2_floors(rows, tables, card):
    """Each K2 row's floor: its check's steps at P1's one-launch us a step
    over the same index table (int32 forms: path 1's rows; int64: path
    2's; the bidirectional int64 check runs on path 1's genome, whose int64
    rows are path 1's table in size), from this run's probe phase."""
    by_what = {t["what"]: t for t in tables}
    for name, row in rows.items():
        if not name.startswith("pool_search") or "check_steps" not in row:
            continue
        table = by_what["path 2's index rows" if name == "pool_search_i64"
                        else "path 1's index rows"]
        row["floor_us_step"] = table["one_launch_us"]
        row["floor_ms"] = row["check_steps"] * table["one_launch_us"] / 1e3
        row["limit"] = ("floor" if row["floor_ms"] > row["bound_ms"]
                        else "bytes")
        log(f"K2 {name}: {row['us_step']:.3f} us a step against P1's "
            f"one-launch floor {table['one_launch_us']:.3f} at "
            f"{table['what']} ({row['ms'] / row['floor_ms']:.2f}x it) and "
            f"the bytes bound "
            f"{row['bound_ms'] * 1e3 / row['check_steps']:.4f}; {card}")


def finish(torch, rows, launches, path_of, card, t_start) -> int:
    """Print the kernel table and the last line."""
    keys = ("route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    # `path`: the run whose launches the row counts; pool_search rows also
    # carry `steps`, the pool steps that run took (their launches: one init
    # an invocation and one cooperative launch a store generation), their
    # check's steps, us a step, launch plan and ptxas figures, and P1's
    # one-launch floor for the check's steps (`floor_ms`, `floor_us_step`;
    # `limit` names the larger of floor and bytes bound); pool_compact rows the
    # boundaries of their check, the launches of one boundary, and their
    # time at a shape of the main path; search_batch its check's `steps`,
    # the keys of the popped chunks it reads (`scan_bytes`, 4 x the chunk
    # width a lane-step) and their time at the memory rate (`scan_ms`,
    # beyond its bound), its longest lane's steps (`max_lane_steps`), its
    # time over them (`us_step`), its launch plan and ptxas figures, the
    # same four and its time on the center-start check (`center_*`) and the
    # steps of each batch of path 6; shard_rebase (path "K9": its launches
    # those of K9's call at path 7's block, `k9_launches`) its time split
    # (`host_ms`, `device_ms`, `launches_per_call`), its launches in path
    # 7's two-shard run (`path7_launches`, 0: a shard's K5 rebases) and
    # K9's numbers: its reads, each shard's steps, its time, plain time and
    # bound, and the time of the same shards run one after the other, at
    # the check's shape and (k9_main_*) at path 7's block; the rows of path
    # 1's kernels also carry their launches in path 7's two-shard run
    # (`path7_launches`, its own reset run) and in paths 9 (the in-process
    # worker's) and 10 (`path9_launches`, `path10_launches`), pool_search
    # also its shards'
    # steps (`path7_steps`: one launch a generation plus one init per shard
    # and invocation), pack_result its rebasing launches there
    # (`path7_rebase_launches`, one a shard and block) and its time with a
    # shard's rebase (`rebase`: events, host, card); the probe rows (path "probes", launches from the probe
    # tools' run) P1's per-step times at three tables in three forms, its
    # launch-per-step time and latency floor (T dependent loads), the copies' device times from the profiler (and
    # an empty kernel's, `floor_device_ms`), the shape of their headline,
    # every probe shape's numbers and their PTX and SASS instruction counts; the bi_d rows the walk steps of their run,
    # their launch plan (with the resident warps an SM) and ptxas figures,
    # bi_d_i64 also the same for both parts (`both_*`); the extract_chains
    # rows (K3) and unpack_prep_full (K6) their time split: `device_ms`
    # (the profiler's card time), `host_ms` (the wrapper on the host) and
    # their launches a call; K3 also its deepest walked chain (op words),
    # the dependent-load latency (`load_ns`) and their product, the walk's
    # floor (`walk_floor_ms`), its launch plan and ptxas figures
    more = ("steps", "boundaries", "launches_per_boundary", "main_shape",
            "main_ms", "main_bound_ms", "main_launches_per_boundary",
            "scan_bytes", "scan_ms", "max_lane_steps", "center_ms",
            "center_max_lane_steps", "center_us_step", "center_plan",
            "path_steps",
            "path7_launches", "path7_steps", "path7_rebase_launches",
            "path9_launches", "path10_launches",
            "rebase", "k9_launches", "k9_reads", "k9_steps", "k9_ms",
            "k9_plain_ms", "k9_bound_ms", "k9_sequential_ms",
            "k9_main_reads", "k9_main_steps", "k9_main_ms",
            "k9_main_bound_ms", "k9_main_sequential_ms",
            "check_steps", "us_step", "plan", "ptxas", "floor_ms",
            "floor_us_step", "limit",
            "launch_per_step_ms", "step_tables", "latency_floor_ms",
            "also_replaces", "device_ms",
            "library_device_ms", "floor_device_ms", "shape", "ptx_sass",
            "shapes",
            "walk_steps", "both_ms", "both_walk_steps", "both_bound_ms",
            "both_plan", "host_ms", "launches_per_call", "walk_floor_ms",
            "deepest_chain", "load_ns")
    table = [
        {"name": name, **{k: dict(row, launches=launches[name])[k]
                          for k in keys},
         "path": path_of[name], **{k: row[k] for k in more if k in row}}
        for name, row in rows.items()
    ]
    log(f"total: {time.perf_counter() - t_start:.1f} s")
    log(card)
    print(json.dumps({"kernels": table}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
