#!/usr/bin/env python3
"""Smoke run of mapad_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from csrc/ (one nvcc per source, all at
once), holds every kernel bit for bit against its plain PyTorch version on
the card at its path's shapes, then drives two paths:

  path 1 (small genome, int32): generate a 4 Mbp repeat-rich genome and
  16,384 aDNA-damaged reads from a seed (bench.py's generators, copied) ->
  `index` -> `map --engine device` through the CLI (two 8192-read blocks
  through the streaming driver; kernels K4, K2 with K1 inline, K3, K5);

  path 2 (big-genome mode forced, int64): a second, larger genome with its
  own reads -> `index` -> `pipeline.run` with
  `DeviceSearchEngine(fmd, params, big=True, packed_hits=True)` at the
  big-mode defaults (Bi-D on the card, 4096-read blocks, deep tier on, full
  width; kernels K6, K7 and the int64 forms of K1, K2, K3, K5).

Each path's reads are mapped again with `map --engine native` (the exact
host C++ search); the two BAMs must be equal record for record except XD (a
timing).  The launch counts are set to 0 just before each path is driven
and read just after.

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
import subprocess
import sys
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
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


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
    torch.cuda.synchronize()
    t = time.perf_counter()
    state = sp2._pool_loop_cuda(*args)
    torch.cuda.synchronize()
    k2_ms = (time.perf_counter() - t) * 1e3
    res = sp2._extract_chains_cuda(*state, cfg)
    k3_ms = timed(torch, lambda: sp2._extract_chains_cuda(*state, cfg), 5)
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
    n_ext = min(int(res.n_chains), cfg.max_chains)
    walked = int((res.c_ops[:n_ext] != 0).sum())
    # K2 must read the index rows, the LUT/Bi-D rows and the consts once,
    # write the frame store blocks (9 frames of 8 words, 11 with int64
    # intervals), masks and finish log of its steps, and in every step read
    # each lane's ring of pop keys (4 B per ring slot) to find the best entry
    frame_words = 11 if big else 8
    RB = min(cfg.total_steps, cfg.read_step_cap + 1)
    ring_bytes = steps * L * 4 * RB
    k2_bytes = (nbytes(idx_d.rows, *consts, slut)
                + steps * L * (9 * frame_words + 1 + 1) * 4 + ring_bytes)
    # K3 reads the masks, finish log and the frame records it walks, and
    # writes the PoolResult
    k3_bytes = steps * L * 8 + walked * frame_words * 4 + nbytes(*res)
    rows = {}
    rows["pool_search" + sfx] = dict(
        route="cuda", source="mapad_tpu_torch/csrc/pool_search.cu",
        replaces="mapad_tpu/ops/search_pool2.py:81", max_abs_err=err,
        ms=k2_ms, plain_ms=k2_plain_ms, bound_ms=bound_ms(k2_bytes),
        bound_by="bytes", library_ms=None,
    )
    rows["extract_chains" + sfx] = dict(
        route="cuda", source="mapad_tpu_torch/csrc/extract_chains.cu",
        replaces="mapad_tpu/ops/search_pool2.py:617", max_abs_err=err,
        ms=k3_ms, plain_ms=k3_plain_ms, bound_ms=bound_ms(k3_bytes),
        bound_by="bytes", library_ms=None,
    )
    scan_ms = bound_ms(ring_bytes)
    log(f"K2+K3{sfx} L={L} S={cfg.total_steps} CAP={cfg.read_step_cap} "
        f"C={cfg.max_chains} M={M} on {r} reads: bit-exact; {steps} steps, "
        f"{int(res.n_chains)} chains; K2 {k2_ms:.1f} ms "
        f"({k2_ms * 1e3 / max(steps, 1):.2f} us/step; ring-scan bound "
        f"{scan_ms * 1e3 / max(steps, 1):.2f} us/step), plain "
        f"{k2_plain_ms:.1f} ms; K3 {k3_ms:.3f} ms, plain {k3_plain_ms:.1f} ms")

    # K5 on that result
    packed = eng._pack_result(res)
    err = compare(torch, (packed,), (eng._pack_result_plain(res),),
                  "pack_result" + sfx)
    rows["pack_result" + sfx] = dict(
        route="cuda", source="mapad_tpu_torch/csrc/pack_result.cu",
        replaces="mapad_tpu/ops/engine.py:1591", max_abs_err=err,
        ms=timed(torch, lambda: eng._pack_result(res), 20),
        plain_ms=timed(torch, lambda: eng._pack_result_plain(res), 5),
        bound_ms=bound_ms(nbytes(*res, packed)), bound_by="bytes",
        library_ms=None,
    )
    log(f"K5 pack_result{sfx} C={cfg.max_chains}: bit-exact, "
        f"{rows['pack_result' + sfx]['ms']:.4f} ms (plain "
        f"{rows['pack_result' + sfx]['plain_ms']:.4f} ms)")
    return rows


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
    rows["unpack_prep"] = dict(
        route="cuda", source="mapad_tpu_torch/csrc/unpack_prep.cu",
        replaces="mapad_tpu/ops/engine.py:231", max_abs_err=err,
        ms=timed(torch, k4, 20), plain_ms=timed(torch, k4_plain, 3),
        bound_ms=bound_ms(nbytes(blob, parts[5]) + touched * 16),
        bound_by="bytes", library_ms=None,
    )
    log(f"K4 unpack_prep R={R} M={M} rle: bit-exact, "
        f"{rows['unpack_prep']['ms']:.4f} ms (plain "
        f"{rows['unpack_prep']['plain_ms']:.4f} ms)")

    idx_d = engine.device_index
    rows["extend_batch"] = k1_check(torch, fm, idx_d, "extend_batch",
                                    "extend_batch")

    # K2 + K3 + K5 at full width on the block's first CHECK_READS reads
    r = CHECK_READS
    rows.update(pool_check(
        torch, sp2, eng, idx_d, tuple(p[:r] for p in parts[:5]),
        parts[5][: r * M], engine._params(), cfg, M, False,
    ))
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
    rows["unpack_prep_full"] = dict(
        route="cuda", source="mapad_tpu_torch/csrc/unpack_prep.cu",
        replaces="mapad_tpu/ops/engine.py:292", max_abs_err=err,
        ms=timed(torch, k6, 20), plain_ms=timed(torch, k6_plain, 3),
        bound_ms=bound_ms(nbytes(blob, rank, code, score_lut, pen)
                          + touched * 20),
        bound_by="bytes", library_ms=None,
    )
    log(f"K6 unpack_prep_full R={R} M={M}: bit-exact, "
        f"{rows['unpack_prep_full']['ms']:.4f} ms (plain "
        f"{rows['unpack_prep_full']['plain_ms']:.4f} ms)")

    # K7 at R=4096, M=128: the main path's backward part, then both parts
    steps = prep["bid_steps"]

    def k7(fwd=cfg.compute_forward_part):
        return bi_d.compute_bi_d(idx_d, rank, pen, n, split, fwd, steps)

    def k7_plain(fwd=cfg.compute_forward_part):
        return bi_d.compute_bi_d_plain(idx_d, rank, pen, n, split, fwd,
                                       steps)

    bid = k7()
    err = compare(torch, (bid,), (k7_plain(),), "bi_d")
    # a second split puts reads into both parts, for the forward part
    half = torch.div(n, 2, rounding_mode="floor").to(torch.int32)
    n_h, half_h = n.cpu(), half.cpu()
    steps2 = (int(half_h.max()), int((n_h - half_h).max()))
    both = bi_d.compute_bi_d(idx_d, rank, pen, n, half, True, steps2)
    err = max(err, compare(
        torch, (both,),
        (bi_d.compute_bi_d_plain(idx_d, rank, pen, n, half, True, steps2),),
        "bi_d (both parts)"))
    # the walk steps this block's data needs: walk w of a part of length p
    # takes max(0, p - w) steps, two 512 B index rows each
    sp = split.cpu().long()
    walk_steps = int(sum(torch.clamp(sp - w, min=0).sum()
                         for w in range(bi_d.MAX_OFFSET)))
    k7_bytes = (nbytes(rank, pen, n, split, bid)
                + min(nbytes(idx_d.rows), walk_steps * 2 * 512))
    rows["bi_d"] = dict(
        route="cuda", source="mapad_tpu_torch/csrc/bi_d.cu",
        replaces="mapad_tpu/ops/bi_d.py:27", max_abs_err=err,
        ms=timed(torch, k7, 10), plain_ms=timed(torch, k7_plain, 1),
        bound_ms=bound_ms(k7_bytes), bound_by="bytes", library_ms=None,
    )
    log(f"K7 bi_d R={R} M={M} ({R * bi_d.MAX_OFFSET} walks, {walk_steps} "
        f"walk steps, longest parts {steps}): bit-exact with and without "
        f"the forward part, {rows['bi_d']['ms']:.4f} ms (plain "
        f"{rows['bi_d']['plain_ms']:.1f} ms)")

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
    rows.update(pool_check(
        torch, sp2, eng, idx_d,
        tuple(p[:r].contiguous() for p in (n, split, scale, thresh, repr_mm)),
        slut[: r * M].contiguous(), engine._params(), cfg, M, True,
    ))
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
    dh, dr = bam_records(dev_bam)
    nh, nr = bam_records(nat_bam)
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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import numpy as np

    from mapad_tpu_torch import _build, cli
    from mapad_tpu_torch._build import LAUNCHES
    from mapad_tpu_torch.index import load_index
    from mapad_tpu_torch.map import pipeline
    from mapad_tpu_torch.ops.engine import DeviceSearchEngine

    t_start = time.perf_counter()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(card)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")

    t = time.perf_counter()
    logs = _build.build_cuda(verbose=True)
    for name in ("searcher", "postprocess", "sais"):
        _build.host_library(name, ["-pthread"] if name == "postprocess"
                            else [])
    log(f"build: {time.perf_counter() - t:.1f} s (nvcc for "
        f"{sorted(logs) or 'none: cached'})")
    for name, text in sorted(logs.items()):
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")

    os.makedirs(WORK, exist_ok=True)
    args = cli.build_parser().parse_args(
        ["map", "-r", "x", "-g", "x", "-o", "x", *MAP_FLAGS])
    params = cli.build_alignment_parameters(args)

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
    launches = {k: LAUNCHES.get(k) for k in rows}
    stats = tap.stats
    if stats is None:
        raise AssertionError("the device map logged no search stats")
    rows["pool_search"]["steps"] = stats["steps"]
    report_run("path 1, map --engine device", card, dev_s, stats, launches)
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
    launches2 = {k: LAUNCHES.get(k) for k in rows2}
    stats2 = engine2.stats()
    rows["pool_search_i64"]["steps"] = stats2["steps"]
    report_run("path 2, pipeline.run big=True", card, dev_s, stats2,
               launches2)
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

    keys = ("route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    # `path`: the run whose launches the row counts; pool_search rows also
    # carry `steps`, the pool steps that run took (their launches are two
    # per step queued, plus one per invocation)
    table = [
        {"name": name, **{k: dict(row, launches=launches[name])[k]
                          for k in keys},
         "path": path_of[name],
         **({"steps": row["steps"]} if "steps" in row else {})}
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
