#!/usr/bin/env python3
"""Smoke run of mapad_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --path7   # path 7 alone (a machine of several cards)
    python3 chip_smoke.py --probes  # the probe phase alone (P1-P4)
    python3 chip_smoke.py --knobs   # the knobs phase alone (path 1's index)
    python3 chip_smoke.py --configs # path 14 alone: mapAD's other map
                                    # settings on path 1's genome
    python3 chip_smoke.py --big-text [SIZE]  # path 11 alone: a genome of
                                    # SIZE bp (1.1e9), its text past 2^31
    python3 chip_smoke.py --assembly [SCALE]  # path 12 alone: a GRCh37-
                                    # shaped assembly (86 sequences, N runs,
                                    # IUPAC runs) at SCALE (1: past 2^31)
    python3 chip_smoke.py --cards [SCALE] [--phases abcd]  # path 13
                                    # alone: a node of two cards or more
                                    # (the assembly at SCALE)
    python3 chip_smoke.py --long [SCALE] [--phases ab]  # path 15
                                    # alone: runs of a user's length ((a)
                                    # 524,288 reads; (b) the assembly at
                                    # SCALE, 262,144 reads)
    python3 chip_smoke.py --inputs [SCALE] [--phases abcd]  # path 16
                                    # alone: mapAD's input as its users
                                    # supply it (an unaligned pipeline
                                    # BAM, stdin, .fastq.gz, the
                                    # dispatcher)

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

After path 2, the rows past 2^32: a synthetic big-mode table of 4.4e9
symbols made on the card (tools/big_rows.py `synthetic_index`: 4,741,380
rows, 2.43 GB; random ranks from a seed, no genome, no index build), and
on it, each against its plain version and timed beside the same call on
path 2's rows: K1 in int64 (`occ4_batch` on 65,536 ranks and
`extend_batch` on as many intervals, the first and last rows, the ranks
around 2^31, 2^32 and n - 1 among them), K7 in int64 on 256 random reads
at M = 128 (both parts), and K2 in int64 at a fixed step count, then K3
and K5 on its result, on 512 of path 2's reads made the table's own
strings (LF walks) and prepared by path 2's engine; the largest hit
`lower` K3 returns must pass 2^32.  The table holds seeded X runs (rank 5,
a genome's long N runs) of 20 bp to 50 kbp, about one a Mbp; a quarter of
K1's ranks sit on its X symbols (read from the rows), and K1's and K7's
queries that read a row holding X are counted: each must have some.

Then the small assembly: tools/assembly.py's GRCh37-shaped assembly at
0.0075 of its size (8.3 Mbp: hs37d5's 86 sequences, long N runs that the
index makes X, short IUPAC runs whose bases it replaces and keeps in
OriginalSymbols) and N_READS of its reads (a tenth of them at N-run edges,
on short runs and at sequence joins; some carry N), indexed by the CLI;
on its rows K1 in both widths (ranks on X symbols), K4, K6, K7 (walks into
the X runs) and K2 at a fixed step count with K3 and K5 in both widths,
each against its plain version; then `map --engine device` (int32) and
`pipeline.run` with `big=True` and MAPAD_RETRY_TIER=1 (the step budget
starved where the defaults retry nothing), each BAM equal to `map --engine
native`'s and held to the assembly's invariants (the header's 86
sequences, no record on an X or across a sequence's end, M-only records'
mismatches equal to NM, MD's original symbols on replaced bases), and the
host searcher's hits at the joins located as the BAM conversion does.

Path 11 (`--big-text [SIZE]`, alone, not in the default run: its index
build takes minutes): `gen_genome(SIZE)` (1.1e9 by default: a text of
2,200,000,002 symbols) as contigs of 50 Mbp, indexed by the CLI into
.smoke/big_text/ (reused there for the same size and seed; the build's
seconds and the CLI process's own host peak printed), the rows' host
peak at load (`from_host`, by chunks), then 16,384 of its reads through
`map --engine native`, `map --engine device` with nothing forcing big
mode (the engine must choose it; K6, K7 and the int64 K1, K2, K3, K5 must
launch, no int32 form) and `map` (hybrid), the last two BAMs equal to the
first (XD aside); the native BAM is held to the genome as path 12's is
(header, NM, MD) and its records past text position 2^31 are counted
(there must be some); last `tools/measure_big.py` on the loaded index.

Path 12 (`--assembly [SCALE]`, alone: its index build takes minutes):
the assembly above at SCALE (1 by default: 1,106,352,191 bp, a text of
2,212,704,384 symbols, past 2^31; chromosomes 1-5 at GRCh37's lengths,
6-22, X and Y at a thousandth of theirs), indexed by the CLI into
.smoke/assembly/ (the build's seconds and host peak printed), then 16,384
of its reads through `map --engine native`, `map --engine device` (the
engine chooses big mode), `map` (hybrid) and `map --engine device` with
MAPAD_RETRY_TIER=1, every BAM equal to the native one and held to the
assembly's invariants; some MD tag must carry an original IUPAC symbol
past text position 2^31.

Path 13 (`--cards [SCALE] [--phases LETTERS]`, alone: a node of two
cards or more, which it refuses to run without; the phases named, all by
default): (a) path 1's workload at CARDS_READS reads (bench.py's whole
65,536, so that every layout fills its blocks) through `pipeline.run` with
the pool engine on one card, over `make_mesh(2)` and over the automatic
mesh of every card, in turns and back, then `map` with no `--engine` (the
hybrid over every card), each with its reads/s, stage seconds, shard steps
and each card's peak memory; (b) K9's API over every card and over two in
both widths at a full block, against its shards run one after the other,
with the block's step efficiency, and over every card against its plain
version (the int64 block; int32 at n x 512 reads); (d) `run_multihost`
with a process per card (CUDA_VISIBLE_DEVICES) and per pair of cards, and
`map --dispatcher` with a `worker --device cuda:i` per card, over
8,192-read chunks, each process or worker held to its layout; then (c)
the assembly at SCALE (path 12's; its index built after (d); big mode
chosen by the engine at 1, forced below 2^31) through `map --engine
native`, then `--engine device` and the hybrid over every card, each
card's peak above its replica of the rows.  Every BAM equals the native
one of the same chunks; the assembly's are held to its invariants.

Path 14 (`--configs`, alone): mapAD's other `map` settings
(mapad_tpu_torch/tools/configs.py), each as CLI flags replacing or joining
MAP_FLAGS: a double-stranded library (`ds`), the Continuous bound `-c 0.15
-e 1.0` in place of `-p` (`cutoff`), `--ignore_base_quality`, the gap
settings (0, 1), (10, 3) and no gap at all, `--no_search_limit_recovery`
and `-R`.  Path 1's genome and N_READS reads of each library (the
double-stranded setting's with G->A at the 3' end) with indels at
CONFIG_INDEL_RATE a base; under MAP_FLAGS first (the yardstick of
reads/s), then under each setting, `map --engine native` and `map --engine
device` twice (cold, with the setting's score table built, then warm;
for `ds` and `cutoff` also the hybrid and big mode forced), each BAM
equal to the native one (the `-R` header line and RG tags checked; no
record with a gap without gaps, records with an insertion and with a
deletion where MAP_FLAGS' gap open rate allows them); then one block's
kernels against their plain versions in both widths (up to half of
them reads whose native record holds a gap): K4, or K6 and K7,
then K2 at CONFIG_FIXED steps, K3 and K5, with the hits whose chains hold
an insertion or a deletion counted; K10 and the int32 K7 for the bound
and gap settings.  The default run holds the same kernels of `cutoff` (a
bound scale of len^e, not 1) and `gaps_0_1` on path 1's index after path
6 (K2 at CONFIG_DEFAULT_FIXED steps).

Path 15 (`--long [SCALE]`, alone): runs of a user's length at mapAD's
default --batch_size (250,000 reads a sheet, so that every sheet ends in
a short block in the middle of the stream).  (a) path 1's genome and
524,288 of its reads with indels at CONFIG_INDEL_RATE (three sheets),
after their first 16,384 (path 1's length, the yardstick of reads/s):
`map --engine native`, `--engine device` and the hybrid through the CLI;
(b) the assembly at SCALE (0.0075 by default: big mode forced; 1: chosen
by the engine) and 262,144 of its reads (two sheets), the deep tier at
its default (on).  Every BAM equals the native one over every read, (b)'s
held to the assembly's invariants; at each sheet boundary
(tools/sheets.py `SheetWatch`) the card's allocated bytes between blocks
and its reserved bytes stay within 64 MiB of the first sheet's end and
the host's RSS within 5%; the Python threads after each run are those
after the first; each kernel's launches are what the run's input and
tier blocks imply; in (b) a deep block is prepared before the input runs
out.  Printed: reads/s of each run and each sheet, stage seconds,
escalations by cause, the tier blocks before and after the input ran
out, the hybrid's device fraction at each sheet's end and its reads on
each side, the memory readings, the launches.  The default run holds a
short form after path 1: 24,576 reads at --batch_size 10,000 (sheets of
10,000, 10,000 and 4,576) through `--engine device` and `--engine
native`, the same checks (`sheets_launches` in path 1's rows).

Path 16 (`--inputs [SCALE]`, alone): mapAD's input as its users supply
it, through the CLI at its defaults.  tools/pipeline_bam.py writes an
unaligned pipeline BAM from a seed: merged reads, unmerged pairs (R1 0x4D,
R2 0x8D; mates of 76 and 150 bp, the 150 bp ones longer than the pool's
max_len and escalated as overlong), QC-failed reads, reads stored
reverse-complemented under 0x10 beside their forward twins, reads holding
`=` and IUPAC codes, zero-length records, a run of quality-less records
(QUAL 0xFF) filling whole blocks and a few scattered, tags to keep (RG,
XI, YI, a B array) and to filter (NM, MD, AS, XD).  (a) path 1's genome
and 524,288 records (three sheets of mapAD's --batch_size), `--engine
native`, `device` and the hybrid; (b) the assembly at SCALE (0.0075: big
mode forced) and 262,144 records starting at its N-run edges, short runs
and joins among others, the same engines; (c) (a)'s BAM piped into `map -r
-` with `--engine device -R` against `--engine native -R` on the file,
and its merged reads as a `.fastq.gz`, device against native, with the
decode of each input alone (and of the same reads as a FASTQ); (d) `map
--dispatcher --batch_size 16384` over (a)'s first 65,536 records with two
`worker --device cuda:0`, one killed (SIGKILL) holding its second chunk,
which the other maps.  Every BAM equals its native one over every record
(XD aside; (d)'s against `--seed 0` in name order) and is held to its
input (`pipeline_bam.check_output`: names, flags less the mate bits, tags
less the filtered ones in order with `-R`'s RG, quality-less QUAL, each
0x10 record mapped as its forward twin); (b)'s BAM to the assembly's
invariants; the device engine escalates every overlong read as such; each
block's upload route follows its reads' highest quality (tools/sheets.py
records it), and K4 (K6) launches on the device-LUT blocks alone, K7, K2,
K3 and K5 on every block.  Printed: reads/s, the routes' prep and device
ms a block, the decode's seconds and share of the wall, the hybrid's
device fraction, memory at the sheet turns.  The default run keeps a short
form after the small assembly: 24,576 records at --batch_size 10,000
(the second sheet's first block quality-less), `--engine native` on the
file and `--engine device` on stdin, the same checks, then the kernels on
one block of this input against their plain versions: K2, K3 and K5 on
256 quality-less reads in the host-scored upload, K4 on 256 reads led by
those holding `=` and IUPAC codes, and K6, K7, K2, K3, K5 in int64 on the
same reads (`inputs` and `inputs_launches` in the kernel rows).

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

After path 10, the knobs phase, on path 1's index: path 1's workload
through `pipeline.run` on one engine at its defaults (after a warm-up
run), then under each of mapad_tpu's environment knobs in turn
(MAPAD_DEV_LUT=0: no K4 launch; MAPAD_XD_STEPS=0: K2 without its step log;
MAPAD_PREP_THREADS=2; MAPAD_FB_THREADS=1; MAPAD_INFLIGHT=1, 2, 3 and back
over 4096-read blocks), then at the defaults again, each BAM equal to path
1's native BAM, with reads/s, peak card memory and the fallback's
core-seconds; one 4096-read block in big mode at its defaults (after a
warm-up) and under MAPAD_DEV_LUT=0 (the same hits; no K6 launch, K7 from the dense
inputs); K2 with PoolConfig's debug_fixed_steps in its four forms against
its plain version, below and above the loop's natural end (one init and
one generation each), and timed at a fixed count at each K2 row's check
shape; `occ4_batch` (K1's rank query alone) in both widths.

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

import contextlib
import gzip
import io
import json
import logging
import os
import re
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
# the rows-past-2^32 phase: a synthetic big-mode table of 4.4e9 symbols
# (4,741,380 rows, 2.43 GB on the card; tools/big_rows.py), K1 on 65,536
# ranks, K7 on 256 random reads at M = 128, K2 at a fixed step count (the
# first of 512, 1,024, ... whose hits pass 2^32), K3 and K5 on
# CHECK2_READS of path 2's reads made the table's own strings
ROWS64_N = 4_400_000_000
ROWS64_SEED = 64
ROWS64_RANKS = 65_536
ROWS64_BID_READS = 256
ROWS64_FIXED = 512
ROWS64_PAST = 2**32  # the compared intervals must pass it
# path 11 (`--big-text [SIZE]`): a genome whose doubled text passes 2^31
# symbols, written as contigs of 50 Mbp (BAM's per-contig length is an
# int32; bench.py splits its genome the same way), its index cached in
# .smoke/big_text/ for the same size and seed
BIG_TEXT_SIZE = 1_100_000_000
BIG_TEXT_CONTIG = 50_000_000
BIG_TEXT_SEED = 62
BIG_TEXT_MEASURE_READS = 4096
# path 12 (--assembly [SCALE]) and the default smoke's small assembly:
# tools/assembly.py's GRCh37-shaped assembly, at scale 1 a text of
# 2,212,704,384 symbols; ASSEMBLY_SMALL_SCALE makes it 8.3 Mbp
ASSEMBLY_SCALE = 1.0
ASSEMBLY_SMALL_SCALE = 0.0075
ASSEMBLY_SEED = 37
ASSEMBLY_CHECK_READS = 256  # the small assembly's kernel check
ASSEMBLY_RANKS = 65_536
ASSEMBLY_FIXED = 512  # K2's fixed step count there
ASSEMBLY_STARVED_STEPS = "2048"  # where the defaults retry nothing
JOIN_POSITIONS = 64  # positions located a hit at a join
BIG_TEXT_MIN = 2**31 - 1  # the text length from which the engine is big
# the kernels of a map in each width (int32: the Bi-D on the host)
KERNELS_I32 = ["unpack_prep", "extend_batch", "pool_search",
               "extract_chains", "pack_result"]
KERNELS_I64 = ["unpack_prep_full", "bi_d_i64", "extend_batch_i64",
               "pool_search_i64", "extract_chains_i64", "pack_result_i64"]


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


# The bench workload (bench.py's gen_genome and make_reads) is
# mapad_tpu_torch/tools/assembly.py's, which the assembly's reads share.


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


def interval_ends(torch, lower, size):
    """The two ranks an extension of each interval queries: lower - 1 (-1,
    no query, where lower is 0) and lower + size - 1, as int64."""
    lower, size = lower.long(), size.long()
    return torch.cat([torch.where(lower > 0, lower - 1, -1),
                      lower + size - 1])


def occ_bytes(torch, idx, ranks):
    """Bytes the rank queries `ranks` (one int tensor; a rank below 0 reads
    nothing) need of `idx`'s fused rows, each 32-byte sector once over the
    whole call: in every row queried, its checkpoint words and its symbol
    words up to the furthest offset queried there.  Two ends in one row,
    or two queries of one row, read it once."""
    r = ranks.to(idx.rows.device).long()
    r = r[r >= 0]
    nb, k = idx.rows.shape[0], idx.occ_k
    last = (idx.n_cp_cols + (r % k) // 8) // 8  # the row's last sector
    need = torch.zeros(nb, dtype=torch.int64, device=r.device)
    need.scatter_reduce_(0, (r // k).clamp(max=nb - 1), last + 1, "amax")
    return int(need.sum()) * 32


class K7Queries:
    """While on (`with`), the ranks that the active walk steps of
    `bi_d.compute_bi_d_plain` query (both ends of the interval each step
    extends) are gathered in `ranks`, and their steps counted in `steps`:
    the kernel's walk w of a part of length p runs steps w..p-1, and it
    reads the rows of those steps only."""

    def __init__(self, torch, bi_d):
        self.torch, self.bi_d = torch, bi_d
        self.ranks, self.steps = [], 0

    def __enter__(self):
        torch, bi_d = self.torch, self.bi_d
        self._saved = bi_d._walk_part_plain, bi_d.extend_batch_plain
        walk, ext = self._saved
        part = {}

        def walk_part(index, rank, pen, part_len, forward, n_steps):
            w = bi_d.MAX_OFFSET
            part.update(step=0, skip=torch.arange(
                w, device=rank.device).repeat(rank.shape[0]),
                plen=part_len.long().repeat_interleave(w))
            return walk(index, rank, pen, part_len, forward, n_steps)

        def extend(index, lower, lrev, size):
            i = part["step"]
            part["step"] += 1
            on = (i >= part["skip"]) & (i < part["plen"])
            self.steps += int(on.sum())
            self.ranks.append(interval_ends(torch, lower[on], size[on]))
            return ext(index, lower, lrev, size)

        bi_d._walk_part_plain, bi_d.extend_batch_plain = walk_part, extend
        return self

    def __exit__(self, *exc):
        self.bi_d._walk_part_plain, self.bi_d.extend_batch_plain = \
            self._saved

    def bytes(self, idx):
        return occ_bytes(self.torch, idx, self.torch.cat(self.ranks))


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
        bound_ms=bound_ms(occ_bytes(torch, idx_d, interval_ends(
            torch, lower, size)) + nbytes(lower, lrev, size, *out)),
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
    `boundary_log`), and every call of the loop its config in `configs`."""

    def __init__(self, sp2):
        self.sp2, self.events, self.configs = sp2, [], []

    def __enter__(self):
        self.loop = loop = self.sp2._pool_loop_cuda
        self.sp2._pool_loop_cuda = self._run
        return self

    def _run(self, *args):
        ev = []
        self.configs.append(args[7])
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
    uploaded to the shards' cards (the packed rows in int32, K6's dense
    inputs in big mode; each shard's K7 in K9).  Held bit for bit against
    the same shards run one after the other through the unsharded pool
    search, each on its card, and re-based, and with `plain` against its
    plain version; timed in turns with the shards one after the other,
    each card waited for before the next shard starts (do two streams on
    one card, or the cards, overlap?).  -> (K9's numbers, the shards'
    unsharded results)."""
    from mapad_tpu_torch._build import LAUNCHES
    from mapad_tpu_torch.ops import search_pool2 as sp2
    from mapad_tpu_torch.ops.search_pool import PoolResult
    from mapad_tpu_torch.parallel import pool_sharded as tps

    D, R = engine.n_shards, len(recs)
    r = R // D
    mesh, indexes, params = engine.mesh, engine._mesh_index, engine._params()
    big = engine.device_index.big
    cfg, prep, _t0 = engine._prep_block(recs, R, engine.pool_config)
    ups = []
    for d, part in enumerate(prep["shards"]):
        with torch.cuda.device(mesh[d]):
            ups.append(engine._upload(part, mesh[d]))
    sync_cards(torch)

    def cat(parts):  # the shards' parts as the block's, on the first card
        return torch.cat([t.to(mesh[0]) for t in parts])

    p = {k: cat([consts[i] for consts, _ in ups])
         for i, k in enumerate(tps.CONST_KEYS)}
    if big:
        p.update((k, cat([kw["dense"][i] for _, kw in ups]))
                 for i, k in enumerate(tps.DENSE_KEYS))
    else:
        p["slut_packed"] = cat([kw["slut"] for _, kw in ups])
    parts = tps.shard_reads(mesh, p)

    def wall_ms(fn):
        sync_cards(torch)
        t = time.perf_counter()
        out = fn()
        sync_cards(torch)
        return out, (time.perf_counter() - t) * 1e3

    def k9():
        return tps.pool_search_sharded(mesh, indexes, p, params, cfg,
                                       runner=engine._shards)

    def one_after_the_other():
        out = []
        for d in range(D):
            consts, kw = tps._shard_inputs(parts[d])
            with torch.cuda.device(mesh[d]):
                out.append(sp2.k_mismatch_search_pool2(
                    indexes[d], *consts, params, cfg, **kw))
            # K2 returns before the card ends: without the wait, shards on
            # distinct cards would overlap here too
            torch.cuda.synchronize(mesh[d])
        return out

    def fields(res, dev=None):
        return tuple(t.to(dev or t.device) for t in res if t is not None)

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
            fields(want, mesh[0]), f"K9 shard {d} against its unsharded run"))
    steps = [int(x) for x in res.steps]
    C, L = cfg.max_chains, cfg.lanes
    # each card's bytes (its shards' search, extraction and rebase): shards
    # on distinct cards run at once, each from its own memory, so the bound
    # is the busiest card's; shards on one card add up
    card_bytes = {}
    for d in range(D):
        consts, kw = tps._shard_inputs(parts[d])
        card_bytes[mesh[d]] = card_bytes.get(mesh[d], 0) + (
            (C + L) * 4 * 2 + 8
            + pool_search_bytes(indexes[d], [*consts, *kw.get("dense", ())],
                                kw.get("slut"), cfg, steps[d], big)
            + extract_bytes(torch, cfg, seq[d], big))
    k9_bound = bound_ms(max(card_bytes.values()))
    k9_ms, seq_ms = median(times["k9"]), median(times["seq"])
    where = ("one card" if len(set(mesh)) == 1
             else f"{len(set(mesh))} distinct cards")
    eff = sum(steps) / (D * max(steps))
    log(f"K9 pool_search_sharded {'int64' if big else 'int32'} {D} shards x "
        f"{r} reads on {where} through a sharded engine's shard threads "
        f"(L={L} S={cfg.total_steps} CAP={cfg.read_step_cap} C={C}): "
        f"bit-exact against {'its plain version and ' if plain else ''}the "
        f"same shards unsharded; shard steps {steps} (the block's step "
        f"efficiency {eff:.4f}); {k9_ms:.1f} ms (median of "
        f"{', '.join(f'{x:.1f}' for x in times['k9'])}; first call "
        f"{first_ms:.1f}), the same shards one after the other {seq_ms:.1f} "
        f"ms (median of {', '.join(f'{x:.1f}' for x in times['seq'])}): "
        f"K9 at {k9_ms / seq_ms:.2f}x; bound {k9_bound:.3f} ms (the busiest "
        f"card's bytes)" + (f", plain {plain_ms:.1f} ms" if plain else ""))
    return dict(reads=R, steps=steps, step_efficiency=eff, ms=k9_ms,
                plain_ms=plain_ms, bound_ms=k9_bound,
                sequential_ms=seq_ms, max_abs_err=err,
                rebase_launches=rebases), seq


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
(root, fasta, fastq, out, coordinator, pid, count, flags, seed, chunk,
 device) = sys.argv[1:]
sys.path.insert(0, root)
import torch
from mapad_tpu_torch import cli
from mapad_tpu_torch.index import load_index
from mapad_tpu_torch.ops.engine import DeviceSearchEngine
from mapad_tpu_torch.parallel.multihost import run_multihost

t = time.perf_counter()
args = cli.build_parser().parse_args(
    ["map", "-r", fastq, "-g", fasta, "-o", out, *json.loads(flags)])
params = dataclasses.replace(cli.build_alignment_parameters(args),
                             chunk_size=int(chunk))
fmd = load_index(fasta).fmd
# no device named: the engine `run_multihost` makes when given none, made
# here to read its stats
engine = (DeviceSearchEngine(fmd, params, lanes=args.lanes, packed_hits=True,
                             device=device) if device else
          DeviceSearchEngine(fmd, params))
run_multihost(fastq, fasta, out, True, params, engine=engine,
              position_seed=int(seed), cmdline="mapad map",
              coordinator=coordinator, num_processes=int(count),
              process_id=int(pid))
st = engine.stats()
print(f"process {pid}: {torch.cuda.device_count()} visible cards, "
      f"{engine.n_shards} shards, {st['device_lanes']} reads in "
      f"{st['batches']} blocks, shard steps {st.get('shard_steps')}, "
      f"{time.perf_counter() - t:.2f} s from start to merge", flush=True)
"""


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def native_chunks(cli, fasta, fastq, seed=None):
    """`map --engine native --batch_size PATH8_CHUNK` (with `--seed` where
    given) of the workload -> its BAM: the yardstick of a run over the
    same chunks (the position drawn for a read with several best hits is
    seeded by the seed, its chunk's id and its place in the chunk)."""
    bam = os.path.join(WORK, f"native_{PATH8_CHUNK}"
                       f"{'' if seed is None else f'_seed{seed}'}.bam")
    t = time.perf_counter()
    if cli.main([*([] if seed is None else ["--seed", str(seed)]),
                 "--threads", "0", "map", "-r", fastq, "-g", fasta, "-o",
                 bam, "--force_overwrite", "--engine", "native",
                 "--batch_size", str(PATH8_CHUNK), *MAP_FLAGS]) != 0:
        raise SystemExit("native map failed")
    log(f"map{'' if seed is None else f' --seed {seed}'} --engine native "
        f"--batch_size {PATH8_CHUNK}: {time.perf_counter() - t:.2f} s")
    return bam


def multihost(fasta, fastq, out, seed, what, device="", visible=None,
              processes=2):
    """`run_multihost` in `processes` processes (PATH8_PROCESS) over gloo on
    localhost, each over its own chunks; process 0 merges into `out`.
    `device`: the engine's card ("": none named, the engine run_multihost
    makes by itself); `visible`: each process's CUDA_VISIBLE_DEVICES (None:
    every card, MAPAD_SHARD=0).  A process that fails or hangs, or that
    does not report as many shards as it sees cards (one without
    `visible`), fails the smoke.  -> seconds from the processes' start to
    the merged BAM."""
    coordinator = f"127.0.0.1:{free_port()}"
    env = dict(os.environ, MAPAD_SHARD="0")
    envs = [env] * processes
    if visible is not None:
        env.pop("MAPAD_SHARD")
        envs = [dict(env, CUDA_VISIBLE_DEVICES=v) for v in visible]
    t = time.perf_counter()
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", PATH8_PROCESS, ROOT, fasta, fastq, out,
             coordinator, str(pid), str(processes), json.dumps(MAP_FLAGS),
             str(seed), str(PATH8_CHUNK), device],
            env=envs[pid], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        )
        for pid in range(processes)
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
            raise AssertionError(f"{what}: process {pid} exited with "
                                 f"{p.returncode}:\n{text[-4000:]}")
        # the layout: as many shards as the process sees cards (one where
        # MAPAD_SHARD=0)
        cards = None if visible is None else len(visible[pid].split(","))
        shown = re.findall(rf"^process {pid}: (\d+) visible cards, (\d+) "
                           "shards", text, re.M)
        if (len(shown) != 1 or int(shown[0][1]) != (cards or 1)
                or cards not in (None, int(shown[0][0]))):
            raise AssertionError(
                f"{what}: process {pid} ran {shown} (visible cards, shards), "
                f"not {cards or 'any'} and {cards or 1}:\n{text[-4000:]}")
        for line in text.splitlines():
            if line.startswith("process "):
                log(f"  {line}"
                    + ("" if visible is None
                       else f" (CUDA_VISIBLE_DEVICES={visible[pid]})"))
    secs = time.perf_counter() - t
    log(f"{what}, run_multihost in {processes} processes (gloo on "
        f"localhost, {PATH8_CHUNK}-read chunks): {N_READS} reads in "
        f"{secs:.2f} s = {N_READS / secs:.1f} reads/s, process start to "
        f"merged BAM")
    return secs


def path8(cli, fasta, fastq, native_bam, seed, device="cuda:0"):
    """Two processes on one machine run `run_multihost` over gloo on
    localhost, each over its own chunk on cuda:0; process 0 merges.  The
    merged BAM equals the native engine's BAM of the same chunks (the
    position drawn for a read with several best hits depends on the chunk
    size: path 1's native BAM, one chunk, differs there)."""
    chunks = native_chunks(cli, fasta, fastq)
    a, b = bam_records(chunks)[1], bam_records(native_bam)[1]
    log(f"path 8: {sum(x != y for x, y in zip(a, b))} records differ from "
        f"the one-chunk native BAM (positions of reads with several best "
        f"hits)")
    out = os.path.join(WORK, "multihost.bam")
    secs = multihost(fasta, fastq, out, seed, "path 8", device=device)
    bam_compare(out, chunks, "path 8")
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


def dispatcher_run(what, fasta, fastq, native, out, workers, env,
                   in_process=False, batch_size=PATH8_CHUNK,
                   while_waiting=None):
    """`map --dispatcher --batch_size batch_size` in a subprocess, a CLI
    `worker` subprocess (`-v`: it logs each chunk it takes) for each
    argument list in `workers` and, with `in_process`, a `Worker` on a
    thread of this process once the first CLI worker holds the first
    chunk; every subprocess under `env`.  `while_waiting(dispatcher,
    workers, procs)` (the dispatcher's `_Lines`, the CLI workers' `_Lines`
    and processes), where given, runs once the workers are started and
    returns the indices of the CLI workers it killed, whose exit is not
    checked.  A process or thread that fails or hangs fails the smoke, and
    the BAM `out` must equal `native` (`map --seed 0 --engine native` of
    the same chunks: the position drawn for a read with several best hits
    is seeded by the seed, the chunk's id and the read's place in it) in
    read-name order (the dispatcher writes a chunk as its result comes
    in).  -> (seconds from the dispatcher's start to its BAM, the
    in-process `Worker` or None, each CLI worker's `_Lines`)."""
    from mapad_tpu_torch.distributed.worker import Worker

    port = str(free_port())
    cmd = [sys.executable, "-m", "mapad_tpu_torch.cli", "--port", port]
    procs, lines, errors = [], [], []
    worker = thread = None
    killed = set()

    def start(argv):
        procs.append(subprocess.Popen(
            cmd + argv, cwd=ROOT, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT))
        lines.append(_Lines(procs[-1]))
        return lines[-1]

    def serve():
        try:
            worker.run()
        except Exception as e:  # noqa: BLE001 - fails the run below
            errors.append(e)

    t = time.perf_counter()
    try:
        dispatcher = start(["map", "--dispatcher", "-r", fastq, "-g", fasta,
                            "-o", out, "--force_overwrite", *MAP_FLAGS,
                            "--batch_size", str(batch_size)])
        dispatcher.wait_for("Dispatcher listening", PATH9_TIMEOUT,
                            f"{what}: the dispatcher")
        for argv in workers:
            start(["-v", "worker", "--host", "127.0.0.1", *argv])
        if in_process:
            # the first CLI worker holds the first chunk before this one
            # connects
            dispatcher.wait_for("Worker connected", PATH9_TIMEOUT,
                                f"{what}: the dispatcher", other=lines[1])
            worker = Worker("127.0.0.1", int(port))
            thread = threading.Thread(target=serve, daemon=True)
            thread.start()
        if while_waiting is not None:
            killed = {1 + k for k in while_waiting(dispatcher, lines[1:],
                                                   procs[1:])}
        for k, (proc, text) in enumerate(zip(procs, lines)):
            if k in killed:
                continue
            who = ("the dispatcher" if k == 0 else
                   f"CLI worker {k} {' '.join(workers[k - 1])}".rstrip())
            try:
                rc = proc.wait(timeout=PATH9_TIMEOUT)
            except subprocess.TimeoutExpired:
                raise AssertionError(f"{what}: {who} hangs:\n"
                                     + text.tail()) from None
            if rc != 0:
                raise AssertionError(f"{what}: {who} exited with {rc}:\n"
                                     f"{text.tail()}")
        if thread is not None:
            thread.join(timeout=PATH9_TIMEOUT)
            if thread.is_alive() or errors:
                raise AssertionError(
                    f"{what}: the in-process worker "
                    f"{errors[0] if errors else 'hangs'}")
    finally:
        for proc in procs:
            proc.kill()
            proc.wait()
    secs = time.perf_counter() - t
    bam_compare(out, native, what, in_name_order=True)
    return secs, worker, lines[1:]


def path9(torch, cli, fasta, fastq, card, kernels):
    """Distributed mode on the card (`dispatcher_run`): `map --dispatcher`
    in a subprocess with two workers on cuda:0, the CLI's `worker` in a
    subprocess and a `Worker` on a thread of this process (its launches
    counted), one 8,192-read chunk each; the BAM equal to the native one
    of the same chunks with the dispatcher's position seed (0).  -> the
    in-process worker's launch counts."""
    from mapad_tpu_torch._build import LAUNCHES

    native = native_chunks(cli, fasta, fastq, seed=0)
    LAUNCHES.reset()
    torch.cuda.synchronize()
    secs, worker, _ = dispatcher_run(
        "path 9", fasta, fastq, native, os.path.join(WORK, "distributed.bam"),
        [[]], dict(os.environ, MAPAD_SHARD="0"), in_process=True)
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


# --- the knobs phase -------------------------------------------------------

KNOB_BLOCK_READS = 4096  # the MAPAD_INFLIGHT runs: four blocks of path 1's
FIXED_CFG = dict(total_steps=1024, read_step_cap=256)  # the fixed-step check
FIXED_READS = 512        # one read a lane at full width
FIXED_TIMED = 2048       # the timed fixed count, at the K2 rows' shapes


def stats_since(after, before):
    """An engine's counts and stage seconds of one run: `after` less
    `before` (the engine is reused from run to run)."""
    out = {}
    for k, v in after.items():
        b = before.get(k)
        if isinstance(v, dict):
            out[k] = {c: n - (b or {}).get(c, 0) for c, n in v.items()}
        elif isinstance(v, list):  # shard_steps
            out[k] = [n - m for n, m in zip(v, b or [0] * len(v))]
        elif isinstance(v, (int, float)):
            out[k] = v - (b or 0)
    return out


def knob_runs(torch, engine, index, params, args, fastq, fasta, native_bam,
              card, kernels):
    """Path 1's workload through `pipeline.run` on ONE engine (each knob is
    read at the call, as in mapad_tpu): a warm-up run at the defaults (the
    engine's first: its card tables, the native searcher), the defaults,
    each knob in turn, MAPAD_INFLIGHT 1, 2, 3 and back, the defaults again;
    every BAM equal to path 1's native BAM.  -> [(run, its numbers)]."""
    from mapad_tpu_torch._build import LAUNCHES
    from mapad_tpu_torch.map import pipeline
    from mapad_tpu_torch.ops import search_pool2 as sp2

    inflight = [(f"MAPAD_INFLIGHT={n} MAPAD_BLOCK_READS={KNOB_BLOCK_READS}",
                 dict(MAPAD_INFLIGHT=str(n),
                      MAPAD_BLOCK_READS=str(KNOB_BLOCK_READS)))
                for n in (1, 2, 3)]
    runs = [("warm-up, defaults", {}), ("defaults", {}),
            ("MAPAD_DEV_LUT=0", dict(MAPAD_DEV_LUT="0")),
            ("MAPAD_XD_STEPS=0", dict(MAPAD_XD_STEPS="0")),
            ("MAPAD_PREP_THREADS=2", dict(MAPAD_PREP_THREADS="2")),
            ("MAPAD_FB_THREADS=1", dict(MAPAD_FB_THREADS="1"))]
    runs += inflight + inflight[::-1] + [("defaults", {})]
    bam = os.path.join(WORK, "knobs.bam")
    out = []
    for what, env in runs:
        before = engine.stats()
        with _Env(**env), _BoundaryTap(sp2) as k2_tap:
            LAUNCHES.reset()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t = time.perf_counter()
            pipeline.run(fastq, fasta, bam, True, params, None,
                         engine=engine, position_seed=args.seed,
                         cmdline="mapad map", threads=os.cpu_count() or 1,
                         index=index)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t
            blocks = engine.block_reads
        peak = torch.cuda.max_memory_allocated()
        st = stats_since(engine.stats(), before)
        counts = {k: LAUNCHES.get(k) for k in kernels}
        tracks = sorted({c.track_read_steps for c in k2_tap.configs})
        log(f"knobs, {what}: {N_READS} reads in {secs:.2f} s = "
            f"{N_READS / secs:.1f} reads/s, {st['batches']} blocks of "
            f"{blocks}, peak card memory {peak / 2**20:.1f} MiB "
            f"(max_memory_allocated), prep {st['prep_s']:.3f} s, device "
            f"{st['device_s']:.3f} s, wait {st['wait_s']:.3f} s, fallback "
            f"{st['fb_secs']:.3f} core-s ({st['oracle']} host searches; "
            f"pool of {engine._fb_threads}), prep threads "
            f"{engine._prep_threads}, K2 step log {tracks}; {card}")
        log(f"  kernel launches on this run: {counts}")
        lut = env.get("MAPAD_DEV_LUT") != "0"
        if bool(counts["unpack_prep"]) != lut or any(
                v <= 0 for k, v in counts.items() if k != "unpack_prep"):
            raise AssertionError(f"knobs, {what}: launches {counts}")
        check_k2_launches(counts, f"knobs, {what}")
        if tracks != [env.get("MAPAD_XD_STEPS") != "0"]:
            raise AssertionError(f"knobs, {what}: K2's step log {tracks}")
        want_fb = int(env.get("MAPAD_FB_THREADS", 0)) or max(
            1, (os.cpu_count() or 2) - 1)
        want_prep = int(env.get("MAPAD_PREP_THREADS", 1))
        if (engine._fb_threads != want_fb
                or engine._prep_threads != want_prep):
            raise AssertionError(
                f"knobs, {what}: fallback pool {engine._fb_threads}, prep "
                f"threads {engine._prep_threads}")
        bam_compare(bam, native_bam, f"knobs, {what}")
        out.append((what, dict(reads_s=N_READS / secs, peak_mib=peak / 2**20,
                               fb_core_s=st["fb_secs"])))
    return out


def knob_big_block(torch, np, engine, reads):
    """MAPAD_DEV_LUT=0 in big mode: one 4096-read block of path 1's
    workload on a big-mode engine, at its defaults and under the knob: the
    same hits read for read; K6 launches at the defaults and not under the
    knob, where K7 takes the dense inputs.  -> {run: its launches}."""
    from mapad_tpu_torch._build import LAUNCHES
    from mapad_tpu_torch.map.record import Record

    recs = [Record(sequence=s, base_qualities=q)
            for s, q in reads[:BLOCK2_READS]]
    names = ("unpack_prep_full", "bi_d_i64", "pool_search_i64",
             "extract_chains_i64", "pack_result_i64")
    outs, counts = {}, {}
    for what, env in (("warm-up, defaults", {}), ("defaults", {}),
                      ("MAPAD_DEV_LUT=0", dict(MAPAD_DEV_LUT="0"))):
        with _Env(**env):
            LAUNCHES.reset()
            t = time.perf_counter()
            outs[what] = engine.search_chunk(recs)
            secs = time.perf_counter() - t
        counts[what] = {k: LAUNCHES.get(k) for k in names}
        log(f"knobs, big mode, {what}: {len(recs)} reads in {secs:.2f} s, "
            f"launches {counts[what]}")
    bad = [i for i, ((a, _), (b, _)) in enumerate(
        zip(outs["defaults"], outs["MAPAD_DEV_LUT=0"]))
        if not packed_same(np, a, b)]
    with_hits = sum(1 for h, _ in outs["defaults"] if len(h))
    if bad or with_hits < len(recs) // 2:
        raise AssertionError(f"knobs, big mode: {len(bad)} reads' hits "
                             f"differ under MAPAD_DEV_LUT=0, first at "
                             f"{bad[:5]} ({with_hits} reads with hits)")
    off = counts["MAPAD_DEV_LUT=0"]
    if (not counts["defaults"]["unpack_prep_full"]
            or off["unpack_prep_full"]
            or any(off[k] <= 0 for k in names[1:])):
        raise AssertionError(f"knobs, big mode: launches {counts}")
    log(f"knobs, big mode: the hits of every read equal the defaults' "
        f"under MAPAD_DEV_LUT=0 ({with_hits} reads with hits); K6 0 "
        f"launches there, K7 {off['bi_d_i64']}")
    return counts


def fixed_steps_check(torch, sp2, engine, reads, timed_reads, card):
    """K2 with PoolConfig.debug_fixed_steps against its plain version in
    `engine`'s form (width, direction): at full width with one read a
    lane, a count below the loop's natural end (lanes come back
    unfinished) and one above it (steps run with every lane done), each
    one init and one generation; then timed at the K2 row's check shape
    (`timed_reads` reads at the engine's own config) over FIXED_TIMED
    steps.  -> the row's `fixed_*` keys."""
    from mapad_tpu_torch._build import LAUNCHES
    from mapad_tpu_torch.map.record import Record

    big = bool(engine.device_index.big)
    sfx = "_i64" if big else ""
    bidir = not engine.pool_config.backward_only
    name = "pool_search" + ("_bidir" if bidir else "") + sfx

    def inputs(n, cfg):
        recs = [Record(sequence=s, base_qualities=q) for s, q in reads[:n]]
        cfg, prep, _t0 = engine._prep_block(recs, n, cfg)
        with torch.cuda.device(engine.device):
            consts, kw = engine._upload(prep)
            slut = kw["slut"] if "slut" in kw else sp2._dense_slut(
                engine.device_index, kw["dense"], consts[0], consts[1], cfg,
                kw["bid_steps"])
        return cfg, (engine.device_index, *consts, engine._params(), cfg,
                     slut)

    def with_cfg(args, cfg):
        return args[:7] + (cfg,) + args[8:]

    cfg, args = inputs(FIXED_READS, engine.pool_config._replace(**FIXED_CFG))
    natural = int(sp2._extract_chains_cuda(*sp2._pool_loop_cuda(*args),
                                           cfg).steps)
    err = 0.0
    for where, fixed in (("below", natural // 2),
                         ("above", min(natural + 64, cfg.total_steps))):
        c = cfg._replace(debug_fixed_steps=fixed)
        a = with_cfg(args, c)
        LAUNCHES.reset()
        res = sp2._extract_chains_cuda(*sp2._pool_loop_cuda(*a), c)
        torch.cuda.synchronize()
        launches = {k: LAUNCHES.get(k) for k in (name, "extend_batch" + sfx)}
        check_k2_launches(launches, f"{name} fixed {fixed}", sfx=sfx,
                          name=name)
        if launches[name] != 2:
            raise AssertionError(f"{name} fixed {fixed}: {launches}")
        pres = sp2._extract_chains_plain(*sp2._pool_loop_plain(*a), c)
        err = max(err, compare(torch, tuple(res), tuple(pres),
                               f"{name} fixed {fixed}"))
        unfinished = bool(res.lane_unfinished.any())
        if int(res.steps) != fixed or unfinished != (where == "below"):
            raise AssertionError(f"{name} fixed {fixed}: {int(res.steps)} "
                                 f"steps, unfinished lanes {unfinished}")
        log(f"K2 {name} debug_fixed_steps={fixed} ({where} the natural "
            f"{natural}; L={cfg.lanes} S={cfg.total_steps} "
            f"CAP={cfg.read_step_cap}, {FIXED_READS} reads): bit-exact "
            f"against its plain version, {launches[name]} launches (init + "
            f"one generation), unfinished lanes {unfinished}")
    # the per-step figure of a fixed count at the K2 row's check shape
    cfg, args = inputs(timed_reads, engine.pool_config)
    full = int(sp2._extract_chains_cuda(*sp2._pool_loop_cuda(*args),
                                        cfg).steps)
    c = cfg._replace(debug_fixed_steps=FIXED_TIMED)
    state, ms = k2_timed(torch, sp2, with_cfg(args, c))
    steps = state[3].tolist()[sp2.G_STEP]
    if steps != FIXED_TIMED:
        raise AssertionError(f"{name}: {steps} steps at a fixed "
                             f"{FIXED_TIMED}")
    log(f"K2 {name} at a fixed {FIXED_TIMED} steps, {timed_reads} reads, "
        f"L={cfg.lanes} S={cfg.total_steps} (natural end {full}): "
        f"{ms:.2f} ms, {ms * 1e3 / steps:.3f} us a step; {card}")
    return dict(fixed_check=dict(natural=natural, below=natural // 2,
                                 above=min(natural + 64, cfg.total_steps),
                                 max_abs_err=err),
                fixed_steps=FIXED_TIMED, fixed_ms=ms,
                fixed_us_step=ms * 1e3 / steps, fixed_natural_steps=full)


def occ4_check(torch, fm, idx_d, card):
    """`occ4_batch` (K1's rank query alone, one warp a position) against
    `_row_occ4` on 1,024 positions of `idx_d`, -1 and garbage among them.
    -> the K1 row's `occ4_batch` key."""
    from mapad_tpu_torch._build import LAUNCHES

    idt = idx_d.idx_dtype
    g = torch.Generator(device="cpu").manual_seed(2)
    n = idx_d.text_len
    info = torch.iinfo(idt)
    r = torch.cat([torch.randint(-1, n, (960,), generator=g, dtype=idt),
                   torch.tensor([-1, 0, n - 1], dtype=idt),
                   torch.randint(info.min, info.max, (61,), generator=g,
                                 dtype=idt)]).to(idx_d.rows.device)
    name = "occ4_batch" + ("_i64" if idx_d.big else "")
    LAUNCHES.reset()
    got = fm.occ4_batch(idx_d, r)
    if LAUNCHES.get(name) != 1:
        raise AssertionError(f"{name}: {LAUNCHES.get(name)} launches")
    err = compare(torch, (got,), (fm._row_occ4(idx_d, r),), name)
    out = dict(max_abs_err=err, positions=int(r.numel()),
               ms=timed(torch, lambda: fm.occ4_batch(idx_d, r), 50),
               plain_ms=timed(torch, lambda: fm._row_occ4(idx_d, r), 10),
               bound_ms=bound_ms(occ_bytes(torch, idx_d, r)
                                 + nbytes(r, got)))
    log(f"K1 {name}: bit-exact on {r.numel()} positions, "
        f"{out['ms']:.4f} ms (plain {out['plain_ms']:.4f} ms, bound "
        f"{out['bound_ms']:.6f} ms); {card}")
    return out


def knobs_phase(torch, np, index, params, vparams, args, fastq, fasta,
                reads, native_bam, card, kernels):
    """The knobs phase on path 1's index: the runs of `knob_runs` on one
    engine, MAPAD_DEV_LUT=0 on a big-mode block, the fixed-step K2 in its
    four forms, `occ4_batch` in both widths.  -> the extra keys of the
    kernel rows (K2's `fixed_*`, K1's `occ4_batch`)."""
    from mapad_tpu_torch.ops import fm
    from mapad_tpu_torch.ops import search_pool2 as sp2
    from mapad_tpu_torch.ops.engine import DeviceSearchEngine

    t0 = time.perf_counter()

    def engine(p, big=False):
        return DeviceSearchEngine(index.fmd, p, lanes=args.lanes, big=big,
                                  packed_hits=True)

    small = engine(params)
    runs = knob_runs(torch, small, index, params, args, fastq, fasta,
                     native_bam, card, kernels)
    log("knobs, in the order run: " + "; ".join(
        f"{what} {v['reads_s']:.1f} reads/s, {v['peak_mib']:.1f} MiB, "
        f"fallback {v['fb_core_s']:.3f} core-s" for what, v in runs)
        + f"; {card}")
    big = engine(params, big=True)
    knob_big_block(torch, np, big, reads)
    extra = {"extend_batch": dict(occ4_batch=occ4_check(
                 torch, fm, small.device_index, card)),
             "extend_batch_i64": dict(occ4_batch=occ4_check(
                 torch, fm, big.device_index, card))}
    for eng in (small, big, engine(vparams), engine(vparams, big=True)):
        wide = bool(eng.device_index.big)
        bidir = not eng.pool_config.backward_only
        name = ("pool_search" + ("_bidir" if bidir else "")
                + ("_i64" if wide else ""))
        extra[name] = fixed_steps_check(
            torch, sp2, eng, reads,
            BIDIR_READS if bidir else CHECK_READS if not wide
            else CHECK2_READS, card)
    log(f"knobs phase: {time.perf_counter() - t0:.1f} s")
    return extra


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
    with K7Queries(torch, bi_d) as q7:
        want7 = k7_plain()
    err7 = compare(torch, (bid,), (want7,), f"bi_d ({what})")
    if bid_row:
        walk_steps = bi_d.walk_steps(n, split, fwd)
        assert q7.steps == walk_steps, (q7.steps, walk_steps)
        rows["bi_d"] = dict(
            route="cuda", source="mapad_tpu_torch/csrc/bi_d.cu",
            replaces="mapad_tpu/ops/bi_d.py:27", max_abs_err=err7,
            ms=timed(torch, k7, 10), plain_ms=timed(torch, k7_plain, 1),
            bound_ms=bound_ms(nbytes(rank, pen, n, split, bid)
                              + q7.bytes(idx_d)),
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
    with K7Queries(torch, bi_d) as q7:
        want7 = k7_plain()
    err = compare(torch, (bid,), (want7,), "bi_d_i64")
    # a second split puts reads into both parts, for the forward part
    half = torch.div(n, 2, rounding_mode="floor").to(torch.int32)
    n_h, half_h = n.cpu(), half.cpu()
    steps2 = (int(half_h.max()), int((n_h - half_h).max()))
    both = bi_d.compute_bi_d(idx_d, rank, pen, n, half, True, steps2)
    with K7Queries(torch, bi_d) as q7_both:
        want7 = bi_d.compute_bi_d_plain(idx_d, rank, pen, n, half, True,
                                        steps2)
    err = max(err, compare(torch, (both,), (want7,),
                           "bi_d_i64 (both parts)"))
    # the walk steps each run's data needs (both parts where the forward
    # part is on), and the index bytes their rank queries need
    fwd = cfg.compute_forward_part
    walk_steps = bi_d.walk_steps(n, split, fwd)
    both_steps = bi_d.walk_steps(n, half, True)
    assert (q7.steps, q7_both.steps) == (walk_steps, both_steps)
    k7_bytes = nbytes(rank, pen, n, split, bid) + q7.bytes(idx_d)
    rows["bi_d_i64"] = dict(
        route="cuda", source="mapad_tpu_torch/csrc/bi_d.cu",
        replaces="mapad_tpu/ops/bi_d.py:27", max_abs_err=err,
        ms=timed(torch, k7, 10), plain_ms=timed(torch, k7_plain, 1),
        bound_ms=bound_ms(k7_bytes), bound_by="bytes", library_ms=None,
        walk_steps=walk_steps, plan=k7_plan(bi_d, dev, rank, fwd, True),
        both_ms=timed(torch, lambda: bi_d.compute_bi_d(
            idx_d, rank, pen, n, half, True, steps2), 10),
        both_walk_steps=both_steps,
        both_bound_ms=bound_ms(nbytes(rank, pen, n, half, both)
                               + q7_both.bytes(idx_d)),
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


def rows64_k1(torch, fm, tables, xs, card):
    """K1 int64 (`occ4_batch`, `extend_batch`) against its plain versions
    at ROWS64_RANKS ranks of each table (`edge_ranks`; on a table with X,
    the second quarter of them on X symbols of `xs`): the positions
    themselves, and as many intervals whose lower end (the first half) or
    upper end (the second) ranks them.  The queries that read a row
    holding X are counted."""
    from mapad_tpu_torch.tools.big_rows import edge_ranks

    out = {}
    for what, idx in tables:
        n = idx.text_len
        has_x, x_pos = xs[what]
        r = edge_ranks(idx, ROWS64_RANKS, ROWS64_SEED)
        q = ROWS64_RANKS // 4
        if x_pos.numel():
            g = torch.Generator(device="cpu").manual_seed(ROWS64_SEED + 4)
            r[q : 2 * q] = x_pos[torch.randint(
                0, x_pos.numel(), (q,), generator=g).to(x_pos.device)]
        half = r[: ROWS64_RANKS // 2]
        g = torch.Generator(device="cpu").manual_seed(ROWS64_SEED + 1)
        size = torch.randint(0, 65, half.shape, generator=g,
                             dtype=torch.int64).to(r.device)
        lo_a = (half + 1).clamp(0, n - 1)
        lo_b = (half - size + 1).clamp(0, n - 1)
        lower = torch.cat([lo_a, lo_b])
        size = torch.minimum(torch.cat([size, size]), n - lower)
        lower[0], size[0] = 0, n  # the whole text
        lrev = torch.randint(0, n, lower.shape, generator=g,
                             dtype=torch.int64).to(r.device)
        occ = fm.occ4_batch(idx, r)
        err = compare(torch, (occ,), (fm._row_occ4(idx, r),),
                      f"occ4_batch_i64 on {what}")
        ext = fm.extend_batch(idx, lower, lrev, size)
        err = max(err, compare(torch, ext, fm.extend_batch_plain(
            idx, lower, lrev, size), f"extend_batch_i64 on {what}"))
        ends = interval_ends(torch, lower, size)
        out[what] = dict(
            max_abs_err=err, ranks=int(r.numel()),
            intervals=int(lower.numel()),
            x_rows=int(has_x.sum()), x_symbols=int(x_pos.numel()),
            x_rank_queries=x_queried(torch, idx, has_x, r),
            x_row_queries=x_queried(torch, idx, has_x, ends),
            max_rank=int(r.max()), max_child_lower=int(ext[0].max()),
            occ4_ms=timed(torch, lambda: fm.occ4_batch(idx, r), 20),
            occ4_plain_ms=timed(torch, lambda: fm._row_occ4(idx, r), 3),
            ms=timed(torch, lambda: fm.extend_batch(idx, lower, lrev, size),
                     20),
            plain_ms=timed(torch, lambda: fm.extend_batch_plain(
                idx, lower, lrev, size), 3),
            occ4_bound_ms=bound_ms(occ_bytes(torch, idx, r) + nbytes(r, occ)),
            bound_ms=bound_ms(occ_bytes(torch, idx, ends)
                              + nbytes(lower, lrev, size, *ext)))
        o = out[what]
        log(f"K1 int64 on {what} ({n:,} symbols; {o['x_rows']:,} rows hold "
            f"{o['x_symbols']:,} X symbols): occ4_batch on {o['ranks']} "
            f"ranks ({o['x_rank_queries']} in rows with X) and extend_batch "
            f"on {o['intervals']} intervals ({o['x_row_queries']} ends in "
            f"rows with X) bit-exact against their plain versions (largest "
            f"rank {o['max_rank']:,}, largest child lower "
            f"{o['max_child_lower']:,}); occ4_batch {o['occ4_ms']:.4f} ms "
            f"(plain {o['occ4_plain_ms']:.2f}, bound "
            f"{o['occ4_bound_ms']:.5f}), extend_batch "
            f"{o['ms']:.4f} ms (plain {o['plain_ms']:.2f}, bound "
            f"{o['bound_ms']:.4f}); {card}")
    return out


def rows64_k7(torch, bi_d, tables, xs, card):
    """K7 int64 against its plain version on ROWS64_BID_READS random reads
    at M = 128, both parts (split n // 2), on each table: random ranks
    over a random table, so the walks' restarts spread over all of it,
    into the rows holding X (`xs`; their queries counted)."""
    g = torch.Generator(device="cpu").manual_seed(ROWS64_SEED + 2)
    R, M = ROWS64_BID_READS, 128
    rank = torch.randint(1, 5, (R, M), generator=g, dtype=torch.int32)
    pen = -4 * torch.rand((R, M), generator=g, dtype=torch.float32)
    n = torch.full((R,), M, dtype=torch.int32)
    split = n // 2
    steps = (M // 2, M - M // 2)
    walk = bi_d.walk_steps(n, split, True)
    out = {}
    for what, idx in tables:
        dev = idx.rows.device
        a = (rank.to(dev), pen.to(dev), n.to(dev), split.to(dev), True,
             steps)
        got = bi_d.compute_bi_d(idx, *a)
        with K7Queries(torch, bi_d) as q7:
            want = bi_d.compute_bi_d_plain(idx, *a)
        assert q7.steps == walk, (q7.steps, walk)
        err = compare(torch, (got,), (want,), f"bi_d_i64 on {what}")
        ranks7 = torch.cat(q7.ranks)
        out[what] = dict(
            max_abs_err=err, reads=R, walk_steps=walk,
            queries=int(ranks7.numel()),
            x_row_queries=x_queried(torch, idx, xs[what][0], ranks7),
            ms=timed(torch, lambda: bi_d.compute_bi_d(idx, *a), 10),
            plain_ms=timed(torch, lambda: bi_d.compute_bi_d_plain(idx, *a),
                           1),
            bound_ms=bound_ms(nbytes(*a[:4], got) + q7.bytes(idx)))
        o = out[what]
        log(f"K7 int64 on {what}: {R} reads at M={M}, both parts, "
            f"{walk} walk steps ({o['x_row_queries']} of their "
            f"{o['queries']} rank queries in rows with X), bit-exact; "
            f"{o['ms']:.4f} ms (plain "
            f"{o['plain_ms']:.1f}, bound {o['bound_ms']:.5f}); {card}")
    return out


def rows64_pool(torch, np, engine, reads, tables, xs, card):
    """K2 int64 at a fixed step count, then K3 and K5 on its result,
    against their plain versions on the first table; timed on each.  The
    block is CHECK2_READS of path 2's reads (their lengths and qualities)
    prepared by path 2's engine, their bases the first table's own strings
    (`text_strings`), so that they hit; the same prepared inputs go to each
    table, its Bi-D made there (K7).  The count: the first of ROWS64_FIXED,
    twice it, ... (the kernel alone) whose hits pass ROWS64_PAST, so that
    the plain loop runs no more steps than the check needs.  The chains'
    interval ends that fall in a row holding X (`xs`) are counted."""
    from mapad_tpu_torch.map.record import Record
    from mapad_tpu_torch.ops import engine as eng
    from mapad_tpu_torch.ops import search_pool2 as sp2
    from mapad_tpu_torch.tools.big_rows import text_strings

    R = CHECK2_READS
    syn = tables[0][1]
    strings = text_strings(syn, R, 128, ROWS64_SEED + 3).cpu().numpy()
    acgt = np.frombuffer(b"ACGT", dtype=np.uint8)
    recs = [Record(sequence=acgt[strings[i, -len(s):] - 1].tobytes(),
                   base_qualities=q) for i, (s, q) in enumerate(reads[:R])]
    dev = engine.device
    cfg, prep, _t0 = engine._prep_block(recs, R, engine.pool_config)
    with torch.cuda.device(dev):
        consts, kw = engine._upload(prep)
    args = {what: (idx, *consts, engine._params(), cfg, sp2._dense_slut(
        idx, kw["dense"], consts[0], consts[1], cfg, kw["bid_steps"]))
        for what, idx in tables}

    def fixed_args(what, fixed):
        a = args[what]
        return a[:7] + (cfg._replace(debug_fixed_steps=fixed),) + a[8:]

    def hits(res):
        n_ext = min(int(res.n_chains), cfg.max_chains)
        hit = (res.c_read[:n_ext] >= 0) & ~res.c_abandon[:n_ext]
        return (int(hit.sum()),
                int(res.c_lower[:n_ext][hit].max()) if bool(hit.any())
                else -1,
                int(res.c_lrev[:n_ext][hit].max()) if bool(hit.any())
                else -1)

    fixed = ROWS64_FIXED
    while True:
        a = fixed_args(tables[0][0], fixed)
        if hits(sp2._extract_chains_cuda(*sp2._pool_loop_cuda(*a),
                                         a[7]))[1] > ROWS64_PAST:
            break
        if fixed >= cfg.total_steps:
            raise AssertionError(f"K2 on {tables[0][0]}: no hit past "
                                 f"{ROWS64_PAST:,} in {fixed} steps")
        fixed = min(2 * fixed, cfg.total_steps)
    out = {}
    for what, idx in tables:
        a = fixed_args(what, fixed)
        c = a[7]
        state, k2_ms = k2_timed(torch, sp2, a)
        res = sp2._extract_chains_cuda(*state, c)
        buf = sp2._extract_chains_cuda(*state, c, views=False)
        packed = eng._pack_buffer(buf, c, R, True)
        steps = int(res.steps)
        n_hits, max_lower, max_lrev = hits(res)
        n_ch = min(int(res.n_chains), c.max_chains)
        o = out[what] = dict(
            x_row_ends=x_queried(torch, idx, xs[what][0], interval_ends(
                torch, res.c_lower[:n_ch], res.c_size[:n_ch])),
            reads=R, fixed_steps=fixed, steps=steps, k2_ms=k2_ms,
            k2_us_step=k2_ms * 1e3 / max(steps, 1),
            k3_ms=timed(torch, lambda: sp2._extract_chains_cuda(*state, c),
                        20),
            k5_ms=timed(torch, lambda: eng._pack_buffer(buf, c, R, True),
                        20),
            chains=int(res.n_chains), hits=n_hits, max_lower=max_lower,
            max_lower_rev=max_lrev)
        if idx is syn:
            t = time.perf_counter()
            pres = sp2._extract_chains_plain(*sp2._pool_loop_plain(*a), c)
            torch.cuda.synchronize()
            o["plain_ms"] = (time.perf_counter() - t) * 1e3
            o["max_abs_err"] = max(
                compare(torch, tuple(res), tuple(pres),
                        f"pool_search_i64 + extract_chains_i64 on {what}"),
                compare(torch, (packed,), (eng._pack_result_plain(res),),
                        f"pack_result_i64 on {what}"))
            if steps != fixed or max_lower <= ROWS64_PAST:
                raise AssertionError(
                    f"K2 on {what}: {steps} steps, largest hit lower "
                    f"{max_lower:,} (must pass {ROWS64_PAST:,})")
        log(f"K2+K3+K5 int64 on {what}: {R} reads (the table's own "
            f"strings), debug_fixed_steps={fixed}: "
            + ("bit-exact against the plain versions "
               f"(plain K2+K3 {o['plain_ms']:.0f} ms); " if idx is syn
               else "")
            + f"{o['chains']} chains ({o['x_row_ends']} of their interval "
            f"ends in rows with X), {n_hits} hits, largest hit lower "
            f"{max_lower:,} (lower_rev {max_lrev:,}); K2 {k2_ms:.2f} ms "
            f"({o['k2_us_step']:.3f} us a step), K3 {o['k3_ms']:.4f} ms, "
            f"K5 {o['k5_ms']:.4f} ms; {card}")
    return out


def rows64_phase(torch, np, engine, reads, card):
    """K1, K7, K2, K3 and K5 in int64 on a table whose rows pass 2^32:
    the synthetic index of ROWS64_N symbols, each kernel bit for bit
    against its plain version there and timed beside the same call on
    path 2's rows (`engine`'s index).  -> {kernel-table row: its
    `past_2_32` keys}."""
    from mapad_tpu_torch.ops import bi_d, fm
    from mapad_tpu_torch.tools.big_rows import synthetic_index

    t0 = time.perf_counter()
    torch.cuda.synchronize()
    syn = synthetic_index(ROWS64_N, ROWS64_SEED, engine.device)
    torch.cuda.synchronize()
    made_s = time.perf_counter() - t0
    log(f"rows past 2^32: a synthetic BWT of {syn.text_len:,} symbols, "
        f"{syn.rows.shape[0]:,} rows = {nbytes(syn.rows) / 1e9:.3f} GB on "
        f"the card (checkpoints up to {int(syn.less[-1]):,}), made in "
        f"{made_s:.1f} s")
    tables = (("the synthetic table", syn),
              ("path 2's rows", engine.device_index))
    xs = {what: rows_with_x(torch, idx) for what, idx in tables}
    k1 = rows64_k1(torch, fm, tables, xs, card)
    k7 = rows64_k7(torch, bi_d, tables, xs, card)
    pool = rows64_pool(torch, np, engine, reads, tables, xs, card)
    del syn, tables, xs
    torch.cuda.empty_cache()
    syn_k, p2 = "the synthetic table", "path 2's rows"
    if k1[syn_k]["max_child_lower"] <= ROWS64_PAST:
        raise AssertionError("K1 int64: no child interval past 2^32")
    for what, n_x in (
            ("occ4_batch_i64", k1[syn_k]["x_rank_queries"]),
            ("extend_batch_i64", k1[syn_k]["x_row_queries"]),
            ("bi_d_i64", k7[syn_k]["x_row_queries"])):
        if not n_x:
            raise AssertionError(f"{what}: no query on the synthetic table "
                                 "read a row holding X")
    common = dict(n=ROWS64_N, rows=-(-ROWS64_N // 928), made_s=made_s)
    po, pp = pool[syn_k], pool[p2]
    rows = {
        "extend_batch_i64": dict(common, **{
            k: k1[syn_k][k] for k in ("max_abs_err", "ms", "plain_ms",
                                      "bound_ms", "occ4_ms", "occ4_bound_ms",
                                      "max_child_lower", "x_rows",
                                      "x_symbols", "x_rank_queries",
                                      "x_row_queries")},
            ms_path2=k1[p2]["ms"], occ4_ms_path2=k1[p2]["occ4_ms"],
            bound_ms_path2=k1[p2]["bound_ms"]),
        "bi_d_i64": dict(common, **{
            k: k7[syn_k][k] for k in ("max_abs_err", "ms", "plain_ms",
                                      "bound_ms", "walk_steps", "queries",
                                      "x_row_queries")},
            ms_path2=k7[p2]["ms"], bound_ms_path2=k7[p2]["bound_ms"]),
        "pool_search_i64": dict(
            common, max_abs_err=po["max_abs_err"], ms=po["k2_ms"],
            us_step=po["k2_us_step"], fixed_steps=po["fixed_steps"],
            plain_ms=po["plain_ms"], ms_path2=pp["k2_ms"],
            us_step_path2=pp["k2_us_step"]),
        "extract_chains_i64": dict(
            common, max_abs_err=po["max_abs_err"], ms=po["k3_ms"],
            chains=po["chains"], hits=po["hits"],
            x_row_ends=po["x_row_ends"],
            max_lower=po["max_lower"], ms_path2=pp["k3_ms"]),
        "pack_result_i64": dict(
            common, max_abs_err=po["max_abs_err"], ms=po["k5_ms"],
            ms_path2=pp["k5_ms"]),
    }
    log(f"rows past 2^32: K1, K7, K2, K3 and K5 in int64 bit-exact, the "
        f"largest compared hit lower {po['max_lower']:,} > 2^32; the phase "
        f"{time.perf_counter() - t0:.1f} s; {card}")
    return rows


def write_workload(np, size, seed, tag):
    """Genome and reads from a seed -> (fasta path, fastq path, reads)."""
    fasta = os.path.join(WORK, f"genome{tag}.fa")
    fastq = os.path.join(WORK, f"reads{tag}.fq")
    from mapad_tpu_torch.tools.assembly import (
        gen_genome,
        make_reads,
        write_fastq,
    )

    t = time.perf_counter()
    genome = gen_genome(size, seed)
    write_fasta(fasta, f"bench{tag}_chr1", genome)
    reads = make_reads(genome, N_READS, seed + 100)
    write_fastq(reads, fastq)
    log(f"data{tag}: {size} bp genome, {N_READS} reads in "
        f"{time.perf_counter() - t:.1f} s")
    return fasta, fastq, reads


def write_fasta(path, name, genome):
    """One sequence of bases, 80 a line."""
    with open(path, "w") as f:
        f.write(f">{name}\n")
        s = genome.tobytes().decode()
        f.writelines(s[i : i + 80] + "\n" for i in range(0, len(s), 80))


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


def sync_cards(torch):
    """Wait for every visible card."""
    for d in range(torch.cuda.device_count()):
        torch.cuda.synchronize(d)


def reset_card_peaks(torch):
    for d in range(torch.cuda.device_count()):
        torch.cuda.reset_peak_memory_stats(d)


def card_peaks_gb(torch):
    """Each visible card's peak allocated GB since `reset_card_peaks`."""
    return [torch.cuda.max_memory_allocated(d) / 1e9
            for d in range(torch.cuda.device_count())]


def mesh_run(torch, what, engine, index, params, args, fastq, fasta,
             native_bam, card, kernels):
    """`pipeline.run` of `fastq` with a pool `engine` (one card, or a
    mesh), its BAM equal to `native_bam`.  A run makes no `shard_rebase`
    launch: a shard's K5 makes its ids global (`pack_result_rebase` counts
    those launches, one a shard and block).  Prints its reads/s, stage
    seconds, launches, shard steps with their summed efficiency and each
    card's peak memory.  -> (seconds, launch counts, the engine's stats,
    each card's peak GB)."""
    from mapad_tpu_torch._build import LAUNCHES
    from mapad_tpu_torch.map import pipeline

    bam = os.path.join(WORK, "sharded.bam")
    before = engine.stats()  # the engine may have run blocks before
    LAUNCHES.reset()
    sync_cards(torch)
    reset_card_peaks(torch)
    t = time.perf_counter()
    pipeline.run(fastq, fasta, bam, True, params, None, engine=engine,
                 position_seed=args.seed, cmdline="mapad map",
                 threads=os.cpu_count() or 1, index=index)
    sync_cards(torch)
    secs = time.perf_counter() - t
    st = stats_since(engine.stats(), before)
    peaks = card_peaks_gb(torch)
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
            f" (sum / (D x max), summed over the run's blocks)")
    log("  peak card memory, GB: " + ", ".join(
        f"cuda:{d} {gb:.3f}" for d, gb in enumerate(peaks)))
    bam_compare(bam, native_bam, what.split(",")[0])
    return secs, counts, st, peaks


def path7(torch, index, params, args, fastq, fasta, native_bam, card,
          kernels):
    """Path 1's workload through `pipeline.run` with one card's pool engine,
    then over two shards on cuda:0 (MAPAD_SHARD=1, `mesh`), and, on a
    machine with more than one card, over all of them with no `mesh` (the
    automatic mesh); each BAM equal to path 1's native BAM (`mesh_run`).
    -> the launch counts of the two-shard run (`kernels`, shard_rebase and
    pack_result_rebase) and its shards' steps."""
    from mapad_tpu_torch.ops.engine import DeviceSearchEngine

    def run(what, engine):
        secs, counts, st, _peaks = mesh_run(
            torch, what, engine, index, params, args, fastq, fasta,
            native_bam, card, kernels)
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


def knobs_alone(torch, np, cli, load_index, params, args, card, t_start):
    """`--knobs`: the knobs phase alone, with what it needs of path 1 (its
    workload, index and native BAM)."""
    import dataclasses

    from mapad_tpu_torch.models import Discrete, VindijaPwm

    fasta, fastq, reads = write_workload(np, GENOME_SIZE, 42, "")
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
    pwm = VindijaPwm()
    vparams = dataclasses.replace(
        params, difference_model=pwm, mismatch_bound=Discrete(
            args.poisson_prob, np.float32(args.divergence),
            pwm.get_representative_mismatch_penalty()))
    knobs_phase(torch, np, load_index(fasta), params, vparams, args, fastq,
                fasta, reads, native_bam, card,
                ["unpack_prep", "extend_batch", "pool_search",
                 "extract_chains", "pack_result"])
    log(f"total: {time.perf_counter() - t_start:.1f} s")
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


# --- path 14 (`--configs`): mapAD's other `map` settings -----------------

CONFIG_INDEL_RATE = 0.001  # make_reads' indels a base
CONFIG_SEED = 142          # path 1's reads' seed
CONFIG_CHECK_READS = 256   # one block's kernels against their plain versions
CONFIG_FIXED = 2048        # K2's fixed step count there
CONFIG_BATCH_READS = 256   # K10's and the int32 K7's check
# the settings run also through the hybrid engine and in big mode forced
CONFIG_BOTH_MODES = ("ds", "cutoff")
# the settings whose K10 (and int32 K7) are held against plain
CONFIG_BATCH = ("cutoff", "gaps_0_1", "gaps_10_3", "no_gaps")
# the settings with MAP_FLAGS' gap open rate and gaps allowed: records with
# an insertion and with a deletion must be among their hits
CONFIG_GAPS = ("base", "ibq", "gaps_0_1", "gaps_10_3", "abort", "rg")
# the default run's phase: the kernels of these on path 1's index
CONFIG_DEFAULT = ("cutoff", "gaps_0_1")
CONFIG_DEFAULT_FIXED = 512


def config_params(cli, name):
    """A setting of tools/configs.py on MAP_FLAGS, as the CLI builds it ->
    (flags, AlignmentParameters)."""
    from mapad_tpu_torch.tools import configs

    return (configs.flags(name, MAP_FLAGS),
            configs.parameters(cli, name, base=MAP_FLAGS))


def config_reads(genome, n, library):
    """n of path 1's kind of reads with indels at CONFIG_INDEL_RATE, of a
    `library` library."""
    from mapad_tpu_torch.tools.assembly import make_reads

    return make_reads(genome, n, CONFIG_SEED, library=library,
                      indel_rate=CONFIG_INDEL_RATE)


def config_kernels(torch, index, params, args, reads, name, fixed, card):
    """One block of `reads` under setting `name`, in both widths: K4
    (int32) or K6 and K7 (int64), then K2 at `fixed` steps, K3 and K5, each
    against its plain version; and, for the settings of CONFIG_BATCH, K10
    and the int32 K7 at CONFIG_BATCH_READS reads of the batch engine.  ->
    {kernel-table row: its figures under the setting}."""
    from mapad_tpu_torch.map.record import Record
    from mapad_tpu_torch.ops import bi_d
    from mapad_tpu_torch.ops import engine as eng
    from mapad_tpu_torch.ops import search_pool2 as sp2
    from mapad_tpu_torch.ops.engine import DeviceSearchEngine
    from mapad_tpu_torch.ops.prep import _DEV_LUT_Q

    R = CONFIG_CHECK_READS
    recs = [Record(sequence=s, base_qualities=q) for s, q in reads[:R]]
    out = {}
    for big in (False, True):
        engine = DeviceSearchEngine(index.fmd, params, lanes=args.lanes,
                                    big=big, packed_hits=True)
        idx, sfx = engine.device_index, "_i64" if big else ""
        cfg, prep, _t0 = engine._prep_block(recs, R, engine.pool_config)
        M = prep["max_len"]
        blob = torch.from_numpy(prep["blob"]).to(engine.device)
        tab, pen_tab, off = engine._device_lut()
        what = f"{name}'s reads"
        if big:
            dense = eng._unpack_prep_full(blob, tab, pen_tab, off, R, M,
                                          _DEV_LUT_Q)
            out["unpack_prep_full"] = dict(max_abs_err=compare(
                torch, dense, eng._unpack_prep_full_plain(
                    blob, tab, pen_tab, off, R, M, _DEV_LUT_Q),
                f"unpack_prep_full on {what}"), reads=R)
            rank, code, n, score_lut, pen, split, *_rest = dense
            steps = prep["bid_steps"]
            fwd = cfg.compute_forward_part
            bid = bi_d.compute_bi_d(idx, rank, pen, n, split, fwd, steps)
            out["bi_d_i64"] = dict(max_abs_err=compare(
                torch, (bid,), (bi_d.compute_bi_d_plain(
                    idx, rank, pen, n, split, fwd, steps),),
                f"bi_d_i64 on {what}"), reads=R,
                walk_steps=bi_d.walk_steps(n, split, fwd))
            consts = (n, split, *dense[6:])
            scale = dense[6]
            slut = sp2._dense_slut(idx, (rank, code, score_lut, pen), n,
                                   split, cfg, steps)
        else:
            parts = eng._unpack_prep_lut(blob, tab, off, R, M, _DEV_LUT_Q,
                                         prep["rle"])
            out["unpack_prep"] = dict(max_abs_err=compare(
                torch, parts, eng._unpack_prep_lut_plain(
                    blob, tab, off, R, M, _DEV_LUT_Q, prep["rle"]),
                f"unpack_prep on {what}"), reads=R)
            consts, slut = parts[:5], parts[5]
            scale = parts[2]
        err, res, done, indels = fixed_pool_check(
            torch, engine, consts, slut, cfg, R, fixed, what)
        if not done:
            raise AssertionError(f"K2{sfx} on {what}: no hit in {fixed} "
                                 "steps")
        live = scale[: len(recs)].cpu()
        for k in ("pool_search", "extract_chains", "pack_result"):
            out[k + sfx] = dict(max_abs_err=err, reads=R, fixed_steps=fixed,
                                chains=int(res.n_chains), hits=done,
                                indel_hits=indels)
        out["pool_search" + sfx]["scale"] = [float(live.min()),
                                             float(live.max())]
        log(f"{name}: {'K6, K7' if big else 'K4'}, K2 + K3 + K5{sfx} on "
            f"{R} reads (indels at {CONFIG_INDEL_RATE} a base), "
            f"debug_fixed_steps={fixed}: bit-exact against the plain "
            f"versions; {int(res.n_chains)} chains, {done} hits, {indels} "
            f"of them with an insertion or a deletion; bound scale "
            f"{float(live.min()):g}-{float(live.max()):g}; {card}")
        del engine
    if name in CONFIG_BATCH:
        batch = DeviceSearchEngine(index.fmd, params, mode="batch")
        got = batch_check(torch, batch, reads, CONFIG_BATCH_READS, name,
                          bid_row=True)
        for k in ("search_batch", "bi_d"):
            g = got[k]
            out[k] = dict(max_abs_err=g["max_abs_err"],
                          reads=CONFIG_BATCH_READS, ms=g["ms"],
                          plain_ms=g["plain_ms"])
    return out


def config_setting(torch, cli, name, index, fasta, fastqs, work, card):
    """Path 14 under setting `name`: `map --engine native`, then `map
    --engine device` twice (cold: with the setting's score table built;
    warm), for CONFIG_BOTH_MODES the hybrid and big mode forced, each BAM
    equal to the native one -> its figures, with `gapped` the indexes of
    the reads whose record holds an insertion or a deletion."""
    from mapad_tpu_torch.tools import configs

    flags, _params = config_params(cli, name)
    where = os.path.join(work, name)
    os.makedirs(where, exist_ok=True)
    text_len = 2 * GENOME_SIZE + 2  # both strands, two sentinels
    fastq = fastqs[configs.LIBRARY.get(name, "single_stranded")]
    log(f"path 14, {name}: map {' '.join(flags)}; {card}")
    small = CliMaps(torch, cli, f"path 14, {name}", fasta, fastq, where,
                    text_len, False, card, flags=flags)
    small.run("native", ["--engine", "native"])
    # the first run builds the setting's score table (host, once a
    # setting in a process); the second is the warm yardstick
    small.run("device", ["--engine", "device"])
    small.run("device_warm", ["--engine", "device"])
    figures = small.figures
    if name in CONFIG_BOTH_MODES:
        small.run("hybrid", [])
        big = CliMaps(torch, cli, f"path 14, {name}, big mode forced",
                      fasta, fastq, where, text_len, True, card,
                      force_big=True, flags=flags)
        big.run("big", ["--engine", "device"])
        figures.update(big.figures)
    header, recs = bam_records(small.bam("native"))
    mapped = [r for r in recs if not r[1] & 0x4]
    ins = sum(1 for r in mapped if "I" in r[5])
    dels = sum(1 for r in mapped if "D" in r[5])
    gapped = [int(r[0][4:]) for r in mapped if "I" in r[5] or "D" in r[5]]
    summary = dict(flags=flags, engines=figures, mapped=len(mapped),
                   with_insertion=ins, with_deletion=dels, gapped=gapped)
    if name == "no_gaps" and ins + dels:
        raise AssertionError(f"path 14, {name}: {ins + dels} records with "
                             "a gap")
    if name in CONFIG_GAPS and not (ins and dels):
        raise AssertionError(f"path 14, {name}: no record with an "
                             f"insertion ({ins}) or no deletion ({dels})")
    rg = configs.SETTINGS.get(name, {}).get("-R")
    if rg:
        line = rg.replace("\\t", "\t")
        rg_id = line.split("\t")[1][3:]
        if line not in header:
            raise AssertionError(f"path 14, {name}: no {line!r} in the "
                                 "header")
        if not all((b"RG", "Z", rg_id.encode()) in r[8] for r in recs):
            raise AssertionError(f"path 14, {name}: a record without "
                                 f"RG:Z:{rg_id}")
    log(f"path 14, {name}: {len(mapped)} of {len(recs)} reads mapped, "
        f"{ins} records with an insertion, {dels} with a deletion; "
        + ", ".join(f"{k} {e['reads_per_s']:.1f} reads/s"
                    for k, e in figures.items()) + f"; {card}")
    return summary


def config_genome(np, work):
    """Path 1's genome (the same seed), written once -> (fasta, bases)."""
    from mapad_tpu_torch.tools.assembly import gen_genome

    genome = gen_genome(GENOME_SIZE, 42)
    fasta = os.path.join(work, "genome.fa")
    write_fasta(fasta, "configs_chr1", genome)
    return fasta, genome


def configs_alone(torch, np, cli, load_index, args, card, t_start):
    """`--configs`: path 14 alone.  Path 1's genome and N_READS reads of
    each library with indels; under MAP_FLAGS ("base", the yardstick of
    reads/s) and each setting of tools/configs.py the native and device
    BAMs (and for CONFIG_BOTH_MODES the hybrid and big
    mode forced) equal, and one block's kernels against their plain
    versions in both widths (K10 too for CONFIG_BATCH)."""
    from mapad_tpu_torch.tools import configs
    from mapad_tpu_torch.tools.assembly import write_fastq

    work = os.path.join(WORK, "configs")
    os.makedirs(work, exist_ok=True)
    t = time.perf_counter()
    fasta, genome = config_genome(np, work)
    reads, fastqs = {}, {}
    for library in sorted(set(configs.LIBRARY.values())):
        reads[library] = config_reads(genome, N_READS, library)
        fastqs[library] = os.path.join(work, f"reads_{library}.fq")
        write_fastq(reads[library], fastqs[library])
    if cli.main(["index", "-g", fasta]) != 0:
        raise SystemExit("index failed")
    log(f"path 14: {GENOME_SIZE} bp genome (path 1's), {N_READS} reads of "
        f"each library with indels at {CONFIG_INDEL_RATE} a base, index, "
        f"in {time.perf_counter() - t:.1f} s")
    index = load_index(fasta)
    summary = {}
    for name in ["base", *configs.SETTINGS]:
        t = time.perf_counter()
        s = summary[name] = config_setting(torch, cli, name, index, fasta,
                                           fastqs, work, card)
        gapped = s.pop("gapped")
        if name != "base":  # the default run holds MAP_FLAGS' kernels
            _flags, params = config_params(cli, name)
            # the block's first half the reads whose native record holds
            # a gap, so that its chains hold insertions and deletions
            lib = reads[configs.LIBRARY[name]]
            first = gapped[: CONFIG_CHECK_READS // 2]
            taken = set(first)
            order = first + [i for i in range(len(lib)) if i not in taken]
            s["kernels"] = config_kernels(
                torch, index, params, args, [lib[i] for i in order], name,
                CONFIG_FIXED, card)
        s["seconds"] = time.perf_counter() - t
        log(json.dumps({"configs_" + name: s}))
    base = summary["base"]["engines"]["device_warm"]["reads_per_s"]
    log("path 14, map --engine device (warm) against MAP_FLAGS on the same "
        "reads: " + ", ".join(
            f"{k} {s['engines']['device_warm']['reads_per_s'] / base:.3f}x"
            for k, s in summary.items()) + f"; {card}")
    log(f"total: {time.perf_counter() - t_start:.1f} s")
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def configs_phase(torch, np, cli, index, args, card):
    """The default run's part of path 14: the kernels of CONFIG_DEFAULT's
    settings (the Continuous bound's scale, the gap settings (0, 1)) on
    path 1's index, each against its plain version -> {kernel-table row:
    {setting: its figures}}."""
    from mapad_tpu_torch.tools.assembly import gen_genome

    t = time.perf_counter()
    reads = config_reads(gen_genome(GENOME_SIZE, 42), CONFIG_CHECK_READS,
                         "single_stranded")
    rows = {}
    for name in CONFIG_DEFAULT:
        _flags, params = config_params(cli, name)
        for row, figs in config_kernels(torch, index, params, args, reads,
                                        name, CONFIG_DEFAULT_FIXED,
                                        card).items():
            rows.setdefault(row, {})[name] = figs
    log(f"path 14's kernels ({', '.join(CONFIG_DEFAULT)}): "
        f"{time.perf_counter() - t:.1f} s")
    return rows


# --- path 15 (`--long [SCALE]`): runs of a user's length ------------------

LONG_READS = 524_288      # (a): sheets of 250,000, 250,000 and 24,288
LONG_BIG_READS = 262_144  # (b): sheets of 250,000 and 12,144
LONG_SHORT_READS = 16_384  # (a)'s yardstick: path 1's length, same reads
LONG_SCALE = ASSEMBLY_SMALL_SCALE  # (b)'s assembly (8.3 Mbp)
LONG_BATCH = 250_000  # mapAD's default --batch_size, the CLI's
LONG_CARD_BYTES = 64 << 20  # card memory a later sheet may add
LONG_RSS_SHARE = 0.05       # host RSS a later sheet may add
SHEETS_READS = 24_576       # the default run's phase: sheets of 10,000,
SHEETS_BATCH = 10_000       # 10,000 and 4,576 (two short blocks mid-stream)
# the engines of a long run, the native one first (its BAM the yardstick)
LONG_ENGINES = (("native", ["--engine", "native"]),
                ("device", ["--engine", "device"]),
                ("hybrid", []))


def settled_threads(before):
    """Python threads alive once the threads started since `before` (a
    set of threads) have ended or 10 s have passed, after a collection of
    the engines a run left behind: their pools' threads end with them."""
    import gc

    gc.collect()
    deadline = time.perf_counter() + 10
    for t in threading.enumerate():
        if t not in before and t is not threading.current_thread():
            t.join(timeout=max(0.0, deadline - time.perf_counter()))
    return threading.active_count()


def sheet_sizes(n, batch):
    return [min(batch, n - lo) for lo in range(0, n, batch)]


def block_of(big):
    """The engine's block of one card: MAPAD_BLOCK_READS, else 4096 reads
    in big mode and 8192 in int32 (at the CLI's lanes)."""
    return int(os.environ.get("MAPAD_BLOCK_READS", 0)) or (
        4096 if big else 8192)


def expected_launches(big, blocks, lut):
    """Each kernel's launches for `blocks` invocations of one store
    generation each, `lut` of them uploaded as the device-LUT blob: K4 (or
    K6) on those, K7 on every block, K1 one a K2 generation (K7's own
    besides), K2 an init and a generation, K3 and K5 one each."""
    if big:
        return dict(unpack_prep_full=lut, bi_d_i64=blocks,
                    extend_batch_i64=2 * blocks, pool_search_i64=2 * blocks,
                    extract_chains_i64=blocks, pack_result_i64=blocks)
    return dict(unpack_prep=lut, extend_batch=blocks,
                pool_search=2 * blocks, extract_chains=blocks,
                pack_result=blocks)


def block_routes(run, what):
    """The upload route of each block a watched run prepared, held to its
    reads: the device-LUT blob (K4, or K6) where every base quality of
    the reads that fit the pool is below the LUT's ceiling, the
    host-scored rows (or big mode's dense arrays) where one is not -> the
    number of device-LUT blocks."""
    from mapad_tpu_torch.ops.prep import _DEV_LUT_Q

    blocks = run["blocks"]
    wrong = [(i, b) for i, b in enumerate(blocks) if b["route"] != (
        "lut" if b["max_qual"] < _DEV_LUT_Q else "host")]
    if wrong:
        raise AssertionError(f"{what}: {len(wrong)} blocks took the other "
                             f"upload route, the first {wrong[:3]}")
    return sum(b["route"] == "lut" for b in blocks)


def sheets_check(what, e, run, batch, n, card, hold_memory=True):
    """A watched run of `n` reads in sheets of `batch`: the sheets and
    input blocks it pulled, its launches against its blocks, and where
    `hold_memory` card memory within LONG_CARD_BYTES of the first sheet's
    end at every later sheet boundary (a drop allowed at the run's end,
    when nothing is in flight), host RSS within LONG_RSS_SHARE of it ->
    its sheet figures (reads/s of each sheet as the engine pulled it)."""
    sizes, block = sheet_sizes(n, batch), block_of(e["big"])
    if run["sheets"] != sizes:
        raise AssertionError(f"{what}: sheets {run['sheets']}, not {sizes}")
    blocks = sum(-(-k // block) for k in sizes)
    if run["input_blocks"] != blocks:
        raise AssertionError(f"{what}: {run['input_blocks']} input blocks, "
                             f"not {blocks}")
    short = [k % block for k in sizes if k % block]
    tiers = run["tier_blocks"]
    from mapad_tpu_torch.tools.sheets import deep_before

    before = deep_before(run) if tiers else 0
    lut = block_routes(run, what)
    want = expected_launches(e["big"], blocks + len(tiers), lut)
    if e["launches"] != want:
        raise AssertionError(f"{what}: launches {e['launches']} against "
                             f"{want} for {blocks} input and {len(tiers)} "
                             f"tier blocks, {lut} of them device-LUT")
    samples = run["samples"]
    first = samples[0]
    rows, bad = [], []
    t_prev = n_prev = 0
    prev = dict.fromkeys(samples[0]["stats"], 0)
    for i, s in enumerate(samples):
        d_alloc = s["allocated"] - first["allocated"]
        d_res = s["reserved"] - first["reserved"]
        d_rss = s["rss"] - first["rss"]
        rate = (s["reads"] - n_prev) / max(s["seconds"] - t_prev, 1e-9)
        t_prev, n_prev = s["seconds"], s["reads"]
        # the sheet's blocks and stage seconds a block
        st = {k: v - prev[k] for k, v in s["stats"].items()}
        prev = s["stats"]
        n_blocks = max(st.pop("batches"), 1)
        rows.append(dict(sheet=i, reads_per_s=rate, blocks=n_blocks,
                         ms_a_block={k: v * 1e3 / n_blocks
                                     for k, v in st.items()},
                         allocated_mib=s["allocated"] / 2**20,
                         reserved_mib=s["reserved"] / 2**20,
                         rss_gib=s["rss"] / 2**30,
                         device_fraction=s.get("device_fraction")))
        if i:
            end = i == len(samples) - 1
            for k, d in (("allocated", d_alloc), ("reserved", d_res)):
                if d > LONG_CARD_BYTES or (not end
                                           and -d > LONG_CARD_BYTES):
                    bad.append(f"{k} {d / 2**20:+.1f} MiB after sheet {i}")
            if d_rss > LONG_RSS_SHARE * first["rss"]:
                bad.append(f"rss {d_rss / 2**20:+.1f} MiB after sheet {i}")
    log(f"{what}: sheets {sizes} (short blocks {short}); {blocks} input "
        f"blocks, {len(tiers)} tier blocks ({before} prepared before the "
        f"input ran out; reads {tiers}), {lut} of them device-LUT; "
        f"launches {e['launches']}, as the blocks imply")
    for r in rows:
        log(f"  sheet {r['sheet']}: {r['reads_per_s']:.1f} reads/s; "
            f"{r['blocks']} blocks, ms a block: " + ", ".join(
                f"{k} {v:.1f}" for k, v in r["ms_a_block"].items()))
        log(f"  sheet {r['sheet']}: card "
            f"allocated {r['allocated_mib']:.1f} MiB, reserved "
            f"{r['reserved_mib']:.1f} MiB; host RSS {r['rss_gib']:.3f} GiB"
            + (f"; device fraction {r['device_fraction']:.3f}"
               if r["device_fraction"] is not None else "") + f"; {card}")
    if bad and hold_memory:
        raise AssertionError(f"{what}: memory grew across sheets: {bad}")
    return dict(sheets=rows, input_blocks=blocks, short_blocks=short,
                tier_blocks=tiers, tier_blocks_before_drained=before,
                tier_blocks_after_drained=len(tiers) - before,
                exhausted=run["exhausted"], lut_blocks=lut,
                routes=route_figures(run))


def route_figures(run):
    """A watched run's blocks by upload route -> {route: blocks, mean prep
    ms a block, mean ms of the device thread a block}."""
    out = {}
    for r in ("lut", "host"):
        prep = [b["prep_s"] for b in run["blocks"] if b["route"] == r]
        dev = [b["device_s"] for b in run["runs"] if b["route"] == r]
        if prep:
            out[r] = dict(blocks=len(prep),
                          prep_ms=sum(prep) * 1e3 / len(prep),
                          device_ms=sum(dev) * 1e3 / max(len(dev), 1))
    return out


def watched_maps(torch, maps, n, batch, card, what):
    """LONG_ENGINES through `maps` (a CliMaps of `n` reads), each inside a
    SheetWatch, the threads left after each counted -> {engine: its
    figures}; the streaming runs held to `sheets_check`, the threads to the
    first run's count."""
    from mapad_tpu_torch.tools.sheets import SheetWatch

    out, threads = {}, None
    for key, extra in LONG_ENGINES:
        before = set(threading.enumerate())
        with SheetWatch(torch) as watch:
            e = maps.run(key, extra)
        e["threads"] = settled_threads(before)
        log(f"{what}, {key}: {e['threads']} Python threads after the run")
        threads = e["threads"] if threads is None else threads
        if e["threads"] != threads:
            raise AssertionError(f"{what}, {key}: {e['threads']} threads "
                                 f"after the run, {threads} after the first")
        if key != "native":
            e.update(sheets_check(f"{what}, {key}", e, watch.runs[-1],
                                  batch, n, card))
            st = e["stats"]
            log(f"  {key}: {e['reads_per_s']:.1f} reads/s; stage seconds "
                + ", ".join(f"{k} {st[k]:.3f}" for k in (
                    "prep_s", "device_s", "wait_s", "decode_s", "fb_secs"))
                + f"; escalated {st['escalated']} by cause {st['esc_why']};"
                f" {card}")
        out[key] = e
    return out


def long_alone(torch, np, cli, load_index, card, t_start, scale, phases):
    """`--long [SCALE] [--phases ab]`: path 15, runs of a user's length,
    the phases named (both by default).  (a) path 1's
    genome and LONG_READS of its reads with indels (three sheets at the
    default --batch_size of 250,000, each ending in a short block), after
    their first LONG_SHORT_READS as the yardstick of path 1's length: `map`
    with each of LONG_ENGINES through the CLI; (b) the GRCh37-shaped
    assembly at SCALE and LONG_BIG_READS of its reads (two sheets) in big
    mode (forced below 2^31, chosen by the engine above), the deep tier at
    its default (on), the BAMs also held to the assembly's invariants.
    Every BAM equals the native one; card memory, host RSS and the threads
    stay flat across sheets and runs, the launches are what the blocks
    imply, and in (b) a deep block is prepared before the input runs out.
    """
    batch = cli.build_parser().parse_args(
        ["map", "-r", "x", "-g", "x", "-o", "x", *MAP_FLAGS]).chunk_size
    if batch != LONG_BATCH:
        raise AssertionError(f"the CLI's --batch_size is {batch}, not "
                             f"{LONG_BATCH}")
    work = os.path.join(WORK, "long")
    os.makedirs(work, exist_ok=True)
    summary = dict(card=card, scale=scale, phases=phases)
    if "a" in phases:
        summary["a"] = long_a(torch, np, cli, card, work)
    if "b" in phases:
        summary["b"] = long_b(torch, cli, card, work, scale)
    log(f"total: {time.perf_counter() - t_start:.1f} s")
    log(card)
    print(json.dumps({"long": summary}, default=str), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def long_a(torch, np, cli, card, work):
    """Path 15 (a) -> its figures."""
    global N_READS
    from mapad_tpu_torch.tools.assembly import write_fastq

    t = time.perf_counter()
    fasta, genome = config_genome(np, work)
    reads = config_reads(genome, LONG_READS, "single_stranded")
    fastq = os.path.join(work, "reads.fq")
    short_fq = os.path.join(work, "reads_short.fq")
    write_fastq(reads, fastq)
    write_fastq(reads[:LONG_SHORT_READS], short_fq)
    del reads
    if cli.main(["index", "-g", fasta]) != 0:
        raise SystemExit("index failed")
    log(f"path 15 (a): {GENOME_SIZE} bp genome (path 1's), {LONG_READS} "
        f"reads with indels at {CONFIG_INDEL_RATE} a base, index, in "
        f"{time.perf_counter() - t:.1f} s; {card}")
    text_len = 2 * GENOME_SIZE + 2
    N_READS = LONG_SHORT_READS
    short = CliMaps(torch, cli, "path 15 (a), path 1's length", fasta,
                    short_fq, os.path.join(work, "short"), text_len, False,
                    card)
    os.makedirs(short.work, exist_ok=True)
    for key, extra in LONG_ENGINES:
        short.run(key, extra)
    N_READS = LONG_READS
    maps = CliMaps(torch, cli, "path 15 (a)", fasta, fastq,
                   os.path.join(work, "a"), text_len, False, card)
    os.makedirs(maps.work, exist_ok=True)
    runs = watched_maps(torch, maps, LONG_READS, LONG_BATCH, card,
                          "path 15 (a)")
    for key, e in runs.items():
        ratio = e["reads_per_s"] / short.figures[key]["reads_per_s"]
        log(f"path 15 (a), {key}: {e['reads_per_s']:.1f} reads/s over "
            f"{LONG_READS} reads against "
            f"{short.figures[key]['reads_per_s']:.1f} over "
            f"{LONG_SHORT_READS} ({ratio:.3f}x); {card}")
    hyb = runs["hybrid"]["stats"]
    log(f"path 15 (a), hybrid: device fraction at each sheet's end "
        f"{[r['device_fraction'] for r in runs['hybrid']['sheets']]}, "
        f"reads on the device {hyb['hybrid_device_reads']}, on the host "
        f"{hyb['hybrid_native_reads']}; {card}")
    return dict(short=short.figures, long=runs)


def long_b(torch, cli, card, work, scale):
    """Path 15 (b): the assembly in big mode, the deep tier mid-stream
    -> its figures."""
    global N_READS
    N_READS = LONG_BIG_READS
    awork = os.path.join(WORK, "assembly")
    w = assembly_make(scale, awork)
    index_s, index_peak = cli_index(w["fasta"], w["lay"].text_len, awork,
                                    "path 15 (b)", card)
    text_len = w["lay"].text_len
    chosen = text_len >= BIG_TEXT_MIN
    maps = CliMaps(torch, cli, "path 15 (b)", w["fasta"], w["fastq"],
                   os.path.join(work, "b"), text_len, True, card,
                   force_big=not chosen)
    os.makedirs(maps.work, exist_ok=True)
    runs = watched_maps(torch, maps, LONG_BIG_READS, LONG_BATCH, card,
                          "path 15 (b)")
    got = assembly_invariants(w, maps.bam("native"), "path 15 (b)",
                              text_len > 2**31)
    for key in ("device", "hybrid"):
        e = runs[key]
        log(f"path 15 (b), {key}: deep blocks {len(e['tier_blocks'])}, "
            f"{e['tier_blocks_before_drained']} prepared before the input "
            f"ran out, {e['tier_blocks_after_drained']} after; deep_retried "
            f"{e['stats']['deep_retried']}, nohit_host "
            f"{e['stats']['nohit_host']}; {card}")
    if not runs["device"]["tier_blocks_before_drained"]:
        raise AssertionError("path 15 (b): no deep block before the input "
                             "ran out")
    hyb = runs["hybrid"]["stats"]
    log(f"path 15 (b), hybrid: device fraction at each sheet's end "
        f"{[r['device_fraction'] for r in runs['hybrid']['sheets']]}, "
        f"reads on the device {hyb['hybrid_device_reads']}, on the host "
        f"{hyb['hybrid_native_reads']}; {card}")
    return dict(big="chosen" if chosen else "forced", index_s=index_s,
                index_peak_gib=index_peak, long=runs,
                records={k: v for k, v in got.items() if isinstance(v, int)})


def sheets_phase(torch, np, cli, fasta, card, kernels):
    """The default run's multi-sheet stream: SHEETS_READS of path 1's kind
    of reads through `map --engine device` and `--engine native` at
    --batch_size SHEETS_BATCH (sheets of 10,000, 10,000 and 4,576: two
    short blocks mid-stream), the BAMs equal, the launches what the blocks
    imply -> the launches of `kernels` in the device run (counted from 0
    just before it)."""
    from mapad_tpu_torch.tools.assembly import gen_genome, make_reads
    from mapad_tpu_torch.tools.sheets import SheetWatch

    global N_READS
    t = time.perf_counter()
    work = os.path.join(WORK, "sheets")
    os.makedirs(work, exist_ok=True)
    fastq = os.path.join(work, "reads.fq")
    from mapad_tpu_torch.tools.assembly import write_fastq

    write_fastq(make_reads(gen_genome(GENOME_SIZE, 42), SHEETS_READS, 142),
                fastq)
    saved, N_READS = N_READS, SHEETS_READS
    try:
        maps = CliMaps(torch, cli, "multi-sheet phase", fasta, fastq, work,
                       2 * GENOME_SIZE + 2, False, card)
        maps.argv += ["--batch_size", str(SHEETS_BATCH)]
        maps.run("native", ["--engine", "native"])
        with SheetWatch(torch) as watch:
            e = maps.run("device", ["--engine", "device"])
        # its first sheet ends two blocks into the run, before the
        # pipeline's steady state: memory is printed, not held
        sheets_check("multi-sheet phase", e, watch.runs[-1], SHEETS_BATCH,
                     SHEETS_READS, card, hold_memory=False)
    finally:
        N_READS = saved
    log(f"multi-sheet phase: {time.perf_counter() - t:.1f} s")
    return {k: e["launches"][k] for k in kernels}


# --- path 16 (`--inputs [SCALE]`): mapAD's input as its users supply it ---

INPUTS_READS = LONG_READS          # (a): sheets of 250,000, 250,000, 24,288
INPUTS_BIG_READS = LONG_BIG_READS  # (b): sheets of 250,000 and 12,144
INPUTS_SEED = 20
INPUTS_SCALE = LONG_SCALE          # (b)'s assembly
INPUTS_QLESS = (16_384, 8_192)  # the first sheet's third 8,192-read block
#                                 (its fifth and sixth of 4,096 in big mode)
INPUTS_RG = "@RG\tID:x\tSM:y"
INPUTS_DISPATCH_READS = 65_536  # (d): four chunks of INPUTS_CHUNK
INPUTS_CHUNK = 16_384
INPUTS_SHORT_READS = SHEETS_READS     # the default run's form, in sheets of
INPUTS_SHORT_QLESS = (10_000, 8_192)  # SHEETS_BATCH: the second sheet's
#                                       first block quality-less
INPUTS_CHECK_READS = 256  # one block of this input against the plain kernels
INPUTS_FIXED = 512        # K2's fixed step count there


@contextlib.contextmanager
def piped_stdin(path):
    """sys.stdin fed by `cat path` through a pipe, as `cat path | map -r -`
    feeds it."""
    proc = subprocess.Popen(["cat", path], stdout=subprocess.PIPE)
    saved, sys.stdin = sys.stdin, io.TextIOWrapper(proc.stdout)
    try:
        yield
    finally:
        sys.stdin = saved
        proc.stdout.close()
        proc.kill()
        proc.wait()


def decode_seconds(path, what, card, stdin=False):
    """Seconds to pull every sheet of `path` (or, with `stdin`, of `path`
    piped into stdin) through the InputSource the pipeline reads, records
    converted, at mapAD's --batch_size -> (seconds, records)."""
    from mapad_tpu_torch.io.sniff import InputSource

    t = time.perf_counter()
    with piped_stdin(path) if stdin else contextlib.nullcontext():
        src = InputSource.from_path("-" if stdin else path)
        n = sum(len(sheet.records) for sheet in src.task_queue(LONG_BATCH))
    secs = time.perf_counter() - t
    log(f"decode of {what} ({src.kind}{', stdin' if stdin else ''}): {n} "
        f"records in {secs:.2f} s = {n / secs:.1f} records/s (the "
        f"InputSource alone, on the host; {card})")
    return secs, n


def inputs_checks(truth, maps, runs, what, card, read_group=None):
    """Path 16's checks of one input's maps (`runs`, CliMaps figures by
    engine; every BAM already equal to the native one): the native and
    device BAMs held to the input (`pipeline_bam.check_output`), the
    overlong reads among the device engine's escalations (and the
    hybrid's), the routes' costs printed -> the checks' counts."""
    from mapad_tpu_torch.tools import pipeline_bam as pb

    out = {}
    for key in ("native", "device"):
        if key in runs:
            out[key] = pb.check_output(truth, maps.bam(key), read_group)
    log(f"{what}: the native and device BAMs held to the input: "
        f"{out.get('native') or out.get('device')} (names, flags less the "
        f"mate bits, tags less the filtered ones in order, quality-less "
        f"QUAL, 0x10 records as their forward twins)")
    overlong = int(truth.overlong.sum())
    for key, e in runs.items():
        if key == "native":
            continue
        got = e["stats"]["esc_why"]["overlong"]
        if (got != overlong if key == "device"
                else not 0 < got <= overlong):
            raise AssertionError(f"{what}, {key}: {got} reads escalated as "
                                 f"overlong, the input holds {overlong}")
        for route, r in e.get("routes", {}).items():
            log(f"  {key}, {route} blocks: {r['blocks']}, prep "
                f"{r['prep_ms']:.1f} ms a block, device thread "
                f"{r['device_ms']:.1f} ms a block; {card}")
        log(f"  {key}: {got} of the input's {overlong} overlong reads "
            f"escalated as such; {e['reads_per_s']:.1f} reads/s; {card}")
        if "device_fraction" in e["stats"] and e["stats"]["device_fraction"]:
            log(f"  {key}: device fraction {e['stats']['device_fraction']:.3f}"
                f", reads on the device {e['stats']['hybrid_device_reads']},"
                f" on the host {e['stats']['hybrid_native_reads']}")
    return out


def inputs_small(np, cli, work, card):
    """Path 1's genome (written and indexed in `work`) and a pipeline BAM
    of INPUTS_READS of its records -> dict: fasta, bam, truth."""
    from mapad_tpu_torch.tools import pipeline_bam as pb

    t, n = time.perf_counter(), INPUTS_READS
    fasta, genome = config_genome(np, work)
    if not os.path.exists(os.path.join(f"{fasta}.tpx", "meta.json")):
        if cli.main(["index", "-g", fasta]) != 0:
            raise SystemExit("index failed")
    bam = os.path.join(work, f"pipeline_{n}.bam")
    truth = pb.make(bam, genome, n, INPUTS_SEED, qualityless=INPUTS_QLESS)
    log(f"path 16: path 1's genome ({GENOME_SIZE} bp) and a pipeline BAM of "
        f"{truth.counts()} in {time.perf_counter() - t:.1f} s; {card}")
    return dict(fasta=fasta, bam=bam, truth=truth, work=work)


def inputs_a(torch, cli, a, card):
    """Path 16 (a): the pipeline BAM through `map` with each of
    LONG_ENGINES at the CLI's defaults -> its figures."""
    global N_READS
    N_READS = INPUTS_READS
    maps = CliMaps(torch, cli, "path 16 (a)", a["fasta"], a["bam"],
                   os.path.join(a["work"], "a"), 2 * GENOME_SIZE + 2, False,
                   card)
    os.makedirs(maps.work, exist_ok=True)
    runs = watched_maps(torch, maps, INPUTS_READS, LONG_BATCH, card,
                        "path 16 (a)")
    checks = inputs_checks(a["truth"], maps, runs, "path 16 (a)", card)
    secs, _n = decode_seconds(a["bam"], "path 16 (a)'s BAM", card)
    for key, e in runs.items():
        log(f"path 16 (a), {key}: the BAM's decode alone {secs:.2f} s, "
            f"{secs / e['seconds']:.3f} of this map's wall "
            f"({e['seconds']:.2f} s)")
    return dict(runs=runs, checks=checks, decode_s=secs)


def inputs_b(torch, cli, card, scale):
    """Path 16 (b): the assembly at `scale` and a pipeline BAM of its reads
    (starts at its N-run edges, short runs and joins among them) in big
    mode (forced below 2^31) -> its figures."""
    global N_READS
    from mapad_tpu_torch.tools import assembly
    from mapad_tpu_torch.tools import pipeline_bam as pb

    awork = os.path.join(WORK, "assembly")
    t = time.perf_counter()
    lay, bases, _r, _k, fasta, _fq = assembly.make(awork, scale,
                                                  ASSEMBLY_SEED, 1)
    starts, kinds = assembly.read_starts(lay, INPUTS_BIG_READS, INPUTS_SEED)
    bam = os.path.join(WORK, "inputs", f"assembly_{scale:g}.bam")
    truth = pb.make(bam, bases, INPUTS_BIG_READS, INPUTS_SEED, starts=starts,
                    qualityless=INPUTS_QLESS)
    log(f"path 16 (b): the assembly at {scale:g} ({lay.text_len:,} "
        f"symbols) and a pipeline BAM of {truth.counts()} "
        f"({int((kinds != '').sum())} starts at edges) in "
        f"{time.perf_counter() - t:.1f} s")
    cli_index(fasta, lay.text_len, awork, "path 16 (b)", card)
    chosen = lay.text_len >= BIG_TEXT_MIN
    N_READS = INPUTS_BIG_READS
    maps = CliMaps(torch, cli, "path 16 (b)", fasta, bam,
                   os.path.join(WORK, "inputs", "b"), lay.text_len, True,
                   card, force_big=not chosen)
    os.makedirs(maps.work, exist_ok=True)
    runs = watched_maps(torch, maps, INPUTS_BIG_READS, LONG_BATCH, card,
                        "path 16 (b)")
    inv = bam_invariants(lay, bases, maps.bam("native"), "path 16 (b)")
    checks = inputs_checks(truth, maps, runs, "path 16 (b)", card)
    return dict(big="chosen" if chosen else "forced", runs=runs,
                checks=checks,
                records={k: v for k, v in inv.items() if isinstance(v, int)})


def stdin_run(torch, maps, key, path, n, batch, card, what):
    """`maps.run(key)` with its input `path` piped into `map -r -`, watched
    and held to `sheets_check` -> its figures."""
    from mapad_tpu_torch.tools.sheets import SheetWatch

    at = maps.argv.index(path)
    maps.argv[at] = "-"
    try:
        with SheetWatch(torch) as watch, piped_stdin(path):
            e = maps.run(key, ["--engine", "device"])
    finally:
        maps.argv[at] = path
    e.update(sheets_check(what, e, watch.runs[-1], batch, n, card,
                          hold_memory=False))
    return e


def inputs_c(torch, cli, a, card):
    """Path 16 (c): the BAM of (a) piped into `map -r -` with `--engine
    device` and `-R` against `--engine native` on the file with the same
    `-R`; (a)'s merged reads as a `.fastq.gz`, device against native; the
    decode alone of each input and of the same reads as a FASTQ -> its
    figures."""
    global N_READS
    from mapad_tpu_torch.tools import pipeline_bam as pb
    from mapad_tpu_torch.tools.sheets import SheetWatch

    truth, work = a["truth"], os.path.join(a["work"], "c")
    os.makedirs(work, exist_ok=True)
    N_READS = INPUTS_READS
    maps = CliMaps(torch, cli, "path 16 (c), -R", a["fasta"], a["bam"], work,
                   2 * GENOME_SIZE + 2, False, card,
                   flags=[*MAP_FLAGS, "-R", INPUTS_RG])
    maps.run("native", ["--engine", "native"])
    e = stdin_run(torch, maps, "device", a["bam"], INPUTS_READS,
                  LONG_BATCH, card, "path 16 (c), stdin -R")
    runs = dict(native=maps.figures["native"], device=e)
    checks = inputs_checks(truth, maps, runs, "path 16 (c), stdin -R", card,
                           read_group="x")

    gz = os.path.join(work, "merged.fastq.gz")
    fq = os.path.join(work, "merged.fq")
    N_READS = pb.write_fastq_gz(gz, truth)
    with gzip.open(gz, "rb") as f_in, open(fq, "wb") as f_out:
        shutil.copyfileobj(f_in, f_out)
    gz_maps = CliMaps(torch, cli, "path 16 (c), .fastq.gz", a["fasta"], gz,
                      os.path.join(work, "gz"), 2 * GENOME_SIZE + 2, False,
                      card)
    os.makedirs(gz_maps.work, exist_ok=True)
    gz_maps.run("native", ["--engine", "native"])
    with SheetWatch(torch) as watch:
        g = gz_maps.run("device", ["--engine", "device"])
    g.update(sheets_check("path 16 (c), .fastq.gz", g, watch.runs[-1],
                          LONG_BATCH, N_READS, card, hold_memory=False))
    decode = {}
    for what, path, stdin in (("the BAM", a["bam"], False),
                              ("the BAM", a["bam"], True),
                              ("the merged reads' .fastq.gz", gz, False),
                              ("the merged reads' FASTQ", fq, False)):
        decode[f"{what}{' on stdin' if stdin else ''}"] = decode_seconds(
            path, what, card, stdin)
    return dict(stdin=runs, fastq_gz=dict(native=gz_maps.figures["native"],
                                          device=g),
                merged_reads=N_READS, checks=checks, decode=decode)


def kill_second_taker(what, seen):
    """A `dispatcher_run` hook: the first CLI worker to take its second
    chunk, that is after its first result, is sent SIGKILL, and the
    dispatcher must queue its chunk again.  Stores in `seen` the
    dispatcher's `_Lines`, the killed worker's index, the chunk it held and
    the other worker's `_Lines`."""
    def hook(dispatcher, workers, procs):
        end = time.perf_counter() + PATH9_TIMEOUT
        while True:
            taken = [[ln for ln in list(w.lines) if "Map chunk" in ln]
                     for w in workers]
            k = next((k for k in (0, 1) if len(taken[k]) >= 2), None)
            if k is not None:
                break
            if dispatcher.proc.poll() is not None or (
                    time.perf_counter() > end):
                raise AssertionError(
                    f"{what}: no worker took a second chunk:\n"
                    + "\n".join(w.tail() for w in (dispatcher, *workers)))
            time.sleep(0.02)
        procs[k].kill()
        procs[k].wait()
        seen.update(dispatcher=dispatcher, k=k, other=workers[1 - k],
                    held=int(re.search(r"Map chunk (\d+)",
                                       taken[k][-1]).group(1)))
        dispatcher.wait_for("Re-queue chunk", PATH9_TIMEOUT,
                            f"{what}: the dispatcher")
        return {k}
    return hook


def inputs_d(cli, a, card):
    """Path 16 (d): the first INPUTS_DISPATCH_READS records of (a)'s BAM
    through `map --dispatcher` with two CLI workers on the card, one killed
    holding a chunk (`dispatcher_run`, `kill_second_taker`) -> its
    figures."""
    global N_READS
    from mapad_tpu_torch.tools import pipeline_bam as pb

    work = os.path.join(a["work"], "d")
    os.makedirs(work, exist_ok=True)
    N_READS = INPUTS_DISPATCH_READS
    bam = os.path.join(work, "head.bam")
    truth = pb.head(a["truth"], a["bam"], bam, N_READS)
    native = os.path.join(work, "native.bam")
    t = time.perf_counter()
    if cli.main(["--seed", "0", "--threads", "0", "map", "-r", bam, "-g",
                 a["fasta"], "-o", native, "--force_overwrite", "--engine",
                 "native", *MAP_FLAGS, "--batch_size",
                 str(INPUTS_CHUNK)]) != 0:
        raise SystemExit("native map failed")
    log(f"path 16 (d): map --seed 0 --engine native --batch_size "
        f"{INPUTS_CHUNK}: {time.perf_counter() - t:.2f} s")
    checks = pb.check_output(truth, native)
    what, seen = "path 16 (d)", {}
    secs, _, _ = dispatcher_run(
        what, a["fasta"], bam, native, os.path.join(work, "dispatched.bam"),
        [["--device", "cuda:0"]] * 2, dict(os.environ, MAPAD_SHARD="0"),
        batch_size=INPUTS_CHUNK, while_waiting=kill_second_taker(what, seen))
    killed = seen["held"]
    requeued = [int(m) for m in re.findall(
        r"Re-queue chunk (\d+)", "\n".join(seen["dispatcher"].lines))]
    mapped = [int(m) for m in re.findall(
        r"Map chunk (\d+)", "\n".join(seen["other"].lines))]
    log(f"{what}: worker {seen['k'] + 1} killed holding chunk {killed}; the "
        f"dispatcher requeued {requeued}; the other worker mapped chunks "
        f"{mapped}")
    if requeued != [killed] or killed not in mapped:
        raise AssertionError(f"{what}: chunk {killed} of the killed worker "
                             f"requeued {requeued}, the other worker mapped "
                             f"{mapped}")
    log(f"path 16 (d), map --dispatcher with two workers on cuda:0, one "
        f"killed: {N_READS} records in {secs:.2f} s = {N_READS / secs:.1f} "
        f"reads/s, dispatcher start to BAM; {card}")
    return dict(seconds=secs, reads_per_s=N_READS / secs, killed=killed,
                other_mapped=mapped, checks=checks)


def inputs_kernels(torch, small, big, truth, card):
    """The kernels on one block of this input against their plain versions:
    on INPUTS_CHECK_READS quality-less reads in the host-scored upload, K2
    at INPUTS_FIXED steps, K3 and K5 (int32); on as many reads led by
    those holding `=` and IUPAC codes, K4 (int32), then K6, K7, K2, K3 and
    K5 (int64).  -> {kernel-table row: its `inputs` keys}."""
    import numpy as np

    from mapad_tpu_torch.map.record import Record
    from mapad_tpu_torch.ops import bi_d
    from mapad_tpu_torch.ops import engine as eng
    from mapad_tpu_torch.ops.prep import _DEV_LUT_Q
    from mapad_tpu_torch.ops import search_pool2 as sp2
    from mapad_tpu_torch.tools import pipeline_bam as pb

    R = INPUTS_CHECK_READS
    lens = np.array([len(s) for s in truth.sequences])
    fits = (lens > 0) & ~truth.overlong

    def block(first):
        rest = np.flatnonzero(fits & ~first & ~truth.qualityless)
        idx = [*np.flatnonzero(fits & first), *rest][:R]
        return [Record.from_bam(truth.names[i], int(truth.flags[i]),
                                truth.sequences[i], truth.qualities[i],
                                truth.tags[i]) for i in idx]

    qless = block(truth.qualityless)
    iupac = block((truth.kinds == pb.IUPAC) & ~truth.qualityless)
    n_iupac = sum(any(c not in b"ACGTN" for c in r.sequence) for r in iupac)
    out = {}

    def pool(engine, consts, slut, cfg, what, key):
        err, res, done, _ = fixed_pool_check(torch, engine, consts, slut,
                                             cfg, R, INPUTS_FIXED, what)
        if not done:
            raise AssertionError(f"{what}: no hit in {INPUTS_FIXED} steps")
        sfx = "_i64" if engine.device_index.big else ""
        for name in ("pool_search", "extract_chains", "pack_result"):
            out.setdefault(name + sfx, {})[key] = dict(
                max_abs_err=err, reads=R, fixed_steps=INPUTS_FIXED,
                chains=int(res.n_chains), hits=done)
        log(f"K2 + K3 + K5{sfx} on {what}: {R} reads, debug_fixed_steps="
            f"{INPUTS_FIXED}, bit-exact against the plain versions; "
            f"{int(res.n_chains)} chains, {done} of them hits; {card}")

    cfg, prep, _t0 = small._prep_block(qless, R, small.pool_config)
    if prep["dev_lut"]:
        raise AssertionError("a quality-less block took the device-LUT blob")
    consts, kw = small._upload(prep)
    pool(small, consts, kw["slut"], cfg,
         "a quality-less block (host-scored rows, no K4)", "qualityless")

    tab, pen_tab, off = small._device_lut()
    cfg, prep, _t0 = small._prep_block(iupac, R, small.pool_config)
    if not prep["dev_lut"]:
        raise AssertionError("a block of quality reads took the host-scored "
                             "rows")
    M = prep["max_len"]
    blob = torch.from_numpy(prep["blob"]).to(small.device)
    parts = eng._unpack_prep_lut(blob, tab, off, R, M, _DEV_LUT_Q,
                                 prep["rle"])
    out["unpack_prep"] = {"iupac": dict(max_abs_err=compare(
        torch, parts, eng._unpack_prep_lut_plain(
            blob, tab, off, R, M, _DEV_LUT_Q, prep["rle"]),
        "unpack_prep on a block with IUPAC bases"), reads=R,
        iupac_reads=n_iupac)}
    log(f"K4 on a block of {R} reads, {n_iupac} of them holding `=` or "
        f"IUPAC codes: bit-exact; {card}")

    tab, pen_tab, off = big._device_lut()
    cfg, prep, _t0 = big._prep_block(iupac, R, big.pool_config)
    if not prep.get("dev_full"):
        raise AssertionError("a block of quality reads took the dense arrays")
    M, idx = prep["max_len"], big.device_index
    blob = torch.from_numpy(prep["blob"]).to(big.device)
    dense = eng._unpack_prep_full(blob, tab, pen_tab, off, R, M, _DEV_LUT_Q)
    err6 = compare(torch, dense, eng._unpack_prep_full_plain(
        blob, tab, pen_tab, off, R, M, _DEV_LUT_Q),
        "unpack_prep_full on a block with IUPAC bases")
    rank, code, n, score_lut, pen, split, *_rest = dense
    steps, fwd = prep["bid_steps"], cfg.compute_forward_part
    bid = bi_d.compute_bi_d(idx, rank, pen, n, split, fwd, steps)
    err7 = compare(torch, (bid,), (bi_d.compute_bi_d_plain(
        idx, rank, pen, n, split, fwd, steps),),
        "bi_d_i64 on a block with IUPAC bases")
    out["unpack_prep_full"] = {"iupac": dict(max_abs_err=err6, reads=R,
                                             iupac_reads=n_iupac)}
    out["bi_d_i64"] = {"iupac": dict(max_abs_err=err7, reads=R,
                                     iupac_reads=n_iupac)}
    log(f"K6, K7 (int64) on the same block: bit-exact; {card}")
    slut = sp2._dense_slut(idx, (rank, code, score_lut, pen), n, split, cfg,
                           steps)
    pool(big, (n, split, *dense[6:]), slut, cfg,
         "a block with IUPAC bases (int64)", "iupac")
    return {k: {"inputs": v} for k, v in out.items()}


def inputs_phase(torch, np, cli, fasta, card, kernels, params, args):
    """The default run's form of path 16: INPUTS_SHORT_READS records of a
    pipeline BAM of path 1's genome (a quality-less block, overlong mates,
    IUPAC and `=` bases, 0x10 twins), `map --engine native` on the file
    and `map --engine device` on stdin at --batch_size SHEETS_BATCH, the
    BAMs equal and held to the input, the launches what the blocks' routes
    imply; then `inputs_kernels` on path 1's index.  -> {row: keys}: the
    kernels' `inputs` and `inputs_launches` (the stdin run's, counted from
    0 just before it)."""
    global N_READS
    from mapad_tpu_torch.index import load_index
    from mapad_tpu_torch.ops.engine import DeviceSearchEngine
    from mapad_tpu_torch.tools import pipeline_bam as pb

    t = time.perf_counter()
    work = os.path.join(WORK, "inputs_short")
    os.makedirs(work, exist_ok=True)
    bam = os.path.join(work, "pipeline.bam")
    from mapad_tpu_torch.tools.assembly import gen_genome

    truth = pb.make(bam, gen_genome(GENOME_SIZE, 42), INPUTS_SHORT_READS,
                    INPUTS_SEED, qualityless=INPUTS_SHORT_QLESS, scattered=1)
    log(f"path 16, short form: a pipeline BAM of {truth.counts()}")
    saved, N_READS = N_READS, INPUTS_SHORT_READS
    try:
        maps = CliMaps(torch, cli, "path 16, short form", fasta, bam, work,
                       2 * GENOME_SIZE + 2, False, card)
        maps.argv += ["--batch_size", str(SHEETS_BATCH)]
        maps.run("native", ["--engine", "native"])
        e = stdin_run(torch, maps, "device", bam, INPUTS_SHORT_READS,
                      SHEETS_BATCH, card, "path 16, short form, stdin")
        inputs_checks(truth, maps, dict(native=maps.figures["native"],
                                        device=e),
                      "path 16, short form", card)
        if not e["routes"].get("host") or not e["routes"].get("lut"):
            raise AssertionError(f"path 16, short form: routes "
                                 f"{e['routes']}, not both")
    finally:
        N_READS = saved
    index = load_index(fasta)
    rows = inputs_kernels(
        torch, DeviceSearchEngine(index.fmd, params, lanes=args.lanes,
                                  packed_hits=True),
        DeviceSearchEngine(index.fmd, params, lanes=args.lanes, big=True,
                           packed_hits=True), truth, card)
    for name in kernels:
        rows.setdefault(name, {})["inputs_launches"] = e["launches"][name]
    log(f"path 16, short form: {time.perf_counter() - t:.1f} s")
    return rows


def inputs_alone(torch, np, cli, card, t_start, scale, phases):
    """`--inputs [SCALE] [--phases abcd]`: path 16, the phases named (all by
    default).  (a) path 1's genome and a pipeline BAM of INPUTS_READS
    records (tools/pipeline_bam.py) through `map` with each of
    LONG_ENGINES at the CLI's defaults; (b) the assembly at SCALE and a
    pipeline BAM of INPUTS_BIG_READS of its reads in big mode, the same
    engines; (c) (a)'s BAM on stdin with `-R` and its merged reads as a
    `.fastq.gz`, device against native; (d) the dispatcher with two card
    workers, one killed holding a chunk.  Every BAM equals its native one
    and is held to its input; the launches are what the blocks' routes
    imply."""
    work = os.path.join(WORK, "inputs")
    os.makedirs(work, exist_ok=True)
    summary = dict(card=card, scale=scale, phases=phases)
    a = (inputs_small(np, cli, work, card)
         if set(phases) & set("acd") else None)
    for p, fn in (("a", lambda: inputs_a(torch, cli, a, card)),
                  ("b", lambda: inputs_b(torch, cli, card, scale)),
                  ("c", lambda: inputs_c(torch, cli, a, card)),
                  ("d", lambda: inputs_d(cli, a, card))):
        if p in phases:
            t = time.perf_counter()
            summary[p] = fn()
            log(f"path 16 ({p}): {time.perf_counter() - t:.1f} s")
    log(f"total: {time.perf_counter() - t_start:.1f} s")
    log(card)
    print(json.dumps({"inputs": summary}, default=str), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def big_text_layout(np, size):
    """Path 11's genome of `size` bp as contigs of BIG_TEXT_CONTIG bp: a
    tools/assembly.py Layout with no runs, so that its BAMs are held to
    the assembly's invariants."""
    from mapad_tpu_torch.tools.assembly import Layout

    starts = np.arange(0, size, BIG_TEXT_CONTIG, dtype=np.int64)
    none = np.zeros(0, dtype=np.int64)
    return Layout(names=tuple(f"big_chr{i + 1}" for i in range(len(starts))),
                  lengths=np.minimum(BIG_TEXT_CONTIG, size - starts),
                  starts=starts, run_start=none, run_len=none,
                  run_sym=np.zeros(0, dtype=np.uint8))


# `python -c PEAK_LAUNCHER PEAK_FILE CMD...` runs CMD as its own child and
# writes that child's peak resident kB (wait4's ru_maxrss) to PEAK_FILE.
# The launcher is small, so the child's figure is its own: a process takes
# over the high-water mark of the one that forks it (and, where that forks
# by vfork, its whole peak), which for the smoke is gigabytes.
PEAK_LAUNCHER = r"""
import os, subprocess, sys
peak_file, cmd = sys.argv[1], sys.argv[2:]
_pid, status, usage = os.wait4(subprocess.Popen(cmd).pid, 0)
with open(peak_file, "w") as f:
    f.write(str(usage.ru_maxrss))
sys.exit(os.waitstatus_to_exitcode(status))
"""


def run_measured(module, args, log_path):
    """`python -m module args` from the repo's root, its output into
    `log_path` -> (exit code, seconds, its own peak resident GiB, or None
    where it left none), the peak by PEAK_LAUNCHER."""
    peak_path = f"{log_path}.peak"
    if os.path.exists(peak_path):
        os.remove(peak_path)
    t = time.perf_counter()
    with open(log_path, "w") as out:
        rc = subprocess.call(
            [sys.executable, "-c", PEAK_LAUNCHER, peak_path, sys.executable,
             "-m", module, *args],
            cwd=ROOT, stdout=out, stderr=subprocess.STDOUT)
    secs = time.perf_counter() - t
    peak = None
    if os.path.exists(peak_path):
        with open(peak_path) as f:
            peak = int(f.read()) / 2**20
    return rc, secs, peak


def cli_index(fasta, text_len, work, what, card):
    """The CLI's index of `fasta`, reused where its bundle is of a text of
    `text_len` symbols, else built (`run_measured`, its log in `work`) ->
    (seconds, host peak GiB), both None where reused."""
    meta_path = os.path.join(f"{fasta}.tpx", "meta.json")
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            if json.load(f).get("text_len") != text_len:
                os.remove(meta_path)
    secs = peak = None
    if os.path.exists(meta_path):
        log(f"{what}: index reused ({meta_path})")
    else:
        log_path = os.path.join(work, "index.log")
        rc, secs, peak = run_measured("mapad_tpu_torch.cli",
                                      ["index", "-g", fasta], log_path)
        if rc != 0:
            with open(log_path) as f:
                tail = f.read()[-2000:]
            raise SystemExit(f"{what}: index failed ({rc}; {log_path}):\n"
                             f"{tail}")
        log(f"{what}: index built in {secs:.1f} s, host peak {peak:.2f} GiB "
            f"(the CLI's own process); {card}")
    with open(meta_path) as f:
        got = json.load(f)["text_len"]
    assert got == text_len, (got, text_len)
    return secs, peak


class CliMaps:
    """`map` through the CLI on one workload, an engine a run, as paths 11
    and 12 and the small assembly run it.  The native engine's run comes
    first: its BAM is the yardstick.  A device engine's run must leave
    `big` to the engine and find the mode `big`, launch every kernel of
    that width (K2's launches held to its form) and none of the other, and
    write a BAM equal to the native one (XD aside)."""

    def __init__(self, torch, cli, what, fasta, fastq, work, text_len, big,
                 card, force_big=False, flags=None):
        self.torch, self.cli, self.what, self.work = torch, cli, what, work
        self.text_len, self.big, self.card = text_len, big, card
        # below the size that selects big mode: the engines made big
        self.force_big = force_big
        self.argv = ["--threads", "0", "map", "-r", fastq, "-g", fasta,
                     "--force_overwrite",
                     *(MAP_FLAGS if flags is None else flags)]
        self.figures = {}

    def bam(self, key):
        return os.path.join(self.work, f"{key}.bam")

    def run(self, key, extra, env=None):
        """`map ... extra` into KEY.bam with `env` set (None: unset) -> its
        figures: seconds and reads/s; for a device engine also its mode,
        shards, rows and each card's peak memory, launches and the
        pipeline's stats."""
        from mapad_tpu_torch._build import LAUNCHES
        from mapad_tpu_torch.ops.engine import DeviceSearchEngine

        torch, env = self.torch, env or {}
        what = (f"{self.what}, map {' '.join(extra) or '(hybrid)'}"
                + "".join(f" {k}={'(unset)' if v is None else v}"
                          for k, v in env.items()))
        made, init = [], DeviceSearchEngine.__init__

        def recording_init(engine, *a, **kw):
            if kw.get("big") is not None:
                raise AssertionError(f"{what} must leave `big` to the "
                                     "engine")
            if self.force_big:
                kw["big"] = True
            init(engine, *a, **kw)
            made.append(engine)

        tap = _StatsTap()
        logger = logging.getLogger("mapad_tpu_torch.map.pipeline")
        logger.addHandler(tap)
        LAUNCHES.reset()
        sync_cards(torch)
        reset_card_peaks(torch)
        DeviceSearchEngine.__init__ = recording_init
        t = time.perf_counter()
        try:
            with _Env(**env):
                if self.cli.main([*self.argv, "-o", self.bam(key),
                                  *extra]) != 0:
                    raise SystemExit(f"{what} failed")
        finally:
            DeviceSearchEngine.__init__ = init
            logger.removeHandler(tap)
        sync_cards(torch)
        secs = time.perf_counter() - t
        e = self.figures[key] = dict(seconds=secs,
                                     reads_per_s=N_READS / secs)
        if env:
            e["env"] = env
        if key == "native":
            log(f"{what}: {N_READS} reads in {secs:.2f} s = "
                f"{N_READS / secs:.1f} reads/s; {self.card}")
            return e
        if len(made) != 1:
            raise AssertionError(f"{what}: {len(made)} device engines")
        engine = made.pop()
        idx = engine.device_index
        if idx.big != self.big or idx.text_len != self.text_len:
            raise AssertionError(f"{what}: big mode {idx.big} on a text of "
                                 f"{idx.text_len:,}")
        peaks = card_peaks_gb(torch)
        e.update(big=idx.big, shards=engine.n_shards,
                 rows_gb=nbytes(idx.rows) / 1e9, peak_card_gb=peaks[0],
                 peak_cards_gb=peaks)
        del idx, engine
        mine, other = ((KERNELS_I64, KERNELS_I32 + ["bi_d"]) if self.big
                       else (KERNELS_I32, KERNELS_I64))
        counts = {k: LAUNCHES.get(k) for k in mine + other}
        report_run(what, self.card, secs, tap.stats,
                   {k: counts[k] for k in mine})
        check_k2_launches(counts, what, sfx="_i64" if self.big else "")
        if any(counts[k] for k in other):
            raise AssertionError(f"{what}: kernels of the other width "
                                 f"launched: { {k: counts[k] for k in other} }")
        e.update(launches={k: counts[k] for k in mine},
                 stats=tier_stats(tap.stats))
        log(f"  {'big' if e['big'] else 'int32'} mode "
            f"{'forced' if self.force_big else 'chosen by the engine'} "
            f"(text {self.text_len:,} symbols), {e['shards']} shards; rows "
            f"{e['rows_gb']:.3f} GB on a card, peak card memory "
            + ", ".join(f"cuda:{d} {gb:.3f}" for d, gb in enumerate(peaks))
            + f" GB; {self.card}")
        if e["shards"] > 1:
            steps = e["shard_steps"] = tap.stats["shard_steps"]
            log(f"  shard steps {steps}, step efficiency "
                f"{sum(steps) / (len(steps) * max(steps)):.4f} (sum / (D x "
                f"max), summed over the run's blocks)")
        bam_compare(self.bam(key), self.bam("native"), what)
        return e


def bam_invariants(lay, bases, bam, what):
    """A BAM's records held to the reference `lay`, `bases`
    (`assembly.check_records`: the header's names and lengths, no record
    on an X or across a sequence's end, M-only records' mismatches equal
    to NM, MD's letters the reference's) -> its counts, with the mapped
    records past text positions 2^31 and 2^32 and the largest."""
    from mapad_tpu_torch.tools.assembly import EDGE_SPAN, check_records

    _h, recs = bam_records(bam)
    got = check_records(lay, bases, bam_references(bam), recs)
    where = got.pop("text_pos")
    got.update(past_2_31=int((where >= 2**31).sum()),
               past_2_32=int((where >= 2**32).sum()),
               max_text_pos=int(where.max()))
    log(f"{what}: header of {len(lay.names)} sequences, names and lengths "
        f"the reference's; {got['mapped']} mapped records, none on an X or "
        f"across a sequence's end, {got['beside_long_run']} within "
        f"{EDGE_SPAN} bp of an N run, {got['past_2_31']} at text positions "
        f"past 2^31, {got['past_2_32']} past 2^32 (largest "
        f"{got['max_text_pos']:,}); {got['checked']} M-only records' "
        f"mismatches against the index's text equal their NM; every MD "
        f"letter the reference's")
    return got


def big_text_alone(torch, np, cli, load_index, params, card, t_start, size):
    """`--big-text [SIZE]`: path 11, a genome of SIZE bp (default
    BIG_TEXT_SIZE: a text of 2,200,000,002 symbols, past 2^31) end to end:
    its index by the CLI (cached in .smoke/big_text/ for the same size and
    seed), the rows' host peak at load (by chunks), then `map --engine
    native`, `map --engine device` (big mode chosen by the engine itself)
    and `map` (the hybrid engine), the last two BAMs equal to the first
    (XD aside), the mapped records held to the genome (`bam_invariants`)
    and those past text position 2^31 counted; last `tools/measure_big.py`
    on the loaded index."""
    from mapad_tpu_torch.map.record import Record
    from mapad_tpu_torch.tools import measure_big
    from mapad_tpu_torch.tools.assembly import (
        gen_genome,
        make_reads,
        write_fasta,
        write_fastq,
    )

    work = os.path.join(WORK, "big_text")
    os.makedirs(work, exist_ok=True)
    seed = BIG_TEXT_SEED
    fasta = os.path.join(work, f"genome_{size}_{seed}.fa")
    fastq = os.path.join(work, f"reads_{size}_{seed}.fq")
    lay = big_text_layout(np, size)
    text_len = lay.text_len
    summary = dict(genome_bp=size, contigs=len(lay.names),
                   text_len=text_len, seed=seed)
    log(f"path 11: a {size:,} bp genome, {summary['contigs']} contigs of "
        f"{BIG_TEXT_CONTIG:,} bp: a text of {text_len:,} symbols "
        f"({text_len / 2**31:.3f} x 2^31)")
    t = time.perf_counter()
    genome = gen_genome(size, seed)
    written = not os.path.exists(fasta)
    if written:
        write_fasta(fasta, genome, lay.names, lay.starts, lay.lengths)
    reads = make_reads(genome, N_READS, seed + 100)
    write_fastq(reads, fastq)
    log(f"path 11: genome and {N_READS} reads in "
        f"{time.perf_counter() - t:.1f} s (FASTA "
        f"{'written' if written else 'reused'})")
    secs, peak = cli_index(fasta, text_len, work, "path 11", card)
    summary["index"] = (dict(cache="reused") if secs is None else
                        dict(cache="built", seconds=secs, peak_gib=peak))

    # the rows' host peak at load, packed by chunks (the bundle's row cache
    # made anew)
    log_path = os.path.join(work, "load_peak.log")
    rc, secs, peak = run_measured("mapad_tpu_torch.tools.big_rows",
                                  ["load-peak", "-g", fasta], log_path)
    if rc != 0:
        raise SystemExit(f"path 11: load-peak failed ({rc}; {log_path})")
    with open(log_path) as f:
        got = json.loads(f.read().strip().splitlines()[-1])
    if not got["big"]:
        raise AssertionError("path 11: the rows were packed in int32 mode")
    summary["load"] = got
    log(f"path 11: rows packed by chunks: {got['seconds']:.1f} s, host peak "
        f"{got['peak_gib']:.2f} GiB ({got['peak_gib_before']:.2f} before the "
        f"packing: the index loaded, the card's context), rows "
        f"{got['rows_bytes'] / 1e9:.3f} GB; {card}")

    maps = CliMaps(torch, cli, "path 11", fasta, fastq, work, text_len,
                   True, card)
    maps.run("native", ["--engine", "native"])
    maps.run("device", ["--engine", "device"])
    maps.run("hybrid", [])
    summary["engines"] = maps.figures
    got = bam_invariants(lay, genome, maps.bam("native"), "path 11")
    summary.update(mapped=got["mapped"], past_2_31=got["past_2_31"],
                   past_2_32=got["past_2_32"],
                   max_text_pos=got["max_text_pos"],
                   checked_against_genome=got["checked"])
    if not got["past_2_31"]:
        raise AssertionError("path 11: no mapped record past text position "
                             "2^31")
    del genome

    # the int64 pool kernel alone on the loaded index
    index = load_index(fasta)
    m = measure_big.measure(index, params, [
        Record(sequence=sq, base_qualities=q)
        for sq, q in reads[:BIG_TEXT_MEASURE_READS]])
    summary["measure_big"] = m
    log(measure_big.line(m))
    log(f"total: {time.perf_counter() - t_start:.1f} s")
    log(card)
    print(json.dumps({"big_text": summary}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


# --- the GRCh37-shaped assembly: path 12 and the default smoke's small run


def assembly_make(scale, work):
    """tools/assembly.py's assembly at `scale` and N_READS of its reads
    under `work` -> dict: layout, bases, reads, kinds, fasta, fastq and the
    seconds they took."""
    from mapad_tpu_torch.tools import assembly

    t = time.perf_counter()
    lay, bases, reads, kinds, fasta, fastq = assembly.make(
        work, scale, ASSEMBLY_SEED, N_READS)
    made_s = time.perf_counter() - t
    s = lay.summary()
    log(f"assembly at scale {scale:g}: {s['sequences']} sequences, "
        f"{s['bp']:,} bp (a text of {s['text_len']:,} symbols, "
        f"{s['text_len'] / 2**31:.3f} x 2^31), {s['long_runs']} N runs of "
        f"20 bp or more ({s['long_run_bp']:,} bp, {s['n_share']:.2%}: X in "
        f"the index), {s['short_runs']} short IUPAC runs; {N_READS} reads "
        f"({int((kinds != '').sum())} at edges: "
        f"{ {k: int((kinds == k).sum()) for k in ('long', 'short', 'join')} }"
        f", {sum(b'N' in r for r, _q in reads)} carrying N) in "
        f"{made_s:.1f} s")
    return dict(lay=lay, bases=bases, reads=reads, kinds=kinds, fasta=fasta,
                fastq=fastq, made_s=made_s)


def assembly_workload(scale, work, card):
    """`assembly_make`, then its index by the CLI (`cli_index`) -> its dict
    with the index's seconds and host peak (None: reused)."""
    w = assembly_make(scale, work)
    w["index_s"], w["index_peak_gib"] = cli_index(
        w["fasta"], w["lay"].text_len, work, "assembly", card)
    return w


def bam_references(path):
    """The (name, length) of each sequence of a BAM's header."""
    from mapad_tpu_torch.io.bam import BamReader

    with open(path, "rb") as f:
        return list(BamReader(f).references)


def assembly_invariants(w, bam, what, past_2_31):
    """A BAM's records held to the assembly (`bam_invariants`); some MD
    must carry an original symbol, past text position 2^31 where
    `past_2_31`.  -> the counts."""
    got = bam_invariants(w["lay"], w["bases"], bam, what)
    log(f"{what}: {got['md_original']} MD tags carry an original IUPAC "
        f"symbol, each on a replaced base (the furthest at text position "
        f"{got['md_original_max_text_pos']:,})")
    if not got["md_original"]:
        raise AssertionError(f"{what}: no MD tag carries an original symbol")
    if past_2_31 and got["md_original_max_text_pos"] < 2**31:
        raise AssertionError(f"{what}: no MD tag with an original symbol "
                             "past text position 2^31")
    return got


def join_drops(w, index, params):
    """The host searcher's hits of the reads placed at sequence joins,
    each hit's positions (at most JOIN_POSITIONS of them) located as the
    BAM conversion locates them: a hit every one of whose positions
    crosses a join is dropped there (the next-best hit is reported)."""
    from mapad_tpu_torch.map.native_search import NativeSearchEngine
    from mapad_tpu_torch.map.record import Record, effective_len

    picked = [i for i, k in enumerate(w["kinds"]) if k == "join"]
    recs = [Record(sequence=w["reads"][i][0], base_qualities=w["reads"][i][1])
            for i in picked]
    out = NativeSearchEngine(index.fmd, params).search_chunk(recs)
    sa, ids = index.suffix_array, index.id_pos_map
    strand = len(sa) // 2
    hits = positions = crossing = dropped = 0
    for hit_list, _d in out:
        for h in hit_list:
            hits += 1
            eff = effective_len(h.edit_operations)
            lo = h.interval.lower
            cross = n = 0
            for sar in range(lo, lo + min(h.interval.size, JOIN_POSITIONS)):
                a = sa.get(sar)
                if a is None:
                    continue
                if a >= strand:
                    a = len(sa) - a - eff - 1
                n += 1
                cross += ids.get_reference_identifier(a, eff) is None
            positions += n
            crossing += cross
            dropped += n > 0 and cross == n
    got = dict(reads=len(recs), hits=hits, positions=positions,
               crossing=crossing, dropped=dropped)
    log(f"  joins: {len(recs)} reads placed at sequence joins, {hits} hits "
        f"of the host searcher, {positions} positions located, {crossing} "
        f"of them across a join; {dropped} hits dropped at a join (every "
        f"position across one)")
    if not dropped:
        raise AssertionError("no hit was dropped at a join")
    return got


def tier_stats(stats):
    return {k: stats.get(k, 0) for k in (
        "batches", "steps", "escalated", "esc_why", "oracle", "retried",
        "deep_retried", "nohit_host", "prep_s", "device_s", "wait_s",
        "decode_s", "fb_secs", "hybrid_device_reads", "hybrid_native_reads",
        "device_fraction")}


def assembly_retry(run, what):
    """`run(env)` -> stats, with MAPAD_RETRY_TIER=1; when the defaults
    retry nothing (no read was left unfinished or undispatched), once more
    with the primary step budget starved to ASSEMBLY_STARVED_STEPS."""
    stats = run(dict(MAPAD_RETRY_TIER="1"))
    if stats.get("retried", 0):
        return stats, None
    log(f"{what}: the defaults retried nothing (escalated by cause "
        f"{stats.get('esc_why')}); once more with MAPAD_POOL_STEPS="
        f"{ASSEMBLY_STARVED_STEPS}")
    stats = run(dict(MAPAD_RETRY_TIER="1",
                     MAPAD_POOL_STEPS=ASSEMBLY_STARVED_STEPS))
    if not stats.get("retried", 0):
        raise AssertionError(f"{what}: the retry tier retried nothing")
    return stats, ASSEMBLY_STARVED_STEPS


def rows_with_x(torch, idx):
    """(nb,) bool: the fused rows whose symbols hold an X (rank 5), and
    the BWT positions of the X symbols (int64, on the rows' device), read
    from the rows 65,536 at a time."""
    k, step = idx.occ_k, 1 << 16
    shifts = torch.arange(0, 32, 4, dtype=torch.int32,
                          device=idx.rows.device)
    has, pos = [], []
    for b0 in range(0, idx.rows.shape[0], step):
        words = idx.rows[b0 : b0 + step, idx.n_cp_cols:]
        x = ((words[:, :, None] >> shifts) & 0xF).reshape(
            words.shape[0], -1) == 5
        has.append(x.any(dim=1))
        pos.append(torch.nonzero(x.reshape(-1))[:, 0] + b0 * k)
    pos = torch.cat(pos)
    return torch.cat(has), pos[pos < idx.text_len]


def x_queried(torch, idx, has_x, ranks):
    """How many of the rank queries `ranks` read a row holding X."""
    r = ranks.to(idx.rows.device).long()
    r = r[r >= 0]
    return int(has_x[(r // idx.occ_k).clamp(max=has_x.numel() - 1)].sum())


def assembly_kernels(torch, small, big, w, card):
    """The kernels of the small assembly's two runs against their plain
    versions on its rows (X in them), on ASSEMBLY_CHECK_READS reads (the
    edge reads first, then reads with N): K1 (`occ4_batch`,
    `extend_batch`) in both widths on ranks at the BWT's X symbols and at
    random; K4 (int32); K6 and K7 (int64: walks into the X runs); K2 at
    ASSEMBLY_FIXED steps, K3 and K5 in both widths.  -> {kernel-table
    row: its `assembly` keys}."""
    from mapad_tpu_torch.map.record import Record
    from mapad_tpu_torch.ops import bi_d, fm
    from mapad_tpu_torch.ops import engine as eng
    from mapad_tpu_torch.ops import search_pool2 as sp2
    from mapad_tpu_torch.ops.prep import _DEV_LUT_Q

    reads, kinds = w["reads"], w["kinds"]
    order = sorted(range(len(reads)),
                   key=lambda i: (kinds[i] == "", b"N" not in reads[i][0]))
    R = ASSEMBLY_CHECK_READS
    recs = [Record(sequence=reads[i][0], base_qualities=reads[i][1])
            for i in order[:R]]
    out = {}
    for engine in (small, big):
        idx = engine.device_index
        sfx = "_i64" if idx.big else ""
        has_x, x_pos = rows_with_x(torch, idx)
        g = torch.Generator(device="cpu").manual_seed(ASSEMBLY_SEED)
        pick = torch.randint(0, x_pos.numel(), (ASSEMBLY_RANKS // 2,),
                             generator=g).to(x_pos.device)
        r = torch.cat([x_pos[pick], torch.randint(
            -1, idx.text_len, (ASSEMBLY_RANKS // 2,), generator=g).to(
                x_pos.device)]).to(idx.idx_dtype)
        occ = fm.occ4_batch(idx, r)
        err = compare(torch, (occ,), (fm._row_occ4(idx, r),),
                      f"occ4_batch{sfx} on the assembly's rows")
        lower = (r.long() - 3).clamp(0, idx.text_len - 1).to(idx.idx_dtype)
        size = torch.minimum(torch.full_like(lower, 7), idx.text_len - lower)
        lrev = lower.flip(0)
        ext = fm.extend_batch(idx, lower, lrev, size)
        err = max(err, compare(
            torch, ext, fm.extend_batch_plain(idx, lower, lrev, size),
            f"extend_batch{sfx} on the assembly's rows"))
        ends = interval_ends(torch, lower, size)
        out["extend_batch" + sfx] = dict(
            max_abs_err=err, ranks=int(r.numel()),
            x_rows=int(has_x.sum()), rows=int(has_x.numel()),
            x_symbols=int(x_pos.numel()),
            x_row_queries=x_queried(torch, idx, has_x, ends),
            ms=timed(torch, lambda: fm.extend_batch(idx, lower, lrev, size),
                     20),
            bound_ms=bound_ms(occ_bytes(torch, idx, ends)
                              + nbytes(lower, lrev, size, *ext)),
            occ4_ms=timed(torch, lambda: fm.occ4_batch(idx, r), 20),
            occ4_bound_ms=bound_ms(occ_bytes(torch, idx, r)
                                   + nbytes(r, occ)))
        o = out["extend_batch" + sfx]
        log(f"K1{sfx} on the small assembly's rows ({o['x_rows']} of "
            f"{o['rows']} rows hold X, {o['x_symbols']:,} X symbols): "
            f"occ4_batch and extend_batch on {o['ranks']} ranks, half of "
            f"them on an X, bit-exact ({o['x_row_queries']} interval ends "
            f"in rows with X); extend_batch {o['ms']:.4f} ms (bound "
            f"{o['bound_ms']:.5f}), occ4_batch {o['occ4_ms']:.4f} ms (bound "
            f"{o['occ4_bound_ms']:.5f}); {card}")

        cfg, prep, _t0 = engine._prep_block(recs, R, engine.pool_config)
        M = prep["max_len"]
        blob = torch.from_numpy(prep["blob"]).to(engine.device)
        tab, pen_tab, off = engine._device_lut()
        if idx.big:
            dense = eng._unpack_prep_full(blob, tab, pen_tab, off, R, M,
                                          _DEV_LUT_Q)
            err = compare(torch, dense, eng._unpack_prep_full_plain(
                blob, tab, pen_tab, off, R, M, _DEV_LUT_Q),
                "unpack_prep_full on the assembly's reads")
            out["unpack_prep_full"] = dict(max_abs_err=err, reads=R)
            rank, code, n, score_lut, pen, split, *_rest = dense
            steps = prep["bid_steps"]
            fwd = cfg.compute_forward_part
            bid = bi_d.compute_bi_d(idx, rank, pen, n, split, fwd, steps)
            with K7Queries(torch, bi_d) as q7:
                want = bi_d.compute_bi_d_plain(idx, rank, pen, n, split, fwd,
                                               steps)
            ranks7 = torch.cat(q7.ranks)
            out["bi_d_i64"] = o = dict(
                max_abs_err=compare(torch, (bid,), (want,),
                                    "bi_d_i64 on the assembly's reads"),
                reads=R, walk_steps=q7.steps,
                x_row_queries=x_queried(torch, idx, has_x, ranks7),
                ms=timed(torch, lambda: bi_d.compute_bi_d(
                    idx, rank, pen, n, split, fwd, steps), 10),
                bound_ms=bound_ms(nbytes(rank, pen, n, split, bid)
                                  + q7.bytes(idx)))
            log(f"K6, K7 on the small assembly's rows: {R} reads (edge "
                f"reads, reads with N), bit-exact; K7 {q7.steps} walk "
                f"steps, {o['x_row_queries']} of their rank queries in rows "
                f"with X, {o['ms']:.4f} ms (bound {o['bound_ms']:.5f}); "
                f"{card}")
            if not o["x_row_queries"]:
                raise AssertionError("K7 walked into no row with X")
            consts = (n, split, *dense[6:])
            slut = sp2._dense_slut(idx, (rank, code, score_lut, pen), n,
                                   split, cfg, steps)
        else:
            parts = eng._unpack_prep_lut(blob, tab, off, R, M, _DEV_LUT_Q,
                                         prep["rle"])
            err = compare(torch, parts, eng._unpack_prep_lut_plain(
                blob, tab, off, R, M, _DEV_LUT_Q, prep["rle"]),
                "unpack_prep on the assembly's reads")
            out["unpack_prep"] = dict(max_abs_err=err, reads=R)
            consts, slut = parts[:5], parts[5]
        err, res, done, _indels = fixed_pool_check(
            torch, engine, consts, slut, cfg, R, ASSEMBLY_FIXED,
            "the assembly's reads")
        if not done:
            raise AssertionError(f"K2{sfx} on the assembly's reads: no hit "
                                 f"in {ASSEMBLY_FIXED} steps")
        for name in ("pool_search", "extract_chains", "pack_result"):
            out[name + sfx] = dict(max_abs_err=err, reads=R,
                                   fixed_steps=ASSEMBLY_FIXED,
                                   chains=int(res.n_chains), hits=done)
        log(f"K4{' (K6, K7)' if idx.big else ''}, K2 + K3 + K5{sfx} on the "
            f"small assembly's rows: {R} reads, debug_fixed_steps="
            f"{ASSEMBLY_FIXED}, bit-exact against the plain versions; "
            f"{int(res.n_chains)} chains, {done} of them hits")
    return out


def fixed_pool_check(torch, engine, consts, slut, cfg, R, fixed, what):
    """K2 at `fixed` steps (debug_fixed_steps) on R reads' device inputs,
    then K3 (both entries) and K5 on its result, each against its plain
    version -> (max abs error, the PoolResult, its hits, the hits whose
    chain holds an insertion or a deletion)."""
    from mapad_tpu_torch.ops import engine as eng
    from mapad_tpu_torch.ops import search_pool2 as sp2
    from mapad_tpu_torch.ops.search import (
        OP_DELETION,
        OP_INSERTION,
        OP_VALID_BIT,
    )

    idx = engine.device_index
    sfx = "_i64" if idx.big else ""
    c = cfg._replace(debug_fixed_steps=fixed)
    a = (idx, *consts, engine._params(), c, slut)
    res = sp2._extract_chains_cuda(*sp2._pool_loop_cuda(*a), c)
    state = sp2._pool_loop_cuda(*a)
    buf = sp2._extract_chains_cuda(*state, c, views=False)
    pres = sp2._extract_chains_plain(*sp2._pool_loop_plain(*a), c)
    err = compare(torch, tuple(res), tuple(pres),
                  f"pool_search{sfx} + extract_chains{sfx} on {what}")
    err = max(err, compare(torch, (eng._pack_buffer(buf, c, R, idx.big),),
                           (eng._pack_result_plain(res),),
                           f"pack_result{sfx} on {what}"))
    n_ext = min(int(res.n_chains), c.max_chains)
    hit = (res.c_read[:n_ext] >= 0) & ~res.c_abandon[:n_ext]
    ops = res.c_ops[:n_ext]
    kind = (ops >> 17) & 3
    gap = (((ops & OP_VALID_BIT) != 0)
           & ((kind == OP_INSERTION) | (kind == OP_DELETION))).any(1)
    return err, res, int(hit.sum()), int((hit & gap).sum())


def small_assembly_phase(torch, cli, load_index, params, args, card,
                         pipeline):
    """The default smoke's assembly: tools/assembly.py's at
    ASSEMBLY_SMALL_SCALE (86 sequences, X runs, short IUPAC runs, reads
    beside them and with N), its kernels against their plain versions
    there, then `map --engine device` (int32, through the CLI) and
    `pipeline.run` with `big=True` and MAPAD_RETRY_TIER=1, each BAM equal
    to the native engine's and held to the assembly's invariants.  ->
    kernel-table keys {row: {"assembly": ..., "assembly_launches": n}}
    (the phase's figures on a JSON line of their own)."""
    from mapad_tpu_torch._build import LAUNCHES
    from mapad_tpu_torch.ops.engine import DeviceSearchEngine

    t0 = time.perf_counter()
    work = os.path.join(WORK, "assembly_small")
    w = assembly_workload(ASSEMBLY_SMALL_SCALE, work, card)
    index = load_index(w["fasta"])
    small = DeviceSearchEngine(index.fmd, params, lanes=args.lanes,
                               packed_hits=True)
    big = DeviceSearchEngine(index.fmd, params, lanes=args.lanes, big=True,
                             packed_hits=True)
    assert not small.device_index.big and big.device_index.big
    kernels = assembly_kernels(torch, small, big, w, card)
    del small, big
    maps = CliMaps(torch, cli, "small assembly", w["fasta"], w["fastq"],
                   work, w["lay"].text_len, False, card)
    maps.run("native", ["--engine", "native"])
    got = assembly_invariants(w, maps.bam("native"),
                              "small assembly, native", False)
    e = maps.run("device", ["--engine", "device"])
    launches = dict(e["launches"])
    runs = {"device": e}
    secs = None

    def big_run(env):
        nonlocal secs
        LAUNCHES.reset()
        with _Env(**env):
            engine = DeviceSearchEngine(index.fmd, params, lanes=args.lanes,
                                        big=True, packed_hits=True)
            torch.cuda.synchronize()
            t = time.perf_counter()
            pipeline.run(w["fastq"], w["fasta"], maps.bam("big_retry"), True,
                         params, None, engine=engine,
                         position_seed=args.seed, cmdline="mapad map",
                         threads=os.cpu_count() or 1, index=index)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t
        return engine.stats()

    stats, starved = assembly_retry(big_run, "small assembly, big mode")
    i32, i64 = KERNELS_I32 + ["bi_d"], KERNELS_I64
    counts = {k: LAUNCHES.get(k) for k in i32 + i64}
    what = ("small assembly, pipeline.run big=True MAPAD_RETRY_TIER=1"
            + (f" MAPAD_POOL_STEPS={starved}" if starved else ""))
    report_run(what, card, secs, stats, {k: counts[k] for k in i64})
    check_k2_launches(counts, what, sfx="_i64")
    if any(counts[k] for k in i32):
        raise AssertionError(f"{what}: int32 kernels launched")
    bam_compare(maps.bam("big_retry"), maps.bam("native"), what)
    for k in i64:
        launches[k] = counts[k]
    runs["big_retry"] = dict(seconds=secs, reads_per_s=N_READS / secs,
                             starved_steps=starved, stats=tier_stats(stats))
    got["joins"] = join_drops(w, index, params)
    got["reads_with_n"] = sum(b"N" in r for r, _q in w["reads"])
    summary = dict(scale=ASSEMBLY_SMALL_SCALE, **w["lay"].summary(),
                   index_s=w["index_s"], index_peak_gib=w["index_peak_gib"],
                   runs=runs, records=got,
                   seconds=time.perf_counter() - t0)
    log(f"small assembly: the phase {summary['seconds']:.1f} s; {card}")
    log(json.dumps({"small_assembly": summary}))
    return {name: dict(assembly=k, assembly_launches=launches[name])
            for name, k in kernels.items()}


def assembly_alone(torch, cli, load_index, params, card, t_start, scale):
    """`--assembly [SCALE]`: path 12, tools/assembly.py's GRCh37-shaped
    assembly at SCALE (1: 86 sequences, 1,106,352,191 bp, a text of
    2,212,704,384 symbols, past 2^31) end to end: its index by the CLI
    (cached in .smoke/assembly/), then `map --engine native`, `map
    --engine device` (the engine chooses the mode: big past 2^31), `map`
    (hybrid) and `map --engine device` with MAPAD_RETRY_TIER=1 (the step
    budget starved where the defaults retry nothing), each BAM equal to
    the native one (XD aside), which is held to the assembly's invariants;
    the host searcher's hits at sequence joins located as the BAM
    conversion does."""
    work = os.path.join(WORK, "assembly")
    w = assembly_workload(scale, work, card)
    text_len = w["lay"].text_len
    want_big = text_len >= BIG_TEXT_MIN
    summary = dict(scale=scale, seed=ASSEMBLY_SEED, **w["lay"].summary(),
                   made_s=w["made_s"], index_s=w["index_s"],
                   index_peak_gib=w["index_peak_gib"])
    log(f"path 12: the assembly at scale {scale:g}, a text of {text_len:,} "
        f"symbols: big mode {'expected' if want_big else 'not expected'}; "
        f"{card}")
    maps = CliMaps(torch, cli, "path 12", w["fasta"], w["fastq"], work,
                   text_len, want_big, card)
    maps.run("native", ["--engine", "native"])
    maps.run("device", ["--engine", "device"])
    maps.run("hybrid", [])
    _stats, starved = assembly_retry(
        lambda env: maps.run("retry", ["--engine", "device"], env)["stats"],
        "path 12")
    summary["engines"] = maps.figures
    summary["engines"]["retry"]["starved_steps"] = starved

    index = load_index(w["fasta"])
    got = assembly_invariants(w, maps.bam("native"), "path 12",
                              text_len > 2**31)
    got["joins"] = join_drops(w, index, params)
    got["reads_with_n"] = sum(b"N" in r for r, _q in w["reads"])
    log(f"path 12: {got['reads_with_n']} reads carry N; {card}")
    summary["records"] = got
    log(f"total: {time.perf_counter() - t_start:.1f} s")
    log(card)
    print(json.dumps({"assembly": summary}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


# --- path 13 (`--cards [SCALE]`): one node of several cards ----------------

CARDS_READS = 65_536  # bench.py's whole workload: every layout fills blocks


def run_figures(secs, stats, peaks):
    """A run's figures for path 13's summary line."""
    steps = stats.get("shard_steps")
    return dict(seconds=secs, reads_per_s=N_READS / secs,
                shard_steps=steps,
                step_efficiency=(sum(steps) / (len(steps) * max(steps))
                                 if steps else None),
                peak_cards_gb=peaks,
                **{k: stats[k] for k in ("batches", "escalated", "oracle",
                                         "prep_s", "device_s", "wait_s",
                                         "decode_s", "fb_secs")})


def cards_workload(np, cli, load_index):
    """Path 1's workload at N_READS (CARDS_READS) and its index -> (fasta,
    fastq, reads, index, text length)."""
    fasta, fastq, reads = write_workload(np, GENOME_SIZE, 42, "")
    if cli.main(["index", "-g", fasta]) != 0:
        raise SystemExit("index failed")
    with open(os.path.join(f"{fasta}.tpx", "meta.json")) as f:
        text_len = json.load(f)["text_len"]
    return fasta, fastq, reads, load_index(fasta), text_len


def cards_scaling(torch, cli, params, args, card, n, fasta, fastq, reads,
                  index, text_len):
    """Path 13 (a): path 1's workload through `pipeline.run` with the pool
    engine on one card (`device="cuda:0"`: a named card is that card
    alone), over `make_mesh(2)` and over the automatic mesh of every card
    (no device named, MAPAD_SHARD unset), in turns (one, two, every card,
    then back), each turn's engine made anew and warmed by a block, then
    `map` through the CLI with no `--engine` (the hybrid over the automatic
    mesh); every BAM equal to `map --engine native`'s.  -> figures."""
    from mapad_tpu_torch.map.record import Record
    from mapad_tpu_torch.ops.engine import DeviceSearchEngine
    from mapad_tpu_torch.parallel.sharding import make_mesh

    work = os.path.join(WORK, "cards")
    os.makedirs(work, exist_ok=True)
    maps = CliMaps(torch, cli, "path 13 (a)", fasta, fastq, work, text_len,
                   False, card)
    maps.run("native", ["--engine", "native"])
    figs = {"native": maps.figures["native"]}
    layouts = (("one card", dict(device="cuda:0")),
               ("2 cards", dict(mesh=make_mesh(2))),
               (f"{n} cards, the automatic mesh", {}))
    recs = [Record(sequence=s, base_qualities=q) for s, q in reads]
    runs = {name: [] for name, _ in layouts}
    order = [*range(len(layouts)), *reversed(range(len(layouts)))]
    for turn, k in enumerate(order):
        name, kw = layouts[k]
        with _Env(MAPAD_SHARD=None):
            engine = DeviceSearchEngine(index.fmd, params, lanes=args.lanes,
                                        packed_hits=True, **kw)
            # one block first, so that no run pays the first use of a card
            # or of the engine (its LUT tables, plans, threads)
            engine.warm(recs[: engine.block_reads])
        want = None if "device" in kw else make_mesh(2 if kw else None)
        if engine.mesh != want:
            raise AssertionError(f"path 13 (a), {name}: {engine.n_shards} "
                                 f"shards on {engine.mesh}")
        secs, _counts, st, peaks = mesh_run(
            torch, f"path 13 (a), pipeline.run on {name} (turn {turn + 1} "
            f"of {len(order)})", engine, index, params, args, fastq, fasta,
            maps.bam("native"), card, KERNELS_I32)
        runs[name].append(run_figures(secs, st, peaks))
        if engine.mesh:
            engine._shards.shutdown()
        del engine
    for name, got in runs.items():
        rates = [g["reads_per_s"] for g in got]
        figs[name] = dict(got[0], turns_reads_per_s=rates,
                          reads_per_s=median(rates))
    e = maps.run("hybrid", [], env=dict(MAPAD_SHARD=None))
    if e["shards"] != n:
        raise AssertionError(f"path 13 (a): the CLI's hybrid engine took "
                             f"{e['shards']} shards of {n} cards")
    figs["map (hybrid), the automatic mesh"] = e
    one = figs["one card"]["reads_per_s"]

    def rate(name, v):
        turns = v.get("turns_reads_per_s")
        return (f"{name} {v['reads_per_s']:.1f} ({v['reads_per_s'] / one:.2f}"
                "x one card"
                + (f"; turns {', '.join(f'{x:.1f}' for x in turns)}"
                   if turns else "") + ")")

    log("path 13 (a), reads/s (the median of a layout's turns): "
        + "; ".join(rate(k, v) for k, v in figs.items()) + f"; {card}")
    return figs


def cards_k9(torch, index, params, args, reads, n):
    """Path 13 (b): K9's API (`pool_search_sharded`) on the shard threads of
    an engine over distinct cards, int64 then int32, over two cards and
    over every card (the automatic mesh): one full block of the engine's
    (D x 8,192 reads; D x 4,096 in big mode) against its shards run one
    after the other, each on its card, with the block's step efficiency
    from its PoolResult's steps.  Over every card, the int64 block is also
    held bit for bit against `pool_search_sharded_plain`; the int32 one
    against it at n x K9_READS reads (the plain loop takes ~6.6 ms a
    shard's step: the int32 block's 4 x 8,192 steps would add ~3.6
    minutes)."""
    from mapad_tpu_torch.map.record import Record
    from mapad_tpu_torch.ops.engine import DeviceSearchEngine
    from mapad_tpu_torch.parallel.sharding import make_mesh

    recs = [Record(sequence=s, base_qualities=q) for s, q in reads]
    out = {}
    for big in (True, False):
        for D in sorted({2, n}):
            with _Env(MAPAD_SHARD=None):
                engine = DeviceSearchEngine(
                    index.fmd, params, lanes=args.lanes, packed_hits=True,
                    big=big, **({} if D == n else dict(mesh=make_mesh(D))))
            if engine.mesh != make_mesh(D):
                raise AssertionError(f"path 13 (b): {engine.n_shards} shards "
                                     f"on {engine.mesh}")
            got = {}
            got["block"], _ = k9_run(torch, engine,
                                     recs[: engine.block_reads],
                                     plain=D == n and big)
            if D == n and not big:
                got["plain_check"], _ = k9_run(
                    torch, engine, recs[: n * K9_READS], plain=True)
            out[f"{'int64' if big else 'int32'}, {D} cards"] = got
            engine._shards.shutdown()
            del engine
    return out


def worker_layout(lines, device):
    """The line a CLI worker logs on making its engine, where the engine is
    on `device` alone -> whether `lines` (its `_Lines`) hold it."""
    return f"Search engine on {device}, 1 shard(s)" in lines.tail(10**4)


def dispatcher_per_card(cli, fasta, fastq, card, n):
    """`dispatcher_run` with a CLI `worker --device cuda:i` for every card i
    (MAPAD_SHARD unset): each worker must log its engine on its named card
    alone.  -> seconds from the dispatcher's start to its BAM."""
    native = native_chunks(cli, fasta, fastq, seed=0)
    env = dict(os.environ)
    env.pop("MAPAD_SHARD", None)
    what = f"path 13 (d), map --dispatcher with a worker on each of {n} cards"
    secs, _, workers = dispatcher_run(
        what, fasta, fastq, native, os.path.join(WORK, "distributed_cards.bam"),
        [["--device", f"cuda:{i}"] for i in range(n)], env)
    for i, lines in enumerate(workers):
        if not worker_layout(lines, f"cuda:{i}"):
            raise AssertionError(f"{what}: worker --device cuda:{i} logged no "
                                 f"engine on cuda:{i} alone:\n{lines.tail()}")
    log(f"{what} ({PATH8_CHUNK}-read chunks): {N_READS} reads in "
        f"{secs:.2f} s = {N_READS / secs:.1f} reads/s, dispatcher start to "
        f"BAM, on {card}; each worker's engine on its card alone")
    return secs


def cards_processes(cli, fasta, fastq, seed, card, n):
    """Path 13 (d): path 1's workload in PATH8_CHUNK-read chunks through
    `run_multihost` with a process per card (CUDA_VISIBLE_DEVICES=i), then
    with a process per pair of cards, each taking its own automatic mesh
    (four cards or more), then `map --dispatcher` with a worker per card;
    each BAM equal to `map --engine native` of the same chunks, in
    read-name order."""
    chunks = native_chunks(cli, fasta, fastq)
    out = os.path.join(WORK, "multihost_cards.bam")
    figs = {}
    layouts = [("a process per card", [str(i) for i in range(n)])]
    if n >= 4:
        layouts.append(("a process per pair of cards",
                        [f"{2 * i},{2 * i + 1}" for i in range(n // 2)]))
    else:
        log(f"path 13 (d): a process per pair of cards needs four cards; "
            f"skipped on {n}")
    for name, visible in layouts:
        what = f"path 13 (d), {name}"
        secs = multihost(fasta, fastq, out, seed, what, visible=visible,
                         processes=len(visible))
        bam_compare(out, chunks, what, in_name_order=True)
        figs[name] = dict(processes=len(visible), seconds=secs,
                          reads_per_s=N_READS / secs)
    secs = dispatcher_per_card(cli, fasta, fastq, card, n)
    figs["a worker per card"] = dict(workers=n, seconds=secs,
                                     reads_per_s=N_READS / secs)
    return figs


def cards_assembly(torch, cli, w, card, n):
    """Path 13 (c): the assembly through `map --engine native`, then `map
    --engine device` and `map` (the hybrid) over the automatic mesh of
    every card, in big mode (chosen by the engine past 2^31, else forced);
    each BAM equal to the native one and held to the assembly's
    invariants, each card's peak memory above its replica of the rows."""
    text_len = w["lay"].text_len
    want_big = text_len >= BIG_TEXT_MIN
    maps = CliMaps(torch, cli, "path 13 (c)", w["fasta"], w["fastq"],
                   os.path.dirname(w["fasta"]), text_len, True, card,
                   force_big=not want_big)
    maps.run("native", ["--engine", "native"])
    records = {"native": assembly_invariants(
        w, maps.bam("native"), "path 13 (c), native", text_len > 2**31)}
    for key, extra in (("device", ["--engine", "device"]), ("hybrid", [])):
        what = f"path 13 (c), {key}"
        e = maps.run(key, extra, env=dict(MAPAD_SHARD=None))
        if e["shards"] != n:
            raise AssertionError(f"{what}: {e['shards']} shards of {n} "
                                 "cards")
        low = [d for d, gb in enumerate(e["peak_cards_gb"][:n])
               if gb < e["rows_gb"]]
        if low:
            raise AssertionError(f"{what}: cards {low} peaked below their "
                                 f"replica of the rows ({e['rows_gb']:.3f} "
                                 "GB)")
        records[key] = bam_invariants(w["lay"], w["bases"], maps.bam(key),
                                      what)
        st = e["stats"]
        log(f"{what}: {records[key]['past_2_31']} records past text position "
            f"2^31; deep tier: {st['deep_retried']} reads retried, "
            f"{st['nohit_host']} no-hit reads to the host, {st['oracle']} "
            f"host searches")
    return dict(big_chosen=want_big, engines=maps.figures, records=records)


def cards_alone(torch, np, cli, load_index, params, args, t_start, scale,
                phases):
    """`--cards [SCALE] [--phases LETTERS]`: path 13, one node of several
    cards (two or more; main refuses fewer before any work), the phases
    named in `phases` (all by default): (a) path 1's workload at
    CARDS_READS reads on one card, two and all (`cards_scaling`); (b) K9's
    API over every card in both widths (`cards_k9`); (d) a process per
    card, per pair of cards and a worker per card (`cards_processes`);
    then (c) the assembly at SCALE over the automatic mesh
    (`cards_assembly`), its index built after (a), (b) and (d), which
    measure the host's work and so run on a quiet host."""
    from mapad_tpu_torch import tools

    global N_READS
    N_READS = CARDS_READS
    n = torch.cuda.device_count()
    lines = tools.cards()
    for i, line in enumerate(lines):
        log(f"cuda:{i}: {line}")
    card = (f"{n} x {lines[0]}" if len(set(lines)) == 1
            else "; ".join(lines))
    summary = dict(cards=lines, reads=N_READS, scale=scale, phases=phases)
    if set(phases) & set("abd"):
        fasta, fastq, reads, index, text_len = cards_workload(np, cli,
                                                              load_index)
    if "a" in phases:
        summary["scaling"] = cards_scaling(torch, cli, params, args, card, n,
                                           fasta, fastq, reads, index,
                                           text_len)
    if "b" in phases:
        summary["k9"] = cards_k9(torch, index, params, args, reads, n)
    if "d" in phases:
        summary["processes"] = cards_processes(cli, fasta, fastq, args.seed,
                                               card, n)
    if "c" in phases:
        work = os.path.join(WORK, "assembly")
        w = assembly_make(scale, work)
        summary["index_s"], summary["index_peak_gib"] = cli_index(
            w["fasta"], w["lay"].text_len, work, "path 13 (c)", card)
        summary["assembly"] = cards_assembly(torch, cli, w, card, n)
    log(f"total: {time.perf_counter() - t_start:.1f} s")
    for line in lines:
        log(line)
    print(json.dumps({"cards": summary}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": n}}), flush=True)
    return 0


def scale_arg(flag, default):
    """The number after `flag` on the command line, else `default`."""
    at = sys.argv.index(flag) + 1
    if at < len(sys.argv) and not sys.argv[at].startswith("--"):
        return float(sys.argv[at])
    return default


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    if "--cards" in sys.argv[1:] and torch.cuda.device_count() < 2:
        print(f"chip_smoke --cards: needs two cards or more, "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
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

    if "--big-text" in sys.argv[1:]:
        at = sys.argv.index("--big-text") + 1
        size = (int(sys.argv[at]) if at < len(sys.argv)
                and sys.argv[at].isdigit() else BIG_TEXT_SIZE)
        return big_text_alone(torch, np, cli, load_index, params, card,
                              t_start, size)

    if "--assembly" in sys.argv[1:]:
        return assembly_alone(torch, cli, load_index, params, card, t_start,
                              scale_arg("--assembly", ASSEMBLY_SCALE))

    if "--cards" in sys.argv[1:]:
        phases = (sys.argv[sys.argv.index("--phases") + 1]
                  if "--phases" in sys.argv[1:] else "abcd")
        return cards_alone(torch, np, cli, load_index, params, args, t_start,
                           scale_arg("--cards", ASSEMBLY_SCALE), phases)

    if "--knobs" in sys.argv[1:]:
        return knobs_alone(torch, np, cli, load_index, params, args, card,
                           t_start)

    if "--configs" in sys.argv[1:]:
        return configs_alone(torch, np, cli, load_index, args, card,
                             t_start)

    if "--long" in sys.argv[1:]:
        phases = (sys.argv[sys.argv.index("--phases") + 1]
                  if "--phases" in sys.argv[1:] else "ab")
        return long_alone(torch, np, cli, load_index, card, t_start,
                          scale_arg("--long", LONG_SCALE), phases)

    if "--inputs" in sys.argv[1:]:
        phases = (sys.argv[sys.argv.index("--phases") + 1]
                  if "--phases" in sys.argv[1:] else "abcd")
        return inputs_alone(torch, np, cli, card, t_start,
                            scale_arg("--inputs", INPUTS_SCALE), phases)

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

    # --- a stream of several sheets on path 1's index: short blocks
    # mid-stream ---
    for name, n in sheets_phase(torch, np, cli, fasta, card,
                                KERNELS_I32).items():
        rows[name]["sheets_launches"] = n

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

    # --- the rows past 2^32: the int64 kernels on a synthetic table ---
    for name, keys in rows64_phase(torch, np, engine2, reads2, card).items():
        rows[name]["past_2_32"] = keys

    # --- the small assembly: X runs, IUPAC runs, 86 sequences, reads with
    # N, the retry tier; int32 and big mode ---
    for name, k in small_assembly_phase(torch, cli, load_index, params, args,
                                        card, pipeline).items():
        rows[name].update(k)

    # --- path 16's short form: a pipeline BAM on stdin, its blocks'
    # routes, the kernels on a quality-less and an IUPAC block ---
    for name, k in inputs_phase(torch, np, cli, fasta, card, KERNELS_I32,
                                params, args).items():
        rows[name].update(k)

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

    # --- path 14's kernels: the Continuous bound's scale and the gap
    # settings (0, 1) on path 1's index ---
    for name, keys in configs_phase(torch, np, cli, index1, args,
                                    card).items():
        rows[name]["configs"] = keys

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

    # --- the knobs phase: the reference's environment knobs on one engine,
    # K2's fixed step count in four forms, occ4_batch ---
    for name, keys in knobs_phase(torch, np, index1, params, vparams, args,
                                  fastq, fasta, reads, native_bam, card,
                                  path1).items():
        rows[name].update(keys)

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
    # (`path7_launches`, its own reset run), in paths 9 (the in-process
    # worker's) and 10 (`path9_launches`, `path10_launches`) and in the
    # multi-sheet phase (`sheets_launches`) and in path 16's short form
    # (`inputs_launches`, its stdin run's), and the kernels' checks on
    # its quality-less and IUPAC blocks (`inputs`), pool_search
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
    # floor (`walk_floor_ms`), its launch plan and ptxas figures; from the
    # knobs phase, the K2 rows their fixed-step check (`fixed_check`: the
    # natural end at full width with a read a lane, the counts below and
    # above it) and their time at a fixed count at the check's shape
    # (`fixed_steps`, `fixed_ms`, `fixed_us_step`, beside that shape's
    # natural end `fixed_natural_steps`), the K1 rows `occ4_batch` (its
    # check, time, plain time and bound)
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
            "deepest_chain", "load_ns",
            "fixed_check", "fixed_steps", "fixed_ms", "fixed_us_step",
            "fixed_natural_steps", "occ4_batch", "past_2_32", "assembly",
            "assembly_launches", "sheets_launches", "inputs",
            "inputs_launches")
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
