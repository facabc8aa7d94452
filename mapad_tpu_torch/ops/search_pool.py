"""Shared types of the persistent-pool search (mapad_tpu/ops/search_pool.py).

The pool keeps every lane busy: the moment a lane finishes a read it takes
a fresh root frame for the next read of the pool.  `PoolConfig` holds the
static shape and policy of one invocation; `PoolResult` the compacted hit
chains and per-lane bookkeeping it returns, as a NamedTuple of tensors
with the same fields, dtypes and shapes as the JAX package's.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

OP_ABANDON_BIT = 1 << 22  # in-store marker: read hit the per-read step cap


class PoolConfig(NamedTuple):
    max_len: int = 128  # M
    lanes: int = 512  # L
    total_steps: int = 16384  # S: shared step budget == store rows / CANDS
    read_step_cap: int = 2048  # abandon a read after this many pops
    max_chains: int = 8192  # compacted hit-chain capacity
    compute_forward_part: bool = False
    # With backward-only models (find_alignment_start == len, the production
    # aDNA model) start+len == n is invariant, so the extension direction is
    # always Backward: the kernel then runs its cheaper backward-only form
    # (one LUT row per step, no per-lane direction selects).  False runs
    # the bidirectional form that center-start models need.
    backward_only: bool = True
    # The ablation flags of mapad_tpu's tools/ablate_pool.py ("pop",
    # "extend", "lut", "frame", "store", "ring"); the search reads none of
    # them, in either package, so every flag leaves the result as it is.
    debug_ablate: tuple = ()
    # Per-read device step accounting for per-read XD timing: logs
    # (read_id, steps consumed) at each lane refill.
    track_read_steps: bool = False
    # In-kernel store generations.  1: the invocation ends when the store
    # (total_steps blocks) is full, reads left over escalate.  > 1: at a
    # full store with lanes still live the finished chains are extracted,
    # the live window (the last read_step_cap steps) moves to the top of
    # the store and the loop goes on, so unfinished and undispatched reads
    # resume with their frontier intact; at most generations - 1 such
    # boundaries.  Needs read_step_cap + 4 <= total_steps.
    generations: int = 1
    # no further generation when fewer lanes than this are still live
    min_live: int = 1
    # > 0: a generation after a boundary runs at most this many steps
    # (capped spill); 0: until the store is full again
    spill_steps: int = 0
    # > 0: the step loop runs exactly min(total_steps, this) steps, done
    # lanes or not (a fixed amount of work for timing a step); one store
    # generation only.  0: it stops when every lane is done.
    debug_fixed_steps: int = 0


class PoolResult(NamedTuple):
    c_read: torch.Tensor  # (C,) i32 read id (-1 = unused entry)
    c_slot: torch.Tensor  # (C,) i32 store slot (descending == completion order)
    c_abandon: torch.Tensor  # (C,) bool: abandon marker, not a hit
    c_lower: torch.Tensor  # (C,) i32
    c_lrev: torch.Tensor  # (C,) i32
    c_size: torch.Tensor  # (C,) i32
    c_score: torch.Tensor  # (C,) f32
    c_ops: torch.Tensor  # (C, MW) i32 op words, 0-terminated
    n_chains: torch.Tensor  # () i32 (may exceed C -> escalate everything)
    lane_read: torch.Tensor  # (L,) i32 read id still held per lane (R = none)
    lane_unfinished: torch.Tensor  # (L,) bool lane held an unfinished read
    next_read: torch.Tensor  # () i32 pool watermark (reads >= this never ran)
    steps: torch.Tensor  # () i32
    # (R,) i32 per-read device step count (clipped at 4095), -1 for reads
    # that never finished on device or when track_read_steps is off
    read_steps: torch.Tensor = None
