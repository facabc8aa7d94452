"""Mapping layer: alignment parameters, hits, edit operations."""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np

from ..index.fmd import BiInterval

# Search-space limits (reference mapping.rs:52-54)
STACK_LIMIT = 2_000_000
EDIT_TREE_LIMIT = 10_000_000

# Gap states (reference map/mod.rs:93-98)
GAP_INSERTION = 1
GAP_DELETION = 2
GAP_CLOSED = 0

# Edit operation kinds
OP_MATCH = 0
OP_MISMATCH = 1
OP_INSERTION = 2
OP_DELETION = 3


class EditOperation(NamedTuple):
    """(kind, read position, reference base) — record.rs:226-231."""

    kind: int
    pos: int
    base: int  # reference base for Mismatch/Deletion; 0 otherwise


class HitInterval(NamedTuple):
    """Completed alignment (map/mod.rs:35-39)."""

    interval: BiInterval
    alignment_score: np.float32
    edit_operations: list  # ordered list[EditOperation]


@dataclass
class AlignmentParameters:
    """reference map/mod.rs:22-31."""

    difference_model: object
    mismatch_bound: object
    penalty_gap_open: np.float32
    penalty_gap_extend: np.float32
    chunk_size: int = 250_000
    gap_dist_ends: int = 5
    max_num_gaps_open: int = 2
    stack_limit_abort: bool = False

    def __post_init__(self):
        self.penalty_gap_open = np.float32(self.penalty_gap_open)
        self.penalty_gap_extend = np.float32(self.penalty_gap_extend)
