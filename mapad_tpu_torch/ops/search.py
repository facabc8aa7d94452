"""Search constants, the op-word format and the search parameters.

Counterpart of mapad_tpu/ops/search.py:41-96 (the fixed-batch kernel
itself, `k_mismatch_search_batch`, is a later slice of the port).  The
frame and op-word layouts are the contract between the pool search, the
chain extraction, the result wire format and the host decoders, so they
are kept bit for bit.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

GAP_CLOSED, GAP_INSERTION, GAP_DELETION = 0, 1, 2
OP_MATCH, OP_MISMATCH, OP_INSERTION, OP_DELETION = 0, 1, 2, 3

# packed frame layout in the store's trailing axis
F_LOWER, F_LREV, F_SIZE, F_PARENT, F_STARTLEN, F_GAPS, F_OP, F_SCOREBITS = range(8)
NF = 8
CANDS = 9  # 1 insertion + 4 x (deletion, match/mismatch)

OP_VALID_BIT = 1 << 20  # distinguishes real op words from chain terminators
OP_COMP_BIT = 1 << 21  # marks store entries that completed as hits


def pack_op(kind, pos, base):
    return OP_VALID_BIT | (kind << 17) | (pos << 2) | base


class SearchConfig(NamedTuple):
    max_len: int = 128  # M: padded read length
    max_steps: int = 2048  # S: step budget (fixed-batch kernel)
    hit_cap: int = 24  # H: hit slots per lane (fixed-batch kernel)
    compute_forward_part: bool = False  # center-start models need both halves


class SearchParams(NamedTuple):
    """Scalar search parameters as 0-d tensors on the engine's device."""

    pgo_pge: torch.Tensor  # f32: penalty_gap_open + penalty_gap_extend
    pge: torch.Tensor  # f32: penalty_gap_extend
    gap_dist_ends: torch.Tensor  # i32
    max_gaps: torch.Tensor  # i32
    stack_limit_abort: torch.Tensor  # bool (escalation covers abort semantics)

    @classmethod
    def from_alignment(cls, p, device) -> "SearchParams":
        return cls(
            pgo_pge=torch.tensor(
                float(np.float32(p.penalty_gap_open + p.penalty_gap_extend)),
                dtype=torch.float32, device=device,
            ),
            pge=torch.tensor(float(np.float32(p.penalty_gap_extend)),
                             dtype=torch.float32, device=device),
            gap_dist_ends=torch.tensor(int(p.gap_dist_ends),
                                       dtype=torch.int32, device=device),
            max_gaps=torch.tensor(int(p.max_num_gaps_open),
                                  dtype=torch.int32, device=device),
            stack_limit_abort=torch.tensor(bool(p.stack_limit_abort),
                                           device=device),
        )
