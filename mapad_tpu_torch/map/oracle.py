"""Host oracle: exact sequential port of the k-mismatch search.

This is the semantics reference for the batched device engine (ops/search):
a best-first branch-and-bound over the FMD-index with the priority stack,
Bi-D lookahead pruning, early stops, and stack-limit recovery of reference
src/map/mapping.rs:1012-1383.  Used by tests (validated against the
reference's own unit-test goldens) and as a fallback for reads whose search
space overflows the device arena.

Scores are np.float32 throughout with the reference's operation order.
"""

from __future__ import annotations

import heapq
from dataclasses import dataclass

import numpy as np

from ..index.fmd import BiInterval
from ..utils.seq import COMPLEMENT_TABLE
from . import (
    EDIT_TREE_LIMIT,
    GAP_CLOSED,
    GAP_DELETION,
    GAP_INSERTION,
    OP_DELETION,
    OP_INSERTION,
    OP_MATCH,
    OP_MISMATCH,
    STACK_LIMIT,
    EditOperation,
    HitInterval,
)
from .bi_d_array import BiDArray


@dataclass
class _Frame:
    interval: BiInterval
    start: int  # current_sub_alignment_start (i16)
    length: int  # current_sub_alignment_len (i16)
    gap_backwards: int
    gap_forwards: int
    num_gaps_open: int
    score: np.float32
    node: int  # edit tree node id


class _EditTree:
    """Slab-arena parent-pointer tree (backtrack_tree.rs).  Node 0 = root."""

    def __init__(self):
        self.ops: list = [None]
        self.parents: list = [0]
        self.free: list = []

    def clear(self) -> int:
        self.ops = [None]
        self.parents = [0]
        self.free = []
        return 0

    def add(self, op, parent: int) -> int:
        if self.free:
            nid = self.free.pop()
            self.ops[nid] = op
            self.parents[nid] = parent
            return nid
        self.ops.append(op)
        self.parents.append(parent)
        return len(self.ops) - 1

    def remove(self, nid: int):
        if nid != 0:
            self.ops[nid] = None
            self.free.append(nid)

    def __len__(self):
        return len(self.ops) - len(self.free)

    def ancestors(self, nid: int):
        """Inclusive iterator from nid up to (excluding) the root."""
        while nid != 0:
            yield self.ops[nid]
            nid = self.parents[nid]


def extract_edit_operations(end_node, edit_tree, alignment_start):
    """Recover read-order ops from a center-start search (record.rs:465-500)."""
    buckets: dict[int, list] = {}
    for op in edit_tree.ancestors(end_node):
        buckets.setdefault(op.pos, []).append(op)
    track = []
    for pos in sorted(buckets):
        ops = buckets[pos]
        if pos < alignment_start:
            track.extend(ops)
        else:
            track.extend(reversed(ops))
    return track


def k_mismatch_search(
    pattern,
    base_qualities,
    parameters,
    fmd_index,
    sdm=None,
    mismatch_bound=None,
    stack_limit: int = STACK_LIMIT,
    edit_tree_limit: int = EDIT_TREE_LIMIT,
) -> list:
    """-> list of HitInterval (unsorted heap contents).

    Exact port of mapping.rs:1012-1383.  Ties on the priority stack pop in
    LIFO order of insertion (the reference heap's tie order is unspecified;
    LIFO matches it on all ported goldens).
    """
    pattern = np.asarray(bytearray(pattern), dtype=np.uint8)
    base_qualities = np.asarray(bytearray(base_qualities), dtype=np.uint8)
    sdm = sdm if sdm is not None else parameters.difference_model
    mb = mismatch_bound if mismatch_bound is not None else parameters.mismatch_bound
    n = len(pattern)
    if n == 0:
        return []

    alignment_start_pos = sdm.find_alignment_start(n)
    bi_d_array = BiDArray(
        pattern, base_qualities, alignment_start_pos, parameters, fmd_index, sdm
    )
    # score LUT: S[j, b] = sdm.get(j, n, base_b, pattern[j], qual[j]) - optimal[j]
    score_lut = sdm.score_lut(pattern, base_qualities)

    hits: list[HitInterval] = []
    best_hit_score = None  # max alignment_score among hits (heap peek)
    best_hit_size = None

    edit_tree = _EditTree()
    root = edit_tree.clear()

    # Priority stack: max-heap by score; ties pop LIFO (latest insertion
    # first), which empirically matches the reference MinMaxHeap on all
    # ported goldens (ambiguous indel placement, equal-score hit order).
    counter = [0]
    heap: list = []

    def push_heap(frame: _Frame):
        counter[0] += 1
        heapq.heappush(heap, (-float(frame.score), -counter[0], frame))

    def pop_max():
        return heapq.heappop(heap)[2]

    def pop_min():
        # Rare recovery path: linear scan for the minimum-score frame
        # (items are (-score, -counter, frame): min score == max first key).
        i_min = max(range(len(heap)), key=lambda i: (heap[i][0], heap[i][1]))
        item = heap[i_min]
        heap[i_min] = heap[-1]
        heap.pop()
        if i_min < len(heap):
            heapq.heapify(heap)
        return item[2]

    stack_size_limit_reported = False

    pgo = parameters.penalty_gap_open
    pge = parameters.penalty_gap_extend
    gap_dist_ends = int(parameters.gap_dist_ends)
    max_num_gaps_open = int(parameters.max_num_gaps_open)

    def check_and_push(frame: _Frame, edit_op: EditOperation):
        nonlocal best_hit_score, best_hit_size
        # reference mapping.rs:932-987
        if best_hit_score is not None and mb.reject_iterative(
            frame.score, best_hit_score
        ):
            return
        if frame.num_gaps_open > max_num_gaps_open:
            return
        frame.node = edit_tree.add(edit_op, frame.node)
        if frame.length == n:
            ops = extract_edit_operations(frame.node, edit_tree, alignment_start_pos)
            hits.append(HitInterval(frame.interval, frame.score, ops))
            if best_hit_score is None or frame.score > best_hit_score:
                best_hit_score = frame.score
                best_hit_size = frame.interval.size
            return
        push_heap(frame)

    push_heap(
        _Frame(
            interval=fmd_index.init_interval(),
            start=alignment_start_pos,
            length=0,
            gap_backwards=GAP_CLOSED,
            gap_forwards=GAP_CLOSED,
            num_gaps_open=0,
            score=np.float32(0.0),
            node=root,
        )
    )

    while heap:
        stack_frame = pop_max()

        # Decide which side of the sub-alignment to extend (mapping.rs:1077-1097)
        if stack_frame.start <= n - stack_frame.start - stack_frame.length:
            j = stack_frame.start + stack_frame.length
            forward = True
            d_k = stack_frame.start
            d_l = stack_frame.start + stack_frame.length
        else:
            j = stack_frame.start - 1
            forward = False
            d_k = stack_frame.start - 1
            d_l = stack_frame.start + stack_frame.length - 1

        if forward:
            fmd_ext_interval = stack_frame.interval.swapped()
            next_insertion_backward = stack_frame.gap_backwards
            next_insertion_forward = GAP_INSERTION
            next_deletion_backward = stack_frame.gap_backwards
            next_deletion_forward = GAP_DELETION
            next_closed_gap_backward = stack_frame.gap_backwards
            next_closed_gap_forward = GAP_CLOSED
            gap_state = stack_frame.gap_forwards
        else:
            fmd_ext_interval = stack_frame.interval
            next_insertion_backward = GAP_INSERTION
            next_insertion_forward = stack_frame.gap_forwards
            next_deletion_backward = GAP_DELETION
            next_deletion_forward = stack_frame.gap_forwards
            next_closed_gap_backward = GAP_CLOSED
            next_closed_gap_forward = stack_frame.gap_forwards
            gap_state = stack_frame.gap_backwards

        insertion_score = np.float32(
            (pge if gap_state == GAP_INSERTION else np.float32(pgo + pge))
            + stack_frame.score
        )
        deletion_score = np.float32(
            (pge if gap_state == GAP_DELETION else np.float32(pgo + pge))
            + stack_frame.score
        )
        # mm_scores in extension sweep slot order; the model is queried with
        # the reported reference char in both directions (mapping.rs:1137-1146
        # forward complements, :1175-1184 backward does not), so slot k maps
        # to base code k when extending forward and 3-k when backward.
        slot_codes = (0, 1, 2, 3) if forward else (3, 2, 1, 0)
        mm_scores = [
            np.float32(score_lut[j, b] + stack_frame.score) for b in slot_codes
        ]
        num_gaps_open = stack_frame.num_gaps_open + (
            1 if gap_state == GAP_CLOSED else 0
        )

        lower_bound = bi_d_array.get(d_k, d_l)

        # Early global stop: best-first implies nothing better remains
        if best_hit_score is not None and mb.reject_iterative(
            np.float32(stack_frame.score + lower_bound), best_hit_score
        ):
            break

        # Insertion in read / deletion in reference (mapping.rs:1213-1242)
        if not mb.reject(np.float32(insertion_score + lower_bound), n) and min(
            j, n - j - 1
        ) >= gap_dist_ends:
            check_and_push(
                _Frame(
                    interval=stack_frame.interval,
                    start=stack_frame.start - 1 if not forward else stack_frame.start,
                    length=stack_frame.length + 1,
                    gap_backwards=next_insertion_backward,
                    gap_forwards=next_insertion_forward,
                    num_gaps_open=num_gaps_open,
                    score=insertion_score,
                    node=stack_frame.node,
                ),
                EditOperation(OP_INSERTION, j, 0),
            )

        # Bidirectional extension of the interval (mapping.rs:1244-1339)
        for slot, (c, interval_prime) in enumerate(fmd_index.extend_all(fmd_ext_interval)):
            if interval_prime.size < 1:
                continue
            if forward:
                interval_prime = interval_prime.swapped()
                c_char = int(COMPLEMENT_TABLE[fmd_index.get_rev(c)])
            else:
                c_char = fmd_index.get_rev(c)
            mm_score = mm_scores[slot]

            # Deletion in read / insertion in reference
            dist_5_prime = j + 1 if not forward else j
            dist_3_prime = n - dist_5_prime
            dist_to_closest_end = min(dist_5_prime, dist_3_prime)
            if (
                not mb.reject(np.float32(deletion_score + lower_bound), n)
                and dist_to_closest_end >= gap_dist_ends
            ):
                check_and_push(
                    _Frame(
                        interval=interval_prime,
                        start=stack_frame.start,
                        length=stack_frame.length,
                        gap_backwards=next_deletion_backward,
                        gap_forwards=next_deletion_forward,
                        num_gaps_open=num_gaps_open,
                        score=deletion_score,
                        node=stack_frame.node,
                    ),
                    EditOperation(OP_DELETION, j, c_char),
                )

            # Match/mismatch
            if not mb.reject(np.float32(mm_score + lower_bound), n):
                check_and_push(
                    _Frame(
                        interval=interval_prime,
                        start=stack_frame.start - 1
                        if not forward
                        else stack_frame.start,
                        length=stack_frame.length + 1,
                        gap_backwards=next_closed_gap_backward,
                        gap_forwards=next_closed_gap_forward,
                        num_gaps_open=stack_frame.num_gaps_open,
                        score=mm_score,
                        node=stack_frame.node,
                    ),
                    EditOperation(OP_MATCH, j, 0)
                    if c_char == pattern[j]
                    else EditOperation(OP_MISMATCH, j, c_char),
                )

        # Only search until a multi-hit is found (mapping.rs:1341-1355)
        if len(hits) > 9 or (best_hit_size is not None and best_hit_size > 1):
            return hits

        # Stack/tree size limits with worst-frame eviction (mapping.rs:1357-1380)
        if len(heap) > stack_limit or len(edit_tree) > edit_tree_limit:
            if not stack_size_limit_reported:
                stack_size_limit_reported = True
            if parameters.stack_limit_abort:
                return hits
            for _ in range(
                max(len(heap) - stack_limit, len(edit_tree) - edit_tree_limit)
            ):
                if heap:
                    min_frame = pop_min()
                    edit_tree.remove(min_frame.node)

    return hits
