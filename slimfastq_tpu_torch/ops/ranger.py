"""Frozen format constants of the lane-interleaved binary range coder.

The normative bit format is the NumPy oracle of the JAX package
(``slimfastq_tpu/ops/ranger_np.py``); this module carries only the
constants and the pad-coding rule that the port's coder and drivers need.
Changing any value here changes the bit format.

The coding law, in brief: a carry-less 32-bit range coder with byte
renormalisation codes every symbol through a balanced binary tree of
12-bit adaptive probabilities. W lanes advance in lockstep and share one
table; within a bit-step every lane reads the table as it stood before
the step, then all updates merge by addition (with a collision-count
marker in bits 22-31 that scales each delta down) and touched entries are
clamped. Every lane with at least one symbol codes ``pad_steps(S)`` steps;
steps past its own count code symbol 0 in the pinned sacrificial context.
"""

from __future__ import annotations

TOP = 1 << 24  # renormalise while range < TOP can't be decided
BOT = 1 << 16  # underflow threshold
PROB_BITS = 12
PROB_ONE = 1 << PROB_BITS  # 4096
PROB_INIT = PROB_ONE // 2  # 2048
PROB_MIN = 16  # clamp: keeps per-bit cost bounded => bounded output size
PROB_MAX = PROB_ONE - PROB_MIN
# collision-capped adaptation: each lane's delta is scaled down by
# 2^max(0, ceil_log2(c) - CAP_LOG2) when c lanes hit one entry in a
# bit-step; the count rides in the entry's high bits (CNT_SHIFT) and
# cancels exactly
CAP_LOG2 = 4
CNT_SHIFT = 22
RENORM_ITERS = 4  # provably sufficient for 32-bit state, 8-bit renorm
FLUSH_BYTES = 4  # tail bytes emitted per lane at flush
STEP_BUCKET = 256  # lockstep steps are padded to multiples of this
MASK32 = 0xFFFFFFFF


def pad_steps(S: int) -> int:
    """Format rule: number of coded lockstep steps for a block whose longest
    lane has S symbols."""
    if S <= 0:
        return 0
    return ((S + STEP_BUCKET - 1) // STEP_BUCKET) * STEP_BUCKET
