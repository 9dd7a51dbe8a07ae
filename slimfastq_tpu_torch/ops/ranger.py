"""Lane-interleaved binary range coder: the frozen format constants and
the NumPy oracle coder (the port's copy of the JAX package's
ops/ranger_np.py, the normative bit format; the port's kernels and
stream code use the constants, ops/streams_np the coder). Changing any value
here changes the bit format.

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

import numpy as np

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


# the oracle's unsigned 32-bit forms of the constants above
U32 = np.uint32
I32 = np.int32
U8 = np.uint8
_TOP = U32(TOP)
_BOT = U32(BOT)
_MASK32 = U32(MASK32)


def worst_case_bytes(num_bits: int) -> int:
    """Upper bound on bytes one lane can emit for ``num_bits`` bit-steps.

    With p clamped to [PROB_MIN, PROB_MAX], one bit costs at most 8 bits of
    range, i.e. at most one renormalisation byte per bit-step (amortised),
    plus slack for the underflow clamp and the flush tail.
    """
    return int(num_bits) + 2 * FLUSH_BYTES + 16


class LaneEncoder:
    """W-lane lockstep binary range encoder (NumPy oracle). Unmasked: every
    lane codes every step (pad-coded format rule)."""

    def __init__(self, num_lanes: int, max_bytes: int):
        self.W = int(num_lanes)
        self.low = np.zeros(self.W, dtype=U32)
        self.rng = np.full(self.W, _MASK32, dtype=U32)
        self.out = np.zeros((self.W, int(max_bytes)), dtype=U8)
        self.ptr = np.zeros(self.W, dtype=np.int64)

    def encode_bits(self, p: np.ndarray, bit: np.ndarray) -> None:
        """Advance every lane by one binary decision.
        p: uint32[W] probability of bit==0 in [PROB_MIN, PROB_MAX];
        bit: uint32[W] in {0,1}."""
        split = (self.rng >> U32(PROB_BITS)) * p.astype(U32)
        is1 = bit.astype(bool)
        low = np.where(is1, (self.low + split) & _MASK32, self.low)
        rng = np.where(is1, (self.rng - split) & _MASK32, split)
        lanes = np.arange(self.W)
        for _ in range(RENORM_ITERS):
            agree = ((low ^ (low + rng)) & _MASK32) < _TOP
            under = rng < _BOT
            do = agree | under
            clamp = do & ~agree
            rng = np.where(clamp, (U32(0) - low) & U32(BOT - 1), rng)
            byte = (low >> U32(24)).astype(U8)
            w = np.where(do)[0]
            self.out[w, self.ptr[w]] = byte[w]
            self.ptr += do.astype(np.int64)
            low = np.where(do, (low << U32(8)) & _MASK32, low)
            rng = np.where(do, (rng << U32(8)) & _MASK32, rng)
        agree = ((low ^ (low + rng)) & _MASK32) < _TOP
        under = rng < _BOT
        if np.any(agree | under):
            raise AssertionError("range-coder renorm exceeded RENORM_ITERS")
        self.low, self.rng = low, rng

    def flush(self) -> None:
        for _ in range(FLUSH_BYTES):
            byte = (self.low >> U32(24)).astype(U8)
            self.out[np.arange(self.W), self.ptr] = byte
            self.ptr += 1
            self.low = (self.low << U32(8)) & _MASK32

    def lane_bytes(self) -> list[bytes]:
        return [self.out[i, : self.ptr[i]].tobytes() for i in range(self.W)]


class LaneDecoder:
    """W-lane lockstep binary range decoder (NumPy oracle). Reads past a
    lane's end yield zero bytes (lanes whose payload was dropped decode
    garbage that, by the sacrificial-context rule, cannot touch shared
    state)."""

    def __init__(self, payload: np.ndarray, lane_lens: np.ndarray):
        self.W = payload.shape[0]
        if payload.shape[1] == 0:  # all-empty lanes: keep indexing valid
            payload = np.zeros((self.W, 1), dtype=U8)
        self.buf = payload
        self.lens = lane_lens.astype(np.int64)
        self.low = np.zeros(self.W, dtype=U32)
        self.rng = np.full(self.W, _MASK32, dtype=U32)
        self.ptr = np.zeros(self.W, dtype=np.int64)
        code = np.zeros(self.W, dtype=U32)
        for _ in range(4):
            code = (code << U32(8)) | self._read_bytes(
                np.ones(self.W, dtype=bool))
        self.code = code

    def _read_bytes(self, do: np.ndarray) -> np.ndarray:
        idx = np.minimum(self.ptr, self.buf.shape[1] - 1)
        byte = self.buf[np.arange(self.W), idx].astype(U32)
        byte = np.where((self.ptr < self.lens) & do, byte, U32(0))
        self.ptr += do.astype(np.int64)
        return byte

    def decode_bits(self, p: np.ndarray) -> np.ndarray:
        """Decode one binary decision per lane. Returns uint32[W] bits."""
        split = (self.rng >> U32(PROB_BITS)) * p.astype(U32)
        diff = (self.code - self.low) & _MASK32
        bit = (diff >= split).astype(U32)
        is1 = bit.astype(bool)
        self.low = np.where(is1, (self.low + split) & _MASK32, self.low)
        self.rng = np.where(is1, (self.rng - split) & _MASK32, split)
        low, rng, code = self.low, self.rng, self.code
        for _ in range(RENORM_ITERS):
            agree = ((low ^ (low + rng)) & _MASK32) < _TOP
            under = rng < _BOT
            do = agree | under
            clamp = do & ~agree
            rng = np.where(clamp, (U32(0) - low) & U32(BOT - 1), rng)
            nxt = self._read_bytes(do)
            code = np.where(do, ((code << U32(8)) | nxt) & _MASK32, code)
            low = np.where(do, (low << U32(8)) & _MASK32, low)
            rng = np.where(do, (rng << U32(8)) & _MASK32, rng)
        self.low, self.rng, self.code = low, rng, code
        return bit


# ---------------------------------------------------------------------------
# Adaptive probability table: shared batch-synchronous model + sacrificial row
# ---------------------------------------------------------------------------

def table_init(table_size: int, sac_base: int) -> np.ndarray:
    """Entries below sac_base adapt from PROB_INIT; the sacrificial row
    [sac_base, table_size) is pinned at PROB_MAX and never updated."""
    t = np.full(int(table_size), PROB_INIT, dtype=I32)
    t[sac_base:] = PROB_MAX
    return t


def table_mark(table: np.ndarray, idx: np.ndarray, sac_base: int) -> None:
    """Step A of the collision-capped law: every lane deposits a count
    marker in its entry's high bits (sacrificial entries excluded)."""
    np.add.at(table, idx, np.where(idx < sac_base, I32(1 << CNT_SHIFT),
                                   I32(0)))


def ceil_log2_counts(c: np.ndarray):
    """ceil(log2(c)) for c in [1, 1024] via threshold sums (no float)."""
    lg = np.zeros_like(c)
    for j in range(10):
        lg = lg + (c > (1 << j)).astype(c.dtype)
    return lg


def table_update(table: np.ndarray, idx: np.ndarray, marked: np.ndarray,
                 bit: np.ndarray, rate: int, sac_base: int,
                 vtable: np.ndarray | None = None,
                 rate_lo: int = 0) -> None:
    """Batch-synchronous collision-capped update (deterministic parallel
    law). ``marked`` is the gathered entry AFTER table_mark: low bits carry
    the pre-step probability, high bits the step's collision count.

    All lanes computed their delta from the same snapshot; deltas (scaled
    by the collision cap) merge by commutative addition together with the
    marker removal, then touched entries are clamped (duplicates clamp to
    the identical value, so order is irrelevant). Sacrificial entries
    never change.

    Visit-count warm-up (format v4, frozen when a geometry sets
    0 < rate_lo < rate): ``vtable`` counts prior visits per entry, and the
    effective adaptation shift for this step is
        r_eff = min(rate, rate_lo + ceil_log2(min(vis, 1024) + 1))
    — cold entries adapt fast (rate_lo) and warm entries at the frozen
    rate. All colliding lanes read the same pre-step snapshot and each
    adds one visit (commutative), so encoder and decoder stay in lockstep
    exactly as for the probability update. Measured (tools/
    probe_qual_warmup.py): -3.6..-12% on 500-read corpora, -0.9% on a
    warm 16k block — strictly better than any fixed-rate choice.
    """
    p32 = (marked & I32((1 << CNT_SHIFT) - 1)).astype(I32)
    cnt = (marked >> I32(CNT_SHIFT)).astype(I32)
    p32 = np.clip(p32, PROB_MIN, PROB_MAX)
    real = idx < sac_base
    if vtable is not None and 0 < rate_lo < rate:
        vis = np.minimum(vtable[idx], I32(1024))
        lgv = ceil_log2_counts(vis + I32(1))
        r_eff = np.minimum(I32(rate), I32(rate_lo) + lgv)
        delta = np.where(bit.astype(bool),
                         -(p32 >> r_eff),
                         (I32(PROB_ONE) - p32) >> r_eff)
        np.add.at(vtable, idx, np.where(real, I32(1), I32(0)))
    else:
        delta = np.where(bit.astype(bool),
                         -(p32 >> rate),
                         (I32(PROB_ONE) - p32) >> rate)
    extra = np.maximum(ceil_log2_counts(np.maximum(cnt, 1)) - CAP_LOG2, 0)
    delta = delta >> extra  # arithmetic shift: consistent across backends
    delta = np.where(real, delta - I32(1 << CNT_SHIFT), I32(0))
    np.add.at(table, idx, delta)
    touched = idx[real]
    table[touched] = np.clip(table[touched], PROB_MIN, PROB_MAX)


# ---------------------------------------------------------------------------
# Symbol-level coding through a balanced binary tree
# ---------------------------------------------------------------------------

def encode_symbols(enc: LaneEncoder, table: np.ndarray, ctx: np.ndarray,
                   sym: np.ndarray, depth: int, rate: int,
                   sac_base: int, vtable: np.ndarray | None = None,
                   rate_lo: int = 0) -> None:
    """Encode one ``depth``-bit symbol per lane (every lane, every step).

    Tree node layout: entry index = ctx * (2**depth - 1) + (node - 1), with
    node starting at 1 and descending node = 2*node + bit, MSB first.
    Padded steps pass ctx == num_ctx (the sacrificial row) and sym == 0.
    """
    nodes = (1 << depth) - 1
    base = ctx.astype(np.int64) * nodes
    node = np.ones(ctx.shape[0], dtype=np.int64)
    for i in range(depth - 1, -1, -1):
        bit = ((sym >> U32(i)) & U32(1)).astype(U32)
        idx = base + node - 1
        table_mark(table, idx, sac_base)
        marked = table[idx]
        p = np.clip(marked & I32((1 << CNT_SHIFT) - 1),
                    PROB_MIN, PROB_MAX).astype(U32)
        enc.encode_bits(p, bit)
        table_update(table, idx, marked, bit, rate, sac_base,
                     vtable=vtable, rate_lo=rate_lo)
        node = 2 * node + bit.astype(np.int64)


def decode_symbols(dec: LaneDecoder, table: np.ndarray, ctx: np.ndarray,
                   depth: int, rate: int, sac_base: int,
                   vtable: np.ndarray | None = None,
                   rate_lo: int = 0) -> np.ndarray:
    """Decode one ``depth``-bit symbol per lane. Returns uint32[W]."""
    nodes = (1 << depth) - 1
    base = ctx.astype(np.int64) * nodes
    node = np.ones(ctx.shape[0], dtype=np.int64)
    sym = np.zeros(ctx.shape[0], dtype=U32)
    for _ in range(depth):
        idx = base + node - 1
        table_mark(table, idx, sac_base)
        marked = table[idx]
        p = np.clip(marked & I32((1 << CNT_SHIFT) - 1),
                    PROB_MIN, PROB_MAX).astype(U32)
        bit = dec.decode_bits(p)
        table_update(table, idx, marked, bit, rate, sac_base,
                     vtable=vtable, rate_lo=rate_lo)
        node = 2 * node + bit.astype(np.int64)
        sym = (sym << U32(1)) | bit
    return sym
