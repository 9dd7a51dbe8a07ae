"""The lane coder: Kernel E (encode) and Kernel D (decode).

Ports of the JAX package's ``ops/streams_jax.py`` ``_build_encode`` (with
the schedule it reads, ``_ctx_precompute`` + ``_build_schedule``) and
``_build_decode``:

* ``lane_encode(syms, pos, reset, counts, kind, geom, CB, mflag)``: a
  stream's symbols ``[Sp, W]`` u8 with its per-step pos and reset
  ``[Sp, W]`` int32 (read by the qual and seq kinds), its lane counts
  ``[W]`` int32 and, for a format-v5 SEQ trial, its match-span flags
  ``[Sp, W]`` u8 -> ``ebufs [NC, W, CB]`` u8 (each chunk's renorm
  bytes), ``eptrs [NC, W]`` i32 (bytes each lane emitted per chunk,
  counted past CB so the caller sees an overflow), ``low [W]`` (the final
  coder low, u32 bits held in int32) and ``emax`` (max of eptrs, a 0-d
  int32 tensor). Each step's context row is built online from the
  symbols before it, as Kernel D builds it from the symbols it decodes
  (``_ctx_step`` / ``_ctx_advance``); the JAX package's closed-form
  schedule gives the same rows (streams_torch._schedule, its plain copy).
* ``lane_decode(payload, lens, counts, poss, resets, kind, geom, mflag)``:
  per-lane payload bytes ``[W, Lb]`` u8 with lengths ``[W]``, the lane
  counts ``[W]`` int32 (a step is active below its lane's count) and the
  per-step position/read-start matrices ``[Sp, W]`` int32 (and, for a
  format-v5 SEQ stream coded with the match-context family, its
  match-span flags ``[Sp, W]`` u8; ``_build_decode(with_mflag=True)``) ->
  symbols ``[Sp, W]`` u8 (0 where a step is inactive).

``lane_encode_blocks`` / ``lane_decode_blocks`` code one stream of each
block of a window at once (the JAX package's vmap over blocks,
parallel/mesh.py with mesh=None): each block its own inputs and step
count, its own fresh table and its own overflow check. ``lane_encode`` /
``lane_decode`` are their one-block case.

Both run the batch-synchronous, collision-capped table law (see
ops/ranger.py) with the format-v4 visit-count warm-up when the geometry
sets ``0 < rate_lo < rate``. Kernel E is the decoupled encode of
ops/encode_torch.py (csrc/encode.cu: p of every decision by a scan per
table entry, then each lane coded alone), on CUDA tensors its phases'
kernels and on CPU tensors their plain versions; Kernel D is the decode
of csrc/coder.cu (one synchronisation a symbol-step) on CUDA tensors and
``lane_decode_plain`` (the format's bit-step order) on CPU tensors. The
plain versions here carry low/range/code in int64 masked to 32 bits
(torch.uint32 has no arithmetic) and the table in int32, whose adds wrap
exactly as the format's collision-count field requires:
``lane_encode_plain`` (the lockstep encode, from the schedule
``online_schedule`` builds) is the independent reference the decoupled
encode is held against.

The kernels' table entries hold a 12-bit p and the visit count saturated
at ``visit_cap``: 16 bits (a 4-bit count) where the cap is below 16,
which every built-in level's is, else 32 bits (a 10-bit count, caps up
to 512, the most any header can ask for); ``entry_bytes`` chooses.
Kernel D's launch shape (a CTA or a thread block cluster a block, the
table in the CTA's shared memory or in device memory, SEQ's device table
in padded rows, the lanes' state in registers or, past REG_LANES, in
device memory) is ``decode_shape``'s, derived from the geometry, W and
the window's blocks; the wrappers take any lane count and any geometry
the header names up to Kernel D's eight tree levels.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from . import _cuda
from .ranger import (BOT, CAP_LOG2, CNT_SHIFT, MASK32, PROB_BITS, PROB_INIT,
                     PROB_MAX, PROB_MIN, PROB_ONE, RENORM_ITERS, TOP)

CHUNK_SYMS = 8  # symbol-steps per emission chunk
KINDS = {"qual": 0, "seq": 1, "byte": 2, "flag": 3}
_PMASK = (1 << CNT_SHIFT) - 1

_P, _I = _cuda.PTR, _cuda.INT
_SIGS = {
    # descs, n, W, table_size, sac_base, rate, rate_lo, vcap, depth, kind,
    # num_ctx, k0, k1, k2, k3, match, then the DecodeShape: cluster,
    # threads, smem_table, padded, bytes, the lanes a thread and the
    # entry's bytes; stream
    "lane_decode": [_P] + [_I] * 22 + [_P],
    # iters, threads, cluster, out, stream
    "barrier_loop": [_I, _I, _I, _P, _P],
}
# lanes of a stream Kernel D holds in registers: one lane a thread over a
# cluster of up to 8 CTAs of 512 threads (a table in device memory) or two
# or four a thread in one CTA of up to 1,024 (a table in shared memory);
# past it the loop form, each lane's state in device memory
REG_LANES = 4096
# lanes from which a count of lanes on one entry (and E's record numbers)
# no longer fits 16 bits: D's counters take 64 bits, E's records 32-bit
# fields (ops/encode_torch.py)
WIDE_LANES = 1 << 16
CTA_THREADS = 1024  # threads of one CTA
CLUSTER_THREADS = 512  # threads of each CTA of a cluster (csrc/coder.cu)
LOOP_THREADS = 1024  # threads of each CTA of the loop form's cluster
MAX_BLOCKS = 256  # blocks a launch: csrc/coder.cu's MAX_BLOCKS
MAX_CLUSTER = 8  # CTAs a cluster: the portable size (csrc/coder.cu)
SMS = 132  # the H100 SXM's streaming multiprocessors
MAX_DEPTH = 8  # tree levels a symbol Kernel D takes (csrc/coder.cu)


class EncIn(NamedTuple):
    """Kernel E's inputs of one block's stream, on one device: symbols
    [Sp, W] u8 (Sp a multiple of CHUNK_SYMS), pos and reset [Sp, W] int32
    (read by the qual and seq kinds; None for byte and flag), the lane
    counts [W] int32 and a format-v5 SEQ trial's match-span flags [Sp, W]
    u8 or None."""
    syms: torch.Tensor
    pos: torch.Tensor | None
    reset: torch.Tensor | None
    counts: torch.Tensor
    mflag: torch.Tensor | None = None

    @property
    def NC(self) -> int:
        return self.syms.shape[0] // CHUNK_SYMS

    def tensors(self) -> list:
        return [t for t in self if t is not None]


class _DecDesc(ctypes.Structure):
    """csrc/coder.cu's DecDesc: one block's stream for Kernel D."""
    _fields_ = [("payload", ctypes.c_void_p), ("lens", ctypes.c_void_p),
                ("counts", ctypes.c_void_p), ("poss", ctypes.c_void_p),
                ("resets", ctypes.c_void_p), ("mflags", ctypes.c_void_p),
                ("table", ctypes.c_void_p), ("tally", ctypes.c_void_p),
                ("syms", ctypes.c_void_p), ("state", ctypes.c_void_p),
                ("Lb", ctypes.c_int), ("Sp", ctypes.c_int)]
SMEM_LIMIT = 232448  # dynamic shared memory one CTA may use on the H100
# the kernels' entries: p in bits 0-11, the visit count from bit 12, in
# the 4 bits of a 16-bit entry or in a 32-bit one (csrc/ctx.cuh)
VIS_BITS = 4


def _warm(geom) -> bool:
    rate_lo = getattr(geom, "rate_lo", 0)
    return 0 < rate_lo < geom.rate


def _tables(geom, dev):
    """Fresh adaptive table (PROB_INIT, sacrificial row pinned at PROB_MAX)
    and, for a warm-up geometry, its zeroed visit table."""
    table = torch.full((geom.table_size,), PROB_INIT, dtype=torch.int32,
                       device=dev)
    table[geom.sac_base:] = PROB_MAX
    vtab = (torch.zeros(geom.table_size, dtype=torch.int32, device=dev)
            if _warm(geom) else None)
    return table, vtab


def visit_cap(geom) -> int:
    """The least visit count from which the warm-up shift stops changing
    (0 without warm-up): the kernels keep min(visits, cap). The shift
    min(rate, rate_lo + ceil_log2(v + 1)) reaches its last value where
    ceil_log2(v + 1) reaches min(rate - rate_lo, 10) (the law's
    ceil_log2 saturates at 10), at v = 2^(that - 1): no cap passes 512.
    A closed form: the wrappers read it at every launch."""
    if not _warm(geom):
        return 0
    return 1 << (min(geom.rate - geom.rate_lo, 10) - 1)


def entry_bytes(geom) -> int:
    """Bytes of one entry of the kernels' tables (and of the plain
    encode's carried tables): 2 where the visit cap fits 4 bits (every
    built-in level), else 4."""
    return 2 if visit_cap(geom) < 1 << VIS_BITS else 4


def table_bytes(geom) -> int:
    """Bytes of the kernels' table (entry_bytes an entry)."""
    return entry_bytes(geom) * geom.table_size


def _table_smem(geom) -> int:
    return (table_bytes(geom) + 15) // 16 * 16


def table_in_smem(geom) -> bool:
    """Whether Kernel D's table fits one CTA's shared memory (the kernel
    then builds it there)."""
    return _table_smem(geom) <= SMEM_LIMIT


def lane_state_bytes(geom) -> int:
    """Bytes of csrc/coder.cu's LaneState (the loop form's lanes): its
    coder, context and symbol fields, and one entry a tree level."""
    return 32 + MAX_DEPTH * entry_bytes(geom)


def _check_geom(geom) -> int:
    """The kernels' visit cap of the geometry; raises where the geometry
    does not fit them (Kernel D's tree levels)."""
    if not 1 <= geom.depth <= MAX_DEPTH:
        raise ValueError(f"depth {geom.depth} outside Kernel D's 1 to "
                         f"{MAX_DEPTH} levels")
    return visit_cap(geom)


class DecodeShape(NamedTuple):
    """Kernel D's launch over a window: ``cluster`` CTAs of ``threads``
    threads a block (lane w in CTA w // threads), the table in the CTA's
    shared memory ("smem", one CTA a block) or in device memory
    ("device"), ``padded``: a depth-2 device table (SEQ) laid out in rows
    padded to 4 entries, each loaded whole at its symbol's start;
    ``entries``: the table's entries in that layout; each CTA's dynamic
    shared memory and the launch's ``ctas``; ``entry_bytes``: 2 or 4
    (entry_bytes). The law's counters, one int32 an entry of the unpadded
    table, live in device memory."""
    cluster: int
    threads: int
    table: str
    padded: bool
    entries: int
    smem_bytes: int
    ctas: int
    entry_bytes: int = 2


def may_cluster(geom, W: int) -> bool:
    """Whether Kernel D may spread a stream over a cluster: a table in
    device memory (QUAL and SEQ at levels 2-4, the level-4 trials) beside
    at least 256 lanes, two CTAs of 128 threads or more."""
    return not table_in_smem(geom) and (W + 31) // 32 * 32 >= 256


def decode_shape(geom, W: int, B: int = 1) -> DecodeShape:
    """Kernel D's launch shape for W lanes of B blocks, derived (no option
    sets it). The table lives in the CTA's shared memory where it fits,
    else in device memory. A stream that may_cluster (QUAL, SEQ) spreads
    over a cluster of up to MAX_CLUSTER CTAs of at least 128 threads, as
    large as lets a window's clusters of two streams run side by side on
    the card's SMS (2 * B * cluster <= SMS), whatever its reads: the card
    measured SEQ's cluster about twice as fast as one CTA from 100-base
    reads to 16.5 kb ones; past 1,024 lanes, a cluster as large as keeps
    its CTAs at CLUSTER_THREADS (one lane a thread up to 4,096). Every
    other stream keeps one CTA a block, past 1,024 lanes with two or four
    lanes a thread (lanes_per_thread). For W <= 1,024 every thread holds
    one lane. Past REG_LANES every stream takes the loop form: a cluster
    of MAX_CLUSTER CTAs of up to LOOP_THREADS threads, its table in device
    memory (in padded rows at depth 2), as many lanes a thread as W asks.
    Entries of 32 bits (entry_bytes) halve the entries shared memory
    holds. Raises where the geometry does not fit the kernel."""
    _check_geom(geom)
    if not 1 <= B <= MAX_BLOCKS:
        raise ValueError(f"one launch codes 1 to {MAX_BLOCKS} blocks, not "
                         f"{B}")
    eb = entry_bytes(geom)
    if W > REG_LANES:
        C = MAX_CLUSTER
        threads = min(LOOP_THREADS, (-(-W // C) + 31) // 32 * 32)
        padded = geom.depth == 2
        entries = geom.table_size // 3 * 4 if padded else geom.table_size
        return DecodeShape(C, threads, "device", padded, entries, 0, B * C,
                           eb)
    lanes = (W + 31) // 32 * 32
    # a table past shared memory lives in device memory, a depth-1 one
    # (the flag kind past 16 history bits) as well as a deeper one
    if table_in_smem(geom):
        table, smem = "smem", _table_smem(geom)
    else:
        table, smem = "device", 0
    padded = table == "device" and geom.depth == 2
    entries = geom.table_size // 3 * 4 if padded else geom.table_size
    C = 1
    while (may_cluster(geom, W) and C < MAX_CLUSTER
           and lanes // (2 * C) >= 128 and 2 * B * 2 * C <= SMS):
        C *= 2
    while (may_cluster(geom, W) and W > CTA_THREADS
           and -(-W // C) > CLUSTER_THREADS):
        C *= 2
    k = 1 if C > 1 else cta_lanes_per_thread(W)
    threads = (-(-W // (C * k)) + 31) // 32 * 32
    return DecodeShape(C, threads, table, padded, entries, smem, B * C, eb)


def cta_lanes_per_thread(W: int) -> int:
    """The lanes each thread holds where one CTA holds W lanes (Kernel D
    beside a table in shared memory, E's touches): one up to CTA_THREADS,
    then two, then four."""
    return 1 if W <= CTA_THREADS else 2 if W <= 2 * CTA_THREADS else 4


def lanes_per_thread(shape: DecodeShape, W: int) -> int:
    """The lanes each thread of Kernel D's launch in ``shape`` decodes:
    lane (r k + i) T + t on thread t of CTA r of the cluster, i < k."""
    return -(-W // (shape.cluster * shape.threads))


def _kernel_geom(geom, W: int, dev, B: int | None = None):
    """Kernel D's table arguments: (a fresh device table, [B,
    entries] for B blocks, or None where the table lives in shared
    memory; the law's zeroed counters, [B, table_size] int32, int64 from
    WIDE_LANES lanes on; vcap; the DecodeShape). Raises where the
    geometry does not fit the kernel."""
    shape = decode_shape(geom, W, 1 if B is None else B)
    table = (None if shape.table == "smem"
             else device_table(geom, dev, B, shape.padded))
    tally = torch.zeros((1 if B is None else B, geom.table_size),
                        dtype=torch.int64 if W >= WIDE_LANES
                        else torch.int32, device=dev)
    return table, tally, visit_cap(geom), shape


def device_table(geom, dev, B: int | None = None,
                 padded: bool = False) -> torch.Tensor:
    """A fresh table of the kernels' entries in device memory (int16 or
    int32 by entry_bytes; PROB_INIT, visit count 0; the sacrificial row
    at PROB_MAX), or B of them [B, table_size], one a block; ``padded``: a
    depth-2 table's rows padded to 4 entries (Kernel D's layout: row r's
    node k at 4 r + k - 1)."""
    size, sac = geom.table_size, geom.sac_base
    if padded:
        size, sac = size // 3 * 4, sac // 3 * 4
    table = torch.full((size,) if B is None else (B, size), PROB_INIT,
                       dtype=torch.int16 if entry_bytes(geom) == 2
                       else torch.int32, device=dev)
    table[..., sac:] = PROB_MAX
    return table


def _lg_lut(dev):
    """lg[c] = #{j < 10 : c > 2^j} for c in [0, 1025] (ceil_log2 of a
    count, saturating at 10, 0 for c <= 1): the threshold sums of the
    table law as one lookup. Its users index it with a count the format's
    field holds (n mod 1024) or a visit count capped at 1,024, plus one,
    never with a raw lane count."""
    c = torch.arange(1026, device=dev)[:, None]
    return (c > (1 << torch.arange(10, device=dev))[None, :]).sum(
        dim=1).int()


def _u32_bits(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> the same 32 bits as int32."""
    return torch.where(x >= (1 << 31), x - (1 << 32), x).to(torch.int32)


class _Law:
    """Table law of one bit-step, plain version (ranger_np.table_mark +
    table_update in whole-lane tensor ops). The table, the probabilities
    and the deltas are int32, so the collision-count field in bits 22-31
    wraps exactly as the format requires."""

    def __init__(self, geom, W: int, dev):
        self.rate = geom.rate
        self.table, self.vtab = _tables(geom, dev)
        lg = _lg_lut(dev)
        # at most 2^CAP_LOG2 lanes can collide: the cap never scales
        self.extra = ((lg - CAP_LOG2).clamp_(min=0)
                      if W > (1 << CAP_LOG2) else None)
        if self.vtab is not None:  # effective shift by visit count
            self.shift = (lg[1:] + geom.rate_lo).clamp_(max=geom.rate)

    def mark(self, idx, marks):
        """Step A: deposit the count markers (``marks`` = real <<
        CNT_SHIFT). Returns the marked entries and the clamped p."""
        self.table.index_add_(0, idx, marks)
        marked = self.table[idx]
        return marked, (marked & _PMASK).clamp_(PROB_MIN, PROB_MAX)

    def update(self, idx, real, marked, p, one):
        """Step B: every lane's delta from the pre-step snapshot, merged
        by addition with the marker removal, then the touched entries
        clamped (colliding lanes store one value, so order is moot)."""
        if self.vtab is not None:
            shift = self.shift[self.vtab[idx].clamp_(max=1024)]
            self.vtab.index_add_(0, idx, real)
        else:
            shift = self.rate
        delta = torch.where(one, -(p >> shift), (PROB_ONE - p) >> shift)
        if self.extra is not None:
            delta >>= self.extra[(marked >> CNT_SHIFT).clamp_(min=0)]
        t = self.table
        t.index_add_(0, idx, (delta - (1 << CNT_SHIFT)) * real)
        t[idx] = t[idx].clamp_(PROB_MIN, PROB_MAX)


def _coder_step(low, rng, p, one):
    """The binary decision's interval split (before renormalisation)."""
    split = (rng >> PROB_BITS) * p
    return (low + split * one) & MASK32, torch.where(one, rng - split, split)


def _renorm(low, rng):
    """(agree, do) of one renorm round: `do` lanes shift a byte out."""
    agree = ((low ^ (low + rng)) & MASK32) < TOP
    return agree, agree | (rng < BOT)


def lane_encode_plain(idx_c: torch.Tensor, bit_c: torch.Tensor, geom,
                      CB: int):
    """Plain PyTorch version of Kernel E's coder (same outputs), from the
    schedule its contexts give (online_schedule)."""
    NC, KD, W = idx_c.shape
    dev = idx_c.device
    real_all = (idx_c < geom.sac_base).int()
    marks_all = real_all << CNT_SHIFT
    one_all = bit_c != 0
    law = _Law(geom, W, dev)
    low = torch.zeros(W, dtype=torch.int64, device=dev)
    rng = torch.full((W,), MASK32, dtype=torch.int64, device=dev)
    ebufs = torch.zeros((NC, W, CB), dtype=torch.uint8, device=dev)
    eptrs = torch.zeros((NC, W), dtype=torch.int32, device=dev)
    loff = torch.arange(W, device=dev) * CB
    sink = W * CB
    ebuf = torch.zeros(W * CB + 1, dtype=torch.uint8, device=dev)
    for c in range(NC):
        ebuf.zero_()
        eptr = torch.zeros(W, dtype=torch.int64, device=dev)
        for i in range(KD):
            idx, one = idx_c[c, i], one_all[c, i]
            marked, p = law.mark(idx, marks_all[c, i])
            low, rng = _coder_step(low, rng, p, one)
            for _ in range(RENORM_ITERS):
                agree, do = _renorm(low, rng)
                if not bool(do.any()):
                    break   # a renorm round with no lane to shift is a no-op
                rng = torch.where(do & ~agree, (-low) & (BOT - 1), rng)
                tgt = torch.where(do & (eptr < CB), loff + eptr, sink)
                ebuf.index_put_((tgt,), (low >> 24).to(torch.uint8))
                eptr = eptr + do
                low = torch.where(do, (low << 8) & MASK32, low)
                rng = torch.where(do, (rng << 8) & MASK32, rng)
            law.update(idx, real_all[c, i], marked, p, one)
        ebufs[c] = ebuf[:-1].reshape(W, CB)
        eptrs[c] = eptr.int()
    return ebufs, eptrs, _u32_bits(low), eptrs.max()


def _ctx_init(kind: str, W: int, dev):
    z = torch.zeros(W, dtype=torch.int64, device=dev)
    return (z, z.clone()) if kind == "qual" else (z,)


def _qdelta_code(a, b):
    """2-bit quantised q1-q2 delta (frozen format rule, config.QualGeom):
    0: equal; 1: up by <=3; 2: down by <=3; 3: |delta| > 3."""
    d = a - b
    return torch.where(d == 0, 0, torch.where((d > 0) & (d <= 3), 1,
                                              torch.where((d < 0) & (d >= -3),
                                                          2, 3)))


def _ctx_step(kind: str, geom, cst, pos, rs, mflag=None):
    """Online context of one symbol-step (the reference's _ctx_step);
    mflag: the step's match-span flags (seq, format v5)."""
    if kind == "qual":
        a, b = (torch.where(rs, 0, x) for x in cst)
        ctx = a
        shift = geom.depth
        if geom.q2_bits:
            ctx = ctx | ((b >> (geom.depth - geom.q2_bits)) << shift)
            shift += geom.q2_bits
        if geom.delta_bits:
            ctx = ctx | (_qdelta_code(a, b) << shift)
            shift += geom.delta_bits
        if geom.pos_bits:
            posb = (pos >> geom.pos_shift).clamp_(max=(1 << geom.pos_bits)
                                                  - 1)
            ctx = ctx | (posb << shift)
        return ctx, (a, b)
    if kind == "seq":
        h = torch.where(rs, 0, cst[0])
        j = pos.clamp(max=geom.order)
        ctx = h + ((1 << (2 * j)) - 1) // 3
        if mflag is not None and geom.match_bits:
            mctx = geom.tree_ctx + (h & ((1 << geom.match_bits) - 1))
            ctx = torch.where(mflag == 1, mctx, ctx)
        return ctx, (h,)
    if kind == "byte":
        return (cst[0] if geom.order else torch.zeros_like(cst[0])), cst
    if kind == "flag":
        return cst[0], cst
    raise ValueError(kind)


def _ctx_advance(kind: str, geom, cst, sym):
    if kind == "qual":
        return (sym, cst[0])
    if kind == "seq":
        return (((cst[0] << 2) | sym) & ((1 << (2 * geom.order)) - 1),)
    if kind == "byte":
        return (sym,)
    if kind == "flag":
        return (((cst[0] << 1) | sym) & ((1 << geom.hist_bits) - 1),)
    raise ValueError(kind)


def lane_decode_plain(payload: torch.Tensor, lens: torch.Tensor,
                      counts: torch.Tensor, poss: torch.Tensor,
                      resets: torch.Tensor, kind: str, geom, mflag=None):
    """Plain PyTorch version of Kernel D (same output)."""
    W, Lb = payload.shape
    Sp = poss.shape[0]
    dev = payload.device
    law = _Law(geom, W, dev)
    pay = payload.reshape(-1)
    rowoff = torch.arange(W, device=dev) * Lb
    lens64 = lens.long()
    steps = torch.arange(Sp, device=dev)[:, None]
    act_all = steps < counts.long()[None, :]
    # an active step's context is a real one, an inactive step codes in
    # the sacrificial row: `real` is `act`
    real_all = act_all.int()
    marks_all = real_all << CNT_SHIFT
    rs_all = resets != 0
    pos_all = poss.long()
    low = torch.zeros(W, dtype=torch.int64, device=dev)
    rng = torch.full((W,), MASK32, dtype=torch.int64, device=dev)
    code = torch.zeros(W, dtype=torch.int64, device=dev)
    ptr = torch.zeros(W, dtype=torch.int64, device=dev)

    def read(ptr, do):
        """Next payload byte of every lane where `do`; 0 past its end."""
        b = pay.index_select(0, rowoff + ptr.clamp(max=Lb - 1)).long()
        return b * ((ptr < lens64) & do)

    everyone = torch.ones(W, dtype=torch.bool, device=dev)
    for _ in range(4):
        code = (code << 8) | read(ptr, everyone)
        ptr = ptr + 1
    cst = _ctx_init(kind, W, dev)
    depth = geom.depth
    nodes = (1 << depth) - 1
    syms = torch.zeros((Sp, W), dtype=torch.uint8, device=dev)
    for t in range(Sp):
        act, real, marks = act_all[t], real_all[t], marks_all[t]
        ctx, cst = _ctx_step(kind, geom, cst, pos_all[t], rs_all[t],
                             None if mflag is None else mflag[t])
        base = torch.where(act, ctx, geom.num_ctx) * nodes - 1
        node = torch.ones(W, dtype=torch.int64, device=dev)
        for _ in range(depth):
            idx = base + node
            marked, p = law.mark(idx, marks)
            split = (rng >> PROB_BITS) * p
            one = ((code - low) & MASK32) >= split
            low, rng = _coder_step(low, rng, p, one)
            for _ in range(RENORM_ITERS):
                agree, do = _renorm(low, rng)
                if not bool(do.any()):
                    break
                rng = torch.where(do & ~agree, (-low) & (BOT - 1), rng)
                code = torch.where(do, ((code << 8) | read(ptr, do))
                                   & MASK32, code)
                ptr = ptr + do
                low = torch.where(do, (low << 8) & MASK32, low)
                rng = torch.where(do, (rng << 8) & MASK32, rng)
            law.update(idx, real, marked, p, one)
            node = 2 * node + one
        sym = (node - (1 << depth)) * act
        cst = _ctx_advance(kind, geom, cst, sym)
        syms[t] = sym.to(torch.uint8)
    return syms


def _kind_params(kind: str, geom):
    """Context parameters Kernel D builds its online context from."""
    if kind == "qual":
        return (geom.q2_bits, geom.delta_bits, geom.pos_bits, geom.pos_shift)
    if kind == "seq":
        return (geom.order, geom.match_bits, geom.tree_ctx, 0)
    if kind == "byte":
        return (geom.order, 0, 0, 0)
    if kind == "flag":
        return (geom.hist_bits, 0, 0, 0)
    raise ValueError(kind)


def _per_read(kind: str) -> bool:
    """The kinds whose contexts read pos and reset."""
    return kind in ("qual", "seq")


def online_schedule(kind: str, geom, item: EncIn):
    """The encode schedule Kernel E codes, built online as it builds it:
    each step's context row from the carried state (_ctx_step /
    _ctx_advance, Kernel D's rules). Returns idx_c, bit_c [NC, 8*depth,
    W] int32: bit j of a step's symbol takes entry row + ((1 << j) |
    (sym >> (depth - j))) - 1 and bit (sym >> (depth - 1 - j)) & 1; a step
    at or past its lane's count codes symbol 0 in the sacrificial row
    num_ctx."""
    syms, pos, reset, counts, mflag = item
    Sp, W = syms.shape
    dev = syms.device
    zero = torch.zeros(W, dtype=torch.int64, device=dev)
    cnt = counts.long()
    per_read = _per_read(kind)

    def step(t, cst):
        act = t < cnt
        ctx, cst = _ctx_step(kind, geom, cst,
                             pos[t].long() if per_read else zero,
                             reset[t] != 0 if per_read else zero != 0,
                             None if mflag is None else mflag[t])
        sym = torch.where(act, syms[t].long(), 0)
        return (torch.where(act, ctx, geom.num_ctx), sym,
                _ctx_advance(kind, geom, cst, sym))

    cst = _ctx_init(kind, W, dev)
    ctxs, sel = [], []
    for t in range(Sp):
        ctx, sym, cst = step(t, cst)
        ctxs.append(ctx)
        sel.append(sym)
    depth = geom.depth
    base = torch.stack(ctxs) * ((1 << depth) - 1)
    sym = torch.stack(sel)
    idx = torch.empty((Sp, depth, W), dtype=torch.int32, device=dev)
    bit = torch.empty_like(idx)
    for j in range(depth):
        idx[:, j] = base + ((1 << j) | (sym >> (depth - j))) - 1
        bit[:, j] = (sym >> (depth - 1 - j)) & 1
    NC = Sp // CHUNK_SYMS
    return (idx.view(NC, CHUNK_SYMS * depth, W),
            bit.view(NC, CHUNK_SYMS * depth, W))


def lane_encode_blocks_plain(items, kind: str, geom, CB: int) -> list:
    """Plain version of lane_encode_blocks: per block, its schedule built
    online (online_schedule), then lane_encode_plain."""
    return [lane_encode_plain(*online_schedule(kind, geom, item), geom, CB)
            for item in items]


def lane_decode_blocks_plain(items, kind: str, geom) -> list:
    """Plain version of lane_decode_blocks: lane_decode_plain per block."""
    return [lane_decode_plain(*it[:5], kind, geom,
                              it[5] if len(it) > 5 else None)
            for it in items]


def _window_device(tensors) -> torch.device:
    dev = tensors[0].device
    if any(t.device != dev for t in tensors):
        raise ValueError("every input of a launch must share a device")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def _check_items(items, kind: str, geom) -> tuple:
    """(W, each item as Kernel E reads it) of a launch's EncIn items:
    symbols u8 [Sp, W] with Sp a multiple of CHUNK_SYMS; pos and reset
    int32 [Sp, W] for the qual and seq kinds (dropped for byte and flag);
    counts int32 [W]; match flags u8 [Sp, W] where the geometry has the
    match family (dropped elsewhere, as the closed form ignores them)."""
    W = items[0].syms.shape[-1]
    family = kind == "seq" and bool(getattr(geom, "match_bits", 0))
    checked = []
    for it in items:
        syms, pos, reset, counts, mflag = it
        if syms.dim() != 2 or syms.dtype != torch.uint8:
            raise ValueError("symbols must be [Sp, W] uint8")
        Sp = syms.shape[0]
        if syms.shape[1] != W:
            raise ValueError("every block of a launch has the same lanes")
        if Sp % CHUNK_SYMS:
            raise ValueError(f"steps {Sp} not a multiple of {CHUNK_SYMS}")
        if counts.shape != (W,) or counts.dtype != torch.int32:
            raise ValueError("counts must be [W] int32")
        if _per_read(kind):
            if pos is None or reset is None or any(
                    x.dtype != torch.int32 or x.shape != syms.shape
                    for x in (pos, reset)):
                raise ValueError("pos and reset must be [Sp, W] int32")
        else:
            pos = reset = None
        if mflag is not None and (mflag.dtype != torch.uint8
                                  or mflag.shape != syms.shape):
            raise ValueError("mflag must be [Sp, W] uint8")
        checked.append(EncIn(syms, pos, reset, counts,
                             mflag if family else None))
    return W, checked


def lane_encode_blocks(items, kind: str, geom, CB: int) -> list:
    """Kernel E over a window: ``items`` holds each block's EncIn of one
    stream (one W, kind and geometry for all). Returns per block (ebufs
    [NC, W, CB] u8, eptrs [NC, W] i32, low [W], emax) as lane_encode
    does, emax the block's own. The decoupled encode of ops/encode_torch
    (in its slices): its phases' kernels on CUDA tensors, their plain
    versions on CPU tensors. Its bytes are lane_encode_blocks_plain's
    (the lockstep form)."""
    from . import encode_torch  # it imports this module's helpers
    if not 1 <= len(items) <= MAX_BLOCKS:
        raise ValueError(f"one launch codes 1 to {MAX_BLOCKS} blocks, not "
                         f"{len(items)}")
    W, items = _check_items(items, kind, geom)
    dev = _window_device([t for it in items for t in it.tensors()])
    if dev.type == "cuda":
        _check_geom(geom)
        items = [EncIn(*(None if x is None else x.contiguous() for x in it))
                 for it in items]
        _cuda.count("lane_encode", len(items), dev)
    return encode_torch.encode_blocks(items, kind, geom, CB)


def lane_encode(syms: torch.Tensor, pos: torch.Tensor | None,
                reset: torch.Tensor | None, counts: torch.Tensor, kind: str,
                geom, CB: int, mflag: torch.Tensor | None = None):
    """Kernel E on CUDA tensors, its plain version on CPU tensors: the
    one-block case of lane_encode_blocks."""
    return lane_encode_blocks([EncIn(syms, pos, reset, counts, mflag)],
                              kind, geom, CB)[0]


def lane_decode_blocks(items, kind: str, geom) -> list:
    """Kernel D over a window: ``items`` holds each block's (payload
    [W, Lb_b] u8, lens [W] int32, counts [W] int32, poss, resets [Sp_b,
    W] int32, and for a format-v5 SEQ stream with the match-context
    family its mflag [Sp_b, W] u8 or None), one W and geometry for all;
    the flags are given for every block of a launch or for none.
    poss/resets/mflag may also come as the reference's [NC, 8, W].
    Returns each block's symbols [Sp_b, W] u8. One launch (one CTA or
    cluster a block, decode_shape) on CUDA tensors, the plain version on
    CPU tensors."""
    if not 1 <= len(items) <= MAX_BLOCKS:
        raise ValueError(f"one launch codes 1 to {MAX_BLOCKS} blocks, not "
                         f"{len(items)}")
    W = items[0][0].shape[0]
    checked, flagged = [], []
    for it in items:
        payload, lens, counts, poss, resets = it[:5]
        mflag = it[5] if len(it) > 5 else None
        if payload.dim() != 2 or payload.dtype != torch.uint8:
            raise ValueError("payload must be [W, Lb] uint8")
        if payload.shape[0] != W:
            raise ValueError("every block of a launch has the same lanes")
        if payload.shape[1] < 1:
            raise ValueError("payload needs at least one column")
        for x, what in ((lens, "lens"), (counts, "counts")):
            if x.shape != (W,) or x.dtype != torch.int32:
                raise ValueError(f"{what} must be [W] int32")
        poss, resets = (x.reshape(-1, W) for x in (poss, resets))
        if any(x.dtype != torch.int32 or x.shape != poss.shape
               for x in (poss, resets)):
            raise ValueError("poss/resets must be int32 of one shape")
        if mflag is not None:
            mflag = mflag.reshape(-1, W)
            if mflag.dtype != torch.uint8 or mflag.shape != poss.shape:
                raise ValueError("mflag must be uint8 of the shape of poss")
        flagged.append(mflag is not None)
        checked.append((payload, lens, counts, poss, resets, mflag))
    if any(flagged) and not all(flagged):
        raise ValueError("the match-span flags come for every block of a "
                         "launch or for none")
    dev = _window_device([t for it in checked for t in it if t is not None])
    if dev.type == "cpu":
        return lane_decode_blocks_plain(checked, kind, geom)
    B = len(checked)
    table, tally, vcap, shape = _kernel_geom(geom, W, dev, B)
    # the loop form's lanes' state (csrc/coder.cu's LaneState), one a lane
    states = (torch.empty((B, W, lane_state_bytes(geom) // 4),
                          dtype=torch.int32, device=dev)
              if W > REG_LANES else None)
    # the kernel takes the flags only where the geometry has the family
    family = all(flagged) and kind == "seq" and bool(geom.match_bits)
    lib = _cuda.load("coder", _SIGS)
    descs, outs, keep = (_DecDesc * B)(), [], []
    for b, (payload, lens, counts, poss, resets, mflag) in \
            enumerate(checked):
        ins = [x.contiguous() for x in (payload, lens, counts, poss, resets)]
        mflag = mflag.contiguous() if family else None
        keep += ins + [mflag]
        syms = torch.empty(poss.shape, dtype=torch.uint8, device=dev)
        d = descs[b]
        d.payload, d.lens, d.counts, d.poss, d.resets = (
            x.data_ptr() for x in ins)
        d.mflags = None if mflag is None else mflag.data_ptr()
        d.table = None if table is None else table[b].data_ptr()
        d.tally = tally[b].data_ptr()
        d.state = None if states is None else states[b].data_ptr()
        d.syms, d.Lb, d.Sp = syms.data_ptr(), ins[0].shape[1], poss.shape[0]
        outs.append(syms)
    rate_lo = getattr(geom, "rate_lo", 0)
    err = _cuda.launch(
        outs[0], lib.lane_decode, ctypes.addressof(descs), B, W,
        geom.table_size, geom.sac_base, geom.rate, rate_lo, vcap,
        geom.depth, KINDS[kind], geom.num_ctx, *_kind_params(kind, geom),
        int(family), shape.cluster, shape.threads,
        int(shape.table == "smem"), int(shape.padded), shape.smem_bytes,
        lanes_per_thread(shape, W), shape.entry_bytes)
    _cuda.count("lane_decode", B, dev)
    _cuda.check(lib, err, "lane_decode")
    return outs


def lane_decode(payload: torch.Tensor, lens: torch.Tensor,
                counts: torch.Tensor, poss: torch.Tensor,
                resets: torch.Tensor, kind: str, geom,
                mflag: torch.Tensor | None = None):
    """Kernel D on CUDA tensors, its plain version on CPU tensors: the
    one-block case of lane_decode_blocks. poss/resets (and mflag, the
    uint8 match-span flags of a format-v5 SEQ stream) may be [Sp, W] or
    the reference's [NC, 8, W]."""
    return lane_decode_blocks([(payload, lens, counts, poss, resets, mflag)],
                              kind, geom)[0]
