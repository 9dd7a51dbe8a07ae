"""Kernel E, the decoupled encode: its six phases, their plain versions
and the composition that coder_torch.lane_encode_blocks runs.

The table law of the lockstep coder (ops/ranger.py) reads, at bit-step s,
the same p and visit count for every real lane on an entry e, and every
lane coding a 1 adds the same delta d1, every other one d0: with n the
real lanes on e and k of them coding a 1,

    p_e(s+1) = clamp(p + k*d1 + (n-k)*d0, 16, 4080),  vis_e += n.

So the table evolves with the symbols alone and the encode splits into
phases, each over its own parallel axis (csrc/encode.cu):

1. ``rows``: each symbol-step's first entry ``rows [B, Lt, W]`` int32,
   from its lane's context state (the one Kernel D decodes with), which
   the last few symbols alone decide (the kernel rebuilds it from them a
   step; the plain version carries it across the slice, and to the next
   in ``ctx``);
2. ``touches``: per bit-step, the real lanes grouped by entry into
   records (entry ``key``, ``nk`` = n | k << 16), numbered within the
   step in the order of each entry's first lane; ``cnt [B*L + 1]``
   becomes each step's first record (an exclusive scan, the total last),
   so block b's records are those from ``cnt[b*L]`` to ``cnt[(b+1)*L]``,
   and ``rid [B, L, W]`` int16 each decision's record number in its step
   (all ones for a sacrificial decision). From WIDE_LANES lanes on, where
   n, k and a step's records can reach 65,536, ``nk`` holds n and ``kk``
   k, and ``rid`` is int32;
3. ``sort``: the records grouped by entry, in step order within an entry
   (a stable sort: an LSD radix sort of 8-bit digits on the card), with
   each record's number in the same order;
4. ``entry_scan``: each entry walks its records in order and writes p
   as it stood before each record over the record's ``nk``; the tables
   ``[B, table_size]`` (p | vis << 12, 16-bit or, where the visit cap
   passes 15, 32-bit entries: coder_torch.entry_bytes) carry to the next
   slice with the whole visit count;
5. ``gather``: each decision's p through its record, with its bit,
   written over its rid (p | bit << 15);
6. ``code``: each lane codes its decisions alone from them, emitting
   into its chunk windows; its low, range and chunk position carry to
   the next slice.

A launch set covers one stream of each of B blocks (a window) in slices
of L bit-steps, at most SLICE_DECISIONS decisions (B x L x W) a slice, so
its scratch is bounded whatever the streams' length. On the card one host
call (csrc/encode.cu's ``enc_run``) issues every slice's phases, the lane
coder of a slice on a second CUDA stream beside the other phases of the
next slice. Each phase's wrapper launches its kernels on CUDA tensors
(counted in ``_cuda.launches`` under its name) and runs its plain
version, below, on CPU tensors; ``encode_blocks`` composes the plain
versions on CPU tensors and calls ``enc_run`` on CUDA tensors, and its
outputs are ``coder_torch.lane_encode_blocks``'s.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from . import _cuda
from .coder_torch import (CHUNK_SYMS, KINDS, _coder_step, _ctx_advance,
                          _ctx_init, _ctx_step, _kind_params, _lg_lut,
                          _renorm, _u32_bits, _warm, WIDE_LANES,
                          cta_lanes_per_thread, device_table, entry_bytes,
                          visit_cap)
from .ranger import (BOT, CAP_LOG2, MASK32, PROB_BITS, PROB_MAX, PROB_MIN,
                     PROB_ONE, RENORM_ITERS)

# decisions (blocks x bit-steps x lanes) of one slice: its scratch is
# about SCRATCH_PER_DECISION bytes each (~105 MB); the tests lower it to
# put slice boundaries where they want them
SLICE_DECISIONS = 1 << 22
# rid 2 + 2 (two buffers), the records' key and nk 4 + 4, the sort's three
# more buffers 12, its tile histogram 1
SCRATCH_PER_DECISION = 25
# from WIDE_LANES lanes on: rid 4 + 4 and the records' kk 4
WIDE_SCRATCH = 8
NK_BITS = 16  # record fields below WIDE_LANES: n (bits 0-15), k (16-31)
# WIDE_LANES (coder_torch): from there n, k (up to W each) and a step's
# record numbers (up to W - 1, beside the sacrificial all ones) no longer
# fit 16 bits: the records keep n in nk and k in kk, and rid is 32 bits
COUNT_FIELD = 1 << 10  # the format's collision-count field holds n mod 1024
RADIX_BITS = 8
TILE = 1024  # records a sort tile (csrc/encode.cu)
SCAN_CHUNK = 4096  # ints a scan CTA covers
BIT_SHIFT = 15  # the gather's u16 a decision: p (bits 0-11), its bit
VIS_SHIFT = PROB_BITS  # a table entry's visit count, above its 12-bit p

_P, _I = _cuda.PTR, _cuda.INT
_SIGS = {"enc_rows": [_P, _I, _P], "enc_touches": [_P, _I, _P],
         "enc_sort": [_P, _P], "enc_scan": [_P, _P],
         "enc_gather": [_P, _I, _P], "enc_code": [_P, _I, _P],
         "enc_run": [_P, _P, _P, _I, _P, _P, _P]}


class _Block(ctypes.Structure):
    """csrc/encode.cu's Block: one block's stream."""
    _fields_ = [("syms", ctypes.c_void_p), ("poss", ctypes.c_void_p),
                ("resets", ctypes.c_void_p), ("counts", ctypes.c_void_p),
                ("mflags", ctypes.c_void_p), ("ebufs", ctypes.c_void_p),
                ("eptrs", ctypes.c_void_p), ("Sp", ctypes.c_int),
                ("NC", ctypes.c_int)]


class _Plan(ctypes.Structure):
    """csrc/encode.cu's Plan: a launch set's scratch, carried state and
    shape."""
    _fields_ = [(n, ctypes.c_void_p) for n in (
        "blocks", "rows", "cnt", "rid", "key", "nk", "kk", "key1", "val1",
        "val2", "hist", "parts", "tables", "coder", "low", "emax", "hkey",
        "hcnt", "hfirst", "hslot", "ccnt")] + [
        (n, ctypes.c_int) for n in (
            "table_size", "sac_base", "rate", "rate_lo", "vcap", "kind",
            "depth", "num_ctx", "k0", "k1", "k2", "k3", "B", "W", "CB", "L",
            "Lt", "Dcap", "ntiles", "nbits", "wide", "tthreads", "tlanes",
            "nsl", "tbytes", "nch", "ebytes")]


class TouchShape(NamedTuple):
    """The touches phase's launch: up to CTA_LANES lanes one CTA a
    bit-step run, ``threads`` threads of ``per_thread`` lanes each (lane
    i * threads + t on thread t), a hash of 2^nsl slots (at least 2W) and
    ``smem_bytes`` of dynamic shared memory; past it one CTA a chunk of
    ``threads`` lanes and a bit-step, one lane a thread, the step's hash
    of 2^nsl slots in device memory (``smem_bytes`` 0)."""
    threads: int
    per_thread: int
    nsl: int
    smem_bytes: int

    @property
    def in_device(self) -> bool:
        """Whether the step's hash lives in device memory."""
        return self.smem_bytes == 0

    def chunks(self, W: int) -> int:
        """A step's CTAs where the hash lives in device memory."""
        return -(-W // self.threads)


CTA_LANES = 4096  # lanes the touches hold in one CTA (csrc/encode.cu)
CHUNK_THREADS = 256  # a touches CTA past CTA_LANES: one lane a thread
# a device-memory hash slot: the entry (then its record's number), n | k
# << 32 and the first lane
SLOT_BYTES = 16


def touch_shape(W: int) -> TouchShape:
    """The touches launch for W lanes: one lane a thread up to 1,024,
    then two or four, in whole warps of one CTA up to CTA_LANES, the
    hash's slots and the count words of each round's warps in two buffers
    in its shared memory; past it chunks of CHUNK_THREADS lanes, the
    step's hash in device memory (csrc/encode.cu checks the shape and
    refuses another)."""
    if W > CTA_LANES:
        return TouchShape(CHUNK_THREADS, 1, (2 * W - 1).bit_length(), 0)
    k = cta_lanes_per_thread(W)
    threads = (-(-W // k) + 31) // 32 * 32
    nsl = (2 * threads * k - 1).bit_length()
    return TouchShape(threads, k, nsl, (6 * (1 << nsl) + 64 * k) * 4)


def wide_records(W: int) -> bool:
    """Whether W lanes need the 32-bit record fields (WIDE_LANES)."""
    return W >= WIDE_LANES


def slice_steps(B: int, W: int, S: int) -> int:
    """Bit-steps of a slice of a launch set of B blocks of W lanes whose
    longest stream has S bit-steps."""
    return max(1, min(S, SLICE_DECISIONS // (B * W)))


def set_slices(items, depth: int) -> int:
    """Slices of the launch set of ``items`` (EncIn, symbols [Sp, W]) at
    a code tree of ``depth``."""
    W = items[0].syms.shape[1]
    S = max(it.syms.shape[0] for it in items) * depth
    return -(-S // slice_steps(len(items), W, S))


def scratch_bytes(B: int, W: int, S: int, depth: int) -> int:
    """Device bytes of the scratch of such a launch set (the carried
    tables and the outputs not included)."""
    L = slice_steps(B, W, S)
    D = B * L * W
    per = SCRATCH_PER_DECISION + WIDE_SCRATCH * wide_records(W)
    ts = touch_shape(W)
    hash_bytes = (B * L * ((1 << ts.nsl) * SLOT_BYTES + 4 * ts.chunks(W))
                  + 4 * D if ts.in_device else 0)
    return int(D * per) + 4 * B * (L // depth + 2) * W \
        + 4 * (B * L + 1) + 24 * B * W + hash_bytes


class EncodeSet:
    """One launch set of Kernel E: B blocks' EncIn of one stream (one
    kind, geometry and W; checked by coder_torch._check_items), their
    outputs, the scratch of one slice of L bit-steps (slice_steps') and
    the state that carries between slices."""

    def __init__(self, items, kind: str, geom, CB: int):
        self.items, self.kind, self.geom, self.CB = items, kind, geom, CB
        dev = self.dev = items[0].syms.device
        B = self.B = len(items)
        W = self.W = items[0].syms.shape[1]
        depth = self.depth = geom.depth
        self.S = max(it.syms.shape[0] for it in items) * depth
        L = self.L = slice_steps(B, W, self.S)
        self.Lt = L // depth + 2
        D = self.Dcap = B * L * W
        self.nbits = max(1, (geom.sac_base - 1).bit_length())
        self.ntiles = -(-D // TILE)

        def i32(*shape):
            return torch.empty(shape, dtype=torch.int32, device=dev)

        def zeros(*shape, dtype=torch.int32):
            # what the phases compare whole: a slice writes only its
            # blocks' part
            return torch.zeros(shape, dtype=dtype, device=dev)
        self.rows = zeros(B, self.Lt, W)
        self.ctx = zeros(B, 2, W)  # rows_plain's carried context state
        self.cnt = i32(B * L + 1)
        # two: the lane coder of one slice reads one while the phases of
        # the next write the other
        self.wide = wide_records(W)
        rtype = torch.int32 if self.wide else torch.int16
        self.rids = [zeros(B, L, W, dtype=rtype) for _ in range(2)]
        self.rid = self.rids[0]  # the one the phases use; enc_run takes both
        self.key, self.nk = i32(D), i32(D)
        self.kk = i32(D) if self.wide else None
        self.key1, self.val1, self.val2 = i32(D), i32(D), i32(D)
        self.hist = i32((1 << RADIX_BITS) * self.ntiles)
        ts = self.touch = touch_shape(W)
        # the touches past CTA_LANES: each step's hash and the chunks'
        # counts (csrc/encode.cu's Plan)
        nc = B * L * ts.chunks(W) + 1 if ts.in_device else 0
        if ts.in_device:
            slots = B * L << ts.nsl
            self.hkey, self.hfirst = i32(slots), i32(slots)
            self.hcnt = torch.empty(slots, dtype=torch.int64, device=dev)
            self.hslot, self.ccnt = i32(D), i32(nc)
        else:
            self.hkey = self.hcnt = self.hfirst = self.hslot = None
            self.ccnt = None
        self.parts = i32(-(-max(B * L + 1, (1 << RADIX_BITS) * self.ntiles,
                                nc) // SCAN_CHUNK))
        self.tables = device_table(geom, dev, B)
        self.coder = i32(B, 3, W)
        self.low = zeros(B, W)
        self.emax = zeros(B)
        # one allocation each for the blocks' chunk windows and counts;
        # every block's windows start 16-byte aligned (CB is a multiple of
        # 16)
        NCs = [it.NC for it in items]
        ebufs = torch.zeros(sum(NCs) * W * CB, dtype=torch.uint8,
                            device=dev)
        eptrs = torch.zeros(sum(NCs) * W, dtype=torch.int32, device=dev)
        self.ebufs, self.eptrs, at = [], [], 0
        for NC in NCs:
            self.ebufs.append(ebufs[at * W * CB: (at + NC) * W * CB].view(
                NC, W, CB))
            self.eptrs.append(eptrs[at * W: (at + NC) * W].view(NC, W))
            at += NC
        self.plan = self._plan() if dev.type == "cuda" else None

    def _plan(self) -> _Plan:
        """The kernels' Plan, its Block descriptors uploaded to the card
        (kept alive by self.blocks)."""
        descs = (_Block * self.B)()

        def ptr(t):
            return None if t is None else t.data_ptr()
        for d, it, eb, ep in zip(descs, self.items, self.ebufs, self.eptrs):
            d.syms, d.poss, d.resets, d.counts, d.mflags = (
                ptr(x) for x in it)
            d.ebufs, d.eptrs = eb.data_ptr(), ep.data_ptr()
            d.Sp, d.NC = it.syms.shape[0], it.NC
        host = torch.frombuffer(bytearray(descs), dtype=torch.uint8)
        with torch.cuda.device(self.dev):
            self.blocks = host.pin_memory().to(self.dev, non_blocking=True)
        g = self.geom
        p = _Plan(table_size=g.table_size, sac_base=g.sac_base, rate=g.rate,
                  rate_lo=getattr(g, "rate_lo", 0), vcap=visit_cap(g),
                  kind=KINDS[self.kind], depth=g.depth, num_ctx=g.num_ctx,
                  B=self.B, W=self.W, CB=self.CB, L=self.L, Lt=self.Lt,
                  Dcap=self.Dcap, ntiles=self.ntiles, nbits=self.nbits)
        p.k0, p.k1, p.k2, p.k3 = _kind_params(self.kind, g)
        p.tthreads, p.tlanes, p.nsl, p.tbytes = self.touch
        p.nch = self.touch.chunks(self.W) if self.touch.in_device else 0
        for name in ("blocks", "rows", "cnt", "rid", "key", "nk",
                     "key1", "val1", "val2", "hist", "parts", "tables",
                     "coder", "low", "emax"):
            setattr(p, name, getattr(self, name).data_ptr())
        for name in ("kk", "hkey", "hcnt", "hfirst", "hslot", "ccnt"):
            t = getattr(self, name)
            setattr(p, name, None if t is None else t.data_ptr())
        p.wide = int(self.wide)
        p.ebytes = entry_bytes(g)
        return p

    def span(self, b: int, s0: int):
        """Block b's bit-steps [s0, s1) of the slice at s0, or None."""
        S = self.items[b].syms.shape[0] * self.depth
        return None if s0 >= S else (s0, min(s0 + self.L, S))

    def sorted_records(self):
        """(entries, record numbers) of the sort's output: the buffer pair
        its last radix pass wrote."""
        passes = -(-self.nbits // RADIX_BITS)
        return ((self.key1, self.val1) if passes % 2 else
                (self.key, self.val2))

    def records(self) -> int:
        return int(self.cnt[self.B * self.L])

    def results(self) -> list:
        """Per block (ebufs [NC, W, CB] u8, eptrs [NC, W] i32, low [W]
        int32, emax 0-d int32)."""
        return [(eb, ep, self.low[b], self.emax[b])
                for b, (eb, ep) in enumerate(zip(self.ebufs, self.eptrs))]


# ---------------------------------------------------------------------------
# the phases' wrappers: the kernel on CUDA tensors, the plain version on CPU
# tensors
# ---------------------------------------------------------------------------

def _launch(es: EncodeSet, name: str, entry: str, *args) -> None:
    lib = _cuda.load("encode", _SIGS)
    err = _cuda.launch(es.cnt, getattr(lib, entry),
                       ctypes.byref(es.plan), *args)
    _cuda.count(name, es.B, es.dev)
    _cuda.check(lib, err, entry)


def rows(es: EncodeSet, s0: int) -> None:
    """Phase 1 of the slice at s0: rows, the carried context state."""
    if es.plan is None:
        rows_plain(es, s0)
    else:
        _launch(es, "encode_rows", "enc_rows", s0)


def touches(es: EncodeSet, s0: int) -> None:
    """Phase 2 of the slice at s0: cnt (offsets), key, nk, rid."""
    if es.plan is None:
        touches_plain(es, s0)
    else:
        _launch(es, "encode_touches", "enc_touches", s0)


def sort(es: EncodeSet) -> None:
    """Phase 3: the records by entry (sorted_records)."""
    if es.plan is None:
        sort_plain(es)
    else:
        _launch(es, "encode_sort", "enc_sort")


def entry_scan(es: EncodeSet) -> None:
    """Phase 4: each record's p (in nk), the carried tables."""
    if es.plan is None:
        entry_scan_plain(es)
    else:
        _launch(es, "encode_entry_scan", "enc_scan")


def gather(es: EncodeSet, s0: int) -> None:
    """Phase 5 of the slice at s0: p | bit << 15 of every decision, over
    its rid."""
    if es.plan is None:
        gather_plain(es, s0)
    else:
        _launch(es, "encode_gather", "enc_gather", s0)


def code(es: EncodeSet, s0: int) -> None:
    """Phase 5 of the slice at s0: the chunk windows and counts, the
    carried coder state, low and emax at a stream's end."""
    if es.plan is None:
        code_plain(es, s0)
    else:
        _launch(es, "encode_code", "enc_code", s0)


STEPS = (("rows", rows, True), ("touches", touches, True),
         ("sort", sort, False), ("entry_scan", entry_scan, False),
         ("gather", gather, True), ("code", code, True))
# where enc_run's error came from: a phase, or the streams' ordering
RUN_PHASES = tuple(name for name, _, _ in STEPS) + ("stream order",)


def encode_blocks(items, kind: str, geom, CB: int):
    """Kernel E over a launch set (coder_torch.lane_encode_blocks' checked
    items): every slice through the six phases. On the card one call of
    enc_run issues them all: the lane coder on a second CUDA stream,
    slice k's behind its gather, slice k+2's touches (which write the rid
    buffer it reads) behind it, and the calling stream behind it at the
    end. Returns per block (ebufs, eptrs, low, emax)."""
    es = EncodeSet(items, kind, geom, CB)
    if es.plan is None:
        for s0 in range(0, es.S, es.L):
            for _, fn, sliced in STEPS:
                fn(es, s0) if sliced else fn(es)
        return es.results()
    lib = _cuda.load("encode", _SIGS)
    prep = torch.cuda.current_stream(es.dev)
    coding = torch.cuda.Stream(es.dev)
    where = (ctypes.c_int * 2)()
    with torch.cuda.device(es.dev):
        err = lib.enc_run(ctypes.byref(es.plan), es.rids[0].data_ptr(),
                          es.rids[1].data_ptr(), es.S, prep.cuda_stream,
                          coding.cuda_stream, where)
    n = -(-es.S // es.L)
    _cuda.count_many({"encode_run": (1, n), **{
        f"encode_{name}": (n, n * es.B) for name, _, _ in STEPS}}, es.dev)
    if err:
        _cuda.check(lib, err, f"enc_run (slice {where[0]}, "
                    f"{RUN_PHASES[where[1]]})")
    return es.results()


# ---------------------------------------------------------------------------
# plain versions (whole-slice tensor ops; the coder steps bit by bit)
# ---------------------------------------------------------------------------

def _wrap(v: torch.Tensor, dtype) -> torch.Tensor:
    """Non-negative int64 values below 2^bits as the same bits of a signed
    `dtype` of that width (int16 or int32)."""
    bits = torch.iinfo(dtype).bits
    return torch.where(v >= 1 << (bits - 1), v - (1 << bits), v).to(dtype)


def _rid_bits(es: EncodeSet) -> int:
    """All ones of rid's width: the sacrificial decision's rid."""
    return (1 << torch.iinfo(es.rid.dtype).bits) - 1


def _state_in(es: EncodeSet, b: int, s0: int) -> tuple:
    """Block b's carried context state as _ctx_step takes it."""
    W = es.W
    if s0 == 0:
        return _ctx_init(es.kind, W, es.dev)
    sa, sb = (es.ctx[b, i].long() for i in (0, 1))
    return (sa, sb) if es.kind == "qual" else (sa,)


def _state_out(es: EncodeSet, b: int, cst) -> None:
    for i, x in enumerate(cst):
        es.ctx[b, i] = x.int()


def rows_plain(es: EncodeSet, s0: int) -> None:
    """Plain version of phase 1 (_ctx_step / _ctx_advance a step)."""
    kind, geom, depth = es.kind, es.geom, es.depth
    nodes = (1 << depth) - 1
    per_read = kind in ("qual", "seq")
    zero = torch.zeros(es.W, dtype=torch.int64, device=es.dev)
    for b, it in enumerate(es.items):
        span = es.span(b, s0)
        if span is None:
            continue
        s1 = span[1]
        t0, t1, tnext = s0 // depth, -(-s1 // depth), s1 // depth
        cst = _state_in(es, b, s0)
        cnt = it.counts.long()
        for t in range(t0, t1):
            if t == tnext:
                _state_out(es, b, cst)
            act = t < cnt
            ctx, cst = _ctx_step(kind, geom, cst,
                                 it.pos[t].long() if per_read else zero,
                                 it.reset[t] != 0 if per_read else zero != 0,
                                 None if it.mflag is None else it.mflag[t])
            es.rows[b, t - t0] = (torch.where(act, ctx, geom.num_ctx)
                                  * nodes).int()
            cst = _ctx_advance(kind, geom, cst,
                               torch.where(act, it.syms[t].long(), 0))
        if t1 <= tnext:
            _state_out(es, b, cst)


def _decisions(es: EncodeSet, b: int, s0: int, s1: int):
    """Block b's decisions of bit-steps [s0, s1): (entry, bit) [s1-s0, W]
    int64, from the rows and the symbols."""
    it, depth = es.items[b], es.depth
    t0, t1 = s0 // depth, -(-s1 // depth)
    t = torch.arange(t0, t1, device=es.dev)[:, None, None]
    act = t < it.counts.long()[None, None, :]
    sym = torch.where(act, it.syms[t0:t1].long()[:, None, :], 0)
    row = es.rows[b, :t1 - t0].long()[:, None, :]
    # every bit of each symbol-step, [t1 - t0, depth, W], then the span's
    j = torch.arange(depth, device=es.dev)[None, :, None]
    entry = row + ((1 << j) | (sym >> (depth - j))) - 1
    one = (sym >> (depth - 1 - j)) & 1
    lo, hi = s0 - t0 * depth, s1 - t0 * depth
    W = es.W
    return (entry.reshape(-1, W)[lo:hi], one.reshape(-1, W)[lo:hi])


def touches_plain(es: EncodeSet, s0: int) -> None:
    """Plain version of phase 2: a step's records in the order of their
    entries' first lanes, as the kernel numbers them."""
    W, L, T = es.W, es.L, es.geom.table_size
    es.cnt.zero_()
    lanes = torch.arange(W, device=es.dev)
    made = []
    for b in range(es.B):
        span = es.span(b, s0)
        if span is None:
            continue
        entry, one = _decisions(es, b, *span)
        real = entry < es.geom.sac_base
        n_s = entry.shape[0]
        steps = torch.arange(n_s, device=es.dev)[:, None].expand(-1, W)
        keys = (steps * T + entry)[real]
        uniq, inv = torch.unique(keys, return_inverse=True)
        lane = lanes.expand(n_s, -1)[real]
        first = torch.full((uniq.numel(),), W, dtype=torch.int64,
                           device=es.dev).scatter_reduce_(0, inv, lane,
                                                          "amin")
        rep = torch.zeros_like(real)
        rep[real] = lane == first[inv]
        local = rep.long().cumsum(dim=1) - 1
        es.cnt[b * L: b * L + n_s] = rep.sum(dim=1).int()
        made.append((b, span, entry, one, real, inv, rep, local))
    # each step's first record: an exclusive scan (the total last)
    es.cnt.copy_(torch.cumsum(es.cnt, 0, dtype=torch.int32) - es.cnt)
    for b, span, entry, one, real, inv, rep, local in made:
        n_s = entry.shape[0]
        n = torch.bincount(inv)
        k = torch.bincount(inv, weights=one[real].double()).long()
        loc_u = torch.empty_like(n)
        loc_u[inv[rep[real]]] = local[rep]
        at = (es.cnt[b * L: b * L + n_s].long()[:, None] + local)[rep]
        es.key[at] = entry[rep].int()
        urep = inv[rep[real]]
        if es.wide:
            es.nk[at], es.kk[at] = n[urep].int(), k[urep].int()
        else:
            es.nk[at] = _wrap(n[urep] | (k[urep] << NK_BITS), torch.int32)
        rid = torch.full((n_s, W), _rid_bits(es), dtype=torch.int64,
                         device=es.dev)
        rid[real] = loc_u[inv]
        es.rid[b, :n_s] = _wrap(rid, es.rid.dtype)


def sort_plain(es: EncodeSet) -> None:
    """Plain version of phase 3: a stable sort of the records by entry."""
    N = es.records()
    K, V = es.sorted_records()
    key = es.key[:N].clone()
    order = torch.sort(key, stable=True).indices
    K[:N] = key[order]
    V[:N] = order.int()


def _law(geom, warm: bool, lg, p, vis, n, one: bool):
    """ranger.table_update's delta of a lane coding `one` (law_delta in
    csrc/ctx.cuh), over tensors: the format's count field holds the n
    lanes on the entry mod 1024 and scales the delta only where it reads
    17 to 511."""
    r = ((lg[vis.clamp(max=1024) + 1] + geom.rate_lo).clamp(max=geom.rate)
         if warm else geom.rate)
    d = -(p >> r) if one else (PROB_ONE - p) >> r
    m = n & (COUNT_FIELD - 1)
    scaled = (m > (1 << CAP_LOG2)) & (m < COUNT_FIELD // 2)
    return d >> torch.where(scaled, lg[m] - CAP_LOG2, 0)


def entry_scan_plain(es: EncodeSet) -> None:
    """Plain version of phase 4: every entry's records in order, all
    entries at once (one tensor step a record of the longest chain)."""
    N = es.records()
    if N == 0:
        return
    K, V = (x[:N].long() for x in es.sorted_records())
    geom, T = es.geom, es.geom.table_size
    warm, vcap = _warm(geom), visit_cap(geom)
    lg = _lg_lut(es.dev).long()
    head = torch.ones(N, dtype=torch.bool, device=es.dev)
    head[1:] = K[1:] != K[:-1]
    starts = head.nonzero().flatten()
    lens = torch.diff(starts, append=torch.tensor([N], device=es.dev))
    e = K[starts]
    G = starts.numel()
    tab = es.tables.view(-1)
    bits = torch.iinfo(tab.dtype).bits  # 16 or 32 (entry_bytes)
    # a record's block: the last block whose first record is at or before
    # it (a block without records starts where the next one does)
    starts_b = es.cnt[0: es.B * es.L: es.L].long()
    cur = torch.full((G,), -1, dtype=torch.int64, device=es.dev)
    pr = torch.zeros(G, dtype=torch.int64, device=es.dev)
    vis = torch.zeros_like(pr)

    def store(g):
        tab[cur[g] * T + e[g]] = _wrap(pr[g] | (vis[g] << VIS_SHIFT),
                                       tab.dtype)
    for i in range(int(lens.max())):
        g = (lens > i).nonzero().flatten()
        r = V[starts[g] + i]
        if es.wide:
            n, k = es.nk[r].long(), es.kk[r].long()
        else:
            nk = es.nk[r].long() & MASK32
            n, k = nk & ((1 << NK_BITS) - 1), nk >> NK_BITS
        b = torch.searchsorted(starts_b, r, right=True) - 1
        sw = b != cur[g]
        out = g[sw & (cur[g] >= 0)]
        if out.numel():
            store(out)
        into = g[sw]
        if into.numel():
            cur[into] = b[sw]
            ent = tab[b[sw] * T + e[into]].long() & ((1 << bits) - 1)
            pr[into] = ent & (PROB_ONE - 1)
            vis[into] = ent >> VIS_SHIFT
        p, v = pr[g], vis[g]
        es.nk[r] = p.int()
        d1 = _law(geom, warm, lg, p, v, n, True)
        d0 = _law(geom, warm, lg, p, v, n, False)
        pr[g] = (p + k * d1 + (n - k) * d0).clamp(PROB_MIN, PROB_MAX)
        if warm:
            vis[g] = (v + n).clamp(max=vcap)
    store(torch.arange(G, device=es.dev))


def gather_plain(es: EncodeSet, s0: int) -> None:
    """Plain version of phase 5."""
    for b in range(es.B):
        span = es.span(b, s0)
        if span is None:
            continue
        n_s = span[1] - s0
        _, one = _decisions(es, b, *span)
        off = es.cnt[b * es.L: b * es.L + n_s].long()
        none = _rid_bits(es)
        rid = es.rid[b, :n_s].long() & none
        p = torch.where(rid == none, PROB_MAX,
                        es.nk[off[:, None] + torch.where(rid == none, 0, rid)].long())
        es.rid[b, :n_s] = _wrap(p | (one << BIT_SHIFT), es.rid.dtype)


def code_plain(es: EncodeSet, s0: int) -> None:
    """Plain version of phase 6: each block's lanes bit-step by bit-step
    (lane_encode_plain's coder without its law)."""
    W, CB, depth = es.W, es.CB, es.depth
    KD = CHUNK_SYMS * depth
    loff = torch.arange(W, device=es.dev) * CB
    sink = W * CB
    for b in range(es.B):
        span = es.span(b, s0)
        if span is None:
            continue
        s1 = span[1]
        q = es.rid[b, :s1 - s0].long() & 0xFFFF
        prob, ones = q & (PROB_ONE - 1), (q >> BIT_SHIFT) != 0
        if s0 == 0:
            low = torch.zeros(W, dtype=torch.int64, device=es.dev)
            rng = torch.full((W,), MASK32, dtype=torch.int64, device=es.dev)
            eptr = torch.zeros(W, dtype=torch.int64, device=es.dev)
        else:
            low, rng, eptr = (es.coder[b, i].long() & MASK32
                              for i in range(3))
        ebufs, eptrs = es.ebufs[b], es.eptrs[b]
        emx = 0
        c = s0 // KD
        ebuf = torch.zeros(W * CB + 1, dtype=torch.uint8, device=es.dev)
        ebuf[:-1] = ebufs[c].reshape(-1)
        for s in range(s0, s1):
            low, rng = _coder_step(low, rng, prob[s - s0], ones[s - s0])
            for _ in range(RENORM_ITERS):
                agree, do = _renorm(low, rng)
                if not bool(do.any()):
                    break
                rng = torch.where(do & ~agree, (-low) & (BOT - 1), rng)
                tgt = torch.where(do & (eptr < CB), loff + eptr, sink)
                ebuf.index_put_((tgt,), (low >> 24).to(torch.uint8))
                eptr = eptr + do
                low = torch.where(do, (low << 8) & MASK32, low)
                rng = torch.where(do, (rng << 8) & MASK32, rng)
            if (s + 1) % KD == 0:  # the chunk is complete
                ebufs[c] = ebuf[:-1].view(W, CB)
                eptrs[c] = eptr.int()
                emx = max(emx, int(eptr.max()))
                eptr = torch.zeros_like(eptr)
                c += 1
                if c < ebufs.shape[0]:
                    ebuf[:-1] = ebufs[c].reshape(-1)
        if s1 % KD:  # the slice ends inside a chunk
            ebufs[c] = ebuf[:-1].view(W, CB)
        for i, x in enumerate((low, rng, eptr)):
            es.coder[b, i] = _u32_bits(x)
        if s1 == es.items[b].syms.shape[0] * depth:
            es.low[b] = _u32_bits(low)
        es.emax[b] = max(int(es.emax[b]), emx)


def outputs_of(es: EncodeSet, phase: str) -> tuple:
    """What a phase wrote in the slice it ran last (the records' buffers
    up to their count): a kernel and its plain version must agree on it
    whole."""
    N = es.records()
    if phase == "rows":
        return (es.rows,)
    if phase == "touches":
        kk = () if es.kk is None else (es.kk[:N],)
        return (es.cnt, es.rid, es.key[:N], es.nk[:N], *kk)
    if phase == "sort":
        return tuple(x[:N] for x in es.sorted_records())
    if phase == "entry_scan":
        return es.nk[:N], es.tables
    if phase == "gather":
        return (es.rid,)
    return (es.coder, es.low, es.emax, *es.ebufs, *es.eptrs)


PLAIN = {"rows": rows_plain, "touches": touches_plain, "sort": sort_plain,
         "entry_scan": entry_scan_plain, "gather": gather_plain,
         "code": code_plain}


def compare_phases(items, kind: str, geom, CB: int,
                   plain_s: dict | None = None) -> dict:
    """Each phase's kernel against its plain version on the card, slice by
    slice: two launch sets of the same items, one through the kernels and
    one through the plain versions; after each phase the outputs_of both
    must be equal (raises AssertionError at the first difference).
    Returns {phase: largest absolute difference} (all 0) and adds each
    plain version's host seconds to ``plain_s``."""
    import time
    ek = EncodeSet(items, kind, geom, CB)
    ep = EncodeSet(items, kind, geom, CB)
    errs = dict.fromkeys(PLAIN, 0)
    for s0 in range(0, ek.S, ek.L):
        for name, fn, sliced in STEPS:
            args = (s0,) if sliced else ()
            fn(ek, *args)
            torch.cuda.synchronize(ek.dev)
            t = time.perf_counter()
            PLAIN[name](ep, *args)
            torch.cuda.synchronize(ek.dev)
            if plain_s is not None:
                plain_s[name] = plain_s.get(name, 0.0) + (
                    time.perf_counter() - t)
            for a, b in zip(outputs_of(ek, name), outputs_of(ep, name)):
                err = (int((a.long() - b.long()).abs().max())
                       if a.numel() else 0)
                if a.shape != b.shape or err:
                    raise AssertionError(
                        f"encode phase {name} ({kind}, slice at {s0}): "
                        f"kernel and plain version differ ({a.shape} vs "
                        f"{b.shape}, max abs error {err})")
    for a, b in zip(ek.results(), ep.results()):
        for x, y in zip(a, b):
            if not torch.equal(x, y):
                raise AssertionError(f"encode ({kind}): outputs differ")
    return errs

