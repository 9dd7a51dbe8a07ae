"""Stream drivers of the lane-interleaved codec on PyTorch (port of the JAX
package's ops/streams_jax.py, main-path surface).

Byte-identical to the JAX package and its NumPy oracle. Per stream:

* encode: the whole-array schedule (contexts in closed form from shifted
  symbol arrays, then every bit-step's table index and bit) -> Kernel E
  (the lockstep coder, ops/coder_torch) with chunk buffers sized
  optimistically, rerun with the hard worst-case size if any chunk
  overflowed -> Kernel C (compaction, ops/compact_torch), one launch for
  all of a block's streams -> one copy of the compacted bytes to the host
  -> the lanes' flush bytes appended there (native.flush_append).
* decode: acts/pos/reset derived as whole-array ops -> Kernel D.

A window of blocks' streams is coded at once: ``encode_window`` launches
Kernel E once per stream (and geometry) over the window's blocks, each
launch on its own CUDA stream (``StreamSet``), reads all the overflow
checks back in one synchronisation, compacts every block's streams in one
Kernel C launch and brings them to the host in one copy; ``encode_block``
is its one-block case. ``StreamSet.decode_blocks`` does the same for
Kernel D, each block's symbols read back when its caller needs them.

The ``*_blocks`` entry points (``encode_stream_blocks``,
``encode_seq_qual_raw_blocks``, ``decode_stream_blocks``,
``decode_seq_qual_raw_blocks``) are the batched multi-block surface of
the JAX package's streams_jax (its vmapped parallel/mesh.py kernels with
mesh=None): per block, the outputs of the one-block entries. Blocks need
not share a length: each block's CTA runs its own step count.

``encode_stream``/``decode_stream`` serve any kind with host-supplied
pos/reset (the main path sends the aux kinds ``byte`` and ``flag``);
``encode_seq_qual_raw``/``decode_seq_qual_raw`` carry SEQ and QUAL from
raw block bytes: the lane pack/unpack (ops/pack_torch) and pos/reset
derivation happen on the device, so the host ships only raw bytes, the
per-lane record-length matrix and the compressed payloads. A block of
2 GiB and more packs its lanes on the host instead (``host_jobs``, and
``decode_seq_qual_raw_blocks(host_unpack=...)``; ``encode_stream_ll`` /
``decode_stream_ll`` are the one-stream forms, as in streams_jax). A
stream whose schedule would pass SLICE_BYTES is coded in step slices
(``Slices``), and ``device_budget`` / ``encode_bytes`` /
``decode_bytes`` bound what a window holds on the device.

Every entry takes an explicit ``device``; the CPU runs the kernels' plain
versions.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager, nullcontext
from typing import NamedTuple

import numpy as np
import torch

from .. import native
from ..pipeline import _lane_lengths_matrix
from ..utils.stats import trace
from . import coder_torch, compact_torch, pack_torch
from .coder_torch import CHUNK_SYMS, _qdelta_code
from .ranger import FLUSH_BYTES, pad_steps


def _chunk_bytes(depth: int, hard: bool) -> int:
    """Per-lane emission capacity for one chunk. The hard bound is 3 bytes
    per bit-step (32-bit state, 8-bit renorm); the optimistic bound
    (~1 byte/bit-step + slack) is almost never exceeded — encode_block
    detects overflow and retries with the hard size."""
    bits = CHUNK_SYMS * depth
    b = (3 * bits + 8) if hard else (bits + 16)
    return (b + 15) // 16 * 16


# ---------------------------------------------------------------------------
# device bytes: step slices and the window budget
# ---------------------------------------------------------------------------

# Schedule bytes of one Kernel E launch of a stream: a longer stream is
# coded in step slices (Slices), its schedule built slice by slice. A
# 65,536-record block of 100 bp reads (QUAL's schedule 315 MB) is one
# slice; one of 16.5 kb reads (QUAL 52 GB, L3 SEQ 17 GB) is 25 + 9.
SLICE_BYTES = 2 << 30
# the device-byte budget of a window on the CPU (tests lower it)
CPU_BUDGET = 64 << 30


def _chunk_sched_bytes(depth: int, W: int) -> int:
    """Schedule bytes of one chunk of a stream (idx_c + bit_c, int32)."""
    return 2 * 4 * CHUNK_SYMS * depth * W


def slice_chunks(depth: int, W: int) -> int:
    """Chunks a step slice of a stream takes: SLICE_BYTES of schedule."""
    return max(1, SLICE_BYTES // _chunk_sched_bytes(depth, W))


def encode_bytes(Sp: int, W: int, depths, sym_bytes: int) -> int:
    """Device bytes of a block's SEQ/QUAL encode over Sp steps of W
    lanes, one tree depth a stream in ``depths`` (QUAL, SEQ, then each
    match trial's SEQ): pos and reset; per stream its symbols
    (``sym_bytes`` a step and lane: 4 packed on the device, 1 on the
    host), its schedule or one step slice of it, and its chunk buffers
    and counts at the optimistic size; a trial's match flags (1 byte)."""
    NC = Sp // CHUNK_SYMS
    total = (8 + max(len(depths) - 2, 0)) * Sp * W
    for d in depths:
        total += (sym_bytes * Sp * W
                  + min(NC, slice_chunks(d, W)) * _chunk_sched_bytes(d, W)
                  + NC * W * (_chunk_bytes(d, hard=False) + 4))
    return total


def decode_bytes(Sp: int, W: int) -> int:
    """Device bytes of a block's SEQ/QUAL decode over Sp steps of W
    lanes: acts, pos and reset (int32), both streams' symbols and the
    match flags (u8)."""
    return 16 * Sp * W


# per host thread: its side CUDA streams by device index (StreamSet) and
# the share of a card it codes with (card_share)
_LOCAL = threading.local()


@contextmanager
def card_share(n: int):
    """device_budget on this thread gives 1/n of the card: n shards of a
    mesh code on it at once."""
    prev = getattr(_LOCAL, "share", 1)
    _LOCAL.share = n
    try:
        yield
    finally:
        _LOCAL.share = prev


def device_budget(device) -> int:
    """Device bytes the SEQ/QUAL streams of a window may take (a window
    closes before the block that would pass it; a block above it codes
    alone): half of what the card has free, its caching allocator's idle
    blocks included, over the shards that share the card (card_share).
    The other half is headroom: a hard-chunk rerun raises a stream's
    chunk buffers up to 2.5-fold (QUAL at depth 6: 160 against 64 bytes
    a chunk and lane), and the schedule's and the unpack's temporaries
    come on top. On the CPU: CPU_BUDGET, shared as well."""
    dev = torch.device(device)
    share = getattr(_LOCAL, "share", 1)
    if dev.type != "cuda":
        return CPU_BUDGET // share
    free, _ = torch.cuda.mem_get_info(dev)
    idle = torch.cuda.memory_reserved(dev) - torch.cuda.memory_allocated(dev)
    return (free + idle) // 2 // share


def split_by_bytes(sizes, budget: int) -> list:
    """Consecutive runs of indices into ``sizes`` whose sums stay within
    ``budget`` (a run's first item may pass it alone)."""
    runs, used = [], 0
    for i, n in enumerate(sizes):
        if not runs or used + n > budget:
            runs.append([])
            used = 0
        runs[-1].append(i)
        used += n
    return runs


# ---------------------------------------------------------------------------
# schedule: closed-form contexts + per-bit-step table index and bit
# ---------------------------------------------------------------------------

def _shift_t(x: torch.Tensor, n: int) -> torch.Tensor:
    """x[t-n] along the step axis, zero-filled (lane streams start at 0)."""
    if n == 0:
        return x
    out = torch.zeros_like(x)
    out[n:] = x[:-n]
    return out


def _ctx_precompute(kind: str, geom, syms, pos, reset, mflag=None):
    """Closed-form [Sp, W] int32 context streams for the encode path; equal
    to the decoder's carried-state contexts at every active step. mflag
    (seq, format v5): 1 at the steps inside a match span, which code in
    the match-context family tree_ctx + (h & (2^match_bits - 1))."""
    rs = reset != 0
    if kind == "qual":
        a = torch.where(rs, 0, _shift_t(syms, 1))
        b = torch.where(rs | (_shift_t(reset, 1) != 0), 0, _shift_t(syms, 2))
        ctx = a
        shift = geom.depth
        if geom.q2_bits:
            ctx = ctx | ((b >> (geom.depth - geom.q2_bits)) << shift)
            shift += geom.q2_bits
        if geom.delta_bits:
            ctx = ctx | (_qdelta_code(a, b).int() << shift)
            shift += geom.delta_bits
        if geom.pos_bits:
            posb = (pos >> geom.pos_shift).clamp(max=(1 << geom.pos_bits)
                                                 - 1)
            ctx = ctx | (posb << shift)
        return ctx
    if kind == "seq":
        k = geom.order
        h = torch.zeros_like(syms)
        for j in range(1, k + 1):
            h = h | torch.where(pos >= j, _shift_t(syms, j) << (2 * (j - 1)),
                                0)
        j = pos.clamp(max=k)
        ctx = h + ((1 << (2 * j)) - 1) // 3
        if mflag is not None and geom.match_bits:
            mctx = geom.tree_ctx + (h & ((1 << geom.match_bits) - 1))
            ctx = torch.where(mflag == 1, mctx, ctx)
        return ctx
    if kind == "byte":
        return _shift_t(syms, 1) if geom.order else torch.zeros_like(syms)
    if kind == "flag":
        hb = geom.hist_bits
        h = torch.zeros_like(syms)
        for j in range(1, hb + 1):
            h = h | (_shift_t(syms, j) << (j - 1))
        return h & ((1 << hb) - 1)
    raise ValueError(kind)


def _halo(kind: str, geom) -> int:
    """Steps before a step that its context reads (_ctx_precompute's
    shifts)."""
    return {"qual": 2, "seq": getattr(geom, "order", 0), "byte": 1,
            "flag": getattr(geom, "hist_bits", 0)}[kind]


def _schedule(kind: str, geom, syms, pos, reset, counts, mflag=None,
              c0: int = 0, c1: int | None = None):
    """[Sp, W] symbols (int32 or u8), pos/reset (int32) + counts [W] ->
    the encode schedule idx_c, bit_c [NC, 8*depth, W] int32, or chunks
    [c0, c1) of it (a step slice: its contexts read their history from
    the steps before). Inactive steps code symbol 0 in the sacrificial
    context num_ctx. mflag: [Sp, W] match-span flags of a format-v5 SEQ
    trial."""
    Sp, W = syms.shape
    depth = geom.depth
    dev = syms.device
    t0 = c0 * CHUNK_SYMS
    t1 = Sp if c1 is None else c1 * CHUNK_SYMS
    a = max(0, t0 - _halo(kind, geom))
    ctx = _ctx_precompute(kind, geom, syms[a:t1].int(), pos[a:t1],
                          reset[a:t1],
                          None if mflag is None else mflag[a:t1])[t0 - a:]
    steps = torch.arange(t0, t1, device=dev, dtype=torch.int32)
    active = steps[:, None] < counts[None, :]
    ctx = torch.where(active, ctx, geom.num_ctx)
    sym = torch.where(active, syms[t0:t1].int(), 0)
    base = ctx * ((1 << depth) - 1)
    idx = torch.empty((t1 - t0, depth, W), dtype=torch.int32, device=dev)
    bit = torch.empty_like(idx)
    for j in range(depth):
        idx[:, j] = base + ((1 << j) | (sym >> (depth - j))) - 1
        bit[:, j] = (sym >> (depth - 1 - j)) & 1
    NC = (t1 - t0) // CHUNK_SYMS
    return (idx.view(NC, CHUNK_SYMS * depth, W),
            bit.view(NC, CHUNK_SYMS * depth, W))


def _pos_reset(lane_lens: torch.Tensor, Sp: int, S: int, W: int):
    """pos/reset [Sp, W] int32 from the per-lane record-length matrix
    [Rpl, W] (int64): a boundary scatter of the reads' starts, and of each
    start's distance from the lane's start before, whose running sum down
    the steps is the last read start (int32 throughout: no [Sp, W] int64
    temporary)."""
    dev = lane_lens.device
    starts = torch.zeros_like(lane_lens)
    if lane_lens.shape[0] > 1:
        starts[1:] = torch.cumsum(lane_lens[:-1], dim=0)
    lanes = torch.arange(W, device=dev)
    valid = (lane_lens > 0) & (starts < S)
    flat = torch.where(valid, starts * W + lanes, Sp * W).reshape(-1)
    # the latest valid start before each record (0 before the first)
    seen = torch.cummax(torch.where(valid, starts, 0), dim=0).values
    prev = torch.zeros_like(seen)
    prev[1:] = seen[:-1]
    reset = torch.zeros(Sp * W + 1, dtype=torch.int32, device=dev)
    reset[flat] = 1
    last = torch.zeros(Sp * W + 1, dtype=torch.int32, device=dev)
    last.index_add_(0, flat, torch.where(valid, starts - prev, 0).reshape(
        -1).int())
    pos = last[:-1].view(Sp, W).cumsum_(0)
    t_idx = torch.arange(Sp, dtype=torch.int32, device=dev)[:, None]
    return pos.neg_().add_(t_idx), reset[:-1].view(Sp, W)


def _to(x: np.ndarray, dev, dtype=None) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(x))
    return t.to(device=dev, dtype=dtype or t.dtype)


def _pad2(x, Sp: int, W: int, dev, dtype=torch.int32) -> torch.Tensor:
    out = torch.zeros((Sp, W), dtype=dtype, device=dev)
    if x is not None and x.shape[0]:
        out[: x.shape[0]] = _to(x, dev, dtype)
    return out


# ---------------------------------------------------------------------------
# encode / decode of one stream
# ---------------------------------------------------------------------------

def _flush_append(pay: np.ndarray, totals: np.ndarray, low: np.ndarray,
                  counts: np.ndarray):
    """Compacted per-lane payload + per-lane byte totals -> (payload
    [W, maxlen], lens) with the FLUSH_BYTES coder-tail bytes appended to
    every lane that has symbols (empty lanes contribute nothing)."""
    act = counts > 0
    lens = np.where(act, totals + FLUSH_BYTES, 0).astype(np.int64)
    maxlen = int(lens.max()) if lens.size else 0
    return native.flush_append(pay, totals, low, counts, maxlen), lens


# ---------------------------------------------------------------------------
# a block's streams at once
# ---------------------------------------------------------------------------


def _tensors(out) -> list:
    """The tensors of a launch's output (a tensor, or tuples and lists of
    them, or None)."""
    if isinstance(out, torch.Tensor):
        return [out]
    return [t for x in out or () for t in _tensors(x)]


class StreamSet:
    """A block's coder launches, each on its own CUDA stream from a pool
    of the calling thread's on the device (a mesh's shards on one card
    keep apart), so the block costs its longest chain and not the sum
    (on the CPU they run in order on the calling thread). A launch starts
    after the calling stream's work so far; ``join`` makes the calling
    stream wait for every launch."""

    def __init__(self, device):
        self.dev = torch.device(device)
        cuda = self.dev.type == "cuda"
        self.main = torch.cuda.current_stream(self.dev) if cuda else None
        self.used: list = []
        self.outputs: list = []
        self.decoded: dict = {}

    def _next(self):
        if self.main is None:
            return None
        if not hasattr(_LOCAL, "pools"):
            _LOCAL.pools = {}
        pool = _LOCAL.pools.setdefault(self.main.device_index, [])
        if len(pool) == len(self.used):
            pool.append(torch.cuda.Stream(self.dev))
        self.used.append(pool[len(self.used)])
        return self.used[-1]

    def launch(self, fn, *inputs, after=None):
        """fn() on the next stream of the pool, or behind the work of
        ``after``, a stream an earlier launch returned; returns its output
        (a tensor, or tuples and lists of them) and the stream."""
        s = after or self._next()
        if s is None:
            return fn(), None
        s.wait_stream(self.main)
        with torch.cuda.stream(s):
            out = fn()
        for t in inputs:
            t.record_stream(s)
        self.outputs.extend(_tensors(out))
        return out, s

    def join(self) -> None:
        """The calling stream waits for every launch so far; their outputs
        are marked in use by it (and no longer held here)."""
        if self.main is None:
            return
        for s in self.used:
            self.main.wait_stream(s)
        for t in self.outputs:
            t.record_stream(self.main)
        self.outputs.clear()

    def decode(self, name: str, kind: str, geom, payload: np.ndarray,
               lens: np.ndarray, counts: np.ndarray, num_steps: int,
               pos: np.ndarray | None = None,
               reset: np.ndarray | None = None) -> None:
        """Launch Kernel D on one host-modelled stream; ``symbols(name)``
        reads it back."""
        self.decode_blocks(name, [name], kind, geom,
                           [(payload, lens, counts, num_steps, pos, reset)])

    def decode_blocks(self, name: str, keys: list, kind: str, geom,
                      items: list) -> None:
        """Launch Kernel D once on one host-modelled stream of several
        blocks, each item a block's (payload, lens, counts, num_steps,
        pos or None, reset or None); ``symbols(key)`` reads a block's
        back."""
        dev, live, args = self.dev, [], []
        for key, (payload, lens, counts, num_steps, pos, reset) in zip(
                keys, items):
            W = payload.shape[0]
            counts = np.asarray(counts)
            Sp = pad_steps(num_steps)
            if Sp == 0 or not (counts > 0).any():
                self.decoded[key] = (None, None, num_steps, W)
                continue
            live.append((key, num_steps, W))
            args.append((_payload_tensor(payload, dev),
                         _to(lens, dev, torch.int32),
                         _acts(_to(counts, dev, torch.int32), Sp),
                         _pad2(pos, Sp, W, dev), _pad2(reset, Sp, W, dev)))
        if not live:
            return
        with trace(f"sfq.decode.{name}.coder"):
            syms, s = self.launch(lambda: coder_torch.lane_decode_blocks(
                args, kind, geom), *_tensors(args))
        for (key, S, W), sy in zip(live, syms):
            self.decoded[key] = (sy, s, S, W)

    def symbols(self, key) -> np.ndarray:
        """[num_steps, W] u8 symbols of a stream launched by ``decode`` or
        ``decode_blocks``, waiting for its stream only."""
        syms, s, S, W = self.decoded[key]
        if syms is None:
            return np.zeros((S, W), dtype=np.uint8)
        with torch.cuda.stream(s) if s is not None else nullcontext():
            return syms[:S].cpu().numpy()


def stream_schedule(kind: str, geom, syms: np.ndarray, counts: np.ndarray,
                    device, pos: np.ndarray | None = None,
                    reset: np.ndarray | None = None):
    """The encode schedule (idx_c, bit_c) of a host-modelled [S, W] stream
    on the device, or None where it codes no step."""
    S, W = syms.shape
    Sp = pad_steps(S)
    if Sp == 0 or not (np.asarray(counts) > 0).any():
        return None
    dev = torch.device(device)
    with trace(f"sfq.encode.{kind}.schedule"):
        return _schedule(kind, geom, _pad2(syms, Sp, W, dev),
                         _pad2(pos, Sp, W, dev), _pad2(reset, Sp, W, dev),
                         _to(counts, dev, torch.int32))


def by_geom(name: str, kind: str, entries) -> list:
    """One stream of a window's blocks as encode_window groups: entries
    (block, geom, idx_c, bit_c, counts) split by geometry (a Kernel E
    launch takes one), in the order the geometries first come."""
    groups: dict = {}
    for b, geom, idx_c, bit_c, counts in entries:
        groups.setdefault(geom, []).append((b, idx_c, bit_c, counts))
    return [(name, kind, geom, members) for geom, members in groups.items()]


def _heads(outs) -> list:
    """[(emax, longest lane total)] of Kernel E outputs, one
    synchronisation."""
    return torch.stack([torch.stack([o[3], o[1].sum(dim=0).max()])
                        for o in outs]).cpu().tolist()


def _encode_members(ss: StreamSet | None, members, geom, CB: int) -> list:
    """Kernel E over a group's members (block, idx_c, bit_c, counts):
    one launch over those whose schedule is built, on a stream of ``ss``
    (the calling stream without one). Returns each member's (ebufs,
    eptrs, low, emax), or for a Slices member its generator of launches
    (Slices.encode), which _run_slices drives."""
    outs = [m[1].encode(CB) if isinstance(m[1], Slices) else None
            for m in members]
    built = [i for i, m in enumerate(members)
             if not isinstance(m[1], Slices)]
    if built:
        scheds = [(members[i][1], members[i][2]) for i in built]

        def run():
            return coder_torch.lane_encode_blocks(scheds, geom, CB)
        res = run() if ss is None else ss.launch(run, *_tensors(scheds))[0]
        for i, o in zip(built, res):
            outs[i] = o
    return outs


def _run_slices(ss: StreamSet | None, groups) -> None:
    """Drive the launches of every Slices member of ``groups`` ((members,
    outs) pairs, outs as _encode_members gives them), the slices of all
    the streams in turn (round robin), each stream on a CUDA stream of
    its own (the calling stream without ``ss``): the host issues each
    stream's first slices before a full launch queue can hold it up
    behind another's. Each member's generator in ``outs`` becomes its
    (ebufs, eptrs, low, emax)."""
    live = [(outs, i, m[1], None) for members, outs in groups
            for i, m in enumerate(members) if isinstance(m[1], Slices)]
    while live:
        nxt = []
        for outs, i, sl, s in live:
            if ss is None:
                out = next(outs[i])
            else:
                out, s = ss.launch(lambda g=outs[i]: next(g), *sl.tensors(),
                                   after=s)
            if out is None:
                nxt.append((outs, i, sl, s))
            else:
                outs[i] = out
        live = nxt


def encode_window(groups, device) -> dict:
    """Code a window of blocks' streams at once. ``groups`` yields (name,
    kind, geom, members), members a list of (block, idx_c, bit_c, counts
    [W]) of the blocks whose stream codes a step (a generator may build
    each group's schedules as it goes; the launches before it run
    meanwhile); a member whose idx_c is a Slices is coded in step slices
    on a stream of its own. Kernel E runs once a group, over its blocks,
    on its own CUDA stream with optimistic chunk buffers; one host
    synchronisation
    reads every block's overflow check and longest lane; the blocks whose
    chunk overflowed are rerun with hard buffers (the others keep their
    bytes, which do not depend on the buffer size); then one Kernel C
    launch compacts every block's streams, one copy brings the payloads,
    totals and coder tails to the host, and the flush bytes are appended
    there. Returns {(block, name): (payload [W, maxlen] u8, lens [W]
    int64)}."""
    ss = StreamSet(device)
    todo = []
    for name, _kind, geom, members in groups:
        CB = _chunk_bytes(geom.depth, hard=False)
        with trace(f"sfq.encode.{name}.coder"):
            outs = _encode_members(ss, members, geom, CB)
        todo.append((name, geom, members, outs))
    if not todo:
        return {}
    with trace("sfq.encode.slices"):
        _run_slices(ss, [(members, outs) for *_, members, outs in todo])
    ss.join()
    heads = iter(_heads([o for *_, outs in todo for o in outs]))
    streams, tails, keys = [], [], []
    for name, geom, members, outs in todo:
        head = [next(heads) for _ in outs]
        CB = _chunk_bytes(geom.depth, hard=False)
        over = [i for i, (emax, _) in enumerate(head) if emax > CB]
        if over:  # rare: rerun with the worst-case chunk size
            CB = _chunk_bytes(geom.depth, hard=True)
            for i in over:
                outs[i] = None  # the optimistic buffers go first
            with trace(f"sfq.encode.{name}.coder"):
                again = [members[i] for i in over]
                redo = _encode_members(None, again, geom, CB)
                _run_slices(None, [(again, redo)])
            for i, o, h in zip(over, redo, _heads(redo)):
                if h[0] > CB:
                    raise AssertionError("encode chunk overflow even with "
                                         "hard buffers")
                outs[i], head[i] = o, h
        for (b, _, _, counts), o, (_, tmax) in zip(members, outs, head):
            streams.append((o[0], o[1], max(tmax, 1)))
            tails.append(o[2])
            keys.append((b, name, counts))
    with trace("sfq.encode.compact"):
        flat, layout = compact_torch.compact_streams_dev(streams, tails)
        host = _to_host(flat)
    return {(b, name): _flush_append(pay.numpy(), tot.numpy(),
                                     low.numpy().view(np.uint32),
                                     np.asarray(counts))
            for (b, name, counts), (pay, tot, low) in zip(
                keys, layout.views(host))}


def encode_block(jobs, device) -> dict:
    """Code a block's streams at once: encode_window's one-block case.
    ``jobs`` yields (name, kind, geom, idx_c, bit_c, counts) in turn.
    Returns {name: (payload [W, maxlen] u8, lens [W] int64)}."""
    coded = encode_window(
        ((name, kind, geom, [(0, idx_c, bit_c, counts)])
         for name, kind, geom, idx_c, bit_c, counts in jobs), device)
    return {name: v for (_, name), v in coded.items()}


def _to_host(flat: torch.Tensor) -> torch.Tensor:
    """A CUDA tensor's bytes on the host: one copy into pinned memory on
    the calling stream, one synchronisation. The buffer is the caller's
    alone (_flush_append copies out of it)."""
    if flat.device.type == "cpu":
        return flat
    host = torch.empty(flat.shape, dtype=flat.dtype, pin_memory=True)
    host.copy_(flat, non_blocking=True)
    torch.cuda.current_stream(flat.device).synchronize()
    return host


def _empty_encode(W: int):
    return np.zeros((W, 0), dtype=np.uint8), np.zeros(W, dtype=np.int64)


def encode_stream(kind: str, geom, syms: np.ndarray, counts: np.ndarray,
                  device, pos: np.ndarray | None = None,
                  reset: np.ndarray | None = None):
    """[S, W] symbols + per-lane counts -> (payload [W, maxlen] u8, lens
    [W] int64). pos/reset: host [S, W] matrices for qual/seq."""
    counts = np.asarray(counts)
    sched = stream_schedule(kind, geom, syms, counts, device, pos, reset)
    if sched is None:
        return _empty_encode(syms.shape[1])
    return encode_block([(kind, kind, geom, *sched, counts)], device)[kind]


def _payload_tensor(payload: np.ndarray, dev) -> torch.Tensor:
    """Payload [W, L] u8 on the device, at least one column (bytes past a
    lane's length are never read)."""
    if payload.shape[1] == 0:
        payload = np.zeros((payload.shape[0], 1), dtype=np.uint8)
    return _to(payload, dev, torch.uint8)


def _acts(counts_t: torch.Tensor, Sp: int) -> torch.Tensor:
    steps = torch.arange(Sp, dtype=torch.int32, device=counts_t.device)
    return (steps[:, None] < counts_t[None, :]).int()


def decode_stream(kind: str, geom, payload: np.ndarray, lens: np.ndarray,
                  counts: np.ndarray, num_steps: int, device,
                  pos: np.ndarray | None = None,
                  reset: np.ndarray | None = None) -> np.ndarray:
    """(payload, lens) -> [num_steps, W] u8 symbols (0 past each count)."""
    ss = StreamSet(device)
    ss.decode(kind, kind, geom, payload, lens, counts, num_steps, pos, reset)
    return ss.symbols(kind)


def _ll_inputs(lane_len_mat: np.ndarray, S: int, W: int, dev):
    """(Sp, pos, reset [Sp, W] int32) of a per-read stream from its
    per-lane record-length matrix, derived on the device."""
    Sp = pad_steps(S)
    return (Sp, *_pos_reset(_lane_lens(lane_len_mat, W, dev), Sp, S, W))


def encode_stream_ll(kind: str, geom, syms: np.ndarray,
                     lane_len_mat: np.ndarray, counts: np.ndarray, device,
                     mflag: np.ndarray | None = None):
    """encode_stream for a per-read stream (qual/seq): pos/reset are
    derived on the device from the per-lane record-length matrix, so the
    host ships only the [S, W] symbols (as bytes) and that matrix; the
    schedule is built in step slices where the whole would pass
    SLICE_BYTES. mflag: a format-v5 SEQ trial's [S, W] match-span flags.
    Returns (payload [W, maxlen] u8, lens [W] int64)."""
    S, W = syms.shape
    counts = np.asarray(counts)
    if pad_steps(S) == 0 or not (counts > 0).any():
        return _empty_encode(W)
    dev = torch.device(device)
    Sp, pos, reset = _ll_inputs(lane_len_mat, S, W, dev)
    job = _coder_job(kind, kind, geom, _pad2(syms, Sp, W, dev, torch.uint8),
                     pos, reset, _to(counts, dev, torch.int32),
                     None if mflag is None
                     else _pad2(mflag, Sp, W, dev, torch.uint8))
    return encode_block([(kind, kind, geom, job.idx_c, job.bit_c, counts)],
                        device)[kind]


def decode_stream_ll(kind: str, geom, payload: np.ndarray, lens: np.ndarray,
                     lane_len_mat: np.ndarray, counts: np.ndarray,
                     num_steps: int, device,
                     mflag: np.ndarray | None = None) -> np.ndarray:
    """decode_stream with acts/pos/reset derived on the device from the
    per-lane record-length matrix: [num_steps, W] u8 symbols (0 past each
    count). mflag: a format-v5 SEQ stream's [S, W] match-span flags."""
    W = payload.shape[0]
    counts = np.asarray(counts)
    S = num_steps
    if pad_steps(S) == 0 or not (counts > 0).any():
        return np.zeros((S, W), dtype=np.uint8)
    dev = torch.device(device)
    Sp, pos, reset = _ll_inputs(lane_len_mat, S, W, dev)
    item = (_payload_tensor(payload, dev), _to(lens, dev, torch.int32),
            _acts(_to(counts, dev, torch.int32), Sp), pos, reset)
    if mflag is not None:
        item += (_pad2(mflag, Sp, W, dev, torch.uint8),)
    with trace(f"sfq.decode.{kind}.coder"):
        syms, = coder_torch.lane_decode_blocks([item], kind, geom)
    return syms[:S].cpu().numpy()


# ---------------------------------------------------------------------------
# device-raw SEQ + QUAL
# ---------------------------------------------------------------------------

def _lane_lens(ll_mat: np.ndarray, W: int, dev) -> torch.Tensor:
    Rpl = max(ll_mat.shape[0], 1)
    ll = np.zeros((Rpl, W), dtype=np.int64)
    ll[: ll_mat.shape[0]] = ll_mat
    return _to(ll, dev)


class Slices(NamedTuple):
    """A stream's encode schedule built one step slice at a time, as
    Kernel E takes it (coder_torch.lane_encode_slices): a stream whose
    whole schedule would pass SLICE_BYTES. Symbols (int32 or u8), pos and
    reset [Sp, W], counts [W] int32 and match flags on the device; called
    with (c0, c1), the schedule of chunks [c0, c1)."""
    kind: str
    geom: object
    syms: torch.Tensor
    pos: torch.Tensor
    reset: torch.Tensor
    counts: torch.Tensor
    mflag: torch.Tensor | None

    @property
    def NC(self) -> int:
        return self.syms.shape[0] // CHUNK_SYMS

    def __call__(self, c0: int, c1: int):
        with trace(f"sfq.encode.{self.kind}.schedule"):
            return _schedule(self.kind, self.geom, self.syms, self.pos,
                             self.reset, self.counts, self.mflag, c0, c1)

    def encode(self, CB: int):
        """Kernel E over the stream, one slice a step of this generator
        (coder_torch.lane_encode_slices): (ebufs, eptrs, low, emax) as
        lane_encode gives them, after the last."""
        W = self.syms.shape[1]
        return coder_torch.lane_encode_slices(
            self, self.NC, slice_chunks(self.geom.depth, W), W, self.geom,
            CB, self.syms.device)

    def tensors(self) -> list:
        return [t for t in (self.syms, self.pos, self.reset, self.counts,
                            self.mflag) if t is not None]


class CoderJob(NamedTuple):
    """One SEQ/QUAL stream's coder inputs on the device: lane symbols
    [Sp, W] (int32, or u8 where the host packed them), pos and reset
    [Sp, W] int32, counts [W] int32 and the encode schedule idx_c, bit_c
    [NC, 8*depth, W] int32; or, where the whole schedule would pass
    SLICE_BYTES, idx_c a Slices and bit_c None."""
    name: str
    kind: str
    geom: object
    syms: torch.Tensor
    pos: torch.Tensor
    reset: torch.Tensor
    counts: torch.Tensor
    idx_c: object
    bit_c: torch.Tensor | None


def _coder_job(name: str, kind: str, geom, syms, pos, reset, counts_t,
               mflag) -> CoderJob:
    """A stream's CoderJob: its schedule built whole, or as Slices where
    the whole would pass SLICE_BYTES."""
    Sp, W = syms.shape
    if Sp // CHUNK_SYMS > slice_chunks(geom.depth, W):
        return CoderJob(name, kind, geom, syms, pos, reset, counts_t,
                        Slices(kind, geom, syms, pos, reset, counts_t,
                               mflag), None)
    with trace(f"sfq.encode.{kind}.schedule"):
        idx_c, bit_c = _schedule(kind, geom, syms, pos, reset, counts_t,
                                 mflag)
    return CoderJob(name, kind, geom, syms, pos, reset, counts_t, idx_c,
                    bit_c)


def _jobs(streams, pos, reset, counts_t, Sp: int, W: int, dev, seq_mflag,
          only: tuple):
    """Each (name, kind, geom, symbols or a function that returns them) of
    ``streams`` named in ``only`` as a CoderJob, in turn."""
    for name, kind, geom, syms in streams:
        if name not in only:
            continue
        mflag = (_pad2(seq_mflag, Sp, W, dev, torch.uint8)
                 if name == "SEQ" and seq_mflag is not None else None)
        yield _coder_job(name, kind, geom, syms() if callable(syms) else
                         syms, pos, reset, counts_t, mflag)


def seq_qual_jobs(seq_geom, qual_geom, data: np.ndarray,
                  seq_offs: np.ndarray, qual_offs: np.ndarray,
                  lengths: np.ndarray, W: int, seq_map: np.ndarray,
                  qual_bias: int, ll_mat: np.ndarray, counts: np.ndarray,
                  device, seq_mflag: np.ndarray | None = None,
                  only: tuple = ("SEQ", "QUAL")):
    """Lane-pack SEQ and QUAL from raw block bytes on the device, then
    yield each stream's CoderJob in turn (QUAL, the longest chain, then
    SEQ: a caller may launch the first while the second's schedule is
    built). ``data`` is zero-padded to a pack_torch.pad_flat length (the
    pipelined caller pays the pad copy in its host half); some lane has
    symbols. seq_mflag: the [S, W] match-span flags of a format-v5 SEQ
    trial; ``only`` restricts the jobs (a trial re-codes SEQ alone)."""
    if len(data) != pack_torch.pad_flat(len(data)):
        raise ValueError("raw block bytes must be padded to pad_flat")
    S = int(counts.max())
    Sp = pad_steps(S)
    dev = torch.device(device)
    with trace("sfq.encode.pack_pair"):
        seq_syms, qual_syms = pack_torch.pack_pair(
            _to(data, dev), seq_offs, qual_offs, lengths, W, Sp, seq_map,
            qual_bias)
        pos, reset = _pos_reset(_lane_lens(ll_mat, W, dev), Sp, S, W)
        counts_t = _to(counts, dev, torch.int32)
    yield from _jobs((("QUAL", "qual", qual_geom, qual_syms.int),
                      ("SEQ", "seq", seq_geom, seq_syms.int)),
                     pos, reset, counts_t, Sp, W, dev, seq_mflag, only)


def host_jobs(seq_geom, qual_geom, seq_syms: np.ndarray,
              qual_syms: np.ndarray | None, ll_mat: np.ndarray,
              counts: np.ndarray, device,
              seq_mflag: np.ndarray | None = None,
              only: tuple = ("SEQ", "QUAL")):
    """seq_qual_jobs for lanes packed on the host (native.pack_lanes,
    [S, W] u8; qual_syms may be None where only SEQ is coded), the path
    of a block whose raw bytes reach 2 GiB: the symbols cross to the
    device as bytes and stay bytes there; pos/reset are derived on the
    device from the per-lane record-length matrix (the JAX package's
    _build_schedule_ll). Some lane has symbols."""
    counts = np.asarray(counts)
    W = len(counts)
    dev = torch.device(device)
    Sp, pos, reset = _ll_inputs(ll_mat, int(counts.max()), W, dev)
    counts_t = _to(counts, dev, torch.int32)
    yield from _jobs(
        (("QUAL", "qual", qual_geom,
          lambda: _pad2(qual_syms, Sp, W, dev, torch.uint8)),
         ("SEQ", "seq", seq_geom,
          lambda: _pad2(seq_syms, Sp, W, dev, torch.uint8))),
        pos, reset, counts_t, Sp, W, dev, seq_mflag, only)


def seq_qual_groups(gens, only: tuple = ("SEQ", "QUAL"),
                    rename: dict | None = None):
    """SEQ and QUAL of a window's blocks as encode_window groups: QUAL
    over every block, then SEQ (each split by geometry). ``gens``:
    (block, counts [W], its seq_qual_jobs or host_jobs generator over
    ``only``); every block's jobs are made as the group that first needs
    them is built. ``rename`` maps a stream's name to its group's (a
    match trial's SEQ@t)."""
    gens = list(gens)
    for _ in only:
        jobs = [(b, counts, next(gen)) for b, counts, gen in gens]
        if not jobs:
            return
        j0 = jobs[0][2]
        yield from by_geom((rename or {}).get(j0.name, j0.name), j0.kind,
                           [(b, j.geom, j.idx_c, j.bit_c, counts)
                            for b, counts, j in jobs])


def encode_seq_qual_raw(seq_geom, qual_geom, data: np.ndarray,
                        seq_offs: np.ndarray, qual_offs: np.ndarray,
                        lengths: np.ndarray, W: int, seq_map: np.ndarray,
                        qual_bias: int, ll_mat: np.ndarray,
                        counts: np.ndarray, device,
                        seq_mflag: np.ndarray | None = None,
                        only: tuple = ("SEQ", "QUAL")):
    """Encode SEQ and QUAL from raw block bytes (zero-padded to a
    pack_torch.pad_flat length) with on-device lane packing. Returns
    {"SEQ": (payload, lens), "QUAL": (payload, lens)}, restricted to
    ``only``; seq_mflag as in seq_qual_jobs."""
    counts = np.asarray(counts)
    if not (counts > 0).any():
        return {name: _empty_encode(W) for name in only}
    return encode_block(
        ((j.name, j.kind, j.geom, j.idx_c, j.bit_c, counts)
         for j in seq_qual_jobs(seq_geom, qual_geom, data, seq_offs,
                                qual_offs, lengths, W, seq_map, qual_bias,
                                ll_mat, counts, device, seq_mflag, only)),
        device)


def decode_seq_qual_raw(seq_geom, qual_geom,
                        seq_payload: np.ndarray, seq_lens: np.ndarray,
                        qual_payload: np.ndarray, qual_lens: np.ndarray,
                        ll_mat: np.ndarray, counts: np.ndarray, S: int,
                        rec_starts: np.ndarray, lengths: np.ndarray,
                        total: int, seq_map: np.ndarray, qual_bias: int,
                        device, streams: StreamSet | None = None,
                        seq_mflag=None):
    """Decode SEQ and QUAL and unpack them on the device straight to
    record-major flat byte buffers (seq through seq_map, qual + bias).
    Returns (seq_bytes, qual_bytes) of length ``total``. S is the steps,
    counts.max() (the reference's signature). With ``streams``, the two
    decodes join that block's other launches: on return the calling
    stream waits for all of them. seq_mflag: for a format-v5 block whose
    SEQ is e-transformed, a function that returns its [S, W] match-span
    flags, called once QUAL's decode is launched. The one-block case of
    decode_seq_qual_raw_blocks."""
    return decode_seq_qual_raw_blocks(
        [seq_geom], [seq_payload], [seq_lens], [qual_payload], [qual_lens],
        [ll_mat], [counts], [rec_starts], [lengths], [total], [qual_geom],
        [qual_bias], seq_map, device, streams, [seq_mflag])[0]


def decode_seq_qual_raw_blocks(sgeoms, pay_s, lens_s, pay_q, lens_q,
                               ll_list, counts_list, starts_list,
                               lengths_list, totals, qgeoms, minqs,
                               seq_map: np.ndarray, device,
                               streams: StreamSet | None = None,
                               seq_mflags=None, host_unpack=None) -> list:
    """SEQ and QUAL of a window's blocks (per block as
    decode_seq_qual_raw): Kernel D once for QUAL and once for SEQ over
    the blocks, split only where the launch needs one value (the
    geometry; for SEQ also whether the block's match-span flags select
    the match family). seq_mflags: None or per block None or a function
    that returns its flags, called once every QUAL decode is launched.
    host_unpack: None or per block whether its symbols come to the host
    as [S, W] lanes and unpack there (native.unpack_lanes; a block of 2
    GiB and more, whose device unpack would need [S, W] int64 indices).
    Returns per block (seq_bytes, qual_bytes)."""
    dev = torch.device(device)
    ss = streams or StreamSet(device)
    out: list = [None] * len(pay_s)
    live = {}
    for b, counts in enumerate(counts_list):
        counts, total = np.asarray(counts), int(totals[b])
        S = int(counts.max()) if counts.size else 0
        Sp = pad_steps(S)
        if Sp == 0 or not (counts > 0).any() or total == 0:
            out[b] = (np.zeros(total, dtype=np.uint8),
                      np.zeros(total, dtype=np.uint8))
            continue
        W = pay_s[b].shape[0]
        pos, reset = _pos_reset(_lane_lens(ll_list[b], W, dev), Sp, S, W)
        live[b] = (Sp, W, _acts(_to(counts, dev, torch.int32), Sp), pos,
                   reset, S)
    dec = {}
    for name, kind, geoms, pays, lenses in (
            ("QUAL", "qual", qgeoms, pay_q, lens_q),
            ("SEQ", "seq", sgeoms, pay_s, lens_s)):
        groups: dict = {}
        for b, (Sp, W, acts, pos, reset, _) in live.items():
            item = (_payload_tensor(pays[b], dev),
                    _to(lenses[b], dev, torch.int32), acts, pos, reset)
            if name == "SEQ" and seq_mflags and seq_mflags[b] is not None:
                mf = seq_mflags[b]()
                mflag = torch.zeros((Sp, W), dtype=torch.uint8, device=dev)
                mflag[: mf.shape[0]] = _to(mf, dev)
                item += (mflag,)
            groups.setdefault((geoms[b], len(item)), []).append((b, item))
        for (geom, _), members in groups.items():
            items = [item for _, item in members]
            with trace(f"sfq.decode.{name}.coder"):
                syms, _ = ss.launch(lambda: coder_torch.lane_decode_blocks(
                    items, kind, geom), *_tensors(items))
            for (b, _), sy in zip(members, syms):
                dec[b, name] = sy
    ss.join()
    for b, (_, W, *_rest, S) in live.items():
        total = int(totals[b])
        if host_unpack and host_unpack[b]:
            with trace("sfq.decode.unpack_lanes"):
                out[b] = (
                    native.unpack_lanes(dec[b, "SEQ"][:S].cpu().numpy(),
                                        lengths_list[b], W, starts_list[b],
                                        total, map256=seq_map)[:total],
                    native.unpack_lanes(dec[b, "QUAL"][:S].cpu().numpy(),
                                        lengths_list[b], W, starts_list[b],
                                        total, bias=minqs[b])[:total])
            continue
        with trace("sfq.decode.unpack_pair"):
            seq_flat, qual_flat = pack_torch.unpack_pair(
                dec[b, "SEQ"], dec[b, "QUAL"], starts_list[b],
                lengths_list[b], W, total, seq_map, minqs[b])
        out[b] = (seq_flat[:total].cpu().numpy(),
                  qual_flat[:total].cpu().numpy())
    return out


# ---------------------------------------------------------------------------
# the batched multi-block surface (streams_jax.*_blocks)
# ---------------------------------------------------------------------------

def encode_stream_blocks(kind: str, geom, syms_list, counts_list, device,
                         pos_list=None, reset_list=None) -> list:
    """Many blocks' worth of one host-modelled stream: one Kernel E launch
    over the blocks that code a step. Returns per block (payload, lens),
    as encode_stream gives them."""
    entries = []
    for b, syms in enumerate(syms_list):
        sched = stream_schedule(
            kind, geom, syms, counts_list[b], device,
            None if pos_list is None else pos_list[b],
            None if reset_list is None else reset_list[b])
        if sched is not None:
            entries.append((b, geom, *sched, np.asarray(counts_list[b])))
    coded = encode_window(by_geom(kind, kind, entries), device)
    return [coded.get((b, kind)) or _empty_encode(syms.shape[1])
            for b, syms in enumerate(syms_list)]


def encode_seq_qual_raw_blocks(sgeoms, raw_list, counts_list, qgeoms,
                               minqs, seq_map: np.ndarray,
                               device) -> list:
    """SEQ and QUAL of many blocks from their raw bytes: raw_list[b] =
    (raw bytes zero-padded to a pack_torch.pad_flat length, seq offsets,
    qual offsets, lengths) as pipeline_native.prepare_block_fast makes
    them; sgeoms[b] is the block's effective SEQ geometry. One Kernel E
    launch for QUAL and one for SEQ over the blocks that hold bases (more
    where their geometries differ). Returns per block {"SEQ": (payload,
    lens), "QUAL": ...}, as encode_seq_qual_raw gives them."""
    W = len(counts_list[0]) if len(counts_list) else 0
    gens = []
    for b, ((dpad, soffs, qoffs, lengths), counts) in enumerate(
            zip(raw_list, counts_list)):
        counts = np.asarray(counts)
        if (counts > 0).any():
            gens.append((b, counts, seq_qual_jobs(
                sgeoms[b], qgeoms[b], dpad, soffs, qoffs, lengths, W,
                seq_map, minqs[b], _lane_lengths_matrix(lengths, W), counts,
                device)))
    coded = encode_window(seq_qual_groups(gens), device)
    return [{name: coded.get((b, name)) or _empty_encode(W)
             for name in ("SEQ", "QUAL")} for b in range(len(raw_list))]


def decode_stream_blocks(kind: str, geom, payload_list, lens_list,
                         counts_list, steps_list, device, pos_list=None,
                         reset_list=None) -> list:
    """Many blocks of one host-modelled stream: one Kernel D launch over
    the blocks that code a step. Returns per block its [steps, W] u8
    symbols, as decode_stream gives them."""
    ss = StreamSet(device)
    keys = list(range(len(payload_list)))
    ss.decode_blocks(kind, keys, kind, geom, [
        (payload_list[b], lens_list[b], counts_list[b], steps_list[b],
         None if pos_list is None else pos_list[b],
         None if reset_list is None else reset_list[b]) for b in keys])
    return [ss.symbols(b) for b in keys]
