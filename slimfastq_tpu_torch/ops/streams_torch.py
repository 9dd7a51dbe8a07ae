"""Stream drivers of the lane-interleaved codec on PyTorch (port of the JAX
package's ops/streams_jax.py, main-path surface).

Byte-identical to the JAX package and its NumPy oracle. Per stream:

* encode: the stream's symbols (u8), pos/reset and counts -> Kernel E
  (the lockstep coder, ops/coder_torch), which builds every step's
  context row and bits itself, with chunk buffers sized optimistically,
  rerun with the hard worst-case size if any chunk overflowed -> Kernel C
  (compaction, ops/compact_torch), one launch for all of a block's
  streams -> one copy of the compacted bytes to the host -> the lanes'
  flush bytes appended there (native.flush_append).
* decode: the lane counts and pos/reset -> Kernel D.

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
pos/reset and, for a format-v5 SEQ stream, match-span flags (the main
path sends the aux kinds ``byte`` and ``flag``; the pure-Python pipeline
sends every stream, through ``DeviceBackend``);
``encode_seq_qual_raw``/``decode_seq_qual_raw`` carry SEQ and QUAL from
raw block bytes: the lane pack with pos/reset (Kernel L) and the unpack
(Kernel U, ops/pack_torch) happen on the device, so the host ships only
raw bytes, the per-lane record-length matrix and the compressed payloads.
A block of 2 GiB and more packs its lanes on the host instead
(``host_jobs``, and ``decode_seq_qual_raw_blocks(host_unpack=...)``;
``encode_stream_ll`` / ``decode_stream_ll`` are the one-stream forms, as
in streams_jax), with pos/reset from Kernel L's step-input mode. Kernel
E codes each stream in one launch set (ops/encode_torch: slices of
bounded scratch), and ``device_budget`` /
``encode_bytes`` / ``decode_bytes`` bound what a window holds on the
device.

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
from . import coder_torch, compact_torch, encode_torch, pack_torch
from .coder_torch import CHUNK_SYMS, EncIn, _per_read, _qdelta_code
from .pack_torch import _pos_reset
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
# device bytes: the window budget
# ---------------------------------------------------------------------------

# the device-byte budget of a window on the CPU (tests lower it)
CPU_BUDGET = 64 << 30


def encode_bytes(Sp: int, W: int, depths) -> int:
    """Device bytes of a block's SEQ/QUAL encode over Sp steps of W
    lanes, one tree depth a stream in ``depths`` (QUAL, SEQ, then each
    match trial's SEQ): what Kernel E reads, pos and reset (int32) and
    per stream its symbols (u8); a trial's match flags (u8); and per
    stream its chunk buffers and counts at the optimistic size and the
    scratch of its E launch set (encode_torch.scratch_bytes: one slice's,
    at most ~105 MB whatever the stream's length)."""
    NC = Sp // CHUNK_SYMS
    total = (8 + max(len(depths) - 2, 0)) * Sp * W
    for d in depths:
        total += Sp * W + NC * W * (_chunk_bytes(d, hard=False) + 4)
        total += encode_torch.scratch_bytes(1, W, Sp * d, d)
    return total


def decode_bytes(Sp: int, W: int) -> int:
    """Device bytes of a block's SEQ/QUAL decode over Sp steps of W
    lanes: pos and reset (int32), both streams' symbols and the match
    flags (u8)."""
    return 12 * Sp * W


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
    """Device bytes the SEQ/QUAL streams of a window may take, Kernel E's
    scratch included (encode_bytes; a window closes before the block that
    would pass it; a block above it codes alone): half of what the card
    has free, its caching allocator's idle blocks included, over the
    shards that share the card (card_share).
    The other half is headroom: a hard-chunk rerun raises a stream's
    chunk buffers up to 2.5-fold (QUAL at depth 6: 160 against 64 bytes
    a chunk and lane), and Kernel C's and the unpack's outputs come on
    top. On the CPU: CPU_BUDGET, shared as well."""
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
# the schedule in closed form: the plain version of the JAX package's
# _build_schedule (Kernel E builds its rows online, coder_torch.
# online_schedule its plain version; the tests hold the two equal)
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


def _schedule(kind: str, geom, syms, pos, reset, counts, mflag=None):
    """[Sp, W] symbols (int32 or u8), pos/reset (int32) + counts [W] ->
    the encode schedule idx_c, bit_c [NC, 8*depth, W] int32. Inactive
    steps code symbol 0 in the sacrificial context num_ctx. mflag: [Sp, W]
    match-span flags of a format-v5 SEQ trial."""
    Sp, W = syms.shape
    depth = geom.depth
    dev = syms.device
    ctx = _ctx_precompute(kind, geom, syms.int(), pos, reset, mflag)
    steps = torch.arange(Sp, device=dev, dtype=torch.int32)
    active = steps[:, None] < counts[None, :]
    ctx = torch.where(active, ctx, geom.num_ctx)
    sym = torch.where(active, syms.int(), 0)
    base = ctx * ((1 << depth) - 1)
    idx = torch.empty((Sp, depth, W), dtype=torch.int32, device=dev)
    bit = torch.empty_like(idx)
    for j in range(depth):
        idx[:, j] = base + ((1 << j) | (sym >> (depth - j))) - 1
        bit[:, j] = (sym >> (depth - 1 - j)) & 1
    NC = Sp // CHUNK_SYMS
    return (idx.view(NC, CHUNK_SYMS * depth, W),
            bit.view(NC, CHUNK_SYMS * depth, W))


def _to(x: np.ndarray, dev, dtype=None) -> torch.Tensor:
    x = np.ascontiguousarray(x)
    if x.dtype == np.uint32:  # the pure-Python pipeline's symbols, pos,
        x = x.view(np.int32)  # reset and flags: every value below 2^31
    t = torch.from_numpy(x)
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
               reset: np.ndarray | None = None,
               mflag: np.ndarray | None = None) -> None:
        """Launch Kernel D on one host-modelled stream; ``symbols(name)``
        reads it back."""
        self.decode_blocks(name, [name], kind, geom, [
            (payload, lens, counts, num_steps, pos, reset, mflag)])

    def decode_blocks(self, name: str, keys: list, kind: str, geom,
                      items: list) -> None:
        """Launch Kernel D on one host-modelled stream of several blocks,
        each item a block's (payload, lens, counts, num_steps, pos or
        None, reset or None[, mflag or None]): once over the blocks, or
        twice where only some carry the match-span flags of a format-v5
        SEQ stream (a launch takes them for every block or for none);
        ``symbols(key)`` reads a block's back. Its span takes the
        uploads with the launches."""
        with trace(f"sfq.decode.{name}.coder"):
            dev, groups = self.dev, {}
            for key, item in zip(keys, items):
                payload, lens, counts, num_steps, pos, reset = item[:6]
                mflag = item[6] if len(item) > 6 else None
                W = payload.shape[0]
                counts = np.asarray(counts)
                Sp = pad_steps(num_steps)
                if Sp == 0 or not (counts > 0).any():
                    self.decoded[key] = (None, None, num_steps, W)
                    continue
                arg = (_payload_tensor(payload, dev),
                       _to(lens, dev, torch.int32),
                       _to(counts, dev, torch.int32),
                       _pad2(pos, Sp, W, dev), _pad2(reset, Sp, W, dev))
                if mflag is not None:
                    arg += (_pad2(mflag, Sp, W, dev, torch.uint8),)
                groups.setdefault(len(arg), []).append(((key, num_steps, W),
                                                        arg))
            for members in groups.values():
                args = [arg for _, arg in members]
                syms, s = self.launch(
                    lambda: coder_torch.lane_decode_blocks(args, kind, geom),
                    *_tensors(args))
                for ((key, S, W), _), sy in zip(members, syms):
                    self.decoded[key] = (sy, s, S, W)

    def symbols(self, key) -> np.ndarray:
        """[num_steps, W] u8 symbols of a stream launched by ``decode`` or
        ``decode_blocks``, waiting for its stream only."""
        syms, s, S, W = self.decoded[key]
        if syms is None:
            return np.zeros((S, W), dtype=np.uint8)
        with torch.cuda.stream(s) if s is not None else nullcontext():
            return _host_copy(syms[:S])


def _host_copy(t: torch.Tensor) -> np.ndarray:
    """A decode's tensor on the host as a numpy array: one pageable copy
    and the wait for it, each a ``sfq.decode.wait_card`` span (on the CPU
    a span too, so the count of copies is the card's)."""
    with trace("sfq.decode.wait_card", bytes=t.numel() * t.element_size(),
               pinned=0):
        return t.cpu().numpy()


def stream_inputs(kind: str, geom, syms: np.ndarray, counts: np.ndarray,
                  device, pos: np.ndarray | None = None,
                  reset: np.ndarray | None = None,
                  mflag: np.ndarray | None = None) -> EncIn | None:
    """Kernel E's inputs (coder_torch.EncIn) of a host-modelled [S, W]
    stream on the device, or None where it codes no step. pos/reset: host
    [S, W] matrices of a per-read stream (qual, seq); mflag: a format-v5
    SEQ stream's [S, W] match-span flags."""
    S, W = syms.shape
    Sp = pad_steps(S)
    if Sp == 0 or not (np.asarray(counts) > 0).any():
        return None
    dev = torch.device(device)
    per_read = _per_read(kind)
    return EncIn(_pad2(syms, Sp, W, dev, torch.uint8),
                 _pad2(pos, Sp, W, dev) if per_read else None,
                 _pad2(reset, Sp, W, dev) if per_read else None,
                 _to(counts, dev, torch.int32),
                 None if mflag is None
                 else _pad2(mflag, Sp, W, dev, torch.uint8))


def by_geom(name: str, kind: str, entries) -> list:
    """One stream of a window's blocks as encode_window groups: entries
    (block, geom, EncIn, counts) split by geometry (a Kernel E launch
    takes one), in the order the geometries first come."""
    groups: dict = {}
    for b, geom, item, counts in entries:
        groups.setdefault(geom, []).append((b, item, counts))
    return [(name, kind, geom, members) for geom, members in groups.items()]


def _heads(outs) -> list:
    """[(emax, longest lane total)] of Kernel E outputs, one
    synchronisation."""
    return torch.stack([torch.stack([o[3], o[1].sum(dim=0).max()])
                        for o in outs]).cpu().tolist()


def _encode_members(ss: StreamSet | None, members, kind: str, geom,
                    CB: int) -> list:
    """Kernel E over a group's members (block, EncIn, counts): one launch,
    on a stream of ``ss`` (the calling stream without one). Returns each
    member's (ebufs, eptrs, low, emax)."""
    items = [m[1] for m in members]

    def run():
        return coder_torch.lane_encode_blocks(items, kind, geom, CB)
    return run() if ss is None else ss.launch(run, *_tensors(items))[0]


def _slices(members, geom) -> int:
    """The slices of Kernel E's launch set over a group's members (the
    ``slices`` of its coder span)."""
    return encode_torch.set_slices([m[1] for m in members], geom.depth)


def encode_window(groups, device) -> dict:
    """Code a window of blocks' streams at once. ``groups`` yields (name,
    kind, geom, members), members a list of (block, EncIn, counts [W]) of
    the blocks whose stream codes a step (a generator may make each
    group's inputs as it goes; the launches before it run meanwhile).
    Kernel E runs once a group, over its
    blocks, on its own CUDA stream with optimistic chunk buffers; one host
    synchronisation reads every block's overflow check and longest lane;
    the blocks whose chunk overflowed are rerun with hard buffers (the
    others keep their bytes, which do not depend on the buffer size);
    then one Kernel C launch compacts every block's streams, one copy
    brings the payloads, totals and coder tails to the host, and the
    flush bytes are appended there. Returns {(block, name): (payload [W,
    maxlen] u8, lens [W] int64)}."""
    ss = StreamSet(device)
    todo = []
    groups = iter(groups)
    while True:
        with trace("sfq.encode.inputs"):
            group = next(groups, None)
        if group is None:
            break
        name, kind, geom, members = group
        CB = _chunk_bytes(geom.depth, hard=False)
        with trace(f"sfq.encode.{name}.coder") as sp:
            sp.set(slices=_slices(members, geom))
            outs = _encode_members(ss, members, kind, geom, CB)
        todo.append((name, kind, geom, members, outs))
    if not todo:
        return {}
    every = [o for *_, outs in todo for o in outs]
    with trace("sfq.encode.wait_card", bytes=16 * len(every)):
        ss.join()
        heads = iter(_heads(every))
    streams, tails, keys = [], [], []
    for name, kind, geom, members, outs in todo:
        head = [next(heads) for _ in outs]
        CB = _chunk_bytes(geom.depth, hard=False)
        over = [i for i, (emax, _) in enumerate(head) if emax > CB]
        if over:  # rare: rerun with the worst-case chunk size
            CB = _chunk_bytes(geom.depth, hard=True)
            for i in over:
                outs[i] = None  # the optimistic buffers go first
            with trace(f"sfq.encode.{name}.coder") as sp:
                again = [members[i] for i in over]
                sp.set(slices=_slices(again, geom))
                redo = _encode_members(None, again, kind, geom, CB)
            with trace("sfq.encode.wait_card", bytes=16 * len(redo)):
                redo_heads = _heads(redo)
            for i, o, h in zip(over, redo, redo_heads):
                if h[0] > CB:
                    raise AssertionError("encode chunk overflow even with "
                                         "hard buffers")
                outs[i], head[i] = o, h
        for (b, _, counts), o, (_, tmax) in zip(members, outs, head):
            streams.append((o[0], o[1], max(tmax, 1)))
            tails.append(o[2])
            keys.append((b, name, counts))
    with trace("sfq.encode.compact"):
        flat, layout = compact_torch.compact_streams_dev(streams, tails)
        host = _to_host(flat)
    with trace("sfq.encode.assemble"):
        return {(b, name): _flush_append(pay.numpy(), tot.numpy(),
                                         low.numpy().view(np.uint32),
                                         np.asarray(counts))
                for (b, name, counts), (pay, tot, low) in zip(
                    keys, layout.views(host))}


def encode_block(jobs, device) -> dict:
    """Code a block's streams at once: encode_window's one-block case.
    ``jobs`` yields (name, kind, geom, EncIn, counts) in turn. Returns
    {name: (payload [W, maxlen] u8, lens [W] int64)}."""
    coded = encode_window(
        ((name, kind, geom, [(0, item, counts)])
         for name, kind, geom, item, counts in jobs), device)
    return {name: v for (_, name), v in coded.items()}


def _to_host(flat: torch.Tensor) -> torch.Tensor:
    """A CUDA tensor's bytes on the host: one copy into pinned memory on
    the calling stream, one synchronisation. The buffer is the caller's
    alone (_flush_append copies out of it)."""
    if flat.device.type == "cpu":
        return flat
    with trace("sfq.encode.wait_card",
               bytes=flat.numel() * flat.element_size()):
        host = torch.empty(flat.shape, dtype=flat.dtype, pin_memory=True)
        host.copy_(flat, non_blocking=True)
        torch.cuda.current_stream(flat.device).synchronize()
    return host


def _empty_encode(W: int):
    return np.zeros((W, 0), dtype=np.uint8), np.zeros(W, dtype=np.int64)


def encode_stream(kind: str, geom, syms: np.ndarray, counts: np.ndarray,
                  device, pos: np.ndarray | None = None,
                  reset: np.ndarray | None = None,
                  mflag: np.ndarray | None = None):
    """[S, W] symbols + per-lane counts -> (payload [W, maxlen] u8, lens
    [W] int64): Kernels E and C, one launch each. pos/reset: host [S, W]
    matrices for qual/seq; mflag: a format-v5 SEQ stream's [S, W]
    match-span flags."""
    counts = np.asarray(counts)
    item = stream_inputs(kind, geom, syms, counts, device, pos, reset, mflag)
    if item is None:
        return _empty_encode(syms.shape[1])
    return encode_block([(kind, kind, geom, item, counts)], device)[kind]


def _payload_tensor(payload: np.ndarray, dev) -> torch.Tensor:
    """Payload [W, L] u8 on the device, at least one column (bytes past a
    lane's length are never read)."""
    if payload.shape[1] == 0:
        payload = np.zeros((payload.shape[0], 1), dtype=np.uint8)
    return _to(payload, dev, torch.uint8)


def decode_stream(kind: str, geom, payload: np.ndarray, lens: np.ndarray,
                  counts: np.ndarray, num_steps: int, device,
                  pos: np.ndarray | None = None,
                  reset: np.ndarray | None = None,
                  mflag: np.ndarray | None = None) -> np.ndarray:
    """(payload, lens) -> [num_steps, W] u8 symbols (0 past each count):
    one Kernel D launch. mflag: a format-v5 SEQ stream's [S, W]
    match-span flags."""
    ss = StreamSet(device)
    ss.decode(kind, kind, geom, payload, lens, counts, num_steps, pos, reset,
              mflag)
    return ss.symbols(kind)


def _ll_inputs(lane_len_mat: np.ndarray, S: int, W: int, dev):
    """(Sp, pos, reset [Sp, W] int32) of a per-read stream from its
    per-lane record-length matrix, derived on the device (Kernel L's
    step-input mode)."""
    Sp = pad_steps(S)
    return (Sp, *pack_torch.step_inputs(lane_len_mat, Sp, S, W, dev))


def encode_stream_ll(kind: str, geom, syms: np.ndarray,
                     lane_len_mat: np.ndarray, counts: np.ndarray, device,
                     mflag: np.ndarray | None = None):
    """encode_stream for a per-read stream (qual/seq): pos/reset are
    derived on the device from the per-lane record-length matrix, so the
    host ships only the [S, W] symbols (as bytes) and that matrix.
    mflag: a format-v5 SEQ trial's [S, W] match-span flags. Returns
    (payload [W, maxlen] u8, lens [W] int64)."""
    S, W = syms.shape
    counts = np.asarray(counts)
    if pad_steps(S) == 0 or not (counts > 0).any():
        return _empty_encode(W)
    dev = torch.device(device)
    Sp, pos, reset = _ll_inputs(lane_len_mat, S, W, dev)
    item = EncIn(_pad2(syms, Sp, W, dev, torch.uint8), pos, reset,
                 _to(counts, dev, torch.int32),
                 None if mflag is None
                 else _pad2(mflag, Sp, W, dev, torch.uint8))
    return encode_block([(kind, kind, geom, item, counts)], device)[kind]


def decode_stream_ll(kind: str, geom, payload: np.ndarray, lens: np.ndarray,
                     lane_len_mat: np.ndarray, counts: np.ndarray,
                     num_steps: int, device,
                     mflag: np.ndarray | None = None) -> np.ndarray:
    """decode_stream with pos/reset derived on the device from the
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
            _to(counts, dev, torch.int32), pos, reset)
    if mflag is not None:
        item += (_pad2(mflag, Sp, W, dev, torch.uint8),)
    with trace(f"sfq.decode.{kind}.coder"):
        syms, = coder_torch.lane_decode_blocks([item], kind, geom)
    return _host_copy(syms[:S])


# ---------------------------------------------------------------------------
# device-raw SEQ + QUAL
# ---------------------------------------------------------------------------

def _lane_lens(ll_mat: np.ndarray, W: int, dev) -> torch.Tensor:
    """The per-lane record-length matrix on the device (int64, at least
    one row), as _pos_reset takes it."""
    return _to(pack_torch._lane_lens(ll_mat, W), dev)


class CoderJob(NamedTuple):
    """One SEQ/QUAL stream's Kernel E inputs on the device (an EncIn:
    lane symbols [Sp, W] u8, pos and reset [Sp, W] int32, counts [W]
    int32 and a trial's match flags)."""
    name: str
    kind: str
    geom: object
    item: EncIn

    @property
    def syms(self) -> torch.Tensor:
        return self.item.syms

    @property
    def pos(self) -> torch.Tensor:
        return self.item.pos

    @property
    def reset(self) -> torch.Tensor:
        return self.item.reset

    @property
    def counts(self) -> torch.Tensor:
        return self.item.counts


def _jobs(streams, pos, reset, counts_t, Sp: int, W: int, dev, seq_mflag,
          only: tuple):
    """Each (name, kind, geom, symbols or a function that returns them) of
    ``streams`` named in ``only`` as a CoderJob, in turn."""
    for name, kind, geom, syms in streams:
        if name not in only:
            continue
        mflag = (_pad2(seq_mflag, Sp, W, dev, torch.uint8)
                 if name == "SEQ" and seq_mflag is not None else None)
        yield CoderJob(name, kind, geom, EncIn(
            syms() if callable(syms) else syms, pos, reset, counts_t, mflag))


def seq_qual_jobs(seq_geom, qual_geom, data: np.ndarray,
                  seq_offs: np.ndarray, qual_offs: np.ndarray,
                  lengths: np.ndarray, W: int, seq_map: np.ndarray,
                  qual_bias: int, ll_mat: np.ndarray, counts: np.ndarray,
                  device, seq_mflag: np.ndarray | None = None,
                  only: tuple = ("SEQ", "QUAL")):
    """Lane-pack SEQ and QUAL from raw block bytes on the device with
    their pos and reset (Kernel L, one launch), then yield each stream's
    CoderJob in turn (QUAL, the longest chain, then SEQ). ``data`` is
    zero-padded to a pack_torch.pad_flat length (the pipelined caller
    pays the pad copy in its host half; where it wrote them into a
    page-locked buffer of pack_torch.pinned_empty, they go up in one
    asynchronous copy on the stream Kernel L launches on); some lane has
    symbols.
    seq_mflag: the [S, W] match-span flags of a format-v5 SEQ trial;
    ``only`` restricts the jobs (a trial re-codes SEQ alone)."""
    if len(data) != pack_torch.pad_flat(len(data)):
        raise ValueError("raw block bytes must be padded to pad_flat")
    S = int(counts.max())
    Sp = pad_steps(S)
    dev = torch.device(device)
    with trace("sfq.encode.lane_layout"):
        seq_syms, qual_syms, pos, reset = pack_torch.lane_layout(
            pack_torch.upload(data, dev), seq_offs, qual_offs,
            lengths, ll_mat, W, Sp, S, seq_map, qual_bias)
        counts_t = _to(counts, dev, torch.int32)
    yield from _jobs((("QUAL", "qual", qual_geom, qual_syms),
                      ("SEQ", "seq", seq_geom, seq_syms)),
                     pos, reset, counts_t, Sp, W, dev, seq_mflag, only)


def host_jobs(seq_geom, qual_geom, seq_syms: np.ndarray,
              qual_syms: np.ndarray | None, ll_mat: np.ndarray,
              counts: np.ndarray, device,
              seq_mflag: np.ndarray | None = None,
              only: tuple = ("SEQ", "QUAL")):
    """seq_qual_jobs for lanes packed on the host (native.pack_lanes,
    [S, W] u8; qual_syms may be None where only SEQ is coded), the path
    of a block whose raw bytes reach 2 GiB: the symbols cross to the
    device as bytes; pos/reset are derived on the device from the
    per-lane record-length matrix (Kernel L's step-input mode, the JAX
    package's _build_schedule_ll). Some lane has symbols."""
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
                           [(b, j.geom, j.item, counts)
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
        ((j.name, j.kind, j.geom, j.item, counts)
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
        with trace("sfq.decode.lane_layout"):
            pos, reset = pack_torch.step_inputs(ll_list[b], Sp, S, W, dev)
            live[b] = (Sp, W, _to(counts, dev, torch.int32), pos, reset, S)
    dec = {}
    for name, kind, geoms, pays, lenses in (
            ("QUAL", "qual", qgeoms, pay_q, lens_q),
            ("SEQ", "seq", sgeoms, pay_s, lens_s)):
        with trace(f"sfq.decode.{name}.coder"):  # uploads and launches
            groups: dict = {}
            for b, (Sp, W, counts_t, pos, reset, _) in live.items():
                item = (_payload_tensor(pays[b], dev),
                        _to(lenses[b], dev, torch.int32), counts_t, pos,
                        reset)
                if name == "SEQ" and seq_mflags and \
                        seq_mflags[b] is not None:
                    mf = seq_mflags[b]()
                    mflag = torch.zeros((Sp, W), dtype=torch.uint8,
                                        device=dev)
                    mflag[: mf.shape[0]] = _to(mf, dev)
                    item += (mflag,)
                groups.setdefault((geoms[b], len(item)), []).append(
                    (b, item))
            for (geom, _), members in groups.items():
                items = [item for _, item in members]
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
                    native.unpack_lanes(_host_copy(dec[b, "SEQ"][:S]),
                                        lengths_list[b], W, starts_list[b],
                                        total, map256=seq_map)[:total],
                    native.unpack_lanes(_host_copy(dec[b, "QUAL"][:S]),
                                        lengths_list[b], W, starts_list[b],
                                        total, bias=minqs[b])[:total])
            continue
        with trace("sfq.decode.unpack_pair"):
            seq_flat, qual_flat = pack_torch.unpack_pair(
                dec[b, "SEQ"], dec[b, "QUAL"], starts_list[b],
                lengths_list[b], W, total, seq_map, minqs[b])
        out[b] = (_host_copy(seq_flat[:total]),
                  _host_copy(qual_flat[:total]))
    return out


# ---------------------------------------------------------------------------
# the batched multi-block surface (streams_jax.*_blocks)
# ---------------------------------------------------------------------------

def _nth(xs, b):
    return None if xs is None else xs[b]


def encode_stream_blocks(kind: str, geom, syms_list, counts_list, device,
                         pos_list=None, reset_list=None,
                         mflag_list=None) -> list:
    """Many blocks' worth of one host-modelled stream: one Kernel E launch
    over the blocks that code a step (mflag_list: per block a format-v5
    SEQ stream's match-span flags or None), one Kernel C launch. Returns
    per block (payload, lens), as encode_stream gives them."""
    entries = []
    for b, syms in enumerate(syms_list):
        item = stream_inputs(kind, geom, syms, counts_list[b], device,
                             _nth(pos_list, b), _nth(reset_list, b),
                             _nth(mflag_list, b))
        if item is not None:
            entries.append((b, geom, item, np.asarray(counts_list[b])))
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
                         reset_list=None, mflag_list=None) -> list:
    """Many blocks of one host-modelled stream: one Kernel D launch over
    the blocks that code a step (two where only some carry match-span
    flags in mflag_list). Returns per block its [steps, W] u8 symbols, as
    decode_stream gives them."""
    ss = StreamSet(device)
    keys = list(range(len(payload_list)))
    ss.decode_blocks(kind, keys, kind, geom, [
        (payload_list[b], lens_list[b], counts_list[b], steps_list[b],
         _nth(pos_list, b), _nth(reset_list, b), _nth(mflag_list, b))
        for b in keys])
    return [ss.symbols(b) for b in keys]


class DeviceBackend:
    """A device bound to the per-stream surface with the NumPy oracle's
    signature (ops/streams_np: no ``device`` argument), the backend of the
    pure-Python pipeline (pipeline.encode_block / decode_block): each
    stream's Kernels E and C (encode) or D (decode) run on ``device``, one
    stream at a time; the ``*_blocks`` forms take many blocks of one
    stream in one launch."""

    def __init__(self, device):
        self.device = torch.device(device)

    def encode_stream(self, kind: str, geom, syms, counts, pos=None,
                      reset=None, mflag=None):
        return encode_stream(kind, geom, syms, counts, self.device, pos,
                             reset, mflag)

    def decode_stream(self, kind: str, geom, payload, lens, counts,
                      num_steps: int, pos=None, reset=None, mflag=None):
        return decode_stream(kind, geom, payload, lens, counts, num_steps,
                             self.device, pos, reset, mflag)

    def encode_stream_blocks(self, kind: str, geom, syms_list, counts_list,
                             pos_list=None, reset_list=None,
                             mflag_list=None) -> list:
        return encode_stream_blocks(kind, geom, syms_list, counts_list,
                                    self.device, pos_list, reset_list,
                                    mflag_list)

    def decode_stream_blocks(self, kind: str, geom, payload_list, lens_list,
                             counts_list, steps_list, pos_list=None,
                             reset_list=None, mflag_list=None) -> list:
        return decode_stream_blocks(kind, geom, payload_list, lens_list,
                                    counts_list, steps_list, self.device,
                                    pos_list, reset_list, mflag_list)
