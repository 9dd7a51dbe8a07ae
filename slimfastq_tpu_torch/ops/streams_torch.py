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

A block's streams are coded at once: ``encode_block`` launches Kernel E
of every stream on its own CUDA stream (``StreamSet``) and reads all the
overflow checks back in one synchronisation; ``StreamSet.decode`` does the
same for Kernel D, each stream's symbols read back when its caller needs
them.

``encode_stream``/``decode_stream`` serve any kind with host-supplied
pos/reset (the main path sends the aux kinds ``byte`` and ``flag``);
``encode_seq_qual_raw``/``decode_seq_qual_raw`` carry SEQ and QUAL from
raw block bytes: the lane pack/unpack (ops/pack_torch) and pos/reset
derivation happen on the device, so the host ships only raw bytes, the
per-lane record-length matrix and the compressed payloads.

Every entry takes an explicit ``device``; the CPU runs the kernels' plain
versions.
"""

from __future__ import annotations

from contextlib import nullcontext
from typing import NamedTuple

import numpy as np
import torch

from .. import native
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


def _schedule(kind: str, geom, syms, pos, reset, counts, mflag=None):
    """[Sp, W] symbols/pos/reset (int32) + counts [W] -> the encode
    schedule idx_c, bit_c [NC, 8*depth, W] int32. Inactive steps code
    symbol 0 in the sacrificial context num_ctx. mflag: [Sp, W] match-span
    flags of a format-v5 SEQ trial."""
    Sp, W = syms.shape
    depth = geom.depth
    steps = torch.arange(Sp, device=syms.device, dtype=torch.int32)
    active = steps[:, None] < counts[None, :]
    ctx = torch.where(active, _ctx_precompute(kind, geom, syms, pos, reset,
                                              mflag), geom.num_ctx)
    sym = torch.where(active, syms, 0)
    base = ctx * ((1 << depth) - 1)
    idx = torch.stack([base + ((1 << j) | (sym >> (depth - j))) - 1
                       for j in range(depth)], dim=1)
    bit = torch.stack([(sym >> (depth - 1 - j)) & 1 for j in range(depth)],
                      dim=1)
    NC = Sp // CHUNK_SYMS
    return (idx.reshape(NC, CHUNK_SYMS * depth, W).int(),
            bit.reshape(NC, CHUNK_SYMS * depth, W).int())


def _pos_reset(lane_lens: torch.Tensor, Sp: int, S: int, W: int):
    """pos/reset [Sp, W] int32 from the per-lane record-length matrix
    [Rpl, W] (int64): a boundary scatter plus a running max of the last
    read start."""
    dev = lane_lens.device
    starts = torch.zeros_like(lane_lens)
    if lane_lens.shape[0] > 1:
        starts[1:] = torch.cumsum(lane_lens[:-1], dim=0)
    lanes = torch.arange(W, device=dev)
    valid = (lane_lens > 0) & (starts < S)
    flat = torch.where(valid, starts * W + lanes, Sp * W).reshape(-1)
    reset = torch.zeros(Sp * W + 1, dtype=torch.int32, device=dev)
    reset[flat] = 1
    reset = reset[:-1].reshape(Sp, W)
    t_idx = torch.arange(Sp, dtype=torch.int32, device=dev)[:, None]
    marks = torch.where(reset == 1, t_idx, -1)
    last = torch.cummax(marks, dim=0).values
    return (t_idx - last.clamp(min=0)).int(), reset


def _to(x: np.ndarray, dev, dtype=None) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(x))
    return t.to(device=dev, dtype=dtype or t.dtype)


def _pad2(x, Sp: int, W: int, dev) -> torch.Tensor:
    out = torch.zeros((Sp, W), dtype=torch.int32, device=dev)
    if x is not None and x.shape[0]:
        out[: x.shape[0]] = _to(x, dev, torch.int32)
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

_POOL: dict[int, list] = {}  # device index -> side CUDA streams


class StreamSet:
    """A block's coder launches, each on its own CUDA stream from a
    per-device pool, so the block costs its longest chain and not the sum
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
        pool = _POOL.setdefault(self.main.device_index, [])
        if len(pool) == len(self.used):
            pool.append(torch.cuda.Stream(self.dev))
        self.used.append(pool[len(self.used)])
        return self.used[-1]

    def launch(self, fn, *inputs, after=None):
        """fn() on the next stream of the pool, or behind the work of
        ``after``, a stream an earlier launch returned; returns its output
        (a tensor or a tuple of them) and the stream."""
        s = after or self._next()
        if s is None:
            return fn(), None
        s.wait_stream(self.main)
        with torch.cuda.stream(s):
            out = fn()
        for t in inputs:
            t.record_stream(s)
        self.outputs.extend(out if isinstance(out, tuple) else (out,))
        return out, s

    def join(self) -> None:
        """The calling stream waits for every launch so far; their outputs
        are marked in use by it."""
        if self.main is None:
            return
        for s in self.used:
            self.main.wait_stream(s)
        for t in self.outputs:
            t.record_stream(self.main)

    def decode(self, name: str, kind: str, geom, payload: np.ndarray,
               lens: np.ndarray, counts: np.ndarray, num_steps: int,
               pos: np.ndarray | None = None,
               reset: np.ndarray | None = None) -> None:
        """Launch Kernel D on one host-modelled stream; ``symbols(name)``
        reads it back."""
        W = payload.shape[0]
        counts = np.asarray(counts)
        Sp = pad_steps(num_steps)
        if Sp == 0 or not (counts > 0).any():
            self.decoded[name] = (None, None, num_steps, W)
            return
        dev = self.dev
        args = (_payload_tensor(payload, dev), _to(lens, dev, torch.int32),
                _acts(_to(counts, dev, torch.int32), Sp),
                _pad2(pos, Sp, W, dev), _pad2(reset, Sp, W, dev))
        with trace(f"sfq.decode.{name}.coder"):
            syms, s = self.launch(lambda: coder_torch.lane_decode(
                *args, kind, geom), *args)
        self.decoded[name] = (syms, s, num_steps, W)

    def symbols(self, name: str) -> np.ndarray:
        """[num_steps, W] u8 symbols of a stream launched by ``decode``,
        waiting for its stream only."""
        syms, s, S, W = self.decoded[name]
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


def encode_block(jobs, device) -> dict:
    """Code a block's streams at once. ``jobs`` yields (name, kind, geom,
    idx_c, bit_c, counts) in turn (a generator may build each schedule as
    it goes; the launches before it run meanwhile). Kernel E of each runs
    on its own CUDA stream with optimistic chunk buffers; one host
    synchronisation reads every overflow check and compacted size; a
    stream whose chunk overflowed is rerun with hard buffers; then one
    Kernel C launch compacts every stream, one copy brings the payloads,
    totals and coder tails to the host, and the flush bytes are appended
    there. Returns {name: (payload [W, maxlen] u8, lens [W] int64)}."""
    ss = StreamSet(device)
    todo, outs = [], []
    for name, kind, geom, idx_c, bit_c, counts in jobs:
        CB = _chunk_bytes(geom.depth, hard=False)
        with trace(f"sfq.encode.{name}.coder"):
            out, _ = ss.launch(lambda: coder_torch.lane_encode(
                idx_c, bit_c, geom, CB), idx_c, bit_c)
        todo.append((name, geom, idx_c, bit_c, counts, CB))
        outs.append(out)
    if not todo:
        return {}
    ss.join()
    # one synchronisation: each stream's emax and longest lane total
    head = torch.stack([torch.stack([out[3], out[1].sum(dim=0).max()])
                        for out in outs]).cpu().tolist()
    streams = []
    for k, ((name, geom, idx_c, bit_c, _, CB), (emax, tmax)) in enumerate(
            zip(todo, head)):
        if emax > CB:  # rare: rerun with the worst-case chunk size
            CB = _chunk_bytes(geom.depth, hard=True)
            with trace(f"sfq.encode.{name}.coder"):
                outs[k] = coder_torch.lane_encode(idx_c, bit_c, geom, CB)
            if int(outs[k][3]) > CB:
                raise AssertionError("encode chunk overflow even with hard "
                                     "buffers")
            tmax = int(outs[k][1].sum(dim=0).max())
        streams.append((outs[k][0], outs[k][1], max(tmax, 1)))
    with trace("sfq.encode.compact"):
        flat, layout = compact_torch.compact_streams_dev(
            streams, [out[2] for out in outs])
        host = _to_host(flat)
    return {job[0]: _flush_append(pay.numpy(), tot.numpy(),
                                  low.numpy().view(np.uint32),
                                  np.asarray(job[4]))
            for job, (pay, tot, low) in zip(todo, layout.views(host))}


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


# ---------------------------------------------------------------------------
# device-raw SEQ + QUAL
# ---------------------------------------------------------------------------

def _lane_lens(ll_mat: np.ndarray, W: int, dev) -> torch.Tensor:
    Rpl = max(ll_mat.shape[0], 1)
    ll = np.zeros((Rpl, W), dtype=np.int64)
    ll[: ll_mat.shape[0]] = ll_mat
    return _to(ll, dev)


class CoderJob(NamedTuple):
    """One device-raw stream's coder inputs on the device: lane symbols,
    pos and reset [Sp, W] int32, counts [W] int32 and the encode
    schedule idx_c, bit_c [NC, 8*depth, W] int32."""
    name: str
    kind: str
    geom: object
    syms: torch.Tensor
    pos: torch.Tensor
    reset: torch.Tensor
    counts: torch.Tensor
    idx_c: torch.Tensor
    bit_c: torch.Tensor


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
    for name, kind, geom, syms in (("QUAL", "qual", qual_geom, qual_syms),
                                   ("SEQ", "seq", seq_geom, seq_syms)):
        if name not in only:
            continue
        syms = syms.int()
        mflag = (_pad2(seq_mflag, Sp, W, dev)
                 if name == "SEQ" and seq_mflag is not None else None)
        with trace(f"sfq.encode.{kind}.schedule"):
            idx_c, bit_c = _schedule(kind, geom, syms, pos, reset, counts_t,
                                     mflag)
        yield CoderJob(name, kind, geom, syms, pos, reset, counts_t, idx_c,
                       bit_c)
        del syms, mflag, idx_c, bit_c


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
    Returns (seq_bytes, qual_bytes) of length ``total``. With
    ``streams``, the two decodes join that block's other launches: on
    return the calling stream waits for all of them. seq_mflag: for a
    format-v5 block whose SEQ is e-transformed, a function that returns
    its [S, W] match-span flags, called once QUAL's decode is launched."""
    W = seq_payload.shape[0]
    counts = np.asarray(counts)
    Sp = pad_steps(S)
    ss = streams or StreamSet(device)
    if Sp == 0 or not (counts > 0).any() or total == 0:
        return (np.zeros(total, dtype=np.uint8),
                np.zeros(total, dtype=np.uint8))
    dev = torch.device(device)
    pos, reset = _pos_reset(_lane_lens(ll_mat, W, dev), Sp, S, W)
    acts = _acts(_to(counts, dev, torch.int32), Sp)
    dec = {}
    for name, kind, geom, payload, lens in (
            ("QUAL", "qual", qual_geom, qual_payload, qual_lens),
            ("SEQ", "seq", seq_geom, seq_payload, seq_lens)):
        args = (_payload_tensor(payload, dev), _to(lens, dev, torch.int32),
                acts, pos, reset)
        mflag = None
        if name == "SEQ" and seq_mflag is not None:
            mf = seq_mflag()
            mflag = torch.zeros((Sp, W), dtype=torch.uint8, device=dev)
            mflag[: mf.shape[0]] = _to(mf, dev)
            args += (mflag,)
        with trace(f"sfq.decode.{name}.coder"):
            dec[name], _ = ss.launch(lambda: coder_torch.lane_decode(
                *args[:5], kind, geom, mflag=mflag), *args)
    ss.join()
    with trace("sfq.decode.unpack_pair"):
        seq_flat, qual_flat = pack_torch.unpack_pair(
            dec["SEQ"], dec["QUAL"], rec_starts, lengths, W, total, seq_map,
            qual_bias)
    return (seq_flat[:total].cpu().numpy(), qual_flat[:total].cpu().numpy())
