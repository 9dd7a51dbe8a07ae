"""Stream drivers of the lane-interleaved codec on PyTorch (port of the JAX
package's ops/streams_jax.py, main-path surface).

Byte-identical to the JAX package and its NumPy oracle. Per stream:

* encode: the whole-array schedule (contexts in closed form from shifted
  symbol arrays, then every bit-step's table index and bit) -> Kernel E
  (the lockstep coder, ops/coder_torch) with chunk buffers sized
  optimistically, rerun with the hard worst-case size if any chunk
  overflowed -> Kernel C (compaction, ops/compact_torch) -> the lanes'
  flush bytes appended on the host (native.flush_append).
* decode: acts/pos/reset derived as whole-array ops -> Kernel D.

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
    (~1 byte/bit-step + slack) is almost never exceeded — _code
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


def _ctx_precompute(kind: str, geom, syms, pos, reset):
    """Closed-form [Sp, W] int32 context streams for the encode path; equal
    to the decoder's carried-state contexts at every active step."""
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
        return h + ((1 << (2 * j)) - 1) // 3
    if kind == "byte":
        return _shift_t(syms, 1) if geom.order else torch.zeros_like(syms)
    if kind == "flag":
        hb = geom.hist_bits
        h = torch.zeros_like(syms)
        for j in range(1, hb + 1):
            h = h | (_shift_t(syms, j) << (j - 1))
        return h & ((1 << hb) - 1)
    raise ValueError(kind)


def _schedule(kind: str, geom, syms, pos, reset, counts):
    """[Sp, W] symbols/pos/reset (int32) + counts [W] -> the encode
    schedule idx_c, bit_c [NC, 8*depth, W] int32. Inactive steps code
    symbol 0 in the sacrificial context num_ctx."""
    Sp, W = syms.shape
    depth = geom.depth
    steps = torch.arange(Sp, device=syms.device, dtype=torch.int32)
    active = steps[:, None] < counts[None, :]
    ctx = torch.where(active, _ctx_precompute(kind, geom, syms, pos, reset),
                      geom.num_ctx)
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


def _encode_chunks(kind: str, geom, idx_c, bit_c):
    """Schedule -> Kernel E's (ebufs, eptrs, low) on the device, with chunk
    buffers sized optimistically and rerun at the hard size if any chunk
    overflowed."""
    for hard in (False, True):
        CB = _chunk_bytes(geom.depth, hard)
        with trace(f"sfq.encode.{kind}.coder"):
            ebufs, eptrs, low, emax = coder_torch.lane_encode(idx_c, bit_c,
                                                              geom, CB)
        if int(emax) <= CB:
            return ebufs, eptrs, low
    raise AssertionError("encode chunk overflow even with hard buffers")


def _code(kind: str, geom, idx_c, bit_c, counts: np.ndarray):
    """Schedule -> (payload [W, maxlen] u8, lens [W] int64) on the host."""
    ebufs, eptrs, low = _encode_chunks(kind, geom, idx_c, bit_c)
    totals = eptrs.sum(dim=0).cpu().numpy()
    with trace(f"sfq.encode.{kind}.compact"):
        pay, _ = compact_torch.compact_lanes_dev(ebufs, eptrs,
                                                 max(int(totals.max()), 1))
    return _flush_append(pay.cpu().numpy(), totals,
                         low.cpu().numpy().view(np.uint32), counts)


def _empty_encode(W: int):
    return np.zeros((W, 0), dtype=np.uint8), np.zeros(W, dtype=np.int64)


def encode_stream(kind: str, geom, syms: np.ndarray, counts: np.ndarray,
                  device, pos: np.ndarray | None = None,
                  reset: np.ndarray | None = None):
    """[S, W] symbols + per-lane counts -> (payload [W, maxlen] u8, lens
    [W] int64). pos/reset: host [S, W] matrices for qual/seq."""
    S, W = syms.shape
    counts = np.asarray(counts)
    Sp = pad_steps(S)
    if Sp == 0 or not (counts > 0).any():
        return _empty_encode(W)
    dev = torch.device(device)
    with trace(f"sfq.encode.{kind}.schedule"):
        idx_c, bit_c = _schedule(kind, geom, _pad2(syms, Sp, W, dev),
                                 _pad2(pos, Sp, W, dev),
                                 _pad2(reset, Sp, W, dev),
                                 _to(counts, dev, torch.int32))
    return _code(kind, geom, idx_c, bit_c, counts)


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
    W = payload.shape[0]
    counts = np.asarray(counts)
    S = num_steps
    Sp = pad_steps(S)
    if Sp == 0 or not (counts > 0).any():
        return np.zeros((S, W), dtype=np.uint8)
    dev = torch.device(device)
    with trace(f"sfq.decode.{kind}.coder"):
        syms = coder_torch.lane_decode(
            _payload_tensor(payload, dev), _to(lens, dev, torch.int32),
            _acts(_to(counts, dev, torch.int32), Sp),
            _pad2(pos, Sp, W, dev), _pad2(reset, Sp, W, dev), kind, geom)
    return syms[:S].cpu().numpy()


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
                  device):
    """Lane-pack SEQ and QUAL from raw block bytes on the device, then
    yield each stream's CoderJob in turn (SEQ, then QUAL). ``data`` is
    zero-padded to a pack_torch.pad_flat length (the pipelined caller
    pays the pad copy in its host half); some lane has symbols."""
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
    for name, kind, geom, syms in (("SEQ", "seq", seq_geom, seq_syms),
                                   ("QUAL", "qual", qual_geom, qual_syms)):
        syms = syms.int()
        with trace(f"sfq.encode.{kind}.schedule"):
            idx_c, bit_c = _schedule(kind, geom, syms, pos, reset, counts_t)
        yield CoderJob(name, kind, geom, syms, pos, reset, counts_t, idx_c,
                       bit_c)
        del syms, idx_c, bit_c


def encode_seq_qual_raw(seq_geom, qual_geom, data: np.ndarray,
                        seq_offs: np.ndarray, qual_offs: np.ndarray,
                        lengths: np.ndarray, W: int, seq_map: np.ndarray,
                        qual_bias: int, ll_mat: np.ndarray,
                        counts: np.ndarray, device):
    """Encode SEQ and QUAL from raw block bytes (zero-padded to a
    pack_torch.pad_flat length) with on-device lane packing. Returns
    {"SEQ": (payload, lens), "QUAL": (payload, lens)}."""
    counts = np.asarray(counts)
    if not (counts > 0).any():
        return {"SEQ": _empty_encode(W), "QUAL": _empty_encode(W)}
    return {job.name: _code(job.kind, job.geom, job.idx_c, job.bit_c, counts)
            for job in seq_qual_jobs(seq_geom, qual_geom, data, seq_offs,
                                     qual_offs, lengths, W, seq_map,
                                     qual_bias, ll_mat, counts, device)}


def decode_seq_qual_raw(seq_geom, qual_geom,
                        seq_payload: np.ndarray, seq_lens: np.ndarray,
                        qual_payload: np.ndarray, qual_lens: np.ndarray,
                        ll_mat: np.ndarray, counts: np.ndarray, S: int,
                        rec_starts: np.ndarray, lengths: np.ndarray,
                        total: int, seq_map: np.ndarray, qual_bias: int,
                        device):
    """Decode SEQ and QUAL and unpack them on the device straight to
    record-major flat byte buffers (seq through seq_map, qual + bias).
    Returns (seq_bytes, qual_bytes) of length ``total``."""
    W = seq_payload.shape[0]
    counts = np.asarray(counts)
    Sp = pad_steps(S)
    if Sp == 0 or not (counts > 0).any() or total == 0:
        return (np.zeros(total, dtype=np.uint8),
                np.zeros(total, dtype=np.uint8))
    dev = torch.device(device)
    pos, reset = _pos_reset(_lane_lens(ll_mat, W, dev), Sp, S, W)
    acts = _acts(_to(counts, dev, torch.int32), Sp)
    dec = []
    for kind, geom, payload, lens in (("seq", seq_geom, seq_payload,
                                       seq_lens),
                                      ("qual", qual_geom, qual_payload,
                                       qual_lens)):
        with trace(f"sfq.decode.{kind}.coder"):
            dec.append(coder_torch.lane_decode(
                _payload_tensor(payload, dev), _to(lens, dev, torch.int32),
                acts, pos, reset, kind, geom))
    with trace("sfq.decode.unpack_pair"):
        seq_flat, qual_flat = pack_torch.unpack_pair(
            dec[0], dec[1], rec_starts, lengths, W, total, seq_map,
            qual_bias)
    return (seq_flat[:total].cpu().numpy(), qual_flat[:total].cpu().numpy())
