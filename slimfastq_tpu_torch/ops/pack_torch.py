"""Device-side lane pack/unpack: raw FASTQ bytes <-> [Sp, W] symbol
matrices (port of the JAX package's ops/pack_jax.py: the SEQ+QUAL pair
forms of the main path, and the single-stream ``pack_device`` /
``unpack_device``, which no path runs, as in the JAX package), and the
per-step inputs of a per-read stream (streams_jax._pos_reset_device).

On CUDA tensors the pair forms and the step inputs are the hand-written
kernels of csrc/lanes.cu:

* Kernel L (``lane_layout``, counted as ``lane_layout``): pack mode
  writes SEQ through the map, QUAL minus the bias and the stream's pos
  and reset in one launch a block; step-input mode (``step_inputs``)
  writes pos and reset;
* Kernel U (``unpack_pair``, counted as ``lane_unpack``): the inverse of
  pack mode, [Sp, W] SEQ and QUAL to their record-major bytes.

On CPU tensors they run their plain versions below (``pack_pair_plain``,
``unpack_pair_plain``, ``_pos_reset``), whole-array tensor ops
with this index math (O(Sp*W), outside the coder loop):

  record r -> lane w = r % W, ordinal j = r // W    (frozen format rule)
  ll[j, w]   = record length          (reshape of the lengths array)
  cum[j, w]  = exclusive per-lane cumsum of ll  (record's start row)
  adj[j, w]  = src_off[j, w] - cum[j, w]
  For row s of lane w the owning record is the last j with
  cum[j, w] <= s, so adding the adj *deltas* at rows cum[j, w] and
  cumsum-ing down the rows reconstructs adj(s, w) everywhere, and
      IDX[s, w] = s + adj(s, w)
  is the flat source byte for every (s, w). Zero-length records collide
  their delta onto the next record's row; the sum telescopes, so the last
  record starting at a row wins, which is exactly the pack order. Rows
  past a lane's total are inactive (the coder masks them via counts;
  Kernel L writes 0 there, the plain version the clamped gather's bytes).

SEQ and QUAL share the lane layout (same lengths), so one index_add_ +
cumsum serves both and one flat gather (pack) or scatter (unpack) moves
their bytes. A stream's bytes map through a 256-entry table or shift by a
bias, wrapping modulo 256 (the JAX package's int32 -> u8 conversion).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import _cuda

_P, _I, _L = _cuda.PTR, _cuda.INT, ctypes.c_longlong
_SIGS = {
    # data, Dp, off_s, off_q, smap, qbias, seq, qual, lens, n, Sp, S, W,
    # pos, reset, stream
    "lane_layout": [_P, _L, _P, _P, _P, _I, _P, _P, _P, _L, _L, _L, _I, _P,
                    _P, _P],
    # seq, qual, offs, lens, n, Sp, total, W, smap, qbias, seq_out,
    # qual_out, stream
    "lane_unpack": [_P, _P, _P, _P, _L, _L, _L, _I, _P, _I, _P, _P, _P],
}

_BUCKET = 1 << 20  # flat-buffer length quantum (1 MiB)


def pad_flat(nbytes: int) -> int:
    return max(_BUCKET, ((nbytes + _BUCKET - 1) // _BUCKET) * _BUCKET)


def _mats(offs: np.ndarray, lengths: np.ndarray, W: int, Rpl: int):
    """Host-side [Rpl, W] reshapes of per-record offsets/lengths."""
    n = len(offs)
    off_mat = np.zeros(Rpl * W, dtype=np.int64)
    ll_mat = np.zeros(Rpl * W, dtype=np.int64)
    off_mat[:n] = offs
    ll_mat[:n] = lengths
    return off_mat.reshape(Rpl, W), ll_mat.reshape(Rpl, W)


def _adj_rows(adj_src: torch.Tensor, ll: torch.Tensor, Sp: int, W: int):
    """adj(s, w) for every row from per-record source offsets
    ``adj_src`` [Rpl, W] or [Rpl, W, k] and lengths ``ll`` [Rpl, W]
    (int64, one device): [Sp, W] or [Sp, W, k]."""
    Rpl = ll.shape[0]
    cum = torch.zeros_like(ll)
    if Rpl > 1:
        cum[1:] = torch.cumsum(ll[:-1], dim=0)
    c = cum if adj_src.dim() == 2 else cum[..., None]
    adj = adj_src - c
    deltas = torch.cat([adj[:1], adj[1:] - adj[:-1]], dim=0)
    lanes = torch.arange(W, device=ll.device)
    flat = torch.where(cum < Sp, cum * W + lanes, Sp * W).reshape(-1)
    acc = torch.zeros((Sp * W + 1,) + tuple(adj.shape[2:]),
                      dtype=torch.int64, device=ll.device)
    acc.index_add_(0, flat, deltas.reshape((-1,) + tuple(adj.shape[2:])))
    return torch.cumsum(acc[:-1].reshape((Sp, W) + tuple(adj.shape[2:])),
                        dim=0)


def _map_or_bias(x: torch.Tensor, map256: np.ndarray | None,
                 bias: int) -> torch.Tensor:
    """u8 ``x`` through the 256-entry ``map256``, or plus ``bias``
    modulo 256."""
    if map256 is not None:
        m = torch.from_numpy(np.ascontiguousarray(map256, dtype=np.uint8))
        return m.to(x.device).index_select(0, x.reshape(-1).long()).reshape(
            x.shape)
    return ((x.int() + int(bias)) & 255).to(torch.uint8)


def pack_pair_plain(data: torch.Tensor, seq_offs: np.ndarray,
                    qual_offs: np.ndarray, lengths: np.ndarray, W: int,
                    Sp: int, seq_map: np.ndarray, qual_bias: int):
    """Plain version of Kernel L's pack mode, its symbols: SEQ + QUAL lane
    pack. data: u8 [Dp] (a pad_flat length); offsets are relative to its
    start. Returns (seq_syms, qual_syms) [Sp, W] u8 on data's device."""
    dev = data.device
    n = len(seq_offs)
    Rpl = max((n + W - 1) // W, 1)
    off_s, ll_mat = _mats(seq_offs, lengths, W, Rpl)
    off_q, _ = _mats(qual_offs, lengths, W, Rpl)
    src = torch.from_numpy(np.stack([off_s, off_q], axis=-1)).to(dev)
    ll = torch.from_numpy(ll_mat).to(dev)
    adj = _adj_rows(src, ll, Sp, W)                       # [Sp, W, 2]
    rows = torch.arange(Sp, device=dev)[:, None, None]
    idx = (rows + adj).clamp_(0, data.shape[0] - 1)
    raw = data.index_select(0, idx.reshape(-1)).reshape(Sp, W, 2)
    return (_map_or_bias(raw[:, :, 0], seq_map, 0),
            _map_or_bias(raw[:, :, 1], None, -int(qual_bias)))


def unpack_pair_plain(seq_syms: torch.Tensor, qual_syms: torch.Tensor,
                      out_offs: np.ndarray, lengths: np.ndarray, W: int,
                      total: int, seq_map: np.ndarray, qual_bias: int):
    """Plain version of Kernel U: SEQ + QUAL lane unpack, [Sp, W] u8
    symbols -> two record-major [pad_flat(total)] u8 buffers on the
    symbols' device (the first ``total`` bytes are meaningful), seq
    through ``seq_map``, qual plus ``qual_bias``."""
    dev = seq_syms.device
    n = len(out_offs)
    Sp = int(seq_syms.shape[0])
    Rpl = max((n + W - 1) // W, 1)
    off_mat, ll_mat = _mats(out_offs, lengths, W, Rpl)
    ll = torch.from_numpy(ll_mat).to(dev)
    adj = _adj_rows(torch.from_numpy(off_mat).to(dev), ll, Sp, W)
    Tp = pad_flat(total)
    rows = torch.arange(Sp, device=dev)[:, None]
    active = rows < ll.sum(dim=0)[None, :]
    idx = torch.where(active, (rows + adj).clamp_(0, Tp - 1), Tp)
    pair = torch.stack([seq_syms, qual_syms], dim=-1).reshape(-1, 2)
    flat = torch.zeros((Tp + 1, 2), dtype=torch.uint8, device=dev)
    flat.index_put_((idx.reshape(-1),), pair)
    return (_map_or_bias(flat[:-1, 0], seq_map, 0),
            _map_or_bias(flat[:-1, 1], None, qual_bias))


def _pos_reset(lane_lens: torch.Tensor, Sp: int, S: int, W: int):
    """Plain version of Kernel L's pos and reset: [Sp, W] int32 from the
    per-lane record-length matrix [Rpl, W] (int64): a boundary scatter of
    the reads' starts, and of each start's distance from the lane's start
    before, whose running sum down the steps is the last read start
    (int32 throughout: no [Sp, W] int64 temporary)."""
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


def _lane_lens(ll_mat: np.ndarray, W: int) -> np.ndarray:
    """The per-lane record-length matrix with at least one row (int64)."""
    ll = np.zeros((max(ll_mat.shape[0], 1), W), dtype=np.int64)
    ll[: ll_mat.shape[0]] = ll_mat
    return ll


def _dev(x: np.ndarray, dev, dtype: torch.dtype) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(x))
    return t.to(device=dev, dtype=dtype)


def _layout(dev, Sp: int, S: int, W: int, ll_mat: np.ndarray,
            pack=None) -> tuple:
    """Kernel L, one launch: (pos, reset) [Sp, W] int32, preceded in pack
    mode (``pack`` = (data, seq_offs, qual_offs, seq_map, qual_bias)) by
    (seq, qual) [Sp, W] u8."""
    if W < 1 or Sp < 1:
        raise ValueError("the lane layout needs a lane and a step")
    lens = _dev(_lane_lens(ll_mat, W).reshape(-1), dev, torch.int32)
    outs = [torch.empty((Sp, W), dtype=torch.int32, device=dev)
            for _ in range(2)]
    ptr = [None] * 6  # data, off_s, off_q, smap, seq, qual
    Dp, qbias = 0, 0
    if pack is not None:
        data, seq_offs, qual_offs, seq_map, qbias = pack
        if data.dtype != torch.uint8 or data.dim() != 1 \
                or not data.is_contiguous():
            raise ValueError("data must be contiguous [Dp] uint8")
        syms = [torch.empty((Sp, W), dtype=torch.uint8, device=dev)
                for _ in range(2)]
        ins = [_dev(seq_offs, dev, torch.int64),
               _dev(qual_offs, dev, torch.int64),
               _dev(seq_map, dev, torch.uint8)]
        ptr = [data.data_ptr()] + [t.data_ptr() for t in ins + syms]
        Dp, outs = data.shape[0], syms + outs
    lib = _cuda.load("lanes", _SIGS)
    pos, reset = outs[-2:]
    err = _cuda.launch(
        outs[0], lib.lane_layout, ptr[0], Dp, ptr[1], ptr[2], ptr[3],
        int(qbias), ptr[4], ptr[5], lens.data_ptr(), lens.numel(), Sp, S, W,
        pos.data_ptr(), reset.data_ptr())
    _cuda.count("lane_layout", 1, dev)
    _cuda.check(lib, err, "lane_layout")
    return tuple(outs)


def lane_layout(data: torch.Tensor, seq_offs: np.ndarray,
                qual_offs: np.ndarray, lengths: np.ndarray,
                ll_mat: np.ndarray, W: int, Sp: int, S: int,
                seq_map: np.ndarray, qual_bias: int) -> tuple:
    """Kernel L, pack mode: a block's SEQ and QUAL lanes from its raw
    bytes (``data`` u8 [Dp], a pad_flat length; offsets relative to its
    start; ``lengths`` per record and ``ll_mat`` [Rpl, W] the same
    lengths by lane) and the per-step pos and reset of its reads (S: the
    longest lane's steps), in one launch on a CUDA tensor. Returns (seq,
    qual) [Sp, W] u8 and (pos, reset) [Sp, W] int32; rows past a lane's
    count hold 0 (the plain version: the clamped gather's bytes; they are
    never coded). On a CPU tensor: pack_pair_plain and _pos_reset."""
    dev = data.device
    if dev.type == "cpu":
        return (*pack_pair_plain(data, seq_offs, qual_offs, lengths, W, Sp,
                                 seq_map, qual_bias),
                *_pos_reset(torch.from_numpy(_lane_lens(ll_mat, W)), Sp, S,
                            W))
    return _layout(dev, Sp, S, W, ll_mat, (data, seq_offs, qual_offs,
                                           seq_map, qual_bias))


def step_inputs(ll_mat: np.ndarray, Sp: int, S: int, W: int,
                device) -> tuple:
    """Kernel L, step-input mode: pos and reset [Sp, W] int32 of a
    per-read stream from its per-lane record-length matrix [Rpl, W] (S:
    the longest lane's steps): one launch on a CUDA device; _pos_reset on
    the CPU."""
    dev = torch.device(device)
    if dev.type == "cpu":
        return _pos_reset(torch.from_numpy(_lane_lens(ll_mat, W)), Sp, S, W)
    return _layout(dev, Sp, S, W, ll_mat)


def unpack_pair(seq_syms: torch.Tensor, qual_syms: torch.Tensor,
                out_offs: np.ndarray, lengths: np.ndarray, W: int,
                total: int, seq_map: np.ndarray, qual_bias: int):
    """SEQ + QUAL lane unpack: [Sp, W] u8 symbols -> their record-major
    bytes, seq through ``seq_map``, qual plus ``qual_bias``, on the
    symbols' device (``out_offs``: each record's first byte, ``total``
    the bytes). Kernel U, one launch, on CUDA tensors: two [total] u8
    buffers; unpack_pair_plain on CPU tensors: [pad_flat(total)], of
    which the first ``total`` bytes are meaningful."""
    dev = seq_syms.device
    if dev.type == "cpu":
        return unpack_pair_plain(seq_syms, qual_syms, out_offs, lengths, W,
                                 total, seq_map, qual_bias)
    Sp = int(seq_syms.shape[0])
    for x in (seq_syms, qual_syms):
        if x.dtype != torch.uint8 or x.shape != (Sp, W) \
                or not x.is_contiguous() or x.device != dev:
            raise ValueError("symbols must be contiguous [Sp, W] uint8 on "
                             "one device")
    n = len(out_offs)
    offs = _dev(out_offs, dev, torch.int64)
    lens = _dev(lengths, dev, torch.int32)
    smap = _dev(seq_map, dev, torch.uint8)
    outs = [torch.empty(max(total, 1), dtype=torch.uint8, device=dev)[:total]
            for _ in range(2)]
    lib = _cuda.load("lanes", _SIGS)
    err = _cuda.launch(
        seq_syms, lib.lane_unpack, seq_syms.data_ptr(), qual_syms.data_ptr(),
        offs.data_ptr(), lens.data_ptr(), n, Sp, total, W, smap.data_ptr(),
        int(qual_bias), outs[0].data_ptr(), outs[1].data_ptr())
    _cuda.count("lane_unpack", 1, dev)
    _cuda.check(lib, err, "lane_unpack")
    return tuple(outs)


def pack_device(data: torch.Tensor, offs: np.ndarray, lengths: np.ndarray,
                W: int, Sp: int, map256: np.ndarray | None = None,
                bias: int = 0) -> torch.Tensor:
    """One stream's lane pack: record-major bytes gathered into the
    [Sp, W] u8 lane-major symbol matrix on data's device, through
    ``map256`` or minus ``bias``. data: u8 [Dp] (a pad_flat length);
    ``offs`` are relative to its start. Rows past a lane's count hold the
    clamped gather's bytes, as in the JAX package."""
    dev = data.device
    n = len(offs)
    Rpl = max((n + W - 1) // W, 1)
    off_mat, ll_mat = _mats(offs, lengths, W, Rpl)
    adj = _adj_rows(torch.from_numpy(off_mat).to(dev),
                    torch.from_numpy(ll_mat).to(dev), Sp, W)
    rows = torch.arange(Sp, device=dev)[:, None]
    idx = (rows + adj).clamp_(0, data.shape[0] - 1)
    raw = data.index_select(0, idx.reshape(-1)).reshape(Sp, W)
    return _map_or_bias(raw, map256, -int(bias))


def unpack_device(syms: torch.Tensor, out_offs: np.ndarray,
                  lengths: np.ndarray, W: int, total: int,
                  map256: np.ndarray | None = None,
                  bias: int = 0) -> torch.Tensor:
    """One stream's lane unpack: the [Sp, W] u8 symbols scattered back to
    a record-major [pad_flat(total)] u8 buffer on their device (the first
    ``total`` bytes are meaningful), through ``map256`` or plus
    ``bias``."""
    dev = syms.device
    n = len(out_offs)
    Sp = int(syms.shape[0])
    Rpl = max((n + W - 1) // W, 1)
    off_mat, ll_mat = _mats(out_offs, lengths, W, Rpl)
    ll = torch.from_numpy(ll_mat).to(dev)
    adj = _adj_rows(torch.from_numpy(off_mat).to(dev), ll, Sp, W)
    Tp = pad_flat(total)
    rows = torch.arange(Sp, device=dev)[:, None]
    active = rows < ll.sum(dim=0)[None, :]
    idx = torch.where(active, (rows + adj).clamp_(0, Tp - 1), Tp)
    flat = torch.zeros(Tp + 1, dtype=torch.uint8, device=dev)
    flat.index_put_((idx.reshape(-1),), syms.reshape(-1))
    return _map_or_bias(flat[:-1], map256, bias)
