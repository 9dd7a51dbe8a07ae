"""Device-side lane pack/unpack: raw FASTQ bytes <-> [Sp, W] symbol
matrices (port of the JAX package's ops/pack_jax.py: the SEQ+QUAL pair
forms of the main path, and the single-stream ``pack_device`` /
``unpack_device``, which no path runs, as in the JAX package), and the
per-step inputs of a per-read stream (streams_jax._pos_reset_device).

On CUDA tensors every form is a hand-written kernel of csrc/lanes.cu:

* Kernel L (counted as ``lane_layout``): pair mode (``lane_layout``)
  writes SEQ through the map, QUAL minus the bias and the stream's pos
  and reset in one launch a block; step-input mode (``step_inputs``)
  writes pos and reset; single-stream mode (``pack_device``) one stream
  through a map or minus a bias;
* Kernel U (counted as ``lane_unpack``): pair mode (``unpack_pair``), the
  inverse of L's, [Sp, W] SEQ and QUAL to their record-major bytes;
  single-stream mode (``unpack_device``) one stream.

A launch's offsets (int32, relative to the block: ``staging`` refuses one
that does not fit), lengths and map go up in one page-locked copy on the
stream it launches on; a block's raw bytes go up the same way where the
pipeline prepared them in a page-locked buffer (``pinned_empty``).

On CPU tensors they run their plain versions below (``pack_pair_plain``,
``unpack_pair_plain``, ``_pos_reset``, ``pack_device_plain``,
``unpack_device_plain``), whole-array tensor ops with this index math
(O(Sp*W), outside the coder loop):

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
  past a lane's total are inactive (the coder masks them via counts);
  they hold the clamped gather's bytes, in the kernels as in the plain
  versions.

SEQ and QUAL share the lane layout (same lengths), so one index_add_ +
cumsum serves both and one flat gather (pack) or scatter (unpack) moves
their bytes. A stream's bytes map through a 256-entry table or shift by a
bias, wrapping modulo 256 (the JAX package's int32 -> u8 conversion).
"""

from __future__ import annotations

import ctypes
from functools import partial

import numpy as np
import torch

from . import _cuda

_P, _I, _L = _cuda.PTR, _cuda.INT, ctypes.c_longlong
_SIGS = {
    # mode, data, Dp, off_s, off_q, lens, smap, bias, Rpl, Sp, S, W, seq,
    # qual, pos, reset, stream
    "lane_layout": [_I, _P, _L, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P,
                    _P, _P, _P],
    # seq, qual, offs, lens, n, Sp, total, W, smap, qbias, seq_out,
    # qual_out, Tp, stream
    "lane_unpack": [_P, _P, _P, _P, _L, _L, _L, _I, _P, _I, _P, _P, _L,
                    _P],
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


# ---------------------------------------------------------------------------
# the kernels' inputs from the host
# ---------------------------------------------------------------------------

_I32 = np.iinfo(np.int32)


def staging(parts, empty=None):
    """The small inputs of a launch in one host buffer: each part an
    (array, dtype, count) triple, written as ``count`` entries of
    ``dtype`` (the array's, then zeros) at a 16-byte boundary. Returns
    the buffer (from ``empty(nbytes)``, u8; a numpy one without it) and
    the parts' views into it.
    An int32 part raises ValueError where a value does not fit: record
    offsets are relative to the block and no narrowing is silent."""
    spans, at = [], 0
    for x, dtype, count in parts:
        nbytes = count * np.dtype(dtype).itemsize
        spans.append((at, nbytes))
        at += -(-nbytes // 16) * 16
    buf = (empty or partial(np.empty, dtype=np.uint8))(max(at, 16))
    views = []
    for (x, dtype, count), (at, nbytes) in zip(parts, spans):
        x = np.asarray(x).reshape(-1)
        if dtype == np.int32 and x.size and (int(x.min()) < _I32.min
                                             or int(x.max()) > _I32.max):
            raise ValueError("an offset or length does not fit int32 "
                             "(a block's raw span must stay below 2 GiB)")
        v = buf[at: at + nbytes].view(dtype)
        v[: x.size] = x
        v[x.size:] = 0
        views.append(v)
    return buf, views


def pinned_empty(nbytes: int) -> np.ndarray:
    """A page-locked u8 host array of ``nbytes`` (contents undefined)
    from PyTorch's caching host allocator, which hands its memory out
    again only once the copies ``upload`` made from it have completed."""
    return torch.empty(max(nbytes, 1), dtype=torch.uint8,
                       pin_memory=True).numpy()[:nbytes]


def upload(arr: np.ndarray, dev: torch.device) -> torch.Tensor:
    """u8 ``arr`` [n] on ``dev``: one asynchronous copy on the current
    stream from the page-locked tensor it lies in (pinned_empty's: the
    allocator records the copy against that tensor's block); a plain copy
    from any other array."""
    t = arr
    while t is not None and not isinstance(t, torch.Tensor):
        # numpy views lead to the tensor the memory is from
        t = getattr(t, "base", None)
    if dev.type != "cuda" or t is None or arr.ndim != 1 \
            or not arr.flags.c_contiguous or not t.is_pinned():
        return torch.from_numpy(np.ascontiguousarray(arr)).to(dev)
    at = arr.ctypes.data - t.data_ptr()
    with torch.cuda.device(dev):
        return t[at: at + arr.size].to(dev, non_blocking=True)


def _upload(dev, parts) -> list:
    """staging(parts) on ``dev`` in one page-locked, asynchronous copy on
    the device's current stream (the one the kernel launches on). Returns
    the parts on the device, in order."""
    host, views = staging(parts, pinned_empty)
    buf = upload(host, dev)
    out, at = [], 0
    for v in views:
        out.append(buf[at: at + v.nbytes].view(_TORCH[v.dtype]))
        at += -(-v.nbytes // 16) * 16
    return out


_TORCH = {np.dtype(np.int32): torch.int32, np.dtype(np.uint8): torch.uint8}


def _check(x: torch.Tensor, W: int, what: str) -> int:
    """Sp of a contiguous [Sp, W] u8 CUDA tensor, or ValueError."""
    if x.dtype != torch.uint8 or x.dim() != 2 or x.shape[1] != W \
            or not x.is_contiguous():
        raise ValueError(f"{what} must be contiguous [Sp, W] uint8")
    return int(x.shape[0])


def _raw(data: torch.Tensor) -> None:
    if data.dtype != torch.uint8 or data.dim() != 1 \
            or not data.is_contiguous():
        raise ValueError("data must be contiguous [Dp] uint8")


_PAIR, _STEPS, _ONE = 0, 1, 2


def _layout(mode: int, dev, Sp: int, S: int, W: int, ll_mat: np.ndarray,
            data=None, offs=(), smap=None, bias: int = 0) -> tuple:
    """Kernel L, one launch: (seq, qual) [Sp, W] u8 then (pos, reset)
    [Sp, W] int32 (pair mode: ``offs`` = (seq_offs, qual_offs), ``smap``
    SEQ's map, ``bias`` QUAL's), (pos, reset) (step-input mode) or the one
    stream's [Sp, W] u8 (single-stream mode: ``offs`` = (offs,), through
    ``smap`` or minus ``bias``). Offsets, lengths and the map go up in one
    staged copy."""
    if W < 1 or Sp < 1:
        raise ValueError("the lane layout needs a lane and a step")
    Rpl = max(ll_mat.shape[0], 1)
    parts = [(ll_mat, np.int32, Rpl * W)]
    parts += [(o, np.int32, Rpl * W) for o in offs]
    if smap is not None:
        parts.append((smap, np.uint8, 256))
    ins = _upload(dev, parts)
    lens_t, offs_t = ins[0], ins[1: 1 + len(offs)]
    smap_t = ins[-1] if smap is not None else None
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    u8 = [torch.empty((Sp, W), dtype=torch.uint8, device=dev)
          for _ in range({_PAIR: 2, _STEPS: 0, _ONE: 1}[mode])]
    i32 = [torch.empty((Sp, W), dtype=torch.int32, device=dev)
           for _ in range(0 if mode == _ONE else 2)]
    outs = (u8 + [None, None])[:2] + (i32 + [None, None])[:2]
    if data is not None:
        _raw(data)
    lib = _cuda.load("lanes", _SIGS)
    err = _cuda.launch(
        (u8 + i32)[0], lib.lane_layout, mode, ptr(data),
        0 if data is None else data.shape[0], *(ptr(t) for t in
                                                (offs_t + [None] * 2)[:2]),
        lens_t.data_ptr(), ptr(smap_t), int(bias), Rpl, Sp, S, W,
        *(ptr(t) for t in outs))
    _cuda.count("lane_layout", 1, dev)
    _cuda.check(lib, err, "lane_layout")
    return tuple(u8 + i32)


def lane_layout(data: torch.Tensor, seq_offs: np.ndarray,
                qual_offs: np.ndarray, lengths: np.ndarray,
                ll_mat: np.ndarray, W: int, Sp: int, S: int,
                seq_map: np.ndarray, qual_bias: int) -> tuple:
    """Kernel L, pair mode: a block's SEQ and QUAL lanes from its raw
    bytes (``data`` u8 [Dp], a pad_flat length; offsets relative to its
    start, each below 2^31; ``lengths`` per record and ``ll_mat``
    [Rpl, W] the same lengths by lane) and the per-step pos and reset of
    its reads (S: the longest lane's steps), in one launch on a CUDA
    tensor. Returns (seq, qual) [Sp, W] u8 and (pos, reset) [Sp, W]
    int32, the whole matrices equal to the plain versions' (rows past a
    lane's count hold the clamped gather's bytes; they are never coded).
    On a CPU tensor: pack_pair_plain and _pos_reset."""
    dev = data.device
    if dev.type == "cpu":
        return (*pack_pair_plain(data, seq_offs, qual_offs, lengths, W, Sp,
                                 seq_map, qual_bias),
                *_pos_reset(torch.from_numpy(_lane_lens(ll_mat, W)), Sp, S,
                            W))
    return _layout(_PAIR, dev, Sp, S, W, ll_mat, data,
                   (seq_offs, qual_offs), seq_map, int(qual_bias))


def step_inputs(ll_mat: np.ndarray, Sp: int, S: int, W: int,
                device) -> tuple:
    """Kernel L, step-input mode: pos and reset [Sp, W] int32 of a
    per-read stream from its per-lane record-length matrix [Rpl, W] (S:
    the longest lane's steps): one launch on a CUDA device; _pos_reset on
    the CPU."""
    dev = torch.device(device)
    if dev.type == "cpu":
        return _pos_reset(torch.from_numpy(_lane_lens(ll_mat, W)), Sp, S, W)
    return _layout(_STEPS, dev, Sp, S, W, ll_mat)


def _unpack(syms, qual, out_offs, lengths, W: int, total: int, smap,
            bias: int, Tp: int) -> tuple:
    """Kernel U, one launch: pair mode where ``qual`` is given (two
    [total] buffers), single-stream mode otherwise (one [Tp] buffer).
    Output offsets, lengths and the map go up in one staged copy."""
    dev = syms.device
    Sp = _check(syms, W, "symbols")
    if qual is not None and (qual.device != dev
                             or _check(qual, W, "symbols") != Sp):
        raise ValueError("symbols must be contiguous [Sp, W] uint8 on one "
                         "device")
    n = len(out_offs)
    parts = [(out_offs, np.int32, n), (lengths, np.int32, n)]
    if smap is not None:
        parts.append((smap, np.uint8, 256))
    ins = _upload(dev, parts)
    smap_t = ins[2] if smap is not None else None
    size = total if qual is not None else Tp
    outs = [torch.empty(max(size, 1), dtype=torch.uint8, device=dev)[:size]
            for _ in range(1 if qual is None else 2)]
    lib = _cuda.load("lanes", _SIGS)
    err = _cuda.launch(
        syms, lib.lane_unpack, syms.data_ptr(),
        None if qual is None else qual.data_ptr(), ins[0].data_ptr(),
        ins[1].data_ptr(), n, Sp, total, W,
        None if smap_t is None else smap_t.data_ptr(), int(bias),
        outs[0].data_ptr(), None if qual is None else outs[1].data_ptr(), Tp)
    _cuda.count("lane_unpack", 1, dev)
    _cuda.check(lib, err, "lane_unpack")
    return tuple(outs)


def unpack_pair(seq_syms: torch.Tensor, qual_syms: torch.Tensor,
                out_offs: np.ndarray, lengths: np.ndarray, W: int,
                total: int, seq_map: np.ndarray, qual_bias: int):
    """SEQ + QUAL lane unpack: [Sp, W] u8 symbols -> their record-major
    bytes, seq through ``seq_map``, qual plus ``qual_bias``, on the
    symbols' device (``out_offs``: each record's first byte, ``total``
    the bytes, below 2^31). Kernel U, one launch, on CUDA tensors: two
    [total] u8 buffers; unpack_pair_plain on CPU tensors:
    [pad_flat(total)], of which the first ``total`` bytes are
    meaningful."""
    if seq_syms.device.type == "cpu":
        return unpack_pair_plain(seq_syms, qual_syms, out_offs, lengths, W,
                                 total, seq_map, qual_bias)
    return _unpack(seq_syms, qual_syms, out_offs, lengths, W, total, seq_map,
                   qual_bias, total)


def pack_device_plain(data: torch.Tensor, offs: np.ndarray,
                      lengths: np.ndarray, W: int, Sp: int,
                      map256: np.ndarray | None = None,
                      bias: int = 0) -> torch.Tensor:
    """Plain version of Kernel L's single-stream mode: the JAX package's
    pack_device in tensor ops."""
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


def pack_device(data: torch.Tensor, offs: np.ndarray, lengths: np.ndarray,
                W: int, Sp: int, map256: np.ndarray | None = None,
                bias: int = 0) -> torch.Tensor:
    """One stream's lane pack: record-major bytes gathered into the
    [Sp, W] u8 lane-major symbol matrix on data's device, through
    ``map256`` or minus ``bias``. data: u8 [Dp] (a pad_flat length);
    ``offs`` are relative to its start (below 2^31 on a card). Rows past
    a lane's count hold the clamped gather's bytes, as in the JAX
    package. Kernel L's single-stream mode, one launch, on a CUDA tensor;
    pack_device_plain on a CPU tensor."""
    dev = data.device
    if dev.type == "cpu":
        return pack_device_plain(data, offs, lengths, W, Sp, map256, bias)
    ll_mat = np.zeros(max(-(-len(lengths) // W), 1) * W, dtype=np.int64)
    ll_mat[: len(lengths)] = lengths
    seq, = _layout(_ONE, dev, Sp, Sp, W, ll_mat.reshape(-1, W), data,
                   (offs,), map256, bias)
    return seq


def unpack_device_plain(syms: torch.Tensor, out_offs: np.ndarray,
                        lengths: np.ndarray, W: int, total: int,
                        map256: np.ndarray | None = None,
                        bias: int = 0) -> torch.Tensor:
    """Plain version of Kernel U's single-stream mode: the JAX package's
    unpack_device in tensor ops."""
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


def unpack_device(syms: torch.Tensor, out_offs: np.ndarray,
                  lengths: np.ndarray, W: int, total: int,
                  map256: np.ndarray | None = None,
                  bias: int = 0) -> torch.Tensor:
    """One stream's lane unpack: the [Sp, W] u8 symbols scattered back to
    a record-major [pad_flat(total)] u8 buffer on their device (the first
    ``total`` bytes are the records', the rest the zero byte through
    ``map256`` or plus ``bias``; the records' output ranges tile [0,
    total), as their starts give them). Kernel U's single-stream mode,
    one launch, on a CUDA tensor; unpack_device_plain on a CPU tensor."""
    if syms.device.type == "cpu":
        return unpack_device_plain(syms, out_offs, lengths, W, total, map256,
                                   bias)
    flat, = _unpack(syms, None, out_offs, lengths, W, total, map256, bias,
                    pad_flat(total))
    return flat
