"""Emission compaction: chunked coder output -> per-lane byte streams.

Contract (the JAX package's ops/compact_pallas.py ``_build``/``_build_v2``
and ops/compact_xla.py ``_build``): the encode coder emits renorm bytes
into dense per-chunk windows ``ebufs [NC, W, CB]`` u8 with per-chunk valid
counts ``eptrs [NC, W]``; per lane, concatenate each chunk's valid prefix
at the lane's exclusive prefix offset into ``payload [W, Bmax]`` u8, and
return the per-lane totals [W]. Here bytes past each total are 0 (the TPU
versions leave them unspecified), so kernel and plain version agree on
every byte.

``compact_streams_dev`` compacts every stream of an encode block in one
launch of Kernel C (csrc/compact.cu) on CUDA tensors, and runs
``compact_streams_plain`` on CPU tensors. Both fill one flat byte buffer
(``FlatLayout``): every stream's rows, then its totals, then the coder
tails the caller hands in, so one copy takes the whole block to the host.
A window of blocks (the small-block window path) hands every stream of
every block to one launch; ``compact_lanes_dev`` is the one-stream case.
A launch takes up to MAX_STREAMS streams.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from . import _cuda

MAX_STREAMS = 256  # descriptors a launch: csrc/compact.cu's MAX_STREAMS


class _Desc(ctypes.Structure):
    _fields_ = [("ebufs", ctypes.c_void_p), ("eptrs", ctypes.c_void_p),
                ("out", ctypes.c_void_p), ("totals", ctypes.c_void_p),
                ("NC", ctypes.c_int), ("W", ctypes.c_int),
                ("CB", ctypes.c_int), ("Bmax", ctypes.c_int),
                ("pitch", ctypes.c_int)]


_SIGS = {"compact_streams": [_cuda.PTR, _cuda.INT, _cuda.PTR]}


class FlatLayout(NamedTuple):
    """Byte offsets in the flat buffer: per stream (rows, totals, tail or
    -1, W, pitch, Bmax). Rows are [W, pitch] u8 with pitch = Bmax rounded
    up to 16; totals and tails are [W] int32."""
    parts: tuple
    nbytes: int

    def views(self, flat: torch.Tensor) -> list:
        """Per stream (payload [W, Bmax] u8, totals [W] i32, tail [W] i32
        or None): views of ``flat`` or of a copy of it."""
        out = []
        for rows, tot, tail, W, pitch, Bmax in self.parts:
            pay = flat[rows: rows + W * pitch].view(W, pitch)[:, :Bmax]
            out.append((pay, flat[tot: tot + 4 * W].view(torch.int32),
                        None if tail < 0 else
                        flat[tail: tail + 4 * W].view(torch.int32)))
        return out


def _layout(shapes, with_tails: bool) -> FlatLayout:
    """shapes: per stream (W, Bmax)."""
    parts, at = [], 0
    for W, Bmax in shapes:
        pitch = (Bmax + 15) // 16 * 16
        parts.append([at, 0, -1, W, pitch, Bmax])
        at += W * pitch
    for p in parts:
        p[1] = at
        at += 4 * p[3]
    if with_tails:
        for p in parts:
            p[2] = at
            at += 4 * p[3]
    return FlatLayout(tuple(tuple(p) for p in parts), at)


def compact_lanes_plain(ebufs: torch.Tensor, eptrs: torch.Tensor,
                        Bmax: int):
    """Plain PyTorch version of Kernel C on one stream: one scatter of
    every valid byte to its lane row."""
    NC, W, CB = ebufs.shape
    dev = ebufs.device
    ep = eptrs.long()
    offs = torch.cumsum(ep, dim=0) - ep                      # [NC, W]
    b = torch.arange(CB, device=dev)
    pos = offs[:, :, None] + b                               # [NC, W, CB]
    keep = (b < ep[:, :, None]) & (pos < Bmax)
    lanes = torch.arange(W, device=dev)[None, :, None]
    dst = torch.where(keep, lanes * Bmax + pos, W * Bmax)
    out = torch.zeros(W * Bmax + 1, dtype=torch.uint8, device=dev)
    out.index_put_((dst.reshape(-1),), ebufs.reshape(-1))
    return out[:-1].reshape(W, Bmax), ep.sum(dim=0).int()


def _check(streams, tails):
    if not 1 <= len(streams) <= MAX_STREAMS:
        raise ValueError(f"one launch compacts 1 to {MAX_STREAMS} streams, "
                         f"not {len(streams)}")
    if tails is not None and len(tails) != len(streams):
        raise ValueError("one tail per stream")
    dev = streams[0][0].device
    shapes = []
    for k, (ebufs, eptrs, Bmax) in enumerate(streams):
        if ebufs.dim() != 3 or ebufs.dtype != torch.uint8:
            raise ValueError("ebufs must be [NC, W, CB] uint8")
        NC, W, CB = ebufs.shape
        if eptrs.shape != (NC, W) or eptrs.dtype != torch.int32:
            raise ValueError("eptrs must be [NC, W] int32")
        if int(Bmax) < 1:
            raise ValueError("Bmax must be >= 1")
        parts = [ebufs, eptrs]
        if tails is not None:
            if tails[k].shape != (W,) or tails[k].dtype != torch.int32:
                raise ValueError("a tail must be [W] int32")
            parts.append(tails[k])
        if any(x.device != dev for x in parts):
            raise ValueError("every tensor of a launch must share a device")
        shapes.append((W, int(Bmax)))
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev, _layout(shapes, tails is not None)


def _fill_tails(flat, layout, tails):
    """The tails, one region at the end of the buffer, in one copy."""
    if tails is not None:
        torch.cat(list(tails), out=flat[layout.parts[0][2]:].view(
            torch.int32))


def compact_streams_plain(streams, tails=None):
    """Plain PyTorch version of compact_streams_dev: compact_lanes_plain on
    each stream, laid into the same flat buffer."""
    dev, layout = _check(streams, tails)
    flat = torch.zeros(layout.nbytes, dtype=torch.uint8, device=dev)
    for (ebufs, eptrs, Bmax), (pay, tot, _) in zip(streams,
                                                   layout.views(flat)):
        p, t = compact_lanes_plain(ebufs, eptrs, int(Bmax))
        pay.copy_(p)
        tot.copy_(t)
    _fill_tails(flat, layout, tails)
    return flat, layout


def compact_streams_dev(streams, tails=None):
    """Compact a block's (or a window's) streams at once. streams: a list
    of (ebufs [NC, W, CB] u8, eptrs [NC, W] i32, Bmax), each stream its
    own NC, W, CB and Bmax; tails: None or one [W] int32 tensor a stream (the coder
    tails), carried into the flat buffer. Returns (flat u8, FlatLayout);
    ``layout.views(flat)`` gives each stream's (payload [W, Bmax],
    totals [W], tail). On CUDA tensors: one launch of Kernel C (CB must
    be a multiple of 16), counted as ``compact_lanes_dev``; on CPU
    tensors: compact_streams_plain."""
    dev, layout = _check(streams, tails)
    if dev.type == "cpu":
        return compact_streams_plain(streams, tails)
    flat = torch.empty(layout.nbytes, dtype=torch.uint8, device=dev)
    descs, keep = (_Desc * len(streams))(), []
    for d, (ebufs, eptrs, Bmax), (rows, tot, _, W, pitch, _) in zip(
            descs, streams, layout.parts):
        NC, _, CB = ebufs.shape
        if CB % 16:
            raise ValueError("Kernel C reads 16-byte words: CB must be a "
                             "multiple of 16")
        ebufs, eptrs = ebufs.contiguous(), eptrs.contiguous()
        if ebufs.data_ptr() % 16:
            ebufs = ebufs.clone()
        keep += [ebufs, eptrs]
        d.ebufs, d.eptrs = ebufs.data_ptr(), eptrs.data_ptr()
        d.out, d.totals = flat.data_ptr() + rows, flat.data_ptr() + tot
        d.NC, d.W, d.CB, d.Bmax, d.pitch = NC, W, CB, int(Bmax), pitch
    _fill_tails(flat, layout, tails)
    if not any(W for _, _, _, W, _, _ in layout.parts):
        return flat, layout  # no stream has a lane: nothing to launch
    lib = _cuda.load("compact", _SIGS)
    err = _cuda.launch(flat, lib.compact_streams, ctypes.addressof(descs),
                       len(streams))
    _cuda.count("compact_lanes_dev", len(streams), flat.device)
    _cuda.check(lib, err, "compact_streams")
    return flat, layout


def compact_lanes_dev(ebufs: torch.Tensor, eptrs: torch.Tensor, Bmax: int):
    """(payload [W, Bmax] u8, totals [W] i32) from ebufs [NC, W, CB] u8 and
    eptrs [NC, W] i32: compact_streams_dev on one stream."""
    flat, layout = compact_streams_dev([(ebufs, eptrs, Bmax)])
    pay, tot, _ = layout.views(flat)[0]
    return pay, tot
