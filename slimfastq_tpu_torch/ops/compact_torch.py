"""Emission compaction: chunked coder output -> per-lane byte streams.

Contract (the JAX package's ops/compact_pallas.py ``_build``/``_build_v2``
and ops/compact_xla.py ``_build``): the encode coder emits renorm bytes
into dense per-chunk windows ``ebufs [NC, W, CB]`` u8 with per-chunk valid
counts ``eptrs [NC, W]``; per lane, concatenate each chunk's valid prefix
at the lane's exclusive prefix offset into ``payload [W, Bmax]`` u8, and
return the per-lane totals [W]. Here bytes past each total are 0 (the TPU
versions leave them unspecified), so kernel and plain version agree on
every byte.

``compact_lanes_dev`` launches Kernel C (csrc/compact.cu) on CUDA tensors
and runs ``compact_lanes_plain`` on CPU tensors.
"""

from __future__ import annotations

import torch

from . import _cuda

_SIGS = {"compact_lanes": [_cuda.PTR, _cuda.PTR, _cuda.INT, _cuda.INT,
                           _cuda.INT, _cuda.INT, _cuda.PTR, _cuda.PTR,
                           _cuda.PTR]}


def compact_lanes_plain(ebufs: torch.Tensor, eptrs: torch.Tensor,
                        Bmax: int):
    """Plain PyTorch version of Kernel C: one scatter of every valid byte
    to its lane row."""
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


def compact_lanes_dev(ebufs: torch.Tensor, eptrs: torch.Tensor, Bmax: int):
    """(payload [W, Bmax] u8, totals [W] i32) from ebufs [NC, W, CB] u8 and
    eptrs [NC, W] i32."""
    if ebufs.dim() != 3 or ebufs.dtype != torch.uint8:
        raise ValueError("ebufs must be [NC, W, CB] uint8")
    NC, W, CB = ebufs.shape
    if eptrs.shape != (NC, W) or eptrs.dtype != torch.int32:
        raise ValueError("eptrs must be [NC, W] int32")
    if ebufs.device != eptrs.device:
        raise ValueError("ebufs and eptrs must share a device")
    Bmax = int(Bmax)
    if Bmax < 1:
        raise ValueError("Bmax must be >= 1")
    if ebufs.device.type == "cpu":
        return compact_lanes_plain(ebufs, eptrs, Bmax)
    if ebufs.device.type != "cuda":
        raise ValueError(f"unsupported device {ebufs.device}")
    ebufs = ebufs.contiguous()
    eptrs = eptrs.contiguous()
    lib = _cuda.load("compact", _SIGS)
    out = torch.empty((W, Bmax), dtype=torch.uint8, device=ebufs.device)
    totals = torch.empty(W, dtype=torch.int32, device=ebufs.device)
    err = lib.compact_lanes(ebufs.data_ptr(), eptrs.data_ptr(), NC, W, CB,
                            Bmax, out.data_ptr(), totals.data_ptr(),
                            _cuda.stream_ptr(ebufs))
    _cuda.launches["compact_lanes_dev"] += 1
    _cuda.check(lib, err, "compact_lanes")
    return out, totals
