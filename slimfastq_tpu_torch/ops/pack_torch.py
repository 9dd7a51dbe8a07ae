"""Device-side SEQ+QUAL lane pack/unpack: raw FASTQ bytes <-> [Sp, W] symbol
matrices, as whole-array tensor ops (port of the JAX package's
ops/pack_jax.py pair forms).

Index math (O(Sp*W) whole-array ops, outside the coder loop):

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
  past a lane's total are inactive (the coder masks them via counts).

SEQ and QUAL share the lane layout (same lengths), so one index_add_ +
cumsum serves both and one flat gather (pack) or scatter (unpack) moves
their bytes.
"""

from __future__ import annotations

import numpy as np
import torch

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


def pack_pair(data: torch.Tensor, seq_offs: np.ndarray,
              qual_offs: np.ndarray, lengths: np.ndarray, W: int, Sp: int,
              seq_map: np.ndarray, qual_bias: int):
    """SEQ + QUAL lane pack. data: u8 [Dp] on the device (a pad_flat
    length); offsets are relative to its start. Returns (seq_syms,
    qual_syms) [Sp, W] u8 on data's device."""
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
    smap = torch.from_numpy(np.ascontiguousarray(seq_map)).to(dev)
    seq = smap.index_select(0, raw[:, :, 0].reshape(-1).long()).reshape(
        Sp, W)
    qual = ((raw[:, :, 1].int() - int(qual_bias)) & 255).to(torch.uint8)
    return seq, qual


def unpack_pair(seq_syms: torch.Tensor, qual_syms: torch.Tensor,
                out_offs: np.ndarray, lengths: np.ndarray, W: int,
                total: int, seq_map: np.ndarray, qual_bias: int):
    """SEQ + QUAL lane unpack: [Sp, W] u8 symbols -> two record-major
    [pad_flat(total)] u8 buffers on the symbols' device (the first
    ``total`` bytes are meaningful), seq through ``seq_map``, qual plus
    ``qual_bias``."""
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
    flat = flat[:-1]
    smap = torch.from_numpy(np.ascontiguousarray(seq_map)).to(dev)
    seq = smap.index_select(0, flat[:, 0].long())
    qual = ((flat[:, 1].int() + int(qual_bias)) & 255).to(torch.uint8)
    return seq, qual
