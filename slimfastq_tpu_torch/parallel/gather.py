"""Ordered ragged gather of one byte payload per process over
torch.distributed (the JAX package's parallel/gather.py).

Every rank holds one ragged u8 payload (a container block, or a shard
container of a run of blocks); the lengths ride a first ``all_gather``
(int64, one per rank), so every rank knows every trim point, then the
payloads, zero-padded to the longest, ride a second; each row is trimmed
and the rows are joined in rank order, the ordered gather that feeds the
writing process. On NCCL the tensors live on the rank's card (its current
device), on gloo on the CPU. The two collectives are library calls
(communication, not a kernel body).

torch.distributed has one device per rank, so the JAX package's
single-process form (one payload per device of a mesh, gathered with
``shard_map``) has no counterpart here: the port's form is one process a
card or host, as ``parallel.multihost`` runs it. ``gather_hlo`` (XLA text
for a test's assert) has none either; the port's test checks the two
collective calls instead.

As in the JAX package, the container writer keeps the host merge
(multihost.merge_containers) as its default: the gathered payload lands
on every rank, so the collective pays off only where the shards already
live with the ranks.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist


def _device(group) -> torch.device:
    """Where the group's collectives take their tensors."""
    if dist.get_backend(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def ragged_all_gather(shard, group=None, return_parts: bool = False):
    """Gather every rank's u8 payload ``shard`` (bytes or a u8 array) into
    their rank-order concatenation, on every rank; with ``return_parts``
    the list of trimmed per-rank u8 arrays instead."""
    row = (np.frombuffer(shard, dtype=np.uint8) if isinstance(shard, bytes)
           else np.ascontiguousarray(shard, dtype=np.uint8).reshape(-1))
    dev = _device(group)
    world = dist.get_world_size(group)
    n = torch.tensor([row.size], dtype=torch.int64, device=dev)
    lens = [torch.empty_like(n) for _ in range(world)]
    dist.all_gather(lens, n, group=group)
    lens = [int(x) for x in torch.cat(lens).cpu()]
    pad = torch.zeros(max(max(lens), 1), dtype=torch.uint8)
    pad.numpy()[:row.size] = row
    pad = pad.to(dev)
    rows = [torch.empty_like(pad) for _ in range(world)]
    dist.all_gather(rows, pad, group=group)
    parts = [r[:k].cpu().numpy() for r, k in zip(rows, lens)]
    if return_parts:
        return parts
    return b"".join(p.tobytes() for p in parts)
