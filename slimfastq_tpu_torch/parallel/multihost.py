"""Multi-process (multi-host) block coding (the JAX package's
parallel/multihost.py).

Blocks are independent (each its own adaptive state, delta chains reset
per block), so the multi-process workflow is embarrassingly parallel and
its container equals a single-process run byte for byte:

1. ``initialize`` joins the process group (one process per host, or per
   card: torch.distributed has one device per rank).
2. Each process takes a contiguous run of blocks (``process_block_ranges``;
   shard containers concatenated in process order reproduce the global
   block order) and encodes them on its card, or over its host's cards
   with parallel.sharded.
3. The shard containers are merged in process order (``merge_containers``:
   block bytes concatenated, the index rebuilt, nothing re-encoded), on
   the host that holds them or after parallel.gather.ragged_all_gather
   carried them to every rank.

A lost process's blocks are re-encoded anywhere; container.Writer.resume
continues a partly written shard. The three functions after
``initialize`` hold no framework code.
"""

from __future__ import annotations

import io
import os

import torch

from .. import container


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None,
               backend: str | None = None) -> None:
    """Join the process group (torch.distributed.init_process_group).

    With explicit arguments (``coordinator_address`` "host:port", the
    process count and this process's id) a bad id or a missing count
    raises ValueError and a failed init raises: a multi-process run never
    degrades to single-process in silence. With none, it initialises from
    the environment ``torchrun`` sets (MASTER_ADDR, MASTER_PORT,
    WORLD_SIZE, RANK), or stays single-process where that is absent. A
    second call after a successful init returns quietly. The backend
    defaults to NCCL where the process codes on CUDA (each rank then on
    card LOCAL_RANK, or its id modulo the node's cards), else gloo."""
    import torch.distributed as dist
    if dist.is_initialized():
        return
    if coordinator_address is not None:
        if (num_processes is None or process_id is None
                or not 0 <= process_id < num_processes):
            raise ValueError(
                f"invalid distributed config: process_id={process_id} "
                f"num_processes={num_processes}")
        init_method = f"tcp://{coordinator_address}"
    elif all(k in os.environ for k in ("MASTER_ADDR", "WORLD_SIZE",
                                       "RANK")):
        init_method = "env://"
        num_processes = int(os.environ["WORLD_SIZE"])
        process_id = int(os.environ["RANK"])
    else:
        return  # a single-process run: nothing to join
    backend = backend or ("nccl" if torch.cuda.is_available() else "gloo")
    if backend == "nccl":
        torch.cuda.set_device(int(os.environ.get(
            "LOCAL_RANK", process_id % torch.cuda.device_count())))
    dist.init_process_group(backend, init_method=init_method,
                            world_size=num_processes, rank=process_id)


def process_block_ranges(total_records: int, block_records: int,
                         num_processes: int, process_id: int
                         ) -> list[tuple[int, int]]:
    """CONTIGUOUS assignment of blocks to processes (process p owns one
    run of consecutive blocks; sizes differ by at most one block), so that
    per-process shard containers concatenated in process order reproduce
    the global block order byte-for-byte. Every block boundary is a
    multiple of block_records, so per-process encoding is bit-identical to
    the same blocks of a single-process run."""
    n_blocks = max((total_records + block_records - 1) // block_records, 0)
    base, rem = divmod(n_blocks, num_processes)
    first = process_id * base + min(process_id, rem)
    count = base + (1 if process_id < rem else 0)
    out = []
    for b in range(first, first + count):
        lo = b * block_records
        hi = min(lo + block_records, total_records)
        out.append((lo, hi))
    return out


def merge_containers(shard_bytes: list[bytes]) -> bytes:
    """Merge per-process shard containers (listed in process order; each
    holds a contiguous run of global blocks per ``process_block_ranges``)
    into one container: block bytes concatenated and the index rebuilt.
    O(total bytes): block extents come from each shard's index (blocks
    are stored contiguously between the header and the index), with no
    per-block re-parsing.

    All shards must share an identical header (same config/level)."""
    if not shard_bytes:
        raise ValueError("no shards to merge")
    headers = []
    all_offsets = []
    out = io.BytesIO()
    for i, sb in enumerate(shard_bytes):
        f = io.BytesIO(sb)
        cfg = container.read_header(f)
        if cfg.fmt != container.VERSION:
            # v1 shards have a different index tail layout; shards are
            # always produced by the current encoder, so reject clearly
            # rather than misparse (mirrors Writer.resume)
            raise ValueError(
                f"shard {i} is format v{cfg.fmt}; merge_containers only "
                f"accepts current-format (v{container.VERSION}) shards")
        header_end = f.tell()
        hdr = sb[:header_end]
        headers.append(hdr)
        if hdr != headers[0]:
            raise ValueError("shard headers differ; cannot merge")
        offsets = container.read_index(f)
        if i == 0:
            out.write(hdr)
        if not offsets:
            continue
        index_start = len(sb) - container.index_size(len(offsets))
        bounds = list(offsets) + [index_start]
        for j, off in enumerate(offsets):
            all_offsets.append(out.tell())
            out.write(sb[off:bounds[j + 1]])
    container.write_index(out, all_offsets)
    return out.getvalue()


def merge_container_files(shard_paths: list[str], out_path: str) -> None:
    shards = []
    for p in shard_paths:
        with open(p, "rb") as f:
            shards.append(f.read())
    merged = merge_containers(shards)
    with open(out_path, "wb") as f:
        f.write(merged)
