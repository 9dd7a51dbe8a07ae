#!/usr/bin/env python3
"""The multi-process workflow of the PyTorch/CUDA port across ranks on
one node: WORLD processes (one a card, or on the CPU with gloo), each
joins the process group (parallel.multihost.initialize over a localhost
TCP store), encodes its contiguous run of blocks
(multihost.process_block_ranges) of the pinned generator's reads, and
carries its shard container to every rank with
parallel.gather.ragged_all_gather (timed); every rank merges the shards
(multihost.merge_containers), and the merged container must equal the
whole input encoded by one process. Prints one JSON line per rank
(encode and gather times), then the card names and power limits.

Usage: python3 tools/gather_ranks.py [--world N] [--reads R]
       [--block-records B] [--lanes W] [--backend nccl|gloo]
Defaults: every card of the node, 4 x 65,536 reads of 100 bp, NCCL.
On the CPU (a rehearsal): --backend gloo --reads 300 --block-records 64
--lanes 64.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def _args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--world", type=int, default=None)
    p.add_argument("--reads", type=int, default=4 * 65536)
    p.add_argument("--block-records", type=int, default=65536)
    p.add_argument("--lanes", type=int, default=1024)
    p.add_argument("--backend", choices=["nccl", "gloo"], default="nccl")
    p.add_argument("--rank", type=int, default=None)  # a worker's own
    p.add_argument("--port", type=int, default=None)
    p.add_argument("--dir", default=None)
    return p.parse_args(argv)


def _data(a) -> bytes:
    from slimfastq_tpu_torch.utils.synth import synth_fastq
    return synth_fastq(a.reads, read_len=100, seed=0, var_len=False,
                       n_rate=0.0005)


def _cfg(a):
    from slimfastq_tpu_torch.config import config_for_level
    return config_for_level(3, block_records=a.block_records, lanes=a.lanes)


def _device(a) -> str:
    return "cuda" if a.backend == "nccl" else "cpu"


def worker(a) -> int:
    """One rank: encode its blocks, gather every rank's shard, merge."""
    import torch.distributed as dist
    from slimfastq_tpu_torch import api, native
    from slimfastq_tpu_torch.parallel import gather, multihost
    multihost.initialize(f"127.0.0.1:{a.port}", a.world, a.rank,
                         backend=a.backend)
    try:
        data = _data(a)
        idx, n = native.fastq_index(data)
        ranges = multihost.process_block_ranges(n, a.block_records, a.world,
                                                a.rank)
        (lo, _), (_, hi) = ranges[0], ranges[-1]  # a run of blocks a rank
        start = int(idx["id_off"][lo]) - 1
        end = int(idx["id_off"][hi]) - 1 if hi < n else len(data)
        t = time.perf_counter()
        shard = api.encode_fastq(data[start:end], cfg=_cfg(a),
                                 device=_device(a))
        enc_s = time.perf_counter() - t
        gather.ragged_all_gather(b"warm-up")
        dist.barrier()
        t = time.perf_counter()
        parts = gather.ragged_all_gather(shard, return_parts=True)
        gather_ms = (time.perf_counter() - t) * 1e3
        merged = multihost.merge_containers([p.tobytes() for p in parts])
        with open(os.path.join(a.dir, f"merged{a.rank}.sfq"), "wb") as f:
            f.write(merged)
    finally:
        dist.destroy_process_group()
    print(json.dumps({"rank": a.rank, "world": a.world,
                      "backend": a.backend, "blocks": len(ranges),
                      "shard_bytes": len(shard), "encode_s": enc_s,
                      "gather_ms": gather_ms,
                      "gathered_bytes": sum(p.size for p in parts)}),
          flush=True)
    return 0


def main() -> int:
    a = _args()
    if a.rank is not None:
        return worker(a)
    import torch
    if a.backend == "nccl" and not torch.cuda.is_available():
        print("gather_ranks: no CUDA device", file=sys.stderr)
        return 1
    from slimfastq_tpu_torch import api
    a.world = a.world or (torch.cuda.device_count() if a.backend == "nccl"
                          else 2)
    whole = api.encode_fastq(_data(a), cfg=_cfg(a), device=_device(a))
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    with tempfile.TemporaryDirectory() as d:
        base = [sys.executable, os.path.abspath(__file__),
                "--world", str(a.world), "--reads", str(a.reads),
                "--block-records", str(a.block_records),
                "--lanes", str(a.lanes), "--backend", a.backend,
                "--port", str(port), "--dir", d]
        procs = [subprocess.Popen(base + ["--rank", str(r)],
                                  stdout=subprocess.PIPE, text=True)
                 for r in range(a.world)]
        rcs = []
        try:
            for p in procs:
                out, _ = p.communicate(timeout=600)
                rcs.append(p.returncode)
                sys.stdout.write(out)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
        if any(rcs):
            print(f"gather_ranks: worker exit codes {rcs}", file=sys.stderr)
            return 1
        for r in range(a.world):
            with open(os.path.join(d, f"merged{r}.sfq"), "rb") as f:
                if f.read() != whole:
                    print(f"gather_ranks: rank {r}'s merged container "
                          "differs from the whole encode", file=sys.stderr)
                    return 1
    print(json.dumps({"merged_equals_whole": True, "world": a.world,
                      "whole_bytes": len(whole)}), flush=True)
    if a.backend == "nccl":
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
