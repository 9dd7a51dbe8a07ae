#!/usr/bin/env python3
"""Level 4 on the long-read block with the PyTorch/CUDA port
(slimfastq_tpu_torch): one block of 65,536 reads of 16.5 kb (raw span past
2 GiB: SEQ and QUAL packed on the host, Kernel E once a stream, the
matcher over ~1.08 Gbase, the plain SEQ and both match trials coded)
encoded twice and decoded once through api.encode_fastq / decode_fastq,
the card's kernels built before the first clock starts.

Prints the arena line (`long_read_arena`), then one JSON line
(`long_read_l4`): for each encode its wall, peak device memory, the
matcher's host seconds (native.match_find_arrays; with SFQ_MATCH_STATS=1
the library prints its phases to stderr), the block's device bytes beside
the window's budget, the kernels' launches, the container's
size and SHA-256; whether the two encodes' SHA-256 agree; the decode's
wall and peak device memory and whether the round trip is exact; the
ratio; and the matcher's candidate arena reckoned with NumPy from the
sampling rule (arena_cursor) against what the 27-bit block field of
native/host.cpp's MIndex holds (a slot packs blk / 4 << 5 | cnt in 32
bits: 2^29 entries; match_find raises past it).

With ``--roots DIR ...`` it compares decodes instead: the block encoded
once by this tree at ``--level``, then decoded by each tree of the port
given (e.g. an earlier commit unpacked with git archive; ``--roots A B B
A`` compares two in turns; ``DIR@one_cta`` decodes SEQ in one CTA of
Kernel D, not its cluster, by hiding SEQ from coder_torch.may_cluster),
each in a fresh process that builds its
kernels before any clock starts: the decode's wall and whether it returns
the input, then a second decode with each Kernel D launch timed (CUDA
events around coder_torch.lane_decode_blocks: its kind, lanes, steps and
milliseconds). Prints one JSON line (`long_read_decode`) with the card's
name and power limit.

Usage: python3 tools/longread_l4_torch.py [--reads N] [--read-len L]
       [--level 4] [--device cpu] [--roots DIR ...]
Runs on the card unless --device cpu is given; without a card it exits 1.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# a slot's 27-bit field addresses a candidate block in 4-entry units
# (MIndex::insert: s.bc = blk / 4 << 5 | cnt in a uint32), so the arena
# holds 2^29 entries
BLK_LIMIT = 1 << 29
# arena entries a key takes: 4 on its first insert, 16 more on its fifth
# (the 4-entry block grown once to MMAXC = 16, contiguous)
FIRST_BLOCK, GROWN_BLOCK, GROW_AT = 4, 16, 5


def sampled_keys(data: bytes, chunk: int = 1024):
    """The forward K-mers the matcher inserts into its index, as uint32
    arrays, one per chunk of ``chunk`` records: every position of every
    read of at least K bases whose K-mer (2-bit codes, non-ACGT as 0,
    MSB-first) is content-sampled (models/matcher.py's rule, which
    native/host.cpp's match_find twins)."""
    import numpy as np
    from slimfastq_tpu_torch import native
    from slimfastq_tpu_torch.models import matcher as M
    idx, n = native.fastq_index(data)
    buf = np.frombuffer(data, dtype=np.uint8)
    offs, lens = idx["seq_off"][:n], idx["seq_len"][:n].astype(np.int64)
    kmask = np.uint64((1 << (2 * M.K)) - 1)
    for lo in range(0, n, chunk):
        o, L = offs[lo:lo + chunk], lens[lo:lo + chunk]
        keep = L >= M.K
        o, L = o[keep], L[keep]
        if not len(L):
            continue
        starts = np.zeros(len(L), dtype=np.int64)
        starts[1:] = np.cumsum(L[:-1])
        total = int(L.sum())
        # the chunk's bases back to back, then each position's K-mer
        at = np.repeat(o - starts, L) + np.arange(total)
        c = M._B2C0[buf[at]].astype(np.uint64)
        m = total - M.K + 1
        km = np.zeros(m, dtype=np.uint64)
        for j in range(M.K):
            km = ((km << np.uint64(2)) | c[j:j + m]) & kmask
        # a K-mer is a read's when it starts at most L - K into it
        inread = np.arange(m) - np.repeat(starts, L)[:m] \
            <= np.repeat(L - M.K, L)[:m]
        hit = inread & ((M._mix64(km) & np.uint64(M.sample_mask())) == 0)
        yield km[hit].astype(np.uint32)


def arena_cursor(data: bytes, chunk: int = 1024) -> dict:
    """The matcher's final candidate-arena cursor on ``data`` as one
    block: FIRST_BLOCK entries for each distinct sampled key plus
    GROWN_BLOCK for each key sampled GROW_AT times or more, against
    BLK_LIMIT."""
    import numpy as np
    keys = list(sampled_keys(data, chunk))
    keys = np.concatenate(keys) if keys else np.zeros(0, dtype=np.uint32)
    _, counts = np.unique(keys, return_counts=True)
    grown = int((counts >= GROW_AT).sum())
    cursor = FIRST_BLOCK * len(counts) + GROWN_BLOCK * grown
    return {"sampled": int(len(keys)), "distinct_keys": int(len(counts)),
            "keys_reaching_5": grown, "cursor": cursor,
            "blk_limit": BLK_LIMIT, "passes_blk_limit": cursor > BLK_LIMIT}


def run(data: bytes, level: int, device, encodes: int = 2,
        **overrides) -> dict:
    """``data`` encoded ``encodes`` times and decoded once on ``device``
    (api.encode_fastq / decode_fastq at the defaults but the level and
    the config ``overrides``), each direction timed on the host clock to
    the device's synchronisation, with the counts and peaks the module
    docstring lists."""
    import torch
    from slimfastq_tpu_torch import api, native
    from slimfastq_tpu_torch.ops import _cuda
    from slimfastq_tpu_torch.ops import streams_torch as ST
    dev = api.resolve_device(device)
    cuda = dev.type == "cuda"
    if cuda:  # every kernel built before any clock starts
        _cuda.build()
    acc = {"match_s": 0.0, "device_bytes": []}
    real_find, real_bytes = native.match_find_arrays, api.device_bytes

    def find(*a, **k):
        t = time.perf_counter()
        try:
            return real_find(*a, **k)
        finally:
            acc["match_s"] += time.perf_counter() - t

    def nbytes(*a, **k):
        n = real_bytes(*a, **k)
        acc["device_bytes"].append(n)
        return n

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    def timed(fn):
        sync()
        if cuda:
            torch.cuda.reset_peak_memory_stats(dev)
        _cuda.reset_launches()
        t = time.perf_counter()
        out = fn()
        sync()
        rec = {"wall_s": time.perf_counter() - t,
               "launches": dict(_cuda.launches)}
        rec["peak_device_GB"] = (torch.cuda.max_memory_allocated(dev) / 1e9
                                 if cuda else None)
        return out, rec

    out = {"level": level, "raw_bytes": len(data), "encodes": []}
    native.match_find_arrays, api.device_bytes = find, nbytes
    try:
        enc = None
        for _ in range(encodes):
            acc["match_s"], acc["device_bytes"] = 0.0, []
            budget = ST.device_budget(dev)
            e, rec = timed(lambda: api.encode_fastq(
                data, level=level, device=device, **overrides))
            rec.update(match_host_s=acc["match_s"], device_budget=budget,
                       block_device_bytes=acc["device_bytes"],
                       compressed_bytes=len(e),
                       sha256=hashlib.sha256(e).hexdigest())
            out["encodes"].append(rec)
            enc = enc or e
            del e
    finally:
        native.match_find_arrays, api.device_bytes = real_find, real_bytes
    out["sha256_agree"] = len({r["sha256"] for r in out["encodes"]}) == 1
    dec, out["decode"] = timed(lambda: api.decode_fastq(enc, device=device))
    out["round_trip_exact"] = dec == data
    out["ratio"] = len(data) / len(enc)
    return out


def decode_child(spec: str, path: str, want: str) -> int:
    """Decode the container at ``path`` with the tree of ``spec`` (a root
    directory, @ the SEQ shape to force or none) on the card, twice (the
    second with Kernel D's launches timed); print one JSON line."""
    root, _, shape = spec.partition("@")
    sys.path.insert(0, root)
    import torch
    from slimfastq_tpu_torch import api
    from slimfastq_tpu_torch.ops import _cuda
    from slimfastq_tpu_torch.ops import coder_torch as CT
    if shape == "one_cta":
        real = CT.may_cluster
        CT.may_cluster = lambda g, w: g.depth != 2 and real(g, w)
    elif shape:
        raise ValueError(f"unknown shape {shape!r}")
    _cuda.build()
    with open(path, "rb") as f:
        enc = f.read()
    torch.cuda.synchronize()
    t = time.perf_counter()
    dec = api.decode_fastq(enc, device="cuda")
    torch.cuda.synchronize()
    out = {"root": spec, "wall_s": time.perf_counter() - t,
           "exact": hashlib.sha256(dec).hexdigest() == want}
    del dec
    real, rec = CT.lane_decode_blocks, []

    def timed(items, kind, geom, *a, **k):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        res = real(items, kind, geom, *a, **k)
        ev[1].record()
        W = items[0][0].shape[0]
        rec.append((kind, W, int(items[0][3].reshape(-1, W).shape[0]), ev))
        return res
    CT.lane_decode_blocks = timed
    torch.cuda.synchronize()
    t = time.perf_counter()
    api.decode_fastq(enc, device="cuda")
    torch.cuda.synchronize()
    out["timed_wall_s"] = time.perf_counter() - t
    out["d_launches"] = [{"kind": k, "W": W, "Sp": Sp,
                          "ms": ev[0].elapsed_time(ev[1])}
                         for k, W, Sp, ev in rec]
    print(json.dumps(out), flush=True)
    return 0


def compare_decodes(data: bytes, level: int, roots: list) -> dict:
    """``data`` encoded once on the card by this tree, then decoded by
    each of ``roots`` in a fresh process (decode_child)."""
    import torch
    from slimfastq_tpu_torch import api
    from slimfastq_tpu_torch.ops import _cuda
    _cuda.build()
    want = hashlib.sha256(data).hexdigest()
    t = time.perf_counter()
    enc = api.encode_fastq(data, level=level, device="cuda")
    out = {"level": level, "raw_bytes": len(data),
           "encode_s": time.perf_counter() - t, "compressed_bytes": len(enc),
           "sha256": hashlib.sha256(enc).hexdigest(), "runs": []}
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "long.sfq")
        with open(path, "wb") as f:
            f.write(enc)
        del enc
        for spec in roots:
            root, at, shape = spec.partition("@")
            r = subprocess.run([sys.executable, os.path.abspath(__file__),
                                "--child", os.path.abspath(root) + at + shape,
                                path, want], capture_output=True, text=True)
            if r.returncode != 0:
                raise RuntimeError(f"decode with {spec} failed:\n"
                                   f"{r.stderr[-3000:]}")
            out["runs"].append(json.loads(r.stdout.strip().splitlines()[-1]))
    return out


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--reads", type=int, default=65536)
    p.add_argument("--read-len", type=int, default=16500)
    p.add_argument("--level", type=int, default=4)
    p.add_argument("--device", default=None)
    p.add_argument("--roots", nargs="+", default=None)
    p.add_argument("--child", nargs=3, help=argparse.SUPPRESS)
    args = p.parse_args()
    if args.child:
        return decode_child(*args.child)
    sys.path.insert(0, HERE)
    import torch
    if args.device is None and not torch.cuda.is_available():
        print("longread_l4_torch: no CUDA device", file=sys.stderr)
        return 1
    from slimfastq_tpu_torch.utils.synth import synth_fastq
    t = time.perf_counter()
    data = synth_fastq(args.reads, read_len=args.read_len, seed=0,
                       var_len=False, n_rate=0.0005)
    make_s = time.perf_counter() - t
    if args.roots:
        out = compare_decodes(data, args.level, args.roots)
        out.update(reads=args.reads, read_len=args.read_len,
                   card=subprocess.run(
                       ["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True).stdout.strip().splitlines()[0])
        print(json.dumps({"long_read_decode": out}), flush=True)
        return 0 if all(r["exact"] for r in out["runs"]) else 1
    t = time.perf_counter()
    arena = arena_cursor(data)
    arena["reckon_s"] = time.perf_counter() - t
    card = torch.cuda.get_device_name(0) if args.device is None else "cpu"
    head = {"reads": args.reads, "read_len": args.read_len, "card": card,
            "make_data_s": make_s}
    # the arena first: it stands whatever the coding does
    print(json.dumps({"long_read_arena": {**head, **arena}}), flush=True)
    os.environ.setdefault("SFQ_MATCH_STATS", "1")
    out = run(data, args.level, args.device)
    print(json.dumps({"long_read_l4": {**head, "arena": arena, **out}}),
          flush=True)
    return 0 if out["round_trip_exact"] else 1


if __name__ == "__main__":
    sys.exit(main())
