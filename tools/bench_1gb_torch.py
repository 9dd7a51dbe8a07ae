#!/usr/bin/env python3
"""GB-class streaming run of the PyTorch/CUDA port (slimfastq_tpu_torch)
on the card: `python -m slimfastq_tpu_torch.cli --streaming` encode and
`-d --streaming` decode of synthetic corpora of a few sizes (0.25 and 1
GB by default, 10^9 bytes a GB: one and four 256 MiB read chunks), each
direction a watched child process.

For each size: both walls and GB/s, each child's peak resident memory
(its resident size, polled) and that peak above the base of a child
that only imports the port and creates the CUDA context, the ratio, a
`cmp` of the round trip and, with --xz, xz -6's ratio and wall. Memory is
bounded when, in each direction, every larger size's peak above the base
stays within the smallest size's plus RSS_SLACK (one read chunk): the
streaming path holds a chunk and a few windows of blocks, whatever the
file's size. The round trip and the bound are asserted; the numbers print
as one JSON line.

The corpus: pieces of 262,144 reads of 100 bp (utils/synth.synth_fastq,
seed = the piece's number), made by a process pool; a size takes the
first pieces that reach it, so each smaller corpus is a prefix of the
largest.

Usage: python3 tools/bench_1gb_torch.py [GB ...] [--level N] [--sharded]
       [--xz] [--device cpu] [--keep]
Runs on the card unless --device cpu is given; without a card it exits 1.
"""

from __future__ import annotations

import argparse
import json
import multiprocessing
import os
import shutil
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

PIECE_READS, READ_LEN = 262144, 100
RSS_SLACK = 256 << 20
POLL_S = 0.005
PAGE = os.sysconf("SC_PAGE_SIZE")
CHUNK_BYTES = 1 << 28  # the CLI's default read chunk


def _piece(args) -> bytes:
    seed, reads, read_len = args
    from slimfastq_tpu_torch.utils.synth import synth_fastq
    return synth_fastq(reads, read_len=read_len, seed=seed, var_len=False,
                       n_rate=0.0005)


def synth_corpus(path: str, nbytes: int, piece_reads: int = PIECE_READS,
                 read_len: int = READ_LEN, workers: int | None = None) -> list:
    """Write pieces 0, 1, ... of ``piece_reads`` reads to ``path`` until it
    holds ``nbytes`` or more; returns each piece's end offset in the
    file."""
    per_read = len(_piece((0, 64, read_len))) / 64
    n = max(1, -(-nbytes // int(per_read * piece_reads)))
    ctx = multiprocessing.get_context("spawn")
    ends = []
    with ctx.Pool(min(n, workers or os.cpu_count() or 1)) as pool, \
            open(path, "wb") as f:
        for data in pool.imap(_piece, [(i, piece_reads, read_len)
                                       for i in range(n)]):
            f.write(data)
            ends.append((ends[-1] if ends else 0) + len(data))
        while ends[-1] < nbytes:  # the estimate fell short
            data = _piece((len(ends), piece_reads, read_len))
            f.write(data)
            ends.append(ends[-1] + len(data))
    while len(ends) > 1 and ends[-2] >= nbytes:  # or ran over
        ends.pop()
    with open(path, "r+b") as f:
        f.truncate(ends[-1])
    return ends


def _copy_prefix(src: str, dst: str, n: int) -> None:
    with open(src, "rb") as f, open(dst, "wb") as g:
        while n > 0:
            buf = f.read(min(n, 1 << 26))
            g.write(buf)
            n -= len(buf)


def _rss(pid: int) -> int:
    """The process's resident bytes now (/proc/PID/statm, as
    chip_smoke.py reads its own), 0 once it is gone."""
    try:
        with open(f"/proc/{pid}/statm") as f:
            return int(f.read().split()[1]) * PAGE
    except (OSError, IndexError, ValueError):
        return 0


def run_watched(cmd: list) -> tuple:
    """(wall seconds, peak resident bytes) of a child process, which must
    exit 0. The peak is the largest of the child's own resident sizes,
    read every POLL_S while it runs (its rusage would count the parent's
    pages at the fork)."""
    env = dict(os.environ, PYTHONPATH=ROOT)
    with tempfile.TemporaryFile() as out, tempfile.TemporaryFile() as err:
        t = time.perf_counter()
        p = subprocess.Popen(cmd, env=env, stdout=out, stderr=err)
        peak = 0
        while p.poll() is None:
            peak = max(peak, _rss(p.pid))
            time.sleep(POLL_S)
        wall = time.perf_counter() - t
        if p.returncode:
            out.seek(0)
            err.seek(0)
            raise RuntimeError(f"{cmd} exited {p.returncode}:\n"
                               f"{out.read()[-2000:].decode()}"
                               f"{err.read()[-4000:].decode()}")
    if not peak:
        raise RuntimeError(f"{cmd}: no resident size read from /proc")
    return wall, peak


def base_rss(device: str) -> int:
    """Peak resident bytes of a child that imports the port and creates
    its device context (the CUDA context on the card)."""
    code = ("import time, torch, slimfastq_tpu_torch.api, "
            "slimfastq_tpu_torch.cli; "
            f"torch.zeros(1, device={device!r}); time.sleep(1)")
    return run_watched([sys.executable, "-c", code])[1]


def run_size(src: str, work: str, level: int = 3, device: str = "cuda",
             sharded: bool = False, chunk_bytes: int = CHUNK_BYTES,
             block_records: int | None = None, xz: bool = False) -> dict:
    """``src`` through the streaming encode and decode CLI (watched
    children): walls, GB/s, peak RSS each way, ratio, the round trip
    compared; with ``xz``, xz -6 of ``src``."""
    dst, back = os.path.join(work, "out.sfq"), os.path.join(work, "back.fq")
    cli = [sys.executable, "-m", "slimfastq_tpu_torch.cli", "--device",
           device, "-f", "--streaming"] + (["--sharded"] if sharded else [])
    raw = os.path.getsize(src)
    enc_cmd = cli + [src, "-o", dst, f"-{level}"]
    if chunk_bytes != CHUNK_BYTES:
        enc_cmd += ["--chunk-bytes", str(chunk_bytes)]
    if block_records:
        enc_cmd += ["--block-records", str(block_records)]
    enc_s, enc_rss = run_watched(enc_cmd)
    dec_s, dec_rss = run_watched(cli + ["-d", dst, "-o", back])
    t = time.perf_counter()
    same = subprocess.run(["cmp", "-s", src, back]).returncode == 0
    out = {"raw_bytes": raw, "compressed_bytes": os.path.getsize(dst),
           "chunks": -(-raw // chunk_bytes), "encode_wall_s": enc_s,
           "encode_GB_per_s": raw / enc_s / 1e9, "decode_wall_s": dec_s,
           "decode_GB_per_s": raw / dec_s / 1e9,
           "encode_peak_rss_bytes": enc_rss,
           "decode_peak_rss_bytes": dec_rss,
           "round_trip_exact": same, "cmp_s": time.perf_counter() - t}
    out["ratio"] = raw / out["compressed_bytes"]
    os.remove(back)
    if not same:
        raise AssertionError(f"{src}: the streaming round trip differs")
    if xz and shutil.which("xz"):
        t = time.perf_counter()
        with open(os.path.join(work, "x.xz"), "wb") as f:
            subprocess.run(["xz", "-6", "-T4", "-c", src], stdout=f,
                           check=True)
        out["xz6_wall_s"] = time.perf_counter() - t
        out["xz6_bytes"] = os.path.getsize(os.path.join(work, "x.xz"))
        out["xz6_ratio"] = raw / out["xz6_bytes"]
        os.remove(os.path.join(work, "x.xz"))
    return out


def rss_bound(rows: list, base: int) -> dict:
    """Each direction's peak above ``base`` at every size against the
    smallest size's plus RSS_SLACK; ``holds`` when none passes."""
    first = min(rows, key=lambda r: r["raw_bytes"])
    out = {"base_rss_bytes": base, "slack_bytes": RSS_SLACK, "holds": True}
    for way in ("encode", "decode"):
        limit = first[f"{way}_peak_rss_bytes"] - base + RSS_SLACK
        above = [r[f"{way}_peak_rss_bytes"] - base for r in rows]
        out[way] = {"limit_above_base_bytes": limit,
                    "above_base_bytes": above}
        out["holds"] &= max(above) <= limit
    return out


def streaming_scale(sizes, work: str, level: int = 3, device: str = "cuda",
                    sharded: bool = False, xz: bool = False,
                    piece_reads: int = PIECE_READS,
                    chunk_bytes: int = CHUNK_BYTES,
                    block_records: int | None = None) -> dict:
    """The corpus of the largest of ``sizes`` (bytes) made in ``work``,
    each size's prefix of it (whole pieces) through run_size, the base
    child's RSS and the bound (rss_bound). xz runs on the largest size
    only."""
    sizes = sorted(sizes)
    t = time.perf_counter()
    whole = os.path.join(work, "corpus.fq")
    ends = synth_corpus(whole, sizes[-1], piece_reads)
    out = {"level": level, "device": device, "sharded": sharded,
           "make_data_s": time.perf_counter() - t,
           "chunk_bytes": chunk_bytes, "base_rss_bytes": base_rss(device),
           "sizes": []}
    for i, size in enumerate(sizes):
        end = next(e for e in ends if e >= size)
        src = whole
        if end < ends[-1]:
            src = os.path.join(work, "in.fq")
            _copy_prefix(whole, src, end)
        row = run_size(src, work, level, device, sharded, chunk_bytes,
                       block_records, xz and i == len(sizes) - 1)
        row["asked_bytes"] = size
        out["sizes"].append(row)
        if src != whole:
            os.remove(src)
    out["rss_bound"] = rss_bound(out["sizes"], out["base_rss_bytes"])
    return out


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("gb", type=float, nargs="*", default=[0.25, 1.0])
    p.add_argument("--level", type=int, default=3)
    p.add_argument("--sharded", action="store_true")
    p.add_argument("--xz", action="store_true")
    p.add_argument("--device", default="cuda")
    p.add_argument("--keep", action="store_true")
    args = p.parse_args()
    import torch
    if args.device == "cuda" and not torch.cuda.is_available():
        print("bench_1gb_torch: no CUDA device", file=sys.stderr)
        return 1
    work = tempfile.mkdtemp(prefix="sfq_torch_1gb_")
    try:
        out = streaming_scale([int(g * 1e9) for g in args.gb], work,
                              args.level, args.device, args.sharded,
                              args.xz)
    finally:
        if not args.keep:
            shutil.rmtree(work, ignore_errors=True)
    card = "cpu"
    if args.device == "cuda":
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0]
    print(json.dumps({"streaming_scale": {"card": card, **out}}),
          flush=True)
    if not out["rss_bound"]["holds"]:
        print("bench_1gb_torch: peak RSS above the bound", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
