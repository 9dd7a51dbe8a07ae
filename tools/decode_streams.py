#!/usr/bin/env python3
"""Kernel D on the pinned 64k block, stream by stream, for any tree of
the port (``--root``, e.g. an earlier commit unpacked with git archive):
each of the level-3 block's seven streams decoded alone on the main
path's inputs (pipeline_native's own setup), the block's decode span
with its streams launched at once through streams_torch.StreamSet, the
level-4 block's SEQ stream as its kept match trial codes it, and the
16k window's QUAL (4 blocks in one launch); every output is held against
the coded symbols. CUDA events, the mean of ``--reps`` launches after one
more; prints one JSON line (`decode_streams`) with the card's name and
power limit.

With ``--shape-sweep L ...`` it times instead, for each read length L, the
level-3 SEQ stream of one block of synthetic reads of L bases (about
``--sweep-bases`` bases, by default as many as the pinned block; at least
one read a lane) in Kernel D's shape, a cluster, and in one CTA (forced
here by hiding SEQ from coder_torch.may_cluster), beside the share of its
steps that start a read.

Usage: python3 tools/decode_streams.py [--root DIR] [--reps N]
       [--shape-sweep L ... [--sweep-bases N]]
Runs on the card only (exits 1 without one). Run the parent and this tree
in turns on one card (parent, change, change, parent) to compare them.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--shape-sweep", type=int, nargs="+", default=None)
    ap.add_argument("--sweep-bases", type=int, default=None)
    a = ap.parse_args()
    root = os.path.abspath(a.root)
    sys.path.insert(0, root)
    os.chdir(root)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("decode_streams: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as CS
    from slimfastq_tpu_torch import native, pipeline_native as PN
    from slimfastq_tpu_torch.config import config_for_level
    from slimfastq_tpu_torch.ops import coder_torch as CT
    from slimfastq_tpu_torch.ops import compact_torch as CC
    from slimfastq_tpu_torch.ops import streams_torch as ST
    from slimfastq_tpu_torch.ops.ranger import pad_steps
    from slimfastq_tpu_torch.pipeline import MATCH_USED
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    if a.shape_sweep:
        print(json.dumps({"seq_shape_sweep": {
            "root": root, "card": card, "reps": a.reps,
            "reads": [sweep(L, a.reps, dev, a.sweep_bases)
                      for L in a.shape_sweep]}}),
            flush=True)
        return 0
    data = CS._pinned(CS.READS)
    buf = np.frombuffer(data, dtype=np.uint8)
    idx, n = native.fastq_index(data)

    def same(got, syms, counts, what):
        m = torch.arange(syms.shape[0], device=dev)[:, None] < counts[None, :]
        if not torch.equal(got[m], syms[m]):
            raise AssertionError(f"{what}: D does not return the symbols")

    def ms(fn):
        return _ms(fn, a.reps)

    # the level-3 block's streams, as block_spans in chip_smoke.py
    cfg = config_for_level(3)
    pre = PN.prepare_block_fast(buf, idx, 0, n, cfg)
    blk = PN.encode_prepared_block(pre, cfg, dev)
    fns = {}
    for name, kind, geom, item, _c in PN._coder_jobs(pre, cfg, dev):
        es = blk.streams[name]
        W = es.payload.shape[0]
        counts = ST._to(es.sym_counts, dev, torch.int32)
        S = int(es.sym_counts.max())
        Sp = pad_steps(S)
        if kind in ("seq", "qual"):
            pos, reset = ST._pos_reset(ST._lane_lens(pre[4], W, dev), Sp, S,
                                       W)
        else:
            pos = reset = ST._pad2(None, Sp, W, dev)
        args = (ST._payload_tensor(es.payload, dev),
                ST._to(es.lane_lens, dev, torch.int32), counts, pos, reset)
        same(CT.lane_decode(*args, kind, geom), item.syms, counts, name)
        fns[name] = (kind, geom, args)
    out = {"streams_ms": {name: ms(lambda v=v: CT.lane_decode(
        *v[2], v[0], v[1])) for name, v in fns.items()}}
    ss = ST.StreamSet(dev)

    def at_once():
        res = [ss.launch(lambda v=v: CT.lane_decode(*v[2], v[0], v[1]),
                         *v[2])[0] for v in fns.values()]
        ss.join()
        return res
    at_once()
    out["span_ms"] = min(CS._events_ms(at_once)[0] for _ in range(a.reps))
    # the level-4 block's SEQ, from its kept trial's symbols and flags
    cfg4 = config_for_level(4)
    pre4 = PN.prepare_block_fast(buf, idx, 0, n, cfg4)
    blk4 = PN.encode_prepared_block(pre4, cfg4, dev)
    if not blk4.flags & MATCH_USED:
        raise AssertionError("the pinned level-4 block takes no match trial")
    for _t, alt, _, _, mflag in pre4[6]["trials"]:
        job = next(ST.seq_qual_jobs(*PN.seq_qual_args(pre4, cfg4, alt), dev,
                                    mflag, ("SEQ",)))
        pay, _ = ST.encode_block([("SEQ", "seq", job.geom, job.item,
                                   pre4[0]["SEQ"][3])], dev)["SEQ"]
        if np.array_equal(pay, blk4.streams["SEQ"].payload):
            break
    else:
        raise AssertionError("no trial gives the block's SEQ stream")
    Sp, W = job.syms.shape
    mf = torch.zeros((Sp, W), dtype=torch.uint8, device=dev)
    mf[: mflag.shape[0]] = torch.from_numpy(mflag).to(dev)
    args4 = (ST._payload_tensor(blk4.streams["SEQ"].payload, dev),
             ST._to(blk4.streams["SEQ"].lane_lens, dev, torch.int32),
             job.counts, job.pos, job.reset)
    same(CT.lane_decode(*args4, "seq", job.geom, mf), job.syms, job.counts,
         "L4 SEQ")
    out["l4_seq_trial_ms"] = ms(lambda: CT.lane_decode(*args4, "seq",
                                                       job.geom, mf))
    # the 16k window's QUAL, 4 blocks in one launch
    wcfg, pres = CS._window_pres(data, 3, CS.WINDOW_RECORDS)
    q = next(g for g in PN._window_jobs(pres, wcfg, dev) if g[0] == "QUAL")
    geom = q[2]
    enc = CT.lane_encode_blocks([m[1] for m in q[3]], "qual", geom,
                                ST._chunk_bytes(geom.depth, hard=False))
    items, refs = [], []
    for p, e, (_, _, counts) in zip(pres, enc, q[3]):
        pay, tot = CC.compact_lanes_dev(e[0], e[1], max(int(
            e[1].sum(dim=0).max()), 1))
        pay, lens = ST._flush_append(pay.cpu().numpy(),
                                     tot.cpu().numpy().astype(np.int64),
                                     e[2].cpu().numpy().view(np.uint32),
                                     np.asarray(counts))
        j = next(ST.seq_qual_jobs(*PN.seq_qual_args(p, wcfg), dev))
        items.append((torch.from_numpy(pay).to(dev),
                      torch.from_numpy(lens.astype(np.int32)).to(dev),
                      j.counts, j.pos, j.reset))
        refs.append((j.syms, j.counts))
    for got, (syms, counts) in zip(CT.lane_decode_blocks(items, "qual", geom),
                                   refs):
        same(got, syms, counts, "the 16k window's QUAL")
    out["window_16k_qual_ms"] = ms(lambda: CT.lane_decode_blocks(
        items, "qual", geom))
    print(json.dumps({"decode_streams": {"root": root, "card": card,
                                         "reps": a.reps, **out}}),
          flush=True)
    return 0


def _ms(fn, reps: int) -> float:
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def sweep(L: int, reps: int, dev, bases: int | None = None) -> dict:
    """One block of reads of L bases at level 3 (about ``bases`` bases, by
    default the pinned block's): its SEQ stream's Kernel D in a cluster
    and in one CTA (ms), each held against the coded symbols, and the
    share of its steps that start a read."""
    import numpy as np
    import torch
    import chip_smoke as CS
    from slimfastq_tpu_torch import native, pipeline_native as PN
    from slimfastq_tpu_torch.config import config_for_level
    from slimfastq_tpu_torch.ops import coder_torch as CT
    from slimfastq_tpu_torch.ops import streams_torch as ST
    from slimfastq_tpu_torch.ops.ranger import pad_steps
    from slimfastq_tpu_torch.utils.synth import synth_fastq
    cfg = config_for_level(3)
    reads = max(cfg.lanes, (bases or CS.READS * CS.READ_LEN) // L)
    data = synth_fastq(reads, read_len=L, seed=0, var_len=False,
                       n_rate=0.0005)
    buf = np.frombuffer(data, dtype=np.uint8)
    idx, n = native.fastq_index(data)
    pre = PN.prepare_block_fast(buf, idx, 0, n, cfg)
    blk = PN.encode_prepared_block(pre, cfg, dev)
    _, _, geom, item, _ = next(j for j in PN._coder_jobs(pre, cfg, dev)
                               if j[0] == "SEQ")
    es = blk.streams["SEQ"]
    W = es.payload.shape[0]
    S = int(es.sym_counts.max())
    Sp = pad_steps(S)
    share = int(np.count_nonzero(pre[4])) / int(es.sym_counts.sum())
    pos, reset = ST._pos_reset(ST._lane_lens(pre[4], W, dev), Sp, S, W)
    counts = ST._to(es.sym_counts, dev, torch.int32)
    args = (ST._payload_tensor(es.payload, dev),
            ST._to(es.lane_lens, dev, torch.int32), counts, pos, reset)
    m = torch.arange(Sp, device=dev)[:, None] < counts[None, :]
    out = {"read_len": L, "reads": reads, "steps": S, "share": share,
           "cluster": CT.decode_shape(geom, W).cluster}
    real = CT.may_cluster
    for what, cluster in (("cluster_ms", True), ("one_cta_ms", False)):
        CT.may_cluster = real if cluster else (lambda g, w: False)
        try:
            got = CT.lane_decode(*args, "seq", geom)
            if not torch.equal(got[m], item.syms[m]):
                raise AssertionError(f"{L}-base reads, {what}: D does not "
                                     "return the symbols")
            out[what] = _ms(lambda: CT.lane_decode(*args, "seq", geom), reps)
        finally:
            CT.may_cluster = real
    return out


if __name__ == "__main__":
    sys.exit(main())
