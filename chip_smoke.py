#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (slimfastq_tpu_torch) on one GPU.

Run from the root of a checkout on a machine with a CUDA card:

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught):
  1. the card's name and power limit, the torch/CUDA versions;
  2. build the CUDA kernels from csrc/ (one nvcc per source, in parallel);
  3. kernels: each of Kernel E (lane_encode: the decoupled encode, six
     phases, each also held against its own plain version slice by slice
     on whole outputs wherever E runs below, QUAL also in slices of
     1,000 bit-steps and the ragged windows in slices of 100), D
     (lane_decode) and C (compact_lanes_dev, one stream) against its plain
     PyTorch version on the card, byte for byte, at W = 1024, Sp = 256
     with the level-3 SEQ
     (all lanes at context 0 at every read start: the collision case,
     with 1,024 and with 700 active lanes, where the format's count field
     wraps) and QUAL geometries, at the aux width W = 64 with the byte and
     flag kinds (tables in shared memory), and with level 4's SEQ (order
     11, the match-context family: 1,024 and 700 flagged lanes on one
     entry) and QUAL (the q1-q2 delta); D's cluster form with 700
     colliding lanes spread over every CTA of its cluster (L3 SEQ, L4 SEQ
     with the match family, 100-base reads) and over 1,500-base reads;
     past 1,024 lanes (WIDE_CHECKS): E, C and D at W = 1,500, 2,048 and
     4,096 with 1,100 or every lane on one entry (the format's count
     field wraps), level 4's match family, and level 1's QUAL and the
     byte and flag kinds two or four lanes a thread; past 4,096 (D's loop
     form, E's touches over chunks) at W = 5,000, 8,192 and 65,536, every
     lane on one entry at a read start (at 65,536 D's 64-bit counters and
     E's 32-bit record fields), level 4's match family, level 1's QUAL
     and the byte and flag kinds with their tables in device memory;
     Kernel C's one launch over a
     ragged mix of streams (W of 8 to 1,024, counts above CB, an empty
     stream, rows longer than one shared-memory stage); then E and D
     timed with CUDA events on the main path's own inputs (the pinned 64k
     x 100 bp block's QUAL stream: W = 1024, Sp = 6400, NC = 800, where E's
     phases are also held against their plain versions, and the
     phases are timed one after another beside their byte and chain
     bounds (the sort also beside torch.sort); and its level-4 SEQ stream
     as the winning match trial codes it), where D's output is held
     against the packed symbols; Kernel L (lane_layout: pair mode, SEQ,
     QUAL, pos and reset in one launch; step-input mode, pos and reset)
     and Kernel U (lane_unpack) on the pinned block's own inputs
     against their plain versions (the tensor-op chains they replaced)
     on whole matrices, timed (profiler records; the wrappers with CUDA
     events) beside them and their byte bounds (the earlier design's
     recorded times on the earlier_ms line),
     L then U giving the block's qualities back; the raw block's upload
     from a pageable array and from a page-locked one (pinned_empty),
     and L reading that buffer straight through its mapping (held
     against the kernel); with the host's time for
     the level-4 matcher and trials; Kernel C's one launch over the pinned
     block's coded streams (7 at level 3, 11 at level 4, as encode_block
     hands them over; again with QUAL at the hard chunk size) against its
     plain version, its device time (profiler kernel records) and its
     wrapper-inclusive time (CUDA events) beside its byte bound and its
     32-byte-sector bound, at level 3 also on QUAL alone; the block's
     compaction-to-host phase (tools/compact_phase.py: from the join of
     the coder launches to the payloads on the host); and one 1,024-thread
     barrier timed, for D's bound (the larger of two such barriers a
     symbol-step, whatever shape D takes, and the lane coder's chain a
     bit-step, beside the lockstep order's one barrier a bit-step; E's is
     printed beside its byte bound), and the cluster barrier of 2, 4 and
     8 CTAs of 128 to 512 threads, which D's QUAL and SEQ lanes wait at
     where they run over a cluster (printed beside the bound as the
     design's cost);
  4. main path, level 3 then level 4: the pinned block through
     api.encode_fastq / decode_fastq on the card: container size and
     SHA-256 equal the JAX package's, the round trip is exact, every
     kernel's launch count moved, at level 3 exactly 1 L / 7 E / 1 C to
     encode (each of E's phases once a slice of each stream) and 1 L / 7
     D / 1 U to decode (at level 4 the block takes a
     match trial, one L launch a trial); at level 3 the block's seven E
     and seven D launches, on the
     main path's inputs, timed alone and launched at once through the main
     path's StreamSet (the block's coder span, first launch to join,
     beside the sum); at level 4 its E launches (with the trials' SEQ and
     MATCH) alone and in two orders, and each stream's D alone; the
     main path's device halves timed with CUDA events; then encode and
     decode wall time over 4 blocks of
     the same generator, at each level; the 4-block set at level 3
     encoded twice back to back on page-locked buffers the pool reuses,
     both containers equal to the set's container from the host-pack
     path (no pool), and no new buffer taken by the second; then lane
     counts past 1,024: the pinned block at lanes 2,048, 4,096, 5,000,
     8,192, 16,384 and 65,536 (L3; 2,048, 4,096 and 8,192 at L4) and
     aux_lanes 2,048, 4,096 and 8,192 (L3) through api.encode_fastq /
     decode_fastq on the card, each container's size and SHA-256 the JAX
     package's (PINNED_WIDE), exact round trips, E, C, D, L and U
     launched; and the W sweep: the level-3 block's seven E and D
     launches alone and at once at W = 1,024 to 65,536 (block_spans)
     beside the container's ratio and QUAL's D bound; then the header's
     other geometries (GEOMS: level 3 with QUAL at rate 7 / rate_lo 2,
     visit cap 16, SEQ at 14 / 1, cap 512, both in the kernels' 32-bit
     entries, and FLAG at 17 history bits, a depth-1 table in device
     memory): E, C and D against their plain versions at each (512 lanes
     and more on one entry; E's phases also over several slices), the
     pinned block through api.encode_fastq / decode_fastq at each with
     the JAX package's size and SHA-256 (PINNED_GEOM), exact round trips,
     E, C, L and D, U launched, and E's and D's QUAL and SEQ streams
     alone at level 3 (16-bit entries) and at the two warm-up geometries
     (32-bit), in turns.

  5. the small-block window path on the same 4-block set at
     block_records = 16,384 (the 4 blocks in one window): Kernels E and D over
     ragged windows (blocks of different step counts, one active lane,
     the L3 SEQ collision case, L4's match family) against their plain
     versions and against one launch a block, and Kernel C's window
     launch over 88 streams; the window's QUAL through E and D (and
     against their plain versions on the first 64 steps of each block)
     and its 28 streams through C timed on their own inputs, and its
     coder span against its blocks' spans; the window path through
     api.encode_fastq / decode_fastq at level 3 and 4 (the JAX package's
     SHA-256, exact round trips, one C launch a window, E and D once a
     stream group over several blocks; at L3 one 16k block's ratio
     6.2698, at L4 MATCH_USED); walls with the window and one block at a
     time; the window sweep, each window once ({1, 2, 4, 8} on 8 16k
     blocks at L3; on the 4 64k blocks {1, 2, 4} at L3, {1, 4} at L4); in
     a fresh process, the streaming encode (chunks that cut records), a
     resumed truncated copy and the streaming decode, with peak host RSS.
  6. long reads: one block of 65,536 x 16.5 kb reads (raw span past 2
     GiB) through api.encode_fastq / decode_fastq at the defaults: SEQ
     and QUAL packed and unpacked on the host, Kernel E once a stream;
     exact round trip, walls, peak device memory, launches, the block's
     device bytes against the window budget; the same block on a card
     held to a quarter of its memory fails with torch's OOM error and
     leaves no container; E over the long QUAL in one launch set, D on its
     payload, C on its chunk buffers and L's step
     inputs over the block (three times), timed beside their bounds, E
     held against its plain version on the first 2 chunks, L against its
     plain version;
     then the pinned block forced through the host-pack path keeps its
     SHA-256 at level 3 and level 4.
  7. block sharding (parallel.sharded) on make_mesh() (every card) and on
     a mesh naming cuda:0 twice (two shard threads): the pinned block
     keeps both SHA-256 pins; the 4 x 64k set at level 3 and 4 gives
     api.encode_fastq's container, its walls beside the single card's in
     turns, each shard's launches; the 16k set through the streaming
     sharded encode (with a resume) and decode; ragged_all_gather on
     NCCL (world size 1, a fresh process) carrying the 4 blocks' shard
     containers, merged into the whole container; level 1 (tables in
     shared memory) forced through the host-pack path equals the unforced
     container, one E launch a SEQ/QUAL stream, and E on its QUAL's first
     2 chunks equals its plain version.
  8. the host-side reference paths: the pinned block through the
     pure-Python pipeline (api.encode_fastq / decode_fastq with
     use_native=False: every stream's Kernels E and C, or D, launched one
     stream at a time) at level 3 and 4 keeps both SHA-256 pins and round
     trips, with each direction's launches, host wall and device time
     (torch.profiler); the level-3 block the same way through
     encode_fastq_sharded / decode_fastq_sharded(use_native=False) on
     make_mesh(); a 2,048-read input encoded on the card equals the NumPy
     oracle's container (backend="oracle"), whose encode and decode
     launch no kernel and allocate nothing on the card; and the
     single-stream pack_device / unpack_device (Kernels L and U in their
     single-stream modes) on the pinned block's QUAL (bias) and SEQ (map)
     held against pack_device_plain / unpack_device_plain on whole
     arrays and timed beside them and their byte bounds.
  9. the entry points (slimfastq_tpu_torch/entry.py): entry()'s flagship
     step (Kernel E on level-3 QUAL symbols, launched once) on
     the card equals its CPU run; dryrun_multichip over every card
     round-trips its toy, production (W = 1024 / 64) and level-4 phases.
 10. the streaming run at scale (tools/bench_1gb_torch.py): 0.5 GB of
     100 bp reads through the streaming CLI, encode and decode each in a
     fresh process, two 256 MiB read chunks: exact round trip, walls,
     GB/s, peak RSS above a CUDA-context base, ratio.
 11. the native matcher's faults, in a fresh process under a 120 s limit:
     2,048 reads of 16 bp, each a distinct 16-mer that the default mask
     samples (16 times the keys the matcher's index is first sized for),
     through api.encode_fastq(level=4) / decode_fastq on the card
     (Kernels E, C and D launched): the container equals the NumPy
     oracle's, the round trip is exact, and match_find's milliseconds
     are printed.

Prints `compact_block_l3`, `compact_block_l4`, `compact_phase_l3`,
`compact_phase_l4`, `block`, `block_l4`, `wall`, `pool_reuse`, `wall_l4`,
`block_w1024` ... `block_w65536`, `wide_lanes`, `block_geom_*`,
`geometries`,
`window_kernels`, `window_walls`, `window_sweep`, `streaming`,
`long_read`, `long_read_kernels`, `sharded`, `sharded_streaming`,
`gather_nccl`, `level1`, `python_pipeline`, `python_pipeline_s`,
`single_stream_pack`, `entry`, `streaming_scale`, `matcher_faults`,
`barrier_us`, `cluster_barrier_us`, `earlier_ms`
(recorded constants, Kernel E's lockstep design and Kernel D's one-CTA
design among them),
`phase_s` (seconds a phase) and `kernels` JSON lines, then the card's
name and power limit and, as its last line, the `ok` JSON line.
"""

from __future__ import annotations

import hashlib
import json
import signal
import subprocess
import sys
import time

# Pinned block (bench.py's shape): 65,536 reads x 100 bp, level 3 and
# level 4.
READS, READ_LEN = 65536, 100
# size and SHA-256 of the JAX package's container for the pinned block
# (its api.encode_fastq(data, level=level, backend=streams_jax), run on a
# CPU), by level
PINNED = {
    3: (2593846,
        "056cae0e9fd312106cae2a401155a533840c167a46ced960fad355c4471a3f6c"),
    4: (2072715,
        "31026796c476744a9da168b3b6132be07d3151b3c7020feeb8790e7a5322470f"),
}
WALL_BLOCKS = 4
# Lane counts past 1,024 (past coder_torch.REG_LANES = 4,096 D's loop form
# and E's touches over chunks; at 65,536 one read a lane, every lane on
# one entry at the first symbol-step): size and SHA-256 of the JAX
# package's container of the pinned block at (level, field, lanes) (its
# api.encode_fastq(data, level=level, backend=streams_jax, **{field:
# lanes}), run on a CPU)
PINNED_WIDE = {
    (3, "lanes", 2048): (
        2570589,
        "1e10d5fab136357c424554809663825add81a348b23d845095ff6af25dfcc01f"),
    (3, "lanes", 4096): (
        2965739,
        "3f888a82c1d4906b7b8ef94c2371e471fcc1c2872ad16a75a4da6947ad6f22af"),
    (3, "aux_lanes", 2048): (
        2884815,
        "ec56ffd8725797ddb2107f267545949c3429487fc4abab125c4b71a094e41907"),
    (3, "aux_lanes", 4096): (
        2962328,
        "e51bf8e4aefc70c6b286873118a665613a88b5aaa5199ea5459ef57dbbec57a3"),
    (4, "lanes", 2048): (
        2037527,
        "37c2dc85e3824ae9611c7c64b929f6a1097944adf40d2da55b3f418c13e669ab"),
    (4, "lanes", 4096): (
        2420294,
        "155f60ea74f6eae780be39f6469c26f6b047388f65be0183cab0762a4f4174c2"),
    (3, "lanes", 5000): (
        2810007,
        "8cd8c42383aaaab0efe0ce106010cb66d8b8fce57ae32eb278515c23fc1f64f0"),
    (3, "lanes", 8192): (
        3160580,
        "29955ea312d339f8f7cf1446a598dfc0e8fe7faad9c9b12f2bfd6b030c717c6f"),
    (3, "lanes", 16384): (
        4571045,
        "4e4d5c28596467838a144d28b22816146fe3b8188c4d44b1fbfe597212651037"),
    (3, "lanes", 65536): (
        6511387,
        "125ab7b85ace87b788f95236a8eaddb901f92dd466a7592192fc951fca985d7a"),
    (4, "lanes", 8192): (
        2616306,
        "bc7c407afb2b5a6885abb00aaa4b8ff28bbdd23a3e2184d3c5290350bc6a3991"),
    (3, "aux_lanes", 8192): (
        3046196,
        "61acad2da02a3fc317c05025335c9d4188877ab6c9538d09a6b49dabc045f212"),
}
# the W sweep of the wide_lanes phase: the pinned block at level 3
WIDE_SWEEP = (1024, 2048, 4096, 8192, 16384, 65536)
# Geometries the header names past the built-in levels': the pinned block
# at level 3 with one stream changed (the stream's config field and its
# changes): visit caps of 16 (QUAL rate 7, rate_lo 2) and 512 (SEQ 14 / 1,
# the most the law allows) in the kernels' 32-bit entries, and FLAG's 17
# history bits, a depth-1 table past shared memory that Kernel D keeps in
# device memory
GEOMS = {"qual_rate7_lo2": ("qual", {"rate": 7, "rate_lo": 2}),
         "seq_rate14_lo1": ("seq", {"rate": 14, "rate_lo": 1}),
         "flag_hist17": ("flags", {"hist_bits": 17})}
# size and SHA-256 of the JAX package's container of the pinned block at
# each geometry (its api.encode_fastq(data, cfg=cfg, backend=streams_jax)
# with the JAX package's level 3 changed alike, run on a CPU)
PINNED_GEOM = {
    "qual_rate7_lo2": (
        2459962,
        "5d7c0c3007546ffeaed575601454c969b016230467ed6ce60f11f09d62e13548"),
    "seq_rate14_lo1": (
        2577465,
        "2f58e4a7ce5df3374ef15a9f373903926559c63eeb68bcaa11d728395da3189b"),
    "flag_hist17": (
        2593974,
        "46024d7ec6cfee79598dd0e9bf3706b4ba80cee10d589641fa27237b9ba9664e"),
}
# Kernels E and D against their plain versions past 1,024 lanes: (level,
# kind, W, lanes on one entry at each read start; None: the byte and flag
# kinds' ragged lanes, every one on the root entry at step 0). 1,100 lanes
# read a count of 76, 4,096 of 0; W = 1,500 leaves the last CTA, warp and
# round ragged; level 1's QUAL and the byte and flag kinds keep their
# table in shared memory, two or four lanes a thread up to 4,096; past
# it D's loop form (their tables in device memory) and E's touches over
# chunks, at 65,536 lanes on one entry D's 64-bit counters and E's 32-bit
# record fields
WIDE_CHECKS = [(3, "seq", 1500, 1100), (3, "qual", 2048, 1100),
               (3, "seq", 4096, 4096), (4, "seq", 2048, 1100),
               (4, "qual", 4096, 1100), (1, "qual", 4096, 4096),
               (3, "byte", 2048, None), (3, "flag", 1500, None),
               (3, "byte", 4096, None),
               (3, "seq", 8192, 8192), (3, "qual", 5000, 4500),
               (4, "seq", 8192, 5000), (1, "qual", 8192, 8192),
               (3, "byte", 8192, None), (3, "flag", 5000, None),
               (3, "seq", 65536, 65536), (3, "qual", 65536, 65536)]
# The small-block window path: the same 4-block set (4 x 16,384 records,
# the generator above with 65,536 reads) at block_records = 16,384, coded
# in one window (the default takes all 4); size and SHA-256 of the JAX
# package's container
# (its api.encode_fastq(data, level=level, backend=streams_jax,
# block_records=16384), which runs its own window path, on a CPU)
WINDOW_RECORDS = 16384
PINNED_16K = {
    3: (2937850,
        "0ccf54fbb501fc7fbfa80b09f5abdaac2b1a7a5068977ae17949f58b0072e725"),
    4: (2510237,
        "f93ec9b2a88d24dd733003164590c83eb97f5564da7aa508dc3a427b9a4bfb9c"),
}
STREAM_CHUNK = 3_000_001  # ~12,500 records: chunks cut records and blocks
# The long-read block: 65,536 reads of 16.5 kb (an ordinary PacBio HiFi
# run's lengths), one 65,536-record block whose raw span passes 2 GiB
LONG_READS, LONG_LEN = 65536, 16500
HBM_BYTES_PER_S = 3.35e12  # H100 SXM published memory rate
# the host link of an H100 SXM card: PCIe 5.0 x16, 64 GB/s a direction
# (nominal)
PCIE_BYTES_PER_S = 64e9
# the NumPy oracle's input: the pinned generator's first 2,048 reads
ORACLE_READS = 2048
# the streaming run at scale: 0.5 GB of 100 bp reads, two 256 MiB chunks
STREAM_SCALE_BYTES = 500_000_000
# the native matcher's faults: reads of 16 bp, one sampled 16-mer each
FAULT_READS, FAULT_LIMIT_S = 2048, 120
# Recorded constants, printed on a line of their own (this script, H100
# 80GB HBM3, 700 W): each kernel's time at the timed shape before E and D
# moved their table law into shared memory, and Kernel C on QUAL alone
# when it took one launch per stream (CUDA events around the wrapper)
EARLIER_MS = {"before_smem_table_law": {"lane_encode": 142.01,
                                        "lane_decode": 136.97,
                                        "compact_lanes_dev": 0.0317},
              "one_launch_per_stream": {"compact_lanes_dev": 0.0325}}
# Kernels L and U before L's tiled design (L: one thread a lane and a run
# of 64 rows; their inputs in one pageable copy each), recorded by this
# script (H100 80GB HBM3, 700 W, the pinned 64k L3 block; the long block
# for its step inputs, two runs; ms): device time (profiler) and, where
# recorded, the wrapper's (CUDA events)
EARLIER_LANES_MS = {"pack": {"ms": 0.0702, "wrapper_ms": 0.591},
                 "steps": {"ms": 0.0427},
                 "unpack": {"ms": 0.0537, "wrapper_ms": 0.230},
                 "long_steps": {"ms": [9.63, 13.96]}}
# Kernel E before this design (the lockstep encode, two barriers a
# bit-step), recorded by this script (H100 80GB HBM3, 700 W; ms): the
# pinned 64k block's QUAL and its level-4 SEQ trial, the 16k window's QUAL,
# the long block's QUAL (CUDA events); its SEQ from the block's streams
# timed alone
EARLIER_E_MS = {"qual_64k": 56.27, "seq_64k": 45.0, "window_16k_qual": 14.97,
                "l4_seq_trial": 33.94, "long_qual": 10731.0}
# Kernel D before this design (in lockstep by bit-step: one barrier a
# bit-step, two for the flag kind and SEQ's device table, the hash in three
# buffers, SEQ over a cluster of 8 CTAs whatever its reads), recorded by
# this script (H100 80GB HBM3, 700 W; ms): the pinned 64k L3 block's streams
# each alone and their decode span, its level-4 SEQ trial, the 16k window's
# QUAL, the long block's QUAL (CUDA events)
EARLIER_D_MS = {"streams_64k": {"QUAL": 46.38, "SEQ": 39.49, "IDD": 27.08,
                                "LEN": 3.73, "FLAG": 1.74, "SEQX": 2.00,
                                "IDX": 0.62},
                "block_decode_span": 46.28, "l4_seq_trial": 31.97,
                "window_16k_qual": 12.23, "long_qual": 8607.0}
# the cluster barriers timed beside the CTA's: (CTAs, threads a CTA); 8
# of 1,024 threads: Kernel D's loop form past 4,096 lanes
CLUSTER_BARRIERS = [(2, 128), (2, 512), (4, 128), (4, 256), (8, 128),
                    (8, 256), (8, 512), (8, 1024)]
# one link of the decoupled encode's chains at its least latency: dependent
# integer operations of 4 cycles each at the H100 SXM's 1,980 MHz boost
# clock (an entry scan's record: the two deltas' shifts, the scaled sum,
# the clamp; a lane coder's decision: the split, the interval, the renorm
# test)
LINK_OPS = {"entry_scan": 12, "code": 10}
SM_CLOCK_HZ = 1.98e9
BARRIER_ITERS = 200000
# seconds any one phase of main() may take before the process ends
PHASE_LIMIT_S = 420


def d_bound(bit_steps: int, depth: int, bar_us: float, shape,
            cbar_us: dict) -> dict:
    """Kernel D's floor for one block's stream (ms): its symbol-steps, each
    two barriers of the card's fastest (`bar_us`, one CTA's: the card
    could run the function in one CTA whatever shape the design takes),
    against its bit-steps, each one decision of the lane coder's chain
    (E's lane coder runs the same arithmetic: LINK_OPS dependent
    operations at their least latency), whichever is larger; beside it
    the lockstep order's floor on the same barrier, one a bit-step, and
    what the barriers of the design's `shape` cost (its cluster's, timed
    in cluster_barrier_us, where it spans one)."""
    sync_ms = bit_steps // depth * 2 * bar_us / 1e3
    chain_ms = bit_steps * LINK_OPS["code"] * 4 / SM_CLOCK_HZ * 1e3
    key = f"{shape.cluster}x{shape.threads}"
    # the loop form's CTAs of fewer than 1,024 threads: the timed 8 x 1,024
    design_us = (bar_us if shape.cluster == 1 else cbar_us.get(
        key, cbar_us[f"{shape.cluster}x1024"]))
    return {"bound_ms": max(sync_ms, chain_ms),
            "bound_by": "operations" if chain_ms >= sync_ms else "latency",
            "symbol_step_barriers_ms": sync_ms, "decision_chain_ms": chain_ms,
            "lockstep_bound_ms": bit_steps * bar_us / 1e3,
            "design_barrier_us": design_us,
            "design_barriers_ms": bit_steps // depth * 2 * design_us / 1e3}
# The window forms' plain versions run on the first PLAIN_CHUNKS chunks of
# CHUNK_STEPS symbol steps of each block of the 16k window
CHUNK_STEPS, PLAIN_CHUNKS = 8, 8


def _kernel_name(line: str) -> str:
    """A kernel's name and template arguments from ptxas's mangled one,
    e.g. lane_decode_kernel<1,0,1,0,4,u16>."""
    import re
    m = re.search(r"\d([a-z_]+_kernel)(I(?:L[bi]\d+E|[tj])+E)?", line)
    if m is None:
        return line.split()[-1]
    args = [a or {"t": "u16", "j": "u32"}[t] for a, t in re.findall(
        r"L[bi](\d+)E|([tj])", m.group(2) or "")]
    return m.group(1) + (f"<{','.join(args)}>" if args else "")


def _pinned(reads: int) -> bytes:
    from slimfastq_tpu_torch.utils.synth import synth_fastq
    return synth_fastq(reads, read_len=READ_LEN, seed=0, var_len=False,
                       n_rate=0.0005)


def _time_ms(fn, reps: int) -> float:
    """Mean device time of one call, CUDA events around `reps` calls after
    one warm-up call."""
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


def _compare(errs: dict, name: str, what: str, a, b) -> None:
    """Kernel output(s) `a` against the plain version's `b`: records the
    largest absolute difference under `name` and fails unless it is 0."""
    if isinstance(a, (tuple, list)):
        for x, y in zip(a, b):
            _compare(errs, name, what, x, y)
        return
    if a.shape != b.shape:
        raise AssertionError(f"{what}: shapes {a.shape} != {b.shape}")
    err = int((a.long() - b.long()).abs().max()) if a.numel() else 0
    errs[name] = max(errs.get(name, 0), err)
    if err:
        raise AssertionError(f"{what}: kernel and plain version differ "
                             f"(max abs error {err})")


# ---------------------------------------------------------------------------
# phase 3a: kernels against their plain versions at the reduced shape
# ---------------------------------------------------------------------------

def _phases_vs_plain(errs: dict, items, kind, geom, CB, what: str,
                     plain_s: dict | None = None, L=None) -> None:
    """Each of Kernel E's phase kernels against its plain version on the
    card, slice by slice, on whole outputs (encode_torch.compare_phases;
    L: slices of L bit-steps in place of the default, through
    SLICE_DECISIONS); records each phase's largest difference in `errs`
    as encode_<phase> and adds the plain versions' host seconds to
    `plain_s`."""
    from slimfastq_tpu_torch.ops import coder_torch as CT
    from slimfastq_tpu_torch.ops import encode_torch as E
    W, items = CT._check_items(items, kind, geom)
    items = [CT.EncIn(*(None if x is None else x.contiguous() for x in it))
             for it in items]
    saved = E.SLICE_DECISIONS
    if L is not None:
        E.SLICE_DECISIONS = L * len(items) * W
    try:
        got = E.compare_phases(items, kind, geom, CB, plain_s)
    finally:
        E.SLICE_DECISIONS = saved
    for name, err in got.items():
        key = f"encode_{name}"
        errs[key] = max(errs.get(key, 0), err)
    if any(got.values()):
        raise AssertionError(f"{what}: a phase differs from its plain "
                             f"version: {got}")


def _head(item, steps: int):
    """The first `steps` symbol-steps of an EncIn (a prefix codes exactly
    as the stream's start)."""
    from slimfastq_tpu_torch.ops import coder_torch as CT
    return CT.EncIn(*(None if x is None else x[:steps]
                      for x in item[:3]), item.counts,
                    None if item.mflag is None else item.mflag[:steps])


def phase_times(items, kind, geom, CB, errs: dict | None = None) -> dict:
    """Kernel E's phases on `items` one after another (CUDA events around
    each phase's launches, summed over the slices) beside each one's byte
    bound at HBM_BYTES_PER_S and, for the chains, the longest chain's
    links at their least latency (LINK_OPS); the sort also beside one
    torch.sort of each slice's keys (library_ms, stable). Then the same
    items through lane_encode_blocks (the lane coder beside the next
    slice's phases), timed as `e_ms`, which must equal the phases'
    outputs."""
    import torch
    from slimfastq_tpu_torch.ops import coder_torch as CT
    from slimfastq_tpu_torch.ops import encode_torch as E
    es = E.EncodeSet(items, kind, geom, CB)
    ms = dict.fromkeys((n for n, _, _ in E.STEPS), 0.0)
    lib_ms, chains, records = 0.0, {"entry_scan": 0, "code": 0}, 0
    for s0 in range(0, es.S, es.L):
        for name, fn, sliced in E.STEPS:
            t, _ = _events_ms(lambda: fn(es, s0) if sliced else fn(es))
            ms[name] += t
            if name == "sort":  # the slice's longest chain of records
                N = es.records()
                records += N
                K = es.sorted_records()[0][:N]
                if N:
                    chains["entry_scan"] += int(torch.unique_consecutive(
                        K, return_counts=True)[1].max())
                # the library's yardstick: a stable sort of the same keys
                lib_ms += _events_ms(lambda: torch.sort(
                    es.key[:N] if K.data_ptr() != es.key.data_ptr()
                    else K.clone(), stable=True))[0]
    chains["code"] = es.S
    res = es.results()
    e_ms, got = _events_ms(lambda: CT.lane_encode_blocks(items, kind, geom,
                                                         CB))
    for a, b in zip(got, res):
        _compare({} if errs is None else errs, "lane_encode",
                 "E launched whole vs phase by phase", a, b)
    # each input read once, each output written once: a symbol-step's u8
    # symbol, int32 pos and reset and u8 match flag where the stream has
    # them, its int32 row; a decision's u16 rid, then its u16 p | bit; a
    # record's int32 key and n | k (and its sorted key, number and p)
    syms = sum(it.syms.numel() for it in items)
    per = 1 + 8 * (items[0].pos is not None) + (items[0].mflag is not None)
    D = syms * geom.depth
    out_bytes = sum(r[0].numel() + r[1].numel() * 4 + r[2].numel() * 4
                    for r in res)
    nbytes = {"rows": syms * (per + 4),
              "touches": syms * 5 + D * 2 + records * 8,
              "sort": records * 12,
              "entry_scan": records * 16,
              "gather": D * 8 + syms,
              "code": D * 2 + out_bytes}
    link_s = {k: v * 4 / SM_CLOCK_HZ for k, v in LINK_OPS.items()}
    out = {"e_ms": e_ms, "slices": -(-es.S // es.L),
           "slice_bit_steps": es.L, "records": records, "decisions": D,
           "phases": {}}
    for name in ms:
        row = {"ms": ms[name], "bytes": nbytes[name],
               "bound_ms": nbytes[name] / HBM_BYTES_PER_S * 1e3,
               "bound_by": "bytes"}
        if name in chains:
            row["chain_links"] = chains[name]
            row["chain_bound_ms"] = chains[name] * link_s[name] * 1e3
        if name == "sort":
            row["library_ms"] = lib_ms
            row["library"] = "torch.sort(keys, stable=True) a slice"
        out["phases"][name] = row
    return out


# Kernel E's phases' launch counts (one a slice of a launch set)
E_PHASES = ("encode_rows", "encode_touches", "encode_sort",
            "encode_entry_scan", "encode_gather", "encode_code")


def phase_counts(data: bytes, level: int, dev) -> dict:
    """Launches of each of Kernel E's phases when the block's streams are
    coded one launch set a stream (the main path at level 3, the
    pure-Python pipeline): each stream's slices."""
    import numpy as np
    from slimfastq_tpu_torch import native, pipeline_native as PN
    from slimfastq_tpu_torch.config import config_for_level
    from slimfastq_tpu_torch.ops import encode_torch as E
    cfg = config_for_level(level)
    idx, n = native.fastq_index(data)
    pre = PN.prepare_block_fast(np.frombuffer(data, dtype=np.uint8), idx, 0,
                                n, cfg)
    slices = 0
    for _name, _kind, geom, item, _ in PN._coder_jobs(pre, cfg, dev):
        slices += E.set_slices([item], geom.depth)
    return dict.fromkeys(E_PHASES, slices)


def _reads_layout(W: int, Sp: int, read_len: int, active):
    """The first `active` lanes (or the lanes of the array `active`) hold
    reads of `read_len` starting at step 0, the others none: at each read
    start the active lanes share one context (the collision case)."""
    import numpy as np
    ll = np.zeros((Sp // read_len, W), dtype=np.int64)
    ll[:, np.arange(active) if np.isscalar(active) else active] = read_len
    return ll, ll.sum(axis=0)


def _match_layout(syms, pos, counts):
    """(e-letter symbols, mflag [Sp, W] u8) of a level-4 SEQ trial: every
    active lane flagged over read positions [20, 90), its symbols there
    mostly 0 (e-transform letters) and all 0 at positions 18-23, so at the
    span's first steps every active lane shares one match-family entry."""
    import numpy as np
    rng = np.random.default_rng(9)
    p = pos.cpu().numpy()
    span = (p >= 20) & (p < 90) & (np.arange(p.shape[0])[:, None]
                                   < counts[None, :])
    e = np.where(rng.random(syms.shape) < 0.9, 0, syms)
    out = np.where(span, e, syms).astype(np.uint8)
    out[(p >= 18) & (p < 24)] = 0
    return out, span.astype(np.uint8)


def _check_stream(kind, geom, syms_np, counts_np, pos, reset, dev, plain,
                  errs, mflag_np=None):
    """E, C and D on the card against their plain versions for one stream
    (mflag_np: a level-4 SEQ stream's match-span flags). Records the plain
    versions' times (ms) at this shape in `plain` and each kernel's
    largest difference in `errs`."""
    import numpy as np
    import torch
    from slimfastq_tpu_torch.ops import coder_torch, compact_torch
    from slimfastq_tpu_torch.ops import streams_torch as ST
    Sp, W = syms_np.shape
    syms = torch.from_numpy(syms_np.astype(np.uint8)).to(dev)
    counts = torch.from_numpy(counts_np.astype(np.int32)).to(dev)
    mflag = None if mflag_np is None else torch.from_numpy(mflag_np).to(dev)
    item = coder_torch.EncIn(syms, pos, reset, counts, mflag)
    CB = ST._chunk_bytes(geom.depth, hard=False)
    enc_k = coder_torch.lane_encode_blocks([item], kind, geom, CB)[0]
    torch.cuda.synchronize()
    t = time.perf_counter()
    enc_p = coder_torch.lane_encode_blocks_plain([item], kind, geom, CB)[0]
    torch.cuda.synchronize()
    plain["lane_encode"] = (time.perf_counter() - t) * 1e3
    _compare(errs, "lane_encode", f"lane_encode {kind} W={W}", enc_k,
             enc_p)
    phase_s = {}
    _phases_vs_plain(errs, [item], kind, geom, CB, f"E's phases, {kind} "
                     f"W={W}", phase_s)
    for name, s in phase_s.items():
        plain[f"encode_{name}"] = s * 1e3
    ebufs, eptrs, low, emax = enc_k
    if int(emax) > CB:
        raise AssertionError(f"{kind}: optimistic chunk buffer overflowed")
    Bmax = max(int(eptrs.sum(dim=0).max()), 1)
    com_k = compact_torch.compact_lanes_dev(ebufs, eptrs, Bmax)
    torch.cuda.synchronize()
    t = time.perf_counter()
    com_p = compact_torch.compact_lanes_plain(ebufs, eptrs, Bmax)
    torch.cuda.synchronize()
    plain["compact_lanes_dev"] = (time.perf_counter() - t) * 1e3
    _compare(errs, "compact_lanes_dev", f"compact {kind} W={W}", com_k,
             com_p)
    pay, lens = ST._flush_append(com_k[0].cpu().numpy(),
                                 com_k[1].cpu().numpy().astype(np.int64),
                                 low.cpu().numpy().view(np.uint32),
                                 counts_np)
    args = (torch.from_numpy(pay).to(dev),
            torch.from_numpy(lens.astype(np.int32)).to(dev), counts, pos,
            reset)
    dec_k = coder_torch.lane_decode(*args, kind, geom, mflag)
    torch.cuda.synchronize()
    t = time.perf_counter()
    dec_p = coder_torch.lane_decode_plain(*args, kind, geom, mflag)
    torch.cuda.synchronize()
    plain["lane_decode"] = (time.perf_counter() - t) * 1e3
    _compare(errs, "lane_decode", f"lane_decode {kind} W={W}", dec_k,
             dec_p)
    mask = np.arange(Sp)[:, None] < counts_np[None, :]
    if not np.array_equal(dec_k.cpu().numpy()[mask],
                          syms_np.astype(np.uint8)[mask]):
        raise AssertionError(f"{kind}: decode does not invert encode")


def check_kernels(dev):
    """All four coder kinds, and level 4's SEQ with the match-context
    family and QUAL with the q1-q2 delta. Returns the plain versions' times
    in the QUAL case (the longest chain) at W = 1024, Sp = 256 and each
    kernel's largest absolute difference from its plain version, then the
    same at level 4 (times in the 1,024-lane SEQ case)."""
    import numpy as np
    import torch
    from slimfastq_tpu_torch.config import config_for_level
    from slimfastq_tpu_torch.ops import coder_torch as CT
    from slimfastq_tpu_torch.ops import streams_torch as ST
    cfg = config_for_level(3)
    rng = np.random.default_rng(7)
    Sp, W = 256, 1024
    seq = rng.integers(0, 4, size=(Sp, W)).astype(np.uint8)
    steps = rng.integers(-2, 3, size=(Sp, W))
    qual = np.clip(30 + np.cumsum(steps, axis=0), 0, 41).astype(np.uint8)
    plain_qual, errs = {}, {}
    # 700 lanes on one entry read a negative count, 1,024 a count of 0
    for active in (700, W):
        ll, counts = _reads_layout(W, Sp, READ_LEN, active)
        pos, reset = ST._pos_reset(torch.from_numpy(ll).to(dev), Sp,
                                   int(counts.max()), W)
        _check_stream("seq", cfg.seq, seq, counts, pos, reset, dev, {},
                      errs)
    _check_stream("qual", cfg.qual, qual, counts, pos, reset, dev,
                  plain_qual, errs)
    # Kernel D's cluster form (SEQ, 100-base reads): 700 colliding lanes
    # spread over every CTA of the cluster, the count each reads being the
    # whole cluster's
    spread = np.sort(np.random.default_rng(8).choice(W, 700, replace=False))
    ll_s, counts_s = _reads_layout(W, Sp, READ_LEN, spread)
    pos_s, reset_s = ST._pos_reset(torch.from_numpy(ll_s).to(dev), Sp,
                                   int(counts_s.max()), W)
    for geom in (cfg.seq, config_for_level(4).seq):
        shape = CT.decode_shape(geom, W, 1)
        if shape.cluster < 2 or len(set(spread // shape.threads)) \
                != shape.cluster:
            raise AssertionError(f"the spread lanes do not cover the "
                                 f"cluster of {shape}")
    _check_stream("seq", cfg.seq, seq, counts_s, pos_s, reset_s, dev, {},
                  errs)
    # SEQ of long reads over the cluster too: 1,500-base reads
    S_long = 3000
    ll_l, counts_l = _reads_layout(W, S_long, 1500, W)
    pos_l, reset_l = ST._pos_reset(torch.from_numpy(ll_l).to(dev), S_long,
                                   int(counts_l.max()), W)
    _check_stream("seq", cfg.seq, np.random.default_rng(10).integers(
        0, 4, size=(S_long, W)).astype(np.uint8), counts_l, pos_l, reset_l,
        dev, {}, errs)
    # slices of 1,000 bit-steps: each ends inside a symbol and a chunk
    item = ST.EncIn(torch.from_numpy(qual).to(dev), pos, reset,
                    torch.from_numpy(counts.astype(np.int32)).to(dev))
    _phases_vs_plain(errs, [item], "qual", cfg.qual,
                     ST._chunk_bytes(6, hard=False), "E's phases, qual in "
                     "slices of 1,000 bit-steps", L=1000)
    Wa = cfg.aux_lanes
    zeros = torch.zeros((Sp, Wa), dtype=torch.int32, device=dev)
    ragged = rng.integers(Sp // 2, Sp + 1, size=Wa)
    _check_stream("byte", cfg.bytes_,
                  rng.integers(0, 256, size=(Sp, Wa)).astype(np.uint8),
                  ragged, zeros, zeros, dev, {}, errs)
    _check_stream("flag", cfg.flags,
                  rng.integers(0, 2, size=(Sp, Wa)).astype(np.uint8),
                  ragged, zeros, zeros, dev, {}, errs)
    cfg4, errs4, plain_seq4 = config_for_level(4), {}, {}
    for active in (700, W):  # every active lane flagged on one entry
        ll, counts = _reads_layout(W, Sp, READ_LEN, active)
        pos, reset = ST._pos_reset(torch.from_numpy(ll).to(dev), Sp,
                                   int(counts.max()), W)
        e_syms, mflag = _match_layout(seq, pos, counts)
        _check_stream("seq", cfg4.seq, e_syms, counts, pos, reset, dev,
                      plain_seq4, errs4, mflag)
    _check_stream("qual", cfg4.qual, qual, counts, pos, reset, dev, {},
                  errs4)
    e_syms, mflag = _match_layout(seq, pos_s, counts_s)
    _check_stream("seq", cfg4.seq, e_syms, counts_s, pos_s, reset_s, dev,
                  {}, errs4, mflag)
    print(f"kernels match their plain versions: seq (1,024 and 700 "
          f"colliding lanes)/qual at W={W} Sp={Sp}, byte/flag at W={Wa} "
          f"Sp={Sp}; level 4: seq with the match family (1,024 and 700 "
          f"flagged lanes on one entry), qual with the q1-q2 delta; D's "
          f"cluster form with 700 colliding lanes spread over its "
          f"{CT.decode_shape(cfg.seq, W, 1).cluster} CTAs (L3 seq, "
          f"L4 seq with "
          f"the match family); SEQ of 1,500-base reads",
          flush=True)
    check_wide(dev, errs, errs4)
    return plain_qual, errs, plain_seq4, errs4


def check_wide(dev, errs: dict, errs4: dict) -> None:
    """E, C and D against their plain versions past 1,024 lanes
    (WIDE_CHECKS), Sp = 256: more than 1,024 lanes on one entry, where the
    format's count field wraps (the law reads n mod 1024), at W 1,500,
    2,048 and 4,096; level 4's SEQ with every active lane flagged."""
    import numpy as np
    import torch
    from slimfastq_tpu_torch.config import config_for_level
    from slimfastq_tpu_torch.ops import coder_torch as CT
    from slimfastq_tpu_torch.ops import streams_torch as ST
    Sp, ran = 256, []
    for level, kind, W, active in WIDE_CHECKS:
        cfg = config_for_level(level)
        geom = {"seq": cfg.seq, "qual": cfg.qual, "byte": cfg.bytes_,
                "flag": cfg.flags}[kind]
        rng = np.random.default_rng(W + level)
        mflag = None
        if active is None:
            counts = rng.integers(Sp // 2, Sp + 1, size=W)
            syms = rng.integers(0, 256 if kind == "byte" else 2, size=(Sp, W))
            pos = reset = torch.zeros((Sp, W), dtype=torch.int32, device=dev)
        else:
            ll, counts = _reads_layout(W, Sp, READ_LEN, active)
            pos, reset = ST._pos_reset(torch.from_numpy(ll).to(dev), Sp,
                                       int(counts.max()), W)
            if kind == "seq":
                syms = rng.integers(0, 4, size=(Sp, W))
            else:
                syms = np.clip(30 + np.cumsum(rng.integers(-2, 3, (Sp, W)),
                                              axis=0), 0, 41)
            if level == 4 and kind == "seq":
                syms, mflag = _match_layout(syms, pos, counts)
        _check_stream(kind, geom, syms.astype(np.uint8), counts, pos, reset,
                      dev, {}, errs4 if level == 4 else errs, mflag)
        shape = CT.decode_shape(geom, W)
        ran.append(f"L{level} {kind} W={W} ({active or W} lanes on one "
                     f"entry; D {shape.cluster} x {shape.threads} threads x "
                     f"{CT.lanes_per_thread(shape, W)} lanes)")
    print("kernels match their plain versions past 1,024 lanes: "
          + "; ".join(ran), flush=True)


# ---------------------------------------------------------------------------
# phase 3b: kernel times on the main path's own inputs
# ---------------------------------------------------------------------------

def time_kernels(data: bytes, dev, errs: dict) -> dict:
    """Device times (ms) and byte bounds of E, D, L and U on the pinned
    block's own inputs (pipeline_native.prepare_block_fast,
    streams_torch.seq_qual_jobs): E and D on its QUAL stream (the longest
    serial chain of the block), E's phases held against their plain
    versions at this full shape (`errs`; their host times recorded); Kernel
    L's pack mode (SEQ, QUAL, pos, reset) and step-input mode (pos,
    reset) and Kernel U (both streams back to their record-major
    bytes) held against their plain versions and timed beside them (the
    tensor-op chains the kernels replace, on the card). At this size C
    (one stream) is also held against its plain version and D's output
    against the packed QUAL symbols."""
    import numpy as np
    import torch
    from slimfastq_tpu_torch import native
    from slimfastq_tpu_torch.config import config_for_level
    from slimfastq_tpu_torch.ops import coder_torch, compact_torch
    from slimfastq_tpu_torch.ops import streams_torch as ST
    from slimfastq_tpu_torch.pipeline_native import (prepare_block_fast,
                                                     seq_qual_args)
    cfg = config_for_level(3)
    idx, n = native.fastq_index(data)
    pre = prepare_block_fast(np.frombuffer(data, dtype=np.uint8), idx, 0, n,
                             cfg)
    args = seq_qual_args(pre, cfg)
    q = next(j for j in ST.seq_qual_jobs(*args, dev) if j.name == "QUAL")
    Sp, W = q.syms.shape
    NC, KD = q.item.NC, 8 * q.geom.depth
    out = {"shape": {"W": W, "Sp": Sp, "NC": NC, "depth": q.geom.depth},
           "bit_steps": NC * KD}
    CB = ST._chunk_bytes(q.geom.depth, hard=False)

    def enc():
        return coder_torch.lane_encode_blocks([q.item], "qual", q.geom, CB)[0]
    ebufs, eptrs, low, emax = enc()
    if int(emax) > CB:
        raise AssertionError("QUAL: optimistic chunk buffer overflowed")
    phase_s = {}
    _phases_vs_plain(errs, [q.item], "qual", q.geom, CB, "E's phases at the "
                     f"pinned block's QUAL (Sp={Sp}, W={W})", phase_s)
    out["phase_plain_ms"] = {k: v * 1e3 for k, v in phase_s.items()}
    out["phases"] = phase_times([q.item], "qual", q.geom, CB, errs)
    e_ms = _time_ms(enc, 3)
    e_bytes = 9 * Sp * W + W * 4 + ebufs.numel() + eptrs.numel() * 4 \
        + W * 4
    totals = eptrs.sum(dim=0)
    Bmax = int(totals.max())
    com_k = compact_torch.compact_lanes_dev(ebufs, eptrs, Bmax)
    _compare(errs, "compact_lanes_dev", f"compact qual NC={NC} W={W}", com_k,
             compact_torch.compact_lanes_plain(ebufs, eptrs, Bmax))
    pay, lens = ST._flush_append(com_k[0].cpu().numpy(),
                                 totals.cpu().numpy().astype(np.int64),
                                 low.cpu().numpy().view(np.uint32),
                                 q.counts.cpu().numpy())
    dargs = (torch.from_numpy(pay).to(dev),
             torch.from_numpy(lens.astype(np.int32)).to(dev), q.counts,
             q.pos, q.reset)
    dec = coder_torch.lane_decode(*dargs, "qual", q.geom)
    mask = torch.arange(Sp, device=dev)[:, None] < q.counts[None, :]
    if not torch.equal(dec[mask], q.syms[mask]):
        raise AssertionError("lane_decode of the pinned block's QUAL stream "
                             "does not return its packed symbols")
    d_ms = _time_ms(lambda: coder_torch.lane_decode(*dargs, "qual", q.geom),
                    3)
    d_bytes = pay.size + 2 * W * 4 + 2 * Sp * W * 4 + Sp * W
    out["lane_encode"] = (e_ms, e_bytes)
    out["lane_decode"] = (d_ms, d_bytes)
    out.update(lanes(args, dev, errs))
    print(f"kernels at the main path's shape: E's phases equal their plain "
          f"versions, compact "
          f"equals its plain version (NC={NC}, W={W}), decode returns the "
          f"packed QUAL symbols; L (pack and step inputs) and U equal their "
          f"plain versions", flush=True)
    return out


def lanes(args, dev, errs: dict) -> dict:
    """Kernel L (pair mode, step-input mode) and Kernel U on a block's own
    inputs (seq_qual_args), each against its plain version (whole
    matrices: L's rows past a lane's count hold the clamped gather's
    bytes in both) and timed: device time from profiler records, the
    wrapper's (its staged upload of offsets, lengths and map, its
    allocations and the launch) with CUDA events around 20 calls, beside
    the plain version (the tensor-op chain the kernel replaced, events),
    with the earlier design's recorded times printed beside them (not
    returned); U's QUAL bytes must be the block's qualities. Also the
    block's raw bytes to the card: from a pageable array and from a
    page-locked one of pinned_empty (events), and L reading them straight
    from that mapped buffer, with no device copy.
    Bytes: what the function must move (the records' bases and
    qualities; offsets and lengths as int32 [Rpl, W], the map; the rows
    out), at 3.35 TB/s."""
    import numpy as np
    import torch
    from slimfastq_tpu_torch.ops import pack_torch as PT
    from slimfastq_tpu_torch.ops import streams_torch as ST
    from slimfastq_tpu_torch.ops.ranger import pad_steps
    from slimfastq_tpu_torch.pipeline_native import _CODE_TO_BASE_FULL
    (_, _, dpad, soffs, qoffs, lengths, W, seq_map, minq, ll_mat,
     counts) = args
    n, total = len(lengths), int(lengths.sum())
    S = int(counts.max())
    Sp = pad_steps(S)
    d = ST._to(dpad, dev)

    def pack():
        return PT.lane_layout(d, soffs, qoffs, lengths, ll_mat, W, Sp, S,
                              seq_map, minq)

    def pack_plain():
        return (*PT.pack_pair_plain(d, soffs, qoffs, lengths, W, Sp,
                                    seq_map, minq),
                *PT._pos_reset(ST._lane_lens(ll_mat, W, dev), Sp, S, W))
    k, p = pack(), pack_plain()
    _compare(errs, "lane_layout", "L pair mode vs plain (whole matrices)",
             k, p)
    del p

    def steps():
        return PT.step_inputs(ll_mat, Sp, S, W, dev)

    def steps_plain():
        return PT._pos_reset(ST._lane_lens(ll_mat, W, dev), Sp, S, W)
    _compare(errs, "lane_layout", "L step-input mode vs plain", steps(),
             steps_plain())
    starts = np.zeros(n, dtype=np.int64)
    starts[1:] = np.cumsum(lengths[:-1])

    def unpack():
        return PT.unpack_pair(k[0], k[1], starts, lengths, W, total,
                              _CODE_TO_BASE_FULL, minq)

    def unpack_plain():
        return PT.unpack_pair_plain(k[0], k[1], starts, lengths, W, total,
                                    _CODE_TO_BASE_FULL, minq)
    u = unpack()
    _compare(errs, "lane_unpack", "U vs plain", u,
             [x[:total] for x in unpack_plain()])
    want_q = np.concatenate([dpad[o: o + L] for o, L in zip(qoffs, lengths)])
    if not np.array_equal(u[1].cpu().numpy(), want_q):
        raise AssertionError("L then U does not give the block's qualities")
    # the raw block's ways to the card
    host = PT.pinned_empty(len(dpad))
    host[:] = dpad
    hpin = torch.from_numpy(host)
    mapped = lambda: PT._layout(  # noqa: E731
        PT._PAIR, dev, Sp, S, W, ll_mat, hpin, (soffs, qoffs), seq_map, minq)
    _compare(errs, "lane_layout", "L reading the mapped page-locked block",
             mapped(), k)
    upload = {
        "bytes": len(dpad),
        "pageable_ms": _time_ms(lambda: torch.from_numpy(dpad).to(dev), 20),
        "pinned_ms": _time_ms(lambda: PT.upload(host, dev), 20),
        "pcie_bound_ms": len(dpad) / PCIE_BYTES_PER_S * 1e3,
        "mapped_read_pair_ms": _device_ms(mapped, 20, "lane_layout_kernel"),
        "note": "L in pair mode reading the raw bytes straight from the "
                "page-locked host buffer (no device copy), beside the "
                "pinned upload plus L from device memory"}
    del host, hpin
    nrec = ll_mat.size  # Rpl * W: every int32 input's entries
    nbytes = {"pack": 2 * total + 12 * nrec + 256 + 10 * Sp * W,
              "steps": 4 * nrec + 8 * Sp * W,
              "unpack": 2 * total + 8 * n + 256 + 2 * total}
    out = {}
    for f, fn, fp, key in (
            ("pack", pack, pack_plain, "lane_layout_kernel"),
            ("steps", steps, steps_plain, "lane_layout_kernel"),
            ("unpack", unpack, unpack_plain, "lane_unpack_kernel")):
        out[f] = {"ms": _device_ms(fn, 20, key),
                  "wrapper_ms": _time_ms(fn, 20),
                  "plain_ms": _time_ms(fp, 3), "bytes": nbytes[f],
                  "bound_ms": nbytes[f] / HBM_BYTES_PER_S * 1e3,
                  "bound_by": "bytes"}
        print(f"Kernel {'U' if f == 'unpack' else 'L'} {f}: device "
              f"{out[f]['ms']:.4f} ms, wrapper {out[f]['wrapper_ms']:.4f} "
              f"ms, bound {out[f]['bound_ms']:.4f} ms; before the tiled "
              f"design (recorded, not measured in this run): "
              f"{json.dumps(EARLIER_LANES_MS[f])}", flush=True)
    return {"lane_layout": {**out["pack"], "step_inputs": out["steps"],
                            "raw_upload": upload},
            "lane_unpack": out["unpack"]}


def time_kernels_l4(data: bytes, dev, errs4: dict) -> dict:
    """Device times (ms) and byte bounds of E and D on the pinned
    block's level-4 SEQ stream as the block codes it: the winning match
    trial's e-letters and flags, the order-11 table (pipeline_native's own
    setup). Also the host's share of a level-4 block: the matcher and the
    trials' rewritten copies (host clock). D's output is held against the
    packed trial symbols, C (one stream) against its plain version
    (`errs4`)."""
    import numpy as np
    import torch
    from slimfastq_tpu_torch import native
    from slimfastq_tpu_torch import pipeline_native as PN
    from slimfastq_tpu_torch.config import config_for_level
    from slimfastq_tpu_torch.models import matcher as M
    from slimfastq_tpu_torch.ops import coder_torch, compact_torch
    from slimfastq_tpu_torch.ops import streams_torch as ST
    from slimfastq_tpu_torch.pipeline import MATCH_USED
    cfg = config_for_level(4)
    idx, n = native.fastq_index(data)
    buf = np.frombuffer(data, dtype=np.uint8)
    host = {}
    t = time.perf_counter()
    PN.prepare_block_fast(buf, idx, 0, n, config_for_level(3))
    host["prep_l3_ms"] = (time.perf_counter() - t) * 1e3
    t = time.perf_counter()
    pre = PN.prepare_block_fast(buf, idx, 0, n, cfg)
    host["prep_l4_ms"] = (time.perf_counter() - t) * 1e3
    lengths = idx["seq_len"].astype(np.int64)
    t = time.perf_counter()
    matches = native.match_find_arrays(buf, idx["seq_off"], lengths,
                                       min(M.THRESHOLDS))
    host["match_find_ms"] = (time.perf_counter() - t) * 1e3
    t = time.perf_counter()
    trials = PN._match_trials(matches, pre[5], cfg.lanes, cfg.aux_lanes,
                              int(pre[4].sum(0).max()))
    host["trials_ms"] = (time.perf_counter() - t) * 1e3
    host["trials"] = [tr[0] for tr in trials]
    blk = PN.encode_prepared_block(pre, cfg, dev)
    if not blk.flags & MATCH_USED:
        raise AssertionError("the pinned level-4 block takes no match trial")
    # the trial the block kept: its SEQ bytes are the block's
    for t_, alt, _, _, mflag in pre[6]["trials"]:
        job = next(ST.seq_qual_jobs(*PN.seq_qual_args(pre, cfg, alt), dev,
                                    mflag, ("SEQ",)))
        pay, _ = ST.encode_block([("SEQ", "seq", job.geom, job.item,
                                   pre[0]["SEQ"][3])], dev)["SEQ"]
        if np.array_equal(pay, blk.streams["SEQ"].payload):
            break
    else:
        raise AssertionError("no trial gives the block's SEQ stream")
    host["winner"] = t_
    Sp, W = job.syms.shape
    NC, KD = job.item.NC, 8 * job.geom.depth
    out = {"shape": {"W": W, "Sp": Sp, "NC": NC, "depth": job.geom.depth,
                     "order": job.geom.order,
                     "table_entries": job.geom.table_size},
           "bit_steps": NC * KD, "host": host}
    CB = ST._chunk_bytes(job.geom.depth, hard=False)
    def enc():
        return coder_torch.lane_encode_blocks([job.item], "seq", job.geom,
                                              CB)[0]
    ebufs, eptrs, low, emax = enc()
    if int(emax) > CB:
        raise AssertionError("L4 SEQ: optimistic chunk buffer overflowed")
    e_ms = _time_ms(enc, 3)
    e_bytes = 10 * Sp * W + W * 4 + ebufs.numel() + eptrs.numel() * 4 \
        + W * 4
    _phases_vs_plain(errs4, [_head(job.item, 256)], "seq", job.geom, CB,
                     "E's phases, the L4 SEQ trial's first 256 steps")
    out["phases"] = phase_times([job.item], "seq", job.geom, CB, errs4)
    totals = eptrs.sum(dim=0)
    Bmax = int(totals.max())
    _compare(errs4, "compact_lanes_dev", f"compact L4 seq NC={NC} W={W}",
             compact_torch.compact_lanes_dev(ebufs, eptrs, Bmax),
             compact_torch.compact_lanes_plain(ebufs, eptrs, Bmax))
    mf = torch.zeros((Sp, W), dtype=torch.uint8, device=dev)
    mf[: mflag.shape[0]] = torch.from_numpy(mflag).to(dev)
    dargs = (ST._payload_tensor(blk.streams["SEQ"].payload, dev),
             ST._to(blk.streams["SEQ"].lane_lens, dev, torch.int32),
             job.counts, job.pos, job.reset)
    dec = coder_torch.lane_decode(*dargs, "seq", job.geom, mf)
    mask = torch.arange(Sp, device=dev)[:, None] < job.counts[None, :]
    if not torch.equal(dec[mask], job.syms[mask]):
        raise AssertionError("lane_decode of the pinned block's L4 SEQ "
                             "stream does not return its trial symbols")
    d_ms = _time_ms(lambda: coder_torch.lane_decode(*dargs, "seq", job.geom,
                                                    mf), 3)
    d_bytes = dargs[0].numel() + 2 * W * 4 + 2 * Sp * W * 4 + 2 * Sp * W
    out["lane_encode"] = (e_ms, e_bytes)
    out["lane_decode"] = (d_ms, d_bytes)
    print(f"L4 kernels at the main path's shape: the block keeps trial "
          f"t={t_}; compact equals its plain version, decode returns the "
          f"trial's symbols; host {json.dumps(host)}", flush=True)
    return out


# ---------------------------------------------------------------------------
# phase 3c: Kernel C, one launch for all of a block's streams
# ---------------------------------------------------------------------------

C_KERNEL = "compact_streams_kernel"
# (NC, W, CB, count cap, Bmax past the longest lane) of the ragged mix held
# in one launch: W of 8, 64, 100 and 1024; NC not a multiple of the
# kernel's 128-chunk tile; counts above CB; a lane of zeros in each; an
# all-empty stream; rows longer than one shared-memory stage (27,904 bytes)
RAGGED = [(300, 8, 32, 40, 5), (129, 64, 48, 48, 0), (77, 100, 16, 24, 3),
          (800, 1024, 64, 4, 0), (5, 64, 16, 0, 1), (1600, 100, 32, 40, 9)]


def _device_ms(fn, reps: int, key: str) -> float:
    """Mean device time (ms) of a launch of the kernel whose name holds
    `key`, from torch.profiler's kernel records over `reps` calls of fn
    (one launch each) after one warm-up call. The profiler may drop
    records (a run on the H100 kept 8 of 20): the mean is over the records
    it kept, and there must be one."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total, n = 0.0, 0
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and key in e.key:
            total += e.self_device_time_total / 1e3
            n += e.count
    if not 1 <= n <= reps:
        raise AssertionError(f"the profiler kept {n} records of {key} for "
                             f"{reps} launches")
    return total / n


def _c_bytes(streams, sector: int = 1) -> int:
    """Kernel C's byte bound over a launch: each stream's valid bytes, its
    [NC, W] counts, its [W, pitch] rows and its totals. With sector=32,
    each window's valid bytes count as the 32-byte sectors they fill: the
    least the reads can move."""
    total = 0
    for ebufs, eptrs, Bmax in streams:
        NC, W, CB = ebufs.shape
        valid = (eptrs.clamp(max=CB).long() + sector - 1) // sector * sector
        total += int(valid.sum()) + eptrs.numel() * 4 \
            + W * ((Bmax + 15) // 16 * 16) + W * 4
    return total


def check_ragged(dev, errs: dict) -> None:
    """Kernel C's one launch over the ragged mix (with a tail per stream)
    against compact_streams_plain, the whole flat buffer byte for byte."""
    import numpy as np
    import torch
    from slimfastq_tpu_torch.ops import compact_torch as CC
    rng = np.random.default_rng(3)
    streams = []
    for NC, W, CB, cap, extra in RAGGED:
        eptrs = rng.integers(0, cap + 1, size=(NC, W)).astype(np.int32)
        eptrs[:, W // 3] = 0
        ebufs = rng.integers(0, 256, size=(NC, W, CB)).astype(np.uint8)
        streams.append((torch.from_numpy(ebufs).to(dev),
                        torch.from_numpy(eptrs).to(dev),
                        max(int(eptrs.sum(axis=0).max()) + extra, 1)))
    tails = [torch.arange(ep.shape[1], dtype=torch.int32, device=dev) - 9
             for _, ep, _ in streams]
    _compare(errs, "compact_lanes_dev", "compact, the ragged mix in one "
             "launch", CC.compact_streams_dev(streams, tails)[0],
             CC.compact_streams_plain(streams, tails)[0])
    print(f"compact: one launch over {len(streams)} ragged streams (W "
          f"{sorted({s[0].shape[1] for s in streams})}, rows up to "
          f"{max(s[2] for s in streams)} bytes) equals its plain version",
          flush=True)


def block_compaction(data: bytes, dev, level: int, errs: dict) -> dict:
    """Kernel C on the pinned block's coded streams at `level` as
    encode_block hands them over (pipeline_native._coder_jobs, Kernel E's
    outputs and coder tails): the one launch held against
    compact_streams_plain byte for byte, and again with QUAL coded at the
    hard chunk size (encode_block's rerun), which must give QUAL's same
    payload and totals; then the launch's device time (profiler kernel
    records) and its wrapper-inclusive time (CUDA events around
    compact_streams_dev) beside its byte bound, its plain version's time,
    and at level 3 the same for QUAL alone (one stream a launch, as
    Kernel C ran before it took a block's streams at once)."""
    import numpy as np
    from slimfastq_tpu_torch import native, pipeline_native as PN
    from slimfastq_tpu_torch.config import config_for_level
    from slimfastq_tpu_torch.ops import coder_torch, compact_torch as CC
    from slimfastq_tpu_torch.ops import streams_torch as ST
    cfg = config_for_level(level)
    idx, n = native.fastq_index(data)
    pre = PN.prepare_block_fast(np.frombuffer(data, dtype=np.uint8), idx, 0,
                                n, cfg)
    names, streams, tails = [], [], []
    for name, kind, geom, item, _ in PN._coder_jobs(pre, cfg, dev):
        CB = ST._chunk_bytes(geom.depth, hard=False)
        ebufs, eptrs, low, emax = coder_torch.lane_encode_blocks(
            [item], kind, geom, CB)[0]
        if int(emax) > CB:
            raise AssertionError(f"L{level} {name}: optimistic chunk buffer "
                                 "overflowed")
        if name == "QUAL":
            hard = coder_torch.lane_encode_blocks(
                [item], kind, geom, ST._chunk_bytes(geom.depth, hard=True))[0]
        names.append(name)
        tails.append(low)
        streams.append((ebufs, eptrs, max(int(eptrs.sum(dim=0).max()), 1)))
    what = f"compact L{level} block ({len(streams)} streams)"
    flat, layout = CC.compact_streams_dev(streams, tails)
    _compare(errs, "compact_lanes_dev", what, flat,
             CC.compact_streams_plain(streams, tails)[0])
    q = names.index("QUAL")
    hard_streams = list(streams)
    hard_streams[q] = (hard[0], hard[1], streams[q][2])
    hflat, hlayout = CC.compact_streams_dev(hard_streams, tails)
    _compare(errs, "compact_lanes_dev", f"{what}, QUAL at the hard CB",
             hflat, CC.compact_streams_plain(hard_streams, tails)[0])
    _compare({}, "compact_lanes_dev", f"{what}: QUAL at the hard CB against "
             "the optimistic CB", hlayout.views(hflat)[q][:2],
             layout.views(flat)[q][:2])

    def launch():
        return CC.compact_streams_dev(streams, tails)
    nbytes = _c_bytes(streams)
    out = {"streams": names, "device_ms": _device_ms(launch, 20, C_KERNEL),
           "wrapper_ms": _time_ms(launch, 20),
           "plain_ms": _time_ms(lambda: CC.compact_streams_plain(
               streams, tails), 3),
           "bytes": nbytes, "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
           "sector_bound_ms": _c_bytes(streams, 32) / HBM_BYTES_PER_S * 1e3}
    out["bound_fraction"] = out["bound_ms"] / out["device_ms"]
    if level == 3:  # like for like with the one-launch-per-stream kernel
        qs = streams[q]
        qbound = _c_bytes([qs]) / HBM_BYTES_PER_S * 1e3
        qdev = _device_ms(lambda: CC.compact_lanes_dev(*qs), 20, C_KERNEL)
        out["qual_alone"] = {
            "device_ms": qdev,
            "wrapper_ms": _time_ms(lambda: CC.compact_lanes_dev(*qs), 20),
            "bound_ms": qbound, "bound_fraction": qbound / qdev,
            "shape": {"NC": int(qs[0].shape[0]), "W": int(qs[0].shape[1]),
                      "CB": int(qs[0].shape[2]), "Bmax": qs[2]}}
    print(json.dumps({f"compact_block_l{level}": out}), flush=True)
    return out


def barrier_us(dev, cluster: int = 1, threads: int = 1024) -> float:
    """One barrier on the card (us): `threads` threads of one CTA
    (__syncthreads()), or of each CTA of a cluster of `cluster` CTAs (the
    cluster barrier); csrc/coder.cu's barrier_loop, CUDA events around
    BARRIER_ITERS barriers, less a launch of none."""
    import torch
    from slimfastq_tpu_torch.ops import _cuda, coder_torch
    lib = _cuda.load("coder", coder_torch._SIGS)
    out = torch.zeros(1, dtype=torch.int32, device=dev)

    def run(iters):
        _cuda.check(lib, _cuda.launch(out, lib.barrier_loop, iters, threads,
                                      cluster, out.data_ptr()),
                    "barrier_loop")
    full = _time_ms(lambda: run(BARRIER_ITERS), 3)
    empty = _time_ms(lambda: run(0), 3)
    return (full - empty) * 1e3 / BARRIER_ITERS


def cluster_barrier_us(dev) -> dict:
    """The cluster barrier (barrier.cluster.arrive / wait) of 2, 4 and 8
    CTAs of 128 to 512 threads (us), beside which Kernel D's cluster form
    runs its bit-steps."""
    return {f"{c}x{t}": barrier_us(dev, c, t) for c, t in CLUSTER_BARRIERS}


# ---------------------------------------------------------------------------
# phase 4: the main path
# ---------------------------------------------------------------------------

# launches a direction of the pinned 64k block on the main path at level
# 3: Kernel L packs SEQ and QUAL with pos/reset (encode) or makes the step
# inputs (decode), E (one launch set a stream) or D codes the 7 streams, C
# compacts them, U unpacks; one host call (enc_run) issues each launch set
# of E, each of whose phases launches once a slice of a stream
# (phase_counts)
MAIN_LAUNCHES_L3 = (
    {"lane_encode": 7, "lane_decode": 0, "compact_lanes_dev": 1,
     "lane_layout": 1, "lane_unpack": 0, "encode_run": 7},
    {"lane_encode": 0, "lane_decode": 7, "compact_lanes_dev": 0,
     "lane_layout": 1, "lane_unpack": 1, "encode_run": 0})


def _phases_even(launches: dict) -> bool:
    """Kernel E's six phases launched alike, at least once a launch set
    of E, and each launch set one host call (encode_run)."""
    n = {launches[k] for k in E_PHASES}
    return (len(n) == 1 and n.pop() >= launches["lane_encode"]
            and launches["encode_run"] == launches["lane_encode"])


def main_path(data: bytes, level: int) -> dict:
    """The pinned block through api.encode_fastq / decode_fastq at
    `level`, the launch counts set to 0 just before each direction and
    read just after: at level 3 exactly MAIN_LAUNCHES_L3 and E's phases
    once a slice of each stream (phase_counts; no schedule, pack or
    pos/reset tensor op is left to launch), at level 4 every kernel, one
    L launch for the block and one a match trial, E's phases alike, and
    the block must take a match trial (MATCH_USED). Returns the launches
    of both directions summed."""
    import io
    import torch
    from slimfastq_tpu_torch import api, container
    from slimfastq_tpu_torch.ops import _cuda
    from slimfastq_tpu_torch.pipeline import MATCH_USED
    phases = phase_counts(data, 3, torch.device("cuda"))
    want_l3 = ({**MAIN_LAUNCHES_L3[0], **phases},
               {**MAIN_LAUNCHES_L3[1], **dict.fromkeys(phases, 0)})
    _cuda.reset_launches()
    enc = api.encode_fastq(data, level=level, device="cuda")
    enc_launches = dict(_cuda.launches)
    _cuda.reset_launches()
    dec = api.decode_fastq(enc, device="cuda")
    dec_launches = dict(_cuda.launches)
    launches = {k: enc_launches[k] + dec_launches[k] for k in enc_launches}
    nbytes, want_sha = PINNED[level]
    if len(enc) != nbytes:
        raise AssertionError(f"L{level} container is {len(enc)} bytes, "
                             f"expected {nbytes}")
    sha = hashlib.sha256(enc).hexdigest()
    if sha != want_sha:
        raise AssertionError(f"L{level} container SHA-256 {sha} differs "
                             "from the JAX package's")
    if dec != data:
        raise AssertionError(f"L{level} decode does not return the input")
    idle = [k for k in launches if launches[k] == 0]
    if idle:
        raise AssertionError(f"kernels not launched on the L{level} main "
                             f"path: {idle}")
    if level == 3 and (enc_launches, dec_launches) != want_l3:
        raise AssertionError(f"L3 launches: encode {enc_launches}, decode "
                             f"{dec_launches}, expected {want_l3}")
    # at level 4 each trial codes SEQ@t and MATCH@t beside the 7 streams
    if level == 4 and (enc_launches["lane_layout"]
                       != (enc_launches["lane_encode"] - 7) // 2 + 1
                       or not _phases_even(enc_launches)
                       or dec_launches["lane_layout"] != 1
                       or dec_launches["lane_unpack"] != 1):
        raise AssertionError(f"L4 launches: encode {enc_launches}, decode "
                             f"{dec_launches}")
    f = io.BytesIO(enc)
    cfg = container.read_header(f)
    flags = [blk.flags for blk in container.iter_blocks(f, cfg)]
    if level == 4 and not all(fl & MATCH_USED for fl in flags):
        raise AssertionError(f"L4 block flags {flags}: no MATCH_USED")
    print(f"main path L{level}: {len(data)} raw -> {len(enc)} bytes (ratio "
          f"{len(data) / len(enc):.4f}), SHA-256 equals the JAX package's, "
          f"block flags {flags}, round trip exact, launches encode "
          f"{enc_launches}, decode {dec_launches}", flush=True)
    return launches


def _events_ms(fn):
    """(ms between CUDA events on the calling stream around fn(), its
    result), after the card is idle."""
    import torch
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    out = fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1), out


def block_spans(data: bytes, dev, cfg=None, key: str = "block") -> dict:
    """The pinned block's seven coder launches per direction (at level 3,
    or at `cfg`; printed under `key`), with the
    inputs the main path gives them (pipeline_native's own setup): each
    stream's E and D time (ms) alone, and the block's coder span, its
    streams launched at once through streams_torch.StreamSet as the main
    path launches them, from the calling stream's event before the first
    launch to its event after the join. The main path decodes LEN first
    and the rest once the host has read its lengths; here the seven
    decodes start together, so the decode span leaves out that host step.
    `device_half_ms` times the main path's own device halves
    (pipeline_native.encode_prepared_block, decode_block_device) with
    events on the calling stream: the lane layout, compaction, the unpack
    and the host's reads and flush included. The launches at once must give what
    the launches alone give."""
    import numpy as np
    import torch
    from slimfastq_tpu_torch import native, pipeline_native as PN
    from slimfastq_tpu_torch.config import config_for_level
    from slimfastq_tpu_torch.ops import coder_torch
    from slimfastq_tpu_torch.ops import streams_torch as ST
    from slimfastq_tpu_torch.ops.ranger import pad_steps
    cfg = cfg or config_for_level(3)
    idx, n = native.fastq_index(data)
    pre = PN.prepare_block_fast(np.frombuffer(data, dtype=np.uint8), idx, 0,
                                n, cfg)
    jobs = list(PN._coder_jobs(pre, cfg, dev))
    ll_mat = pre[4]
    enc_ms, blk = _events_ms(lambda: PN.encode_prepared_block(pre, cfg, dev))
    dec_ms, _ = _events_ms(lambda: PN.decode_block_device(blk, cfg, dev))
    launches = {"encode": {}, "decode": {}}
    for name, kind, geom, item, _counts in jobs:
        CB = ST._chunk_bytes(geom.depth, hard=False)
        _phases_vs_plain({}, [_head(item, 16)], kind, geom, CB,
                         f"E's phases, the block's {name}: its first 2 "
                         "chunks")
        launches["encode"][name] = (
            lambda item=item, kind=kind, geom=geom, CB=CB:
            coder_torch.lane_encode_blocks([item], kind, geom, CB)[0],
            item.tensors())
        es = blk.streams[name]
        W = es.payload.shape[0]
        counts = ST._to(es.sym_counts, dev, torch.int32)
        S = int(es.sym_counts.max())
        Sp = pad_steps(S)
        if kind in ("seq", "qual"):
            pos, reset = ST._pos_reset(ST._lane_lens(ll_mat, W, dev), Sp, S,
                                       W)
        else:
            pos = reset = ST._pad2(None, Sp, W, dev)
        args = (ST._payload_tensor(es.payload, dev),
                ST._to(es.lane_lens, dev, torch.int32), counts, pos, reset)
        launches["decode"][name] = (
            lambda args=args, kind=kind, geom=geom:
            coder_torch.lane_decode(*args, kind, geom), args)
    out = {}
    for direction, fns in launches.items():
        alone = {k: _time_ms(fn, 1) for k, (fn, _) in fns.items()}
        ss = ST.StreamSet(dev)

        def at_once():
            res = [ss.launch(fn, *inputs)[0] for fn, inputs in fns.values()]
            ss.join()
            return res
        span, res = _events_ms(at_once)
        for (name, (fn, _)), got in zip(fns.items(), res):
            _compare({}, name, f"{direction} {name}: launched at once vs "
                     "alone", got, fn())
        total = sum(alone.values())
        out[direction] = {"span_ms": span, "sum_ms": total,
                          "span_below_sum": span < total,
                          "streams_ms": alone,
                          "device_half_ms": (enc_ms if direction == "encode"
                                             else dec_ms)}
    print(json.dumps({key: out}), flush=True)
    return out


def wide_lanes(data: bytes, dev, card: str, bar_us: float,
               cbar_us: dict) -> dict:
    """Lane counts past 1,024 on the main path: the pinned block through
    api.encode_fastq / decode_fastq on the card at each PINNED_WIDE width
    (lanes 2,048 to 65,536 at level 3, 2,048 to 8,192 at level 4,
    aux_lanes 2,048 to 8,192 at level 3), the launch counts set to 0 just
    before each direction and read just after: size and SHA-256 equal the
    JAX package's, the round trip is exact, E, C, D, L and U launched.
    Then the W sweep (WIDE_SWEEP): block_spans on the level-3 block at
    each lane count, D's streams alone and the block's decode span, E's
    streams alone and its launch-set span, beside the container's size
    and ratio and QUAL's D bound (d_bound on its shape at that W); every
    figure with the card's name and power limit."""
    from slimfastq_tpu_torch import api
    from slimfastq_tpu_torch.config import config_for_level
    from slimfastq_tpu_torch.ops import _cuda
    from slimfastq_tpu_torch.ops import coder_torch as CT
    from slimfastq_tpu_torch.ops.ranger import pad_steps
    out = {"card": card, "containers": {}, "launches": {}, "sweep": {}}
    sizes = {1024: PINNED[3][0]}
    for (level, field, W), (nbytes, want) in PINNED_WIDE.items():
        what = f"L{level} {field}={W}"
        _cuda.reset_launches()
        enc = api.encode_fastq(data, level=level, device="cuda", **{field: W})
        enc_l = dict(_cuda.launches)
        _cuda.reset_launches()
        dec = api.decode_fastq(enc, device="cuda")
        dec_l = dict(_cuda.launches)
        sha = hashlib.sha256(enc).hexdigest()
        if (len(enc), sha) != (nbytes, want):
            raise AssertionError(f"{what}: container {len(enc)} bytes, "
                                 f"SHA-256 {sha}; the JAX package's "
                                 f"{nbytes}, {want}")
        if dec != data:
            raise AssertionError(f"{what}: decode does not return the input")
        idle = [k for k in ("lane_encode", "compact_lanes_dev", "lane_layout")
                if not enc_l[k]] + [k for k in ("lane_decode", "lane_unpack")
                                    if not dec_l[k]]
        if idle:
            raise AssertionError(f"{what}: kernels not launched: {idle}")
        if level == 3 and field == "lanes":
            sizes[W] = len(enc)
        out["containers"][what] = {"bytes": len(enc),
                                   "ratio": len(data) / len(enc),
                                   "sha256_matches": True}
        for k in enc_l:
            out["launches"][k] = out["launches"].get(k, 0) + enc_l[k] + \
                dec_l[k]
    for W in WIDE_SWEEP:
        cfg = config_for_level(3, lanes=W)
        spans = block_spans(data, dev, cfg, key=f"block_w{W}")
        dec, enc = spans["decode"], spans["encode"]
        # QUAL's symbol-steps: the longest lane's bases, padded
        Sp = pad_steps(-(-READS // W) * READ_LEN)
        shape = CT.decode_shape(cfg.qual, W)
        out["sweep"][W] = {
            "qual_shape": {**shape._asdict(),
                           "per_thread": CT.lanes_per_thread(shape, W)},
            "qual_d_bound": d_bound(Sp * cfg.qual.depth, cfg.qual.depth,
                                    bar_us, shape, cbar_us),
            "decode_streams_ms": {k: dec["streams_ms"][k]
                                  for k in ("QUAL", "SEQ", "IDD")},
            "decode_span_ms": dec["span_ms"],
            "encode_streams_ms": {k: enc["streams_ms"][k]
                                  for k in ("QUAL", "SEQ", "IDD")},
            "encode_span_ms": enc["span_ms"],
            "bytes": sizes[W], "ratio": len(data) / sizes[W]}
    print(json.dumps({"wide_lanes": out}), flush=True)
    return out


def geom_cfg(name: str):
    """Level 3 with GEOMS[name]'s one stream changed."""
    from dataclasses import replace
    from slimfastq_tpu_torch.config import config_for_level
    field, changes = GEOMS[name]
    cfg = config_for_level(3)
    return replace(cfg, **{field: replace(getattr(cfg, field), **changes)})


def check_geometries(dev, errs: dict) -> list:
    """E, C and D against their plain versions at each GEOMS geometry, at
    the shapes of check_kernels (W = 1,024, Sp = 256; the flag kind at the
    64 aux lanes, ragged): QUAL at cap 16 with all 1,024 lanes on one
    entry at each read start, SEQ at cap 512 with 700 (a count that reads
    negative) and 1,024, FLAG at 17 history bits; then E's phases over
    slices of 1,000 bit-steps at QUAL cap 16 and of 200 at SEQ cap 512,
    so the 32-bit tables carry across slices. Returns what ran."""
    import numpy as np
    import torch
    from slimfastq_tpu_torch.ops import coder_torch as CT
    from slimfastq_tpu_torch.ops import streams_torch as ST
    rng = np.random.default_rng(11)
    Sp, W = 256, 1024
    seq = rng.integers(0, 4, size=(Sp, W)).astype(np.uint8)
    qual = np.clip(30 + np.cumsum(rng.integers(-2, 3, size=(Sp, W)),
                                  axis=0), 0, 41).astype(np.uint8)
    q, s, f = (getattr(geom_cfg(n), GEOMS[n][0]) for n in GEOMS)
    ran, items = [], {}
    for kind, geom, syms, active in (("qual", q, qual, W),
                                     ("seq", s, seq, 700),
                                     ("seq", s, seq, W)):
        ll, counts = _reads_layout(W, Sp, READ_LEN, active)
        pos, reset = ST._pos_reset(torch.from_numpy(ll).to(dev), Sp,
                                   int(counts.max()), W)
        _check_stream(kind, geom, syms, counts, pos, reset, dev, {}, errs)
        items[kind] = ST.EncIn(torch.from_numpy(syms).to(dev), pos, reset,
                               torch.from_numpy(counts.astype(np.int32)).to(
                                   dev))
        shape = CT.decode_shape(geom, W)
        ran.append(f"{kind} rate {geom.rate} rate_lo {geom.rate_lo} (cap "
                   f"{CT.visit_cap(geom)}, {shape.entry_bytes}-byte entries, "
                   f"D {shape.table} {shape.cluster} x {shape.threads}; "
                   f"{active} lanes on one entry)")
    Wa = 64
    zeros = torch.zeros((Sp, Wa), dtype=torch.int32, device=dev)
    _check_stream("flag", f, rng.integers(0, 2, size=(Sp, Wa)).astype(
        np.uint8), rng.integers(Sp // 2, Sp + 1, size=Wa), zeros, zeros, dev,
                  {}, errs)
    shape = CT.decode_shape(f, Wa)
    ran.append(f"flag hist_bits {f.hist_bits} ({f.table_size} entries, D "
               f"{shape.table} {shape.cluster} x {shape.threads})")
    for kind, geom, L in (("qual", q, 1000), ("seq", s, 200)):
        _phases_vs_plain(errs, [items[kind]], kind, geom,
                         ST._chunk_bytes(geom.depth, hard=False),
                         f"E's phases, {kind} cap {CT.visit_cap(geom)} in "
                         f"slices of {L} bit-steps", L=L)
        ran.append(f"E's phases {kind} cap {CT.visit_cap(geom)} in slices "
                   f"of {L} bit-steps")
    print("kernels match their plain versions at the header's other "
          "geometries: " + "; ".join(ran), flush=True)
    return ran


def geometries(data: bytes, dev, card: str, errs: dict) -> dict:
    """Every geometry the header names on the main path: the kernels
    against their plain versions (check_geometries), then the pinned block
    through api.encode_fastq / decode_fastq on the card at each GEOMS
    geometry, the launch counts set to 0 just before each direction and
    read just after: size and SHA-256 equal the JAX package's
    (PINNED_GEOM), the round trip is exact, E, C and L launched to encode
    and D and U to decode. Then E's and D's QUAL and SEQ streams alone on
    the block (block_spans), at level 3 (16-bit entries) and at the two
    warm-up geometries (32-bit), in turns: L3, QUAL 7 / 2, SEQ 14 / 1,
    SEQ 14 / 1, QUAL 7 / 2, L3."""
    from slimfastq_tpu_torch import api
    from slimfastq_tpu_torch.config import config_for_level
    from slimfastq_tpu_torch.ops import _cuda
    from slimfastq_tpu_torch.ops import coder_torch as CT
    out = {"card": card, "checks": check_geometries(dev, errs),
           "containers": {}, "launches": {}}
    for name, (nbytes, want) in PINNED_GEOM.items():
        cfg = geom_cfg(name)
        _cuda.reset_launches()
        enc = api.encode_fastq(data, cfg=cfg, device="cuda")
        enc_l = dict(_cuda.launches)
        _cuda.reset_launches()
        dec = api.decode_fastq(enc, device="cuda")
        dec_l = dict(_cuda.launches)
        sha = hashlib.sha256(enc).hexdigest()
        if (len(enc), sha) != (nbytes, want):
            raise AssertionError(f"{name}: container {len(enc)} bytes, "
                                 f"SHA-256 {sha}; the JAX package's "
                                 f"{nbytes}, {want}")
        if dec != data:
            raise AssertionError(f"{name}: decode does not return the input")
        idle = [k for k in ("lane_encode", "compact_lanes_dev", "lane_layout")
                if not enc_l[k]] + [k for k in ("lane_decode", "lane_unpack")
                                    if not dec_l[k]]
        if idle:
            raise AssertionError(f"{name}: kernels not launched: {idle}")
        geom = getattr(cfg, GEOMS[name][0])
        W = cfg.aux_lanes if GEOMS[name][0] == "flags" else cfg.lanes
        shape = CT.decode_shape(geom, W)
        out["containers"][name] = {
            "bytes": len(enc), "ratio": len(data) / len(enc),
            "sha256_matches": True, "visit_cap": CT.visit_cap(geom),
            "entry_bytes": CT.entry_bytes(geom),
            "table_bytes": CT.table_bytes(geom), "d_shape": shape._asdict(),
            "launches": {"encode": enc_l, "decode": dec_l}}
        for k in enc_l:
            out["launches"][k] = out["launches"].get(k, 0) + enc_l[k] + \
                dec_l[k]
    turns = ("l3", "qual_rate7_lo2", "seq_rate14_lo1", "seq_rate14_lo1",
             "qual_rate7_lo2", "l3")
    times = {}
    for i, name in enumerate(turns):
        cfg = config_for_level(3) if name == "l3" else geom_cfg(name)
        spans = block_spans(data, dev, cfg, key=f"block_geom_{name}_{i}")
        for way in ("encode", "decode"):
            for stream in ("QUAL", "SEQ"):
                times.setdefault(name, {}).setdefault(way, {}).setdefault(
                    stream, []).append(spans[way]["streams_ms"][stream])
    out["streams_ms"] = times
    print(json.dumps({"geometries": out}), flush=True)
    return out


def l4_spans(data: bytes, dev) -> dict:
    """The pinned level-4 block's encode launches (QUAL, the plain SEQ, each
    match trial's SEQ@t and MATCH@t, the aux streams) on the main path's
    inputs: each alone, and the block's coder span in two orders, all at
    once (the main path's) and each trial's SEQ queued behind the plain
    SEQ on one CUDA stream (at most one order-11 SEQ table in use at a
    time), in turns (at once, serial, serial, at once); both must give
    the bytes of the launches alone. Also the main path's device halves
    at level 4, CUDA events on the calling stream."""
    import numpy as np
    import torch
    from slimfastq_tpu_torch import native, pipeline_native as PN
    from slimfastq_tpu_torch.config import config_for_level
    from slimfastq_tpu_torch.ops import coder_torch
    from slimfastq_tpu_torch.ops import streams_torch as ST
    from slimfastq_tpu_torch.ops.ranger import pad_steps
    cfg = config_for_level(4)
    idx, n = native.fastq_index(data)
    pre = PN.prepare_block_fast(np.frombuffer(data, dtype=np.uint8), idx, 0,
                                n, cfg)
    enc_ms, blk = _events_ms(lambda: PN.encode_prepared_block(pre, cfg, dev))
    dec_ms, _ = _events_ms(lambda: PN.decode_block_device(blk, cfg, dev))
    fns, jobs = {}, {}
    for name, kind, geom, item, _counts in PN._coder_jobs(pre, cfg, dev):
        jobs[name] = (kind, geom, item)
        CB = ST._chunk_bytes(geom.depth, hard=False)
        _phases_vs_plain({}, [_head(item, 16)], kind, geom, CB,
                         f"E's phases, the L4 block's {name}: its first 2 "
                         "chunks")
        fns[name] = (lambda item=item, kind=kind, geom=geom, CB=CB:
                     coder_torch.lane_encode_blocks([item], kind, geom,
                                                    CB)[0],
                     item.tensors())
    alone = {k: _time_ms(fn, 1) for k, (fn, _) in fns.items()}

    def launch(serial: bool):
        ss = ST.StreamSet(dev)
        res, seq_stream = [], None
        for name, (fn, inputs) in fns.items():
            trial = serial and name.startswith("SEQ@")
            out, s = ss.launch(fn, *inputs,
                               after=seq_stream if trial else None)
            if name == "SEQ":
                seq_stream = s
            res.append(out)
        ss.join()
        return res
    spans = {"at_once_ms": [], "serial_ms": []}
    for serial in (False, True, True, False):
        span, res = _events_ms(lambda: launch(serial))
        spans["serial_ms" if serial else "at_once_ms"].append(span)
        for (name, (fn, _)), got in zip(fns.items(), res):
            _compare({}, name, f"L4 encode {name}: launched at once vs "
                     "alone", got, fn())
    # each stream's D alone on the block's payload, its output against the
    # coded symbols (SEQ, whose flags come from the kept trial, is timed
    # in time_kernels_l4)
    dec_alone = {}
    for name, es in blk.streams.items():
        if name == "SEQ":
            continue
        kind, geom, item = jobs[name if name in jobs else
                                next(k for k in jobs
                                     if k.startswith(name + "@"))]
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
        got = coder_torch.lane_decode(*args, kind, geom)
        if name in jobs:
            n = min(Sp, item.syms.shape[0])
            mask = torch.arange(n, device=dev)[:, None] < counts[None, :]
            if not torch.equal(got[:n][mask], item.syms[:n][mask]):
                raise AssertionError(f"L4 decode of {name} does not return "
                                     "its coded symbols")
        dec_alone[name] = _time_ms(
            lambda args=args, kind=kind, geom=geom:
            coder_torch.lane_decode(*args, kind, geom), 1)
    out = {"streams_ms": alone, "sum_ms": sum(alone.values()), **spans,
           "decode_streams_ms": dec_alone,
           "device_half_ms": {"encode": enc_ms, "decode": dec_ms}}
    print(json.dumps({"block_l4": out}), flush=True)
    return out


def wall(data: bytes, dev, level: int) -> None:
    """Encode and decode wall time of `data`, the 4-block set, at
    `level`."""
    import torch
    from slimfastq_tpu_torch import api
    torch.cuda.synchronize()
    t = time.perf_counter()
    enc = api.encode_fastq(data, level=level, device=dev)
    t_enc = time.perf_counter() - t
    t = time.perf_counter()
    dec = api.decode_fastq(enc, device=dev)
    t_dec = time.perf_counter() - t
    if dec != data:
        raise AssertionError(f"L{level} 4-block round trip is not exact")
    print(json.dumps({"wall" if level == 3 else f"wall_l{level}": {
        "level": level, "blocks": WALL_BLOCKS, "raw_bytes": len(data),
        "compressed_bytes": len(enc), "ratio": len(data) / len(enc),
        "encode_s": t_enc, "decode_s": t_dec,
        "encode_GBps": len(data) / t_enc / 1e9,
        "decode_GBps": len(data) / t_dec / 1e9}}), flush=True)


def pool_reuse(data4: bytes) -> dict:
    """The 4 x 64k L3 set through api.encode_fastq twice back to back on
    the card, its raw bytes in page-locked buffers (pack_torch.pinned_empty,
    from PyTorch's caching host allocator), the second encode on the
    memory the first returned: both containers equal the set's container
    from the host-pack path (the port's _MAX_SPAN lowered to 1: no raw
    buffer; that path keeps the JAX package's SHA-256 on the pinned block,
    host_pack_pins), and the second encode allocates no new page-locked
    memory. The JAX package's SHA-256 of this set is not in the
    repository: its encode on a CPU is a full-size run."""
    import torch
    from slimfastq_tpu_torch import api
    from slimfastq_tpu_torch import pipeline_native as PN
    saved = PN._MAX_SPAN
    PN._MAX_SPAN = 1
    try:
        ref = api.encode_fastq(data4, level=3, device="cuda")
    finally:
        PN._MAX_SPAN = saved
    want = hashlib.sha256(ref).hexdigest()
    shas, held = [], []
    for _ in range(2):
        enc = api.encode_fastq(data4, level=3, device="cuda")
        shas.append(hashlib.sha256(enc).hexdigest())
        held.append(torch.cuda.host_memory_stats()["num_host_alloc"])
    if shas != [want, want]:
        raise AssertionError(f"4 x 64k L3 encoded twice: SHA-256 {shas}, "
                             f"the host-pack path's {want}")
    if held[1] != held[0]:
        raise AssertionError(f"the second encode allocated new page-locked "
                             f"memory: {held} allocations")
    out = {"compressed_bytes": len(ref), "sha256": want,
           "page_locked_allocations": held}
    print(json.dumps({"pool_reuse": out}), flush=True)
    return out


# ---------------------------------------------------------------------------
# phase 5: the small-block window path (16,384-record blocks in windows)
# ---------------------------------------------------------------------------

def _window_stream(kind, rng, Sp: int, W: int, active, read_len: int = 32):
    """(syms [Sp, W] u8, counts) of one block of a ragged window: reads of
    `read_len` from step 0 in the first `active` lanes (all at one context
    at each read start: the collision case) for seq/qual, ragged counts
    for byte."""
    import numpy as np
    if kind == "byte":
        return (rng.integers(0, 256, size=(Sp, W)).astype(np.uint8),
                rng.integers(1, Sp + 1, size=W))
    ll, counts = _reads_layout(W, Sp, read_len, W if active is None
                               else active)
    if kind == "seq":
        syms = rng.integers(0, 4, size=(Sp, W))
    else:
        syms = np.clip(30 + np.cumsum(rng.integers(-2, 3, size=(Sp, W)),
                                      axis=0), 0, 41)
    return syms.astype(np.uint8), counts, ll


# (level, kind, W, [(Sp, active lanes)], match family) of the ragged
# windows: blocks of different step counts, a block with one active lane,
# the level-3 SEQ collision case (1,024 and 700 lanes), level 4's match
# family
WINDOWS = [(3, "seq", 1024, [(128, None), (256, 700), (64, 1)], False),
           (3, "qual", 1024, [(160, None), (64, 1), (128, 900)], False),
           (4, "seq", 1024, [(128, None), (192, 700), (32, 1)], True),
           (3, "byte", 64, [(128, None), (32, None), (256, None)], False)]


def check_windows(dev, errs: dict) -> None:
    """Kernels E and D over each ragged window in one launch (one CTA a
    block) against their plain versions and against one launch per block,
    byte for byte; D's output against the coded symbols; then Kernel C's
    window launch over 88 streams (a window of 8 level-4 blocks with their
    trials) against its plain version. Records each batched form's
    largest difference in `errs`."""
    import numpy as np
    import torch
    from slimfastq_tpu_torch.config import config_for_level
    from slimfastq_tpu_torch.ops import coder_torch as CT
    from slimfastq_tpu_torch.ops import compact_torch as CC
    from slimfastq_tpu_torch.ops import streams_torch as ST
    rng = np.random.default_rng(11)
    for level, kind, W, blocks, match in WINDOWS:
        cfg = config_for_level(level)
        geom = {"seq": cfg.seq, "qual": cfg.qual, "byte": cfg.bytes_}[kind]
        scheds, inputs = [], []
        for Sp, active in blocks:
            made = _window_stream(kind, rng, Sp, W, active)
            syms, counts = made[0], made[1]
            if kind == "byte":
                pos = reset = torch.zeros((Sp, W), dtype=torch.int32,
                                          device=dev)
            else:
                pos, reset = ST._pos_reset(torch.from_numpy(made[2]).to(dev),
                                           Sp, int(counts.max()), W)
            mflag = None
            if match:
                syms, mf = _match_layout(syms, pos, counts)
                mflag = torch.from_numpy(mf).to(dev)
            s = torch.from_numpy(syms.astype(np.uint8)).to(dev)
            c = torch.from_numpy(counts.astype(np.int32)).to(dev)
            scheds.append(CT.EncIn(s, pos, reset, c, mflag))
            inputs.append((s, counts, c, pos, reset, mflag))
        CB = ST._chunk_bytes(geom.depth, hard=False)
        what = f"L{level} {kind} window of {len(blocks)}"
        enc = CT.lane_encode_blocks(scheds, kind, geom, CB)
        _compare(errs, "lane_encode_blocks", f"{what}: E vs plain", enc,
                 CT.lane_encode_blocks_plain(scheds, kind, geom, CB))
        _compare({}, "lane_encode_blocks", f"{what}: E vs one launch a "
                 "block", enc, [CT.lane_encode_blocks([it], kind, geom, CB)[0]
                                for it in scheds])
        _phases_vs_plain(errs, scheds, kind, geom, CB, f"{what}: E's phases")
        _phases_vs_plain(errs, scheds, kind, geom, CB, f"{what}: E's phases "
                         "in slices of 100 bit-steps", L=100)
        items = []
        for (s, counts, c, pos, reset, mflag), e in zip(inputs, enc):
            if int(e[3]) > CB:
                raise AssertionError(f"{what}: optimistic chunk buffer "
                                     "overflowed")
            Bmax = max(int(e[1].sum(dim=0).max()), 1)
            pay, tot = CC.compact_lanes_dev(e[0], e[1], Bmax)
            pay, lens = ST._flush_append(
                pay.cpu().numpy(), tot.cpu().numpy().astype(np.int64),
                e[2].cpu().numpy().view(np.uint32), counts)
            items.append((ST._payload_tensor(pay, dev),
                          torch.from_numpy(lens.astype(np.int32)).to(dev),
                          c, pos, reset, mflag))
        dec = CT.lane_decode_blocks(items, kind, geom)
        _compare(errs, "lane_decode_blocks", f"{what}: D vs plain", dec,
                 CT.lane_decode_blocks_plain(items, kind, geom))
        _compare({}, "lane_decode_blocks", f"{what}: D vs one launch a "
                 "block", dec, [CT.lane_decode(*it[:5], kind, geom, it[5])
                                for it in items])
        for d, (s, _, c, *_r) in zip(dec, inputs):
            mask = torch.arange(s.shape[0], device=dev)[:, None] < c[None, :]
            if not torch.equal(d[mask], s[mask]):
                raise AssertionError(f"{what}: decode does not invert "
                                     "encode")
    streams = []
    for seed in range(15):
        r = np.random.default_rng(seed)
        for NC, W, CB, cap, extra in RAGGED[:6]:
            eptrs = r.integers(0, cap + 1, size=(NC, W)).astype(np.int32)
            ebufs = r.integers(0, 256, size=(NC, W, CB)).astype(np.uint8)
            streams.append((torch.from_numpy(ebufs).to(dev),
                            torch.from_numpy(eptrs).to(dev),
                            max(int(eptrs.sum(axis=0).max()) + extra, 1)))
    streams = streams[:88]
    tails = [torch.arange(ep.shape[1], dtype=torch.int32, device=dev)
             for _, ep, _ in streams]
    _compare(errs, "compact_window", "Kernel C's window launch over 88 "
             "streams", CC.compact_streams_dev(streams, tails)[0],
             CC.compact_streams_plain(streams, tails)[0])
    print(f"window kernels: E and D over {len(WINDOWS)} ragged windows "
          f"equal their plain versions and one launch a block; Kernel C's "
          f"window launch over {len(streams)} streams equals its plain "
          f"version", flush=True)


def _window_pres(data: bytes, level: int, block_records: int):
    import numpy as np
    from slimfastq_tpu_torch import native, pipeline_native as PN
    from slimfastq_tpu_torch.config import config_for_level
    cfg = config_for_level(level, block_records=block_records)
    idx, n = native.fastq_index(data)
    buf = np.frombuffer(data, dtype=np.uint8)
    return cfg, [PN.prepare_block_fast(buf, idx, lo,
                                       min(lo + block_records, n), cfg)
                 for lo in range(0, n, block_records)]


def time_window(data: bytes, dev, bar_us: float, cbar_us: dict,
                errs: dict) -> dict:
    """The batched launches on the 16k L3 window's own inputs
    (pipeline_native._window_jobs, 4 blocks of 16,384 records): E over the
    window's QUAL (the longest chain) timed with CUDA events beside one
    launch a block; D over the same, its output against the packed
    symbols; E and D against their plain versions on the first
    PLAIN_CHUNKS chunks of each block of the same inputs (the plain
    versions step in Python), both timed there; Kernel C's window launch
    over every coded stream of the 4 blocks (28) against its plain
    version, its device time (profiler records) and its wrapper time
    beside its byte bound; then the window's coder span (every group's E
    launched at once, as the main path launches them) against the sum of
    its blocks' spans, each block's groups launched at once alone."""
    import numpy as np
    import torch
    from slimfastq_tpu_torch import pipeline_native as PN
    from slimfastq_tpu_torch.ops import coder_torch as CT
    from slimfastq_tpu_torch.ops import compact_torch as CC
    from slimfastq_tpu_torch.ops import streams_torch as ST
    cfg, pres = _window_pres(data, 3, WINDOW_RECORDS)
    groups = list(PN._window_jobs(pres, cfg, dev))
    q = next(g for g in groups if g[0] == "QUAL")
    geom = q[2]
    scheds = [m[1] for m in q[3]]
    CB = ST._chunk_bytes(geom.depth, hard=False)
    enc = CT.lane_encode_blocks(scheds, "qual", geom, CB)
    e_ms = _time_ms(lambda: CT.lane_encode_blocks(scheds, "qual", geom, CB),
                    3)
    e_one = sum(_time_ms(lambda it=it: CT.lane_encode_blocks(
        [it], "qual", geom, CB), 1) for it in scheds)
    e_bytes = sum(9 * it.syms.numel() + e[0].numel() + e[1].numel() * 4
                  + e[2].numel() * 8 for it, e in zip(scheds, enc))
    items, syms_ref = [], []
    for pre, e, (_, _, counts) in zip(pres, enc, q[3]):
        Bmax = max(int(e[1].sum(dim=0).max()), 1)
        pay, tot = CC.compact_lanes_dev(e[0], e[1], Bmax)
        pay, lens = ST._flush_append(pay.cpu().numpy(),
                                     tot.cpu().numpy().astype(np.int64),
                                     e[2].cpu().numpy().view(np.uint32),
                                     np.asarray(counts))
        job = next(ST.seq_qual_jobs(*PN.seq_qual_args(pre, cfg), dev))
        Sp = job.syms.shape[0]
        items.append((torch.from_numpy(pay).to(dev),
                      torch.from_numpy(lens.astype(np.int32)).to(dev),
                      job.counts, job.pos, job.reset))
        syms_ref.append(job.syms)
    dec = CT.lane_decode_blocks(items, "qual", geom)
    for d, s, it in zip(dec, syms_ref, items):
        mask = torch.arange(s.shape[0], device=dev)[:, None] < it[2][None, :]
        if not torch.equal(d[mask], s[mask]):
            raise AssertionError("the window's QUAL decode does not return "
                                 "its packed symbols")
    # the plain versions on a prefix of every block: E on its first chunks,
    # D on their steps (a prefix decodes exactly from the whole payload)
    n_steps = CHUNK_STEPS * PLAIN_CHUNKS
    pre_e = [CT.EncIn(*(x[:n_steps] for x in it[:3]), it.counts)
             for it in scheds]
    pre_d = [(p, ln, c, *(x[:n_steps] for x in rest))
             for p, ln, c, *rest in items]
    plain, prefix_ms = {}, {}
    for name, args, kernel, plain_fn in (
            ("lane_encode_blocks", pre_e,
             lambda a: CT.lane_encode_blocks(a, "qual", geom, CB),
             lambda a: CT.lane_encode_blocks_plain(a, "qual", geom, CB)),
            ("lane_decode_blocks", pre_d,
             lambda a: CT.lane_decode_blocks(a, "qual", geom),
             lambda a: CT.lane_decode_blocks_plain(a, "qual", geom))):
        got = kernel(args)
        torch.cuda.synchronize()
        t = time.perf_counter()
        want = plain_fn(args)
        torch.cuda.synchronize()
        plain[name] = (time.perf_counter() - t) * 1e3
        _compare(errs, name, f"{name}: the 16k L3 window's QUAL, the first "
                 f"{n_steps} steps of each block", got, want)
        prefix_ms[name] = _time_ms(lambda a=args, k=kernel: k(a), 3)
    _phases_vs_plain(errs, pre_e, "qual", geom, CB, f"E's phases: the 16k "
                     f"L3 window's QUAL, the first {n_steps} steps of each "
                     "block")
    phases = phase_times(scheds, "qual", geom, CB, errs)
    d_ms = _time_ms(lambda: CT.lane_decode_blocks(items, "qual", geom), 3)
    d_one = sum(_time_ms(lambda it=it: CT.lane_decode(*it, "qual", geom), 1)
                for it in items)
    steps = max(it.NC * 8 * geom.depth for it in scheds)
    # Kernel C over the window's coded streams, as encode_window hands them
    streams, tails = [], []
    for _, kind, g, members in groups:
        cb = ST._chunk_bytes(g.depth, hard=False)
        for e in CT.lane_encode_blocks([m[1] for m in members], kind, g, cb):
            if int(e[3]) > cb:
                raise AssertionError("window: optimistic chunk buffer "
                                     "overflowed")
            streams.append((e[0], e[1], max(int(e[1].sum(dim=0).max()), 1)))
            tails.append(e[2])
    _compare(errs, "compact_window", f"Kernel C: the 16k L3 window's "
             f"{len(streams)} streams",
             CC.compact_streams_dev(streams, tails)[0],
             CC.compact_streams_plain(streams, tails)[0])
    c_bytes = _c_bytes(streams)

    def run(gs):
        ss = ST.StreamSet(dev)
        outs = [ss.launch(lambda g=g: CT.lane_encode_blocks(
            [m[1] for m in g[3]], g[1], g[2],
            ST._chunk_bytes(g[2].depth, hard=False)))[0] for g in gs]
        ss.join()
        return outs
    run(groups)
    span, _ = _events_ms(lambda: run(groups))
    block_spans = []
    for b in range(len(pres)):
        gs = [(n, k, g, [m for m in ms if m[0] == b])
              for n, k, g, ms in groups]
        gs = [g for g in gs if g[3]]
        block_spans.append(_events_ms(lambda: run(gs))[0])
    prefix = f"the first {n_steps} steps of each block, W = 1024"
    out = {"blocks": len(pres), "groups": len(groups),
           "lane_encode_blocks": {
               "ms": e_ms, "one_launch_a_block_sum_ms": e_one,
               "bytes": e_bytes,
               "bound_ms": e_bytes / HBM_BYTES_PER_S * 1e3,
               "bit_steps_per_block": steps,
               "plain_ms": plain["lane_encode_blocks"],
               "prefix_ms": prefix_ms["lane_encode_blocks"],
               "plain_shape": prefix, "phases": phases},
           "lane_decode_blocks": {
               "ms": d_ms, "one_launch_a_block_sum_ms": d_one,
               **d_bound(steps, geom.depth, bar_us, CT.decode_shape(
                   geom, items[0][0].shape[0], len(items)), cbar_us),
               "plain_ms": plain["lane_decode_blocks"],
               "prefix_ms": prefix_ms["lane_decode_blocks"],
               "plain_shape": prefix},
           "compact_window": {
               "streams": len(streams),
               "device_ms": _device_ms(lambda: CC.compact_streams_dev(
                   streams, tails), 20, C_KERNEL),
               "wrapper_ms": _time_ms(lambda: CC.compact_streams_dev(
                   streams, tails), 20),
               "plain_ms": _time_ms(lambda: CC.compact_streams_plain(
                   streams, tails), 3),
               "bytes": c_bytes,
               "bound_ms": c_bytes / HBM_BYTES_PER_S * 1e3},
           "coder_span": {"window_ms": span, "block_spans_ms": block_spans,
                          "sum_ms": sum(block_spans)}}
    print(json.dumps({"window_kernels": out}), flush=True)
    return out


def window_path(data: bytes, level: int) -> tuple:
    """The 16k window path at `level` through api.encode_fastq /
    decode_fastq (4 blocks of 16,384 records, one window by default),
    the launch counts set to 0 just before and read just after: the
    container's size and SHA-256 equal the JAX package's, the round trip
    is exact, Kernel C runs once for the window and E and D once per
    stream group, each launch over several blocks (at level 4 a block
    takes a match trial). Returns (launches, descriptors) by kernel."""
    import io
    from slimfastq_tpu_torch import api, container
    from slimfastq_tpu_torch.models import matcher as M
    from slimfastq_tpu_torch.ops import _cuda
    from slimfastq_tpu_torch.pipeline import MATCH_USED
    _cuda.reset_launches()
    enc = api.encode_fastq(data, level=level, device="cuda",
                           block_records=WINDOW_RECORDS)
    dec = api.decode_fastq(enc, device="cuda")
    launches, descs = dict(_cuda.launches), dict(_cuda.descs)
    nbytes, want_sha = PINNED_16K[level]
    sha = hashlib.sha256(enc).hexdigest()
    if (len(enc), sha) != (nbytes, want_sha):
        raise AssertionError(f"16k L{level} container {len(enc)} bytes, "
                             f"SHA-256 {sha}: not the JAX package's")
    if dec != data:
        raise AssertionError(f"16k L{level} decode does not return the "
                             "input")
    f = io.BytesIO(enc)
    cfg = container.read_header(f)
    flags = [blk.flags for blk in container.iter_blocks(f, cfg)]
    if level == 3:
        # BASELINE.md's 16k L3 ratio is bench.py's: one block of
        # synth_fastq(16384) (a smaller genome than the 4-block set's)
        one = _pinned(WINDOW_RECORDS)
        ratio = len(one) / len(api.encode_fastq(
            one, level=3, device="cuda", block_records=WINDOW_RECORDS))
        if round(ratio, 4) != 6.2698:
            raise AssertionError(f"one 16k block's L3 ratio {ratio}")
    if level == 4 and not any(fl & MATCH_USED for fl in flags):
        raise AssertionError(f"16k L4 block flags {flags}: no MATCH_USED")
    # one E a stream name (7, and at level 4 each threshold's SEQ@t and
    # MATCH@t); D: the 5 aux streams, QUAL and SEQ, at level 4 MATCH and
    # SEQ's match-family launch; C once over the window's 28 or more
    # streams
    e_max, d_max = (7, 7) if level == 3 else (7 + 2 * len(M.THRESHOLDS), 9)
    if launches["compact_lanes_dev"] != 1 \
            or descs["compact_lanes_dev"] < 4 * 7 \
            or launches["lane_encode"] > e_max \
            or not _phases_even(launches) \
            or launches["lane_decode"] > d_max \
            or any(descs[k] <= launches[k]
                   for k in ("lane_encode", "lane_decode")):
        raise AssertionError(f"16k L{level} window launches {launches}, "
                             f"descriptors {descs}")
    print(f"window path L{level}: 4 x {WINDOW_RECORDS} records, {len(data)} "
          f"raw -> {len(enc)} bytes (ratio {len(data) / len(enc):.4f}), "
          f"SHA-256 equals the JAX package's, block flags {flags}, round "
          f"trip exact, launches {launches} (descriptors {descs})",
          flush=True)
    return launches, descs


def _walls(data: bytes, level: int, block_records: int, window) -> tuple:
    import torch
    from slimfastq_tpu_torch import api
    torch.cuda.synchronize()
    t = time.perf_counter()
    enc = api.encode_fastq(data, level=level, device="cuda",
                           block_records=block_records, window=window)
    t_enc = time.perf_counter() - t
    t = time.perf_counter()
    dec = api.decode_fastq(enc, device="cuda", window=window)
    t_dec = time.perf_counter() - t
    if dec != data:
        raise AssertionError(f"window {window}: round trip is not exact")
    return t_enc, t_dec, hashlib.sha256(enc).hexdigest()


def window_walls(data: bytes) -> dict:
    """Encode and decode walls of the 4 16k blocks with the window on (4)
    and one block at a time, at level 3 and level 4, in turns."""
    out = {}
    for level in (3, 4):
        runs = {4: [], 1: []}
        for window in (4, 1, 1, 4):
            t_enc, t_dec, sha = _walls(data, level, WINDOW_RECORDS, window)
            if sha != PINNED_16K[level][1]:
                raise AssertionError(f"window {window}: SHA-256 differs")
            runs[window].append((t_enc, t_dec))
        out[f"L{level}"] = {f"window_{w}": {"encode_s": [r[0] for r in v],
                                             "decode_s": [r[1] for r in v]}
                            for w, v in runs.items()}
    print(json.dumps({"window_walls": out}), flush=True)
    return out


def window_sweep(data4: bytes) -> dict:
    """Walls by window, each window once: level 3 with {1, 2, 4, 8} on 8
    blocks of 16,384 records (the first 131,072 records of the 4-block
    set), and on the 4-block set of 65,536-record blocks {1, 2, 4} at
    level 3 and {1, 4} at level 4. The bytes never depend on the
    window."""
    import numpy as np
    nl = np.flatnonzero(np.frombuffer(data4, dtype=np.uint8) == 10)
    data16 = data4[: int(nl[4 * 8 * WINDOW_RECORDS - 1]) + 1]
    out = {}
    for data, records, level, windows in (
            (data16, WINDOW_RECORDS, 3, (1, 2, 4, 8)),
            (data4, READS, 3, (1, 2, 4)),
            (data4, READS, 4, (1, 4))):
        runs, shas = {}, set()
        for w in windows:
            t_enc, t_dec, sha = _walls(data, level, records, w)
            runs[w] = {"encode_s": t_enc, "decode_s": t_dec}
            shas.add(sha)
        if len(shas) != 1:
            raise AssertionError(f"{records}-record blocks: the bytes depend "
                                 "on the window")
        blocks = (data.count(b"\n") // 4 + records - 1) // records
        out[f"L{level} {records}x{blocks}"] = runs
    print(json.dumps({"window_sweep": out}), flush=True)
    return out


def _peak_rss_mb(fn):
    """(fn(), the process's peak resident memory in MB while fn ran,
    sampled every 2 ms from /proc/self/statm by a watcher thread)."""
    import os
    import threading
    page = os.sysconf("SC_PAGE_SIZE")

    def rss():
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * page
    peak, done = [rss()], threading.Event()

    def watch():
        while not done.is_set():
            peak[0] = max(peak[0], rss())
            done.wait(0.002)
    t = threading.Thread(target=watch)
    t.start()
    try:
        out = fn()
    finally:
        done.set()
        t.join()
    return out, max(peak[0], rss()) / 1e6


def _streaming_child(d: str) -> int:
    """`chip_smoke.py --streaming-child DIR`, a fresh process: DIR/in.fq
    through api.encode_file_streaming (chunks that cut records) into
    DIR/out.sfq, then that output cut mid-way through its third block and
    resumed (it must come back the same), then decode_file_streaming into
    DIR/back.fq; prints one JSON line with the process's resident memory
    once the card is up and its peak during each phase."""
    import io
    import os
    import torch
    from slimfastq_tpu_torch import api, container
    from slimfastq_tpu_torch.ops import _cuda
    torch.zeros(1, device="cuda")
    _cuda.build()
    src, dst, back = (os.path.join(d, n) for n in ("in.fq", "out.sfq",
                                                    "back.fq"))
    kw = dict(level=3, device="cuda", block_records=WINDOW_RECORDS,
              chunk_bytes=STREAM_CHUNK)
    out = {"base_rss_mb": _peak_rss_mb(lambda: None)[1]}
    _, out["encode_peak_rss_mb"] = _peak_rss_mb(
        lambda: api.encode_file_streaming(src, dst, **kw))
    with open(dst, "rb") as f:
        full = f.read()
    offs = container.read_index(io.BytesIO(full))
    with open(dst, "wb") as f:
        f.write(full[: offs[2] + 1000])
    _, out["resume_peak_rss_mb"] = _peak_rss_mb(
        lambda: api.encode_file_streaming(src, dst, resume=True, **kw))
    with open(dst, "rb") as f:
        if f.read() != full:
            raise AssertionError("the resumed container differs")
    _, out["decode_peak_rss_mb"] = _peak_rss_mb(
        lambda: api.decode_file_streaming(dst, back, device="cuda"))
    print(json.dumps(out), flush=True)
    return 0


def streaming(data: bytes) -> dict:
    """The 4 16k blocks through the streaming path in a fresh process
    (_streaming_child, so its memory is its own): the streamed container
    equals encode_fastq's (the pinned SHA-256), the resumed copy equals
    it, and the streaming decode gives the input back."""
    import os
    import tempfile
    with tempfile.TemporaryDirectory() as d:
        with open(os.path.join(d, "in.fq"), "wb") as f:
            f.write(data)
        r = subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--streaming-child", d], capture_output=True,
                           text=True, timeout=300)
        if r.returncode:
            raise AssertionError(f"streaming phase failed:\n"
                                 f"{r.stdout[-2000:]}{r.stderr[-4000:]}")
        out = json.loads(r.stdout.strip().splitlines()[-1])
        with open(os.path.join(d, "out.sfq"), "rb") as f:
            full = f.read()
        if hashlib.sha256(full).hexdigest() != PINNED_16K[3][1]:
            raise AssertionError("streaming encode differs from "
                                 "encode_fastq's container")
        with open(os.path.join(d, "back.fq"), "rb") as f:
            if f.read() != data:
                raise AssertionError("streaming decode does not return the "
                                     "input")
    out.update(chunk_bytes=STREAM_CHUNK, raw_bytes=len(data),
               compressed_bytes=len(full))
    print(json.dumps({"streaming": out}), flush=True)
    return out


# ---------------------------------------------------------------------------
# phase 6: long reads, the host-pack path
# ---------------------------------------------------------------------------

def _long_read_kernels(pre, enc: bytes, dev, bar_us: float, cbar_us: dict,
                       errs: dict) -> dict:
    """Kernels E, D, C and L on the long block's QUAL stream, from the main
    path's own setup (pipeline_native.prepare_block_fast packs it on the
    host; _sq_jobs gives its inputs, pos/reset from Kernel L): E over the
    whole stream in one launch (CUDA events), D once on the container's
    QUAL payload (events; its symbols held against the host-packed ones),
    C on E's chunk buffers (events around its wrapper), L's step-input
    mode over the whole block (events; held against its plain version,
    _pos_reset); each beside its bound. E and its plain version over the
    stream's first 2 chunks, in `errs`."""
    import io
    import numpy as np
    import torch
    from slimfastq_tpu_torch import container
    from slimfastq_tpu_torch import pipeline_native as PN
    from slimfastq_tpu_torch.config import config_for_level
    from slimfastq_tpu_torch.ops import coder_torch as CT
    from slimfastq_tpu_torch.ops import compact_torch as CC
    from slimfastq_tpu_torch.ops import encode_torch as E
    from slimfastq_tpu_torch.ops import pack_torch as PT
    from slimfastq_tpu_torch.ops import streams_torch as ST
    cfg = config_for_level(3)
    q = next(PN._sq_jobs(pre, cfg, dev, only=("QUAL",)))
    item = q.item
    W, NC, depth = cfg.lanes, item.NC, q.geom.depth
    CB = ST._chunk_bytes(depth, hard=False)
    out = {"W": W, "NC": NC, "depth": depth, "bit_steps": NC * 8 * depth}
    # E and its plain version on the first 2 chunks (the plain version
    # takes ~1 s a chunk at W = 1024)
    head = CT.EncIn(item.syms[:16], item.pos[:16], item.reset[:16],
                    item.counts)
    t = time.perf_counter()
    plain = CT.lane_encode_blocks_plain([head], "qual", q.geom, CB)[0]
    out["plain_ms_2_chunks"] = (time.perf_counter() - t) * 1e3
    _compare(errs, "lane_encode", "E vs plain, long QUAL, first 2 chunks",
             CT.lane_encode_blocks([head], "qual", q.geom, CB)[0], plain)
    del plain
    _phases_vs_plain(errs, [head], "qual", q.geom, CB, "E's phases, long "
                     "QUAL, first 2 chunks")
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    total_ms, (ebufs, eptrs, low, emax) = _events_ms(
        lambda: CT.lane_encode_blocks([item], "qual", q.geom, CB)[0])
    if int(emax) > CB:
        raise AssertionError("long QUAL: optimistic chunk buffer overflowed")
    Sp = item.syms.shape[0]
    e_bytes = 9 * Sp * W + ebufs.numel() + eptrs.numel() * 4 + 2 * W * 4
    steps = NC * 8 * depth
    out["lane_encode"] = {
        "ms": total_ms, "bytes": e_bytes,
        "bound_ms": e_bytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
        "lane_coder_chain_bound_ms": steps * LINK_OPS["code"] * 4
        / SM_CLOCK_HZ * 1e3,
        "slices": -(-steps // E.slice_steps(1, W, steps)),
        "device_GB_above_inputs": (torch.cuda.max_memory_allocated() - base)
        / 1e9,
        "outputs_GB": (ebufs.numel() + eptrs.numel() * 4) / 1e9,
        "plain_ms_2_chunks": out["plain_ms_2_chunks"]}
    Bmax = int(eptrs.sum(dim=0).max())
    streams = [(ebufs, eptrs, Bmax)]
    c_bytes = _c_bytes(streams)
    # CUDA events around the wrapper: the profiler kept no record of C
    # after E's long run in one call on the H100
    out["compact_lanes_dev"] = {
        "ms": _time_ms(lambda: CC.compact_streams_dev(streams), 3),
        "timed": "CUDA events around the wrapper",
        "bytes": c_bytes, "bound_ms": c_bytes / HBM_BYTES_PER_S * 1e3,
        "bound_by": "bytes", "NC": NC, "Bmax": Bmax}
    del ebufs, eptrs, streams, item, head, q
    f = io.BytesIO(enc)
    blk = next(container.iter_blocks(f, container.read_header(f)))
    qs = blk.streams["QUAL"]
    ll_mat, counts = pre[4], pre[0]["QUAL"][3]
    S = int(counts.max())
    # L's step-input mode over the whole block against its plain version,
    # timed three times (events; each run writes 8.65 GB afresh)
    torch.cuda.empty_cache()
    l_runs = []
    for _ in range(3):
        l_ms, (pos, reset) = _events_ms(
            lambda: PT.step_inputs(ll_mat, Sp, S, W, dev))
        l_runs.append(l_ms)
        if len(l_runs) < 3:
            del pos, reset
    ppos, preset = PT._pos_reset(ST._lane_lens(ll_mat, W, dev), Sp, S, W)
    _compare(errs, "lane_layout", "L step inputs vs plain, long block",
             (pos, reset), (ppos, preset))
    del ppos, preset
    l_bytes = ll_mat.size * 4 + 8 * Sp * W
    out["lane_layout"] = {"ms": l_runs[0], "runs_ms": l_runs,
                          "ms_is": "the first run, on fresh device memory, "
                                   "as the main path launches it",
                          "mode": "step inputs (decode)", "bytes": l_bytes,
                          "bound_ms": l_bytes / HBM_BYTES_PER_S * 1e3,
                          "bound_by": "bytes"}
    item = (ST._payload_tensor(qs.payload, dev),
            ST._to(qs.lane_lens, dev, torch.int32),
            ST._to(counts, dev, torch.int32), pos, reset)
    d_ms, (syms,) = _events_ms(lambda: CT.lane_decode_blocks(
        [item], "qual", pre[0]["QUAL"][1]))
    if not np.array_equal(syms[:S].cpu().numpy(), pre[0]["QUAL"][2]):
        raise AssertionError("D on the long QUAL does not return its "
                             "host-packed symbols")
    steps = NC * 8 * depth
    out["lane_decode"] = {
        "ms": d_ms, **d_bound(steps, depth, bar_us, CT.decode_shape(
            pre[0]["QUAL"][1], W), cbar_us),
        "byte_bound_ms": (qs.payload.size + 2 * Sp * W * 4 + Sp * W
                          + 2 * W * 4) / HBM_BYTES_PER_S * 1e3,
        "us_per_bit_step": d_ms * 1e3 / steps}
    out["lane_encode"]["us_per_bit_step"] = \
        out["lane_encode"]["ms"] * 1e3 / steps
    return out


def _long_read_oom(data: bytes) -> dict:
    """The long block on a card that cannot hold it (the allocator held to
    a quarter of the card, which the window budget, from the free bytes,
    does not see): api.encode_file must fail with torch's OOM error, not
    hang, and leave no container; then the card codes again."""
    import os
    import tempfile
    import torch
    from slimfastq_tpu_torch import api
    with tempfile.TemporaryDirectory() as d:
        src, dst = os.path.join(d, "in.fq"), os.path.join(d, "out.sfq")
        with open(src, "wb") as f:
            f.write(data)
        torch.cuda.empty_cache()
        torch.cuda.set_per_process_memory_fraction(0.25)
        t = time.perf_counter()
        try:
            api.encode_file(src, dst, device="cuda")
        except torch.OutOfMemoryError as e:
            err = type(e).__name__
        else:
            raise AssertionError("the long block encoded in a quarter of "
                                 "the card")
        finally:
            torch.cuda.set_per_process_memory_fraction(1.0)
            torch.cuda.empty_cache()
        out = {"memory_fraction": 0.25, "raised": err,
               "s": time.perf_counter() - t,
               "container_left": os.path.exists(dst)}
    if out["container_left"]:
        raise AssertionError("an encode that ran out of device memory left "
                             "a container")
    return out


def long_read(dev, bar_us: float, cbar_us: dict, errs: dict) -> dict:
    """One block of 65,536 x 16.5 kb reads (LONG_READS x LONG_LEN: raw
    span >= 2 GiB, so SEQ and QUAL pack on the host) through
    api.encode_fastq / decode_fastq at the defaults (level 3, 65,536
    records a block) on the card, the launch counts set to 0 just before
    each direction and read just after: the round trip is exact, Kernel E
    coded each of the 7 streams in one launch, D, C and L ran, U did not.
    Prints the `long_read` line: walls and GB/s, the ratio, peak device
    memory each way, the launches, the block's device bytes against the
    window budget; then the long QUAL's kernels (_long_read_kernels)."""
    import numpy as np
    import torch
    from slimfastq_tpu_torch import api, native
    from slimfastq_tpu_torch import pipeline_native as PN
    from slimfastq_tpu_torch.config import config_for_level
    from slimfastq_tpu_torch.ops import _cuda
    from slimfastq_tpu_torch.ops import streams_torch as ST
    from slimfastq_tpu_torch.utils.synth import synth_fastq
    t = time.perf_counter()
    data = synth_fastq(LONG_READS, read_len=LONG_LEN, seed=0, var_len=False,
                       n_rate=0.0005)
    out = {"make_data_s": time.perf_counter() - t, "raw_bytes": len(data)}
    idx, n = native.fastq_index(data)
    out["span"] = PN.block_span(idx, 0, n)
    if out["span"] < 1 << 31:
        raise AssertionError(f"long block spans {out['span']} < 2^31 bytes")
    # the block as the main path prepares it (host prep timed), its device
    # bytes against the window budget: a second such block would take a
    # window of its own
    t = time.perf_counter()
    pre = PN.prepare_block_fast(np.frombuffer(data, dtype=np.uint8), idx, 0,
                                n, config_for_level(3))
    out["host_prep_s"] = time.perf_counter() - t
    torch.cuda.empty_cache()
    budget = ST.device_budget(dev)
    need = PN.device_bytes(pre, config_for_level(3))
    out.update(device_budget=budget, block_device_bytes=need,
               windows_of_two_such_blocks=ST.split_by_bytes([need, need],
                                                            budget))
    for way in ("encode", "decode"):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _cuda.reset_launches()
        t = time.perf_counter()
        if way == "encode":
            enc = api.encode_fastq(data, device="cuda")
        else:
            dec = api.decode_fastq(enc, device="cuda")
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t
        out[way] = {"wall_s": wall_s, "GB_per_s": len(data) / wall_s / 1e9,
                    "peak_device_GB": torch.cuda.max_memory_allocated()
                    / 1e9, "launches": dict(_cuda.launches),
                    "descriptors": dict(_cuda.descs)}
    if dec != data:
        raise AssertionError("long block: the round trip is not exact")
    del dec
    e, d = out["encode"], out["decode"]
    # the host packs and unpacks: Kernel L makes pos/reset, U does not
    # run; each stream one E launch (an overflowed one a second)
    if not 7 <= e["descriptors"]["lane_encode"] <= 14 \
            or not _phases_even(e["launches"]) \
            or e["launches"]["compact_lanes_dev"] < 1 \
            or d["launches"]["lane_decode"] < 2 \
            or e["launches"]["lane_layout"] != 1 \
            or d["launches"]["lane_layout"] != 1 \
            or d["launches"]["lane_unpack"] != 0:
        raise AssertionError(f"long block launches: encode {e}, decode {d}")
    out["ratio"] = len(data) / len(enc)
    out["compressed_bytes"] = len(enc)
    out["past_the_card"] = _long_read_oom(data)
    print(json.dumps({"long_read": out}), flush=True)
    del data
    out["kernels"] = _long_read_kernels(pre, enc, dev, bar_us, cbar_us,
                                        errs)
    print(json.dumps({"long_read_kernels": out["kernels"]}), flush=True)
    return out


def host_pack_pins(data: bytes) -> None:
    """The pinned 64k block through the host-pack path (the port's
    _MAX_SPAN lowered to 1): its container keeps the JAX package's
    SHA-256 at level 3 and at level 4 (MATCH_USED) and decodes exactly
    through the host unpack; Kernel E codes each stream in one launch."""
    import io
    from slimfastq_tpu_torch import api, container
    from slimfastq_tpu_torch import pipeline_native as PN
    from slimfastq_tpu_torch.ops import _cuda
    from slimfastq_tpu_torch.pipeline import MATCH_USED
    saved = PN._MAX_SPAN
    PN._MAX_SPAN = 1
    try:
        for level in (3, 4):
            _cuda.reset_launches()
            enc = api.encode_fastq(data, level=level, device="cuda")
            n_e = _cuda.launches["lane_encode"]
            sha = hashlib.sha256(enc).hexdigest()
            if (len(enc), sha) != PINNED[level] or n_e < 2:
                raise AssertionError(f"host-pack L{level}: {len(enc)} bytes, "
                                     f"SHA-256 {sha}, {n_e} E launches")
            f = io.BytesIO(enc)
            flags = next(container.iter_blocks(f, container.read_header(
                f))).flags
            if level == 4 and not flags & MATCH_USED:
                raise AssertionError("host-pack L4: no MATCH_USED")
            if api.decode_fastq(enc, device="cuda") != data:
                raise AssertionError(f"host-pack L{level}: the round trip "
                                     "is not exact")
            print(f"host-pack path L{level}: the pinned block's SHA-256, "
                  f"{n_e} E launches, flags {flags}, round trip exact",
                  flush=True)
    finally:
        PN._MAX_SPAN = saved


# ---------------------------------------------------------------------------
# phase 7: block sharding over the node's cards, the gather, level 1
# ---------------------------------------------------------------------------

def _sharded_walls(data: bytes, level: int, mesh) -> tuple:
    """(encode s, decode s, container, launches by shard) of `data`
    through the sharded path on `mesh`, or through api.encode_fastq /
    decode_fastq with mesh=None; the launch counts set to 0 just before
    and read just after."""
    import torch
    from slimfastq_tpu_torch import api
    from slimfastq_tpu_torch.config import config_for_level
    from slimfastq_tpu_torch.ops import _cuda
    from slimfastq_tpu_torch.parallel import sharded as SH
    cfg = config_for_level(level)
    torch.cuda.synchronize()
    _cuda.reset_launches()
    t = time.perf_counter()
    enc = (api.encode_fastq(data, cfg=cfg, device="cuda") if mesh is None
           else SH.encode_fastq_sharded(data, cfg, mesh=mesh))
    t_enc = time.perf_counter() - t
    t = time.perf_counter()
    dec = (api.decode_fastq(enc, device="cuda") if mesh is None
           else SH.decode_fastq_sharded(enc, mesh=mesh))
    t_dec = time.perf_counter() - t
    by_shard = {f"shard {i} on {d}": dict(v)
                for (i, d), v in sorted(_cuda.by_shard.items())}
    if dec != data:
        raise AssertionError(f"sharded L{level}: the round trip is not exact")
    if mesh is not None:
        kinds = set(_cuda.launches)  # E, D, C, L and U on every shard
        if len(by_shard) != min(mesh.size, data.count(b"\n") // 4 // READS
                                or 1) \
                or any(set(v) != kinds for v in by_shard.values()):
            raise AssertionError(f"sharded L{level} on {mesh.size} shards: "
                                 f"launches by shard {by_shard}")
    return t_enc, t_dec, enc, by_shard


def sharded(data: bytes, data4: bytes) -> dict:
    """The sharded path (parallel.sharded.encode_fastq_sharded /
    decode_fastq_sharded) on make_mesh() (every card) and on a mesh
    naming cuda:0 twice (two shard threads on one card): the pinned block
    keeps both SHA-256 pins; the 4 x 64k set at level 3 and 4 gives
    api.encode_fastq's container, with the walls of the single card, the
    mesh and the card twice in turns (single, mesh, twice, twice, mesh,
    single; after one untimed pass on each mesh, the first use of its
    cards) and each shard's launches. Returns (the `sharded` line, the
    4 x 64k set's level-3 container)."""
    from slimfastq_tpu_torch.parallel import mesh as M
    meshes = {"make_mesh": M.make_mesh(),
              "card_twice": M.make_mesh(devices=["cuda:0", "cuda:0"])}
    out = {"mesh_sizes": {k: m.size for k, m in meshes.items()}}
    wants = {}
    for mesh in meshes.values():  # every card's first use, untimed
        _sharded_walls(data4, 3, mesh)
    for level in (3, 4):
        for name, mesh in meshes.items():
            _, _, enc, _ = _sharded_walls(data, level, mesh)
            sha = hashlib.sha256(enc).hexdigest()
            if (len(enc), sha) != PINNED[level]:
                raise AssertionError(f"sharded L{level} on {name}: the "
                                     f"pinned block gives {len(enc)} bytes, "
                                     f"SHA-256 {sha}")
        runs = {"single": [], "make_mesh": [], "card_twice": []}
        want = None
        for name in ("single", "make_mesh", "card_twice", "card_twice",
                     "make_mesh", "single"):
            t_enc, t_dec, enc, by_shard = _sharded_walls(
                data4, level, meshes.get(name))
            want = want or enc
            if enc != want:
                raise AssertionError(f"sharded L{level} on {name}: the "
                                     "container differs from api's")
            runs[name].append({"encode_s": t_enc, "decode_s": t_dec,
                               "launches_by_shard": by_shard})
        out[f"L{level}"] = {"raw_bytes": len(data4),
                            "compressed_bytes": len(want), **runs}
        wants[level] = want
    print(json.dumps({"sharded": out}), flush=True)
    return out, wants[3]


def sharded_streaming(data: bytes) -> dict:
    """The 16k set through encode_file_streaming_sharded on the card named
    twice (chunks that cut records), a copy cut in its third block and
    resumed, and decode_file_streaming_sharded: the pinned 16k container
    (its SHA-256) and the input back; the launch counts set to 0 just
    before and read just after."""
    import io
    import os
    import tempfile
    from slimfastq_tpu_torch import container
    from slimfastq_tpu_torch.ops import _cuda
    from slimfastq_tpu_torch.parallel import mesh as M
    from slimfastq_tpu_torch.parallel import sharded as SH
    mesh = M.make_mesh(devices=["cuda:0", "cuda:0"])
    kw = dict(level=3, mesh=mesh, block_records=WINDOW_RECORDS,
              chunk_bytes=STREAM_CHUNK)
    out = {}
    with tempfile.TemporaryDirectory() as d:
        src, dst, back = (os.path.join(d, n) for n in ("in.fq", "o.sfq",
                                                        "b.fq"))
        with open(src, "wb") as f:
            f.write(data)
        _cuda.reset_launches()
        t = time.perf_counter()
        SH.encode_file_streaming_sharded(src, dst, **kw)
        out["encode_s"] = time.perf_counter() - t
        out["launches_by_shard"] = {f"shard {i} on {dv}": dict(v) for
                                    (i, dv), v in _cuda.by_shard.items()}
        with open(dst, "rb") as f:
            full = f.read()
        if hashlib.sha256(full).hexdigest() != PINNED_16K[3][1]:
            raise AssertionError("sharded streaming encode differs from the "
                                 "pinned 16k container")
        if len(out["launches_by_shard"]) != 2:
            raise AssertionError(f"sharded streaming: launches by shard "
                                 f"{out['launches_by_shard']}")
        offs = container.read_index(io.BytesIO(full))
        with open(dst, "wb") as f:
            f.write(full[: offs[2] + 1000])
        t = time.perf_counter()
        SH.encode_file_streaming_sharded(src, dst, resume=True, **kw)
        out["resume_s"] = time.perf_counter() - t
        with open(dst, "rb") as f:
            if f.read() != full:
                raise AssertionError("sharded streaming: the resumed "
                                     "container differs")
        t = time.perf_counter()
        SH.decode_file_streaming_sharded(dst, back, mesh=mesh)
        out["decode_s"] = time.perf_counter() - t
        with open(back, "rb") as f:
            if f.read() != data:
                raise AssertionError("sharded streaming decode does not "
                                     "return the input")
    print(json.dumps({"sharded_streaming": out}), flush=True)
    return out


def _gather_child(d: str) -> int:
    """`chip_smoke.py --gather-child DIR`, a fresh process: a process
    group of world size 1 on NCCL over a localhost TCP store
    (parallel.multihost.initialize); each DIR/shard{i}.sfq through
    parallel.gather.ragged_all_gather (timed, host clock around the call,
    which synchronises), merged (multihost.merge_containers) into
    DIR/merged.sfq; the group destroyed after. Prints one JSON line."""
    import glob
    import os
    import socket
    import torch
    import torch.distributed as dist
    from slimfastq_tpu_torch.parallel import gather, multihost
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    multihost.initialize(f"127.0.0.1:{port}", 1, 0, backend="nccl")
    try:
        if dist.get_backend() != "nccl":
            raise AssertionError("the process group is not on NCCL")
        shards = []
        for p in sorted(glob.glob(os.path.join(d, "shard*.sfq"))):
            with open(p, "rb") as f:
                shards.append(f.read())
        gather.ragged_all_gather(shards[0])  # warm-up: NCCL's first call
        parts, ms = [], []
        for sb in shards:
            torch.cuda.synchronize()
            t = time.perf_counter()
            parts += gather.ragged_all_gather(sb, return_parts=True)
            ms.append((time.perf_counter() - t) * 1e3)
        with open(os.path.join(d, "merged.sfq"), "wb") as f:
            f.write(multihost.merge_containers([q.tobytes() for q in parts]))
    finally:
        dist.destroy_process_group()
    # the least time of a call: the padded row up to the card and each
    # part down over the host link, the all_gather's copy (world size 1:
    # one row read and written) at the card's memory rate
    link = [2 * len(sb) for sb in shards]
    copy = [2 * len(sb) for sb in shards]
    bound = [a / PCIE_BYTES_PER_S * 1e3 + b / HBM_BYTES_PER_S * 1e3
             for a, b in zip(link, copy)]
    print(json.dumps({"world_size": 1, "backend": "nccl",
                      "shard_bytes": [len(sb) for sb in shards],
                      "gather_ms": ms, "bound_ms": bound,
                      "bound_by": "bytes",
                      "bound_rates": {"host_link_bytes_per_s":
                                      PCIE_BYTES_PER_S,
                                      "hbm_bytes_per_s": HBM_BYTES_PER_S}}),
          flush=True)
    return 0


def gather_nccl(data4: bytes, whole: bytes) -> dict:
    """ragged_all_gather over NCCL (world size 1, in a fresh process:
    _gather_child): the 4 x 64k set cut into 4 process shards
    (multihost.process_block_ranges), each shard's container gathered and
    merged: the whole container `whole`."""
    import os
    import tempfile
    from slimfastq_tpu_torch import api, native
    from slimfastq_tpu_torch.parallel import multihost
    idx, n = native.fastq_index(data4)
    with tempfile.TemporaryDirectory() as d:
        for p in range(WALL_BLOCKS):
            (lo, hi), = multihost.process_block_ranges(n, READS, WALL_BLOCKS,
                                                       p)
            start = int(idx["id_off"][lo]) - 1
            end = int(idx["id_off"][hi]) - 1 if hi < n else len(data4)
            with open(os.path.join(d, f"shard{p}.sfq"), "wb") as f:
                f.write(api.encode_fastq(data4[start:end], level=3,
                                         device="cuda"))
        r = subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--gather-child", d], capture_output=True,
                           text=True, timeout=240)
        if r.returncode:
            raise AssertionError(f"gather_nccl phase failed:\n"
                                 f"{r.stdout[-2000:]}{r.stderr[-4000:]}")
        out = json.loads(r.stdout.strip().splitlines()[-1])
        with open(os.path.join(d, "merged.sfq"), "rb") as f:
            if f.read() != whole:
                raise AssertionError("gathered shards merge into another "
                                     "container than the whole encode's")
    print(json.dumps({"gather_nccl": out}), flush=True)
    return out


def level1(data: bytes, dev, errs: dict) -> dict:
    """Level 1, whose SEQ and QUAL tables live in shared memory: the
    pinned block forced through the host-pack path equals the unforced
    L1 container and round-trips, the launch counts set to 0 just before
    and read just after (each SEQ/QUAL stream one E launch); its QUAL
    through E in one launch, timed (CUDA events), and E over the first 2
    chunks against its plain version (`errs`)."""
    import numpy as np
    from slimfastq_tpu_torch import api, native
    from slimfastq_tpu_torch import pipeline_native as PN
    from slimfastq_tpu_torch.config import config_for_level
    from slimfastq_tpu_torch.ops import _cuda
    from slimfastq_tpu_torch.ops import coder_torch as CT
    from slimfastq_tpu_torch.ops import streams_torch as ST
    cfg = config_for_level(1)
    if not (CT.table_in_smem(cfg.qual) and CT.table_in_smem(cfg.seq)):
        raise AssertionError("L1 tables do not live in shared memory")
    want = api.encode_fastq(data, cfg=cfg, device="cuda")
    saved, kinds = (PN._MAX_SPAN, CT.lane_encode_blocks), []

    def spy(items, kind, *args):
        kinds.extend([kind] * len(items))
        return saved[1](items, kind, *args)
    PN._MAX_SPAN, CT.lane_encode_blocks = 1, spy
    try:
        _cuda.reset_launches()
        enc = api.encode_fastq(data, cfg=cfg, device="cuda")
        n_e = _cuda.launches["lane_encode"]
        if enc != want or kinds.count("qual") != 1 \
                or kinds.count("seq") != 1:
            raise AssertionError(f"host-pack L1: {len(enc)} bytes (the "
                                 f"unforced {len(want)}), {n_e} E launches "
                                 f"of {kinds}")
        if api.decode_fastq(enc, device="cuda") != data:
            raise AssertionError("host-pack L1: the round trip is not exact")
    finally:
        PN._MAX_SPAN, CT.lane_encode_blocks = saved
    idx, n = native.fastq_index(data)
    pre = PN.prepare_block_fast(np.frombuffer(data, dtype=np.uint8), idx, 0,
                                n, cfg)
    q = next(PN._sq_jobs(pre, cfg, dev, only=("QUAL",)))
    CB = ST._chunk_bytes(q.geom.depth, hard=False)
    one_ms, _ = _events_ms(lambda: CT.lane_encode_blocks(
        [q.item], "qual", q.geom, CB)[0])
    part = CT.EncIn(q.syms[:16], q.pos[:16], q.reset[:16], q.counts)
    _compare(errs, "lane_encode", "L1 QUAL (a shared-memory table): E over "
             "2 chunks vs its plain version",
             CT.lane_encode_blocks([part], "qual", q.geom, CB)[0],
             CT.lane_encode_blocks_plain([part], "qual", q.geom, CB)[0])
    _phases_vs_plain(errs, [part], "qual", q.geom, CB, "E's phases, L1 "
                     "QUAL, first 2 chunks")
    out = {"unforced_bytes": len(want), "forced_e_launches": n_e,
           "qual_one_launch_ms": one_ms, "qual_NC": q.item.NC,
           "table_bytes": CT.table_bytes(q.geom)}
    print(json.dumps({"level1": out}), flush=True)
    return out


# ---------------------------------------------------------------------------
# phase 8: the host-side reference paths
# ---------------------------------------------------------------------------

# launches a direction of the pinned block through the pure-Python
# pipeline, by level: every stream its own E and C (level 4: the plain SEQ
# and both trials' SEQ and MATCH), D once a stream (level 4: MATCH too)
PYTHON_LAUNCHES = {
    3: ({"lane_encode": 7, "lane_decode": 0, "compact_lanes_dev": 7,
         "lane_layout": 0, "lane_unpack": 0, "encode_run": 7},
        {"lane_encode": 0, "lane_decode": 7, "compact_lanes_dev": 0,
         "lane_layout": 0, "lane_unpack": 0, "encode_run": 0}),
    4: ({"lane_encode": 11, "lane_decode": 0, "compact_lanes_dev": 11,
         "lane_layout": 0, "lane_unpack": 0, "encode_run": 11},
        {"lane_encode": 0, "lane_decode": 8, "compact_lanes_dev": 0,
         "lane_layout": 0, "lane_unpack": 0, "encode_run": 0}),
}


def _profiled(fn) -> tuple:
    """(fn(), {host wall ms, device busy ms (the union of the device
    intervals), device ms summed, launches}) of one run under
    torch.profiler, the launch counts set to 0 just before and read just
    after."""
    from slimfastq_tpu_torch.ops import _cuda
    from tools.gpu_profile import _profile
    _cuda.reset_launches()
    out, rep = _profile(fn)
    return out, {"host_ms": rep["wall_s"] * 1e3,
                 "device_busy_ms": rep["device_busy_s"] * 1e3,
                 "device_sum_ms": rep["device_sum_s"] * 1e3,
                 "launches": dict(_cuda.launches)}


def python_pipeline(data: bytes) -> dict:
    """The pinned block through the pure-Python pipeline on the card
    (use_native=False) at level 3 and 4, and at level 3 through the
    sharded path on make_mesh(): both SHA-256 pins, exact round trips,
    the launches of each direction as PYTHON_LAUNCHES says, level 4's
    MATCH_USED; then the NumPy oracle (backend="oracle") against the card
    on a 2,048-read input, with no launch and no device allocation."""
    import io
    import torch
    from slimfastq_tpu_torch import api, container
    from slimfastq_tpu_torch.config import config_for_level
    from slimfastq_tpu_torch.ops import _cuda
    from slimfastq_tpu_torch.parallel import mesh as M
    from slimfastq_tpu_torch.parallel import sharded as SH
    from slimfastq_tpu_torch.pipeline import MATCH_USED
    out = {}
    for level in (3, 4):
        enc, e = _profiled(lambda: api.encode_fastq(
            data, level=level, device="cuda", use_native=False))
        dec, d = _profiled(lambda: api.decode_fastq(
            enc, device="cuda", use_native=False))
        if (len(enc), hashlib.sha256(enc).hexdigest()) != PINNED[level]:
            raise AssertionError(f"use_native=False L{level}: the pinned "
                                 f"block gives {len(enc)} bytes")
        if dec != data:
            raise AssertionError(f"use_native=False L{level}: the round "
                                 "trip is not exact")
        f = io.BytesIO(enc)
        cfg = container.read_header(f)
        flags = [blk.flags for blk in container.iter_blocks(f, cfg)]
        if level == 4 and not flags[0] & MATCH_USED:
            raise AssertionError(f"use_native=False L4: flags {flags}")
        # E's phases: once a slice of each stream (at level 3 as the
        # block's streams give them: phase_counts), never to decode
        want_e, want_d = PYTHON_LAUNCHES[level]
        phases = {k: e["launches"][k] for k in E_PHASES}
        if level == 3:
            phases = phase_counts(data, level, torch.device("cuda"))
        want_e = {**want_e, **phases}
        want_d = {**want_d, **dict.fromkeys(phases, 0)}
        if (e["launches"], d["launches"]) != (want_e, want_d) \
                or not _phases_even(e["launches"]):
            raise AssertionError(f"use_native=False L{level}: launches "
                                 f"{e['launches']} / {d['launches']}")
        out[f"L{level}"] = {"encode": e, "decode": d, "flags": flags}
    mesh = M.make_mesh()
    enc, e = _profiled(lambda: SH.encode_fastq_sharded(
        data, config_for_level(3), mesh=mesh, use_native=False))
    dec, d = _profiled(lambda: SH.decode_fastq_sharded(
        enc, mesh=mesh, use_native=False))
    if (len(enc), hashlib.sha256(enc).hexdigest()) != PINNED[3] \
            or dec != data:
        raise AssertionError("use_native=False on make_mesh(): not the "
                             "single card's container or round trip")
    if not all(e["launches"][k] for k in ("lane_encode",
                                          "compact_lanes_dev")) \
            or not d["launches"]["lane_decode"]:
        raise AssertionError(f"use_native=False on make_mesh(): launches "
                             f"{e['launches']} / {d['launches']}")
    out["L3_make_mesh"] = {"mesh_size": mesh.size, "encode": e,
                           "decode": d}
    small = _pinned(ORACLE_READS)
    card = api.encode_fastq(small, level=3, device="cuda")
    torch.cuda.synchronize()
    _cuda.reset_launches()
    allocs = torch.cuda.memory_stats().get("allocation.all.allocated", 0)
    t = time.perf_counter()
    enc = api.encode_fastq(small, level=3, backend="oracle")
    t_enc = time.perf_counter() - t
    t = time.perf_counter()
    dec = api.decode_fastq(enc, backend="oracle")
    t_dec = time.perf_counter() - t
    untouched = (all(v == 0 for v in _cuda.launches.values()) and
                 torch.cuda.memory_stats().get("allocation.all.allocated",
                                               0) == allocs)
    if enc != card or dec != small or not untouched:
        raise AssertionError(f"oracle: container equal {enc == card}, "
                             f"round trip {dec == small}, card untouched "
                             f"{untouched}")
    out["oracle"] = {"reads": ORACLE_READS, "compressed_bytes": len(enc),
                     "encode_ms": t_enc * 1e3, "decode_ms": t_dec * 1e3,
                     "launches": dict(_cuda.launches),
                     "device_allocations": 0}
    print(json.dumps({"python_pipeline": out}), flush=True)
    return out


def single_stream_pack(data: bytes, dev, errs: dict) -> dict:
    """pack_device / unpack_device (ops/pack_torch: Kernel L's and U's
    single-stream modes, the JAX package's single-stream pack_jax.py:75 /
    :93, which no path runs) on the pinned block's QUAL (through its bias)
    and SEQ (through the map) at W = 1024: each against its plain version
    (pack_device_plain / unpack_device_plain) on whole arrays (the [Sp, W]
    matrix with its rows past a lane's count, the [pad_flat(total)] buffer
    with its bytes past the total), the largest difference in `errs`
    under the kernel's name; device time (profiler records), wrapper time
    (CUDA events) and the plain version's beside each one's byte bound
    (pack: the stream's bytes, int32 offsets and lengths [Rpl, W], the map
    read, the [Sp, W] symbols written; unpack: the active symbols, int32
    offsets and lengths [n] read, the [pad_flat(total)] buffer written);
    the unpack gives QUAL back."""
    import numpy as np
    import torch
    from slimfastq_tpu_torch import native
    from slimfastq_tpu_torch.ops import pack_torch as PT
    from slimfastq_tpu_torch.ops.ranger import pad_steps
    from slimfastq_tpu_torch.pipeline_native import (_BASE_TO_CODE_DEV,
                                                     _CODE_TO_BASE_FULL)
    buf = np.frombuffer(data, dtype=np.uint8)
    idx, n = native.fastq_index(data)
    W = 1024
    lengths = idx["seq_len"].astype(np.int64)
    minq, _ = native.minmax_ranges(buf, idx["qual_off"], lengths)
    Sp = pad_steps(int(np.bincount(np.arange(n) % W, weights=lengths,
                                   minlength=W).max()))
    dpad = np.zeros(PT.pad_flat(len(buf)), dtype=np.uint8)
    dpad[: len(buf)] = buf
    d = torch.from_numpy(dpad).to(dev)
    starts = np.zeros(n, dtype=np.int64)
    starts[1:] = np.cumsum(lengths[:-1])
    total = int(lengths.sum())
    Rpl = -(-n // W)
    out = {"shape": f"the pinned block: n = {n}, W = {W}, Sp = {Sp}"}
    for name, offs, fwd, back in (
            ("qual", idx["qual_off"].astype(np.int64), dict(bias=minq),
             dict(bias=minq)),
            ("seq", idx["seq_off"].astype(np.int64),
             dict(map256=_BASE_TO_CODE_DEV),
             dict(map256=_CODE_TO_BASE_FULL))):
        def pack():
            return PT.pack_device(d, offs, lengths, W, Sp, **fwd)

        def pack_plain():
            return PT.pack_device_plain(d, offs, lengths, W, Sp, **fwd)
        syms = pack()
        _compare(errs, "lane_layout", f"single-stream L, {name}", syms,
                 pack_plain())

        def unpack():
            return PT.unpack_device(syms, starts, lengths, W, total, **back)

        def unpack_plain():
            return PT.unpack_device_plain(syms, starts, lengths, W, total,
                                          **back)
        flat = unpack()
        _compare(errs, "lane_unpack", f"single-stream U, {name}", flat,
                 unpack_plain())
        if name == "qual":
            want = np.concatenate([buf[o: o + L]
                                   for o, L in zip(offs, lengths)])
            if not np.array_equal(flat[:total].cpu().numpy(), want):
                raise AssertionError("unpack_device does not give QUAL "
                                     "back")
        nb = {"pack": total + 8 * Rpl * W + 256 + Sp * W,
              "unpack": total + 8 * n + 256 + PT.pad_flat(total)}
        for f, fn, fp, key in (("pack", pack, pack_plain,
                                "lane_layout_kernel"),
                               ("unpack", unpack, unpack_plain,
                                "lane_unpack_kernel")):
            out[f"{f}_{name}"] = {
                "ms": _device_ms(fn, 20, key), "wrapper_ms": _time_ms(fn, 20),
                "plain_ms": _time_ms(fp, 3), "bytes": nb[f],
                "bound_ms": nb[f] / HBM_BYTES_PER_S * 1e3,
                "bound_by": "bytes"}
    print(json.dumps({"single_stream_pack": out}), flush=True)
    return out


# ---------------------------------------------------------------------------
# phase 9: the entry points; phase 10: the streaming run at scale
# ---------------------------------------------------------------------------

def entry_phase() -> dict:
    """The port's entry points (slimfastq_tpu_torch/entry.py): entry()'s
    flagship step (Kernel E on level-3 QUAL symbols) on the card,
    the launch counts set to 0 just before and read just after (Kernel E
    once), equals the same fn on the CPU (its plain version) byte for
    byte; then dryrun_multichip over every card round-trips its three
    phases (toy L2, L3 at W = 1024 / 64, L4 with MATCH_USED), every
    kernel launched. Prints the `entry` line."""
    import torch
    from slimfastq_tpu_torch import entry
    from slimfastq_tpu_torch.ops import _cuda
    fn, args = entry.entry()
    fn(*args)  # warm
    torch.cuda.synchronize()
    _cuda.reset_launches()
    t = time.perf_counter()
    got = fn(*args)
    torch.cuda.synchronize()
    out = {"ms": (time.perf_counter() - t) * 1e3,
           "launches": dict(_cuda.launches),
           "shape": "L3 QUAL, S = 256, W = 128"}
    fn_cpu, args_cpu = entry.entry(device="cpu")
    t = time.perf_counter()
    ref = fn_cpu(*args_cpu)
    out["plain_ms"] = (time.perf_counter() - t) * 1e3
    out["max_abs_err"] = max(
        int((a.cpu().long() - b.long()).abs().max()) if a.numel() else 0
        for a, b in zip(got, ref))
    if out["max_abs_err"] or out["launches"]["lane_encode"] != 1:
        raise AssertionError(f"entry() on the card: {out}")
    n = torch.cuda.device_count()
    _cuda.reset_launches()
    t = time.perf_counter()
    enc = entry.dryrun_multichip(n)
    dry = {"n_devices": n, "s": time.perf_counter() - t,
           "launches": dict(_cuda.launches),
           "compressed_bytes": {k: len(v) for k, v in enc.items()}}
    if not all(dry["launches"].values()):
        raise AssertionError(f"dryrun_multichip: {dry}")
    out["dryrun_multichip"] = dry
    print(json.dumps({"entry": out}), flush=True)
    return out


def streaming_scale() -> dict:
    """tools/bench_1gb_torch.py's streaming run at STREAM_SCALE_BYTES,
    level 3: the CLI's streaming encode and decode, each in a fresh
    process, over two 256 MiB read chunks; the round trip exact, walls,
    GB/s, each process's peak RSS against the base of one that only
    creates the CUDA context, the ratio. Prints the `streaming_scale`
    line."""
    import tempfile
    from tools import bench_1gb_torch as B
    with tempfile.TemporaryDirectory() as d:
        out = B.streaming_scale([STREAM_SCALE_BYTES], d, level=3)
    row = out["sizes"][0]
    if row["chunks"] != 2 or not row["round_trip_exact"]:
        raise AssertionError(f"streaming_scale: {row}")
    print(json.dumps({"streaming_scale": out}), flush=True)
    return out


# ---------------------------------------------------------------------------
# phase 11: the native matcher's faults
# ---------------------------------------------------------------------------

def sampled_kmer_fastq(n: int, seed: int = 0) -> bytes:
    """n reads of 16 bp, each a distinct 16-mer k with mix64(k) & 15 == 0
    (the default sampling mask takes it): every read is one key of the
    matcher's index, 16 times the keys its first sizing expects."""
    import numpy as np
    rng = np.random.default_rng(seed)
    k = rng.integers(0, 1 << 32, size=64 * n, dtype=np.uint64)
    x = k.copy()  # splitmix64's finalizer
    x ^= x >> np.uint64(30)
    x *= np.uint64(0xBF58476D1CE4E5B9)
    x ^= x >> np.uint64(27)
    x *= np.uint64(0x94D049BB133111EB)
    x ^= x >> np.uint64(31)
    k = k[(x & np.uint64(15)) == 0]
    _, first = np.unique(k, return_index=True)
    k = k[np.sort(first)][:n]
    shifts = np.uint64(2) * np.arange(15, -1, -1, dtype=np.uint64)
    codes = ((k[:, None] >> shifts) & np.uint64(3)).astype(np.uint8)
    seq = np.frombuffer(b"ACGT", dtype=np.uint8)[codes]
    qual = rng.integers(35, 74, size=(n, 16), dtype=np.uint8)
    return b"".join(b"@s%d\n%s\n+\n%s\n" % (i, seq[i].tobytes(),
                                             qual[i].tobytes())
                    for i in range(n))


def _matcher_child(d: str) -> int:
    """`chip_smoke.py --matcher-child DIR`, a fresh process: DIR/in.fq
    through api.encode_fastq(level=4) on the card, the launch counts set
    to 0 just before and read just after, native.match_find_arrays timed
    on the host clock; api.decode_fastq on the card the same way; the
    NumPy oracle's container (backend="oracle"). Writes DIR/card.sfq and
    DIR/oracle.sfq and prints one JSON line."""
    import os
    import torch
    from slimfastq_tpu_torch import api, native
    from slimfastq_tpu_torch.ops import _cuda
    torch.zeros(1, device="cuda")
    _cuda.build()
    with open(os.path.join(d, "in.fq"), "rb") as f:
        data = f.read()
    find_ms, real_find = [], native.match_find_arrays

    def find(*a, **k):
        t = time.perf_counter()
        try:
            return real_find(*a, **k)
        finally:
            find_ms.append((time.perf_counter() - t) * 1e3)
    out = {}
    native.match_find_arrays = find
    try:
        _cuda.reset_launches()
        t = time.perf_counter()
        enc = api.encode_fastq(data, level=4, device="cuda")
        torch.cuda.synchronize()
        out["encode_ms"] = (time.perf_counter() - t) * 1e3
        out["encode_launches"] = dict(_cuda.launches)
    finally:
        native.match_find_arrays = real_find
    out["match_find_ms"] = find_ms
    _cuda.reset_launches()
    t = time.perf_counter()
    dec = api.decode_fastq(enc, device="cuda")
    torch.cuda.synchronize()
    out["decode_ms"] = (time.perf_counter() - t) * 1e3
    out["decode_launches"] = dict(_cuda.launches)
    out["round_trip_exact"] = dec == data
    t = time.perf_counter()
    oracle = api.encode_fastq(data, level=4, backend="oracle")
    out["oracle_encode_ms"] = (time.perf_counter() - t) * 1e3
    for name, blob in (("card.sfq", enc), ("oracle.sfq", oracle)):
        with open(os.path.join(d, name), "wb") as f:
            f.write(blob)
    print(json.dumps(out), flush=True)
    return 0


def matcher_faults() -> dict:
    """FAULT_READS reads that fill the native matcher's first index table
    (sampled_kmer_fastq) through the level-4 main path on the card in a
    fresh process (_matcher_child) under FAULT_LIMIT_S: it returns, the
    matcher ran once, Kernels E and C (encode) and D (decode) launched,
    the container equals the oracle's byte for byte and the round trip is
    exact. Prints the `matcher_faults` line, match_find's milliseconds in
    it."""
    import os
    import tempfile
    data = sampled_kmer_fastq(FAULT_READS)
    with tempfile.TemporaryDirectory() as d:
        with open(os.path.join(d, "in.fq"), "wb") as f:
            f.write(data)
        try:
            r = subprocess.run([sys.executable, os.path.abspath(__file__),
                                "--matcher-child", d], capture_output=True,
                               text=True, timeout=FAULT_LIMIT_S)
        except subprocess.TimeoutExpired:
            raise AssertionError(f"matcher_faults: the level-4 encode did "
                                 f"not end within {FAULT_LIMIT_S} s")
        if r.returncode:
            raise AssertionError(f"matcher_faults phase failed:\n"
                                 f"{r.stdout[-2000:]}{r.stderr[-4000:]}")
        out = json.loads(r.stdout.strip().splitlines()[-1])
        with open(os.path.join(d, "card.sfq"), "rb") as f:
            card = f.read()
        with open(os.path.join(d, "oracle.sfq"), "rb") as f:
            oracle = f.read()
    e, dl = out["encode_launches"], out["decode_launches"]
    out.update(reads=FAULT_READS, raw_bytes=len(data),
               compressed_bytes=len(card), equals_oracle=card == oracle,
               sha256=hashlib.sha256(card).hexdigest())
    if not (out["equals_oracle"] and out["round_trip_exact"]
            and len(out["match_find_ms"]) == 1
            and e.get("lane_encode") and e.get("compact_lanes_dev")
            and dl.get("lane_decode")):
        raise AssertionError(f"matcher_faults: {out}")
    print(json.dumps({"matcher_faults": out}), flush=True)
    return out


def _by_shard(shard: dict, name: str) -> dict:
    """Kernel `name`'s launches by shard in the level-3 sharded runs of
    the 4 x 64k set (the first run on each mesh)."""
    return {mesh: {k: v.get(name, 0) for k, v in
                   shard["L3"][mesh][0]["launches_by_shard"].items()}
            for mesh in ("make_mesh", "card_twice")}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from slimfastq_tpu_torch.ops import _cuda
    from tools.compact_phase import phase
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"{card} | torch {torch.__version__} cuda {torch.version.cuda}",
          flush=True)
    dev = torch.device("cuda")

    t = time.perf_counter()
    reports = _cuda.build()
    print(f"build: {time.perf_counter() - t:.1f} s", flush=True)
    for name, rep in reports.items():
        for line in rep.splitlines():
            if "Function properties for" in line:
                fn = _kernel_name(line)
            elif "registers" in line or "spill" in line:
                print(f"  {name}.cu ptxas {fn}: {line.strip()}", flush=True)

    # seconds each phase took, printed as the `phase_s` line; each phase
    # under PHASE_LIMIT_S (SIGALRM's default action ends the process: a
    # kernel that never returns cannot hold the card past it)
    phase_s, last = {}, [time.perf_counter()]
    signal.alarm(PHASE_LIMIT_S)

    def done(name: str) -> None:
        now = time.perf_counter()
        phase_s[name] = now - last[0]
        last[0] = now
        signal.alarm(PHASE_LIMIT_S)

    plain, errs, plain4, errs4 = check_kernels(dev)
    check_ragged(dev, errs)
    done("kernels_vs_plain")
    check_windows(dev, errs)
    done("windows_vs_plain")
    data = _pinned(READS)
    data4 = _pinned(READS * WALL_BLOCKS)
    done("make_data")
    times = time_kernels(data, dev, errs)
    times4 = time_kernels_l4(data, dev, errs4)
    done("time_kernels")
    comp = block_compaction(data, dev, 3, errs)
    comp4 = block_compaction(data, dev, 4, errs4)
    phases = {}
    for level in (3, 4):
        phases[level] = phase(data, level, dev)
        print(json.dumps({f"compact_phase_l{level}": phases[level]}),
              flush=True)
    bar_us = barrier_us(dev)
    print(json.dumps({"barrier_us": bar_us}), flush=True)
    cbar_us = cluster_barrier_us(dev)
    print(json.dumps({"cluster_barrier_us": cbar_us}), flush=True)
    done("compaction_and_barrier")
    launches = main_path(data, 3)
    spans = block_spans(data, dev)
    wall(data4, dev, 3)
    pool_reuse(data4)
    done("main_path_l3")
    launches4 = main_path(data, 4)
    spans4 = l4_spans(data, dev)
    wall(data4, dev, 4)
    done("main_path_l4")
    # lane counts past 1,024: pins and the W sweep to 65,536
    wide = wide_lanes(data, dev, card, bar_us, cbar_us)
    done("wide_lanes")
    # the header's other geometries: 32-bit entries, FLAG's device table
    geo = geometries(data, dev, card, errs)
    done("geometries")
    # the small-block window path on the same 4-block set
    win = time_window(data, dev, bar_us, cbar_us, errs)
    done("window_kernels")
    wlaunches = {level: window_path(data, level) for level in (3, 4)}
    done("window_path")
    window_walls(data)
    done("window_walls")
    window_sweep(data4)
    done("window_sweep")
    streaming(data)
    done("streaming")
    # long reads: the host-pack path, Kernel E once a stream
    lr = long_read(dev, bar_us, cbar_us, errs)
    done("long_read")
    host_pack_pins(data)
    done("host_pack_pins")
    # block sharding, the NCCL gather, level 1's shared-memory tables
    shard, whole = sharded(data, data4)
    done("sharded")
    sharded_streaming(data)
    done("sharded_streaming")
    gather_nccl(data4, whole)
    done("gather_nccl")
    l1 = level1(data, dev, errs)
    done("level1")
    # the host-side reference paths: the pure-Python pipeline on the card
    # and on make_mesh(), the NumPy oracle, the single-stream pack
    t = time.perf_counter()
    python_pipeline(data)
    print(json.dumps({"python_pipeline_s": time.perf_counter() - t}),
          flush=True)
    done("python_pipeline")
    single = single_stream_pack(data, dev, errs)
    done("single_stream_pack")
    # the entry points and the streaming run at scale
    entry_phase()
    done("entry")
    streaming_scale()
    done("streaming_scale")
    # the native matcher's faults, on the level-4 main path
    matcher_faults()
    done("matcher_faults")

    replaces = {
        "lane_encode": "slimfastq_tpu/ops/streams_jax.py:298",
        "lane_decode": "slimfastq_tpu/ops/streams_jax.py:450",
        "compact_lanes_dev": "slimfastq_tpu/ops/compact_pallas.py:40",
        "lane_layout": "slimfastq_tpu/ops/pack_jax.py:134",
        "lane_unpack": "slimfastq_tpu/ops/pack_jax.py:152",
    }
    # the device programs each kernel took in beside the one it replaces
    also = {"lane_encode": ["slimfastq_tpu/ops/streams_jax.py:91",
                            "slimfastq_tpu/ops/streams_jax.py:207",
                            "slimfastq_tpu/ops/streams_jax.py:262"],
            "lane_layout": ["slimfastq_tpu/ops/streams_jax.py:241",
                            "slimfastq_tpu/ops/pack_jax.py:75"],
            "lane_unpack": ["slimfastq_tpu/ops/pack_jax.py:93"]}
    source = {"lane_encode": "slimfastq_tpu_torch/csrc/encode.cu",
              "lane_decode": "slimfastq_tpu_torch/csrc/coder.cu",
              "compact_lanes_dev": "slimfastq_tpu_torch/csrc/compact.cu",
              "lane_layout": "slimfastq_tpu_torch/csrc/lanes.cu",
              "lane_unpack": "slimfastq_tpu_torch/csrc/lanes.cu"}
    shape = times["shape"]
    kernels = []
    for name in ("lane_encode", "lane_decode"):
        ms, nbytes = times[name]
        row = {
            "name": name, "route": "cuda", "source": source[name],
            "replaces": replaces[name], "also_replaces": also.get(name, []),
            "launches": launches[name],
            "match": errs[name] == 0, "max_abs_err": errs[name],
            "ms": ms, "plain_ms": plain[name],
            "plain_shape": "W=1024 Sp=256 qual",
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
            "bound_by": "bytes", "library_ms": None, "shape": shape}
        direction = "encode" if name == "lane_encode" else "decode"
        steps = times["bit_steps"]
        row.update({
            "bit_steps": steps, "us_per_bit_step": ms * 1e3 / steps,
            "barrier_us": bar_us,
            "block_streams_ms": spans[direction]["streams_ms"],
            "block_span_ms": spans[direction]["span_ms"],
            "block_sum_ms": spans[direction]["sum_ms"]})
        if name == "lane_encode":
            # E's table evolves with its inputs alone: the decoupled
            # encode needs no barrier and its bound is the byte bound;
            # its phases are rows of their own below
            row.update(slices=times["phases"]["slices"],
                       slice_bit_steps=times["phases"]["slice_bit_steps"],
                       phases_one_after_another_ms={
                           k: v["ms"] for k, v in
                           times["phases"]["phases"].items()})
        else:
            # D's law couples the lanes once a symbol-step: two CTA
            # barriers a symbol-step or the lane coder's chain, whichever
            # is larger, is the floor of the function (d_bound), the
            # design's cluster barriers beside it as their cost; then
            # QUAL's and SEQ's shapes, the cluster barrier and E's lane
            # coder a bit-step on the same stream (the coder chain
            # without the law)
            from slimfastq_tpu_torch.config import config_for_level
            from slimfastq_tpu_torch.ops import coder_torch as CT
            c3 = config_for_level(3)
            sq = CT.decode_shape(c3.seq, shape["W"])
            qs = CT.decode_shape(c3.qual, shape["W"])
            row.update({
                **d_bound(steps, c3.qual.depth, bar_us, qs, cbar_us),
                "byte_bound_ms": row["bound_ms"],
                "decode_shapes": {
                    "QUAL": qs._asdict(),
                    "SEQ": sq._asdict()},
                "cluster_barrier_us": cbar_us,
                "seq_cluster_barrier_us": cbar_us.get(
                    f"{sq.cluster}x{sq.threads}"),
                "e_lane_coder_us_per_bit_step":
                    times["phases"]["phases"]["code"]["ms"] * 1e3 / steps})
        # level 4: the pinned block's SEQ stream (the winning match trial,
        # order-11 table); the checks of phase 3 at level 4
        ms4, nbytes4 = times4[name]
        steps4 = times4["bit_steps"]
        l4 = {"launches": launches4[name], "max_abs_err": errs4[name],
              "ms": ms4, "plain_ms": plain4[name],
              "plain_shape": "W=1024 Sp=256 seq, match family",
              "bound_ms": nbytes4 / HBM_BYTES_PER_S * 1e3,
              "bound_by": "bytes", "shape": times4["shape"],
              "bit_steps": steps4, "us_per_bit_step": ms4 * 1e3 / steps4}
        if name == "lane_encode":
            l4.update({"block_streams_ms": spans4["streams_ms"]})
        if name == "lane_decode":
            s4 = CT.decode_shape(config_for_level(4).seq, times4["shape"]["W"])
            l4.update({**d_bound(steps4, 2, bar_us, s4, cbar_us),
                       "byte_bound_ms": l4["bound_ms"],
                       "seq_shape": s4._asdict(),
                       "block_streams_ms": {
                           **spans4["decode_streams_ms"], "SEQ": ms4},
                       "device_half_ms": spans4["device_half_ms"][
                           "decode"]})
        row["l4"] = l4
        # the long-read block (one of 65,536 x 16.5 kb reads): launches in
        # its main-path run, and the kernel on its QUAL stream
        way = "encode" if name == "lane_encode" else "decode"
        row["long_read"] = {"launches": lr[way]["launches"][name],
                            **lr["kernels"][name]}
        if name == "lane_encode":
            row["l1_shared_memory_table"] = l1
        row["sharded_launches"] = _by_shard(shard, name)
        # past 1,024 lanes: launches on the wide main path (both
        # directions), and the W sweep's times on the level-3 block
        way = "encode" if name == "lane_encode" else "decode"
        row["wide_lanes"] = {
            "launches": wide["launches"][name], "card": card,
            "sweep": {W: {"span_ms": v[f"{way}_span_ms"],
                          "streams_ms": v[f"{way}_streams_ms"],
                          "ratio": v["ratio"]}
                      for W, v in wide["sweep"].items()}}
        # the header's other geometries: launches on their main-path runs
        # (both directions), QUAL's and SEQ's times alone in turns (16-bit
        # entries at level 3, 32-bit at the warm-up geometries)
        row["geometries"] = {
            "launches": geo["launches"][name], "card": card,
            "streams_ms": {g: v[way] for g, v in geo["streams_ms"].items()},
            "entry_bytes": {g: v["entry_bytes"]
                            for g, v in geo["containers"].items()}}
        kernels.append(row)
    # Kernel E's six phases on the pinned block's QUAL, one after another
    # (CUDA events summed over its slices), each held against its plain
    # version at this shape and at the others (errs); launches from the
    # main path's run
    for phase, t in times["phases"]["phases"].items():
        name = f"encode_{phase}"
        row = {"name": name, "route": "cuda",
               "source": source["lane_encode"],
               "replaces": replaces["lane_encode"],
               "also_replaces": also["lane_encode"],
               "launches": launches[name], "launches_l4": launches4[name],
               "match": errs[name] == 0 and errs4[name] == 0,
               "max_abs_err": max(errs[name], errs4[name]),
               "ms": t["ms"], "plain_ms": times["phase_plain_ms"][phase],
               "plain_shape": "the same QUAL, host clock",
               "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
               "bytes": t["bytes"], "library_ms": t.get("library_ms"),
               "shape": f"the pinned 64k L3 block's QUAL: W = "
                        f"{shape['W']}, Sp = {shape['Sp']}, "
                        f"{times['phases']['slices']} slices",
               "l4_seq_trial": times4["phases"]["phases"][phase],
               "window_16k_qual": win["lane_encode_blocks"]["phases"][
                   "phases"][phase]}
        for k in ("chain_links", "chain_bound_ms", "library"):
            if k in t:
                row[k] = t[k]
        kernels.append(row)
    # Kernel C: one launch per block; its device time (profiler) is `ms`
    name = "compact_lanes_dev"
    row = {"name": name, "route": "cuda", "source": source[name],
           "replaces": replaces[name], "launches": launches[name],
           "match": errs[name] == 0, "max_abs_err": errs[name]}
    for lv, c, lc, err in ((3, comp, launches[name], errs[name]),
                           (4, comp4, launches4[name], errs4[name])):
        part = {"launches": lc, "max_abs_err": err, "ms": c["device_ms"],
                "wrapper_ms": c["wrapper_ms"], "plain_ms": c["plain_ms"],
                "plain_shape": "the same launch's streams, CUDA events",
                "bound_ms": c["bound_ms"], "bound_by": "bytes",
                "bound_fraction": c["bound_fraction"],
                "sector_bound_ms": c["sector_bound_ms"], "library_ms": None,
                "shape": f"one launch: the pinned L{lv} block's "
                         f"{len(c['streams'])} coded streams",
                "phase_ms": phases[lv]}
        if lv == 3:
            row.update(part, qual_alone=c["qual_alone"])
        else:
            row["l4"] = part
    row["long_read"] = {"launches": lr["encode"]["launches"][name],
                        "descriptors": lr["encode"]["descriptors"][name],
                        "shape": "the long block's QUAL alone",
                        **lr["kernels"][name]}
    row["sharded_launches"] = _by_shard(shard, name)
    kernels.append(row)
    # Kernels L and U on the pinned block's own inputs (profiler records;
    # the plain versions are the tensor-op chains they replaced, on the
    # card, CUDA events); launches from the main path's run at L3 and L4
    for name in ("lane_layout", "lane_unpack"):
        t3 = times[name]
        row = {"name": name, "route": "cuda", "source": source[name],
               "replaces": replaces[name],
               "also_replaces": also.get(name, []),
               "launches": launches[name], "launches_l4": launches4[name],
               "match": errs[name] == 0, "max_abs_err": errs[name],
               "ms": t3["ms"], "wrapper_ms": t3["wrapper_ms"],
               "plain_ms": t3["plain_ms"],
               "plain_shape": "the replaced tensor-op chain on the same "
                              "inputs, CUDA events",
               "bound_ms": t3["bound_ms"], "bound_by": "bytes",
               "bytes": t3["bytes"], "library_ms": None,
               "shape": f"the pinned 64k L3 block: W = {shape['W']}, Sp = "
                        f"{shape['Sp']}",
               "sharded_launches": _by_shard(shard, name)}
        if name == "lane_layout":
            row.update(mode="pair (SEQ, QUAL, pos, reset)",
                       step_inputs=t3["step_inputs"],
                       raw_upload=t3["raw_upload"],
                       long_read={"launches": lr["encode"]["launches"][name]
                                  + lr["decode"]["launches"][name],
                                  **lr["kernels"][name]},
                       single_stream={k: v for k, v in single.items()
                                      if k == "shape"
                                      or k.startswith("pack_")})
        else:
            row.update(single_stream={k: v for k, v in single.items()
                                      if k == "shape"
                                      or k.startswith("unpack_")})
        kernels.append(row)
    # the window forms: one launch over the blocks of a window, on the 16k
    # L3 window's own inputs (4 blocks of 16,384 records); launches (and
    # the descriptors they took: blocks for E and D, streams for C) from
    # the window path's run at level 3 and at level 4, counted under the
    # kernel's one name
    for name, key, base, replaced in (
            ("lane_encode_blocks", "lane_encode_blocks", "lane_encode",
             "slimfastq_tpu/parallel/mesh.py:44"),
            ("lane_decode_blocks", "lane_decode_blocks", "lane_decode",
             "slimfastq_tpu/parallel/mesh.py:75"),
            ("compact_streams_dev", "compact_window", "compact_lanes_dev",
             "slimfastq_tpu/ops/compact_pallas.py:40")):
        w = win[key]
        (l3, d3), (l4, d4) = wlaunches[3], wlaunches[4]
        row = {"name": name, "form": "window", "counted_as": base,
               "route": "cuda", "source": source[base],
               "replaces": replaced, "launches": l3[base],
               "descriptors": d3[base], "launches_l4": l4[base],
               "descriptors_l4": d4[base],
               "match": errs[key] == 0, "max_abs_err": errs[key],
               "library_ms": None, "bound_ms": w["bound_ms"],
               "bound_by": w.get("bound_by", "bytes")}
        if key == "compact_window":
            row.update(ms=w["device_ms"], wrapper_ms=w["wrapper_ms"],
                       plain_ms=w["plain_ms"],
                       plain_shape="the same launch's streams, CUDA events",
                       shape=f"one launch: the 16k L3 window's "
                             f"{w['streams']} coded streams")
        else:
            row.update(ms=w["ms"], plain_ms=w["plain_ms"],
                       plain_shape=w["plain_shape"] + ", host clock",
                       prefix_ms=w["prefix_ms"],
                       one_launch_a_block_sum_ms=w[
                           "one_launch_a_block_sum_ms"],
                       shape="QUAL of the 16k L3 window: 4 blocks, W = "
                             "1024",
                       window_coder_span=win["coder_span"])
        kernels.append(row)
    print(json.dumps({"phase_s": phase_s}), flush=True)
    print(json.dumps({"earlier_ms": {
        "note": "recorded constants (this script, H100 80GB HBM3, 700 W), "
                "not measured in this run: E, D and C before the "
                "shared-memory table law, and C on QUAL alone when it took "
                "one launch per stream (CUDA events around the wrapper); "
                "Kernels L and U before L's tiled design (profiler records; "
                "wrappers with CUDA events), as lanes_before_tiles; Kernel "
                "E's lockstep design before the decoupled encode, as "
                "lockstep_encode; Kernel D before this design (in lockstep "
                "by bit-step), as lockstep_decode",
        **EARLIER_MS, "lanes_before_tiles": EARLIER_LANES_MS,
        "lockstep_encode": EARLIER_E_MS, "lockstep_decode": EARLIER_D_MS}}),
        flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--streaming-child"]:
        sys.exit(_streaming_child(sys.argv[2]))
    if sys.argv[1:2] == ["--gather-child"]:
        sys.exit(_gather_child(sys.argv[2]))
    if sys.argv[1:2] == ["--matcher-child"]:
        sys.exit(_matcher_child(sys.argv[2]))
    sys.exit(main())
