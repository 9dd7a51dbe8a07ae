"""Kernel D's launch shape (coder_torch.decode_shape), on the CPU: at
every level's QUAL, SEQ, byte and flag geometry, at 1 to 1,024 lanes
(either side of the cluster's 256; 600, a cluster of 4) and windows of
1, 4 and 256 blocks, the table lives in the CTA's shared memory where it
fits and in device memory otherwise, the cluster stays within the
portable size, is taken by every wide stream with a device table (QUAL,
SEQ) whatever its reads, and a window's two cluster streams fit the
card side by side, and the refusals hold. The kernel itself runs only on
a card (tests/test_torch_cuda.py)."""

from dataclasses import replace

import pytest

from slimfastq_tpu_torch import config as tconfig
from slimfastq_tpu_torch.ops import coder_torch as CT

KINDS = {"qual": "qual", "seq": "seq", "byte": "bytes_", "flag": "flags"}


@pytest.mark.parametrize("B", [1, 4, 256])
@pytest.mark.parametrize("W", [1, 64, 100, 255, 256, 600, 1024])
@pytest.mark.parametrize("kind", list(KINDS))
@pytest.mark.parametrize("level", [1, 2, 3, 4])
def test_decode_shape_fits_and_partitions(level, kind, W, B):
    geom = getattr(tconfig.LEVELS[level], KINDS[kind])
    s = CT.decode_shape(geom, W, B)
    # the table in the CTA's shared memory where it fits, else in device
    # memory (the law's counters always are); a depth-2 device table (SEQ)
    # in rows padded to 4 entries
    table16 = (2 * geom.table_size + 15) // 16 * 16
    if s.table == "smem":
        assert table16 <= CT.SMEM_LIMIT and CT.table_in_smem(geom)
        assert s.smem_bytes == table16
        assert (s.padded, s.entries) == (False, geom.table_size)
    else:
        assert (s.table, s.smem_bytes) == ("device", 0)
        assert geom.depth >= 2 and table16 > CT.SMEM_LIMIT
        nodes = (1 << geom.depth) - 1
        assert geom.table_size % nodes == 0
        if geom.depth == 2:
            assert s.padded and s.entries == geom.table_size // 3 * 4
        else:
            assert (s.padded, s.entries) == (False, geom.table_size)
    # the cluster: a power of two within the portable size, only for a
    # stream of 256 lanes or more with a device table, every CTA with a
    # live lane, a window's two cluster streams side by side on the card
    assert s.cluster in (1, 2, 4, 8) and s.cluster <= CT.MAX_CLUSTER
    assert s.ctas == B * s.cluster
    assert s.threads % 32 == 0
    assert 32 <= s.threads <= (512 if s.cluster > 1 else 1024)
    assert s.threads * s.cluster >= W > s.threads * (s.cluster - 1)
    # W lanes take whole warps: 255 lanes are 256 threads
    lanes = (W + 31) // 32 * 32
    wide = s.table == "device" and lanes >= 256
    assert CT.may_cluster(geom, W) == wide
    # as many CTAs of at least 128 threads as the lanes fill, at most 8,
    # and a window's two cluster streams side by side on the card
    C = next(c for c in (8, 4, 2, 1) if lanes // c >= 128 or c == 1)
    C = min(C, 8 if B <= 8 else 4 if B <= 16 else 2 if B <= 33 else 1)
    assert s.cluster == (C if wide else 1)
    if s.cluster > 1:
        assert s.threads >= 128 and 2 * B * s.cluster <= CT.SMS


def test_decode_shape_of_the_main_path():
    """The 64k block's shapes at level 3: QUAL over a cluster of 8 CTAs of
    128 threads, its 1.03 MB table in device memory; SEQ's 8.4 MB table in
    device memory in rows padded to 4 entries, over a cluster of 8 CTAs
    too; the aux streams one CTA, their tables in shared memory."""
    cfg = tconfig.LEVELS[3]
    q = CT.decode_shape(cfg.qual, 1024, 4)
    assert (q.cluster, q.threads, q.table, q.padded, q.smem_bytes,
            q.ctas) == (8, 128, "device", False, 0, 32)
    assert q.entries == cfg.qual.table_size
    assert CT.decode_shape(cfg.seq, 1024).entries == 4194306 // 3 * 4
    s = CT.decode_shape(cfg.seq, 1024, 4)
    assert (s.cluster, s.threads, s.table, s.padded, s.ctas) == (
        8, 128, "device", True, 32)
    assert CT.decode_shape(cfg.seq, 1024, 16).cluster == 4
    for g in (cfg.bytes_, cfg.flags):
        a = CT.decode_shape(g, 64, 4)
        assert (a.cluster, a.threads, a.table, a.ctas) == (1, 64, "smem", 4)
    # shared memory holds the table alone
    assert CT.decode_shape(cfg.bytes_, 64).smem_bytes == 131072
    assert CT.decode_shape(cfg.flags, 64).smem_bytes == 16
    # level 4's SEQ (the match trials') over a cluster too
    assert CT.decode_shape(tconfig.LEVELS[4].seq, 1024).cluster == 8


def test_decode_shape_refusals():
    """W past 1,024 lanes, a visit cap past 4 bits, a depth past the
    kernel's 8 levels, a depth-1 table that does not fit shared memory and
    a launch of 0 or more than 256 blocks are refused, each with its
    reason."""
    cfg = tconfig.LEVELS[3]
    with pytest.raises(ValueError, match="exceeds"):
        CT.decode_shape(cfg.qual, 1025)
    with pytest.raises(ValueError, match="visit cap"):
        CT.decode_shape(replace(cfg.seq, rate=14, rate_lo=1), 64)
    with pytest.raises(ValueError, match="levels"):
        CT.decode_shape(replace(cfg.bytes_, depth=9), 64)
    with pytest.raises(ValueError, match="shared memory"):
        CT.decode_shape(replace(cfg.flags, hist_bits=17), 64)
    for B in (0, CT.MAX_BLOCKS + 1):
        with pytest.raises(ValueError, match="blocks"):
            CT.decode_shape(cfg.qual, 1024, B)
