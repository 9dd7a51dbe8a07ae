"""Kernel D's launch shape (coder_torch.decode_shape), on the CPU: at
every level's QUAL, SEQ, byte and flag geometry, at 64 and 1,024 lanes and
windows of 1, 4 and 256 blocks, each CTA's regions fit its shared memory,
the hash's partition over a cluster's CTAs covers every entry exactly
once, the cluster stays within the portable size and a window's two
cluster streams fit the card side by side, and the refusals hold. The
kernel itself runs only on a card (tests/test_torch_cuda.py)."""

from dataclasses import replace

import numpy as np
import pytest

from slimfastq_tpu_torch import config as tconfig
from slimfastq_tpu_torch.ops import coder_torch as CT

KINDS = {"qual": "qual", "seq": "seq", "byte": "bytes_", "flag": "flags"}


@pytest.mark.parametrize("B", [1, 4, 256])
@pytest.mark.parametrize("W", [64, 1024])
@pytest.mark.parametrize("kind", list(KINDS))
@pytest.mark.parametrize("level", [1, 2, 3, 4])
def test_decode_shape_fits_and_partitions(level, kind, W, B):
    geom = getattr(tconfig.LEVELS[level], KINDS[kind])
    s = CT.decode_shape(geom, W, B)
    lanes = -(-W // 32) * 32
    # each CTA's regions fit its shared memory; the hash holds every lane
    assert 1 << s.nsl >= 2 * lanes > 1 << (s.nsl - 1)
    assert s.hash_bytes == CT.hash_bytes(W) == 2 * CT.NBUF * (1 << s.nsl) * 4
    assert s.smem_bytes == s.table_bytes + s.hash_bytes <= CT.SMEM_LIMIT
    table16 = (2 * geom.table_size + 15) // 16 * 16
    if s.table == "smem":
        assert s.table_bytes == table16 and CT.table_in_smem(geom, W)
    else:
        assert s.table == "device" and s.table_bytes == 0
        assert geom.depth >= 2 and table16 + s.hash_bytes > CT.SMEM_LIMIT
    # the one-barrier ordering needs depth >= 2, and depth >= 3 where the
    # entry is loaded one bit-step ahead from device memory
    assert s.two_barriers == (geom.depth == 1 or (
        geom.depth == 2 and s.table == "device"))
    # the cluster: a power of two within the portable size, only for wide
    # streams with two barriers and a device table, every CTA with a live
    # lane, a window's two cluster streams side by side on the card
    assert s.cluster in (1, 2, 4, 8) and s.cluster <= CT.MAX_CLUSTER
    assert s.ctas == B * s.cluster
    assert s.threads % 32 == 0
    assert 32 <= s.threads <= (512 if s.cluster > 1 else 1024)
    assert s.threads * s.cluster >= W > s.threads * (s.cluster - 1)
    wide = s.two_barriers and s.table == "device" and W == 1024
    assert s.cluster == (8 if wide and B <= 8 else 1)
    if s.cluster > 1:
        assert s.threads >= 128 and 2 * B * s.cluster <= CT.SMS
        # the kernel keeps entry e's hash slots in CTA e & (C - 1) (C a
        # power of two): every entry in exactly one CTA, each CTA's
        # entries a residue class
        e = np.arange(geom.table_size)
        rank = e & (s.cluster - 1)
        assert np.array_equal(rank, e % s.cluster)
        assert np.array_equal(np.bincount(rank, minlength=s.cluster),
                              [len(range(r, geom.table_size, s.cluster))
                               for r in range(s.cluster)])


def test_decode_shape_of_the_main_path():
    """The 64k block's shapes at level 3: QUAL one CTA of 1,024 threads,
    its 1.03 MB table in device memory, one barrier; SEQ's 8.4 MB table in
    device memory with two barriers, over a cluster of 8 CTAs of 128
    threads; the aux streams one CTA, their tables in shared memory."""
    cfg = tconfig.LEVELS[3]
    q = CT.decode_shape(cfg.qual, 1024, 4)
    assert (q.cluster, q.threads, q.table, q.smem_bytes, q.two_barriers,
            q.ctas) == (1, 1024, "device", 49152, False, 4)
    s = CT.decode_shape(cfg.seq, 1024, 4)
    assert (s.cluster, s.threads, s.table, s.two_barriers, s.ctas) == (
        8, 128, "device", True, 32)
    assert CT.decode_shape(cfg.seq, 1024, 16).cluster == 4
    for g in (cfg.bytes_, cfg.flags):
        a = CT.decode_shape(g, 64, 4)
        assert (a.cluster, a.threads, a.table, a.ctas) == (1, 64, "smem", 4)
    assert CT.decode_shape(cfg.flags, 64).two_barriers
    # level 4's SEQ (the match trials') over a cluster too
    assert CT.decode_shape(tconfig.LEVELS[4].seq, 1024).cluster == 8


def test_decode_shape_refusals():
    """W past 1,024 lanes, a visit cap past 4 bits, a depth-1 table that
    does not fit shared memory and a launch of 0 or more than 256 blocks
    are refused, each with its reason."""
    cfg = tconfig.LEVELS[3]
    with pytest.raises(ValueError, match="exceeds"):
        CT.decode_shape(cfg.qual, 1025)
    with pytest.raises(ValueError, match="visit cap"):
        CT.decode_shape(replace(cfg.seq, rate=14, rate_lo=1), 64)
    with pytest.raises(ValueError, match="shared memory"):
        CT.decode_shape(replace(cfg.flags, hist_bits=17), 64)
    for B in (0, CT.MAX_BLOCKS + 1):
        with pytest.raises(ValueError, match="blocks"):
            CT.decode_shape(cfg.qual, 1024, B)
