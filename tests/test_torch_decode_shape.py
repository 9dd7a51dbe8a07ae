"""Kernel D's launch shape (coder_torch.decode_shape), on the CPU: at
every level's QUAL, SEQ, byte and flag geometry, at 1 to 1,024 lanes
(either side of the cluster's 256; 600, a cluster of 4) and windows of
1, 4 and 256 blocks, the table lives in the CTA's shared memory where it
fits and in device memory otherwise, the cluster stays within the
portable size, is taken by every wide stream with a device table (QUAL,
SEQ) whatever its reads, and a window's two cluster streams fit the
card side by side, and the refusals hold. Past 1,024 lanes (1,500,
2,048, 4,096) a cluster's CTAs keep at most 512 threads, one lane each,
and a table in shared memory keeps one CTA, two or four lanes a thread;
every shape up to 1,024 lanes is the one it was, and so is Kernel E's
touches launch (encode_torch.touch_shape). Past 4,096 lanes every stream
takes D's loop form (a cluster of 8 CTAs of at most 1,024 threads, every
lane on one thread, the table in device memory) and E's touches spread a
step over chunks of 256 lanes with the step's hash in device memory. The
kernels themselves run only on a card (tests/test_torch_cuda.py)."""

from dataclasses import replace

import pytest

from slimfastq_tpu_torch import config as tconfig
from slimfastq_tpu_torch.ops import coder_torch as CT
from slimfastq_tpu_torch.ops import encode_torch as ET

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
    """A depth past the kernel's 8 levels and a launch of 0 or more than
    256 blocks are refused, each with its reason; 1,025, 4,097, 8,192 and
    65,536 lanes are taken, and so are visit caps of 16 and 512 (32-bit
    entries: SEQ's padded rows, QUAL over its cluster as at 16 bits) and a
    depth-1 table past shared memory (FLAG at 17 history bits: device
    memory, one CTA, its rows unpadded)."""
    cfg = tconfig.LEVELS[3]
    for W in (4097, 8192, 65536):
        s = CT.decode_shape(cfg.qual, W)
        assert s.cluster * s.threads * CT.lanes_per_thread(s, W) >= W
    assert CT.decode_shape(cfg.qual, 1025).cluster == 8
    for rate, rate_lo in ((7, 2), (14, 1)):
        seq = replace(cfg.seq, rate=rate, rate_lo=rate_lo)
        s = CT.decode_shape(seq, 64)
        assert (s.table, s.padded, s.entry_bytes, s.cluster) == (
            "device", True, 4, 1)
        assert s.entries == seq.table_size // 3 * 4
        qual = replace(cfg.qual, rate=rate, rate_lo=rate_lo)
        assert CT.decode_shape(qual, 1024)._replace(entry_bytes=2) == \
            CT.decode_shape(cfg.qual, 1024)
    flag = replace(cfg.flags, hist_bits=17)
    for W in (64, 1024, 5000):
        s = CT.decode_shape(flag, W)
        assert (s.table, s.padded, s.smem_bytes, s.entries) == (
            "device", False, 0, flag.table_size)
    assert CT.decode_shape(flag, 64).cluster == 1
    with pytest.raises(ValueError, match="levels"):
        CT.decode_shape(replace(cfg.bytes_, depth=9), 64)
    for B in (0, CT.MAX_BLOCKS + 1):
        with pytest.raises(ValueError, match="blocks"):
            CT.decode_shape(cfg.qual, 1024, B)


@pytest.mark.parametrize("B", [1, 4])
@pytest.mark.parametrize("W", [1500, 2048, 4096])
@pytest.mark.parametrize("kind", list(KINDS))
@pytest.mark.parametrize("level", [1, 2, 3, 4])
def test_decode_shape_past_1024_lanes(level, kind, W, B):
    geom = getattr(tconfig.LEVELS[level], KINDS[kind])
    s = CT.decode_shape(geom, W, B)
    k = CT.lanes_per_thread(s, W)
    # the regions fit one CTA's shared memory; the table where it was
    assert s.smem_bytes <= CT.SMEM_LIMIT
    assert (s.table == "smem") == CT.table_in_smem(geom)
    assert s.ctas == B * s.cluster and s.threads % 32 == 0
    # every lane on a thread, and less than a warp of empty lanes a CTA
    # and round (lane (r k + i) T + t on thread t of CTA r)
    assert 0 <= k * s.threads * s.cluster - W < 32 * k * s.cluster
    if s.table == "device":
        # one lane a thread over a cluster of CTAs of at most 512 threads
        assert (k, s.cluster > 1) == (1, True)
        assert s.cluster <= CT.MAX_CLUSTER and s.threads <= 512
    else:
        # one CTA of at most 1,024 threads, two or four lanes a thread
        assert (s.cluster, k) == (1, 2 if W <= 2048 else 4)
        assert s.threads <= 1024


def _old_decode_shape(geom, W, B):
    """decode_shape as it stood for 1 to 1,024 lanes, one lane a thread."""
    lanes = (W + 31) // 32 * 32
    smem = CT.table_in_smem(geom)
    padded = not smem and geom.depth == 2
    C = 1
    while (CT.may_cluster(geom, W) and C < 8 and lanes // (2 * C) >= 128
           and 2 * B * 2 * C <= 132):
        C *= 2
    return CT.DecodeShape(
        C, (-(-W // C) + 31) // 32 * 32, "smem" if smem else "device",
        padded, geom.table_size // 3 * 4 if padded else geom.table_size,
        (2 * geom.table_size + 15) // 16 * 16 if smem else 0, B * C)


@pytest.mark.parametrize("kind", list(KINDS))
@pytest.mark.parametrize("level", [1, 2, 3, 4])
def test_shapes_to_1024_lanes_unchanged(level, kind):
    """Every W from 1 to 1,024 keeps its shape, one lane a thread, at
    windows of 1 to 256 blocks."""
    geom = getattr(tconfig.LEVELS[level], KINDS[kind])
    for W in list(range(1, 1025, 7)) + [255, 256, 1023, 1024]:
        for B in (1, 4, 8, 16, 17, 33, 34, 256):
            s = CT.decode_shape(geom, W, B)
            assert s == _old_decode_shape(geom, W, B), (W, B)
            assert CT.lanes_per_thread(s, W) == 1


def test_touch_shape():
    """Kernel E's touches launch: up to 1,024 lanes as it was (one lane a
    thread, 2^ceil(log2(2 threads)) hash slots), past it two or four lanes
    a thread, at least 2W slots, within one CTA's shared memory; past
    4,096 lanes a step's chunks of 256 lanes, one a thread, its hash of at
    least 2W slots in device memory."""
    for W in range(1, 1025):
        threads = (W + 31) // 32 * 32
        nsl = next(n for n in range(20) if (1 << n) >= 2 * threads)
        assert ET.touch_shape(W) == (threads, 1, nsl,
                                     (6 * (1 << nsl) + 64) * 4)
    for W in range(1025, 4097, 13):
        t = ET.touch_shape(W)
        assert t.per_thread == (2 if W <= 2048 else 4)
        assert t.threads % 32 == 0 and t.threads <= 1024
        assert t.threads * t.per_thread >= W
        assert (1 << t.nsl) >= 2 * W
        assert t.smem_bytes <= CT.SMEM_LIMIT
    assert ET.touch_shape(4096) == (1024, 4, 13, 197632)
    for W in (4097, 5000, 8192, 16384, 65535, 65536, 100000, 1 << 20):
        t = ET.touch_shape(W)
        assert t.in_device and (t.threads, t.per_thread) == (256, 1)
        # every lane in one chunk, the last chunk with a live lane
        n = t.chunks(W)
        assert n * t.threads >= W > (n - 1) * t.threads
        assert (1 << t.nsl) >= 2 * W > 1 << (t.nsl - 1)
        assert t.smem_bytes == 0
        assert ET.wide_records(W) == (W >= 65536)
        # the chunks' grid: a slice's steps and a window's blocks within
        # the grid's y and z limits
        for B in (1, 256):
            assert ET.slice_steps(B, W, 10 ** 9) <= 65535


@pytest.mark.parametrize("B", [1, 4, 256])
@pytest.mark.parametrize("W", [4097, 5000, 8192, 16384, 65536, 100000])
@pytest.mark.parametrize("kind", list(KINDS))
@pytest.mark.parametrize("level", [1, 2, 3, 4])
def test_decode_shape_past_4096_lanes(level, kind, W, B):
    """The loop form: a cluster of 8 CTAs of at most 1,024 threads a
    block, every lane on one thread (lane r T + t + i C T), the table in
    device memory (a depth-2 table in padded rows), no shared memory; the
    launch's clusters are scheduled whole, so a window of 256 blocks
    only queues them."""
    geom = getattr(tconfig.LEVELS[level], KINDS[kind])
    s = CT.decode_shape(geom, W, B)
    k = CT.lanes_per_thread(s, W)
    assert (s.cluster, s.table, s.smem_bytes) == (8, "device", 0)
    # one cluster a block, resident whole on the card's SMs, one CTA an SM
    assert s.ctas == B * 8 and s.cluster <= CT.SMS
    assert s.threads % 32 == 0 and 32 <= s.threads <= 1024
    assert s.threads == (1024 if W > 8192 else (-(-W // 8) + 31) // 32 * 32)
    # every lane on one thread, every thread's last lane within one round
    assert k * s.cluster * s.threads >= W > (k - 1) * s.cluster * s.threads
    assert s.padded == (geom.depth == 2)
    assert s.entries == (geom.table_size // 3 * 4 if s.padded
                         else geom.table_size)
    assert s.smem_bytes <= CT.SMEM_LIMIT
