"""The port's emission compaction (slimfastq_tpu_torch.ops.compact_torch)
against the JAX package's compactors: the Pallas kernels (interpret mode on
the CPU, as tests/test_compact_pallas.py runs them), the XLA compactor and
the NumPy reference. Exact byte equality of every lane's valid prefix and
of the totals; against the reference (zeros past each total) the whole
payload. A block's streams at once (compact_streams_plain, the flat
buffer's layout) stream by stream against the same references, and the
wrapper's refusals."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from slimfastq_tpu.ops import compact_pallas as CP
from slimfastq_tpu.ops import compact_xla as CX
from slimfastq_tpu_torch import native as tnative
from slimfastq_tpu_torch.ops import compact_torch as CT

torch.set_num_threads(1)


def _inputs(seed, NC, W, CB, empty_lane=True):
    rng = np.random.default_rng(seed)
    eptrs = rng.integers(0, CB + 1, size=(NC, W)).astype(np.int32)
    eptrs[rng.random((NC, W)) < 0.3] = 0   # empty chunks share starts
    if empty_lane:
        eptrs[:, 0] = 0                    # a fully-empty lane
    ebufs = np.zeros((NC, W, CB), dtype=np.uint8)
    for c in range(NC):
        for w in range(W):
            ebufs[c, w, : eptrs[c, w]] = rng.integers(1, 256, eptrs[c, w])
    return ebufs, eptrs


def _plain(ebufs, eptrs, Bmax):
    out, tot = CT.compact_lanes_dev(torch.from_numpy(ebufs),
                                    torch.from_numpy(eptrs), Bmax)
    return out.numpy(), tot.numpy()


def _same_prefixes(out, tot, ref, rtot):
    assert np.array_equal(tot, rtot)
    for w in range(len(rtot)):
        t = int(rtot[w])
        assert np.array_equal(out[w, :t], ref[w, :t]), f"lane {w}"


@pytest.mark.parametrize("seed,NC,W,CB", [(0, 12, 16, 32), (1, 7, 64, 64),
                                          (2, 300, 8, 160)])
def test_compact_matches_host_reference(seed, NC, W, CB):
    ebufs, eptrs = _inputs(seed, NC, W, CB)
    Bmax = int(eptrs.sum(axis=0).max()) + 7
    out, tot = _plain(ebufs, eptrs, Bmax)
    ref, rtot = CX.compact_host_reference(ebufs, eptrs, Bmax)
    assert np.array_equal(tot, rtot)
    assert np.array_equal(out, ref)  # zeros past every total, as the kernel


@pytest.mark.parametrize("seed,NC,W,CB", [(3, 10, 16, 32), (4, 5, 64, 16)])
def test_compact_matches_xla(seed, NC, W, CB):
    ebufs, eptrs = _inputs(seed, NC, W, CB)
    Bmax = int(eptrs.sum(axis=0).max()) + 128
    out, tot = _plain(ebufs, eptrs, Bmax)
    xo, xt = CX.compact_device(jnp.asarray(ebufs.reshape(NC, W * CB)),
                               jnp.asarray(eptrs), Bmax)
    _same_prefixes(out, tot, np.asarray(xo), np.asarray(xt))


@pytest.mark.parametrize("v2", [False, True])
def test_compact_matches_pallas(v2):
    NC, W, CB = 16, 16, 64
    ebufs, eptrs = _inputs(5 + v2, NC, W, CB)
    eptrs = np.minimum(eptrs, CB // 3)  # the Pallas tests' window
    Bmax = 1024
    out, tot = _plain(ebufs, eptrs, Bmax)
    fn = CP.compact_device_v2 if v2 else CP.compact_device
    po, pt = fn(jnp.asarray(ebufs.astype(np.int32)), jnp.asarray(eptrs),
                Bmax)
    _same_prefixes(out, tot, np.asarray(po).astype(np.uint8),
                   np.asarray(pt))


def test_compact_all_empty():
    NC, W, CB = 4, 8, 16
    ebufs = np.full((NC, W, CB), 9, dtype=np.uint8)
    eptrs = np.zeros((NC, W), dtype=np.int32)
    out, tot = _plain(ebufs, eptrs, 64)
    assert not tot.any() and not out.any()
    xo, xt = CX.compact_device(jnp.asarray(ebufs.reshape(NC, W * CB)),
                               jnp.asarray(eptrs), 64)
    assert not np.asarray(xt).any()


def test_compact_rejects_bad_inputs():
    ebufs = torch.zeros((2, 4, 8), dtype=torch.uint8)
    with pytest.raises(ValueError):
        CT.compact_lanes_dev(ebufs, torch.zeros((2, 4), dtype=torch.int64),
                             8)
    with pytest.raises(ValueError):
        CT.compact_lanes_dev(ebufs.int(), torch.zeros((2, 4),
                                                      dtype=torch.int32), 8)


# A block's streams in one call: (NC, W, CB, count cap, Bmax past the
# longest lane). Each its own NC, W, CB and Bmax; NC not a multiple of
# Kernel C's 128-chunk tile; a fully-empty lane in each; an all-empty
# stream; counts above CB (an overflowed window: its bytes past CB are 0).
MIX = [(12, 16, 32, 32, 7), (7, 64, 64, 64, 0), (130, 8, 160, 160, 33),
       (4, 8, 16, 0, 5), (33, 24, 16, 24, 0)]


def _mix(seed):
    rng = np.random.default_rng(seed)
    streams = []
    for NC, W, CB, cap, extra in MIX:
        eptrs = rng.integers(0, cap + 1, size=(NC, W)).astype(np.int32)
        eptrs[rng.random((NC, W)) < 0.3] = 0
        eptrs[:, W // 2] = 0
        ebufs = rng.integers(0, 256, size=(NC, W, CB)).astype(np.uint8)
        Bmax = int(eptrs.sum(axis=0).max()) + extra
        streams.append((ebufs, eptrs, max(Bmax, 1)))
    return streams


def _zero_extended(ebufs, eptrs):
    """The windows widened to the largest count with zeros: what a count
    past CB reads."""
    NC, W, CB = ebufs.shape
    wide = np.zeros((NC, W, max(CB, int(eptrs.max()))), dtype=np.uint8)
    wide[:, :, :CB] = ebufs
    return wide


@pytest.mark.parametrize("ref", ["host", "xla", "pallas", "pallas_v2"])
def test_compact_streams_plain_ragged_mix(ref):
    """compact_streams_plain on the mix, with a tail per stream, each
    stream's view of the flat buffer against one of the JAX package's
    compactors on that stream alone."""
    streams = _mix(11)
    tails = [torch.arange(p.shape[1], dtype=torch.int32) * 7 - 3
             for _, p, _ in streams]
    flat, layout = CT.compact_streams_plain(
        [(torch.from_numpy(e), torch.from_numpy(p), b)
         for e, p, b in streams], tails)
    assert flat.shape == (layout.nbytes,) and flat.dtype == torch.uint8
    for (ebufs, eptrs, Bmax), (pay, tot, tail), want_tail in zip(
            streams, layout.views(flat), tails):
        assert pay.shape == (eptrs.shape[1], Bmax)
        assert torch.equal(tail, want_tail)
        pay, tot = pay.numpy(), tot.numpy()
        wide = _zero_extended(ebufs, eptrs)
        if ref == "host":
            want, wtot = CX.compact_host_reference(wide, eptrs, Bmax)
            assert np.array_equal(pay, want)
        elif ref == "xla":
            want, wtot = CX.compact_device(jnp.asarray(wide), jnp.asarray(
                eptrs), Bmax)
        else:
            fn = CP.compact_device_v2 if ref == "pallas_v2" else \
                CP.compact_device
            want, wtot = fn(jnp.asarray(wide.astype(np.int32)),
                            jnp.asarray(eptrs), Bmax)
        _same_prefixes(pay, tot, np.asarray(want).astype(np.uint8),
                       np.asarray(wtot))
        assert not pay[eptrs.sum(axis=0)[:, None] <= np.arange(Bmax)].any()


def test_compact_lanes_dev_is_the_one_stream_launch():
    """compact_lanes_dev returns the one-stream layout's views; the rows
    sit at a pitch of Bmax rounded up to 16, zero past Bmax."""
    ebufs, eptrs = _inputs(12, 9, 40, 32)
    Bmax = int(eptrs.sum(axis=0).max()) + 3
    eb, ep = torch.from_numpy(ebufs), torch.from_numpy(eptrs)
    pay, tot = CT.compact_lanes_dev(eb, ep, Bmax)
    want, wtot = CT.compact_lanes_plain(eb, ep, Bmax)
    assert torch.equal(pay, want) and torch.equal(tot, wtot)
    flat, layout = CT.compact_streams_dev([(eb, ep, Bmax)])
    (rows, totals, tail, W, pitch, B), = layout.parts
    assert (rows, W, B, tail) == (0, 40, Bmax, -1)
    assert pitch % 16 == 0 and Bmax <= pitch < Bmax + 16
    assert totals == W * pitch and layout.nbytes == totals + 4 * W
    full = flat[: W * pitch].view(W, pitch)
    assert not full[:, Bmax:].any()


@pytest.mark.parametrize("pitch_extra", [0, 5, 16])
def test_flush_append_takes_pitched_rows(pitch_extra):
    """native.flush_append on payload rows at a wider pitch (the flat
    buffer's views) equals it on the same rows made contiguous."""
    rng = np.random.default_rng(pitch_extra)
    W, Bmax = 12, 40
    wide = rng.integers(0, 256, size=(W, Bmax + pitch_extra)).astype(
        np.uint8)
    pay = wide[:, :Bmax]
    totals = rng.integers(0, Bmax + 1, size=W)
    low = rng.integers(0, 2**32, size=W, dtype=np.uint64).astype(np.uint32)
    counts = np.where(np.arange(W) % 5 == 0, 0, 10)
    maxlen = int(totals.max()) + 4
    got = tnative.flush_append(pay, totals, low, counts, maxlen)
    want = tnative.flush_append(np.ascontiguousarray(pay), totals, low,
                                counts, maxlen)
    assert np.array_equal(got, want)


def _refusal(case):
    z = torch.zeros
    ok = (z((2, 4, 16), dtype=torch.uint8), z((2, 4), dtype=torch.int32), 8)
    meta = torch.device("meta")
    return {
        "too_many_streams": ([ok] * (CT.MAX_STREAMS + 1), None),
        "no_stream": ([], None),
        "mixed_devices": ([ok, (ok[0], ok[1].to(meta), 8)], None),
        "ebufs_dtype": ([(ok[0].int(), ok[1], 8)], None),
        "eptrs_dtype": ([(ok[0], ok[1].long(), 8)], None),
        "eptrs_shape": ([(ok[0], z((2, 5), dtype=torch.int32), 8)], None),
        "bmax": ([(ok[0], ok[1], 0)], None),
        "tail_dtype": ([ok], [z(4, dtype=torch.int64)]),
        "tail_count": ([ok, ok], [z(4, dtype=torch.int32)]),
        "tail_device": ([ok], [z(4, dtype=torch.int32, device=meta)]),
        "unsupported_device": ([tuple(x.to(meta) for x in ok[:2]) + (8,)],
                               None),
    }[case]


@pytest.mark.parametrize("case", ["too_many_streams", "no_stream",
                                  "mixed_devices", "ebufs_dtype",
                                  "eptrs_dtype", "eptrs_shape", "bmax",
                                  "tail_dtype", "tail_count", "tail_device",
                                  "unsupported_device"])
def test_compact_streams_refuses(case):
    streams, tails = _refusal(case)
    with pytest.raises(ValueError):
        CT.compact_streams_dev(streams, tails)
