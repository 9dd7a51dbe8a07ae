"""The port's emission compaction (slimfastq_tpu_torch.ops.compact_torch)
against the JAX package's compactors: the Pallas kernels (interpret mode on
the CPU, as tests/test_compact_pallas.py runs them), the XLA compactor and
the NumPy reference. Exact byte equality of every lane's valid prefix and
of the totals; against the reference (zeros past each total) the whole
payload."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from slimfastq_tpu.ops import compact_pallas as CP
from slimfastq_tpu.ops import compact_xla as CX
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
