"""The port's lane pack/unpack (slimfastq_tpu_torch.ops.pack_torch) against
the JAX package's ops/pack_jax, the SEQ+QUAL pair forms and the
single-stream pack_device / unpack_device: every symbol of the [Sp, W]
matrices and every byte of the record-major buffers equal."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from slimfastq_tpu.ops import pack_jax as PJ
from slimfastq_tpu.ops import ranger_np as R
from slimfastq_tpu.pipeline_native import _BASE_TO_CODE_DEV, \
    _CODE_TO_BASE_FULL
from slimfastq_tpu_torch.ops import pack_torch as PT

torch.set_num_threads(1)


def _block(rng, n, W, maxlen, zero_len=True):
    """A raw record-major block: per record a seq and a qual field."""
    lengths = rng.integers(0 if zero_len else 1, maxlen + 1,
                           size=n).astype(np.int64)
    parts, seq_offs, qual_offs, off = [], [], [], 0
    for L in lengths:
        s = rng.choice(np.frombuffer(b"ACGTN", np.uint8), size=L)
        q = rng.integers(35, 75, size=L).astype(np.uint8)
        hdr = np.frombuffer(b"@r\n", np.uint8)
        rec = np.concatenate([hdr, s, np.frombuffer(b"\n+\n", np.uint8), q,
                              np.frombuffer(b"\n", np.uint8)])
        seq_offs.append(off + 3)
        qual_offs.append(off + 3 + L + 3)
        parts.append(rec)
        off += len(rec)
    data = np.concatenate(parts) if parts else np.zeros(0, np.uint8)
    dpad = np.zeros(PT.pad_flat(len(data)), dtype=np.uint8)
    dpad[: len(data)] = data
    ll = np.zeros(((n + W - 1) // W) * W, dtype=np.int64)
    ll[:n] = lengths
    S = int(ll.reshape(-1, W).sum(axis=0).max())
    return dpad, np.array(seq_offs), np.array(qual_offs), lengths, S


@pytest.mark.parametrize("seed,n,W,maxlen", [(0, 100, 16, 60),
                                             (1, 37, 8, 150),
                                             (2, 300, 64, 20)])
def test_pack_pair_matches_jax(seed, n, W, maxlen):
    rng = np.random.default_rng(seed)
    dpad, so, qo, lengths, S = _block(rng, n, W, maxlen)
    Sp = R.pad_steps(S)
    minq = 35
    js, jq = PJ.pack_pair_device(jnp.asarray(dpad), so, qo, lengths, W, Sp,
                                 _BASE_TO_CODE_DEV, minq)
    ps, pq = PT.pack_pair(torch.from_numpy(dpad), so, qo, lengths, W, Sp,
                          _BASE_TO_CODE_DEV, minq)
    assert ps.dtype == torch.uint8 and pq.dtype == torch.uint8
    assert np.array_equal(ps.numpy(), np.asarray(js))
    assert np.array_equal(pq.numpy(), np.asarray(jq))


@pytest.mark.parametrize("seed,n,W,maxlen", [(3, 100, 16, 60),
                                             (4, 41, 8, 150)])
def test_unpack_pair_matches_jax(seed, n, W, maxlen):
    rng = np.random.default_rng(seed)
    lengths = rng.integers(0, maxlen + 1, size=n).astype(np.int64)
    starts = np.zeros(n, dtype=np.int64)
    starts[1:] = np.cumsum(lengths[:-1])
    total = int(lengths.sum())
    ll = np.zeros(((n + W - 1) // W) * W, dtype=np.int64)
    ll[:n] = lengths
    Sp = R.pad_steps(int(ll.reshape(-1, W).sum(axis=0).max()))
    seq = rng.integers(0, 4, size=(Sp, W)).astype(np.uint8)
    qual = rng.integers(0, 41, size=(Sp, W)).astype(np.uint8)
    js, jq = PJ.unpack_pair_device(jnp.asarray(seq), jnp.asarray(qual),
                                   starts, lengths, W, total,
                                   _CODE_TO_BASE_FULL, 33)
    ps, pq = PT.unpack_pair(torch.from_numpy(seq), torch.from_numpy(qual),
                            starts, lengths, W, total, _CODE_TO_BASE_FULL,
                            33)
    assert ps.shape == (PT.pad_flat(total),)
    assert np.array_equal(ps.numpy()[:total], np.asarray(js)[:total])
    assert np.array_equal(pq.numpy()[:total], np.asarray(jq)[:total])


def test_pack_unpack_round_trip():
    rng = np.random.default_rng(5)
    n, W = 90, 16
    dpad, so, qo, lengths, S = _block(rng, n, W, 70, zero_len=False)
    Sp = R.pad_steps(S)
    ps, pq = PT.pack_pair(torch.from_numpy(dpad), so, qo, lengths, W, Sp,
                          _BASE_TO_CODE_DEV, 35)
    starts = np.zeros(n, dtype=np.int64)
    starts[1:] = np.cumsum(lengths[:-1])
    total = int(lengths.sum())
    us, uq = PT.unpack_pair(ps, pq, starts, lengths, W, total,
                            _CODE_TO_BASE_FULL, 35)
    want_q = np.concatenate([dpad[o: o + L] for o, L in zip(qo, lengths)])
    want_s = np.concatenate([dpad[o: o + L] for o, L in zip(so, lengths)])
    want_s = np.where(want_s == ord("N"), ord("A"), want_s)
    assert np.array_equal(uq.numpy()[:total], want_q)
    assert np.array_equal(us.numpy()[:total], want_s)


def test_pad_flat_bucket():
    assert PT.pad_flat(0) == PJ.pad_flat(0) == 1 << 20
    for nbytes in (1, (1 << 20) + 1, 15609138):
        assert PT.pad_flat(nbytes) == PJ.pad_flat(nbytes)


# the cases of tests/test_device_pack.py::test_pack_device_equals_host
@pytest.mark.parametrize("n,W,maxlen", [(100, 8, 30), (257, 32, 50),
                                        (64, 16, 1), (33, 8, 0)])
@pytest.mark.parametrize("aux", ["bias", "map"])
def test_single_stream_pack_matches_jax(n, W, maxlen, aux):
    """pack_device / unpack_device against pack_jax's on ranges with
    empty records, through a bias (wrapping below 0) or a 256-entry map:
    the whole [Sp, W] matrix (rows past a lane's count included) and the
    whole [pad_flat(total)] buffer equal."""
    rng = np.random.default_rng(n)
    lens = rng.integers(0, maxlen + 1, size=n).astype(np.int64)
    total = int(lens.sum())
    data = rng.integers(33, 120, size=total + 7).astype(np.uint8)
    offs = np.zeros(n, dtype=np.int64)
    offs[1:] = np.cumsum(lens[:-1])
    offs += 7
    counts = np.bincount(np.arange(n) % W, weights=lens,
                         minlength=W).astype(np.int64)
    Sp = max(R.pad_steps(int(counts.max())), 1)
    dpad = np.zeros(PT.pad_flat(len(data)), dtype=np.uint8)
    dpad[: len(data)] = data
    if aux == "bias":
        kw, back = dict(bias=40), dict(bias=-5)
    else:
        kw = dict(map256=_BASE_TO_CODE_DEV)
        back = dict(map256=np.arange(256, dtype=np.uint8)[::-1].copy())
    want = np.asarray(PJ.pack_device(jnp.asarray(dpad), offs.astype(np.int32),
                                     lens.astype(np.int32), W, Sp, **kw))
    got = PT.pack_device(torch.from_numpy(dpad), offs, lens, W, Sp, **kw)
    assert got.dtype == torch.uint8 and got.shape == (Sp, W)
    assert np.array_equal(got.numpy(), want)
    starts = np.zeros(n, dtype=np.int64)
    starts[1:] = np.cumsum(lens[:-1])
    want = np.asarray(PJ.unpack_device(jnp.asarray(got.numpy()),
                                       starts.astype(np.int32),
                                       lens.astype(np.int32), W, total,
                                       **back))
    flat = PT.unpack_device(got, starts, lens, W, total, **back)
    assert flat.shape == (PT.pad_flat(total),)
    assert np.array_equal(flat.numpy(), want)
