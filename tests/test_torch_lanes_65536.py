"""The plain encode's record fields at 65,536 lanes, on the CPU. A step's
records carry each entry's n real lanes and k ones, and each decision its
record number (rid). With every lane real and on one entry at a read
start, n reaches W: at 65,536 lanes n no longer fits the 16 bits of the
packed word n | k << 16, and from 32,768 ones on the packed word's sign
must not reach k. One SEQ stream of 8 steps, two 4-base reads a lane
starting together (every lane on the root entry at steps 0 and 4, where
the entry is read again), through the port's plain encode against the JAX
package's NumPy oracle (ranger_np, streams_np's context) and against the
lockstep plain encode, and the port's plain decode of the oracle's bytes.
The kernels' wide fields run on the card (tests/test_torch_cuda.py,
chip_smoke.py's `wide_lanes`)."""

import numpy as np
import pytest
import torch

from slimfastq_tpu.ops import ranger_np as R
from slimfastq_tpu.ops import streams_np as JNP
from slimfastq_tpu_torch.config import config_for_level
from slimfastq_tpu_torch.ops import coder_torch as CT
from slimfastq_tpu_torch.ops import compact_torch as CC
from slimfastq_tpu_torch.ops import streams_torch as ST

torch.set_num_threads(1)

READ = 4  # bases a read
SP = 2 * READ  # steps: one emission chunk


def _stream(W: int):
    """[SP, W] SEQ symbols of two reads a lane, every lane's first base G
    (its first bit a one at the root entry, so k = n = W there), its
    pos / reset and counts."""
    rng = np.random.default_rng(W)
    syms = rng.integers(0, 4, size=(SP, W)).astype(np.uint8)
    syms[0] = 2
    counts = np.full(W, SP, dtype=np.int64)
    pos, reset = JNP.build_pos_reset(np.full((2, W), READ, dtype=np.int64),
                                     SP)
    return syms, counts, pos, reset


def _oracle(geom, syms, counts, pos, reset):
    """The JAX package's lockstep oracle over the SP steps (streams_np's
    encode_stream without its padding to 256 steps): (payload, lens)."""
    W = syms.shape[1]
    table = R.table_init(geom.table_size, geom.sac_base)
    vtable = np.zeros(geom.table_size, dtype=np.int32)  # visit warm-up
    enc = R.LaneEncoder(W, R.worst_case_bytes(SP * geom.depth))
    ctxer = JNP.SeqCtx(geom, W)
    for t in range(SP):
        ctx = ctxer.step_ctx(t, pos[t], reset[t], mflag=None)
        ctx = np.where(counts > t, ctx, np.uint32(geom.num_ctx))
        sym = syms[t].astype(np.uint32)
        R.encode_symbols(enc, table, ctx, sym, geom.depth, geom.rate,
                         geom.sac_base, vtable=vtable, rate_lo=geom.rate_lo)
        ctxer.advance(sym)
    enc.flush()
    return enc.out[:, :int(enc.ptr.max())], enc.ptr


@pytest.mark.parametrize("W", [40000, 65536])
def test_every_lane_on_one_entry(W):
    syms, counts, pos, reset = _stream(W)
    geom = config_for_level(3).seq
    assert CT._warm(geom)
    pay, lens = _oracle(geom, syms, counts, pos, reset)
    t = [torch.from_numpy(x.astype(np.int32)) for x in (counts, pos, reset)]
    item = CT.EncIn(torch.from_numpy(syms), t[1], t[2], t[0])
    CB = ST._chunk_bytes(geom.depth, hard=False)
    got = CT.lane_encode_blocks([item], "seq", geom, CB)[0]
    # the decoupled encode's outputs equal the lockstep form's
    for a, b in zip(got, CT.lane_encode_blocks_plain([item], "seq", geom,
                                                     CB)[0]):
        assert torch.equal(a, b)
    ebufs, eptrs, low, _ = got
    totals = eptrs.sum(dim=0)
    com = CC.compact_lanes_plain(ebufs, eptrs, int(totals.max()))
    gp, gl = ST._flush_append(com[0].numpy(), totals.numpy().astype(np.int64),
                              low.numpy().view(np.uint32), counts)
    assert np.array_equal(gl, lens) and np.array_equal(gp, pay)
    back = CT.lane_decode(torch.from_numpy(pay), torch.from_numpy(
        lens.astype(np.int32)), t[0], t[1], t[2], "seq", geom)
    assert np.array_equal(back.numpy(), syms)
