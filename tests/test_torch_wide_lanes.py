"""Lane counts past 1,024 on the CPU: the port's plain versions against the
JAX package at `lanes` 1,500, 2,048 and 4,096, levels 1, 3 and 4. Each
block holds more than 1,024 reads, so more than 1,024 lanes meet on one
table entry at a read start and the format's 10-bit collision count wraps
(the law reads n mod 1024). The port's containers equal the JAX package's
byte for byte and the port decodes them; the law's delta is held against
ranger_np.table_update for every lane count from 1 to 4,096. The card's
kernels at these widths: tests/test_torch_cuda.py and chip_smoke.py's
`wide_lanes` phase."""

import numpy as np
import pytest
import torch

from slimfastq_tpu import api as japi
from slimfastq_tpu.ops import ranger_np
from slimfastq_tpu_torch import api as tapi
from slimfastq_tpu_torch.config import config_for_level
from slimfastq_tpu_torch.ops import coder_torch as CT
from slimfastq_tpu_torch.ops import encode_torch as ET
from slimfastq_tpu_torch.utils.synth import synth_fastq

torch.set_num_threads(1)

MAX_N = 4096


def _reads(n: int, read_len: int = 50) -> bytes:
    return synth_fastq(n, read_len=read_len, seed=0, var_len=False,
                       n_rate=0.0005)


def test_plain_encode_at_2048_lanes_equals_the_reference():
    """The fault: 1,100 lanes on one entry at 2,048 lanes. The plain
    encode reads the count as the format does and gives the JAX package's
    container."""
    data = _reads(1100, read_len=100)
    kw = dict(level=3, lanes=2048, block_records=4096)
    assert tapi.encode_fastq(data, device="cpu", **kw) == \
        japi.encode_fastq(data, **kw)


@pytest.mark.parametrize("lanes", [1500, 2048, 4096])
@pytest.mark.parametrize("level", [1, 3, 4])
def test_wide_lanes_equal_the_reference(level, lanes):
    """The port's container at `lanes` equals the JAX package's (its
    NumPy oracle), and the port decodes the JAX package's container."""
    data = _reads(1100)
    kw = dict(level=level, lanes=lanes, block_records=4096)
    ref = japi.encode_fastq(data, **kw)
    assert tapi.encode_fastq(data, device="cpu", **kw) == ref
    assert tapi.decode_fastq(ref, device="cpu") == data


def _reference_entry(geom, p: int, vis: int, n: int, k: int) -> tuple:
    """One entry with n lanes on it, k of them coding a 1, through
    ranger_np.table_mark + table_update: (p, visits) after the step."""
    table = np.array([p, ranger_np.PROB_MAX], dtype=np.int32)
    idx = np.zeros(n, dtype=np.int64)
    ranger_np.table_mark(table, idx, 1)
    marked = table[idx]
    bit = (np.arange(n) < k).astype(np.int32)
    warm = CT._warm(geom)
    vt = np.array([vis, 0], dtype=np.int32) if warm else None
    ranger_np.table_update(table, idx, marked, bit, geom.rate, 1, vtable=vt,
                           rate_lo=geom.rate_lo if warm else 0)
    return int(table[0]), int(vt[0]) if warm else 0


def _cases(geom):
    """(p, visits, n, k) for every n from 1 to 4,096: p and the ones
    spread over their range, visits up to the kernels' cap."""
    n = np.arange(1, MAX_N + 1)
    p = 16 + (n * 997) % (4080 - 16 + 1)
    vis = n % (CT.visit_cap(geom) + 1)
    k = (n * 7) % (n + 1)
    return p, vis, n, k


@pytest.mark.parametrize("kind", ["qual", "bytes_"])
def test_encode_law_reads_the_wrapped_count(kind):
    """encode_torch._law, the entry scan's delta (law_delta in
    csrc/ctx.cuh), for every n from 1 to 4,096 lanes on an entry: p +
    k d(1) + (n - k) d(0), clamped, equals the format's."""
    geom = getattr(config_for_level(3), kind)
    p, vis, n, k = _cases(geom)
    lg = CT._lg_lut(torch.device("cpu")).long()
    pt, vt, nt, kt = (torch.from_numpy(x).long() for x in (p, vis, n, k))
    warm = CT._warm(geom)
    d1 = ET._law(geom, warm, lg, pt, vt, nt, True)
    d0 = ET._law(geom, warm, lg, pt, vt, nt, False)
    got = (pt + kt * d1 + (nt - kt) * d0).clamp(ranger_np.PROB_MIN,
                                                ranger_np.PROB_MAX)
    want = [_reference_entry(geom, *map(int, c))[0]
            for c in zip(p, vis, n, k)]
    assert got.tolist() == want


@pytest.mark.parametrize("kind", ["qual", "bytes_"])
def test_decode_law_reads_the_wrapped_count(kind):
    """coder_torch._Law, the plain decode's bit-step (int32 marks that
    wrap), for every n from 1 to 4,096 lanes on an entry, equals the
    format's p and visit count."""
    geom = getattr(config_for_level(3), kind)
    law = CT._Law(geom, MAX_N, torch.device("cpu"))
    for p, vis, n, k in zip(*_cases(geom)):
        p, vis, n, k = int(p), int(vis), int(n), int(k)
        law.table[0] = p
        if law.vtab is not None:
            law.vtab[0] = vis
        idx = torch.zeros(n, dtype=torch.int64)
        real = torch.ones(n, dtype=torch.int32)
        marked, pp = law.mark(idx, real << ranger_np.CNT_SHIFT)
        law.update(idx, real, marked, pp, torch.arange(n) < k)
        got = (int(law.table[0]),
               int(law.vtab[0]) if law.vtab is not None else 0)
        assert got == _reference_entry(geom, p, vis, n, k), (n, k)
