"""Lane counts past 1,024 on the CPU, continued: `aux_lanes` 2,048 at levels
1, 3 and 4 (the byte and flag streams with more than 1,024 lanes on one
entry), the JAX package decoding the port's wide containers, and one
case through the JAX package's streams_jax backend. See
tests/test_torch_wide_lanes.py."""

import pytest
import torch

from slimfastq_tpu import api as japi
from slimfastq_tpu.ops import streams_jax
from slimfastq_tpu_torch import api as tapi
from slimfastq_tpu_torch.utils.synth import synth_fastq

torch.set_num_threads(1)


def _reads(n: int) -> bytes:
    return synth_fastq(n, read_len=50, seed=0, var_len=False,
                       n_rate=0.0005)


@pytest.mark.parametrize("level", [1, 3, 4])
def test_wide_aux_lanes_equal_the_reference(level):
    """1,100 records over 2,048 aux lanes: the port's container equals the
    JAX package's and the port decodes the JAX package's."""
    data = _reads(1100)
    kw = dict(level=level, aux_lanes=2048, block_records=4096)
    ref = japi.encode_fastq(data, **kw)
    assert tapi.encode_fastq(data, device="cpu", **kw) == ref
    assert tapi.decode_fastq(ref, device="cpu") == data


@pytest.mark.parametrize("lanes,aux", [(1500, 64), (2048, 64), (4096, 64),
                                       (1024, 2048)])
def test_reference_decodes_the_wide_port(lanes, aux):
    """The JAX package decodes the port's level-3 container at each
    width."""
    data = _reads(1100)
    enc = tapi.encode_fastq(data, device="cpu", level=3, lanes=lanes,
                            aux_lanes=aux, block_records=4096)
    assert japi.decode_fastq(enc) == data


def test_wide_lanes_equal_streams_jax():
    """2,048 lanes at level 3 through the JAX package's device backend
    (streams_jax on the CPU), not only its oracle."""
    data = _reads(1100)
    kw = dict(level=3, lanes=2048, block_records=4096)
    enc = tapi.encode_fastq(data, device="cpu", **kw)
    assert enc == japi.encode_fastq(data, backend=streams_jax, **kw)
    assert japi.decode_fastq(enc, backend=streams_jax) == data
