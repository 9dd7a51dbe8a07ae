"""Level 4 through the port's pure-Python pipeline (``use_native=False``):
a block above MATCH_CHUNK records whose match trial wins (MATCH_USED),
coded stream by stream with the match-span flags (the trials' SEQ on
encode, the MATCH_USED block's SEQ on decode), against the JAX package's
pure-Python container and the port's native one."""

import io

import torch

from slimfastq_tpu import api as japi
from slimfastq_tpu.ops import streams_jax
from slimfastq_tpu_torch import api, container
from slimfastq_tpu_torch.models.matcher import MATCH_CHUNK
from slimfastq_tpu_torch.pipeline import MATCH_USED
from slimfastq_tpu_torch.utils.synth import corpus

torch.set_num_threads(1)


def test_python_pipeline_level4_match_used():
    data = corpus("novaseq", MATCH_CHUNK + 76)
    kw = dict(level=4, lanes=256, aux_lanes=16)
    enc = api.encode_fastq(data, device="cpu", use_native=False, **kw)
    f = io.BytesIO(enc)
    cfg = container.read_header(f)
    assert [b.flags & MATCH_USED for b in container.iter_blocks(f, cfg)] \
        == [MATCH_USED]
    assert enc == japi.encode_fastq(data, backend=streams_jax,
                                    use_native=False, **kw)
    assert enc == api.encode_fastq(data, device="cpu", **kw)
    assert api.decode_fastq(enc, device="cpu", use_native=False) == data
    assert japi.decode_fastq(enc, backend=streams_jax) == data
