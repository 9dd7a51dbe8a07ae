"""Block sharding at level 4 on a mesh of 8 CPU entries (the kernels'
plain versions): a coverage corpus whose first block takes a match trial
(MATCH_USED), sharded with each block on its own shard thread, against
the JAX package's container (the comparison of tests/test_torch_sharded.py;
the JAX package's own tests hold its sharded containers to its sequential
ones)."""

import io

import torch

from slimfastq_tpu.utils.synth import corpus
from slimfastq_tpu_torch import container as tcontainer
from slimfastq_tpu_torch.pipeline import MATCH_USED
from tests.test_torch_sharded import _three_ways, mesh8  # noqa: F401

torch.set_num_threads(1)


def test_sharded_level4_match_used(mesh8):  # noqa: F811
    """Two blocks, 1,100 reads (above the matcher's 1,024-read chunk, so
    its trials code inside the first shard's call) and 50, one a shard:
    the first takes MATCH_USED; the JAX package's container; decoded on
    the mesh."""
    data = corpus("novaseq", 1150, seed=0)
    enc = _three_ways(data, 4, mesh8, None, lanes=256, aux_lanes=16,
                      block_records=1100)
    f = io.BytesIO(enc)
    cfg = tcontainer.read_header(f)
    flags = [b.flags for b in tcontainer.iter_blocks(f, cfg)]
    assert len(flags) == 2 and flags[0] & MATCH_USED
