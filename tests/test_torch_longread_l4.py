"""The host-pack path end to end on the CPU at level 4: a coverage corpus
whose block takes a match trial (MATCH_USED, as in test_torch_api.py -k
level4) with every block packed on the host (the port's _MAX_SPAN
lowered) and its SEQ/QUAL streams in step slices, against the JAX
package (the fixture and the round trip of
tests/test_torch_longread_levels.py)."""

import io

import torch

from slimfastq_tpu.utils.synth import corpus
from slimfastq_tpu_torch import container as tcontainer
from slimfastq_tpu_torch.pipeline import MATCH_USED
from tests.test_torch_longread_levels import _round_trip, forced  # noqa: F401

torch.set_num_threads(1)


def test_host_pack_level4_match_trial(forced):  # noqa: F811
    """A coverage corpus whose block takes a match trial (MATCH_USED, as in
    test_torch_api.py -k level4): each trial's rewritten SEQ packed on the
    host; the JAX package's container, and each decodes the other's."""
    data = corpus("novaseq", 1100, seed=0)
    enc = _round_trip(data, 4, forced, lanes=128, aux_lanes=16,
                      block_records=1536)
    f = io.BytesIO(enc)
    cfg = tcontainer.read_header(f)
    assert next(tcontainer.iter_blocks(f, cfg)).flags & MATCH_USED
