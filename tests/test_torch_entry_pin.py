"""The JAX package's container of the port's dryrun_multichip match phase
(tests/test_torch_entry.py holds the port's to its SHA-256): recomputed
here with the JAX package's api.encode_fastq on the CPU, in a file of its
own so that it runs beside the port's dry run."""

import hashlib

from slimfastq_tpu import api as japi
from slimfastq_tpu.config import config_for_level
from slimfastq_tpu.utils.synth import corpus
from tests.test_torch_entry import MATCH_BYTES, MATCH_SHA256


def test_match_pin_is_the_jax_container():
    cfg = config_for_level(4, lanes=64, aux_lanes=16, block_records=1536)
    enc = japi.encode_fastq(corpus("novaseq", 1536 * 2, seed=3), cfg)
    assert len(enc) == MATCH_BYTES
    assert hashlib.sha256(enc).hexdigest() == MATCH_SHA256
