"""Each block's host modelling (pipeline_native.prepare_block_fast, its
``sfq.encode.prep`` span), summed over the prep pool's threads, ms per
raw GB encoded."""
from sfqbench import spans

NAME = "sfq.encode.prep"


def read(run):
    s = spans.of(run)
    return None if s is None else s.pool_ms_per_GB("encode", NAME)
