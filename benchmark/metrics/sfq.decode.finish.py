"""Each block's finish on the host (pipeline_native.decode_block_finish,
its ``sfq.decode.finish`` span), summed over the finish pool's threads,
ms per raw GB decoded."""
from sfqbench import spans

NAME = "sfq.decode.finish"


def read(run):
    s = spans.of(run)
    return None if s is None else s.pool_ms_per_GB("decode", NAME)
