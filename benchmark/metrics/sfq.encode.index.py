"""native.fastq_index on the encode's main thread (api.encode_fastq_on), ms
per raw GB encoded, self time."""
from sfqbench import spans

NAMES = ("sfq.encode.index",)


def read(run):
    s = spans.of(run)
    return None if s is None else s.self_ms_per_GB("encode", NAMES)
