"""The coder tails appended to the lanes (streams_torch._flush_append) and
each block assembled (pipeline_native._assemble) on the main thread, ms
per raw GB encoded, self time."""
from sfqbench import spans

NAMES = ("sfq.encode.assemble",)


def read(run):
    s = spans.of(run)
    return None if s is None else s.self_ms_per_GB("encode", NAMES)
