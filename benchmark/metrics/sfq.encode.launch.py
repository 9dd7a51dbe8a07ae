"""The host's time in Kernel E's and Kernel C's launches
(``sfq.encode.<stream>.coder``, ``sfq.encode.compact``), ms per raw GB
encoded, self time: the waits inside are read apart."""
from sfqbench import spans

NAMES = ("sfq.encode.*.coder",
         "sfq.encode.compact")


def read(run):
    s = spans.of(run)
    return None if s is None else s.self_ms_per_GB("encode", NAMES)
